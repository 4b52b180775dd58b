"""The one traffic generator. A mix is a data file (sqlbench/traffic/
<mix>.json): its sessions, its loop, and its templates, each with SQL text,
a weight, its substitution parameters and the reference that answers it.

Parameter kinds (drawn in the order written; a derived one reads those
before it):
    {"uniform_int": [lo, hi]}            an int in [lo, hi]
    {"choice": [a, b, ...]}              one of the values
    {"uniform_date": [lo, hi]}           a 'YYYY-MM-DD' in [lo, hi]
    {"year_start": [lo, hi]}             'YYYY-01-01' for a year in [lo, hi]
    {"decimal_step": [lo, hi, step]}     a decimal string on the grid lo + k step
    {"fixed": value}                     the value itself
    {"date_minus_days": [date, param]}   date - param days
    {"date_plus_years": [param, n]}      param + n years
    {"decimal_add": [param, delta]}      param + delta, at param's scale

Each session draws its statements from its own stream of the seed, in
blocks that hold every template as often as its weight says, in a random
order: every seed gives each session the same shares.
"""

from __future__ import annotations

from dataclasses import dataclass
from decimal import Decimal

import numpy as np


@dataclass(frozen=True)
class Statement:
    template: str
    sql: str
    params: tuple  # ((name, value), ...) in the order drawn

    def param_dict(self) -> dict:
        return dict(self.params)


def _date(s: str) -> np.datetime64:
    return np.datetime64(s, "D")


def draw_params(spec: dict, rng: np.random.Generator) -> dict:
    out = {}
    for name, p in spec.items():
        (kind, arg), = p.items()
        if kind == "uniform_int":
            out[name] = int(rng.integers(arg[0], arg[1] + 1))
        elif kind == "choice":
            out[name] = arg[int(rng.integers(0, len(arg)))]
        elif kind == "uniform_date":
            lo, hi = _date(arg[0]), _date(arg[1])
            out[name] = str(lo + int(rng.integers(0, int((hi - lo).astype(int)) + 1)))
        elif kind == "year_start":
            out[name] = f"{int(rng.integers(arg[0], arg[1] + 1)):04d}-01-01"
        elif kind == "decimal_step":
            lo, hi, step = (Decimal(a) for a in arg)
            k = int(rng.integers(0, int((hi - lo) / step) + 1))
            out[name] = str(lo + k * step)
        elif kind == "fixed":
            out[name] = arg
        elif kind == "date_minus_days":
            out[name] = str(_date(arg[0]) - int(out[arg[1]]))
        elif kind == "date_plus_years":
            y, rest = out[arg[0]].split("-", 1)
            out[name] = f"{int(y) + int(arg[1]):04d}-{rest}"
        elif kind == "decimal_add":
            base = Decimal(out[arg[0]])
            out[name] = str((base + Decimal(arg[1])).quantize(base))
        else:
            raise ValueError(f"unknown parameter kind {kind!r}")
    return out


def statement(tmpl: dict, rng: np.random.Generator) -> Statement:
    params = draw_params(tmpl.get("params", {}), rng)
    return Statement(tmpl["name"], tmpl["sql"].format(**params), tuple(params.items()))


class Stream:
    """One session's statements, drawn lazily from its own seed stream."""

    def __init__(self, mix: dict, seed: int, session: int):
        self.templates = mix["templates"]
        self.rng = np.random.default_rng([seed, 0x51, session])
        self.block: list = []

    def next(self) -> Statement:
        if not self.block:
            idx = [i for i, t in enumerate(self.templates) for _ in range(int(t.get("weight", 1)))]
            self.block = [idx[j] for j in self.rng.permutation(len(idx))]
        return statement(self.templates[self.block.pop()], self.rng)


def warm_statements(mix: dict, seed: int) -> list:
    """One statement of each template, from a stream of its own (the set-up
    runs these before the window)."""
    rng = np.random.default_rng([seed, 0x3A])
    return [statement(t, rng) for t in mix["templates"]]

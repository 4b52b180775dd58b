"""Extension registry: custom scalar functions and system variables without
touching core (ref: pkg/extension — WithCustomSysVariables manifest.go:38,
WithCustomFunctions manifest.go:52; SURVEY §2.1 names this as the hook the
TPU feature gate itself would use in the reference).

Custom functions run host-side: the planner lowers them to IR ops, the
row-at-a-time evaluator dispatches to the registered Python callable, and
the DAG splitter keeps any expression containing one on the root side
(where the oracle fallback executes), exactly like a non-pushdown-able
builtin behind the pushdown blocklist (infer_pushdown.go IsPushDownEnabled).

Copy of `tidb_tpu/sql/extension.py` for the PyTorch port (imports rewritten; it imports nothing of tidb_tpu).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..expr import ir
from ..types import Datum, DatumKind, FieldType, MyDecimal, new_double, new_longlong, new_varchar


@dataclass
class CustomFunction:
    name: str
    fn: object  # (*python values | None) -> python value | None
    ft: FieldType
    raw: bool = False  # fn takes the Datum list and returns a Datum
    # (internal consumers like the subquery Apply fallback need exact
    # types for bindings; user extensions keep the plain-value contract)


_APPLY_CAP = 256  # FIFO bound on internal __apply_* registrations


class ExtensionRegistry:
    def __init__(self):
        self.functions: dict[str, CustomFunction] = {}
        self._apply_fifo: list[str] = []

    def register_function(self, name: str, fn, result_ft: FieldType | None = None, raw: bool = False):
        """Register a host-evaluated scalar function usable from SQL.
        `fn` receives plain Python values (None for NULL) and returns one;
        the result type defaults to VARCHAR unless given. raw=True passes
        and returns Datums verbatim (internal use)."""
        name = name.lower()
        if name in ir.SCALAR_OPS:
            raise ValueError(f"{name!r} is a builtin and cannot be overridden")
        cf = CustomFunction(name, fn, result_ft or new_varchar(255), raw)
        self.functions[name] = cf
        ir.EXTENSION_OPS.add(name)
        if name.startswith("__apply_"):
            # the subquery Apply fallback registers one closure per
            # rewritten statement (it pins the sub-AST + result cache);
            # statements re-rewrite on every execution, so old entries are
            # dead — a FIFO cap keeps the registry bounded
            self._apply_fifo.append(name)
            if len(self._apply_fifo) > _APPLY_CAP:
                self.unregister_function(self._apply_fifo.pop(0))
        return cf

    def register_sysvar(self, name: str, default: str, validator=None, scope: str = "both"):
        """Register a custom system variable (ref: WithCustomSysVariables)."""
        from .sysvar import DEFINITIONS, SysVar

        name = name.lower()
        if name in DEFINITIONS:
            raise ValueError(f"sysvar {name!r} already defined")
        sv = SysVar(name, default, scope, validator)
        DEFINITIONS[name] = sv
        return sv

    def unregister_function(self, name: str):
        self.functions.pop(name.lower(), None)
        ir.EXTENSION_OPS.discard(name.lower())

    def call(self, name: str, datums: list) -> Datum:
        cf = self.functions[name.lower()]
        if cf.raw:
            return cf.fn(list(datums))
        args = [None if d.is_null() else d.val for d in datums]
        out = cf.fn(*args)
        return _to_datum(out, cf.ft)


def _to_datum(v, ft: FieldType) -> Datum:
    if v is None:
        return Datum.NULL
    if isinstance(v, bool):
        return Datum.i64(int(v))
    if isinstance(v, int):
        return Datum.u64(v) if ft.is_unsigned() else Datum.i64(v)
    if isinstance(v, float):
        return Datum.f64(v)
    if isinstance(v, MyDecimal):
        return Datum.dec(v)
    if isinstance(v, bytes):
        return Datum.bytes_(v)
    return Datum.string(str(v))


EXTENSIONS = ExtensionRegistry()

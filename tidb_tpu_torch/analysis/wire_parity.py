"""`wire-parity` — encode/decode symmetry over codec/wire.py (ref: the
protobuf contract the reference gets for free from .proto codegen; a
hand-rolled tagged binary format has no generator, so symmetry is a lint
invariant instead).

For every `encode_X`/`w_X` in the wire module there must be a matching
`decode_X`/`r_X`, and the pair must cover the SAME fields:

  * the set of primitive writer ops used (`w.u8/i32/i64/u64/f64/blob/s/
    bool_`) equals the set of primitive reader ops (`r.<same>`), so a
    field written in one width can never be read back in another — and a
    field written but never read (or vice versa) shifts the stream for
    everything after it;
  * helper calls pair up: `w_foo`/`encode_foo` on the write side must be
    mirrored by `r_foo`/`decode_foo` on the read side.

Sets (not call counts) are compared: loops and per-kind branches
legitimately differ in call-site counts (e.g. one shared `w.f64` for two
float kinds decodes through two `r.f64` branches).

Copy of `tidb_tpu/analysis/wire_parity.py` for the PyTorch port, scoped to
`tidb_tpu_torch/codec/wire.py` (the fragment frames included).
"""

from __future__ import annotations

import ast

from .common import Finding

PASS = "wire-parity"

_PRIMS = {"u8", "i32", "i64", "u64", "f64", "blob", "s", "bool_"}


def _is_codec_fn(name: str) -> str | None:
    """-> role key for pairing: ('encode'|'decode'|'w'|'r', stem)."""
    for prefix, role in (("encode_", "encode"), ("decode_", "decode"),
                         ("w_", "w"), ("r_", "r")):
        if name.startswith(prefix):
            return f"{role}:{name[len(prefix):]}"
    return None


_MIRROR = {"encode": "decode", "decode": "encode", "w": "r", "r": "w"}


def _profile(fn: ast.FunctionDef) -> tuple[set, set]:
    """(primitive ops, helper stems) used by one codec function."""
    prims: set = set()
    helpers: set = set()
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr in _PRIMS and isinstance(f.value, ast.Name):
            prims.add(f.attr)
        elif isinstance(f, ast.Name):
            key = _is_codec_fn(f.id)
            if key is not None:
                role, stem = key.split(":", 1)
                helpers.add((role, stem))
    return prims, helpers


def run(files) -> list:
    findings: list = []
    for sf in files:
        if sf.tree is None or not sf.rel.endswith("wire.py"):
            continue
        fns = {n.name: n for n in sf.tree.body if isinstance(n, ast.FunctionDef)}
        roles: dict[str, ast.FunctionDef] = {}
        for name, fn in fns.items():
            key = _is_codec_fn(name)
            if key is not None:
                roles[key] = fn
        for key, fn in sorted(roles.items()):
            role, stem = key.split(":", 1)
            if role in ("decode", "r"):
                continue  # pairs are reported from the write side
            mirror = f"{_MIRROR[role]}:{stem}"
            partner = roles.get(mirror)
            if partner is None:
                findings.append(Finding(
                    sf.rel, fn.lineno, PASS,
                    f"{fn.name} has no matching "
                    f"{_MIRROR[role]}_{stem} — every encoder needs a decoder "
                    f"(round-trip parity)"))
                continue
            wp, wh = _profile(fn)
            rp, rh = _profile(partner)
            if wp != rp:
                only_w = sorted(wp - rp)
                only_r = sorted(rp - wp)
                detail = []
                if only_w:
                    detail.append(f"written but never read: {only_w}")
                if only_r:
                    detail.append(f"read but never written: {only_r}")
                findings.append(Finding(
                    sf.rel, fn.lineno, PASS,
                    f"{fn.name}/{partner.name} field-kind mismatch — "
                    + "; ".join(detail)))
            wh_m = {(_MIRROR[r], s) for r, s in wh}
            if wh_m != rh:
                only_w = sorted(s for r, s in wh if (_MIRROR[r], s) not in rh)
                only_r = sorted(s for r, s in rh if (r, s) not in wh_m)
                detail = []
                if only_w:
                    detail.append(f"encoded sub-structures with no decode: {only_w}")
                if only_r:
                    detail.append(f"decoded sub-structures never encoded: {only_r}")
                findings.append(Finding(
                    sf.rel, fn.lineno, PASS,
                    f"{fn.name}/{partner.name} sub-structure mismatch — "
                    + "; ".join(detail)))
    return findings

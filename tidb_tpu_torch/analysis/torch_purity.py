"""`torch-purity` — no module-level tensors and no process-wide torch
toggles in the program-building packages (ops/, exec/, expr/, parallel/):
the port's counterpart of the JAX package's `jit-purity` pass.

A module whose top level runs `X = torch.tensor(...)` makes its tensor
whenever the module is FIRST imported: the tensor's device and dtype are
fixed then (the CPU, whatever default dtype is ambient), and every program
built later either copies it to the card on each call or mixes devices.
Constants belong in numpy or Python scalars, or inside the function that
builds the program, where the device is known.

Process-wide toggles — `torch.set_default_dtype`, `set_default_device`,
`set_default_tensor_type`, `use_deterministic_algorithms`,
`set_flush_denormal` and assignments under `torch.backends.` — flip global
state for every thread and every later import (the counterparts of the
JAX package's `enable_x64` and `jax.config.update`). They are flagged
wherever they appear in scope: inside a function they are still
process-wide.
"""

from __future__ import annotations

import ast

from .common import Finding

PASS = "torch-purity"

# torch functions that return a new tensor
_FACTORIES = {
    "tensor", "as_tensor", "asarray", "from_numpy", "frombuffer", "scalar_tensor",
    "zeros", "ones", "empty", "full", "empty_strided", "arange", "range", "linspace",
    "logspace", "eye", "rand", "randn", "randint", "randperm", "zeros_like", "ones_like",
    "empty_like", "full_like", "rand_like", "randn_like", "randint_like", "stack", "cat",
    "concat", "where", "tril_indices", "triu_indices",
}
_TOGGLES = {
    "set_default_dtype", "set_default_device", "set_default_tensor_type",
    "use_deterministic_algorithms", "set_flush_denormal",
}


def _torch_aliases(tree: ast.AST) -> tuple[set, set]:
    """(names bound to the torch module, names bound to torch factories
    by `from torch import ...`)."""
    mods, funcs = set(), set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "torch" or a.name.startswith("torch."):
                    mods.add(a.asname or "torch")
        elif isinstance(node, ast.ImportFrom) and node.module == "torch" and node.level == 0:
            for a in node.names:
                if a.name in _FACTORIES or a.name in _TOGGLES:
                    funcs.add(a.asname or a.name)
    return mods or {"torch"}, funcs


def _dotted(node) -> list[str] | None:
    """`torch.backends.cuda.x` -> ["torch", "backends", "cuda", "x"]."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return parts[::-1]
    return None


def _call_name(call: ast.Call, mods: set, funcs: set) -> str | None:
    """The torch function a call names (`torch.zeros(...)` -> "zeros"),
    else None."""
    f = call.func
    if isinstance(f, ast.Name):
        return f.id if f.id in funcs else None
    parts = _dotted(f)
    if parts and parts[0] in mods and len(parts) == 2:
        return parts[1]
    return None


def _tensor_call(value, mods: set, funcs: set) -> ast.Call | None:
    for sub in ast.walk(value):
        if isinstance(sub, ast.Call) and _call_name(sub, mods, funcs) in _FACTORIES:
            return sub
    return None


def _target_name(node) -> str:
    t = node.targets[0] if isinstance(node, ast.Assign) else node.target
    try:
        return ast.unparse(t)
    except Exception:  # noqa: BLE001
        return "<target>"


def run(files) -> list:
    findings: list = []
    for sf in files:
        if sf.tree is None:
            continue
        mods, funcs = _torch_aliases(sf.tree)
        for node in sf.tree.body:  # tensors: MODULE level only
            if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)) and node.value is not None:
                if _tensor_call(node.value, mods, funcs) is not None:
                    findings.append(Finding(
                        sf.rel, node.lineno, PASS,
                        f"module-level tensor bound to {_target_name(node)}: made at import "
                        f"time, it fixes its device and dtype (the CPU, the ambient default "
                        f"dtype) for every program built later — build it inside the "
                        f"function, or keep a numpy/python constant"))
        for node in ast.walk(sf.tree):  # toggles: anywhere in scope
            if isinstance(node, ast.Call):
                name = _call_name(node, mods, funcs)
                if name in _TOGGLES:
                    findings.append(Finding(
                        sf.rel, node.lineno, PASS,
                        f"call to torch.{name}() flips process-wide torch state — every "
                        f"thread and every later import sees it; pass the dtype/device "
                        f"explicitly instead"))
            elif isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                targets = node.targets if isinstance(node, ast.Assign) else [node.target]
                for t in targets:
                    parts = _dotted(t)
                    if parts and len(parts) > 2 and parts[0] in mods and parts[1] == "backends":
                        findings.append(Finding(
                            sf.rel, node.lineno, PASS,
                            f"assignment to {'.'.join(parts)} flips a process-wide torch "
                            f"backend setting — every thread and every later import sees it"))
    return findings

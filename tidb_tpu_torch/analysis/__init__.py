"""The port's runtime analysis: `lockwatch`, the opt-in lockset and
lock-order detector that the storm and concurrency tests run under, and
`guards`, which reads the `# guarded_by:` / `# requires:` comments it
checks (`common` holds the shared source-file plumbing).

    from tidb_tpu_torch.analysis import lockwatch
    with lockwatch.watching() as w:
        ...  # drive concurrent engine work
    w.report()  # {"edges", "cycles", "violations"}

The submodules load on first use. The JAX package's static vet passes and
its jaxpr auditor have no counterpart here.
"""

from __future__ import annotations

import importlib

__all__ = ["common", "guards", "lockwatch"]


def __getattr__(name: str):
    if name in __all__:
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

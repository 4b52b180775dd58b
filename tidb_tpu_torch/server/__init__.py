"""MySQL wire protocol server (ref: pkg/server), the store's admission gate
and the cross-session coalescer.

Lazily re-exported (PEP 562): the store tier imports `server.admission`
for its AdmissionGate and `server.coalesce` for its SessionCoalescer, and
eagerly importing the wire server here would cycle back through sql ->
store.

Copy of `tidb_tpu/server/__init__.py` for the PyTorch port (it imports
nothing of tidb_tpu)."""

__all__ = ["MySQLServer", "MiniClient", "split_statements",
           "AdmissionGate", "AdmissionShed", "SessionCoalescer"]


def __getattr__(name):
    if name == "MiniClient":
        from .client import MiniClient
        return MiniClient
    if name in ("MySQLServer", "split_statements"):
        from . import server as _server
        return getattr(_server, name)
    if name in ("AdmissionGate", "AdmissionShed"):
        from . import admission as _admission
        return getattr(_admission, name)
    if name == "SessionCoalescer":
        from .coalesce import SessionCoalescer
        return SessionCoalescer
    raise AttributeError(name)

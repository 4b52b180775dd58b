"""The server tier of the port: the store's admission gate
(admission.py, a copy of tidb_tpu/server/admission.py). The MySQL wire
server and the cross-session coalescer are not ported."""

from .admission import AdmissionGate, AdmissionShed

__all__ = ["AdmissionGate", "AdmissionShed"]

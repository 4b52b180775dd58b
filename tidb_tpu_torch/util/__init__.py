"""Utilities copied from the JAX package's JAX-free `tidb_tpu/util/`:
`metrics` (the registry and its families), `failpoint`, `tracing` and
`backoff`."""

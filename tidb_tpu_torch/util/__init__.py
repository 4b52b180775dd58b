"""Utilities copied from the JAX package's JAX-free `tidb_tpu/util/`: so far
`metrics` (the registry and its families)."""

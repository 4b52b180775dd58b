"""A benchmark of tidb_tpu_torch: SQL statement streams through its
Session on one card. `python sqlbench/run.py --help`."""

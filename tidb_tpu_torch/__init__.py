"""tidb_tpu_torch — the coprocessor program on PyTorch and CUDA.

A port of `tidb_tpu`'s device path to eager PyTorch on an NVIDIA Hopper
card. The layout mirrors the JAX package module for module, so each
module's counterpart is easy to find:

  types/, chunk/column.py, chunk/chunk.py, expr/ir.py, expr/agg.py,
  expr/eval_ref.py, exec/dag.py, exec/ladder.py, codec/, store/kv.py,
  store/region.py, store/errors.py, native/
             copies of the JAX package's JAX-free modules (imports only
             rewritten); the port never imports `tidb_tpu` or `jax`
  chunk/device.py  host Chunk -> capacity-padded torch DeviceBatch
  expr/compile.py  Expr trees -> eager torch ops over device columns
  ops/             selection, key normalisation, segment machinery,
                   aggregation, and ops/dense_agg.py — the one-pass small-G
                   GROUP BY kernel written in CUDA C++ for sm_90a
                   (csrc/dense_agg.cu)
  exec/            DAG -> a closure over eager ops (builder.py), the
                   overflow-retry driver and the row-at-a-time oracle
                   (executor.py)
  store/store.py   the coprocessor store: region rows decoded once per
                   region version, cached on the host and the device, served
                   by coprocessor(req) and coprocessor_bytes (wire bytes)
  interop.py       numpy column arrays -> DeviceBatch (feeds both packages
                   identical batches in the tests)
  distsql/         the dispatch loop and execute_root (push half per
                   region, root merge on the device)
  parser/, sql/, store/txn.py
                   the SQL session (sql.Session): parser, planner, plan
                   cache and Percolator transactions over execute_root
  server/          the MySQL wire server, the HTTP status API, the
                   store's admission gate and the cross-session coalescer
                   (point gets of many sessions as lanes of one batched
                   launch; autocommit writes as one group commit)
  br/, tools/br.py full backup / restore and log backup with
                   point-in-time RESTORE ... UNTIL TS over the store
  cdc/, columnar/  changefeeds over the replication log, and the columnar
                   replica they feed: delta + stable layers whose stable
                   batches stay on the store's device, served to
                   execute_root's engine routing and the MPP tier's probe

Every entry point takes an explicit `device` (default "cuda") and raises
when CUDA is absent; the tests pass device="cpu". Dtypes are explicit:
int lanes are int64, MySQL DOUBLE is float64.
"""

__version__ = "0.1.0"

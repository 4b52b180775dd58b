"""The MPP exchange data plane (port of tidb_tpu/mpp/; ref:
pkg/planner/core/fragment.go + unistore/cophandler/mpp_exec.go).

  fragment.py     the fragment planner (a copy): cuts a shuffle-eligible
                  DAG at each join / final-agg boundary.
  exchange_op.py  the exchange operator: hash partition ids, bucket
                  scatter, the all_to_all over the shards, and the
                  shuffle-join program.
  dispatch.py     execute_exchange_plan: stacks the scanned chunks, slices
                  the build tables over the shards and runs the exchange
                  program on the capacity ladder.

The MPP tier's own dispatch (try_mpp_select: fragment frames on the wire,
the columnar replica as the probe source) is not ported; the session's
seam declines it and the mesh select runs the same exchange programs.
Import submodules directly; this initializer stays import-light.
"""

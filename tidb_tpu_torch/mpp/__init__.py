"""The MPP exchange data plane (port of tidb_tpu/mpp/; ref:
pkg/planner/core/fragment.go + unistore/cophandler/mpp_exec.go).

  fragment.py     the fragment planner (a copy): cuts a shuffle-eligible
                  DAG at each join / final-agg boundary.
  exchange_op.py  the exchange operator: hash partition ids, bucket
                  scatter, the all_to_all over the shards, and the
                  shuffle-join program.
  dispatch.py     try_mpp_select, the MPP statement tier: the fragment
                  plan through the wire codec's fragment frames, the probe
                  scan from the columnar replica where it covers the
                  snapshot, else through the row store's select, the
                  exchange program; and
                  execute_exchange_plan, which stacks the scanned chunks,
                  slices the build tables over the shards and runs the
                  exchange program on the capacity ladder.

Import submodules directly; this initializer stays import-light.
"""

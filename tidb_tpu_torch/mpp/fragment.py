"""Fragment planner (a copy of tidb_tpu/mpp/fragment.py): cut an eligible
pushdown DAG at exchange boundaries into ExchangeSender/ExchangeReceiver-
linked fragments (ref: pkg/planner/core/fragment.go:116
GenerateRootMPPTasks; the sender modes are
unistore/cophandler/mpp_exec.go:669-719).

The reference walks the physical plan top-down, starts a new fragment under
every ExchangeReceiver, and assigns each fragment one MPP task per
participating store. Here the cut points are structural — each JOIN
boundary (both sides hash-partition by the join key) and the final-agg
boundary (Partial1 states hash-partition by group key; the Final fragment
streams to root PassThrough) — and the task topology is the mesh itself:
every fragment runs `n_tasks` tasks, one per shard, so the fragment graph
is a launch plan for ONE exchange program (`mpp/exchange_op.py`: phases
over the shards with collectives between them) rather than a process
tree. The topology is STABLE: fragment indices are assigned bottom-up per
stage, so equal DAG shapes produce equal plans.

The string width gate lives here because it is a property of the EXCHANGE,
not of any one tier: packed compare words carry the first
STRING_WORDS*8 bytes across the all_to_all; longer values would silently
truncate, so every exchange consumer (mesh tier, mpp tier) shares this
check. flen counts CHARACTERS (utf8mb4: up to 4 bytes each) and inserts do
not enforce it, so the static gate is advisory only — the authoritative
check measures actual bytes in the scanned chunks (chunks_exchange_safe).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..exec.dag import Aggregation, DAGRequest, Join, Selection, TableScan

# exchange partition modes (ref: mpp_exec.go:669 partition types)
EXCHANGE_HASH = "hash"
EXCHANGE_BROADCAST = "broadcast"
EXCHANGE_PASSTHROUGH = "passthrough"

# widest string (bytes) the packed compare words carry byte-exactly
MAX_EXCHANGE_STR = 32

# the root collector pseudo-fragment: the Final fragment's PassThrough
# sender streams to it (ref: the TiDB-side MPPGather above the plan)
ROOT_COLLECTOR = -1


def chunks_exchange_safe(chunks) -> bool:
    """No string value in any scanned column exceeds the packed-word width
    the exchange can carry byte-exactly."""
    for c in chunks:
        for col in c.columns:
            if col.is_varlen() and len(col):
                if int((col.offsets[1:] - col.offsets[:-1]).max()) > MAX_EXCHANGE_STR:
                    return False
    return True


@dataclass(frozen=True)
class ExchangeSender:
    """The fragment's output boundary (ref: PhysicalExchangeSender)."""

    exchange_type: str        # EXCHANGE_HASH | _BROADCAST | _PASSTHROUGH
    partition_keys: tuple     # Expr tuple (hash mode; empty otherwise)
    target_fragment: int      # receiving fragment idx (ROOT_COLLECTOR = root)


@dataclass(frozen=True)
class ExchangeReceiver:
    """The fragment's input boundary (ref: PhysicalExchangeReceiver)."""

    source_fragment: int      # fragment whose sender feeds this input


@dataclass(frozen=True)
class Fragment:
    """One exchange-delimited plan slice; runs n_tasks SPMD tasks."""

    idx: int
    executors: tuple          # DAG executor nodes local to this fragment
    receivers: tuple          # ExchangeReceiver inputs, probe side first
    sender: ExchangeSender


@dataclass(frozen=True)
class FragmentPlan:
    fragments: tuple
    n_tasks: int              # tasks per fragment = mesh width
    root: int                 # idx of the Final fragment (streams to root)


def split_join_dag(dag: DAGRequest):
    """-> (probe_scan, pre_sels, [(join, post_sels), ...], agg) or None.

    A CHAIN of shuffle joins is eligible (TPC-H Q3's 3-table shape:
    lineitem ⋈ orders ⋈ customer — each stage re-exchanges the widened
    schema by the next join key, ref: fragment.go stacking ExchangeSender
    under each HashJoin). Build sides must be scan [selection]* — a join
    nested INSIDE a build side still stays off-mesh; the planner
    right-deepens chains so that shape is the common one."""
    exs = dag.executors
    if not exs or not isinstance(exs[0], TableScan):
        return None
    i = 1
    pre = []
    while i < len(exs) and isinstance(exs[i], Selection):
        pre.append(exs[i])
        i += 1
    stages = []
    while i < len(exs) and isinstance(exs[i], Join):
        join = exs[i]
        i += 1
        post = []
        while i < len(exs) and isinstance(exs[i], Selection):
            post.append(exs[i])
            i += 1
        if not join.build or not isinstance(join.build[0], TableScan):
            return None
        if not all(isinstance(e, Selection) for e in join.build[1:]):
            return None
        stages.append((join, post))
    if not stages or i != len(exs) - 1 or not isinstance(exs[i], Aggregation):
        return None
    return exs[0], pre, stages, exs[i]


def fragment_kind(dag: DAGRequest) -> str | None:
    """Exchange-shape eligibility — "agg" | "join" | None. Delegates to the
    shared gate (parallel/sql.py mesh_eligible: DAG shape + host-only-expr
    refusal), which both the mesh shortcut and the mpp tier consult."""
    from ..parallel.sql import mesh_eligible

    return mesh_eligible(dag)


def fragment_plan(dag: DAGRequest, n_tasks: int) -> FragmentPlan | None:
    """Cut the DAG at its exchange boundaries (fragment.go:116 analog).

    Join shape — per stage i, bottom-up:

        [probe scan frag] --hash(probe key 0)--\\
        [build frag 0]    --hash(build key 0)---> [join frag 0] --hash(...)-> ...
                                ...                [join frag k] --hash(group key)-> [final frag] --passthrough-> root

    Agg shape: [scan+sel+Partial1] --hash(group key)--> [Final] -> root.
    The SAME Aggregation node appears in both agg-boundary fragments: its
    mode (Partial1 vs Final merge) is positional, exactly as the device
    program splits it (grouped.agg_exchange_phases phases 1 and 3)."""
    parts = split_join_dag(dag)
    if parts is not None:
        probe_scan, pre_sels, stages, agg = parts
        frags = []
        n_stages = len(stages)

        def join_frag_idx(i):
            return 2 + 2 * i

        frags.append(Fragment(
            idx=0,
            executors=(probe_scan, *pre_sels),
            receivers=(),
            sender=ExchangeSender(EXCHANGE_HASH, tuple(stages[0][0].probe_keys), join_frag_idx(0)),
        ))
        for i, (join, post_sels) in enumerate(stages):
            frags.append(Fragment(
                idx=2 * i + 1,
                executors=tuple(join.build),
                receivers=(),
                sender=ExchangeSender(EXCHANGE_HASH, tuple(join.build_keys), join_frag_idx(i)),
            ))
            last = i == n_stages - 1
            if last:
                out = ExchangeSender(EXCHANGE_HASH, tuple(agg.group_by), 2 * n_stages + 1)
            else:
                out = ExchangeSender(EXCHANGE_HASH, tuple(stages[i + 1][0].probe_keys), join_frag_idx(i + 1))
            upstream = 0 if i == 0 else join_frag_idx(i - 1)
            frags.append(Fragment(
                idx=join_frag_idx(i),
                executors=(join, *post_sels, *((agg,) if last else ())),
                receivers=(ExchangeReceiver(upstream), ExchangeReceiver(2 * i + 1)),
                sender=out,
            ))
        root_idx = 2 * n_stages + 1
        frags.append(Fragment(
            idx=root_idx,
            executors=(agg,),
            receivers=(ExchangeReceiver(join_frag_idx(n_stages - 1)),),
            sender=ExchangeSender(EXCHANGE_PASSTHROUGH, (), ROOT_COLLECTOR),
        ))
        return FragmentPlan(tuple(frags), n_tasks, root_idx)

    # agg shape: scan [Selection]* Aggregation(GROUP BY)
    exs = dag.executors
    if (len(exs) < 2 or not isinstance(exs[0], TableScan)
            or not isinstance(exs[-1], Aggregation)
            or not all(isinstance(e, Selection) for e in exs[1:-1])):
        return None
    agg = exs[-1]
    if not agg.group_by:
        return None
    frags = (
        Fragment(
            idx=0,
            executors=tuple(exs),
            receivers=(),
            sender=ExchangeSender(EXCHANGE_HASH, tuple(agg.group_by), 1),
        ),
        Fragment(
            idx=1,
            executors=(agg,),
            receivers=(ExchangeReceiver(0),),
            sender=ExchangeSender(EXCHANGE_PASSTHROUGH, (), ROOT_COLLECTOR),
        ),
    )
    return FragmentPlan(frags, n_tasks, 1)

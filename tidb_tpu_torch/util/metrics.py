"""Metrics registry — counters, gauges and histograms per subsystem, plain
and labeled (ref: pkg/metrics Prometheus wrappers; CounterVec/HistogramVec
are the prometheus client_golang vec types). `Registry.dump()` emits the
Prometheus text exposition format v0.0.4 — `# HELP`/`# TYPE` headers,
label sets, and cumulative `_bucket{le="..."}` lines — which the HTTP
status server serves raw at `GET /metrics`.

A copy of the JAX package's tidb_tpu/util/metrics.py (stdlib only): the
port's families carry the same names, so one scrape reads either."""

from __future__ import annotations

import threading
from bisect import bisect_right

_DEFAULT_BUCKETS = (0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0)


def _esc(v) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"')


def _fmt_labels(names: tuple, values: tuple) -> str:
    if not names:
        return ""
    return "{" + ",".join(f'{k}="{_esc(v)}"' for k, v in zip(names, values)) + "}"


def _fmt_value(v) -> str:
    if isinstance(v, float):
        return f"{v:.6f}"
    return str(v)


class Counter:
    __slots__ = ("name", "help", "_v", "_lock", "_labels")

    def __init__(self, name: str, help: str = "", labels: str = ""):
        self.name = name
        self.help = help
        self._v = 0  # guarded_by: _lock
        self._lock = threading.Lock()
        self._labels = labels  # pre-rendered {k="v",...} or ""

    def inc(self, n: int = 1):
        with self._lock:
            self._v += n

    @property
    def value(self) -> int:
        with self._lock:
            return self._v

    def _expose(self) -> list[str]:
        with self._lock:
            v = self._v
        return [f"{self.name}{self._labels} {v}"]


class Gauge:
    """A value that goes up AND down (open txns, cache entries, pool size)."""

    __slots__ = ("name", "help", "_v", "_lock", "_labels")

    def __init__(self, name: str, help: str = "", labels: str = ""):
        self.name = name
        self.help = help
        self._v = 0.0  # guarded_by: _lock
        self._lock = threading.Lock()
        self._labels = labels

    def set(self, v: float):
        with self._lock:
            self._v = v

    def inc(self, n: float = 1):
        with self._lock:
            self._v += n

    def dec(self, n: float = 1):
        with self._lock:
            self._v -= n

    @property
    def value(self) -> float:
        with self._lock:
            return self._v

    def _expose(self) -> list[str]:
        with self._lock:
            v = self._v
        return [f"{self.name}{self._labels} {_fmt_value(int(v) if float(v).is_integer() else v)}"]


class Histogram:
    __slots__ = ("name", "help", "buckets", "_counts", "_sum", "_n", "_lock", "_labels")

    def __init__(self, name: str, help: str = "", buckets=_DEFAULT_BUCKETS, labels: str = ""):
        self.name = name
        self.help = help
        self.buckets = tuple(buckets)
        self._counts = [0] * (len(self.buckets) + 1)  # guarded_by: _lock
        self._sum = 0.0  # guarded_by: _lock
        self._n = 0  # guarded_by: _lock
        self._lock = threading.Lock()
        self._labels = labels

    def observe(self, v: float):
        with self._lock:
            self._counts[bisect_right(self.buckets, v)] += 1
            self._sum += v
            self._n += 1

    @property
    def count(self) -> int:
        with self._lock:
            return self._n

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def _expose(self) -> list[str]:
        """Cumulative bucket lines + sum + count, the histogram exposition
        contract (`le` is inclusive upper bound; +Inf == count)."""
        base = self._labels[1:-1] if self._labels else ""
        lines = []
        with self._lock:
            cum = 0
            for ub, c in zip(self.buckets, self._counts):
                cum += c
                ls = ",".join(x for x in (base, f'le="{ub}"') if x)
                lines.append(f"{self.name}_bucket{{{ls}}} {cum}")
            ls = ",".join(x for x in (base, 'le="+Inf"') if x)
            lines.append(f"{self.name}_bucket{{{ls}}} {self._n}")
            lines.append(f"{self.name}_sum{self._labels} {self._sum:.6f}")
            lines.append(f"{self.name}_count{self._labels} {self._n}")
        return lines


class _Vec:
    """Label-set family sharing one metric name (ref: prometheus *Vec).
    `labels(**kv)` returns (creating once) the child for that label set."""

    _child_cls: type = Counter
    typ = "counter"

    def __init__(self, name: str, help: str = "", labelnames: tuple = (), **kw):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._kw = kw
        self._children: dict[tuple, object] = {}  # guarded_by: _lock
        self._lock = threading.Lock()

    def labels(self, *values, **kv):
        if kv:
            if values:
                raise ValueError("pass label values positionally or by name, not both")
            values = tuple(kv[n] for n in self.labelnames)
        values = tuple(str(v) for v in values)
        if len(values) != len(self.labelnames):
            raise ValueError(f"{self.name} expects labels {self.labelnames}, got {values}")
        with self._lock:
            child = self._children.get(values)
            if child is None:
                child = self._child_cls(
                    self.name, self.help,
                    labels=_fmt_labels(self.labelnames, values), **self._kw,
                )
                self._children[values] = child
            return child

    def _expose(self) -> list[str]:
        with self._lock:
            kids = [self._children[k] for k in sorted(self._children)]
        out: list[str] = []
        for c in kids:
            out.extend(c._expose())
        return out


class CounterVec(_Vec):
    _child_cls = Counter
    typ = "counter"


class GaugeVec(_Vec):
    _child_cls = Gauge
    typ = "gauge"


class HistogramVec(_Vec):
    _child_cls = Histogram
    typ = "histogram"


_TYPE_OF = {Counter: "counter", Gauge: "gauge", Histogram: "histogram"}


class Registry:
    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, object] = {}  # guarded_by: _lock

    def _get_or_make(self, name: str, factory):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = factory()
                self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_make(name, lambda: Counter(name, help))

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_make(name, lambda: Gauge(name, help))

    def histogram(self, name: str, help: str = "", buckets=_DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_make(name, lambda: Histogram(name, help, buckets))

    def counter_vec(self, name: str, help: str = "", labelnames: tuple = ()) -> CounterVec:
        return self._get_or_make(name, lambda: CounterVec(name, help, labelnames))

    def gauge_vec(self, name: str, help: str = "", labelnames: tuple = ()) -> GaugeVec:
        return self._get_or_make(name, lambda: GaugeVec(name, help, labelnames))

    def histogram_vec(self, name: str, help: str = "", labelnames: tuple = (), buckets=_DEFAULT_BUCKETS) -> HistogramVec:
        return self._get_or_make(
            name, lambda: HistogramVec(name, help, labelnames, buckets=buckets)
        )

    def dump(self) -> str:
        """Prometheus text exposition format v0.0.4 (the scrapeable form;
        tools/scrape_check.py validates this output in the test suite)."""
        with self._lock:
            items = sorted(self._metrics.items())
        lines: list[str] = []
        for name, m in items:
            samples = m._expose()
            if not samples and isinstance(m, HistogramVec):
                # a histogram family before its first label set has no
                # `_count`, which the format refuses: leave it out until
                # it has one, as client_golang leaves out an empty vec
                continue
            typ = getattr(m, "typ", None) or _TYPE_OF[type(m)]
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            lines.append(f"# TYPE {name} {typ}")
            lines.extend(samples)
        return "\n".join(lines) + ("\n" if lines else "")

    def sample_lines(self) -> list[tuple[str, str]]:
        """(series-with-labels, value) pairs of every sample — the SHOW
        STATUS / JSON view, comment lines excluded."""
        out = []
        for line in self.dump().splitlines():
            if not line or line.startswith("#"):
                continue
            series, _, value = line.rpartition(" ")
            out.append((series, value))
        return out

    def labeled_samples(self, family: str) -> dict:
        """First-label-value -> numeric sample for one labeled family
        (e.g. "tidb_tpu_replica_read_total" -> {"leader": 3.0, ...}) —
        THE shared parser for bench/chaos-style per-label readouts (three
        call sites used to hand-roll the same sample_lines() split)."""
        out: dict[str, float] = {}
        for series, value in self.sample_lines():
            if series.startswith(family + "{"):
                out[series.split('"')[1]] = float(value)
        return out

    def reset(self):
        with self._lock:
            self._metrics.clear()


REGISTRY = Registry()

# the subsystems' shared instruments (ref: pkg/metrics per-subsystem files)
COP_REQUESTS = REGISTRY.counter("tidb_tpu_cop_requests_total", "coprocessor requests served")
COP_ERRORS = REGISTRY.counter("tidb_tpu_cop_errors_total", "coprocessor requests failed")
COP_FALLBACKS = REGISTRY.counter("tidb_tpu_cop_oracle_fallbacks_total", "cop requests served by the oracle fallback")
COP_CACHE_HITS = REGISTRY.counter("tidb_tpu_cop_cache_hits_total", "cop requests served from the coprocessor result cache")
BATCH_COP_BATCHES = REGISTRY.counter("tidb_tpu_batch_cop_batches_total", "vmapped multi-region coprocessor launches")
BATCH_COP_REGIONS = REGISTRY.counter("tidb_tpu_batch_cop_regions_total", "regions served by batched coprocessor launches")
BATCH_COP_LAUNCHES_SAVED = REGISTRY.counter("tidb_tpu_batch_cop_launches_saved_total", "per-region XLA launches avoided by batching (regions - launches)")
COP_DURATION = REGISTRY.histogram("tidb_tpu_cop_duration_seconds", "coprocessor request latency")
COP_EXECUTOR_ROWS = REGISTRY.counter_vec(
    "tidb_tpu_cop_executor_rows_total", "rows produced per pushed executor",
    labelnames=("executor",),
)
DISTSQL_TASKS = REGISTRY.counter("tidb_tpu_distsql_tasks_total", "per-region cop tasks dispatched")
DISTSQL_STORE_TASKS = REGISTRY.counter_vec(
    "tidb_tpu_distsql_store_tasks_total", "cop tasks dispatched per placement store",
    labelnames=("store",),
)
DISTSQL_TASK_DURATION = REGISTRY.histogram_vec(
    "tidb_tpu_distsql_task_duration_seconds", "per-region cop task latency incl. paging+retries",
    labelnames=("scan",),
)
MESH_SELECTS = REGISTRY.counter("tidb_tpu_mesh_selects_total", "SQL plans executed over the device mesh")
MESH_COP_BATCHES = REGISTRY.counter("tidb_tpu_mesh_cop_batches_total", "shard_map mesh-tier launches (one merged state per launch)")
MESH_COP_LANES = REGISTRY.counter("tidb_tpu_mesh_cop_lanes_total", "region lanes whose partial states were psum-merged on device")
MESH_COP_FALLBACKS = REGISTRY.counter("tidb_tpu_mesh_cop_fallbacks_total", "mesh-tier groups degraded to the vmapped batch tier (overflow/trace failure)")
SPILL_PARTITIONS = REGISTRY.counter("tidb_tpu_spill_partitions_total", "out-of-capacity host-partitioned multi-pass executions (the spill analog)")
MEM_EVICTIONS = REGISTRY.counter("tidb_tpu_mem_evictions_total", "store cache evictions by the OOM action")
MEM_DEGRADED_QUERIES = REGISTRY.counter("tidb_tpu_mem_degraded_total", "queries degraded to the low-memory fold path")
DISTSQL_RETRIES = REGISTRY.counter("tidb_tpu_distsql_region_retries_total", "region-error retries")
BACKOFF_SECONDS = REGISTRY.counter_vec(
    "tidb_tpu_backoff_seconds_total", "dispatch backoff sleep time by error kind",
    labelnames=("kind",),
)
REGION_ERRORS = REGISTRY.counter_vec(
    "tidb_tpu_region_errors_total", "typed region errors seen by dispatch",
    labelnames=("kind",),
)
BREAKER_STATE = REGISTRY.gauge_vec(
    "tidb_tpu_store_breaker_state", "per-store circuit breaker state (0=closed 1=half-open 2=open)",
    labelnames=("store",),
)
BREAKER_TRIPS = REGISTRY.counter_vec(
    "tidb_tpu_store_breaker_trips_total", "circuit-breaker open transitions per store",
    labelnames=("store",),
)
# region replication (tidb_tpu/replication) — replica reads + safe_ts
REPLICA_READS = REGISTRY.counter_vec(
    "tidb_tpu_replica_read_total", "cop tasks served by peer role under tidb_replica_read routing",
    labelnames=("target",),
)
REPLICA_SAFE_TS_LAG = REGISTRY.gauge_vec(
    "tidb_tpu_replica_safe_ts_lag", "worst follower safe_ts lag behind its leader's committed watermark, per store (ts units)",
    labelnames=("store",),
)
REPLICA_QUORUM_FAILS = REGISTRY.counter(
    "tidb_tpu_replica_quorum_fail_total", "write proposals that failed to reach quorum ack")
PROGRAM_COMPILES = REGISTRY.counter("tidb_tpu_program_compiles_total", "fused XLA programs built")
PROGRAM_LAUNCHES = REGISTRY.counter("tidb_tpu_program_launches_total", "fused XLA program executions dispatched (batched counts once)")
PROGRAM_CACHE_HITS = REGISTRY.counter("tidb_tpu_program_cache_hits_total", "program-cache hits (compile skipped)")
PROGRAM_CACHE_ENTRIES = REGISTRY.gauge("tidb_tpu_program_cache_entries", "compiled programs resident in the cache")
PROGRAM_COMPILE_DURATION = REGISTRY.histogram(
    "tidb_tpu_program_compile_seconds", "XLA trace+compile time per program",
    buckets=(0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 30.0),
)
STATEMENTS = REGISTRY.counter_vec(
    "tidb_tpu_statements_total", "statements executed by type and outcome",
    labelnames=("type", "status"),
)
# production front door — digest-keyed plan cache + admission
PLAN_CACHE_HITS = REGISTRY.counter(
    "tidb_tpu_plan_cache_hits_total", "statements served from the digest-keyed plan cache (parse+plan skipped)")
PLAN_CACHE_MISSES = REGISTRY.counter(
    "tidb_tpu_plan_cache_misses_total", "cacheable statements that planned cold and installed an entry")
PLAN_CACHE_EVICTIONS = REGISTRY.counter(
    "tidb_tpu_plan_cache_evictions_total", "plan-cache entries evicted by the LRU capacity bound")
PLAN_CACHE_DECLINES = REGISTRY.counter_vec(
    "tidb_tpu_plan_cache_declines_total", "statements declined by the plan cache, by typed reason",
    labelnames=("reason",),
)
PLAN_CACHE_ENTRIES = REGISTRY.gauge(
    "tidb_tpu_plan_cache_entries", "plan templates resident in the cache")
PLAN_CACHE_SHARED_HITS = REGISTRY.counter(
    "tidb_tpu_plan_cache_shared_hits_total",
    "local-miss lookups served by the shared cross-catalog tier (fingerprint-revalidated)")
ADMISSION_ADMITTED = REGISTRY.counter(
    "tidb_tpu_admission_admitted_total", "statements admitted through the bounded statement gate")
ADMISSION_SHED = REGISTRY.counter_vec(
    "tidb_tpu_admission_shed_total", "statements shed with typed ServerIsBusy backpressure, by gate",
    labelnames=("where",),
)
ADMISSION_QUEUE_WAITS = REGISTRY.counter(
    "tidb_tpu_admission_queue_waits_total", "statements that waited in a per-session admission queue")
ADMISSION_INFLIGHT = REGISTRY.gauge(
    "tidb_tpu_admission_inflight", "statements currently executing inside the admission gate")
# cross-session fused execution — the per-store session
# coalescer: point-get micro-batch windows + group-commit write batching
COALESCE_BATCHES = REGISTRY.counter(
    "tidb_tpu_coalesce_batches_total", "coalescer micro-batch windows flushed (read launches + write group commits)")
COALESCE_LANES = REGISTRY.counter_vec(
    "tidb_tpu_coalesce_lanes_total", "session lanes served through a coalesced window, by kind",
    labelnames=("kind",),
)
COALESCE_LAUNCHES_SAVED = REGISTRY.counter(
    "tidb_tpu_coalesce_launches_saved_total", "device launches avoided by cross-session point-get coalescing (lanes - launches)")
COALESCE_FALLBACKS = REGISTRY.counter_vec(
    "tidb_tpu_coalesce_fallbacks_total", "lanes that fell out of a window to the single path, by typed reason",
    labelnames=("reason",),
)
COALESCE_GROUP_COMMITS = REGISTRY.counter(
    "tidb_tpu_coalesce_group_commits_total", "write lanes committed through a group-commit window")
COALESCE_GROUP_PROPOSALS_SAVED = REGISTRY.counter(
    "tidb_tpu_coalesce_group_proposals_saved_total", "quorum proposals avoided by folding lanes into per-region group proposals")
COALESCE_WINDOW_WAIT = REGISTRY.histogram(
    "tidb_tpu_coalesce_window_wait_seconds", "time a lane parked in the coalescer window before flush",
    buckets=(0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.05),
)
OPEN_TXNS = REGISTRY.gauge("tidb_tpu_open_txns", "transactions currently open")
NATIVE_DECODES = REGISTRY.counter("tidb_tpu_native_decode_batches_total", "region batches decoded by the C++ rowcodec")
NATIVE_DECODE_FALLBACKS = REGISTRY.counter("tidb_tpu_native_decode_fallbacks_total", "native decode errors served by the python decoder")

# change data capture (tidb_tpu/cdc) — the TiCDC-analog changefeed
# families (ref: ticdc_* metrics: puller/sorter event counts, the
# checkpoint/resolved lag gauges, sink flush histograms)
CDC_EVENTS = REGISTRY.counter(
    "tidb_tpu_cdc_events_total", "raw change entries captured from the replication log (live + recovery scans)")
CDC_EVENTS_EMITTED = REGISTRY.counter(
    "tidb_tpu_cdc_events_emitted_total", "mounted row events emitted to changefeed sinks")
CDC_EVENTS_SKIPPED = REGISTRY.counter(
    "tidb_tpu_cdc_events_skipped_total", "captured entries skipped at mount (index entries, meta keys, unknown tables)")
CDC_RESOLVED_LAG = REGISTRY.gauge_vec(
    "tidb_tpu_cdc_resolved_ts_lag", "latest commit watermark minus the changefeed's emitted resolved frontier (ts units)",
    labelnames=("changefeed",),
)
CDC_SINK_FLUSH = REGISTRY.histogram(
    "tidb_tpu_cdc_sink_flush_seconds", "sink write+flush latency per changefeed tick")
CDC_RECOVERY_SCANS = REGISTRY.counter(
    "tidb_tpu_cdc_recovery_scans_total", "incremental re-scans after a lost subscription, pause resume, or changefeed birth")
CDC_SCHEMA_EVENTS = REGISTRY.counter(
    "tidb_tpu_cdc_schema_events_total", "schema-change entries replicated through changefeeds as ordered DDL events")
CDC_SCHEMA_DRIFT_LEGACY = REGISTRY.counter(
    "tidb_tpu_cdc_schema_drift_legacy_total", "rows the tracked snapshot could not decode, re-decoded against the live catalog (the counted legacy drift fallback)")

# HTAP columnar replica (tidb_tpu/columnar) — the TiFlash-analog tier
# (ref: tiflash_* metrics: apply throughput, delta compaction counts, the
# replica freshness gauges)
COLUMNAR_APPLIED = REGISTRY.counter(
    "tidb_tpu_columnar_applied_events_total", "mounted row events applied into columnar delta layers")
COLUMNAR_COMPACTIONS = REGISTRY.counter(
    "tidb_tpu_columnar_compactions_total", "delta-to-stable compaction passes that folded rows")
COLUMNAR_SCANS = REGISTRY.counter(
    "tidb_tpu_columnar_scans_total", "analytical queries served by the columnar replica")
COLUMNAR_FALLBACKS = REGISTRY.counter(
    "tidb_tpu_columnar_fallbacks_total", "engine-routed queries that fell back to the row store (frontier lag, floored snapshot, schema drift)")
COLUMNAR_RESOLVED_LAG = REGISTRY.gauge_vec(
    "tidb_tpu_columnar_resolved_ts_lag", "latest commit watermark minus the replica's applied resolved frontier, per table (ts units)",
    labelnames=("table",),
)
COLUMNAR_RESHAPES = REGISTRY.counter(
    "tidb_tpu_columnar_reshapes_total", "mid-feed ALTERs applied to columnar replicas by col_id remap (zero parks)")

# point-in-time recovery (tidb_tpu/br) — the log-backup stream
# and replay-to-ts restore families (ref: BR's br_log_backup_* /
# tikv_log_backup_* checkpoint and flush metrics)
LOG_BACKUP_SEGMENTS = REGISTRY.counter(
    "tidb_tpu_log_backup_segments_total", "atomic log-backup segments committed (write-temp + fsync + rename)")
LOG_BACKUP_EVENTS = REGISTRY.counter(
    "tidb_tpu_log_backup_events_total", "raw KV change records persisted into log-backup segments")
LOG_BACKUP_CHECKPOINT_TS = REGISTRY.gauge_vec(
    "tidb_tpu_log_backup_checkpoint_ts", "the log backup's durable manifest checkpoint (every commit at or below it is restorable)",
    labelnames=("changefeed",),
)
LOG_BACKUP_LAG = REGISTRY.gauge_vec(
    "tidb_tpu_log_backup_resolved_lag", "latest commit watermark minus the log backup's durable checkpoint (ts units)",
    labelnames=("changefeed",),
)
PITR_RESTORES = REGISTRY.counter(
    "tidb_tpu_pitr_restores_total", "RESTORE ... UNTIL TS runs that completed (full backup + log replay)")
PITR_SEGMENTS_REPLAYED = REGISTRY.counter(
    "tidb_tpu_pitr_segments_replayed_total", "log segments replayed into a restore target")
PITR_REPLAYED_EVENTS = REGISTRY.counter(
    "tidb_tpu_pitr_replayed_events_total", "KV and schema records applied during log replay")
PITR_LOG_GAPS = REGISTRY.counter(
    "tidb_tpu_pitr_log_gaps_total", "restores refused with a typed LogGapError (missing/corrupt segment, broken chain, short log)")
PITR_REPLAY_RESUMES = REGISTRY.counter(
    "tidb_tpu_pitr_replay_resumes_total", "restores that resumed from a per-segment checkpoint after a mid-replay crash")

# mpp exchange data plane (ref: tiflash_coprocessor_* mpp task
# metrics and the mpp_gather dispatch counters)
MPP_SELECTS = REGISTRY.counter(
    "tidb_tpu_mpp_selects_total", "SQL plans executed through the mpp exchange tier")
MPP_FRAGMENTS = REGISTRY.counter(
    "tidb_tpu_mpp_fragments_total", "plan fragments cut at exchange boundaries by the fragment planner")
MPP_TASKS = REGISTRY.counter(
    "tidb_tpu_mpp_tasks_total", "SPMD fragment tasks dispatched (fragments x mesh width)")
MPP_FALLBACKS = REGISTRY.counter(
    "tidb_tpu_mpp_fallbacks_total", "mpp-eligible plans that fell back (dispatch lost, exchange stall, overflow ladder exhausted, stack refusal)")
MPP_EXCHANGED_BYTES = REGISTRY.counter(
    "tidb_tpu_mpp_exchanged_bytes_total", "bytes entering the all_to_all exchange (probe + build sides, pre-partition)")

# placement driver (tidb_tpu/pd) — its own pd_ namespace, like the
# reference PD process exposing pd_scheduler_*/pd_hotspot_* families
PD_REGION_HEARTBEATS = REGISTRY.counter("pd_region_heartbeat_total", "region heartbeat snapshots absorbed by the PD")
PD_OPERATORS = REGISTRY.counter_vec(
    "pd_operator_total", "operators admitted to the PD queue by type",
    labelnames=("type",),
)
PD_OPERATOR_TIMEOUTS = REGISTRY.counter("pd_operator_timeout_total", "pending operators expired before dispatch")
PD_OPERATOR_PENDING = REGISTRY.gauge("pd_operator_pending", "operators waiting in the PD queue")
PD_HOT_REGION = REGISTRY.gauge_vec(
    "pd_hot_region", "hot regions (read or write) placed on each store",
    labelnames=("store",),
)
PD_STORE_REGIONS = REGISTRY.gauge_vec(
    "pd_store_regions", "regions placed on each store",
    labelnames=("store",),
)
PD_REGIONS = REGISTRY.gauge("pd_regions", "regions in the cluster")
PD_PLACEMENT_DECISIONS = REGISTRY.counter("pd_placement_decision_total", "placement-map misses resolved by a PD least-loaded decision")
PD_FAILOVERS = REGISTRY.counter("pd_failover_total", "regions failed over off a sick store (leader transfer or placement move)")
PD_TRANSFER_LEADER = REGISTRY.counter("pd_transfer_leader_total", "region leaderships transferred between peers")
PD_TICK_DURATION = REGISTRY.histogram("pd_tick_seconds", "PD scheduling tick latency")

# Top SQL resource attribution (tidb_tpu/topsql) — ref: the
# tidb_topsql_* families of pkg/util/topsql/reporter. Time counters stay
# in the ledger's native integer units (ns / ms) so the exposition
# reconciles EXACTLY against the window sums the API serves — converting
# to seconds would make the cross-surface consistency check float-fuzzy.
TOPSQL_RECORDS = REGISTRY.counter(
    "tidb_tpu_topsql_records_total", "finished statements folded into the Top SQL ledger")
TOPSQL_CPU_NS = REGISTRY.counter(
    "tidb_tpu_topsql_cpu_ns_total", "host thread-CPU ns attributed to tagged statements")
TOPSQL_DEVICE_NS = REGISTRY.counter(
    "tidb_tpu_topsql_device_ns_total", "fused-program device ns attributed to tagged statements")
TOPSQL_COMPILE_NS = REGISTRY.counter(
    "tidb_tpu_topsql_compile_ns_total", "program compile ns attributed to tagged statements")
TOPSQL_BACKOFF_MS = REGISTRY.counter(
    "tidb_tpu_topsql_backoff_ms_total", "Backoffer sleep ms attributed to tagged statements")
TOPSQL_QUEUE_MS = REGISTRY.counter(
    "tidb_tpu_topsql_queue_ms_total", "admission queue wait ms attributed to tagged statements")
TOPSQL_LAUNCH_DEVICE_NS = REGISTRY.counter(
    "tidb_tpu_topsql_launch_device_ns_total", "total device ns of launches that ran under a statement tag (the conservation ledger)")
TOPSQL_WINDOWS_SEALED = REGISTRY.counter(
    "tidb_tpu_topsql_windows_sealed_total", "Top SQL reporter windows sealed into the ring")
TOPSQL_OTHERS_FOLDED = REGISTRY.counter(
    "tidb_tpu_topsql_others_folded_total", "digests folded into a window's (others) row at seal time")
TOPSQL_LIVE_DIGESTS = REGISTRY.gauge(
    "tidb_tpu_topsql_live_digests", "distinct digests in the live (unsealed) window")
TOPSQL_CLASS_DECISIONS = REGISTRY.counter_vec(
    "tidb_tpu_topsql_class_admissions_total", "cost-classed admission decisions by class",
    labelnames=("cost_class", "decision"),
)

"""`failpoints` — failpoint cross-reference checking + catalog generation
for the PyTorch port (copy of `tidb_tpu/analysis/failpoints.py`).

A failpoint armed under a typo'd name silently never fires — the test
that "exercises" a fault path then passes by exercising nothing (the
reference avoids this with compile-time failpoint rewriting; a runtime
registry has no such guard). Statically:

  * every `failpoint.enable/enabled/disable("name")` in the port's tests
    (`tests/test_torch_*.py`, `tests/torch_sql_parity.py`), its tools
    (`tidb_tpu_torch/tools/`) and `chip_smoke.py` must reference a SITE —
    a `failpoint.eval/is_armed/peek("name")` call — defined in
    `tidb_tpu_torch/` (or in the same file, for self-contained failpoint
    unit tests);
  * every site defined in `tidb_tpu_torch/` must carry a one-line
    description in DESCRIPTIONS below — that's what makes the generated
    catalog complete by construction.

Directories whose path holds `vet_fixtures` (true-positive corpora) are
never scanned by the live run.
"""

from __future__ import annotations

import glob
import os
import re

from .common import REPO, Finding

PASS = "failpoints"
PKG = "tidb_tpu_torch"

# one line per failpoint: what arming it injects (the catalog body)
DESCRIPTIONS = {
    "cop-region-error": "injects `epoch_not_match` at the coprocessor RPC seam — exercises the re-split retry path",
    "cop-other-error": "injects a non-retryable `other_error` cop response — surfaces as CopInternalError / MySQL 1105",
    "cop-debug-raise": "re-raises store-side execution errors with a stack instead of folding them into `other_error`",
    "distsql.before_task": "hook before every cop-task send — tests raise or count here to probe the dispatch loop",
    "ddl_index_delete_only": "pauses online index DDL in the delete-only state so tests can write concurrently",
    "ddl_index_write_only": "pauses online index DDL in the write-only state",
    "ddl_index_write_reorg": "pauses online index DDL in the write-reorg (backfill) state",
    "cdc/puller-drop": "drops a changefeed's live log deliveries — the span is marked lost and recovered by an incremental scan from the checkpoint at the next tick (the TiCDC re-subscribe path); nothing is lost, only late",
    "cdc/resolved-stuck": "pins every changefeed's resolved-ts watermarks — the frontier stops advancing (and the checkpoint with it) until disarmed; emission stays gated so downstream still only sees complete prefixes",
    "cdc/sink-stall": "skips a tick's sink emission — the sorter keeps the backlog and the emitted checkpoint holds until the stall clears",
    "columnar/apply-stall": "wedges the columnar replica's apply sink — the feeding changefeed parks in `error` with the backlog re-queued below its held checkpoint; RESUME (ColumnarReplica.resume_all) replays it, absorbed by the idempotent delta fold",
    "columnar/compact-stall": "skips the pd.columnar tick's delta-to-stable compaction — delta layers grow and the stable floor stops advancing; scans keep serving through the delta overlay",
    "mpp/dispatch-lost": "loses an MPP task dispatch before launch — the coordinator abandons the fragment run as a counted fallback (MPP_FALLBACKS) and the statement re-dispatches on the non-MPP tiers, byte-identically",
    "mpp/exchange-stall": "stalls the fragment exchange mid-run — the coordinator abandons the MPP attempt after sourcing the probe scan; a counted fallback, never a torn result",
    "server/admission-full": "forces the admission gate's saturated answer — every statement/dispatch arriving at an armed gate sheds as typed ServerIsBusy{backoff_ms} without consuming a slot, so tests exercise backpressure without real load",
    "pd/heartbeat-lost": "drops one tick's region-heartbeat interval on the floor (a lost heartbeat stream)",
    "pd/operator-timeout": "force-expires every pending PD operator at the next tick's dispatch phase",
    "replica/apply-lag": "wedges armed follower stores' apply loop — their safe_ts stops advancing, so replica reads at newer snapshots answer DataIsNotReady until disarmed (per-store arming)",
    "replica/drop-ack": "drops armed follower stores' replication acks — proposals count quorum without them, and losing quorum flips the group to quorum_lost (placement-move failover)",
    "store/not-leader": "injects a typed NotLeader region error for requests to armed stores (True/set/dict arming)",
    "store/transfer-leader-timeout": "times out leader-transfer attempts (breaker failover and the PD transfer-leader operator) — the operator retires as timeout and the caller backs off",
    "store/server-busy": "injects ServerIsBusy with an optional `backoff_ms` suggestion for armed stores",
    "store/unreachable": "injects StoreUnavailable for armed stores and fails their liveness probe (ping_store)",
    "coalesce/window-stall": "wedges the coalescer window's leader past its deadline (arm with a float to choose the hold seconds) — followers outwait their patience, withdraw their unclaimed lanes, and fall back to the single path as counted `window_stall` fallbacks",
    "coalesce/flush-lost": "loses a coalescer window's flush before any lane is answered — every lane falls out as a counted `flush_lost` fallback and re-runs its single path; no statement is lost, none launches twice",
    "cdc/segment-crash": "kills a segment flush between the tmp write and the rename (typed SinkError, tmp left behind) — the kill-mid-flush drill: consumers must see only whole renamed-in segments, and the feed re-queues the window for exactly-once redelivery",
    "restore/replay-crash": "raises typed ReplayInterrupted right after a replayed segment's checkpoint write — a re-run of the same RESTORE ... UNTIL TS resumes past every already-applied segment (counted PITR_REPLAY_RESUMES)",
    "br/log-gap": "drops the middle entry from the log-backup manifest as restore reads it — the coverage chain breaks and the restore MUST fail as typed LogGapError, never a silently-short cluster",
}

_SITE = re.compile(r"""(?:failpoint|_fp|fp)\s*\.\s*(?:eval|is_armed|peek)\(\s*["']([^"']+)["']""")
_USE = re.compile(r"""(?:failpoint|_fp|fp)\s*\.\s*(?:enable|enabled|disable)\(\s*["']([^"']+)["']""")


def _py_files(*rel_dirs: str):
    for rel in rel_dirs:
        root = os.path.join(REPO, rel)
        if os.path.isfile(root):
            yield root
            continue
        for dirpath, _dirs, files in os.walk(root):
            if "vet_fixtures" in dirpath:
                continue  # true-positive corpora are scanned EXPLICITLY by
                # their tests, never by the live-tree run
            for f in sorted(files):
                if f.endswith(".py"):
                    yield os.path.join(dirpath, f)


def _use_files():
    """The port's arming sites: its tests, its tools and chip_smoke.py
    (never the JAX package's tests, which arm the JAX package's sites)."""
    tests = sorted(glob.glob(os.path.join(REPO, "tests", "test_torch_*.py")))
    tests.append(os.path.join(REPO, "tests", "torch_sql_parity.py"))
    out = [p for p in tests if os.path.isfile(p)]
    out += list(_py_files(os.path.join(PKG, "tools"), "chip_smoke.py"))
    return out


def _scan(pattern: re.Pattern, paths) -> dict[str, list[str]]:
    """name -> ["relpath:line", ...] for every match of `pattern`."""
    out: dict[str, list[str]] = {}
    for path in paths:
        rel = os.path.relpath(path, REPO)
        try:
            text = open(path, encoding="utf-8").read()
        except OSError:
            continue
        for ln, line in enumerate(text.splitlines(), 1):
            for m in pattern.finditer(line):
                out.setdefault(m.group(1), []).append(f"{rel}:{ln}")
    return out


def check() -> tuple[list[str], dict[str, list[str]]]:
    """Returns (errors, defined-sites). Sites defined under
    tidb_tpu_torch/ are the catalog; uses elsewhere must name one of them
    OR a site defined in the SAME file (self-contained failpoint unit
    tests)."""
    findings, sites = analyze()
    return [f.message for f in findings], sites


def _loc(where: str) -> tuple[str, int]:
    rel, _, ln = where.rpartition(":")
    return rel, int(ln)


def _unresolved_uses(sites: dict, uses: dict, local_sites: dict) -> list:
    """Findings for armed names no tidb_tpu_torch/ (or same-file) site defines."""
    findings: list = []
    for name, where in sorted(uses.items()):
        if name in sites:
            continue
        local = {w.split(":")[0] for w in local_sites.get(name, ())}
        missing = [w for w in where if w.split(":")[0] not in local]
        if missing:
            rel, ln = _loc(missing[0])
            findings.append(Finding(
                rel, ln, PASS,
                f"failpoint {name!r} armed at {', '.join(missing)} but no "
                f"eval/is_armed/peek site defines it under {PKG}/ — it can never fire"))
    return findings


def analyze() -> tuple[list, dict[str, list[str]]]:
    """Finding-shaped variant of check() for the vet driver."""
    sites = _scan(_SITE, _py_files(PKG))
    use_files = _use_files()
    uses = _scan(_USE, use_files)
    local_sites = _scan(_SITE, use_files)
    findings = _unresolved_uses(sites, uses, local_sites)
    for name in sorted(sites):
        if name not in DESCRIPTIONS:
            rel, ln = _loc(sites[name][0])
            findings.append(Finding(
                rel, ln, PASS,
                f"failpoint {name!r} (defined at {sites[name][0]}) has no entry in "
                f"{PKG}/analysis/failpoints.py DESCRIPTIONS — add one line so the "
                f"catalog stays complete"))
    return findings, sites


def run(files=None) -> list:
    """Vet-pass entry point. With no `files` the pass owns its scoping
    (sites in tidb_tpu_torch/, uses in the port's tests, tools and
    chip_smoke.py); with an explicit
    list (the vet CLI's --files mode) the GIVEN files' arms are checked
    against the live tree's sites — a fixture corpus must report, not
    silently fall back to a clean full-tree scan."""
    if not files:
        return analyze()[0]
    sites = _scan(_SITE, _py_files(PKG))
    paths = [sf.path for sf in files]
    return _unresolved_uses(sites, _scan(_USE, paths), _scan(_SITE, paths))


def write_catalog(sites: dict[str, list[str]], path: str) -> None:
    lines = [
        "# Failpoint catalog",
        "",
        "Generated by `tidb_tpu_torch.analysis.failpoints.write_catalog` — every",
        "`failpoint.eval/is_armed/peek` site in `tidb_tpu_torch/` and what arming it",
        "injects. Arm with `failpoint.enable(name, value)` (bool = always, int =",
        "fire-N-times, set/dict = per-store arming for `store/*` points, a",
        "ZERO-arg callable returning any of those shapes = custom per-hit",
        "logic); disarm with `failpoint.disable(name)`.",
        "",
        "| failpoint | injection sites | injects |",
        "|---|---|---|",
    ]
    for name in sorted(sites):
        where = ", ".join(f"`{w}`" for w in sites[name])
        lines.append(f"| `{name}` | {where} | {DESCRIPTIONS.get(name, '')} |")
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")

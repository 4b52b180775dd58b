"""The port's vet driver — run tidb_tpu_torch's static-analysis suite and
its program auditor, and fail on any finding (the counterpart of the JAX
package's `tools/vet.py`).

Usage:
    python -m tidb_tpu_torch.tools.vet                  # human output, exit 1 on findings
    python -m tidb_tpu_torch.tools.vet --json           # machine output (stable, sorted —
                                                        # diffable across commits)
    python -m tidb_tpu_torch.tools.vet --only PASS      # one pass (repeatable; globs ok:
                                                        # --only 'dataflow-*')
    python -m tidb_tpu_torch.tools.vet --files F..      # run every pass over exactly these
                                                        # files (fixture corpora)
    python -m tidb_tpu_torch.tools.vet --baseline FILE  # write current findings to FILE
                                                        # (stable sorted JSON), exit 0
    python -m tidb_tpu_torch.tools.vet --diff FILE      # compare against a baseline: print
                                                        # {"new": [...], "fixed": [...]},
                                                        # exit 1 only on NEW findings
    python -m tidb_tpu_torch.tools.vet --list           # pass catalog
    python -m tidb_tpu_torch.tools.vet --device cpu     # run prog-audit's catalog on the
                                                        # CPU (default: cuda, which raises
                                                        # without a card)

Exit codes: 0 clean, 1 on findings (or new findings under --diff), 2 on
an unusable baseline or an unknown pass. Passes live in
tidb_tpu_torch/analysis/. Results cache per file revision in
.vet_cache_torch.json; suppress a finding with `# vet: ignore[<pass>]` on
(or just above) the flagged line — the `suppressions` pass flags markers
that no longer suppress anything.
"""

from __future__ import annotations

import fnmatch
import json
import os
import sys
from collections import Counter

_VALUE_FLAGS = ("--baseline", "--diff", "--only", "--device")


def _flag_value(argv: list[str], flag: str) -> str | None:
    if flag in argv:
        i = argv.index(flag)
        if i + 1 < len(argv):
            return argv[i + 1]
    return None


def _expand_only(argv: list[str], names) -> tuple[list[str], list[str]]:
    """--only values (repeatable, glob-capable) -> (matched, unknown)."""
    pats = [argv[i + 1] for i, a in enumerate(argv)
            if a == "--only" and i + 1 < len(argv)]
    matched: list[str] = []
    unknown: list[str] = []
    for p in pats:
        hits = [n for n in names if fnmatch.fnmatch(n, p)]
        if hits:
            matched.extend(h for h in hits if h not in matched)
        else:
            unknown.append(p)
    return matched, unknown


def _diff_key(d: dict) -> tuple:
    # line-agnostic: pure line drift between commits is not a new finding
    return (d["path"], d["pass"], d["message"])


def _diff_sets(base: list, cur: list) -> tuple[list, list]:
    """Multiset comparison: a SECOND instance of an identical defect in
    the same file is a new finding even though its key already exists
    (a plain set-diff would wave it through the gate)."""
    base_n = Counter(_diff_key(d) for d in base)
    cur_n = Counter(_diff_key(d) for d in cur)
    new: list = []
    seen: Counter = Counter()
    for d in cur:
        k = _diff_key(d)
        seen[k] += 1
        if seen[k] > base_n.get(k, 0):
            new.append(d)
    fixed: list = []
    seen = Counter()
    for d in base:
        k = _diff_key(d)
        seen[k] += 1
        if seen[k] > cur_n.get(k, 0):
            fixed.append(d)
    return sorted(new, key=_diff_key), sorted(fixed, key=_diff_key)


def _input_files(argv: list[str]) -> list[str]:
    """The paths after --files; value flags and their arguments are NOT
    input files (`--files a.py --baseline out.json` must not analyze the
    baseline JSON as source)."""
    consumed: set = set()
    for flag in _VALUE_FLAGS:
        for i, a in enumerate(argv):
            if a == flag:
                consumed.update((i, i + 1))
    start = argv.index("--files") + 1
    return [a for i, a in enumerate(argv[start:], start) if not a.startswith("--") and i not in consumed]


def main(argv: list[str]) -> int:
    from tidb_tpu_torch import analysis

    if "--list" in argv:
        for name, spec in analysis.PASSES.items():
            scope = ", ".join(spec.roots) if spec.roots else "(self-scoped)"
            print(f"{name:22s} {scope}")
        print(f"{analysis.SUPPRESSIONS:22s} (stale-marker / KNOWN audit; --only runs the full suite)")
        return 0
    only, unknown = _expand_only(argv, list(analysis.PASSES) + [analysis.SUPPRESSIONS])
    if unknown:
        print(f"unknown pass(es): {', '.join(unknown)} — see --list", file=sys.stderr)
        return 2
    device = _flag_value(argv, "--device") or "cuda"
    if "--files" in argv:
        from tidb_tpu_torch.analysis.common import load_files

        files = load_files(os.path.abspath(p) for p in _input_files(argv))
        findings = []
        for p in (only or list(analysis.PASSES)):
            findings.extend(analysis.run_pass(p, files))
        findings.sort(key=lambda f: (f.path, f.line, f.passname))
    elif only and analysis.SUPPRESSIONS in only:
        # the stale-marker audit needs every other pass's verdict: run
        # the full suite and keep the selected passes' findings
        keep = set(only)
        findings = [f for f in analysis.run_all(device=device) if f.passname in keep]
    elif only:
        findings = analysis.run_only(only, device=device)
    else:
        findings = analysis.run_all(device=device)

    dicts = [f.to_dict() for f in findings]
    baseline_path = _flag_value(argv, "--baseline")
    if baseline_path is not None:
        with open(baseline_path, "w", encoding="utf-8") as fh:
            json.dump(dicts, fh, indent=2, sort_keys=True)
            fh.write("\n")
        print(f"baseline: {len(dicts)} finding(s) -> {baseline_path}")
        return 0
    diff_path = _flag_value(argv, "--diff")
    if diff_path is not None:
        try:
            with open(diff_path, encoding="utf-8") as fh:
                base = json.load(fh)
            if not isinstance(base, list):
                raise ValueError("baseline must be a JSON array of findings")
        except (OSError, ValueError) as exc:
            # a missing/corrupt baseline must be distinguishable from
            # "new findings found" (exit 1) — callers branch on it
            print(f"unusable baseline {diff_path!r}: {exc}", file=sys.stderr)
            return 2
        new, fixed = _diff_sets(base, dicts)
        print(json.dumps({"new": new, "fixed": fixed}, indent=2, sort_keys=True))
        return 1 if new else 0
    if "--json" in argv:
        print(json.dumps(dicts, indent=2))
    else:
        for f in findings:
            print(f.render(), file=sys.stderr)
        if not findings:
            ran = ", ".join(only) if only else ", ".join(analysis.ALL_PASS_NAMES)
            print(f"ok: 0 findings ({ran})")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

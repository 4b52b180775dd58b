"""`suppressions` — stale-suppression audit:
a `# vet: ignore[<pass>]` marker that no longer suppresses a live
finding is rot. The code it excused was fixed or rewritten, but the
marker keeps silencing the pass for whatever lands on that line next —
exactly how a real regression ships under a years-old waiver. Nothing
noticed until now; this pass does.

Runs only from the full-suite driver (`run_all` / the vet CLI without
`--only`): a marker is judged stale only when the pass it names actually
RAN over its file and produced nothing for it to suppress. A marker
naming an unknown pass is always a finding — it can never suppress
anything.

The same audit covers prog-audit's KNOWN table (analysis/progaudit.py): an
entry that excused no live finding in a run of the auditor is stale too.

Copy of `tidb_tpu/analysis/suppress_audit.py` for the PyTorch port.
"""

from __future__ import annotations

from .common import Finding

PASS = "suppressions"


def audit(files, used_markers: set, ran_passes: set, known_passes: set) -> list:
    """`used_markers` = {(rel, marker_line, passname)} recorded by the
    suppression filter; any ignore marker in `files` not in that set —
    for a pass that ran — is stale."""
    findings: list = []
    for sf in files:
        for line, names in sf.ignore_markers():
            for name in names:
                if name == PASS:
                    continue  # suppressing the auditor itself is meta-rot,
                    # but flagging it would make the marker unfixable
                if name not in known_passes:
                    findings.append(Finding(
                        sf.rel, line, PASS,
                        f"suppression names unknown pass {name!r} — it can never "
                        f"suppress anything (see `python -m tidb_tpu_torch.tools.vet --list`)"))
                    continue
                if name not in ran_passes:
                    continue  # pass didn't run this invocation: no verdict
                if (sf.rel, line, name) not in used_markers:
                    findings.append(Finding(
                        sf.rel, line, PASS,
                        f"stale suppression: `vet: ignore[{name}]` no longer "
                        f"suppresses any finding here — the excused code is gone; "
                        f"remove the marker before it silences the next regression"))
    return findings

"""dynlint over the port — project-native static analysis (counterpart of
scripts/dynlint.py).

Pure-AST, stdlib-only (no torch import): safe and fast as a tier-1 gate.

Usage::

    python -m dynamo_tpu_torch.scripts.dynlint --check            # the gate
    python -m dynamo_tpu_torch.scripts.dynlint --write-baseline   # re-record debt
    python -m dynamo_tpu_torch.scripts.dynlint --knob-table       # KNOBS.md
    python -m dynamo_tpu_torch.scripts.dynlint --list             # findings, no gate

``--check`` compares findings against ANALYSIS_BASELINE_CUDA.json (the
ratchet): exit 1 on any NEW finding (not in the baseline) or any STALE
baseline entry (debt that no longer exists must be re-recorded so the
baseline only shrinks deliberately).  It also writes
ANALYSIS_SUMMARY_CUDA.json — per-pass finding and suppression counts.

``--knob-table`` prints the port's knob page (``dynamo_tpu_torch/KNOBS.md``
is its output, section by section); ``--knob-table SECTION`` one section's
table.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from dynamo_tpu_torch import analysis
from dynamo_tpu_torch.analysis import core

REPO_ROOT = Path(__file__).resolve().parents[2]


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--check", action="store_true",
                        help="gate mode: fail on new/stale findings vs the baseline")
    parser.add_argument("--list", action="store_true",
                        help="print all current findings (no baseline compare)")
    parser.add_argument("--write-baseline", action="store_true",
                        help="record the current findings as the accepted baseline")
    parser.add_argument("--knob-table", nargs="?", const="all", default=None,
                        metavar="SECTION",
                        help="print the port's knob page (markdown); optional "
                             "section filter, e.g. observability")
    parser.add_argument("--passes", default=None,
                        help="comma-separated pass subset (default: all)")
    parser.add_argument("--baseline", default=str(REPO_ROOT / core.BASELINE_NAME))
    parser.add_argument("--summary", default=str(REPO_ROOT / core.SUMMARY_NAME))
    parser.add_argument("roots", nargs="*", default=list(analysis.DEFAULT_ROOTS),
                        help="directories/files to scan (default: dynamo_tpu_torch)")
    args = parser.parse_args(argv)

    if args.knob_table is not None:
        from dynamo_tpu_torch.utils import knobs  # stdlib-only module; no torch

        if args.knob_table == "all":
            print(knobs.knob_page(), end="")
        else:
            print(knobs.knob_table(args.knob_table))
        return 0

    passes = tuple(args.passes.split(",")) if args.passes else None
    findings, summary = analysis.analyze(
        REPO_ROOT, roots=tuple(args.roots), passes=passes
    )

    if args.write_baseline:
        core.write_baseline(Path(args.baseline), findings)
        print(f"wrote {args.baseline} ({len(findings)} finding(s) accepted as debt)")
        return 0

    if args.list or not args.check:
        for f in findings:
            print(f.render())
        print(f"\n{len(findings)} finding(s), {summary['suppressed']} suppressed; "
              f"per pass: {summary['per_pass']}")
        return 0 if not args.check else (1 if findings else 0)

    # --check: the ratchet
    baseline = core.load_baseline(Path(args.baseline))
    new, stale = core.diff_baseline(findings, baseline)
    summary["baselined"] = len(findings) - len(new)
    summary["new"] = len(new)
    summary["stale_baseline_entries"] = len(stale)
    Path(args.summary).write_text(json.dumps(summary, indent=2) + "\n")

    if new:
        print(f"dynlint: {len(new)} NEW finding(s) not in {Path(args.baseline).name}:")
        for f in new:
            print(f"  {f.render()}")
    if stale:
        print(f"dynlint: {len(stale)} STALE baseline entr(ies) — the debt they "
              "recorded no longer exists.  Re-record with --write-baseline:")
        for key in stale:
            print(f"  {key}")
    if new or stale:
        return 1
    print(f"dynlint: clean — {summary['files_scanned']} files, "
          f"{len(findings)} finding(s) all baselined, "
          f"{summary['suppressed']} suppressed; per pass: {summary['per_pass']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

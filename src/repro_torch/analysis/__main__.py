"""CLI: ``python -m repro_torch.analysis --check <path> [...]``.

Runs the effect-protocol lint over every ``*.py`` under the given
paths (default: the installed ``repro`` package sources), emits the
findings as JSON on stdout, and exits non-zero if any finding is not
grandfathered by the baseline.

Baseline workflow::

    python -m repro_torch.analysis --check src                  # gate (CI)
    python -m repro_torch.analysis --check src --write-baseline # grandfather
    python -m repro_torch.analysis --explain                    # rule list

The baseline default is ``analysis-baseline.json`` in the current
directory (the repo checks in an empty one: the shipped tree has zero
grandfathered findings, and the file documents the workflow).
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from repro_torch.analysis.effects import ALL_RULES, lint_file, lint_tree
from repro_torch.analysis.findings import load_baseline, new_findings, write_baseline

DEFAULT_BASELINE = "analysis-baseline.json"


def main(argv: "list[str] | None" = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Determinism / effect-protocol static analysis.")
    parser.add_argument(
        "--check", nargs="+", metavar="PATH", default=None,
        help="files or directories to lint (default: the repro package "
             "sources)")
    parser.add_argument(
        "--baseline", default=DEFAULT_BASELINE, metavar="FILE",
        help=f"grandfathered-findings file (default: {DEFAULT_BASELINE}; "
             f"a missing file is an empty baseline)")
    parser.add_argument(
        "--write-baseline", action="store_true",
        help="write the current findings to the baseline file and exit 0")
    parser.add_argument(
        "--explain", action="store_true",
        help="list the rules and exit")
    args = parser.parse_args(argv)

    if args.explain:
        for rule, desc in sorted(ALL_RULES.items()):
            print(f"{rule}  {desc}")
        return 0

    if args.check is None:
        import repro_torch

        roots = [Path(repro_torch.__file__).parent]
    else:
        roots = [Path(p) for p in args.check]

    findings = []
    checked = 0
    for root in roots:
        if root.is_dir():
            findings.extend(lint_tree(root))
            checked += sum(1 for _ in root.rglob("*.py"))
        elif root.exists():
            findings.extend(lint_file(root, root.parent))
            checked += 1
        else:
            print(f"error: no such path {root}", file=sys.stderr)
            return 2

    if args.write_baseline:
        write_baseline(findings, args.baseline)
        print(f"wrote {len(findings)} finding(s) to {args.baseline}",
              file=sys.stderr)
        return 0

    baseline = load_baseline(args.baseline)
    new = new_findings(findings, baseline)
    json.dump(
        {
            "checked_files": checked,
            "findings": [f.to_json() for f in findings],
            "new": [f.to_json() for f in new],
            "grandfathered": len(findings) - len(new),
        },
        sys.stdout, indent=2)
    print()
    for f in new:
        print(str(f), file=sys.stderr)
    if new:
        print(f"{len(new)} new finding(s) not in baseline ({args.baseline})",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

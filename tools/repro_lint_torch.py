#!/usr/bin/env python
"""CLI for the port's repro-lint (see src/repro_torch/analysis/lint.py).

Usage:
  python tools/repro_lint_torch.py               # human report, all findings
  python tools/repro_lint_torch.py --check      # exit 1 on NON-baselined findings
  python tools/repro_lint_torch.py --json      # machine-readable report
  python tools/repro_lint_torch.py --fix-baseline  # regenerate tools/lint_baseline_torch.json
  python tools/repro_lint_torch.py --paths src/repro_torch/core/serving.py  # narrow scope

The baseline (tools/lint_baseline_torch.json) holds pre-existing findings
that are tracked but not blocking; --check fails only on findings outside
it. The rule engine is stdlib only: it imports neither torch nor the
reference package.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.analysis import lint  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--check", action="store_true",
                    help="exit 1 if any non-baselined finding exists")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="emit findings as JSON")
    ap.add_argument("--fix-baseline", action="store_true",
                    help="rewrite the baseline from the current findings "
                         "(sorted, deterministic)")
    ap.add_argument("--baseline", default=str(ROOT / "tools" /
                                              "lint_baseline_torch.json"),
                    help="baseline file path")
    ap.add_argument("--paths", nargs="*", default=None,
                    help="files/dirs to scan (repo-relative; default "
                         "src/repro_torch)")
    args = ap.parse_args(argv)

    findings = lint.scan_paths(ROOT, args.paths)

    if args.fix_baseline:
        Path(args.baseline).write_text(lint.make_baseline(findings))
        print(f"baseline written: {args.baseline} "
              f"({len(findings)} findings)")
        return 0

    baseline = lint.load_baseline(args.baseline)
    new = lint.mark_baselined(findings, baseline)

    if args.as_json:
        print(json.dumps({"findings": [f.to_json() for f in findings],
                          "new": len(new),
                          "baselined": len(findings) - len(new)},
                         indent=2))
    else:
        for f in findings:
            tag = "baselined" if f.baselined else "NEW"
            print(f"{f.path}:{f.line}: {f.rule} [{tag}] {f.message}")
        print(f"\n{len(findings)} finding(s): {len(new)} new, "
              f"{len(findings) - len(new)} baselined")
        if new and args.check:
            print("FAIL: new findings above must be fixed, suppressed "
                  "with `# repro-lint: disable=<rule>` + justification, "
                  "or (rarely) baselined via --fix-baseline.")

    if args.check and new:
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Static analysis for the port's captured hot paths (repro-lint).

``repro_torch.analysis.lint`` is the rule engine; ``tools/repro_lint_torch.py``
is the CLI that runs it against ``src/repro_torch`` with the baseline in
``tools/lint_baseline_torch.json``.
"""
from repro_torch.analysis.lint import (Finding, RULES, scan_paths,
                                       scan_sources, load_baseline,
                                       make_baseline, mark_baselined)

__all__ = ["Finding", "RULES", "scan_paths", "scan_sources",
           "load_baseline", "make_baseline", "mark_baselined"]

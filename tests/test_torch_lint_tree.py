"""The port's repro-lint around its rules: suppression comments, the
baseline's round trip and keys, and the live port tree clean against an
empty baseline (``tools/lint_baseline_torch.json``); the restated cases
of ``tests/test_lint.py``."""
import json
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro_torch.analysis import lint

ROOT = Path(__file__).resolve().parents[1]
BASELINE = ROOT / "tools" / "lint_baseline_torch.json"
SRC = "src/repro_torch/x.py"


# ------------------------------------------------------- suppression

def test_suppression_same_line_and_preceding_line():
    src = ("def f(x):\n"
           "    assert x > 0  # repro-lint: disable=R5\n"
           "    # repro-lint: disable=R5\n"
           "    assert x < 9\n"
           "    return x\n")
    assert lint.scan_sources({SRC: src}) == []


def test_suppression_is_rule_specific():
    src = ("def f(x):\n"
           "    assert x > 0  # repro-lint: disable=R1\n"
           "    return x\n")
    assert [f.rule for f in lint.scan_sources({SRC: src})] == ["R5"]


def test_suppression_disable_all():
    src = ("def f(x):\n"
           "    assert x > 0  # repro-lint: disable=all\n"
           "    return x\n")
    assert lint.scan_sources({SRC: src}) == []


# ---------------------------------------------------------- baseline

def test_baseline_roundtrip_and_determinism(tmp_path):
    src = {SRC: ("def f(x):\n"
                 "    assert x > 0\n"
                 "    assert x < 9\n"
                 "    return x\n")}
    findings = lint.scan_sources(src)
    assert len(findings) == 2
    text = lint.make_baseline(findings)
    assert text == lint.make_baseline(list(reversed(findings)))
    bp = tmp_path / "b.json"
    bp.write_text(text)
    assert lint.mark_baselined(lint.scan_sources(src),
                               lint.load_baseline(bp)) == []


def test_baseline_key_survives_line_moves(tmp_path):
    before = {SRC: "def f(x):\n    assert x > 0\n"}
    bp = tmp_path / "b.json"
    bp.write_text(lint.make_baseline(lint.scan_sources(before)))
    # same finding, shifted three lines down: still baselined
    after = {SRC: ("import os\n"
                   "\n"
                   "\n"
                   "def f(x):\n"
                   "    assert x > 0\n")}
    assert lint.mark_baselined(lint.scan_sources(after),
                               lint.load_baseline(bp)) == []


def test_new_finding_not_in_baseline_is_flagged(tmp_path):
    bp = tmp_path / "b.json"
    bp.write_text(lint.make_baseline([]))
    findings = lint.scan_sources({SRC: "def f(x):\n    assert x\n"})
    new = lint.mark_baselined(findings, lint.load_baseline(bp))
    assert len(new) == 1 and not new[0].baselined


# --------------------------------------------------------- live tree

def test_live_tree_has_zero_non_baselined_findings():
    findings = lint.scan_paths(ROOT)
    new = lint.mark_baselined(findings, lint.load_baseline(BASELINE))
    assert new == [], ("non-baselined lint findings:\n" + "\n".join(
        f"{f.path}:{f.line}: {f.rule} {f.message}" for f in new))


def test_live_tree_has_no_orphans():
    """Every public kernel and registry function has a caller in the
    port, or its line says why not (the chip check's and the tests'
    entries)."""
    keys = {f.key for f in lint.scan_paths(ROOT) if f.rule == "R4"}
    assert keys == set(), keys


def test_cli_check_passes_on_tree():
    res = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "repro_lint_torch.py"),
         "--check", "--json"], capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert json.loads(res.stdout)["new"] == 0


def test_baseline_is_empty_and_stays_empty():
    """Each finding on the port is fixed or suppressed on its line with a
    reason: the baseline is [] and the tree is clean without it."""
    baseline = json.loads(BASELINE.read_text())
    assert baseline["findings"] == [], baseline["findings"]
    assert lint.scan_paths(ROOT) == []

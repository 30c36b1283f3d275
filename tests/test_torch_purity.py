"""The port stands alone: it imports neither JAX nor anything of the
reference package, and ``chip_smoke.py`` and the serve and train CLIs
refuse to run without a card unless the CPU is asked for."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"

_PROBE = """
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any `import jax` now raises
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for must in ("repro_torch.core.fed_engine", "repro_torch.core.algorithms",
             "repro_torch.core.compression", "repro_torch.core.convergence",
             "repro_torch.trees", "repro_torch.core.fleet",
             "repro_torch.core.distill", "repro_torch.launch.steps",
             "repro_torch.optim.schedules", "repro_torch.models.moe",
             "repro_torch.models.encdec", "repro_torch.launch.mesh",
             "repro_torch.sharding", "repro_torch.sharding.specs",
             "repro_torch.configs.grok_1_314b",
             "repro_torch.configs.llama4_scout_17b_a16e",
             "repro_torch.configs.internlm2_20b",
             "repro_torch.configs.h2o_danube_3_4b",
             "repro_torch.configs.minitron_4b",
             "repro_torch.configs.paligemma_3b",
             "repro_torch.configs.seamless_m4t_large_v2"):
    assert must in names, (must, names)
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if m == "repro" or m.startswith("repro."))
assert not bad, bad
print(len(names))
"""


def test_port_imports_with_jax_blocked_and_loads_no_reference_module():
    out = subprocess.run([sys.executable, "-c", _PROBE],
                         env={**os.environ, "PYTHONPATH": str(SRC)},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout) >= 65          # every module was imported


_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax|from\s+jax|import\s+repro(\.|\s|$)|from\s+repro[.\s])",
    re.M)


def test_no_jax_or_reference_import_in_port_sources():
    files = sorted((SRC / "repro_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]
    hits = [f"{f}: {m.group(0).strip()}" for f in files
            for m in _FORBIDDEN.finditer(f.read_text())]
    assert not hits, hits


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_card_or_the_repo(alone, tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the refusal")
    script = ROOT / "chip_smoke.py"
    if alone:                      # a directory holding only the script
        (tmp_path / "chip_smoke.py").write_text(script.read_text())
        script = tmp_path / "chip_smoke.py"
    out = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_serve_cli_refuses_without_a_card_unless_asked_for_the_cpu():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the refusal")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "hymba-1.5b", "--reduced", "--continuous", "--requests", "1"],
        env={**os.environ, "PYTHONPATH": str(SRC)}, capture_output=True,
        text=True, timeout=120)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr and "served" not in out.stdout


def test_train_cli_refuses_without_a_card_unless_asked_for_the_cpu():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the refusal")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--mode", "sync",
         "--reduced"],
        env={**os.environ, "PYTHONPATH": str(SRC)}, capture_output=True,
        text=True, timeout=120)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr and "final_loss" not in out.stdout


_TEST_SIDE_PROBE = """
import sys
sys.modules["jax"] = None
sys.path.insert(0, {tests!r})
import lm_mesh_oracle, test_torch_lm_mesh_ranks, test_torch_cuda_lm_mesh
from repro_torch.launch import mesh, steps
from repro_torch.sharding import specs
bad = sorted(m for m in sys.modules if m == "repro" or m.startswith("repro."))
assert not bad, bad
print(len(lm_mesh_oracle.CASES))
"""


def test_mesh_ranks_and_four_card_runner_import_no_jax():
    """What the gloo ranks and the four-card ``torchrun`` ranks import
    (the oracle's case table, the rank bodies, the mesh modules) loads
    neither JAX nor the reference: only the oracle's own process does."""
    out = subprocess.run(
        [sys.executable, "-c",
         _TEST_SIDE_PROBE.format(tests=str(ROOT / "tests"))],
        env={**os.environ, "PYTHONPATH": str(SRC)}, capture_output=True,
        text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout) >= 10


def test_kernel_wrappers_refuse_dtensors():
    """Every kernel wrapper raises on a DTensor, naming ``local_map``,
    before its CPU branch, so no DTensor reaches a launch; the scoring
    forward under ``act_pspec`` hands the kernels rank-local tensors, and
    on the card launches each once a layer as without a mesh."""
    import torch
    from torch.distributed.tensor import DTensor, Replicate
    from repro_torch.configs import get_config
    from repro_torch.kernels import (decode_attend, kd_loss, ssd_decode,
                                     ssd_scan, swa_attention)
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import act_pspec
    from repro_torch.models import lm, registry
    mesh = make_host_mesh(device="cpu")

    def dt(*shape, dtype=torch.float32):
        return DTensor.from_local(torch.zeros(shape, dtype=dtype), mesh,
                                  [Replicate(), Replicate()])
    calls = {
        "swa_attention": lambda: swa_attention.swa_attention(
            dt(2, 8, 64), dt(2, 8, 64), dt(2, 8, 64), 4),
        "swa_attention_gqa": lambda: swa_attention.swa_attention_gqa(
            dt(1, 8, 2, 64), dt(1, 8, 1, 64), dt(1, 8, 1, 64), 4),
        "ssd_scan": lambda: ssd_scan.ssd_scan(
            dt(1, 8, 2, 4), dt(1, 8, 2), dt(2), dt(1, 8, 3), dt(1, 8, 3)),
        "ssd_decode_step": lambda: ssd_decode.ssd_decode_step(
            dt(1, 2, 4), dt(1, 2), dt(2), dt(1, 3), dt(1, 3), dt(1, 2, 4, 3)),
        "ring_decode_attend": lambda: decode_attend.ring_decode_attend(
            dt(1, 1, 2, 64), dt(1, 4, 1, 64), dt(1, 4, 1, 64),
            dt(1, dtype=torch.int32), 4),
        "extent_decode_attend": lambda: decode_attend.extent_decode_attend(
            dt(1, 1, 2, 64), dt(1, 4, 1, 64), dt(1, 4, 1, 64),
            dt(1, dtype=torch.int32), 0, 4),
        "kd_loss_fused": lambda: kd_loss.kd_loss_fused(
            dt(2, 8), dt(2, 8), dt(2, dtype=torch.int32), 0.5),
        "kd_loss_fused_bwd": lambda: kd_loss.kd_loss_fused_bwd(
            dt(2, 8), dt(2, 8), dt(2, dtype=torch.int32), None, dt(2),
            None, 0.5, 1.0)}
    for name, call in calls.items():
        with pytest.raises(TypeError, match="local_map"):
            call()
    cfg = get_config("hymba-1.5b").reduced()
    params = registry.init_params(torch.Generator().manual_seed(0), cfg,
                                  "cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 32),
                         generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got, _ = lm.forward_hidden(params, cfg, toks, kernel="cuda",
                                   act_pspec=act_pspec(mesh, cfg, 32))
        want, _ = lm.forward_hidden(params, cfg, toks, kernel="cuda")
    assert torch.equal(got, want)

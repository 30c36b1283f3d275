"""The slice as a whole: the port's ``run_pipeline`` (KD into ResNet3D-18,
then async Algorithm 1 on the Jetson fleet) vs the reference's
``run_pipeline(mode="async", engine="loop", kd_kernel="pallas")``.

The port is handed the reference run's initial params: they are recomputed
as ``repro.core.distill.run_chain`` draws them, converted, and put in
place of the port's ``registry.init_params`` for the test only. Stage-1
targets are ``argmax(teacher_logits)``; at seed 0 no teacher row has a
near-tie between its top two logits, so both frameworks pick the same
labels (a near-tie could pick a different label and break parity)."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jget
from repro.core import distill as jdistill
from repro.launch import pipeline as jpipe
from repro_torch.checkpoint.convert import params_from_jax
from repro_torch.launch import pipeline as tpipe
from repro_torch.models import registry as treg

from torch_parity import assert_params_close, chain_init

KW = dict(reduced=True, clients=2, epochs=2, batch=2, kd_steps=4,
          teacher_steps=2, seed=0)


def _patch_port_init(monkeypatch):
    chain = [jget("resnet3d-34").reduced(), jget("resnet3d-18").reduced()]
    init = chain_init(chain, KW["seed"])
    monkeypatch.setattr(
        treg, "init_params",
        lambda gen, cfg, device, dtype=None: params_from_jax(
            init[cfg.name], cfg, device=device))


def test_async_pipeline_matches_reference(monkeypatch):
    stages = {}
    run_chain = jdistill.run_chain

    def capture(*a, **k):            # the reference reports no KD losses
        out = run_chain(*a, **k)
        stages["jax"] = out[1]
        return out

    monkeypatch.setattr(jdistill, "run_chain", capture)
    jrep, jparams = jpipe.run_pipeline(mode="async", engine="loop",
                                       kd_kernel="pallas", **KW)
    _patch_port_init(monkeypatch)
    trep, tparams = tpipe.run_pipeline(device="cpu", kd_kernel="eager", **KW)

    (js,), (ts,) = stages["jax"], trep["stage1"]["stages"]
    assert (ts["teacher"], ts["student"]) == (js.teacher, js.student)
    np.testing.assert_allclose(ts["losses"], js.losses, rtol=1e-3)
    assert ts["accuracy"] == pytest.approx(js.accuracy, rel=1e-3)
    j2, t2 = jrep["stage2"], trep["stage2"]
    np.testing.assert_allclose(t2["final_loss"], j2["final_loss"], rtol=1e-3)
    assert t2["accuracy"] == pytest.approx(j2["accuracy"], rel=1e-3)
    assert t2["virtual_wall_s"] == j2["virtual_wall_s"]
    assert_params_close(jparams, tparams, rtol=1e-3, atol=1e-5)


def test_pipeline_is_bit_reproducible_and_kernel_path_agrees(monkeypatch):
    """Two runs give one digest; the kernel's autograd path (its plain
    version on the CPU) gives what the eager loss gives."""
    _patch_port_init(monkeypatch)
    a, pa = tpipe.run_pipeline(device="cpu", kd_kernel="cuda", **KW)
    b, _ = tpipe.run_pipeline(device="cpu", kd_kernel="cuda", **KW)
    assert a["params_digest"] == b["params_digest"]
    assert a["stage1"]["digest"] == b["stage1"]["digest"]
    e, pe = tpipe.run_pipeline(device="cpu", kd_kernel="eager", **KW)
    np.testing.assert_allclose(a["stage1"]["stages"][0]["losses"],
                               e["stage1"]["stages"][0]["losses"], rtol=1e-5)
    for k in pa:
        np.testing.assert_allclose(pa[k].numpy(), pe[k].numpy(), rtol=1e-4,
                                   atol=1e-6)


def test_cli_smoke_prints_report(capsys):
    assert tpipe.main(["--smoke", "--device", "cpu"]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["mode"] == "async" and report["device"] == "cpu"
    assert report["stage1"]["stages"][0]["steps"] == 4
    assert np.isfinite(report["stage2"]["final_loss"])


@pytest.mark.parametrize("kw", [{"mode": "sync"}, {"engine": "scan"},
                                {"codistill": True},
                                {"compare_scratch": True}])
def test_unported_modes_raise(kw):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tpipe.run_pipeline(device="cpu", **kw)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the refusal")
    with pytest.raises(RuntimeError, match="CUDA"):
        tpipe.run_pipeline(**KW)
    with pytest.raises(RuntimeError, match="CUDA"):
        tpipe.main(["--smoke"])

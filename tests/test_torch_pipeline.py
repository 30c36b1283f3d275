"""The slice as a whole: the port's ``run_pipeline`` (KD into ResNet3D-18,
then async Algorithm 1, or sync FedAvg with the scratch baseline beside
it, on the Jetson fleet) vs the reference's ``run_pipeline(engine="loop",
kd_kernel="pallas")`` in the same mode.

The port is handed the reference run's initial params: they are recomputed
as ``repro.core.distill.run_chain`` draws them, converted, and put in
place of the port's ``registry.init_params`` for the test only; the
scratch baseline's init, the reference's ``fold_in(PRNGKey(seed), 1)``
draw, takes the place of the port's ``_scratch_init``. Stage-1
targets are ``argmax(teacher_logits)``; at seed 0 no teacher row has a
near-tie between its top two logits, so both frameworks pick the same
labels (a near-tie could pick a different label and break parity)."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

from repro.configs import get_config as jget
from repro.core import distill as jdistill
from repro.launch import pipeline as jpipe
from repro_torch.checkpoint.convert import params_from_jax
from repro_torch.launch import pipeline as tpipe
from repro_torch.models import registry as treg

from torch_parity import assert_params_close, chain_init, jax_flat_params

KW = dict(reduced=True, clients=2, epochs=2, batch=2, kd_steps=4,
          teacher_steps=2, seed=0)


def _patch_port_init(monkeypatch, scratch: bool = False):
    chain = [jget("resnet3d-34").reduced(), jget("resnet3d-18").reduced()]
    init = chain_init(chain, KW["seed"])
    monkeypatch.setattr(
        treg, "init_params",
        lambda gen, cfg, device, dtype=None: params_from_jax(
            init[cfg.name], cfg, device=device))
    if scratch:
        flat = jax_flat_params(
            chain[1], jax.random.fold_in(jax.random.PRNGKey(KW["seed"]), 1))
        monkeypatch.setattr(
            tpipe, "_scratch_init",
            lambda cfg, seed, device: params_from_jax(flat, cfg,
                                                      device=device))


def _run_both(monkeypatch, mode: str, **kw):
    """The reference's run (its stage-1 results captured: its report has
    no KD losses) and the port's on the same init."""
    stages = {}
    run_chain = jdistill.run_chain

    def capture(*a, **k):
        out = run_chain(*a, **k)
        stages["jax"] = out[1]
        return out

    monkeypatch.setattr(jdistill, "run_chain", capture)
    jrep, jparams = jpipe.run_pipeline(mode=mode, engine="loop",
                                       kd_kernel="pallas", **kw, **KW)
    _patch_port_init(monkeypatch, scratch=kw.get("compare_scratch", False))
    trep, tparams = tpipe.run_pipeline(mode=mode, device="cpu",
                                       kd_kernel="eager", **kw, **KW)
    (js,), (ts,) = stages["jax"], trep["stage1"]["stages"]
    assert (ts["teacher"], ts["student"]) == (js.teacher, js.student)
    np.testing.assert_allclose(ts["losses"], js.losses, rtol=1e-3)
    assert ts["accuracy"] == pytest.approx(js.accuracy, rel=1e-3)
    j2, t2 = jrep["stage2"], trep["stage2"]
    np.testing.assert_allclose(t2["final_loss"], j2["final_loss"], rtol=1e-3)
    assert t2["accuracy"] == pytest.approx(j2["accuracy"], rel=1e-3)
    assert t2["virtual_wall_s"] == j2["virtual_wall_s"]
    assert_params_close(jparams, tparams, rtol=1e-3, atol=1e-5)
    return jrep, trep


def test_async_pipeline_matches_reference(monkeypatch):
    _run_both(monkeypatch, "async")


def test_sync_pipeline_and_scratch_baseline_match_reference(monkeypatch):
    jrep, trep = _run_both(monkeypatch, "sync", compare_scratch=True)
    js, ts = jrep["scratch"], trep["scratch"]
    np.testing.assert_allclose(ts["final_loss"], js["final_loss"], rtol=1e-3)
    assert ts["accuracy"] == pytest.approx(js["accuracy"], rel=1e-3)
    # the report carries every key of the reference's (the port's eager
    # stages compile nothing, so they report no ``compiles``)
    assert set(jrep) <= set(trep)
    for part in ("stage1", "stage2", "scratch"):
        assert set(jrep[part]) <= set(trep[part]), part
    assert set(jrep["stage1"]["stages"][0]) - {"compiles"} <= \
        set(trep["stage1"]["stages"][0])


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


def test_stage1_hook_and_stage2_alone_reproduce_the_pipeline():
    """``on_stage1`` hands out the params the report's stage-1 digest is
    of, and ``finetune`` from them alone gives the pipeline's params bit
    for bit, in both modes."""
    from repro_torch.configs import get_config as tget
    from repro_torch.data import make_dataset_for
    from repro_torch.types import FedConfig
    cfg = tget("resnet3d-18").reduced()
    fed = FedConfig(num_clients=KW["clients"], global_epochs=KW["epochs"],
                    seed=KW["seed"])
    ds = make_dataset_for(cfg, small=True, seed=KW["seed"])
    for mode in ("async", "sync"):
        seen = []
        rep, params = tpipe.run_pipeline(device="cpu", mode=mode,
                                         on_stage1=seen.append, **KW)
        assert len(seen) == 1
        assert tpipe.params_digest(seen[0]) == rep["stage1"]["digest"]
        res = tpipe.finetune(seen[0], cfg, fed, ds, KW["batch"], mode,
                             "scan", KW["seed"], "cpu")
        assert tpipe.params_digest(res.params) == rep["params_digest"]
        assert res.wall_clock_s == rep["stage2"]["virtual_wall_s"]


def test_cli_smoke_prints_report(capsys):
    assert tpipe.main(["--smoke", "--device", "cpu"]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["mode"] == "async" and report["device"] == "cpu"
    assert report["stage1"]["stages"][0]["steps"] == 4
    assert np.isfinite(report["stage2"]["final_loss"])


# engine="shard", refused before the sharded round was ported: a sync
# pipeline on it (a world of one) gives the scan pipeline bit for bit;
# async refuses it, as the reference's run_async does
@pytest.mark.parametrize("kw", [{"engine": "shard"}])
def test_unported_modes_raise(kw):
    with pytest.raises(ValueError, match="not supported here"):
        tpipe.run_pipeline(device="cpu", **kw, **KW)
    got, _ = tpipe.run_pipeline(device="cpu", mode="sync", **kw, **KW)
    want, _ = tpipe.run_pipeline(device="cpu", mode="sync", **KW)
    assert got["engine"] == kw["engine"]
    assert got["params_digest"] == want["params_digest"]
    assert got["stage2"] == want["stage2"]


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the refusal")
    with pytest.raises(RuntimeError, match="CUDA"):
        tpipe.run_pipeline(**KW)
    with pytest.raises(RuntimeError, match="CUDA"):
        tpipe.main(["--smoke"])


def test_cli_sync_with_scratch_prints_report(capsys):
    assert tpipe.main(["--smoke", "--mode", "sync", "--compare-scratch",
                       "--device", "cpu"]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["mode"] == "sync"
    assert np.isfinite(report["stage2"]["final_loss"])
    assert np.isfinite(report["scratch"]["final_loss"])

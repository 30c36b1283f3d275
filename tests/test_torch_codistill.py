"""Codistillation and the analytic chain-time model in the port
(``repro_torch/core/distill.py``) against the reference's
``repro/core/distill.py``.

``CodistillFleet`` groups its members by architecture, one call a group
for the round-start logits and one for the masked KD runs, each member's
budget H^k an input: the [a, a, b] fleet of ``tests/test_distill.py``
compiles 4 signatures and a warm round none. Each member's round is
matched against the reference's from the same converted init (losses
rtol 1e-3, params within 1e-3·(1 + |ref|), the NaN pattern exactly), on
the reference's tiny dense LMs and on reduced ResNet3D members, and
``run_pipeline(codistill=True)`` against the reference's pipeline. The
port's init draws are replaced by the reference's for the test only
(``registry.init_params``, as ``tests/test_torch_pipeline.py`` does)."""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

from repro.configs import get_config as jget
from repro.core import distill as jdistill
from repro.data import SyntheticLMDataset
from repro.data import stack_batches
from repro.launch import pipeline as jpipe
from repro.models import resnet3d as jresnet
from repro.types import DistillConfig as JDcfg
from repro.types import ModelConfig as JModel
from repro_torch.configs import get_config as tget
from repro_torch.core import distill as tdistill
from repro_torch.launch import pipeline as tpipe
from repro_torch.models import registry as treg
from repro_torch.models import resnet3d as tresnet
from repro_torch.types import DistillConfig as TDcfg
from repro_torch.types import ModelConfig as TModel

from torch_parity import _flatten, assert_params_close, port_params

TINY_LM = dict(family="dense", num_layers=1, d_model=32, num_heads=2,
               num_kv_heads=2, d_ff=64, vocab_size=64)


def _tiny_lm(Model, name, **over):
    return Model(name=name, **{**TINY_LM, **over})


def _lm_fleet_cfgs(Model):
    a = _tiny_lm(Model, "co-big")
    b = _tiny_lm(Model, "co-small", d_model=16, d_ff=32)
    return [a, a, b]


def _resnet_cfgs(get):
    return [get("resnet3d-34").reduced(), get("resnet3d-18").reduced()]


def _reference_fleet(cfgs, seed=0):
    return jdistill.CodistillFleet(cfgs, JDcfg(lr=0.01),
                                   kd_kernel="pallas").init(
        jax.random.PRNGKey(seed))


def _patch_inits(monkeypatch, jfleet, tcfgs):
    """The port's ``init`` draws, in its order (group by group, members
    in order), replaced by the reference fleet's member params."""
    groups: dict = {}
    for i, c in enumerate(tcfgs):
        groups.setdefault(c, []).append(i)
    queue = [_flatten(jfleet.member_params(i))
             for idx in groups.values() for i in idx]
    monkeypatch.setattr(
        treg, "init_params", lambda gen, cfg, device, dtype=None:
        port_params(queue.pop(0), cfg, device))


def _port_fleet(monkeypatch, jfleet, tcfgs, kd_kernel="eager"):
    _patch_inits(monkeypatch, jfleet, tcfgs)
    return tdistill.CodistillFleet(tcfgs, TDcfg(lr=0.01),
                                   kd_kernel=kd_kernel).init(
        torch.Generator().manual_seed(0), "cpu")


def _losses_match(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    live = ~np.isnan(want)
    np.testing.assert_allclose(got[live], want[live], rtol=1e-3)


def _members_match(jfleet, tfleet, n):
    for i in range(n):
        assert_params_close(jfleet.member_params(i),
                            tfleet.member_params(i), rtol=1e-3, atol=1e-3)


def _lm_probe(seed, steps=4):
    ds = SyntheticLMDataset(vocab=64, seq_len=8, seed=0)
    return stack_batches(iter(ds.batches(2, steps, seed=seed)))


def test_codistill_heterogeneous_fleet_groups_by_arch(monkeypatch):
    """The [a, a, b] fleet with budgets [4, 2, 3]: (3, 4) losses, NaN past
    each budget, 2 groups × (logits + KD) = 4 signatures, a warm round
    with other budgets adds none; every member matches the reference."""
    jfleet = _reference_fleet(_lm_fleet_cfgs(JModel))
    tcfgs = _lm_fleet_cfgs(TModel)
    fleet = _port_fleet(monkeypatch, jfleet, tcfgs)
    assert fleet.num_members == 3 and len(fleet.groups) == 2
    probe = _lm_probe(1)
    got = fleet.round(probe, iters=[4, 2, 3])
    want = np.asarray(jfleet.round(probe, iters=[4, 2, 3]))
    assert got.shape == (3, 4)
    assert torch.isfinite(got[0]).all()
    assert torch.isfinite(got[1, :2]).all() and got[1, 2:].isnan().all()
    assert torch.isfinite(got[2, :3]).all() and got[2, 3:].isnan().all()
    _losses_match(got.numpy(), want)
    assert fleet.num_compiled == 4
    probe2 = _lm_probe(2)
    _losses_match(fleet.round(probe2).numpy(),
                  np.asarray(jfleet.round(probe2)))
    fleet.round(probe2, iters=[1, 3, 2])
    assert fleet.num_compiled == 4
    jfleet.round(probe2, iters=[1, 3, 2])
    _members_match(jfleet, fleet, 3)
    for i, cfg in enumerate(tcfgs):
        shapes = {k: tuple(v.shape) for k, v in fleet.member_params(i).items()}
        ref = {k: tuple(np.shape(v))
               for k, v in port_params(_flatten(jfleet.member_params(i)),
                                       cfg).items()}
        assert shapes == ref
    with pytest.raises(ValueError, match=r"iters must be \(3,\)"):
        fleet.round(probe, iters=[4, 2])


@pytest.mark.parametrize("case", ["one", "width", "probe", "kernel"])
def test_codistill_rejects_bad_fleets(case):
    a = _tiny_lm(TModel, "co-a")
    cfgs, match, kw = {
        "one": ([a], ">= 2", {}),
        "width": ([a, dataclasses.replace(a, name="co-v", vocab_size=32)],
                  "equal logit width", {}),
        "probe": ([a, dataclasses.replace(tget("resnet3d-18").reduced(),
                                          num_classes=a.vocab_size)],
                  "probe batch", {}),
        "kernel": ([a, a], "kd_kernel", {"kd_kernel": "pallas"})}[case]
    with pytest.raises(ValueError, match=match):
        tdistill.CodistillFleet(cfgs, TDcfg(), **kw)


def test_resnet_codistill_round_matches_reference(monkeypatch):
    """One round of reduced ResNet3D-34 and -18 on four clip batches,
    budgets [4, 2]."""
    from repro.data import make_dataset_for
    jcfgs = _resnet_cfgs(jget)
    jfleet = _reference_fleet(jcfgs)
    fleet = _port_fleet(monkeypatch, jfleet, _resnet_cfgs(tget))
    ds = make_dataset_for(jcfgs[1], small=False, seed=0)
    probe = stack_batches(iter(ds.batches(2, 4, seed=3)))
    got = fleet.round(probe, iters=[4, 2]).numpy()
    want = np.asarray(jfleet.round(probe, iters=[4, 2]))
    assert np.isnan(got[1, 2:]).all() and np.isfinite(got[1, :2]).all()
    _losses_match(got, want)
    _members_match(jfleet, fleet, 2)


def test_run_codistill_takes_fresh_passes(monkeypatch):
    """Three rounds of two steps over a stream of four batches: the
    third round starts a fresh pass, as the reference's does."""
    ds = SyntheticLMDataset(vocab=64, seq_len=8, seed=0)
    batches = lambda: ds.batches(2, 4, seed=1)          # noqa: E731
    evals = list(ds.batches(2, 2, seed=9))
    jcfgs, tcfgs = _lm_fleet_cfgs(JModel)[1:], _lm_fleet_cfgs(TModel)[1:]
    jfleet, jout = jdistill.run_codistill(jcfgs, JDcfg(lr=0.01), batches,
                                          evals, rounds=3, steps_per_round=2,
                                          kd_kernel="eager")
    _patch_inits(monkeypatch, _reference_fleet(jcfgs), tcfgs)
    tfleet, tout = tdistill.run_codistill(tcfgs, TDcfg(lr=0.01), batches,
                                          evals, rounds=3, steps_per_round=2,
                                          kd_kernel="eager", device="cpu")
    assert tout["losses"].shape == (3, 2, 2)
    _losses_match(tout["losses"], jout["losses"])
    assert tout["accuracy"] == pytest.approx(jout["accuracy"], abs=1e-6)
    _members_match(jfleet, tfleet, 2)


def test_kernel_path_agrees_and_rounds_reproduce(monkeypatch):
    """``kd_kernel="cuda"`` (its plain version on the CPU) gives what the
    eager loss gives; the same round twice gives the same bits."""
    jfleet = _reference_fleet(_lm_fleet_cfgs(JModel))
    runs = []
    for kernel in ("cuda", "cuda", "eager"):
        fleet = _port_fleet(monkeypatch, jfleet, _lm_fleet_cfgs(TModel),
                            kd_kernel=kernel)
        runs.append((fleet.round(_lm_probe(1), iters=[4, 2, 3]), fleet))
    (a, fa), (b, fb), (e, fe) = runs
    assert torch.equal(a.isnan(), b.isnan())
    assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))
    np.testing.assert_allclose(a.numpy(), e.numpy(), rtol=1e-5)
    for i in range(3):
        for k, v in fa.member_params(i).items():
            assert torch.equal(v, fb.member_params(i)[k]), k
            np.testing.assert_allclose(v.numpy(),
                                       fe.member_params(i)[k].numpy(),
                                       rtol=1e-4, atol=1e-6)


def test_codistill_pipeline_matches_reference(monkeypatch):
    """``run_pipeline(codistill=True)``, async, reduced: stage 1 by
    codistillation of ResNet3D-34 and -18 (2 rounds of 4 steps), then
    the student's fine-tune on two Jetsons."""
    kw = dict(reduced=True, mode="async", clients=2, epochs=2, batch=2,
              kd_steps=8, teacher_steps=2, seed=0, codistill=True)
    jrep, jparams = jpipe.run_pipeline(engine="loop", kd_kernel="pallas",
                                       **kw)
    _patch_inits(monkeypatch, _reference_fleet(_resnet_cfgs(jget)),
                 _resnet_cfgs(tget))
    seen = []
    trep, tparams = tpipe.run_pipeline(device="cpu", kd_kernel="eager",
                                       on_stage1=seen.append, **kw)
    js, ts = jrep["stage1"], trep["stage1"]
    assert ts["codistill"] is True and ts["rounds"] == js["rounds"] == 2
    assert ts["accuracy"] == pytest.approx(js["accuracy"], abs=1e-6)
    assert np.asarray(ts["losses"]).shape == (2, 2, 4)
    assert np.isfinite(ts["losses"]).all()
    assert len(seen) == 1 and tpipe.params_digest(seen[0]) == ts["digest"]
    j2, t2 = jrep["stage2"], trep["stage2"]
    assert t2["virtual_wall_s"] == j2["virtual_wall_s"]
    np.testing.assert_allclose(t2["final_loss"], j2["final_loss"], rtol=1e-3)
    assert t2["accuracy"] == pytest.approx(j2["accuracy"], rel=1e-3)
    assert_params_close(jparams, tparams, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("chain", [
    ("resnet3d-34", "resnet3d-18"),
    ("resnet3d-34", "resnet3d-26", "resnet3d-18"),
    ("hymba-1.5b", "mamba2-130m")])
def test_chain_time_model_equals_reference(chain):
    jc, tc = [jget(n) for n in chain], [tget(n) for n in chain]
    for kw in ({}, {"device_flops": 989e12, "mfu": 0.4}):
        assert tdistill.chain_time_model(tc, 1e6, 200, **kw) == \
            jdistill.chain_time_model(jc, 1e6, 200, **kw)
    for (jt, js), (tt, ts) in zip(zip(jc, jc[1:]), zip(tc, tc[1:])):
        assert tdistill.stage_flops(tt, ts, 3.5e5) == \
            jdistill.stage_flops(jt, js, 3.5e5)
    if len(chain) == 3:       # a TA stage costs more time (Table I's shape)
        assert tdistill.chain_time_model(tc, 1e6, 200)["total_s"] > \
            tdistill.chain_time_model([tc[0], tc[2]], 1e6, 200)["total_s"]


def test_input_shape_equals_reference():
    for name in ("resnet3d-18", "resnet3d-34"):
        for j, t in ((jget(name), tget(name)),
                     (jget(name).reduced(), tget(name).reduced())):
            for batch in (1, 4):
                assert tresnet.input_shape(t, batch) == \
                    jresnet.input_shape(j, batch)


def test_cli_codistill_prints_report(capsys):
    assert tpipe.main(["--smoke", "--codistill", "--device", "cpu"]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    st = report["stage1"]
    assert st["codistill"] is True and st["rounds"] == 1
    assert st["compiles"] == 4 and len(st["accuracy"]) == 2
    assert np.isfinite(st["losses"]).all()
    assert np.isfinite(report["stage2"]["final_loss"])

"""A scheduled learning rate through the port's engines
(``optim.schedules.cosine`` and ``inverse_sqrt``) against the reference's
engines under the same schedule, on the same numpy batches and converted
params: ``ClientRun`` (one client, and a ragged ``run_batch``) on the
reference's tiny dense LM, also against the port's per-iteration loop
(losses rtol 1e-4, params 1e-5); ``DistillEngine`` and ``ScratchRun``
epochs, ``run_chain`` with tail epochs, ``run_async`` and ``run_sync`` and
``CodistillFleet`` on reduced ResNet3D and tiny LM members, through the
KD kernels' wrappers (their plain versions on the CPU). The step counts
equal the reference's exactly, the virtual clocks too; losses and params
rtol 1e-3. A constant rate keeps its host-int step, which no call takes
as an input, and SCAFFOLD refuses a schedule as the reference does."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

from repro.configs import get_config as jget
from repro.core import distill as jdistill
from repro.core import fed_engine as jfe
from repro.core import fedavg as jfedavg
from repro.core import simulator as jsim
from repro.core.algorithms import Scaffold as JScaffold
from repro.core.fleet import Fleet as JFleet
from repro.data import BatchLoader as JLoader
from repro.data import SyntheticActionDataset as JDS
from repro.data import SyntheticLMDataset
from repro.optim import schedules as jsched
from repro.types import DistillConfig as JDcfg
from repro.types import FedConfig as JFed
from repro.types import ModelConfig as JModel
from repro_torch.configs import get_config as tget
from repro_torch.core import distill as tdistill
from repro_torch.core import fed_engine as tfe
from repro_torch.core import fedasync as tfa
from repro_torch.core import fedavg as tfedavg
from repro_torch.core import simulator as tsim
from repro_torch.core.fleet import JETSON_FLEET_HMDB51, Fleet
from repro_torch.data import BatchLoader as TLoader
from repro_torch.data import stack_batches
from repro_torch.models import registry as treg
from repro_torch.optim import schedules as tsched
from repro_torch.types import DistillConfig as TDcfg
from repro_torch.types import FedConfig as TFed
from repro_torch.types import ModelConfig as TModel

from torch_parity import (_flatten, assert_params_close, chain_init,
                          jax_params_both, port_params)

TINY = dict(name="schedule-test-tiny", family="dense", num_layers=1,
            d_model=32, num_heads=2, num_kv_heads=2, d_ff=64, vocab_size=64)
FED = dict(num_clients=4, global_epochs=6, local_iters_min=1,
           local_iters_max=3)
# (reference schedule, port schedule) by name, built alike
SCHEDS = {"cosine": lambda m, lr, total: m.cosine(lr, total, 1),
          "inverse_sqrt": lambda m, lr, total: m.inverse_sqrt(lr, 1)}


def _both(name, lr, total=6):
    return SCHEDS[name](jsched, lr, total), SCHEDS[name](tsched, lr, total)


def _close(a: dict, b: dict, rtol=1e-5, atol=1e-5):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), rtol=rtol,
                                   atol=atol, err_msg=k)


@pytest.fixture(scope="module")
def tiny():
    jc, tc = JModel(**TINY), TModel(**TINY)
    jp, flat = jax_params_both(jc, jax.random.PRNGKey(0))
    ds = SyntheticLMDataset(vocab=64, seq_len=8, seed=0)
    return jc, tc, jp, port_params(flat, tc), ds


@pytest.fixture(scope="module")
def resnet():
    jc, tc = jget("resnet3d-18").reduced(), tget("resnet3d-18").reduced()
    jp, flat = jax_params_both(jc, jax.random.PRNGKey(0))
    return jc, tc, jp, port_params(flat, tc)


@pytest.mark.parametrize("sched", SCHEDS)
def test_client_run_matches_reference_and_loop(tiny, sched):
    """One client's H = 3 steps: the reference's engine, the port's loop,
    and a constant rate's run, whose params part from the scheduled
    ones."""
    jc, tc, jp, tp, ds = tiny
    js, ts = _both(sched, 0.1)
    fed = TFed(**FED, lr=ts)
    bl = list(ds.batches(2, 3, seed=3))
    stacked = stack_batches(iter(bl))
    w, losses = tfe.ClientRun(tc, fed)(tp, stacked)
    jw, jl = jfe.ClientRun(jc, JFed(**FED, lr=js))(jp, stacked)
    np.testing.assert_allclose(losses.numpy(), np.asarray(jl), rtol=1e-3)
    assert_params_close(jw, w, rtol=1e-3, atol=1e-5)
    w_loop, _, l_loop = tfa.client_update(tp, 0, iter(bl), tc, fed,
                                          num_iters=3)
    np.testing.assert_allclose(losses.numpy(), l_loop, rtol=1e-4)
    _close(w_loop, w)
    w_flat, flat = tfe.ClientRun(tc, TFed(**FED, lr=0.1))(tp, stacked)
    assert flat[0] == losses[0]
    assert not all(torch.allclose(w_flat[k], w[k]) for k in w)


@pytest.mark.parametrize("sched", SCHEDS)
def test_ragged_run_batch_freezes_each_clients_step(tiny, sched):
    """H^k = 3, 1, 2 in one padded call: each client's step stops at its
    budget (the loop's run of H^k steps), as the reference's carry."""
    jc, tc, jp, tp, ds = tiny
    js, ts = _both(sched, 0.1)
    fed = TFed(**FED, lr=ts)
    lists = [list(ds.batches(2, h, seed=10 + h)) for h in (3, 1, 2)]
    padded, iters = tfe.pad_client_batches(
        [stack_batches(iter(bl)) for bl in lists], H_max=3)
    run = tfe.ClientRun(tc, fed)
    w_news, losses = run.run_batch(tp, padded, iters)
    jw, jl = jfe.ClientRun(jc, JFed(**FED, lr=js)).run_batch(jp, padded,
                                                            iters)
    np.testing.assert_array_equal(np.isnan(losses.numpy()),
                                  np.isnan(np.asarray(jl)))
    live = ~np.isnan(np.asarray(jl))
    np.testing.assert_allclose(losses.numpy()[live], np.asarray(jl)[live],
                               rtol=1e-3)
    for j, (w, bl) in enumerate(zip(run.unstack(w_news, 3), lists)):
        w_loop, _, l_loop = tfa.client_update(tp, 0, iter(bl), tc, fed,
                                              num_iters=len(bl))
        np.testing.assert_allclose(losses[j, :len(bl)].numpy(), l_loop,
                                   rtol=1e-4)
        _close(w_loop, w)
        assert_params_close(jax.tree_util.tree_map(lambda a: a[j], jw), w,
                            rtol=1e-3, atol=1e-5)


def _clips(H, seed):
    ds = JDS(num_classes=8, samples_per_class=8, seed=1)
    return stack_batches(ds.batches(2, H, seed=seed))


def _epochs_match(jrun, trun, jfix, tfix, jp, tp, stacks):
    """Epochs over ``stacks`` from a fresh optimizer state in both
    packages: losses, the step (a tensor here) and the params; then one
    more epoch of the first shape adds no signature."""
    jparams, jst = jp, jrun.opt.init(jp)
    params, st = tp, trun.opt.init(tp)
    for stacked in stacks:
        jparams, jst, jl = jrun.epoch(*jfix, jparams, jst, stacked)
        params, st, losses = trun.epoch(*tfix, params, st, stacked)
        np.testing.assert_allclose(losses.numpy(), np.asarray(jl),
                                   rtol=1e-3)
    assert isinstance(st["step"], torch.Tensor)
    assert int(st["step"]) == int(jst["step"])
    assert_params_close(jparams, params, rtol=1e-3, atol=1e-5)
    trun.epoch(*tfix, params, st, stacks[0])
    assert trun.num_compiled == len({len(s["labels"]) for s in stacks})
    return int(st["step"])


@pytest.mark.parametrize("sched", SCHEDS)
def test_kd_and_scratch_epochs_carry_the_step(resnet, tiny, sched):
    """ResNet3D-18 reduced distilled into itself through the KD kernels'
    wrappers, two epochs of H 3: the step ends at 6, as the reference's;
    scratch epochs of 3 and a shorter 2 on the tiny LM end at 5."""
    jc, tc, jp, tp = resnet
    jt, tflat = jax_params_both(jc, jax.random.PRNGKey(1))
    js, ts = _both(sched, 0.01)
    assert _epochs_match(
        jdistill.DistillEngine(jc, jc, JDcfg(lr=js), kd_kernel="eager"),
        tdistill.DistillEngine(tc, tc, TDcfg(lr=ts)), (jt,),
        (port_params(tflat, tc),), jp, tp,
        [_clips(3, 4), _clips(3, 5)]) == 6
    jc, tc, jp, tp, ds = tiny
    js, ts = _both(sched, 0.1)
    assert _epochs_match(
        jdistill.ScratchRun(jc, JDcfg(lr=js)),
        tdistill.ScratchRun(tc, TDcfg(lr=ts)), (), (), jp, tp,
        [stack_batches(iter(ds.batches(2, h, seed=h))) for h in (3, 2)]) \
        == 5


@pytest.mark.parametrize("sched", SCHEDS)
def test_run_chain_carries_the_step_across_tail_epochs(monkeypatch, sched):
    """A tiny LM teacher's pretrain (4 steps: epochs of 3 and 1) and its
    KD into a narrower one (5 steps: 3 and 2) under the schedule, each
    epoch starting where the last ended, against the reference's
    chain."""
    big = dict(TINY, name="chain-big")
    small = dict(big, name="chain-small", d_model=16, d_ff=32)
    jchain = [JModel(**big), JModel(**small)]
    tchain = [TModel(**big), TModel(**small)]
    init = chain_init(jchain, 0)
    monkeypatch.setattr(
        treg, "init_params", lambda gen, cfg, device, dtype=None:
        port_params(init[cfg.name], cfg, device))
    ds = SyntheticLMDataset(vocab=64, seq_len=8, seed=0)

    def train():
        return list(ds.batches(2, 5, seed=2))
    evals = list(ds.batches(2, 2, seed=9))
    js, ts = _both(sched, 0.1, total=5)
    kw = dict(steps_per_stage=5, trained_teacher_steps=4, epoch_len=3)
    jparams, jres = jdistill.run_chain(jchain, JDcfg(lr=js), train, evals,
                                       kd_kernel="eager", **kw)
    tparams, tres = tdistill.run_chain(tchain, TDcfg(lr=ts), train, evals,
                                       device="cpu", **kw)
    assert len(tres[0].losses) == len(jres[0].losses) == 5
    np.testing.assert_allclose(tres[0].losses, jres[0].losses, rtol=1e-3)
    assert_params_close(jparams, tparams, rtol=1e-3, atol=1e-5)


def _loaders(Loader, ds, steps=(3, 3, 3, 3)):
    return [Loader(ds, 2, steps=s, seed=k) for k, s in enumerate(steps)]


def _same_clock(a, b):
    assert a.wall_clock_s == b.wall_clock_s
    assert [h[:2] for h in a.history] == [h[:2] for h in b.history]


def _sim_matches(out: dict, ref):
    for res in out.values():
        _same_clock(res, ref)
        np.testing.assert_allclose([h[2] for h in res.history],
                                   [h[2] for h in ref.history], rtol=1e-3)
        assert_params_close(ref.params, res.params, rtol=1e-3, atol=1e-5)
    _close(out["loop"].params, out["scan"].params)


@pytest.mark.parametrize("sched,window", [("inverse_sqrt", 0.0),
                                          ("cosine", 300.0)])
def test_run_async_scan_and_loop_match_reference(tiny, sched, window):
    """The four Jetsons, every dispatch through ``run_batch`` padded to
    H_max, on ``scan`` and ``loop``."""
    jc, tc, jp, tp, ds = tiny
    js, ts = _both(sched, 0.05, total=3)
    out = {e: tsim.run_async(tp, tc, TFed(**FED, lr=ts), Fleet.from_lists(
        JETSON_FLEET_HMDB51, _loaders(TLoader, ds)), engine=e,
        window=window, device="cpu") for e in ("scan", "loop")}
    ref = jsim.run_async(jp, jc, JFed(**FED, lr=js), JFleet.from_lists(
        JETSON_FLEET_HMDB51, _loaders(JLoader, ds)), engine="scan",
        window=window)
    _sim_matches(out, ref)


@pytest.mark.parametrize("sched", SCHEDS)
def test_run_sync_ragged_and_zero_weight_match_reference(tiny, sched):
    """``run_sync`` over clients of 3, 1, 2 and 0 batches, then one round
    of H^k 3, 1, 2, 3 with a zero-weight client, on ``scan`` and
    ``loop``, against the reference's scan."""
    jc, tc, jp, tp, ds = tiny
    js, ts = _both(sched, 0.05, total=3)
    fed = dict(FED, global_epochs=8)
    steps = (3, 1, 2, 0)
    out = {e: tsim.run_sync(tp, tc, TFed(**fed, lr=ts), Fleet.from_lists(
        JETSON_FLEET_HMDB51, _loaders(TLoader, ds, steps)), engine=e,
        device="cpu") for e in ("scan", "loop")}
    ref = jsim.run_sync(jp, jc, JFed(**fed, lr=js), JFleet.from_lists(
        JETSON_FLEET_HMDB51, _loaders(JLoader, ds, steps)), engine="scan")
    _sim_matches(out, ref)
    sizes = [16, 8, 16, 0]
    data = [list(ds.batches(2, h, seed=20 + k))
            for k, h in enumerate((3, 1, 2, 3))]
    got = {e: tfedavg.fedavg_round(tp, [iter(b) for b in data], tc,
                                   TFed(**fed, lr=ts), engine=e,
                                   data_sizes=sizes)
           for e in ("scan", "loop")}
    jw, jl = jfedavg.fedavg_round(jp, [iter(b) for b in data], jc,
                                  JFed(**fed, lr=js), engine="scan",
                                  data_sizes=sizes)
    for w, losses in got.values():
        np.testing.assert_allclose(np.concatenate(losses),
                                   np.concatenate(jl), rtol=1e-3)
        assert_params_close(jw, w, rtol=1e-3, atol=1e-5)
    _close(got["loop"][0], got["scan"][0])


@pytest.mark.parametrize("sched", SCHEDS)
def test_codistill_member_steps_match_reference(monkeypatch, sched):
    """[co-big, co-big, co-small], two rounds at budgets [3, 1, 2]: each
    member's step advances on its active steps only and persists across
    rounds ([6, 2] and [4]), with the reference's losses."""
    lm = dict(TINY, name="co-big")
    small = dict(lm, name="co-small", d_model=16, d_ff=32)
    jcfgs = [JModel(**lm), JModel(**lm), JModel(**small)]
    tcfgs = [TModel(**lm), TModel(**lm), TModel(**small)]
    js, ts = _both(sched, 0.1, total=8)
    jfleet = jdistill.CodistillFleet(jcfgs, JDcfg(lr=js),
                                     kd_kernel="eager").init(
        jax.random.PRNGKey(0))
    queue = [_flatten(jfleet.member_params(i)) for i in range(3)]
    monkeypatch.setattr(
        treg, "init_params", lambda gen, cfg, device, dtype=None:
        port_params(queue.pop(0), cfg, device))
    fleet = tdistill.CodistillFleet(tcfgs, TDcfg(lr=ts)).init(
        torch.Generator().manual_seed(0), "cpu")
    ds = SyntheticLMDataset(vocab=64, seq_len=8, seed=0)
    for seed in (1, 2):
        probe = stack_batches(iter(ds.batches(2, 3, seed=seed)))
        got = fleet.round(probe, iters=[3, 1, 2]).numpy()
        want = np.asarray(jfleet.round(probe, iters=[3, 1, 2]))
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        live = ~np.isnan(want)
        np.testing.assert_allclose(got[live], want[live], rtol=1e-3)
    want_steps = [np.asarray(o["step"]).tolist() for o in jfleet._opt]
    assert want_steps == [[6, 2], [4]]
    assert [fleet.member_step(i) for i in range(3)] == [6, 2, 4]
    for i in range(3):
        assert_params_close(jfleet.member_params(i), fleet.member_params(i),
                            rtol=1e-3, atol=1e-5)
    assert fleet.num_compiled == 4
    monkeypatch.undo()
    const = tdistill.CodistillFleet(tcfgs, TDcfg(lr=0.1))
    assert const.init(torch.Generator().manual_seed(0), "cpu") \
        .member_step(0) is None


def test_scaffold_refuses_a_schedule_as_the_reference_does(tiny):
    """SCAFFOLD's variate update divides by the rate: both packages raise
    ``TypeError`` on a schedule."""
    jc, tc, jp, tp, ds = tiny
    js, ts = _both("inverse_sqrt", 0.1)
    stacked = stack_batches(iter(ds.batches(2, 3, seed=3)))
    with pytest.raises(TypeError):
        jfe.ClientRun(jc, JFed(**FED, lr=js), algorithm=JScaffold())(
            jp, stacked)
    run = tfe.make_client_run(tc, TFed(**FED, lr=ts), algorithm="scaffold")
    with pytest.raises(TypeError):
        run(tp, stacked, server_ctx=run.algorithm.ctx_for(tp),
            state=run.algorithm.state_for(0, tp))


def test_a_constant_rate_hands_no_step_to_a_call():
    """A constant rate's scratch epoch passes its arguments as before
    schedules (no step among them) and counts its step on the host; a
    scheduled one passes its step tensor and gets the next one back."""
    cfg = tget("resnet3d-18").reduced()
    params = treg.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    args, steps = [], []
    for lr in (0.01, tsched.cosine(0.01, 6, 1)):
        run = tdistill.ScratchRun(cfg, TDcfg(lr=lr))
        call = run._graphs.call

        def spy(name, fn, a, call=call):
            args.append(a)
            return call(name, fn, a)
        run._graphs.call = spy
        st = run.opt.init(params)
        for seed in (4, 5):
            _, st, _ = run.epoch(params, st, _clips(2, seed))
        steps.append(st["step"])
    assert [len(a) for a in args] == [3, 3, 4, 4]
    assert steps[0] == 4 and not isinstance(steps[0], torch.Tensor)
    assert isinstance(args[3][3], torch.Tensor) and int(args[3][3]) == 2
    assert int(steps[1]) == 4

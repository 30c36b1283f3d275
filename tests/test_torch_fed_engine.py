"""The port's batched client engines (``repro_torch.core.fed_engine``) on
the CPU: against the port's own per-iteration loop at the reference's
tolerances (``tests/test_fed_engine.py``: losses rtol 1e-4, params rtol
and atol 1e-5), and against the reference's ``fed_engine`` on the same
numpy batches and JAX-initialised, converted params (rtol 1e-3). Two
models: the reference's tiny dense LM of ``tests/test_fed_engine.py`` and
ResNet3D-18 reduced. Also the padding helpers' errors, one program per
round shape whatever H^k is drawn, outputs that outlive the next call,
the captured KD epoch against its per-step loop, the batched server mix
and the engine knob."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.core import fed_engine as jfe
from repro.core import fedasync as jfa
from repro.data import SyntheticActionDataset as JDS
from repro.data import SyntheticLMDataset
from repro.types import FedConfig as JFed
from repro.types import ModelConfig as JModel
from repro_torch.configs import get_config as tget
from repro_torch.core import distill as tdistill
from repro_torch.core import fed_engine as tfe
from repro_torch.core import fedasync as tfa
from repro_torch.core import fedavg as tfedavg
from repro_torch.core.fleet import ASYNC_ENGINES, EngineSpec
from repro_torch.data import stack_batches
from repro_torch.types import DistillConfig
from repro_torch.types import FedConfig as TFed
from repro_torch.types import ModelConfig as TModel

from torch_parity import assert_params_close, jax_params_both, port_params

TINY = dict(name="engine-test-tiny", family="dense", num_layers=1,
            d_model=32, num_heads=2, num_kv_heads=2, d_ff=64, vocab_size=64)
FED = dict(num_clients=4, global_epochs=6, local_iters_min=1,
           local_iters_max=3, lr=0.01)
MODELS = ("tiny", "resnet")


@pytest.fixture(scope="module", params=MODELS)
def model(request):
    """(name, reference config, port config, reference params, port params,
    a batch maker: (B, H, seed) -> list of H numpy batches)."""
    if request.param == "tiny":
        jc, tc = JModel(**TINY), TModel(**TINY)
        ds = SyntheticLMDataset(vocab=64, seq_len=8, seed=0)
    else:
        jc = jax_get("resnet3d-18").reduced()
        tc = tget("resnet3d-18").reduced()
        ds = JDS(num_classes=8, samples_per_class=8, seed=1)
    jp, flat = jax_params_both(jc, jax.random.PRNGKey(0))

    def batches(B, H, seed):
        return list(ds.batches(B, H, seed=seed))
    return request.param, jc, tc, jp, port_params(flat, tc), batches


def jax_get(name):
    from repro.configs import get_config
    return get_config(name)


def _close(a: dict, b: dict, rtol=1e-5, atol=1e-5):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), rtol=rtol,
                                   atol=atol, err_msg=k)


def test_scan_client_matches_loop(model):
    _, _, tc, _, tp, batches = model
    fed = TFed(**FED)
    bl = batches(2, 3, 7)
    w_loop, tau, l_loop = tfa.client_update(tp, 5, iter(bl), tc, fed,
                                            num_iters=3)
    w_scan, l_scan = tfe.ClientRun(tc, fed)(tp, stack_batches(iter(bl)))
    assert tau == 5 and l_scan.shape == (3,)
    np.testing.assert_allclose(l_scan.numpy(), l_loop, rtol=1e-4)
    _close(w_loop, w_scan)


def test_client_run_matches_reference(model):
    _, jc, tc, jp, tp, batches = model
    stacked = stack_batches(iter(batches(2, 3, 3)))
    jw, jl = jfe.ClientRun(jc, JFed(**FED))(jp, stacked)
    tw, tl = tfe.ClientRun(tc, TFed(**FED))(tp, stacked)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-3)
    assert_params_close(jw, tw, rtol=1e-3, atol=1e-5)


def test_run_batch_padded_matches_loop_and_reference(model):
    """Clients of H^k = 3, 1 and 0 (out of data) in one padded call: each
    equals its own loop run, its losses are NaN past H^k, the empty
    client returns the anchor; and the call equals the reference's."""
    _, jc, tc, jp, tp, batches = model
    fed = TFed(**FED)
    lists = [batches(2, 3, 0), batches(2, 1, 1), []]
    stacks = [stack_batches(iter(bl)) for bl in lists]
    padded, iters = tfe.pad_client_batches(stacks, H_max=3)
    assert iters.tolist() == [3, 1, 0]
    run = tfe.ClientRun(tc, fed)
    w_news, losses = run.run_batch(tp, padded, iters)
    assert losses.shape == (3, 3)
    for j, (w, bl) in enumerate(zip(run.unstack(w_news, 3), lists)):
        w_loop, _, l_loop = tfa.client_update(tp, 0, iter(bl), tc, fed,
                                              num_iters=len(bl))
        np.testing.assert_allclose(losses[j, :len(bl)].numpy(), l_loop,
                                   rtol=1e-4)
        assert torch.isnan(losses[j, len(bl):]).all()
        _close(w_loop, w)
    jw, jl = jfe.ClientRun(jc, JFed(**FED)).run_batch(jp, padded, iters)
    np.testing.assert_allclose(losses.numpy(), np.asarray(jl), rtol=1e-3)
    assert_params_close(jax.tree_util.tree_map(lambda a: a[0], jw),
                        run.unstack(w_news, 3)[0], rtol=1e-3, atol=1e-5)


def test_one_program_per_round_shape_whatever_the_draw(model):
    """Three H^k draws at one (n_clients, H_max) shape: one program; the
    unpadded run: one per distinct H."""
    _, _, tc, _, tp, batches = model
    run = tfe.ClientRun(tc, TFed(**FED))
    stacks = [stack_batches(iter(batches(2, 3, k))) for k in range(3)]
    padded, _ = tfe.pad_client_batches(stacks)
    for draw in ([3, 2, 1], [1, 1, 3], [2, 3, 2]):
        _, losses = run.run_batch(tp, padded, np.asarray(draw, np.int32))
        assert (~torch.isnan(losses)).sum(1).tolist() == draw
    assert run.num_compiled == 1
    for H in (1, 3, 3):
        run(tp, stack_batches(iter(batches(2, H, H))))
    assert run.num_compiled == 3


def test_outputs_outlive_the_next_call(model):
    """Two dispatches through one program: the first w_new still equals
    the loop's after the second ran (nothing returned aliases the
    engine's buffers)."""
    _, _, tc, _, tp, batches = model
    fed = TFed(**FED)
    run = tfe.ClientRun(tc, fed)
    first, second = batches(2, 2, 11), batches(2, 2, 12)
    w1, _ = run(tp, stack_batches(iter(first)))
    w2, _ = run(tp, stack_batches(iter(second)))
    w_loop, _, _ = tfa.client_update(tp, 0, iter(first), tc, fed,
                                     num_iters=2)
    _close(w_loop, w1)
    assert any(not torch.equal(w1[k], w2[k]) for k in w1)


def test_sync_round_matches_loop_and_reference(model):
    """Homogeneous clients with data-size weights, then a ragged round
    (H^k = 3, 1) on the padded path: the round equals the loop oracle,
    and the homogeneous one the reference's vmap round."""
    _, jc, tc, jp, tp, batches = model
    fed = TFed(**FED)
    sizes = [10, 30, 60]
    lists = [batches(2, 3, k) for k in range(3)]
    g_loop, l_loop = tfedavg.fedavg_round_loop(
        tp, [iter(b) for b in lists], tc, fed, data_sizes=sizes)
    g_scan, l_scan = tfedavg.fedavg_round(
        tp, [iter(b) for b in lists], tc, fed, data_sizes=sizes)
    np.testing.assert_allclose(l_scan, l_loop, rtol=1e-4)
    _close(g_loop, g_scan)
    jg, jl = jfe.SyncRound(jc, JFed(**FED))(
        jp, [stack_batches(iter(b)) for b in lists],
        weights=np.asarray(sizes, np.float32) / 100)
    np.testing.assert_allclose(np.ravel(l_scan), np.ravel(jl), rtol=1e-3)
    assert_params_close(jg, g_scan, rtol=1e-3, atol=1e-5)
    ragged = [batches(2, 3, 5), batches(2, 1, 6)]
    g_loop, l_loop = tfedavg.fedavg_round_loop(
        tp, [iter(b) for b in ragged], tc, fed)
    g_pad, l_pad = tfedavg.fedavg_round(tp, [iter(b) for b in ragged], tc,
                                        fed)
    assert [len(x) for x in l_pad] == [3, 1]
    np.testing.assert_allclose(np.concatenate(l_pad),
                               np.concatenate(l_loop), rtol=1e-4)
    _close(g_loop, g_pad)


def test_ragged_within_client_falls_back(model):
    """Batch shapes that do not stack within a client drop that client to
    the per-iteration loop; generators survive (raggedness is found after
    the batches are taken)."""
    _, _, tc, _, tp, batches = model
    fed = TFed(**FED)
    uniform = batches(2, 3, 0)
    ragged = batches(2, 2, 1) + batches(1, 1, 2)
    g_loop, l_loop = tfedavg.fedavg_round_loop(
        tp, [iter(uniform), iter(ragged)], tc, fed)
    g_new, l_new = tfedavg.fedavg_round(
        tp, (b for b in [iter(uniform), iter(ragged)]), tc, fed)
    assert [len(x) for x in l_new] == [len(x) for x in l_loop]
    np.testing.assert_allclose(np.concatenate(l_new),
                               np.concatenate(l_loop), rtol=1e-4)
    _close(g_loop, g_new)


def _arr(*shape, dtype=np.float32):
    return np.zeros(shape, dtype)


def test_stack_and_pad_errors_and_empty_clients():
    a = {"x": _arr(3, 2, 4), "y": _arr(3, 2, dtype=np.int32)}
    b = {"x": _arr(1, 2, 4), "y": _arr(1, 2, dtype=np.int32)}
    assert tfe.stack_client_batches([a, a])["x"].shape == (2, 3, 2, 4)
    with pytest.raises(ValueError, match="pad_client_batches"):
        tfe.stack_client_batches([a, b])
    with pytest.raises(ValueError, match="no client"):
        tfe.stack_client_batches([])
    stacked, iters = tfe.pad_client_batches([a, None, b, {}])
    assert iters.tolist() == [3, 0, 1, 0]
    assert stacked["x"].shape == (4, 3, 2, 4)
    assert stacked["y"].dtype == np.int32
    with pytest.raises(ValueError, match="no client"):
        tfe.pad_client_batches([])
    with pytest.raises(ValueError, match="all clients empty"):
        tfe.pad_client_batches([None, {}])
    with pytest.raises(ValueError, match="exceed"):
        tfe.pad_client_batches([a], H_max=2)
    with pytest.raises(ValueError, match="keys"):
        tfe.pad_client_batches([a, {"x": _arr(1, 2, 4),
                                    "z": _arr(1, 2, dtype=np.int32)}])
    with pytest.raises(ValueError, match="shapes/dtypes"):
        tfe.pad_client_batches([a, {"x": _arr(1, 3, 4),
                                    "y": _arr(1, 2, dtype=np.int32)}])
    # the reference pads the same way
    jstacked, jiters = jfe.pad_client_batches([a, None, b])
    ours, our_iters = tfe.pad_client_batches([a, None, b])
    np.testing.assert_array_equal(our_iters, jiters)
    for k in ours:
        np.testing.assert_array_equal(ours[k], jstacked[k])


def test_captured_kd_epoch_equals_its_step_loop():
    """``DistillEngine.epoch`` (one call; one graph per (H, batch shape) on
    the card) equals H calls of ``step``; the same for ``ScratchRun``."""
    tcfg = tget("resnet3d-34").reduced()
    scfg = tget("resnet3d-18").reduced()
    gen = torch.Generator().manual_seed(0)
    from repro_torch.models import registry
    teacher = registry.init_params(gen, tcfg, "cpu")
    student = registry.init_params(gen, scfg, "cpu")
    ds = JDS(num_classes=8, samples_per_class=8, seed=1)
    stacked = stack_batches(ds.batches(2, 3, seed=4))
    dcfg = DistillConfig(lr=0.01)
    engine = tdistill.DistillEngine(tcfg, scfg, dcfg, kd_kernel="cuda")
    scratch = tdistill.ScratchRun(scfg, dcfg)
    for run, fixed in ((engine, (teacher,)), (scratch, ())):
        p, st, losses = run.epoch(*fixed, student, run.opt.init(student),
                                  stacked)
        q, sq = student, run.opt.init(student)
        want = []
        for i in range(3):
            q, sq, loss = run.step(*fixed, q, sq,
                                   {k: v[i] for k, v in stacked.items()})
            want.append(float(loss))
        np.testing.assert_allclose(losses.numpy(), want, rtol=1e-6)
        assert st["step"] == sq["step"] == 3
        for k in p:
            torch.testing.assert_close(p[k], q[k], rtol=1e-6, atol=1e-7)
            torch.testing.assert_close(st["mom"][k], sq["mom"][k],
                                       rtol=1e-6, atol=1e-7)
        assert run.num_compiled == 1
    assert tdistill.make_distill_engine(tcfg, scfg, dcfg) is \
        tdistill.make_distill_engine(tcfg, scfg, dcfg)


def test_batched_server_update_matches_reference(rng):
    """A group of three receives in one call equals three chained scalar
    mixes and the reference's fused mix."""
    shapes = {"a": (4, 5), "b": (7,)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    w_news = [{k: rng.standard_normal(s).astype(np.float32)
               for k, s in shapes.items()} for _ in range(3)]
    fed = TFed(**FED)
    _, betas = tfa.group_mixing_weights(fed, 5, [5, 3, 1])
    t = lambda d: {k: torch.tensor(v) for k, v in d.items()}
    got = tfa.make_batched_server_update(fed)(t(params), betas,
                                              *[t(w) for w in w_news])
    chained = t(params)
    for w, b in zip(w_news, betas):
        chained = tfa._mix(chained, t(w), b)
    want = jfa.make_batched_server_update(JFed(**FED))(
        {k: jnp.asarray(v) for k, v in params.items()},
        jnp.asarray(betas, jnp.float32),
        *[{k: jnp.asarray(v) for k, v in w.items()} for w in w_news])
    for k in shapes:
        assert torch.equal(got[k], chained[k])
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-7)


def test_engine_spec_and_memo():
    assert EngineSpec.from_str("scan") is EngineSpec.SCAN
    assert ASYNC_ENGINES == (EngineSpec.SCAN, EngineSpec.LOOP)
    with pytest.raises(ValueError, match="engine must be one of"):
        EngineSpec.from_str("vmap")
    with pytest.raises(ValueError, match="not supported here"):
        EngineSpec.from_str("shard", allowed=ASYNC_ENGINES)
    cfg = tget("resnet3d-18").reduced()
    fed = TFed(**FED)
    assert EngineSpec.LOOP.build_sync(cfg, fed) is None
    assert isinstance(EngineSpec.SCAN.build_sync(cfg, fed), tfe.SyncRound)
    # the sharded and hierarchical rounds, memoized on their mesh (a
    # world of one on the CPU here)
    for spec in (EngineSpec.SHARD, EngineSpec.HIER):
        rnd = spec.build_sync(cfg, fed, device="cpu")
        assert isinstance(rnd, tfe.ShardedSyncRound)
        assert spec.build_sync(cfg, fed, device="cpu") is rnd
    # a stateful algorithm gets its own engine, whose call equals the
    # algorithm-aware loop oracle
    from repro_torch.core import algorithms as talg
    scaffold = tfe.make_client_run(cfg, fed, algorithm="scaffold")
    assert isinstance(scaffold.algorithm, talg.Scaffold)
    assert tfe.make_client_run(cfg, fed, algorithm=talg.Scaffold()) is \
        scaffold
    from repro_torch.models import registry as treg
    ds = JDS(num_classes=8, samples_per_class=8, seed=1)
    tp = treg.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    bl = list(ds.batches(2, fed.local_iters_max, seed=3))
    alg = talg.Scaffold()
    w, st, msg, losses = scaffold(tp, stack_batches(bl),
                                  server_ctx=alg.ctx_for(tp),
                                  state=alg.state_for(0, tp))
    lw, lst, lmsg, ll = talg.client_update_loop(tp, bl, cfg, fed, alg)
    np.testing.assert_allclose(losses.numpy(), ll, rtol=1e-4)
    for k in tp:
        for a, b in ((w, lw), (st, lst), (msg, lmsg)):
            np.testing.assert_allclose(a[k].numpy(), b[k].numpy(),
                                       rtol=1e-5, atol=1e-5, err_msg=k)
    # server-side knobs share an engine; client-side ones do not
    run = tfe.make_client_run(cfg, fed)
    assert tfe.make_client_run(cfg, TFed(**FED, mixing_beta=0.3)) is run
    assert tfe.make_client_run(cfg, TFed(**{**FED, "lr": 0.02})) is not run
    assert tfe.make_sync_round(cfg, fed).client is run

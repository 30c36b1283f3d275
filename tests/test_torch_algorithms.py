"""The port's federated-algorithm layer (``repro_torch.core.algorithms``)
on the CPU, mirroring ``tests/test_algorithms.py`` on the reference's tiny
dense LM (the sharded and hierarchical rounds are ROADMAP Queue 1 item
13; SCAFFOLD ≥ FedProx fails on the reference itself, Queue 3).

Both packages get the same numpy batches and the same JAX-initialised
params. Tolerances: the batched engines against the port's loop oracle,
and the port against the reference, at the reference's own (params and
variates rtol 1e-4, atol 1e-5; losses rtol 1e-4; low-rank atol 1e-4);
FedProx through the layer ``==`` the default path; LowRank masks, wire
bytes and virtual clocks exactly. Also the paper's convergence bound
(``core/convergence.py``) equal to the reference's, and the SCAFFOLD and
proximal helpers of ``optim/proximal.py``."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.checkpoint.ckpt import _flatten
from repro.configs import get_config as jget
from repro.core import algorithms as jalg
from repro.core import compression as jcomp
from repro.core import convergence as jconv
from repro.core import fedavg as jfedavg
from repro.core import simulator as jsim
from repro.core.fleet import Fleet as JFleet
from repro.data import BatchLoader as JLoader
from repro.data import SyntheticLMDataset
from repro.optim import control_variate_grad as j_cvg
from repro.optim.proximal import proximal_penalty as j_pen
from repro.types import FedConfig as JFed
from repro.types import ModelConfig as JModel
from repro_torch.checkpoint.convert import params_to_numpy
from repro_torch.configs import get_config as tget
from repro_torch.core import algorithms as talg
from repro_torch.core import compression as tcomp
from repro_torch.core import convergence as tconv
from repro_torch.core import fed_engine as tfe
from repro_torch.core import fedavg as tfedavg
from repro_torch.core import simulator as tsim
from repro_torch.core.fleet import JETSON_FLEET_HMDB51, Fleet
from repro_torch.data import BatchLoader as TLoader
from repro_torch.optim import control_variate_grad as t_cvg
from repro_torch.optim import proximal_penalty as t_pen
from repro_torch.types import FedConfig as TFed
from repro_torch.types import ModelConfig as TModel

from torch_parity import assert_params_close, jax_params_both, port_params

TINY = dict(name="alg-test-tiny", family="dense", num_layers=1, d_model=32,
            num_heads=2, num_kv_heads=2, d_ff=64, vocab_size=64)
FED = dict(num_clients=3, global_epochs=4, local_iters_min=1,
           local_iters_max=3, lr=0.01)
TOL = dict(rtol=1e-4, atol=1e-5)
LOWRANK_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def setup():
    jc, tc = JModel(**TINY), TModel(**TINY)
    jp, flat = jax_params_both(jc, jax.random.PRNGKey(0))
    ds = SyntheticLMDataset(vocab=64, seq_len=8, seed=0)
    return jc, tc, jp, port_params(flat, tc), ds


def client_lists(ds, n, Hs=None, seed0=0):
    Hs = Hs or [FED["local_iters_max"]] * n
    return [list(ds.batches(2, h, seed=seed0 + k)) for k, h in enumerate(Hs)]


def tree_close(jtree, tdict, tol):
    """A reference pytree against the port's flat dict, leaf by leaf."""
    assert_params_close(jtree, tdict, **tol)


def flat_equal(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def _fleet(Loader, ds, n=3):
    return [Loader(ds, 2, steps=4, seed=k) for k in range(n)]


def _tfleet(ds, n=3):
    return Fleet.from_lists(list(JETSON_FLEET_HMDB51)[:n], _fleet(TLoader, ds,
                                                                  n))


def _jfleet(ds, n=3):
    return JFleet.from_lists(list(JETSON_FLEET_HMDB51)[:n],
                             _fleet(JLoader, ds, n))


def _same_clock(a, b):
    assert a.wall_clock_s == b.wall_clock_s
    assert a.staleness_hist == b.staleness_hist
    assert [h[:2] for h in a.history] == [h[:2] for h in b.history]


# ---------------------------------------------------------------------------
# The algorithm knob and FedProx
# ---------------------------------------------------------------------------

def test_make_algorithm_validates():
    assert isinstance(talg.make_algorithm("scaffold"), talg.Scaffold)
    assert isinstance(talg.make_algorithm("FedProx"), talg.FedProx)
    alg = talg.LowRankSubmodel()
    assert talg.make_algorithm(alg) is alg
    with pytest.raises(ValueError) as e:
        talg.make_algorithm("fedavgm")
    for name in sorted(talg.ALGORITHMS):
        assert name in str(e.value)
    assert sorted(talg.ALGORITHMS) == sorted(jalg.ALGORITHMS)
    with pytest.raises(ValueError, match="capacity"):
        talg.LowRankSubmodel(capacity=1.5)
    # the engines key on cache_key(): equal keys share an engine
    cfg = tget("resnet3d-18").reduced()
    fed = TFed(**FED)
    assert tfe.make_client_run(cfg, fed, algorithm=talg.FedProx()) is \
        tfe.make_client_run(cfg, fed)
    sc = tfe.make_sync_round(cfg, fed, algorithm="scaffold")
    assert sc is tfe.make_sync_round(cfg, fed, algorithm=talg.Scaffold())
    assert sc.client is not tfe.make_client_run(cfg, fed)


def test_fedprox_through_the_layer_is_the_default_path(setup):
    """algorithm=FedProx() runs exactly what algorithm=None runs: the sync
    round on both engines, and the loop oracle's step against the plain
    client step."""
    _, tc, _, tp, ds = setup
    fed = TFed(**FED)
    bl = client_lists(ds, 3)
    for engine in ("scan", "loop"):
        g0, l0 = tfedavg.fedavg_round(tp, [iter(b) for b in bl], tc, fed,
                                      engine=engine)
        g1, l1 = tfedavg.fedavg_round(tp, [iter(b) for b in bl], tc, fed,
                                      engine=engine, algorithm=talg.FedProx())
        flat_equal(g0, g1)
        assert l0 == l1
    w, st, msg, losses = talg.client_update_loop(
        tp, bl[0], tc, fed, talg.FedProx())
    from repro_torch.core.fedasync import client_update
    w2, _, losses2 = client_update(tp, 0, bl[0], tc, fed)
    flat_equal(w, w2)
    assert losses == losses2 and st == () and msg == ()


@pytest.mark.parametrize("engine", ["scan", "loop"])
def test_async_fedprox_explicit_is_bit_identical(setup, engine):
    """``run_async`` without an algorithm is FedProx, and FedProx's wire
    codec is the plain int8 / int4 delta round trip, bit for bit."""
    _, tc, _, tp, ds = setup
    fed = TFed(**FED)
    r0 = tsim.run_async(tp, tc, fed, _tfleet(ds), engine=engine,
                        device="cpu")
    r1 = tsim.run_async(tp, tc, fed, _tfleet(ds), engine=engine,
                        algorithm=talg.FedProx(), device="cpu")
    flat_equal(r0.params, r1.params)
    assert r0.final_loss == r1.final_loss
    _same_clock(r0, r1)
    alg = talg.FedProx()
    for bits in (8, 4):
        fb = TFed(**FED, compress_bits=bits)
        got, msg = alg.decode(alg.encode(r1.params, (), tp, fb), tp, fb)
        flat_equal(got, tcomp.roundtrip(r1.params, tp, bits)[0])
        assert msg == ()


def test_stateful_engine_calls_need_the_callers_state(setup):
    """The memoized engine is shared by every equal-keyed instance, so a
    stateful call without the caller's server context and states raises
    instead of reading another instance's."""
    from repro_torch.data import stack_batches
    _, tc, _, tp, ds = setup
    fed = TFed(**FED)
    run = tfe.make_client_run(tc, fed, algorithm="scaffold")
    rnd = tfe.make_sync_round(tc, fed, algorithm="scaffold")
    alg = talg.Scaffold()
    s = stack_batches(iter(client_lists(ds, 1)[0]))
    for call in (lambda: run(tp, s),
                 lambda: run(tp, s, server_ctx=alg.ctx_for(tp)),
                 lambda: run.run_batch(
                     tp, [s, s], states=alg.stacked_states(tp, [0, 1])),
                 lambda: rnd(tp, [s, s], server_ctx=alg.ctx_for(tp))):
        with pytest.raises(ValueError, match="server_ctx"):
            call()


# ---------------------------------------------------------------------------
# SCAFFOLD: engines against the loop oracle and the reference
# ---------------------------------------------------------------------------

def test_scaffold_round_matches_loop_and_reference(setup):
    jc, tc, jp, tp, ds = setup
    fed, jfed = TFed(**FED), JFed(**FED)
    loop, eng, ref = talg.Scaffold(), talg.Scaffold(), jalg.Scaffold()
    g = {"loop": tp, "eng": tp, "ref": jp}
    for rnd in range(2):              # 2 rounds: state must thread through
        bl = client_lists(ds, 3, seed0=10 * rnd)
        g["loop"], l_loop = tfedavg.fedavg_round_loop(
            g["loop"], [iter(b) for b in bl], tc, fed, algorithm=loop)
        g["eng"], l_eng = tfedavg.fedavg_round(
            g["eng"], [iter(b) for b in bl], tc, fed, algorithm=eng)
        g["ref"], l_ref = jfedavg.fedavg_round(
            g["ref"], [iter(b) for b in bl], jc, jfed, algorithm=ref)
        for k in g["loop"]:
            np.testing.assert_allclose(g["eng"][k].numpy(),
                                       g["loop"][k].numpy(), **TOL)
        tree_close(g["ref"], g["eng"], TOL)
        np.testing.assert_allclose(np.ravel(l_eng), np.ravel(l_loop),
                                   rtol=1e-4)
        np.testing.assert_allclose(np.ravel(l_eng), np.ravel(l_ref),
                                   rtol=1e-4)
    tree_close(ref.ctx_for(jp), eng.ctx_for(tp), TOL)
    tree_close(ref.ctx_for(jp), loop.ctx_for(tp), TOL)
    for k in range(3):
        tree_close(ref.state_for(k, jp), eng.state_for(k, tp), TOL)
        tree_close(ref.state_for(k, jp), loop.state_for(k, tp), TOL)
    # the variates moved (a zero variate would pass the checks above)
    assert sum(float(v.abs().sum())
               for v in eng.state_for(0, tp).values()) > 0


def test_scaffold_padded_ragged_matches_loop_and_reference(setup):
    """Heterogeneous H^k through the padded masked round; a client of zero
    iterations keeps its variate."""
    jc, tc, jp, tp, ds = setup
    fed, jfed = TFed(**FED), JFed(**FED)
    Hs = [3, 1, 2]
    for lens in (Hs, [3, 0, 2]):
        loop, eng, ref = talg.Scaffold(), talg.Scaffold(), jalg.Scaffold()
        bl = client_lists(ds, 3, Hs=lens, seed0=40)
        g_loop, _ = tfedavg.fedavg_round_loop(
            tp, [iter(b) for b in bl], tc, fed, algorithm=loop)
        g_eng, l_eng = tfedavg.fedavg_round(
            tp, [iter(b) for b in bl], tc, fed, algorithm=eng)
        g_ref, _ = jfedavg.fedavg_round(
            jp, [iter(b) for b in bl], jc, jfed, algorithm=ref)
        assert [len(x) for x in l_eng] == lens
        for k in g_loop:
            np.testing.assert_allclose(g_eng[k].numpy(), g_loop[k].numpy(),
                                       **TOL)
        tree_close(g_ref, g_eng, TOL)
        for k in range(3):
            tree_close(ref.state_for(k, jp), eng.state_for(k, tp), TOL)
            tree_close(ref.state_for(k, jp), loop.state_for(k, tp), TOL)
    assert all(float(v.abs().max()) == 0.0
               for v in eng.state_for(1, tp).values())


@pytest.mark.parametrize("alg", ["scaffold", "lowrank"])
def test_async_scan_matches_loop_and_reference(setup, alg):
    """Algorithm 1 with a stateful algorithm: the variate delta (or the
    low-rank projection on the wire) rides the staleness-damped mix alike
    on both engines and in the reference."""
    jc, tc, jp, tp, ds = setup
    tol = TOL if alg == "scaffold" else LOWRANK_TOL
    outs = {eng: tsim.run_async(tp, tc, TFed(**FED), _tfleet(ds),
                                engine=eng, algorithm=alg, device="cpu")
            for eng in ("scan", "loop")}
    ref = jsim.run_async(jp, jc, JFed(**FED), _jfleet(ds), engine="scan",
                         algorithm=jalg.make_algorithm(alg))
    _same_clock(outs["scan"], outs["loop"])
    _same_clock(outs["scan"], ref)
    for k in outs["loop"].params:
        np.testing.assert_allclose(outs["scan"].params[k].numpy(),
                                   outs["loop"].params[k].numpy(), **tol)
    tree_close(ref.params, outs["scan"].params, tol)
    np.testing.assert_allclose([h[2] for h in outs["scan"].history],
                               [h[2] for h in ref.history], rtol=1e-4)


@pytest.mark.parametrize("alg", ["scaffold", "lowrank"])
def test_run_sync_scan_matches_loop_and_reference(setup, alg):
    jc, tc, jp, tp, ds = setup
    tol = TOL if alg == "scaffold" else LOWRANK_TOL
    fed = dict(FED, global_epochs=6)            # two rounds
    outs = {eng: tsim.run_sync(tp, tc, TFed(**fed), _tfleet(ds), engine=eng,
                               algorithm=alg, device="cpu")
            for eng in ("scan", "loop")}
    ref = jsim.run_sync(jp, jc, JFed(**fed), _jfleet(ds), engine="scan",
                        algorithm=jalg.make_algorithm(alg))
    assert len(ref.history) == 2
    for res in outs.values():
        assert res.wall_clock_s == ref.wall_clock_s
        assert [h[:2] for h in res.history] == [h[:2] for h in ref.history]
        tree_close(ref.params, res.params, tol)
        np.testing.assert_allclose([h[2] for h in res.history],
                                   [h[2] for h in ref.history], rtol=1e-4)


# ---------------------------------------------------------------------------
# Low-rank / masked submodels
# ---------------------------------------------------------------------------

def test_lowrank_round_matches_loop_and_reference(setup):
    jc, tc, jp, tp, ds = setup
    bl = client_lists(ds, 3, Hs=[3, 2, 3], seed0=90)
    loop, eng, ref = (talg.LowRankSubmodel(), talg.LowRankSubmodel(),
                      jalg.LowRankSubmodel())
    g_loop, _ = tfedavg.fedavg_round_loop(
        tp, [iter(b) for b in bl], tc, TFed(**FED), algorithm=loop)
    g_eng, _ = tfedavg.fedavg_round(
        tp, [iter(b) for b in bl], tc, TFed(**FED), algorithm=eng)
    g_ref, _ = jfedavg.fedavg_round(
        jp, [iter(b) for b in bl], jc, JFed(**FED), algorithm=ref)
    for k in g_loop:
        np.testing.assert_allclose(g_eng[k].numpy(), g_loop[k].numpy(),
                                   **LOWRANK_TOL)
    tree_close(g_ref, g_eng, LOWRANK_TOL)
    # the split round: the client half and the fold, the SVD between them
    rnd = tfe.SyncRound(tc, TFed(**FED), algorithm=talg.LowRankSubmodel())
    g_split, _ = tfedavg.fedavg_round(tp, [iter(b) for b in bl], tc,
                                      TFed(**FED), engine=rnd,
                                      algorithm=talg.LowRankSubmodel())
    flat_equal(g_split, g_eng)
    assert rnd.num_compiled == 2


def _ref_mask_flat(ref_state) -> dict:
    return {k: np.asarray(v) for k, v in _flatten(ref_state["mask"]).items()}


@pytest.mark.parametrize("model", ["tiny", "resnet"])
def test_lowrank_masks_equal_reference(setup, model):
    """Each client's seeded mask, drawn in the reference's leaf order and
    shape (conv weights DHWIO, then laid out OIDHW), equals the
    reference's bit for bit for clients 0-3, and so does its capacity."""
    if model == "tiny":
        _, _, jp, tp, _ = setup
    else:
        jc, tc = jget("resnet3d-18").reduced(), tget("resnet3d-18").reduced()
        jp, flat = jax_params_both(jc, jax.random.PRNGKey(0))
        tp = port_params(flat, tc)
    for kwargs in ({}, {"capacity": 0.6, "seed": 3}):
        ta, ja = talg.LowRankSubmodel(**kwargs), jalg.LowRankSubmodel(**kwargs)
        ta.bind_fleet(_tfleet(None, 4))
        ja.bind_fleet(_jfleet(None, 4))
        for k in range(4):
            got, want = ta.client_init(tp, k), ja.client_init(jp, k)
            assert got["cap"].numpy().tobytes() == \
                np.asarray(want["cap"]).tobytes()
            gm = params_to_numpy(got["mask"])
            wm = _ref_mask_flat(want)
            assert gm.keys() == wm.keys()
            for key in wm:
                assert gm[key].shape == wm[key].shape, key
                np.testing.assert_array_equal(gm[key], wm[key], err_msg=key)
            assert 0 < np.mean(np.concatenate(
                [m.ravel() for m in gm.values() if m.size > 1])) < 1


def test_lowrank_capacity_follows_fleet_speed(setup):
    alg, ref = talg.LowRankSubmodel(), jalg.LowRankSubmodel()
    fleet, jfleet = _tfleet(None, 4), _jfleet(None, 4)
    alg.bind_fleet(fleet)
    ref.bind_fleet(jfleet)
    caps = [alg.capacity_for(k) for k in range(4)]
    assert caps == [ref.capacity_for(k) for k in range(4)]
    assert [fleet.capacity(k) for k in range(4)] == \
        [jfleet.capacity(k) for k in range(4)]
    assert all(0.0 < c <= 1.0 for c in caps)
    times = [fleet.profile(k).epoch_seconds for k in range(4)]
    assert caps[int(np.argmin(times))] == max(caps)
    assert caps[int(np.argmax(times))] == min(caps)


def test_lowrank_wire_beats_dense_and_equals_reference(setup):
    """At matched widths the truncated factors ship fewer bytes than the
    dense delta; wire and base bytes equal the reference's to the byte on
    the same update, and the decoded update agrees with it."""
    jc, tc, jp, tp, ds = setup
    alg, ref = talg.LowRankSubmodel(), jalg.LowRankSubmodel()
    fed = TFed(**FED)
    w_new, _, msg, _ = talg.client_update_loop(
        tp, client_lists(ds, 1, seed0=5)[0], tc, fed, alg)
    jw = jax.tree_util.tree_map(
        jnp.asarray, _unflatten_like(jp, params_to_numpy(w_new)))
    jmsg = jnp.float32(float(msg))
    sizes = {}
    for bits in (0, 8, 4):
        tf, jf = TFed(**FED, compress_bits=bits), JFed(**FED,
                                                      compress_bits=bits)
        got = alg.encode(w_new, msg, tp, tf)
        want = ref.encode(jw, jmsg, jp, jf)
        assert (got.wire_bytes, got.base_bytes) == (want.wire_bytes,
                                                    want.base_bytes)
        assert got.meta == want.meta
        dec, cap = alg.decode(got, tp, tf)
        jdec, jcap = ref.decode(want, jp, jf)
        assert float(cap) == float(jcap)
        tree_close(jdec, dec, LOWRANK_TOL)
        sizes[bits] = got.wire_bytes
    dense8 = tcomp.quantize_delta(w_new, tp, 8)
    assert sizes[8] < dense8.wire_bytes
    assert sizes[4] < sizes[8] < sizes[0]


def _unflatten_like(tree, flat, prefix=""):
    if isinstance(tree, dict):
        return {k: _unflatten_like(v, flat, f"{prefix}{k}/")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten_like(v, flat, f"{prefix}{i}/")
                          for i, v in enumerate(tree))
    return flat[prefix[:-1]]


def test_scaffold_codec_and_server_reduce_equal_reference(setup):
    """SCAFFOLD's loop oracle, its wire (the params' and the variate
    delta's codes, given the same update on both sides) and the eager
    fold ``server_reduce`` against the reference's."""
    jc, tc, jp, tp, ds = setup
    alg, ref = talg.Scaffold(), jalg.Scaffold()
    bl = client_lists(ds, 2, seed0=7)
    ups, jups = [], []
    for k in range(2):
        w, st, msg, _ = talg.client_update_loop(tp, bl[k], tc, TFed(**FED),
                                                alg, client_id=k)
        jw, jst, jmsg, _ = jalg.client_update_loop(jp, bl[k], jc, JFed(**FED),
                                                   ref, client_id=k)
        tree_close(jmsg, msg, TOL)
        tree_close(jst, st, TOL)
        ups.append((w, st, msg))
        jups.append((jw, jst, jmsg))
    w, msg = ups[0][0], ups[0][2]
    jw, jmsg = (jax.tree_util.tree_map(
        jnp.asarray, _unflatten_like(jp, params_to_numpy(t)))
        for t in (w, msg))
    for bits in (0, 8, 4):
        tf, jf = TFed(**FED, compress_bits=bits), JFed(**FED,
                                                      compress_bits=bits)
        got, want = alg.encode(w, msg, tp, tf), ref.encode(jw, jmsg, jp, jf)
        assert (got.wire_bytes, got.base_bytes) == (want.wire_bytes,
                                                    want.base_bytes)
        (dw, dm), (jdw, jdm) = (alg.decode(got, tp, tf),
                                ref.decode(want, jp, jf))
        exact = dict(rtol=0, atol=0)
        tree_close(jdw, dw, exact if bits else TOL)
        tree_close(jdm, dm, exact)
    weights = np.asarray([0.25, 0.75], np.float32)
    g, ctx = talg.server_reduce(alg, tp, *[[u[i] for u in ups]
                                           for i in range(3)], weights)
    jg, jctx = jalg.server_reduce(ref, jp, *[[u[i] for u in jups]
                                            for i in range(3)],
                                  jnp.asarray(weights))
    tree_close(jg, g, TOL)
    tree_close(jctx, ctx, TOL)


def test_proximal_helpers_and_convergence_bound_equal_reference():
    r = np.random.default_rng(0)
    shapes = {"a": (5,), "b": (3, 4)}
    g, c, ck, p, a = ({k: r.standard_normal(s).astype(np.float32)
                       for k, s in shapes.items()} for _ in range(5))

    def tt(d):
        return {k: torch.tensor(v) for k, v in d.items()}

    def jj(d):
        return {k: jnp.asarray(v) for k, v in d.items()}
    got = t_cvg(tt(g), tt(c), tt(ck))
    want = j_cvg(jj(g), jj(c), jj(ck))
    for k in shapes:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    for theta in (0.0, 0.01):
        np.testing.assert_allclose(float(t_pen(tt(p), tt(a), theta)),
                                   float(j_pen(jj(p), jj(a), theta)),
                                   rtol=1e-6)
        # the penalty lives on the params' device, zero included
        meta = {k: v.to("meta") for k, v in tt(p).items()}
        assert t_pen(meta, meta, theta).device.type == "meta"
    for fed in (TFed(), TFed(local_iters_min=2, local_iters_max=5,
                             lr=0.02)):
        jfed = JFed(**dataclasses.asdict(fed))
        assert fed.imbalance_ratio == jfed.imbalance_ratio
        b, jb = (tconv.BoundInputs.from_fed(fed, F0_minus_FE=2.0),
                 jconv.BoundInputs.from_fed(jfed, F0_minus_FE=2.0))
        assert dataclasses.asdict(b) == dataclasses.asdict(jb)
        assert tconv.bound_terms(b) == jconv.bound_terms(jb)
        assert tconv.bound(b) == jconv.bound(jb)
        assert tconv.asymptotic_bound(b) == jconv.asymptotic_bound(jb)
    assert tconv.min_theta(0.1, 1.0, 1.0, 4.0) == \
        jconv.min_theta(0.1, 1.0, 1.0, 4.0)
    assert tconv.lr_schedule_for_asymptotic(80) == \
        jconv.lr_schedule_for_asymptotic(80)

"""Algorithm 1 in the port vs the reference's per-iteration loop oracle
(``run_async(engine="loop")``) on the same fleet, data and init: the
virtual clock, staleness and group histograms and the event trace match
exactly; losses and params to rtol 1e-3."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.checkpoint.ckpt import _flatten
from repro.configs import get_config as jget
from repro.core import fedasync as jfa
from repro.core import simulator as jsim
from repro.core.fleet import Fleet as JFleet
from repro.data import BatchLoader as JLoader
from repro.data import SyntheticActionDataset as JDS
from repro.data import iid_partition
from repro.models import registry as jreg
from repro.types import FedConfig as JFed
from repro_torch.configs import get_config as tget
from repro_torch.core import fedasync as tfa
from repro_torch.core import simulator as tsim
from repro_torch.core.fleet import JETSON_FLEET_HMDB51, Fleet
from repro_torch.data import BatchLoader as TLoader
from repro_torch.data import SyntheticActionDataset as TDS
from repro_torch.types import FedConfig as TFed

from torch_parity import assert_params_close, port_params

FED = dict(num_clients=4, global_epochs=6, local_iters_min=1,
           local_iters_max=2, lr=0.05)


@pytest.fixture(scope="module")
def setup():
    jc, tc = jget("resnet3d-18").reduced(), tget("resnet3d-18").reduced()
    jp = jax.jit(jreg.init_params, static_argnums=(1,))(
        jax.random.PRNGKey(0), jc)
    return jc, tc, jp, port_params(_flatten(jp), tc)


def _loaders(Loader, DS, n=4):
    ds = DS(num_classes=8, samples_per_class=8, seed=1)
    parts = iid_partition(len(ds), n)
    return [Loader(ds, 2, steps=4, seed=k, indices=parts[k])
            for k in range(n)]


def _tree(rng, shapes=((4, 3), (5,))):
    return {f"l{i}": rng.standard_normal(s).astype(np.float32)
            for i, s in enumerate(shapes)}


def test_group_mixing_weights_equal(rng):
    for fed_kw in ({}, {"max_staleness": 2, "staleness_a": 1.3}):
        jf, tf = JFed(**fed_kw), TFed(**fed_kw)
        for t in (0, 3, 40):
            taus = [int(x) for x in rng.integers(0, t + 1, 5)]
            assert tfa.group_mixing_weights(tf, t, taus) == \
                jfa.group_mixing_weights(jf, t, taus)


def test_server_receive_many_equals_chained_and_reference(rng):
    p0 = _tree(rng)
    ws = [_tree(rng) for _ in range(3)]
    taus = [0, 1, 0]
    tf, jf = TFed(), JFed()
    tp0 = {k: torch.tensor(v) for k, v in p0.items()}
    tws = [{k: torch.tensor(v) for k, v in w.items()} for w in ws]
    st = tfa.ServerState(params=tp0, t=2)
    for w, tau in zip(tws, taus):
        st = tfa.server_receive(st, w, tau, tf)
    many, stals, betas = tfa.server_receive_many(
        tfa.ServerState(params=tp0, t=2), list(zip(tws, taus)), tf)
    assert (many.t, many.total_updates) == (st.t, st.total_updates) == (5, 3)
    assert all(torch.equal(many.params[k], st.params[k]) for k in p0)
    jmany, jstals, jbetas = jfa.server_receive_many(
        jfa.ServerState(params={k: jnp.asarray(v) for k, v in p0.items()},
                        t=2),
        [({k: jnp.asarray(v) for k, v in w.items()}, tau)
         for w, tau in zip(ws, taus)], jf)
    assert (stals, betas) == (jstals, jbetas)
    for k in p0:
        np.testing.assert_allclose(many.params[k].numpy(),
                                   np.asarray(jmany.params[k]),
                                   rtol=1e-6, atol=1e-7)


def test_client_update_matches(setup):
    jc, tc, jp, tp = setup
    jf, tf = JFed(**FED), TFed(**FED)
    jw, jt, jl = jfa.client_update(jp, 3, _loaders(JLoader, JDS)[0](), jc, jf,
                                   num_iters=2)
    tw, tt, tl = tfa.client_update(tp, 3, _loaders(TLoader, TDS)[0](), tc, tf,
                                   num_iters=2)
    assert jt == tt == 3 and len(tl) == len(jl) == 2
    np.testing.assert_allclose(tl, jl, rtol=1e-3)
    assert_params_close(jw, tw, rtol=1e-3, atol=1e-5)


def _trace_key(res):
    return [(e.kind, e.client, e.global_epoch, e.staleness, e.time, e.beta_t)
            for e in res.trace]


# the last case also draws the lognormal clock jitter (the host rng must
# draw in the reference's order) and evaluates every 2 global epochs
@pytest.mark.parametrize("window,per_round,jitter", [(0.0, 0, 0.0),
                                                     (300.0, 0, 0.0),
                                                     (0.0, 2, 0.3)])
def test_run_async_matches_reference_loop(setup, window, per_round, jitter):
    jc, tc, jp, tp = setup
    jf = JFed(**FED, clients_per_round=per_round)
    tf = TFed(**FED, clients_per_round=per_round)
    jevals, tevals = [], []
    jres = jsim.run_async(
        jp, jc, jf, JFleet.from_lists(JETSON_FLEET_HMDB51,
                                      _loaders(JLoader, JDS)),
        engine="loop", window=window, jitter=jitter, eval_every=2,
        eval_fn=lambda t, now, p: jevals.append((t, now)))
    tres = tsim.run_async(
        tp, tc, tf, Fleet.from_lists(JETSON_FLEET_HMDB51,
                                     _loaders(TLoader, TDS)),
        engine="loop", window=window, jitter=jitter, eval_every=2,
        eval_fn=lambda t, now, p: tevals.append((t, now)), device="cpu")
    assert tevals == jevals and len(tevals) >= 2
    assert tres.wall_clock_s == jres.wall_clock_s
    assert tres.staleness_hist == jres.staleness_hist
    assert tres.group_hist == jres.group_hist
    assert tres.max_inflight == jres.max_inflight
    assert _trace_key(tres) == _trace_key(jres)
    if window:
        assert max(tres.group_hist) > 1          # grouping happened
    np.testing.assert_allclose([h[2] for h in tres.history],
                               [h[2] for h in jres.history], rtol=1e-3)
    assert_params_close(jres.params, tres.params, rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("policy", ["skip", "stop"])
def test_scheduler_pop_window_matches_reference(policy, rng):
    a = jsim.Scheduler(window=50.0, policy=policy)
    b = tsim.Scheduler(window=50.0, policy=policy)
    for i in range(40):
        ev = (float(rng.uniform(0, 400)), int(rng.integers(0, 8)), None,
              int(rng.integers(0, 12)), float(i))
        a.push(*ev)
        b.push(*ev)
    t = 10
    while len(a):
        ga = a.pop_window(t, 3, 4)
        gb = b.pop_window(t, 3, 4)
        assert ga == gb
        t += len(ga)
    assert len(b) == 0 and a.max_inflight == b.max_inflight


# the two calls this file's refusal test made before the algorithm layer
# and the wire codec were ported now run: SCAFFOLD against the reference's
# loop oracle (losses and params rtol 1e-3), the int8 wire against the
# port's own loop (a delta within an ulp of a rounding boundary codes one
# quantum apart in the two packages, 8.1e-4 on ``fc/w`` at this lr, so the
# compressed run is held against the reference at the reference's own
# test shape, ``tests/test_torch_engine_sim.py``); the clock exactly
@pytest.mark.parametrize("algorithm,bits", [("scaffold", 0), (None, 8)])
def test_run_async_algorithm_and_compression_match_their_oracle(
        setup, algorithm, bits):
    jc, tc, jp, tp = setup
    from repro.core.algorithms import make_algorithm
    runs = [tsim.run_async(
        tp, tc, TFed(**FED, compress_bits=bits),
        Fleet.from_lists(JETSON_FLEET_HMDB51, _loaders(TLoader, TDS)),
        device="cpu", algorithm=algorithm, engine=engine)
        for engine in (("scan", "loop") if bits else ("scan",))]
    if not bits:
        runs.append(jsim.run_async(
            jp, jc, JFed(**FED),
            JFleet.from_lists(JETSON_FLEET_HMDB51, _loaders(JLoader, JDS)),
            engine="loop", algorithm=make_algorithm(algorithm)))
    tres, oracle = runs
    assert tres.wall_clock_s == oracle.wall_clock_s
    assert tres.staleness_hist == oracle.staleness_hist
    assert _trace_key(tres) == _trace_key(oracle)
    np.testing.assert_allclose([h[2] for h in tres.history],
                               [h[2] for h in oracle.history], rtol=1e-3)
    if bits:
        for k in oracle.params:
            np.testing.assert_allclose(tres.params[k].numpy(),
                                       oracle.params[k].numpy(), rtol=1e-3,
                                       atol=1e-4, err_msg=k)
    else:
        assert_params_close(oracle.params, tres.params, rtol=1e-3,
                            atol=1e-5)


def test_run_async_rejects_unported_paths(setup):
    _, tc, _, tp = setup
    fleet = Fleet.from_lists(JETSON_FLEET_HMDB51, _loaders(TLoader, TDS))
    tf = TFed(**FED)
    # the async path has no fleet-wide round to shard, as in the reference
    with pytest.raises(ValueError, match="not supported here"):
        tsim.run_async(tp, tc, tf, fleet, device="cpu", engine="shard")
    with pytest.raises(ValueError, match="unsupported wire width"):
        tsim.run_async(tp, tc, dataclasses.replace(tf, compress_bits=3),
                       fleet, device="cpu")
    # profiles without their loaders: Fleet.resolve's refusal, as in the
    # reference
    with pytest.raises(ValueError, match="legacy"):
        tsim.run_async(tp, tc, tf, list(JETSON_FLEET_HMDB51), device="cpu")
    with pytest.raises(ValueError, match="num_clients"):
        tsim.run_async(tp, tc, dataclasses.replace(tf, num_clients=3), fleet,
                       device="cpu")


def test_run_async_defaults_to_the_card(setup):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the refusal")
    _, tc, _, tp = setup
    fleet = Fleet.from_lists(JETSON_FLEET_HMDB51, _loaders(TLoader, TDS))
    with pytest.raises(RuntimeError, match="CUDA"):
        tsim.run_async(tp, tc, TFed(**FED), fleet)

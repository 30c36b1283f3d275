"""The sync FedAvg baseline in the port vs the reference, on the same
numpy inputs and JAX-initialised params: ``weighted_average`` (rtol 1e-6),
``fedavg_round_loop`` (params and losses rtol 1e-4),
``run_sync(engine="loop")`` on the four-Jetson fleet (the virtual clock,
the history's times and the trace exactly; losses and params rtol 1e-3),
``analytic_speedup`` exactly and Table II's claim on the port, and the
standalone staleness weights.

``staleness_fn`` is f32 in both packages. XLA's f32 power is not
correctly rounded, and torch's differs from it by at most one unit in the
last place (ulp) at some bases: the weights agree exactly at every
staleness Algorithm 1 can apply (0 to K = 16, the paper's and other
exponents), and within one ulp (rtol 2**-22) up to staleness 5000.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import get_config as jget
from repro.core import fedasync as jfa
from repro.core import fedavg as jfedavg
from repro.core import simulator as jsim
from repro.core.fleet import Fleet as JFleet
from repro.data import BatchLoader as JLoader
from repro.data import SyntheticActionDataset as JDS
from repro.data import iid_partition
from repro.types import FedConfig as JFed
from repro_torch.configs import get_config as tget
from repro_torch.core import fedasync as tfa
from repro_torch.core import fedavg as tfedavg
from repro_torch.core import simulator as tsim
from repro_torch.core.fleet import (JETSON_FLEET_HMDB51, JETSON_FLEET_UCF101,
                                    Fleet)
from repro_torch.data import BatchLoader as TLoader
from repro_torch.data import SyntheticActionDataset as TDS
from repro_torch.types import FedConfig as TFed

from torch_parity import assert_params_close, jax_params_both, port_params

# lr 0.01: at 0.05 the second sync round is ill-conditioned; the
# reference's own run, its init perturbed by 1e-7 relative, moves a weight
# of stages/3/1/w1 by 1.3e-4, as far as the port's run lands from it
FED = dict(num_clients=4, global_epochs=8, local_iters_min=1,
           local_iters_max=2, lr=0.01)
SHAPES = ((4, 5), (7,), (2, 3, 4))


@pytest.fixture(scope="module")
def setup():
    jc, tc = jget("resnet3d-18").reduced(), tget("resnet3d-18").reduced()
    jp, flat = jax_params_both(jc, jax.random.PRNGKey(0))
    return jc, tc, jp, port_params(flat, tc)


def _loaders(Loader, DS, n=4):
    ds = DS(num_classes=8, samples_per_class=8, seed=1)
    parts = iid_partition(len(ds), n)
    return [Loader(ds, 2, steps=4, seed=k, indices=parts[k])
            for k in range(n)]


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("sizes", [None, [3, 1, 6]])
def test_weighted_average_matches_reference(dt, sizes, rng):
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16}[dt]
    trees = [{f"l{i}": jnp.asarray(rng.standard_normal(s), jdt)
              for i, s in enumerate(SHAPES)} for _ in range(3)]
    want = jfedavg.weighted_average(trees, jfedavg._client_weights(3, sizes))
    w = tfedavg._client_weights(3, sizes)
    np.testing.assert_array_equal(
        w.numpy(), np.asarray(jfedavg._client_weights(3, sizes)))
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16}[dt]
    got = tfedavg.weighted_average(
        [{k: torch.tensor(np.asarray(v.astype(jnp.float32))).to(tdt)
          for k, v in t.items()} for t in trees], w)
    for k, v in want.items():
        assert got[k].dtype == tdt
        np.testing.assert_allclose(got[k].float().numpy(),
                                   np.asarray(v.astype(jnp.float32)),
                                   rtol=1e-6, atol=1e-7, err_msg=k)


def test_fedavg_round_loop_matches_reference(setup):
    jc, tc, jp, tp = setup
    batches = [list(ld()) for ld in _loaders(TLoader, TDS, n=2)]
    jw, jl = jfedavg.fedavg_round_loop(jp, [iter(b) for b in batches], jc,
                                       JFed(**FED))
    tw, tl = tfedavg.fedavg_round_loop(tp, [iter(b) for b in batches], tc,
                                       TFed(**FED))
    assert [len(x) for x in tl] == [len(x) for x in jl] == [2, 2]
    np.testing.assert_allclose(np.ravel(tl), np.ravel(jl), rtol=1e-4)
    assert_params_close(jw, tw, rtol=1e-4, atol=1e-6)
    # engine="loop" routes to the loop; the multi-device engines run in a
    # world of one (an in-process gloo group) and give the scan round
    rw, rl = tfedavg.fedavg_round(tp, [iter(b) for b in batches], tc,
                                  TFed(**FED), engine="loop")
    assert rl == tl and all(torch.equal(rw[k], tw[k]) for k in tw)
    sw, sl = tfedavg.fedavg_round(tp, batches, tc, TFed(**FED))
    for engine in ("shard", "hier"):
        gw, gl = tfedavg.fedavg_round(tp, batches, tc, TFed(**FED),
                                      engine=engine)
        assert gl == sl and all(torch.equal(gw[k], sw[k]) for k in sw)
    assert_params_close(jw, gw, rtol=1e-4, atol=1e-6)
    # the algorithm layer runs: a SCAFFOLD round on the batched engine
    # against the port's loop oracle and the reference's
    from repro.core.algorithms import Scaffold as JScaffold
    from repro_torch.core.algorithms import Scaffold
    jsc, tsc, lsc = JScaffold(), Scaffold(), Scaffold()
    jw, jl = jfedavg.fedavg_round_loop(jp, [iter(b) for b in batches], jc,
                                       JFed(**FED), algorithm=jsc)
    sw, sl = tfedavg.fedavg_round(tp, [iter(b) for b in batches], tc,
                                  TFed(**FED), algorithm="scaffold")
    lw, ll = tfedavg.fedavg_round_loop(tp, [iter(b) for b in batches], tc,
                                       TFed(**FED), algorithm=lsc)
    np.testing.assert_allclose(np.ravel(sl), np.ravel(ll), rtol=1e-4)
    np.testing.assert_allclose(np.ravel(sl), np.ravel(jl), rtol=1e-4)
    assert_params_close(jw, sw, rtol=1e-4, atol=1e-5)
    assert_params_close(jw, lw, rtol=1e-4, atol=1e-5)
    assert_params_close(jsc.ctx_for(jp), lsc.ctx_for(tp), rtol=1e-4,
                        atol=1e-5)


def _trace_key(res):
    return [(e.kind, e.client, e.global_epoch, e.staleness, e.time, e.beta_t)
            for e in res.trace]


# the second case samples two clients a round (4 rounds), draws the
# lognormal clock jitter and evaluates every 2 rounds
@pytest.mark.parametrize("per_round,jitter", [(0, 0.0), (2, 0.3)])
def test_run_sync_matches_reference_loop(setup, per_round, jitter):
    jc, tc, jp, tp = setup
    jevals, tevals = [], []
    jres = jsim.run_sync(
        jp, jc, JFed(**FED, clients_per_round=per_round),
        JFleet.from_lists(JETSON_FLEET_HMDB51, _loaders(JLoader, JDS)),
        engine="loop", jitter=jitter, eval_every=2,
        eval_fn=lambda r, now, p: jevals.append((r, now)))
    tres = tsim.run_sync(
        tp, tc, TFed(**FED, clients_per_round=per_round),
        Fleet.from_lists(JETSON_FLEET_HMDB51, _loaders(TLoader, TDS)),
        engine="loop", jitter=jitter, eval_every=2,
        eval_fn=lambda r, now, p: tevals.append((r, now)), device="cpu")
    assert len(tres.history) == (4 if per_round else 2)
    assert tevals == jevals
    assert tres.wall_clock_s == jres.wall_clock_s
    assert [h[:2] for h in tres.history] == [h[:2] for h in jres.history]
    assert _trace_key(tres) == _trace_key(jres)
    np.testing.assert_allclose([h[2] for h in tres.history],
                               [h[2] for h in jres.history], rtol=1e-3)
    assert_params_close(jres.params, tres.params, rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("algorithm", ["scaffold", "lowrank"])
def test_run_sync_algorithm_matches_reference_loop(setup, algorithm):
    """``run_sync(algorithm=)``, refused before the algorithm layer was
    ported, on the batched engine against the reference's loop oracle
    (the clock exactly; losses rtol 1e-3, params rtol 1e-3 atol 1e-4)."""
    jc, tc, jp, tp = setup
    from repro.core.algorithms import make_algorithm
    jres = jsim.run_sync(
        jp, jc, JFed(**FED),
        JFleet.from_lists(JETSON_FLEET_HMDB51, _loaders(JLoader, JDS)),
        engine="loop", algorithm=make_algorithm(algorithm))
    tres = tsim.run_sync(
        tp, tc, TFed(**FED),
        Fleet.from_lists(JETSON_FLEET_HMDB51, _loaders(TLoader, TDS)),
        algorithm=algorithm, device="cpu")
    assert tres.wall_clock_s == jres.wall_clock_s
    assert _trace_key(tres) == _trace_key(jres)
    np.testing.assert_allclose([h[2] for h in tres.history],
                               [h[2] for h in jres.history], rtol=1e-3)
    assert_params_close(jres.params, tres.params, rtol=1e-3, atol=1e-4)


def test_run_sync_rejects_unported_paths(setup):
    _, tc, _, tp = setup
    # the sharded and hierarchical engines, refused before they were
    # ported, run in a world of one: the scan run's clock and params
    want = tsim.run_sync(tp, tc, TFed(**FED), Fleet.from_lists(
        JETSON_FLEET_HMDB51, _loaders(TLoader, TDS)), device="cpu")
    for engine in ("shard", "hier"):
        got = tsim.run_sync(tp, tc, TFed(**FED), Fleet.from_lists(
            JETSON_FLEET_HMDB51, _loaders(TLoader, TDS)), device="cpu",
            engine=engine)
        assert got.wall_clock_s == want.wall_clock_s
        assert got.history == want.history
        assert all(torch.equal(got.params[k], want.params[k])
                   for k in want.params)
    fleet = Fleet.from_lists(JETSON_FLEET_HMDB51, _loaders(TLoader, TDS))
    with pytest.raises(ValueError, match="legacy"):
        tsim.run_sync(tp, tc, TFed(**FED), list(JETSON_FLEET_HMDB51),
                      device="cpu")
    with pytest.raises(ValueError, match="num_clients"):
        tsim.run_sync(tp, tc, TFed(**dict(FED, num_clients=3)), fleet,
                      device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tsim.run_sync(tp, tc, TFed(**FED), fleet)


@pytest.mark.parametrize("fleet,jfleet", [
    (JETSON_FLEET_HMDB51, jsim.JETSON_FLEET_HMDB51),
    (JETSON_FLEET_UCF101, jsim.JETSON_FLEET_UCF101)],
    ids=["hmdb51", "ucf101"])
def test_analytic_speedup_equals_reference_and_table2_holds(fleet, jfleet):
    assert [dataclasses.astuple(p) for p in fleet] == \
        [dataclasses.astuple(p) for p in jfleet]
    for epochs, local in ((80, 3), (20, 1), (7, 2)):
        assert tsim.analytic_speedup(fleet, epochs, local) == \
            jsim.analytic_speedup(jfleet, epochs, local)
    # Table II: async cuts the wall clock by at least 35% at the paper's
    # operating point (E = 80, 3 local epochs)
    sp = tsim.analytic_speedup(fleet, epochs=80, local_epochs=3)
    assert sp["async_s"] < sp["sync_s"]
    assert sp["reduction"] >= 0.35, sp


def test_staleness_fn_and_mixing_weight_match_reference():
    near = np.arange(-3, 17)                 # 0..K after the clamp
    far = np.arange(17, 5000)
    for a in (0.5, 0.0, 0.3, 1.0, 1.3, 2.0):
        js, ts = jfa.staleness_fn(a), tfa.staleness_fn(a)
        got = ts(torch.as_tensor(near))
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(js(jnp.asarray(near))))
        np.testing.assert_allclose(ts(torch.as_tensor(far)).numpy(),
                                   np.asarray(js(jnp.asarray(far))),
                                   rtol=2.0 ** -22, atol=0)
        assert float(ts(0)) == float(js(0)) == 1.0
    for kw in ({}, {"mixing_beta": 0.33, "staleness_a": 1.3}):
        jf, tf = JFed(**kw), TFed(**kw)
        for t, tau in ((0, 0), (5, 2), (20, 3), (1, 4)):
            assert float(tfa.mixing_weight(tf, t, tau)) == \
                float(jfa.mixing_weight(jf, t, tau))

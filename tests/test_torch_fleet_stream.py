"""Streaming fleets in the port (``repro_torch/core/fleet.py``) against the
reference's ``repro/core/fleet.py``.

A ``FleetSpec``'s per-client draws (profile, H^k, capacity, the batches
of each visit) are pure numpy functions of (spec, k, visit): the port's
must equal the reference's byte for byte, and its validation errors the
reference's. A streamed run equals its ``materialize()``d twin bit for
bit (``torch.equal``), as ``tests/test_fleet.py`` pins for the reference;
a streamed run of the port matches the reference's streamed run on the
same converted init (history and virtual clock exact, staleness
histogram equal, params within 1e-3·(1 + |ref|)) and visits every client
as often (each ``Fleet.data(k)`` call is a visit that seeds the client's
next loader). At 10^6 clients the resident state is O(m) for sync rounds
and O(in-flight) for async runs, and the async run's tail releases its
finished clients."""
import dataclasses
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

from repro.configs import get_config as jget
from repro.core import fleet as jfleet
from repro.core import simulator as jsim
from repro.data import SyntheticActionDataset as JDS
from repro.types import FedConfig as JFed
from repro_torch.configs import get_config as tget
from repro_torch.core import fleet as tfleet
from repro_torch.core import simulator as tsim
from repro_torch.data import SyntheticActionDataset as TDS
from repro_torch.types import FedConfig as TFed

from torch_parity import assert_params_close, jax_params_both, port_params

FED = dict(num_clients=4, global_epochs=8, local_iters_min=1,
           local_iters_max=2, lr=0.05, clients_per_round=2, seed=5)
DS = dict(num_classes=8, samples_per_class=8, seed=1)


def _spec(mod, DS_, population=4, partition="iid", **kw):
    return mod.FleetSpec(population=population,
                         profiles=mod.JETSON_FLEET_HMDB51,
                         dataset=DS_(**DS), batch_size=4, steps=4, seed=3,
                         partition=partition, **kw)


@pytest.fixture(scope="module")
def setup():
    jc, tc = jget("resnet3d-18").reduced(), tget("resnet3d-18").reduced()
    jp, flat = jax_params_both(jc, jax.random.PRNGKey(0))
    return jc, tc, jp, port_params(flat, tc)


def _in_flight(res) -> set:
    """Clients dispatched and not yet received when the run ended."""
    out: dict = {}
    for ev in res.trace:
        out[ev.client] = out.get(ev.client, 0) + (
            1 if ev.kind == "dispatch" else -1 if ev.kind == "receive" else 0)
    return {k for k, n in out.items() if n > 0}


def _batches_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert sorted(x) == sorted(y)
        for k in x:
            assert x[k].dtype == y[k].dtype
            assert x[k].tobytes() == y[k].tobytes(), k


@pytest.mark.parametrize("partition,population", [("shared", 100),
                                                  ("iid", 16)])
def test_spec_draws_equal_the_reference(partition, population):
    weights = (0.1, 0.2, 0.3, 0.4)
    js = _spec(jfleet, JDS, population, partition, profile_weights=weights)
    ts = _spec(tfleet, TDS, population, partition, profile_weights=weights)
    jf = JFed(num_clients=population, local_iters_min=1, local_iters_max=4)
    tf = TFed(num_clients=population, local_iters_min=1, local_iters_max=4)
    jfl, tfl = jfleet.Fleet.from_spec(js), tfleet.Fleet.from_spec(ts)
    for k in (0, 1, 7, population - 1):
        assert ts.profile_index(k) == js.profile_index(k)
        assert ts.profile(k).name == js.profile(k).name
        assert ts.iters(k, tf) == js.iters(k, jf)
        assert ts.capacity(k) == js.capacity(k)
        assert ts.capacity(k, 0.1, 0.9) == js.capacity(k, 0.1, 0.9)
        for visit in range(3):
            _batches_equal(list(ts.data(k, visit=visit)()),
                           list(js.data(k, visit=visit)()))
            # the fleet's own visit counter draws the same streams
            _batches_equal(list(tfl.data(k)()), list(jfl.data(k)()))
    assert tfl._visits == jfl._visits
    if partition == "iid":
        np.testing.assert_array_equal(tfl._perm(), jfl._perm())
    # weightless specs draw uniformly, as the reference's
    ju = _spec(jfleet, JDS, population, partition)
    tu = _spec(tfleet, TDS, population, partition)
    assert [tu.profile_index(k) for k in range(population)] == \
        [ju.profile_index(k) for k in range(population)]


def test_sampling_equals_the_reference():
    """The exact draw for small populations, rejection sampling at 10^6,
    with an exclusion set, from one generator state."""
    for population, m, excl in ((8, 8, ()), (10**6, 64, range(32))):
        js = _spec(jfleet, JDS, population, "shared")
        ts = _spec(tfleet, TDS, population, "shared")
        a = jfleet.Fleet.from_spec(js).sample(np.random.default_rng(0), m,
                                              exclude=excl)
        b = tfleet.Fleet.from_spec(ts).sample(np.random.default_rng(0), m,
                                              exclude=excl)
        np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("bad", [
    {"population": 0}, {"profiles": ()}, {"profile_weights": (1.0,)},
    {"partition": "dirichlet"}, {"dataset": None}])
def test_spec_validation_errors_are_the_reference(bad):
    def kw(mod, DS_):
        out = dict(population=4, profiles=mod.JETSON_FLEET_HMDB51,
                   dataset=DS_(**DS), partition="iid")
        out.update(bad)
        return out
    with pytest.raises(ValueError) as want:
        jfleet.FleetSpec(**kw(jfleet, JDS))
    with pytest.raises(ValueError) as got:
        tfleet.FleetSpec(**kw(tfleet, TDS))
    assert str(got.value) == str(want.value)


def test_resolve_covers_its_three_branches():
    tf = TFed(num_clients=4, clients_per_round=2)
    spec = _spec(tfleet, TDS)
    fleet = tfleet.Fleet.from_spec(spec)
    assert tfleet.Fleet.resolve(fleet, None, tf) is fleet
    streamed = tfleet.Fleet.resolve(spec, None, tf)
    assert streamed.spec is spec and streamed.resident == 0
    profiles = tfleet.JETSON_FLEET_HMDB51
    loaders = [lambda: iter(())] * 4
    with pytest.warns(DeprecationWarning, match="deprecated"):
        legacy = tfleet.Fleet.resolve(profiles, loaders, tf)
    assert legacy.spec is None and legacy.population == 4
    assert legacy.data(2) is loaders[2]
    for args, match in (((fleet, loaders, tf), "client_data must be None"),
                        ((spec, loaders, tf), "client_data must be None"),
                        ((profiles, None, tf), "legacy"),
                        ((fleet, None, dataclasses.replace(tf,
                                                           num_clients=5)),
                         "num_clients"),
                        ((fleet, None, dataclasses.replace(
                            tf, clients_per_round=5)), "clients_per_round")):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            with pytest.raises(ValueError, match=match):
                tfleet.Fleet.resolve(*args)


def test_materialize_pins_and_release_drops():
    fleet = tfleet.Fleet.from_spec(_spec(tfleet, TDS, 8))
    twin = fleet.materialize()
    assert twin.resident == twin.max_resident == 8
    twin.release(range(8))
    assert twin.resident == 8                 # pinned
    fleet.data(3)
    fleet.profile(5)
    assert fleet.resident == 2 and fleet.max_resident == 2
    fleet.release([3, 5])
    assert fleet.resident == 0 and fleet._visits == {3: 1}
    lists = tfleet.Fleet.from_lists(tfleet.JETSON_FLEET_HMDB51, [None] * 4)
    assert lists.materialize() is lists and lists.resident == 4


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_streamed_equals_materialized(mode, setup):
    _, tc, _, tp = setup
    run = tsim.run_sync if mode == "sync" else tsim.run_async
    spec = _spec(tfleet, TDS)
    a = run(tp, tc, TFed(**FED), tfleet.Fleet.from_spec(spec), device="cpu")
    b = run(tp, tc, TFed(**FED), tfleet.Fleet.from_spec(spec).materialize(),
            device="cpu")
    assert set(a.params) == set(b.params)
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k
    assert a.history == b.history
    assert a.staleness_hist == b.staleness_hist


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_streamed_run_matches_the_reference(mode, setup):
    """The port's scan engine against the reference's loop, both on a
    streamed iid fleet from one converted init; both fleets are visited
    alike and end holding the same clients."""
    jc, tc, jp, tp = setup
    jrun = jsim.run_sync if mode == "sync" else jsim.run_async
    trun = tsim.run_sync if mode == "sync" else tsim.run_async
    # sync at lr 0.01, as tests/test_torch_engine_sim.py: at 0.05 the
    # second sync round moves a weight by ~1e-4 for a 1e-7 change of the
    # reference's own init (PERF.md §6)
    fed = dict(FED, lr=0.01) if mode == "sync" else FED
    jfl = jfleet.Fleet.from_spec(_spec(jfleet, JDS))
    tfl = tfleet.Fleet.from_spec(_spec(tfleet, TDS))
    want = jrun(jp, jc, JFed(**fed), jfl, engine="loop")
    got = trun(tp, tc, TFed(**fed), tfl, device="cpu")
    assert got.wall_clock_s == want.wall_clock_s
    assert [h[:2] for h in got.history] == [h[:2] for h in want.history]
    np.testing.assert_allclose([h[2] for h in got.history],
                               [h[2] for h in want.history], rtol=1e-3)
    assert got.staleness_hist == want.staleness_hist
    assert got.max_inflight == want.max_inflight
    assert tfl._visits == jfl._visits
    assert (tfl.resident, tfl.max_resident) == (jfl.resident,
                                                 jfl.max_resident)
    assert tfl.resident == len(_in_flight(got))
    assert_params_close(want.params, got.params, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_million_clients_hold_o_m_state(mode, setup):
    """10^6 clients, m = 4: sync holds at most the round's m, async at
    most its in-flight set, and neither keeps a client it is done with."""
    _, tc, _, tp = setup
    fed = TFed(num_clients=10**6, global_epochs=8, local_iters_min=1,
               local_iters_max=2, lr=0.05, clients_per_round=4)
    fleet = tfleet.Fleet.from_spec(_spec(tfleet, TDS, 10**6, "shared"))
    run = tsim.run_sync if mode == "sync" else tsim.run_async
    res = run(tp, tc, fed, fleet, device="cpu")
    assert np.isfinite(res.final_loss)
    assert 0 < fleet.max_resident <= 4
    if mode == "async":
        assert res.max_inflight <= 4
    assert fleet.resident == len(_in_flight(res)) <= 4
    assert len(fleet._visits) <= sum(fleet._visits.values()) <= 2 * 8 + 4


def test_async_tail_releases_finished_clients(setup):
    """The last receive group's clients are released too, as in the
    reference: a run ends holding only the clients still in flight."""
    jc, tc, jp, tp = setup
    fed = dict(FED, global_epochs=3)
    jfl = jfleet.Fleet.from_spec(_spec(jfleet, JDS))
    tfl = tfleet.Fleet.from_spec(_spec(tfleet, TDS))
    want = jsim.run_async(jp, jc, JFed(**fed), jfl, engine="loop")
    got = tsim.run_async(tp, tc, TFed(**fed), tfl, device="cpu",
                         engine="loop")
    assert _in_flight(got) == _in_flight(want)
    assert tfl.resident == jfl.resident == len(_in_flight(got)) < 2
    assert set(tfl._cache) == _in_flight(got)
    assert tfl.max_resident == jfl.max_resident == 2


def test_legacy_pair_runs_with_a_warning(setup):
    """The deprecated (profiles, client_data) pair, ``client_data`` the
    fifth positional argument as in the reference, runs the list fleet's
    run."""
    _, tc, _, tp = setup
    fed = TFed(**dict(FED, clients_per_round=0, global_epochs=4))
    spec = _spec(tfleet, TDS)
    loaders = [spec.data(k) for k in range(4)]
    with pytest.warns(DeprecationWarning):
        a = tsim.run_sync(tp, tc, fed, list(spec.profiles), loaders,
                          device="cpu")
    b = tsim.run_sync(tp, tc, fed, tfleet.Fleet.from_lists(
        list(spec.profiles), [spec.data(k) for k in range(4)]), device="cpu")
    assert a.history == b.history
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k

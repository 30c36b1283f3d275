"""The sharded and hierarchical sync rounds (``repro_torch.core.fed_engine
.ShardedSyncRound``) in a world of one on the CPU (an in-process gloo
group, ``launch.mesh.init_world``): the shard and hier rounds equal the
port's scan round bit for bit on an even round and on a ragged round with
a zero-weight client (also under a scheduled rate), for FedProx, SCAFFOLD
(its server context too) and LowRank, and match the reference's scan round
(``repro.core.fedavg.fedavg_round(engine="scan")``) at the reference's
own shard tolerance: params rtol 1e-3 / atol 1e-4, losses rtol 1e-4.
``run_sync`` on both engines keeps the reference's virtual clock exactly.
Also ``fed_round_specs``' keys and levels, ``make_fleet_mesh``'s
validation, the hierarchical round refusing a 1-D mesh, and memoizing.

The reference's own sharded rounds fail on this JAX (its ``shard_map``
checks a ``lax.scan`` carry's varying axes), so its scan round is the
oracle: the sharded round is by construction the flat weighted average.
Real splits over 2 and 4 ranks are ``tests/test_torch_sharded_ranks.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

from repro.core import fedavg as jfedavg
from repro.core import simulator as jsim
from repro.core.algorithms import Scaffold as JScaffold
from repro.core.fleet import Fleet as JFleet
from repro.data import BatchLoader as JLoader
from repro.data import SyntheticLMDataset
from repro.types import FedConfig as JFed
from repro.types import ModelConfig as JModel
from repro_torch import sharding
from repro_torch.core import algorithms as talg
from repro_torch.core import fed_engine as tfe
from repro_torch.core import fedavg as tfedavg
from repro_torch.core import simulator as tsim
from repro_torch.core.fleet import JETSON_FLEET_HMDB51, Fleet
from repro_torch.data import BatchLoader as TLoader
from repro_torch.launch.mesh import make_fleet_mesh
from repro_torch.optim import schedules as tsched
from repro_torch.types import FedConfig as TFed
from repro_torch.types import ModelConfig as TModel

from torch_parity import assert_params_close, jax_params_both, port_params

TINY = dict(name="sharded-test-tiny", family="dense", num_layers=1,
            d_model=32, num_heads=2, num_kv_heads=2, d_ff=64, vocab_size=64)
FED = dict(num_clients=5, global_epochs=10, local_iters_min=1,
           local_iters_max=3, lr=0.05)
# the ragged round: H^k 3, 1, 2, 3, 1 and a zero-weight client; the
# scheduled one is the ragged round under a decaying rate
COUNTS = {"even": [3, 3, 3, 3], "ragged": [3, 1, 2, 3, 1],
          "scheduled": [3, 1, 2, 3, 1]}
SIZES = {"even": None, "ragged": [32, 8, 16, 32, 0],
         "scheduled": [32, 8, 16, 32, 0]}
ENGINES = ("shard", "hier")


@pytest.fixture(scope="module")
def setup():
    jc, tc = JModel(**TINY), TModel(**TINY)
    jp, flat = jax_params_both(jc, jax.random.PRNGKey(0))
    ds = SyntheticLMDataset(vocab=64, seq_len=8, seed=0)
    return jc, tc, jp, port_params(flat, tc), ds


def _data(ds, case):
    return [list(ds.batches(4, h, seed=k))
            for k, h in enumerate(COUNTS[case])]


def _equal(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def _mesh(engine):
    return make_fleet_mesh(edges=0 if engine == "hier" else None,
                           device="cpu")


def test_fed_round_specs_keys_and_levels():
    from torch.distributed.tensor import Replicate, Shard
    flat, tree = _mesh("shard"), _mesh("hier")
    s = sharding.fed_round_specs(flat)
    assert set(s) == {"axis", "clients", "replicated"}
    assert s["axis"] == "clients"
    assert s["clients"] == (Shard(0),) and s["replicated"] == (Replicate(),)
    t = sharding.fed_round_specs(tree)
    assert tree.mesh_dim_names == ("edge", "clients")
    assert t["axis"] == ("edge", "clients")
    assert t["clients"] == (Shard(0), Shard(0))
    assert t["replicated"] == (Replicate(), Replicate())
    assert sharding.levels(flat) == ("clients",)
    assert sharding.levels(tree) == ("clients", "edge")   # innermost first
    assert sharding.shard_index(flat) == sharding.shard_index(tree) == (0, 1)
    # an empty tree comes back as it is; a world of one sums to itself
    assert sharding.psum_levels((), tree) == ()
    x = {"a": torch.arange(6.0).reshape(2, 3), "b": torch.ones(4)}
    _equal(sharding.psum_levels(x, tree), x)
    m = {"mask": torch.tensor([[True, False], [False, True]]),
         "cap": torch.tensor([0.25, 0.5])}
    _equal(sharding.gather_levels(m, tree), m)


def test_make_fleet_mesh_validation():
    import torch.distributed as dist
    mesh = make_fleet_mesh(device="cpu")
    n = dist.get_world_size()
    assert mesh.mesh_dim_names == ("clients",) and mesh.size() == n
    with pytest.raises(ValueError, match="divisor"):
        make_fleet_mesh(n, edges=n + 1, device="cpu")
    with pytest.raises(ValueError, match="process group"):
        make_fleet_mesh(n + 1, device="cpu")
    tree = make_fleet_mesh(edges=0, device="cpu")
    assert set(tree.mesh_dim_names) == {"edge", "clients"}
    assert tuple(tree.shape) == (1, 1)
    assert make_fleet_mesh(edges=0, device="cpu") is tree
    assert make_fleet_mesh(n, edges=1, device="cpu") is tree


def test_hierarchical_round_refuses_a_flat_mesh(setup):
    _, tc, _, _, _ = setup
    with pytest.raises(ValueError, match="edge"):
        tfe.make_hierarchical_sync_round(tc, TFed(**FED),
                                         mesh=_mesh("shard"))


def test_memoized_per_mesh_and_algorithm(setup):
    _, tc, _, tp, ds = setup
    fed = TFed(**FED)
    eng = tfe.make_sharded_sync_round(tc, fed, mesh=_mesh("shard"))
    assert tfe.make_sharded_sync_round(tc, fed, mesh=_mesh("shard")) is eng
    assert tfe.make_sharded_sync_round(tc, fed, device="cpu") is eng
    hier = tfe.make_hierarchical_sync_round(tc, fed, device="cpu")
    assert hier is tfe.make_hierarchical_sync_round(tc, fed,
                                                    mesh=_mesh("hier"))
    assert hier is not eng
    assert tfe.make_sharded_sync_round(tc, fed, mesh=_mesh("shard"),
                                       algorithm="scaffold") is not eng
    # the engine strings route to the memoized engines
    fed = TFed(**dict(FED, lr=0.03))
    tfedavg.fedavg_round(tp, _data(ds, "even"), tc, fed, engine="hier")
    assert tfe.make_hierarchical_sync_round(
        tc, fed, device="cpu").num_compiled == 1
    # a mesh on another device type than the params is refused
    with pytest.raises(ValueError, match="mesh on"):
        eng({k: v.to("meta") for k, v in tp.items()}, _data(ds, "even"))


@pytest.mark.parametrize("case", ["even", "ragged", "scheduled"])
@pytest.mark.parametrize("engine", ENGINES)
def test_round_equals_the_scan_round_bit_for_bit(setup, engine, case):
    _, tc, _, tp, ds = setup
    fed = TFed(**FED)
    if case == "scheduled":
        fed = TFed(**dict(FED, lr=tsched.inverse_sqrt(0.05, 1)))
    want, wl = tfedavg.fedavg_round(tp, _data(ds, case), tc, fed,
                                    data_sizes=SIZES[case])
    got, gl = tfedavg.fedavg_round(tp, _data(ds, case), tc, fed,
                                   engine=engine, data_sizes=SIZES[case])
    _equal(got, want)
    assert gl == wl and [len(l) for l in gl] == COUNTS[case]


@pytest.mark.parametrize("engine", ENGINES)
def test_round_matches_the_reference_scan_round(setup, engine):
    jc, tc, jp, tp, ds = setup
    jw, jl = jfedavg.fedavg_round(jp, _data(ds, "ragged"), jc, JFed(**FED),
                                  engine="scan", data_sizes=SIZES["ragged"])
    tw, tl = tfedavg.fedavg_round(tp, _data(ds, "ragged"), tc, TFed(**FED),
                                  engine=engine, data_sizes=SIZES["ragged"])
    assert [len(l) for l in tl] == [len(l) for l in jl]
    np.testing.assert_allclose(np.concatenate(tl),
                               np.concatenate([np.asarray(l) for l in jl]),
                               rtol=1e-4)
    assert_params_close(jw, tw, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("engine", ENGINES)
def test_scaffold_params_and_server_context(setup, engine):
    jc, tc, jp, tp, ds = setup
    scan, shard, jsc = talg.Scaffold(), talg.Scaffold(), JScaffold()
    for r in range(2):                 # the second round reads the states
        want, wl = tfedavg.fedavg_round(tp, _data(ds, "ragged"), tc,
                                        TFed(**FED), algorithm=scan,
                                        data_sizes=SIZES["ragged"])
        got, gl = tfedavg.fedavg_round(tp, _data(ds, "ragged"), tc,
                                       TFed(**FED), engine=engine,
                                       algorithm=shard,
                                       data_sizes=SIZES["ragged"])
        jw, _ = jfedavg.fedavg_round(jp, _data(ds, "ragged"), jc,
                                     JFed(**FED), engine="scan",
                                     algorithm=jsc,
                                     data_sizes=SIZES["ragged"])
        _equal(got, want)
        assert gl == wl
        _equal(shard.ctx_for(tp), scan.ctx_for(tp))
        for k in range(5):
            _equal(shard.state_for(k, tp), scan.state_for(k, tp))
        assert_params_close(jw, got, rtol=1e-3, atol=1e-4)
        assert_params_close(jsc.ctx_for(jp), shard.ctx_for(tp), rtol=1e-3,
                            atol=1e-4)


@pytest.mark.parametrize("engine", ENGINES)
def test_lowrank_params(setup, engine):
    _, tc, _, tp, ds = setup
    scan, shard = talg.LowRankSubmodel(), talg.LowRankSubmodel()
    want, wl = tfedavg.fedavg_round(tp, _data(ds, "ragged"), tc, TFed(**FED),
                                    algorithm=scan,
                                    data_sizes=SIZES["ragged"])
    got, gl = tfedavg.fedavg_round(tp, _data(ds, "ragged"), tc, TFed(**FED),
                                   engine=engine, algorithm=shard,
                                   data_sizes=SIZES["ragged"])
    _equal(got, want)
    assert gl == wl
    for k in range(5):
        _equal(shard.state_for(k, tp)["mask"], scan.state_for(k, tp)["mask"])


@pytest.mark.parametrize("engine", ENGINES)
def test_run_sync_clock_equals_the_reference(setup, engine):
    jc, tc, jp, tp, ds = setup

    def loaders(Loader):
        return [Loader(ds, 2, steps=3, seed=k) for k in range(5)]
    profiles = list(JETSON_FLEET_HMDB51) + [JETSON_FLEET_HMDB51[0]]
    jres = jsim.run_sync(jp, jc, JFed(**FED),
                         JFleet.from_lists(profiles, loaders(JLoader)),
                         engine="scan", jitter=0.3)
    scan = tsim.run_sync(tp, tc, TFed(**FED),
                         Fleet.from_lists(profiles, loaders(TLoader)),
                         jitter=0.3, device="cpu")
    tres = tsim.run_sync(tp, tc, TFed(**FED),
                         Fleet.from_lists(profiles, loaders(TLoader)),
                         engine=engine, jitter=0.3, device="cpu")
    assert tres.wall_clock_s == jres.wall_clock_s == scan.wall_clock_s
    assert [h[:2] for h in tres.history] == [h[:2] for h in jres.history]
    assert tres.history == scan.history
    _equal(tres.params, scan.params)
    np.testing.assert_allclose([h[2] for h in tres.history],
                               [h[2] for h in jres.history], rtol=1e-3)
    assert_params_close(jres.params, tres.params, rtol=1e-3, atol=1e-4)

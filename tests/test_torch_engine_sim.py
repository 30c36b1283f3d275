"""The simulator and the launchers on the port's batched engines
(``engine="scan"``, the default) on the CPU.

``run_async`` (window 0 and 300 s, two clients in flight with clock
jitter) and ``run_sync`` on the four-Jetson fleet against the port's own
loop (losses rtol 1e-4, params rtol and atol 1e-5) and against the
reference's ``engine="scan"`` runs on the same numpy data and JAX-
initialised params (losses and params rtol 1e-3); the virtual clock, the
staleness and group histograms and the trace exactly, on both; then
``run_async`` with compressed updates (``fed.compress_bits`` 8 and 4) at
the reference's own test shape and tolerance. The sync
runs use lr 0.01, as ``tests/test_torch_fedavg.py`` does: at 0.05 the
second sync round is ill-conditioned (a 1e-7 perturbation of the
reference's own init moves a weight by 1.3e-4; PERF.md §6). Then
the pipeline and the trainer on ``scan`` against ``loop``."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

from repro.configs import get_config as jget
from repro.core import simulator as jsim
from repro.core.fleet import Fleet as JFleet
from repro.data import BatchLoader as JLoader
from repro.data import SyntheticActionDataset as JDS
from repro.data import iid_partition
from repro.types import FedConfig as JFed
from repro_torch.configs import get_config as tget
from repro_torch.core import simulator as tsim
from repro_torch.core.fleet import JETSON_FLEET_HMDB51, Fleet
from repro_torch.data import BatchLoader as TLoader
from repro_torch.data import SyntheticActionDataset as TDS
from repro_torch.launch import pipeline as tpipe
from repro_torch.launch import train as ttrain
from repro_torch.types import FedConfig as TFed

from torch_parity import assert_params_close, jax_params_both, port_params

ASYNC = dict(num_clients=4, global_epochs=6, local_iters_min=1,
             local_iters_max=2, lr=0.05)
SYNC = dict(num_clients=4, global_epochs=8, local_iters_min=1,
            local_iters_max=2, lr=0.01)


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


def _trace_key(res):
    return [(e.kind, e.client, e.global_epoch, e.staleness, e.time, e.beta_t)
            for e in res.trace]


def _same_clock(a, b):
    assert a.wall_clock_s == b.wall_clock_s
    assert a.staleness_hist == b.staleness_hist
    assert a.group_hist == b.group_hist
    assert a.max_inflight == b.max_inflight
    assert [h[:2] for h in a.history] == [h[:2] for h in b.history]
    assert _trace_key(a) == _trace_key(b)


def _port(run, tc, tp, fed, engine, **kw):
    return run(tp, tc, TFed(**fed), Fleet.from_lists(
        JETSON_FLEET_HMDB51, _loaders(TLoader, TDS)), engine=engine,
        device="cpu", **kw)


ASYNC_CASES = [dict(window=0.0), dict(window=300.0),
               dict(window=0.0, per_round=2, jitter=0.3)]


@pytest.mark.parametrize("case", ASYNC_CASES, ids=["w0", "w300", "m2"])
def test_run_async_scan_matches_loop_and_reference(setup, case):
    jc, tc, jp, tp = setup
    per_round = case.get("per_round", 0)
    fed = dict(ASYNC, clients_per_round=per_round)
    kw = dict(window=case["window"], jitter=case.get("jitter", 0.0))
    scan = _port(tsim.run_async, tc, tp, fed, "scan", **kw)
    loop = _port(tsim.run_async, tc, tp, fed, "loop", **kw)
    _same_clock(scan, loop)
    if case["window"]:
        assert max(scan.group_hist) > 1            # grouping happened
    np.testing.assert_allclose([h[2] for h in scan.history],
                               [h[2] for h in loop.history], rtol=1e-4)
    for k in loop.params:
        np.testing.assert_allclose(scan.params[k].numpy(),
                                   loop.params[k].numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    ref = jsim.run_async(jp, jc, JFed(**fed), JFleet.from_lists(
        JETSON_FLEET_HMDB51, _loaders(JLoader, JDS)), engine="scan", **kw)
    _same_clock(scan, ref)
    np.testing.assert_allclose([h[2] for h in scan.history],
                               [h[2] for h in ref.history], rtol=1e-3)
    assert_params_close(ref.params, scan.params, rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("per_round,jitter", [(0, 0.0), (2, 0.3)])
def test_run_sync_scan_matches_loop_and_reference(setup, per_round, jitter):
    jc, tc, jp, tp = setup
    fed = dict(SYNC, clients_per_round=per_round)
    scan = _port(tsim.run_sync, tc, tp, fed, "scan", jitter=jitter)
    loop = _port(tsim.run_sync, tc, tp, fed, "loop", jitter=jitter)
    assert len(scan.history) == (4 if per_round else 2)
    _same_clock(scan, loop)
    np.testing.assert_allclose([h[2] for h in scan.history],
                               [h[2] for h in loop.history], rtol=1e-4)
    for k in loop.params:
        np.testing.assert_allclose(scan.params[k].numpy(),
                                   loop.params[k].numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    ref = jsim.run_sync(jp, jc, JFed(**fed), JFleet.from_lists(
        JETSON_FLEET_HMDB51, _loaders(JLoader, JDS)), engine="scan",
        jitter=jitter)
    _same_clock(scan, ref)
    np.testing.assert_allclose([h[2] for h in scan.history],
                               [h[2] for h in ref.history], rtol=1e-3)
    assert_params_close(ref.params, scan.params, rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("bits", [8, 4])
def test_run_async_compressed_matches_loop_and_reference(bits):
    """``fed.compress_bits``: every dispatch's delta through the int8 /
    int4 round trip, at the reference's own test shape
    (``tests/test_fed_engine.py``: its tiny dense LM, lr 0.01): ``scan``
    against ``loop`` and against the reference's ``scan`` at the
    reference's tolerance for compressed runs (losses and params rtol
    1e-3, atol 1e-4), the clock and histograms exactly."""
    from repro.data import SyntheticLMDataset
    from repro.types import ModelConfig as JModel
    from repro_torch.types import ModelConfig as TModel
    tiny = dict(name="engine-test-tiny", family="dense", num_layers=1,
                d_model=32, num_heads=2, num_kv_heads=2, d_ff=64,
                vocab_size=64)
    fed = dict(num_clients=4, global_epochs=6, local_iters_min=1,
               local_iters_max=3, lr=0.01, compress_bits=bits)
    jc, tc = JModel(**tiny), TModel(**tiny)
    jp, flat = jax_params_both(jc, jax.random.PRNGKey(0))
    tp = port_params(flat, tc)
    ds = SyntheticLMDataset(vocab=64, seq_len=8, seed=0)

    def loaders(Loader):
        return [Loader(ds, 2, steps=4, seed=k) for k in range(4)]
    scan, loop = (tsim.run_async(tp, tc, TFed(**fed), Fleet.from_lists(
        JETSON_FLEET_HMDB51, loaders(TLoader)), engine=e, device="cpu")
        for e in ("scan", "loop"))
    ref = jsim.run_async(jp, jc, JFed(**fed), JFleet.from_lists(
        JETSON_FLEET_HMDB51, loaders(JLoader)), engine="scan")
    for other in (loop, ref):
        _same_clock(scan, other)
        np.testing.assert_allclose([h[2] for h in scan.history],
                                   [h[2] for h in other.history],
                                   rtol=1e-3, atol=1e-4)
    for k in loop.params:
        np.testing.assert_allclose(scan.params[k].numpy(),
                                   loop.params[k].numpy(), rtol=1e-3,
                                   atol=1e-4, err_msg=k)
    assert_params_close(ref.params, scan.params, rtol=1e-3, atol=1e-4)


def test_pipeline_defaults_to_scan_and_equals_loop():
    """``run_pipeline`` runs ``scan`` by default, and each mode's result
    equals ``loop``'s within the engine's tolerance (a masked step is a
    ``torch.where``; the sync average is an einsum); stage 1 is the same
    call on both."""
    kw = dict(reduced=True, clients=2, epochs=2, batch=2, kd_steps=2,
              teacher_steps=1, seed=0, device="cpu")
    for mode in ("async", "sync"):
        scan, sp = tpipe.run_pipeline(mode=mode, **kw)
        loop, lp = tpipe.run_pipeline(mode=mode, engine="loop", **kw)
        assert (scan["engine"], loop["engine"]) == ("scan", "loop")
        assert scan["stage1"]["digest"] == loop["stage1"]["digest"]
        assert scan["stage2"]["virtual_wall_s"] == \
            loop["stage2"]["virtual_wall_s"]
        np.testing.assert_allclose(scan["stage2"]["losses"],
                                   loop["stage2"]["losses"], rtol=1e-4)
        for k in lp:
            np.testing.assert_allclose(sp[k].numpy(), lp[k].numpy(),
                                       rtol=1e-5, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("mode", ["async", "sync"])
def test_train_engine_flag(mode, capsys):
    args = ["--mode", mode, "--reduced", "--epochs", "4", "--clients", "2",
            "--batch", "2", "--lr", "0.01", "--device", "cpu"]
    results = {}
    for engine in ("scan", "loop"):
        assert ttrain.main(args + ["--engine", engine]) == 0
        results[engine] = json.loads(
            capsys.readouterr().out.strip().splitlines()[-1])
    scan, loop = results["scan"], results["loop"]
    assert scan["virtual_wall_s"] == loop["virtual_wall_s"]
    np.testing.assert_allclose(scan["final_loss"], loop["final_loss"],
                               rtol=1e-4)

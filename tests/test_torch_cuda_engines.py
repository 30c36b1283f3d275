"""The batched engines and the captured KD epoch on the card: each replayed
CUDA graph against the same function run eagerly on the card (TF32 off;
1e-5 * (1 + |eager|)), no host sync inside a replay, one capture per round
shape, the KD kernels run H times by each replayed epoch (the profiler's
device events; the wrappers count the eager run and the capture, not the
replays), outputs that outlive the next replay, and a capture that fails
raising; the algorithm layer's stateful rounds (SCAFFOLD replayed against
its eager run, one capture per round shape over H^k draws and mixed
LowRank capacities, no host sync in their replays, LowRank's SVD refused
by a capture and run between the round's two graphs); a codistillation
round replayed against its eager run (cuDNN deterministic: bit for bit)
with 2 × H launches of each KD kernel on the card, budgets that change
across rounds capturing nothing new, and a streamed fleet of 8 clients
against its materialized twin, sync and async, bit for bit; under a
scheduled rate, KD epochs and a ragged round replayed against their eager
runs, the step a graph input. Needs an
NVIDIA GPU and nvcc; elsewhere every test skips with a reason. Imports no
JAX:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda_engines.py
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config
from repro_torch.core import (algorithms, distill, fed_engine, fedasync,
                              simulator)
from repro_torch.core.compile_cache import GraphCache
from repro_torch.core.fleet import JETSON_FLEET_HMDB51, Fleet, FleetSpec
from repro_torch.data import SyntheticActionDataset, stack_batches
from repro_torch.device import batch_to
from repro_torch.kernels import kd_loss
from repro_torch.models import registry
from repro_torch.optim import trainable_mask
from repro_torch.types import DistillConfig, FedConfig

pytestmark = pytest.mark.cuda

TOL = 1e-5      # |replay - eager| <= TOL * (1 + |eager|)
FED = FedConfig(num_clients=3, local_iters_min=1, local_iters_max=3,
                lr=0.01)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA graph has no CPU mode")
    cudnn, matmul = (torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = cudnn
    torch.backends.cuda.matmul.allow_tf32 = matmul


def _close(got: dict, want: dict):
    for k in want:
        g, w = got[k].float(), want[k].float()
        assert bool(((g - w).abs() <= TOL * (1 + w.abs())).all()), k


def _setup(device, seed=0):
    cfg = get_config("resnet3d-18").reduced()
    params = registry.init_params(torch.Generator().manual_seed(seed), cfg,
                                  device)
    ds = SyntheticActionDataset(num_classes=8, samples_per_class=8, seed=1)
    stacks = [stack_batches(ds.batches(2, 3, seed=k)) for k in range(3)]
    padded, _ = fed_engine.pad_client_batches(stacks)
    return cfg, params, ds, padded


def test_replayed_round_equals_eager(cuda):
    cfg, params, _, padded = _setup(cuda)
    iters = np.asarray([3, 1, 2], np.int32)
    run = fed_engine.ClientRun(cfg, FED)
    mask = trainable_mask(params, FED.trainable)
    want = run._clients(params, batch_to(padded, cuda), mask,
                        torch.as_tensor(iters, device=cuda))
    for _ in range(3):                 # eager, capture and replay, replay
        got = run.run_batch(params, padded, iters)
        _close(got[0], want[0])
        np.testing.assert_array_equal(torch.isnan(got[1]).cpu(),
                                      torch.isnan(want[1]).cpu())
        _close({"l": got[1].nan_to_num()}, {"l": want[1].nan_to_num()})
    sync = fed_engine.SyncRound(cfg, FED)
    weights = np.asarray([0.2, 0.3, 0.5], np.float32)
    want = sync._rnd_padded(params, batch_to(padded, cuda),
                            torch.as_tensor(weights, device=cuda),
                            torch.as_tensor(iters, device=cuda), mask)
    for _ in range(3):
        got = sync(params, padded, weights=weights, iters=iters)
        _close(got[0], want[0])
    assert run._graphs.num_captured == sync._graphs.num_captured == 1


def test_one_capture_per_round_shape_and_no_host_sync(cuda):
    cfg, params, _, padded = _setup(cuda)
    run = fed_engine.ClientRun(cfg, FED)
    mix = fedasync.make_batched_server_update(FED)
    for _ in range(2):                 # eager, then the capture
        run.run_batch(params, padded, np.asarray([3, 3, 3], np.int32))
        mix(params, [0.5, 0.25], params, params)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for draw in ([1, 2, 3], [2, 2, 1]):
            run.run_batch(params, padded, np.asarray(draw, np.int32))
        mix(params, [0.1, 0.2], params, params)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert run.num_compiled == 1 and run._graphs.num_captured == 1


def test_outputs_outlive_the_next_replay(cuda):
    """Two dispatches through one graph after its capture: the first
    w_new still equals its eager run once the second replay wrote the
    graph's memory."""
    cfg, params, ds, _ = _setup(cuda)
    run = fed_engine.ClientRun(cfg, FED)
    mask = trainable_mask(params, FED.trainable)
    a, b, c = (stack_batches(ds.batches(2, 2, seed=s)) for s in (7, 8, 9))
    run(params, c)                     # eager; a's call captures
    w_a, _ = run(params, a)
    w_b, _ = run(params, b)
    want, _ = run._run(params, batch_to(a, cuda), mask)
    _close(w_a, want)
    assert any(not torch.equal(w_a[k], w_b[k]) for k in w_a)


def _kd_device_launches(fn) -> dict:
    """``fn()``'s KD forward and backward kernels, from the profiler's
    device events (a replayed graph's kernels are listed one by one)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if "kd_loss" in e.name]
    return out, {"fwd": sum("bwd" not in n for n in names),
                 "bwd": sum("bwd" in n for n in names)}


def test_replayed_kd_epoch_equals_eager_and_counts_h_launches(cuda):
    """The KD epoch replayed as one graph equals the eager epoch on the
    card (the backward kernel, launched from autograd's device thread, is
    in the graph: the student's update needs its ds). The wrappers count
    H launches of each kernel in the first, eager call and H more in the
    capture, none in a replay; the card runs each kernel H times a call,
    replays included."""
    tcfg = get_config("resnet3d-34").reduced()
    scfg = get_config("resnet3d-18").reduced()
    gen = torch.Generator().manual_seed(0)
    teacher = registry.init_params(gen, tcfg, cuda)
    student = registry.init_params(gen, scfg, cuda)
    ds = SyntheticActionDataset(num_classes=8, samples_per_class=8, seed=1)
    H = 4
    stacked = stack_batches(ds.batches(2, H, seed=3))
    engine = distill.DistillEngine(tcfg, scfg, DistillConfig(lr=0.01))
    state = engine.opt.init(student)
    want = engine._epoch(teacher, student, state["mom"],
                         batch_to(stacked, cuda))
    for i, counted in enumerate((H, H, 0, 0)):   # eager, capture, replays
        f0 = kd_loss.kd_loss_fused.launches
        b0 = kd_loss.kd_loss_fused_bwd.launches
        if i == 3:
            torch.cuda.set_sync_debug_mode("error")
        try:
            if i in (0, 2):            # eager and a replay, traced
                (p, st, losses), ran = _kd_device_launches(
                    lambda: engine.epoch(teacher, student, state, stacked))
                assert ran == {"fwd": H, "bwd": H}
            else:                      # the capture; a replay, guarded
                p, st, losses = engine.epoch(teacher, student, state,
                                             stacked)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert kd_loss.kd_loss_fused.launches - f0 == counted
        assert kd_loss.kd_loss_fused_bwd.launches - b0 == counted
        _close(p, want[0])
        _close(st["mom"], want[1])
        _close({"l": losses}, {"l": want[2]})
    assert engine._graphs.num_captured == 1


_FAILING_CAPTURE = """
import torch
from repro_torch.core.compile_cache import GraphCache
cache = GraphCache()
x = torch.ones(4, device="cuda")
cache.call("sync", lambda t: t * float(t.sum()), (x,))   # eager
try:
    cache.call("sync", lambda t: t * float(t.sum()), (x,))
except RuntimeError as e:
    print("raised", cache.num_captured)
"""


def test_a_capture_that_fails_raises(cuda):
    """A host read inside the function cannot be captured: the second
    call, which captures, raises, and nothing runs eagerly in the graph's
    place (in a process of its own: a failed capture may leave the card's
    stream unusable)."""
    src = Path(__file__).resolve().parents[1] / "src"
    out = subprocess.run([sys.executable, "-c", _FAILING_CAPTURE],
                         env={**os.environ, "PYTHONPATH": str(src)},
                         capture_output=True, text=True, timeout=300)
    assert out.stdout.split() == ["raised", "0"], out.stderr


def _stateful(alg, params, n=3):
    alg.bind_fleet(None)
    return alg.ctx_for(params), alg.stacked_states(params, range(n))


def test_replayed_scaffold_round_equals_eager(cuda):
    """A SCAFFOLD round (the client half, the variate update, the weighted
    fold and the server context's update in one graph) replayed against
    the same round run eagerly, cuDNN deterministic: params, context and
    states."""
    cfg, params, _, padded = _setup(cuda)
    iters = np.asarray([3, 1, 2], np.int32)
    weights = np.asarray([0.2, 0.3, 0.5], np.float32)
    alg = algorithms.Scaffold()
    ctx, states = _stateful(alg, params)
    sync = fed_engine.SyncRound(cfg, FED, algorithm=alg)
    mask = trainable_mask(params, FED.trainable)
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        want = sync._rnd_padded(params, batch_to(padded, cuda), weights,
                                torch.as_tensor(iters, device=cuda), mask,
                                ctx, states)
        for _ in range(3):             # eager, capture and replay, replay
            got = sync(params, padded, weights=weights, iters=iters,
                       server_ctx=ctx, states=states)
            _close(got[0], want[0])
            _close(got[1], want[1])
            for k in want[2]:
                _close({k: got[2][k]}, {k: want[2][k]})
    finally:
        torch.backends.cudnn.deterministic = det
    assert sync._graphs.num_captured == 1
    assert float(sum(v.abs().sum() for v in got[1].values())) > 0


def test_stateful_rounds_capture_once_per_shape_without_host_sync(cuda):
    """Three H^k draws and the LowRank clients' mixed capacities share one
    graph per round shape (two for the LowRank round, whose SVD runs
    between them); a replay of each reads nothing back to the host."""
    cfg, params, _, padded = _setup(cuda)
    weights = np.asarray([0.2, 0.3, 0.5], np.float32)
    mask = trainable_mask(params, FED.trainable)
    draws = [np.asarray(d, np.int32) for d in ([3, 1, 2], [1, 1, 3],
                                               [2, 3, 3])]
    for alg, n_round in ((algorithms.Scaffold(), 1),
                         (algorithms.LowRankSubmodel(), 2)):
        ctx, states = _stateful(alg, params)
        if isinstance(alg, algorithms.LowRankSubmodel):
            for k, cap in enumerate((0.2, 0.5, 1.0)):
                alg.set_capacity(k, cap)
            alg.reset()
            ctx, states = _stateful(alg, params)
            np.testing.assert_array_equal(states["cap"].cpu().numpy(),
                                          np.float32([0.2, 0.5, 1.0]))
        run = fed_engine.ClientRun(cfg, FED, algorithm=alg)
        sync = fed_engine.SyncRound(cfg, FED, algorithm=alg)
        for d in draws:
            run.run_batch(params, padded, d, server_ctx=ctx, states=states)
            sync(params, padded, weights=weights, iters=d, server_ctx=ctx,
                 states=states)
        assert [run.num_compiled, run._graphs.num_captured] == [1, 1]
        assert [sync.num_compiled, sync._graphs.num_captured] == \
            [n_round, n_round]
        if n_round == 2:
            w, st, msgs, _ = sync.client_half(params, padded, mask,
                                              draws[0], ctx, states)
            w_eff = alg.reduce_prepare(w, params, st, ctx)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            run.run_batch(params, padded, draws[1], server_ctx=ctx,
                          states=states)
            if n_round == 1:
                sync(params, padded, weights=weights, iters=draws[1],
                     server_ctx=ctx, states=states)
            else:
                sync.client_half(params, padded, mask, draws[1], ctx, states)
                sync.fold(w_eff, params, weights, msgs, ctx)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert sync._graphs.num_captured == n_round


_SVD_CAPTURE = """
import torch
from repro_torch.core.algorithms import LowRankSubmodel
from repro_torch.core.compile_cache import GraphCache
alg = LowRankSubmodel()
anchor = {"fc/w": torch.randn(512, 400, device="cuda")}
w = {"fc/w": anchor["fc/w"][None] + 1e-3 * torch.randn(2, 512, 400,
                                                      device="cuda")}
states = {"cap": torch.tensor([0.25, 0.5], device="cuda")}
cache = GraphCache()
args = (w, anchor, states, ())
cache.call("prepare", alg.reduce_prepare, args)           # eager
try:
    cache.call("prepare", alg.reduce_prepare, args)       # the capture
    print("captured", cache.num_captured)
except RuntimeError as e:
    print("raised", cache.num_captured)
"""


def test_lowrank_svd_capture_raises_and_never_falls_back(cuda):
    """LowRank's reduce_prepare (``torch.linalg.svd`` of each client's
    ``fc/w`` delta) captured: either it captures, or the capture raises
    and nothing runs in the graph's place; the algorithm declares which,
    and the sync round splits around the prepare only when it must (in a
    process of its own: a failed capture may leave the stream unusable)."""
    src = Path(__file__).resolve().parents[1] / "src"
    out = subprocess.run([sys.executable, "-c", _SVD_CAPTURE],
                         env={**os.environ, "PYTHONPATH": str(src)},
                         capture_output=True, text=True, timeout=300)
    if algorithms.LowRankSubmodel.prepare_in_graph:
        assert out.stdout.split() == ["captured", "1"], out.stderr
    else:
        assert out.stdout.split() == ["raised", "0"], out.stderr


class _Deterministic:
    """cuDNN's deterministic algorithms inside the block (TF32 is off in
    the ``cuda`` fixture): a computation repeated on the card, eagerly or
    replayed, gives the same bits."""

    def __enter__(self):
        self.det = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True

    def __exit__(self, *exc):
        torch.backends.cudnn.deterministic = self.det


def _codistill_fleet(device):
    cfgs = [get_config("resnet3d-34").reduced(),
            get_config("resnet3d-18").reduced()]
    return distill.CodistillFleet(cfgs, DistillConfig(lr=0.01)).init(
        torch.Generator().manual_seed(0), device)


def _probes(n, H=4):
    ds = SyntheticActionDataset(num_classes=8, samples_per_class=8, seed=1)
    return [stack_batches(ds.batches(2, H, seed=10 + i)) for i in range(n)]


def test_replayed_codistill_round_equals_eager(cuda):
    """Two fleets from one init: the first runs its second round through
    the graphs captured then (the capture runs nothing; the replay
    does), the second runs it eagerly (a fresh graph cache). Losses, NaN
    pattern and every member's params equal bit for bit. A later replay
    runs 2 members × H steps of each KD kernel on the card, none of them
    launched from the host; the capture counted them once."""
    H = 4
    p1, p2 = _probes(2, H)
    with _Deterministic():
        a, b = _codistill_fleet(cuda), _codistill_fleet(cuda)
        a.round(p1)
        b.round(p1)
        f0 = kd_loss.kd_loss_fused.launches
        got = a.round(p2, iters=[4, 2])
        assert kd_loss.kd_loss_fused.launches - f0 == 2 * H
        b._graphs = GraphCache()
        want = b.round(p2, iters=[4, 2])
        for i in range(2):
            for k, v in b.member_params(i).items():
                assert torch.equal(a.member_params(i)[k], v), k
        f0 = kd_loss.kd_loss_fused_bwd.launches
        _, ran = _kd_device_launches(lambda: a.round(p1))
    assert kd_loss.kd_loss_fused_bwd.launches == f0
    assert ran == {"fwd": 2 * H, "bwd": 2 * H}
    assert bool(got[1, 2:].isnan().all())
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))
    assert a._graphs.num_captured == 4


def test_codistill_budgets_make_no_new_capture(cuda):
    """Budget vectors that change from round to round are inputs of the
    KD graphs: after the capture no round adds a signature or a graph,
    and a replayed round reads nothing back to the host."""
    fleet = _codistill_fleet(cuda)
    probes = _probes(2)
    fleet.round(probes[0], iters=[4, 4])
    fleet.round(probes[1], iters=[3, 1])
    assert [fleet.num_compiled, fleet._graphs.num_captured] == [4, 4]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for draw in ([1, 2], [2, 4], [4, 3]):
            losses = fleet.round(probes[0], iters=draw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert [fleet.num_compiled, fleet._graphs.num_captured] == [4, 4]
    assert bool(losses[1, 3:].isnan().all())
    assert bool(losses[0].isfinite().all())


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_streamed_run_equals_materialized_on_the_card(mode, cuda):
    """A population of 8, two clients a round or in flight, streamed and
    materialized: the same params bit for bit and the same history."""
    cfg = get_config("resnet3d-18").reduced()
    params = registry.init_params(torch.Generator().manual_seed(0), cfg,
                                  cuda)
    ds = SyntheticActionDataset(num_classes=8, samples_per_class=8, seed=1)
    spec = FleetSpec(population=8, profiles=JETSON_FLEET_HMDB51, dataset=ds,
                     batch_size=2, steps=2, seed=3, partition="iid")
    fed = FedConfig(num_clients=8, global_epochs=8, local_iters_min=1,
                    local_iters_max=2, lr=0.05, clients_per_round=2, seed=5)
    run = simulator.run_sync if mode == "sync" else simulator.run_async
    with _Deterministic():
        streamed = Fleet.from_spec(spec)
        a = run(params, cfg, fed, streamed, device=cuda)
        b = run(params, cfg, fed, Fleet.from_spec(spec).materialize(),
                device=cuda)
    assert a.history == b.history
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k
    assert streamed.max_resident <= 2


def test_scheduled_replays_equal_eager_without_host_sync(cuda):
    """Under a scheduled rate the step is a tensor input of each graph:
    three KD epochs of H 4 (eager, capture, replay) carry it to 12, each
    equal to the eager epoch from the same state, with one
    capture; a ragged ``run_batch`` under ``inverse_sqrt`` replays its
    eager run; the replays read nothing back to the host."""
    from repro_torch.optim import schedules
    cfg, params, ds, padded = _setup(cuda)
    teacher = registry.init_params(torch.Generator().manual_seed(1), cfg,
                                   cuda)
    engine = distill.DistillEngine(
        cfg, cfg, DistillConfig(lr=schedules.cosine(0.01, 12, 2)))
    run = fed_engine.ClientRun(
        cfg, dataclasses.replace(FED, lr=schedules.inverse_sqrt(0.05, 1)))
    iters = np.asarray([3, 1, 2], np.int32)
    mask = trainable_mask(params, FED.trainable)
    with _Deterministic():
        state = engine.opt.init(params)
        student = params
        for e in range(3):
            stacked = stack_batches(ds.batches(2, 4, seed=20 + e))
            want = engine._epoch(teacher, student, state["mom"],
                                 batch_to(stacked, cuda), state["step"])
            if e == 2:
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
            try:
                student, state, losses = engine.epoch(teacher, student,
                                                      state, stacked)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            _close(student, want[0])
            _close({"l": losses}, {"l": want[2]})
            assert torch.equal(state["step"], want[3])
        want = run._clients(params, batch_to(padded, cuda), mask,
                            torch.as_tensor(iters, device=cuda))
        for i in range(3):
            if i == 2:
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
            try:
                got = run.run_batch(params, padded, iters, mask=mask)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            _close(got[0], want[0])
    assert int(state["step"]) == 12
    assert engine._graphs.num_captured == run._graphs.num_captured == 1

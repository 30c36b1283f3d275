"""The sharded and hierarchical sync rounds split for real, over gloo ranks
on the CPU: 2 ranks on the ``("clients",)`` mesh and 4 on the (2, 2)
``("edge", "clients")`` tree, each started by ``torch.multiprocessing
.spawn`` over a ``FileStore`` and bounded by its own time limit (a rank
that hangs fails the test; its collectives time out after 60 s as well).

Each rank checks, against the port's scan round run in the same process:
3 and 5 clients (so the client axis pads with zero-weight dummies),
ragged H^k with a zero-weight client, FedProx, SCAFFOLD (its server
context and states too) and LowRank: params within rtol 1e-5 / atol 1e-6
(the order of the sums differs from the scan round's single einsum),
losses within 1e-6 relative, and ``run_sync``'s virtual clock exactly
the scan run's; the ragged round and ``run_sync`` again on 2 ranks under a
scheduled rate. Then ``torchrun`` of the training CLI over 2 ranks.
Imports no JAX: the spawned ranks import this module."""
import datetime
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist
import torch.multiprocessing as mp

ROOT = Path(__file__).resolve().parents[1]
SPAWN_LIMIT_S = 240
TINY = dict(name="ranks-test-tiny", family="dense", num_layers=1,
            d_model=32, num_heads=2, num_kv_heads=2, d_ff=64, vocab_size=64)
FED = dict(num_clients=5, global_epochs=10, local_iters_min=1,
           local_iters_max=3, lr=0.05)
# (H^k, data sizes): 3 clients, one of zero weight; 5 ragged clients
ROUNDS = (([3, 1, 2], [10, 30, 0]), ([3, 1, 2, 3, 1], [32, 8, 16, 32, 0]))


def _close(got: dict, want: dict, what: str):
    assert set(got) == set(want), what
    for k in want:
        np.testing.assert_allclose(got[k].float().numpy(),
                                   want[k].float().numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=f"{what}: {k}")


def _losses_close(got, want, what: str):
    assert [len(l) for l in got] == [len(l) for l in want], what
    np.testing.assert_allclose(np.concatenate(got), np.concatenate(want),
                               rtol=1e-6, err_msg=what)


def _rank(rank: int, world: int, store: str, edges, out: str):
    """One rank: every check against its own scan round; rank 0 writes
    what it checked to ``out``."""
    from repro_torch.core import algorithms, fed_engine, fedavg, simulator
    from repro_torch.core.fleet import JETSON_FLEET_HMDB51, Fleet
    from repro_torch.data import BatchLoader, SyntheticLMDataset
    from repro_torch.launch.mesh import make_fleet_mesh
    from repro_torch.models import registry
    from repro_torch.types import FedConfig, ModelConfig
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    mesh = make_fleet_mesh(edges=edges, device="cpu")
    engine = "shard" if edges is None else "hier"
    cfg = ModelConfig(**TINY)
    params = registry.init_params(torch.Generator().manual_seed(0), cfg,
                                  "cpu")
    ds = SyntheticLMDataset(vocab=64, seq_len=8, seed=0)
    fed = FedConfig(**FED)
    checked = []
    for counts, sizes in ROUNDS:
        for alg in (None, "fedprox", "scaffold", "lowrank"):
            a_scan, a_shard = (algorithms.make_algorithm(alg),
                               algorithms.make_algorithm(alg)) \
                if alg else (None, None)
            for r in range(2 if alg == "scaffold" else 1):
                data = [list(ds.batches(4, h, seed=k + 10 * r))
                        for k, h in enumerate(counts)]
                want, wl = fedavg.fedavg_round(params, data, cfg, fed,
                                               data_sizes=sizes,
                                               algorithm=a_scan)
                got, gl = fedavg.fedavg_round(params, data, cfg, fed,
                                              engine=engine,
                                              data_sizes=sizes,
                                              algorithm=a_shard)
                what = f"{len(counts)} clients, {alg}, round {r}"
                _close(got, want, what)
                _losses_close(gl, wl, what)
                if alg == "scaffold":
                    _close(a_shard.ctx_for(params), a_scan.ctx_for(params),
                           what + ": server context")
                    for k in range(len(counts)):
                        _close(a_shard.state_for(k, params),
                               a_scan.state_for(k, params),
                               f"{what}: state {k}")
                if alg == "lowrank":
                    for k in range(len(counts)):
                        _close(a_shard.state_for(k, params)["mask"],
                               a_scan.state_for(k, params)["mask"],
                               f"{what}: mask {k}")
                checked.append(what)
    rnd = fed_engine.make_sharded_sync_round(cfg, fed, mesh=mesh) \
        if edges is None else \
        fed_engine.make_hierarchical_sync_round(cfg, fed, mesh=mesh)
    assert rnd.mesh is mesh and rnd._n_shards == world

    def fleet():
        return Fleet.from_lists(
            list(JETSON_FLEET_HMDB51) + [JETSON_FLEET_HMDB51[1]],
            [BatchLoader(ds, 2, steps=3, seed=k) for k in range(5)])
    runs = {e: simulator.run_sync(params, cfg, fed, fleet(), engine=e,
                                  jitter=0.3, device="cpu",
                                  algorithm="scaffold")
            for e in ("scan", engine)}
    assert runs[engine].wall_clock_s == runs["scan"].wall_clock_s
    assert [h[:2] for h in runs[engine].history] == \
        [h[:2] for h in runs["scan"].history]
    _close(runs[engine].params, runs["scan"].params, "run_sync")
    checked.append(f"run_sync {engine}")
    if rank == 0:
        Path(out).write_text(json.dumps({
            "mesh": list(mesh.mesh_dim_names), "shape": list(mesh.shape),
            "checked": checked, "clock": runs[engine].wall_clock_s}))
    dist.destroy_process_group()


def _rank_scheduled(rank: int, world: int, store: str, edges, out: str):
    """One rank under ``inverse_sqrt``: the 5-client ragged round with a
    zero-weight client and ``run_sync`` against the rank's own scan
    round and run; rank 0 writes the clock to ``out``."""
    from repro_torch.core import fedavg, simulator
    from repro_torch.core.fleet import JETSON_FLEET_HMDB51, Fleet
    from repro_torch.data import BatchLoader, SyntheticLMDataset
    from repro_torch.models import registry
    from repro_torch.optim import schedules
    from repro_torch.types import FedConfig, ModelConfig
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    cfg = ModelConfig(**TINY)
    params = registry.init_params(torch.Generator().manual_seed(0), cfg,
                                  "cpu")
    ds = SyntheticLMDataset(vocab=64, seq_len=8, seed=0)
    fed = FedConfig(**dict(FED, lr=schedules.inverse_sqrt(0.05, 1)))
    counts, sizes = ROUNDS[1]
    data = [list(ds.batches(4, h, seed=k)) for k, h in enumerate(counts)]
    want, wl = fedavg.fedavg_round(params, data, cfg, fed, data_sizes=sizes)
    got, gl = fedavg.fedavg_round(params, data, cfg, fed, engine="shard",
                                  data_sizes=sizes)
    _close(got, want, "scheduled round")
    _losses_close(gl, wl, "scheduled round")

    def fleet():
        return Fleet.from_lists(
            list(JETSON_FLEET_HMDB51) + [JETSON_FLEET_HMDB51[1]],
            [BatchLoader(ds, 2, steps=3, seed=k) for k in range(5)])
    runs = {e: simulator.run_sync(params, cfg, fed, fleet(), engine=e,
                                  device="cpu") for e in ("scan", "shard")}
    assert runs["shard"].wall_clock_s == runs["scan"].wall_clock_s
    _close(runs["shard"].params, runs["scan"].params, "scheduled run_sync")
    if rank == 0:
        Path(out).write_text(json.dumps({"clock":
                                         runs["shard"].wall_clock_s}))
    dist.destroy_process_group()


def _spawn(world: int, edges, tmp_path, fn=_rank) -> dict:
    """``world`` ranks of ``fn``; fails, never hangs, past
    ``SPAWN_LIMIT_S``."""
    out = tmp_path / "rank0.json"
    ctx = mp.spawn(fn, args=(world, str(tmp_path / "store"), edges,
                                str(out)),
                   nprocs=world, join=False)
    deadline = time.monotonic() + SPAWN_LIMIT_S
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"{world} ranks did not finish in {SPAWN_LIMIT_S} s")
    return json.loads(out.read_text())


def test_two_ranks_on_the_clients_mesh(tmp_path):
    got = _spawn(2, None, tmp_path)
    assert got["mesh"] == ["clients"] and got["shape"] == [2]
    assert len(got["checked"]) == 11


def test_four_ranks_on_the_edge_clients_tree(tmp_path):
    got = _spawn(4, 0, tmp_path)
    assert got["mesh"] == ["edge", "clients"] and got["shape"] == [2, 2]
    assert len(got["checked"]) == 11


def test_two_ranks_under_a_scheduled_rate(tmp_path):
    assert _spawn(2, None, tmp_path, _rank_scheduled)["clock"] > 0


def test_torchrun_of_the_training_cli_over_two_ranks():
    """Two gloo ranks of ``launch.train --engine shard``: one result line,
    rank 0's, with the single-process scan run's clock."""
    argv = ["-m", "repro_torch.launch.train", "--mode", "sync", "--reduced",
            "--device", "cpu", "--epochs", "2"]
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2"] + argv + ["--engine", "shard"],
        cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=SPAWN_LIMIT_S)
    assert run.returncode == 0, run.stderr[-4000:]
    lines = [l for l in run.stdout.splitlines() if l.startswith("{")]
    assert len(lines) == 1, run.stdout
    got = json.loads(lines[0])
    want = json.loads(subprocess.run(
        [sys.executable] + argv + ["--engine", "scan"], cwd=ROOT, env=env,
        capture_output=True, text=True,
        timeout=SPAWN_LIMIT_S).stdout.splitlines()[-1])
    assert got["mode"] == "sync" and got["algorithm"] == "fedprox"
    assert got["virtual_wall_s"] == want["virtual_wall_s"]
    np.testing.assert_allclose(got["final_loss"], want["final_loss"],
                               rtol=1e-5)

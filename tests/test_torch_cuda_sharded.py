"""The sharded and hierarchical sync rounds on the card, in a world of one
over NCCL (``launch.mesh.init_world``; more ranks need more cards): the
shard and hier rounds against the scan round, TF32 off and cuDNN
deterministic, within 1e-6 * (1 + |scan|) (a world of one gives 0.0), on
a ragged round with a zero-weight client, for FedProx, SCAFFOLD (its
server context too) and LowRank; one CUDA graph per round shape with its
collectives inside (two for LowRank's round, split around its SVD),
replayed with no host sync. With two or more cards, ``torchrun`` of the
trainer with one rank a card (NCCL across cards, the (2, 2) tree on four)
against the single-process scan run: the virtual clock exactly, params
within 1e-3 * (1 + |scan|) (TF32 and cuDNN at PyTorch's defaults in both
runs). Needs an NVIDIA GPU; elsewhere every test skips with a reason.
Imports no JAX:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda_sharded.py
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config
from repro_torch.core import algorithms, fed_engine, fedavg
from repro_torch.data import SyntheticActionDataset, stack_batches
from repro_torch.launch.mesh import make_fleet_mesh
from repro_torch.models import registry
from repro_torch.types import FedConfig

pytestmark = pytest.mark.cuda

TOL = 1e-6      # |shard - scan| <= TOL * (1 + |scan|)
FED = FedConfig(num_clients=5, local_iters_min=1, local_iters_max=3,
                lr=0.01)
COUNTS, SIZES = [3, 1, 2, 3, 1], [32, 8, 16, 32, 0]
ENGINES = ("shard", "hier")
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: NCCL and CUDA graphs have no "
                    "CPU mode")
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    yield torch.device("cuda")
    (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.deterministic) = saved


def _setup(device):
    cfg = get_config("resnet3d-18").reduced()
    params = registry.init_params(torch.Generator().manual_seed(0), cfg,
                                  device)
    ds = SyntheticActionDataset(num_classes=8, samples_per_class=8, seed=1)
    return cfg, params, ds


def _data(ds, seed=0):
    return [list(ds.batches(2, h, seed=seed + k))
            for k, h in enumerate(COUNTS)]


def _close(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        g, w = got[k].float(), want[k].float()
        assert bool(((g - w).abs() <= TOL * (1 + w.abs())).all()), k


def test_the_mesh_is_a_world_of_one_over_nccl(cuda):
    import torch.distributed as dist
    mesh = make_fleet_mesh(device="cuda")
    assert mesh.device_type == "cuda" and mesh.size() == 1
    assert "nccl" in dist.get_backend()
    tree = make_fleet_mesh(edges=0, device="cuda")
    assert tree.mesh_dim_names == ("edge", "clients")
    with pytest.raises(ValueError):
        make_fleet_mesh(2, device="cuda")


@pytest.mark.parametrize("engine", ENGINES)
def test_round_equals_scan_one_capture_no_host_sync(cuda, engine):
    cfg, params, ds = _setup(cuda)
    want, wl = fedavg.fedavg_round(params, _data(ds), cfg, FED,
                                   data_sizes=SIZES)
    for seed in (0, 1, 0):           # eager, capture, replay
        got, gl = fedavg.fedavg_round(params, _data(ds, seed), cfg, FED,
                                      engine=engine, data_sizes=SIZES)
        if seed == 0:
            _close(got, want)
            np.testing.assert_allclose(np.concatenate(gl),
                                       np.concatenate(wl), rtol=TOL)
    rnd = (fed_engine.make_sharded_sync_round(cfg, FED, device="cuda")
           if engine == "shard" else
           fed_engine.make_hierarchical_sync_round(cfg, FED, device="cuda"))
    assert (rnd.num_compiled, rnd._graphs.num_captured) == (1, 1)
    stacked, iters = fed_engine.pad_client_batches(
        [stack_batches(b) for b in _data(ds)])
    weights = np.asarray(SIZES, np.float32) / np.float32(sum(SIZES))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        replayed = rnd(params, stacked, weights=weights, iters=iters)
        torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert rnd._graphs.num_captured == 1
    assert all(bool(torch.isfinite(v).all()) for v in replayed[0].values())


@pytest.mark.parametrize("engine", ENGINES)
def test_stateful_algorithms_equal_scan(cuda, engine):
    cfg, params, ds = _setup(cuda)
    for name, captures in (("scaffold", 1), ("lowrank", 2)):
        scan, shard = (algorithms.make_algorithm(name),
                       algorithms.make_algorithm(name))
        for r in range(3):           # eager, capture, replay
            want, _ = fedavg.fedavg_round(params, _data(ds, r), cfg, FED,
                                          data_sizes=SIZES, algorithm=scan)
            got, _ = fedavg.fedavg_round(params, _data(ds, r), cfg, FED,
                                         engine=engine, data_sizes=SIZES,
                                         algorithm=shard)
            _close(got, want)
            if name == "scaffold":
                _close(shard.ctx_for(params), scan.ctx_for(params))
                for k in range(len(COUNTS)):
                    _close(shard.state_for(k, params),
                           scan.state_for(k, params))
        rnd = fed_engine.make_sharded_sync_round(
            cfg, FED, device="cuda", algorithm=shard) \
            if engine == "shard" else \
            fed_engine.make_hierarchical_sync_round(
                cfg, FED, device="cuda", algorithm=shard)
        assert rnd._graphs.num_captured == captures, name


def test_torchrun_one_rank_a_card(cuda, tmp_path):
    cards = torch.cuda.device_count()
    if cards < 2:
        pytest.skip("needs two or more cards: NCCL takes one rank a card")
    argv = ["-m", "repro_torch.launch.train", "--mode", "sync", "--reduced",
            "--clients", "5", "--epochs", "10", "--algorithm", "scaffold",
            "--device", "cuda"]
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    runs = {}
    for engine, launcher in (
            ("hier", ["-m", "torch.distributed.run", "--standalone",
                      "--nproc-per-node", str(cards)]),
            ("scan", [])):
        ckpt = str(tmp_path / engine)
        run = subprocess.run(
            [sys.executable] + launcher + argv + ["--engine", engine,
                                                  "--ckpt", ckpt],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
        assert run.returncode == 0, run.stderr[-4000:]
        lines = [l for l in run.stdout.splitlines() if l.startswith("{")]
        assert len(lines) == 1, run.stdout
        with np.load(ckpt + ".npz") as f:
            runs[engine] = (json.loads(lines[0]), dict(f))
    (got, gp), (want, wp) = runs["hier"], runs["scan"]
    assert got["virtual_wall_s"] == want["virtual_wall_s"]
    assert set(gp) == set(wp)
    for k in wp:
        assert np.all(np.abs(gp[k] - wp[k]) <= 1e-3 * (1 + np.abs(wp[k]))), k

"""The port's dry run (``repro_torch/launch/dryrun.py``) on fake worlds:
``model_flops`` against the reference's formula on the reference's
configs, train / prefill / decode combos of reduced configs on a fake
(2, 2) and (16, 16) world (collectives by kind, peak bytes a rank), the
FL server programs on the fake (2, 16, 16) world, the command line, and
no process group left behind.

The reference's ``repro.launch.dryrun`` is never imported here: it sets
``XLA_FLAGS`` to 512 host devices at import, for the whole worker."""
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist

import repro.configs as jcfg
from repro_torch.configs import ASSIGNED_ARCHS, SHAPES
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_mod
from repro_torch.types import FedConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _no_world_before_or_after():
    """Each test starts without a default group (one an earlier test file
    of this worker made is dropped: its users remake theirs through
    ``init_world``) and must leave none."""
    mesh_mod.destroy_world()
    yield
    left = dist.is_initialized()
    mesh_mod.destroy_world()
    assert not left, "a process group was left behind"


def test_model_flops_equal_the_reference_formula():
    for arch in ASSIGNED_ARCHS:
        jc = jcfg.get_config(arch)
        for name, shape in SHAPES.items():
            n = jc.active_param_count()
            tokens = shape.global_batch * (1 if shape.kind == "decode"
                                           else shape.seq_len)
            want = (6.0 if shape.kind == "train" else 2.0) * n * tokens
            assert dryrun.model_flops(dryrun.get_arch(arch), shape) == want
            jr = jcfg.get_config(arch).reduced()
            assert dryrun.get_arch(arch + "-reduced").active_param_count() \
                == jr.active_param_count()


def _combo(world, shape, arch, shape_name):
    dryrun.fake_world(world)
    try:
        mesh = mesh_mod.make_mesh(shape, ("data", "model"), device="cpu")
        return dryrun.lower_combo(arch, shape_name, mesh, "test",
                                  FedConfig())
    finally:
        mesh_mod.destroy_world()


def _check(rep, world, kinds):
    d = rep.to_dict()
    assert d["chips"] == world
    assert d["flops_per_device"] > 0 and d["bytes_per_device"] > 0
    assert set(kinds) <= set(d["collectives"]), d["collectives"]
    assert all(v > 0 for v in d["collectives"].values())
    assert d["collective_bytes"] == sum(d["collectives"].values())
    assert d["peak_memory_bytes"] > 0
    assert d["model_precision"] == "bf16" and d["mfu"] > 0


@pytest.mark.parametrize("world,shape,arch,shape_name,kinds", [
    (4, (2, 2), "mamba2-130m-reduced", "train_4k",
     ("all-gather", "all-reduce")),
    (4, (2, 2), "llama4-scout-17b-a16e-reduced", "prefill_32k",
     ("all-gather",)),
    (4, (2, 2), "hymba-1.5b-reduced", "decode_32k", ("all-gather",)),
    (256, (16, 16), "llama4-scout-17b-a16e-reduced", "train_4k",
     ("all-gather", "all-reduce")),
    (256, (16, 16), "llama4-scout-17b-a16e-reduced", "prefill_32k",
     ("all-gather",)),
    (256, (16, 16), "mamba2-130m-reduced", "decode_32k", ("all-gather",))])
def test_combo_on_a_fake_world(world, shape, arch, shape_name, kinds):
    rep = _combo(world, shape, arch, shape_name)
    _check(rep, world, kinds)


def test_the_model_axis_splits_the_params_a_rank_holds():
    """The same train combo on (2, 2) and (16, 16): the larger mesh holds
    a smaller block of the params on each rank and gathers them for the
    step."""
    small = _combo(4, (2, 2), "mamba2-130m-reduced", "decode_32k")
    large = _combo(256, (16, 16), "mamba2-130m-reduced", "decode_32k")
    assert large.peak_memory_bytes < small.peak_memory_bytes
    assert large.collectives["all-gather"] < small.collectives["all-gather"]


def test_fl_aggregation_on_a_fake_multipod_world():
    dryrun.fake_world(512)
    try:
        mesh = mesh_mod.make_production_mesh(multi_pod=True, device="cpu")
        res = dryrun.lower_fl_aggregation("mamba2-130m-reduced", mesh,
                                          "multipod", FedConfig())
    finally:
        mesh_mod.destroy_world()
    assert set(res) == {"mixing", "fedavg"}
    assert res["mixing"].collectives == {}
    assert set(res["fedavg"].collectives) == {"all-reduce"}
    assert res["mixing"].chips == res["fedavg"].chips == 512
    for rep in res.values():
        assert rep.bytes_per_device > 0 and rep.peak_memory_bytes > 0


def test_fake_world_refuses_a_real_process_group():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        with pytest.raises(RuntimeError, match="fake world"):
            dryrun.fake_world(4)
    finally:
        mesh_mod.destroy_world()


def test_unported_flag_raises_naming_why():
    dryrun.fake_world(4)
    try:
        mesh = mesh_mod.make_mesh((2, 2), ("data", "model"), device="cpu")
        with pytest.raises(ValueError, match="no pjit-only MoE dispatch"):
            dryrun.lower_combo("llama4-scout-17b-a16e-reduced", "train_4k",
                               mesh, "test", FedConfig(),
                               opts={"moe_shardmap": False})
    finally:
        mesh_mod.destroy_world()


def test_cli_counts_one_combo_on_the_pod(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "mamba2-130m-reduced", "--shape", "decode_32k", "--mesh", "pod",
         "--out", str(tmp_path)], capture_output=True, text=True, env=env,
        timeout=300, cwd=ROOT)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "1 OK, 0 skipped, 0 failed" in res.stdout
    row = json.loads((tmp_path / "baseline_mamba2-130m-reduced_decode_32k_"
                                  "pod.json").read_text())
    assert row["status"] == "OK" and row["chips"] == 256
    for key in ("flops_per_device", "bytes_per_device", "collectives",
                "peak_memory_bytes", "mfu", "dominant"):
        assert key in row
    listed = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--list"],
        capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert listed.returncode == 0
    assert len(listed.stdout.splitlines()) == len(ASSIGNED_ARCHS) * len(
        SHAPES)

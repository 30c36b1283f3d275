"""The port's trainer and checkpoints against the reference.

``repro_torch.launch.train.main`` in each mode (async, sync, central), on
the reduced ResNet3D-18 and on the reduced Mamba2-130M (the LM data path:
the Markov token stream, no client shards), vs
``repro.launch.train.main(["--engine", "loop", ...])`` on the same init
(JAX-initialised, converted) and the same numpy data: ``final_loss`` rtol
1e-3, ``virtual_wall_s`` exactly, the result line's keys equal. A
checkpoint written by either package is read by the other, bit for bit.
``--engine shard`` gives the scan run's result in a world of one and is
refused in async mode, as the reference's is."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

from repro import checkpoint as jckpt
from repro.configs import get_config as jget
from repro.core import fedasync as jfa
from repro.launch import train as jtrain
from repro.models import registry as jreg
from repro_torch import checkpoint as tckpt
from repro_torch.checkpoint.convert import load_jax_checkpoint, params_from_jax
from repro_torch.configs import get_config as tget
from repro_torch.core import fedasync as tfa
from repro_torch.launch import train as ttrain
from repro_torch.models import registry as treg
from repro_torch.types import FedConfig as TFed

from torch_parity import jax_params_both

ARGS = ["--arch", "resnet3d-18", "--reduced", "--clients", "2", "--batch",
        "2", "--epochs", "4", "--steps", "4", "--seed", "0"]


_INITS: dict = {}


def _init(arch: str):
    """One reference init of ``arch`` (reduced) for both trainers."""
    if arch not in _INITS:
        jc, tc = jget(arch).reduced(), tget(arch).reduced()
        jp, flat = jax_params_both(jc, jax.random.PRNGKey(0))
        _INITS[arch] = (jc, tc, jp, flat)
    return _INITS[arch]


@pytest.fixture(scope="module")
def init():
    return _init("resnet3d-18")


def _result(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


# the LM config runs the Markov token stream (no client shards); the
# reference's own second usage line
@pytest.mark.parametrize("arch", ["resnet3d-18", "mamba2-130m"])
@pytest.mark.parametrize("mode", ["async", "sync", "central"])
def test_train_main_matches_reference(mode, arch, monkeypatch, capsys):
    jc, tc, jp, flat = _init(arch)
    args = ARGS[:1] + [arch] + ARGS[2:]
    # both trainers draw their init from the seed: hand each the same
    # JAX-initialised params (the reference's own, jitted)
    monkeypatch.setattr(jreg, "init_params", lambda key, cfg: jp)
    assert jtrain.main(["--engine", "loop", "--mode", mode] + args) == 0
    want = _result(capsys)
    monkeypatch.setattr(
        treg, "init_params", lambda gen, cfg, device, dtype=None:
        params_from_jax(flat, cfg, device=device))
    assert ttrain.main(["--mode", mode, "--device", "cpu"] + args) == 0
    got = _result(capsys)
    assert set(got) == set(want)
    assert got["mode"] == mode
    np.testing.assert_allclose(got["final_loss"], want["final_loss"],
                               rtol=1e-3)
    if mode != "central":
        assert got["virtual_wall_s"] == want["virtual_wall_s"]


# --algorithm, refused before the algorithm layer was ported, now runs
# on both modes and engines, against the reference's trainer on its loop
@pytest.mark.parametrize("mode,algorithm,engine", [
    ("async", "scaffold", "scan"), ("sync", "lowrank", "scan"),
    ("sync", "scaffold", "loop")])
def test_algorithm_flag_matches_reference(mode, algorithm, engine, init,
                                          monkeypatch, capsys):
    jc, tc, jp, flat = init
    argv = ["--mode", mode, "--algorithm", algorithm] + ARGS
    monkeypatch.setattr(jreg, "init_params", lambda key, cfg: jp)
    assert jtrain.main(["--engine", "loop"] + argv) == 0
    want = _result(capsys)
    monkeypatch.setattr(
        treg, "init_params", lambda gen, cfg, device, dtype=None:
        params_from_jax(flat, cfg, device=device))
    assert ttrain.main(["--engine", engine, "--device", "cpu"] + argv) == 0
    got = _result(capsys)
    assert set(got) == set(want)
    assert got["algorithm"] == algorithm
    assert got["virtual_wall_s"] == want["virtual_wall_s"]
    np.testing.assert_allclose(got["final_loss"], want["final_loss"],
                               rtol=1e-3)


# --engine shard, refused before the sharded round was ported: in sync
# mode (a world of one) the scan run's result line; in async mode the
# reference's trainer prints that the engine is sync-only and runs on
# scan, and so does the port's
@pytest.mark.parametrize("flag,item", [(["--engine", "shard"],
                                        "engine=shard is sync-only; async "
                                        "uses engine=scan")])
def test_unported_flags_raise(flag, item, capsys):
    for mode in ("async", "sync"):
        assert ttrain.main(["--mode", mode, "--engine", "scan", "--device",
                            "cpu"] + ARGS) == 0
        want = _result(capsys)
        assert ttrain.main(["--mode", mode, "--device", "cpu"] + ARGS
                           + flag) == 0
        out = capsys.readouterr().out
        assert (f"  {item}\n" in out) == (mode == "async")
        got = json.loads(out.strip().splitlines()[-1])
        assert got["final_loss"] == want["final_loss"]
        assert got["virtual_wall_s"] == want["virtual_wall_s"]


# --population, refused before streaming fleets were ported: a streamed
# fleet of 64 clients, 4 a round (sync) or in flight (async)
@pytest.mark.parametrize("mode", ["sync", "async"])
def test_population_flag_runs(mode, capsys):
    assert ttrain.main(["--mode", mode, "--population", "64",
                        "--clients-per-round", "4", "--device", "cpu"]
                       + ARGS) == 0
    res = _result(capsys)
    assert res["mode"] == mode
    assert np.isfinite(res["final_loss"]) and res["virtual_wall_s"] > 0


def test_sync_after_distill_first_on_the_port(tmp_path, capsys):
    """``--distill-first`` runs the KD chain through the kernel's wrapper
    (its plain version on the CPU), then sync FedAvg from the student, and
    ``--ckpt`` saves the result in the reference's format."""
    ck = str(tmp_path / "student")
    assert ttrain.main(["--mode", "sync", "--distill-first", "--device",
                        "cpu", "--ckpt", ck] + ARGS) == 0
    out = capsys.readouterr().out
    assert "KD resnet3d-34-reduced -> resnet3d-18-reduced" in out
    res = json.loads(out.strip().splitlines()[-1])
    assert np.isfinite(res["final_loss"]) and res["virtual_wall_s"] > 0
    with open(ck + ".json") as f:
        assert json.load(f)["extra"] == res
    jc = jget("resnet3d-18").reduced()
    template = jax.eval_shape(lambda k: jreg.init_params(k, jc),
                              jax.random.PRNGKey(0))
    back = jckpt.load_params(template, ck)
    assert all(np.isfinite(np.asarray(v)).all()
               for v in jax.tree_util.tree_leaves(back))


def test_checkpoints_cross_read(init, tmp_path):
    jc, tc, jp, flat = init
    tp = params_from_jax(flat, tc)
    # the port writes, the reference reads
    tckpt.save_params(tp, str(tmp_path / "port"), extra={"round": 3})
    back = jckpt.load_params(jp, str(tmp_path / "port"))
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(jp)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # the reference writes, the port reads (both of its readers)
    jckpt.save_params(jp, str(tmp_path / "ref"), extra={"round": 3})
    for got in (tckpt.load_params(tp, str(tmp_path / "ref.npz")),
                load_jax_checkpoint(str(tmp_path / "ref"), tc)):
        assert set(got) == set(tp)
        for k in tp:
            assert got[k].dtype == tp[k].dtype
            assert torch.equal(got[k], tp[k]), k
    with open(tmp_path / "port.json") as f:
        mine = json.load(f)
    with open(tmp_path / "ref.json") as f:
        theirs = json.load(f)
    assert mine["keys"] == theirs["keys"] == mine["treedef"]
    assert mine["extra"] == theirs["extra"]


def test_server_state_cross_read(init, tmp_path):
    jc, tc, jp, flat = init
    tp = params_from_jax(flat, tc)
    tckpt.save_server_state(tfa.ServerState(params=tp, t=5, total_updates=7),
                            str(tmp_path / "port"), fed=TFed(seed=3))
    js = jckpt.load_server_state(jp, str(tmp_path / "port"))
    assert (js.t, js.total_updates) == (5, 7)
    with open(tmp_path / "port.json") as f:
        assert json.load(f)["extra"]["fed"]["seed"] == 3
    jckpt.save_server_state(jfa.ServerState(params=jp, t=2, total_updates=9),
                            str(tmp_path / "ref"))
    ts = tckpt.load_server_state(tp, str(tmp_path / "ref"))
    assert (ts.t, ts.total_updates) == (2, 9)
    assert all(torch.equal(ts.params[k], tp[k]) for k in tp)
    with pytest.raises(ValueError, match="checkpoint"):
        tckpt.load_params({"fc/b": torch.zeros(3)}, str(tmp_path / "ref"))

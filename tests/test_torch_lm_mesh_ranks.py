"""The LM's mesh steps split for real, over gloo ranks on the CPU, against
the reference's sharded steps on a CPU mesh of the same shape.

The reference runs once, in a process of its own with four host devices
(``tests/lm_mesh_oracle.py``: ``jit_train_step`` one step at f32
compute, ``jit_serve_step`` four greedy tokens after a prefill, the MoE
layer's distributed dispatch), and writes its inputs and outputs as npz
files. Then 4 ranks run the (2, 2) ``("data", "model")`` cases and 2
ranks the (2, 1) and (1, 2) ones, each spawn bounded by its own time
limit, on the same inputs converted (``params_from_jax``): the port's
``jit_train_step`` / ``jit_serve_step`` with reduced Hymba, Mamba2,
llama4-scout (the MoE dispatch over the data axes, and with
``moe_fullgrid``: an all-to-all over ``"model"`` to the rank's experts,
and a batch of 3 the data axes do not divide),
seamless (the encoder-decoder; also with 15 target tokens beside 16
source frames, and on (1, 4)), paligemma (its patch prefix and one kv
head), gemma3 (windowed and global layers) and grok-1 with 3 experts
(each expert's ``d_ff`` split), and Mamba2 on (1, 4); every family
computes on each rank's heads, SSD heads, ``d_ff`` columns, experts and
vocabulary rows (``sharding.compute_layout``); grok-1's 3 experts also
under ``moe_fullgrid``, the buffers gathered along the capacity to meet
each expert's ``d_ff`` columns. Train: loss
within 1e-5 relative, params within
1e-5 (1 + |ref|). Serve: tokens equal, cache within 1e-5 (1 + |ref|).
The capacity case shows the port follows the reference's distributed
dispatch, whose per-shard capacity drops a pick that the local path
keeps."""
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

sys.path.insert(0, str(Path(__file__).resolve().parent))
from lm_mesh_oracle import (ANCHOR_SCALE, BATCH, CASES, FED,  # noqa: E402
                            SEQ, SERVE_STEPS, _serve_shapes, case_config)

ROOT = Path(__file__).resolve().parents[1]
ORACLE_LIMIT_S = 300
SPAWN_LIMIT_S = 240
TOL = 1e-5
# the reduced Hymba's and Mamba2's SSM mixer (d_inner 256, 8 SSD heads,
# B and C 2 x 16) on the rank's block of heads, as the cases record it
SSM_SPLIT = {
    "layers/ssm/in_proj": [-1, [[256, True], [256, True], [32, False],
                                [8, True]]],
    "layers/ssm/conv_w": [-1, [[256, True], [32, False]]],
    "layers/ssm/conv_b": [-1, [[256, True], [32, False]]],
    "layers/ssm/A_log": [-1, [[8, True]]], "layers/ssm/D": [-1, [[8, True]]],
    "layers/ssm/dt_bias": [-1, [[8, True]]],
    "layers/ssm/norm": [-1, [[256, True]]],
    "layers/ssm/out_proj": [-2, 1]}
# the reduced seamless (4 / 4 heads, d_ff 256, V 256) on "model" 2 or 4:
# both stacks' attention, the decoder's cross-attention and both MLPs on
# the rank's heads and d_ff columns, the embedding and the head by
# vocabulary rows
SEAMLESS_SPLIT = {
    **{f"{st}/{blk}/{k}": [-2 if k == "wo" else -1, 1]
       for st, blocks in (("enc_layers", ("attn",)),
                          ("dec_layers", ("attn", "xattn")))
       for blk in blocks for k in ("wq", "wk", "wv", "wo")},
    **{f"{st}/mlp/{k}": [-2 if k == "wo" else -1, 1]
       for st in ("enc_layers", "dec_layers") for k in ("wg", "wi", "wo")},
    "embed": [-2, 1], "lm_head": [-1, 1]}


def _names(kind=None, world=None):
    return [n for n, (shape, _, k, _) in CASES.items()
            if (kind is None or k == kind)
            and (world is None or shape[0] * shape[1] == world)]


def _err(got: torch.Tensor, want: np.ndarray) -> float:
    """max |got - want| / (1 + |want|)."""
    got = got.detach().float().numpy()
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want) / (1 + np.abs(want)))) \
        if got.size else 0.0


def _check(name: str, ref: Path) -> dict:
    """One case on this rank: the port's step on the reference's inputs,
    its errors against the reference's outputs."""
    from repro_torch.checkpoint.convert import _shapes, params_from_jax
    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe as tmoe
    from repro_torch.models import registry
    from repro_torch.types import FedConfig, MoEConfig, ShapeConfig
    shape, arch, kind, opts = CASES[name]
    mesh = make_mesh(shape, ("data", "model"), device="cpu")
    z = np.load(ref / f"{name}.npz")
    part = lambda pre: {k[len(pre):]: z[k] for k in z.files  # noqa: E731
                        if k.startswith(pre)}
    if kind == "capacity":
        p = {k: torch.tensor(v) for k, v in part("p/").items()}
        row = mesh.get_coordinate()[0]
        moe = MoEConfig(num_experts=4, top_k=1, capacity_factor=1.0)
        out, aux = tmoe.moe_forward(
            p, torch.tensor(z["x"][row:row + 1]), moe, "silu",
            moe_ctx={"mesh": mesh, "dp": "data"})
        return {"out": _err(out, z["dist_out"][row:row + 1]),
                "aux": abs(float(aux) - float(z["dist_aux"])),
                "local_vs_dist": float(np.max(np.abs(
                    z["local_out"][row] - z["dist_out"][row])))}
    cfg = case_config(get_config, arch, opts)
    params = params_from_jax(part("p/"), cfg)
    if kind == "train":
        anchor = params_from_jax(
            {k: v * np.float32(ANCHOR_SCALE) for k, v in part("p/").items()},
            cfg)
        batch = {k: torch.tensor(v) for k, v in part("b/").items()}
        sc = ShapeConfig("t", seq_len=SEQ,
                         global_batch=opts.get("batch", BATCH), kind="train")
        fn, _ = steps.jit_train_step(
            cfg, FedConfig(**FED), mesh, sc, _shapes(cfg),
            registry.batch_spec(cfg, sc), donate=False,
            moe_fullgrid=opts.get("moe_fullgrid", False),
            constrain_acts=opts.get("constrain_acts", True),
            train_kwargs={"dtype": torch.float32})
        new, state, loss = fn(params, fn.opt.init(params), anchor, batch)
        want = part("out/")
        return {"loss": abs(float(loss.to_local()) - float(z["loss"]))
                / abs(float(z["loss"])),
                "params": max(_err(new[k].full_tensor(), want[k])
                              for k in want),
                "step": state["step"],
                "split": _layout(fn.split) if fn.split else {},
                "seq_split": bool(fn.split and fn.split.seq)}
    B, _, S = _serve_shapes(cfg, opts)
    sc = ShapeConfig("s", seq_len=S, global_batch=B, kind="decode")
    cache = {k: torch.tensor(v) for k, v in part("c/").items()}
    fn, _ = steps.jit_serve_step(cfg, mesh, sc, _shapes(cfg), cache,
                                 ring=opts.get("ring", False))
    tok, pos, picked = torch.tensor(z["token"]), int(z["pos"]), []
    for t in range(SERVE_STEPS):
        tok, cache = fn(params, tok, cache, pos + t)
        picked.append(tok.full_tensor().numpy())
    want = part("out/")
    return {"tokens_equal": bool(np.array_equal(np.stack(picked),
                                                z["tokens"])),
            "cache": max(_err(cache[k].full_tensor(), want[k])
                         for k in want),
            "split": _layout(fn.split)}


def _layout(split) -> dict:
    """The leaves a step computes on the rank's block of, as lists."""
    return {k: list(v) for k, v in split.layout.items() if v is not None}


def _rank(rank: int, world: int, store: str, ref: str, names: list,
          out: str):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    got = {name: _check(name, Path(ref)) for name in names}
    Path(out, f"rank{rank}.json").write_text(json.dumps(got))
    dist.destroy_process_group()


def _spawn(world: int, names: list, ref: Path, out: Path) -> dict:
    """``world`` ranks of ``_rank``; fails, never hangs, past
    ``SPAWN_LIMIT_S``. Each case's errors, the worst over the ranks."""
    ctx = mp.spawn(_rank, args=(world, str(out / "store"), str(ref), names,
                                str(out)),
                   nprocs=world, join=False)
    deadline = time.monotonic() + SPAWN_LIMIT_S
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"{world} ranks did not finish in {SPAWN_LIMIT_S} s")
    ranks = [json.loads((out / f"rank{r}.json").read_text())
             for r in range(world)]
    worst = {}
    for name in names:
        worst[name] = {k: (all(r[name][k] for r in ranks)
                           if isinstance(ranks[0][name][k], bool)
                           else ranks[0][name][k]
                           if isinstance(ranks[0][name][k], dict)
                           else max(r[name][k] for r in ranks))
                       for k in ranks[0][name]}
    return worst


def _oracle(out: Path) -> Path:
    """The reference's outputs of every case, written under ``out``."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    names = list(CASES)
    # two processes, half the cases each: the reference compiles every
    # case's step, which is most of its time
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "lm_mesh_oracle.py"), str(out)]
        + names[i::2], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for i in range(2)]
    deadline = time.monotonic() + ORACLE_LIMIT_S
    for proc in procs:
        try:
            _, err = proc.communicate(
                timeout=max(deadline - time.monotonic(), 1))
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            pytest.fail(f"the reference's oracle took over "
                        f"{ORACLE_LIMIT_S} s")
        assert proc.returncode == 0, err[-4000:]
    return out


def _results(tmp_path_factory) -> dict:
    """Every case's errors: the oracle, then the ranks against it."""
    oracle = _oracle(tmp_path_factory.mktemp("lm_mesh_oracle"))
    got = {}
    for world in (4, 2):
        out = tmp_path_factory.mktemp(f"ranks{world}")
        got.update(_spawn(world, _names(world=world), oracle, out))
    return got


@pytest.fixture(scope="module")
def results(tmp_path_factory) -> dict:
    """``_results``, computed once a session: under pytest-xdist the
    first worker to need them computes them while holding a lock in the
    workers' shared temporary directory, and the others read its file."""
    import fcntl
    if not os.environ.get("PYTEST_XDIST_WORKER"):
        return _results(tmp_path_factory)
    shared = tmp_path_factory.getbasetemp().parent
    path = shared / "lm_mesh_ranks_results.json"
    with open(shared / "lm_mesh_ranks_results.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not path.is_file():
            path.write_text(json.dumps(_results(tmp_path_factory)))
        return json.loads(path.read_text())


@pytest.mark.parametrize("name", _names("train"))
def test_train_step_matches_the_reference(results, name):
    got = results[name]
    assert got["loss"] <= TOL and got["params"] <= TOL, got
    assert got["step"] == 1


def test_new_cases_compute_on_the_rank_s_blocks(results):
    """The dense and the 3-expert MoE cases run the split path: heads,
    d_ff columns and vocabulary rows on the rank's block, the 3 experts
    split by their d_ff columns (2 does not divide 3), and llama4's 4
    experts expert-parallel, under ``moe_fullgrid`` too; Hymba's and Mamba2's SSM mixers on the
    rank's SSD heads, 4 of 8 on (2, 2) and (1, 2), 2 on (1, 4); the
    encoder-decoder's two stacks and cross-attention on the rank's
    heads and d_ff columns, its vocabulary rows split."""
    gemma = results["2x2-gemma3"]["split"]
    assert gemma == {"layers/attn/wq": [-1, 1], "layers/attn/wk": [-1, 1],
                     "layers/attn/wv": [-1, 1], "layers/attn/wo": [-2, 1],
                     "layers/mlp/wg": [-1, 1], "layers/mlp/wi": [-1, 1],
                     "layers/mlp/wo": [-2, 1], "embed": [-2, 1]}, gemma
    grok = results["2x2-grok1-e3"]["split"]
    assert grok["layers/moe/wi"] == [-1, 1] and \
        grok["layers/moe/wo"] == [-2, 1], grok
    for name in ("2x2-llama4", "2x2-llama4-b3", "2x2-llama4-fullgrid",
                 "1x2-llama4-fullgrid"):
        for k in ("wg", "wi", "wo"):
            assert results[name]["split"][f"layers/moe/{k}"] == [-3, 1], \
                name
    # under moe_fullgrid the 3 experts' d_ff columns meet the buffers
    # gathered along C; the rest of the layout is the default's
    assert results["2x2-grok1-e3-fullgrid"]["split"] == grok
    assert results["2x2-llama4-fullgrid"]["split"] == \
        results["2x2-llama4"]["split"]
    # paligemma's one kv head: both ranks read it, gathered and sliced
    assert results["2x2-paligemma"]["split"]["layers/attn/wk"] == [-1, 2]
    for name in ("2x2-hymba", "1x2-hymba", "2x2-mamba2", "1x4-mamba2"):
        got = results[name]["split"]
        assert {k: v for k, v in got.items() if "/ssm/" in k} == \
            SSM_SPLIT, (name, got)
    assert results["2x1-hymba"]["split"] == {}
    # the encoder-decoder: 2 of 4 heads a rank on (2, 2), 1 on (1, 4);
    # with 15 target tokens beside 16 source frames only the encoder's
    # residual splits its sequence
    for name in ("2x2-seamless", "2x2-seamless-odd-tgt", "1x4-seamless"):
        assert results[name]["split"] == SEAMLESS_SPLIT, \
            (name, results[name]["split"])
        assert results[name]["seq_split"], name
    # between layers the residual is split over "model" on its sequence,
    # but for the case without act_pspec, whose partial sums all-reduce
    assert results["2x2-gemma3"]["seq_split"]
    assert not results["2x2-gemma3-noseq"]["seq_split"]
    assert results["2x2-gemma3-noseq"]["split"] == gemma


@pytest.mark.parametrize("name", _names("serve"))
def test_serve_step_matches_the_reference(results, name):
    got = results[name]
    assert got["tokens_equal"] and got["cache"] <= TOL, got


def test_serve_cases_decode_on_the_rank_s_blocks(results):
    """The serve step splits the leaves the train step splits: gemma3's
    heads, d_ff columns and vocabulary rows (uniform, and at batch 1 with
    the cache over ("data", "model")), grok-1's 3 experts by their d_ff
    columns, llama4's experts expert-parallel, paligemma's one kv head
    read by both ranks; Hymba's reduced 4 heads and 8 SSD heads split;
    Mamba2's SSM mixers on the rank's SSD heads beside its vocabulary
    rows, on (2, 2) and (1, 4); the encoder-decoder's decoder on the
    rank's heads (self- and cross-attention against caches split on
    their sequence), d_ff columns and vocabulary rows."""
    gemma = results["2x2-gemma3"]["split"]
    assert results["2x2-gemma3-serve"]["split"] == gemma
    assert results["2x2-gemma3-serve-b1"]["split"] == gemma
    assert results["2x2-grok1-e3-serve"]["split"] == \
        results["2x2-grok1-e3"]["split"]
    assert results["2x2-llama4-serve"]["split"]["layers/moe/wg"] == [-3, 1]
    assert results["2x2-paligemma-serve"]["split"]["layers/attn/wk"] == \
        [-1, 2]
    for name in ("2x2-hymba-serve", "2x2-hymba-serve-ring",
                 "2x2-hymba-serve-b1"):
        assert results[name]["split"] == results["2x2-hymba"]["split"]
        assert results[name]["split"]["layers/attn/wq"] == [-1, 1]
    assert results["2x2-mamba2-serve"]["split"] == \
        results["2x2-mamba2"]["split"] == {"embed": [-2, 1], **SSM_SPLIT}
    assert results["1x4-mamba2-serve"]["split"] == \
        results["1x4-mamba2"]["split"] == results["2x2-mamba2"]["split"]
    assert results["1x2-hymba-serve"]["split"] == \
        results["1x2-hymba"]["split"]
    assert results["2x2-seamless-serve"]["split"] == SEAMLESS_SPLIT


def test_moe_follows_the_distributed_capacity(results):
    got = results["2x1-capacity"]
    assert got["out"] <= TOL and got["aux"] <= TOL, got
    # the reference's two paths differ on this input by far more
    assert got["local_vs_dist"] > 100 * TOL, got

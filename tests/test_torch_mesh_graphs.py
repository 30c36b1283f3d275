"""The LM mesh steps through their ``GraphCache`` (``fn.graphs``), on gloo
ranks: a world of one on the (1, 1) mesh and 4 ranks on (2, 2), each
spawn bounded by its own time limit.

On the CPU the cache runs each call eagerly, but it keys each call as it
would on the card: the shapes of the copied-in leaves, the addresses of
the in-place ones and every other value. So one signature a shape here
is one CUDA graph a shape there. For the reduced Hymba, h2o-danube,
llama4-scout (its MoE dispatch, and under ``moe_fullgrid``) and
seamless:

- ``jit_train_step``, 3 steps a run at a constant rate with the params
  donated and copied, and at a scheduled rate (its step tensor an input
  and an output): one ``"mesh_train"`` signature a run, the donated
  params and momentum coming back as the DTensors passed in, a constant
  rate's step a host int counted by the wrapper;
- ``jit_serve_step``, 16 greedy tokens a run, uniform and (Hymba, h2o)
  ring, ``pos`` an int, a (B,) tensor and a 0-d tensor in turn, the
  first 8 tokens without logits and the last 8 with them: two
  ``"mesh_serve"`` signatures a run, the donated cache coming back as
  the DTensors passed in;
- every call equal, bit for bit, to ``fn.eager`` (the same body run
  without the cache) on copies of the same inputs.
"""
import dataclasses
import datetime
import json
import os
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

SPAWN_LIMIT_S = 240
MESHES = {"1x1": (1, 1), "2x2": (2, 2)}
# case -> (arch, moe_fullgrid)
TRAIN_CASES = {"hymba": ("hymba-1.5b", False),
               "h2o": ("h2o-danube-3-4b", False),
               "llama4": ("llama4-scout-17b-a16e", False),
               "llama4-fullgrid": ("llama4-scout-17b-a16e", True),
               "seamless": ("seamless-m4t-large-v2", False)}
SERVE_CASES = {"hymba": "hymba-1.5b", "h2o": "h2o-danube-3-4b",
               "llama4": "llama4-scout-17b-a16e",
               "seamless": "seamless-m4t-large-v2"}
TRAIN = (4, 32, 3)              # B, S, steps
SERVE = (4, 24, 8, 16)          # B, cache positions, prompt, tokens
LR = 0.05


def _config(arch):
    from repro_torch.configs import get_config
    cfg = get_config(arch).reduced(d_model=128, vocab=256)
    # a window shorter than the train sequence and the cache
    return dataclasses.replace(cfg, sliding_window=8) \
        if cfg.sliding_window else cfg


def _copy(tree):
    """A copy of a tree of DTensors (their blocks cloned), tensors and
    other values."""
    from torch.distributed.tensor import DTensor
    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_copy(v) for v in tree)
    if isinstance(tree, DTensor):
        return DTensor.from_local(tree.to_local().clone(), tree.device_mesh,
                                  tree.placements, run_check=False,
                                  shape=tree.shape, stride=tree.stride())
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    return tree


def _equal(a, b) -> bool:
    """Trees equal bit for bit, a DTensor by its block."""
    from torch.distributed.tensor import DTensor
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(map(_equal, a, b))
    if isinstance(a, DTensor):
        return isinstance(b, DTensor) and _equal(a.to_local(), b.to_local())
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return a == b


def _train(mesh, arch: str, fullgrid: bool) -> dict:
    """Each variant's 3 steps through ``fn`` and ``fn.eager``."""
    from repro_torch.checkpoint.convert import _shapes
    from repro_torch.launch import steps
    from repro_torch.models import registry
    from repro_torch.optim import schedules
    from repro_torch.sharding import specs as shspecs
    from repro_torch.types import FedConfig, ShapeConfig
    cfg = _config(arch)
    B, S, n = TRAIN
    sc = ShapeConfig("t", seq_len=S, global_batch=B, kind="train")
    rng = np.random.default_rng(0)
    batches = [registry.synth_batch(rng, cfg, sc, device="cpu")
               for _ in range(n)]
    init = registry.init_params(torch.Generator().manual_seed(0), cfg,
                                "cpu")
    out = {}
    for variant, lr, donate in (
            ("constant", LR, True), ("constant_copied", LR, False),
            ("scheduled", schedules.inverse_sqrt(LR, 1), True)):
        fn, (in_sh, _) = steps.jit_train_step(
            cfg, FedConfig(lr=lr), mesh, sc, _shapes(cfg),
            registry.batch_spec(cfg, sc), donate=donate,
            moe_fullgrid=fullgrid, train_kwargs={"dtype": torch.float32})
        params = shspecs.place(mesh, {k: v.clone() for k, v in init.items()},
                               in_sh[0])
        anchor = shspecs.place(mesh, {k: 0.9 * v for k, v in init.items()},
                               in_sh[2])
        state = fn.opt.init(params)
        equal, kept, losses = True, True, []
        for b in batches:
            before = _copy((params, state))
            new, nstate, loss = fn(params, state, anchor, b)
            want = fn.eager(*before, anchor, b)
            equal = equal and _equal((new, nstate, loss), want)
            kept = kept and (not donate or (
                all(new[k] is params[k] for k in params) and all(
                    nstate["mom"][k] is state["mom"][k]
                    for k in state["mom"])))
            params, state = new, nstate
            losses.append(float(loss.to_local()))
        step = state["step"]
        out[variant] = {
            "signatures": fn.graphs.num_compiled,
            "mesh_train": fn.graphs.count("mesh_train"),
            "equal_to_eager": equal, "donated_kept": kept,
            "losses_finite": all(np.isfinite(losses)),
            "step": int(step), "step_is_tensor":
                isinstance(step, torch.Tensor)}
    return out


def _serve(mesh, arch: str) -> dict:
    """Each layout's 16 tokens through ``fn`` and ``fn.eager``."""
    from repro_torch.checkpoint.convert import _shapes
    from repro_torch.launch import steps
    from repro_torch.models import lm, registry
    from repro_torch.sharding import specs as shspecs
    from repro_torch.types import ShapeConfig
    cfg = _config(arch)
    B, L, P, T = SERVE
    params = registry.init_params(torch.Generator().manual_seed(1), cfg,
                                  "cpu")
    rng = np.random.default_rng(1)
    with torch.no_grad():
        if cfg.is_encdec:
            src = torch.from_numpy(rng.standard_normal(
                (B, P, cfg.d_model)).astype(np.float32))
            filled = registry.prefill(
                params, cfg, {"src_embeds": src},
                registry.init_cache(cfg, B, L, torch.float32, "cpu"))
            first, P = torch.zeros(B, dtype=torch.int32), 0     # BOS
        else:
            prompt = torch.from_numpy(rng.integers(
                0, cfg.vocab_size, (B, P)).astype(np.int32))
            logits, filled = registry.prefill(
                params, cfg, {"tokens": prompt},
                registry.init_cache(cfg, B, L, torch.float32, "cpu"))
            first = torch.argmax(logits, dim=-1).to(torch.int32)
    sc = ShapeConfig("s", seq_len=L, global_batch=B, kind="decode")
    out = {}
    for ring in (False, True) if cfg.sliding_window else (False,):
        base = lm.to_ring_cache(cfg, filled, P) if ring else filled
        fn, (in_sh, _) = steps.jit_serve_step(cfg, mesh, sc, _shapes(cfg),
                                              base, ring=ring)
        placed = shspecs.place(mesh, params, in_sh[0])
        cache = shspecs.place(mesh, {k: v.clone() for k, v in base.items()},
                              in_sh[2])
        tok, equal, kept, picks = first, True, True, []
        for t in range(T):
            pos = (P + t, torch.full((B,), P + t, dtype=torch.int32),
                   torch.tensor(P + t))[t % 3]
            before = _copy(cache)
            got = fn(placed, tok, cache, pos, with_logits=t >= T // 2)
            want = fn.eager(placed, tok, before, pos,
                            with_logits=t >= T // 2)
            equal = equal and _equal(got[0], want[0]) and \
                _equal(got[1], want[1]) and (len(got) == 2 or torch.equal(
                    got[2], want[2]))
            kept = kept and all(got[1][k] is cache[k] for k in cache)
            tok, cache = got[0], got[1]
            picks.append(tok.full_tensor().tolist())
        out["ring" if ring else "uniform"] = {
            "signatures": fn.graphs.num_compiled,
            "mesh_serve": fn.graphs.count("mesh_serve"),
            "equal_to_eager": equal, "donated_kept": kept,
            "picks_in_vocab": all(0 <= p < cfg.vocab_size
                                  for row in picks for p in row)}
    return out


def _rank(rank: int, world: int, store: str, out: str):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    from repro_torch.launch.mesh import make_mesh
    shape = (2, 2) if world == 4 else (1, 1)
    mesh = make_mesh(shape, ("data", "model"), device="cpu")
    got = {"train": {c: _train(mesh, *a) for c, a in TRAIN_CASES.items()},
           "serve": {c: _serve(mesh, a) for c, a in SERVE_CASES.items()}}
    Path(out, f"rank{rank}.json").write_text(json.dumps(got))
    dist.destroy_process_group()


def _spawn(world: int, out: Path) -> list:
    """``world`` ranks of ``_rank``; fails, never hangs, past
    ``SPAWN_LIMIT_S``. Each rank's results."""
    ctx = mp.spawn(_rank, args=(world, str(out / "store"), str(out)),
                   nprocs=world, join=False)
    deadline = time.monotonic() + SPAWN_LIMIT_S
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"{world} ranks did not finish in {SPAWN_LIMIT_S} s")
    return [json.loads((out / f"rank{r}.json").read_text())
            for r in range(world)]


def _results(tmp_path_factory) -> dict:
    return {name: _spawn(shape[0] * shape[1],
                         tmp_path_factory.mktemp(f"mesh_graphs_{name}"))
            for name, shape in MESHES.items()}


@pytest.fixture(scope="module")
def results(tmp_path_factory) -> dict:
    """``_results``, computed once a session: under pytest-xdist the
    first worker to need them computes them while holding a lock in the
    workers' shared temporary directory, and the others read its file."""
    import fcntl
    if not os.environ.get("PYTEST_XDIST_WORKER"):
        return _results(tmp_path_factory)
    shared = tmp_path_factory.getbasetemp().parent
    path = shared / "mesh_graphs_results.json"
    with open(shared / "mesh_graphs_results.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not path.is_file():
            path.write_text(json.dumps(_results(tmp_path_factory)))
        return json.loads(path.read_text())


@pytest.mark.parametrize("case", TRAIN_CASES)
@pytest.mark.parametrize("mesh", MESHES)
def test_train_step_is_one_signature_a_shape(results, mesh, case):
    """3 steps a run, each on every rank: one signature, the wrapper
    equal to the eager body; the donated DTensors kept; a constant
    rate's step a host int, a schedule's a tensor, both at 3."""
    for rank in results[mesh]:
        got = rank["train"][case]
        for variant, g in got.items():
            assert g["signatures"] == g["mesh_train"] == 1, (variant, g)
            assert g["equal_to_eager"] and g["donated_kept"] and \
                g["losses_finite"], (variant, g)
            assert g["step"] == TRAIN[2], (variant, g)
            assert g["step_is_tensor"] == (variant == "scheduled"), \
                (variant, g)


@pytest.mark.parametrize("case", SERVE_CASES)
@pytest.mark.parametrize("mesh", MESHES)
def test_serve_step_is_one_signature_a_shape(results, mesh, case):
    """16 tokens a run, ``pos`` an int or a tensor: two signatures (with
    and without logits), every token's outputs and cache equal to the
    eager body's, the donated cache kept."""
    for rank in results[mesh]:
        got = rank["serve"][case]
        assert set(got) == ({"uniform", "ring"} if case in ("hymba", "h2o")
                            else {"uniform"}), got
        for layout, g in got.items():
            assert g["signatures"] == g["mesh_serve"] == 2, (layout, g)
            assert g["equal_to_eager"] and g["donated_kept"] and \
                g["picks_in_vocab"], (layout, g)

"""Tensor-parallel compute on the LM mesh's ``"model"`` axis
(``sharding.compute_layout``, ``sharding.MeshSplit``), without the
reference: the reference's own split is held against the port by
``tests/test_torch_lm_mesh_ranks.py``.

- the layout leaf by leaf on the production meshes (``MeshShape``):
  gemma3's heads split, the kv heads read by query group; Hymba's and
  paligemma's attention gathered (25 and 8 heads on 16), Hymba's MLP
  split; llama4's experts expert-parallel; grok-1's experts split by
  ``d_ff``; the SSM mixers, the encoder-decoder and a one-rank
  ``"model"`` gathered;
- the vocabulary-parallel CE over 2 gloo ranks against ``cross_entropy``
  on the whole logits, values and gradients;
- the train step on a fake (2, 2) world: no whole leaf of a split param
  is made, and no DTensor is gathered whole;
- the autograd collectives counted under their classes by
  ``roofline.counter``;
- the serve step on a fake (2, 2) world: no param is gathered whole,
  each layer's leaves are gathered inside its own layer, to the rank's
  blocks; on 4 gloo ranks against a cache "model" does not split
  (uniform, ring, window-sliced) equal to one process's decode;
- the pod dry run of gemma3-12b's widths cut to 2 layers: its
  ``useful_flop_ratio`` at least 8x that of the same step with every leaf
  gathered over ``"model"``; its decode's flops a device at most a
  quarter of the same decode's with every leaf gathered, its peak
  smaller.
"""
import dataclasses
import datetime
import json
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

from repro_torch.checkpoint.convert import _shapes  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.sharding import specs as shspecs  # noqa: E402
from repro_torch.sharding.specs import MeshShape, Split  # noqa: E402
from repro_torch.types import FedConfig, ShapeConfig  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

POD = MeshShape((16, 16), ("data", "model"))
MULTIPOD = MeshShape((2, 16, 16), ("pod", "data", "model"))
SPAWN_LIMIT_S = 120


def _gathered(mesh, cfg, params, moe_fullgrid=False):
    """``compute_layout`` with every leaf gathered over ``"model"``."""
    return {k: None for k in params}


@pytest.fixture(autouse=True)
def _no_world_before_or_after():
    mesh_mod.destroy_world()
    yield
    mesh_mod.destroy_world()


def _layout(arch, mesh=POD, **kw):
    cfg = get_config(arch)
    return shspecs.compute_layout(mesh, cfg, _shapes(cfg),
                                  **kw)


@pytest.mark.parametrize("mesh", [POD, MULTIPOD])
def test_dense_heads_and_vocabulary_split(mesh):
    lay = _layout("gemma3-12b", mesh)
    # 16 heads, 8 kv heads on 16 ranks: a head each, two ranks a kv head
    assert lay["layers/attn/wq"] == Split(-1)
    assert lay["layers/attn/wo"] == Split(-2)
    assert lay["layers/attn/wk"] == lay["layers/attn/wv"] == Split(-1, 2)
    assert lay["layers/mlp/wi"] == Split(-1) and \
        lay["layers/mlp/wo"] == Split(-2)
    assert lay["embed"] == Split(-2)
    assert lay["layers/ln1"] is None and lay["final_norm"] is None
    lay = _layout("internlm2-20b", mesh)
    assert lay["lm_head"] == Split(-1) and lay["embed"] == Split(-2)


def test_heads_the_axis_does_not_divide_stay_gathered():
    hymba = _layout("hymba-1.5b")
    for k in ("wq", "wk", "wv", "wo"):
        assert hymba[f"layers/attn/{k}"] is None          # 25 / 5 heads
    assert hymba["layers/mlp/wg"] == Split(-1)            # d_ff 5504
    assert all(v is None for k, v in hymba.items() if "/ssm/" in k)
    assert hymba["embed"] is None                          # V 32001
    pali = _layout("paligemma-3b")                         # 8 / 1 heads
    assert pali["layers/attn/wq"] is None and \
        pali["layers/mlp/wi"] == Split(-1)
    assert all(v is None for v in _layout("mamba2-130m").values())
    assert all(v is None for v in _layout("seamless-m4t-large-v2").values())
    one = MeshShape((256, 1), ("data", "model"))
    assert all(v is None for v in _layout("gemma3-12b", one).values())


def test_experts_split_by_the_rule_s_two_branches():
    llama = _layout("llama4-scout-17b-a16e")
    for k in ("wg", "wi", "wo"):                           # E 16 on 16
        assert llama[f"layers/moe/{k}"] == Split(-3)
    assert llama["layers/moe/router"] is None
    assert llama["layers/moe/shared_wi"] == Split(-1)
    assert llama["layers/attn/wq"] is None                 # 40 heads
    grok = _layout("grok-1-314b")                          # E 8 on 16
    assert grok["layers/moe/wg"] == grok["layers/moe/wi"] == Split(-1)
    assert grok["layers/moe/wo"] == Split(-2)
    assert grok["layers/attn/wq"] == Split(-1) and \
        grok["layers/attn/wk"] == Split(-1, 2)
    # moe_fullgrid splits the tokens over "model" instead
    full = _layout("llama4-scout-17b-a16e", moe_fullgrid=True)
    assert full["layers/moe/wg"] is None and \
        full["layers/moe/shared_wi"] == Split(-1)


def _ce_rank(rank: int, store: str, out: str):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, 2),
                            rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=60))
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.common import chunked_lm_nll, cross_entropy
    mesh = make_mesh((1, 2), ("data", "model"), device="cpu")
    V, d = 24, 8
    layout = {"lm_head": Split(-1)}
    split = shspecs.MeshSplit(mesh, {"lm_head": shspecs.P(None, "model")},
                              {"embed": Split(-2), **layout}, seq=False)
    rng = np.random.default_rng(0)
    h = torch.tensor(rng.standard_normal((2, 10, d)), dtype=torch.float32)
    head = torch.tensor(rng.standard_normal((d, V)), dtype=torch.float32)
    labels = torch.tensor(rng.integers(0, V, (2, 10)))
    labels[0, :3] = -100
    h_own = h.clone().requires_grad_()
    blk = head[:, rank * V // 2:(rank + 1) * V // 2].clone().requires_grad_()
    nll, cnt = chunked_lm_nll(h_own, blk, labels, chunk=4, split=split)
    (nll / cnt).backward()
    h_grad = h_own.grad.clone()
    dist.all_reduce(h_grad)                  # the parts of h's gradient
    h_ref = h.clone().requires_grad_()
    head_ref = head.clone().requires_grad_()
    want = cross_entropy(h_ref @ head_ref, labels)
    want.backward()
    got = {"ce_err": abs(float(nll / cnt) - float(want)),
           "h_grad_err": float((h_grad - h_ref.grad).abs().max()),
           "head_grad_err": float((blk.grad - head_ref.grad[
               :, rank * V // 2:(rank + 1) * V // 2]).abs().max()),
           "count": float(cnt)}
    Path(out, f"rank{rank}.json").write_text(json.dumps(got))
    dist.destroy_process_group()


def test_vocabulary_parallel_ce_matches_cross_entropy(tmp_path):
    ctx = mp.spawn(_ce_rank, args=(str(tmp_path / "store"), str(tmp_path)),
                   nprocs=2, join=False)
    deadline = time.monotonic() + SPAWN_LIMIT_S
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"2 ranks did not finish in {SPAWN_LIMIT_S} s")
    for r in range(2):
        got = json.loads((tmp_path / f"rank{r}.json").read_text())
        assert got["count"] == 17.0
        assert got["ce_err"] <= 1e-6 and got["h_grad_err"] <= 1e-6 and \
            got["head_grad_err"] <= 1e-6, got


def _fake_train_step(cfg, world=4, shape=(2, 2), seq=64):
    """``jit_train_step`` of ``cfg`` on a fake world of ``world`` ranks:
    (fn, its placed arguments)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch import steps
    dryrun.fake_world(world)
    mesh = mesh_mod.make_mesh(shape, ("data", "model"), device="cpu")
    sc = ShapeConfig("t", seq_len=seq, global_batch=4, kind="train")
    mode = FakeTensorMode()
    with mode:
        pstruct = dryrun.params_struct(cfg)
        bstruct = registry.batch_spec(cfg, sc)
        fn, (in_sh, _) = steps.jit_train_step(cfg, FedConfig(), mesh, sc,
                                              pstruct, bstruct)
        params = shspecs.place(mesh, pstruct, in_sh[0])
        anchor = shspecs.place(mesh, {k: v.clone() for k, v in
                                      pstruct.items()}, in_sh[0])
        batch = shspecs.place(mesh, dryrun._fake(bstruct), in_sh[3])
        state = fn.opt.init(pstruct)
        state["mom"] = shspecs.place(mesh, state["mom"], in_sh[0])
    return mode, fn, (params, state, anchor, batch), mesh


def test_no_rank_holds_a_whole_split_leaf(monkeypatch):
    """Reduced gemma3 (4 / 4 heads, d_ff 512, V 512) on a fake (2, 2)
    world: every leaf the layout splits is gathered over the data axes
    only, to the rank's (., n / 2) block of the layer's slice, and no
    DTensor is gathered whole or redistributed in the step."""
    from torch.distributed.tensor import DTensor
    cfg = get_config("gemma3-12b").reduced()
    mode, fn, args, mesh = _fake_train_step(cfg)
    seen = {}
    gather = shspecs.MeshSplit.gather

    def record(self, key, x):
        out = gather(self, key, x)
        seen.setdefault(key, set()).add(tuple(out.shape))
        return out

    def refuse(*a, **k):
        raise AssertionError("a DTensor gathered in the split step")
    monkeypatch.setattr(shspecs.MeshSplit, "gather", record)
    monkeypatch.setattr(DTensor, "full_tensor", refuse)
    monkeypatch.setattr(DTensor, "redistribute", refuse)
    with mode:
        fn(*args)
    split = {k for k, v in fn.split.layout.items() if v is not None}
    assert split == {"embed", "layers/attn/wq", "layers/attn/wk",
                     "layers/attn/wv", "layers/attn/wo", "layers/mlp/wg",
                     "layers/mlp/wi", "layers/mlp/wo"}
    shapes = _shapes(cfg)
    for k in split:
        whole = shapes[k][1:] if k.startswith("layers/") else shapes[k]
        dim = fn.split.layout[k].dim
        want = list(whole)
        want[dim] //= 2
        assert seen[k] == {tuple(want)}, (k, seen[k])
    # the gathered leaves come back whole
    assert seen["layers/ln1"] == {shapes["layers/ln1"][1:]}


def test_serve_step_gathers_a_layer_of_the_rank_s_blocks(monkeypatch):
    """Reduced gemma3's serve step (B 4, 64 cache positions) on a fake
    (2, 2) world: no param DTensor is gathered whole or redistributed;
    each ``layers/`` leaf is gathered once a layer, between the previous
    layer's compute and its own, to the rank's (., n / 2) block of the
    layer's slice where the layout splits it; the embedding, the last
    norm and the head are gathered where they are used, ``embed`` to its
    vocabulary block."""
    from torch.distributed.tensor import DTensor
    from repro_torch.launch import steps
    from repro_torch.models import lm
    cfg = get_config("gemma3-12b").reduced()
    dryrun.fake_world(4)
    mesh = mesh_mod.make_mesh((2, 2), ("data", "model"), device="cpu")
    sc = ShapeConfig("s", seq_len=64, global_batch=4, kind="decode")
    mode = FakeTensorMode()
    with mode:
        pstruct = dryrun.params_struct(cfg)
        tok, cspec, pos = registry.decode_spec(cfg, sc, torch.float32)
        fn, (in_sh, _) = steps.jit_serve_step(cfg, mesh, sc, pstruct, cspec)
        params = shspecs.place(mesh, pstruct, in_sh[0])
        args = (params, shspecs.place(mesh, dryrun._fake(tok), in_sh[1]),
                shspecs.place(mesh, dryrun._fake(cspec), in_sh[2]),
                dryrun._fake(pos))
    events, whole = [], []
    gather, layer = shspecs.MeshSplit.gather, lm._split_layer
    full, redist = DTensor.full_tensor, DTensor.redistribute

    def record(self, key, x):
        out = gather(self, key, x)
        events.append((key, tuple(out.shape)))
        return out

    def run_layer(*a, **k):
        events.append(("layer", None))
        return layer(*a, **k)

    def watch(orig):
        def f(self, *a, **k):
            if any(self is v for v in params.values()):
                whole.append(tuple(self.shape))
            return orig(self, *a, **k)
        return f
    monkeypatch.setattr(shspecs.MeshSplit, "gather", record)
    monkeypatch.setattr(lm, "_split_layer", run_layer)
    monkeypatch.setattr(DTensor, "full_tensor", watch(full))
    monkeypatch.setattr(DTensor, "redistribute", watch(redist))
    with mode:
        fn(*args)
    assert whole == [], whole
    split = {k for k, v in fn.split.layout.items() if v is not None}
    assert split == {"embed", "layers/attn/wq", "layers/attn/wk",
                     "layers/attn/wv", "layers/attn/wo", "layers/mlp/wg",
                     "layers/mlp/wi", "layers/mlp/wo"}
    shapes = _shapes(cfg)
    stacks = sorted(k for k in shapes if k.startswith("layers/"))
    cuts = [i for i, (k, _) in enumerate(events) if k == "layer"]
    assert len(cuts) == cfg.num_layers
    starts = [0] + [c + 1 for c in cuts[:-1]]
    for lo, hi in zip(starts, cuts):
        got = [e for e in events[lo:hi] if e[0].startswith("layers/")]
        assert sorted(k for k, _ in got) == stacks, got
        for k, shape in got:
            want = list(shapes[k][1:])
            if k in split:
                want[fn.split.layout[k].dim] //= 2
            assert shape == tuple(want), (k, shape, want)
    rest = [e for e in events[:starts[0]] + events[cuts[-1] + 1:]]
    assert all(not k.startswith("layers/") for k, _ in rest), rest
    V, d = shapes["embed"]
    assert ("embed", (V // 2, d)) in rest and \
        ("final_norm", (d,)) in rest, rest


def _whole_cache_rank(rank: int, store: str, out: str):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, 4),
                            rank=rank, world_size=4,
                            timeout=datetime.timedelta(seconds=60))
    from repro_torch.launch import steps
    from repro_torch.models import lm
    cfg = dataclasses.replace(get_config("gemma3-12b").reduced(),
                              sliding_window=6, global_every=2)
    mesh = mesh_mod.make_mesh((2, 2), ("data", "model"), device="cpu")
    B, S, P, T = 4, 25, 12, 6           # "model" does not divide S
    params = registry.init_params(torch.Generator().manual_seed(0), cfg,
                                  "cpu")
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, P)).astype(np.int32))
    rows = slice(2 * mesh.get_coordinate()[0], 2 * mesh.get_coordinate()[0]
                 + 2)
    got = {}
    for mode, kw in (("uniform", {}), ("ring", {"ring": True}),
                     ("window_slice", {"unroll": True,
                                       "window_slice": True})):
        with torch.no_grad():
            lg, cache = registry.prefill(
                params, cfg, {"tokens": prompt},
                registry.init_cache(cfg, B, S, torch.float32, "cpu"))
            if mode == "ring":
                cache = lm.to_ring_cache(cfg, cache, P)
        tok = torch.argmax(lg, dim=-1).to(torch.int32)
        plain = {k: v.clone() for k, v in cache.items()}
        fn, (in_sh, _) = steps.jit_serve_step(
            cfg, mesh, ShapeConfig("s", seq_len=S, global_batch=B,
                                   kind="decode"), _shapes(cfg), cache, **kw)
        placed = shspecs.place(mesh, params, in_sh[0])
        c = shspecs.place(mesh, cache, in_sh[2])
        err, equal = 0.0, True
        for t in range(T):
            nxt, c, lk = fn(placed, tok, c, P + t, with_logits=True)
            with torch.no_grad():
                step = lm.decode_step_ring if mode == "ring" else \
                    registry.decode_step
                le, plain = step(params, cfg, tok, plain, P + t)
            tok = nxt.full_tensor()
            err = max(err, float((lk - le[rows]).abs().max()))
            equal = equal and torch.equal(tok, torch.argmax(le, dim=-1)
                                          .to(torch.int32))
        got[mode] = {"logits": err, "tokens_equal": equal,
                     "cache": max(float((c[k].full_tensor() - plain[k])
                                        .abs().max()) for k in plain),
                     "split": fn.split.splits("layers/attn/wq"),
                     "cache_spec": list(in_sh[2]["v" if "v" in in_sh[2]
                                                 else "v_win"])}
    Path(out, f"rank{rank}.json").write_text(json.dumps(got))
    dist.destroy_process_group()


def test_serve_step_on_rank_heads_against_a_whole_cache(tmp_path):
    """Reduced gemma3 on 4 gloo ranks, (2, 2), a 25-position cache that
    "model" does not split: each rank writes every kv head of its rows'
    new position and attends its heads against its kv heads' block of
    the whole cache, uniform, as a ring, and window-sliced; tokens equal
    one process's decode, logits and cache within 1e-5."""
    ctx = mp.spawn(_whole_cache_rank, args=(str(tmp_path / "store"),
                                            str(tmp_path)),
                   nprocs=4, join=False)
    deadline = time.monotonic() + SPAWN_LIMIT_S
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"4 ranks did not finish in {SPAWN_LIMIT_S} s")
    for r in range(4):
        got = json.loads((tmp_path / f"rank{r}.json").read_text())
        for mode, g in got.items():
            assert g["split"] and g["cache_spec"][2] is None, (mode, g)
            assert g["tokens_equal"] and g["logits"] <= 1e-5 and \
                g["cache"] <= 1e-5, (mode, g)


def test_autograd_collectives_count_under_their_classes():
    """The split step's collectives on a fake (2, 2) world, forward and
    backward: the sequence and param all-gathers, the partial sums'
    reduce-scatters and the gradient sums' all-reduces, each under its
    ``hlo.py`` class."""
    from repro_torch.roofline.counter import Counter
    cfg = get_config("gemma3-12b").reduced()
    mode, fn, args, mesh = _fake_train_step(cfg)
    with mode, Counter(watch=args) as c:
        fn(*args)
    assert set(c.collectives) == {"all-gather", "reduce-scatter",
                                  "all-reduce"}, c.collectives
    assert all(v > 0 for v in c.collectives.values())


def _pod_counts(cfg, shape_name, layout=None, monkeypatch=None):
    if layout is not None:
        monkeypatch.setattr(shspecs, "compute_layout", layout)
    dryrun.fake_world(256)
    mesh = mesh_mod.make_production_mesh(device="cpu")
    try:
        return dryrun.lower_combo(cfg.name, shape_name, mesh, "pod",
                                  FedConfig(), cfg=cfg).to_dict()
    finally:
        mesh_mod.destroy_world()


def test_pod_dry_run_splits_the_work_over_the_model_axis(monkeypatch):
    """gemma3-12b's widths cut to 2 layers on the pod: train_4k's split
    step has a ``useful_flop_ratio`` at least 8x the same step's with
    every leaf gathered over ``"model"`` (the compute replicated there),
    its rank 0 peak smaller; decode_32k's split serve step has at most a
    quarter of the gathered one's flops a device (the projections and the
    head on the rank's blocks; the attend over the rank's positions
    stays), its rank 0 peak smaller."""
    cfg = dataclasses.replace(get_config("gemma3-12b"), num_layers=2)
    t0 = time.perf_counter()
    split = _pod_counts(cfg, "train_4k")
    decode = _pod_counts(cfg, "decode_32k")
    seconds = time.perf_counter() - t0
    gathered = _pod_counts(cfg, "train_4k", _gathered, monkeypatch)
    gathered_decode = _pod_counts(cfg, "decode_32k", _gathered, monkeypatch)
    assert seconds < 20, seconds
    assert split["useful_flop_ratio"] >= 8 * gathered["useful_flop_ratio"], \
        (split["useful_flop_ratio"], gathered["useful_flop_ratio"])
    assert split["peak_memory_bytes"] < gathered["peak_memory_bytes"]
    assert "reduce-scatter" in split["collectives"]
    assert 4 * decode["flops_per_device"] <= \
        gathered_decode["flops_per_device"], \
        (decode["flops_per_device"], gathered_decode["flops_per_device"])
    assert decode["peak_memory_bytes"] < \
        gathered_decode["peak_memory_bytes"], \
        (decode["peak_memory_bytes"], gathered_decode["peak_memory_bytes"])

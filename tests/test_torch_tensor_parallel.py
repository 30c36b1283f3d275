"""Tensor-parallel compute on the LM mesh's ``"model"`` axis
(``sharding.compute_layout``, ``sharding.MeshSplit``), without the
reference: the reference's own split is held against the port by
``tests/test_torch_lm_mesh_ranks.py``.

- the layout leaf by leaf on the production meshes (``MeshShape``):
  gemma3's heads split, the kv heads read by query group; Hymba's and
  paligemma's attention gathered (25 and 8 heads on 16), Hymba's MLP
  split; llama4's experts expert-parallel; grok-1's experts split by
  ``d_ff``; seamless's two stacks and cross-attention split, its
  vocabulary on (2, 2) only; a one-rank ``"model"`` gathered;
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
- the encoder-decoder's train and serve steps on a fake (2, 2) world on
  the rank's blocks, no param gathered whole; its decode on 4 gloo
  ranks against whole self-attention and source caches equal to one
  process's;
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


# every attention, cross-attention and MLP leaf of the encoder-decoder
_SEAMLESS_SPLIT = {f"{st}/{blk}/{k}"
                   for st, blocks in (("enc_layers", ("attn", "mlp")),
                                      ("dec_layers", ("attn", "xattn",
                                                      "mlp")))
                   for blk in blocks
                   for k in (("wg", "wi", "wo") if blk == "mlp"
                             else ("wq", "wk", "wv", "wo"))}


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
    # seamless: 16 / 16 heads and d_ff 8192 split on 16 in both stacks
    # and the cross-attention; V 256206 does not, on (2, 2) it does
    seamless = _layout("seamless-m4t-large-v2")
    assert {k for k, v in seamless.items() if v is not None} == \
        _SEAMLESS_SPLIT
    assert seamless["dec_layers/xattn/wk"] == Split(-1) and \
        seamless["enc_layers/mlp/wo"] == Split(-2)
    assert seamless["embed"] is None and seamless["lm_head"] is None
    assert seamless["dec_layers/lnx"] is None and seamless["enc_norm"] is None
    two = _layout("seamless-m4t-large-v2", MeshShape((2, 2),
                                                     ("data", "model")))
    assert {k for k, v in two.items() if v is not None} == \
        _SEAMLESS_SPLIT | {"embed", "lm_head"}
    assert two["embed"] == Split(-2) and two["lm_head"] == Split(-1)
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
    # moe_fullgrid splits the tokens over "model" too, and its buffers
    # meet the same stored blocks
    full = _layout("llama4-scout-17b-a16e", moe_fullgrid=True)
    for k in ("wg", "wi", "wo"):
        assert full[f"layers/moe/{k}"] == Split(-3)
    assert full["layers/moe/shared_wi"] == Split(-1)
    full = _layout("grok-1-314b", moe_fullgrid=True)
    assert full["layers/moe/wg"] == full["layers/moe/wi"] == Split(-1)
    assert full["layers/moe/wo"] == Split(-2)


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


def _fake_serve_step(cfg, seq=16):
    """``jit_serve_step`` of ``cfg`` (B 4, ``seq`` cache positions, a
    source of ``seq`` frames for the encoder-decoder) on a fake (2, 2)
    world: (mode, fn, its placed arguments)."""
    from repro_torch.launch import steps
    dryrun.fake_world(4)
    mesh = mesh_mod.make_mesh((2, 2), ("data", "model"), device="cpu")
    sc = ShapeConfig("s", seq_len=seq, global_batch=4, kind="decode")
    mode = FakeTensorMode()
    with mode:
        pstruct = dryrun.params_struct(cfg)
        tok, cspec, pos = registry.decode_spec(cfg, sc, torch.float32)
        fn, (in_sh, _) = steps.jit_serve_step(cfg, mesh, sc, pstruct, cspec)
        args = (shspecs.place(mesh, pstruct, in_sh[0]),
                shspecs.place(mesh, dryrun._fake(tok), in_sh[1]),
                shspecs.place(mesh, dryrun._fake(cspec), in_sh[2]),
                dryrun._fake(pos))
    return mode, fn, args


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
    from repro_torch.models import lm
    cfg = get_config("gemma3-12b").reduced()
    mode, fn, args = _fake_serve_step(cfg, seq=64)
    params = args[0]
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


@pytest.mark.parametrize("kind", ["train", "serve"])
def test_encoder_decoder_steps_hold_no_whole_leaf(kind, monkeypatch):
    """Reduced seamless (4 / 4 heads, d_ff 512, V 512) on a fake (2, 2)
    world, its train and its serve step: no param DTensor is gathered
    whole or redistributed; every attention, cross-attention and MLP
    leaf of both stacks is gathered to the rank's (., n / 2) block of
    the layer's slice, and the embedding to its vocabulary rows."""
    from torch.distributed.tensor import DTensor
    cfg = get_config("seamless-m4t-large-v2").reduced()
    if kind == "train":
        mode, fn, args, _ = _fake_train_step(cfg)
    else:
        mode, fn, args = _fake_serve_step(cfg)
    seen, whole = {}, []
    gather = shspecs.MeshSplit.gather

    def record(self, key, x):
        out = gather(self, key, x)
        seen.setdefault(key, set()).add(tuple(out.shape))
        return out

    def watch(orig):
        def f(self, *a, **k):
            if any(self is v for v in args[0].values()):
                whole.append(tuple(self.shape))
            return orig(self, *a, **k)
        return f
    monkeypatch.setattr(shspecs.MeshSplit, "gather", record)
    monkeypatch.setattr(DTensor, "full_tensor", watch(DTensor.full_tensor))
    monkeypatch.setattr(DTensor, "redistribute",
                        watch(DTensor.redistribute))
    with mode:
        fn(*args)
    assert whole == [], whole
    split = {k for k, v in fn.split.layout.items() if v is not None}
    assert split == _SEAMLESS_SPLIT | {"embed", "lm_head"}
    shapes = _shapes(cfg)
    # the serve step reads the decoder alone; the head and the last norm
    # where they are used
    for k in (split if kind == "train" else
              {k for k in split if not k.startswith("enc_layers/")}):
        want = list(shapes[k][1:] if "layers/" in k else shapes[k])
        want[fn.split.layout[k].dim] //= 2
        assert seen[k] == {tuple(want)}, (k, seen[k])
    assert seen["dec_layers/lnx"] == {shapes["dec_layers/lnx"][1:]}


def _encdec_whole_cache_rank(rank: int, store: str, out: str):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, 4),
                            rank=rank, world_size=4,
                            timeout=datetime.timedelta(seconds=60))
    from repro_torch.launch import steps
    from repro_torch.models import encdec
    cfg = get_config("seamless-m4t-large-v2").reduced(d_model=128,
                                                      vocab=256)
    mesh = mesh_mod.make_mesh((2, 2), ("data", "model"), device="cpu")
    B, Ss, St, T = 4, 7, 25, 4         # "model" divides neither length
    params = registry.init_params(torch.Generator().manual_seed(0), cfg,
                                  "cpu")
    src = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (B, Ss, cfg.d_model)).astype(np.float32))
    with torch.no_grad():
        cache = registry.prefill(
            params, cfg, {"src_embeds": src},
            encdec.init_cache(cfg, B, Ss, St, torch.float32, "cpu"))
    plain = {k: v.clone() for k, v in cache.items()}
    fn, (in_sh, _) = steps.jit_serve_step(
        cfg, mesh, ShapeConfig("s", seq_len=Ss, global_batch=B,
                               kind="decode"), _shapes(cfg), cache)
    placed = shspecs.place(mesh, params, in_sh[0])
    c = shspecs.place(mesh, cache, in_sh[2])
    rows = slice(2 * mesh.get_coordinate()[0], 2 * mesh.get_coordinate()[0]
                 + 2)
    tok = torch.zeros(B, dtype=torch.int32)
    err, equal = 0.0, True
    for t in range(T):
        nxt, c, lk = fn(placed, tok, c, t, with_logits=True)
        with torch.no_grad():
            le, plain = registry.decode_step(params, cfg, tok, plain, t)
        tok = nxt.full_tensor()
        err = max(err, float((lk - le[rows]).abs().max()))
        equal = equal and torch.equal(tok, torch.argmax(le, dim=-1)
                                      .to(torch.int32))
    # the scoring forward on the rank's blocks and rows: its vocabulary
    # block of every position's logits, both stacks' sequences split
    gen = np.random.default_rng(1)
    batch = {"src_embeds": torch.from_numpy(gen.standard_normal(
        (B, 8, cfg.d_model)).astype(np.float32)),
        "tokens": torch.from_numpy(gen.integers(0, cfg.vocab_size, (B, 6))
                                   .astype(np.int32))}
    split, _ = steps.mesh_split(cfg, mesh, 14, _shapes(cfg))
    V = cfg.vocab_size // 2
    cols = slice(mesh.get_coordinate()[1] * V,
                 (mesh.get_coordinate()[1] + 1) * V)
    with torch.no_grad():
        lg = registry.logits_fn({k: v.to_local() for k, v in
                                 placed.items()}, cfg,
                                {k: v[rows] for k, v in batch.items()},
                                split=split)
        want = registry.logits_fn(params, cfg, batch)[rows][..., cols]
    got = {"logits": err, "tokens_equal": equal,
           "cache": max(float((c[k].full_tensor() - plain[k]).abs().max())
                        for k in plain),
           "split": fn.split.splits("dec_layers/xattn/wq"),
           "cache_spec": {k: list(in_sh[2][k]) for k in ("k", "enc_k")},
           "scoring_seq_split": split.seq,
           "scoring_logits": float((lg - want).abs().max())}
    Path(out, f"rank{rank}.json").write_text(json.dumps(got))
    dist.destroy_process_group()


def test_encoder_decoder_decode_against_whole_caches(tmp_path):
    """Reduced seamless on 4 gloo ranks, (2, 2), a 7-frame source and a
    25-position target cache that "model" does not split: each rank
    writes every kv head of its rows' new position, attends its query
    heads against its kv heads' block of the whole self-attention and
    source caches, and sums the partial sums; tokens equal one process's
    decode, logits and cache within 1e-5. The scoring forward
    (``logits_fn(split=)``) on the rank's blocks and rows: its vocabulary
    block of the logits within 1e-5 of the whole forward's."""
    ctx = mp.spawn(_encdec_whole_cache_rank,
                   args=(str(tmp_path / "store"), str(tmp_path)),
                   nprocs=4, join=False)
    deadline = time.monotonic() + SPAWN_LIMIT_S
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"4 ranks did not finish in {SPAWN_LIMIT_S} s")
    for r in range(4):
        got = json.loads((tmp_path / f"rank{r}.json").read_text())
        assert got["split"] and got["cache_spec"] == {
            "k": [None, "data", None, None, None],
            "enc_k": [None, "data", None, None, None]}, got
        assert got["tokens_equal"] and got["logits"] <= 1e-5 and \
            got["cache"] <= 1e-5, got
        assert got["scoring_seq_split"] and \
            got["scoring_logits"] <= 1e-5, got


def test_autograd_collectives_count_under_their_classes():
    """The split step's collectives on a fake (2, 2) world, forward and
    backward: the sequence and param all-gathers, the partial sums'
    reduce-scatters and the gradient sums' all-reduces, each under its
    ``hlo.py`` class."""
    from repro_torch.roofline.counter import Counter
    cfg = get_config("gemma3-12b").reduced()
    mode, fn, args, mesh = _fake_train_step(cfg)
    with mode, Counter(watch=args) as c:
        fn.eager(*args)       # a counter counts the eager body, no graph
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


def test_ssm_mixers_split_by_head_block_where_model_divides_heads():
    """At "model" 2 Hymba's 50 SSD heads and Mamba2-130M's 24 split: the
    rank's rows of ``out_proj`` (its stored block), and of the gathered
    ``in_proj`` its z, x and dt columns beside every B and C column, of
    the conv its x channels beside B and C, its heads and norm columns;
    Mamba2 at 4 and 8 too. Hymba at 4 (50 heads) stays gathered."""
    from repro_torch.sharding.specs import Pick
    two = MeshShape((2, 2), ("data", "model"))
    hymba = _layout("hymba-1.5b", two)
    di, nh = 3200, 50
    assert hymba["layers/ssm/in_proj"] == Pick(
        -1, ((di, True), (di, True), (32, False), (nh, True)))
    assert hymba["layers/ssm/conv_w"] == hymba["layers/ssm/conv_b"] == \
        Pick(-1, ((di, True), (32, False)))
    for k in ("A_log", "D", "dt_bias"):
        assert hymba[f"layers/ssm/{k}"] == Pick(-1, ((nh, True),))
    assert hymba["layers/ssm/norm"] == Pick(-1, ((di, True),))
    assert hymba["layers/ssm/out_proj"] == Split(-2)
    assert hymba["layers/attn/wq"] is None                 # 25 heads
    for M in (2, 4, 8):
        mamba = _layout("mamba2-130m", MeshShape((1, M), ("data", "model")))
        assert mamba["layers/ssm/in_proj"] == Pick(
            -1, ((1536, True), (1536, True), (256, False), (24, True)))
        assert mamba["layers/ssm/out_proj"] == Split(-2), M
    four = _layout("hymba-1.5b", MeshShape((1, 4), ("data", "model")))
    assert all(v is None for k, v in four.items() if "/ssm/" in k)


def _ssm_rank(rank: int, store: str, out_dir: str):
    """Reduced Mamba2's mixer on 2 gloo ranks, each on its 4 of 8 SSD
    heads, against the whole mixer: the gated norm, the forward with its
    gradients, and a decode step."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, 2),
                            rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=60))
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.models.common import rms_norm
    cfg = get_config("mamba2-130m").reduced(d_model=128)
    mesh = mesh_mod.make_mesh((1, 2), ("data", "model"), device="cpu")
    shapes = _shapes(cfg)
    split = shspecs.MeshSplit(mesh, shspecs.param_pspecs(mesh, cfg, shapes),
                              shspecs.compute_layout(mesh, cfg, shapes),
                              seq=False)
    heads = split.ssm_heads()
    params = registry.init_params(torch.Generator().manual_seed(0), cfg,
                                  "cpu")
    rng = np.random.default_rng(1)
    whole = {k.split("/")[-1]: (v[0] + 0.1 * torch.tensor(
        rng.standard_normal(v[0].shape), dtype=torch.float32))
        .requires_grad_() for k, v in params.items() if "/ssm/" in k}

    def block(p):
        out = {}
        for k, v in p.items():
            s = split.layout[f"layers/ssm/{k}"]
            out[k] = split.own(v, -2, "layers/ssm/out_proj") \
                if k == "out_proj" else split.pick(v, s)
        return out

    def err(a, b):                 # max |a - b| / (1 + max |b|)
        a, b = a.detach(), b.detach()
        return float((a - b).abs().max() / (1 + b.abs().max()))

    def parts(t):                  # the ranks' parts of a gradient, summed
        t = t.clone()
        dist.all_reduce(t)
        return t

    got = {}
    # the gated norm: the rank's columns of the whole one's
    y = torch.tensor(rng.standard_normal((2, 5, 256)), dtype=torch.float32)
    z = torch.tensor(rng.standard_normal((2, 5, 256)), dtype=torch.float32)
    scale = whole["norm"].detach()
    own = slice(rank * 128, (rank + 1) * 128)
    got["norm"] = err(ssm_mod.gated_norm(y[..., own], z[..., own],
                                         scale[own], heads),
                      rms_norm(y * torch.nn.functional.silu(z),
                               scale)[..., own])
    # the forward: partial sums summed, the gradients' parts summed
    x = torch.tensor(rng.standard_normal((2, 40, 128)), dtype=torch.float32)
    w = torch.tensor(rng.standard_normal((2, 40, 128)), dtype=torch.float32)
    xs = x.clone().requires_grad_()
    out, (st, _) = ssm_mod.ssm_forward(block(whole), xs, cfg.ssm,
                                       heads=heads)
    (out * w).sum().backward()
    grads = {k: parts(v.grad) for k, v in whole.items()}
    out, xg = parts(out.detach()), parts(xs.grad)
    ref = {k: v.detach().clone().requires_grad_() for k, v in whole.items()}
    xr = x.clone().requires_grad_()
    want, (st_want, _) = ssm_mod.ssm_forward(ref, xr, cfg.ssm)
    (want * w).sum().backward()
    got["out"] = err(out, want)
    got["state"] = err(st, st_want[:, rank * 4:(rank + 1) * 4])
    got["x_grad"] = err(xg, xr.grad)
    got["grads"] = {k: err(grads[k], ref[k].grad) for k in ref}
    # a decode step: the rank's heads of the state, the whole conv state
    state = torch.tensor(rng.standard_normal((2, 8, 32, 16)),
                         dtype=torch.float32)
    conv = torch.tensor(rng.standard_normal((2, 3, 288)),
                        dtype=torch.float32)
    with torch.no_grad():
        o, (s1, c1) = ssm_mod.ssm_decode_step(
            block(whole), x[:, :1], cfg.ssm, state[:, rank * 4:rank * 4 + 4],
            conv, heads=heads)
        o_w, (s_w, c_w) = ssm_mod.ssm_decode_step(whole, x[:, :1], cfg.ssm,
                                                  state, conv)
    got["decode"] = {"out": err(parts(o), o_w),
                     "state": err(s1, s_w[:, rank * 4:rank * 4 + 4]),
                     "conv": err(c1, c_w)}
    Path(out_dir, f"rank{rank}.json").write_text(json.dumps(got))
    dist.destroy_process_group()


def test_ssm_mixer_on_rank_heads_matches_the_whole(tmp_path):
    """The gated norm's split sum of squares (one all-reduce over
    "model") against ``rms_norm`` over all of d_inner; the mixer's
    forward on each rank's heads, its partial sums and its gradients'
    parts summed over the ranks, against the whole mixer's; a decode
    step's partial sums, the rank's state heads and the whole conv state
    it writes: all within 1e-5 (1 + max |whole|), the sums' f32 order
    apart."""
    ctx = mp.spawn(_ssm_rank, args=(str(tmp_path / "store"), str(tmp_path)),
                   nprocs=2, join=False)
    deadline = time.monotonic() + SPAWN_LIMIT_S
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"2 ranks did not finish in {SPAWN_LIMIT_S} s")
    for r in range(2):
        got = json.loads((tmp_path / f"rank{r}.json").read_text())
        flat = [got["norm"], got["out"], got["state"], got["x_grad"],
                *got["grads"].values(), *got["decode"].values()]
        assert max(flat) <= 1e-5, got


def _without_ssm_split(mesh, cfg, params, moe_fullgrid=False):
    """``compute_layout`` with the SSM mixer gathered over ``"model"``,
    as before it split by heads."""
    lay = _COMPUTE_LAYOUT(mesh, cfg, params, moe_fullgrid)
    return {k: None if "/ssm/" in k else v for k, v in lay.items()}


_COMPUTE_LAYOUT = shspecs.compute_layout


def _serve_collectives(cfg):
    """One serve step of ``cfg`` (B 2, 16 cache positions) on a fake
    (1, 2) world: its collectives as (kind, output shape), and the shapes
    ``MeshSplit.gather`` gave each ``layers/ssm/`` leaf."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves
    from repro_torch.launch import steps
    from repro_torch.roofline.counter import COLLECTIVES
    dryrun.fake_world(2)
    mesh = mesh_mod.make_mesh((1, 2), ("data", "model"), device="cpu")
    sc = ShapeConfig("s", seq_len=16, global_batch=2, kind="decode")
    mode = FakeTensorMode()
    with mode:
        pstruct = dryrun.params_struct(cfg)
        tok, cspec, pos = registry.decode_spec(cfg, sc, torch.float32)
        fn, (in_sh, _) = steps.jit_serve_step(cfg, mesh, sc, pstruct, cspec)
        args = (shspecs.place(mesh, pstruct, in_sh[0]),
                shspecs.place(mesh, dryrun._fake(tok), in_sh[1]),
                shspecs.place(mesh, dryrun._fake(cspec), in_sh[2]),
                dryrun._fake(pos))
    seen, blocks = [], {}

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, a=(), kw=None):
            out = func(*a, **(kw or {}))
            kind = COLLECTIVES.get(func.overloadpacket.__name__)
            if kind is not None:
                seen.extend((kind, tuple(t.shape)) for t in tree_leaves(out)
                            if isinstance(t, torch.Tensor))
            return out
    gather = shspecs.MeshSplit.gather

    def record(self, key, x):
        out = gather(self, key, x)
        if "/ssm/" in key:
            blocks.setdefault(key, set()).add(tuple(out.shape))
        return out
    shspecs.MeshSplit.gather = record
    try:
        with mode, Record():
            fn(*args)
    finally:
        shspecs.MeshSplit.gather = gather
    return seen, blocks


@pytest.mark.parametrize("arch", ["mamba2-130m", "hymba-1.5b"])
def test_split_serve_step_moves_no_ssm_state(arch, monkeypatch):
    """The reduced config's serve step on a fake (1, 2) world, its 16 SSD
    heads split: no collective carries the SSM state (its (P, N) rows),
    which the step decodes in place on the rank's 8 heads; ``out_proj``
    is the rank's (d_inner / 2, d) rows, never gathered over "model".
    With the mixer gathered (the layout before the split) the state is
    gathered to the rank's rows. The count: the split adds two
    all-reduces a layer (the gated norm's sum of squares, the partial
    sum's exit) and gathers the conv's new x channels where the gathered
    mixer gathers ``out_proj``, less the state's all-gather."""
    cfg = get_config(arch).reduced()
    di, L = cfg.ssm.expand * cfg.d_model, cfg.num_layers
    nh = di // cfg.ssm.head_dim
    P, N = cfg.ssm.head_dim, cfg.ssm.d_state
    seen, blocks = _serve_collectives(cfg)
    moved = [c for c in seen if c[1][-2:] == (P, N)]
    assert moved == [], moved
    assert blocks["layers/ssm/out_proj"] == {(di // 2, cfg.d_model)}
    assert blocks["layers/ssm/in_proj"] == {
        (cfg.d_model, di + 2 * N + nh // 2)}
    assert blocks["layers/ssm/conv_w"] == {(cfg.ssm.d_conv, di // 2 + 2 * N)}
    monkeypatch.setattr(shspecs, "compute_layout", _without_ssm_split)
    was, was_blocks = _serve_collectives(cfg)
    assert [c for c in was if c[1][-2:] == (P, N)], was
    assert was_blocks["layers/ssm/out_proj"] == {(di, cfg.d_model)}
    count = {k: sum(c[0] == k for c in seen) for k in ("all-gather",
                                                       "all-reduce")}
    was_count = {k: sum(c[0] == k for c in was) for k in count}
    assert count == {"all-gather": was_count["all-gather"] - 1,
                     "all-reduce": was_count["all-reduce"] + 2 * L}, \
        (count, was_count)


def test_split_train_step_runs_the_mixer_on_rank_heads(monkeypatch):
    """Reduced Mamba2's train step on a fake (2, 2) world: each layer
    gathers ``out_proj`` over the data axis only, to the rank's
    (d_inner / 2, d) rows, and computes on the rank's 8 of 16 SSD heads'
    columns of the gathered ``in_proj`` and conv."""
    cfg = get_config("mamba2-130m").reduced()
    di, N = cfg.ssm.expand * cfg.d_model, cfg.ssm.d_state
    nh = di // cfg.ssm.head_dim
    mode, fn, args, mesh = _fake_train_step(cfg)
    seen = {}
    gather = shspecs.MeshSplit.gather

    def record(self, key, x):
        out = gather(self, key, x)
        seen.setdefault(key, set()).add(tuple(out.shape))
        return out
    monkeypatch.setattr(shspecs.MeshSplit, "gather", record)
    with mode:
        fn(*args)
    assert fn.split.ssm_heads() is not None
    assert seen["layers/ssm/out_proj"] == {(di // 2, cfg.d_model)}
    assert seen["layers/ssm/in_proj"] == {(cfg.d_model, di + 2 * N
                                           + nh // 2)}
    assert seen["layers/ssm/conv_b"] == {(di // 2 + 2 * N,)}
    assert seen["layers/ssm/A_log"] == {(nh // 2,)}

"""The LM's ``("data", "model")`` mesh across cards: ``torchrun`` with one
rank a card (NCCL), the (2, 2) mesh on four cards, (1, 2) and (2, 1) on
two, each run bounded by a time limit. Every rank checks, against runs on
its own card without a mesh:

- Hymba-1.5B at full width (f32 params, bf16 compute, remat), three
  steps of B 2 x S 2048 through ``jit_train_step``: the losses within the
  bf16 limit of ``tests/test_torch_steps.py`` (3e-4 relative) of
  ``make_train_step(mesh=None)`` on the whole batch; each step's ms, the
  card's peak GB, the last step's profile (device ms, the ops with the
  most device and host time);
- every mesh train step and token below through the step's CUDA graphs
  (``fn.graphs``: one capture a shape, the third step and the tokens
  after the second replays), each against the rank's eager body on a
  copy of the same inputs within ``ENGINE_TOL`` (tokens equal), TF32
  off and cuDNN deterministic; a replayed step's and token's NCCL
  kernels, their device ms and the host's kernel launches (profiler);
- Hymba-1.5B and h2o-danube-3-4b served by ``jit_serve_step`` on the
  rank's blocks, a layer gathered at a time: B 4, a 2048-position cache
  (its sequence dim split over ``"model"``) prefilled with 64 tokens, 16
  greedy tokens, against the whole batch decoded on one card fed the
  same tokens: the same picks but for near-ties within the two decodes'
  difference (counted, as ``chip_smoke.py``'s ``lm_families`` does);
  each token's wall ms and the peak GB a card, h2o's beside the same
  steps with every leaf gathered over ``"model"`` (``compute_layout``
  patched in the ranks: on (2, 2) h2o splits every leaf, Hymba its MLP
  and its SSM mixer, 25 of 50 SSD heads a rank, its 25 attention heads
  gathered);
- llama4-scout's first 4 layers at dp 2 (the mesh's data axis of 2), B 2
  x S 2048: the CE with ``moe_ctx`` and ``act_pspec`` against a
  per-shard oracle, each data shard's row through the local MoE path
  (its own capacity), the NLL and label counts summed over the shards;
  then the mesh scoring forward on the split path (the train step's
  layout, ``steps.mesh_split``) from each rank's blocks, through kernel
  5 and eagerly: on (2, 2) 20 query heads and 4 kv heads a launch, 8
  experts a rank, the CE within ``SPLIT_CE_RTOL`` of the oracle's; on
  (2, 2) the same forward under ``moe_fullgrid`` on the rank's 8 experts
  (two all-to-alls a MoE layer) against it with the experts gathered
  over ``"model"``: the CE within ``SPLIT_CE_RTOL``, kernel 5 at 20 / 4
  heads, each one's forward ms and peak GB a card;
- Hymba-1.5B's mesh scoring forward on the split path (its MLP and SSM
  mixer split, attention gathered), B 2 x S 2048, against the whole
  batch scored on one card: kernel 6 once a layer on the rank's SSD
  heads (25 of 50 where "model" is 2);
- on (2, 2): Hymba-1.5B served again with f32 caches, its logits
  against one card's; seamless-m4t-large-v2 at full width, three train
  steps of B 2 x 2048 source frames x 1024 target tokens (the losses
  within the bf16 limit of one card's) and 16 tokens served from a
  512-frame source (the picks one card's but for near-ties), each on
  the split path and with every leaf gathered over "model": ms, peak GB
  a card, the last train step's collectives.

With fewer than two cards every test skips. Imports no JAX:

    PYTHONPATH=src python -m pytest -m cuda -s tests/test_torch_cuda_lm_mesh.py

The ranks run this file as a script (``python -m torch.distributed.run
... tests/test_torch_cuda_lm_mesh.py OUT_DIR``); rank 0 writes what it
measured and checked to ``OUT_DIR/lm_mesh.json``.
"""
import contextlib
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.cuda

ROOT = Path(__file__).resolve().parents[1]
RUN_LIMIT_S = 900
BF16_LOSS_RTOL = 3e-4          # tests/test_torch_steps.py's bf16 limit
TRAIN = (2, 2048, 3)           # B, S, steps (the last profiled)
SERVE = (4, 2048, 64, 16)      # B, cache positions, prompt, tokens
# served beside Hymba: every leaf of its layers splits over "model"
SERVE_DENSE = "h2o-danube-3-4b"
MOE_LAYERS = 4
EXPERTS = ("layers/moe/wg", "layers/moe/wi", "layers/moe/wo")
# the encoder-decoder on (2, 2): B, source frames, target tokens, steps;
# and served: B, source frames, tokens from BOS
ENCDEC = "seamless-m4t-large-v2"
ENCDEC_TRAIN = (2, 2048, 1024, 3)
ENCDEC_SERVE = (4, 512, 16)
# the split path's CE against one card's (f32): its row-parallel partial
# sums reduce in another order
SPLIT_CE_RTOL = 1e-5
KERNEL_CE_RTOL = 1e-4          # kernel 5 against the eager attend (f32)
ENGINE_TOL = 1e-6              # a replay against its eager body


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def _free():
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def _encdec_batches(cfg) -> list:
    """``ENCDEC_TRAIN``'s batches: random source frames, target tokens
    and their next tokens as labels."""
    import numpy as np
    B, Ss, St, n = ENCDEC_TRAIN
    rng = np.random.default_rng(5)
    out = []
    for _ in range(n):
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, St + 1))
                                .astype(np.int32)).cuda()
        out.append({"src_embeds": torch.from_numpy(rng.standard_normal(
            (B, Ss, cfg.d_model)).astype(np.float32)).cuda(),
            "tokens": toks[:, :-1], "labels": toks[:, 1:]})
    return out


def _train(mesh, cfg, gathered: bool = False) -> dict:
    """``cfg`` at full width (f32 params, bf16 compute, remat) through
    ``jit_train_step`` on ``mesh``, ``TRAIN``'s batches
    (``ENCDEC_TRAIN``'s for the encoder-decoder), through the step's
    CUDA graphs (the first step eager, the second captured, the third
    replayed), then, the graphs dropped, through its eager body
    (``fn.eager``) from the same params: every loss and the last params
    and momentum within ``ENGINE_TOL``; each step's ms and the eager
    body's, the card's peak GB over the graph calls and with the graphs
    held, the last step's profile and what it ran on the card (NCCL
    kernels by kind, host launches) beside the eager body's last step
    (its profile and the collectives it dispatched); with ``gathered`` the same steps again with every
    leaf gathered over ``"model"`` (``_all_gathered``). The losses
    against ``make_train_step(mesh=None)`` on the whole batches on this
    card alone."""
    import numpy as np
    from repro_torch.checkpoint.convert import _shapes
    from repro_torch.launch import steps
    from repro_torch.models import registry
    from repro_torch.sharding import specs as shspecs
    from repro_torch.types import FedConfig, ShapeConfig
    if cfg.is_encdec:
        batches = _encdec_batches(cfg)
        B, Ss, St, _ = ENCDEC_TRAIN
        shape = ShapeConfig("train", seq_len=Ss + St, global_batch=B,
                            kind="train")
    else:
        B, S, n = TRAIN
        shape = ShapeConfig("train", seq_len=S, global_batch=B,
                            kind="train")
        rng = np.random.default_rng(0)
        batches = [registry.synth_batch(rng, cfg, shape, device="cuda")
                   for _ in range(n)]
    fed = FedConfig()

    def init():
        return registry.init_params(
            torch.Generator(device="cuda").manual_seed(0), cfg, "cuda")
    runs = {}
    for name in ("split", "gathered") if gathered else ("split",):
        with _all_gathered() if name == "gathered" else \
                contextlib.nullcontext():
            fn, (in_sh, _) = steps.jit_train_step(cfg, fed, mesh, shape,
                                                  _shapes(cfg), batches[0])
        whole = init()
        anchor = shspecs.place(mesh, whole, in_sh[2])

        def start():
            params = shspecs.place(mesh, {k: v.clone() for k, v in
                                          whole.items()}, in_sh[0])
            return params, fn.opt.init(params)
        params, state = start()
        losses, ms, peak = [], [], 0.0
        for i, b in enumerate(batches):
            t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            prof = _profiler() if i == len(batches) - 1 else \
                contextlib.nullcontext()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            with prof:
                t0.record()
                params, state, loss = fn(params, state, anchor, b)
                t1.record()
                torch.cuda.synchronize()
            peak = max(peak, torch.cuda.max_memory_allocated() / 1e9)
            ms.append(t0.elapsed_time(t1))
            losses.append(float(loss.to_local()))
        graphs = _graphs(fn, "mesh_train")
        # the eager body from the same params, the graphs dropped
        e_p, e_s = start()
        del whole
        _free()
        eager_ms, err = [], 0.0
        for i, (b, got) in enumerate(zip(batches, losses)):
            last = i == len(batches) - 1
            eprof = _profiler() if last else contextlib.nullcontext()
            t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            with eprof, _Collectives() if last else \
                    contextlib.nullcontext() as coll:
                t0.record()
                e_p, e_s, e_loss = fn.eager(e_p, e_s, anchor, b)
                t1.record()
                torch.cuda.synchronize()
            eager_ms.append(t0.elapsed_time(t1))
            e_loss = float(e_loss.to_local())
            err = max(err, abs(got - e_loss) / abs(e_loss))
        err = max(err, _blocks_diff(params, e_p),
                  _blocks_diff(state["mom"], e_s["mom"]))
        graphs.update(graph_vs_eager_err=err, graphs_ok=graphs["captures"]
                      == graphs["signatures"] == 1 and err <= ENGINE_TOL)
        runs[name] = {"split": repr(fn.split), "losses": losses,
                      "step_ms": ms, "eager_step_ms": eager_ms,
                      "peak_gb": peak, **graphs,
                      "last_step_profile": _top_ops(prof),
                      "last_step_on_card": _on_card(prof),
                      "eager_last_step_on_card": _on_card(eprof),
                      "eager_step_collectives": coll.count}
        del e_p, e_s
        del params, state, anchor
        _free()
    step, opt = steps.make_train_step(cfg, fed)
    p = init()
    anchor, ost, want = dict(p), opt.init(p), []
    for b in batches:
        p, ost, l = step(p, ost, anchor, b)
        want.append(float(l))
    del p, ost, anchor
    _free()
    for run in runs.values():
        run["loss_rel_err"] = max(abs(a - b) / abs(b)
                                  for a, b in zip(run["losses"], want))
    got = {**runs.pop("split"), "one_card_losses": want}
    got["ok"] = got["loss_rel_err"] <= BF16_LOSS_RTOL and all(
        math.isfinite(x) for x in got["losses"]) and all(
        r["loss_rel_err"] <= BF16_LOSS_RTOL for r in runs.values()) and \
        all(r["graphs_ok"] for r in (got, *runs.values()))
    return {**got, **runs}


def _copy(tree):
    """A copy of a tree of DTensors (their blocks cloned), tensors and
    other values: a donated argument kept for the eager body."""
    from torch.distributed.tensor import DTensor
    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    if isinstance(tree, DTensor):
        return DTensor.from_local(tree.to_local().clone(), tree.device_mesh,
                                  tree.placements, run_check=False,
                                  shape=tree.shape, stride=tree.stride())
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def _nbytes(tree) -> int:
    """The bytes of a tree's tensors (a DTensor's block)."""
    from torch.distributed.tensor import DTensor
    if isinstance(tree, dict):
        return sum(map(_nbytes, tree.values()))
    if isinstance(tree, DTensor):
        tree = tree.to_local()
    return tree.numel() * tree.element_size() \
        if isinstance(tree, torch.Tensor) else 0


def _blocks_diff(got: dict, want: dict) -> float:
    """The largest absolute difference of two dicts of DTensors' blocks."""
    return max(float((got[k].to_local().float() - want[k].to_local()
                      .float()).abs().max()) for k in got)


def _graphs(fn, entry: str) -> dict:
    """A mesh step's graphs after its calls, then dropped: captures and
    signatures under ``entry``, the card's reserved GB with the graphs
    held (every other cached block released) and the graphs' pool."""
    torch.cuda.empty_cache()
    held = torch.cuda.memory_reserved() / 1e9
    got = {"captures": fn.graphs.captures(entry),
           "signatures": fn.graphs.count(entry),
           "reserved_with_graphs_gb": held}
    fn.graphs.clear()
    _free()
    got["pool_gb"] = held - torch.cuda.memory_reserved() / 1e9
    return got


_NCCL_KINDS = ("AllReduce", "AllGather", "ReduceScatter", "SendRecv",
               "AllToAll", "Broadcast")


def _on_card(prof) -> dict:
    """What a profiled replay ran: its NCCL kernels by kind (count and
    device ms), the kernels launched from the host and the graphs
    launched."""
    out = {"host_kernel_launches": 0, "graph_launches": 0, "nccl": {}}
    for e in prof.key_averages():
        if e.key.startswith("cudaLaunchKernel"):
            out["host_kernel_launches"] += e.count
        elif e.key.startswith("cudaGraphLaunch"):
            out["graph_launches"] += e.count
        elif "nccl" in e.key.lower() and "kernel" in e.key.lower():
            kind = next((k for k in _NCCL_KINDS if k in e.key), "other")
            d = out["nccl"].setdefault(kind, {"count": 0, "device_ms": 0.0})
            d["count"] += e.count
            d["device_ms"] += getattr(e, "self_device_time_total", getattr(
                e, "self_cuda_time_total", 0)) / 1e3
    return out


class _Collectives(contextlib.AbstractContextManager):
    """The collectives dispatched inside, counted by kind (``count``)."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode
        from repro_torch.roofline.counter import COLLECTIVES
        box = self.count = {}

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kind = COLLECTIVES.get(func.overloadpacket.__name__)
                if kind is not None:
                    box[kind] = box.get(kind, 0) + 1
                return func(*args, **(kwargs or {}))
        self.mode = Mode()

    def __enter__(self):
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self.mode.__exit__(*exc)


def _profiler():
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def _top_ops(prof, n: int = 12) -> dict:
    """The profiled step's device time in kernels and its ops with the
    most self device and self host time, ms."""
    rows = prof.key_averages()

    def dev(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0)) / 1e3

    top = lambda key: [[e.key, round(key(e), 3), e.count]  # noqa: E731
                       for e in sorted(rows, key=key, reverse=True)[:n]]
    return {"device_ms": sum(dev(e) for e in rows),
            "host_ms": sum(e.self_cpu_time_total for e in rows) / 1e3,
            "top_device_ms": top(dev),
            "top_host_ms": top(lambda e: e.self_cpu_time_total / 1e3)}


@contextlib.contextmanager
def _all_gathered(keys=None):
    """``compute_layout`` with every leaf (or the leaves of ``keys``)
    gathered over ``"model"`` while inside: the serve step's comparison
    layout."""
    from repro_torch.sharding import specs as shspecs
    layout = shspecs.compute_layout

    def patched(mesh, cfg, params, moe_fullgrid=False):
        return {k: None if keys is None or k in keys else v for k, v in
                layout(mesh, cfg, params, moe_fullgrid).items()}
    shspecs.compute_layout = patched
    try:
        yield
    finally:
        shspecs.compute_layout = layout


def _serve(mesh, cfg, gathered: bool = False,
           cache_dtype=torch.bfloat16) -> dict:
    """``cfg`` at full width (f32) served by ``jit_serve_step`` on
    ``mesh`` (``SERVE``; the encoder-decoder ``ENCDEC_SERVE`` from BOS
    after a prefilled source), the whole params freed before the mesh's
    steps: each token through the step's CUDA graphs (the first eager,
    the second captured, the rest replayed) and through its eager body
    (``fn.eager``) on a copy of the cache, the tokens equal and the
    logits and cache within ``ENGINE_TOL``; each token's wall ms, the
    eager body's, the card's peak GB over the graph calls and with the
    graphs held, what the last token ran on the card. With
    ``gathered`` the same steps again with every leaf gathered over
    ``"model"`` (``_all_gathered``). Then the whole batch decoded on this
    card alone, fed the mesh's tokens: the same picks but for near-ties
    within the two decodes' difference (counted). ``cache_dtype``: both
    decodes' cache."""
    import numpy as np
    from repro_torch.checkpoint.convert import _shapes
    from repro_torch.launch import steps
    from repro_torch.models import registry
    from repro_torch.sharding import specs as shspecs
    from repro_torch.types import ShapeConfig

    def init():
        return registry.init_params(
            torch.Generator(device="cuda").manual_seed(1), cfg, "cuda")
    params = init()
    rng = np.random.default_rng(1)
    if cfg.is_encdec:
        (B, L, T), P = ENCDEC_SERVE, 0
        src = torch.from_numpy(rng.standard_normal(
            (B, L, cfg.d_model)).astype(np.float32)).cuda()
        with torch.no_grad():
            cache = registry.prefill(
                params, cfg, {"src_embeds": src},
                registry.init_cache(cfg, B, L, cache_dtype, "cuda"))
        first = torch.zeros(B, dtype=torch.int32, device="cuda")   # BOS
    else:
        B, L, P, T = SERVE
        prompt = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (B, P)).astype(np.int32)).cuda()
        with torch.no_grad():
            logits, cache = registry.prefill(
                params, cfg, {"tokens": prompt},
                registry.init_cache(cfg, B, L, cache_dtype, "cuda"))
        first = torch.argmax(logits, dim=-1).to(torch.int32)
        del logits
    shape = ShapeConfig("serve", seq_len=L, global_batch=B, kind="decode")
    fn, (in_sh, _) = steps.jit_serve_step(cfg, mesh, shape, _shapes(cfg),
                                          cache)
    fns = {"split": fn}
    if gathered:
        with _all_gathered():
            fns["gathered"] = steps.jit_serve_step(cfg, mesh, shape,
                                                   _shapes(cfg), cache)[0]
    placed = shspecs.place(mesh, params, in_sh[0])
    del params
    _free()
    out = {}
    for name, fn in fns.items():
        c = shspecs.place(mesh, {k: v.clone() for k, v in cache.items()},
                          in_sh[2])
        tok, picks, lks, ms, eager_ms = first, [], [], [], []
        peak, err, same = 0.0, 0.0, True
        for t in range(T):
            before = _copy(c)
            prof = _profiler() if t == T - 1 else contextlib.nullcontext()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            with prof:
                t0 = time.perf_counter()
                nxt, c, lk = fn(placed, tok, c, P + t, with_logits=True)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            peak = max(peak, (torch.cuda.max_memory_allocated()
                              - _nbytes(before)) / 1e9)
            t0 = time.perf_counter()
            e_nxt, e_c, e_lk = fn.eager(placed, tok, before, P + t,
                                        with_logits=True)
            torch.cuda.synchronize()
            eager_ms.append((time.perf_counter() - t0) * 1e3)
            same = same and torch.equal(nxt.to_local(), e_nxt.to_local())
            err = max(err, float((lk - e_lk).abs().max()),
                      _blocks_diff(c, e_c))
            del before, e_c
            tok = nxt.full_tensor()
            picks.append(tok)
            lks.append(lk)
        graphs = _graphs(fn, "mesh_serve")
        out[name] = {"split": repr(fn.split), "step_wall_ms": ms,
                     "eager_step_wall_ms": eager_ms, "peak_gb": peak,
                     "tokens_equal_eager": same, **graphs,
                     "graph_vs_eager_err": err, "graphs_ok":
                     graphs["captures"] == graphs["signatures"] == 1
                     and err <= ENGINE_TOL,
                     "last_token_on_card": _on_card(prof),
                     "picks": picks, "logits": lks}
        del c
    del placed
    _free()
    params, plain = init(), cache
    rows = _rows(mesh, B)
    ties, errs, tok = 0, [], first
    for t in range(T):
        with torch.no_grad():
            le, plain = registry.decode_step(params, cfg, tok, plain, P + t)
        le = le[rows]
        lk, picks = out["split"]["logits"][t], out["split"]["picks"][t]
        diff = (lk - le).abs().max(dim=-1).values
        gap = le.max(dim=-1).values - le.gather(
            -1, picks[rows].long()[:, None])[:, 0]
        off = le.argmax(dim=-1) != picks[rows]
        if bool((off & (gap > 2 * diff)).any()):
            return {"ok": False, "step": t, "picks": picks.tolist()}
        ties += int(off.sum())
        errs.append(float(((lk - le).abs() / (1 + le.abs())).max()))
        tok = picks
    del params, plain
    _free()
    got = {"ok": all(r["graphs_ok"] and r["tokens_equal_eager"]
                     for r in out.values()),
           "arch": cfg.name, "tokens": T, "greedy_ties": ties,
           "logits_rel_err": max(errs), "cache_dtype": str(cache_dtype)}
    for name, run in out.items():
        got[name] = {k: v for k, v in run.items()
                     if k not in ("picks", "logits")}
    if gathered:
        got["gathered"]["picks_equal_split"] = all(
            torch.equal(a, b) for a, b in zip(out["split"]["picks"],
                                              out["gathered"]["picks"]))
    return got


def _heads_seen():
    """Wrap the attention's kernel entry to record each launch's query and
    kv head counts; returns (the list, an undo)."""
    from repro_torch.kernels import ops
    seen, entry = [], ops.swa_attention_gqa

    def record(q, k, v, window, causal=True):
        seen.append((q.shape[2], k.shape[2]))
        return entry(q, k, v, window, causal)
    ops.swa_attention_gqa = record
    return seen, lambda: setattr(ops, "swa_attention_gqa", entry)


def _scan_heads_seen():
    """Wrap the SSD scan's kernel entry to record each launch's head
    count; returns (the list, an undo)."""
    from repro_torch.kernels import ops
    seen, entry = [], ops.ssd_scan

    def record(x, dt, A, Bm, Cm, chunk=128):
        seen.append(x.shape[2])
        return entry(x, dt, A, Bm, Cm, chunk)
    ops.ssd_scan = record
    return seen, lambda: setattr(ops, "ssd_scan", entry)


def _split_scores(mesh, cfg, whole, batch) -> dict:
    """The mesh scoring forward on the split path (``steps.mesh_split``,
    the train step's layout) from the rank's blocks of ``whole`` and its
    rows of ``batch``: the CE through the kernels and eagerly, kernel 5's
    and kernel 6's launches and the heads each launch saw, the rank's
    block shapes."""
    from repro_torch.checkpoint.convert import _shapes
    from repro_torch.kernels import ssd_scan, swa_attention
    from repro_torch.launch import steps
    from repro_torch.models import registry
    from repro_torch.sharding import specs as shspecs
    B, S = batch["tokens"].shape
    split, ctx = steps.mesh_split(cfg, mesh, S, _shapes(cfg))
    blocks = {k: v.to_local() for k, v in
              shspecs.place(mesh, whole, split.specs).items()}
    rows = {k: v[_rows(mesh, B)] for k, v in batch.items()}
    out = {"split": repr(split)}
    with torch.no_grad():
        seen, undo = _heads_seen()
        scan_seen, undo_scan = _scan_heads_seen()
        before = swa_attention.swa_attention.launches
        before6 = ssd_scan.ssd_scan.launches
        try:
            out["ce"] = float(registry.loss_fn(blocks, cfg, rows,
                                               kernel="cuda", split=split,
                                               moe_ctx=ctx)[1]["ce"])
        finally:
            undo()
            undo_scan()
        out["kernel5_launches"] = swa_attention.swa_attention.launches \
            - before
        out["kernel5_heads"] = [list(h) for h in sorted(set(seen))]
        out["kernel6_launches"] = ssd_scan.ssd_scan.launches - before6
        out["kernel6_heads"] = sorted(set(scan_seen))
        out["ce_eager"] = float(registry.loss_fn(blocks, cfg, rows,
                                                 split=split,
                                                 moe_ctx=ctx)[1]["ce"])
    out["blocks"] = {k: list(blocks[k].shape) for k, v in
                     split.layout.items() if v is not None}
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del blocks
    _free()
    return out


def _fullgrid(mesh, cfg, blocks, batch) -> dict:
    """The mesh scoring forward under ``moe_fullgrid`` from the rank's
    stored ``blocks`` and its rows of ``batch``, on the rank's experts
    (``split``: the dispatch's buffers all-to-all over ``"model"``) and
    with the experts gathered over ``"model"`` (``gathered``: the layout
    ``moe_fullgrid`` computed on before it met the stored experts):
    each one's CE through the kernels, kernel 5's launches and heads, the
    collectives of its first forward by kind, the ms of two more (CUDA
    events) and the card's peak GB over the three above what it held
    before."""
    from repro_torch.checkpoint.convert import _shapes
    from repro_torch.kernels import swa_attention
    from repro_torch.launch import steps
    from repro_torch.models import registry
    B, S = batch["tokens"].shape
    rows = {k: v[_rows(mesh, B)] for k, v in batch.items()}
    out = {}
    for name in ("split", "gathered"):
        with _all_gathered(EXPERTS) if name == "gathered" else \
                contextlib.nullcontext():
            split, ctx = steps.mesh_split(cfg, mesh, S, _shapes(cfg),
                                          moe_fullgrid=True)

        def fwd():
            return float(registry.loss_fn(blocks, cfg, rows, kernel="cuda",
                                          split=split, moe_ctx=ctx)[1]["ce"])
        _free()
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            seen, undo = _heads_seen()
            before = swa_attention.swa_attention.launches
            try:
                with _Collectives() as coll:
                    ce = fwd()
            finally:
                undo()
            launches = swa_attention.swa_attention.launches - before
            ms = []
            for _ in range(2):
                t0, t1 = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
                t0.record()
                fwd()
                t1.record()
                torch.cuda.synchronize()
                ms.append(t0.elapsed_time(t1))
        out[name] = {"split": repr(split), "ce": ce,
                     "kernel5_launches": launches,
                     "kernel5_heads": [list(h) for h in sorted(set(seen))],
                     "collectives": coll.count, "forward_ms": ms,
                     "held_gb": held / 1e9,
                     "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                     "wg_block": list(split.gather(
                         "layers/moe/wg", blocks["layers/moe/wg"][0]).shape)}
    got = out["split"]
    got["ce_rel_err"] = abs(got["ce"] - out["gathered"]["ce"]) \
        / abs(out["gathered"]["ce"])
    M = mesh.size(1)
    got["ok"] = got["ce_rel_err"] <= SPLIT_CE_RTOL and \
        got["kernel5_launches"] == MOE_LAYERS and \
        got["kernel5_heads"] == [[cfg.num_heads // M,
                                  cfg.num_kv_heads // M]] and \
        got["wg_block"][0] == cfg.moe.num_experts // M and \
        got["collectives"].get("all-to-all") == 2 * MOE_LAYERS and \
        "all-to-all" not in out["gathered"]["collectives"]
    got["gathered"] = out["gathered"]
    return got


def _rows(mesh, B: int):
    """This rank's rows of a batch of B split over the data axis."""
    d = mesh.size(0)
    i = mesh.get_coordinate()[0]
    return slice(i * B // d, (i + 1) * B // d)


def _score(mesh, cfg) -> dict:
    """Hymba-1.5B's mesh scoring forward on the split path, B 2 x S 2048
    (its MLP and SSM mixer split over "model", each rank's scans on its
    SSD heads; 25 attention heads gathered): the CE through the kernels
    within ``SPLIT_CE_RTOL`` of the whole batch scored on one card
    without a mesh, and of the split path's eager CE within
    ``KERNEL_CE_RTOL``."""
    import numpy as np
    from repro_torch.models import registry
    from repro_torch.types import ShapeConfig
    B, S, _ = TRAIN
    shape = ShapeConfig("score", seq_len=S, global_batch=B, kind="train")
    batch = registry.synth_batch(np.random.default_rng(3), cfg, shape,
                                 device="cuda")
    whole = registry.init_params(
        torch.Generator(device="cuda").manual_seed(3), cfg, "cuda")
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        want = float(registry.loss_fn(whole, cfg, batch,
                                      kernel="cuda")[1]["ce"])
    got = _split_scores(mesh, cfg, whole, batch)
    del whole
    _free()
    got["one_card_ce"] = want
    got["ce_rel_err"] = abs(got["ce"] - want) / abs(want)
    got["kernel_vs_eager_rel_err"] = abs(got["ce"] - got["ce_eager"]) \
        / abs(got["ce_eager"])
    M, nh = mesh.size(1), cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim
    got["ok"] = got["ce_rel_err"] <= SPLIT_CE_RTOL and \
        got["kernel_vs_eager_rel_err"] <= KERNEL_CE_RTOL and \
        got["kernel5_launches"] == cfg.num_layers and \
        got["kernel6_launches"] == cfg.num_layers and \
        got["kernel6_heads"] == [nh // M if nh % M == 0 else nh]
    return got


def _moe(mesh) -> dict:
    import dataclasses
    import numpy as np
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.models import lm, registry
    from repro_torch.models.common import chunked_lm_nll
    cfg = dataclasses.replace(get_config("llama4-scout-17b-a16e"),
                              num_layers=MOE_LAYERS)
    B, S = 2, 2048
    torch.cuda.reset_peak_memory_stats()
    params = registry.init_params(
        torch.Generator(device="cuda").manual_seed(2), cfg, "cuda")
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (B, S))).cuda()
    labels = torch.cat([toks[:, 1:], torch.full_like(toks[:, :1], -100)], 1)
    rows = _rows(mesh, B)
    batch = {"tokens": toks[rows], "labels": labels[rows]}
    ctx = {"mesh": mesh, "dp": "data"}
    with torch.no_grad():
        _, met = registry.loss_fn(params, cfg, batch, kernel="cuda",
                                  moe_ctx=ctx,
                                  act_pspec=steps.act_pspec(mesh, cfg, S))
        hidden, _ = lm.forward_hidden(params, cfg, batch["tokens"],
                                      kernel="cuda")
        nll, cnt = chunked_lm_nll(hidden, lm.lm_head_weight(params, cfg)
                                  .to(hidden.dtype), batch["labels"])
    parts = torch.stack([nll, cnt])
    dist.all_reduce(parts, group=mesh.get_group("data"))
    want = float(parts[0] / parts[1])
    err = abs(float(met["ce"]) - want) / abs(want)
    out = {"ce": float(met["ce"]), "oracle_ce": want, "ce_rel_err": err,
           "aux": float(met["aux"]), "ok": err <= 1e-6
           and math.isfinite(float(met["aux"])),
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    del hidden
    _free()
    # the split path on the rank's blocks: its heads, experts, vocabulary
    # rows (on (2, 2): 20 query and 4 kv heads, 8 experts a rank)
    split = _split_scores(mesh, cfg, params, {"tokens": toks,
                                              "labels": labels})
    M = mesh.size(1)
    if M > 1:
        # moe_fullgrid on the same stored blocks (the layout moves no
        # storage), the whole params freed first
        from repro_torch.checkpoint.convert import _shapes
        from repro_torch.sharding import specs as shspecs
        blocks = {k: v.to_local().clone() for k, v in shspecs.place(
            mesh, params, shspecs.param_pspecs(mesh, cfg, _shapes(cfg)))
            .items()}
        del params
        _free()
        out["fullgrid"] = _fullgrid(mesh, cfg, blocks, {"tokens": toks,
                                                        "labels": labels})
        out["ok"] = out["ok"] and out["fullgrid"]["ok"]
        del blocks
    else:
        del params
    _free()
    split["ce_rel_err"] = abs(split["ce"] - want) / abs(want)
    split["kernel_vs_eager_rel_err"] = abs(split["ce"] - split["ce_eager"]) \
        / abs(split["ce_eager"])
    split["ok"] = split["ce_rel_err"] <= SPLIT_CE_RTOL and \
        split["kernel_vs_eager_rel_err"] <= KERNEL_CE_RTOL and \
        split["kernel5_launches"] == MOE_LAYERS and \
        split["kernel5_heads"] == [[cfg.num_heads // M,
                                    cfg.num_kv_heads // M]] and \
        split["blocks"]["layers/moe/wg"][1] == cfg.moe.num_experts // M
    out["split"] = split
    out["ok"] = out["ok"] and split["ok"]
    return out


def _rank_main(out_dir: str) -> int:
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import destroy_world, init_world, make_mesh
    init_world()
    # TF32 off and cuDNN deterministic (chip_smoke's _Exact): a replay
    # equals its eager body bit for bit
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    world = dist.get_world_size()
    shapes = [(2, 2)] if world == 4 else [(1, world), (world, 1)]
    cfg = get_config("hymba-1.5b")
    report = {"world": world, "card": _card(), "meshes": {}}
    for shape in shapes:
        mesh = make_mesh(shape, ("data", "model"))
        t0 = time.perf_counter()
        got = {"train": _train(mesh, cfg), "serve": _serve(mesh, cfg)}
        _free()
        got["serve_dense"] = _serve(mesh, get_config(SERVE_DENSE),
                                    gathered=True)
        _free()
        got["score_split"] = _score(mesh, cfg)
        _free()
        if shape[0] == 2:
            got["moe_dp2"] = _moe(mesh)
        if shape == (2, 2):
            got["serve_f32_cache"] = _serve(mesh, cfg,
                                            cache_dtype=torch.float32)
            _free()
            ecfg = get_config(ENCDEC)
            got["encdec_train"] = _train(mesh, ecfg, gathered=True)
            _free()
            got["encdec_serve"] = _serve(mesh, ecfg, gathered=True)
            _free()
        got["seconds"] = time.perf_counter() - t0
        per_rank = [None] * world
        dist.all_gather_object(per_rank, got)
        report["meshes"]["x".join(map(str, shape))] = per_rank
    if dist.get_rank() == 0:
        Path(out_dir, "lm_mesh.json").write_text(json.dumps(report))
    destroy_world()
    return 0


@pytest.fixture(scope="module")
def run(tmp_path_factory) -> dict:
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA devices: one rank a card")
    n = 4 if torch.cuda.device_count() >= 4 else 2
    out = tmp_path_factory.mktemp("lm_mesh")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(n), str(Path(__file__)), str(out)],
        cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
        capture_output=True, text=True, timeout=RUN_LIMIT_S)
    assert proc.returncode == 0, proc.stderr[-6000:]
    report = json.loads((out / "lm_mesh.json").read_text())
    print(json.dumps({"lm_mesh_cards": report}))
    return report


def _all(report, part):
    return [r[part] for ranks in report["meshes"].values() for r in ranks
            if part in r]


def test_train_step_over_cards_matches_one_card(run):
    got = _all(run, "train")
    assert got and all(r["ok"] for r in got), got


def test_serve_step_over_cards_picks_the_one_card_tokens(run):
    got = _all(run, "serve") + _all(run, "serve_dense") + \
        _all(run, "serve_f32_cache")
    assert got and all(r["ok"] for r in got), got


def test_encoder_decoder_over_cards_matches_one_card(run):
    """seamless at full width on (2, 2): the train step's losses within
    the bf16 limit of one card's, split and all-gathered; the serve
    step's picks one card's but for near-ties."""
    got = _all(run, "encdec_train") + _all(run, "encdec_serve")
    if run["world"] == 4:
        assert got and all(r["ok"] for r in got), got


def test_moe_loss_at_dp2_matches_the_per_shard_oracle(run):
    got = _all(run, "moe_dp2")
    assert got and all(r["ok"] for r in got), got


def test_split_scoring_forward_matches_one_card(run):
    got = _all(run, "score_split")
    assert got and all(r["ok"] for r in got), got


if __name__ == "__main__":
    sys.exit(_rank_main(sys.argv[1]))

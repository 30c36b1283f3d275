"""Serving driver (port of ``repro/launch/serve.py``): a static batch
prefilled and decoded greedily, or, with ``--continuous``, a mixed-length
request stream.

The static path synthesises ``--batch`` prompts of ``--prompt-len``
tokens (``registry.synth_batch``: a VLM's patch prefix too; for the
encoder-decoder, ``--prompt-len`` source frames and BOS 0 as the first
target token), prefills an f32 uniform cache and decodes ``--gen`` tokens
one step at a time (``greedy_step``: ``registry.decode_step``, eager
attends), printing the prefill and decode times. On the card the decode
steps are one CUDA graph, captured at the second step and replayed after
it, which reads the params and writes the cache, the token and the
positions where they live.

``--continuous`` serves through the slot-based continuous batcher
(``core/serving.py``): bucketed prefill (``--prefill-buckets`` sets the
smallest bucket; 0 = per-request-length prefill) and per-layer-kind
decode (``--decode-mode ring``: SWA ring buffers and ladder-bucketed
K-extents; ``uniform`` streams the full cache, the parity oracle); the
ring decode runs the CUDA kernels on the card (``--decode-kernel cuda``).

Runs on the card unless ``--device cpu`` is given.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b \
        --reduced --device cpu [--batch 4 --prompt-len 32 --gen 16]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b \
        --reduced --continuous --device cpu
"""
from __future__ import annotations

import argparse
import functools
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.compile_cache import GraphCache
from repro_torch.core.serving import (DECODE_KERNELS, DECODE_MODES,
                                      ContinuousBatcher)
from repro_torch.device import resolve_device
from repro_torch.models import registry
from repro_torch.types import ShapeConfig


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve_continuous(cfg, args) -> int:
    device = resolve_device(args.device)
    rng = np.random.default_rng(args.seed)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = registry.init_params(gen, cfg, device)
    max_len = args.prompt_len + args.gen
    srv = ContinuousBatcher(params, cfg, max_slots=args.batch,
                            max_len=max_len,
                            min_bucket=args.prefill_buckets,
                            decode_mode=args.decode_mode,
                            decode_kernel=args.decode_kernel)
    lengths = rng.integers(1, args.prompt_len + 1, args.requests)
    for n in lengths:
        srv.submit(rng.integers(0, cfg.vocab_size, int(n), dtype=np.int32),
                   max_new=args.gen)
    t0 = time.perf_counter()
    done = srv.run()
    _sync(device)
    dt = time.perf_counter() - t0
    toks = sum(len(r.out) for r in done)
    print(f"served {len(done)} requests ({len(set(map(int, lengths)))} "
          f"distinct prompt lengths) on {device} in {dt:.2f}s "
          f"({toks / max(dt, 1e-9):.1f} gen tok/s)")
    print(f"prefill buckets: {list(srv.buckets) or 'off (per-length)'}")
    print(f"decode mode: {srv.decode_mode}, kernel {srv.decode_kernel} "
          f"(K-extent ladder: "
          f"{list(srv.decode_buckets) or 'n/a (single shape)'})")
    print(f"shapes: prefill={srv.prefill_compiles} "
          f"decode={srv.decode_compiles} total={srv.num_compiled}")
    print(f"admit group sizes {{size: count}}: {srv.group_admits}")
    print(f"bucket use {{bucket: batches run}}: {srv.bucket_hist}")
    return 0


def greedy_step(cfg, params, cache, state):
    """One greedy decode step of the batch fed ``state["tok"]`` (B,)
    int32 at ``state["pos"]`` (B,) int32: writes the argmax token into
    ``tok`` and advances ``pos`` by one, both in place, as the cache.
    Returns (logits, cache, state)."""
    logits, cache = registry.decode_step(params, cfg, state["tok"], cache,
                                         state["pos"])
    state["tok"].copy_(torch.argmax(logits, dim=-1))
    state["pos"].add_(1)
    return logits, cache, state


@torch.no_grad()
def generate(params, cfg, batch, max_len: int, gen: int):
    """Greedy generation from a static batch: ``batch`` is a (B, P) token
    tensor, or a ``synth_batch`` dict (with ``prefix_embeds`` for a VLM;
    an encoder-decoder reads only ``src_embeds``). An LM prefills an f32
    uniform cache of ``max_len`` positions (and a VLM's prefix) and takes
    its first token from the prefill; an encoder-decoder encodes the
    source (a cache of ``max_len`` source frames,
    ``registry.ENCDEC_TGT_LEN`` target positions) and starts from BOS 0
    at position 0. Then ``gen - 1`` greedy decode steps (``greedy_step``)
    through a ``GraphCache`` with the params, the cache and the step's
    token and positions in place: one CUDA graph on the card, eager on
    the CPU. Returns the (B, gen) int32 tokens (numpy) and the prefill and
    decode seconds (the decode's eager step and capture included)."""
    if isinstance(batch, torch.Tensor):
        batch = {"tokens": batch}
    if cfg.is_encdec:
        batch = {"src_embeds": batch["src_embeds"]}
    else:
        batch = {k: v for k, v in batch.items() if k != "labels"}
    first = next(iter(batch.values()))
    device, B = first.device, first.shape[0]
    # a VLM's prefix takes cache positions too (the reference's cache
    # leaves them out: ROADMAP Queue 3)
    prefix = cfg.prefix_len if "prefix_embeds" in batch else 0
    cache = registry.init_cache(cfg, B, max_len + prefix, torch.float32,
                                device)
    _sync(device)
    t0 = time.perf_counter()
    if cfg.is_encdec:
        cache = registry.prefill(params, cfg, batch, cache)
        tok = torch.zeros(B, dtype=torch.int32, device=device)     # BOS
        start_pos = 0
    else:
        # the query chunk spans the prefix too (the reference's is the
        # prompt alone, which need not divide prefix + prompt: ROADMAP
        # Queue 3); chunking splits query rows only, so the logits are
        # the same
        start_pos = batch["tokens"].shape[1] + prefix
        logits, cache = registry.prefill(params, cfg, batch, cache,
                                         q_chunk=min(1024, start_pos))
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
    _sync(device)
    t_prefill = time.perf_counter() - t0
    out = [tok]
    t0 = time.perf_counter()
    state = {"tok": tok.clone(),
             "pos": torch.full((B,), start_pos, dtype=torch.int32,
                               device=device)}
    graphs, step = GraphCache(), functools.partial(greedy_step, cfg)
    for _ in range(gen - 1):
        graphs.call("decode", step, (params, cache, state),
                    inplace=(0, 1, 2))
        out.append(state["tok"].clone())
    _sync(device)
    t_decode = time.perf_counter() - t0
    return torch.stack(out, dim=1).cpu().numpy(), t_prefill, t_decode


def serve_static(cfg, args) -> int:
    device = resolve_device(args.device)
    print(f"serving {cfg.name} ({cfg.family}) batch={args.batch}")
    rng = np.random.default_rng(args.seed)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = registry.init_params(gen, cfg, device)
    # the prompt batch from the registry's spec (its text length is
    # S - prefix_len, so ask for prompt + prefix; an encoder-decoder's
    # source is S frames)
    shape = ShapeConfig(name="serve", global_batch=args.batch,
                        seq_len=args.prompt_len + cfg.prefix_len,
                        kind="decode")
    batch = registry.synth_batch(rng, cfg, shape, act_dtype=torch.float32,
                                 device=device)
    toks, t_prefill, t_decode = generate(
        params, cfg, batch, args.prompt_len + args.gen, args.gen)
    print(f"prefill: {t_prefill*1e3:.1f} ms "
          f"({args.batch * args.prompt_len / max(t_prefill, 1e-9):.0f} tok/s)")
    print(f"decode:  {t_decode*1e3:.1f} ms "
          f"({args.batch * (args.gen - 1) / max(t_decode, 1e-9):.1f} tok/s, "
          f"{t_decode / max(args.gen - 1, 1) * 1e3:.1f} ms/step)")
    print(f"sample generations (first 8 token ids):\n{toks[:, :8]}")
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-12b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4,
                    help="batch size; decode slots in --continuous mode")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--continuous", action="store_true",
                    help="slot-based continuous batching over a "
                         "mixed-length request stream")
    ap.add_argument("--requests", type=int, default=16,
                    help="stream size in --continuous mode")
    ap.add_argument("--prefill-buckets", type=int, default=8,
                    help="smallest prefill bucket (power-of-two ladder up "
                         "to max_len); 0 = per-request-length prefill")
    ap.add_argument("--decode-mode", choices=list(DECODE_MODES),
                    default="ring",
                    help="ring: per-layer-kind decode caches (SWA ring "
                         "buffers + ladder-bucketed K-extents); uniform: "
                         "full-cache decode (parity oracle)")
    ap.add_argument("--decode-kernel", choices=list(DECODE_KERNELS),
                    default="cuda",
                    help="ring-mode decode attends/recurrence: the CUDA "
                         "kernels (default) or the plain torch oracle")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' to run there)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if cfg.family == "resnet3d":
        raise SystemExit("resnet3d is a clip classifier; use pipeline.py")
    if args.continuous:
        return serve_continuous(cfg, args)
    return serve_static(cfg, args)


if __name__ == "__main__":
    raise SystemExit(main())

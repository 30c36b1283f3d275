"""Continuous-batching serving driver (port of ``repro/launch/serve.py``,
its ``--continuous`` path).

A mixed-length request stream is served by the slot-based continuous
batcher (``core/serving.py``): bucketed prefill (``--prefill-buckets``
sets the smallest bucket; 0 = per-request-length prefill) and
per-layer-kind decode (``--decode-mode ring``: SWA ring buffers and
ladder-bucketed K-extents; ``uniform`` streams the full cache, the parity
oracle). Runs on the card unless ``--device cpu`` is given; the ring
decode runs the CUDA kernels there (``--decode-kernel cuda``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b \
        --reduced --continuous --device cpu

The reference's static-batch path (without ``--continuous``) is ROADMAP
Queue 1 item 12.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.serving import (DECODE_KERNELS, DECODE_MODES,
                                      ContinuousBatcher)
from repro_torch.device import resolve_device
from repro_torch.models import registry


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
    if device.type == "cuda":
        torch.cuda.synchronize(device)
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


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-12b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4,
                    help="decode slots")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--continuous", action="store_true",
                    help="slot-based continuous batching over a "
                         "mixed-length request stream (the only path the "
                         "port has)")
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
    if not args.continuous:
        raise SystemExit("the port serves with --continuous only; the "
                         "static-batch path is ROADMAP Queue 1 item 12")
    return serve_continuous(cfg, args)


if __name__ == "__main__":
    raise SystemExit(main())

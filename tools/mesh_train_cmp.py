"""One checkout's encoder-decoder mesh train step at full width, for
comparing two trees.

Runs ``jit_train_step`` of seamless-m4t-large-v2 on the (2, 2)
``("data", "model")`` mesh, one rank a card, from random seeded f32
weights (bf16 compute, remat): ``STEPS`` steps of B 2 x 2048 source
frames x 1024 target tokens, each step's ms (CUDA events), the card's
peak GB over the steps and the collectives the first step dispatches
(counted under a dispatch mode: read times from the other steps; the
first call of a shape runs eagerly on either tree, where the later ones
may replay a CUDA graph, which dispatches nothing). Uses
only the entry points both trees share, so the checkout whose ``src``
is first on ``PYTHONPATH`` is the one measured. Rank 0 writes every
rank's report to ``--out`` as JSON:

    PYTHONPATH=src python3 -m torch.distributed.run --standalone \\
        --nproc-per-node 4 tools/mesh_train_cmp.py --out OUT.json
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys

import numpy as np
import torch

from mesh_serve_cmp import _Collectives


ARCH = "seamless-m4t-large-v2"
SHAPE = (2, 2048, 1024)        # B, source frames, target tokens
STEPS = 3


def _batch(cfg, rng) -> dict:
    B, src, tgt = SHAPE
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, tgt + 1))
                            .astype(np.int32)).cuda()
    return {"src_embeds": torch.from_numpy(rng.standard_normal(
        (B, src, cfg.d_model)).astype(np.float32)).cuda(),
        "tokens": toks[:, :-1], "labels": toks[:, 1:]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    import torch.distributed as dist
    from repro_torch.checkpoint.convert import _shapes
    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import destroy_world, init_world, make_mesh
    from repro_torch.models import registry
    from repro_torch.sharding import specs as shspecs
    from repro_torch.types import FedConfig, ShapeConfig
    init_world()
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh((2, 2), ("data", "model"))
    cfg = get_config(ARCH)
    rng = np.random.default_rng(5)
    batches = [_batch(cfg, rng) for _ in range(STEPS)]
    B, src, tgt = SHAPE
    shape = ShapeConfig("train", seq_len=src + tgt, global_batch=B,
                        kind="train")
    fn, (in_sh, _) = steps.jit_train_step(cfg, FedConfig(), mesh, shape,
                                          _shapes(cfg), batches[0])
    whole = registry.init_params(
        torch.Generator(device="cuda").manual_seed(0), cfg, "cuda")
    params = shspecs.place(mesh, {k: v.clone() for k, v in whole.items()},
                           in_sh[0])
    anchor = shspecs.place(mesh, whole, in_sh[2])
    del whole
    torch.cuda.empty_cache()
    state = fn.opt.init(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 1e9
    losses, ms, counted = [], [], {}
    for i, b in enumerate(batches):
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        with _Collectives() if i == 0 else contextlib.nullcontext() as mode:
            t0.record()
            params, state, loss = fn(params, state, anchor, b)
            t1.record()
            torch.cuda.synchronize()
        if i == 0:
            counted = mode.count
        ms.append(t0.elapsed_time(t1))
        losses.append(float(loss.to_local()))
    rep = {"arch": cfg.name, "batch": B, "src": src, "tgt": tgt,
           "losses": losses, "step_ms": ms, "held_gb": held,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "first_step_collectives": counted,
           "split": repr(getattr(fn, "split", None))}
    per = [None] * dist.get_world_size()
    dist.all_gather_object(per, rep)
    if dist.get_rank() == 0:
        with open(args.out, "w") as f:
            json.dump(per, f)
    destroy_world()
    return 0


if __name__ == "__main__":
    sys.exit(main())

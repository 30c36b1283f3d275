"""Rank 0's work in one mesh scoring forward, counted on a fake world.

The forward is the train step's layout (``steps.mesh_split``: the rank's
stored blocks, the residual split over ``"model"`` on its sequence), bf16
compute on f32 weights, as the dry run's prefill program
(``launch.dryrun._prefill_program``) runs it; ``roofline.Counter``
counts its flops by class, its HBM bytes and its collective bytes. No
device is used: the tensors are fake.

    PYTHONPATH=src python tools/mesh_flops.py --arch hymba-1.5b \\
        --mesh 2,2 --batch 2 --seq 2048

Prints one JSON line: flops a forward, a token and a token a layer.
"""
import argparse
import json
import math

import torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="hymba-1.5b")
    ap.add_argument("--mesh", default="2,2", help="data,model")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=2048)
    args = ap.parse_args(argv)
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.roofline.counter import Counter
    from repro_torch.types import ShapeConfig
    shape = tuple(int(n) for n in args.mesh.split(","))
    cfg = get_config(args.arch)
    dryrun.fake_world(math.prod(shape))
    mesh = mesh_mod.make_mesh(shape, ("data", "model"), device="cpu")
    sc = ShapeConfig("score", seq_len=args.seq, global_batch=args.batch,
                     kind="train")
    mode = FakeTensorMode()
    with mode:
        fwd, placed = dryrun._prefill_program(cfg, sc, mesh,
                                              dryrun.PARAM_DTYPE, True, {})
    with mode, Counter(watch=placed) as c:
        fwd(*placed)
    mesh_mod.destroy_world()
    tokens = args.batch * args.seq // shape[0]          # the rank's rows
    print(json.dumps({
        "arch": args.arch, "mesh": shape, "batch": args.batch,
        "seq": args.seq, "rank0_flops": c.total_flops,
        "flops_by_class": c.flops, "hbm_bytes": c.bytes,
        "collective_bytes": c.collective_bytes,
        "flops_per_token": c.total_flops / tokens,
        "flops_per_token_per_layer": c.total_flops / tokens
        / cfg.num_layers}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

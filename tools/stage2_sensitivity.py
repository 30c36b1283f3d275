#!/usr/bin/env python3
"""How far the reduced pipeline's stage 2 moves when its input moves.

    PYTHONPATH=src python tools/stage2_sensitivity.py [--device cpu]

Runs ``repro_torch.launch.pipeline.run_pipeline`` at the reduced shape
that ``chip_smoke.py``'s phase 4 holds card against CPU (2 clients, 2
global epochs, batch 2, 4 KD and 2 teacher steps, seed 0), keeps its
stage-1 params (``on_stage1``), and fine-tunes them again in each mode
(``pipeline.finetune``, stage 2 alone) after multiplying
every weight by (1 + u · 2^-e), u uniform in [-1, 1] from a seeded
generator, three draws for each e in (24, 20, 17). Prints, for each mode
and e, the largest |w - w0| / (1 + |w0|) of the fine-tuned params against
the unperturbed run's: a smooth fine-tune moves in step with 2^-e, one
that crosses a kink of the network (a ReLU or a max-pool choice flipping)
jumps by a fixed amount. Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))


def _rel_err(got: dict, want: dict) -> float:
    return max(float(((got[k] - want[k]).abs() / (1.0 + want[k].abs())).max())
               for k in want)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="the card unless 'cpu' is given")
    args = ap.parse_args(argv)
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import make_dataset_for
    from repro_torch.device import resolve_device
    from repro_torch.launch import pipeline
    from repro_torch.types import FedConfig

    device = resolve_device(args.device)
    seen = []
    pipeline.run_pipeline(reduced=True, mode="sync", clients=2, epochs=2,
                          batch=2, kd_steps=4, teacher_steps=2, seed=0,
                          device=device, on_stage1=lambda p: seen.append(
                              {k: v.clone() for k, v in p.items()}))
    stage1 = seen[0]
    cfg = get_config("resnet3d-18").reduced()
    fed = FedConfig(num_clients=2, global_epochs=2, seed=0)
    ds = make_dataset_for(cfg, small=True, seed=0)
    gen = torch.Generator().manual_seed(1)
    out = {}
    for mode in ("sync", "async"):
        base = pipeline.finetune(stage1, cfg, fed, ds, 2, mode, "scan", 0,
                                 device).params
        for e in (24, 20, 17):
            errs = []
            for _ in range(3):
                moved = {k: v * (1 + (torch.rand(v.shape, generator=gen)
                                      .to(v.device) * 2 - 1) * 2.0 ** -e)
                         for k, v in stage1.items()}
                res = pipeline.finetune(moved, cfg, fed, ds, 2, mode,
                                        "scan", 0, device)
                errs.append(_rel_err(res.params, base))
            out[f"{mode} 2^-{e}"] = errs
    print(json.dumps({"stage2_param_rel_err_under_input_noise": out,
                      "device": str(device)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

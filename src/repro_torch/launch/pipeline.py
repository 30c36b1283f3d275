"""Two-stage pipeline: KD compression -> federated fine-tuning.

Port of ``repro/launch/pipeline.py``. Stage 1 distils a server-side
teacher into the deployable student over the full synthetic dataset
(``core/distill.py``); stage 2 fine-tunes the distilled student across the
heterogeneous Jetson fleet on each client's reduced local shard,
asynchronously by Algorithm 1 (``simulator.run_async``) or synchronously
by FedAvg (``simulator.run_sync``). Both stages run on the batched
engines by default (``engine="scan"``: the KD epochs and the client runs
replayed as CUDA graphs on the card); ``engine="loop"`` runs stage 2 on
the per-iteration oracle, and in sync mode ``"shard"`` / ``"hier"`` split
its rounds' clients over the process group's ranks
(``fed_engine.ShardedSyncRound``). ``codistill`` replaces stage 1's teacher ->
student chain by codistillation (``distill.run_codistill``): the teacher
and the student train together, each from the other's round-start
logits, and the student goes on to stage 2. ``compare_scratch`` also
fine-tunes a random init of the student the same way: the KD-vs-scratch
comparison. Runs on the card unless ``--device cpu`` is given.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.pipeline --smoke
    PYTHONPATH=src python -m repro_torch.launch.pipeline --arch resnet3d-18 \
        --teacher resnet3d-34 --kd-steps 8 --teacher-steps 2
    PYTHONPATH=src python -m repro_torch.launch.pipeline --reduced \
        --mode sync --compare-scratch --device cpu --engine loop
    PYTHONPATH=src python -m repro_torch.launch.pipeline --reduced \
        --codistill --device cpu
"""
from __future__ import annotations

import argparse
import hashlib
import json
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import distill, simulator
from repro_torch.core.fleet import EngineSpec, Fleet
from repro_torch.data import BatchLoader, iid_partition, make_dataset_for
from repro_torch.device import resolve_device
from repro_torch.launch.train import build_fleet
from repro_torch.models import registry
from repro_torch.types import DistillConfig, FedConfig, ModelConfig


def params_digest(params: dict) -> str:
    """sha256 over keys, shapes, dtypes and raw bytes: two runs agree iff
    their digests agree."""
    h = hashlib.sha256()
    for k in sorted(params):
        v = params[k].detach().cpu().contiguous()
        h.update(f"{k}:{tuple(v.shape)}:{v.dtype}".encode())
        h.update(v.view(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def finetune(params, cfg: ModelConfig, fed: FedConfig, ds, batch: int,
             mode: str, engine, seed: int, device):
    """Stage 2 alone: federated fine-tune from ``params`` over an iid
    partition of the clients' reduced local dataset ``ds``, in ``mode``
    "async" or "sync". Returns the simulator's ``SimResult``."""
    parts = iid_partition(max(len(ds), fed.num_clients * 8),
                          fed.num_clients, seed=seed)
    data = [BatchLoader(ds, batch, steps=fed.local_iters_max,
                        seed=k, indices=parts[k])
            for k in range(fed.num_clients)]
    fleet = Fleet.from_lists(build_fleet(fed.num_clients), data)
    run = simulator.run_async if mode == "async" else simulator.run_sync
    return run(params, cfg, fed, fleet, engine=engine, device=device)


def _scratch_init(cfg: ModelConfig, seed: int, device) -> dict:
    """The scratch baseline's random init of the student: a generator of
    its own, seeded from (seed, 1), so it is deterministic and apart from
    stage 1's stream."""
    gen_seed = int(np.random.SeedSequence([seed, 1]).generate_state(1)[0])
    return registry.init_params(torch.Generator().manual_seed(gen_seed),
                                cfg, device)


def run_pipeline(arch: str = "resnet3d-18", teacher: str = "resnet3d-34",
                 reduced: bool = True, mode: str = "async",
                 clients: int = 4, epochs: int = 4, batch: int = 4,
                 kd_steps: int = 8, teacher_steps: int = 8,
                 kd_lr: float = 0.01, kd_epoch_len: int | None = None,
                 kd_kernel: str = "cuda", engine: str = "scan",
                 codistill: bool = False, compare_scratch: bool = False,
                 eval_steps: int = 4, seed: int = 0, device=None,
                 on_stage1=None):
    """Run KD compression then federated fine-tuning (``mode`` "async" or
    "sync").

    Returns ``(report, params)``: a JSON-serialisable dict and the
    fine-tuned student's params. ``on_stage1``, if given, is called with
    stage 1's params before stage 2 starts, so a caller can hold the two
    stages apart (stage 2 alone is ``finetune``).
    """
    if mode not in ("async", "sync"):
        raise ValueError(f"mode must be 'async' or 'sync', got {mode!r}")
    device = resolve_device(device)
    cfg = get_config(arch)
    tcfg = get_config(teacher)
    if reduced:
        cfg, tcfg = cfg.reduced(), tcfg.reduced()
    t0 = time.time()
    report = {"arch": cfg.name, "teacher": tcfg.name, "mode": mode,
              "engine": EngineSpec.from_str(engine).value,
              "kd_kernel": kd_kernel, "seed": seed, "device": str(device)}

    # ---- stage 1: server-side KD over the full dataset ----------------
    big = make_dataset_for(cfg, small=False, seed=seed)
    loader = BatchLoader(big, batch, steps=kd_steps, seed=seed)
    kd_eval = list(big.batches(batch, eval_steps, seed=999))
    dcfg = DistillConfig(lr=kd_lr, chain=(tcfg.name, cfg.name))
    if codistill:
        t1 = time.time()
        fleet, co = distill.run_codistill(
            [tcfg, cfg], dcfg, loader, kd_eval,
            rounds=max(1, kd_steps // 4), steps_per_round=min(4, kd_steps),
            seed=seed, kd_kernel=kd_kernel, device=device)
        params = fleet.member_params(1)       # the deployable student
        report["stage1"] = {"codistill": True,
                            "accuracy": co["accuracy"],
                            "rounds": int(co["losses"].shape[0]),
                            "losses": co["losses"].tolist(),
                            "compiles": fleet.num_compiled,
                            "wall_s": time.time() - t1}
    else:
        params, stages = distill.run_chain(
            [tcfg, cfg], dcfg, loader, kd_eval, steps_per_stage=kd_steps,
            seed=seed, kd_kernel=kd_kernel,
            trained_teacher_steps=teacher_steps, epoch_len=kd_epoch_len,
            device=device)
        report["stage1"] = {"codistill": False, "stages": [
            {"teacher": s.teacher, "student": s.student, "losses": s.losses,
             "accuracy": s.accuracy, "steps": len(s.losses),
             "wall_s": s.wall_time_s} for s in stages]}
    report["stage1"]["digest"] = params_digest(params)
    if on_stage1 is not None:
        on_stage1(params)

    # ---- stage 2: federated fine-tune on the clients' reduced data ----
    # same seed as stage 1: the clients' dataset draws the same class
    # programs as the server's, so KD transfer is real
    fed = FedConfig(num_clients=clients, global_epochs=epochs, seed=seed)
    ds = make_dataset_for(cfg, small=True, seed=seed)
    res = finetune(params, cfg, fed, ds, batch, mode, engine, seed,
                    device)
    params = res.params
    held_out = list(ds.batches(batch, eval_steps, seed=777))
    report["stage2"] = {"final_loss": res.final_loss,
                        "losses": [h[2] for h in res.history],
                        "virtual_wall_s": res.wall_clock_s,
                        "accuracy": distill.evaluate(params, cfg, held_out)}
    report["params_digest"] = params_digest(params)

    if compare_scratch:
        # the same fine-tune from a random init: the KD baseline
        sres = finetune(_scratch_init(cfg, seed, device), cfg, fed, ds,
                        batch, mode, engine, seed, device)
        report["scratch"] = {
            "final_loss": sres.final_loss,
            "accuracy": distill.evaluate(sres.params, cfg, held_out)}
    report["real_wall_s"] = time.time() - t0
    return report, params


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="resnet3d-18")
    ap.add_argument("--teacher", default="resnet3d-34")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--mode", choices=["async", "sync"], default="async")
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--kd-steps", type=int, default=8)
    ap.add_argument("--teacher-steps", type=int, default=8)
    ap.add_argument("--kd-lr", type=float, default=0.01)
    ap.add_argument("--kd-epoch-len", type=int, default=None,
                    help="KD steps per loss read-back (default: whole stage)")
    ap.add_argument("--kd-kernel", choices=list(distill.KD_KERNELS),
                    default="cuda")
    ap.add_argument("--engine", choices=["scan", "loop", "shard"],
                    default="scan",
                    help="stage 2's client execution: the batched engines "
                         "(CUDA graphs on the card), 'shard' to also split "
                         "the sync round's clients over the process "
                         "group's ranks, or the per-iteration loop")
    ap.add_argument("--codistill", action="store_true",
                    help="stage 1 by codistillation (the teacher and the "
                         "student as peers) instead of the teacher -> "
                         "student chain")
    ap.add_argument("--compare-scratch", action="store_true",
                    help="also fine-tune from a random init and report it")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' to run there)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke", action="store_true",
                    help="tiny preset (reduced, 2 clients, 2 epochs)")
    args = ap.parse_args(argv)

    kw = dict(arch=args.arch, teacher=args.teacher, reduced=args.reduced,
              mode=args.mode, clients=args.clients, epochs=args.epochs,
              batch=args.batch, kd_steps=args.kd_steps,
              teacher_steps=args.teacher_steps, kd_lr=args.kd_lr,
              kd_epoch_len=args.kd_epoch_len, kd_kernel=args.kd_kernel,
              engine=args.engine, codistill=args.codistill,
              compare_scratch=args.compare_scratch,
              seed=args.seed, device=args.device)
    if args.smoke:
        kw.update(reduced=True, clients=2, epochs=2, batch=2,
                  kd_steps=4, teacher_steps=2, eval_steps=2)
    report, _ = run_pipeline(**kw)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

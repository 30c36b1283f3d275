"""Trainer: the paper's stage 2 and its two baselines.

Port of ``repro/launch/train.py`` on a resident fleet of ``--clients``
Jetsons, or with ``--population N`` on a streamed fleet of N clients
drawn from the four Jetson types (``core/fleet.py::FleetSpec``; with
``--clients-per-round m`` only the m sampled or in-flight clients are
ever held): federated fine-tuning asynchronously (Algorithm 1, ``--mode
async``), synchronously (FedAvg, ``--mode sync``), or centrally on the
server with no clients (``--mode central``), from a random init or, with
``--distill-first``, from a short teacher -> student KD stage
(``launch/pipeline.py`` runs both stages in full). Runs on the card
unless ``--device cpu`` is given, and prints one JSON result line last.

``--arch`` takes the decoder-only LM configs too (``mamba2-130m``,
``hymba-1.5b``, ``gemma3-12b``, the moe ``llama4-scout-17b-a16e`` and
``grok-1-314b``, ``paligemma-3b`` without its patch prefix, and the other
dense ones): their clients read the Markov token stream of
``data.SyntheticLMDataset`` at the config's vocabulary, which has no
length, so no client gets a shard. Its transition matrix is V x V on the
host, so pass ``--reduced`` (vocabulary 512) there; ``--distill-first``
stays resnet3d-only, as the reference's. The encoder-decoder
(``seamless-m4t-large-v2``) is refused: the stream carries no source
frames for its encoder, and the reference's trainer fails there too.

``--algorithm`` picks the federated algorithm (``core/algorithms.py``):
the paper's proximal local SGD (``fedprox``, the default), SCAFFOLD's
control variates (``scaffold``) or capacity-scaled low-rank / masked
submodel updates (``lowrank``), on either engine and mode.

``--engine shard|hier`` (sync mode; async mode prints that they are
sync-only and runs on ``scan``, as the reference's trainer) splits each
round's clients over the ranks of the process group
(``launch/mesh.py``): in one process a world
of one; under ``torchrun --nproc-per-node N`` N ranks, each running the
same seeded program on its block of the clients (its own card, or the
CPU over gloo), rank 0 alone printing and writing ``--ckpt``; the group
is destroyed at exit. More than one rank on the card needs as many cards.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.train --mode sync \
        --epochs 8 --reduced --device cpu [--engine scan|loop] \
        [--algorithm fedprox|scaffold|lowrank]
    PYTHONPATH=src python -m torch.distributed.run --standalone \
        --nproc-per-node 2 -m repro_torch.launch.train --mode sync \
        --engine shard --reduced --device cpu --epochs 2
    PYTHONPATH=src python -m repro_torch.launch.train --mode central \
        --steps 20 --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --mode async \
        --population 1000000 --clients-per-round 4 --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m \
        --mode central --steps 50 --reduced --device cpu
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.checkpoint import save_params
from repro_torch.configs import get_config
from repro_torch.core import distill, simulator
from repro_torch.core.algorithms import ALGORITHMS
from repro_torch.core.fedasync import make_client_step
from repro_torch.core.fleet import (ASYNC_ENGINES, JETSON_FLEET_HMDB51,
                                    EngineSpec, Fleet, FleetSpec)
from repro_torch.data import BatchLoader, iid_partition, make_dataset_for
from repro_torch.device import resolve_device
from repro_torch.launch import mesh
from repro_torch.models import registry
from repro_torch.optim import trainable_mask
from repro_torch.types import DistillConfig, FedConfig

def build_fleet(n: int):
    """n Jetson profiles, cycling through the paper's four device types."""
    base = list(JETSON_FLEET_HMDB51)
    return tuple(base[i % len(base)] for i in range(n))


def _quiet(*args, **kwargs) -> None:
    """A rank other than 0 prints nothing."""


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="resnet3d-18")
    ap.add_argument("--mode", choices=["async", "sync", "central"],
                    default="async")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--epochs", type=int, default=20,
                    help="global epochs E (async/sync)")
    ap.add_argument("--steps", type=int, default=50,
                    help="steps (central mode)")
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--population", type=int, default=0,
                    help="streaming fleet population; clients materialize "
                         "only when sampled (0 = the resident fleet of "
                         "--clients devices)")
    ap.add_argument("--clients-per-round", type=int, default=0,
                    help="sync draws m clients a round, async keeps m in "
                         "flight; 0 = the whole fleet")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--beta", type=float, default=0.7)
    ap.add_argument("--a", type=float, default=0.5)
    ap.add_argument("--theta", type=float, default=0.01)
    ap.add_argument("--trainable", choices=["all", "last_layer"],
                    default="all")
    ap.add_argument("--engine", choices=[e.value for e in EngineSpec],
                    default="scan",
                    help="client execution: the batched engines (CUDA "
                         "graphs on the card), 'shard' to also split the "
                         "sync round's clients over the process group's "
                         "ranks (a world of one unless torchrun started "
                         "more), 'hier' for the two-level edge-aggregator "
                         "tree over the ('edge', 'clients') mesh (both "
                         "sync only), or the per-iteration loop, the oracle")
    ap.add_argument("--algorithm", choices=sorted(ALGORITHMS),
                    default="fedprox",
                    help="federated algorithm (core/algorithms.py): "
                         "'fedprox' is the paper's proximal local SGD, "
                         "'scaffold' adds SCAFFOLD's control variates, "
                         "'lowrank' ships capacity-scaled low-rank / masked "
                         "submodel updates")
    ap.add_argument("--async-window", type=float, default=0.0,
                    help="staleness-bounded micro-batching window W in "
                         "virtual seconds (async mode); 0 = event by event")
    ap.add_argument("--distill-first", action="store_true",
                    help="run a short teacher -> student KD stage first")
    ap.add_argument("--kd-kernel", choices=list(distill.KD_KERNELS),
                    default="cuda",
                    help="KD loss: the fused CUDA kernel (default) or the "
                         "eager torch version")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' to run there)")
    args = ap.parse_args(argv)
    if args.mode == "sync" and EngineSpec.from_str(args.engine) in (
            EngineSpec.SHARD, EngineSpec.HIER):
        device = mesh.init_world(args.device)   # a launched rank's own card
    else:
        device = resolve_device(args.device)
    say = print if mesh.rank() == 0 else _quiet

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if cfg.is_encdec:
        # the reference fails here too, at its first loss (ROADMAP Queue 3)
        raise ValueError(
            f"{cfg.name}: make_dataset_for yields token streams with no "
            "src_embeds, which the encoder-decoder's loss reads")
    say(f"arch={cfg.name} family={cfg.family} mode={args.mode}")

    params = registry.init_params(torch.Generator().manual_seed(args.seed),
                                  cfg, device)

    if args.distill_first and cfg.family == "resnet3d":
        teacher_cfg = get_config("resnet3d-34")
        if args.reduced:
            teacher_cfg = teacher_cfg.reduced()
        big = make_dataset_for(cfg, small=False, seed=args.seed)
        loader = BatchLoader(big, args.batch, steps=16, seed=args.seed)
        eval_b = list(big.batches(args.batch, 4, seed=999))
        dcfg = DistillConfig(lr=0.01, chain=(teacher_cfg.name, cfg.name))
        params, stages = distill.run_chain(
            [teacher_cfg, cfg], dcfg, loader, eval_b,
            steps_per_stage=16, seed=args.seed, trained_teacher_steps=16,
            kd_kernel=args.kd_kernel, device=device)
        for st in stages:
            say(f"  KD {st.teacher} -> {st.student}: "
                  f"acc={st.accuracy:.3f} ({st.wall_time_s:.1f}s)")

    population = args.population or args.clients
    fed = FedConfig(num_clients=population, global_epochs=args.epochs,
                    mixing_beta=args.beta, staleness_a=args.a,
                    prox_theta=args.theta, lr=args.lr,
                    trainable=args.trainable,
                    clients_per_round=args.clients_per_round,
                    seed=args.seed)
    ds = make_dataset_for(cfg, small=True, seed=args.seed + 1)
    t0 = time.time()

    if args.mode == "central":
        step, opt = make_client_step(cfg, fed)
        mask = trainable_mask(params, fed.trainable)
        opt_state = opt.init(params)
        anchor = params
        for i, batch in enumerate(ds.batches(args.batch, args.steps,
                                             seed=args.seed)):
            params, opt_state, loss = step(params, opt_state, anchor, batch,
                                           mask)
            if i % 10 == 0:
                say(f"  step {i:4d} loss {float(loss):.4f}")
        result = {"mode": "central", "final_loss": float(loss),
                  "wall_s": time.time() - t0}
    else:
        if args.population:
            fleet = Fleet.from_spec(FleetSpec(
                population=population, profiles=JETSON_FLEET_HMDB51,
                dataset=ds, batch_size=args.batch,
                steps=fed.local_iters_max, seed=args.seed,
                partition="shared"))
        else:
            parts = iid_partition(max(len(ds), args.clients * 8),
                                  args.clients, seed=args.seed) \
                if hasattr(ds, "__len__") else [None] * args.clients
            data = [BatchLoader(ds, args.batch, steps=fed.local_iters_max,
                                seed=k, indices=parts[k])
                    for k in range(args.clients)]
            fleet = Fleet.from_lists(build_fleet(args.clients), data)
        eng = args.engine
        if args.mode == "async" \
                and EngineSpec.from_str(eng) not in ASYNC_ENGINES:
            # the async path has no fleet-wide round to shard: its bursts
            # run on the batched engines, as the reference's trainer does
            say(f"  engine={eng} is sync-only; async uses engine=scan")
            eng = "scan"
        if args.mode == "async":
            res = simulator.run_async(params, cfg, fed, fleet,
                                      engine=eng,
                                      window=args.async_window,
                                      algorithm=args.algorithm,
                                      device=device)
        else:
            res = simulator.run_sync(params, cfg, fed, fleet,
                                     engine=eng,
                                     algorithm=args.algorithm,
                                     device=device)
        params = res.params
        say(f"  virtual wall-clock {res.wall_clock_s:.0f}s "
              f"final loss {res.final_loss:.4f}")
        if args.mode == "async":
            say(f"  staleness histogram: {res.staleness_hist}")
            if args.async_window > 0:
                say(f"  receive-group histogram (W={args.async_window}): "
                      f"{res.group_hist}")
        result = {"mode": args.mode, "algorithm": args.algorithm,
                  "final_loss": res.final_loss,
                  "virtual_wall_s": res.wall_clock_s,
                  "real_wall_s": time.time() - t0}

    if args.ckpt and mesh.rank() == 0:
        save_params(params, args.ckpt, extra=result)
        say(f"  saved {args.ckpt}")
    say(json.dumps(result))
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    finally:
        if mesh.launched():
            mesh.destroy_world()
    raise SystemExit(rc)

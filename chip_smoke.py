#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on any error:

1. card check: a CUDA device must be present; prints the card's name and
   power limit as ``nvidia-smi`` reports them;
2. build: compiles the port's CUDA sources for sm_90a, one nvcc each, all
   at once, and prints the build seconds and ptxas reports;
3. the launch floor (a one-element ``torch.zeros``'s device time, a
   yardstick only); the KD loss's forward and backward kernels against
   their plain PyTorch versions on the card, masked rows of NaN / Inf
   exactly 0, the backward with and without the teacher's gradient; both
   timed at the main path's shape beside their plain versions' kernels a
   call; then the host time of the SSD step's and the KD loss's wrappers,
   cProfile over 1000 calls each (``host_profile`` lines), before the
   pipelines run in the process;
4. the reduced pipeline on the card against the same pipeline on the CPU
   (TF32 off and cuDNN's deterministic algorithms for this phase), both on
   the batched engines (``engine="scan"``: CUDA graphs on the card),
   async, then sync FedAvg with the scratch baseline: losses to rtol
   1e-3, virtual clock exact, params within 1e-3 * (1 + |cpu|) (the
   card's run on ``loop`` too), one forward and one backward KD kernel a
   KD step on the card by the profiler's device events, none on the CPU;
   beside them the stage-1 params card vs CPU, and for sync the run again
   on fresh stage-1 engines and stage 2 alone from the CPU's stage 1
   (cuDNN deterministic and free), then stage 1's eager epoch against a
   replayed one, card against card;
5. the main path at full width: ResNet3D-34 -> 18 KD (400 classes) then
   the four-Jetson async fine-tune on ``scan``, the first run of its
   engines in the process, with every kernel's launches counted; the
   same pipeline on ``loop``, on ``scan`` again and on ``scan`` a third
   time, traced (every KD launch a replay: none from the host, the card's
   by the profiler); ``loop`` and ``scan`` with TF32 off and cuDNN
   deterministic: virtual clocks equal, params within 1e-6 * (1 + |loop|),
   each run's wall time (``engines_full_width``); then the sync baseline
   with the scratch fine-tune beside it, traced, and async again, both at
   8 global epochs (two sync rounds): both virtual clocks and the
   async-vs-sync reduction, each run's wall time, the stage-2 and scratch
   accuracies, the KD launches; then the async pipeline as a user runs
   it, one process a run (``python -m repro_torch.launch.pipeline``), on
   ``scan`` and ``loop`` at 4 and 256 global epochs, twice each, and the
   epochs at which the two engines break even (``break_even``);
6. one KD step and one client step at the main path's clip shape and at
   the paper's (8x112x112, batch 8), TF32 at PyTorch's default, each
   timed and traced by torch.profiler (kernels a step), with the KD
   step's forward and backward launches counted; then, at the main path's
   clip shape, one KD epoch of 8 steps replayed as a CUDA graph and one
   sync round of 4 clients x 3 steps on ``scan`` against ``loop``, and
   the same round's clients one after another in one graph (the
   engine's path) against ``torch.func.vmap`` (grouped convolutions):
   wall and device ms, the device-busy share, the KD kernels of one
   replay from the profiler's device events and from the counts, and
   each comparison's spread with and without cuDNN's deterministic
   algorithms (``captured``); then fresh engines report one program and
   one capture per round shape over three H^k draws, and replay under
   ``torch.cuda.set_sync_debug_mode("error")`` (``engines``);
6a. the sharded and hierarchical sync rounds (``multi_device``) in a
   world of one over NCCL at the main path's full width: shard and hier
   against scan (an even and a ragged round with a zero-weight client)
   in ``_Exact``, one capture per round shape, replays with host syncs
   made errors, each replay's wall and device ms; ``run_sync`` on both
   with FedProx and SCAFFOLD (clocks equal); ``launch.train --mode sync
   --engine hier --distill-first`` traced (16 launches of each KD
   kernel, counted and on the card);
6b. the federated-algorithm layer at the main path's full width
   (``algorithms``): ``run_async`` with SCAFFOLD, LowRankSubmodel and
   FedProx at ``compress_bits`` 8 and 4, ``run_sync`` with SCAFFOLD and
   LowRankSubmodel, each on ``scan`` and ``loop`` with TF32 off and cuDNN
   deterministic (clocks equal, params within 1e-6 * (1 + |loop|), wall
   times); fresh engines' program shapes and captures per round shape
   over three H^k draws and four capacities, replayed with host syncs
   made errors (a second ``engines`` line; LowRank's round is two
   graphs, its SVD eagerly between them); one full-width update's int8,
   int4 and LowRank wire bytes against the formula; the reduced SCAFFOLD
   run with int8 updates on the card against the CPU;
6c. codistillation at full width (``codistill``): ``run_pipeline(
   codistill=True)`` with ResNet3D-34 and -18 as peers, then the async
   fine-tune, traced (16 launches of each KD kernel on the card and 16
   counted on the host); a replayed round against its eager run in
   ``_Exact``, bit for bit; the reduced codistill pipeline and a round
   at budgets [4, 2] card against CPU; the chain-time model of the two
   reference chains;
6d. streamed populations (``population``): ``launch.train --population
   1000000 --clients-per-round 4`` at full width, async and sync, one
   process each; ``run_async`` / ``run_sync`` on a 10^6-client
   ``FleetSpec`` twice each: clients held at once (<= 4), the in-flight
   bound, captures that do not grow with the clients drawn; 8 clients
   streamed against their materialized twin in ``_Exact``, bit for bit;
6e. a scheduled learning rate through the engines (``schedules``) at the
   main path's full width in ``_Exact``: two KD epochs of 8 under
   ``cosine(0.01, 16, 2)`` replayed against their 16 steps run one by
   one (the step ends at 16; the KD kernels 8 + 8 on the card in the
   replays by ``_trace``, none from the host); the ragged 4 x 3 round
   under ``inverse_sqrt(0.05, 1)`` on ``scan`` against ``loop`` and
   ``shard`` / ``hier`` (a world of one over NCCL) against ``scan``;
   ``run_async`` on ``scan`` against ``loop`` (clocks equal); two
   codistill rounds at budgets [4, 2], a replay against eager, each
   member's step; fresh scheduled engines, one capture per round shape
   over three H^k draws, replayed with host syncs made errors (an
   ``engines`` line); a replayed scheduled KD epoch and round, device ms
   and kernels, beside the constant-rate ones;
7. the serving decode kernels (ring attend, extent attend, SSD step)
   against their plain versions on the card, f32 and bf16 caches, an
   extent of 131072 keys among them, the other configs' decode shapes
   too (h2o-danube's ring at D 120, W 4096; llama4-scout's, grok-1's and
   paligemma's extents), the SSD step also on the decode
   step's own views with its state written in place; then timed at
   Hymba-1.5B's full-width decode shape beside their bound and
   ``scaled_dot_product_attention`` (the SSD step on contiguous operands
   and on the path's views in place), and the ring and extent kernels at
   the other configs' shapes, each timed call held against its plain
   version and each kernel's launches a call measured (one);
8. the reduced Hymba serving path on the card against the CPU (TF32 off):
   identical tokens, prefill and decode logits to rtol 1e-3; the card's
   ticks replays of one CUDA graph a K-extent rung (``GraphCache``, the
   params and the cache in place), traced: the decode kernels counted on
   the host (a tick's for each eager tick and each capture) and on the
   card (a tick's every tick, from the profiler's device events);
9. the serving path at full width: Hymba-1.5B, f32, four slots, eight
   requests of 1 to 1500 prompt tokens through the continuous batcher in
   ring mode on the CUDA kernels, each tick a graph replay after its
   rung's eager tick and capture: the stream timed with every kernel's
   host launches counted, then again traced (the kernels the card ran,
   the stream's device-busy share), each batcher's graphs released and
   their pools' GiB printed; 16 decode ticks teacher-forced against the
   uniform eager decode; in ``_Exact``, 12 forced ticks across the
   K-extent rungs 8, 16 and 32, ring and uniform, each replay against the
   eager decode on a copy of the cache, 0.0 apart; one tick at K-extent
   2048 replayed and eager, timed and traced (kernels a tick);
10. the scoring kernels (sliding-window attention through its folded and
    its GQA entry, SSD chunk scan) against their plain versions on the
    card, f32 and bf16, Gemma3-12B's GQA shape at head dim 240 among
    them, and h2o-danube's (D 120), llama4-scout's and grok-1's (D 128)
    and paligemma's (D 256, one kv head), each also timed, then timed at
    Hymba-1.5B's full-width scoring shapes (the attention also at
    Gemma3-12B's) beside their bounds (for the attention
    at the f32 FMA rate and as 3xTF32 on the tensor cores) and, for the
    attention, ``scaled_dot_product_attention`` with the band mask;
11. the reduced Hymba, Mamba2 and Gemma3 scoring forward
    (``registry.loss_fn`` / ``logits_fn``, kernel="cuda") on the card
    against the CPU (TF32 off); then Gemma3-12B at its config's widths,
    cut to its first 6 layers (one global), B = 1, S = 2048, through the
    kernels against the eager forward on the card;
12. the scoring forward at full width: Hymba-1.5B, f32, B = 2, S = 2048,
    ``loss_fn`` and ``logits_fn`` through the kernels (32 launches of each
    a forward) against the eager forward on the card, both timed, one
    forward of each traced by torch.profiler, its copy, index and repeat
    kernels listed;
13. the trainer (``repro_torch.launch.train``) at full width on
    the card: ``--mode central`` for 8 steps, and ``--mode sync
    --distill-first --engine scan --algorithm scaffold`` (16 teacher and
    16 KD steps, then two sync rounds),
    each result line printed, its losses finite, the KD launches counted
    (16 of each on the distill-first run, none on the central one);
13b. the LM training slice (``lm_train``): ``launch.steps.make_train_step``
    on Hymba-1.5B at full width (bf16 compute, remat), 4 steps of B 2 x S
    2048 synthesised tokens, each step's ms, the peak device memory; the
    same step on the reduced Hymba at f32 compute, card against CPU;
    Mamba2-130M distilled into itself at full width (one eager and one
    replayed KD epoch of 4 steps of 4 x 64 tokens: kernels 1 and 1b at
    R = 256, V = 50280, 4 + 4 on the card by the profiler, replay against
    eager bit for bit); kernels 1 and 1b alone at (256, 50280) and (256,
    32001) against their plain versions and timed beside their bounds;
    ``run_async`` on Mamba2-130M at full width on ``scan`` and ``loop``, bit
    for bit; ``launch.train --arch mamba2-130m --reduced`` central and
    async;
13c. single-batch serving (``lm_serve``): ``launch.serve`` without
    ``--continuous`` on Hymba-1.5B at full width (prefill and decode ms,
    the decode one CUDA graph replayed a step); its decode steps in
    ``_Exact``, each replay against the eager step on copies, 0.0 apart,
    ``generate``'s tokens equal to the eager steps', a replayed step
    timed and traced;
    the ring decode and the unrolled window-sliced decode against the
    uniform decode past the window: tokens equal, logits within
    1e-3 * (1 + |uniform|), and the serve steps' tokens equal;
13d. the rest of the LM stack (``lm_families``): the seven other configs
    reduced, card against CPU; then at their configs' widths, one model
    at a time: h2o-danube-3-4b (24 layers, head dim 120) and
    llama4-scout-17b-a16e (4 of 48 layers, top-1 MoE with capacity)
    scored and served through the continuous batcher (traced: its
    ticks' kernels on the card), grok-1-314b (2 of
    64 layers, top-2 MoE) scored, paligemma-3b (18 layers, the patch
    prefix, one kv head) scored, decoded through the extent kernel and
    served by ``serve.py``, seamless-m4t-large-v2 (24 + 24 layers)
    served by ``serve.py``: kernels against eager (logits 1e-3 (1 +
    |ref|), losses 1e-4), the kernel decode's greedy tokens against the
    eager decode fed the same tokens, each model's time and peak GB; the
    ``kernels`` rows of phases 7 and 10 at these shapes take their
    launches from here;
13e. the LM's ("data", "model") mesh (``lm_mesh``), a world of one over
    NCCL (``make_host_mesh``: the (1, 1) mesh), in ``_Exact``: Hymba-1.5B
    at full width, 3 steps of B 2 x S 2048 (bf16 compute, remat) through
    ``jit_train_step`` against ``make_train_step(mesh=None)``, losses and
    params within ``ENGINE_TOL``, each step's ms and the peak GB; 16
    tokens of ``jit_serve_step`` (B 4, a 2048-position cache, uniform and
    ring; then h2o-danube-3-4b at full width, uniform) against the
    unsharded decode: tokens equal, logits and cache within
    ``ENGINE_TOL``; every step and token of these and of seamless's
    through the steps' CUDA graphs (the first call eager, the second
    captured, the rest replayed), each against the eager body on a copy
    of its inputs within ``ENGINE_TOL`` (tokens equal), one capture a
    step shape, no wrapper launch in a replay (the ``graphs`` line: ms
    eager and replayed, the graphs' pool); the scoring forward under
    ``act_pspec`` through kernels 5 and 6 (32 of each counted and on the
    card by the profiler, the hidden and the loss equal to the forward
    without a mesh; the counts go to those kernels' rows); llama4-scout's
    first 4 layers scored with ``moe_ctx`` equal to the local path; the
    sharded train step on five reduced configs, card against the CPU's
    gloo mesh within 1e-5 relative. The phase must take <= 90 s; it frees its
    memory and the process group at its end;
13f. the roofline of three paths (``roofline``), each counted eagerly by
    ``repro_torch.roofline`` (a ``Counter`` over one call; the hand
    kernels recording their analytic models) and timed as it runs: the
    main path's KD step at its clips and at the paper's 8x112x112 (timed
    inside a replayed epoch of 8), Hymba-1.5B's scoring forward (B 2 x S
    2048, kernels 5 and 6), a replayed Hymba-1.5B decode tick (kernels 2,
    3 and 4); each line the flops by class, bytes, compute / memory
    terms, the dominant one, the roofline step time, the measured ms,
    ``mfu`` and the share of the roofline in the measured time; then the
    pod dry run of Hymba-1.5B's train_4k (``python -m
    repro_torch.launch.dryrun``) in a subprocess under a time limit, its
    row printed. Every kernel row's ``bound_ms`` comes from the same
    models (``roofline.analysis``, ``_bound``);
14. Table II's analytic sync-vs-async model on both Jetson fleets (host
    math): the reduction must reach 35%.

Every trace opens with a pause and launches of its own, which the
profiler may lose in place of the traced calls' first launches, and
counts only the device events that the traced calls launched; a kernel
timed alone must show one kernel a call (the SSD scan its three) with
none of its launches lost.

Prints the card's line first, and at the end one ``{"kernels": [...]}``
line, the card's line again, and last ``{"ok": true, "device": {...}}``.
Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

TOL = 1e-4          # |kernel - plain| <= TOL * (1 + |plain|)
KERNEL_SOURCES = ("kd_loss", "decode_attend", "ssd_decode", "swa_attention",
                  "ssd_scan")


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _bound(cost) -> dict:
    """``bound_ms`` and ``bound_by`` of one kernel call whose work is
    ``cost`` ((flops by class, bytes): ``repro_torch.roofline.analysis``'s
    model of that kernel), on the H100's figures (``roofline.HW``)."""
    from repro_torch.roofline import HW
    s, by = HW().bound_s(*cost)
    return {"bound_ms": s * 1e3, "bound_by": by}


def _cuda_ms(fn, iters: int = 200, warmup: int = 20) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def _kd_inputs(R, V, dtype, seed=0):
    import torch
    g = torch.Generator().manual_seed(seed)
    s = torch.randn(R, V, generator=g).to("cuda", dtype)
    t = torch.randn(R, V, generator=g).to("cuda", dtype)
    lab = torch.randint(0, V, (R,), generator=g, dtype=torch.int32).cuda()
    return s, t, lab


def _max_err(got, want):
    """Max |got - want| and whether it is within TOL * (1 + |want|)."""
    diff = (got.float() - want.float()).abs()
    ok = bool((diff <= TOL * (1.0 + want.float().abs())).all())
    return float(diff.max()), ok


def _bwd_err(got, want, bf16: bool) -> tuple:
    """Max |got - want| and whether it is within TOL * (1 + |want|), plus,
    for bf16 gradients, one bf16 step (2^-7 |want|): the kernel and the
    plain version round nearly equal f32 values to bf16."""
    want = want.float()
    diff = (got.float() - want).abs()
    lim = TOL * (1.0 + want.abs()) + (2.0 ** -7 if bf16 else 0.0) * want.abs()
    return float(diff.max()), bool((diff <= lim).all())


def phase_launch_floor() -> float:
    """Device time of a one-element ``torch.zeros`` (one fill kernel): a
    yardstick for the launch-bound kernels, used by nothing on any path."""
    import torch
    floor = _profile(lambda: torch.zeros(1, device="cuda"), 50)
    ms = floor.get("device_ms_per_call")
    print(json.dumps({"phase": "launch_floor", "launch_floor_ms": ms,
                      "kernels_per_call": floor.get("kernels_per_step")}))
    return ms


def phase_kernels() -> list:
    """Fused KD loss kernels (forward, backward) vs their plain versions
    on the card, then timed at the main path's shape."""
    import torch
    from repro_torch.core import distill
    from repro_torch.kernels import kd_loss, ref
    worst = 0.0
    for R, V in ((4, 400), (128, 400), (37, 1000), (8, 513)):
        for dtype in (torch.float32, torch.bfloat16):
            s, t, lab = _kd_inputs(R, V, dtype)
            for alpha, temp in ((0.5, 1.0), (0.3, 2.0)):
                got = kd_loss.kd_loss_fused(s, t, lab, alpha, temp)
                torch.cuda.synchronize()
                want = ref.kd_loss_ref(s, t, lab, alpha, temp)
                err, ok = _max_err(got, want)
                worst = max(worst, err)
                if not ok:
                    raise AssertionError(
                        f"kd_loss R={R} V={V} {dtype} alpha={alpha} T={temp}:"
                        f" max abs err {err}")

    # masked rows: NaN / Inf / huge garbage gives exactly 0.0 and leaves
    # the live rows bit-identical to a run without them
    s, t, lab = _kd_inputs(8, 400, torch.float32, seed=1)
    clean = kd_loss.kd_loss_fused(s, t, lab, 0.5)
    garbage = torch.stack([torch.full((400,), v, device="cuda")
                           for v in (math.nan, math.inf, 1e30)])
    valid = torch.cat([torch.ones(8), torch.zeros(3)]).cuda()
    lab_pad = torch.cat([lab, torch.zeros(3, dtype=torch.int32,
                                          device="cuda")])
    padded = kd_loss.kd_loss_fused(torch.cat([s, garbage]),
                                   torch.cat([t, garbage]), lab_pad, 0.5,
                                   valid=valid)
    if not (torch.equal(padded[:8], clean)
            and torch.equal(padded[8:], torch.zeros(3, device="cuda"))):
        raise AssertionError(f"masked rows not exact: {padded.tolist()}")

    # the backward kernel vs its plain version from the forward's saved
    # logsumexp: vector rows, scalar rows (V = 513), one block a row
    # (V = 4096); masked rows of NaN / Inf / 1e30 exactly 0; with and
    # without dt; at (4, 400) also a masked mean's cotangent, one value
    # broadcast with stride 0
    worst_bwd = 0.0
    for R, V, broadcast in ((4, 400, False), (4, 400, True),
                            (37, 1000, False), (8, 513, False),
                            (3, 4096, False)):
        for dtype in (torch.float32, torch.bfloat16):
            s, t, lab = _kd_inputs(R, V, dtype, seed=R + V)
            s[1], t[1], s[2] = math.nan, math.inf, 1e30
            valid = torch.ones(R, device="cuda")
            valid[1:3] = 0.0
            if broadcast:
                g = torch.full((1,), 0.5, device="cuda").expand(R)
            else:
                g = torch.randn(R,
                                generator=torch.Generator().manual_seed(V))
                g = g.cuda()
            lse = torch.empty(R, device="cuda")
            kd_loss._fused_fwd(s, t, lab, 0.3, 2.0, valid, lse)
            want = kd_loss.kd_loss_rows_bwd(s, t, lab, valid, g, 0.3, 2.0)
            for need_dt in (True, False):
                got = kd_loss.kd_loss_fused_bwd(s, t, lab, valid, g, lse, 0.3,
                                                2.0, need_dt=need_dt)
                torch.cuda.synchronize()
                for name, a, b in zip(("ds", "dt"), got, want):
                    if a is None:
                        continue
                    err, ok = _bwd_err(a, b, dtype == torch.bfloat16)
                    worst_bwd = max(worst_bwd, err)
                    if not ok or not torch.equal(a[1:3],
                                                 torch.zeros_like(a[1:3])):
                        raise AssertionError(
                            f"kd_loss_bwd {name} R={R} V={V} {dtype} "
                            f"need_dt={need_dt} broadcast={broadcast}: "
                            f"max abs err {err}")
                if (got[1] is None) == need_dt:
                    raise AssertionError("kd_loss_bwd: dt returned wrongly")

    # the autograd Function (both kernels) vs autograd through the plain
    # version, in f32; then ``distill.kd_loss``'s masked mean through the
    # kernels vs the eager loss (its sum's cotangent has stride 0)
    for R, V in ((4, 400), (37, 1000)):
        s, t, lab = _kd_inputs(R, V, torch.float32, seed=2)
        w = torch.randn(R, generator=torch.Generator().manual_seed(3)).cuda()
        grads = []
        for rows in (kd_loss.kd_loss_rows, ref.kd_loss_ref):
            sp = s.clone().requires_grad_(True)
            tp = t.clone().requires_grad_(True)
            (w * rows(sp, tp, lab, 0.3, temperature=2.0)).sum().backward()
            grads.append((sp.grad, tp.grad))
        for a, b in zip(*grads):
            err, ok = _max_err(a, b)
            worst_bwd = max(worst_bwd, err)
            if not ok:
                raise AssertionError(f"kd_loss backward R={R} V={V}: {err}")
    s, t, lab = _kd_inputs(4, 400, torch.float32, seed=4)
    valid = torch.tensor([1.0, 0.0, 1.0, 1.0], device="cuda")
    grads = []
    for kernel in ("cuda", "eager"):
        sp = s.clone().requires_grad_(True)
        tp = t.clone().requires_grad_(True)
        distill.kd_loss(sp, tp, lab, 0.3, temperature=2.0, kd_kernel=kernel,
                        valid=valid).backward()
        grads.append((sp.grad, tp.grad))
    for a, b in zip(*grads):
        err, ok = _max_err(a, b)
        worst_bwd = max(worst_bwd, err)
        if not ok or not torch.equal(a[1], torch.zeros_like(a[1])):
            raise AssertionError(f"distill.kd_loss masked mean: {err}")

    # time at the main path's shape (R = KD batch 4, V = 400 classes, f32)
    # as the KD step calls them: the forward with no mask, writing the
    # logsumexp; the backward without dt (the teacher runs under no_grad)
    # from a mean's cotangent. ms / plain_ms are device time (profiler);
    # call_ms / plain_call_ms are CUDA events around back-to-back calls,
    # the host launch included.
    R, V = 4, 400
    s, t, lab = _kd_inputs(R, V, torch.float32)
    lse = torch.empty(R, device="cuda")
    g = torch.full((R,), 1.0 / R, device="cuda")
    fwd = _time_kernel(
        lambda: kd_loss._fused_fwd(s, t, lab, 0.5, 1.0, None, lse),
        lambda: ref.kd_loss_ref(s, t, lab, 0.5))
    bwd = _time_kernel(
        lambda: kd_loss.kd_loss_fused_bwd(s, t, lab, None, g, lse, 0.5, 1.0,
                                          need_dt=False),
        lambda: kd_loss.kd_loss_rows_bwd(s, t, lab, None, g, 0.5, 1.0))
    _one_kernel("kd_loss", fwd)
    _one_kernel("kd_loss_bwd", bwd)
    # the bounds from the kernels' models (roofline.analysis.kd_loss_cost,
    # kd_loss_bwd_cost), at the calls timed: lse written, no mask, no dt
    from repro_torch.roofline import analysis
    rows = []
    for name, row, cost, src_line in (
            ("kd_loss", fwd, analysis.kd_loss_cost(R, V),
             "src/repro/kernels/kd_loss.py:119"),
            ("kd_loss_bwd", bwd, analysis.kd_loss_bwd_cost(R, V),
             "src/repro/kernels/kd_loss.py:164 _rows_bwd")):
        rows.append({"name": name, "route": "cuda",
                     "source": "src/repro_torch/kernels/csrc/kd_loss.cu",
                     "replaces": src_line,
                     "max_abs_err": worst if name == "kd_loss" else worst_bwd,
                     **row, "kernel_ms": row["ms"], **_bound(cost),
                     "library_ms": None})
    for row in rows:
        print(json.dumps({"phase": "kd_kernel_time", **row}))
    return rows


def _all_losses(report) -> list:
    out = []
    for st in report["stage1"]["stages"]:
        out += st["losses"]
    out += report["stage2"]["losses"]
    if "scratch" in report:
        out.append(report["scratch"]["final_loss"])
    return out


def _kd_launches() -> dict:
    from repro_torch.kernels import kd_loss
    return {"kd_loss": kd_loss.kd_loss_fused.launches,
            "kd_loss_bwd": kd_loss.kd_loss_fused_bwd.launches}


def _zero_kd_launches() -> None:
    from repro_torch.kernels import kd_loss
    kd_loss.kd_loss_fused.launches = 0
    kd_loss.kd_loss_fused_bwd.launches = 0


def _expect_launches(what: str, got: dict, want: int) -> None:
    """Both KD kernels launched ``want`` times in ``got``: one forward and
    one backward a KD step."""
    if got != {"kd_loss": want, "kd_loss_bwd": want}:
        raise AssertionError(f"{what}: KD kernels launched {got}, "
                             f"expected {want} each")


def _traced_kd(fn) -> tuple:
    """``fn()``'s result and the KD kernels the card ran in it, from the
    profiler's device events: a replayed graph's kernels are listed one
    by one, where the wrappers' counts see only eager launches and
    captures."""
    out, events, _, _ = _trace(fn)
    names = [e.name() for e in events if "kd_loss" in e.name()]
    return out, {"kd_loss": sum("bwd" not in n for n in names),
                 "kd_loss_bwd": sum("bwd" in n for n in names)}


class _Exact:
    """TF32 off for cuDNN and cuBLAS and cuDNN's deterministic algorithms
    inside the block, PyTorch's defaults (cuDNN TF32 on, cuBLAS off,
    cuDNN free to pick) after it. A run repeated on the card in the block
    gives the same bits; these switches enter each graph's signature, so
    a block captures graphs of its own."""

    def __enter__(self):
        import torch
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.deterministic = True

    def __exit__(self, *exc):
        import torch
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.deterministic = False


def _drop_stage1_engines() -> None:
    """Forget the memoized KD and teacher-pretrain engines (and so their
    graphs): the next pipeline's stage 1 runs on fresh ones."""
    from repro_torch.core import fed_engine
    for key in [k for k in fed_engine._ENGINE_CACHE
                if k[0] in ("distill", "scratch")]:
        del fed_engine._ENGINE_CACHE[key]


def _pipeline_card_vs_cpu(mode: str, **extra) -> list:
    """The reduced pipeline in ``mode`` on the card and on the CPU, with
    the stage-1 params of each run against the CPU's; for ``sync`` once
    more on the card with the stage-1 engines dropped first (a fresh
    engine runs its first epoch eagerly), and stage 2 alone on the card
    from the CPU's stage-1 params. Returns the stage-1 params of the
    card's first run and of the CPU's."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import pipeline
    from repro_torch.data import make_dataset_for
    from repro_torch.types import FedConfig
    s1: list = []      # the stage-1 params of each pipeline run, on the CPU

    def keep(params):
        s1.append({k: v.detach().cpu().clone() for k, v in params.items()})
    kw = dict(reduced=True, mode=mode, clients=2, epochs=2, batch=2,
              kd_steps=4, teacher_steps=2, seed=0, engine="scan",
              on_stage1=keep, **extra)
    fresh = {}
    with _Exact():
        (gpu, gp), ran = _traced_kd(lambda: pipeline.run_pipeline(
            device="cuda", **kw))
        _expect_launches(f"reduced {mode} pipeline on the card", ran,
                         kw["kd_steps"])
        _zero_kd_launches()
        cpu, cp = pipeline.run_pipeline(device="cpu", **kw)
        _expect_launches(f"reduced {mode} pipeline on the CPU",
                         _kd_launches(), 0)
        (_, lp), ran_loop = _traced_kd(lambda: pipeline.run_pipeline(
            device="cuda", **{**kw, "engine": "loop"}))
        _expect_launches(f"reduced {mode} pipeline on the card, loop",
                         ran_loop, kw["kd_steps"])
        if mode == "sync":
            _drop_stage1_engines()
            _zero_kd_launches()
            (_, fp), ran_fresh = _traced_kd(lambda: pipeline.run_pipeline(
                device="cuda", **kw))
            _expect_launches(f"reduced {mode} pipeline on the card, fresh "
                             "stage-1 engines", ran_fresh, kw["kd_steps"])
            fresh["kd_host_launches_fresh_engines"] = _kd_launches()
            fresh["param_rel_err_fresh_stage1_engines"] = _rel_err(
                {k: v.cpu() for k, v in fp.items()}, cp)
            cfg = get_config("resnet3d-18").reduced()
            fed = FedConfig(num_clients=kw["clients"],
                            global_epochs=kw["epochs"], seed=kw["seed"])
            ds = make_dataset_for(cfg, small=True, seed=kw["seed"])
            stage2 = {}
            for cudnn in ("deterministic", "free"):
                torch.backends.cudnn.deterministic = cudnn == "deterministic"
                res = pipeline.finetune(
                    {k: v.cuda() for k, v in s1[1].items()}, cfg, fed, ds,
                    kw["batch"], mode, "scan", kw["seed"], "cuda")
                stage2[cudnn] = _rel_err(
                    {k: v.cpu() for k, v in res.params.items()}, cp)
            torch.backends.cudnn.deterministic = True
            fresh["param_rel_err_stage2_alone_from_cpu_stage1"] = stage2
    a, b = _all_losses(gpu), _all_losses(cpu)
    if len(a) != len(b) or not all(
            math.isclose(x, y, rel_tol=1e-3) for x, y in zip(a, b)):
        raise AssertionError(f"{mode}: card vs CPU losses differ:\n{a}\n{b}")
    if gpu["stage2"]["virtual_wall_s"] != cpu["stage2"]["virtual_wall_s"]:
        raise AssertionError(f"{mode}: virtual clocks differ")
    perr = _rel_err({k: v.cpu() for k, v in gp.items()}, cp)
    perr_loop = _rel_err({k: v.cpu() for k, v in lp.items()}, cp)
    if max(perr, perr_loop) > 1e-3:
        raise AssertionError(f"{mode}: card vs CPU params differ: {perr} "
                             f"(card on loop: {perr_loop})")
    stage1 = {"card": _rel_err(s1[0], s1[1]),
              "card_on_loop": _rel_err(s1[2], s1[1])}
    if mode == "sync":
        stage1["card_fresh_engines"] = _rel_err(s1[3], s1[1])
        stage1["fresh_vs_shared_on_card"] = _rel_err(s1[3], s1[0])
    print(json.dumps({"phase": "cpu_vs_card", "mode": mode,
                      "engine": kw["engine"], **extra,
                      "losses_card": a, "losses_cpu": b,
                      "param_rel_err": perr,
                      "param_rel_err_card_on_loop": perr_loop,
                      "stage1_param_rel_err": stage1, **fresh,
                      "kd_kernels_ran_on_card": ran,
                      "virtual_wall_s": gpu["stage2"]["virtual_wall_s"]}))
    return [s1[0], s1[1]]


def phase_cpu_vs_card():
    """Phase 4: async, then sync with the scratch baseline; then the
    stage-1 params of the async run's card (its KD epoch the engine's
    first, eager) against the sync run's (a replay), card against card."""
    a_card, a_cpu = _pipeline_card_vs_cpu("async")
    s_card, s_cpu = _pipeline_card_vs_cpu("sync", compare_scratch=True)
    print(json.dumps({"phase": "cpu_vs_card_stage1",
                      "eager_vs_replay_on_card": _rel_err(s_card, a_card),
                      "cpu_async_vs_cpu_sync": _rel_err(s_cpu, a_cpu)}))


# scan vs loop, replay vs eager, vmap vs sequential clients on the card,
# in an ``_Exact`` block on both sides: |d| <= tol * (1 + |ref|). There a
# computation repeated on the card gives the same bits (``spread``), and
# two orders of the same sums differ by an ulp or so.
ENGINE_TOL = 1e-6
KD_STEPS = 8        # the full-width pipeline's, one KD epoch


def _full_width_pipeline(what: str, traced: bool = False, **kw) -> tuple:
    """ResNet3D-34 -> 18 (400 classes), 2 teacher and 8 KD steps, then
    four Jetsons: the report, the KD kernels' host launches (the wrappers'
    counts from zero just before, read just after: eager launches and
    captures), with ``traced`` the KD kernels the card ran
    (``_traced_kd``, else None), and the fine-tuned params."""
    from repro_torch.launch.pipeline import run_pipeline

    def run():
        return run_pipeline(arch="resnet3d-18", teacher="resnet3d-34",
                            reduced=False, clients=4, batch=4,
                            kd_steps=KD_STEPS, teacher_steps=2,
                            device="cuda", **kw)
    _zero_kd_launches()
    (report, params), ran = _traced_kd(run) if traced else (run(), None)
    host = _kd_launches()
    losses = _all_losses(report)
    if not losses or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{what}: non-finite losses: {losses}")
    if ran is not None:
        _expect_launches(what, ran, KD_STEPS)
    return report, host, ran, params


def phase_full_width(kernels: list) -> dict:
    """The main path at full width: async (4 global epochs) on ``scan``,
    the first run of its engines in this process, so its KD epoch runs
    eagerly and the wrappers' counts are the card's launches; then
    ``loop``, ``scan`` again (the graphs of signatures seen twice are
    captured) and ``scan`` a third time, traced (every KD launch a replay:
    none from the host, 8 of each on the card); then ``loop`` and
    ``scan`` in an ``_Exact`` block for their comparison; then the sync
    baseline with the scratch run beside it, traced, and async again,
    both at 8 global epochs (two sync rounds) for the virtual clocks'
    comparison."""
    report, launches, _, _ = _full_width_pipeline(
        "full-width async pipeline", mode="async", epochs=4)
    _expect_launches("full-width async pipeline, first run", launches,
                     KD_STEPS)
    for k in kernels:
        k["launches"] = launches[k["name"]]
        k["launches_by_path"] = {"async_pipeline": launches[k["name"]]}
    print(json.dumps({"phase": "full_width", "report": report}))
    loop, loop_host, _, _ = _full_width_pipeline(
        "full-width async pipeline on loop", mode="async", epochs=4,
        engine="loop")
    second, second_host, _, _ = _full_width_pipeline(
        "full-width async pipeline on scan, second run", mode="async",
        epochs=4)
    third, third_host, third_ran, _ = _full_width_pipeline(
        "full-width async pipeline on scan, replayed", traced=True,
        mode="async", epochs=4)
    _expect_launches("full-width async pipeline, replayed: host launches",
                     third_host, 0)
    for k in kernels:
        k["launches_by_path"]["async_pipeline_replayed"] = {
            "host": third_host[k["name"]], "card": third_ran[k["name"]]}
    with _Exact():
        loop_x, _, _, loop_params = _full_width_pipeline(
            "full-width async pipeline on loop, exact", mode="async",
            epochs=4, engine="loop")
        scan_x, _, _, params = _full_width_pipeline(
            "full-width async pipeline on scan, exact", mode="async",
            epochs=4)
    clocks = {r["stage2"]["virtual_wall_s"]
              for r in (report, loop, second, third, loop_x, scan_x)}
    if len(clocks) != 1:
        raise AssertionError(f"scan vs loop: virtual clocks differ {clocks}")
    perr = _rel_err(params, loop_params)
    if perr > ENGINE_TOL:
        raise AssertionError(f"scan vs loop params differ: {perr}")
    print(json.dumps({
        "phase": "engines_full_width", "card": _card_line(),
        "virtual_wall_s": report["stage2"]["virtual_wall_s"],
        "param_rel_err_scan_vs_loop_exact": perr, "tol": ENGINE_TOL,
        "real_wall_s": {"scan_first": report["real_wall_s"],
                        "loop": loop["real_wall_s"],
                        "scan_second": second["real_wall_s"],
                        "loop_exact": loop_x["real_wall_s"],
                        "scan_exact": scan_x["real_wall_s"]},
        "stage1_wall_s": {
            name: r["stage1"]["stages"][0]["wall_s"] for name, r in (
                ("scan_first", report), ("loop", loop),
                ("scan_second", second))},
        "kd_host_launches": {"scan_first": launches, "loop": loop_host,
                             "scan_second": second_host,
                             "scan_replayed": third_host},
        "kd_kernels_ran_on_card_replayed": third_ran,
        "stage2_losses_exact": {"scan": scan_x["stage2"]["losses"],
                                "loop": loop_x["stage2"]["losses"]}}))
    sync, sync_host, sync_ran, _ = _full_width_pipeline(
        "full-width sync pipeline", traced=True, mode="sync", epochs=8,
        compare_scratch=True)
    async8, _, _, _ = _full_width_pipeline(
        "full-width async pipeline, 8 epochs", mode="async", epochs=8)
    for k in kernels:
        k["launches_by_path"]["sync_pipeline"] = {
            "host": sync_host[k["name"]], "card": sync_ran[k["name"]]}
    v_sync = sync["stage2"]["virtual_wall_s"]
    v_async = async8["stage2"]["virtual_wall_s"]
    print(json.dumps({
        "phase": "full_width_sync", "epochs": 8, "report": sync,
        "virtual_wall_s": {"sync": v_sync, "async": v_async},
        "async_vs_sync_reduction": 1.0 - v_async / v_sync,
        "real_wall_s": {"sync_with_scratch_traced": sync["real_wall_s"],
                        "async": async8["real_wall_s"]},
        "accuracy": {"stage2": sync["stage2"]["accuracy"],
                     "scratch": sync["scratch"]["accuracy"]},
        "kd_host_launches": sync_host, "kd_kernels_ran_on_card": sync_ran}))
    return report


BREAK_EVEN_EPOCHS = (4, 256)


def phase_break_even() -> None:
    """The full-width async pipeline as a user runs it, one pipeline a
    process (``python -m repro_torch.launch.pipeline``), on ``scan`` and
    on ``loop`` at 4 and 256 global epochs, twice each in the order scan,
    loop, loop, scan: each run's ``real_wall_s`` (set-up and stage 1
    included), the virtual clocks equal, each engine's fixed and
    per-epoch cost from its means, and the global epochs at which the two
    engines' lines cross (None when they do not)."""
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    wall, clock = {}, {}
    for epochs in BREAK_EVEN_EPOCHS:
        for engine in ("scan", "loop", "loop", "scan"):
            argv = [sys.executable, "-m", "repro_torch.launch.pipeline",
                    "--epochs", str(epochs), "--engine", engine,
                    "--teacher-steps", "2", "--kd-steps", str(KD_STEPS),
                    "--device", "cuda"]
            out = subprocess.run(argv, env=env, cwd=ROOT, text=True,
                                 capture_output=True, timeout=600)
            if out.returncode:
                raise AssertionError(f"{argv}: exit {out.returncode}\n"
                                     f"{out.stderr[-4000:]}")
            rep = json.loads(out.stdout.strip().splitlines()[-1])
            wall.setdefault(engine, {}).setdefault(epochs, []).append(
                rep["real_wall_s"])
            clock.setdefault(epochs, set()).add(
                rep["stage2"]["virtual_wall_s"])
    if any(len(c) != 1 for c in clock.values()):
        raise AssertionError(f"scan vs loop: virtual clocks differ {clock}")
    lo, hi = BREAK_EVEN_EPOCHS
    mean = {e: {n: sum(v) / len(v) for n, v in w.items()}
            for e, w in wall.items()}
    slope = {e: (m[hi] - m[lo]) / (hi - lo) for e, m in mean.items()}
    icpt = {e: mean[e][lo] - slope[e] * lo for e in mean}
    gain = slope["loop"] - slope["scan"]
    print(json.dumps({
        "phase": "break_even", "card": _card_line(),
        "real_wall_s": wall, "mean_real_wall_s": mean,
        "s_per_global_epoch": slope, "s_fixed": icpt,
        "break_even_global_epochs": ((icpt["scan"] - icpt["loop"]) / gain
                                     if gain > 0 else None)}))


def _train(argv: list) -> dict:
    """``repro_torch.launch.train.main(argv)`` in this process: its output
    kept, its JSON result line returned."""
    import contextlib
    import io
    from repro_torch.launch import train
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = train.main(argv)
    out = buf.getvalue().strip().splitlines()
    if rc != 0:
        raise AssertionError(f"train {argv}: exit {rc}\n{out}")
    return json.loads(out[-1])


def phase_train(kernels: list) -> None:
    """The trainer at full width (ResNet3D-18, 400 classes) on the
    card: central fine-tuning for 8 steps, then sync FedAvg with SCAFFOLD
    on four Jetsons after ``--distill-first`` (16 teacher and 16 KD steps
    from ResNet3D-34), traced; finite losses, the KD kernels' host launches
    counted around each run and, on the traced one, the launches the card
    ran."""
    runs = {"central": ["--mode", "central", "--steps", "8"],
            "sync_distill_first": ["--mode", "sync", "--distill-first",
                                   "--epochs", "8", "--engine", "scan",
                                   "--algorithm", "scaffold"]}
    for name, argv in runs.items():
        _zero_kd_launches()
        if name == "central":
            res, ran = _train(argv + ["--device", "cuda"]), None
            _expect_launches(f"train {name}", _kd_launches(), 0)
            res["step_ms"] = res["wall_s"] / 8 * 1e3
        else:
            res, ran = _traced_kd(lambda: _train(argv + ["--device",
                                                         "cuda"]))
            _expect_launches(f"train {name}", ran, 16)
            for k in kernels:
                if k["name"] in ran:
                    k["launches_by_path"]["train_distill_first"] = {
                        "host": _kd_launches()[k["name"]],
                        "card": ran[k["name"]]}
        if not math.isfinite(res["final_loss"]):
            raise AssertionError(f"train {name}: loss {res['final_loss']}")
        print(json.dumps({"phase": "train", "run": name, "result": res,
                          "kd_host_launches": _kd_launches(),
                          "kd_kernels_ran_on_card": ran}))


def phase_analytic_speedup() -> None:
    """Table II's sync-vs-async model on both Jetson fleets (host math)."""
    from repro_torch.core import fleet, simulator
    out = {name: simulator.analytic_speedup(f, epochs=80, local_epochs=3)
           for name, f in (("hmdb51", fleet.JETSON_FLEET_HMDB51),
                           ("ucf101", fleet.JETSON_FLEET_UCF101))}
    if not all(v["reduction"] >= 0.35 for v in out.values()):
        raise AssertionError(f"Table II's reduction below 35%: {out}")
    print(json.dumps({"phase": "analytic_speedup", **out}))


TRACE_WINDOW = "chip_smoke.traced_calls"
TRACE_PAD = 512         # one-element adds launched before and after the calls
TRACE_PAUSE_S = 0.05
_WORK_APIS = ("LaunchKernel", "LaunchCooperativeKernel", "GraphLaunch",
              "Memcpy", "Memset")


def _trace(fn, steps: int = 1) -> tuple:
    """``steps`` calls of ``fn`` under torch.profiler: the last call's
    result, the device events (kernels, copies) that these calls
    launched, their host wall ms, and ``lost``: how many of the calls'
    launches (``calls``) and of the opening pad's (``pad``) have no
    device event in the trace (nor has a launch made while a stream is
    captured).

    On the H100 the profiler loses the device events of a trace's first
    launches, none in a young process and tens late in this script, and
    now and then every event of a trace's first milliseconds. So each
    trace opens with a pause and ``TRACE_PAD`` launches of its own,
    closes with the same, and keeps only the device events whose launch
    (CUDA correlation id) lies inside the calls' span, marked by a
    ``record_function``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    def pad():
        time.sleep(TRACE_PAUSE_S)
        for _ in range(TRACE_PAD):
            cell.add_(1.0)
        torch.cuda.synchronize()
    cell = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        pad()
        with record_function(TRACE_WINDOW):
            t0 = time.perf_counter()
            for _ in range(steps):
                out = fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        pad()
    events = prof.profiler.kineto_results.events()
    span = next(e for e in events if e.name() == TRACE_WINDOW
                and e.device_type() == DeviceType.CPU)
    apis = [e for e in events if e.device_type() == DeviceType.CPU
            and e.name().startswith("cu")]
    inside = {e.correlation_id() for e in apis
              if span.start_ns() <= e.start_ns() <= span.end_ns()}
    on_card = [e for e in events if e.device_type() == DeviceType.CUDA
               and e.name() != TRACE_WINDOW]
    seen = {e.correlation_id() for e in on_card}
    lost = [e for e in apis if e.correlation_id() not in seen
            and any(w in e.name() for w in _WORK_APIS)]
    return (out, [e for e in on_card if e.correlation_id() in inside],
            wall_ms,
            {"calls": sum(e.correlation_id() in inside for e in lost),
             "pad": sum(e.start_ns() < span.start_ns() for e in lost)})


def _profile(fn, steps: int = 3, top: int = 6, match: tuple = ()) -> dict:
    """Device time by kernel over ``steps`` calls of ``fn`` (``_trace``).
    Only device-side events (kernels, copies) are summed: an operator's
    own row repeats its kernels' time. The profiler's overhead lengthens
    the wall time, so the busy share is a floor. Kernels whose name holds
    one of ``match`` are listed with their calls a step under
    ``matched``. ``dropped_launches`` counts the calls' launches that the
    trace lost all the same, ``pad_launches_lost`` the opening pad's
    that it lost in their place; for ``steps`` identical calls
    ``device_ms_per_call`` is each kernel's mean time times its launches
    a call, which a lost event leaves unbiased."""
    _, events, wall_ms, lost = _trace(fn, steps)
    by_name = {}
    for e in events:
        ms, count = by_name.get(e.name(), (0.0, 0))
        by_name[e.name()] = (ms + e.duration_ns() / 1e6, count + 1)
    rows = sorted(((ms, k, c) for k, (ms, c) in by_name.items()),
                  reverse=True)
    if not rows:
        return {"device_time": "not measured (no device events traced)",
                "dropped_launches": lost["calls"],
                "pad_launches_lost": lost["pad"]}
    busy_ms = sum(r[0] for r in rows)
    matched = {k[:90]: c / steps for _, k, c in rows
               if any(m in k for m in match)}
    return {"wall_ms_per_step": wall_ms / steps,
            "device_ms_per_step": busy_ms / steps,
            "device_ms_per_call": sum(d / c * max(1, round(c / steps))
                                      for d, _, c in rows),
            "device_busy_share": busy_ms / wall_ms,
            "kernels_per_step": sum(r[2] for r in rows) / steps,
            "distinct_kernels": len(rows),
            "dropped_launches": lost["calls"],
            "pad_launches_lost": lost["pad"],
            "top": [{"kernel": k[:90], "ms_per_step": d / steps,
                     "calls_per_step": c / steps} for d, k, c in rows[:top]],
            **({"matched": matched} if match else {})}


def phase_step_times():
    """One KD step (ResNet3D-34 -> 18, full width) and one client step at
    the main path's clip shape (4x16x16, batch 4) and at the paper's
    (8x112x112, batch 8), TF32 at PyTorch's default."""
    import torch
    from repro_torch.configs import RESNET18, RESNET34
    from repro_torch.core import distill, fedasync
    from repro_torch.data import SyntheticActionDataset
    from repro_torch.models import registry
    from repro_torch.optim import trainable_mask
    from repro_torch.types import DistillConfig, FedConfig
    gen = torch.Generator().manual_seed(0)
    teacher = registry.init_params(gen, RESNET34, "cuda")
    student = registry.init_params(gen, RESNET18, "cuda")
    engine = distill.DistillEngine(RESNET34, RESNET18, DistillConfig(lr=0.01))
    kd_state = engine.opt.init(student)
    fed = FedConfig()
    step, opt = fedasync.make_client_step(RESNET18, fed)
    fed_state = opt.init(student)
    mask = trainable_mask(student, fed.trainable)
    for name, frames, size, bsz in (("main_path", 4, 16, 4),
                                    ("paper_clip", 8, 112, 8)):
        ds = SyntheticActionDataset(num_classes=400, samples_per_class=1,
                                    frames=frames, size=size, seed=0)
        batch = next(ds.batches(bsz, 1, seed=0))
        fns = {"kd_step": lambda: engine.step(teacher, student, kd_state,
                                              batch),
               "client_step": lambda: step(student, fed_state, student,
                                           batch, mask)}
        out = {"phase": "step_times", "shape": name,
               "clips": [bsz, frames, size, size, 3],
               "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
               "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32}
        torch.cuda.reset_peak_memory_stats()
        for key, fn in fns.items():
            _zero_kd_launches()
            fn()                               # warm-up (cuDNN autotune)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(5):
                fn()
            torch.cuda.synchronize()
            out[key + "_ms"] = (time.perf_counter() - t0) / 5 * 1e3
            out[key + "_profile"] = _profile(fn, 3)
            out[key + "_kernels"] = out[key + "_profile"].get(
                "kernels_per_step")
            # 1 warm-up + 5 timed + 3 profiled calls; a KD step launches
            # the forward and the backward kernel once each, a client step
            # never
            _expect_launches(f"{name} {key}", _kd_launches(),
                             9 if key == "kd_step" else 0)
        out["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        print(json.dumps(out))


def _wall_ms(fn, calls: int = 5) -> float:
    """Host milliseconds a call over ``calls`` back-to-back calls, the card
    synchronised before and after."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e3


def _rel_err(got: dict, want: dict) -> float:
    """max |got - want| / (1 + |want|) over every leaf, by key."""
    return max(float(((got[k] - want[k]).abs() / (1.0 + want[k].abs())).max())
               for k in want)


def _kd_in_profile(prof: dict) -> dict:
    """The KD forward and backward kernels a call, from the profiler's
    device events."""
    matched = prof.get("matched", {})
    return {"kd_loss": sum(c for k, c in matched.items() if "bwd" not in k),
            "kd_loss_bwd": sum(c for k, c in matched.items() if "bwd" in k)}


def _spread(fn, calls: int = 4) -> float:
    """The largest ``_rel_err`` of ``fn()``'s params over ``calls`` calls
    against its first: 0 when the card repeats the computation bit for
    bit."""
    first = fn()[0]
    return max(_rel_err(fn()[0], first) for _ in range(calls - 1))


def phase_captured(kernels: list) -> None:
    """At the main path's clip shape (4x16x16, batch 4): one KD epoch of 8
    steps (ResNet3D-34 -> 18, 400 classes) in a fresh engine, its first
    call eager, its second captured and replayed, later ones replayed,
    each against the epoch run eagerly step by step; one sync round of 4
    clients x 3 steps on ``scan`` against ``loop``; the round's clients
    under ``torch.func.vmap`` against one after another (the engine's
    path), each one graph, and the first eager calls of each
    (torch.func's first use in the process among them). The comparisons
    in an ``_Exact`` block, with each computation's spread over repeated
    calls there and with cuDNN free to pick its algorithms (TF32 still
    off); the timings
    (host clock, 5 calls of replays) and traces (device ms, busy share,
    kernels) at PyTorch's default switches. The KD kernels: the wrappers'
    host launches in the eager call, the capture and the replays, and the
    profiler's device events of a replay."""
    import numpy as np
    import torch
    from repro_torch.configs import RESNET18, RESNET34
    from repro_torch.core import algorithms, distill, fed_engine, fedavg
    from repro_torch.core.compile_cache import GraphCache
    from repro_torch.data import SyntheticActionDataset, stack_batches
    from repro_torch.device import batch_to
    from repro_torch.models import registry
    from repro_torch.optim import trainable_mask
    from repro_torch.types import DistillConfig, FedConfig
    gen = torch.Generator().manual_seed(0)
    teacher = registry.init_params(gen, RESNET34, "cuda")
    student = registry.init_params(gen, RESNET18, "cuda")
    ds = SyntheticActionDataset(num_classes=400, samples_per_class=1,
                                frames=4, size=16, seed=0)
    H = 8
    stacked = stack_batches(ds.batches(4, H, seed=1))
    engine = distill.DistillEngine(
        RESNET34, RESNET18,
        DistillConfig(lr=0.01, chain=(RESNET34.name, RESNET18.name)))
    state = engine.opt.init(student)
    on_card = batch_to(stacked, "cuda")

    def replay():
        return engine.epoch(teacher, student, state, stacked)

    def eager():
        return engine._epoch(teacher, student, state["mom"], on_card)

    def host_launches(fn):
        _zero_kd_launches()
        out = fn()
        return out, _kd_launches()
    with _Exact():
        want = eager()
        runs = [host_launches(replay) for _ in range(3)]
        kd_err = max(_rel_err(out[0], want[0]) for out, _ in runs)
        kd_spread = _spread(eager)
    host = {"eager": runs[0][1], "capture": runs[1][1], "replay": runs[2][1]}
    if kd_err > ENGINE_TOL:
        raise AssertionError(f"replayed KD epoch vs eager: {kd_err}")
    for what, n in (("eager", H), ("capture", H), ("replay", 0)):
        _expect_launches(f"KD epoch's {what} call: host launches",
                         host[what], n)
    with _Exact():
        torch.backends.cudnn.deterministic = False
        kd_spread_free = _spread(eager)
    replay(), replay()                 # eager, then captured, by default
    _zero_kd_launches()
    kd = {"replay_ms_per_epoch": _wall_ms(replay)}
    _expect_launches("5 replayed KD epochs: host launches", _kd_launches(),
                     0)
    kd["eager_ms_per_epoch"] = _wall_ms(eager)
    kd["replay_profile"] = _profile(replay, 3, match=("kd_loss",))
    kd["eager_profile"] = _profile(eager, 3, match=("kd_loss",))
    traced = _kd_in_profile(kd["replay_profile"])
    _expect_launches("KD kernels the card ran a replay",
                     {k: round(v) for k, v in traced.items()}, H)
    kd.update(kd_step_ms_captured=kd["replay_ms_per_epoch"] / H,
              kd_step_ms_eager=kd["eager_ms_per_epoch"] / H,
              kd_host_launches_exact_block=host,
              kd_kernels_ran_on_card_per_replay=traced,
              max_rel_err_vs_eager=kd_err, spread=kd_spread,
              spread_cudnn_free=kd_spread_free)
    for k in kernels:
        if k["name"] in traced:
            k["launches_per_replayed_epoch"] = {
                "H": H, "host_at_capture": host["capture"][k["name"]],
                "host_a_replay": host["replay"][k["name"]],
                "card_a_replay": traced[k["name"]]}

    fed = FedConfig()
    rnd = fed_engine.make_sync_round(RESNET18, fed)
    lists = [list(ds.batches(4, fed.local_iters_max, seed=10 + c))
             for c in range(4)]

    def scan():
        return fedavg.fedavg_round(student, [iter(b) for b in lists],
                                   RESNET18, fed, engine=rnd)

    def loop():
        return fedavg.fedavg_round_loop(student, [iter(b) for b in lists],
                                        RESNET18, fed)
    with _Exact():
        want = loop()[0]
        rnd_err = max(_rel_err(scan()[0], want) for _ in range(3))
    if rnd_err > ENGINE_TOL:
        raise AssertionError(f"scan vs loop round: {rnd_err}")
    scan(), scan()                     # captured by default if not yet
    round_ = {"clients": 4, "H": fed.local_iters_max,
              "scan_ms": _wall_ms(scan), "loop_ms": _wall_ms(loop),
              "scan_profile": _profile(scan, 3),
              "loop_profile": _profile(loop, 3),
              "max_rel_err_scan_vs_loop": rnd_err}

    # the engine's clients, one after another in one graph, against the
    # same clients under torch.func.vmap (grouped convolutions), written
    # here for the comparison only
    run = rnd.client
    padded = {k: np.stack([np.stack([b[k] for b in bl]) for bl in lists])
              for k in lists[0][0]}
    iters = np.full(4, fed.local_iters_max, np.int32)
    mask = trainable_mask(student, fed.trainable)
    vm_cache = GraphCache()

    def vmapped(params, stacked, mask, iters):
        from torch.func import grad_and_value, vmap

        def vg(p, b):
            grads, loss = grad_and_value(lambda q: run._task_loss(q, b))(p)
            return loss, grads
        ctx = algorithms.StepCtx(vg, run.opt, params, mask, (), fed)

        def one(s, n):
            w, _, losses = run._scan(ctx, params, s, n)
            return w, losses
        return vmap(one)(stacked, iters)

    def sequential():
        return run.run_batch(student, padded, iters, mask=mask)

    def grouped():
        return vm_cache.call("vmap", vmapped, (student, padded, mask, iters))
    # a process's first torch.func call loads torch._dynamo
    eager_args = (student, batch_to(padded, "cuda"), mask,
                  torch.as_tensor(iters, device="cuda"))
    dynamo_before = "torch._dynamo" in sys.modules
    first_ms = {"vmap": _wall_ms(lambda: vmapped(*eager_args), 1)}
    first_ms["vmap_again"] = _wall_ms(lambda: vmapped(*eager_args), 1)
    first_ms["sequential"] = _wall_ms(lambda: run._clients(*eager_args), 1)
    with _Exact():
        seq = [sequential() for _ in range(3)]
        vm = [grouped() for _ in range(3)]
        vm_err = max(_rel_err(v[0], q[0]) for v, q in zip(vm, seq))
        spreads = {"sequential": _spread(sequential),
                   "vmap": _spread(grouped)}
        torch.backends.cudnn.deterministic = False
        spreads_free = {"sequential": _spread(sequential),
                        "vmap": _spread(grouped)}
    if vm_err > ENGINE_TOL or not all(bool(torch.isfinite(v[1]).all())
                                      for v in vm):
        raise AssertionError(f"vmap vs sequential clients: {vm_err}")
    for fn in (sequential, grouped, sequential, grouped):
        fn()                           # captured by default if not yet
    batching = {"sequential_ms": _wall_ms(sequential),
                "vmap_ms": _wall_ms(grouped),
                "sequential_profile": _profile(sequential, 3),
                "vmap_profile": _profile(grouped, 3),
                "eager_call_ms": first_ms,
                "torch_dynamo_loaded_before": dynamo_before,
                "max_rel_err_vmap_vs_sequential": vm_err,
                "spread": spreads, "spread_cudnn_free": spreads_free}
    print(json.dumps({"phase": "captured", "card": _card_line(),
                      "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
                      "errors_in_exact_block": True, "tol": ENGINE_TOL,
                      "kd_epoch": kd, "sync_round": round_,
                      "client_batching": batching}))


def phase_engines() -> None:
    """Fresh engines at the main path's shapes, so that every count is
    this phase's own: the async kickoff's burst (4 clients padded to
    H_max) and a lone dispatch (1 client padded to H_max), each over three
    H^k draws, a sync round and the 8-step KD epoch three times each: one
    program shape and one capture each, whatever the H^k; then one more
    call of each under ``torch.cuda.set_sync_debug_mode("error")``: a
    replay, with no new capture and no host sync. The main path's own
    (memoized) engines' shapes and captures after phases 5 and 6 are
    printed beside."""
    import numpy as np
    import torch
    from repro_torch.configs import RESNET18, RESNET34
    from repro_torch.core import distill, fed_engine
    from repro_torch.data import make_dataset_for, stack_batches
    from repro_torch.models import registry
    from repro_torch.types import DistillConfig, FedConfig
    fed = FedConfig()
    dcfg = DistillConfig(lr=0.01, chain=(RESNET34.name, RESNET18.name))
    client = fed_engine.ClientRun(RESNET18, fed)
    sync = fed_engine.SyncRound(RESNET18, fed)
    kd = distill.DistillEngine(RESNET34, RESNET18, dcfg)
    gen = torch.Generator().manual_seed(1)
    student = registry.init_params(gen, RESNET18, "cuda")
    teacher = registry.init_params(gen, RESNET34, "cuda")
    ds = make_dataset_for(RESNET18, small=True, seed=0)
    stacks = [stack_batches(ds.batches(4, fed.local_iters_max, seed=k))
              for k in range(4)]
    H = fed.local_iters_max
    burst, _ = fed_engine.pad_client_batches(stacks)
    lone, _ = fed_engine.pad_client_batches(stacks[:1])
    kd_stack = stack_batches(make_dataset_for(RESNET18, small=False)
                             .batches(4, 8, seed=2))
    draws = [np.asarray(d, np.int32) for d in ([3, 1, 2, 3], [1, 1, 2, 3],
                                               [2, 3, 3, 1])]
    calls = {
        "burst": lambda i: client.run_batch(student, burst, draws[i]),
        "lone": lambda i: client.run_batch(
            student, lone, draws[i][:1] % H + 1),
        "sync_round": lambda i: sync(student, stacks),
        "kd_epoch": lambda i: kd.epoch(teacher, student,
                                       kd.opt.init(student), kd_stack)}
    for fn in calls.values():
        for i in range(3):
            fn(i)

    def counts():
        return {"client_run": [client.num_compiled,
                               client._graphs.num_captured],
                "sync_round": [sync.num_compiled, sync._graphs.num_captured],
                "kd_epoch": [kd.num_compiled, kd._graphs.num_captured]}
    got = counts()
    want = {"client_run": [2, 2], "sync_round": [1, 1], "kd_epoch": [1, 1]}
    if got != want:
        raise AssertionError(f"[program shapes, captures]: {got}, "
                             f"expected {want}")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for fn in calls.values():
            fn(0)
        torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    if counts() != want:
        raise AssertionError(f"a replay captured anew: {counts()}")
    main = {"client_run": fed_engine.make_client_run(RESNET18, fed),
            "sync_round": fed_engine.make_sync_round(RESNET18, fed),
            "kd_epoch": distill.make_distill_engine(RESNET34, RESNET18,
                                                    dcfg),
            "teacher_pretrain": distill.make_scratch_run(RESNET34, dcfg)}
    print(json.dumps({
        "phase": "engines", "program_shapes_and_captures": got,
        "h_draws": [d.tolist() for d in draws],
        "replayed_without_host_sync": list(calls),
        "main_path_engines": {name: [e.num_compiled, e._graphs.num_captured]
                              for name, e in main.items()}}))


MULTI_COUNTS = (3, 1, 2, 3)     # the ragged round's H^k
MULTI_SIZES = (32, 8, 16, 0)    # its data sizes: client 3 of zero weight


def phase_multi_device(kernels: list) -> None:
    """The sharded and hierarchical sync rounds on the card, a world of
    one over NCCL (``launch.mesh.make_fleet_mesh``: the ``("clients",)``
    mesh and the (1, 1) ``("edge", "clients")`` tree), at the main path's
    full width (ResNet3D-18, 400 classes, 4 clients x 3 steps, batch 4,
    4x16x16 clips), in an ``_Exact`` block: (a) fresh shard, hier and scan
    round engines, an even round and a ragged H^k round with a
    zero-weight client, three calls each (eager, capture, replay), params
    and losses against scan's first call within ``ENGINE_TOL``; each
    engine's replay timed (wall ms, 3 x 5 calls in turns, their spread)
    and traced (device ms); (b) program shapes and captures, and a replay
    of each under ``torch.cuda.set_sync_debug_mode("error")``; (c)
    ``run_sync`` on shard and hier against scan, 2 rounds, FedProx and
    SCAFFOLD: clocks equal, params within ``ENGINE_TOL``; (d)
    ``launch.train --mode sync --engine hier --distill-first`` at full
    width, traced: kernels 1 and 1b counted on the host and run on the
    card 16 times each."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.configs import RESNET18
    from repro_torch.core import fed_engine, fedavg, simulator
    from repro_torch.data import make_dataset_for, stack_batches
    from repro_torch.launch.mesh import destroy_world, make_fleet_mesh
    from repro_torch.models import registry
    from repro_torch.types import FedConfig
    t_phase = time.perf_counter()
    fed = FedConfig()
    meshes = {"shard": make_fleet_mesh(device="cuda"),
              "hier": make_fleet_mesh(edges=0, device="cuda")}
    student = registry.init_params(torch.Generator().manual_seed(3),
                                   RESNET18, "cuda")
    ds = make_dataset_for(RESNET18, small=True, seed=0)
    H = fed.local_iters_max
    rounds = {"even": ([H] * 4, None), "ragged": (MULTI_COUNTS, MULTI_SIZES)}
    data = {name: [list(ds.batches(4, h, seed=30 + c))
                   for c, h in enumerate(counts)]
            for name, (counts, _) in rounds.items()}
    with _Exact():
        engines = {"scan": fed_engine.SyncRound(RESNET18, fed)}
        engines.update({name: fed_engine.ShardedSyncRound(RESNET18, fed, m)
                        for name, m in meshes.items()})

        def call(engine, name):
            return lambda: fedavg.fedavg_round(
                student, [iter(b) for b in data[name]], RESNET18, fed,
                engine=engines[engine], data_sizes=rounds[name][1])
        want = {name: call("scan", name)() for name in rounds}
        errs = {}
        for engine in engines:
            for name in rounds:
                for _ in range(3):         # eager, capture, replay
                    got, losses = call(engine, name)()
                    flat = np.concatenate(losses)
                    ref = np.concatenate(want[name][1])
                    err = max(_rel_err(got, want[name][0]), float(
                        np.max(np.abs(flat - ref) / (1 + np.abs(ref)))))
                    errs[f"{engine}_{name}"] = max(
                        errs.get(f"{engine}_{name}", 0.0), err)
        if max(errs.values()) > ENGINE_TOL:
            raise AssertionError(f"shard / hier vs scan: {errs}")
        counts = {e: [r.num_compiled, r._graphs.num_captured]
                  for e, r in engines.items()}
        want_counts = {e: [2, 2] for e in engines}
        if counts != want_counts:
            raise AssertionError(f"[program shapes, captures]: {counts}, "
                                 f"expected {want_counts}")
        stacked, iters = fed_engine.pad_client_batches(
            [stack_batches(b) for b in data["ragged"]])
        weights = np.asarray(MULTI_SIZES, np.float32) / np.float32(
            sum(MULTI_SIZES))
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for e in ("shard", "hier"):
                engines[e](student, stacked, weights=weights, iters=iters)
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        if {e: [r.num_compiled, r._graphs.num_captured]
                for e, r in engines.items()} != want_counts:
            raise AssertionError("a replay captured anew")
        walls = {e: [] for e in engines}
        for e in ("scan", "shard", "hier", "hier", "shard", "scan"):
            walls[e].append(_wall_ms(call(e, "even")))
        timing = {e: {"wall_ms": float(np.median(w)),
                      "wall_ms_spread": max(w) - min(w),
                      "profile": _profile(call(e, "even"), 3)}
                  for e, w in walls.items()}

        sync = {}
        fed8 = FedConfig(global_epochs=8)
        for alg in (None, "scaffold"):
            out = {e: simulator.run_sync(student, RESNET18, fed8,
                                         _jetson_fleet(RESNET18, fed8, 4),
                                         engine=e, algorithm=alg,
                                         device="cuda")
                   for e in ("scan", "shard", "hier")}
            name = alg or "fedprox"
            for e in ("shard", "hier"):
                err = _rel_err(out[e].params, out["scan"].params)
                if (out[e].wall_clock_s != out["scan"].wall_clock_s
                        or err > ENGINE_TOL):
                    raise AssertionError(
                        f"run_sync {e} {name}: clock {out[e].wall_clock_s} "
                        f"vs {out['scan'].wall_clock_s}, params {err}")
                sync[f"{e}_{name}"] = {"virtual_wall_s": out[e].wall_clock_s,
                                       "rounds": len(out[e].history),
                                       "param_rel_err_vs_scan": err}

    argv = ["--mode", "sync", "--engine", "hier", "--distill-first",
            "--epochs", "8", "--device", "cuda"]
    _zero_kd_launches()
    res, ran = _traced_kd(lambda: _train(argv))
    host = _kd_launches()
    _expect_launches("train --engine hier, counted", host, 16)
    _expect_launches("train --engine hier, on the card", ran, 16)
    if not math.isfinite(res["final_loss"]):
        raise AssertionError(f"train --engine hier: {res}")
    for k in kernels:
        if k["name"] in ran:
            k["launches_by_path"]["train_sync_hier_distill_first"] = {
                "host": host[k["name"]], "card": ran[k["name"]]}
    print(json.dumps({
        "phase": "multi_device", "card": _card_line(),
        "backend": dist.get_backend(), "world_size": dist.get_world_size(),
        "meshes": {e: [list(m.mesh_dim_names), list(m.shape)]
                   for e, m in meshes.items()},
        "graph_design": ("one graph a round shape, collectives inside"
                         if counts["shard"][1] == counts["shard"][0]
                         else "split around the collectives"),
        "tol": ENGINE_TOL, "max_rel_err_vs_scan": errs,
        "program_shapes_and_captures": counts,
        "replayed_without_host_sync": ["shard", "hier"],
        "round_4x3": timing, "run_sync": sync,
        "train_hier_distill_first": res, "kd_host_launches": host,
        "kd_kernels_ran_on_card": ran,
        "seconds": time.perf_counter() - t_phase}))
    destroy_world()          # the group and the sharded engines on it


# the algorithm layer's runs at full width: (mode, algorithm, compress_bits)
ALG_RUNS = (("async", "scaffold", 0), ("async", "lowrank", 0),
            ("async", None, 8), ("async", None, 4),
            ("sync", "scaffold", 0), ("sync", "lowrank", 0))


def _jetson_fleet(cfg, fed, batch: int, seed: int = 0):
    """The four-Jetson fleet of ``launch/pipeline.py``'s stage 2: each
    client a loader over its iid part of the clients' reduced dataset."""
    from repro_torch.core.fleet import Fleet
    from repro_torch.data import BatchLoader, iid_partition, make_dataset_for
    from repro_torch.launch.train import build_fleet
    ds = make_dataset_for(cfg, small=True, seed=seed)
    parts = iid_partition(max(len(ds), fed.num_clients * 8),
                          fed.num_clients, seed=seed)
    return Fleet.from_lists(build_fleet(fed.num_clients), [
        BatchLoader(ds, batch, steps=fed.local_iters_max, seed=k,
                    indices=parts[k]) for k in range(fed.num_clients)])


def _wire_bytes(shapes: dict, bits: int, cap=None) -> int:
    """One update's wire bytes from its leaves' shapes alone: dense f32,
    or each array's int8 / packed-int4 payload and its 4-byte scale; with
    ``cap`` each matrix leaf (both sides ≥ 4) ships its rank-r factors,
    r = ceil(cap · min side) in f32 arithmetic, clipped to [1, min side]."""
    import numpy as np

    def payload(n):
        if not bits:
            return 4 * n
        return (n if bits == 8 else (n + 1) // 2) + 4
    total = 0
    for shape in shapes.values():
        if cap is not None and len(shape) == 2 and min(shape) >= 4:
            side = min(shape)
            r = max(1, min(side, math.ceil(float(np.float32(cap)) * side)))
            total += payload(shape[0] * r) + payload(r) + payload(r * shape[1])
        else:
            total += payload(math.prod(shape))
    return total


def phase_algorithms() -> None:
    """The federated-algorithm layer at the main path's full width
    (ResNet3D-18, 400 classes, the four Jetsons, batch 4, 4x16x16 clips),
    in an ``_Exact`` block: ``run_async`` with SCAFFOLD, with
    LowRankSubmodel, and with FedProx at ``compress_bits`` 8 and 4 (4
    global epochs), ``run_sync`` with SCAFFOLD and LowRankSubmodel (2
    rounds), each on ``scan`` and ``loop``: virtual clocks equal, params
    within ``ENGINE_TOL``, each run's wall time. Fresh engines for each
    stateful algorithm, over three H^k draws and the fleet's four
    capacities: program shapes and captures per round shape, then a
    replay of each graph under ``torch.cuda.set_sync_debug_mode("error")``
    (the LowRank round is two graphs, the SVD eagerly between them: the
    ``engines`` line). The wire: int8, int4 and LowRank bytes of one
    full-width update against ``_wire_bytes``. Last, the reduced
    ``run_async`` with SCAFFOLD at ``compress_bits`` 8 on the card
    against the CPU, at 1e-3 · (1 + |cpu|)."""
    import numpy as np
    import torch
    from repro_torch.configs import RESNET18, get_config
    from repro_torch.core import algorithms, compression, fed_engine
    from repro_torch.core import simulator
    from repro_torch.data import make_dataset_for, stack_batches
    from repro_torch.models import registry
    from repro_torch.models.resnet3d import param_shapes
    from repro_torch.optim import trainable_mask
    from repro_torch.types import FedConfig
    t_phase = time.perf_counter()
    params0 = registry.init_params(torch.Generator().manual_seed(3),
                                   RESNET18, "cuda")
    runs = {}
    with _Exact():
        for mode, alg, bits in ALG_RUNS:
            fed = FedConfig(global_epochs=4 if mode == "async" else 8,
                            compress_bits=bits)
            sim = simulator.run_async if mode == "async" \
                else simulator.run_sync
            out, wall = {}, {}
            for engine in ("scan", "loop"):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out[engine] = sim(params0, RESNET18, fed,
                                  _jetson_fleet(RESNET18, fed, 4),
                                  engine=engine, algorithm=alg,
                                  device="cuda")
                torch.cuda.synchronize()
                wall[engine] = time.perf_counter() - t0
            scan, loop = out["scan"], out["loop"]
            name = f"{mode}_{alg or 'fedprox'}" + (f"_int{bits}" if bits
                                                    else "")
            if (scan.wall_clock_s != loop.wall_clock_s
                    or scan.staleness_hist != loop.staleness_hist):
                raise AssertionError(f"{name}: virtual clocks differ")
            if not all(math.isfinite(h[2]) for h in scan.history):
                raise AssertionError(f"{name}: losses {scan.history}")
            err = _rel_err(scan.params, loop.params)
            if err > ENGINE_TOL:
                raise AssertionError(f"{name}: scan vs loop params {err}")
            runs[name] = {"virtual_wall_s": scan.wall_clock_s,
                          "final_loss": scan.final_loss,
                          "param_rel_err_scan_vs_loop": err,
                          "real_wall_s": wall}

    # fresh engines: program shapes and captures, over three H^k draws
    fed = FedConfig()
    student = registry.init_params(torch.Generator().manual_seed(1),
                                   RESNET18, "cuda")
    ds = make_dataset_for(RESNET18, small=True, seed=0)
    stacks = [stack_batches(ds.batches(4, fed.local_iters_max, seed=k))
              for k in range(4)]
    burst, _ = fed_engine.pad_client_batches(stacks)
    draws = [np.asarray(d, np.int32) for d in ([3, 1, 2, 3], [1, 1, 2, 3],
                                               [2, 3, 3, 1])]
    weights = np.full(4, 0.25, np.float32)
    mask = trainable_mask(student, fed.trainable)
    fleet = _jetson_fleet(RESNET18, fed, 4)
    shapes, synced = {}, {}
    for name, alg in (("scaffold", algorithms.Scaffold()),
                      ("lowrank", algorithms.LowRankSubmodel())):
        alg.bind_fleet(fleet)
        if name == "lowrank":
            caps = [alg.capacity_for(k) for k in range(4)]
        client = fed_engine.ClientRun(RESNET18, fed, algorithm=alg)
        rnd = fed_engine.SyncRound(RESNET18, fed, algorithm=alg)
        ctx = alg.ctx_for(student)
        states = alg.stacked_states(student, range(4))
        for i in range(3):
            client.run_batch(student, burst, draws[i], server_ctx=ctx,
                             states=states)
            rnd(student, burst, weights=weights, iters=draws[i],
                server_ctx=ctx, states=states)
        shapes[name] = {
            "client_run": [client.num_compiled, client._graphs.num_captured],
            "sync_round": [rnd.num_compiled, rnd._graphs.num_captured]}
        want = {"client_run": [1, 1],
                "sync_round": [1, 1] if alg.prepare_in_graph else [2, 2]}
        if shapes[name] != want:
            raise AssertionError(f"{name}: [program shapes, captures] "
                                 f"{shapes[name]}, expected {want}")
        if not alg.prepare_in_graph:
            w_news, new_states, msgs, _ = rnd.client_half(
                student, burst, mask, draws[0], ctx, states)
            w_eff = alg.reduce_prepare(w_news, student, new_states, ctx)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            client.run_batch(student, burst, draws[0], server_ctx=ctx,
                             states=states)
            if alg.prepare_in_graph:
                rnd(student, burst, weights=weights, iters=draws[0],
                    server_ctx=ctx, states=states)
                synced[name] = ["client_run", "sync_round"]
            else:
                rnd.client_half(student, burst, mask, draws[0], ctx, states)
                rnd.fold(w_eff, student, weights, msgs, ctx)
                synced[name] = ["client_run", "sync_round.client_half",
                                "sync_round.fold"]
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        if [client.num_compiled, rnd.num_compiled] != [
                want["client_run"][0], want["sync_round"][0]]:
            raise AssertionError(f"{name}: a replay captured anew")
    print(json.dumps({
        "phase": "engines", "algorithms": shapes, "h_draws":
        [d.tolist() for d in draws],
        "lowrank_capacities": caps,
        "replayed_without_host_sync": synced,
        "lowrank_sync_round": "two graphs, the client half and the fold; "
                              "reduce_prepare's torch.linalg.svd runs "
                              "eagerly on the card between them (cuSOLVER's "
                              "status is read on the host: no capture)"}))

    # the wire at full width: one update's bytes against the formula
    shapes_ = param_shapes(RESNET18)
    n_params = sum(math.prod(v) for v in shapes_.values())
    w_new = {k: v + 1e-3 * torch.randn(
        v.shape, generator=torch.Generator(device="cuda").manual_seed(5),
        device="cuda") for k, v in params0.items()}
    wire = {"params": n_params, "leaves": len(shapes_),
            "base_bytes": 4 * n_params}
    for bits in (8, 4):
        upd = compression.quantize_delta(w_new, params0, bits)
        want = _wire_bytes(shapes_, bits)
        if (upd.wire_bytes, upd.base_bytes) != (want, 4 * n_params):
            raise AssertionError(f"int{bits} wire {upd.wire_bytes} / "
                                 f"{upd.base_bytes}, formula {want}")
        # |deq - w| <= scale / 2, beside the f32 roundings of the delta
        # and of the reconstruction
        deq = compression.dequantize_delta(upd, params0)
        eps = torch.finfo(torch.float32).eps
        worst = max(float(((deq[k] - w_new[k]).abs()
                           / upd.scale[k]).max()) for k in w_new)
        if any(bool(((deq[k] - w_new[k]).abs() - upd.scale[k] / 2
                     > 4 * eps * (params0[k].abs() + w_new[k].abs())).any())
               for k in w_new):
            raise AssertionError(f"int{bits}: error {worst} quanta")
        wire[f"int{bits}"] = {"wire_bytes": upd.wire_bytes,
                              "compression_ratio":
                              compression.compression_ratio(upd),
                              "max_err_in_quanta": worst}
    lowrank = algorithms.LowRankSubmodel()
    cap = torch.tensor(0.25, device="cuda")
    for bits in (0, 8, 4):
        upd = lowrank.encode(w_new, cap, params0,
                             FedConfig(compress_bits=bits))
        want = _wire_bytes(shapes_, bits, cap=0.25)
        if upd.wire_bytes != want or upd.base_bytes != 4 * n_params:
            raise AssertionError(f"lowrank int{bits}: wire "
                                 f"{upd.wire_bytes}, formula {want}")
        wire[f"lowrank_cap0.25_bits{bits}"] = {
            "wire_bytes": upd.wire_bytes, "ranks": [r for r in
                                                    upd.meta["ranks"] if r],
            "compression_ratio": upd.base_bytes / upd.wire_bytes}

    # the reduced SCAFFOLD run with int8 updates, card against CPU
    cfg = get_config("resnet3d-18").reduced()
    fed = FedConfig(global_epochs=4, compress_bits=8)
    p_cpu = registry.init_params(torch.Generator().manual_seed(0), cfg,
                                 "cpu")
    with _Exact():
        card = simulator.run_async(p_cpu, cfg, fed, _jetson_fleet(cfg, fed,
                                                                  2),
                                   algorithm="scaffold", device="cuda")
    cpu = simulator.run_async(p_cpu, cfg, fed, _jetson_fleet(cfg, fed, 2),
                              algorithm="scaffold", device="cpu")
    if card.wall_clock_s != cpu.wall_clock_s:
        raise AssertionError("scaffold int8: card vs CPU clocks differ")
    cerr = _rel_err({k: v.cpu() for k, v in card.params.items()},
                    cpu.params)
    if cerr > 1e-3:
        raise AssertionError(f"scaffold int8: card vs CPU params {cerr}")
    print(json.dumps({
        "phase": "algorithms", "card": _card_line(), "tol": ENGINE_TOL,
        "runs": runs, "wire": wire,
        "reduced_scaffold_int8_card_vs_cpu": {
            "param_rel_err": cerr, "virtual_wall_s": card.wall_clock_s,
            "final_loss": {"card": card.final_loss,
                           "cpu": cpu.final_loss}},
        "phase_s": time.perf_counter() - t_phase}))


# ---------------------------------------------------------------------------
# Codistillation and streamed populations
# ---------------------------------------------------------------------------

CODISTILL_STEPS = 8     # the pipeline's default: 2 rounds of 4 steps


def _codistill_losses(report) -> list:
    return ([x for r in report["stage1"]["losses"] for m in r for x in m]
            + report["stage2"]["losses"])


def _nan_equal(a, b) -> bool:
    import torch
    return (torch.equal(a.isnan(), b.isnan())
            and torch.equal(torch.nan_to_num(a), torch.nan_to_num(b)))


def phase_codistill(kernels: list) -> None:
    """Stage 1 by codistillation at full width: ``run_pipeline(
    codistill=True)`` with ResNet3D-34 and ResNet3D-18 as the two members
    (400 classes, batch 4, 2 rounds of 4 KD steps), then the four-Jetson
    async fine-tune on ``scan``, traced: 2 members × 4 steps × 2 rounds =
    16 launches of each KD kernel on the card, and 16 of each counted on
    the host (round 1 eager, round 2's capture; its replay counts
    nothing). Then, in an ``_Exact`` block, a full-width round replayed
    against the same round run eagerly (a fresh graph cache), bit for
    bit, each call's wall ms beside the same round's at PyTorch's
    defaults (eager, captured, three replays); the reduced codistill
    pipeline card against CPU (losses rtol
    1e-3, params within 1e-3 · (1 + |cpu|), clocks equal) and a reduced
    round at budgets [4, 2] card against CPU (the NaN pattern exactly).
    Last, the analytic chain-time model of the two reference chains (host
    math)."""
    import torch
    from repro_torch.configs import RESNET18, RESNET26, RESNET34
    from repro_torch.core import distill
    from repro_torch.core.compile_cache import GraphCache
    from repro_torch.data import make_dataset_for, stack_batches
    from repro_torch.launch.pipeline import run_pipeline
    from repro_torch.types import DistillConfig
    t_phase = time.perf_counter()
    _zero_kd_launches()
    t0 = time.perf_counter()
    (report, _), ran = _traced_kd(lambda: run_pipeline(
        arch="resnet3d-18", teacher="resnet3d-34", reduced=False,
        codistill=True, mode="async", engine="scan", clients=4, batch=4,
        kd_steps=CODISTILL_STEPS, device="cuda"))
    wall = time.perf_counter() - t0
    host = _kd_launches()
    _expect_launches("full-width codistill pipeline on the card", ran,
                     2 * CODISTILL_STEPS)
    _expect_launches("full-width codistill pipeline, host", host,
                     2 * CODISTILL_STEPS)
    losses = _codistill_losses(report)
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"codistill: non-finite losses {losses}")
    for k in kernels:
        if k["name"] in ran:
            k["launches_by_path"]["codistill_pipeline"] = {
                "host": host[k["name"]], "card": ran[k["name"]]}

    # a replayed full-width round against its eager run, card against card
    dcfg = DistillConfig(lr=0.01)
    clips = make_dataset_for(RESNET18, small=False, seed=0)
    p1, p2 = (stack_batches(clips.batches(4, 4, seed=s)) for s in (5, 6))

    def fleet(cfgs, device):
        return distill.CodistillFleet(cfgs, dcfg).init(
            torch.Generator().manual_seed(0), device)
    with _Exact():
        a, b = fleet([RESNET34, RESNET18], "cuda"), fleet(
            [RESNET34, RESNET18], "cuda")
        a.round(p1)
        b.round(p1)
        t0 = time.perf_counter()
        got = a.round(p2, iters=[4, 2])           # captured, then replayed
        torch.cuda.synchronize()
        replay_ms = (time.perf_counter() - t0) * 1e3
        b._graphs = GraphCache()
        t0 = time.perf_counter()
        want = b.round(p2, iters=[4, 2])          # eagerly
        torch.cuda.synchronize()
        eager_ms = (time.perf_counter() - t0) * 1e3
        perr = max(_rel_err(a.member_params(i), b.member_params(i))
                   for i in range(2))
        t0 = time.perf_counter()
        a.round(p1)                               # a replay alone
        torch.cuda.synchronize()
        warm_ms = (time.perf_counter() - t0) * 1e3
    if not _nan_equal(got, want) or perr != 0.0:
        raise AssertionError(f"codistill: replayed round vs eager: params "
                             f"{perr}, losses\n{got}\n{want}")
    captures = [a.num_compiled, a._graphs.num_captured]
    if captures != [4, 4]:
        raise AssertionError(f"codistill [signatures, captures] {captures}")

    # the same full-width round at PyTorch's defaults (cuDNN TF32 on, free
    # to pick its algorithms): eager, captured, then three replays
    d = fleet([RESNET34, RESNET18], "cuda")
    default_ms = []
    for probe in (p1, p2, p1, p2, p1):
        t0 = time.perf_counter()
        d.round(probe)
        torch.cuda.synchronize()
        default_ms.append((time.perf_counter() - t0) * 1e3)

    # the reduced pipeline and a budgeted round, card against CPU
    kw = dict(reduced=True, codistill=True, mode="async", clients=2,
              epochs=2, batch=2, kd_steps=CODISTILL_STEPS, seed=0,
              engine="scan")
    small = [RESNET34.reduced(), RESNET18.reduced()]
    probe = stack_batches(make_dataset_for(small[1], small=False, seed=0)
                          .batches(2, 4, seed=7))
    with _Exact():
        gpu, gp = run_pipeline(device="cuda", **kw)
        cpu, cp = run_pipeline(device="cpu", **kw)
        nan_card = fleet(small, "cuda").round(probe, iters=[4, 2]).cpu()
    nan_cpu = fleet(small, "cpu").round(probe, iters=[4, 2])
    la, lb = _codistill_losses(gpu), _codistill_losses(cpu)
    if len(la) != len(lb) or not all(
            math.isclose(x, y, rel_tol=1e-3) for x, y in zip(la, lb)):
        raise AssertionError(f"codistill card vs CPU losses:\n{la}\n{lb}")
    if gpu["stage2"]["virtual_wall_s"] != cpu["stage2"]["virtual_wall_s"]:
        raise AssertionError("codistill card vs CPU: clocks differ")
    cerr = _rel_err({k: v.cpu() for k, v in gp.items()}, cp)
    if cerr > 1e-3:
        raise AssertionError(f"codistill card vs CPU params {cerr}")
    if not torch.equal(nan_card.isnan(), nan_cpu.isnan()) \
            or not nan_card[1, 2:].isnan().all():
        raise AssertionError(f"codistill NaN pattern:\n{nan_card}\n"
                             f"{nan_cpu}")
    live = ~nan_cpu.isnan()
    nerr = float(((nan_card[live] - nan_cpu[live]).abs()
                  / nan_cpu[live].abs()).max())
    if nerr > 1e-3:
        raise AssertionError(f"codistill budgeted round card vs CPU {nerr}")
    chains = {
        " -> ".join(c.name for c in chain):
        distill.chain_time_model(chain, dataset_items=1e6, epochs=200)
        for chain in ([RESNET34, RESNET18], [RESNET34, RESNET26, RESNET18])}
    print(json.dumps({
        "phase": "codistill", "card": _card_line(), "report": report,
        "wall_s": wall, "num_compiled": report["stage1"]["compiles"],
        "kd_host_launches": host, "kd_kernels_ran_on_card": ran,
        "replay_vs_eager_exact": {"param_rel_err": perr,
                                  "losses_equal": True,
                                  "signatures_and_captures": captures,
                                  "round_ms": {"captured": replay_ms,
                                               "eager": eager_ms,
                                               "replay": warm_ms}},
        "round_ms_default_flags": {"eager": default_ms[0],
                                   "captured": default_ms[1],
                                   "replays": default_ms[2:]},
        "reduced_card_vs_cpu": {"losses_card": la, "losses_cpu": lb,
                                "param_rel_err": cerr,
                                "budgeted_round_loss_rel_err": nerr,
                                "nan_pattern": nan_card.isnan().tolist()},
        "chain_time_model": chains,
        "phase_s": time.perf_counter() - t_phase}))


POPULATION = 10**6
POPULATION_M = 4


def phase_population() -> None:
    """Streamed populations at full width (ResNet3D-18, 400 classes):
    ``python -m repro_torch.launch.train --population 1000000
    --clients-per-round 4 --engine scan`` in async and sync mode, one
    process each, each result line printed; then ``run_async`` and
    ``run_sync`` on a ``FleetSpec`` of 10^6 clients, m = 4, twice each (8
    and 24 global epochs): the most clients held at once (<= m), the
    in-flight bound, the clients drawn, and the engines' [signatures,
    captures], which must not grow with the clients drawn; last, a
    population of 8 streamed against its ``materialize()``d twin in an
    ``_Exact`` block, sync and async: params bit for bit, histories
    equal."""
    import torch
    from repro_torch.configs import RESNET18
    from repro_torch.core import fed_engine, simulator
    from repro_torch.core.fleet import JETSON_FLEET_HMDB51, Fleet, FleetSpec
    from repro_torch.data import make_dataset_for
    from repro_torch.models import registry
    from repro_torch.types import FedConfig
    t_phase = time.perf_counter()
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    for mode in ("async", "sync"):
        argv = [sys.executable, "-m", "repro_torch.launch.train", "--mode",
                mode, "--population", str(POPULATION), "--clients-per-round",
                str(POPULATION_M), "--engine", "scan", "--device", "cuda"]
        t0 = time.perf_counter()
        out = subprocess.run(argv, env=env, cwd=ROOT, text=True,
                             capture_output=True, timeout=600)
        if out.returncode:
            raise AssertionError(f"{argv}: exit {out.returncode}\n"
                                 f"{out.stderr[-4000:]}")
        res = json.loads(out.stdout.strip().splitlines()[-1])
        if not math.isfinite(res["final_loss"]):
            raise AssertionError(f"train --population {mode}: {res}")
        print(json.dumps({"phase": "population_train", "mode": mode,
                          "argv": argv[3:], "result": res,
                          "process_s": time.perf_counter() - t0}))

    ds = make_dataset_for(RESNET18, small=True, seed=1)
    params = registry.init_params(torch.Generator().manual_seed(0),
                                  RESNET18, "cuda")
    engines = {"async": lambda fed: fed_engine.make_client_run(
                   RESNET18, fed, algorithm="fedprox"),
               "sync": lambda fed: fed_engine.make_sync_round(
                   RESNET18, fed, algorithm="fedprox")}
    runs = {}
    for mode, run in (("async", simulator.run_async),
                      ("sync", simulator.run_sync)):
        runs[mode] = []
        for epochs in (8, 24):
            fed = FedConfig(num_clients=POPULATION, global_epochs=epochs,
                            clients_per_round=POPULATION_M, seed=0)
            fleet = Fleet.from_spec(FleetSpec(
                population=POPULATION, profiles=JETSON_FLEET_HMDB51,
                dataset=ds, batch_size=4, steps=fed.local_iters_max,
                seed=0, partition="shared"))
            t0 = time.perf_counter()
            res = run(params, RESNET18, fed, fleet, device="cuda")
            wall = time.perf_counter() - t0
            eng = engines[mode](fed)
            runs[mode].append({
                "global_epochs": epochs, "wall_s": wall,
                "max_resident": fleet.max_resident,
                "resident_at_end": fleet.resident,
                "max_inflight": res.max_inflight,
                "clients_drawn": len(fleet._visits),
                "visits": sum(fleet._visits.values()),
                "final_loss": res.final_loss,
                "virtual_wall_s": res.wall_clock_s,
                "signatures_and_captures": [eng.num_compiled,
                                            eng._graphs.num_captured]})
            if fleet.max_resident > POPULATION_M or not math.isfinite(
                    res.final_loss) or res.max_inflight > POPULATION_M:
                raise AssertionError(f"population {mode}: {runs[mode]}")
        first, second = runs[mode]
        if first["signatures_and_captures"] != \
                second["signatures_and_captures"] \
                or second["clients_drawn"] <= first["clients_drawn"]:
            raise AssertionError(f"population {mode}: captures grew with "
                                 f"the clients drawn: {runs[mode]}")

    # eight clients streamed against their materialized twin
    spec = FleetSpec(population=8, profiles=JETSON_FLEET_HMDB51, dataset=ds,
                     batch_size=4, steps=2, seed=3, partition="iid")
    fed = FedConfig(num_clients=8, global_epochs=8, clients_per_round=2,
                    seed=5)
    twin = {}
    with _Exact():
        for mode, run in (("async", simulator.run_async),
                          ("sync", simulator.run_sync)):
            a = run(params, RESNET18, fed, Fleet.from_spec(spec),
                    device="cuda")
            b = run(params, RESNET18, fed,
                    Fleet.from_spec(spec).materialize(), device="cuda")
            err = _rel_err(a.params, b.params)
            if err != 0.0 or a.history != b.history:
                raise AssertionError(f"{mode}: streamed vs materialized "
                                     f"{err}")
            twin[mode] = {"param_rel_err": err, "history_equal": True,
                          "virtual_wall_s": a.wall_clock_s}
    print(json.dumps({"phase": "population", "card": _card_line(),
                      "population": POPULATION, "m": POPULATION_M,
                      "runs": runs, "streamed_vs_materialized": twin,
                      "phase_s": time.perf_counter() - t_phase}))


def _replay_profile(fn) -> dict:
    """Device ms, kernels and the KD kernels of one call of ``fn`` (the
    mean of 3, ``_profile``), beside its wall ms (5 calls)."""
    prof = _profile(fn, 3, match=("kd_loss",))
    return {"wall_ms": _wall_ms(fn),
            "device_ms": prof.get("device_ms_per_step"),
            "kernels": prof.get("kernels_per_step"),
            "kd_kernels": _kd_in_profile(prof),
            "device_busy_share": prof.get("device_busy_share"),
            "dropped_launches": prof.get("dropped_launches")}


def _schedule_inputs() -> tuple:
    """The ``schedules`` phase's full-width inputs: teacher and student
    params, two KD epoch stacks of ``KD_STEPS``, the ragged round's
    per-client batches."""
    import torch
    from repro_torch.configs import RESNET18, RESNET34
    from repro_torch.data import make_dataset_for, stack_batches
    from repro_torch.models import registry
    gen = torch.Generator().manual_seed(4)
    teacher = registry.init_params(gen, RESNET34, "cuda")
    student = registry.init_params(gen, RESNET18, "cuda")
    clips = make_dataset_for(RESNET18, small=False, seed=0)
    epochs = [stack_batches(clips.batches(4, KD_STEPS, seed=40 + e))
              for e in range(2)]
    ds = make_dataset_for(RESNET18, small=True, seed=0)
    data = [list(ds.batches(4, h, seed=50 + c))
            for c, h in enumerate(MULTI_COUNTS)]
    return teacher, student, epochs, data


def _replays(kd_engine, round_engine, fed, inputs) -> dict:
    """A KD epoch of ``KD_STEPS`` and the ragged 4 x 3 round through the
    given engines in ``_Exact``, each run eagerly, then captured, then
    replayed and profiled (``_replay_profile``)."""
    from repro_torch.configs import RESNET18
    from repro_torch.core import fedavg
    teacher, student, epochs, data = inputs
    state = kd_engine.opt.init(student)

    def kd():
        return kd_engine.epoch(teacher, student, state, epochs[0])

    def rnd():
        return fedavg.fedavg_round(student, [iter(b) for b in data],
                                   RESNET18, fed, engine=round_engine,
                                   data_sizes=MULTI_SIZES)
    with _Exact():
        for _ in range(2):                     # eager, then the capture
            kd()
            rnd()
        return {"kd_epoch": _replay_profile(kd),
                "sync_round_4x3": _replay_profile(rnd)}


def _constant_rate_replays(inputs) -> dict:
    """``_replays`` of fresh constant-rate engines (lr 0.01 and
    ``FedConfig()``'s)."""
    from repro_torch.configs import RESNET18, RESNET34
    from repro_torch.core import distill, fed_engine
    from repro_torch.types import DistillConfig, FedConfig
    return _replays(
        distill.DistillEngine(RESNET34, RESNET18, DistillConfig(
            lr=0.01, chain=(RESNET34.name, RESNET18.name))),
        fed_engine.SyncRound(RESNET18, FedConfig()), FedConfig(), inputs)


def constant_rate_tree(tree: str) -> None:
    """The ``schedules`` phase's constant-rate replays on the engines of a
    checkout of the repo (``.``, or e.g. a ``git archive`` of the parent
    unpacked under ``build/``): its kernels built there, its ``src``
    first on ``sys.path``. Run in a fresh process, before anything
    imports ``repro_torch``; compare trees within one call."""
    sys.path.insert(0, os.path.join(os.path.abspath(tree), "src"))
    import repro_torch
    if not repro_torch.__file__.startswith(os.path.abspath(tree)):
        raise AssertionError(f"repro_torch came from {repro_torch.__file__}")
    build_all()
    print(json.dumps({"phase": "constant_rate_replays", "tree": tree,
                      "card": _card_line(),
                      **_constant_rate_replays(_schedule_inputs())}))


def phase_schedules(kernels: list) -> None:
    """A scheduled learning rate through the engines at the main path's
    full width (ResNet3D-34 -> 18, 400 classes, batch 4, 4x16x16 clips),
    in an ``_Exact`` block. (a) Two KD epochs of 8 under ``cosine(0.01,
    16, 2)``, both replays of one graph (a first pass over the two
    epochs ran the shape eagerly, then captured it), against the same 16
    steps run one by one from a fresh state: params within
    ``ENGINE_TOL``, the step 16, one capture; the KD kernels counted on
    the host in the first pass (8 eager + 8 at the capture), 0 in the
    replays, and 8 + 8 on the card by ``_trace``. (b) The ragged 4 x 3
    sync round (H^k 3, 1, 2, 3; client 4 of zero weight) under
    ``inverse_sqrt(0.05, 1)`` on ``scan`` against ``loop``, and ``shard``
    / ``hier`` in a world of one over NCCL against ``scan``, three calls
    each (eager, capture, replay), one capture each. (c) ``run_async``,
    the four Jetsons x 4 epochs under the same schedule, ``scan`` against
    ``loop``: clocks equal, params within ``ENGINE_TOL``. (d) Two
    codistill rounds at budgets [4, 2] under the KD schedule, the second
    a replay, against the same rounds run eagerly; each member's step.
    (e) Fresh scheduled engines over three H^k draws: one program shape
    and one capture each, and a replay of each with host syncs made
    errors (an ``engines`` line). (f) A replayed scheduled KD epoch and
    4 x 3 round, device ms and kernels, beside the constant-rate ones."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import RESNET18, RESNET34
    from repro_torch.core import distill, fed_engine, fedavg, simulator
    from repro_torch.core.compile_cache import GraphCache
    from repro_torch.data import make_dataset_for, stack_batches
    from repro_torch.launch.mesh import destroy_world, make_fleet_mesh
    from repro_torch.optim import schedules
    from repro_torch.types import DistillConfig, FedConfig
    t_phase = time.perf_counter()
    H = KD_STEPS
    inputs = _schedule_inputs()
    teacher, student, epochs, data = inputs
    clips = make_dataset_for(RESNET18, small=False, seed=0)
    chain = (RESNET34.name, RESNET18.name)
    kd_lr = schedules.cosine(0.01, 2 * H, 2)
    fed_lr = schedules.inverse_sqrt(0.05, 1)
    fed = dataclasses.replace(FedConfig(), lr=fed_lr)
    out = {"phase": "schedules", "card": _card_line(), "tol": ENGINE_TOL,
           "kd_lr": "cosine(0.01, 16, 2)", "fed_lr": "inverse_sqrt(0.05, 1)"}

    # (a) two scheduled KD epochs, replayed, against the steps one by one
    with _Exact():
        engine = distill.DistillEngine(RESNET34, RESNET18,
                                       DistillConfig(lr=kd_lr, chain=chain))
        p, st, want_losses = student, engine.opt.init(student), []
        for stacked in epochs:
            for i in range(H):
                p, st, loss = engine.step(
                    teacher, p, st, {k: v[i] for k, v in stacked.items()})
                want_losses.append(loss)
        want, want_losses = p, torch.stack(want_losses)
        _zero_kd_launches()
        warm = engine.opt.init(student)
        for stacked in epochs:                # eager, then the capture
            _, warm, _ = engine.epoch(teacher, student, warm, stacked)
        host_first = _kd_launches()
        _zero_kd_launches()

        def two_epochs():
            q, s, ls = student, engine.opt.init(student), []
            for stacked in epochs:
                q, s, loss = engine.epoch(teacher, q, s, stacked)
                ls.append(loss)
            return q, s, torch.cat(ls)
        (got, got_st, got_losses), ran = _traced_kd(two_epochs)
        host_replays = _kd_launches()
    kd_err = _rel_err(got, want)
    loss_err = float(((got_losses - want_losses).abs()
                      / (1 + want_losses.abs())).max())
    step = int(got_st["step"])
    if max(kd_err, loss_err) > ENGINE_TOL or step != 2 * H:
        raise AssertionError(f"scheduled KD epochs vs their steps: params "
                             f"{kd_err}, losses {loss_err}, step {step}")
    _expect_launches("scheduled KD epochs, eager + capture: host",
                     host_first, 2 * H)
    _expect_launches("scheduled KD epochs, replays: host", host_replays, 0)
    _expect_launches("scheduled KD epochs, replays: card", ran, 2 * H)
    kd_counts = [engine.num_compiled, engine._graphs.num_captured]
    if kd_counts != [1, 1]:
        raise AssertionError(f"scheduled KD [shapes, captures] {kd_counts}")
    for k in kernels:
        if k["name"] in ran:
            k["launches_by_path"]["schedules_kd_epochs"] = {
                "host_eager_and_capture": host_first[k["name"]],
                "host_replays": host_replays[k["name"]],
                "card_replays": ran[k["name"]]}
    out["kd_epochs"] = {"H": H, "epochs": 2, "step": step,
                        "param_rel_err_vs_steps": kd_err,
                        "loss_rel_err_vs_steps": loss_err,
                        "shapes_and_captures": kd_counts,
                        "host_launches_eager_and_capture": host_first,
                        "host_launches_replays": host_replays,
                        "card_launches_replays": ran}

    # (b) the ragged scheduled round: scan vs loop, shard / hier vs scan
    ds = make_dataset_for(RESNET18, small=True, seed=0)
    meshes = {"shard": make_fleet_mesh(device="cuda"),
              "hier": make_fleet_mesh(edges=0, device="cuda")}

    def round_of(engine, f=fed):
        return lambda: fedavg.fedavg_round(
            student, [iter(b) for b in data], RESNET18, f, engine=engine,
            data_sizes=MULTI_SIZES)
    with _Exact():
        loop_w, loop_l = fedavg.fedavg_round_loop(
            student, [iter(b) for b in data], RESNET18, fed,
            data_sizes=MULTI_SIZES)
        engines = {"scan": fed_engine.SyncRound(RESNET18, fed)}
        engines.update({e: fed_engine.ShardedSyncRound(RESNET18, fed, m)
                        for e, m in meshes.items()})
        rounds = {e: [round_of(r)() for _ in range(3)]
                  for e, r in engines.items()}
    ref = np.concatenate(loop_l)

    def err(res, w, flat):
        got_l = np.concatenate(res[1])
        return max(_rel_err(res[0], w), float(
            np.max(np.abs(got_l - flat) / (1 + np.abs(flat)))))
    round_errs = {"scan_vs_loop": max(err(r, loop_w, ref)
                                      for r in rounds["scan"])}
    scan_first = rounds["scan"][0]
    for e in meshes:
        round_errs[f"{e}_vs_scan"] = max(
            err(r, scan_first[0], np.concatenate(scan_first[1]))
            for r in rounds[e])
    round_counts = {e: [r.num_compiled, r._graphs.num_captured]
                    for e, r in engines.items()}
    if max(round_errs.values()) > ENGINE_TOL:
        raise AssertionError(f"scheduled round: {round_errs}")
    if any(c != [1, 1] for c in round_counts.values()):
        raise AssertionError(f"scheduled round [shapes, captures] "
                             f"{round_counts}")
    out["sync_round"] = {"clients": len(MULTI_COUNTS), "H": MULTI_COUNTS,
                         "data_sizes": MULTI_SIZES, "max_rel_err": round_errs,
                         "shapes_and_captures": round_counts}

    # (c) the scheduled async run, scan against loop
    fed4 = dataclasses.replace(FedConfig(global_epochs=4), lr=fed_lr)
    with _Exact():
        runs = {e: simulator.run_async(student, RESNET18, fed4,
                                       _jetson_fleet(RESNET18, fed4, 4),
                                       engine=e, device="cuda")
                for e in ("scan", "loop")}
    a_err = _rel_err(runs["scan"].params, runs["loop"].params)
    if (runs["scan"].wall_clock_s != runs["loop"].wall_clock_s
            or a_err > ENGINE_TOL):
        raise AssertionError(f"scheduled run_async: clocks "
                             f"{runs['scan'].wall_clock_s} / "
                             f"{runs['loop'].wall_clock_s}, params {a_err}")
    out["run_async"] = {"virtual_wall_s": runs["scan"].wall_clock_s,
                        "updates": len(runs["scan"].history),
                        "param_rel_err_scan_vs_loop": a_err}

    # (d) two scheduled codistill rounds, the second replayed vs eager
    p1, p2 = (stack_batches(clips.batches(4, 4, seed=s)) for s in (5, 6))

    def fleet():
        return distill.CodistillFleet(
            [RESNET34, RESNET18], DistillConfig(lr=kd_lr)).init(
            torch.Generator().manual_seed(0), "cuda")
    with _Exact():
        a, b = fleet(), fleet()
        a.round(p1, iters=[4, 2])
        b.round(p1, iters=[4, 2])
        co_got = a.round(p2, iters=[4, 2])     # captured, then replayed
        b._graphs = GraphCache()
        co_want = b.round(p2, iters=[4, 2])    # eagerly
    co_err = max(_rel_err(a.member_params(i), b.member_params(i))
                 for i in range(2))
    co_steps = [a.member_step(i) for i in range(2)]
    if (co_err > ENGINE_TOL or not _nan_equal(co_got, co_want)
            or co_steps != [b.member_step(i) for i in range(2)]
            or co_steps != [8, 4]):
        raise AssertionError(f"scheduled codistill: params {co_err}, steps "
                             f"{co_steps}, losses\n{co_got}\n{co_want}")
    out["codistill"] = {"budgets": [4, 2], "rounds": 2,
                        "member_steps": co_steps,
                        "param_rel_err_replay_vs_eager": co_err,
                        "losses_equal": True,
                        "shapes_and_captures": [a.num_compiled,
                                                a._graphs.num_captured]}

    # (e) fresh scheduled engines: one shape and one capture over three
    # H^k draws, then a replay of each with host syncs made errors
    stacks = [stack_batches(ds.batches(4, fed.local_iters_max, seed=k))
              for k in range(4)]
    burst, _ = fed_engine.pad_client_batches(stacks)
    draws = [np.asarray(d, np.int32) for d in ([3, 1, 2, 3], [1, 1, 2, 3],
                                               [2, 3, 3, 1])]
    weights = np.asarray(MULTI_SIZES, np.float32) / np.float32(
        sum(MULTI_SIZES))
    fresh = {"client_run": fed_engine.ClientRun(RESNET18, fed),
             "sync_round": fed_engine.SyncRound(RESNET18, fed),
             "shard_round": fed_engine.ShardedSyncRound(RESNET18, fed,
                                                        meshes["shard"]),
             "kd_epoch": distill.DistillEngine(
                 RESNET34, RESNET18, DistillConfig(lr=kd_lr, chain=chain))}
    kd_state = {"s": fresh["kd_epoch"].opt.init(student)}

    def kd_call(i):
        _, kd_state["s"], _ = fresh["kd_epoch"].epoch(
            teacher, student, kd_state["s"], epochs[i % 2])
    calls = {
        "client_run": lambda i: fresh["client_run"].run_batch(
            student, burst, draws[i]),
        "sync_round": lambda i: fresh["sync_round"](
            student, burst, weights=weights, iters=draws[i]),
        "shard_round": lambda i: fresh["shard_round"](
            student, burst, weights=weights, iters=draws[i]),
        "kd_epoch": kd_call}
    with _Exact():
        for fn in calls.values():
            for i in range(3):
                fn(i)
        counts = {n: [e.num_compiled, e._graphs.num_captured]
                  for n, e in fresh.items()}
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for fn in calls.values():
                fn(0)
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    after = {n: [e.num_compiled, e._graphs.num_captured]
             for n, e in fresh.items()}
    if any(c != [1, 1] for c in counts.values()) or after != counts:
        raise AssertionError(f"scheduled [shapes, captures] {counts}, "
                             f"after the guarded replays {after}")
    print(json.dumps({"phase": "engines", "lr": "scheduled",
                      "program_shapes_and_captures": counts,
                      "h_draws": [d.tolist() for d in draws],
                      "replayed_without_host_sync": list(calls),
                      "kd_step_after": int(kd_state["s"]["step"])}))

    # (f) a replayed epoch and round, scheduled beside constant-rate
    timing = _replays(
        distill.DistillEngine(RESNET34, RESNET18,
                              DistillConfig(lr=kd_lr, chain=chain)),
        fed_engine.SyncRound(RESNET18, fed), fed, inputs)
    constant = _constant_rate_replays(inputs)
    for name, part in timing.items():
        s, c = part, constant[name]
        timing[name] = {
            "scheduled": s, "constant": c,
            "extra_kernels": (None if None in (s["kernels"], c["kernels"])
                              else s["kernels"] - c["kernels"]),
            "extra_device_ms": (
                None if None in (s["device_ms"], c["device_ms"])
                else s["device_ms"] - c["device_ms"])}
    out["replay_timing_exact_block"] = timing
    out["phase_s"] = time.perf_counter() - t_phase
    print(json.dumps(out))
    destroy_world()          # the group and the sharded engines on it


# ---------------------------------------------------------------------------
# Serving: the decode kernels, the reduced path card vs CPU, full width
# ---------------------------------------------------------------------------

SERVE_TOL = {"f32": 2e-5, "bf16": 1e-2}   # |err| <= tol * (1 + |plain|)
DECODE_COMBOS = (("f32", "f32"), ("f32", "bf16"), ("bf16", "bf16"))
_TDT = {"f32": "float32", "bf16": "bfloat16"}
# Hymba-1.5B's decode shapes at four slots (configs/hymba_1_5b.py):
# 5 kv heads of 5 query heads, head dim 64; ring W = 1024; the extent's
# deepest rung at max_len 2048; 50 SSD heads of P 64, N 16
HYMBA_ATTEND = (4, 5, 5, 64)
HYMBA_SSD = (4, 50, 64, 16)
# one row of Hymba's attend heads over 131072 cache positions
LONG_EXTENT, LONG_KEYS = (1, 5, 5, 64), 131072
# the rest of the LM stack's decode shapes (phase lm_families), (B, KV, G,
# D), each row's positions, the keys: h2o-danube-3-4b's ring (every layer
# SWA, W 4096) at the positions its batcher's first decode tick reads;
# llama4-scout's extent at its batcher's deepest rung (max_len 1024);
# paligemma-3b's extent (one kv head of 8) over its static decode's
# 256 + 32 + 16 positions
FAMILY_DECODE = {
    "h2o-danube-3-4b": ("ring", (4, 8, 4, 120), (1515, 1115, 528, 115),
                        4096),
    "llama4-scout-17b-a16e": ("extent", (4, 8, 5, 128), (528, 115, 48, 16),
                              1024),
    "paligemma-3b": ("extent", (2, 1, 8, 256), (303, 303), 304)}


def _dt(name):
    import torch
    return getattr(torch, _TDT[name])


def _check_close(what: str, got, want, tol: float) -> float:
    diff = (got.float() - want.float()).abs()
    bad = diff > tol * (1.0 + want.float().abs())
    if bool(bad.any()):
        raise AssertionError(f"{what}: max abs err {float(diff.max())} "
                             f"over tol {tol} x (1 + |plain|)")
    return float(diff.max())


def _attend_inputs(B, KV, G, D, L, q_dt, kv_dt, seed):
    import torch
    g = torch.Generator().manual_seed(seed)
    q = (0.4 * torch.randn(B, KV, G, D, generator=g)).to("cuda", q_dt)
    k = (0.4 * torch.randn(B, L, KV, D, generator=g)).to("cuda", kv_dt)
    v = torch.randn(B, L, KV, D, generator=g).to("cuda", kv_dt)
    return q, k, v


def _ring_visible(pos, W: int, window: int):
    """(B, W) bool: the slots each row attends to (the plain version's
    mask)."""
    import torch
    from repro_torch.kernels import ref
    p = pos.long()[:, None]
    k_pos = p - (p - torch.arange(W, device=pos.device)) % W
    return ref._window_bias(pos, window, k_pos) == 0


def _extent_visible(pos, k_ext: int, window: int):
    import torch
    from repro_torch.kernels import ref
    k_pos = torch.arange(k_ext, device=pos.device)[None, :]
    return (ref._window_bias(pos, window, k_pos) == 0) \
        & (k_pos <= pos.long()[:, None])


def _attend_bound(q, k, visible) -> dict:
    """Least time for one attend, ``visible`` (B, L) the keys each row
    sees: ``roofline.analysis.decode_attend_cost`` (the visible keys' K
    and V read once, q read and the output written once, the positions
    read; 4 operations per (head, key, dim) in 3xTF32)."""
    from repro_torch.roofline import analysis
    _, KV, G, D = q.shape
    return _bound(analysis.decode_attend_cost(
        [int(n) for n in visible.sum(dim=1).tolist()], KV, G, D,
        q_bytes=q.element_size(), kv_bytes=k.element_size()))


def _sdpa_ms(q, k, visible) -> float:
    """One ``scaled_dot_product_attention`` call computing the same attend
    (keys in (B, H, L, D), the equivalent boolean mask): a yardstick,
    used nowhere in the port."""
    import torch
    import torch.nn.functional as F
    B, KV, G, D = q.shape
    qh = q.reshape(B, KV * G, 1, D)
    kh = k.permute(0, 2, 1, 3).contiguous()
    vh = torch.randn_like(kh)
    mask = visible[:, None, None, :]
    return _cuda_ms(lambda: F.scaled_dot_product_attention(
        qh, kh, vh, attn_mask=mask, enable_gqa=True), iters=100)


def _time_kernel(fn, plain) -> dict:
    """Device ms of the kernel and of its plain version (profiler), and
    the per-call cost with the host launch (CUDA events)."""
    dev, pdev = _profile(fn, 50), _profile(plain, 50)
    call_ms, plain_call_ms = _cuda_ms(fn), _cuda_ms(plain, iters=50)
    traced = "device_ms_per_step" in dev and "device_ms_per_step" in pdev
    return {"ms": dev["device_ms_per_call"] if traced else call_ms,
            "plain_ms": (pdev["device_ms_per_call"] if traced
                         else plain_call_ms),
            "ms_source": ("profiler device time" if traced
                          else "cuda events, host launch included"),
            "call_ms": call_ms, "plain_call_ms": plain_call_ms,
            "traced_ms_per_step": dev.get("device_ms_per_step"),
            "kernels_per_call": dev.get("kernels_per_step"),
            "distinct_kernels": dev.get("distinct_kernels"),
            "dropped_launches": dev["dropped_launches"],
            "pad_launches_lost": dev["pad_launches_lost"],
            "plain_kernels": pdev.get("kernels_per_step")}


def phase_decode_kernels() -> list:
    """The three decode kernels against their plain versions on the card,
    then timed at Hymba's full-width decode shape."""
    import torch
    from repro_torch.kernels import decode_attend as da
    from repro_torch.kernels import ref, ssd_decode
    torch.backends.cuda.matmul.allow_tf32 = False
    worst = {"ring": 0.0, "extent": 0.0, "ssd": 0.0}
    cases = 0
    for qn, kvn in DECODE_COMBOS:
        tol = SERVE_TOL["bf16" if "bf16" in (qn, kvn) else "f32"]
        for si, (B, KV, G, D) in enumerate((
                (4, 5, 5, 64), (4, 8, 2, 240), (3, 2, 3, 16),
                *(shape for _, shape, _, _ in FAMILY_DECODE.values()),
                (1, 8, 6, 128))):                      # grok-1's heads
            for W in (1, 17, 1024) + ((4096,) if D == 120 else ()):
                q, k, v = _attend_inputs(B, KV, G, D, W, _dt(qn), _dt(kvn),
                                         seed=si * 10 + W)
                # per-row positions: rings not yet full and wrapped ones
                rows = [W // 2, 3 * W + 5, W - 1, 7 * W + 2][:B]
                pos = torch.tensor(rows, dtype=torch.int32, device="cuda")
                for window in (0, W if W % 2 else W - 1, 5):
                    got = da.ring_decode_attend(q, k, v, pos, window)
                    torch.cuda.synchronize()
                    want = ref.ring_decode_attend_ref(q, k, v, pos, window)
                    worst["ring"] = max(worst["ring"], _check_close(
                        f"ring {qn}/{kvn} {(B, KV, G, D)} W={W} pos={rows} "
                        f"window={window}", got, want, tol))
                    cases += 1
            S_max = 2048
            q, k, v = _attend_inputs(B, KV, G, D, S_max, _dt(qn), _dt(kvn),
                                     seed=si + 100)
            for k_ext in (8, 16, 32, 64, 128, 256, 512, 1024, 2048):
                rows = [0, k_ext - 1, k_ext // 2, k_ext - 1][:B]
                pos = torch.tensor(rows, dtype=torch.int32, device="cuda")
                for window in (0, 5):
                    got = da.extent_decode_attend(q, k, v, pos, window, k_ext)
                    torch.cuda.synchronize()
                    want = ref.extent_decode_attend_ref(q, k, v, pos, window,
                                                        k_ext)
                    worst["extent"] = max(worst["extent"], _check_close(
                        f"extent {qn}/{kvn} {(B, KV, G, D)} k_ext={k_ext} "
                        f"pos={rows} window={window}", got, want, tol))
                    cases += 1
        # far more keys than one block's shared memory held before the
        # redesign (~84k at G = 5): 131072, all visible or a window
        B, KV, G, D = LONG_EXTENT
        q, k, v = _attend_inputs(B, KV, G, D, LONG_KEYS, _dt(qn), _dt(kvn),
                                 seed=7)
        pos = torch.tensor([LONG_KEYS - 1], dtype=torch.int32, device="cuda")
        for window in (0, 1000):
            got = da.extent_decode_attend(q, k, v, pos, window, LONG_KEYS)
            torch.cuda.synchronize()
            want = ref.extent_decode_attend_ref(q, k, v, pos, window,
                                                LONG_KEYS)
            worst["extent"] = max(worst["extent"], _check_close(
                f"extent {qn}/{kvn} {LONG_EXTENT} k_ext={LONG_KEYS} "
                f"window={window}", got, want, tol))
            cases += 1
        del q, k, v
    for xn, sn in DECODE_COMBOS:
        tol = SERVE_TOL["bf16" if "bf16" in (xn, sn) else "f32"]
        for B, H, P, N in (HYMBA_SSD, (4, 24, 64, 128)):
            args = _ssd_inputs(B, H, P, N, _dt(xn), _dt(sn), seed=N)
            y, st = ssd_decode.ssd_decode_step(*args)
            torch.cuda.synchronize()
            y_ref, st_ref = ref.ssd_decode_step_ref(*args)
            what = f"ssd {xn}/{sn} {(B, H, P, N)}"
            worst["ssd"] = max(worst["ssd"],
                               _check_close(what + " y", y, y_ref, tol),
                               _check_close(what + " state", st, st_ref, tol))
            if y.dtype != y_ref.dtype or st.dtype != args[-1].dtype:
                raise AssertionError(f"{what}: dtypes {y.dtype} {st.dtype}")
            if not torch.equal(st[1], args[-1][1]):     # the dt = 0 row
                raise AssertionError(f"{what}: dt = 0 row's state moved")
            cases += 1
        # the decode step's own operands: x, B and C views of the conv
        # output, the state written in place; skew 1 shifts B and C off
        # 16 bytes (the scalar path), as does N = 6
        for B, H, P, N, skew in (HYMBA_SSD + (0,), (4, 24, 64, 128, 0),
                                 HYMBA_SSD + (1,), (3, 4, 8, 6, 0)):
            args = _ssd_path_views(B, H, P, N, _dt(xn), _dt(sn), seed=N,
                                   skew=skew)
            y_ref, st_ref = ref.ssd_decode_step_ref(*args)
            state = args[-1]
            before, ptr = state.clone(), state.data_ptr()
            y, st = ssd_decode.ssd_decode_step(*args, state_out=state)
            torch.cuda.synchronize()
            what = f"ssd views in place {xn}/{sn} {(B, H, P, N)} skew={skew}"
            worst["ssd"] = max(worst["ssd"],
                               _check_close(what + " y", y, y_ref, tol),
                               _check_close(what + " state", st, st_ref, tol))
            if st.data_ptr() != ptr or not torch.equal(st[1], before[1]):
                raise AssertionError(f"{what}: not in place, or the dt = 0 "
                                     f"row's state moved")
            cases += 1
    print(json.dumps({"phase": "decode_kernels", "cases": cases,
                      "max_abs_err": worst}))
    return _time_decode_kernels(worst) + _time_family_decode()


def _ssd_inputs(B, H, P, N, x_dt, s_dt, seed):
    import torch
    import torch.nn.functional as F
    g = torch.Generator().manual_seed(seed)
    xh = torch.randn(B, H, P, generator=g)
    dt = F.softplus(torch.randn(B, H, generator=g))
    dt[1] = 0.0                       # a pad row: its state must not move
    A = -torch.exp(0.3 * torch.randn(H, generator=g))
    Bm = 0.5 * torch.randn(B, N, generator=g)
    Cm = 0.5 * torch.randn(B, N, generator=g)
    st = torch.randn(B, H, P, N, generator=g)
    return (xh.to("cuda", x_dt), dt.cuda(), A.cuda(), Bm.to("cuda", x_dt),
            Cm.to("cuda", x_dt), st.to("cuda", s_dt))


def _ssd_path_views(B, H, P, N, x_dt, s_dt, seed, skew=0):
    """``_ssd_inputs`` with x, B and C cut, as ``ssm_decode_step`` cuts
    them, from one (B, H*P + 2N + skew) conv output."""
    import torch
    xh, dt, A, Bm, Cm, st = _ssd_inputs(B, H, P, N, x_dt, s_dt, seed)
    xbc = torch.empty(B, H * P + 2 * N + skew, device="cuda", dtype=x_dt)
    xbc[:, :H * P] = xh.reshape(B, H * P)
    xbc[:, H * P + skew:H * P + skew + N] = Bm
    xbc[:, H * P + skew + N:] = Cm
    return (xbc[:, :H * P].reshape(B, H, P), dt, A,
            xbc[:, H * P + skew:H * P + skew + N], xbc[:, H * P + skew + N:],
            st)


HOST_PROFILE_CALLS = 1000


def _host_profile(fn) -> dict:
    """The host's microseconds a call of ``fn`` (wall clock around
    HOST_PROFILE_CALLS back-to-back calls, the card synchronised at the
    end: the kernels are shorter than their launches), then the functions
    with the most own time under cProfile, in microseconds a call."""
    import cProfile
    import pstats
    import torch
    n = HOST_PROFILE_CALLS
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) / n * 1e6
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    prof.disable()
    stats = pstats.Stats(prof).stats
    top = sorted(stats.items(), key=lambda kv: kv[1][2], reverse=True)[:8]
    return {"host_us_per_call": wall_us,
            "top_own_time": [
                {"function": f"{os.path.basename(f)}:{line}({name})",
                 "us_per_call": tt / n * 1e6, "calls_per_call": nc / n}
                for (f, line, name), (_, nc, tt, _, _) in top]}


def host_profile_tree(tree: str) -> None:
    """``phase_host_profile`` on the wrappers of another checkout of the
    repo (e.g. a ``git archive`` of the parent unpacked under ``build/``):
    its kernels built there, its ``src`` first on ``sys.path``. Run in a
    fresh process, before anything imports ``repro_torch``."""
    sys.path.insert(0, os.path.join(os.path.abspath(tree), "src"))
    import repro_torch
    if not repro_torch.__file__.startswith(os.path.abspath(tree)):
        raise AssertionError(f"repro_torch came from {repro_torch.__file__}")
    build_all()
    print(json.dumps({"phase": "host_profile_tree", "tree": tree}))
    phase_host_profile()


def phase_host_profile() -> None:
    """Where the host time of the kernels' wrappers goes, at their main
    paths' shapes: the SSD step at Hymba-1.5B's decode shape on contiguous
    operands and on the decode step's views with the state in place; the
    KD forward at R = 4, V = 400; a KD forward and backward through
    autograd, the teacher without a gradient; the ring and extent decode
    attends at Hymba-1.5B's decode shape; the sliding-window attention's
    GQA entry and the SSD chunk scan at its scoring shape."""
    import torch
    from repro_torch.kernels import decode_attend, kd_loss, ops, ssd_decode
    xc, dt, A, bc, cc, st = _ssd_inputs(*HYMBA_SSD, torch.float32,
                                        torch.float32, seed=5)
    xv, dt, A, bv, cv, sv = _ssd_path_views(*HYMBA_SSD, torch.float32,
                                            torch.float32, seed=5)
    s, t, lab = _kd_inputs(4, 400, torch.float32)
    sp = s.clone().requires_grad_(True)

    def kd_step():
        kd_loss.kd_loss_rows(sp, t, lab, 0.5).mean().backward()
    B, KV, G, D = HYMBA_ATTEND
    pos = torch.tensor([1100, 1500, 1030, 2000], dtype=torch.int32,
                       device="cuda")
    ring = _attend_inputs(B, KV, G, D, 1024, torch.float32, torch.float32,
                          seed=1)
    ext = _attend_inputs(B, KV, G, D, 2048, torch.float32, torch.float32,
                         seed=2)
    epos = torch.tensor([2047, 1500, 1100, 1024], dtype=torch.int32,
                        device="cuda")
    gqa = _gqa_inputs(*HYMBA_GQA, "f32", seed=3)
    scan = _scan_inputs(*HYMBA_SCAN[:5], "f32", seed=3)
    for name, fn in (
            ("ssd_decode_step contiguous",
             lambda: ssd_decode.ssd_decode_step(xc, dt, A, bc, cc, st)),
            ("ssd_decode_step views in place",
             lambda: ssd_decode.ssd_decode_step(xv, dt, A, bv, cv, sv,
                                                state_out=sv)),
            ("kd_loss_fused", lambda: kd_loss.kd_loss_fused(s, t, lab, 0.5)),
            ("kd_loss_rows forward + backward", kd_step),
            ("ring_decode_attend",
             lambda: decode_attend.ring_decode_attend(*ring, pos, 1024)),
            ("extent_decode_attend",
             lambda: decode_attend.extent_decode_attend(*ext, epos, 1024,
                                                        2048)),
            ("swa_attention_gqa",
             lambda: ops.swa_attention_gqa(*gqa, 1024)),
            ("ssd_scan", lambda: ops.ssd_scan(*scan, HYMBA_SCAN[5]))):
        print(json.dumps({"phase": "host_profile", "wrapper": name,
                          "calls": HOST_PROFILE_CALLS, **_host_profile(fn)}))


def _one_kernel(name: str, row: dict) -> None:
    """Fails unless a whole trace of the 50 calls saw one kernel, once a
    call."""
    if row["dropped_launches"] or row["distinct_kernels"] != 1 \
            or row["kernels_per_call"] != 1:
        raise AssertionError(
            f"{name}: {row['distinct_kernels']} distinct kernels, "
            f"{row['kernels_per_call']} a call ({row['dropped_launches']} "
            "launches lost by the trace), not one launch")


def _time_decode_kernels(worst: dict) -> list:
    import torch
    from repro_torch.kernels import decode_attend as da
    from repro_torch.kernels import ref, ssd_decode
    out = []
    B, KV, G, D = HYMBA_ATTEND
    # ring: every row wrapped past W = 1024, window 1024 (all slots live)
    q, k, v = _attend_inputs(B, KV, G, D, 1024, torch.float32,
                             torch.float32, seed=1)
    pos = torch.tensor([1100, 1500, 1030, 2000], dtype=torch.int32,
                       device="cuda")
    vis = _ring_visible(pos, 1024, 1024)
    worst["ring"] = max(worst["ring"], _check_close(
        f"ring timed {HYMBA_ATTEND} pos={pos.tolist()}",
        da.ring_decode_attend(q, k, v, pos, 1024),
        ref.ring_decode_attend_ref(q, k, v, pos, 1024), SERVE_TOL["f32"]))
    row = _time_kernel(lambda: da.ring_decode_attend(q, k, v, pos, 1024),
                       lambda: ref.ring_decode_attend_ref(q, k, v, pos, 1024))
    _one_kernel("ring_decode_attend", row)
    out.append({"name": "ring_decode_attend", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/decode_attend.cu",
                "replaces": "src/repro/kernels/swa_attention.py:173",
                "shape": {"B_KV_G_D": HYMBA_ATTEND, "W": 1024,
                          "pos": pos.tolist(), "dtype": "float32"},
                "max_abs_err": worst["ring"], **row,
                **_attend_bound(q, k, vis), "library_ms": _sdpa_ms(q, k, vis),
                "library": "F.scaled_dot_product_attention, boolean mask"})
    # extent: the deepest rung of max_len 2048, rows at the positions
    # the full-width run reaches there
    q, k, v = _attend_inputs(B, KV, G, D, 2048, torch.float32,
                             torch.float32, seed=2)
    pos = torch.tensor([2047, 1500, 1100, 1024], dtype=torch.int32,
                       device="cuda")
    vis = _extent_visible(pos, 2048, 0)
    worst["extent"] = max(worst["extent"], _check_close(
        f"extent timed {HYMBA_ATTEND} pos={pos.tolist()}",
        da.extent_decode_attend(q, k, v, pos, 0, 2048),
        ref.extent_decode_attend_ref(q, k, v, pos, 0, 2048),
        SERVE_TOL["f32"]))
    row = _time_kernel(
        lambda: da.extent_decode_attend(q, k, v, pos, 0, 2048),
        lambda: ref.extent_decode_attend_ref(q, k, v, pos, 0, 2048))
    _one_kernel("extent_decode_attend", row)
    out.append({"name": "extent_decode_attend", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/decode_attend.cu",
                "replaces": "src/repro/kernels/swa_attention.py:221",
                "shape": {"B_KV_G_D": HYMBA_ATTEND, "S_max": 2048,
                          "k_ext": 2048, "pos": pos.tolist(),
                          "dtype": "float32"},
                "max_abs_err": worst["extent"], **row,
                **_attend_bound(q, k, vis),
                "library_ms": _sdpa_ms(q, k[:, :2048], vis),
                "library": "F.scaled_dot_product_attention, boolean mask"})
    # SSD step: the state read and written once, x, dt, A, B, C read,
    # y written (roofline.analysis.ssd_step_cost)
    # (contiguous operands, a new state; and the path's call: the conv
    # output's views, the state written in place)
    B_, H, P, N = HYMBA_SSD
    args = _ssd_inputs(B_, H, P, N, torch.float32, torch.float32, seed=3)
    row = _time_kernel(lambda: ssd_decode.ssd_decode_step(*args),
                       lambda: ref.ssd_decode_step_ref(*args))
    _one_kernel("ssd_decode_step", row)
    views = _ssd_path_views(B_, H, P, N, torch.float32, torch.float32,
                            seed=3)
    path = _time_kernel(
        lambda: ssd_decode.ssd_decode_step(*views, state_out=views[-1]),
        lambda: ref.ssd_decode_step_ref(*views))
    _one_kernel("ssd_decode_step on the path's views", path)
    from repro_torch.roofline import analysis
    out.append({"name": "ssd_decode_step", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/ssd_decode.cu",
                "replaces": "src/repro/kernels/ssd_scan.py:167",
                "shape": {"B_H_P_N": HYMBA_SSD, "dtype": "float32"},
                "max_abs_err": worst["ssd"], **row,
                "views_in_place": {k: path[k] for k in (
                    "ms", "call_ms", "kernels_per_call", "ms_source")},
                **_bound(analysis.ssd_step_cost(B_, H, P, N)),
                "library_ms": None})
    for k_ in out:
        print(json.dumps({"phase": "decode_kernel_time", **k_}))
    return out


def _time_family_decode() -> list:
    """The ring and extent kernels at each ``FAMILY_DECODE`` shape, f32:
    held against their plain versions, timed beside their bounds and SDPA;
    one row an arch, whose launches the ``lm_families`` phase fills in."""
    import torch
    from repro_torch.kernels import decode_attend as da
    from repro_torch.kernels import ref
    out = []
    for arch, (kind, shape, rows, L) in FAMILY_DECODE.items():
        q, k, v = _attend_inputs(*shape, L, torch.float32, torch.float32,
                                 seed=L)
        pos = torch.tensor(rows, dtype=torch.int32, device="cuda")
        window = L if kind == "ring" else 0
        if kind == "ring":
            fn = lambda: da.ring_decode_attend(q, k, v, pos, window)
            plain = lambda: ref.ring_decode_attend_ref(q, k, v, pos, window)
            vis = _ring_visible(pos, L, window)
            name, line, extent = "ring_decode_attend", 173, {"W": L}
        else:
            fn = lambda: da.extent_decode_attend(q, k, v, pos, 0, L)
            plain = lambda: ref.extent_decode_attend_ref(q, k, v, pos, 0, L)
            vis = _extent_visible(pos, L, 0)
            name, line, extent = ("extent_decode_attend", 221,
                                  {"S_max": L, "k_ext": L})
        err = _check_close(f"{name} timed {arch} {shape} pos={rows}", fn(),
                           plain(), SERVE_TOL["f32"])
        row = _time_kernel(fn, plain)
        _one_kernel(f"{name} {arch}", row)
        out.append({"name": name, "route": "cuda",
                    "source": "src/repro_torch/kernels/csrc/decode_attend.cu",
                    "replaces": f"src/repro/kernels/swa_attention.py:{line}",
                    "arch": arch,
                    "shape": {"B_KV_G_D": shape, **extent, "pos": list(rows),
                              "dtype": "float32"},
                    "max_abs_err": err, **row, **_attend_bound(q, k, vis),
                    "library_ms": _sdpa_ms(q, k, vis),
                    "library": "F.scaled_dot_product_attention, boolean "
                               "mask"})
    for k_ in out:
        print(json.dumps({"phase": "decode_kernel_time", **k_}))
    return out


def _decode_launches() -> dict:
    from repro_torch.kernels import decode_attend, ssd_decode
    return {"ring_decode_attend": decode_attend.ring_decode_attend.launches,
            "extent_decode_attend":
                decode_attend.extent_decode_attend.launches,
            "ssd_decode_step": ssd_decode.ssd_decode_step.launches}


def _zero_decode_launches() -> None:
    from repro_torch.kernels import decode_attend, ssd_decode
    decode_attend.ring_decode_attend.launches = 0
    decode_attend.extent_decode_attend.launches = 0
    ssd_decode.ssd_decode_step.launches = 0


def _per_tick(cfg) -> dict:
    """The decode kernels one ring-mode tick of ``cfg`` launches."""
    from repro_torch.models import lm
    attn = cfg.family != "ssm"
    return {"ring_decode_attend": len(lm.swa_layer_ids(cfg)) if attn else 0,
            "extent_decode_attend":
                len(lm.global_layer_ids(cfg)) if attn else 0,
            "ssd_decode_step":
                cfg.num_layers if cfg.family in ("ssm", "hybrid") else 0}


def _decode_on_card(events) -> dict:
    """The decode kernels among the profiler's device events, by wrapper:
    the ring and the extent attend are one template told apart by its
    RING argument (demangled ``true``, mangled ``Lb1E``), the SSD step's
    vector and scalar kernels count as one."""
    out = dict.fromkeys(("ring_decode_attend", "extent_decode_attend",
                         "ssd_decode_step"), 0)
    for e in events:
        n = e.name()
        if "decode_attend_kernel" in n:
            ring = ", true," in n or "Lb1E" in n
            out["ring_decode_attend" if ring else "extent_decode_attend"] += 1
        elif "ssd_decode_" in n and "_kernel" in n:
            out["ssd_decode_step"] += 1
    return out


def _serve_counts(what: str, srv, host: dict, card=None, names=()) -> dict:
    """A stream's decode kernels against its batcher's graphs: from the
    host (``host``, the wrappers' counts) one tick's kernels for each eager
    tick and each capture; on the card (``card``, from ``_decode_on_card``)
    one tick's for every tick. Returns the tick accounting."""
    per = _per_tick(srv.cfg)
    ticks, eager = srv._steps, srv.decode_compiles
    captured = srv._graphs.num_captured
    want = {k: (eager + captured) * v for k, v in per.items()}
    if host != want:
        raise AssertionError(f"{what}: host launches {host}, want {want} "
                             f"({eager} eager ticks + {captured} captures)")
    if card is not None and card != {k: ticks * v for k, v in per.items()}:
        raise AssertionError(f"{what}: the card ran {card}, want {ticks} "
                             f"ticks x {per} (kernel names: "
                             f"{sorted(set(names))[:6]})")
    return {"ticks": ticks, "eager_ticks": eager, "captures": captured,
            "ticks_by_graph": ticks - eager, "per_tick": per,
            "captures_per_rung": {
                str(r): srv._graphs.captures(("decode", r))
                for r in srv.decode_buckets or (0,)
                if srv._graphs.count(("decode", r))}}


def _stream_parts(srv) -> dict:
    """Wrap ``srv``'s admit and decode tick so that a stream's host
    seconds split into admits (prefill and install), eager ticks (a
    shape's first), captured ticks (the capture and its first replay) and
    replayed ticks: {part: [calls, seconds]}, filled as the stream runs.
    Each part ends in a synchronise, where an admit and a tick end in a
    host transfer anyway."""
    import torch
    parts = {k: [0, 0.0] for k in ("admit", "eager_tick", "captured_tick",
                                   "replayed_tick")}
    admit, decode = srv._admit, srv._decode

    def add(kind, t0):
        torch.cuda.synchronize()
        parts[kind][0] += 1
        parts[kind][1] += time.perf_counter() - t0

    def timed_admit():
        t0 = time.perf_counter()
        if not (srv.queue and None in srv.active):
            return admit()
        admit()
        add("admit", t0)

    def timed_decode(mask):
        seen, held = srv._graphs.num_compiled, srv._graphs.num_captured
        t0 = time.perf_counter()
        out = decode(mask)
        add("eager_tick" if srv._graphs.num_compiled > seen else
            "captured_tick" if srv._graphs.num_captured > held else
            "replayed_tick", t0)
        return out

    srv._admit, srv._decode = timed_admit, timed_decode
    return parts


def _release_graphs(srv) -> dict:
    """Drop a batcher's decode graphs: the GiB their pools held (what
    dropping them returns to the card) and the GiB still allocated."""
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_reserved()
    srv._graphs.clear()
    gc.collect()
    torch.cuda.empty_cache()
    return {"graph_pools_gib": (before - torch.cuda.memory_reserved())
            / 2 ** 30,
            "held_after_release_gib": torch.cuda.memory_allocated() / 2 ** 30}


def _serve(params, cfg, prompts, max_new, **kw):
    from repro_torch.core.serving import ContinuousBatcher
    srv = ContinuousBatcher(params, cfg, **kw)
    for p in prompts:
        srv.submit(p, max_new=max_new)
    return srv, {r.rid: r.out for r in srv.run()}


def _logits_close(what, a, b, rtol=1e-3) -> float:
    b = b.to(a.device)
    err = float(((a - b).abs() / (1.0 + b.abs())).max())
    if err > rtol:
        raise AssertionError(f"{what}: logits differ by {err} > {rtol}")
    return err


def _admitted(params, cfg, prompts, **kw):
    """A batcher that has admitted ``prompts`` (one admit: prefill and
    install) and decoded nothing yet."""
    from repro_torch.core.serving import ContinuousBatcher
    srv = ContinuousBatcher(params, cfg, **kw)
    for p in prompts:
        srv.submit(p, max_new=srv.max_len - len(p))
    srv._admit()
    return srv


def _forced_ticks(srv, tokens, mode: str) -> list:
    """Decode ticks on ``srv``'s admitted caches, fed ``tokens[t]`` (one
    per slot) at tick t whatever they predict: ring mode through
    ``decode_step_grouped`` with ``srv``'s kernel and K-extent ladder,
    uniform mode through the eager ``decode_step``. Returns the logits."""
    import numpy as np
    import torch
    from repro_torch.models import registry
    pos = srv.pos.copy()
    mask = np.array([r is not None for r in srv.active])
    out = []
    for t in range(len(tokens)):
        tok = torch.from_numpy(np.asarray(tokens[t], np.int32)).to(
            srv.device)
        p = torch.from_numpy(pos).to(srv.device)
        if mode == "ring":
            srv.pos = pos
            logits, _ = registry.decode_step_grouped(
                srv.params, srv.cfg, tok, srv.cache, p,
                k_ext=srv._decode_k_ext(mask),
                decode_kernel=srv.decode_kernel)
        else:
            logits, _ = registry.decode_step(srv.params, srv.cfg, tok,
                                             srv.cache, p)
        out.append(logits)
        pos = pos + 1
    return out


def phase_serve_card_vs_cpu():
    """Reduced Hymba: one request stream served on the card (CUDA
    kernels, the ticks graph replays, traced) and on the CPU (their plain
    versions, eager), TF32 off."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import registry
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("hymba-1.5b").reduced()
    cpu = registry.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    card = {k: v.cuda() for k, v in cpu.items()}
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 9, 13, 3, 40, 1)]
    kw = dict(max_slots=2, max_len=96, min_bucket=4, decode_mode="ring",
              decode_kernel="cuda")
    _zero_decode_launches()
    (srv, toks_card), events, _, lost = _trace(
        lambda: _serve(card, cfg, prompts, 12, **kw))
    n_card = _decode_launches()
    ticks = _serve_counts("reduced serve", srv, n_card,
                          _decode_on_card(events),
                          [e.name() for e in events])
    ticks["dropped_launches"] = lost["calls"]
    released = _release_graphs(srv)
    _zero_decode_launches()
    _, toks_cpu = _serve(cpu, cfg, prompts, 12, **kw)
    if any(_decode_launches().values()):
        raise AssertionError(f"CPU serve launched kernels: "
                             f"{_decode_launches()}")
    if toks_card != toks_cpu:
        raise AssertionError(f"card vs CPU tokens differ:\n{toks_card}\n"
                             f"{toks_cpu}")
    # logits: a bucketed prefill, then 6 teacher-forced ring decode ticks
    # from the batcher's own install of one admitted group
    B, S = 3, 16
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    lengths = np.asarray([16, 5, 11], np.int32)
    prefill_logits, ticks_logits = {}, {}
    for dev, params in (("cuda", card), ("cpu", cpu)):
        cache = registry.init_cache(cfg, B, S, torch.float32, dev)
        prefill_logits[dev], _ = registry.prefill(
            params, cfg, {"tokens": torch.from_numpy(toks).to(dev)}, cache,
            lengths=torch.from_numpy(lengths).to(dev), q_chunk=S)
        adm = _admitted(params, cfg, [toks[j, :n] for j, n in
                                      enumerate(lengths)],
                        **{**kw, "max_slots": B})
        ticks_logits[dev] = _forced_ticks(adm, toks[:, :6].T, "ring")
    errs = [_logits_close("reduced prefill", prefill_logits["cuda"],
                          prefill_logits["cpu"])]
    for t, (a, b) in enumerate(zip(ticks_logits["cuda"], ticks_logits["cpu"])):
        errs.append(_logits_close(f"reduced decode tick {t}", a, b))
    print(json.dumps({"phase": "serve_card_vs_cpu", "card": _card_line(),
                      "tokens_equal": True, "requests": len(toks_card),
                      "decode_ticks": ticks, "launches": n_card,
                      **released, "logits_rel_err": max(errs)}))


FULL_PROMPTS = (1, 7, 33, 100, 513, 1024, 1100, 1500)
# the exactness check's group: the longest prompt puts the first tick at
# position 6, so 12 forced ticks climb the K-extent rungs 8, 16 and 32
EXACT_PROMPTS = (6, 3, 5, 1)
EXACT_TICKS = 12
# phase 9's eager tick before the decode became a graph (PERF.md §5:
# NVIDIA H100 80GB HBM3, 700 W), printed beside this run's
TICK_BEFORE = {"kernels": 3589.7, "device_ms": 12.14, "wall_ms": 119.6}


def _replayed_vs_eager(srv, forced) -> dict:
    """Ticks of an admitted batcher through its decode graphs, fed
    ``forced[t]`` (one token a slot) at tick t, each against the eager
    decode of its mode (``decode_step_grouped`` with its kernel and
    K-extent, or ``decode_step``) on an identical copy of the cache: the
    logits and every cache leaf 0.0 apart and the argmax tokens equal."""
    import numpy as np
    import torch
    from repro_torch.models import registry
    mask = np.array([r is not None for r in srv.active])
    twin = {k: v.clone() for k, v in srv.cache.items()}
    rungs = []
    for t, tok in enumerate(forced):
        srv.last_tok[:] = tok
        tp = torch.from_numpy(np.stack([srv.last_tok, srv.pos])).to(
            srv.device)
        if srv.decode_mode == "ring":
            rungs.append(srv._decode_k_ext(mask))
            want, twin = registry.decode_step_grouped(
                srv.params, srv.cfg, tp[0], twin, tp[1], k_ext=rungs[-1],
                decode_kernel=srv.decode_kernel)
        else:
            want, twin = registry.decode_step(srv.params, srv.cfg, tp[0],
                                              twin, tp[1])
        nxt, logits = srv._decode(mask)
        apart = [k for k in twin if not torch.equal(srv.cache[k], twin[k])]
        if apart or not torch.equal(logits, want) or not torch.equal(
                nxt, torch.argmax(want, dim=-1).to(torch.int32)):
            raise AssertionError(
                f"{srv.decode_mode} tick {t}: replayed vs eager logits "
                f"{float((logits - want).abs().max())} apart, cache leaves "
                f"{apart} apart")
        srv.pos[mask] += 1
    return {"ticks": len(forced), "k_ext_per_tick": rungs,
            "eager_ticks": srv.decode_compiles,
            "captures": srv._graphs.num_captured,
            "logits_and_cache_max_abs_diff": 0.0, "tokens_equal": True}


def phase_serve_full_width(kernels: list, seed: int) -> None:
    """Hymba-1.5B at full width, f32, through the continuous batcher:
    4 slots, max_len 2048, prefill buckets from 8, ring decode on the CUDA
    kernels, each tick a replay of its K-extent rung's graph after the
    rung's eager tick and capture. Eight requests of FULL_PROMPTS tokens,
    32 new tokens each: they cross several prefill buckets, install
    prompts longer than the 1024-slot ring, wrap it in decode and climb
    the K-extent ladder. The stream runs twice: timed, its launches
    counted on the host (the kernel rows' launches); then traced, the
    kernels the card ran counted from the profiler's device events, and
    the stream's device-busy share. Then replayed ticks against eager ones
    in ``_Exact`` (ring and uniform), and one replayed tick timed and
    traced beside the eager tick."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.serving import ContinuousBatcher, generate_single
    from repro_torch.models import registry
    torch.backends.cuda.matmul.allow_tf32 = False
    t_phase = time.perf_counter()
    card = _card_line()
    cfg = get_config("hymba-1.5b")
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = registry.init_params(gen, cfg, "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in FULL_PROMPTS]
    max_new = 32
    kw = dict(max_slots=4, max_len=2048, min_bucket=8, decode_mode="ring",
              decode_kernel="cuda")
    torch.cuda.reset_peak_memory_stats()
    srv = ContinuousBatcher(params, cfg, **kw)
    parts = _stream_parts(srv)
    for p in prompts:
        srv.submit(p, max_new=max_new)
    _zero_decode_launches()
    t0 = time.perf_counter()
    toks = {r.rid: r.out for r in srv.run()}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _decode_launches()
    stream = _serve_counts("full-width stream", srv, launches)
    stream["parts_s"] = {k: {"calls": n, "s": t}
                         for k, (n, t) in parts.items()}
    stream["parts_s"]["rest"] = wall - sum(t for _, t in parts.values())
    if len(toks) != len(prompts) or any(len(t) != max_new
                                        for t in toks.values()):
        raise AssertionError(f"not every request completed: "
                             f"{ {k: len(v) for k, v in toks.items()} }")
    if srv.prefill_compiles > len(srv.buckets) \
            or srv.decode_compiles > len(srv.decode_buckets):
        raise AssertionError(
            f"shapes: prefill {srv.prefill_compiles} > "
            f"{len(srv.buckets)} or decode {srv.decode_compiles} > "
            f"{len(srv.decode_buckets)}")
    for k in kernels:
        if "arch" not in k:            # the other configs' rows: lm_families
            k["launches"] = launches[k["name"]]
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    report = {"phase": "serve_full_width", "arch": cfg.name, "card": card,
              "params": sum(v.numel() for v in params.values()),
              "init_s": init_s, "real_wall_s": wall,
              "decode_ticks": srv._steps, "generated_tokens": sum(
                  len(t) for t in toks.values()),
              "prefill_compiles": srv.prefill_compiles,
              "buckets": list(srv.buckets),
              "decode_compiles": srv.decode_compiles,
              "decode_buckets": list(srv.decode_buckets),
              "bucket_hist": {str(k): v for k, v in srv.bucket_hist.items()},
              "group_admits": {str(k): v
                               for k, v in srv.group_admits.items()},
              "launches": launches, "graphs": stream,
              "peak_mem_gib": peak_gib}
    report["gen_tok_per_s"] = report["generated_tokens"] / wall
    report.update(_release_graphs(srv))
    del srv

    # the stream again, traced: what the card ran, and its busy share
    _zero_decode_launches()
    (srv, toks2), events, traced_ms, lost = _trace(
        lambda: _serve(params, cfg, prompts, max_new, **kw))
    if toks2 != toks:
        raise AssertionError("the traced stream's tokens differ")
    on_card = _decode_on_card(events)
    _serve_counts("traced full-width stream", srv, _decode_launches(),
                  on_card, [e.name() for e in events])
    busy_ms = sum(e.duration_ns() for e in events) / 1e6
    report["traced_stream"] = {
        "launches_on_card": on_card, "device_ms": busy_ms,
        "traced_wall_ms": traced_ms, "kernels": len(events),
        "device_busy_share_traced": busy_ms / traced_ms,
        "device_busy_share_of_real_wall": busy_ms / (wall * 1e3),
        "dropped_launches": lost["calls"]}
    for k in kernels:
        if "arch" not in k:
            k["launches_on_card"] = on_card[k["name"]]
    report["traced_stream"].update(_release_graphs(srv))
    del srv

    # generate_single launches no kernel; share of requests it agrees
    # with, of the shortest and the longest (its eager decode takes ~3 s a
    # request at this width)
    _zero_decode_launches()
    oracle = (0, len(prompts) - 1)
    same = sum(generate_single(params, cfg, prompts[rid], max_new,
                               max_len=2048) == toks[rid] for rid in oracle)
    if any(_decode_launches().values()):
        raise AssertionError(f"generate_single launched kernels: "
                             f"{_decode_launches()}")
    report["generate_single_share"] = same / len(oracle)

    # teacher-forced: the first admitted group's own tokens through 16
    # ring/cuda ticks and 16 uniform eager ticks, logits compared
    group = prompts[:4]
    forced = np.asarray([toks[j][:16] for j in range(4)]).T   # (16, 4)
    ring = _forced_ticks(_admitted(params, cfg, group, **kw), forced,
                         "ring")
    uni = _forced_ticks(_admitted(params, cfg, group,
                                  **{**kw, "decode_mode": "uniform",
                                     "decode_kernel": "eager"}),
                        forced, "uniform")
    errs = [_logits_close(f"full-width forced tick {t}", a, b)
            for t, (a, b) in enumerate(zip(ring, uni))]
    for lg in ring:
        if not bool(torch.isfinite(lg).all()):
            raise AssertionError("non-finite full-width logits")
    report["forced_logits_rel_err"] = max(errs)

    # replayed ticks against eager ones, bit for bit, across two rungs
    exact = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
             for n in EXACT_PROMPTS]
    forced = rng.integers(0, cfg.vocab_size, (EXACT_TICKS, 4)).astype(
        np.int32)
    report["replayed_vs_eager"] = {}
    with _Exact():
        for mode, kern in (("ring", "cuda"), ("uniform", "eager")):
            adm = _admitted(params, cfg, exact, **{
                **kw, "decode_mode": mode, "decode_kernel": kern})
            report["replayed_vs_eager"][mode] = {
                **_replayed_vs_eager(adm, forced), **_release_graphs(adm)}
            del adm

    # where the time goes: one tick of the stream's second admitted group
    # at the K-extent 2048, replayed (after its eager tick and capture)
    # and eagerly, through the same batcher
    adm = _admitted(params, cfg, prompts[4:], **kw)
    mask = np.ones(4, bool)
    for _ in range(2):
        adm._decode(mask)
    tick = lambda: adm._decode(mask)[0].cpu()
    tp = torch.from_numpy(np.stack([adm.last_tok, adm.pos])).cuda()
    eager = lambda: registry.decode_step_grouped(
        params, cfg, tp[0], adm.cache, tp[1], k_ext=adm._decode_k_ext(mask),
        decode_kernel="cuda")
    report["tick"] = {"k_ext": adm._decode_k_ext(mask),
                      "replayed_wall_ms": _wall_ms(tick, 10),
                      "replayed": _profile(tick, 3),
                      "eager_wall_ms": _wall_ms(eager, 3),
                      "eager": _profile(eager, 3),
                      "before_graphs": TICK_BEFORE}
    report["tick"]["replayed_on_card"] = _decode_on_card(_trace(tick)[1])
    if report["tick"]["replayed_on_card"] != _per_tick(cfg):
        raise AssertionError(f"a replayed tick ran "
                             f"{report['tick']['replayed_on_card']}, want "
                             f"{_per_tick(cfg)}")
    report["tick"].update(_release_graphs(adm))
    report["kernels_per_tick"] = report["tick"]["replayed"].get(
        "kernels_per_step")
    report["device_ms_per_tick"] = report["tick"]["replayed"].get(
        "device_ms_per_step")
    report["phase_s"] = time.perf_counter() - t_phase
    print(json.dumps(report))


# ---------------------------------------------------------------------------
# Scoring: the sliding-window attention and the SSD chunk scan, the reduced
# forward card vs CPU, the full-width forward
# ---------------------------------------------------------------------------

SCORE_TOL = {"f32": 1e-4, "bf16": 1e-2}   # |err| <= tol * (1 + |plain|)
# kernel-name pieces of copies, gathers and repeats in a forward's profile
COPY_KERNELS = ("copy", "Copy", "index", "Index", "repeat")
# Hymba-1.5B's scoring shapes at B = 2, S = 2048 (configs/hymba_1_5b.py):
# 25 query heads over 5 kv heads of dim 64, as the model holds them (the
# GQA entry) and folded into BH = 50 with K/V repeated (the folded entry),
# window 1024 on 29 layers and S on 3; 50 SSD heads of P 64, N 16, chunk
# 128
SCORE_B, SCORE_S = 2, 2048
HYMBA_GQA = (SCORE_B, SCORE_S, 25, 5, 64)
# Gemma3-12B's (configs/gemma3_12b.py): 16 query heads over 8 kv heads of
# dim 240 (d_model 3840), one sequence of 2048, window 1024 on five layers
# of six
GEMMA_GQA = (1, SCORE_S, 16, 8, 240)
# the rest of the LM stack's scoring shapes (phase lm_families): h2o-danube-
# 3-4b's 32 heads over 8 of dim 120 (3840 / 32) at S 4096, window 4096;
# llama4-scout's 40 over 8 of 128 and grok-1's 48 over 8 of 128 at S 2048,
# full attention; paligemma-3b's 8 heads over one of 256, B 2 x S 2048
# (the 256-token patch prefix included), full attention. {arch: (B, S, H,
# KV, D), window}
FAMILY_GQA = {"h2o-danube-3-4b": ((1, 4096, 32, 8, 120), 4096),
              "llama4-scout-17b-a16e": ((1, SCORE_S, 40, 8, 128), SCORE_S),
              "grok-1-314b": ((1, SCORE_S, 48, 8, 128), SCORE_S),
              "paligemma-3b": ((2, SCORE_S, 8, 1, 256), SCORE_S)}
# kernel 5 on one rank's heads under tensor parallelism on the pod's
# "model" axis of 16 (sharding.compute_layout): H / 16 query heads and the
# one kv head they read, two rows of train_4k's 4096 positions; gemma3-12b
# at its local layers' window, the others at their layers' (grok-1's and
# internlm2's full, h2o-danube's 4096). {arch: (B, S, H, KV, D), window}
SPLIT_GQA = {"gemma3-12b": ((2, 4096, 1, 1, 240), 1024),
             "grok-1-314b": ((2, 4096, 3, 1, 128), 4096),
             "h2o-danube-3-4b": ((2, 4096, 2, 1, 120), 4096),
             "internlm2-20b": ((2, 4096, 3, 1, 128), 4096)}
HYMBA_SWA = (SCORE_B * 25, SCORE_S, 64)
HYMBA_SCAN = (SCORE_B, SCORE_S, 50, 64, 16, 128)
# kernel 6 on one rank's SSD heads under tensor parallelism on a "model"
# axis of 2 (sharding.compute_layout): Hymba-1.5B's 25 of 50 heads and
# Mamba2-130M's 12 of 24, B 2 x S 2048 at each config's chunk.
# {arch: (B, S, H, P, N, chunk)}
SPLIT_SCAN = {"hymba-1.5b": (SCORE_B, SCORE_S, 25, 64, 16, 128),
              "mamba2-130m": (SCORE_B, SCORE_S, 12, 64, 128, 256)}
# the reference's sweep (tests/test_kernels.py), Hymba's and Mamba2-130m's
# shape (N = 128 with P = 64: the kernel takes 64 rows at a time)
SCAN_SHAPES = ((128, 2, 32, 16, 32), (256, 3, 64, 16, 64),
               (256, 2, 32, 128, 128), (64, 1, 64, 64, 64),
               HYMBA_SCAN[1:], (512, 24, 64, 128, 256))


def _swa_inputs(BH, S, D, dt_name, seed):
    import torch
    g = torch.Generator().manual_seed(seed)
    q, k = ((0.3 * torch.randn(BH, S, D, generator=g)).to("cuda", _dt(dt_name))
            for _ in range(2))
    v = torch.randn(BH, S, D, generator=g).to("cuda", _dt(dt_name))
    return q, k, v


def _gqa_inputs(B, S, H, KV, D, dt_name, seed):
    """q (B, S, H, D), k and v (B, S, KV, D), the model's layout."""
    import torch
    g = torch.Generator().manual_seed(seed)
    d = _dt(dt_name)
    q = (0.3 * torch.randn(B, S, H, D, generator=g)).to("cuda", d)
    k = (0.3 * torch.randn(B, S, KV, D, generator=g)).to("cuda", d)
    v = torch.randn(B, S, KV, D, generator=g).to("cuda", d)
    return q, k, v


def _scan_inputs(B, S, H, P, N, dt_name, seed, live=None):
    """SSD inputs as ``ssm_forward`` hands them over; rows from ``live`` on
    are its chunk padding: zeros, dt = 0."""
    import torch
    import torch.nn.functional as F
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(B, S, H, P, generator=g)
    dt = F.softplus(torch.randn(B, S, H, generator=g))
    A = -torch.exp(0.3 * torch.randn(H, generator=g))
    Bm = 0.5 * torch.randn(B, S, N, generator=g)
    Cm = 0.5 * torch.randn(B, S, N, generator=g)
    if live is not None:
        for t in (x, dt, Bm, Cm):
            t[:, live:] = 0.0
    d = _dt(dt_name)
    return (x.to("cuda", d), dt.cuda(), A.cuda(), Bm.to("cuda", d),
            Cm.to("cuda", d))


def _two_precisions(cost) -> dict:
    """The bound of a 3xTF32 kernel's ``cost`` (``bound_ms``), and beside
    it the bound were its products f32 on the FMA pipes."""
    (_, ops), = cost[0].items()
    fma = _bound(({"f32": ops}, cost[1]))
    return {**_bound(cost),
            "bound_precision": "3xTF32 on the tensor cores, 495 TFLOP/s",
            "bound_f32_fma_ms": fma["bound_ms"],
            "bound_f32_fma_by": fma["bound_by"]}


def _swa_bound(q, k, window: int) -> dict:
    """``roofline.analysis.swa_attention_cost`` of one call on q (the GQA
    entry's (B, S, H, D) or the folded (BH, S, D)) and k."""
    from repro_torch.roofline import analysis
    if q.dim() == 4:
        B, S, H, D = q.shape
        KV = k.shape[2]
    else:
        (B, S, D), H, KV = q.shape, 1, 1
    return _two_precisions(analysis.swa_attention_cost(
        B, S, H, KV, D, window, dtype_bytes=q.element_size()))


def _scan_bound(x, N: int) -> dict:
    """``roofline.analysis.ssd_scan_cost`` of one call on x, at the
    kernels' own chunk (the scan is the same function for any chunk)."""
    from repro_torch.kernels import ssd_scan as tscan
    from repro_torch.roofline import analysis
    return _two_precisions(analysis.ssd_scan_cost(
        *x.shape, N, dtype_bytes=x.element_size(), chunk=tscan.BLOCK_CHUNK))


def phase_scoring_kernels() -> list:
    """The sliding-window attention and the SSD scan against their plain
    versions on the card, then timed at Hymba's full-width scoring
    shapes."""
    import torch
    from repro_torch.kernels import ops, ref
    torch.backends.cuda.matmul.allow_tf32 = False
    worst = {"swa": 0.0, "swa_gqa": 0.0, "scan": 0.0}
    cases = 0
    for dn in ("f32", "bf16"):
        tol = SCORE_TOL[dn]
        # the GQA entry at G = 1, 2 and 5 query heads over 2 kv heads
        for D, seqs in ((64, (40, 256, 2048)), (128, (256,)),
                        (240, (128, 256)), (256, (128, 256))):
            for S in seqs:
                for G in (1, 2, 5):
                    q, k, v = _gqa_inputs(2, S, 2 * G, 2, D, dn,
                                          seed=S + D + G)
                    for w in (1, 33, 100, S, 0):
                        got = ops.swa_attention_gqa(q, k, v, w)
                        torch.cuda.synchronize()
                        want = ref.swa_attention_gqa_ref(q, k, v, w or S)
                        if got.dtype != q.dtype or not got.is_contiguous():
                            raise AssertionError(f"swa gqa output {got.dtype}"
                                                 f" {got.stride()}")
                        worst["swa_gqa"] = max(worst["swa_gqa"], _check_close(
                            f"swa gqa {dn} S={S} D={D} G={G} w={w}", got,
                            want, tol))
                        cases += 1
        # the GQA entry at the main path's own shape and windows, at
        # Gemma3-12B's (head dim 240) and at the other configs' (head dims
        # 120, 128 at G 5 and 6, 256 with one kv head)
        for shape in (HYMBA_GQA, GEMMA_GQA,
                      *(sh for sh, _ in FAMILY_GQA.values())):
            B, S, H, KV, D = shape
            q, k, v = _gqa_inputs(B, S, H, KV, D, dn, seed=5)
            for w in (1024, S):
                got = ops.swa_attention_gqa(q, k, v, w)
                torch.cuda.synchronize()
                want = ref.swa_attention_gqa_ref(q, k, v, w)
                worst["swa_gqa"] = max(worst["swa_gqa"], _check_close(
                    f"swa gqa {dn} {shape} w={w}", got, want, tol))
                cases += 1
            del q, k, v, got, want
        for D, seqs in ((64, (40, 128, 256, 512, 2048)), (128, (128, 256)),
                        (240, (128, 256)), (256, (128, 256))):
            for S in seqs:
                q, k, v = _swa_inputs(3, S, D, dn, seed=S + D)
                for w in (1, 32, 100, 200, S, 0):
                    got = ops.swa_attention(q, k, v, w)
                    torch.cuda.synchronize()
                    want = ref.swa_attention_ref(q, k, v, w or S)
                    if got.dtype != q.dtype:
                        raise AssertionError(f"swa dtype {got.dtype}")
                    worst["swa"] = max(worst["swa"], _check_close(
                        f"swa {dn} S={S} D={D} w={w}", got, want, tol))
                    cases += 1
        for i, (S, H, P, N, chunk) in enumerate(SCAN_SHAPES):
            args = _scan_inputs(2, S, H, P, N, dn, seed=i)
            y, h = ops.ssd_scan(*args, chunk=chunk)
            torch.cuda.synchronize()
            y_ref, h_ref = ref.ssd_scan_ref(*args, chunk)
            what = f"scan {dn} {(S, H, P, N, chunk)}"
            worst["scan"] = max(worst["scan"],
                                _check_close(what + " y", y, y_ref, tol),
                                _check_close(what + " state", h, h_ref, tol))
            if y.dtype != args[0].dtype or h.dtype != args[0].dtype:
                raise AssertionError(f"{what}: dtypes {y.dtype} {h.dtype}")
            cases += 1
        # ssm_forward's chunk padding: 200 live rows and 56 dt = 0 rows
        # give the final state of the 200 rows alone
        args = _scan_inputs(2, 256, 50, 64, 16, dn, seed=7, live=200)
        y, h = ops.ssd_scan(*args, chunk=128)
        torch.cuda.synchronize()
        y_ref, h_ref = ref.ssd_scan_ref(*(t[:, :200] if t.dim() > 1 else t
                                          for t in args), 128)
        worst["scan"] = max(
            worst["scan"],
            _check_close(f"scan {dn} padded y", y[:, :200], y_ref, tol),
            _check_close(f"scan {dn} padded state", h, h_ref, tol))
        cases += 1
        if dn == "f32":
            worst_f32 = dict(worst)
    print(json.dumps({"phase": "scoring_kernels", "cases": cases,
                      "max_abs_err": worst, "max_abs_err_f32": worst_f32}))
    return _time_scoring_kernels(worst) + _time_family_scoring()


def _time_gqa_entry(q, k, v, w: int, folded: tuple) -> dict:
    """The GQA entry timed beside its plain version, its bounds and one
    ``scaled_dot_product_attention`` call on the ``folded`` (BH, S, D)
    q, k, v with the band mask."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    row = _time_kernel(lambda: ops.swa_attention_gqa(q, k, v, w),
                       lambda: ref.swa_attention_gqa_ref(q, k, v, w))
    row.update(_swa_bound(q, k, w))
    i = torch.arange(q.shape[1], device="cuda")
    band = (i[:, None] - i[None, :] >= 0) & (i[:, None] - i[None, :] < w)
    row["library_ms"] = _cuda_ms(lambda: F.scaled_dot_product_attention(
        *folded, attn_mask=band), iters=50)
    return row


def _time_scoring_kernels(worst: dict) -> list:
    """The main path's entry of each scoring kernel timed at Hymba's
    full-width shapes: the attention's GQA entry (the folded entry beside
    it, under ``folded_entry``; Gemma3-12B's shape under ``gemma3_12b``)
    and the scan (one call, its three kernels)."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import ssd_scan as tscan
    out = []
    B, S, H, KV, D = HYMBA_GQA
    qg, kg, vg = _gqa_inputs(B, S, H, KV, D, "f32", seed=1)
    q, k, v = _swa_inputs(*HYMBA_SWA, "f32", seed=1)
    rows = {}
    for w in (1024, S):
        row = _time_gqa_entry(qg, kg, vg, w, (q, k, v))
        folded = _time_kernel(lambda: ops.swa_attention(q, k, v, w),
                              lambda: ref.swa_attention_ref(q, k, v, w))
        row["folded_entry"] = {**folded, **_swa_bound(q, k, w)}
        _one_kernel(f"swa_attention {HYMBA_GQA} w={w}", row)
        _one_kernel(f"swa_attention {HYMBA_SWA} w={w}", folded)
        rows[w] = row
    # Gemma3-12B's shape: each timed call held against its plain version
    qg, kg, vg = _gqa_inputs(*GEMMA_GQA, "f32", seed=2)
    Bg, Sg, Hg, _, Dg = GEMMA_GQA         # the heads folded, K/V repeated
    folded = tuple(torch.repeat_interleave(t, Hg // t.shape[2], dim=2)
                   .transpose(1, 2).reshape(Bg * Hg, Sg, Dg).contiguous()
                   for t in (qg, kg, vg))
    gemma = {}
    for w in (1024, Sg):
        worst["swa_gqa"] = max(worst["swa_gqa"], _check_close(
            f"swa gqa timed {GEMMA_GQA} w={w}",
            ops.swa_attention_gqa(qg, kg, vg, w),
            ref.swa_attention_gqa_ref(qg, kg, vg, w), SCORE_TOL["f32"]))
        row = _time_gqa_entry(qg, kg, vg, w, folded)
        _one_kernel(f"swa_attention {GEMMA_GQA} w={w}", row)
        gemma["window_1024" if w == 1024 else "window_S"] = row
    del qg, kg, vg, folded
    split = _time_split_scoring(worst)
    # the row is the 29 sliding-window layers' shape; the 3 global
    # layers' (window S) rides along under "window_S"
    out.append({"name": "swa_attention", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/swa_attention.cu",
                "replaces": "src/repro/kernels/swa_attention.py:256",
                "shape": {"B_S_H_KV_D": HYMBA_GQA, "window": 1024,
                          "dtype": "float32", "entry": "swa_attention_gqa",
                          "folded_entry_BH_S_D": HYMBA_SWA},
                "max_abs_err": max(worst["swa"], worst["swa_gqa"]),
                "max_abs_err_by_entry": {"folded": worst["swa"],
                                         "gqa": worst["swa_gqa"]},
                **rows[1024],
                "library": "F.scaled_dot_product_attention on the folded "
                           "heads, boolean band mask",
                "window_S": rows[S],
                "gemma3_12b": {"B_S_H_KV_D": GEMMA_GQA, "dtype": "float32",
                               **gemma},
                "rank_heads_on_model_16": split})
    B, S_, H, P, N, chunk = HYMBA_SCAN
    args = _scan_inputs(B, S_, H, P, N, "f32", seed=3)
    row = _time_kernel(lambda: ops.ssd_scan(*args, chunk=chunk),
                       lambda: ref.ssd_scan_ref(*args, chunk))
    _three_passes("ssd_scan", row)
    bound = _scan_bound(args[0], N)
    del args
    # the rank-head shapes first: their errors count in the row's
    split_scan = _time_split_scan(worst)
    out.append({"name": "ssd_scan", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
                "replaces": "src/repro/kernels/ssd_scan.py:100",
                "shape": {"B_S_H_P_N": HYMBA_SCAN[:5], "chunk": chunk,
                          "dtype": "float32",
                          "block_chunk": tscan.BLOCK_CHUNK},
                "max_abs_err": worst["scan"], **row, **bound,
                "library_ms": None,
                "rank_heads_on_model_2": split_scan})
    for k_ in out:
        print(json.dumps({"phase": "scoring_kernel_time", **k_}))
    return out


def _time_split_scoring(worst: dict) -> dict:
    """Kernel 5's GQA entry at each ``SPLIT_GQA`` shape (a rank's heads on
    the pod's "model" axis), f32: held against its plain version, timed
    beside it, its bounds and SDPA on the folded heads. {arch: row}."""
    import torch
    from repro_torch.kernels import ops, ref
    out = {}
    for arch, (shape, w) in SPLIT_GQA.items():
        q, k, v = _gqa_inputs(*shape, "f32", seed=13)
        B, S, H, KV, D = shape
        err = _check_close(f"swa gqa rank heads {arch} {shape} w={w}",
                           ops.swa_attention_gqa(q, k, v, w),
                           ref.swa_attention_gqa_ref(q, k, v, w),
                           SCORE_TOL["f32"])
        worst["swa_gqa"] = max(worst["swa_gqa"], err)
        folded = tuple(torch.repeat_interleave(t, H // t.shape[2], dim=2)
                       .transpose(1, 2).reshape(B * H, S, D).contiguous()
                       for t in (q, k, v))
        row = _time_gqa_entry(q, k, v, w, folded)
        _one_kernel(f"swa_attention {arch} rank heads {shape}", row)
        out[arch] = {"B_S_H_KV_D": shape, "window": w, "dtype": "float32",
                     "max_abs_err": err, **row}
        print(json.dumps({"phase": "scoring_kernel_time",
                          "name": "swa_attention", "arch": arch,
                          "rank_heads_on_model_16": out[arch]}))
        del q, k, v, folded
    return out


def _three_passes(name: str, row: dict) -> None:
    """Fails unless a whole trace of the 50 calls saw the scan's three
    passes, three distinct kernels, three launches a call."""
    if row["dropped_launches"] or row["distinct_kernels"] != 3 \
            or row["kernels_per_call"] != 3:
        raise AssertionError(
            f"{name} launched {row['distinct_kernels']} distinct kernels, "
            f"{row['kernels_per_call']} a call ({row['dropped_launches']} "
            "launches lost by the trace), not its three passes")


def _scan_f64(x, dt, A, Bm, Cm):
    """The O(S) SSD recurrence (``ref.ssd_sequential_ref``'s) in f64:
    (y, final state), the truth the f32 scans' groupings are measured
    against."""
    import torch
    x, dt, A, Bm, Cm = (t.double() for t in (x, dt, A, Bm, Cm))
    h = torch.zeros(x.shape[0], x.shape[2], x.shape[3], Bm.shape[-1],
                    dtype=torch.float64, device=x.device)
    ys = []
    for t in range(x.shape[1]):
        h = h * torch.exp(dt[:, t] * A)[..., None, None] + torch.einsum(
            "bh,bhp,bn->bhpn", dt[:, t], x[:, t], Bm[:, t])
        ys.append(torch.einsum("bhpn,bn->bhp", h, Cm[:, t]))
    return torch.stack(ys, dim=1), h


def _time_split_scan(worst: dict) -> dict:
    """Kernel 6 at each ``SPLIT_SCAN`` shape (a rank's SSD heads on a
    "model" axis of 2), f32: held against its plain version at the
    kernels' own 64-row chunk, the grouping of sums the kernels compute
    (at Mamba2's 256-row chunk the plain version's f32 cumsum of dt·A
    alone is ~1e-4 (1 + |y|) off the f64 recurrence: ``vs_f64`` gives the
    kernel's, the plain version's at the model's chunk and at 64 rows),
    timed beside the plain version at the model's chunk (the eager
    path's), its bounds. {arch: row}."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import ssd_scan as tscan
    out = {}
    for arch, (B, S, H, P, N, chunk) in SPLIT_SCAN.items():
        args = _scan_inputs(B, S, H, P, N, "f32", seed=17)
        y, h = ops.ssd_scan(*args, chunk=chunk)
        y_ref, h_ref = ref.ssd_scan_ref(*args, tscan.BLOCK_CHUNK)
        what = f"scan rank heads {arch} {(B, S, H, P, N, chunk)}"
        err = max(_check_close(what + " y", y, y_ref, SCORE_TOL["f32"]),
                  _check_close(what + " state", h, h_ref, SCORE_TOL["f32"]))
        worst["scan"] = max(worst["scan"], err)
        truth = dict(zip(("y", "state"), _scan_f64(*args)))
        runs = {"kernel": (y, h),
                "plain_model_chunk": ref.ssd_scan_ref(*args, chunk),
                "plain_kernel_chunk": (y_ref, h_ref)}
        vs_f64 = {name: {k: _rel_err({k: t.double()}, {k: truth[k]})
                         for k, t in zip(("y", "state"), run)}
                  for name, run in runs.items()}
        del y, h, y_ref, h_ref, truth, runs
        row = _time_kernel(lambda: ops.ssd_scan(*args, chunk=chunk),
                           lambda: ref.ssd_scan_ref(*args, chunk))
        _three_passes(f"ssd_scan {arch} rank heads {(B, S, H, P, N)}", row)
        out[arch] = {"B_S_H_P_N": (B, S, H, P, N), "chunk": chunk,
                     "dtype": "float32", "max_abs_err": err,
                     "plain_chunk_held_against": tscan.BLOCK_CHUNK,
                     "vs_f64": vs_f64, **row, **_scan_bound(args[0], N),
                     "library_ms": None}
        print(json.dumps({"phase": "scoring_kernel_time", "name": "ssd_scan",
                          "arch": arch, "rank_heads_on_model_2": out[arch]}))
        del args
    return out


def _time_family_scoring() -> list:
    """Kernel 5's GQA entry at each ``FAMILY_GQA`` shape, f32, its window:
    held against its plain version, timed beside its bounds and SDPA; one
    row an arch, whose launches the ``lm_families`` phase fills in."""
    import torch
    from repro_torch.kernels import ops, ref
    out = []
    for arch, (shape, w) in FAMILY_GQA.items():
        q, k, v = _gqa_inputs(*shape, "f32", seed=11)
        B, S, H, KV, D = shape
        err = _check_close(f"swa gqa timed {arch} {shape} w={w}",
                           ops.swa_attention_gqa(q, k, v, w),
                           ref.swa_attention_gqa_ref(q, k, v, w),
                           SCORE_TOL["f32"])
        folded = tuple(torch.repeat_interleave(t, H // t.shape[2], dim=2)
                       .transpose(1, 2).reshape(B * H, S, D).contiguous()
                       for t in (q, k, v))
        row = _time_gqa_entry(q, k, v, w, folded)
        _one_kernel(f"swa_attention {arch} {shape}", row)
        out.append({"name": "swa_attention", "route": "cuda",
                    "source": "src/repro_torch/kernels/csrc/swa_attention.cu",
                    "replaces": "src/repro/kernels/swa_attention.py:256",
                    "arch": arch,
                    "shape": {"B_S_H_KV_D": shape, "window": w,
                              "dtype": "float32",
                              "entry": "swa_attention_gqa"},
                    "max_abs_err": err, **row,
                    "library": "F.scaled_dot_product_attention on the "
                               "folded heads, boolean band mask"})
        del q, k, v, folded
    for k_ in out:
        print(json.dumps({"phase": "scoring_kernel_time", **k_}))
    return out


def _score_launches() -> dict:
    from repro_torch.kernels import ssd_scan, swa_attention
    return {"swa_attention": swa_attention.swa_attention.launches,
            "ssd_scan": ssd_scan.ssd_scan.launches}


def _zero_score_launches() -> None:
    from repro_torch.kernels import ssd_scan, swa_attention
    swa_attention.swa_attention.launches = 0
    ssd_scan.ssd_scan.launches = 0


def _score_batch(cfg, B, S, seed, device):
    """Random tokens and their next-token labels (the last one ignored)."""
    import numpy as np
    import torch
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int64)
    labels = np.concatenate([toks[:, 1:], np.full((B, 1), -100)], axis=1)
    return {"tokens": torch.from_numpy(toks).to(device),
            "labels": torch.from_numpy(labels).to(device)}


def _per_forward(cfg) -> dict:
    """Kernel launches one scoring forward makes: one attend per attention
    layer, one scan per SSM layer."""
    return {"swa_attention": 0 if cfg.family == "ssm" else cfg.num_layers,
            "ssd_scan": (cfg.num_layers if cfg.family in ("ssm", "hybrid")
                         else 0)}


def _score(params, cfg, batch, kernel: str):
    """(loss, logits) of one batch: ``registry.loss_fn`` and
    ``registry.logits_fn``, no autograd."""
    import torch
    from repro_torch.models import registry
    with torch.no_grad():
        loss, _ = registry.loss_fn(params, cfg, batch, kernel=kernel)
        logits = registry.logits_fn(params, cfg, batch, kernel=kernel)
    return loss, logits


def phase_scoring_card_vs_cpu(seed: int):
    """Reduced Hymba, Mamba2 and Gemma3 scored on the card (the kernels)
    and on the CPU (their plain versions), TF32 off; then Gemma3-12B at
    full width, six layers, kernels against eager on the card."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import registry
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for arch in ("hymba-1.5b", "mamba2-130m", "gemma3-12b"):
        cfg = get_config(arch).reduced()
        cpu = registry.init_params(torch.Generator().manual_seed(0), cfg,
                                   "cpu")
        card = {k: v.cuda() for k, v in cpu.items()}
        res = {}
        for dev, params in (("cuda", card), ("cpu", cpu)):
            _zero_score_launches()
            res[dev] = _score(params, cfg, _score_batch(cfg, 2, 256, 0, dev),
                              "cuda")
            want = ({k: 2 * n for k, n in _per_forward(cfg).items()}
                    if dev == "cuda" else {k: 0 for k in _score_launches()})
            if _score_launches() != want:
                raise AssertionError(f"{arch} on {dev}: launches "
                                     f"{_score_launches()}, want {want}")
        loss_err = abs(float(res["cuda"][0]) - float(res["cpu"][0])) \
            / abs(float(res["cpu"][0]))
        if loss_err > 1e-4:
            raise AssertionError(f"{arch}: loss card vs CPU {loss_err}")
        out[arch] = {"loss": float(res["cuda"][0]), "loss_rel_err": loss_err,
                     "logits_rel_err": _logits_close(
                         f"{arch} scoring logits", res["cuda"][1],
                         res["cpu"][1], rtol=1e-4)}
    print(json.dumps({"phase": "scoring_card_vs_cpu", **out}))
    _score_gemma_six_layers(seed)


def _score_kernels_vs_eager(params, cfg, batch, what: str) -> dict:
    """``batch`` scored by ``loss_fn`` and ``logits_fn`` through the kernels
    (counts zeroed just before, read just after: two forwards' launches)
    and by the eager forward (no launch): finite logits of the batch's
    shape within 1e-3·(1+|ref|), the loss within 1e-4 relative."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_score_launches()
    t0 = time.perf_counter()
    loss_k, logits_k = _score(params, cfg, batch, "cuda")
    torch.cuda.synchronize()
    wall_k = time.perf_counter() - t0
    launches = _score_launches()
    want = {k: 2 * n for k, n in _per_forward(cfg).items()}
    if launches != want:
        raise AssertionError(f"{what} launches {launches}, want {want} "
                             f"(two forwards)")
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    _zero_score_launches()
    loss_e, logits_e = _score(params, cfg, batch, "eager")
    if any(_score_launches().values()):
        raise AssertionError(f"{what}: eager scoring launched kernels: "
                             f"{_score_launches()}")
    if not (bool(torch.isfinite(logits_k).all())
            and math.isfinite(float(loss_k))):
        raise AssertionError(f"non-finite {what}")
    B, T = batch["tokens"].shape
    prefix = cfg.prefix_len if "prefix_embeds" in batch else 0
    shape = (B, T + prefix, cfg.vocab_size)
    if tuple(logits_k.shape) != shape:
        raise AssertionError(f"{what}: logits shape "
                             f"{tuple(logits_k.shape)}, want {shape}")
    logits_err = _logits_close(f"{what} logits", logits_k, logits_e)
    loss_err = abs(float(loss_k) - float(loss_e)) / abs(float(loss_e))
    if loss_err > 1e-4:
        raise AssertionError(f"{what}: loss kernel vs eager {loss_err}")
    return {"loss": float(loss_k), "loss_eager": float(loss_e),
            "loss_rel_err": loss_err, "logits_rel_err": logits_err,
            "launches": launches, "launches_per_forward": _per_forward(cfg),
            "score_wall_s_loss_and_logits": wall_k, "peak_mem_gib": peak_gib}


def _score_gemma_six_layers(seed: int) -> None:
    """Gemma3-12B at the widths of the repo's config (d_model 3840, 16
    heads over 8 kv heads of dim 240 = 3840 / 16, d_ff 15360, vocab
    262144; the published model's head dim is 256, the config sets none),
    cut in depth to its first 6 layers: five at window 1024 and layer 5
    global (every 6th). Random f32 weights from ``seed`` (~9 GB), B = 1,
    S = 2048: kernels against the eager forward on the card."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import lm, registry
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("gemma3-12b"), num_layers=6)
    if lm.global_layer_ids(cfg) != [5] or cfg.head_dim != 240:
        raise AssertionError(f"gemma3-12b cut: globals "
                             f"{lm.global_layer_ids(cfg)}, head dim "
                             f"{cfg.head_dim}")
    params = registry.init_params(
        torch.Generator(device="cuda").manual_seed(seed), cfg, "cuda")
    batch = _score_batch(cfg, 1, SCORE_S, seed, "cuda")
    res = _score_kernels_vs_eager(params, cfg, batch, "gemma3-12b scoring")
    print(json.dumps({
        "phase": "score_gemma3_six_layers", "arch": cfg.name,
        "layers": cfg.num_layers, "global_layers": lm.global_layer_ids(cfg),
        "head_dim": cfg.head_dim, "batch": [1, SCORE_S],
        "params": sum(v.numel() for v in params.values()), **res}))


def phase_score_full_width(kernels: list, seed: int) -> None:
    """Hymba-1.5B at full width, f32 weights from ``seed``: one batch of
    B = 2 sequences of 2048 tokens scored by ``loss_fn`` and ``logits_fn``
    through the kernels (the main path: counts zeroed just before, read
    just after), then by the eager forward, both timed; one kernel forward
    traced."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import lm, registry
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("hymba-1.5b")
    params = registry.init_params(
        torch.Generator(device="cuda").manual_seed(seed), cfg, "cuda")
    batch = _score_batch(cfg, SCORE_B, SCORE_S, seed, "cuda")
    res = _score_kernels_vs_eager(params, cfg, batch, "full-width scoring")
    for k in kernels:
        if "arch" not in k:            # the other configs' rows: lm_families
            k["launches"] = res["launches"][k["name"]]

    def forward(kernel):
        def run():
            with torch.no_grad():
                return lm.forward_hidden(params, cfg, batch["tokens"],
                                         kernel=kernel)
        return run

    times = {}
    for kernel in ("eager", "cuda", "cuda", "eager"):
        fn = forward(kernel)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        times.setdefault(kernel, []).append(
            (time.perf_counter() - t0) / 3 * 1e3)
    print(json.dumps({
        "phase": "score_full_width", "arch": cfg.name,
        "batch": [SCORE_B, SCORE_S], **res, "forward_hidden_ms": times,
        # the copy, index and repeat kernels of each forward: the attend's
        # repeat / fold / unfold are gone from the kernel path
        "forward_profile": _profile(forward("cuda"), 1, top=16,
                                    match=COPY_KERNELS),
        "forward_profile_eager": _profile(forward("eager"), 1,
                                          match=COPY_KERNELS)}))


# ---------------------------------------------------------------------------
# The LM training and single-batch serving slice
# ---------------------------------------------------------------------------

LM_TRAIN_STEPS = 4
LM_TRAIN_SHAPE = (2, 2048)       # B x S; SHAPES["train_4k"] is 256 x 4096
# reduced train step, card vs CPU at f32 (TF32 off): max |param err| and
# max relative loss err, the limits of tests/test_torch_cuda_lm.py
LM_TRAIN_TOL = {"params": 1e-5, "losses": 1e-5}
LM_KD = (4, 4, 64)               # H steps of B x S: R = 256 rows
LM_KD_SHAPES = ((256, 50280), (256, 32001))     # mamba2-130m, hymba-1.5b
# kernels 1 / 1b at the LM shapes: forward |err| <= fwd * |plain|,
# backward |err| <= bwd * (the size of ds's terms), ``_lm_kd_check``;
# about 3x the largest measured on an H100 (1.6e-7 and 1.8e-6)
LM_KD_RTOL = {"fwd": 5e-7, "bwd": 5e-6}
LM_SERVE_PROMPT = 1536           # past Hymba's window of 1024
LM_SERVE_TOKENS = 8


class _SynthLoader:
    """A client's data as ``registry.synth_batch`` draws it: each call a
    new local epoch of ``steps`` (B, S) batches at the config's
    vocabulary, seeded by (seed, epoch), as numpy for the engines."""

    def __init__(self, cfg, batch: int, seq: int, steps: int, seed: int):
        self.cfg, self.steps, self.seed, self._epoch = cfg, steps, seed, 0
        from repro_torch.types import ShapeConfig
        self.shape = ShapeConfig("train", seq_len=seq, global_batch=batch,
                                 kind="train")

    def __call__(self):
        import numpy as np
        from repro_torch.models import registry
        self._epoch += 1
        rng = np.random.default_rng((self.seed, self._epoch))
        for _ in range(self.steps):
            yield {k: v.numpy() for k, v in registry.synth_batch(
                rng, self.cfg, self.shape, device="cpu").items()}


def _err_over(got, want, scale) -> float:
    """max |got - want| / scale, elementwise; where scale is 0 the kernel
    must match exactly (inf otherwise)."""
    import torch
    diff = (got.float() - want.float()).abs()
    zero = torch.zeros((), device=diff.device)
    inf = torch.full((), math.inf, device=diff.device)
    return float(torch.where(scale > 0, diff / scale.clamp(min=1e-38),
                             torch.where(diff > 0, inf, zero)).max())


def _lm_kd_cases(R, V):
    """The inputs kernels 1 and 1b are held at for one LM shape (T = 1, as
    the KD epoch runs them): (name, s, t, labels, alpha, valid, g).
    ``mixed``: independent N(0, 1) logits, alpha 0.5, three rows masked,
    a row cotangent of stride 1 (the squared error is ~V, so the CE half
    is ~1e-4 of the loss here); ``ce``: alpha 1, so the loss and ds are the
    CE half alone; ``near``: the teacher the student plus N(0, 0.01^2)
    noise, alpha 0.5, so the two halves of the loss are of one size. The
    last two have no mask and the stride-0 cotangent of a mean, as the
    epoch's call."""
    import torch
    s, t, lab = _kd_inputs(R, V, torch.float32, seed=V)
    valid = torch.ones(R, device="cuda")
    valid[-3:] = 0.0
    g = torch.full((R,), 1.0 / R, device="cuda")
    g0 = torch.full((1,), 1.0 / R, device="cuda").expand(R)
    noise = torch.randn(R, V, generator=torch.Generator().manual_seed(V + 1))
    near = s + 0.01 * noise.to("cuda")
    return [("mixed", s, t, lab, 0.5, valid, g),
            ("ce", s, t, lab, 1.0, None, g0),
            ("near", s, near, lab, 0.5, None, g0)]


def _lm_kd_check(s, t, lab, alpha, valid, g) -> dict:
    """Kernels 1 and 1b against their plain versions on one input.

    The forward's error is relative to the plain loss on live rows (masked
    rows must be exactly 0). The backward's is relative, elementwise, to
    the size of ds's two terms, alpha |g (p - y)| + (1 - alpha) |2 g (s -
    t)| (dt's: the second), not to 1 + |ds|: ds is ~1/R, so an absolute
    floor would pass any CE half. Both backward calls are held, with dt and
    without."""
    import torch
    from repro_torch.kernels import kd_loss, ref
    got = kd_loss.kd_loss_fused(s, t, lab, alpha, 1.0, valid=valid)
    want = ref.kd_loss_ref(s, t, lab, alpha, 1.0, valid=valid)
    out = {"fwd_max_abs_err": float((got - want).abs().max()),
           "fwd_rel_err": _err_over(got, want, want.abs())}
    lse = torch.empty(s.shape[0], device="cuda")
    kd_loss._fused_fwd(s, t, lab, alpha, 1.0, valid, lse)
    want_ds, want_dt = kd_loss.kd_loss_rows_bwd(s, t, lab, valid, g, alpha,
                                                1.0)
    ce = kd_loss.kd_loss_rows_bwd(s, t, lab, valid, g, 1.0, 1.0)[0].abs()
    sq = kd_loss.kd_loss_rows_bwd(s, t, lab, valid, g, 0.0, 1.0)[0].abs()
    scale = alpha * ce + (1.0 - alpha) * sq
    abs_err, rel_err = 0.0, 0.0
    for need_dt in (True, False):
        ds, dt = kd_loss.kd_loss_fused_bwd(s, t, lab, valid, g, lse, alpha,
                                           1.0, need_dt=need_dt)
        pairs = [(ds, want_ds, scale)]
        if need_dt:
            pairs.append((dt, want_dt, (1.0 - alpha) * sq))
        elif dt is not None:
            raise AssertionError("kd_loss_fused_bwd wrote dt unasked")
        for a, b, sc in pairs:
            abs_err = max(abs_err, float((a - b).abs().max()))
            rel_err = max(rel_err, _err_over(a, b, sc))
    out.update(bwd_max_abs_err=abs_err, bwd_rel_err=rel_err)
    return out


def _lm_kd_kernel_rows(kernels: list) -> None:
    """Kernels 1 and 1b alone at R = 256 rows of the LM vocabularies, f32:
    against their plain versions on ``_lm_kd_cases`` within
    ``LM_KD_RTOL``, then timed as ``_time_kernel`` times them beside their
    bound (bytes at 3.35 TB/s): recorded on the two KD rows of ``kernels``
    under ``lm_shapes``."""
    import torch
    from repro_torch.kernels import kd_loss, ref
    from repro_torch.roofline import analysis
    for R, V in LM_KD_SHAPES:
        cases, checks = _lm_kd_cases(R, V), {}
        for name, *case in cases:
            checks[name] = _lm_kd_check(*case)
            print(json.dumps({"phase": "lm_kd_kernel_check", "R": R, "V": V,
                              "case": name, "rtol": LM_KD_RTOL,
                              **checks[name]}))
        err_f = max(c["fwd_max_abs_err"] for c in checks.values())
        err_b = max(c["bwd_max_abs_err"] for c in checks.values())
        bad = {n: c for n, c in checks.items()
               if c["fwd_rel_err"] > LM_KD_RTOL["fwd"]
               or c["bwd_rel_err"] > LM_KD_RTOL["bwd"]}
        if bad:
            raise AssertionError(f"KD kernels at ({R}, {V}): {bad}")
        _, s, t, lab, _, _, g = cases[0]
        lse = torch.empty(R, device="cuda")
        # timed as the KD step calls them: no mask, the backward without dt
        fwd = _time_kernel(
            lambda: kd_loss._fused_fwd(s, t, lab, 0.5, 1.0, None, lse),
            lambda: ref.kd_loss_ref(s, t, lab, 0.5))
        bwd = _time_kernel(
            lambda: kd_loss.kd_loss_fused_bwd(s, t, lab, None, g, lse, 0.5,
                                              1.0, need_dt=False),
            lambda: kd_loss.kd_loss_rows_bwd(s, t, lab, None, g, 0.5, 1.0))
        _one_kernel(f"kd_loss ({R}, {V})", fwd)
        _one_kernel(f"kd_loss_bwd ({R}, {V})", bwd)
        for name, row, cost, err in (
                ("kd_loss", fwd, analysis.kd_loss_cost(R, V), err_f),
                ("kd_loss_bwd", bwd, analysis.kd_loss_bwd_cost(R, V),
                 err_b)):
            out = {**row, "max_abs_err": err, "library_ms": None,
                   **_bound(cost)}
            print(json.dumps({"phase": "lm_kd_kernel_time", "name": name,
                              "R": R, "V": V, **out}))
            for k in kernels:
                if k["name"] == name:
                    k.setdefault("lm_shapes", {})[f"{R}x{V}"] = out


def _lm_line(report: dict, part: str) -> None:
    """One part of an LM phase, printed as soon as it has passed."""
    print(json.dumps({"phase": "lm_train", "part": part,
                      "card": report["card"], **report[part]}))


def phase_lm_train(kernels: list) -> None:
    """The LM training slice on the card.

    (a) ``launch.steps.make_train_step`` on Hymba-1.5B at full width (f32
    params, bf16 compute, remat), ``LM_TRAIN_STEPS`` steps of B x S =
    ``LM_TRAIN_SHAPE`` tokens from ``registry.synth_batch``: each step's
    ms by CUDA events, the peak device memory, finite losses; (b) the
    same step at Hymba's reduced config and f32 compute, card against CPU
    in ``_Exact``; (c) LM distillation at full width, Mamba2-130M into
    Mamba2-130M (``make_distill_engine``), one eager and one replayed
    epoch of H x B x S = ``LM_KD``: kernels 1 and 1b at R = 256, V =
    50280, H of each on the card by the profiler in each, replay against
    eager bit for bit in ``_Exact``; (d) kernels 1 and 1b alone at
    ``LM_KD_SHAPES``, against their plain versions and timed; (e)
    ``run_async`` on Mamba2-130M at full width, four Jetsons x 4 global
    epochs, each client's data ``synth_batch`` batches of 4 x 64 tokens, on
    ``scan`` and ``loop`` in ``_Exact``: params bit for bit, clocks equal,
    the engine's [signatures, captures]; (f) ``launch.train --arch
    mamba2-130m --reduced`` in ``--mode central`` and ``async`` (the
    Markov token stream at vocabulary 512)."""
    import gc
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import distill, fed_engine, simulator
    from repro_torch.core.fleet import Fleet
    from repro_torch.launch import steps
    from repro_torch.launch.train import build_fleet
    from repro_torch.models import registry
    from repro_torch.types import DistillConfig, FedConfig, ShapeConfig
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    report = {"phase": "lm_train", "card": _card_line()}

    # (a) the train step at full width
    cfg = get_config("hymba-1.5b")
    B, S = LM_TRAIN_SHAPE
    shape = ShapeConfig("train", seq_len=S, global_batch=B, kind="train")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held_before = torch.cuda.memory_allocated()
    rng = np.random.default_rng(0)
    batches = [registry.synth_batch(rng, cfg, shape, device="cuda")
               for _ in range(LM_TRAIN_STEPS)]
    params = registry.init_params(
        torch.Generator(device="cuda").manual_seed(0), cfg, "cuda")
    step, opt = steps.make_train_step(cfg, FedConfig())
    state, anchor = opt.init(params), dict(params)
    step_ms, losses = [], []
    for b in batches:
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        params, state, loss = step(params, state, anchor, b)
        t1.record()
        torch.cuda.synchronize()
        step_ms.append(t0.elapsed_time(t1))
        losses.append(float(loss))
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"hymba-1.5b train step: losses {losses}")
    report["train_step_full_width"] = {
        "arch": cfg.name, "batch": B, "seq_len": S,
        "params": sum(v.numel() for v in params.values()),
        "compute": "bf16", "step_ms": step_ms, "losses": losses,
        # the part's own peak: params, batches, optimizer state and the
        # steps' work, above what earlier phases still held
        "peak_gb": (torch.cuda.max_memory_allocated() - held_before)
        / 2 ** 30, "held_before_gb": held_before / 2 ** 30}
    _lm_line(report, "train_step_full_width")
    del params, state, anchor, batches
    gc.collect()
    torch.cuda.empty_cache()

    # (b) reduced, f32 compute, card vs CPU
    rcfg = cfg.reduced()
    rng = np.random.default_rng(1)
    rb = [registry.synth_batch(rng, rcfg, ShapeConfig("t", 64, 2, "train"),
                               device="cpu") for _ in range(3)]
    out = {}
    with _Exact():
        for dev in ("cpu", "cuda"):
            p = registry.init_params(torch.Generator().manual_seed(0), rcfg,
                                     "cpu")
            p = {k: v.to(dev) for k, v in p.items()}
            st_, op = steps.make_train_step(rcfg, FedConfig(lr=0.05),
                                            loss_kwargs={"dtype": None})
            ost, anc, ls = op.init(p), dict(p), []
            for b in rb:
                p, ost, l = st_(p, ost, anc, b)
                ls.append(float(l))
            out[dev] = (p, ls)
    cpu_p, cpu_l = out["cpu"]
    card_p = {k: v.cpu() for k, v in out["cuda"][0].items()}
    p_err = max(float((card_p[k] - cpu_p[k]).abs().max()) for k in cpu_p)
    l_err = max(abs(a - b) / abs(b) for a, b in zip(out["cuda"][1], cpu_l))
    if p_err > LM_TRAIN_TOL["params"] or l_err > LM_TRAIN_TOL["losses"]:
        raise AssertionError(f"reduced train step card vs CPU: params "
                             f"{p_err}, losses {l_err}")
    report["train_step_reduced_card_vs_cpu"] = {
        "param_max_abs_err": p_err, "loss_rel_err": l_err,
        "tol": LM_TRAIN_TOL}
    _lm_line(report, "train_step_reduced_card_vs_cpu")

    # (c) LM distillation at full width through kernels 1 and 1b
    mcfg = get_config("mamba2-130m")
    H, KB, KS = LM_KD
    dcfg = DistillConfig(lr=0.01, chain=(mcfg.name, mcfg.name))
    loader = _SynthLoader(mcfg, KB, KS, H, seed=2)
    stacked = {k: np.stack([b[k] for b in loader()])
               for k in ("tokens", "labels")}
    teacher = registry.init_params(
        torch.Generator(device="cuda").manual_seed(1), mcfg, "cuda")
    student = registry.init_params(
        torch.Generator(device="cuda").manual_seed(2), mcfg, "cuda")
    engine = distill.make_distill_engine(mcfg, mcfg, dcfg)
    opt_state = engine.opt.init(student)
    on_card = {k: torch.as_tensor(v, device="cuda")
               for k, v in stacked.items()}
    kd = {}
    with _Exact():
        _zero_kd_launches()
        want, ran_eager = _traced_kd(lambda: engine._epoch(
            teacher, student, opt_state["mom"], on_card))
        host_eager = _kd_launches()
        runs = []
        for _ in range(3):             # eager, capture, replay
            _zero_kd_launches()
            out_, ran = _traced_kd(lambda: engine.epoch(
                teacher, student, opt_state, stacked))
            runs.append((out_, ran, _kd_launches()))
    err = max(_rel_err(o[0], want[0]) for o, _, _ in runs)
    l_equal = all(torch.equal(o[2], want[2]) for o, _, _ in runs)
    _expect_launches("LM KD epoch, eager: host", host_eager, H)
    _expect_launches("LM KD epoch, eager: card", ran_eager, H)
    _expect_launches("LM KD epoch, replay: card", runs[2][1], H)
    _expect_launches("LM KD epoch, replay: host", runs[2][2], 0)
    if err != 0.0 or not l_equal:
        raise AssertionError(f"LM KD epoch replay vs eager: {err}")
    if not all(math.isfinite(x) for x in want[2].tolist()):
        raise AssertionError(f"LM KD epoch losses {want[2].tolist()}")
    kd.update(arch=mcfg.name, H=H, batch=KB, seq_len=KS, rows=KB * KS,
              vocab=mcfg.vocab_size, replay_vs_eager=err,
              losses=want[2].tolist(),
              kd_launches={"eager": {"host": host_eager, "card": ran_eager},
                           "capture": {"host": runs[1][2],
                                       "card": runs[1][1]},
                           "replay": {"host": runs[2][2],
                                      "card": runs[2][1]}},
              signatures_and_captures=[engine.num_compiled,
                                       engine._graphs.num_captured])
    engine.epoch(teacher, student, opt_state, stacked)     # default switches
    kd["replay_ms_per_epoch"] = _wall_ms(
        lambda: engine.epoch(teacher, student, opt_state, stacked))
    report["lm_kd_epoch"] = kd
    _lm_line(report, "lm_kd_epoch")
    for k in kernels:
        if k["name"] in ran_eager:
            k.setdefault("launches_by_path", {})["lm_kd_epoch"] = {
                "eager_host": host_eager[k["name"]],
                "eager_card": ran_eager[k["name"]],
                "replay_host": runs[2][2][k["name"]],
                "replay_card": runs[2][1][k["name"]]}
    del teacher, student, opt_state, engine
    gc.collect()
    torch.cuda.empty_cache()

    # (d) kernels 1 and 1b alone at the LM vocabularies
    _lm_kd_kernel_rows(kernels)

    # (e) run_async at full width, scan against loop
    fed = FedConfig(num_clients=4, global_epochs=4)
    params0 = registry.init_params(
        torch.Generator(device="cuda").manual_seed(3), mcfg, "cuda")
    res, wall = {}, {}
    with _Exact():
        for eng in ("scan", "loop"):
            fleet = Fleet.from_lists(build_fleet(4), [
                _SynthLoader(mcfg, 4, 64, fed.local_iters_max, seed=k)
                for k in range(4)])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res[eng] = simulator.run_async(params0, mcfg, fed, fleet,
                                           engine=eng, device="cuda")
            torch.cuda.synchronize()
            wall[eng] = time.perf_counter() - t0
    a_err = _rel_err(res["scan"].params, res["loop"].params)
    if (res["scan"].wall_clock_s != res["loop"].wall_clock_s
            or res["scan"].staleness_hist != res["loop"].staleness_hist
            or a_err != 0.0 or not math.isfinite(res["scan"].final_loss)):
        raise AssertionError(f"mamba2-130m run_async scan vs loop: {a_err}")
    eng = fed_engine.make_client_run(mcfg, fed, algorithm="fedprox")
    report["lm_async_full_width"] = {
        "arch": mcfg.name, "clients": 4, "global_epochs": 4,
        "virtual_wall_s": res["scan"].wall_clock_s,
        "final_loss": res["scan"].final_loss, "scan_vs_loop": a_err,
        "real_wall_s": wall,
        "signatures_and_captures": [eng.num_compiled,
                                    eng._graphs.num_captured]}
    _lm_line(report, "lm_async_full_width")
    del params0, res
    gc.collect()
    torch.cuda.empty_cache()

    # (f) the trainer on the reduced Mamba2 and its Markov token stream
    report["train_cli"] = {}
    for mode, extra in (("central", ["--steps", "8"]),
                        ("async", ["--epochs", "4"])):
        t0 = time.perf_counter()
        r = _train(["--arch", "mamba2-130m", "--reduced", "--mode", mode,
                    "--device", "cuda"] + extra)
        if not math.isfinite(r["final_loss"]):
            raise AssertionError(f"train mamba2-130m {mode}: {r}")
        report["train_cli"][mode] = {"result": r,
                                     "call_s": time.perf_counter() - t0}
    _lm_line(report, "train_cli")
    print(json.dumps({"phase": "lm_train", "card": report["card"],
                      "phase_s": time.perf_counter() - t_phase}))


def _static_decode_replays(params, cfg, seed: int) -> dict:
    """The static decode as ``serve.generate`` runs it at the CLI's shape
    (B 4, prompt 32, 16 tokens: a cache of 48 positions), in ``_Exact``:
    each step ``serve.greedy_step`` through a ``GraphCache`` with the
    params, the cache, the token and the positions in place (the second
    step captured, later ones replayed), against the eager step on copies:
    logits, cache and state 0.0 apart; ``generate``'s tokens equal to the
    eager steps'. Then a replayed step timed and traced (its positions
    reset before each, so the cache holds them)."""
    import functools
    import numpy as np
    import torch
    from repro_torch.core.compile_cache import GraphCache
    from repro_torch.launch import serve
    from repro_torch.models import registry
    from repro_torch.types import ShapeConfig
    B, P, gen = 4, 32, 16
    dev = params["embed"].device
    batch = registry.synth_batch(
        np.random.default_rng(seed), cfg,
        ShapeConfig("serve", seq_len=P, global_batch=B, kind="decode"),
        device=dev)
    step = functools.partial(serve.greedy_step, cfg)
    graphs = GraphCache()
    with _Exact(), torch.no_grad():
        cache = registry.init_cache(cfg, B, P + gen, torch.float32, dev)
        logits, cache = registry.prefill(params, cfg, batch, cache,
                                         q_chunk=P)
        state = {"tok": torch.argmax(logits, dim=-1).to(torch.int32),
                 "pos": torch.full((B,), P, dtype=torch.int32, device=dev)}
        twin = [{k: v.clone() for k, v in cache.items()},
                {k: v.clone() for k, v in state.items()}]
        eager = [state["tok"].cpu().numpy().copy()]
        for i in range(gen - 1):
            lg, cache, state = graphs.call("decode", step,
                                           (params, cache, state),
                                           inplace=(0, 1, 2))
            want, *twin = step(params, *twin)
            apart = [k for k in cache if not torch.equal(cache[k],
                                                         twin[0][k])]
            if apart or not torch.equal(lg, want) or any(
                    not torch.equal(state[k], twin[1][k]) for k in state):
                raise AssertionError(
                    f"static decode step {i}: replayed vs eager logits "
                    f"{float((lg - want).abs().max())} apart, cache leaves "
                    f"{apart} apart")
            eager.append(twin[1]["tok"].cpu().numpy().copy())
        toks = serve.generate(params, cfg, batch, P + gen, gen)[0]
    if not np.array_equal(toks, np.stack(eager, axis=1)):
        raise AssertionError("generate's tokens differ from the eager "
                             "steps'")
    if graphs.num_captured != 1:
        raise AssertionError(f"{graphs.num_captured} captures, want 1")

    def replay():
        state["pos"].fill_(P + 8)
        return graphs.call("decode", step, (params, cache, state),
                           inplace=(0, 1, 2))
    with _Exact(), torch.no_grad():     # the captured graph's switches
        out = {"batch": B, "prompt": P, "tokens": gen, "captures": 1,
               "steps_max_abs_diff": 0.0, "generate_tokens_equal": True,
               "replayed_wall_ms": _wall_ms(replay, 20),
               "replayed": _profile(replay, 3)}
    if graphs.num_captured != 1:
        raise AssertionError("the timed replays captured again")
    graphs.clear()
    return out


def phase_lm_serve(seed: int) -> None:
    """Single-batch serving at full width (Hymba-1.5B, f32): ``python -m
    repro_torch.launch.serve --arch hymba-1.5b --batch 4 --prompt-len 32
    --gen 16``, the static path, its prefill and decode ms; then, from one
    prefill of ``LM_SERVE_PROMPT`` tokens (past the window), the ring
    decode (``to_ring_cache``, ``decode_step_ring``) and the unrolled
    window-sliced decode against the uniform decode for
    ``LM_SERVE_TOKENS`` tokens: greedy tokens equal, logits within
    1e-3 * (1 + |uniform|); and ``steps.make_serve_step`` in the three
    variants giving the same tokens."""
    import contextlib
    import io
    import re
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import serve, steps
    from repro_torch.models import lm, registry
    from repro_torch.types import ShapeConfig
    t_phase = time.perf_counter()
    report = {"phase": "lm_serve", "card": _card_line()}
    argv = ["--arch", "hymba-1.5b", "--batch", "4", "--prompt-len", "32",
            "--gen", "16", "--seed", str(seed), "--device", "cuda"]
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = serve.main(argv)
    text = buf.getvalue()
    if rc != 0 or "sample generations" not in text:
        raise AssertionError(f"serve {argv}: exit {rc}\n{text}")
    ms = dict(re.findall(r"^(prefill|decode):\s+([0-9.]+) ms", text, re.M))
    report["serve_cli"] = {"argv": argv,
                           "prefill_ms": float(ms["prefill"]),
                           "decode_ms": float(ms["decode"]),
                           "decode_ms_per_token": float(ms["decode"]) / 15,
                           "call_s": time.perf_counter() - t0}

    cfg = get_config("hymba-1.5b")
    params = registry.init_params(
        torch.Generator(device="cuda").manual_seed(seed), cfg, "cuda")
    report["static_decode"] = _static_decode_replays(params, cfg, seed)
    P, T = LM_SERVE_PROMPT, LM_SERVE_TOKENS
    toks = registry.synth_batch(
        np.random.default_rng(seed), cfg,
        ShapeConfig("serve", seq_len=P, global_batch=2, kind="decode"),
        device="cuda")["tokens"]
    with torch.no_grad():
        cache = registry.init_cache(cfg, 2, P + T, torch.float32, "cuda")
        logits, cache = registry.prefill(params, cfg, {"tokens": toks},
                                         cache, q_chunk=512)
    first = torch.argmax(logits, dim=-1).to(torch.int32)
    base = {k: v.clone() for k, v in cache.items()}
    caches = {"uniform": cache, "ring": lm.to_ring_cache(cfg, base, P),
              "sliced": {k: v.clone() for k, v in base.items()}}
    if caches["ring"]["k_win"].shape[2] != cfg.sliding_window:
        raise AssertionError("the ring cache holds no W-slot rings")
    decode = {
        "uniform": lambda t, c, p: lm.decode_step(params, cfg, t, c, p),
        "ring": lambda t, c, p: lm.decode_step_ring(params, cfg, t, c, p),
        "sliced": lambda t, c, p: lm.decode_step(
            params, cfg, t, c, p, unroll=True, window_slice=True)}
    tok = {k: first for k in decode}
    gen = {k: [] for k in decode}
    errs = {"ring": 0.0, "sliced": 0.0}
    with torch.no_grad():
        for i in range(T):
            lg = {}
            for k, fn in decode.items():
                lg[k], caches[k] = fn(tok[k], caches[k], P + i)
                tok[k] = torch.argmax(lg[k], dim=-1).to(torch.int32)
                gen[k].append(tok[k].cpu().tolist())
            for k in errs:
                errs[k] = max(errs[k], _logits_close(
                    f"{k} decode vs uniform, token {i}", lg[k],
                    lg["uniform"]))
    if gen["ring"] != gen["uniform"] or gen["sliced"] != gen["uniform"]:
        raise AssertionError(f"decode tokens differ: {gen}")
    # the serve steps, greedy, from the same prefill
    variants = {"uniform": (steps.make_serve_step(cfg), base),
                "ring": (steps.make_serve_step(cfg, ring=True),
                         lm.to_ring_cache(cfg, base, P)),
                "sliced": (steps.make_serve_step(cfg, unroll=True,
                                                 window_slice=True),
                           {k: v.clone() for k, v in base.items()})}
    for name, (step, c) in variants.items():
        t, got = first, []
        t0 = time.perf_counter()
        for i in range(T):
            t, c = step(params, t, c, P + i)
            got.append(t.cpu().tolist())
        report.setdefault("serve_step_ms", {})[name] = \
            (time.perf_counter() - t0) / T * 1e3
        if got != gen["uniform"]:
            raise AssertionError(f"make_serve_step({name}) tokens {got}")
    report["decode_variants"] = {
        "prompt": P, "tokens": T, "batch": 2,
        "logit_rel_err_vs_uniform": errs, "tokens_equal": True,
        "ring_cache_mb": sum(v.numel() * v.element_size()
                             for v in caches["ring"].values()) / 2 ** 20,
        "uniform_cache_mb": sum(v.numel() * v.element_size()
                                for v in base.values()) / 2 ** 20}
    report["phase_s"] = time.perf_counter() - t_phase
    print(json.dumps(report))


# ---------------------------------------------------------------------------
# The rest of the LM stack: the moe, vlm and encdec families and the other
# dense configs, scored and served at their configs' widths
# ---------------------------------------------------------------------------

# {arch: (layers kept (None: all), B, S)}: S counts paligemma's prefix
FAMILY_SCORE = {"h2o-danube-3-4b": (None, 1, 4096),
                "llama4-scout-17b-a16e": (4, 1, SCORE_S),
                "grok-1-314b": (2, 1, SCORE_S),
                "paligemma-3b": (None, 2, SCORE_S)}
# the batchers' request streams: prompt lengths, 16 new tokens each
H2O_PROMPTS = (1, 7, 100, 513, 1100, 1500)
LLAMA4_PROMPTS = (1, 33, 100, 513)
FAMILY_TOKENS = 16
SEAMLESS_FRAMES = 512


def _release_engines() -> float:
    """Forget every memoized engine and the async mix's graphs, which
    earlier phases leave holding their captured graphs' memory pools (the
    runs below need the card's memory: up to ~54 GB a model). Returns the
    GiB still allocated after."""
    import gc
    import torch
    from repro_torch.core import compile_cache, fed_engine, fedasync
    fed_engine._ENGINE_CACHE.clear()
    fedasync._GRAPHS = compile_cache.GraphCache()
    gc.collect()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated() / 2 ** 30


def _family_cfg(arch: str):
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    keep = FAMILY_SCORE.get(arch, (None,))[0]
    return cfg if keep is None else dataclasses.replace(cfg,
                                                        num_layers=keep)


def _family_params(cfg, seed: int):
    import torch
    from repro_torch.models import registry
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    params = registry.init_params(
        torch.Generator(device="cuda").manual_seed(seed), cfg, "cuda")
    torch.cuda.synchronize()
    return params, {"params": sum(v.numel() for v in params.values()),
                    "weights_gb": sum(v.numel() * v.element_size()
                                      for v in params.values()) / 1e9,
                    "init_peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                    "init_s": time.perf_counter() - t0}


def _free(*objs) -> None:
    import gc
    import torch
    for o in objs:
        if isinstance(o, dict):
            o.clear()
    gc.collect()
    torch.cuda.empty_cache()


def _family_batch(cfg, B: int, S: int, seed: int):
    """B sequences of S positions: the registry's synthesised batch (a
    VLM's S includes its patch prefix), labels the next tokens."""
    import numpy as np
    import torch
    from repro_torch.models import registry
    from repro_torch.types import ShapeConfig
    batch = registry.synth_batch(np.random.default_rng(seed), cfg,
                                 ShapeConfig("score", seq_len=S,
                                             global_batch=B, kind="train"),
                                 device="cuda")
    toks = batch["tokens"].long()
    batch["tokens"] = toks
    batch["labels"] = torch.cat([toks[:, 1:], torch.full_like(toks[:, :1],
                                                              -100)], dim=1)
    return batch


def _greedy_ties(what: str, want, lk, le) -> int:
    """The kernel decode's logits ``lk`` and the eager decode's ``le`` (n,
    V) at one step, fed the same tokens, against the kernel run's own
    greedy tokens ``want`` (n,): the kernel decode picks them again, and
    so does the eager decode unless the eager logits of ``want`` are
    within twice the two decodes' difference (that row's max) of the
    eager maximum, a tie that no exact comparison decides. Returns the
    ties."""
    import torch
    want = torch.as_tensor(want, device=lk.device).long()
    if not torch.equal(lk.argmax(dim=-1), want):
        raise AssertionError(f"{what}: the kernel decode, replayed, picks "
                             f"{lk.argmax(dim=-1).tolist()} not "
                             f"{want.tolist()}")
    te = le.argmax(dim=-1)
    diff = (lk - le).abs().max(dim=-1).values
    gap = le.max(dim=-1).values - le.gather(-1, want[:, None])[:, 0]
    if bool(((te != want) & (gap > 2 * diff)).any()):
        raise AssertionError(f"{what}: eager picks {te.tolist()}, the "
                             f"kernels {want.tolist()} (gap {gap.tolist()}, "
                             f"difference {diff.tolist()})")
    return int((te != want).sum())


def _family_serve(params, cfg, prompts, max_len: int, seed: int) -> dict:
    """The continuous batcher in ring mode on the CUDA decode kernels,
    its ticks replays of one graph a K-extent rung, traced (counts zeroed
    just before, read just after; the card's from the profiler's device
    events). Then each admitted group again, the kernel decode and the
    eager decode fed the kernel run's tokens tick by tick
    (``_forced_ticks``): logits within 1e-3 (1 + |eager|), the same greedy
    tokens (``_greedy_ties``)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    reqs = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
            for n in prompts]
    kw = dict(max_slots=4, max_len=max_len, min_bucket=8,
              decode_mode="ring")
    _zero_decode_launches()
    (srv, toks), events, wall_ms, lost = _trace(
        lambda: _serve(params, cfg, reqs, FAMILY_TOKENS,
                       decode_kernel="cuda", **kw))
    launches = _decode_launches()
    if any(len(t) != FAMILY_TOKENS for t in toks.values()):
        raise AssertionError(f"{cfg.name} serve tokens {toks}")
    graphs = _serve_counts(f"{cfg.name} serve", srv, launches,
                           _decode_on_card(events),
                           [e.name() for e in events])
    busy_ms = sum(e.duration_ns() for e in events) / 1e6
    graphs.update(_release_graphs(srv), dropped_launches=lost["calls"])
    _free(srv.cache)
    ticks = srv._steps
    # every request asks for as many tokens, so the slots free together
    # and the groups are admitted in order, max_slots at a time
    errs, ties = [], 0
    for g0 in range(0, len(reqs), kw["max_slots"]):
        ids = range(g0, min(g0 + kw["max_slots"], len(reqs)))
        forced = np.zeros((FAMILY_TOKENS - 1, kw["max_slots"]), np.int32)
        for j, rid in enumerate(ids):
            forced[:, j] = toks[rid][:-1]
        logits = {}
        for kern in ("cuda", "eager"):
            adm = _admitted(params, cfg, [reqs[r] for r in ids],
                            decode_kernel=kern, **kw)
            logits[kern] = _forced_ticks(adm, forced, "ring")
            _free(adm.cache)
        n = len(ids)
        for t, (lk, le) in enumerate(zip(logits["cuda"], logits["eager"])):
            what = f"{cfg.name} requests {list(ids)} tick {t}"
            errs.append(_logits_close(what, lk[:n], le[:n]))
            ties += _greedy_ties(what, [toks[r][t + 1] for r in ids],
                                 lk[:n], le[:n])
    n_tok = sum(len(t) for t in toks.values())
    return {"prompts": list(prompts), "max_len": max_len,
            "decode_ticks": ticks, "launches": launches, "graphs": graphs,
            "forced_logits_rel_err_vs_eager": max(errs),
            "greedy_ties_vs_eager": ties, "traced_wall_s": wall_ms / 1e3,
            "gen_tok_per_s_traced": n_tok / (wall_ms / 1e3),
            "device_busy_share_traced": busy_ms / wall_ms,
            "prefill_compiles": srv.prefill_compiles,
            "decode_compiles": srv.decode_compiles,
            "bucket_hist": {str(k): v for k, v in srv.bucket_hist.items()}}


def _family_reduced_card_vs_cpu() -> dict:
    """The seven configs reduced (h2o-danube also at d_model 480: head dim
    120) scored on the card (kernel 5; the encoder-decoder eagerly) and on
    the CPU (the plain versions), in ``_Exact``: logits within
    1e-4 (1 + |cpu|), loss within 1e-4 relative."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import registry
    from repro_torch.types import ShapeConfig
    out = {}
    with _Exact():
        for arch in ("internlm2-20b", "h2o-danube-3-4b", "minitron-4b",
                     "paligemma-3b", "llama4-scout-17b-a16e", "grok-1-314b",
                     "seamless-m4t-large-v2", "h2o-danube-3-4b@480"):
            name, _, d = arch.partition("@")
            cfg = get_config(name).reduced(d_model=int(d or 256))
            cpu = registry.init_params(torch.Generator().manual_seed(0), cfg,
                                       "cpu")
            card = {k: v.cuda() for k, v in cpu.items()}
            batch = registry.synth_batch(
                np.random.default_rng(1), cfg,
                ShapeConfig("s", seq_len=256, global_batch=2, kind="train"),
                device="cpu")
            kernel = "eager" if cfg.is_encdec else "cuda"
            res = {}
            for dev, params in (("cuda", card), ("cpu", cpu)):
                b = {k: v.to(dev) for k, v in batch.items()}
                with torch.no_grad():
                    loss, m = registry.loss_fn(params, cfg, b, kernel=kernel)
                    logits = registry.logits_fn(params, cfg, b,
                                                kernel=kernel)
                res[dev] = (float(loss), float(m["aux"]), logits)
            loss_err = abs(res["cuda"][0] - res["cpu"][0]) / abs(
                res["cpu"][0])
            aux_err = abs(res["cuda"][1] - res["cpu"][1]) / max(
                abs(res["cpu"][1]), 1e-30)
            if loss_err > 1e-4 or aux_err > 1e-4:
                raise AssertionError(f"{arch} reduced: loss {loss_err}, aux "
                                     f"{aux_err} card vs CPU")
            out[arch] = {"head_dim": cfg.head_dim, "loss_rel_err": loss_err,
                         "aux_rel_err": aux_err if cfg.moe else None,
                         "logits_rel_err": _logits_close(
                             f"{arch} reduced logits", res["cuda"][2],
                             res["cpu"][2], rtol=1e-4)}
    return out


def _family_rows(rows: list, arch: str, launches: dict) -> None:
    for r in rows:
        if r.get("arch") == arch:
            r["launches"] = launches[r["name"]]


def phase_lm_families(seed: int = 0, rows: list = ()) -> None:
    """The moe, vlm and encdec families and the other dense configs at
    their configs' widths, random f32 weights from ``seed`` on the card,
    one model at a time (each freed before the next; its init, time and
    peak GB printed):

    - h2o-danube-3-4b, all 24 layers: scored (B 1 x S 4096, kernel 5 at
      head dim 120, 24 launches a forward) kernels against eager; then the
      continuous batcher (4 slots, W 4096 rings, six requests of 1-1500
      prompt tokens): the ring kernel 24 times a tick (``_family_serve``);
    - llama4-scout-17b-a16e, its first 4 of 48 layers: scored (B 1 x S
      2048: capacity routing at C 160, kernel 5 at G 5), then served (four
      requests, max_len 1024, dropless routing, the extent kernel 4 times
      a tick);
    - grok-1-314b, its first 2 of 64 layers: scored (top-2 routing at C
      640, kernel 5 at G 6);
    - paligemma-3b, all 18 layers: scored (B 2 x S 2048 with the 256-patch
      prefix, kernel 5 at D 256 over one kv head); 16 decode steps from a
      prefilled prefix batch through the extent kernel against the uniform
      eager decode fed the same tokens; then ``serve.py`` (B 2, prompt 32,
      16 tokens);
    - seamless-m4t-large-v2, 24 + 24 layers: ``serve.py`` (B 2, 512 source
      frames, 16 tokens), eager; its decode steps again, fed its tokens,
      against the teacher-forced decoder on the same source.

    Scoring: logits within 1e-3 (1 + |eager|), the loss within 1e-4
    relative. Decoding: logits within 1e-3 (1 + |ref|) and the same greedy
    picks but for ties within the two runs' difference (``_greedy_ties``,
    counted). Before them, the seven reduced configs card against CPU.
    Without ``rows`` (the phase alone), no kernel row is filled in.
    ``rows`` are the kernel rows of these shapes (``_time_family_scoring``,
    ``_time_family_decode``); their launches are set from these runs."""
    import contextlib
    import io
    import re
    import numpy as np
    import torch
    from repro_torch.launch import serve
    from repro_torch.models import lm, registry
    from repro_torch.models import moe as moe_mod
    from repro_torch.types import ShapeConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    t_phase = time.perf_counter()
    held = {"held_before_gib": torch.cuda.memory_allocated() / 2 ** 30,
            "held_after_release_gib": _release_engines()}
    report = {"phase": "lm_families", "card": _card_line(),
              "reduced_card_vs_cpu": _family_reduced_card_vs_cpu()}
    print(json.dumps({"phase": "lm_families", "part": "reduced_card_vs_cpu",
                      **held, **report["reduced_card_vs_cpu"]}))
    score_launches = {}

    def score(arch):
        cfg = _family_cfg(arch)
        _, B, S = FAMILY_SCORE[arch]
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params, info = _family_params(cfg, seed)
        batch = _family_batch(cfg, B, S, seed)
        res = _score_kernels_vs_eager(params, cfg, batch,
                                      f"{arch} scoring")
        score_launches[arch] = res["launches"]
        info.update(res, layers=cfg.num_layers, batch=[B, S],
                    head_dim=cfg.head_dim)
        return cfg, params, info, t0

    def done(info, t0, arch):
        torch.cuda.synchronize()
        info["model_s"] = time.perf_counter() - t0
        # since the scoring began (its weights included), serving too
        info["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        print(json.dumps({"phase": "lm_families", "arch": arch,
                          "card": report["card"], **info}))
        return info

    def cli(argv):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = serve.main(argv + ["--seed", str(seed), "--device", "cuda"])
        text = buf.getvalue()
        if rc != 0 or "sample generations" not in text:
            raise AssertionError(f"serve {argv}: exit {rc}\n{text}")
        ms = dict(re.findall(r"^(prefill|decode):\s+([0-9.]+) ms", text,
                             re.M))
        return {"argv": argv, "prefill_ms": float(ms["prefill"]),
                "decode_ms": float(ms["decode"]),
                "call_s": time.perf_counter() - t0}

    # h2o-danube-3-4b: kernel 5 at D 120, the ring kernel at W 4096
    cfg, params, info, t0 = score("h2o-danube-3-4b")
    info["serve"] = _family_serve(params, cfg, H2O_PROMPTS, 4096, seed)
    _family_rows(rows, "h2o-danube-3-4b",
                 {**score_launches["h2o-danube-3-4b"],
                  **info["serve"]["launches"]})
    _free(params)
    report["h2o-danube-3-4b"] = done(info, t0, "h2o-danube-3-4b")

    # llama4-scout: capacity routing in scoring, dropless serving
    cfg, params, info, t0 = score("llama4-scout-17b-a16e")
    info["capacity"] = moe_mod.capacity(math.prod(info["batch"]), cfg.moe)
    info["serve"] = _family_serve(params, cfg, LLAMA4_PROMPTS, 1024, seed)
    _family_rows(rows, "llama4-scout-17b-a16e",
                 {**score_launches["llama4-scout-17b-a16e"],
                  **info["serve"]["launches"]})
    _free(params)
    report["llama4-scout-17b-a16e"] = done(info, t0, "llama4-scout-17b-a16e")

    # grok-1: top-2 capacity routing
    cfg, params, info, t0 = score("grok-1-314b")
    info["capacity"] = moe_mod.capacity(math.prod(info["batch"]), cfg.moe)
    _family_rows(rows, "grok-1-314b", score_launches["grok-1-314b"])
    _free(params)
    report["grok-1-314b"] = done(info, t0, "grok-1-314b")

    # paligemma-3b: the prefix, kernel 5 at KV 1, the extent kernel at G 8
    cfg, params, info, t0 = score("paligemma-3b")
    P = 32
    batch = _family_batch(cfg, 2, P + cfg.prefix_len, seed + 1)
    max_len = cfg.prefix_len + P + FAMILY_TOKENS
    pre = {"tokens": batch["tokens"], "prefix_embeds": batch["prefix_embeds"]}
    with torch.no_grad():
        cache = registry.init_cache(cfg, 2, max_len, torch.float32, "cuda")
        logits, cache = registry.prefill(params, cfg, pre, cache,
                                         q_chunk=cfg.prefix_len + P)
        first = torch.argmax(logits, dim=-1).to(torch.int32)
        ring = lm.to_ring_cache(cfg, cache, cfg.prefix_len + P)
        # the extent kernel's decode, the uniform eager decode fed its tokens
        tok, errs, ties = first, [], 0
        _zero_decode_launches()
        for i in range(FAMILY_TOKENS):
            p = cfg.prefix_len + P + i
            lk, ring = registry.decode_step_grouped(
                params, cfg, tok, ring, p, k_ext=max_len,
                decode_kernel="cuda")
            le, cache = registry.decode_step(params, cfg, tok, cache, p)
            what = f"paligemma decode step {i}"
            errs.append(_logits_close(what, lk, le))
            tok = torch.argmax(lk, dim=-1).to(torch.int32)
            ties += _greedy_ties(what, tok, lk, le)
        dec_launches = _decode_launches()
    if dec_launches["extent_decode_attend"] != FAMILY_TOKENS * \
            cfg.num_layers:
        raise AssertionError(f"paligemma decode launches {dec_launches}")
    info["decode_steps"] = {"prefix": cfg.prefix_len, "prompt": P,
                            "tokens": FAMILY_TOKENS, "launches": dec_launches,
                            "greedy_ties_vs_eager": ties,
                            "logits_rel_err_vs_eager": max(errs)}
    _family_rows(rows, "paligemma-3b",
                 {**score_launches["paligemma-3b"], **dec_launches})
    _free(params, cache, ring)
    info["serve_cli"] = cli(["--arch", "paligemma-3b", "--batch", "2",
                             "--prompt-len", str(P), "--gen",
                             str(FAMILY_TOKENS)])
    report["paligemma-3b"] = done(info, t0, "paligemma-3b")

    # seamless-m4t-large-v2: the encoder-decoder through serve.py, eager;
    # the CLI's params and source rebuilt from the seed to check its tokens
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    argv = ["--arch", "seamless-m4t-large-v2", "--batch", "2",
            "--prompt-len", str(SEAMLESS_FRAMES), "--gen", str(FAMILY_TOKENS)]
    info = {"serve_cli": cli(argv)}
    cfg = _family_cfg("seamless-m4t-large-v2")
    params, pinfo = _family_params(cfg, seed)
    info.update(pinfo)
    batch = registry.synth_batch(          # the CLI's draws from its seed
        np.random.default_rng(seed), cfg,
        ShapeConfig("serve", seq_len=SEAMLESS_FRAMES, global_batch=2,
                    kind="decode"), device="cuda")
    max_len = SEAMLESS_FRAMES + FAMILY_TOKENS
    toks, _, _ = serve.generate(params, cfg, batch, max_len, FAMILY_TOKENS)
    if toks.shape != (2, FAMILY_TOKENS) or (toks[:, 0] != 0).any():
        raise AssertionError(f"seamless generation {toks}")
    # its decode steps again, fed its tokens, against the teacher-forced
    # decoder over the same tokens
    src = {"src_embeds": batch["src_embeds"]}
    forced_toks = torch.from_numpy(toks).cuda()
    errs, ties = [], 0
    with torch.no_grad():
        forced = registry.logits_fn(params, cfg, {
            **src, "tokens": forced_toks[:, :-1]})
        cache = registry.prefill(params, cfg, src, registry.init_cache(
            cfg, 2, max_len, torch.float32, "cuda"))
        for t in range(FAMILY_TOKENS - 1):
            lk, cache = registry.decode_step(params, cfg, forced_toks[:, t],
                                             cache, t)
            what = f"seamless decode step {t}"
            errs.append(_logits_close(what, lk, forced[:, t]))
            ties += _greedy_ties(what, forced_toks[:, t + 1], lk,
                                 forced[:, t])
    if not bool(torch.isfinite(forced).all()):
        raise AssertionError("seamless: non-finite logits")
    info.update(layers=[cfg.num_encoder_layers, cfg.num_layers],
                logits_rel_err_vs_teacher_forced=max(errs),
                greedy_ties_vs_teacher_forced=ties,
                sample=toks[:, :8].tolist())
    _free(cache)
    _free(params)
    report["seamless-m4t-large-v2"] = done(info, t0, "seamless-m4t-large-v2")

    for r in rows:
        if not r.get("launches"):
            raise AssertionError(f"{r['name']} {r['arch']}: no launch on "
                                 "its path")
    print(json.dumps({"phase": "lm_families", "part": "summary",
                      "phase_s": time.perf_counter() - t_phase,
                      "peak_gb": {a: report[a]["peak_gb"] for a in report
                                  if isinstance(report[a], dict)
                                  and "peak_gb" in report[a]},
                      "model_s": {a: report[a]["model_s"] for a in report
                                  if isinstance(report[a], dict)
                                  and "model_s" in report[a]}}))


# ---------------------------------------------------------------------------
# The LM half of multi-device: the ("data", "model") mesh in a world of one
# ---------------------------------------------------------------------------

# a step shape's first call is eager, its second captured, the third
# replayed
LM_MESH_STEPS = 3
LM_MESH_SERVE = (4, 2048, 64, 16)     # B, cache positions, prompt, tokens
LM_MESH_REDUCED = ("hymba-1.5b", "mamba2-130m", "llama4-scout-17b-a16e",
                   "seamless-m4t-large-v2", "paligemma-3b")
# served at full width beside Hymba: every leaf of its layers splits on a
# "model" axis of 2 or 4 (32 / 8 heads, d_ff 10240, V 32000)
LM_MESH_SERVE_DENSE = "h2o-danube-3-4b"


def _wrapper_launches() -> int:
    """The host launches of every kernel wrapper, summed."""
    from repro_torch.kernels import (decode_attend, kd_loss, ssd_decode,
                                     ssd_scan, swa_attention)
    return sum(f.launches for f in (
        kd_loss.kd_loss_fused, kd_loss.kd_loss_fused_bwd,
        decode_attend.ring_decode_attend, decode_attend.extent_decode_attend,
        ssd_decode.ssd_decode_step, ssd_scan.ssd_scan,
        swa_attention.swa_attention))


def _dt_copy(tree):
    """A copy of a tree of DTensors (their blocks cloned), tensors and
    other values: a donated argument kept for the eager body."""
    import torch
    from torch.distributed.tensor import DTensor
    if isinstance(tree, dict):
        return {k: _dt_copy(v) for k, v in tree.items()}
    if isinstance(tree, DTensor):
        return DTensor.from_local(tree.to_local().clone(), tree.device_mesh,
                                  tree.placements, run_check=False,
                                  shape=tree.shape, stride=tree.stride())
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def _blocks(tree: dict) -> dict:
    return {k: v.to_local() for k, v in tree.items()}


def _nbytes(tree) -> int:
    """The bytes of a tree's tensors (a DTensor's block)."""
    import torch
    from torch.distributed.tensor import DTensor
    if isinstance(tree, (dict, tuple, list)):
        return sum(map(_nbytes, tree.values() if isinstance(tree, dict)
                       else tree))
    if isinstance(tree, DTensor):
        tree = tree.to_local()
    return tree.numel() * tree.element_size() \
        if isinstance(tree, torch.Tensor) else 0


class _MeshGraphs:
    """A mesh step's calls through its graphs (``fn``, from
    ``jit_train_step`` / ``jit_serve_step``) and through its eager body
    (``fn.eager``): each call's wall ms (synchronised), the kernel
    wrappers' host launches during each graph call, the card's allocated
    bytes before each graph call and its peak during it (``tops``,
    without the copies kept for the eager body), and the captures under
    ``entry`` after the last graph call (``captured``)."""

    def __init__(self, fn, entry: str):
        self.fn, self.entry, self.captured = fn, entry, 0
        self.ms, self.eager_ms, self.launches, self.tops = [], [], [], []

    def __call__(self, args: tuple, donated: tuple = (), **kw) -> tuple:
        """``(fn's outputs, fn.eager's)`` on copies of the same inputs;
        ``donated``: the positions of ``args`` the call writes, copied
        for the eager body first."""
        copies = tuple(_dt_copy(a) if i in donated else a
                       for i, a in enumerate(args))
        out = self.graph(args, sum(_nbytes(args[i]) for i in donated), **kw)
        return out, self.eager(copies, **kw)

    def graph(self, args: tuple, extra: int = 0, **kw):
        """``fn(*args)``; ``extra``: bytes held for the eager body."""
        import torch
        n = _wrapper_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        out = self.fn(*args, **kw)
        torch.cuda.synchronize()
        self.ms.append((time.perf_counter() - t0) * 1e3)
        self.launches.append(_wrapper_launches() - n)
        self.tops.append((held - extra,
                          torch.cuda.max_memory_allocated() - extra))
        self.captured = self.fn.graphs.captures(self.entry)
        return out

    def eager(self, args: tuple, **kw):
        """``fn.eager(*args)``."""
        import torch
        t0 = time.perf_counter()
        out = self.fn.eager(*args, **kw)
        torch.cuda.synchronize()
        self.eager_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    def report(self, err: float) -> dict:
        """The entry's captures and signatures, the calls' ms (the first
        eager, the second captured, the rest replays), the launches
        during replays; fails unless one signature was captured once,
        the replays launched nothing from the host and ``err`` (the
        largest difference from the eager body) is within
        ``ENGINE_TOL``."""
        got = {"signatures": self.fn.graphs.count(self.entry),
               "captures": self.captured, "graph_ms": self.ms,
               "replay_ms": self.ms[2:], "eager_ms": self.eager_ms,
               "replay_wrapper_launches": sum(self.launches[2:]),
               "max_err_vs_eager": err}
        if (got["signatures"], got["captures"]) != (1, 1) or \
                got["replay_wrapper_launches"] or err > ENGINE_TOL or \
                len(self.ms) < 3:
            raise AssertionError(f"{self.entry} through its graphs: {got}")
        return got


def _mesh_train_graphs(fn, mesh, init: dict, in_sh, batches) -> tuple:
    """A ``jit_train_step``'s steps over ``batches`` from the params
    ``init`` (the anchor too) through its graphs, then, the graphs
    dropped, through its eager body from the same params: ``(params,
    losses, calls, graphs)``, ``graphs`` the report (``_MeshGraphs``) and
    the graphs' pool (``_pool_gib``). Fails unless every step's loss and
    the last params and momentum are the eager body's within
    ``ENGINE_TOL`` (on one card, a pool, the copies a per-step check
    keeps and the eager step's own memory do not fit together)."""
    from repro_torch.sharding import specs as shspecs

    def start():
        params = shspecs.place(mesh, {k: v.clone() for k, v in init.items()},
                               in_sh[0])
        return params, fn.opt.init(params)
    calls, losses = _MeshGraphs(fn, "mesh_train"), []
    anchor = shspecs.place(mesh, init, in_sh[2])
    params, state = start()
    for b in batches:
        params, state, loss = calls.graph((params, state, anchor, b))
        losses.append(float(loss.to_local()))
    pool = _pool_gib(fn)
    e_p, e_s = start()
    err = 0.0
    for b, got in zip(batches, losses):
        e_p, e_s, e_loss = calls.eager((e_p, e_s, anchor, b))
        err = max(err, abs(got - float(e_loss.to_local()))
                  / abs(float(e_loss.to_local())))
    err = max(err, _max_diff(_blocks(params), _blocks(e_p)),
              _max_diff(_blocks(state["mom"]), _blocks(e_s["mom"])))
    return params, losses, calls, {**calls.report(err), **pool}


def _mesh_token(calls, params, tok, cache, pos) -> tuple:
    """One ``jit_serve_step`` token through its graphs (``calls``, a
    ``_MeshGraphs``), with logits, against its eager body on a copy of
    the cache: ``((next, cache, logits), the largest difference of the
    logits and the cache)``; fails unless the tokens are equal."""
    import torch
    (nxt, cache, lg), (e_nxt, e_cache, e_lg) = calls(
        (params, tok, cache, pos), (2,), with_logits=True)
    if not torch.equal(nxt.to_local(), e_nxt.to_local()):
        raise AssertionError(f"jit_serve_step at {pos}: the graph's tokens "
                             f"{nxt.to_local().tolist()}, eager "
                             f"{e_nxt.to_local().tolist()}")
    return (nxt, cache, lg), max(float((lg - e_lg).abs().max()),
                                 _max_diff(_blocks(cache),
                                           _blocks(e_cache)))


def _pool_gib(fn) -> dict:
    """The card's reserved GiB with ``fn``'s graphs held (every other
    cached block released) and after they are dropped."""
    import gc
    import torch
    torch.cuda.empty_cache()
    held = torch.cuda.memory_reserved() / 2 ** 30
    fn.graphs.clear()
    gc.collect()
    torch.cuda.empty_cache()
    after = torch.cuda.memory_reserved() / 2 ** 30
    return {"reserved_with_graphs_gib": held,
            "reserved_after_clear_gib": after, "pool_gib": held - after}


def _mesh_serve_dense(mesh) -> dict:
    """``LM_MESH_SERVE_DENSE`` at full width (f32, 15.9 GB) served by
    ``jit_serve_step`` on ``mesh`` (``LM_MESH_SERVE``: B 4, a
    2048-position cache, a 64-token prefill, 16 greedy tokens) against
    ``registry.decode_step`` on a copy of the cache, fed the mesh's
    tokens: the same picks but for near-ties (``_greedy_ties``), logits
    and cache within ``ENGINE_TOL``. Each token's wall ms on both; the
    card's peak GB over the mesh's steps and above what was held before
    each."""
    import numpy as np
    import torch
    from repro_torch.checkpoint.convert import _shapes
    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.models import registry
    from repro_torch.sharding import specs as shspecs
    from repro_torch.types import ShapeConfig
    cfg = get_config(LM_MESH_SERVE_DENSE)
    SB, SL, SP, ST = LM_MESH_SERVE
    params = registry.init_params(
        torch.Generator(device="cuda").manual_seed(4), cfg, "cuda")
    prompt = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (SB, SP)).astype(np.int32)).cuda()
    with torch.no_grad():
        first, filled = registry.prefill(
            params, cfg, {"tokens": prompt},
            registry.init_cache(cfg, SB, SL, device="cuda"))
    tok = torch.argmax(first, dim=-1).to(torch.int32)
    plain = {k: v.clone() for k, v in filled.items()}
    fn, (s_in, _) = steps.jit_serve_step(
        cfg, mesh, ShapeConfig("serve", seq_len=SL, global_batch=SB,
                               kind="decode"), _shapes(cfg), filled)
    placed = shspecs.place(mesh, params, s_in[0])
    cache = shspecs.place(mesh, filled, s_in[2])
    calls = _MeshGraphs(fn, "mesh_serve")
    ties, errs, plain_ms, g_err = 0, [], [], 0.0
    for t in range(ST):
        (nxt, cache, lg), err = _mesh_token(calls, placed, tok, cache,
                                            SP + t)
        g_err = max(g_err, err)
        t0 = time.perf_counter()
        with torch.no_grad():
            want, plain = registry.decode_step(params, cfg, tok, plain,
                                               SP + t)
        torch.cuda.synchronize()
        plain_ms.append((time.perf_counter() - t0) * 1e3)
        tok = nxt.to_local()
        ties += _greedy_ties(f"{cfg.name} jit_serve_step step {t}", tok,
                             lg, want)
        errs.append(float(((lg - want).abs() / (1 + want.abs())).max()))
    c_err = _max_diff({k: v.to_local() for k, v in cache.items()}, plain)
    if max(errs) > ENGINE_TOL or c_err > ENGINE_TOL:
        raise AssertionError(f"{cfg.name} jit_serve_step: logits "
                             f"{max(errs)}, cache {c_err}")
    out = {"arch": cfg.name, "batch": SB, "max_len": SL, "prompt": SP,
           "tokens": ST, "greedy_ties": ties, "logits_rel_err": max(errs),
           "cache_max_abs_err": c_err, "split": repr(fn.split),
           "step_wall_ms": calls.ms, "unsharded_step_wall_ms": plain_ms,
           "peak_gb": max(top for _, top in calls.tops) / 1e9,
           "step_peak_above_held_gb": max(top - held for held, top
                                          in calls.tops) / 1e9,
           "params_gb": sum(v.numel() * v.element_size()
                            for v in params.values()) / 1e9,
           "graphs": {**calls.report(g_err), **_pool_gib(fn)}}
    _free(params, placed, cache, plain, filled)
    return out


LM_MESH_ENCDEC = "seamless-m4t-large-v2"
LM_MESH_ENCDEC_TRAIN = (2, 2048, 1024)     # B, source frames, target tokens
LM_MESH_ENCDEC_SERVE = (4, 512, 16)       # B, source frames, tokens


def _mesh_encdec(mesh) -> dict:
    """``LM_MESH_ENCDEC`` at full width (f32 params, bf16 compute, remat)
    on ``mesh``, the split path of both stacks: ``LM_MESH_STEPS`` steps
    of ``LM_MESH_ENCDEC_TRAIN`` through ``jit_train_step`` against
    ``make_train_step(mesh=None)`` on the same batches (losses and
    params within ``ENGINE_TOL``), ms a step of both and the card's peak
    GB over the mesh's steps; then ``jit_serve_step`` from a prefilled
    source (``LM_MESH_ENCDEC_SERVE``) against ``registry.decode_step`` on
    a copy of the cache: tokens equal, logits and cache within
    ``ENGINE_TOL``, each token's wall ms. Frees the params."""
    import gc
    import numpy as np
    import torch
    from repro_torch.checkpoint.convert import _shapes
    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.models import registry
    from repro_torch.sharding import specs as shspecs
    from repro_torch.types import FedConfig, ShapeConfig
    cfg = get_config(LM_MESH_ENCDEC)
    B, Ss, St = LM_MESH_ENCDEC_TRAIN
    rng = np.random.default_rng(5)

    def batch():
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, St + 1))
                                .astype(np.int32)).cuda()
        return {"src_embeds": torch.from_numpy(rng.standard_normal(
            (B, Ss, cfg.d_model)).astype(np.float32)).cuda(),
            "tokens": toks[:, :-1], "labels": toks[:, 1:]}
    batches = [batch() for _ in range(LM_MESH_STEPS)]
    fed = FedConfig()
    init = registry.init_params(
        torch.Generator(device="cuda").manual_seed(5), cfg, "cuda")
    fn, (in_sh, _) = steps.jit_train_step(
        cfg, fed, mesh, ShapeConfig("train", seq_len=Ss + St,
                                    global_batch=B, kind="train"),
        _shapes(cfg), batches[0])
    params, losses, calls, graphs = _mesh_train_graphs(fn, mesh, init,
                                                       in_sh, batches)
    got = {k: v.to_local() for k, v in params.items()}
    del params
    gc.collect()
    step, opt = steps.make_train_step(cfg, fed)
    p = {k: v.clone() for k, v in init.items()}
    ost, plain_losses, plain_ms = opt.init(p), [], []
    for b in batches:
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        p, ost, l = step(p, ost, init, b)
        t1.record()
        torch.cuda.synchronize()
        plain_ms.append(t0.elapsed_time(t1))
        plain_losses.append(float(l))
    p_err = _max_diff(got, p)
    l_err = max(abs(a - b) / abs(b) for a, b in zip(losses, plain_losses))
    if p_err > ENGINE_TOL or l_err > ENGINE_TOL or not all(
            math.isfinite(x) for x in losses):
        raise AssertionError(f"{cfg.name} jit_train_step vs "
                             f"make_train_step: params {p_err}, losses "
                             f"{l_err}")
    out = {"arch": cfg.name, "batch": B, "src_len": Ss, "tgt_len": St,
           "compute": "bf16", "remat": True, "split": repr(fn.split),
           "step_ms": calls.ms, "losses": losses,
           "peak_gb": max(top for _, top in calls.tops) / 1e9,
           "peak_above_held_gb": max(top - held for held, top
                                     in calls.tops) / 1e9,
           "unsharded_step_ms": plain_ms,
           "param_max_abs_err_vs_unsharded": p_err,
           "loss_rel_err_vs_unsharded": l_err, "graphs": graphs}
    del batches
    _free(p, ost, got)

    SB, SS, ST = LM_MESH_ENCDEC_SERVE
    src = torch.from_numpy(rng.standard_normal(
        (SB, SS, cfg.d_model)).astype(np.float32)).cuda()
    with torch.no_grad():
        filled = registry.prefill(init, cfg, {"src_embeds": src},
                                  registry.init_cache(cfg, SB, SS,
                                                      device="cuda"))
    plain = {k: v.clone() for k, v in filled.items()}
    sfn, (s_in, _) = steps.jit_serve_step(
        cfg, mesh, ShapeConfig("serve", seq_len=SS, global_batch=SB,
                               kind="decode"), _shapes(cfg), filled)
    placed = shspecs.place(mesh, init, s_in[0])
    cache = shspecs.place(mesh, filled, s_in[2])
    tok = ref = torch.zeros(SB, dtype=torch.int32, device="cuda")   # BOS
    scalls, errs, g_err = _MeshGraphs(sfn, "mesh_serve"), [], 0.0
    for t in range(ST):
        (tok, cache, lg), err = _mesh_token(scalls, placed, tok, cache, t)
        g_err = max(g_err, err)
        with torch.no_grad():
            want, plain = registry.decode_step(init, cfg, ref, plain, t)
        ref = torch.argmax(want, dim=-1).to(torch.int32)
        if not torch.equal(tok.to_local(), ref):
            raise AssertionError(f"{cfg.name} jit_serve_step step {t}: "
                                 "tokens differ")
        errs.append(float(((lg - want).abs() / (1 + want.abs())).max()))
    c_err = _max_diff({k: v.to_local() for k, v in cache.items()}, plain)
    if max(errs) > ENGINE_TOL or c_err > ENGINE_TOL:
        raise AssertionError(f"{cfg.name} jit_serve_step: logits "
                             f"{max(errs)}, cache {c_err}")
    out["serve"] = {"batch": SB, "src_len": SS, "tokens": ST,
                    "tokens_equal": True, "logits_rel_err": max(errs),
                    "cache_max_abs_err": c_err, "step_wall_ms": scalls.ms,
                    "graphs": {**scalls.report(g_err), **_pool_gib(sfn)}}
    _free(init, placed, cache, plain, filled)
    return out


def _mesh_scoring_on_card(events) -> dict:
    """Kernels 5 and 6 among the profiler's device events: the attention
    kernel once a launch, the SSD scan's state pass once a launch (its
    two chunk passes beside it)."""
    return {"swa_attention": sum("swa_attention_kernel" in e.name()
                                 for e in events),
            "ssd_scan": sum("ssd_state_pass_kernel" in e.name()
                            for e in events)}


def _max_diff(got: dict, want: dict) -> float:
    return max(float((got[k].float() - want[k].float()).abs().max())
               for k in want)


def phase_lm_mesh(rows: list = ()) -> None:
    """The LM's ("data", "model") mesh on the card, a world of one over
    NCCL (``launch.mesh.make_host_mesh``: the (1, 1) mesh), in ``_Exact``:

    (a) Hymba-1.5B at full width, f32 params, bf16 compute, remat,
        ``LM_MESH_STEPS`` steps of B 2 x S 2048 through ``jit_train_step``
        (params, momentum, batch placed by the rules), each step's ms and
        the peak GB; losses and params against ``make_train_step(mesh=
        None)`` on the same batches within ``ENGINE_TOL`` (both run the
        same local ops: 0.0 expected), its steps timed too. Every step of
        (a), (b) and (f) runs through the step's graphs (``fn.graphs``:
        the first call eager, the second captured, the rest replays) and
        is held against its eager body (``fn.eager``) on a copy of the
        same inputs within ``ENGINE_TOL``, tokens equal: one capture a
        step shape, no kernel wrapper launching in a replay; the
        ``graphs`` line has each path's ms, eager and replayed, and the
        card's reserved GiB with its graphs held and after they are
        dropped;
    (b) Hymba-1.5B served by ``jit_serve_step``: B 4, a 2048-position
        cache prefilled with 64 tokens, 16 greedy tokens, uniform and
        ring, against ``make_serve_step`` on a copy: tokens equal, logits
        and cache within ``ENGINE_TOL``; then h2o-danube-3-4b at full
        width the same way against ``registry.decode_step``
        (``_mesh_serve_dense``: near-ties counted teacher-forced), ms a
        token and peak GB;
    (c) the Hymba-1.5B scoring forward through kernels 5 and 6 on the
        train step's split path (``steps.mesh_split``; in a world of one
        the rank's blocks are the whole params), B 2 x S 2048 (the main
        path: counts zeroed just before, read just after, and the card's
        from a trace): 32 of each, the hidden and the loss equal to the
        forward without a mesh;
    (d) llama4-scout's first 4 layers (43.5 GB of f32 weights), B 1 x S
        2048, the loss with ``moe_ctx`` on the split path through kernel
        5: at one dp shard equal to the local path;
    (f) seamless-m4t-large-v2 at full width (f32 params, bf16 compute,
        remat) through ``jit_train_step`` on both stacks' split path, B 2
        x 2048 source frames x 1024 target tokens, ``LM_MESH_STEPS``
        steps against ``make_train_step(mesh=None)`` within
        ``ENGINE_TOL``, ms a step and the peak GB; its ``jit_serve_step``
        for 16 tokens from a 512-frame source, tokens equal to
        ``registry.decode_step``'s (``_mesh_encdec``);
    (e) the sharded train step on the reduced Hymba, Mamba2, llama4-scout,
        seamless and paligemma, f32 compute, the card against the CPU's
        (1, 1) gloo mesh: losses within 1e-5 relative.

    ``rows``: the kernel rows of kernels 5 and 6 at Hymba's shape; their
    ``launches_by_path`` get this path's counts. Frees its memory and the
    process group at the end."""
    import gc
    import numpy as np
    import torch
    from repro_torch.checkpoint.convert import _shapes
    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import destroy_world, make_host_mesh
    from repro_torch.models import lm, registry
    from repro_torch.sharding import specs as shspecs
    from repro_torch.types import FedConfig, ShapeConfig
    t_phase = time.perf_counter()
    held = {"held_before_gib": torch.cuda.memory_allocated() / 2 ** 30,
            "held_after_release_gib": _release_engines()}
    mesh = make_host_mesh(device="cuda")
    report = {"phase": "lm_mesh", "card": _card_line(), **held,
              "mesh": [list(mesh.mesh_dim_names), list(mesh.shape)],
              "tol": ENGINE_TOL}

    def line(part):
        print(json.dumps({"phase": "lm_mesh", "part": part,
                          "card": report["card"], **report[part]}))

    cfg = get_config("hymba-1.5b")
    with _Exact():
        # (a) the train step at full width
        B, S = LM_TRAIN_SHAPE
        shape = ShapeConfig("train", seq_len=S, global_batch=B, kind="train")
        rng = np.random.default_rng(0)
        batches = [registry.synth_batch(rng, cfg, shape, device="cuda")
                   for _ in range(LM_MESH_STEPS)]
        fed = FedConfig()
        init = registry.init_params(
            torch.Generator(device="cuda").manual_seed(0), cfg, "cuda")
        fn, (in_sh, _) = steps.jit_train_step(
            cfg, fed, mesh, shape, _shapes(cfg),
            registry.batch_spec(cfg, shape))
        params, mesh_losses, calls, graphs = _mesh_train_graphs(
            fn, mesh, init, in_sh, batches)
        report["graphs"] = {"train": graphs}
        got = {k: v.to_local() for k, v in params.items()}
        gc.collect()
        step, opt = steps.make_train_step(cfg, fed)
        p = {k: v.clone() for k, v in init.items()}
        ost, plain_losses, plain_ms = opt.init(p), [], []
        for b in batches:
            t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            t0.record()
            p, ost, l = step(p, ost, init, b)
            t1.record()
            torch.cuda.synchronize()
            plain_ms.append(t0.elapsed_time(t1))
            plain_losses.append(float(l))
        p_err = _max_diff(got, p)
        l_err = max(abs(a - b) / abs(b) for a, b in zip(mesh_losses,
                                                        plain_losses))
        if p_err > ENGINE_TOL or l_err > ENGINE_TOL or not all(
                math.isfinite(x) for x in mesh_losses):
            raise AssertionError(f"jit_train_step vs make_train_step: "
                                 f"params {p_err}, losses {l_err}")
        report["train_full_width"] = {
            "arch": cfg.name, "batch": B, "seq_len": S, "compute": "bf16",
            "remat": True, "step_ms": calls.ms, "losses": mesh_losses,
            "peak_gib": max(top - held for held, top in calls.tops)
            / 2 ** 30, "param_max_abs_err_vs_unsharded": p_err,
            "loss_rel_err_vs_unsharded": l_err,
            "unsharded_step_ms": plain_ms}
        line("train_full_width")
        del p, ost, got, params, batches
        _free()

        # (b) the serve step
        SB, SL, SP, ST = LM_MESH_SERVE
        sshape = ShapeConfig("serve", seq_len=SL, global_batch=SB,
                             kind="decode")
        prompt = torch.from_numpy(np.random.default_rng(1).integers(
            0, cfg.vocab_size, (SB, SP)).astype(np.int32)).cuda()
        with torch.no_grad():
            first_logits, filled = registry.prefill(
                init, cfg, {"tokens": prompt},
                registry.init_cache(cfg, SB, SL, device="cuda"))
        first = torch.argmax(first_logits, dim=-1).to(torch.int32)
        serve_rep = {}
        for ring in (False, True):
            base = lm.to_ring_cache(cfg, filled, SP) if ring else filled
            plain = {k: v.clone() for k, v in base.items()}
            sfn, (s_in, _) = steps.jit_serve_step(
                cfg, mesh, sshape, _shapes(cfg), base, ring=ring)
            sparams = shspecs.place(mesh, init, s_in[0])
            cache = shspecs.place(mesh, {k: v.clone()
                                         for k, v in base.items()}, s_in[2])
            tok = ref_tok = first
            calls, errs, g_err = _MeshGraphs(sfn, "mesh_serve"), [], 0.0
            for t in range(ST):
                (tok, cache, lg), err = _mesh_token(calls, sparams, tok,
                                                    cache, SP + t)
                g_err = max(g_err, err)
                with torch.no_grad():
                    if ring:
                        want, plain = lm.decode_step_ring(init, cfg, ref_tok,
                                                          plain, SP + t)
                    else:
                        want, plain = registry.decode_step(init, cfg,
                                                           ref_tok, plain,
                                                           SP + t)
                ref_tok = torch.argmax(want, dim=-1).to(torch.int32)
                if not torch.equal(tok.to_local(), ref_tok):
                    raise AssertionError(f"jit_serve_step ring={ring} step "
                                         f"{t}: tokens differ")
                errs.append(float(((lg - want).abs()
                                   / (1 + want.abs())).max()))
            c_err = _max_diff({k: v.to_local() for k, v in cache.items()},
                              plain)
            if max(errs) > ENGINE_TOL or c_err > ENGINE_TOL:
                raise AssertionError(f"jit_serve_step ring={ring}: logits "
                                     f"{max(errs)}, cache {c_err}")
            serve_rep["ring" if ring else "uniform"] = {
                "tokens": ST, "logits_rel_err": max(errs),
                "cache_max_abs_err": c_err, "step_wall_ms": calls.ms}
            report["graphs"]["serve_ring" if ring else "serve"] = {
                **calls.report(g_err), **_pool_gib(sfn)}
            del sparams, cache, plain
        report["serve"] = {"arch": cfg.name, "batch": SB, "max_len": SL,
                           "prompt": SP, **serve_rep}
        line("serve")
        del filled
        _free()
        # (b') a dense model whose every leaf splits on a "model" axis
        report["serve_dense"] = _mesh_serve_dense(mesh)
        line("serve_dense")

        # (c) the scoring forward through kernels 5 and 6 on the split
        # path (a world of one: the rank's blocks are the whole params)
        batch = _score_batch(cfg, SCORE_B, SCORE_S, 0, "cuda")
        split, _ = steps.mesh_split(cfg, mesh, SCORE_S, _shapes(cfg))
        with torch.no_grad():
            _zero_score_launches()
            (hid, _), events, wall_ms, lost = _trace(
                lambda: lm.forward_hidden(init, cfg, batch["tokens"],
                                          kernel="cuda", split=split))
            host = _score_launches()
            card = _mesh_scoring_on_card(events)
            want_h, _ = lm.forward_hidden(init, cfg, batch["tokens"],
                                          kernel="cuda")
            loss_m = registry.loss_fn(init, cfg, batch, kernel="cuda",
                                      split=split)[0]
            loss_p = registry.loss_fn(init, cfg, batch, kernel="cuda")[0]
        per = _per_forward(cfg)
        if host != per or card != per or lost["calls"]:
            raise AssertionError(f"mesh scoring launches: host {host}, card "
                                 f"{card}, want {per} ({lost} lost)")
        if not torch.equal(hid, want_h) or not torch.equal(loss_m, loss_p):
            raise AssertionError("mesh scoring forward differs from the "
                                 "forward without a mesh")
        for r in rows:
            r.setdefault("launches_by_path", {})["lm_mesh_scoring"] = {
                "host": host[r["name"]], "card": card[r["name"]]}
        report["scoring"] = {
            "arch": cfg.name, "batch": [SCORE_B, SCORE_S],
            "split": repr(split), "launches_host": host,
            "launches_card": card, "dropped_launches": lost["calls"],
            "traced_forward_ms": wall_ms, "hidden_equal": True,
            "loss": float(loss_m), "loss_equal": True}
        line("scoring")
        del init, hid, want_h
        _free()

        # (d) llama4-scout's MoE scoring with moe_ctx
        lcfg = _family_cfg("llama4-scout-17b-a16e")
        torch.cuda.reset_peak_memory_stats()
        lparams, info = _family_params(lcfg, 0)
        lbatch = _family_batch(lcfg, 1, SCORE_S, 0)
        lsplit, ctx = steps.mesh_split(lcfg, mesh, SCORE_S, _shapes(lcfg))
        with torch.no_grad():
            t0 = time.perf_counter()
            lm_, met = registry.loss_fn(lparams, lcfg, lbatch, kernel="cuda",
                                        moe_ctx=ctx, split=lsplit)
            torch.cuda.synchronize()
            moe_s = time.perf_counter() - t0
            lp_, mp_ = registry.loss_fn(lparams, lcfg, lbatch, kernel="cuda")
        if not (torch.equal(lm_, lp_) and torch.equal(met["aux"],
                                                      mp_["aux"])):
            raise AssertionError(f"llama4 moe_ctx loss {float(lm_)} / aux "
                                 f"{float(met['aux'])} vs local "
                                 f"{float(lp_)} / {float(mp_['aux'])}")
        report["moe_scoring"] = {
            "arch": lcfg.name, "layers": lcfg.num_layers,
            "batch": [1, SCORE_S], "loss": float(lm_),
            "aux": float(met["aux"]), "equal_to_local_path": True,
            "loss_s": moe_s, **info,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        line("moe_scoring")
        _free(lparams)

        # (f) the encoder-decoder at full width on the split path
        report["encdec"] = _mesh_encdec(mesh)
        line("encdec")
        # the steps through their graphs, beside their eager bodies
        g = report["graphs"]
        g.update(serve_dense=report["serve_dense"]["graphs"],
                 encdec_train=report["encdec"]["graphs"],
                 encdec_serve=report["encdec"]["serve"]["graphs"])
        g["summary"] = {name: {
            "captures": v["captures"],
            "eager_ms_median": statistics.median(v["eager_ms"]),
            "replay_ms_median": statistics.median(v["replay_ms"]),
            "reserved_with_graphs_gib": v["reserved_with_graphs_gib"],
            "pool_gib": v["pool_gib"]} for name, v in list(g.items())}
        line("graphs")

    # (e) reduced configs, the sharded train step, card vs CPU
    cpu_mesh = make_host_mesh(device="cpu")
    red = {}
    with _Exact():
        for arch in LM_MESH_REDUCED:
            rc = get_config(arch).reduced()
            sh = ShapeConfig("t", seq_len=64, global_batch=2, kind="train")
            b = registry.synth_batch(np.random.default_rng(2), rc, sh,
                                     device="cpu")
            p0 = registry.init_params(torch.Generator().manual_seed(0), rc,
                                      "cpu")
            losses = {}
            for dev, m in (("cuda", mesh), ("cpu", cpu_mesh)):
                rfn, _ = steps.jit_train_step(
                    rc, FedConfig(lr=0.05), m, sh, _shapes(rc),
                    registry.batch_spec(rc, sh),
                    train_kwargs={"dtype": torch.float32})
                pp = {k: v.to(dev) for k, v in p0.items()}
                st, anc = rfn.opt.init(pp), {k: v.clone()
                                             for k, v in pp.items()}
                ls = []
                for _ in range(2):
                    pp, st, l = rfn(pp, st, anc,
                                    {k: v.to(dev) for k, v in b.items()})
                    ls.append(float(l.to_local()))
                losses[dev] = ls
            err = max(abs(a - c) / abs(c) for a, c in zip(losses["cuda"],
                                                          losses["cpu"]))
            if err > 1e-5:
                raise AssertionError(f"{arch} reduced sharded step card vs "
                                     f"CPU: {err}")
            red[arch] = {"losses": losses["cuda"], "loss_rel_err": err}
    report["reduced_card_vs_cpu"] = red
    line("reduced_card_vs_cpu")
    destroy_world()
    _free()
    seconds = time.perf_counter() - t_phase
    print(json.dumps({"phase": "lm_mesh", "part": "summary",
                      "card": report["card"], "mesh": report["mesh"],
                      "seconds": seconds,
                      "held_after_gib": torch.cuda.memory_allocated()
                      / 2 ** 30}))
    if seconds > 90:
        raise AssertionError(f"lm_mesh took {seconds:.1f} s > 90 s")


# ---------------------------------------------------------------------------
# The roofline of three paths: counted (roofline.counter) and timed
# ---------------------------------------------------------------------------

# the pod dry runs of train_4k, path -> (archs, flags), run side by side:
# Hymba-1.5B's and gemma3-12b's (~40 and ~60 s of host time), and
# llama4-scout's under --moe-fullgrid (~45 s)
DRYRUN_TIMEOUT_S = 300
DRYRUN_RUNS = {"dryrun_pod": (("hymba-1.5b", "gemma3-12b"), []),
               "dryrun_pod_moe_fullgrid": (("llama4-scout-17b-a16e",),
                                           ["--moe-fullgrid"])}
# parents' rows (PERF.md: python -m repro_torch.launch.dryrun --arch A
# --shape train_4k --mesh pod [--moe-fullgrid] on the parent tree, torch
# 2.13 on the CPU): gemma3-12b's before tensor-parallel compute, every
# layer's compute replicated over "model"; llama4-scout's under
# --moe-fullgrid with the experts gathered over "model"
DRYRUN_PARENT = {
    ("dryrun_pod", "gemma3-12b"): {
        "flops_per_device": 6522199914559976.0,
        "useful_flop_ratio": 0.043799244529092715,
        "peak_memory_bytes": 199592486920.0},
    ("dryrun_pod_moe_fullgrid", "llama4-scout-17b-a16e"): {
        "flops_per_device": 3131129658823298.0,
        "collective_s": 2.4716794311466668,
        "peak_memory_bytes": 139809721356.0}}


def _roofline_line(path: str, rep, wall_ms: float, prof: dict, want: dict,
                   card: str, **extra) -> dict:
    """Print one path's roofline line: its counted work and terms, the
    device ms a step the profiler measured (wall ms where it traced
    nothing), ``mfu`` and the share ``step_time_s / measured``. Fails
    unless the path's hand kernels recorded ``want`` launches and every
    term is finite and positive."""
    got = {k: v["launches"] for k, v in rep.kernels.items()}
    if got != want:
        raise AssertionError(f"roofline {path}: kernels counted {got}, "
                             f"want {want}")
    traced = "device_ms_per_step" in prof
    measured_ms = prof["device_ms_per_step"] if traced else wall_ms
    rep.measured_s = measured_ms / 1e3
    d = rep.to_dict()
    terms = (rep.flops_per_device, rep.bytes_per_device, rep.compute_s,
             rep.memory_s, rep.step_time_s, rep.mfu, measured_ms)
    if not all(math.isfinite(v) and v > 0 for v in terms):
        raise AssertionError(f"roofline {path}: a term not finite and "
                             f"positive: {terms}")
    line = {"phase": "roofline", "path": path, "card": card,
            "flops_by_class": {p: v["flops"]
                               for p, v in d["flops_by_class"].items()},
            "flops": rep.flops_per_device, "bytes": rep.bytes_per_device,
            "collective_bytes": rep.collective_bytes,
            "model_flops": rep.model_flops_global,
            "model_precision": rep.model_precision,
            "compute_s": rep.compute_s, "memory_s": rep.memory_s,
            "dominant": rep.dominant, "step_time_s": rep.step_time_s,
            "measured_ms": measured_ms,
            "measured": ("device ms a step (profiler)" if traced
                         else "wall ms a step (no device events traced)"),
            "wall_ms": wall_ms, "device_busy_share":
                prof.get("device_busy_share"),
            "mfu": rep.mfu, "share": rep.roofline_share,
            "useful_flop_ratio": rep.useful_flop_ratio,
            "kernels": rep.kernels, "peak_memory_gb":
                rep.peak_memory_bytes / 1e9, **extra}
    print(json.dumps(line))
    return line


def _forward_products(fn) -> dict:
    """The product flops (by class) of one forward ``fn()`` run without
    autograd: the model flops a forward is priced at."""
    import torch
    from repro_torch.roofline.counter import Counter
    with torch.no_grad(), Counter() as c:
        fn()
    return {p: n for p, n in c.flops.items() if p != "f32"}


def _roofline_kd(card: str) -> None:
    """(a) The main path's KD step (ResNet3D-34 -> 18, 400 classes) at its
    clips (batch 4 of 4x16x16) and the paper's (batch 8 of 8x112x112),
    TF32 at PyTorch's default: one eager step counted, the step timed
    inside a replayed epoch of 8. Model flops: the teacher's forward
    products plus three times the student's (forward, and the backward's
    two products a forward one), in cuDNN's TF32 class."""
    import torch
    from repro_torch.configs import RESNET18, RESNET34
    from repro_torch.core import distill
    from repro_torch.data import SyntheticActionDataset, stack_batches
    from repro_torch.device import batch_to
    from repro_torch.models import registry
    from repro_torch.roofline import analyze_step
    from repro_torch.types import DistillConfig
    gen = torch.Generator().manual_seed(0)
    teacher = registry.init_params(gen, RESNET34, "cuda")
    student = registry.init_params(gen, RESNET18, "cuda")
    H = 8
    for name, frames, size, bsz in (("main_path", 4, 16, 4),
                                    ("paper_clip", 8, 112, 8)):
        ds = SyntheticActionDataset(num_classes=400, samples_per_class=1,
                                    frames=frames, size=size, seed=0)
        stacked = stack_batches(ds.batches(bsz, H, seed=1))
        batch = {k: v[0] for k, v in batch_to(stacked, "cuda").items()}
        engine = distill.DistillEngine(RESNET34, RESNET18,
                                       DistillConfig(lr=0.01))
        state = engine.opt.init(student)
        engine.step(teacher, student, state, batch)   # cuDNN's choice
        torch.cuda.synchronize()
        fwd_t = _forward_products(lambda: registry.logits_fn(
            teacher, RESNET34, batch))
        fwd_s = _forward_products(lambda: registry.logits_fn(
            student, RESNET18, batch))
        model = sum(fwd_t.values()) + 3 * sum(fwd_s.values())
        _, rep = analyze_step(
            engine.step, teacher, student, state, batch,
            arch="resnet3d-34->resnet3d-18", shape=name,
            mesh_name="one card", chips=1, model_flops_global=model,
            model_precision="tf32", watch=(teacher, student, state, batch))

        def replay():
            return engine.epoch(teacher, student, state, stacked)
        replay(), replay()                  # eager, then captured
        wall = _wall_ms(replay, 5) / H
        prof = _profile(replay, 3)
        per_step = {k: (v / H if k in ("device_ms_per_step",
                                       "wall_ms_per_step") else v)
                    for k, v in prof.items()}
        _roofline_line(f"kd_step_{name}", rep, wall, per_step,
                       {"kd_loss": 1, "kd_loss_bwd": 1}, card,
                       clips=[bsz, frames, size, size, 3], epoch_H=H,
                       timed="a step of a replayed KD epoch of 8")
        del engine, state, stacked, batch
    _free(teacher, student)


def _roofline_scoring(card: str, seed: int) -> None:
    """(b) Hymba-1.5B's scoring forward (``lm.forward_hidden``, B 2 x S
    2048, f32, cuBLAS TF32 off) through kernels 5 and 6: one forward
    counted, three timed. Model flops 2·N·tokens in f32."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import lm, registry
    from repro_torch.roofline import analyze_step
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("hymba-1.5b")
    params = registry.init_params(
        torch.Generator(device="cuda").manual_seed(seed), cfg, "cuda")
    batch = _score_batch(cfg, SCORE_B, SCORE_S, seed, "cuda")

    def forward():
        with torch.no_grad():
            return lm.forward_hidden(params, cfg, batch["tokens"],
                                     kernel="cuda")
    forward()
    torch.cuda.synchronize()
    _, rep = analyze_step(
        forward, arch=cfg.name, shape=f"score B{SCORE_B} x S{SCORE_S}",
        mesh_name="one card", chips=1,
        model_flops_global=2.0 * cfg.param_count() * SCORE_B * SCORE_S,
        model_precision="f32", watch=(params, batch))
    per_fwd = _per_forward(cfg)
    _roofline_line("scoring_forward", rep, _wall_ms(forward, 3),
                   _profile(forward, 1), per_fwd, card,
                   batch=[SCORE_B, SCORE_S])
    _free(params)


def _roofline_tick(card: str, seed: int) -> None:
    """(c) One Hymba-1.5B decode tick at K-extent 2048 (four slots of the
    stream's longer prompts, f32, ring mode on kernels 2, 3 and 4): one
    eager tick counted, the batcher's replayed tick timed. Model flops
    2·N a slot in f32."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import registry
    from repro_torch.roofline import analyze_step
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("hymba-1.5b")
    params = registry.init_params(
        torch.Generator(device="cuda").manual_seed(seed), cfg, "cuda")
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in FULL_PROMPTS[4:]]
    adm = _admitted(params, cfg, prompts, max_slots=4, max_len=2048,
                    min_bucket=8, decode_mode="ring", decode_kernel="cuda")
    mask = np.ones(4, bool)
    k_ext = adm._decode_k_ext(mask)
    tp = torch.from_numpy(np.stack([adm.last_tok, adm.pos])).cuda()

    def eager():
        return registry.decode_step_grouped(
            params, cfg, tp[0], adm.cache, tp[1], k_ext=k_ext,
            decode_kernel="cuda")
    eager()
    torch.cuda.synchronize()
    _, rep = analyze_step(
        eager, arch=cfg.name, shape=f"decode tick, 4 slots, k_ext {k_ext}",
        mesh_name="one card", chips=1,
        model_flops_global=2.0 * cfg.param_count() * 4,
        model_precision="f32", watch=(params, adm.cache))
    for _ in range(2):                      # the rung's eager tick, capture
        adm._decode(mask)

    def tick():
        return adm._decode(mask)[0].cpu()
    _roofline_line("decode_tick", rep, _wall_ms(tick, 10), _profile(tick, 3),
                   _per_tick(cfg), card, k_ext=k_ext,
                   timed="a replayed tick")
    _release_graphs(adm)
    del adm
    _free(params)


def _dryrun_procs(out: str, env: dict) -> dict:
    """Each ``DRYRUN_RUNS`` dry run started in a process of its own (a
    process keeps one default group), all at once: {path: Popen}."""
    procs = {}
    for path, (archs, flags) in DRYRUN_RUNS.items():
        argv = [sys.executable, "-m", "repro_torch.launch.dryrun"]
        for arch in archs:
            argv += ["--arch", arch]
        os.makedirs(os.path.join(out, path))
        procs[path] = subprocess.Popen(
            argv + ["--shape", "train_4k", "--mesh", "pod", "--out",
                    os.path.join(out, path)] + flags,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env, cwd=ROOT)
    return procs


def _roofline_dryrun(card: str) -> None:
    """(d) the pod dry runs of ``DRYRUN_RUNS`` (``python -m
    repro_torch.launch.dryrun --arch ... --shape train_4k --mesh pod``),
    each in a process of its own, side by side, under
    ``DRYRUN_TIMEOUT_S``: the fake world and fake tensors under this
    machine's torch. Prints each row, gemma3-12b's and llama4-scout's
    under ``--moe-fullgrid`` beside their parents' (``DRYRUN_PARENT``)."""
    import tempfile
    import torch
    with tempfile.TemporaryDirectory() as out:
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
        t0 = time.perf_counter()
        procs = _dryrun_procs(out, env)
        try:
            for path, proc in procs.items():
                try:
                    res = proc.communicate(timeout=max(
                        1.0, DRYRUN_TIMEOUT_S - (time.perf_counter() - t0)))
                except subprocess.TimeoutExpired:
                    raise AssertionError(f"the {path} dry run took over "
                                         f"{DRYRUN_TIMEOUT_S} s")
                if proc.returncode:
                    raise AssertionError(
                        f"the {path} dry run failed ({proc.returncode}):\n"
                        f"{res[0][-3000:]}\n{res[1][-3000:]}")
        finally:
            for proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        seconds = time.perf_counter() - t0
        rows = {}
        for path, (archs, _) in DRYRUN_RUNS.items():
            for arch in archs:
                with open(os.path.join(
                        out, path, f"baseline_{arch}_train_4k_pod.json"),
                        encoding="utf-8") as f:
                    rows[path, arch] = json.load(f)
    keep = ("arch", "shape", "mesh", "chips", "status", "flops_per_device",
            "bytes_per_device", "collectives", "collective_bytes",
            "peak_memory_bytes", "model_flops_global", "compute_s",
            "memory_s", "collective_s", "dominant", "step_time_s",
            "useful_flop_ratio", "mfu", "count_s")
    for (path, arch), row in rows.items():
        parent = DRYRUN_PARENT.get((path, arch))
        extra = {"parent": parent} if parent else {}
        print(json.dumps({"phase": "roofline", "path": path,
                          "card": card, "torch": torch.__version__,
                          "seconds": seconds,
                          "flops_by_class": {p: v["flops"] for p, v in
                                             row["flops_by_class"].items()},
                          **{k: row[k] for k in keep}, **extra}))


def phase_roofline(seed: int) -> None:
    """The roofline of three paths on the card, each counted eagerly by
    ``repro_torch.roofline`` (the hand kernels by their models) and timed
    as it runs: (a) the main path's KD step, (b) Hymba-1.5B's scoring
    forward, (c) a replayed Hymba-1.5B decode tick; then (d) the pod dry
    runs of Hymba-1.5B's and gemma3-12b's train_4k in a subprocess."""
    card = _card_line()
    t0 = time.perf_counter()
    _roofline_kd(card)
    _roofline_scoring(card, seed)
    _roofline_tick(card, seed)
    _roofline_dryrun(card)
    print(json.dumps({"phase": "roofline_done",
                      "seconds": time.perf_counter() - t0}))


def build_all() -> None:
    """One nvcc per kernel source, all started together."""
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        logs = dict(zip(KERNEL_SOURCES, pool.map(build.build,
                                                 KERNEL_SOURCES)))
    print(json.dumps({"phase": "build", "seconds": time.perf_counter() - t0,
                      "compiled": [k for k, v in logs.items() if v]}))
    for name, log in logs.items():
        print(f"[ptxas {name}]\n{log.strip()}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the full-width serving and scoring runs' "
                         "weights and tokens")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    card = _card_line()
    print(card)
    build_all()

    phase_launch_floor()
    kernels = phase_kernels()
    phase_host_profile()
    phase_cpu_vs_card()
    phase_full_width(kernels)
    phase_break_even()
    phase_step_times()
    phase_captured(kernels)
    phase_engines()
    phase_multi_device(kernels)
    phase_algorithms()
    phase_codistill(kernels)
    phase_population()
    phase_schedules(kernels)
    serve_kernels = phase_decode_kernels()
    phase_serve_card_vs_cpu()
    phase_serve_full_width(serve_kernels, args.seed)
    kernels += serve_kernels
    score_kernels = phase_scoring_kernels()
    phase_scoring_card_vs_cpu(args.seed)
    phase_score_full_width(score_kernels, args.seed)
    phase_train(kernels)
    phase_lm_train(kernels)
    phase_lm_serve(args.seed)
    phase_lm_families(args.seed, [k for k in serve_kernels + score_kernels
                                  if "arch" in k])
    phase_lm_mesh([k for k in score_kernels if "arch" not in k])
    phase_roofline(args.seed)
    phase_analytic_speedup()
    kernels += score_kernels

    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

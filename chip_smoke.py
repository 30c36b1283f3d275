#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on any error:

1. card check: a CUDA device must be present; prints the card's name and
   power limit as ``nvidia-smi`` reports them;
2. build: compiles the port's CUDA source for sm_90a and prints the build
   seconds and ptxas report;
3. each kernel against its plain PyTorch version on the card, forward and
   backward, masked rows exactly 0;
4. the reduced pipeline on the card against the same pipeline on the CPU
   (TF32 off for this phase): losses to rtol 1e-3, virtual clock exact,
   one kernel launch per KD step on the card and none on the CPU;
5. the main path at full width: ResNet3D-34 -> 18 KD (400 classes) then
   the four-Jetson async fine-tune, with every kernel's launches counted;
6. one KD step and one client step at the main path's clip shape and at
   the paper's (8x112x112, batch 8), TF32 at PyTorch's default, each
   timed and traced by torch.profiler, with the KD step's launches
   counted.

Prints the card's line first, and at the end one ``{"kernels": [...]}``
line, the card's line again, and last ``{"ok": true, "device": {...}}``.
Imports nothing of JAX.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, f32 FLOP/s
# outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
TOL = 1e-4          # |kernel - plain| <= TOL * (1 + |plain|)


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


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


def phase_kernels() -> dict:
    """Fused KD loss kernel vs ``kd_loss_ref`` on the card."""
    import torch
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

    # backward: the autograd Function (kernel forward + analytic backward)
    # vs autograd through the plain version, in f32 (bf16 gradients would
    # differ by their own rounding, not by the kernel)
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
            worst = max(worst, err)
            if not ok:
                raise AssertionError(f"kd_loss backward R={R} V={V}: {err}")

    # time at the main path's shape: R = KD batch 4, V = 400 classes, f32.
    # ms / plain_ms are device time alone (profiler), comparable with the
    # bound; call_ms / plain_call_ms are CUDA events around back-to-back
    # calls, the cost a caller pays with the host launch included. Where
    # the profiler traces no device time, ms / plain_ms fall back to the
    # events and ms_source says so.
    R, V = 4, 400
    s, t, lab = _kd_inputs(R, V, torch.float32)
    valid = torch.ones(R, device="cuda")

    def fused():
        return kd_loss.kd_loss_fused(s, t, lab, 0.5, valid=valid)

    def plain():
        return ref.kd_loss_ref(s, t, lab, 0.5, valid=valid)

    call_ms, plain_call_ms = _cuda_ms(fused), _cuda_ms(plain)
    kernel_dev, plain_dev = _profile(fused, 50), _profile(plain, 50)
    traced = ("device_ms_per_step" in kernel_dev
              and "device_ms_per_step" in plain_dev)
    # each input read once, the output written once; ~7 f32 operations an
    # element (exp, compare/add for the online max-sum, sub, scale, fma)
    nbytes = 2 * R * V * 4 + 3 * R * 4
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = 7 * R * V / F32_FLOPS * 1e3
    ms = kernel_dev["device_ms_per_step"] if traced else call_ms
    return {"name": "kd_loss", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/kd_loss.cu",
            "replaces": "src/repro/kernels/kd_loss.py:119",
            "max_abs_err": worst, "ms": ms, "kernel_ms": ms,
            "plain_ms": (plain_dev["device_ms_per_step"] if traced
                         else plain_call_ms),
            "ms_source": ("profiler device time" if traced
                          else "cuda events, host launch included"),
            "call_ms": call_ms, "plain_call_ms": plain_call_ms,
            "plain_kernels": plain_dev.get("kernels_per_step"),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None}


def _all_losses(report) -> list:
    out = []
    for st in report["stage1"]["stages"]:
        out += st["losses"]
    return out + report["stage2"]["losses"]


def _expect_launches(what: str, want: int) -> None:
    from repro_torch.kernels import kd_loss
    got = kd_loss.kd_loss_fused.launches
    if got != want:
        raise AssertionError(f"{what}: kd_loss launched {got} times, "
                             f"expected {want}")


def phase_cpu_vs_card():
    import torch
    from repro_torch.kernels import kd_loss
    from repro_torch.launch.pipeline import run_pipeline
    kw = dict(reduced=True, mode="async", clients=2, epochs=2, batch=2,
              kd_steps=4, teacher_steps=2, seed=0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        kd_loss.kd_loss_fused.launches = 0
        gpu, gp = run_pipeline(device="cuda", **kw)
        _expect_launches("reduced pipeline on the card", kw["kd_steps"])
        cpu, cp = run_pipeline(device="cpu", **kw)
        _expect_launches("reduced pipeline on the CPU", kw["kd_steps"])
    finally:
        torch.backends.cudnn.allow_tf32 = True        # PyTorch's defaults
        torch.backends.cuda.matmul.allow_tf32 = False
    a, b = _all_losses(gpu), _all_losses(cpu)
    if len(a) != len(b) or not all(
            math.isclose(x, y, rel_tol=1e-3) for x, y in zip(a, b)):
        raise AssertionError(f"card vs CPU losses differ:\n{a}\n{b}")
    if gpu["stage2"]["virtual_wall_s"] != cpu["stage2"]["virtual_wall_s"]:
        raise AssertionError("virtual clocks differ")
    perr = max(float(((gp[k].cpu() - cp[k]).abs()
                      / (1.0 + cp[k].abs())).max()) for k in cp)
    if perr > 1e-3:
        raise AssertionError(f"card vs CPU params differ: {perr}")
    print(json.dumps({"phase": "cpu_vs_card", "losses_card": a,
                      "losses_cpu": b, "param_rel_err": perr,
                      "virtual_wall_s": gpu["stage2"]["virtual_wall_s"]}))


def phase_full_width(kernels: list) -> dict:
    from repro_torch.kernels import kd_loss
    from repro_torch.launch.pipeline import run_pipeline
    kd_steps = 8
    kd_loss.kd_loss_fused.launches = 0
    report, _ = run_pipeline(arch="resnet3d-18", teacher="resnet3d-34",
                             reduced=False, mode="async", clients=4,
                             epochs=4, batch=4, kd_steps=kd_steps,
                             teacher_steps=2, device="cuda")
    launches = {"kd_loss": kd_loss.kd_loss_fused.launches}
    losses = _all_losses(report)
    if not losses or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite losses: {losses}")
    for k in kernels:
        k["launches"] = launches[k["name"]]
        if k["launches"] == 0:
            raise AssertionError(f"{k['name']} never launched on the path")
    _expect_launches("full-width pipeline", kd_steps)
    print(json.dumps({"phase": "full_width", "report": report}))
    return report


def _profile(fn, steps: int = 3) -> dict:
    """Device time by kernel over ``steps`` calls of ``fn`` (torch.profiler).
    Only device-side events (kernels, copies) are summed: an operator's
    own row repeats its kernels' time. The profiler's overhead lengthens
    the wall time, so the busy share is a floor."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        dev = (getattr(e, "self_device_time_total", 0)
               or getattr(e, "self_cuda_time_total", 0))
        if dev:
            rows.append((dev / 1e3, e.key, e.count))
    rows.sort(reverse=True)
    if not rows:
        return {"device_time": "not measured (no device events traced)"}
    busy_ms = sum(r[0] for r in rows)
    return {"wall_ms_per_step": wall_ms / steps,
            "device_ms_per_step": busy_ms / steps,
            "device_busy_share": busy_ms / wall_ms,
            "kernels_per_step": sum(r[2] for r in rows) / steps,
            "top": [{"kernel": k[:90], "ms_per_step": d / steps,
                     "calls_per_step": c / steps} for d, k, c in rows[:6]]}


def phase_step_times():
    """One KD step (ResNet3D-34 -> 18, full width) and one client step at
    the main path's clip shape (4x16x16, batch 4) and at the paper's
    (8x112x112, batch 8), TF32 at PyTorch's default."""
    import torch
    from repro_torch.configs import RESNET18, RESNET34
    from repro_torch.core import distill, fedasync
    from repro_torch.data import SyntheticActionDataset
    from repro_torch.kernels import kd_loss
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
            kd_loss.kd_loss_fused.launches = 0
            fn()                               # warm-up (cuDNN autotune)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(5):
                fn()
            torch.cuda.synchronize()
            out[key + "_ms"] = (time.perf_counter() - t0) / 5 * 1e3
            out[key + "_profile"] = _profile(fn, 3)
            # 1 warm-up + 5 timed + 3 profiled calls; a KD step launches
            # the kernel once, a client step never
            _expect_launches(f"{name} {key}", 9 if key == "kd_step" else 0)
        out["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        print(json.dumps(out))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import build
    card = _card_line()
    print(card)

    t0 = time.perf_counter()
    log = build.build("kd_loss")
    print(json.dumps({"phase": "build", "seconds": time.perf_counter() - t0,
                      "compiled": bool(log)}))
    print(f"[ptxas kd_loss]\n{log.strip()}")

    kernels = [phase_kernels()]
    phase_cpu_vs_card()
    phase_full_width(kernels)
    phase_step_times()

    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

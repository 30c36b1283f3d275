"""Mamba2 SSD chunk scan: the SSD layer core of the scoring forward.

Port of ``repro/kernels/ssd_scan.py::ssd_scan_pallas``, as the
hand-written CUDA kernels of ``csrc/ssd_scan.cu``: the sequence split into
chunks across the card. One call launches three kernels: the chunk
states (a block per (b, h, chunk)), the state passing across chunks (a
thread per state element) and the chunk outputs (a block per (b, h,
chunk)), with the chunk states in f32 scratch this wrapper allocates.

On a CPU tensor the wrapper computes the plain version
(``ref.ssd_scan_ref``, the model's chunked scan); on a CUDA tensor it
launches the kernel or raises. The kernel has no backward (the reference
defines no VJP), so the wrapper refuses inputs that require a gradient
under grad mode. ``ssd_scan.launches`` counts the calls that launch (one
a call, three kernels each) and nothing else. Under an active
``roofline.counter`` it records its analytic work (``analysis.
ssd_scan_cost`` at the kernels' chunk, whichever runs) and runs with the
counter paused.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.swa_attention import check_no_grad
from repro_torch.roofline import analysis, counter

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_P = 64           # kMaxP in csrc/ssd_scan.cu
MAX_N = 128          # kMaxN there
BLOCK_CHUNK = 64     # kQ there: the rows of a chunk the kernels take


@functools.cache
def _lib():
    """The bound C entry point, built and loaded at first launch."""
    lib = build.load("ssd_scan")
    lib.ssd_scan_fwd.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
                                 + [ctypes.c_void_p])
    lib.ssd_scan_fwd.restype = ctypes.c_int
    lib.ssd_scan_error_string.argtypes = [ctypes.c_int]
    lib.ssd_scan_error_string.restype = ctypes.c_char_p
    return lib


def _check(x, dt, A, Bm, Cm, Q: int):
    if x.dim() != 4:
        raise ValueError(f"x must be (B, S, H, P), got {tuple(x.shape)}")
    B, S, H, P = x.shape
    N = Bm.shape[-1] if Bm.dim() == 3 else -1
    want = {"dt": (dt, (B, S, H)), "A": (A, (H,)), "Bm": (Bm, (B, S, N)),
            "Cm": (Cm, (B, S, N))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise ValueError(f"dt and A must be float32, got {dt.dtype} / "
                         f"{A.dtype}")
    if x.dtype not in _DTYPE_CODE or Bm.dtype != x.dtype \
            or Cm.dtype != x.dtype:
        raise ValueError(f"x, Bm, Cm must share float32 or bfloat16, got "
                         f"{x.dtype} / {Bm.dtype} / {Cm.dtype}")
    if S % Q != 0:
        raise ValueError(f"seq len {S} not divisible by chunk {Q}")
    if not 4 <= P <= MAX_P or not 4 <= N <= MAX_N or P % 4 or N % 4:
        raise ValueError(f"head dim {P} (max {MAX_P}) and state {N} (max "
                         f"{MAX_N}) must be multiples of 4 in range")
    for name, t in (("x", x), ("dt", dt), ("A", A), ("Bm", Bm), ("Cm", Cm)):
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    check_no_grad("ssd_scan", x, dt, A, Bm, Cm)


def ssd_scan(x, dt, A, Bm, Cm, chunk: int = 128):
    """The SSD scan from a zero state.

    x: (B, S, H, P); dt: (B, S, H) f32 (softplus'ed); A: (H,) f32; Bm,
    Cm: (B, S, N) in x's dtype. S must be a multiple of min(chunk, S), the
    reference's contract; the plain version scans in those chunks, the
    kernels in their own (``BLOCK_CHUNK``). Returns (y (B, S, H, P), final
    state (B, H, P, N)), both in x's dtype; f32 inside.
    """
    build.refuse_dtensor("ssd_scan", x, dt, A, Bm, Cm)
    Q = min(chunk, x.shape[1]) if x.dim() == 4 else chunk
    _check(x, dt, A, Bm, Cm, Q)
    if counter.counting():
        return counter.kernel(
            "ssd_scan", analysis.ssd_scan_cost(
                *x.shape, Bm.shape[-1], dtype_bytes=x.element_size(),
                chunk=BLOCK_CHUNK),
            ssd_scan, x, dt, A, Bm, Cm, chunk)
    if x.device.type == "cpu":
        return ref.ssd_scan_ref(x, dt, A, Bm, Cm, chunk)
    if x.device.type != "cuda":
        raise ValueError(f"no SSD scan kernel for {x.device}")
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    for name, t in (("x", x), ("Bm", Bm), ("Cm", Cm)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    nc = -(-S // BLOCK_CHUNK)   # the kernels' chunks, the last one ragged
    y = torch.empty_like(x)
    h_out = torch.empty((B, H, P, N), dtype=x.dtype, device=x.device)
    states = torch.empty((B, H, nc, P, N), dtype=torch.float32,
                         device=x.device)
    decay = torch.empty((B, H, nc), dtype=torch.float32, device=x.device)
    lib = _lib()
    err = build.launch(
        lib.ssd_scan_fwd, x.device, x.data_ptr(), dt.data_ptr(),
        A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), y.data_ptr(),
        h_out.data_ptr(), states.data_ptr(), decay.data_ptr(), B, S, H, P, N,
        _DTYPE_CODE[x.dtype])
    if err:
        raise RuntimeError(f"ssd_scan launch failed: "
                           f"{lib.ssd_scan_error_string(err).decode()} "
                           f"({err})")
    ssd_scan.launches += 1
    return y, h_out


ssd_scan.launches = 0

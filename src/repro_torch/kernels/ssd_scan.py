"""Mamba2 SSD chunk scan: the SSD layer core of the scoring forward.

Port of ``repro/kernels/ssd_scan.py::ssd_scan_pallas``, as the
hand-written CUDA kernel ``csrc/ssd_scan.cu``: one block per (b, h) walks
the chunks in order with the (P, N) state on chip.

On a CPU tensor the wrapper computes the plain version
(``ref.ssd_scan_ref``, the model's chunked scan); on a CUDA tensor it
launches the kernel or raises. The kernel has no backward (the reference
defines no VJP), so the wrapper refuses inputs that require a gradient
under grad mode. ``ssd_scan.launches`` counts the launches and nothing
else.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.swa_attention import check_no_grad

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_P = 64           # kMaxP in csrc/ssd_scan.cu
MAX_N = 128          # kMaxN there
SMEM_LIMIT = 232448  # bytes of shared memory a Hopper block may use


@functools.cache
def _lib():
    """The bound C entry point, built and loaded at first launch."""
    from repro_torch.kernels import build
    lib = build.load("ssd_scan")
    lib.ssd_scan_fwd.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                                 + [ctypes.c_void_p])
    lib.ssd_scan_fwd.restype = ctypes.c_int
    lib.ssd_scan_error_string.argtypes = [ctypes.c_int]
    lib.ssd_scan_error_string.restype = ctypes.c_char_p
    return lib


def smem_bytes(Q: int, P: int, N: int) -> int:
    """Shared memory of one block (csrc/ssd_scan.cu) taking Q rows at a
    time: x·dt, the decayed score tile, B, C, the state and the cumulative
    decay, as f32."""
    return 4 * (Q * P + Q * (Q + 4) + 2 * Q * (N + 1) + P * (N + 1) + Q)


def block_chunk(P: int, N: int) -> int:
    """The kernel's own chunk: 128 rows where a block's buffers fit shared
    memory, else 64 (which fits every P <= 64, N <= 128). Any chunk gives
    the same scan; only the order of its sums moves."""
    return 128 if smem_bytes(128, P, N) <= SMEM_LIMIT else 64


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
    kernel in its own (``block_chunk``). Returns (y (B, S, H, P), final
    state (B, H, P, N)), both in x's dtype; f32 inside.
    """
    Q = min(chunk, x.shape[1]) if x.dim() == 4 else chunk
    _check(x, dt, A, Bm, Cm, Q)
    if x.device.type == "cpu":
        return ref.ssd_scan_ref(x, dt, A, Bm, Cm, chunk)
    if x.device.type != "cuda":
        raise ValueError(f"no SSD scan kernel for {x.device}")
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    for name, t in (("x", x), ("Bm", Bm), ("Cm", Cm)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    y = torch.empty_like(x)
    h_out = torch.empty((B, H, P, N), dtype=x.dtype, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ssd_scan_fwd(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), y.data_ptr(), h_out.data_ptr(), B, S, H, P, N,
            block_chunk(P, N), _DTYPE_CODE[x.dtype], stream)
    if err:
        raise RuntimeError(f"ssd_scan launch failed: "
                           f"{lib.ssd_scan_error_string(err).decode()} "
                           f"({err})")
    ssd_scan.launches += 1
    return y, h_out


ssd_scan.launches = 0

"""One fused Mamba2 SSD token step: decay, rank-1 update and readout.

Port of ``repro/kernels/ssd_scan.py::ssd_decode_step_pallas``, as the
hand-written CUDA kernel ``csrc/ssd_decode.cu``: the state is read once
and written once, and a row with dt = 0 keeps its state bit for bit.

On a CPU tensor the wrapper computes the plain version
(``ref.ssd_decode_step_ref``); on a CUDA tensor it launches the kernel or
raises. ``ssd_decode_step.launches`` counts the launches and nothing else.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import ref

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _lib():
    """The bound C entry point, built and loaded at first launch."""
    from repro_torch.kernels import build
    lib = build.load("ssd_decode")
    lib.ssd_decode_step_fwd.argtypes = ([ctypes.c_void_p] * 8
                                        + [ctypes.c_int] * 6
                                        + [ctypes.c_void_p])
    lib.ssd_decode_step_fwd.restype = ctypes.c_int
    lib.ssd_decode_error_string.argtypes = [ctypes.c_int]
    lib.ssd_decode_error_string.restype = ctypes.c_char_p
    return lib


def _check(xh, dt, A, Bm, Cm, state):
    if xh.dim() != 3:
        raise ValueError(f"xh must be (B, H, P), got {tuple(xh.shape)}")
    B, H, P = xh.shape
    N = Bm.shape[-1] if Bm.dim() == 2 else -1
    want = {"dt": (dt, (B, H)), "A": (A, (H,)), "Bm": (Bm, (B, N)),
            "Cm": (Cm, (B, N)), "state": (state, (B, H, P, N))}
    for name, (x, shape) in want.items():
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(x.shape)}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise ValueError(f"dt and A must be float32, got {dt.dtype} / "
                         f"{A.dtype}")
    if xh.dtype not in _DTYPE_CODE or Bm.dtype != xh.dtype \
            or Cm.dtype != xh.dtype:
        raise ValueError(f"xh, Bm, Cm must share float32 or bfloat16, got "
                         f"{xh.dtype} / {Bm.dtype} / {Cm.dtype}")
    if state.dtype not in _DTYPE_CODE:
        raise ValueError(f"state must be float32 or bfloat16, got "
                         f"{state.dtype}")
    for name, x in (("xh", xh), ("dt", dt), ("A", A), ("Bm", Bm),
                    ("Cm", Cm), ("state", state)):
        if x.device != xh.device:
            raise ValueError(f"{name} on {x.device}, xh on {xh.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def ssd_decode_step(xh, dt, A, Bm, Cm, state):
    """h' = h·exp(dt·A) + dt·x⊗B, y = h'·C for the whole decode batch.

    xh: (B, H, P); dt: (B, H) f32 (softplus'ed); A: (H,) f32; Bm, Cm:
    (B, N) in xh's dtype; state: (B, H, P, N) f32 or bf16. Returns
    (y (B, H, P) in the dtype of promote(state, C), new state in state's
    dtype).
    """
    _check(xh, dt, A, Bm, Cm, state)
    if xh.device.type == "cpu":
        return ref.ssd_decode_step_ref(xh, dt, A, Bm, Cm, state)
    if xh.device.type != "cuda":
        raise ValueError(f"no SSD decode kernel for {xh.device}")
    B, H, P = xh.shape
    N = Bm.shape[-1]
    y = torch.empty((B, H, P), device=xh.device,
                    dtype=torch.promote_types(state.dtype, Cm.dtype))
    new_state = torch.empty_like(state)
    lib = _lib()
    with torch.cuda.device(xh.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ssd_decode_step_fwd(
            xh.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), state.data_ptr(), y.data_ptr(),
            new_state.data_ptr(), B, H, P, N, _DTYPE_CODE[xh.dtype],
            _DTYPE_CODE[state.dtype], stream)
    if err:
        raise RuntimeError(f"ssd_decode_step launch failed: "
                           f"{lib.ssd_decode_error_string(err).decode()} "
                           f"({err})")
    ssd_decode_step.launches += 1
    return y, new_state


ssd_decode_step.launches = 0

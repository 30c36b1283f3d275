"""One fused Mamba2 SSD token step: decay, rank-1 update and readout.

Port of ``repro/kernels/ssd_scan.py::ssd_decode_step_pallas``, as the
hand-written CUDA kernel ``csrc/ssd_decode.cu``: the state is read once
and written once, and a row with dt = 0 keeps its state bit for bit.

x, B and C may be views with a batch stride (the conv output the decode
step cuts them from), and the new state may be written over the old one
(``state_out=state``), as the decode cache is.

On a CPU tensor the wrapper computes the plain version
(``ref.ssd_decode_step_ref``); on a CUDA tensor it launches the kernel or
raises. ``ssd_decode_step.launches`` counts the launches and nothing else.
Under an active ``roofline.counter`` it records its analytic work
(``analysis.ssd_step_cost``) and runs with the counter paused.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, ref
from repro_torch.roofline import analysis, counter

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _lib():
    """The bound C entry point, built and loaded at first launch."""
    lib = build.load("ssd_decode")
    lib.ssd_decode_step_fwd.argtypes = ([ctypes.c_void_p] * 8
                                        + [ctypes.c_int] * 4
                                        + [ctypes.c_longlong] * 3
                                        + [ctypes.c_int] * 2
                                        + [ctypes.c_void_p])
    lib.ssd_decode_step_fwd.restype = ctypes.c_int
    lib.ssd_decode_error_string.argtypes = [ctypes.c_int]
    lib.ssd_decode_error_string.restype = ctypes.c_char_p
    return lib


def _check(xh, dt, A, Bm, Cm, state, state_out, sx, sb, sc):
    """Device, dtype, shape and strides (``sx``, ``sb``, ``sc``: those of
    xh, Bm and Cm), by direct comparisons: this runs once a layer on every
    decode tick."""
    if xh.dim() != 3:
        raise ValueError(f"xh must be (B, H, P), got {tuple(xh.shape)}")
    B, H, P = xh.shape
    if Bm.dim() != 2 or Bm.shape[0] != B:
        raise ValueError(f"Bm must be ({B}, N), got {tuple(Bm.shape)}")
    N = Bm.shape[1]
    if dt.shape != (B, H) or A.shape != (H,) or Cm.shape != (B, N) \
            or state.shape != (B, H, P, N):
        raise ValueError(
            f"want dt {(B, H)}, A {(H,)}, Cm {(B, N)}, state "
            f"{(B, H, P, N)}; got {tuple(dt.shape)}, {tuple(A.shape)}, "
            f"{tuple(Cm.shape)}, {tuple(state.shape)}")
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
    dev = xh.device
    if dt.device != dev or A.device != dev or Bm.device != dev \
            or Cm.device != dev or state.device != dev:
        raise ValueError(f"dt, A, Bm, Cm, state must be on xh's {dev}, got "
                         f"{dt.device} / {A.device} / {Bm.device} / "
                         f"{Cm.device} / {state.device}")
    # x is read at b * stride(0) + h * P + p, B and C at b * stride(0) + n:
    # a size-1 dim's stride is never used
    if (sx[2] != 1 and P > 1) or (sx[1] != P and H > 1) \
            or (sb[1] != 1 and N > 1) or (sc[1] != 1 and N > 1):
        raise ValueError(f"xh must have strides (sb, {P}, 1) and Bm, Cm "
                         f"(sb, 1); got {sx}, {sb}, {sc}")
    if not (dt.is_contiguous() and A.is_contiguous()
            and state.is_contiguous()):
        raise ValueError("dt, A and state must be contiguous")
    if state_out is not None and (
            state_out.shape != state.shape or state_out.dtype != state.dtype
            or state_out.device != dev or not state_out.is_contiguous()):
        raise ValueError(f"state_out must be a contiguous {state.dtype} "
                         f"{tuple(state.shape)} on {dev}")


def ssd_decode_step(xh, dt, A, Bm, Cm, state, state_out=None):
    """h' = h·exp(dt·A) + dt·x⊗B, y = h'·C for the whole decode batch.

    xh: (B, H, P) with strides (sb, P, 1); dt: (B, H) f32 (softplus'ed);
    A: (H,) f32; Bm, Cm: (B, N) in xh's dtype with strides (sb, 1); state:
    (B, H, P, N) f32 or bf16. h' is written into ``state_out`` when it is
    given, which may be ``state`` itself (an in-place update), else into
    a new tensor. Returns (y (B, H, P) in the dtype of promote(state, C),
    h' in state's dtype).
    """
    build.refuse_dtensor("ssd_decode_step", xh, dt, A, Bm, Cm, state,
                         state_out)
    sx, sb, sc = xh.stride(), Bm.stride(), Cm.stride()
    _check(xh, dt, A, Bm, Cm, state, state_out, sx, sb, sc)
    if counter.counting():
        # y's dtype promotes state's and C's: the wider of f32 and bf16
        y_bytes = max(state.element_size(), Cm.element_size())
        return counter.kernel(
            "ssd_decode_step", analysis.ssd_step_cost(
                *xh.shape, Bm.shape[1], x_bytes=xh.element_size(),
                state_bytes=state.element_size(), y_bytes=y_bytes),
            ssd_decode_step, xh, dt, A, Bm, Cm, state, state_out)
    dev = xh.device
    if dev.type == "cpu":
        y, h = ref.ssd_decode_step_ref(xh, dt, A, Bm, Cm, state)
        return y, (h if state_out is None else state_out.copy_(h))
    if dev.type != "cuda":
        raise ValueError(f"no SSD decode kernel for {dev}")
    B, H, P = xh.shape
    N = Bm.shape[1]
    y = torch.empty((B, H, P), device=dev,
                    dtype=torch.promote_types(state.dtype, Cm.dtype))
    if state_out is None:
        state_out = torch.empty_like(state)
    lib = _lib()
    err = build.launch(
        lib.ssd_decode_step_fwd, dev, xh.data_ptr(), dt.data_ptr(),
        A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), state.data_ptr(),
        y.data_ptr(), state_out.data_ptr(), B, H, P, N, sx[0], sb[0], sc[0],
        _DTYPE_CODE[xh.dtype], _DTYPE_CODE[state.dtype])
    if err:
        raise RuntimeError(f"ssd_decode_step launch failed: "
                           f"{lib.ssd_decode_error_string(err).decode()} "
                           f"({err})")
    ssd_decode_step.launches += 1
    return y, state_out


ssd_decode_step.launches = 0

"""Fused KD loss: α·CE(student, labels) + (1-α)·Σ((s-t)/T)² per row.

Port of ``repro/kernels/kd_loss.py``. The forward is the hand-written
CUDA kernel ``csrc/kd_loss.cu`` (replacing the Pallas ``kd_loss_pallas``);
``kd_loss_rows`` wraps it in a ``torch.autograd.Function`` whose backward
is the same file's backward kernel (replacing the reference's analytic
``_rows_bwd``, XLA ops), one launch from the forward's saved logsumexp:

    ∂L_r/∂s = α·(softmax(s_r) - onehot(y_r)) + 2(1-α)(s_r - t_r)/T²
    ∂L_r/∂t = -2(1-α)(s_r - t_r)/T²

Rows with ``valid == 0`` give exactly 0.0 loss and exactly-zero gradients,
by select, so garbage logits in padded rows cannot leak NaN/Inf.
``valid=None`` means every row is live and reaches the kernel as a null
pointer (no mask is made).

On a CPU tensor each wrapper computes its plain version (``ref.kd_loss_ref``,
``kd_loss_rows_bwd``); on a CUDA tensor it launches its kernel or raises.
``kd_loss_fused.launches`` and ``kd_loss_fused_bwd.launches`` count the
launches and nothing else. Under an active ``roofline.counter`` each
wrapper records its analytic work (``analysis.kd_loss_cost``,
``kd_loss_bwd_cost``) and runs with the counter paused.
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
    """The bound C entry points, built and loaded at first launch."""
    lib = build.load("kd_loss")
    lib.kd_loss_fwd.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
        ctypes.c_int, ctypes.c_void_p]
    lib.kd_loss_fwd.restype = ctypes.c_int
    lib.kd_loss_bwd.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] \
        + [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int,
                                   ctypes.c_float, ctypes.c_float,
                                   ctypes.c_int, ctypes.c_void_p]
    lib.kd_loss_bwd.restype = ctypes.c_int
    lib.kd_loss_error_string.argtypes = [ctypes.c_int]
    lib.kd_loss_error_string.restype = ctypes.c_char_p
    return lib


def _check(s, t, labels, valid):
    """Device, dtype, shape and contiguity, by direct comparisons; valid
    may be None."""
    if s.dim() != 2:
        raise ValueError(f"student logits must be (R, V), got {tuple(s.shape)}")
    R, V = s.shape
    if t.shape != s.shape:
        raise ValueError(f"teacher {tuple(t.shape)} != student {tuple(s.shape)}")
    if s.dtype not in _DTYPE_CODE or t.dtype != s.dtype:
        raise ValueError(f"logits must share float32 or bfloat16, got "
                         f"{s.dtype} / {t.dtype}")
    if labels.shape != (R,) or labels.dtype != torch.int32:
        raise ValueError(f"labels must be ({R},) int32, got "
                         f"{tuple(labels.shape)} {labels.dtype}")
    if valid is not None and (valid.shape != (R,)
                              or valid.dtype != torch.float32):
        raise ValueError(f"valid must be ({R},) float32, got "
                         f"{tuple(valid.shape)} {valid.dtype}")
    dev = s.device
    if t.device != dev or labels.device != dev \
            or (valid is not None and valid.device != dev):
        raise ValueError(f"teacher, labels and valid must be on the "
                         f"student's {dev}")
    if not (s.is_contiguous() and t.is_contiguous()
            and labels.is_contiguous()
            and (valid is None or valid.is_contiguous())):
        raise ValueError("logits, labels and valid must be contiguous")
    if V < 1 or R >= 2 ** 31 or V >= 2 ** 31:
        raise ValueError(f"unsupported shape (R, V) = ({R}, {V})")


def _ptr(x) -> int | None:
    return None if x is None else x.data_ptr()


def _fused_fwd(s, t, labels, alpha, temperature, valid, lse):
    """The per-row loss (R,) f32: on a CPU tensor the plain version, on a
    CUDA tensor the forward kernel, which also writes the row logsumexp
    into ``lse`` (an (R,) f32 buffer) unless it is None."""
    build.refuse_dtensor("kd_loss_fused", s, t, labels, valid)
    if counter.counting():
        return counter.kernel(
            "kd_loss", analysis.kd_loss_cost(
                s.numel() // s.shape[-1], s.shape[-1],
                dtype_bytes=s.element_size(), lse=lse is not None,
                masked=valid is not None),
            _fused_fwd, s, t, labels, alpha, temperature, valid, lse)
    if s.device.type == "cpu":
        return ref.kd_loss_ref(s, t, labels, alpha, temperature=temperature,
                               valid=valid)
    if s.device.type != "cuda":
        raise ValueError(f"no kd_loss kernel for {s.device}")
    _check(s, t, labels, valid)
    R, V = s.shape
    out = torch.empty(R, dtype=torch.float32, device=s.device)
    if R == 0:
        return out
    lib = _lib()
    err = build.launch(lib.kd_loss_fwd, s.device, s.data_ptr(),
                       t.data_ptr(), labels.data_ptr(), _ptr(valid),
                       out.data_ptr(), _ptr(lse), R, V, float(alpha),
                       1.0 / float(temperature), _DTYPE_CODE[s.dtype])
    if err:
        raise RuntimeError(f"kd_loss kernel launch failed: "
                           f"{lib.kd_loss_error_string(err).decode()} "
                           f"({err})")
    kd_loss_fused.launches += 1
    return out


# The forward kernel's own entry, for the chip check and the tests; the KD
# steps reach the kernel through kd_loss_rows.
# repro-lint: disable=R4
def kd_loss_fused(student_logits, teacher_logits, labels, alpha: float,
                  temperature: float = 1.0, valid=None):
    """Per-row fused loss. student/teacher: (R, V) f32 or bf16; labels
    (R,) int32; valid (R,) float32 or None (all live). Returns (R,) f32.
    """
    return _fused_fwd(student_logits, teacher_logits, labels, alpha,
                      temperature, valid, None)


kd_loss_fused.launches = 0


# The backward kernel's plain version, which the chip check and the tests
# hold the kernel against.
# repro-lint: disable=R4
def kd_loss_rows_bwd(s, t, labels, valid, g, alpha: float,
                     temperature: float):
    """The reference's analytic backward (``_rows_bwd``) in torch ops: the
    backward kernel's plain version. valid may be None (all live)."""
    s32, t32 = s.float(), t.float()
    p = torch.softmax(s32, dim=-1)
    cols = torch.arange(s.shape[-1], device=s.device)
    onehot = (cols[None, :] == labels.long()[:, None]).float()
    dsq = (2.0 / (temperature * temperature)) * (s32 - t32)
    gcol = g.float()[:, None]
    ds = gcol * (alpha * (p - onehot) + (1.0 - alpha) * dsq)
    dt = gcol * (-(1.0 - alpha)) * dsq
    if valid is not None:
        live = (valid > 0.0)[:, None]
        zero = torch.zeros((), device=s.device)
        ds, dt = torch.where(live, ds, zero), torch.where(live, dt, zero)
    return ds.to(s.dtype), dt.to(t.dtype)


# Called by _KDLossRows.backward; public for the chip check and the tests.
# repro-lint: disable=R4
def kd_loss_fused_bwd(s, t, labels, valid, g, lse, alpha: float,
                      temperature: float, need_dt: bool = True):
    """(ds, dt) of the per-row loss for the row cotangent ``g`` (R,) f32,
    in the logits' dtype; dt is None when ``need_dt`` is False, and the
    kernel then neither computes nor writes it. ``lse`` is the forward's
    row logsumexp (f32, from ``_fused_fwd``; unused on the CPU). ``g``
    may have any stride, 0 among them (a cotangent broadcast from a sum);
    the logits, labels and valid are checked as the forward checks them."""
    build.refuse_dtensor("kd_loss_fused_bwd", s, t, labels, valid, g, lse)
    if counter.counting():
        return counter.kernel(
            "kd_loss_bwd", analysis.kd_loss_bwd_cost(
                s.numel() // s.shape[-1], s.shape[-1],
                dtype_bytes=s.element_size(), need_dt=need_dt,
                masked=valid is not None),
            kd_loss_fused_bwd, s, t, labels, valid, g, lse, alpha,
            temperature, need_dt)
    if s.device.type == "cpu":
        ds, dt = kd_loss_rows_bwd(s, t, labels, valid, g, alpha, temperature)
        return ds, (dt if need_dt else None)
    if s.device.type != "cuda":
        raise ValueError(f"no kd_loss backward kernel for {s.device}")
    _check(s, t, labels, valid)
    R, V = s.shape
    if g.shape != (R,) or g.dtype != torch.float32 or g.device != s.device \
            or lse is None or lse.shape != (R,) \
            or lse.dtype != torch.float32 or lse.device != s.device \
            or not lse.is_contiguous():
        raise ValueError(f"g and lse must be ({R},) float32 on {s.device}, "
                         f"lse contiguous")
    ds = torch.empty_like(s)
    dt = torch.empty_like(t) if need_dt else None
    if R == 0:
        return ds, dt
    lib = _lib()
    err = build.launch(lib.kd_loss_bwd, s.device, s.data_ptr(),
                       t.data_ptr(), labels.data_ptr(), _ptr(valid),
                       g.data_ptr(), g.stride(0), lse.data_ptr(),
                       ds.data_ptr(), _ptr(dt), R, V, float(alpha),
                       1.0 / float(temperature), _DTYPE_CODE[s.dtype])
    if err:
        raise RuntimeError(f"kd_loss backward kernel launch failed: "
                           f"{lib.kd_loss_error_string(err).decode()} "
                           f"({err})")
    kd_loss_fused_bwd.launches += 1
    return ds, dt


kd_loss_fused_bwd.launches = 0


class _KDLossRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, s, t, labels, valid, alpha, temperature):
        lse = (torch.empty(s.shape[0], dtype=torch.float32, device=s.device)
               if s.is_cuda else None)
        out = _fused_fwd(s, t, labels, alpha, temperature, valid, lse)
        ctx.save_for_backward(s, t, labels, valid, lse)
        ctx.alpha, ctx.temperature = alpha, temperature
        return out

    @staticmethod
    def backward(ctx, g):
        s, t, labels, valid, lse = ctx.saved_tensors
        ds, dt = kd_loss_fused_bwd(s, t, labels, valid, g, lse, ctx.alpha,
                                   ctx.temperature,
                                   need_dt=ctx.needs_input_grad[1])
        return (ds if ctx.needs_input_grad[0] else None, dt,
                None, None, None, None)


def kd_loss_rows(student_logits, teacher_logits, labels, alpha: float,
                 temperature: float = 1.0, valid=None):
    """Differentiable per-row fused KD loss (gradients flow to both logit
    tensors; labels/valid are not differentiable). Same shapes and masking
    as ``kd_loss_fused``."""
    if valid is not None:
        valid = valid.float().contiguous()
    return _KDLossRows.apply(student_logits.contiguous(),
                             teacher_logits.contiguous(),
                             labels.to(torch.int32).contiguous(),
                             valid, float(alpha), float(temperature))

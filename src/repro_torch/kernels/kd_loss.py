"""Fused KD loss: α·CE(student, labels) + (1-α)·Σ((s-t)/T)² per row.

Port of ``repro/kernels/kd_loss.py``. The forward is the hand-written
CUDA kernel ``csrc/kd_loss.cu`` (replacing the Pallas ``kd_loss_pallas``);
``kd_loss_rows`` wraps it in a ``torch.autograd.Function`` whose backward
is the reference's analytic ``_rows_bwd`` in torch ops:

    ∂L_r/∂s = α·(softmax(s_r) - onehot(y_r)) + 2(1-α)(s_r - t_r)/T²
    ∂L_r/∂t = -2(1-α)(s_r - t_r)/T²

Rows with ``valid == 0`` give exactly 0.0 loss and exactly-zero gradients,
by select, so garbage logits in padded rows cannot leak NaN/Inf.

On a CPU tensor ``kd_loss_fused`` computes the plain version
(``ref.kd_loss_ref``); on a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import ref

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _kernel_fn():
    """The bound C entry points, built and loaded at first launch."""
    from repro_torch.kernels import build
    lib = build.load("kd_loss")
    fn = lib.kd_loss_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
        ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.kd_loss_error_string.argtypes = [ctypes.c_int]
    lib.kd_loss_error_string.restype = ctypes.c_char_p
    return fn, lib.kd_loss_error_string


def _check(s, t, labels, valid):
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
    if valid.shape != (R,) or valid.dtype != torch.float32:
        raise ValueError(f"valid must be ({R},) float32, got "
                         f"{tuple(valid.shape)} {valid.dtype}")
    for name, x in (("student", s), ("teacher", t), ("labels", labels),
                    ("valid", valid)):
        if x.device != s.device:
            raise ValueError(f"{name} on {x.device}, student on {s.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if V < 1 or R >= 2 ** 31 or V >= 2 ** 31:
        raise ValueError(f"unsupported shape (R, V) = ({R}, {V})")


def kd_loss_fused(student_logits, teacher_logits, labels, alpha: float,
                  temperature: float = 1.0, valid=None):
    """Per-row fused loss. student/teacher: (R, V) f32 or bf16; labels
    (R,) int32; valid (R,) float32 or None (all live). Returns (R,) f32.

    ``kd_loss_fused.launches`` counts the kernel launches (and nothing
    else), so a run can show that it went through the kernel.
    """
    if student_logits.device.type == "cpu":
        return ref.kd_loss_ref(student_logits, teacher_logits, labels, alpha,
                               temperature=temperature, valid=valid)
    if student_logits.device.type != "cuda":
        raise ValueError(f"no kd_loss kernel for {student_logits.device}")
    R, V = student_logits.shape
    if valid is None:
        valid = torch.ones(R, dtype=torch.float32,
                           device=student_logits.device)
    _check(student_logits, teacher_logits, labels, valid)
    out = torch.empty(R, dtype=torch.float32, device=student_logits.device)
    if R == 0:
        return out
    fn, err_str = _kernel_fn()
    with torch.cuda.device(student_logits.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(student_logits.data_ptr(), teacher_logits.data_ptr(),
                 labels.data_ptr(), valid.data_ptr(), out.data_ptr(),
                 R, V, float(alpha), 1.0 / float(temperature),
                 _DTYPE_CODE[student_logits.dtype], stream)
    if err:
        raise RuntimeError(f"kd_loss kernel launch failed: "
                           f"{err_str(err).decode()} ({err})")
    kd_loss_fused.launches += 1
    return out


kd_loss_fused.launches = 0


def kd_loss_rows_bwd(s, t, labels, valid, g, alpha: float,
                     temperature: float):
    """The reference's analytic backward (``_rows_bwd``) in torch ops."""
    s32, t32 = s.float(), t.float()
    p = torch.softmax(s32, dim=-1)
    cols = torch.arange(s.shape[-1], device=s.device)
    onehot = (cols[None, :] == labels.long()[:, None]).float()
    dsq = (2.0 / (temperature * temperature)) * (s32 - t32)
    live = (valid > 0.0)[:, None]
    gcol = g.float()[:, None]
    zero = torch.zeros((), device=s.device)
    ds = torch.where(live, gcol * (alpha * (p - onehot)
                                   + (1.0 - alpha) * dsq), zero)
    dt = torch.where(live, gcol * (-(1.0 - alpha)) * dsq, zero)
    return ds.to(s.dtype), dt.to(t.dtype)


class _KDLossRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, s, t, labels, valid, alpha, temperature):
        ctx.save_for_backward(s, t, labels, valid)
        ctx.alpha, ctx.temperature = alpha, temperature
        return kd_loss_fused(s, t, labels, alpha, temperature=temperature,
                             valid=valid)

    @staticmethod
    def backward(ctx, g):
        s, t, labels, valid = ctx.saved_tensors
        ds, dt = kd_loss_rows_bwd(s, t, labels, valid, g, ctx.alpha,
                                  ctx.temperature)
        return (ds if ctx.needs_input_grad[0] else None,
                dt if ctx.needs_input_grad[1] else None,
                None, None, None, None)


def kd_loss_rows(student_logits, teacher_logits, labels, alpha: float,
                 temperature: float = 1.0, valid=None):
    """Differentiable per-row fused KD loss (gradients flow to both logit
    tensors; labels/valid are not differentiable). Same shapes and masking
    as ``kd_loss_fused``."""
    R = student_logits.shape[0]
    if valid is None:
        valid = torch.ones(R, dtype=torch.float32,
                           device=student_logits.device)
    return _KDLossRows.apply(student_logits.contiguous(),
                             teacher_logits.contiguous(),
                             labels.to(torch.int32).contiguous(),
                             valid.float().contiguous(),
                             float(alpha), float(temperature))

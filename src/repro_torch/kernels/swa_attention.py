"""Causal sliding-window flash attention, the scoring forward's attend.

Port of ``repro/kernels/swa_attention.py::swa_attention_pallas``, as the
hand-written CUDA kernel ``csrc/swa_attention.cu``: an online softmax on
the tensor cores over only the key tiles that meet each query tile's
band. The reference's bidirectional mode (``causal=False``) never loads
keys after a query block, so it is not ported: the wrappers refuse it on
every device.

Two entries, one kernel: ``swa_attention`` takes heads folded into
(BH, S, D), as the reference's kernel does; ``swa_attention_gqa`` takes
the model's own layout, q (B, S, H, D) and k, v (B, S, KV, D), and reads
kv head h // G for query head h in place. On CPU tensors each computes
its plain version (``ref.swa_attention_ref``; for the GQA entry after the
repeat and fold the reference's caller does); on CUDA tensors it launches
the kernel or raises. The kernel has no backward (the reference defines
no VJP), so the wrappers refuse inputs that require a gradient under grad
mode. ``swa_attention.launches`` counts the launches of both entries and
nothing else. Under an active ``roofline.counter`` each entry records its
analytic work (``analysis.swa_attention_cost``) and runs with the counter
paused.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, ref
from repro_torch.roofline import analysis, counter

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 120, 128, 240, 256)   # the kernel's; the plain version any


@functools.cache
def _lib():
    """The bound C entry point, built and loaded at first launch."""
    lib = build.load("swa_attention")
    lib.swa_attention_fwd.argtypes = ([ctypes.c_void_p] * 4
                                      + [ctypes.c_int] * 6 + [ctypes.c_float]
                                      + [ctypes.c_int, ctypes.c_void_p])
    lib.swa_attention_fwd.restype = ctypes.c_int
    lib.swa_attention_error_string.argtypes = [ctypes.c_int]
    lib.swa_attention_error_string.restype = ctypes.c_char_p
    return lib


def check_no_grad(name: str, *tensors) -> None:
    """The scoring kernels have no backward: refuse an output autograd
    would need to differentiate."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise ValueError(f"{name} has no backward (the reference defines no "
                         "VJP): call it under torch.no_grad() or on inputs "
                         "that need no gradient")


def _check_common(q, k, v, window: int, causal: bool):
    if not causal:
        raise ValueError("swa_attention is causal only: the reference's "
                         "causal=False never reads keys after a query block "
                         "(ROADMAP Queue 3)")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share float32 or bfloat16, got "
                         f"{q.dtype} / {k.dtype} / {v.dtype}")
    if not isinstance(window, int) or window < 1:
        raise ValueError(f"window must be an int >= 1, got {window!r}")
    for name, x in (("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError(f"{name} on {x.device}, q on {q.device}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    check_no_grad("swa_attention", q, k, v)


def _check(q, k, v, window: int, causal: bool):
    if q.dim() != 3:
        raise ValueError(f"q must be (BH, S, D), got {tuple(q.shape)}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share (BH, S, D): {tuple(q.shape)} / "
                         f"{tuple(k.shape)} / {tuple(v.shape)}")
    _check_common(q, k, v, window, causal)


def _check_gqa(q, k, v, window: int, causal: bool):
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q must be (B, S, H, D) and k, v (B, S, KV, D), "
                         f"got {tuple(q.shape)} / {tuple(k.shape)}")
    B, S, H, D = q.shape
    KV = k.shape[2]
    if v.shape != k.shape or k.shape != (B, S, KV, D) or H % KV:
        raise ValueError(f"k, v must be (B, S, KV, D) with KV dividing H: "
                         f"q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    _check_common(q, k, v, window, causal)


def _launch(q, k, v, B: int, S: int, H: int, KV: int, window: int):
    """One kernel launch over q (B, S, H, D), k and v (B, S, KV, D)."""
    if q.device.type != "cuda":
        raise ValueError(f"no sliding-window attention kernel for {q.device}")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"head dim {q.shape[-1]} not in {HEAD_DIMS}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    D = q.shape[-1]
    out = torch.empty_like(q)
    lib = _lib()
    err = build.launch(lib.swa_attention_fwd, q.device, q.data_ptr(),
                       k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S, H,
                       KV, D, window, D ** -0.5, _DTYPE_CODE[q.dtype])
    if err:
        raise RuntimeError(f"swa_attention launch failed: "
                           f"{lib.swa_attention_error_string(err).decode()} "
                           f"({err})")
    swa_attention.launches += 1
    return out


def swa_attention(q, k, v, window: int, causal: bool = True):
    """Causal sliding-window attention: query i sees keys j with
    0 <= i - j < window (window >= S: full causal).

    q, k, v: (BH, S, D), one dtype (float32 or bfloat16); on the card D
    in ``HEAD_DIMS``. Returns (BH, S, D) in q's dtype; f32 inside.
    """
    build.refuse_dtensor("swa_attention", q, k, v)
    _check(q, k, v, window, causal)
    if counter.counting():
        BH, S, D = q.shape
        return counter.kernel(
            "swa_attention", analysis.swa_attention_cost(
                BH, S, 1, 1, D, window, dtype_bytes=q.element_size()),
            swa_attention, q, k, v, window, causal)
    if q.device.type == "cpu":
        return ref.swa_attention_ref(q, k, v, window, causal)
    BH, S, _ = q.shape
    return _launch(q, k, v, BH, S, 1, 1, window)


swa_attention.launches = 0


def swa_attention_gqa(q, k, v, window: int, causal: bool = True):
    """``swa_attention`` in the model's layout: q (B, S, H, D), k and v
    (B, S, KV, D), query head h against kv head h // (H // KV). Returns
    (B, S, H, D) in q's dtype.

    The plain version (CPU tensors), ``ref.swa_attention_gqa_ref``,
    repeats K and V over the query groups, folds the heads into
    (B·H, S, D), attends and unfolds, as the reference's
    ``gqa_attention(kernel="pallas")`` does; the kernel reads each kv head
    in place and writes (B, S, H, D).
    """
    build.refuse_dtensor("swa_attention_gqa", q, k, v)
    _check_gqa(q, k, v, window, causal)
    if counter.counting():
        B, S, H, D = q.shape
        return counter.kernel(
            "swa_attention", analysis.swa_attention_cost(
                B, S, H, k.shape[2], D, window,
                dtype_bytes=q.element_size()),
            swa_attention_gqa, q, k, v, window, causal)
    if q.device.type == "cpu":
        return ref.swa_attention_gqa_ref(q, k, v, window, causal)
    B, S, H, _ = q.shape
    return _launch(q, k, v, B, S, H, k.shape[2], window)

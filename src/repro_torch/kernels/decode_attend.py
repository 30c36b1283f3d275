"""One-token GQA decode attends: the ring attend (sliding-window layers)
and the extent attend (full-attention layers).

Port of ``repro/kernels/swa_attention.py``'s ``ring_decode_attend_pallas``
and ``extent_decode_attend_pallas``, both the hand-written CUDA kernel
``csrc/decode_attend.cu``. Unlike the reference, whose kernels take one
scalar position and are ``vmap``ped over the serving slots, every row
here has its own position: ``pos`` is a (B,) int32 tensor on the card,
read by the kernel. Any number of keys runs: the kernel splits each row's
visible keys over a cluster of blocks, each holding only fixed-size tiles.

On a CPU tensor each wrapper computes the plain version (``ref.py``); on
a CUDA tensor it launches its kernel or raises. ``<wrapper>.launches``
counts the launches and nothing else. Under an active
``roofline.counter`` each records its analytic work
(``analysis.decode_attend_cost`` at the keys each row sees: the positions
are read to the host then) and runs with the counter paused.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, ref
from repro_torch.roofline import analysis, counter

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_D = 256
MAX_G = 16


@functools.cache
def _lib():
    """The bound C entry points, built and loaded at first launch."""
    lib = build.load("decode_attend")
    for name, n_ints in (("ring_decode_attend_fwd", 5),
                         ("extent_decode_attend_fwd", 6)):
        fn = getattr(lib, name)
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * (n_ints + 1)
                       + [ctypes.c_float] + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    lib.decode_attend_error_string.argtypes = [ctypes.c_int]
    lib.decode_attend_error_string.restype = ctypes.c_char_p
    return lib


def _check(q, k, v, pos):
    if q.dim() != 4:
        raise ValueError(f"q must be (B, KV, G, D), got {tuple(q.shape)}")
    B, KV, G, D = q.shape
    if k.dim() != 4 or k.shape[0] != B or k.shape[2:] != (KV, D):
        raise ValueError(f"k must be (B, S, KV, D) = ({B}, S, {KV}, {D}), "
                         f"got {tuple(k.shape)}")
    if v.shape != k.shape:
        raise ValueError(f"v {tuple(v.shape)} != k {tuple(k.shape)}")
    if q.dtype not in _DTYPE_CODE or k.dtype not in _DTYPE_CODE \
            or v.dtype != k.dtype:
        raise ValueError(f"q and k/v must be float32 or bfloat16 (k and v "
                         f"alike), got {q.dtype} / {k.dtype} / {v.dtype}")
    if pos.shape != (B,) or pos.dtype != torch.int32:
        raise ValueError(f"pos must be ({B},) int32, got "
                         f"{tuple(pos.shape)} {pos.dtype}")
    for name, x in (("k", k), ("v", v), ("pos", pos)):
        if x.device != q.device:
            raise ValueError(f"{name} on {x.device}, q on {q.device}")
    for name, x in (("q", q), ("k", k), ("v", v), ("pos", pos)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not 1 <= D <= MAX_D or not 1 <= G <= MAX_G:
        raise ValueError(f"head dim {D} (max {MAX_D}) or group {G} "
                         f"(max {MAX_G}) out of range")


def _chunk(k, v) -> int:
    """Bytes of one global-to-shared copy: the largest of 16, 8 and 4 that
    divides a row of D elements and the addresses of k and v; 2 for bf16
    rows of odd D."""
    row = k.shape[-1] * k.element_size()
    for c in (16, 8, 4):
        if row % c == 0 and k.data_ptr() % c == 0 and v.data_ptr() % c == 0:
            return c
    return 2


def _cost(q, k, n_vis) -> tuple:
    _, KV, G, D = q.shape
    return analysis.decode_attend_cost(n_vis, KV, G, D,
                                       q_bytes=q.element_size(),
                                       kv_bytes=k.element_size())


def _launch(name: str, q, k, v, pos, extent: tuple, window: int):
    """Launch ``name`` on the current stream. ``extent`` is (W,) for the
    ring and (S_max, k_ext) for the extent entry."""
    out = torch.empty_like(q)
    B, KV, G, D = q.shape
    lib = _lib()
    err = build.launch(
        getattr(lib, name), q.device, q.data_ptr(), k.data_ptr(),
        v.data_ptr(), pos.data_ptr(), out.data_ptr(), B, *extent, KV, G, D,
        int(window), D ** -0.5, _DTYPE_CODE[q.dtype], _DTYPE_CODE[k.dtype],
        _chunk(k, v))
    if err:
        raise RuntimeError(f"{name} launch failed: "
                           f"{lib.decode_attend_error_string(err).decode()} "
                           f"({err})")
    return out


def ring_decode_attend(q, k, v, pos, window: int):
    """One-token attend over a W-slot ring cache.

    q: (B, KV, G, D); k, v: (B, W, KV, D), slot s holding the latest
    position ≡ s (mod W), each row's new token already written at slot
    ``pos % W``; pos: (B,) int32; window: int (0 = full). Returns
    (B, KV, G, D) in q's dtype.
    """
    build.refuse_dtensor("ring_decode_attend", q, k, v, pos)
    W = k.shape[1]
    _check(q, k, v, pos)
    if counter.counting():
        n_vis = analysis.ring_visible(pos.tolist(), W, window)
        return counter.kernel("ring_decode_attend", _cost(q, k, n_vis),
                              ring_decode_attend, q, k, v, pos, window)
    if q.device.type == "cpu":
        return ref.ring_decode_attend_ref(q, k, v, pos, window)
    if q.device.type != "cuda":
        raise ValueError(f"no ring decode kernel for {q.device}")
    out = _launch("ring_decode_attend_fwd", q, k, v, pos, (W,), window)
    ring_decode_attend.launches += 1
    return out


def extent_decode_attend(q, k, v, pos, window: int, k_ext: int):
    """One-token attend over the first ``k_ext`` positions of a uniform
    cache.

    q: (B, KV, G, D); k, v: (B, S_max, KV, D), each row's new token
    already written at ``pos``; only positions < k_ext are read, and each
    row masks positions beyond its ``pos + 1``. Raises unless
    1 <= k_ext <= S_max. Returns (B, KV, G, D) in q's dtype.
    """
    build.refuse_dtensor("extent_decode_attend", q, k, v, pos)
    S_max = k.shape[1] if k.dim() == 4 else 0
    if not 1 <= k_ext <= S_max:
        raise ValueError(f"k_ext {k_ext} out of range [1, {S_max}]")
    _check(q, k, v, pos)
    if counter.counting():
        n_vis = analysis.extent_visible(pos.tolist(), k_ext, window)
        return counter.kernel("extent_decode_attend", _cost(q, k, n_vis),
                              extent_decode_attend, q, k, v, pos, window,
                              k_ext)
    if q.device.type == "cpu":
        return ref.extent_decode_attend_ref(q, k, v, pos, window, k_ext)
    if q.device.type != "cuda":
        raise ValueError(f"no extent decode kernel for {q.device}")
    out = _launch("extent_decode_attend_fwd", q, k, v, pos,
                  (S_max, int(k_ext)), window)
    extent_decode_attend.launches += 1
    return out


ring_decode_attend.launches = 0
extent_decode_attend.launches = 0

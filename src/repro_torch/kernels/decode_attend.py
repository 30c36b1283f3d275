"""One-token GQA decode attends: the ring attend (sliding-window layers)
and the extent attend (full-attention layers).

Port of ``repro/kernels/swa_attention.py``'s ``ring_decode_attend_pallas``
and ``extent_decode_attend_pallas``, both the hand-written CUDA kernel
``csrc/decode_attend.cu``. Unlike the reference, whose kernels take one
scalar position and are ``vmap``ped over the serving slots, every row
here has its own position: ``pos`` is a (B,) int32 tensor on the card,
read by the kernel.

On a CPU tensor each wrapper computes the plain version (``ref.py``); on
a CUDA tensor it launches its kernel or raises. ``<wrapper>.launches``
counts the launches and nothing else.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import ref

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_D = 256
MAX_G = 16
SMEM_LIMIT = 232448          # bytes of shared memory a Hopper block may use
_THREADS = 256               # kThreads in csrc/decode_attend.cu
_CLUSTER = 8                 # kCluster there: blocks per (row, kv head)


@functools.cache
def _lib():
    """The bound C entry points, built and loaded at first launch."""
    from repro_torch.kernels import build
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


def smem_bytes(G: int, D: int, L: int) -> int:
    """Shared memory one block of the kernel takes (csrc/decode_attend.cu):
    q, the scores of its eighth of the keys, one partial p·V per key group
    and 2·G softmax statistics. With D % 4 == 0 the p·V pass runs
    256 / (D / 4) key groups (fewer when the scalar path runs, so this is
    an upper bound)."""
    groups = _THREADS // (D // 4 if D % 4 == 0 else D)
    per = -(-L // _CLUSTER)
    return 4 * (G * D + G * per + groups * G * D + 2 * G)


def _check(q, k, v, pos, L: int):
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
    if smem_bytes(G, D, L) > SMEM_LIMIT:
        raise ValueError(f"{L} keys x {G} heads do not fit one block's "
                         f"shared memory ({smem_bytes(G, D, L)} B)")


def _vec(k, v) -> int:
    """4-element vector loads need D % 4 == 0 and aligned k, v."""
    align = 4 * k.element_size()
    return int(k.shape[-1] % 4 == 0 and k.data_ptr() % align == 0
               and v.data_ptr() % align == 0)


def _launch(name: str, q, k, v, pos, extent: tuple, window: int):
    """Launch ``name`` on the current stream. ``extent`` is (W,) for the
    ring and (S_max, k_ext) for the extent entry."""
    out = torch.empty_like(q)
    B, KV, G, D = q.shape
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, name)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
            out.data_ptr(), B, *extent, KV, G, D, int(window), D ** -0.5,
            _DTYPE_CODE[q.dtype], _DTYPE_CODE[k.dtype], _vec(k, v), stream)
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
    W = k.shape[1]
    _check(q, k, v, pos, W)
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
    S_max = k.shape[1] if k.dim() == 4 else 0
    if not 1 <= k_ext <= S_max:
        raise ValueError(f"k_ext {k_ext} out of range [1, {S_max}]")
    _check(q, k, v, pos, k_ext)
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

"""Communication-efficient client updates (paper §II cites [44-46]:
FedPAQ-style quantized periodic averaging).

Port of ``repro/core/compression.py``. Clients send *delta* updates
Δ = w_new − w_t quantized to int8 (or packed int4) with a per-leaf
symmetric scale; the server reconstructs w_new ≈ w_t + deq(Δ). On the
paper's testbed the model upload rides constrained links, so 4×/8×
smaller updates shrink exactly the term the async design hides.

int4 packs two signed values per byte (``pack_int4`` / ``unpack_int4``,
numpy only: the wire format); values quantize to [-7, 7], so the nibble
0x8 (-8) is never produced and |Δ − deq(q)| ≤ scale/2 holds at both
widths. The codec runs on the tensors' own device, per dispatch and
outside any captured graph. Rounding is half to even (``torch.round``,
as ``jnp.round``), so the codes equal the reference's bit for bit.

A tree is a flat params dict, or a list or tuple of tensors (the
low-rank factors of ``core/algorithms.py``): ``repro_torch.trees``.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.trees import leaves, nbytes, tree_map

# per-width quantization range: symmetric, excludes int4's -8 so the
# codec never emits a value whose negation is unrepresentable
_QMAX = {8: 127, 4: 7}


class QuantizedUpdate(NamedTuple):
    q: Any        # int8 tree (int4 payloads kept unpacked for compute)
    scale: Any    # f32 0-d tensor per leaf
    base_bytes: int
    wire_bytes: int
    bits: int = 8


def packed_nbytes(size: int, bits: int) -> int:
    """Payload bytes for ``size`` quantized values at the given width."""
    if bits == 8:
        return size
    return (size + 1) // 2


def pack_int4(q):
    """Pack an int8 array of values in [-7, 7] into a uint8 array, two
    nibbles per byte (low nibble first; odd tails pad with 0)."""
    flat = np.asarray(q, dtype=np.int8).reshape(-1)
    if flat.size % 2:
        flat = np.concatenate([flat, np.zeros(1, np.int8)])
    u = (flat.astype(np.int16) & 0xF).astype(np.uint8)
    return (u[0::2] | (u[1::2] << 4)).astype(np.uint8)


def unpack_int4(packed, size: int):
    """Inverse of ``pack_int4``: uint8 nibbles back to int8, trimmed to
    ``size`` values (sign-extended from 4 bits)."""
    p = np.asarray(packed, dtype=np.uint8)
    lo = (p & 0xF).astype(np.int8)
    hi = (p >> 4).astype(np.int8)
    vals = np.empty(p.size * 2, np.int8)
    vals[0::2] = lo
    vals[1::2] = hi
    vals = np.where(vals >= 8, vals - 16, vals).astype(np.int8)
    return vals[:size]


@torch.no_grad()
def _q_leaf(a, b, qmax: int):
    d = a.float() - b.float()
    scale = torch.clamp(d.abs().max(), min=1e-12) / qmax
    q = torch.clamp(torch.round(d / scale), -qmax, qmax).to(torch.int8)
    return q, scale


def quantize_delta(w_new, anchor, bits: int = 8) -> QuantizedUpdate:
    """Symmetric per-leaf quantization of (w_new - anchor)."""
    if bits not in _QMAX:
        raise ValueError(
            f"unsupported wire width bits={bits!r}; valid: "
            f"{sorted(_QMAX)} (int8, packed int4)")
    qmax = _QMAX[bits]
    scales: list = []

    def q_leaf(a, b):
        q, s = _q_leaf(a, b, qmax)
        scales.append(s)
        return q

    q = tree_map(q_leaf, w_new, anchor)
    it = iter(scales)
    scale = tree_map(lambda _: next(it), q)
    wire = sum(packed_nbytes(a.numel(), bits) + 4 for a in leaves(w_new))
    return QuantizedUpdate(q, scale, nbytes(w_new), wire, bits)


@torch.no_grad()
def dequantize_delta(upd: QuantizedUpdate, anchor):
    """Server-side reconstruction w_new ≈ anchor + scale·q."""
    return tree_map(lambda q, s, b: (b.float() + q.float() * s).to(b.dtype),
                    upd.q, upd.scale, anchor)


def roundtrip(w_new, anchor, bits: int = 8):
    """Convenience: quantize + dequantize (what the server sees)."""
    upd = quantize_delta(w_new, anchor, bits)
    return dequantize_delta(upd, anchor), upd


def compression_ratio(upd: QuantizedUpdate) -> float:
    return upd.base_bytes / max(upd.wire_bytes, 1)

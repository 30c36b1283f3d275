"""Public entries of the port's kernels (counterpart of
``repro/kernels/ops.py``)."""
from __future__ import annotations

from repro_torch.kernels import swa_attention as _swa
from repro_torch.kernels.decode_attend import (extent_decode_attend,
                                               ring_decode_attend)
from repro_torch.kernels.kd_loss import kd_loss_rows
from repro_torch.kernels.ssd_decode import ssd_decode_step
from repro_torch.kernels.ssd_scan import ssd_scan

__all__ = ["extent_decode_attend", "kd_loss_rows", "ring_decode_attend",
           "ssd_decode_step", "ssd_scan", "swa_attention",
           "swa_attention_gqa"]


def _band(S: int, window: int) -> int:
    """The kernel's window (0 -> S). S must be a multiple of the
    reference's block, min(128, S)."""
    block = min(128, S)
    if S % block:
        raise ValueError(f"seq len {S} not divisible by blocks "
                         f"(qb={block}, kb={block})")
    return window if window > 0 else S


def swa_attention(q, k, v, window: int, causal: bool = True):
    """(BH, S, D) sliding-window flash attention; window=0 -> full."""
    return _swa.swa_attention(q, k, v, _band(q.shape[1], window),
                              causal=causal)


def swa_attention_gqa(q, k, v, window: int, causal: bool = True):
    """The same attention in the model's layout: q (B, S, H, D), k and v
    (B, S, KV, D) -> (B, S, H, D); window=0 -> full."""
    return _swa.swa_attention_gqa(q, k, v, _band(q.shape[1], window),
                                  causal=causal)

"""Shared building blocks: norms, RoPE, activations, initializers, losses
(port of ``repro/models/common.py``).

Models are pure functions over flat param dicts. The LM's layer params
carry a leading ``L`` axis, as in the reference; the port's layer loops
are plain Python loops over it.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def normal_init(stddev: float = 0.02):
    """N(0, stddev²), drawn from ``gen`` on the generator's device (scaled
    in place: a full-width weight is allocated once)."""
    def init(gen: torch.Generator, shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen,
                           device=gen.device).mul_(stddev).to(dtype)
    return init


def fan_in_init():
    """N(0, 1/fan_in) with fan_in = shape[-2] (shape[-1] for 1-D), scaled
    in place."""
    def init(gen: torch.Generator, shape, dtype=torch.float32):
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        std = 1.0 / math.sqrt(fan_in)
        return torch.randn(shape, generator=gen,
                           device=gen.device).mul_(std).to(dtype)
    return init


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMS norm in f32, scaled by ``1 + scale``; returns x's dtype."""
    dtype = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(dtype)


def _squared_relu(x):
    return torch.square(F.relu(x))


def _gelu_tanh(x):
    # jax.nn.gelu's default is the tanh approximation
    return F.gelu(x, approximate="tanh")


def activation(name: str):
    if name == "silu":
        return F.silu
    if name == "gelu":
        return _gelu_tanh
    if name == "relu":
        # squared relu (Nemotron/minitron); plain relu is never used gated
        return _squared_relu
    raise ValueError(f"unknown activation {name!r}")


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """(head_dim//2,) inverse frequencies, f32."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Rotate split halves (not interleaved), in f32.

    x: (..., S, H, D); positions: broadcastable to (..., S) — ``(S,)`` in
    prefill, ``(B, 1)`` in decode, where every row has its own position.
    """
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)       # (D/2,)
    angles = positions[..., None].float() * freqs                 # (..., S, D/2)
    cos = torch.cos(angles)[..., None, :]                         # (..., S, 1, D/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------

def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  ignore_index: int = -100) -> torch.Tensor:
    """Mean CE over non-ignored positions. logits (..., V), labels (...)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1,
                        labels.long().clamp(min=0).unsqueeze(-1))[..., 0]
    mask = (labels != ignore_index).float()
    nll = (lse - gold) * mask
    return nll.sum() / mask.sum().clamp(min=1.0)


def _chunk_nll(h: torch.Tensor, lm_head: torch.Tensor, labels: torch.Tensor,
               split=None):
    """One chunk's summed next-token NLL and count of non-ignored labels.
    With ``split`` (a ``sharding.MeshSplit`` whose ``"model"`` splits the
    vocabulary) ``lm_head`` is the rank's block of columns: the row maxima
    and the sums of exponentials are reduced over ``"model"``, and the
    gold logit comes from the rank whose block holds the label."""
    logits = torch.matmul(h, lm_head).float()
    if split is None:
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1,
                            labels.long().clamp(min=0).unsqueeze(-1))[..., 0]
    else:
        V = logits.shape[-1]
        m = split.vocab_max(logits.detach().amax(dim=-1))
        lse = torch.log(split.vocab_sum(
            torch.exp(logits - m[..., None]).sum(dim=-1))) + m
        local = labels.long() - split.vocab_offset(V)
        own = (local >= 0) & (local < V)
        g = torch.gather(logits, -1, local.clamp(0, V - 1).unsqueeze(-1))
        gold = split.vocab_sum(torch.where(own, g[..., 0], 0.0))
    mask = (labels != -100).float()
    return torch.sum((lse - gold) * mask), torch.sum(mask)


def chunked_lm_nll(hidden: torch.Tensor, lm_head: torch.Tensor,
                   labels: torch.Tensor, chunk: int = 512, split=None):
    """The summed next-token NLL and the count of non-ignored labels,
    without materialising (B, S, V) at once.

    Walks sequence chunks; under autograd each chunk's logits are
    recomputed in the backward pass (``torch.utils.checkpoint``), so peak
    memory is (B, chunk, V). hidden: (B, S, d); lm_head: (d, V); labels:
    (B, S), -100 ignored. ``split``: the vocabulary-parallel CE of
    ``_chunk_nll``, ``lm_head`` the rank's (d, V / M) block, the chunks
    (B, chunk, V / M).
    """
    B, S, d = hidden.shape
    chunk = min(chunk, S)
    if S % chunk:
        pad = chunk - S % chunk
        hidden = F.pad(hidden, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=-100)
        S += pad
    remat = torch.is_grad_enabled() and (hidden.requires_grad
                                         or lm_head.requires_grad)
    nll = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(0, S, chunk):
        args = (hidden[:, i:i + chunk], lm_head, labels[:, i:i + chunk],
                split)
        a, c = (checkpoint(_chunk_nll, *args, use_reentrant=False) if remat
                else _chunk_nll(*args))
        nll, cnt = nll + a, cnt + c
    return nll, cnt


def chunked_lm_loss(hidden: torch.Tensor, lm_head: torch.Tensor,
                    labels: torch.Tensor, chunk: int = 512) -> torch.Tensor:
    """Next-token CE (mean over the non-ignored labels) of
    ``chunked_lm_nll``."""
    nll, cnt = chunked_lm_nll(hidden, lm_head, labels, chunk)
    return nll / torch.clamp(cnt, min=1.0)

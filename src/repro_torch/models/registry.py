"""Family dispatch (port of ``repro/models/registry.py``): the resnet3d
branch, the decoder-only LM branch (dense / moe / ssm / hybrid / vlm) and
the encoder-decoder branch (encdec / audio).

    init_params(gen, cfg, device, dtype) -> flat param dict
    loss_fn(params, cfg, batch, **kw)    -> (loss, metrics)
    logits_fn(params, cfg, batch, **kw)  -> LM: (B, S, V); resnet3d:
                                            (B, classes)
    logit_width(cfg)                     -> KD compatibility width
    init_cache / init_ring_cache / prefill / decode_step /
    decode_step_grouped                  -> serving
    batch_spec(cfg, shape)               -> meta tensors of a batch
    decode_spec(cfg, shape)              -> meta (token, cache, pos)
    synth_batch(rng, cfg, shape)         -> a random batch (numpy draws)
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import encdec, lm, resnet3d
from repro_torch.types import ModelConfig, ShapeConfig

LM_FAMILIES = lm.FAMILIES
ENCDEC_FAMILIES = ("encdec", "audio")

# Decoder-side target length of the encoder-decoder's serving shapes: a
# shape's seq_len measures the source; the decoder cache is bounded
# separately.
ENCDEC_TGT_LEN = 1024


def init_params(gen: torch.Generator, cfg: ModelConfig, device,
                dtype=torch.float32) -> dict:
    if cfg.family in LM_FAMILIES:
        return lm.init_params(gen, cfg, device, dtype)
    if cfg.family in ENCDEC_FAMILIES:
        return encdec.init_params(gen, cfg, device, dtype)
    if cfg.family == "resnet3d":
        return resnet3d.init_params(gen, cfg, device, dtype)
    raise ValueError(cfg.family)


def loss_fn(params, cfg: ModelConfig, batch: dict, **kw):
    """LM: next-token CE of ``batch`` (tokens, labels; the MoE aux loss
    added); ``kernel="cuda"`` scores the decoder-only families through the
    hand-written kernels."""
    if cfg.family in LM_FAMILIES:
        return lm.loss_fn(params, cfg, batch, **kw)
    if cfg.family in ENCDEC_FAMILIES:
        return encdec.loss_fn(params, cfg, batch, **kw)
    if cfg.family == "resnet3d":
        return resnet3d.loss_fn(params, cfg, batch, **kw)
    raise ValueError(cfg.family)


def logits_fn(params, cfg: ModelConfig, batch: dict, **kw):
    if cfg.family in LM_FAMILIES:
        return lm.logits_fn(params, cfg, batch["tokens"],
                            batch.get("prefix_embeds"), **kw)
    if cfg.family in ENCDEC_FAMILIES:
        return encdec.logits_fn(params, cfg, batch, **kw)
    if cfg.family == "resnet3d":
        return resnet3d.logits_fn(params, cfg, batch, **kw)
    raise ValueError(cfg.family)


def logit_width(cfg: ModelConfig) -> int:
    """Width of the last logits axis: a teacher and a student can only
    distil if their widths match."""
    return cfg.num_classes if cfg.family == "resnet3d" else cfg.vocab_size


def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               dtype=torch.bfloat16, device=None) -> dict:
    """LM: a uniform cache of ``seq_len`` positions; encoder-decoder: a
    source of ``seq_len`` frames and ``ENCDEC_TGT_LEN`` target positions."""
    if cfg.family in LM_FAMILIES:
        return lm.init_cache(cfg, batch, seq_len, dtype, device)
    if cfg.family in ENCDEC_FAMILIES:
        return encdec.init_cache(cfg, batch, seq_len, ENCDEC_TGT_LEN, dtype,
                                 device)
    raise ValueError(f"{cfg.family}: no autoregressive cache")


def init_ring_cache(cfg: ModelConfig, batch: int, seq_len: int,
                    dtype=torch.bfloat16, device=None) -> dict:
    """Per-layer-kind decode cache: W-slot ring buffers for SWA layers,
    ``seq_len`` buffers for full-attention layers (LM families only)."""
    if cfg.family not in LM_FAMILIES:
        raise ValueError(f"{cfg.family}: no ring decode cache")
    return lm.init_ring_cache(cfg, batch, seq_len, dtype, device)


def prefill(params, cfg: ModelConfig, batch: dict, cache, **kw):
    """LM: (last logits, cache); encoder-decoder: the cache with the
    source's cross-attention K/V (bucketed ``lengths=`` is LM-only)."""
    if cfg.family in LM_FAMILIES:
        return lm.prefill(params, cfg, batch["tokens"], cache,
                          batch.get("prefix_embeds"), **kw)
    if cfg.family in ENCDEC_FAMILIES:
        if kw.pop("lengths", None) is not None:
            raise ValueError(
                f"{cfg.family}: bucketed prefill (lengths=) is LM-only")
        return encdec.prefill(params, cfg, batch["src_embeds"], cache, **kw)
    raise ValueError(cfg.family)


def decode_step(params, cfg: ModelConfig, token, cache, pos, **kw):
    if cfg.family in LM_FAMILIES:
        return lm.decode_step(params, cfg, token, cache, pos, **kw)
    if cfg.family in ENCDEC_FAMILIES:
        return encdec.decode_step(params, cfg, token, cache, pos, **kw)
    raise ValueError(cfg.family)


def decode_step_grouped(params, cfg: ModelConfig, token, cache, pos, **kw):
    """Decode against an ``init_ring_cache`` layout; ``k_ext`` bounds the
    K-extent full-attention layers attend against."""
    if cfg.family not in LM_FAMILIES:
        raise ValueError(f"{cfg.family}: no grouped ring decode")
    return lm.decode_step_grouped(params, cfg, token, cache, pos, **kw)


# ---------------------------------------------------------------------------
# Input specs / synthetic batches
# ---------------------------------------------------------------------------

def _spec(shape, dtype) -> torch.Tensor:
    """A tensor with a shape and a dtype and no storage: PyTorch's
    counterpart of ``jax.ShapeDtypeStruct``."""
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_spec(cfg: ModelConfig, shape: ShapeConfig,
               act_dtype=torch.bfloat16) -> dict:
    """Meta tensors of a *training/prefill* batch (no allocation), in the
    reference's key order."""
    B, S = shape.global_batch, shape.seq_len
    if cfg.family == "resnet3d":
        return {"clips": _spec(resnet3d.input_shape(cfg, B), act_dtype),
                "labels": _spec((B,), torch.int32)}
    if cfg.family in ENCDEC_FAMILIES:
        tgt = S // 2 if shape.kind == "train" else ENCDEC_TGT_LEN
        src = S - tgt if shape.kind == "train" else S
        return {"src_embeds": _spec((B, src, cfg.d_model), act_dtype),
                "tokens": _spec((B, tgt), torch.int32),
                "labels": _spec((B, tgt), torch.int32)}
    spec = {}
    text = S
    if cfg.prefix_len:
        text = S - cfg.prefix_len
        spec["prefix_embeds"] = _spec((B, cfg.prefix_len, cfg.d_model),
                                      act_dtype)
    spec["tokens"] = _spec((B, text), torch.int32)
    spec["labels"] = _spec((B, text), torch.int32)
    return spec


def decode_spec(cfg: ModelConfig, shape: ShapeConfig,
                cache_dtype=torch.bfloat16):
    """Meta tensors of one serve step: (token (B,), cache, pos). The
    port's decode positions are per row, so ``pos`` is (B,) int32 where
    the reference's is a scalar."""
    B, S = shape.global_batch, shape.seq_len
    return (_spec((B,), torch.int32),
            init_cache(cfg, B, S, cache_dtype, device="meta"),
            _spec((B,), torch.int32))


def synth_batch(rng: np.random.Generator, cfg: ModelConfig,
                shape: ShapeConfig, act_dtype=torch.float32,
                device=None) -> dict:
    """A random batch matching ``batch_spec``, drawn from ``rng`` in the
    spec's key order exactly as the reference draws it (ints uniform over
    the logit width, floats standard normal in f32), on ``device`` (the
    card unless the CPU is named)."""
    device = resolve_device(device)
    out = {}
    for k, s in batch_spec(cfg, shape, act_dtype).items():
        if s.dtype == torch.int32:
            a = rng.integers(0, logit_width(cfg), s.shape, dtype=np.int32)
        else:
            a = rng.standard_normal(s.shape, dtype=np.float32)
        out[k] = torch.from_numpy(a).to(device=device, dtype=s.dtype)
    return out

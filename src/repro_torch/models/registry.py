"""Family dispatch (port of ``repro/models/registry.py``, resnet3d branch).

    init_params(gen, cfg, device, dtype) -> flat param dict
    loss_fn(params, cfg, batch)          -> (loss, metrics)
    logits_fn(params, cfg, batch)        -> (B, classes)
    logit_width(cfg)                     -> KD compatibility width

The LM / enc-dec families come with the LM stack (ROADMAP Queue 1 item 11).
"""
from __future__ import annotations

import torch

from repro_torch.models import resnet3d
from repro_torch.types import ModelConfig


def _only_resnet3d(cfg: ModelConfig):
    if cfg.family != "resnet3d":
        raise NotImplementedError(
            f"{cfg.family}: the port has the resnet3d family only so far "
            "(LM stack: ROADMAP Queue 1 item 11)")


def init_params(gen: torch.Generator, cfg: ModelConfig, device,
                dtype=torch.float32) -> dict:
    _only_resnet3d(cfg)
    return resnet3d.init_params(gen, cfg, device, dtype)


def loss_fn(params, cfg: ModelConfig, batch: dict, **kw):
    _only_resnet3d(cfg)
    return resnet3d.loss_fn(params, cfg, batch, **kw)


def logits_fn(params, cfg: ModelConfig, batch: dict, **kw):
    _only_resnet3d(cfg)
    return resnet3d.logits_fn(params, cfg, batch, **kw)


def logit_width(cfg: ModelConfig) -> int:
    """Width of the last logits axis: a teacher and a student can only
    distil if their widths match."""
    return cfg.num_classes if cfg.family == "resnet3d" else cfg.vocab_size

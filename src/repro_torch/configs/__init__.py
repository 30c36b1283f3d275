"""Config registry of the port: the paper's 3-D ResNets.

The assigned LM configs arrive with the LM stack (ROADMAP Queue 1 item 11).
"""
from __future__ import annotations

from repro_torch.configs.resnet3d import RESNET18, RESNET26, RESNET34
from repro_torch.types import ModelConfig

_REGISTRY = {c.name: c for c in (RESNET18, RESNET26, RESNET34)}


def get_config(name: str) -> ModelConfig:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown arch {name!r}; the port knows {sorted(_REGISTRY)} "
            "(LM configs: ROADMAP Queue 1 item 11)") from None


__all__ = ["RESNET18", "RESNET26", "RESNET34", "get_config"]

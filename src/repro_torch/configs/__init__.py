"""Config registry of the port: the paper's 3-D ResNets and the LM
configs the serving path runs.

``hymba-1.5b`` is the serving slice's model (every decode kernel runs on
it); ``gemma3-12b`` (the serve CLI's default arch) and ``mamba2-130m`` are
data only here, for the dense and pure-SSM families of the CPU tests. The
other assigned LM configs arrive with their families (ROADMAP Queue 1).
"""
from __future__ import annotations

from repro_torch.configs.gemma3_12b import CONFIG as _gemma3
from repro_torch.configs.hymba_1_5b import CONFIG as _hymba
from repro_torch.configs.mamba2_130m import CONFIG as _mamba2
from repro_torch.configs.resnet3d import RESNET18, RESNET26, RESNET34
from repro_torch.types import ModelConfig

_REGISTRY = {c.name: c for c in (_gemma3, _hymba, _mamba2,
                                  RESNET18, RESNET26, RESNET34)}


def get_config(name: str) -> ModelConfig:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown arch {name!r}; the port knows {sorted(_REGISTRY)} "
            "(the other LM configs: ROADMAP Queue 1 item 11)") from None


__all__ = ["RESNET18", "RESNET26", "RESNET34", "get_config"]

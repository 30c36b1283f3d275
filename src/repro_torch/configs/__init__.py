"""Config registry of the port: the paper's 3-D ResNets, the ten
assigned LM configs and the four input shapes.

``hymba-1.5b`` is the serving and LM-training slices' model (every decode
kernel runs on it); ``gemma3-12b`` (the serve CLI's default arch),
``internlm2-20b``, ``h2o-danube-3-4b`` and ``minitron-4b`` are dense,
``mamba2-130m`` pure SSM, ``llama4-scout-17b-a16e`` and ``grok-1-314b``
MoE, ``paligemma-3b`` a patch-prefix VLM and ``seamless-m4t-large-v2``
the encoder-decoder.
"""
from __future__ import annotations

from repro_torch.configs.gemma3_12b import CONFIG as _gemma3
from repro_torch.configs.grok_1_314b import CONFIG as _grok1
from repro_torch.configs.h2o_danube_3_4b import CONFIG as _danube3
from repro_torch.configs.hymba_1_5b import CONFIG as _hymba
from repro_torch.configs.internlm2_20b import CONFIG as _internlm2
from repro_torch.configs.llama4_scout_17b_a16e import CONFIG as _llama4
from repro_torch.configs.mamba2_130m import CONFIG as _mamba2
from repro_torch.configs.minitron_4b import CONFIG as _minitron
from repro_torch.configs.paligemma_3b import CONFIG as _paligemma
from repro_torch.configs.resnet3d import RESNET18, RESNET26, RESNET34
from repro_torch.configs.seamless_m4t_large_v2 import CONFIG as _seamless
from repro_torch.types import ModelConfig, ShapeConfig

_REGISTRY = {c.name: c for c in (
    _llama4, _grok1, _seamless, _gemma3, _internlm2, _minitron, _danube3,
    _hymba, _mamba2, _paligemma, RESNET18, RESNET26, RESNET34)}

# The 10 assigned architecture ids (order of the assignment sheet).
ASSIGNED_ARCHS = (
    "llama4-scout-17b-a16e",
    "grok-1-314b",
    "seamless-m4t-large-v2",
    "gemma3-12b",
    "internlm2-20b",
    "minitron-4b",
    "h2o-danube-3-4b",
    "hymba-1.5b",
    "mamba2-130m",
    "paligemma-3b",
)

SHAPES = {
    "train_4k":    ShapeConfig("train_4k",    seq_len=4_096,   global_batch=256, kind="train"),
    "prefill_32k": ShapeConfig("prefill_32k", seq_len=32_768,  global_batch=32,  kind="prefill"),
    "decode_32k":  ShapeConfig("decode_32k",  seq_len=32_768,  global_batch=128, kind="decode"),
    "long_500k":   ShapeConfig("long_500k",   seq_len=524_288, global_batch=1,   kind="decode"),
}


def get_config(name: str) -> ModelConfig:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; known: "
                       f"{sorted(_REGISTRY)}") from None


def list_archs() -> list[str]:
    return list(ASSIGNED_ARCHS)


def shape_supported(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Whether (arch, shape) is in the dry-run matrix; (ok, reason_if_not).
    long_500k needs sub-quadratic attention."""
    if cfg.family == "resnet3d":
        if shape.kind != "train":
            return False, "resnet3d: clip classifier, no autoregressive decode"
        return True, ""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "full-attention arch: 500k decode skipped per DESIGN.md"
    return True, ""


__all__ = ["RESNET18", "RESNET26", "RESNET34", "ASSIGNED_ARCHS", "SHAPES",
           "get_config", "list_archs", "shape_supported"]

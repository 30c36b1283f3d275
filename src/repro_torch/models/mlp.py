"""Gated MLP (SwiGLU / GeGLU / squared-ReLU-GLU); port of
``repro/models/mlp.py``."""
from __future__ import annotations

import torch

from repro_torch.models.common import activation, fan_in_init


def init_mlp_params(gen: torch.Generator, d_model: int, d_ff: int,
                    num_layers: int, dtype=torch.float32) -> dict:
    init = fan_in_init()
    L = num_layers
    return {
        "wg": init(gen, (L, d_model, d_ff), dtype),
        "wi": init(gen, (L, d_model, d_ff), dtype),
        "wo": init(gen, (L, d_ff, d_model), dtype),
    }


def mlp_forward(p: dict, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    dt = x.dtype
    g = torch.matmul(x, p["wg"].to(dt))
    h = torch.matmul(x, p["wi"].to(dt))
    return torch.matmul(activation(act)(g) * h, p["wo"].to(dt))

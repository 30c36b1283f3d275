"""Bridge between the reference's parameters and the port's.

Both sides key parameters by the '/'-joined paths that
``repro/checkpoint/ckpt.py::_flatten`` writes (``stem/w``,
``stages/2/0/w1``, ``fc/b``, ``layers/attn/wq``, ``layers/ssm/in_proj``,
``layers/moe/router``, ``dec_layers/xattn/wk``, ``enc_norm`` ...). Conv
weights are DHWIO in the reference and OIDHW here; ``fc/w`` keeps its
(C, classes) meaning; 1-D leaves are unchanged. The LM's einsum weights
keep their (d_in, d_out) layout (the MoE experts' (L, E, d_in, d_out)),
so an LM or encoder-decoder conversion is a shape-checked copy. This is
how the parity tests hand the port JAX-initialised weights, and how the
port reads an npz checkpoint saved by the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import encdec, lm, resnet3d
from repro_torch.types import ModelConfig

_DHWIO_TO_OIDHW = (4, 3, 0, 1, 2)
_OIDHW_TO_DHWIO = (2, 3, 4, 1, 0)


def _shapes(cfg: ModelConfig) -> dict:
    if cfg.family == "resnet3d":
        return resnet3d.param_shapes(cfg)
    if cfg.is_encdec:
        return encdec.param_shapes(cfg)
    return lm.param_shapes(cfg)


def params_from_jax(flat_numpy: dict, cfg: ModelConfig,
                    device="cpu") -> dict:
    """Reference flat params ({path: numpy array}) -> port params."""
    shapes = _shapes(cfg)
    if set(flat_numpy) != set(shapes):
        missing = sorted(set(shapes) - set(flat_numpy))
        extra = sorted(set(flat_numpy) - set(shapes))
        raise ValueError(f"{cfg.name}: keys differ; missing {missing}, "
                         f"unexpected {extra}")
    out = {}
    for k, shape in shapes.items():
        a = np.asarray(flat_numpy[k])
        if a.ndim == 5 and cfg.family == "resnet3d":
            a = a.transpose(_DHWIO_TO_OIDHW)
        if a.shape != shape:
            raise ValueError(f"{k}: got {a.shape} after conversion, "
                             f"want {shape}")
        out[k] = torch.tensor(a, device=device)
    return out


def params_to_numpy(params: dict) -> dict:
    """Port params -> reference flat params ({path: numpy array})."""
    out = {}
    for k, v in params.items():
        a = v.detach().cpu().numpy()
        out[k] = a.transpose(_OIDHW_TO_DHWIO) if a.ndim == 5 else a
    return out


def load_jax_checkpoint(path: str, cfg: ModelConfig, device="cpu") -> dict:
    """Read an npz written by ``repro.checkpoint.save_params``."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    with np.load(path) as data:
        return params_from_jax({k: data[k] for k in data.files}, cfg,
                               device=device)

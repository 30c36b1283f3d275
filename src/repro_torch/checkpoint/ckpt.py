"""Parameter checkpoints: an npz payload and a JSON manifest, in the
reference's format (port of ``repro/checkpoint/ckpt.py``).

The npz is keyed by the '/'-joined parameter paths, the port's own keys,
with the weights in the reference's layouts (``convert.params_to_numpy``:
conv weights DHWIO). So ``repro.checkpoint.load_params`` reads a
checkpoint written here, and ``load_params`` here (or
``convert.load_jax_checkpoint``) reads one written by the reference. The
manifest holds ``keys`` (sorted) and ``extra``; its ``treedef`` field,
which the reference fills with a JAX tree structure that the port cannot
form and that no loader reads, holds the sorted key list instead. Server
state (global epoch, update count, the FedConfig) rides in ``extra``.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from repro_torch.checkpoint.convert import _DHWIO_TO_OIDHW, params_to_numpy


def _npz_path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def _manifest_path(path: str) -> str:
    base = path[:-4] if path.endswith(".npz") else path
    return base + ".json"


def save_params(params: dict, path: str, extra: dict | None = None):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = params_to_numpy(params)
    np.savez(_npz_path(path), **flat)
    keys = sorted(flat)
    manifest = {"treedef": keys, "keys": keys, "extra": extra or {}}
    with open(_manifest_path(path), "w") as f:
        json.dump(manifest, f, indent=1)


def load_params(template: dict, path: str) -> dict:
    """Restore into ``template``'s keys, shapes, dtypes and devices."""
    out = {}
    with np.load(_npz_path(path)) as data:
        for k, leaf in template.items():
            a = data[k]
            if a.ndim == 5:
                a = a.transpose(_DHWIO_TO_OIDHW)
            if tuple(a.shape) != tuple(leaf.shape):
                raise ValueError(f"{k}: checkpoint {tuple(a.shape)} != "
                                 f"{tuple(leaf.shape)}")
            out[k] = torch.tensor(a).to(device=leaf.device, dtype=leaf.dtype)
    return out


def save_server_state(state, path: str, fed=None):
    extra = {"t": int(state.t), "total_updates": int(state.total_updates)}
    if fed is not None:
        extra["fed"] = dict(fed.__dict__)
    save_params(state.params, path, extra=extra)


def load_server_state(template_params: dict, path: str):
    from repro_torch.core.fedasync import ServerState
    params = load_params(template_params, path)
    with open(_manifest_path(path)) as f:
        extra = json.load(f)["extra"]
    return ServerState(params=params, t=extra["t"],
                       total_updates=extra["total_updates"])

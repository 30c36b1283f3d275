"""The paper's proximal local objective (§III-D):

    g_{w_t}(w; d) = l(w; d) + (θ/2)·||w - w_t||²

so ∇g = ∇l + θ·(w - w_t). The difference is taken in f32 and cast back to
the gradient dtype, as in ``repro/optim/proximal.py``.
"""
from __future__ import annotations

import torch


@torch.no_grad()
def proximal_grad(grads: dict, params: dict, anchor: dict,
                  theta: float) -> dict:
    if theta == 0.0:
        return grads
    return {k: g + theta * (params[k].float() - anchor[k].float()).to(g.dtype)
            for k, g in grads.items()}

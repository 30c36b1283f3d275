"""The paper's proximal local objective (§III-D):

    g_{w_t}(w; d) = l(w; d) + (θ/2)·||w - w_t||²

so ∇g = ∇l + θ·(w - w_t). The difference is taken in f32 and cast back to
the gradient dtype, as in ``repro/optim/proximal.py``; SCAFFOLD's drift
correction and the penalty's value sit beside it.
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


@torch.no_grad()
def control_variate_grad(grads: dict, c: dict, c_k: dict) -> dict:
    """SCAFFOLD drift correction (Karimireddy et al. 2020, Alg. 1 line 10):
    g ← g + c − c_k, the variates accumulated in f32 and the result cast
    back to the gradient dtype. Composes after ``proximal_grad``."""
    return {k: (g.float() + c[k] - c_k[k]).to(g.dtype)
            for k, g in grads.items()}


@torch.no_grad()
def proximal_penalty(params: dict, anchor: dict, theta: float):
    """(θ/2)·||w - w_t||² as an f32 0-d tensor (for logging); the squares
    summed per leaf, the leaves in the reference's (sorted key) order."""
    total = torch.tensor(0.0, dtype=torch.float32,
                         device=next(iter(params.values())).device)
    if theta == 0.0:
        return total
    for k in sorted(params):
        total = total + (params[k].float() - anchor[k].float()).square().sum()
    return 0.5 * theta * total

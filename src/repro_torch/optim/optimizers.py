"""Functional SGD over flat parameter dicts (port of ``repro/optim``).

An Optimizer is (init, update): ``update(grads, state, params) ->
(new_params, new_state)``, each a dict keyed like the params. The update
order is the reference's: weight decay is added to the gradients before
momentum, and momentum accumulates as ``μ·m + g``. ``adamw`` and the
schedules are still to be ported (ROADMAP Queue 1 item 2).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class Optimizer(NamedTuple):
    init: Callable
    update: Callable


def value_and_grad(loss_of: Callable, params: dict):
    """(loss, {key: grad}) of ``loss_of(params)`` w.r.t. every leaf; the
    loss comes back detached."""
    p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    loss = loss_of(p)
    grads = torch.autograd.grad(loss, list(p.values()))
    return loss.detach(), dict(zip(p, grads))


def sgd(lr: float, momentum: float = 0.0,
        weight_decay: float = 0.0) -> Optimizer:
    """Constant learning rate (the schedules are still to be ported)."""

    def init(params):
        mom = ({k: torch.zeros_like(v) for k, v in params.items()}
               if momentum else None)
        return {"mom": mom, "step": 0}

    @torch.no_grad()
    def update(grads, state, params):
        if weight_decay:
            grads = {k: g + weight_decay * params[k]
                     for k, g in grads.items()}
        if momentum:
            mom = {k: momentum * state["mom"][k] + g
                   for k, g in grads.items()}
            eff = mom
        else:
            mom, eff = None, grads
        new_state = {"mom": mom, "step": state["step"] + 1}
        new_params = {k: (p - lr * eff[k]).to(p.dtype)
                      for k, p in params.items()}
        return new_params, new_state

    return Optimizer(init, update)


# head keys: the paper fine-tunes only the final FC layer (§V-B)
_HEAD_KEYS = frozenset({"fc", "lm_head", "final_norm", "enc_norm"})


def trainable_mask(params: dict, mode: str = "all") -> dict:
    """Per-leaf 0/1 floats. mode: 'all' | 'last_layer' (only the
    classifier head: 'fc' for resnet3d; 'embed' too for tied LMs)."""
    if mode == "all":
        return {k: 1.0 for k in params}
    if mode != "last_layer":
        raise ValueError(mode)
    tops = {k.split("/")[0] for k in params}
    head = _HEAD_KEYS
    if "lm_head" not in tops and "fc" not in tops:
        head = head | {"embed"}
    return {k: 1.0 if k.split("/")[0] in head else 0.0 for k in params}


def apply_mask(grads: dict, mask: dict) -> dict:
    return {k: g * mask[k] for k, g in grads.items()}

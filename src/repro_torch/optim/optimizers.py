"""Functional optimizers over flat parameter dicts (port of
``repro/optim/optimizers.py``): SGD with momentum, Nesterov and weight
decay, and AdamW.

An Optimizer is (init, update): ``update(grads, state, params) ->
(new_params, new_state)``, each a dict keyed like the params. The update
order is the reference's: weight decay is added to the gradients before
momentum, and momentum accumulates as ``μ·m + g``.

The learning rate is a float or a schedule, a function of the step
(``optim/schedules.py``). ``sgd``'s step has two formats, and every
caller keeps to them:

- a constant rate: the step is a host int. No graph reads it, so the
  engines never hand it to a captured call (``GraphCache`` would bake
  it into the graph and key a new graph on each value); they count it on
  the host where they must (``core/distill.py``'s epochs).
- a schedule: the step is a 0-d int32 tensor on the params' device. It
  enters every captured call as an array leaf and comes back as an
  output, and a masked step keeps it as it was (``fed_engine._where``),
  as the reference's int32 step does in its scans.

``adamw`` always keeps a tensor step, its bias corrections in f32 as the
reference computes them. As in the reference, ``sgd`` evaluates
``lr(step)`` before the increment and ``adamw`` after it.
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


def _step0(params: dict) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32,
                       device=next(iter(params.values())).device)


def sgd(lr, momentum: float = 0.0, weight_decay: float = 0.0,
        nesterov: bool = False) -> Optimizer:
    """lr: a float, or a schedule (step tensor -> f32 lr tensor)."""
    scheduled = callable(lr)

    def init(params):
        mom = ({k: torch.zeros_like(v) for k, v in params.items()}
               if momentum else None)
        return {"mom": mom, "step": _step0(params) if scheduled else 0}

    @torch.no_grad()
    def update(grads, state, params):
        step = state["step"]
        eta = lr(step) if scheduled else lr
        if weight_decay:
            grads = {k: g + weight_decay * params[k]
                     for k, g in grads.items()}
        if momentum:
            mom = {k: momentum * state["mom"][k] + g
                   for k, g in grads.items()}
            eff = ({k: momentum * m + grads[k] for k, m in mom.items()}
                   if nesterov else mom)
        else:
            mom, eff = None, grads
        new_state = {"mom": mom, "step": step + 1}
        new_params = {k: (p - eta * eff[k]).to(p.dtype)
                      for k, p in params.items()}
        return new_params, new_state

    return Optimizer(init, update)


def adamw(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    """Adam with decoupled weight decay; lr a float or a schedule."""

    def init(params):
        return {"m": {k: torch.zeros_like(v) for k, v in params.items()},
                "v": {k: torch.zeros_like(v) for k, v in params.items()},
                "step": _step0(params)}

    @torch.no_grad()
    def update(grads, state, params):
        step = state["step"] + 1
        eta = lr(step) if callable(lr) else lr
        m = {k: b1 * state["m"][k] + (1 - b1) * g for k, g in grads.items()}
        v = {k: b2 * state["v"][k] + (1 - b2) * g * g
             for k, g in grads.items()}
        sf = step.to(torch.float32)
        c1 = 1 - torch.pow(torch.full_like(sf, b1), sf)
        c2 = 1 - torch.pow(torch.full_like(sf, b2), sf)

        def upd(k, p):
            u = (m[k] / c1) / (torch.sqrt(v[k] / c2) + eps)
            if weight_decay:
                u = u + weight_decay * p
            return (p - eta * u).to(p.dtype)

        new_params = {k: upd(k, p) for k, p in params.items()}
        return new_params, {"m": m, "v": v, "step": step}

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

"""Step functions shared by the trainer, the server and the tests (port of
``repro/launch/steps.py``).

The *FL client local step* (paper Algorithm 1, client side): task
gradients, the proximal term θ(w - w_t), an SGD-momentum update; for the
LM families the forward computes in bf16 by default (f32 params and
gradients), as the reference's. ``make_serve_step`` is one token of
greedy decode against a cache. ``mixing_step`` / ``fedavg_step`` are the
server's aggregation programs, in f32 and cast back.

The reference lowers these across a device mesh (``act_pspec``,
``jit_train_step``, ``jit_serve_step``); the port runs on one device, and
those, like a ``mesh`` other than None, raise naming ROADMAP Queue 1 item
13.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.device import batch_to, params_device
from repro_torch.models import lm, registry
from repro_torch.optim import proximal_grad, sgd, value_and_grad
from repro_torch.types import FedConfig, ModelConfig


def _no_mesh(what: str):
    return NotImplementedError(
        f"{what}: device meshes are not ported yet (ROADMAP Queue 1 item 13)")


def act_pspec(mesh, cfg: ModelConfig, seq_len: int):
    raise _no_mesh("act_pspec")


def make_train_step(cfg: ModelConfig, fed: FedConfig, mesh=None,
                    seq_len: int = 0, proximal: bool = True,
                    loss_kwargs: Optional[dict] = None):
    """FL client local step: ``step(params, opt_state, anchor, batch) ->
    (params, opt_state, loss)``; returns ``(step, opt)``. The batch may be
    numpy or tensors; it is moved to the params' device. ``seq_len``
    served the reference's sequence sharding and is unused here."""
    if mesh is not None:
        raise _no_mesh("make_train_step(mesh=...)")
    opt = sgd(fed.lr, fed.momentum, fed.weight_decay)
    loss_kwargs = dict(loss_kwargs or {})
    if cfg.family != "resnet3d":
        loss_kwargs.setdefault("dtype", torch.bfloat16)   # bf16 compute

    def loss(params, batch):
        return registry.loss_fn(params, cfg, batch, **loss_kwargs)[0]

    def step(params, opt_state, anchor, batch):
        batch = batch_to(batch, params_device(params))
        l, grads = value_and_grad(lambda p: loss(p, batch), params)
        if proximal:
            grads = proximal_grad(grads, params, anchor, fed.prox_theta)
        params, opt_state = opt.update(grads, opt_state, params)
        return params, opt_state, l

    return step, opt


def make_serve_step(cfg: ModelConfig, unroll: bool = False,
                    window_slice: bool = False, ring: bool = False):
    """``step(params, token, cache, pos) -> (next_token int32, cache)``,
    greedy. ``ring`` decodes against a ``to_ring_cache`` layout;
    ``unroll`` with ``window_slice`` attends each SWA layer against the
    last ``window`` cache positions only."""
    kw = {}
    if unroll and cfg.family in lm.FAMILIES:
        kw = {"unroll": True, "window_slice": window_slice}

    @torch.no_grad()
    def step(params, token, cache, pos):
        if ring and cfg.family in lm.FAMILIES:
            logits, cache = lm.decode_step_ring(params, cfg, token, cache,
                                                pos)
        else:
            logits, cache = registry.decode_step(params, cfg, token, cache,
                                                 pos, **kw)
        return torch.argmax(logits, dim=-1).to(torch.int32), cache

    return step


def mixing_step(beta_t):
    """Paper server update w_t = (1-β_t)·w_{t-1} + β_t·w_new (async FL),
    accumulated in f32 and cast back."""
    @torch.no_grad()
    def step(w_prev: dict, w_new: dict) -> dict:
        return {k: ((1 - beta_t) * a.float()
                    + beta_t * w_new[k].float()).to(a.dtype)
                for k, a in w_prev.items()}
    return step


@torch.no_grad()
def fedavg_step(w_stacked: dict) -> dict:
    """FedAvg of client models stacked on a leading axis: the mean in f32
    as XLA computes it, the clients summed in order and the sum times the
    f32 reciprocal of their count, cast back."""
    def mean(s):
        acc = s[0].float()
        for i in range(1, s.shape[0]):
            acc = acc + s[i].float()
        return (acc * (1.0 / s.shape[0])).to(s.dtype)
    return {k: mean(s) for k, s in w_stacked.items()}


def jit_train_step(*args, **kwargs):
    raise _no_mesh("jit_train_step")


def jit_serve_step(*args, **kwargs):
    raise _no_mesh("jit_serve_step")

"""Asynchronous federated optimization (paper Algorithm 1).

Port of ``repro/core/fedasync.py``: the server's mix, one receive at a
time or a group in one call (``make_batched_server_update``; for a
stateful algorithm ``_alg_mix_fns``, which carries the server context
along), and the client's per-iteration loop, kept as the oracle of the
batched engines (``core/fed_engine.py``).

Server: on receiving (w_new, τ) from any client at global epoch t,
    β_t = β · s(t - τ),   s(x) = (1 + x)^{-a}        (paper §V-C)
    w_t = (1 - β_t) · w_{t-1} + β_t · w_new

Client k: from the received global (w_t, t), runs H ∈ [H_min, H_max] local
SGD iterations on g_{w_t}(w; d) = l(w; d) + (θ/2)||w - w_t||².
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from repro_torch.core.compile_cache import GraphCache
from repro_torch.device import batch_to, params_device
from repro_torch.models import registry
from repro_torch.optim import (apply_mask, proximal_grad, sgd,
                               trainable_mask, value_and_grad)
from repro_torch.types import FedConfig, ModelConfig


def staleness_fn(a: float):
    """s(x) = (1+x)^{-a} in f32 (the exponent rounded to f32, as the
    reference's weak-typed scalar is); s(0) = 1, decreasing (paper §IV-A).
    The server's β_t come from ``group_mixing_weights``."""
    def s(x):
        x = torch.clamp(torch.as_tensor(x), min=0).to(torch.float32)
        return (1.0 + x) ** torch.tensor(-a, dtype=torch.float32)
    return s


def mixing_weight(fed: FedConfig, t, tau):
    """β·s(t - τ) in f32."""
    return (torch.tensor(fed.mixing_beta, dtype=torch.float32)
            * staleness_fn(fed.staleness_a)(torch.as_tensor(t)
                                            - torch.as_tensor(tau)))


@dataclass
class ServerState:
    params: Any
    t: int = 0                 # global epoch counter
    total_updates: int = 0


@torch.no_grad()
def _mix(params: dict, w_new: dict, beta_t: float) -> dict:
    """One receive: ((1-β)·w + β·w_new) accumulated in f32, cast back.
    β and 1-β are rounded to f32 first, as the reference computes them."""
    b = np.float32(beta_t)
    one_minus = float(np.float32(1.0) - b)
    b = float(b)
    return {k: (one_minus * a.float() + b * w_new[k].float()).to(a.dtype)
            for k, a in params.items()}


def _mix_many_impl(params: dict, betas, *w_news) -> dict:
    """m receives applied in order, each exactly ``_mix``'s arithmetic
    (1-β and β in f32, f32 accumulate, cast back per receive)."""
    betas = torch.as_tensor(betas, device=params_device(params))
    for i, w_new in enumerate(w_news):
        b = betas[i]
        params = {k: ((1.0 - b) * a.float() + b * w_new[k].float()).to(a.dtype)
                  for k, a in params.items()}
    return params


# one graph per group size m (and params signature), shared by every
# FedConfig: the mix reads no config field
_GRAPHS = GraphCache()


def _mix_many(params: dict, betas, *w_news) -> dict:
    return _GRAPHS.call("mix_many", _mix_many_impl,
                        (params, np.asarray(betas, np.float32)) + w_news)


def make_server_update(fed: FedConfig):
    """The single-receive mix ``(w, w_new, β_t) -> w``: config-independent,
    one function for every FedConfig."""
    return _mix


def make_batched_server_update(fed: FedConfig):
    """The fused mix of a group of receives: ``(w, βs, *w_news) -> w``, the
    m mixes in order in one call, with no host read between them; replayed
    as one CUDA graph per group size on the card. Config-independent."""
    return _mix_many


def group_mixing_weights(fed: FedConfig, t: int, taus):
    """(staleness, β_t) for each of a group of receives applied in order:
    the i-th lands at global epoch t + i, so its staleness is
    clamp(t + i - τ_i, 0, K) — what chained ``server_receive`` computes."""
    stals, betas = [], []
    for i, tau in enumerate(taus):
        s = min(max(t + i - int(tau), 0), fed.max_staleness)
        stals.append(s)
        betas.append(float(fed.mixing_beta
                           * (1.0 + s) ** (-fed.staleness_a)))
    return stals, betas


def server_receive(state: ServerState, w_new, tau: int,
                   fed: FedConfig) -> ServerState:
    """One server step of Algorithm 1."""
    _, (beta_t,) = group_mixing_weights(fed, state.t, [tau])
    return ServerState(params=_mix(state.params, w_new, beta_t),
                       t=state.t + 1, total_updates=state.total_updates + 1)


# per-algorithm mixes, memoized by cache_key(): the graphs of each
# algorithm's group mixes key on its own entry name
_ALG_MIX_FNS: dict = {}


def _alg_mix_fns(algorithm):
    """``(mix, mix_many)`` of a stateful algorithm: m receives applied in
    order, each ``algorithm.mix`` over ``(params, server_ctx)``, as one
    call (one CUDA graph per group size m on the card; ``mix`` is the
    group of one). ``mix_many(params, ctx, betas, *w_news, *msgs)``
    returns ``(params, ctx)``."""
    key = algorithm.cache_key()
    if key in _ALG_MIX_FNS:
        return _ALG_MIX_FNS[key]

    def mix_many_impl(params, ctx, betas, *wm):
        m = len(wm) // 2
        betas = torch.as_tensor(betas, device=params_device(params))
        for i in range(m):
            params, ctx = algorithm.mix(params, ctx, wm[i], wm[m + i],
                                        betas[i])
        return params, ctx

    def mix_many(params, ctx, betas, *wm):
        return _GRAPHS.call(("alg_mix_many",) + key, mix_many_impl,
                            (params, ctx, np.asarray(betas, np.float32))
                            + tuple(wm))

    def mix(params, ctx, w_new, msg, beta_t):
        return mix_many(params, ctx, [beta_t], w_new, msg)

    _ALG_MIX_FNS[key] = (mix, mix_many)
    return mix, mix_many


def server_receive_many(state: ServerState, updates, fed: FedConfig,
                        mix_many=None, algorithm=None, server_ctx=None):
    """Apply a group of receives ``[(w_new, τ), ...]`` in order: m chained
    ``server_receive`` calls. A singleton stays on the scalar mix (so
    ``window=0`` is the event-by-event loop); a group of m ≥ 2 goes to
    ``mix_many`` (default ``make_batched_server_update(fed)``) as one
    call. Returns ``(new_state, stalenesses, betas)``.

    With a stateful ``algorithm`` the updates are ``(w_new, msg, τ)``
    triples, the mixes are ``algorithm.mix`` carrying ``server_ctx``
    (default the instance's) along, every group one call, and the return
    is ``(new_state, new_ctx, stalenesses, betas)``."""
    if algorithm is not None and algorithm.stateful:
        if server_ctx is None:
            server_ctx = algorithm.ctx_for(state.params)
        _, amix_many = _alg_mix_fns(algorithm)
        stals, betas = group_mixing_weights(
            fed, state.t, [tau for _, _, tau in updates])
        params, new_ctx = amix_many(
            state.params, server_ctx, betas, *[w for w, _, _ in updates],
            *[m for _, m, _ in updates])
        return (ServerState(params=params, t=state.t + len(updates),
                            total_updates=(state.total_updates
                                           + len(updates))),
                new_ctx, stals, betas)
    stals, betas = group_mixing_weights(fed, state.t,
                                        [tau for _, tau in updates])
    if len(updates) == 1:
        params = _mix(state.params, updates[0][0], betas[0])
    else:
        if mix_many is None:
            mix_many = make_batched_server_update(fed)
        params = mix_many(state.params, betas,
                          *[w_new for w_new, _ in updates])
    return (ServerState(params=params, t=state.t + len(updates),
                        total_updates=state.total_updates + len(updates)),
            stals, betas)


# ---------------------------------------------------------------------------
# Client
# ---------------------------------------------------------------------------

def make_client_step(cfg: ModelConfig, fed: FedConfig):
    """One proximal local SGD iteration:
    (params, opt_state, anchor, batch, mask) -> (params, opt_state, loss).
    Gradients -> proximal term -> trainable mask -> SGD, as the reference."""
    opt = sgd(fed.lr, fed.momentum, fed.weight_decay)

    def step(params, opt_state, anchor, batch, mask):
        batch = batch_to(batch, params_device(params))
        loss, grads = value_and_grad(
            lambda p: registry.loss_fn(p, cfg, batch)[0], params)
        grads = proximal_grad(grads, params, anchor, fed.prox_theta)
        grads = apply_mask(grads, mask)
        params, opt_state = opt.update(grads, opt_state, params)
        return params, opt_state, loss

    return step, opt


@functools.lru_cache(maxsize=16)
def cached_client_step(cfg: ModelConfig, fed: FedConfig):
    """Memoized ``make_client_step``: repeated simulator runs reuse one
    step instead of building a closure per run."""
    return make_client_step(cfg, fed)


def client_update(params_global, t: int, batches, cfg: ModelConfig,
                  fed: FedConfig, step=None, opt=None, mask=None,
                  num_iters: int | None = None):
    """Run H local iterations from the received global model.

    ``batches`` is an iterable of local data batches (length >= H).
    Returns (w_new, tau=t, losses); one host read of the loss per step.
    """
    if step is None:
        step, opt = make_client_step(cfg, fed)
    if mask is None:
        mask = trainable_mask(params_global, fed.trainable)
    params = params_global
    opt_state = opt.init(params)
    losses = []
    H = num_iters if num_iters is not None else fed.local_iters_max
    for _, batch in zip(range(H), batches):
        params, opt_state, loss = step(params, opt_state, params_global,
                                       batch, mask)
        losses.append(float(loss))
    return params, t, losses

"""Synchronous FedAvg baseline (McMahan et al. [30]; paper baseline #2).

Port of ``repro/core/fedavg.py`` through the per-client loop. Each round
every client runs up to ``fed.local_iters_max`` local steps from the
current global model; the server replaces the model with the (data-size)
weighted average. The wall clock of a round is its slowest client
(``core/simulator.py::run_sync``): the straggler penalty the async variant
removes.

Still to be ported: the batched round (``engine`` other than ``"loop"``,
ROADMAP Queue 1 item 7) and the ``algorithm=`` layer (item 8).
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.core.fedasync import make_client_step
from repro_torch.optim import trainable_mask
from repro_torch.types import FedConfig, ModelConfig


@torch.no_grad()
def weighted_average(param_trees: Sequence[dict], weights) -> dict:
    """Per leaf: the clients' leaves stacked as f32, times ``weights``
    ((n_clients,) f32, normalised), summed over the client axis and cast
    back to the leaf's dtype, as the reference computes it."""
    out = {}
    for k, leaf in param_trees[0].items():
        stacked = torch.stack([p[k].float() for p in param_trees])
        w = weights.to(stacked.device).reshape(
            (-1,) + (1,) * (stacked.dim() - 1))
        out[k] = (stacked * w).sum(dim=0).to(leaf.dtype)
    return out


def _client_weights(n: int, data_sizes: Sequence[int] | None):
    """1/n each, or the data sizes over their sum, in f32."""
    if data_sizes is None:
        return torch.full((n,), 1.0 / n, dtype=torch.float32)
    s = torch.tensor(data_sizes, dtype=torch.float32)
    return s / s.sum()


def fedavg_round_loop(params_global, client_batches: Sequence,
                      cfg: ModelConfig, fed: FedConfig, step=None, opt=None,
                      mask=None, data_sizes: Sequence[int] | None = None,
                      algorithm=None):
    """One round as a per-client, per-iteration loop: each client starts
    from ``params_global`` with a fresh optimizer state and runs up to
    ``fed.local_iters_max`` steps (one host read of the loss each).
    Returns (new_global_params, per_client_losses)."""
    if algorithm is not None:
        raise NotImplementedError(
            "algorithm=: the FedAlgorithm layer is ROADMAP Queue 1 item 8")
    if step is None:
        step, opt = make_client_step(cfg, fed)
    if mask is None:
        mask = trainable_mask(params_global, fed.trainable)
    results, losses = [], []
    for batches in client_batches:
        params = params_global
        opt_state = opt.init(params)
        cl = []
        for _, batch in zip(range(fed.local_iters_max), batches):
            params, opt_state, loss = step(params, opt_state, params_global,
                                           batch, mask)
            cl.append(float(loss))
        results.append(params)
        losses.append(cl)
    return (weighted_average(results,
                             _client_weights(len(results), data_sizes)),
            losses)


def fedavg_round(params_global, client_batches: Sequence, cfg: ModelConfig,
                 fed: FedConfig, engine="loop", mask=None,
                 data_sizes: Sequence[int] | None = None, algorithm=None):
    """One synchronous round. ``engine="loop"`` is ``fedavg_round_loop``,
    the only engine ported; returns (new_global_params, per_client_losses).
    """
    if engine != "loop":
        raise NotImplementedError(
            f"engine={engine!r}: the port has the per-client loop only; the "
            "batched round is ROADMAP Queue 1 item 7")
    return fedavg_round_loop(params_global, client_batches, cfg, fed,
                             mask=mask, data_sizes=data_sizes,
                             algorithm=algorithm)

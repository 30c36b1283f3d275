"""Synchronous FedAvg baseline (McMahan et al. [30]; paper baseline #2).

Port of ``repro/core/fedavg.py``. Each round every client runs up to
``fed.local_iters_max`` local steps from the current global model; the
server replaces the model with the (data-size) weighted average. The wall
clock of a round is its slowest client (``core/simulator.py::run_sync``):
the straggler penalty the async variant removes.

``fedavg_round`` runs the whole round as one ``fed_engine.SyncRound``
call (one CUDA graph replay per round shape on the card). Clients with
different batch counts H^k, including zero (out of data), pad to H_max
and run the masked round; only batch shapes that disagree drop to the
per-client fallback (``_ragged_fallback``). ``fedavg_round_loop`` is the
per-client, per-iteration loop, kept as the parity oracle.

``algorithm=``: a ``core.algorithms.FedAlgorithm`` or its name; ``None``
(and ``FedProx``) is the paper's round. A stateful algorithm's per-client
states and server context live on the caller's instance, keyed by
``client_ids`` (default ``range(n_clients)``): the round engine gets them
as inputs (``_alg_round_io``) and its outputs are committed back
(``_alg_round_commit``); the loop oracle runs
``algorithms.client_update_loop`` and ``algorithms.server_reduce``.
"""
from __future__ import annotations

import itertools
from typing import Sequence

import numpy as np
import torch

from repro_torch.core import algorithms, fed_engine
from repro_torch.core.fedasync import cached_client_step, make_client_step
from repro_torch.data import stack_batches
from repro_torch.device import params_device
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


def _alg_round_io(algorithm, params_global, n, client_ids):
    """The caller's instance supplies a stateful algorithm's round inputs
    (the memoized engine may be bound to another, equal-keyed instance).
    Returns (ids, engine-call keywords); ids is None when stateless."""
    if algorithm is None or not algorithm.stateful:
        return None, {}
    ids = list(client_ids) if client_ids is not None else list(range(n))
    return ids, {"server_ctx": algorithm.ctx_for(params_global),
                 "states": algorithm.stacked_states(params_global, ids)}


def _alg_round_commit(algorithm, ids, out):
    """Unpack a round engine's output, committing a stateful algorithm's
    new context and states to the caller's instance. Returns
    (new_global, losses)."""
    if ids is None:
        return out
    new_global, new_ctx, new_states, losses = out
    algorithm.set_ctx(new_ctx)
    algorithm.store_states(ids, new_states)
    return new_global, losses


def fedavg_round_loop(params_global, client_batches: Sequence,
                      cfg: ModelConfig, fed: FedConfig, step=None, opt=None,
                      mask=None, data_sizes: Sequence[int] | None = None,
                      algorithm=None,
                      client_ids: Sequence[int] | None = None):
    """One round as a per-client, per-iteration loop: each client starts
    from ``params_global`` with a fresh optimizer state and runs up to
    ``fed.local_iters_max`` steps (one host read of the loss each).
    Returns (new_global_params, per_client_losses). A stateful algorithm
    goes through ``algorithms.client_update_loop`` and ``server_reduce``;
    a stateless one keeps the plain step."""
    if algorithm is not None:
        algorithm = algorithms.make_algorithm(algorithm)
        if algorithm.stateful:
            client_lists = [list(itertools.islice(b, fed.local_iters_max))
                            for b in client_batches]
            return _ragged_fallback(params_global, client_lists, cfg, fed,
                                    None, mask, data_sizes, algorithm,
                                    client_ids)
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
                 fed: FedConfig, engine=None, mask=None,
                 data_sizes: Sequence[int] | None = None,
                 donate_params: bool = False, algorithm=None,
                 client_ids: Sequence[int] | None = None):
    """One synchronous round as one batched call.

    ``client_batches``: per-client iterables of batches; each is taken to
    at most H = ``fed.local_iters_max`` batches and all clients run
    together. Returns (new_global_params, per_client_losses), the losses
    as lists of floats (H^k per client) read back once, as the loop
    oracle returns them. Equal counts take the plain round, unequal ones
    the padded masked round; batch shapes that disagree within or across
    clients drop to ``_ragged_fallback``.

    ``engine``: a ``fed_engine.SyncRound``, ``None`` (the memoized
    default), or an ``fleet.EngineSpec`` / its string ("loop" routes to
    ``fedavg_round_loop``; "shard" and "hier" split the round's clients
    over the process group's ranks on the params' device type,
    ``fed_engine.ShardedSyncRound``). ``donate_params`` is the
    reference's keyword; the port never
    writes into ``params_global``. ``algorithm`` / ``client_ids``: see
    the module's docstring.
    """
    if algorithm is not None:
        algorithm = algorithms.make_algorithm(algorithm)
    if engine is not None and not isinstance(engine, fed_engine.SyncRound):
        from repro_torch.core.fleet import EngineSpec
        engine = EngineSpec.from_str(engine).build_sync(
            cfg, fed, algorithm=algorithm,
            device=params_device(params_global))
        if engine is None:                  # EngineSpec.LOOP
            return fedavg_round_loop(params_global, client_batches, cfg,
                                     fed, mask=mask, data_sizes=data_sizes,
                                     algorithm=algorithm,
                                     client_ids=client_ids)
    # materialize up to H batches per client first: iterators may be
    # generators, so raggedness must be detected before anything is lost
    client_lists = [list(itertools.islice(b, fed.local_iters_max))
                    for b in client_batches]
    sigs = {_batch_sig(b) for bl in client_lists for b in bl}
    counts = [len(bl) for bl in client_lists]
    if client_lists and len(sigs) == 1:
        if engine is None:
            engine = fed_engine.make_sync_round(cfg, fed,
                                                algorithm=algorithm)
        if min(counts) == max(counts) > 0:
            # straight to (n_clients, H, ...): one host copy
            stacked = {k: np.stack([[b[k] for b in bl]
                                    for bl in client_lists])
                       for k in client_lists[0][0]}
            ids, alg_kw = _alg_round_io(algorithm, params_global,
                                        len(client_lists), client_ids)
            out = engine(
                params_global, stacked,
                weights=_client_weights(len(client_lists), data_sizes),
                mask=mask, donate=True, donate_params=donate_params,
                **alg_kw)
            new_global, losses = _alg_round_commit(algorithm, ids, out)
            return new_global, losses.cpu().numpy().tolist()
        return _padded_round(params_global, client_lists, cfg, fed, engine,
                             mask, data_sizes, donate_params, algorithm,
                             client_ids)
    return _ragged_fallback(params_global, client_lists, cfg, fed, engine,
                            mask, data_sizes, algorithm, client_ids)


def _batch_sig(b):
    return tuple(sorted((k, np.shape(v), str(np.asarray(v).dtype))
                        for k, v in b.items()))


def _padded_round(params_global, client_lists, cfg, fed, engine, mask,
                  data_sizes, donate_params=False, algorithm=None,
                  client_ids=None):
    """Heterogeneous-H round as one padded masked call: batches written
    straight into one zero-initialized (n_clients, H_max, ...) array per
    key, the true H^k as the mask. Empty clients run zero steps and add
    the unchanged global to the average, as in the loop oracle."""
    ref = next(b for bl in client_lists for b in bl)
    n = len(client_lists)
    H_max = max(fed.local_iters_max, max(len(bl) for bl in client_lists))
    iters = np.asarray([len(bl) for bl in client_lists], np.int32)
    stacked = {}
    for k, v in ref.items():
        out = np.zeros((n, H_max) + np.shape(v), np.asarray(v).dtype)
        for c, bl in enumerate(client_lists):
            for i, b in enumerate(bl):
                out[c, i] = b[k]
        stacked[k] = out
    if engine is None:
        engine = fed_engine.make_sync_round(cfg, fed, algorithm=algorithm)
    ids, alg_kw = _alg_round_io(algorithm, params_global, n, client_ids)
    out = engine(params_global, stacked,
                 weights=_client_weights(n, data_sizes), mask=mask,
                 iters=iters, donate=True, donate_params=donate_params,
                 **alg_kw)
    new_global, losses = _alg_round_commit(algorithm, ids, out)
    losses = losses.cpu().numpy()
    return new_global, [[float(x) for x in row[:h]]
                        for row, h in zip(losses, iters)]


def _ragged_fallback(params_global, client_lists, cfg, fed, engine, mask,
                     data_sizes, algorithm=None, client_ids=None):
    """Per-client runs and the weighted average when no batched call can
    form (batch shapes disagree): stackable clients run on the client
    engine, ragged ones on the per-iteration step loop, empty ones return
    the global model. A stateful algorithm runs every client on the
    algorithm-aware loop oracle and folds with ``server_reduce``."""
    if algorithm is not None and algorithm.stateful:
        ids = list(client_ids) if client_ids is not None \
            else list(range(len(client_lists)))
        if mask is None:
            mask = trainable_mask(params_global, fed.trainable)
        ctx = algorithm.ctx_for(params_global)
        w_news, states, msgs, losses = [], [], [], []
        for k, bl in zip(ids, client_lists):
            w, st, msg, ls = algorithms.client_update_loop(
                params_global, bl, cfg, fed, algorithm, client_id=k,
                mask=mask, server_ctx=ctx)
            w_news.append(w)
            states.append(st)
            msgs.append(msg)
            losses.append(ls)
        new_global, _ = algorithms.server_reduce(
            algorithm, params_global, w_news, states, msgs,
            _client_weights(len(ids), data_sizes), server_ctx=ctx)
        return new_global, losses
    # the round engine's client (and its graphs) when one was given
    run = engine.client if engine is not None \
        else fed_engine.make_client_run(cfg, fed)
    if mask is None:
        mask = trainable_mask(params_global, fed.trainable)
    results, losses = [], []
    for bl in client_lists:
        if not bl:                          # client out of data
            results.append(params_global)
            losses.append([])
            continue
        try:
            s = stack_batches(bl)
        except ValueError:                  # ragged shapes within client
            s = None
        if s is None:
            step, opt = cached_client_step(cfg, fed)
            params = params_global
            opt_state = opt.init(params)
            cl = []
            for batch in bl:
                params, opt_state, loss = step(params, opt_state,
                                               params_global, batch, mask)
                cl.append(float(loss))
            results.append(params)
            losses.append(cl)
        else:
            w_new, ls = run(params_global, s, mask=mask)
            results.append(w_new)
            losses.append(ls.cpu().numpy().tolist())
    return (weighted_average(results,
                             _client_weights(len(results), data_sizes)),
            losses)

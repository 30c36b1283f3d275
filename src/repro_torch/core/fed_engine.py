"""Batched client engines for the federated hot path (port of
``repro/core/fed_engine.py``).

The per-iteration loop (``fedasync.client_update`` /
``fedavg.fedavg_round_loop``) launches one step's kernels from the host
and reads its loss back at every local iteration. These engines run a
client's H local proximal-SGD iterations as one call (``ClientRun``), a
burst of clients as one call (``ClientRun.run_batch``) and a whole sync
round with its weighted average as one call (``SyncRound``). On the card
each call is captured once into a CUDA graph per round shape and
replayed after that (``compile_cache.GraphCache``): no host launch and no
host read inside a round, the counterpart of the reference's
``lax.scan`` / ``vmap`` programs. On the CPU the same functions run
eagerly.

Heterogeneous fleets (each device k has its own H^k ∈ [H_min, H_max])
batch through the *padded* path: every client's batch stack is
zero-padded to a common H_max (``pad_client_batches``) and a per-client
iteration count masks the steps: steps with index ≥ H^k leave (params,
optimizer state) unchanged and emit NaN losses. H^k is a device tensor,
an input of the graph, so one graph per round shape ``(n_clients, H_max,
batch...)`` covers every H^k draw.

The clients of a batch run one after another with plain autograd inside
the one call. ``torch.func.vmap`` over them (grouped convolutions for
ResNet3D) replays a 4-client round 1.45x faster on the H100, but its first
call in a process loads ``torch._dynamo``, seconds that hundreds of
rounds do not win back (PERF.md §6), and the LM losses checkpoint their
activations, which ``torch.func.grad`` refuses.

``donate`` keywords are kept so that call sites read as the reference's;
the engines never write into a caller's tensors either way (the batch
stacks are copied into the graph's inputs, the params are read).

What a step, a client's close and the round's fold compute is the
algorithm's (``core/algorithms.py``): ``algorithm=None`` is ``FedProx``,
the paper's proximal local SGD, whose calls return ``(w_new, losses)``
exactly as before the layer. A stateful algorithm (``Scaffold``,
``LowRankSubmodel``) threads a per-client state through the steps and
returns ``(w_new, new_state, msg, losses)`` from a client call and
``(new_global, new_server_ctx, new_states, losses)`` from a round; its
states and server context are graph inputs, so one graph per round shape
serves every client and round. ``ShardedSyncRound`` splits the padded
round's client axis over the ranks of a ``DeviceMesh``
(``make_sharded_sync_round``; ``make_hierarchical_sync_round`` on the
two-level edge / clients mesh) and reduces with ``torch.distributed``
collectives. The loop stays as the parity oracle.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from repro_torch import trees
from repro_torch.core import algorithms
from repro_torch.core.compile_cache import GraphCache
from repro_torch.device import batch_to, params_device
from repro_torch.models import registry
from repro_torch.optim import sgd, trainable_mask, value_and_grad
from repro_torch.types import FedConfig, ModelConfig


def _leaves(stack: dict) -> list:
    """A batch stack's arrays in key order (the reference's leaf order)."""
    return [np.asarray(stack[k]) for k in sorted(stack)]


def stack_shapes(stack: dict) -> tuple:
    """A batch stack's keys with each leaf's per-batch shape and dtype:
    stacks that agree on it pad into one client batch."""
    return tuple((k, np.shape(stack[k])[1:], np.asarray(stack[k]).dtype.str)
                 for k in sorted(stack))


def stack_client_batches(client_batch_stacks: Sequence[dict]) -> dict:
    """Stack per-client batch stacks (each leaf (H, ...)) into one dict
    with a leading client axis (n_clients, H, ...).

    All clients must share H and the batch shapes; raises ValueError
    otherwise: heterogeneous fleets batch through ``pad_client_batches``.
    """
    if not client_batch_stacks:
        raise ValueError("no client batch stacks")
    shapes = [tuple(l.shape for l in _leaves(s)) for s in client_batch_stacks]
    if any(s != shapes[0] for s in shapes[1:]):
        raise ValueError(
            f"heterogeneous client batch stacks {shapes}; use "
            "pad_client_batches to pad per-client H to a common H_max and "
            "run the padded masked-scan round (one batched call)")
    return {k: np.stack([np.asarray(s[k]) for s in client_batch_stacks])
            for k in client_batch_stacks[0]}


def pad_client_batches(client_batch_stacks: Sequence, H_max: int | None
                       = None):
    """Pad per-client batch stacks (each leaf (H^k, ...)) to a common H_max
    and stack to (n_clients, H_max, ...).

    Returns ``(stacked, iters)``: ``iters`` is the int32 array of the true
    H^k, the scan mask. Padding is zeros, which the mask discards. Clients
    may be empty (``None`` or zero-length stacks) as long as one client
    has a batch to take shapes from. Keys, trailing shapes and dtypes must
    agree across clients; raises ValueError otherwise.
    """
    if not client_batch_stacks:
        raise ValueError("no client batch stacks")
    lens = [0 if not s else int(_leaves(s)[0].shape[0])
            for s in client_batch_stacks]
    ref = next((s for s, h in zip(client_batch_stacks, lens) if h), None)
    if ref is None:
        raise ValueError("all clients empty; nothing to pad from")
    if H_max is None:
        H_max = max(lens)
    if max(lens) > H_max:
        raise ValueError(f"client iteration counts {lens} exceed "
                         f"H_max={H_max}")
    keys = sorted(ref)
    trailing = [(l.shape[1:], l.dtype) for l in _leaves(ref)]
    out = {k: np.zeros((len(lens), H_max) + shp, dt)
           for k, (shp, dt) in zip(keys, trailing)}
    for c, (s, h) in enumerate(zip(client_batch_stacks, lens)):
        if h == 0:
            continue
        if sorted(s) != keys:
            raise ValueError(
                "client batch stacks disagree on their keys; matching leaf "
                "shapes cannot substitute for matching keys")
        flat = _leaves(s)
        if [(l.shape[1:], l.dtype) for l in flat] != trailing:
            raise ValueError(
                "client batch stacks disagree on per-batch shapes/dtypes; "
                "padding only evens out iteration counts — use the "
                "per-client fallback for truly ragged batches")
        for k, l in zip(keys, flat):
            out[k][c, :h] = l
    return out, np.asarray(lens, np.int32)


def _batch_len(stacked: dict) -> int:
    return int(stacked[sorted(stacked)[0]].shape[0])


def _full_iters(stacked_clients: dict) -> np.ndarray:
    """(n,) iteration vector for 'every client runs the whole stack'."""
    n, H = stacked_clients[sorted(stacked_clients)[0]].shape[:2]
    return np.full((int(n),), int(H), np.int32)


def _pad_H(fed: FedConfig, client_stacks) -> int:
    """Pad target: the config's H_max, stretched if a caller handed in a
    longer stack, so the padded graph's shape stays the same whatever H^k
    is drawn."""
    return max(fed.local_iters_max,
               max((_batch_len(s) for s in client_stacks if s), default=0))


# ---------------------------------------------------------------------------
# The local runs
# ---------------------------------------------------------------------------

def _where(active, new, old):
    """``new`` where ``active`` (a 0-d bool tensor), else ``old``, over
    the carry's dicts and tuples: every tensor leaf, a scheduled rate's
    step count among them, keeps its old value on a masked step. Other
    leaves (a constant rate's host-int step, which no graph reads) come
    from ``new``, and a subtree the step passed through unchanged (an
    algorithm's state) as it is."""
    if new is old:
        return new
    if isinstance(new, dict):
        return {k: _where(active, new[k], old[k]) for k in new}
    if isinstance(new, (list, tuple)):
        return type(new)(_where(active, a, b) for a, b in zip(new, old))
    if isinstance(new, torch.Tensor):
        return torch.where(active, new, old)
    return new


class ClientRun:
    """A client's H local steps in one call.

    ``engine(params_global, stacked, mask=None)`` -> ``(w_new, losses)``
    where ``stacked`` is a batch dict with leading axis H
    (``data.stack_batches``) and ``losses`` is an (H,) tensor: the only
    host read a caller pays is reading it. One graph per H.

    ``run_batch(params_global, client_stacks, iters)`` is the padded
    batched variant: many clients with different H^k in one call,
    returning ``(w_news, losses)`` with leading client axes (no
    aggregation: the async simulator runs every dispatch through it,
    padded to ``fed.local_iters_max``; ``SyncRound`` adds the weighted
    average). One graph per (m, H_max) burst shape.

    A stateful algorithm's calls take ``server_ctx`` and the client
    state(s) from the caller's instance, and return ``(w_new, new_state,
    msg, losses)``, stacked on the client axis from ``run_batch``.
    """

    def __init__(self, cfg: ModelConfig, fed: FedConfig, loss_kwargs=None,
                 algorithm=None):
        self.cfg = cfg
        self.fed = fed
        self.loss_kwargs = dict(loss_kwargs or {})
        self.algorithm = (algorithm if algorithm is not None
                          else algorithms.FedProx())
        self.opt = sgd(fed.lr, fed.momentum, fed.weight_decay)
        self._graphs = GraphCache()

    def _task_loss(self, params, batch):
        return registry.loss_fn(params, self.cfg, batch,
                                **self.loss_kwargs)[0]

    def _ctx(self, anchor, mask, server_ctx=()) -> algorithms.StepCtx:
        def vg(p, b):
            return value_and_grad(lambda q: self._task_loss(q, b), p)
        return algorithms.StepCtx(vg, self.opt, anchor, mask, server_ctx,
                                  self.fed)

    def _scan(self, ctx, params_global, stacked, n_iters=None, state=()):
        """H steps of ``self.algorithm`` over ``stacked`` from
        ``params_global`` with a fresh optimizer state (a scheduled
        rate's step made here, a tensor inside the call); with ``n_iters``
        (a 0-d int tensor) the steps from index ``n_iters`` on leave the
        carry unchanged and emit NaN. Returns (w, state, losses)."""
        stacked = batch_to(stacked, params_device(params_global))
        carry = (params_global, self.opt.init(params_global), state)
        losses = []
        for i in range(_batch_len(stacked)):
            new, loss = self.algorithm.client_step(ctx, carry,
                                                   trees.index(stacked, i))
            if n_iters is not None:
                active = i < n_iters
                new = _where(active, new, carry)
                loss = torch.where(active, loss, math.nan)
            carry = new
            losses.append(loss)
        return carry[0], carry[2], torch.stack(losses)

    def _run(self, params_global, stacked, mask, server_ctx=(), state=()):
        w_new, state_f, losses = self._scan(
            self._ctx(params_global, mask, server_ctx), params_global,
            stacked, state=state)
        if not self.algorithm.stateful:
            return w_new, losses
        n = torch.full((), len(losses), dtype=torch.int32,
                       device=losses.device)
        w_new, new_state, msg = self.algorithm.client_finalize(
            w_new, params_global, state_f, n, server_ctx, self.fed)
        return w_new, new_state, msg, losses

    def _clients(self, params_global, stacked_clients, mask, iters=None,
                 server_ctx=(), states=()):
        """Every client's run from the same anchor, one after another:
        (w_news, losses) with a leading client axis, and for a stateful
        algorithm (w_news, new_states, msgs, losses). ``iters`` (an (n,)
        int tensor) masks each client's steps."""
        alg = self.algorithm
        device = params_device(params_global)
        stacked_clients = batch_to(stacked_clients, device)
        n = _batch_len(stacked_clients)
        if iters is not None:
            iters = torch.as_tensor(iters, device=device)
        ctx = self._ctx(params_global, mask, server_ctx)
        outs = []
        for c in range(n):
            n_c = None if iters is None else iters[c]
            if not alg.stateful:
                w, _, losses = self._scan(ctx, params_global,
                                          trees.index(stacked_clients, c), n_c)
                outs.append((w, losses))
                continue
            w, state_f, losses = self._scan(
                ctx, params_global, trees.index(stacked_clients, c), n_c,
                trees.index(states, c))
            if n_c is None:
                n_c = torch.full((), len(losses), dtype=torch.int32,
                                 device=device)
            outs.append((*alg.client_finalize(w, params_global, state_f, n_c,
                                              server_ctx, self.fed),
                         losses))
        return tuple(trees.stack(list(col)) for col in zip(*outs))

    def _alg_inputs(self, server_ctx, state_or_states):
        """The (server_ctx, state) pair of a call: ``()`` for a stateless
        algorithm. A stateful one's come from the caller's instance
        (``ctx_for``, ``state_for`` / ``stacked_states``): the memoized
        engine may be shared with other equal-keyed instances, so it
        holds no state of its own and raises when they are missing."""
        if not self.algorithm.stateful:
            return (), ()
        if server_ctx is None or state_or_states is None:
            raise ValueError(
                f"{self.algorithm.name}: a stateful algorithm's engine "
                "calls take server_ctx and the client state(s) from the "
                "caller's instance")
        return server_ctx, state_or_states

    @property
    def num_compiled(self) -> int:
        """Distinct round shapes run: one per H on the unpadded path, one
        per (n_clients, H_max) on the padded one, whatever the H^k."""
        return self._graphs.num_compiled

    def __call__(self, params_global, stacked, mask=None, donate=False,
                 server_ctx=None, state=None):
        """Stateful algorithms take ``server_ctx`` and ``state`` and
        return ``(w_new, new_state, msg, losses)``."""
        if mask is None:
            mask = trainable_mask(params_global, self.fed.trainable)
        server_ctx, state = self._alg_inputs(server_ctx, state)
        return self._graphs.call("run", self._run,
                                 (params_global, stacked, mask, server_ctx,
                                  state))

    def run_batch(self, params_global, client_stacks, iters=None, mask=None,
                  donate=None, server_ctx=None, states=None):
        """``client_stacks``: a sequence of per-client batch stacks
        (padded here by ``pad_client_batches``) or a client-stacked dict
        with (n_clients, H_max, ...) leaves plus ``iters``. Returns
        ``(w_news, losses)`` with leading client axes; loss rows are NaN
        beyond each client's H^k. A stateful algorithm also takes
        ``server_ctx`` and the per-client ``states`` stacked on the client
        axis, and returns ``(w_news, new_states, msgs, losses)``."""
        if isinstance(client_stacks, (list, tuple)):
            client_stacks, lens = pad_client_batches(
                client_stacks, H_max=_pad_H(self.fed, client_stacks))
            if iters is None:
                iters = lens
        if iters is None:
            iters = _full_iters(client_stacks)
        if mask is None:
            mask = trainable_mask(params_global, self.fed.trainable)
        server_ctx, states = self._alg_inputs(server_ctx, states)
        return self._graphs.call(
            "batch", self._clients,
            (params_global, client_stacks, mask,
             np.asarray(iters, np.int32), server_ctx, states))

    def unstack(self, stacked, n: int) -> tuple:
        """Split a client-stacked tree (leaves (n, ...)) into n per-client
        trees of views: no copy and no launch (the engine's outputs are
        already out of the graph's memory)."""
        return tuple(trees.index(stacked, j) for j in range(n))


_ENGINE_CACHE: dict = {}
_ENGINE_CACHE_MAX = 32      # FIFO-bounded: engines hold captured graphs


def _engine_key(kind, cfg: ModelConfig, fed: FedConfig, loss_kwargs,
                algorithm=None):
    """Cache key over the fields that shape the client program. Server-
    side knobs (mixing_beta, staleness_a, ...) do not: two sweeps that
    differ only there share engines. The algorithm enters through
    ``cache_key()``: every FedProx caller shares one engine, every
    Scaffold instance another (their per-client state lives on the
    caller's instance and enters through the calls' arguments)."""
    lk = tuple(sorted((loss_kwargs or {}).items()))
    ak = (algorithm.cache_key() if algorithm is not None
          else algorithms.FedProx().cache_key())
    key = (kind, cfg, fed.lr, fed.momentum, fed.weight_decay,
           fed.prox_theta, fed.trainable, lk, ak)
    try:
        hash(key)
    except TypeError:
        return None
    return key


def cached_engine(key, build):
    """FIFO-bounded engine memo shared across subsystems (the fed engines
    through ``_engine_key``; ``core.distill`` brings its own keys).
    ``key=None`` or an unhashable key builds afresh."""
    if key is not None:
        try:
            hash(key)
        except TypeError:
            key = None
    if key is None:
        return build()
    if key not in _ENGINE_CACHE:
        while len(_ENGINE_CACHE) >= _ENGINE_CACHE_MAX:
            _ENGINE_CACHE.pop(next(iter(_ENGINE_CACHE)))
        _ENGINE_CACHE[key] = build()
    return _ENGINE_CACHE[key]


def _algorithm(algorithm):
    return (None if algorithm is None
            else algorithms.make_algorithm(algorithm))


def make_client_run(cfg: ModelConfig, fed: FedConfig, loss_kwargs=None,
                    algorithm=None) -> ClientRun:
    """The engine replacing the per-iteration step loop, memoized on the
    client-relevant config fields and the algorithm's ``cache_key`` so
    repeated runs reuse their graphs. A stateful algorithm's calls take
    ``server_ctx`` and the states from the caller's instance: the
    memoized engine may be bound to another equal-keyed instance."""
    algorithm = _algorithm(algorithm)
    return cached_engine(
        _engine_key("client", cfg, fed, loss_kwargs, algorithm),
        lambda: ClientRun(cfg, fed, loss_kwargs, algorithm=algorithm))


def _weighted_params(w_news: dict, weights, params_global: dict) -> dict:
    """einsum over the client axis, accumulated in f32, cast back."""
    return {k: torch.einsum("c,c...->...", weights,
                            w_news[k].float()).to(p.dtype)
            for k, p in params_global.items()}


class SyncRound:
    """A FedAvg round in one call: every client's local run, then the
    weighted average.

    ``round(params_global, client_stacks, weights, mask=None, iters=None)``
    -> ``(new_global, losses (n_clients, H))``. ``client_stacks`` is a
    sequence of per-client batch stacks (stacked, or padded when their
    H^k differ) or a client-stacked dict with leading (n_clients, H)
    axes. With ``iters`` the padded masked round runs: NaN losses past
    each client's budget, one graph per round shape whatever the H^k.

    With a stateful algorithm the round is the client half, the
    algorithm's ``reduce_prepare``, the weighted fold, the weighted sum
    of the clients' msgs and ``reduce_finish``, all in the one call (or
    two calls around an eager prepare that a capture refuses,
    ``_split_round``), and it returns ``(new_global, new_server_ctx,
    new_states, losses)``.
    """

    def __init__(self, cfg: ModelConfig, fed: FedConfig, loss_kwargs=None,
                 algorithm=None):
        # the memoized ClientRun: async dispatches and the sync round's
        # clients share one step
        self.client = make_client_run(cfg, fed, loss_kwargs,
                                      algorithm=algorithm)
        self.algorithm = self.client.algorithm
        self.fed = fed
        self._graphs = GraphCache()

    def _fold(self, w_eff, params_global, weights, msgs, server_ctx):
        """A stateful round's fold: the weighted average, the weighted sum
        of the msgs and ``reduce_finish``: (new_global, new_ctx)."""
        weights = torch.as_tensor(weights,
                                  device=params_device(params_global))
        with torch.no_grad():
            avg = _weighted_params(w_eff, weights, params_global)
            msg_sum = algorithms.weighted_state_sum(msgs, weights)
            return self.algorithm.reduce_finish(avg, msg_sum, server_ctx,
                                                params_global)

    def _reduce(self, out, params_global, weights, server_ctx):
        """The round's server half: prepare, weighted fold, finish."""
        alg = self.algorithm
        if not alg.stateful:
            w_news, losses = out
            weights = torch.as_tensor(weights,
                                      device=params_device(params_global))
            return _weighted_params(w_news, weights, params_global), losses
        w_news, new_states, msgs, losses = out
        with torch.no_grad():
            w_eff = alg.reduce_prepare(w_news, params_global, new_states,
                                       server_ctx)
        new_global, new_ctx = self._fold(w_eff, params_global, weights,
                                         msgs, server_ctx)
        return new_global, new_ctx, new_states, losses

    def _rnd(self, params_global, stacked_clients, weights, mask,
             server_ctx=(), states=()):
        out = self.client._clients(params_global, stacked_clients, mask,
                                   None, server_ctx, states)
        return self._reduce(out, params_global, weights, server_ctx)

    def _rnd_padded(self, params_global, stacked_clients, weights, iters,
                    mask, server_ctx=(), states=()):
        out = self.client._clients(params_global, stacked_clients, mask,
                                   iters, server_ctx, states)
        return self._reduce(out, params_global, weights, server_ctx)

    @property
    def num_compiled(self) -> int:
        """Distinct round shapes run: one per (n_clients, H)."""
        return self._graphs.num_compiled

    def _prep(self, params_global, client_stacks, weights, mask, iters):
        if isinstance(client_stacks, (list, tuple)):
            try:
                client_stacks = stack_client_batches(client_stacks)
            except ValueError:
                client_stacks, lens = pad_client_batches(
                    client_stacks, H_max=_pad_H(self.fed, client_stacks))
                if iters is None:   # caller-supplied H^k wins over lens
                    iters = lens
        n = _batch_len(client_stacks)
        if weights is None:
            weights = np.full((n,), 1.0 / n, np.float32)
        else:
            weights = np.asarray(weights, np.float32)
        if mask is None:
            mask = trainable_mask(params_global, self.fed.trainable)
        return client_stacks, weights, mask, iters

    def __call__(self, params_global, client_stacks, weights=None,
                 mask=None, iters=None, donate=None,
                 donate_params: bool = False, server_ctx=None, states=None):
        client_stacks, weights, mask, iters = self._prep(
            params_global, client_stacks, weights, mask, iters)
        server_ctx, states = self.client._alg_inputs(server_ctx, states)
        if self.algorithm.stateful and not self.algorithm.prepare_in_graph:
            return self._split_round(params_global, client_stacks, weights,
                                     mask, iters, server_ctx, states)
        if iters is None:
            return self._graphs.call(
                "rnd", self._rnd,
                (params_global, client_stacks, weights, mask, server_ctx,
                 states))
        return self._graphs.call(
            "pad", self._rnd_padded,
            (params_global, client_stacks, weights,
             np.asarray(iters, np.int32), mask, server_ctx, states))


    def client_half(self, params_global, stacked_clients, mask, iters,
                    server_ctx, states):
        """A split round's first call (one graph per round shape): every
        client's run, ``(w_news, new_states, msgs, losses)``."""
        return self._graphs.call(
            "clients", self.client._clients,
            (params_global, stacked_clients, mask,
             None if iters is None else np.asarray(iters, np.int32),
             server_ctx, states))

    def fold(self, w_eff, params_global, weights, msgs, server_ctx):
        """A split round's last call (one graph per round shape)."""
        return self._graphs.call(
            "fold", self._fold, (w_eff, params_global, weights, msgs,
                                 server_ctx))

    def _split_round(self, params_global, stacked_clients, weights, mask,
                     iters, server_ctx, states):
        """The round of an algorithm whose ``reduce_prepare`` cannot be
        captured (``LowRankSubmodel``: ``torch.linalg.svd`` on the card
        reads cuSOLVER's status back to the host): the client half and the
        fold are a graph each, and the prepare runs eagerly between them,
        on the params' device."""
        w_news, new_states, msgs, losses = self.client_half(
            params_global, stacked_clients, mask, iters, server_ctx, states)
        with torch.no_grad():
            w_eff = self.algorithm.reduce_prepare(w_news, params_global,
                                                  new_states, server_ctx)
        new_global, new_ctx = self.fold(w_eff, params_global, weights, msgs,
                                        server_ctx)
        return new_global, new_ctx, new_states, losses


def make_sync_round(cfg: ModelConfig, fed: FedConfig, loss_kwargs=None,
                    algorithm=None) -> SyncRound:
    """The round engine replacing fedavg's per-client loop, memoized like
    ``make_client_run``."""
    algorithm = _algorithm(algorithm)
    return cached_engine(
        _engine_key("sync", cfg, fed, loss_kwargs, algorithm),
        lambda: SyncRound(cfg, fed, loss_kwargs, algorithm=algorithm))


class ShardedSyncRound(SyncRound):
    """The padded sync round with its client axis split over the ranks of
    a ``DeviceMesh`` (``launch.mesh.make_fleet_mesh``; the split in
    ``sharding.specs.fed_round_specs``), the reference's ``shard_map``
    round.

    Each rank runs its block of the clients (``sharding.shard_index``:
    block e·C + c on the ``("edge", "clients")`` mesh) through the
    client engine, forms its weight-scaled f32 partial of the new global
    and all-reduces it level by level, innermost first: on a 1-D mesh one
    ``all_reduce``; on the two-level mesh the *hierarchical
    edge-aggregator tree*, clients to their edge aggregator, then edges
    to the server. Every weight-scaled client model is added exactly once
    either way, so the nested sum is the flat weighted average,
    Σ_e Σ_{k∈e} w_k·θ_k = Σ_k w_k·θ_k: bit for bit in a world of one,
    within a few ulps of the summation order under real sharding. The
    partials are one f32 buffer, so a level costs one collective. When n
    clients do not divide over the shards, zero-weight, zero-iteration
    dummies pad the axis and their losses and states are sliced off. As
    in ``SyncRound``, a round whose clients all run their whole stack and
    need no dummies runs unmasked, a ragged or padded one masked: two
    round shapes.

    Every rank returns what the reference's ``out_specs`` give: the
    replicated new global (and server context) and the full (n, H) losses
    and n new states, gathered over the mesh (``gather_levels``). A
    stateful algorithm's ``reduce_prepare`` runs on the rank's own
    clients (it is elementwise on the client axis), then the nested sums
    of the partial and of the msgs' weighted sum, then ``reduce_finish``.

    On the card a round shape is one CUDA graph a rank (``GraphCache``)
    with its collectives inside: NCCL records them on the capture stream,
    and the shape's first, eager call has made the communicator the
    capture needs. The mesh's CUDA backend must be NCCL (``init_world``
    checks it). LowRank keeps its split round (``_split_round``): the
    client half, the eager SVD, then the fold with the collectives. On
    the CPU (gloo) the round runs eagerly, as every CPU round does.
    """

    def __init__(self, cfg: ModelConfig, fed: FedConfig, mesh,
                 loss_kwargs=None, algorithm=None):
        from repro_torch import sharding
        super().__init__(cfg, fed, loss_kwargs, algorithm=algorithm)
        self.mesh = mesh
        self._shard, self._n_shards = sharding.shard_index(mesh)

    def _finish(self, w_eff, params_global, weights, msgs, server_ctx,
                new_states, losses):
        """The shard's server half: its weight-scaled f32 partials (of the
        params and the msgs), the level-by-level sums, the cast back,
        ``reduce_finish``, and the per-client outputs gathered."""
        from repro_torch import sharding
        weights = torch.as_tensor(weights,
                                  device=params_device(params_global))
        with torch.no_grad():
            partial = {k: torch.einsum("c,c...->...", weights,
                                       w_eff[k].float())
                       for k in params_global}
            if self.algorithm.stateful:
                msgs = algorithms.weighted_state_sum(msgs, weights)
            partial, msg_sum = sharding.psum_levels((partial, msgs),
                                                    self.mesh)
            avg = {k: partial[k].to(p.dtype)
                   for k, p in params_global.items()}
            new_states, losses = sharding.gather_levels((new_states, losses),
                                                        self.mesh)
            if not self.algorithm.stateful:
                return avg, losses
            new_global, new_ctx = self.algorithm.reduce_finish(
                avg, msg_sum, server_ctx, params_global)
            return new_global, new_ctx, new_states, losses

    def _shard_round(self, params_global, stacked, weights, iters, mask,
                     server_ctx=(), states=()):
        out = self.client._clients(params_global, stacked, mask, iters,
                                   server_ctx, states)
        if not self.algorithm.stateful:
            w_news, losses = out
            return self._finish(w_news, params_global, weights, (), (), (),
                                losses)
        w_news, new_states, msgs, losses = out
        with torch.no_grad():
            w_eff = self.algorithm.reduce_prepare(w_news, params_global,
                                                  new_states, server_ctx)
        return self._finish(w_eff, params_global, weights, msgs, server_ctx,
                            new_states, losses)

    def _split_round(self, params_global, stacked, weights, mask, iters,
                     server_ctx, states):
        w_news, new_states, msgs, losses = self.client_half(
            params_global, stacked, mask, iters, server_ctx, states)
        with torch.no_grad():
            w_eff = self.algorithm.reduce_prepare(w_news, params_global,
                                                  new_states, server_ctx)
        return self._graphs.call(
            "fold", self._finish, (w_eff, params_global, weights, msgs,
                                   server_ctx, new_states, losses))

    def __call__(self, params_global, client_stacks, weights=None,
                 mask=None, iters=None, donate=None,
                 donate_params: bool = False, server_ctx=None, states=None):
        if params_device(params_global).type != self.mesh.device_type:
            raise ValueError(
                f"params on {params_device(params_global)}, mesh on "
                f"{self.mesh.device_type}")
        client_stacks, weights, mask, iters = self._prep(
            params_global, client_stacks, weights, mask, iters)
        server_ctx, states = self.client._alg_inputs(server_ctx, states)
        n = _batch_len(client_stacks)
        pad = (-n) % self._n_shards
        if pad:                  # zero-weight dummies round the axis up
            if iters is None:    # the real clients run their whole stack
                iters = _full_iters(client_stacks)
            client_stacks = {k: np.concatenate(
                [np.asarray(v)] + [np.asarray(v)[:1]] * pad)
                for k, v in client_stacks.items()}
            weights = np.concatenate([weights, np.zeros(pad, np.float32)])
            iters = np.concatenate([np.asarray(iters, np.int32),
                                    np.zeros(pad, np.int32)])
            states = trees.tree_map(lambda l: torch.cat([l] + [l[:1]] * pad),
                                    states)
        b = (n + pad) // self._n_shards
        rows = slice(self._shard * b, (self._shard + 1) * b)
        stacked = {k: np.asarray(v)[rows] for k, v in client_stacks.items()}
        states = trees.tree_map(lambda l: l[rows], states)
        if iters is not None:
            iters = np.asarray(iters, np.int32)[rows]
        if self.algorithm.stateful and not self.algorithm.prepare_in_graph:
            out = self._split_round(params_global, stacked, weights[rows],
                                    mask, iters, server_ctx, states)
        else:
            out = self._graphs.call(
                "shard", self._shard_round,
                (params_global, stacked, weights[rows], iters, mask,
                 server_ctx, states))
        if not self.algorithm.stateful:
            new, losses = out
            return new, losses[:n]
        new, new_ctx, new_states, losses = out
        return (new, new_ctx, trees.tree_map(lambda l: l[:n], new_states),
                losses[:n])


def _sharded_engine(kind: str, cfg, fed, mesh, loss_kwargs, algorithm):
    algorithm = _algorithm(algorithm)
    return cached_engine(
        _engine_key((kind, mesh), cfg, fed, loss_kwargs, algorithm),
        lambda: ShardedSyncRound(cfg, fed, mesh, loss_kwargs,
                                 algorithm=algorithm))


def drop_sharded_engines() -> None:
    """Forget the memoized sharded and hierarchical rounds (their meshes'
    process group is going away)."""
    for key in [k for k in _ENGINE_CACHE
                if isinstance(k[0], tuple) and k[0][0] in ("shard", "hier")]:
        del _ENGINE_CACHE[key]


def make_sharded_sync_round(cfg: ModelConfig, fed: FedConfig, mesh=None,
                            loss_kwargs=None, algorithm=None,
                            device=None) -> ShardedSyncRound:
    """Sync-round engine whose client axis is split over ``mesh``
    (default: every rank of the process group as a 1-D ``("clients",)``
    mesh on ``device``, ``launch.mesh.make_fleet_mesh``). Memoized like
    ``make_sync_round`` with the mesh in the key."""
    if mesh is None:
        from repro_torch.launch.mesh import make_fleet_mesh
        mesh = make_fleet_mesh(device=device)
    return _sharded_engine("shard", cfg, fed, mesh, loss_kwargs, algorithm)


def make_hierarchical_sync_round(cfg: ModelConfig, fed: FedConfig,
                                 mesh=None, edges: int | None = None,
                                 loss_kwargs=None, algorithm=None,
                                 device=None) -> ShardedSyncRound:
    """Sync-round engine over a two-level ``("edge", "clients")`` mesh:
    the hierarchical edge-aggregator tree (clients → edge aggregators →
    server as nested all-reduces, the flat weighted average; see
    ``ShardedSyncRound``). Default mesh: the process group's ranks
    factored by ``make_fleet_mesh(edges=...)`` (a world of one runs the
    same program on the (1, 1) tree). Memoized like
    ``make_sharded_sync_round``; a mesh without both axes raises
    ``ValueError``."""
    if mesh is None:
        from repro_torch.launch.mesh import make_fleet_mesh
        mesh = make_fleet_mesh(edges=edges if edges is not None else 0,
                               device=device)
    if not {"edge", "clients"} <= set(mesh.mesh_dim_names or ()):
        raise ValueError(
            f"hierarchical round needs a ('edge', 'clients') mesh, got "
            f"axes {mesh.mesh_dim_names}")
    return _sharded_engine("hier", cfg, fed, mesh, loss_kwargs, algorithm)

"""Pluggable federated-algorithm layer (port of ``repro/core/algorithms.py``).

``core/fed_engine.py`` runs *execution*: a client's H steps, a burst of
clients, a sync round, each one call (one CUDA graph per round shape on
the card). What those calls compute is the *algorithm*, four pieces owned
by ``FedAlgorithm``:

``client_init`` / ``client_step`` / ``client_finalize``
    Per-client state entering a local run (SCAFFOLD's control variate, a
    submodel mask), one local step over the carry ``(params, opt_state,
    state)`` given a ``StepCtx``, and the close of a run: ``(w_new,
    new_state, msg)``, ``msg`` being the server-bound side channel
    (SCAFFOLD's variate delta, the low-rank client's capacity; ``()`` for
    stateless algorithms).

``reduce_prepare`` / ``reduce_finish`` / ``mix``
    The server: a per-client transform over the stacked client axis
    before the round's weighted fold (the low-rank reconstruction), the
    fold of the weighted msg sum into the server context after it, and
    Algorithm 1's staleness-weighted receive for the async path.

``encode`` / ``decode``
    The wire codec (host-side, per dispatch, outside any graph): the
    int8 / int4 delta codec of ``core/compression.py`` generalized to
    algorithm-shaped payloads.

``FedProx()`` is the paper's proximal local SGD and reproduces the
pre-layer engines bit for bit: its state, context and msg are ``()``, and
its hooks are the exact arithmetic the engines ran before.

Graph discipline: the algorithm instance enters an engine's memo key
through ``cache_key()`` only, and everything that varies between clients
or rounds (a variate, the server context, a client's capacity, an
iteration count) is a tensor, an input of the captured graph; so a fleet
of mixed capacities still captures one graph per round shape. Mutable
cross-round persistence (per-client states, the server context) lives on
the caller's instance, host-side, keyed by real client ids; the engines
stay pure and memoizable.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch import trees
from repro_torch.core import compression
from repro_torch.device import batch_to, params_device
from repro_torch.models import registry
from repro_torch.optim import (Optimizer, apply_mask, control_variate_grad,
                               proximal_grad, sgd, trainable_mask,
                               value_and_grad)
from repro_torch.types import FedConfig, ModelConfig

# 2-D leaves at least this wide on both sides carry low-rank factor
# payloads; anything smaller (biases, norms, tiny heads) ships dense.
_MIN_FACTOR_SIDE = 4

# a conv weight is OIDHW in the port and DHWIO in the reference
_OIDHW_TO_DHWIO = (2, 3, 4, 1, 0)
_DHWIO_TO_OIDHW = (4, 3, 0, 1, 2)


class StepCtx(NamedTuple):
    """What the engine hands the algorithm for one local iteration."""
    value_and_grad: Callable      # (params, batch) -> (loss, grads)
    opt: Optimizer
    anchor: dict                  # the round's global model w_t
    mask: dict                    # trainable mask, per leaf
    server_ctx: Any               # algorithm's server context (broadcast)
    fed: FedConfig


class WireUpdate(NamedTuple):
    """One client update as it crosses the wire."""
    algo: str
    payload: Any                  # algorithm-shaped tree(s)
    meta: Any                     # host-side static metadata (ranks, ...)
    base_bytes: int               # dense float payload it replaces
    wire_bytes: int


def _zeros_f32_like(params: dict) -> dict:
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}


def _mix_params(params: dict, w_new: dict, beta_t) -> dict:
    """((1-β)·w + β·w_new) in f32, cast back; ``beta_t`` a 0-d f32 tensor
    (``fedasync._mix_many``'s arithmetic)."""
    return {k: ((1.0 - beta_t) * a.float() + beta_t * w_new[k].float())
            .to(a.dtype) for k, a in params.items()}


@torch.no_grad()
def weighted_state_sum(trees_stacked, weights):
    """Σ_c w_c · tree_c over the leading client axis, in f32 (server-state
    accumulations stay f32; casting params back is the engine's job)."""
    return trees.tree_map(
        lambda l: torch.einsum("c,c...->...", weights, l.float()),
        trees_stacked)


class FedAlgorithm:
    """Base class; also the stateless-algorithm contract.

    ``stateful = False`` means state, context and msg are all ``()`` and
    the engines keep their entry points' outputs ``(w_new, losses)``.
    """

    name = "base"
    stateful = False
    # route every async update through encode/decode even without
    # compress_bits (LowRankSubmodel: the projection happens on the wire)
    wire_always = False
    # a sync round runs reduce_prepare inside its one call; False splits
    # the round around an eager prepare (``fed_engine.SyncRound``)
    prepare_in_graph = True

    def __init__(self):
        self._states: dict = {}       # client id -> state tree
        self._ctx: Any = None         # server context tree
        self._fleet = None

    # -- identity ---------------------------------------------------------
    def cache_key(self):
        """Hashable identity for engine memoization: equal keys MUST mean
        equal behavior of every hook an engine runs."""
        return (type(self).__name__,)

    def __repr__(self):
        return f"{type(self).__name__}()"

    # -- client hooks (run inside the engines' calls) ---------------------
    def server_init(self, params_global):
        """Server-side algorithm context (broadcast to clients)."""
        return ()

    def client_init(self, params_global, client_id: int = 0):
        """Per-client carried state entering a local run."""
        return ()

    def client_step(self, ctx: StepCtx, carry, batch):
        """One local iteration. Carry is ``(params, opt_state, state)``;
        returns ``(carry, loss)``."""
        params, opt_state, state = carry
        loss, grads = ctx.value_and_grad(params, batch)
        grads = self.local_grads(grads, params, ctx.anchor, state,
                                 ctx.server_ctx, ctx.fed)
        grads = apply_mask(grads, ctx.mask)
        params, opt_state = ctx.opt.update(grads, opt_state, params)
        return (params, opt_state, state), loss

    def local_grads(self, grads, params, anchor, state, server_ctx,
                    fed: FedConfig):
        """Gradient transform inside ``client_step``."""
        return proximal_grad(grads, params, anchor, fed.prox_theta)

    def client_finalize(self, w_new, anchor, state, n_iters, server_ctx,
                        fed: FedConfig):
        """Close a local run: ``(w_new, new_state, msg)``. ``n_iters`` is
        the client's true iteration count, an int tensor on the params'
        device."""
        return w_new, state, ()

    # -- server hooks -----------------------------------------------------
    def reduce_prepare(self, w_news, anchor, states, server_ctx):
        """Per-client transform over the stacked client axis, before the
        weighted fold."""
        return w_news

    def reduce_finish(self, avg_params, msg_sum, server_ctx, params_global):
        """Fold the weighted average and the weighted msg sum into
        ``(new_global, new_server_ctx)``."""
        return avg_params, server_ctx

    @torch.no_grad()
    def mix(self, params, server_ctx, w_new, msg, beta_t):
        """One async receive, Algorithm 1's staleness-weighted mix:
        ``(new_params, new_server_ctx)``."""
        return _mix_params(params, w_new, beta_t), server_ctx

    # -- wire codec (host-side) -------------------------------------------
    def encode(self, w_new, msg, anchor, fed: FedConfig) -> WireUpdate:
        """Client -> server payload: the int8 / int4 delta codec when
        ``fed.compress_bits`` is set, dense floats otherwise."""
        base = trees.nbytes(w_new)
        if fed.compress_bits:
            upd = compression.quantize_delta(w_new, anchor,
                                             fed.compress_bits)
            return WireUpdate(self.name, upd, None, base, upd.wire_bytes)
        return WireUpdate(self.name, w_new, None, base, base)

    def decode(self, wire: WireUpdate, anchor, fed: FedConfig):
        """Server-side reconstruction: ``(w_new, msg)``."""
        if isinstance(wire.payload, compression.QuantizedUpdate):
            return compression.dequantize_delta(wire.payload, anchor), ()
        return wire.payload, ()

    # -- host-side persistence (the caller's instance owns this) ----------
    def bind_fleet(self, fleet):
        """Observe the fleet driving this run (LowRankSubmodel derives
        per-client capacity from device speed rank)."""
        self._fleet = fleet

    def state_for(self, k: int, params):
        if not self.stateful:
            return ()
        k = int(k)
        if k not in self._states:
            self._states[k] = self.client_init(params, k)
        return self._states[k]

    def stacked_states(self, params, ids):
        """Per-client states stacked on a leading client axis for the
        batched engines (init on miss, keyed by real client id)."""
        if not self.stateful:
            return ()
        return trees.stack([self.state_for(k, params) for k in ids])

    def store_state(self, k: int, state):
        if self.stateful:
            self._states[int(k)] = state

    def store_states(self, ids, stacked_states):
        """Commit a round's stacked new states back per client id."""
        if not self.stateful:
            return
        for j, k in enumerate(ids):
            self._states[int(k)] = trees.index(stacked_states, j)

    def ctx_for(self, params):
        if not self.stateful:
            return ()
        if self._ctx is None:
            self._ctx = self.server_init(params)
        return self._ctx

    def set_ctx(self, ctx):
        if self.stateful:
            self._ctx = ctx

    def reset(self):
        """Drop all persisted client and server algorithm state."""
        self._states.clear()
        self._ctx = None


class FedProx(FedAlgorithm):
    """The paper's proximal local SGD (§III-D): the engines' behavior
    before the layer, and its parity oracle. Stateless."""

    name = "fedprox"


class Scaffold(FedAlgorithm):
    """SCAFFOLD (Karimireddy et al. 2020), Option II variate update.

    Client k carries a control variate c_k (f32, shaped like params); the
    server carries c. Each local step corrects the proximal gradient by
    ``+ c - c_k``; after H^k steps

        c_k⁺ = c_k − c + (w_t − w_new) / (H^k · lr)
        msg  = Δc = c_k⁺ − c_k

    Sync server: c += Σ_k weight_k · Δc_k. Async server: c += β_t · Δc,
    the staleness damping Algorithm 1 applies to the params. Clients that
    ran zero iterations keep their variate. Requires a float ``fed.lr``.
    """

    name = "scaffold"
    stateful = True

    def server_init(self, params_global):
        return _zeros_f32_like(params_global)

    def client_init(self, params_global, client_id: int = 0):
        return _zeros_f32_like(params_global)

    def local_grads(self, grads, params, anchor, state, server_ctx,
                    fed: FedConfig):
        grads = proximal_grad(grads, params, anchor, fed.prox_theta)
        return control_variate_grad(grads, server_ctx, state)

    @torch.no_grad()
    def client_finalize(self, w_new, anchor, state, n_iters, server_ctx,
                        fed: FedConfig):
        lr = float(fed.lr)        # raises for schedule callables, by design
        n = torch.clamp(n_iters.float(), min=1.0)
        active = n_iters > 0
        c_new = {k: torch.where(
            active, ck - server_ctx[k]
            + (anchor[k].float() - w_new[k].float()) / (n * lr), ck)
            for k, ck in state.items()}
        delta_c = {k: c_new[k] - ck for k, ck in state.items()}
        return w_new, c_new, delta_c

    @torch.no_grad()
    def reduce_finish(self, avg_params, msg_sum, server_ctx, params_global):
        return avg_params, {k: c + msg_sum[k] for k, c in server_ctx.items()}

    @torch.no_grad()
    def mix(self, params, server_ctx, w_new, msg, beta_t):
        return (_mix_params(params, w_new, beta_t),
                {k: c + beta_t * msg[k] for k, c in server_ctx.items()})

    def encode(self, w_new, msg, anchor, fed: FedConfig) -> WireUpdate:
        base = trees.nbytes(w_new) + trees.nbytes(msg)
        if not fed.compress_bits:
            return WireUpdate(self.name, (w_new, msg), None, base, base)
        upd = compression.quantize_delta(w_new, anchor, fed.compress_bits)
        mupd = compression.quantize_delta(msg, _zeros_f32_like(msg),
                                          fed.compress_bits)
        return WireUpdate(self.name, (upd, mupd), None, base,
                          upd.wire_bytes + mupd.wire_bytes)

    def decode(self, wire: WireUpdate, anchor, fed: FedConfig):
        w, m = wire.payload
        if isinstance(w, compression.QuantizedUpdate):
            msg = compression.dequantize_delta(
                m, trees.tree_map(lambda q: torch.zeros(
                    q.shape, dtype=torch.float32, device=q.device), m.q))
            return compression.dequantize_delta(w, anchor), msg
        return w, m


def _is_factor_leaf(a) -> bool:
    shape = tuple(a.shape)
    return len(shape) == 2 and min(shape) >= _MIN_FACTOR_SIDE


def _static_rank(cap: float, r_full: int) -> int:
    # f32 on purpose: agrees with the device-side ceil in reduce_prepare
    # for any capacity a client state can carry
    return int(max(1, min(r_full,
                          math.ceil(float(np.float32(cap)) * r_full))))


class LowRankSubmodel(FedAlgorithm):
    """Capacity-heterogeneous clients: FedHM-style low-rank updates for
    matrix leaves and subMFL-style seeded masks for the rest.

    Client k gets a capacity fraction cap_k ∈ (0, 1]: ``capacity`` scaled
    by the fleet's relative speed (``Fleet.capacity``: fastest device 1.0,
    slowest 0.5) once ``bind_fleet`` has run. Its state is
    ``{"cap": f32 0-d tensor, "mask": 0/1 tensors per leaf}``; the mask is
    drawn from ``default_rng((seed, 0x5EED, k))`` leaf by leaf in the
    reference's order and shape (a conv weight drawn DHWIO, then laid out
    OIDHW), so it equals the reference's bit for bit.

    Training: non-factor leaves' gradients multiply the mask (keep
    probability cap_k); factor leaves train dense, and their *delta* is
    rank-truncated at the server: ``reduce_prepare`` takes each client's
    full SVD and zeroes the singular values from index ceil(cap_k · r)
    on, the rank a tensor, so mixed capacities share one graph.

    Wire: factor leaves ship the truncated SVD factors (U_r, s_r, V_rᵀ),
    quantized when ``fed.compress_bits`` is set; everything else ships
    dense (or quantized). The async path always routes through the codec
    (``wire_always``), so both engines see the same projected updates.
    """

    name = "lowrank"
    stateful = True
    wire_always = True
    # torch.linalg.svd on the card checks cuSOLVER's status from the host,
    # a synchronization that a CUDA graph capture refuses
    prepare_in_graph = False

    def __init__(self, capacity: float = 0.25, min_capacity: float = 0.05,
                 seed: int = 0):
        super().__init__()
        if not 0.0 < capacity <= 1.0:
            raise ValueError(f"capacity must be in (0, 1], got {capacity}")
        self.capacity = float(capacity)
        self.min_capacity = float(min_capacity)
        self.seed = int(seed)
        self._caps: dict = {}

    def cache_key(self):
        # capacity and seed ride in the client state, never the key: every
        # instance shares one engine and one graph per round shape
        return (type(self).__name__,)

    def __repr__(self):
        return (f"LowRankSubmodel(capacity={self.capacity}, "
                f"seed={self.seed})")

    # -- per-client capacity ----------------------------------------------
    def capacity_for(self, k: int) -> float:
        k = int(k)
        if k not in self._caps:
            rel = 1.0
            if self._fleet is not None:
                rel = float(self._fleet.capacity(k))
            self._caps[k] = max(self.min_capacity,
                                min(1.0, self.capacity * rel))
        return self._caps[k]

    def set_capacity(self, k: int, cap: float):
        self._caps[int(k)] = max(self.min_capacity, min(1.0, float(cap)))

    def client_init(self, params_global, client_id: int = 0):
        cap = self.capacity_for(client_id)
        rng = np.random.default_rng((self.seed, 0x5EED, int(client_id)))
        device = params_device(params_global)
        mask = {}
        for k in sorted(params_global):          # the reference's order
            p = params_global[k]
            if _is_factor_leaf(p):
                keep = np.float32(1.0)           # rank-truncated, not masked
            elif p.dim() == 5:
                shape = tuple(p.shape[i] for i in _OIDHW_TO_DHWIO)
                keep = (rng.random(shape) < cap).transpose(_DHWIO_TO_OIDHW)
            else:
                keep = (rng.random(tuple(p.shape)) < cap) | (p.numel() <= 1)
            mask[k] = torch.tensor(np.asarray(keep, np.float32),
                                   device=device)
        return {"cap": torch.tensor(cap, dtype=torch.float32, device=device),
                "mask": {k: mask[k] for k in params_global}}

    def local_grads(self, grads, params, anchor, state, server_ctx,
                    fed: FedConfig):
        grads = proximal_grad(grads, params, anchor, fed.prox_theta)
        return {k: (g * state["mask"][k]).to(g.dtype)
                for k, g in grads.items()}

    def client_finalize(self, w_new, anchor, state, n_iters, server_ctx,
                        fed: FedConfig):
        # the capacity IS the server-bound message: the codec and the
        # server's reconstruction both need cap_k to agree on ranks
        return w_new, state, state["cap"]

    # -- server reduce ----------------------------------------------------
    @torch.no_grad()
    def reduce_prepare(self, w_news, anchor, states, server_ctx):
        """Each client's factor-leaf delta, SVD'd at full rank (the client
        axis is the SVD's batch axis) and truncated at its own rank."""
        caps = states["cap"]                     # (n_clients,)
        out = {}
        for k, w in w_news.items():
            a = anchor[k]
            if not _is_factor_leaf(a):
                out[k] = w
                continue
            d = w.float() - a.float()
            u, s, vt = torch.linalg.svd(d, full_matrices=False)
            r_full = s.shape[-1]
            r_k = torch.clamp(torch.ceil(caps * r_full), 1, r_full)
            keep = (torch.arange(r_full, device=d.device)
                    < r_k[:, None]).float()
            rec = (u * (s * keep)[:, None, :]) @ vt
            out[k] = (a.float() + rec).to(w.dtype)
        return out

    # -- wire codec -------------------------------------------------------
    def encode(self, w_new, msg, anchor, fed: FedConfig) -> WireUpdate:
        """Factor leaves ship truncated SVD factors at the client's rank
        (cap_k from ``msg``), computed on the host by numpy as the
        reference does; everything else ships dense; both through the
        int8 / int4 codec when ``fed.compress_bits`` is set. The payload
        lists the leaves in the reference's (sorted key) order."""
        cap_leaves = trees.leaves(msg)
        cap = float(cap_leaves[0]) if cap_leaves else self.capacity
        bits = fed.compress_bits
        payload, ranks = [], []
        wire = 0
        for k in sorted(anchor):
            wl, al = w_new[k], anchor[k]
            if _is_factor_leaf(al):
                d = (wl.float() - al.float()).cpu().numpy()
                r = _static_rank(cap, min(d.shape))
                u, s, vt = np.linalg.svd(d, full_matrices=False)
                fac = tuple(torch.from_numpy(np.ascontiguousarray(x))
                            .to(al.device) for x in (u[:, :r], s[:r],
                                                     vt[:r, :]))
                if bits:
                    qf = compression.quantize_delta(
                        fac, trees.tree_map(torch.zeros_like, fac), bits)
                    payload.append(qf)
                    wire += qf.wire_bytes
                else:
                    payload.append(fac)
                    wire += trees.nbytes(fac)
                ranks.append(r)
            else:
                if bits:
                    q = compression.quantize_delta(wl, al, bits)
                    payload.append(q)
                    wire += q.wire_bytes
                else:
                    payload.append(wl)
                    wire += trees.nbytes(wl)
                ranks.append(0)
        return WireUpdate(self.name, payload,
                          {"ranks": tuple(ranks), "cap": cap},
                          trees.nbytes(w_new), wire)

    @torch.no_grad()
    def decode(self, wire: WireUpdate, anchor, fed: FedConfig):
        out = {}
        for k, pl, r in zip(sorted(anchor), wire.payload, wire.meta["ranks"]):
            al = anchor[k]
            if r:
                if isinstance(pl, compression.QuantizedUpdate):
                    zeros = trees.tree_map(lambda q: torch.zeros(
                        q.shape, dtype=torch.float32, device=q.device), pl.q)
                    u, s, vt = compression.dequantize_delta(pl, zeros)
                else:
                    u, s, vt = pl
                rec = (u.float() * s.float()) @ vt.float()
                out[k] = (al.float() + rec).to(al.dtype)
            elif isinstance(pl, compression.QuantizedUpdate):
                out[k] = compression.dequantize_delta(pl, al)
            else:
                out[k] = pl
        return ({k: out[k] for k in anchor},
                torch.tensor(wire.meta["cap"], dtype=torch.float32,
                             device=params_device(anchor)))


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

ALGORITHMS = {
    "fedprox": FedProx,
    "scaffold": Scaffold,
    "lowrank": LowRankSubmodel,
}


def make_algorithm(name, **kwargs) -> FedAlgorithm:
    """Validated algorithm constructor: an instance passes through, a
    name from ``ALGORITHMS`` builds one; unknown names raise naming the
    valid options."""
    if isinstance(name, FedAlgorithm):
        return name
    try:
        cls = ALGORITHMS[str(name).lower()]
    except KeyError:
        raise ValueError(
            f"algorithm must be one of {sorted(ALGORITHMS)}, "
            f"got {name!r}") from None
    return cls(**kwargs)


# ---------------------------------------------------------------------------
# Loop oracles: per-iteration steps, algorithm-aware
# ---------------------------------------------------------------------------

# steps memoized per (cfg, fed, algorithm identity): the hooks are pure
# per cache_key, so any instance with the same key reuses the step
_STEP_CACHE: dict = {}
_STEP_CACHE_MAX = 16


def make_alg_step(cfg: ModelConfig, fed: FedConfig,
                  algorithm: FedAlgorithm):
    """One algorithm-aware local iteration, the per-iteration oracle
    generalizing ``fedasync.make_client_step``:

    (params, opt_state, state, anchor, batch, mask, server_ctx)
        -> (params, opt_state, state, loss)
    """
    key = (cfg, fed, algorithm.cache_key())
    if key in _STEP_CACHE:
        return _STEP_CACHE[key]
    opt = sgd(fed.lr, fed.momentum, fed.weight_decay)

    def vg(params, batch):
        return value_and_grad(
            lambda p: registry.loss_fn(p, cfg, batch)[0], params)

    def step(params, opt_state, state, anchor, batch, mask, server_ctx):
        batch = batch_to(batch, params_device(params))
        ctx = StepCtx(vg, opt, anchor, mask, server_ctx, fed)
        (params, opt_state, state), loss = algorithm.client_step(
            ctx, (params, opt_state, state), batch)
        return params, opt_state, state, loss

    while len(_STEP_CACHE) >= _STEP_CACHE_MAX:
        _STEP_CACHE.pop(next(iter(_STEP_CACHE)))
    _STEP_CACHE[key] = (step, opt)
    return step, opt


def client_update_loop(params_global, batches, cfg: ModelConfig,
                       fed: FedConfig, algorithm: FedAlgorithm,
                       client_id: int = 0, num_iters=None, mask=None,
                       server_ctx=None, state=None):
    """Algorithm-aware loop: one step and one host read of the loss per
    iteration, the parity oracle of the batched engines.

    Returns ``(w_new, new_state, msg, losses)`` (losses as floats) and
    persists the client's new state on ``algorithm``.
    """
    step, opt = make_alg_step(cfg, fed, algorithm)
    if mask is None:
        mask = trainable_mask(params_global, fed.trainable)
    if server_ctx is None:
        server_ctx = algorithm.ctx_for(params_global)
    if state is None:
        state = algorithm.state_for(client_id, params_global)
    params, anchor = params_global, params_global
    opt_state = opt.init(params)
    H = num_iters if num_iters is not None else fed.local_iters_max
    losses = []
    for _, batch in zip(range(H), batches):
        params, opt_state, state, loss = step(
            params, opt_state, state, anchor, batch, mask, server_ctx)
        losses.append(float(loss))
    w_new, new_state, msg = algorithm.client_finalize(
        params, anchor, state,
        torch.tensor(len(losses), dtype=torch.int32,
                     device=params_device(params_global)),
        server_ctx, fed)
    algorithm.store_state(client_id, new_state)
    return w_new, new_state, msg, losses


@torch.no_grad()
def server_reduce(algorithm: FedAlgorithm, params_global, w_news, states,
                  msgs, weights, server_ctx=None, commit: bool = True):
    """Eager algorithm-aware round fold, the loop oracle's server half
    (the engines run the same prepare, fold and finish in their calls).

    ``w_news`` / ``states`` / ``msgs`` are per-client lists; returns the
    new global params and server context, and with ``commit`` persists
    the context on ``algorithm``.
    """
    weights = torch.as_tensor(weights, dtype=torch.float32).to(
        params_device(params_global))
    if server_ctx is None:
        server_ctx = algorithm.ctx_for(params_global)
    w_stack = trees.stack(w_news)
    if algorithm.stateful:
        w_stack = algorithm.reduce_prepare(w_stack, params_global,
                                           trees.stack(states), server_ctx)
    avg = {k: torch.einsum("c,c...->...", weights,
                           w_stack[k].float()).to(p.dtype)
           for k, p in params_global.items()}
    msg_sum = ()
    if msgs and trees.leaves(msgs[0]):
        msg_sum = weighted_state_sum(trees.stack(msgs), weights)
    new_global, new_ctx = algorithm.reduce_finish(avg, msg_sum, server_ctx,
                                                  params_global)
    if commit:
        algorithm.set_ctx(new_ctx)
    return new_global, new_ctx

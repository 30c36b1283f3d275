"""Event-driven simulator of the heterogeneous embedded-device fleet.

Port of ``repro/core/simulator.py``: asynchronous mode (paper Algorithm 1)
and the synchronous FedAvg baseline, on the batched engines
(``engine="scan"``, the default: ``core/fed_engine.py``, CUDA graphs on
the card) or the per-iteration loop (``"loop"``, the oracle), and the
analytic sync-vs-async model of Table II. The paper's testbed is four
Jetson types whose per-epoch times differ by up to 4.7×; the simulator
advances a virtual clock from those measured times while running real
updates. The clock is host-side numpy drawn in the reference's order, so
``wall_clock_s``, the staleness and group histograms and the trace equal
the reference's exactly, on either engine.

``algorithm=`` (``core/algorithms.py``: FedProx, Scaffold,
LowRankSubmodel) runs on both engines and both modes, and
``fed.compress_bits`` sends every async update through the int8 / int4
wire codec (``core/compression.py``), per dispatch and outside any graph.
Both entry points take a ``Fleet`` or a ``FleetSpec`` (``Fleet.resolve``):
a streamed population of any size holds only its sampled (sync) or
in-flight (async) clients. ``run_sync`` also takes the sharded and
hierarchical engines (``"shard"``, ``"hier"``: the round's clients split
over the process group's ranks); ``run_async`` refuses them, as the
reference's does.
"""
from __future__ import annotations

import heapq
import math
from dataclasses import dataclass, field
from typing import Callable, Iterable, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import algorithms, fed_engine, fedasync, fedavg
from repro_torch.core.fedasync import ServerState
from repro_torch.core.fleet import (ASYNC_ENGINES, SYNC_ENGINES,
                                    DeviceProfile, EngineSpec, Fleet)
from repro_torch.data import stack_batches
from repro_torch.device import resolve_device
from repro_torch.optim import trainable_mask
from repro_torch.types import FedConfig, ModelConfig


@dataclass
class TraceEvent:
    time: float
    kind: str            # "dispatch" | "receive"
    client: int
    global_epoch: int
    staleness: int = 0
    beta_t: float = 0.0
    loss: float = math.nan


@dataclass
class SimResult:
    wall_clock_s: float
    history: list            # (virtual_time, global_epoch, loss)
    trace: list = field(default_factory=list)
    params: object = None
    staleness_hist: dict = field(default_factory=dict)
    group_hist: dict = field(default_factory=dict)   # {group size: count}
    max_inflight: int = 0

    @property
    def final_loss(self) -> float:
        return self.history[-1][2] if self.history else math.nan


def _client_time(profile: DeviceProfile, local_iters: int,
                 iters_per_epoch: int, rng: np.random.Generator,
                 jitter: float) -> float:
    epochs = local_iters / max(iters_per_epoch, 1)
    t = profile.epoch_seconds * epochs + profile.upload_seconds
    if jitter:
        # mean-one lognormal multiplier: μ = -σ²/2
        t *= float(rng.lognormal(mean=-0.5 * jitter * jitter, sigma=jitter))
    return t


class Scheduler:
    """Virtual-clock event queue with the staleness-bounded micro-batching
    window (the reference's ``Scheduler``).

    ``pop_window`` returns the earliest pending receive plus every later
    receive that (a) finishes within ``window`` virtual seconds of it,
    (b) would apply at staleness ≤ ``max_staleness`` at its position in
    the group, and (c) fits the remaining global-epoch ``budget``.
    ``policy="skip"`` leaves a too-stale event queued and keeps scanning;
    ``"stop"`` ends the group at the first one. ``window <= 0`` pops one
    event at a time: the exact event-by-event loop.
    """

    def __init__(self, window: float = 0.0, policy: str = "skip"):
        if policy not in ("skip", "stop"):
            raise ValueError(
                f"policy must be 'skip' or 'stop', got {policy!r}")
        self.window = float(window)
        self.policy = policy
        self._events: list = []
        self._seq = 0
        self.max_inflight = 0

    def push(self, finish_time: float, client: int, w_new, tau: int,
             loss: float) -> None:
        heapq.heappush(self._events,
                       (finish_time, self._seq, client, w_new, tau, loss))
        self._seq += 1
        self.max_inflight = max(self.max_inflight, len(self._events))

    def __len__(self) -> int:
        return len(self._events)

    def pop_window(self, t: int, max_staleness: int, budget: int) -> list:
        """Drain one receive group: ``[(finish_time, client, w_new, τ,
        loss), ...]`` in virtual-time order, never empty, at most
        ``budget`` long."""
        ft, _, k, w_new, tau, loss = heapq.heappop(self._events)
        group = [(ft, k, w_new, tau, loss)]
        if self.window > 0:
            deadline = ft + self.window
            skipped = []
            while self._events and len(group) < budget:
                if self._events[0][0] > deadline:
                    break
                ev = heapq.heappop(self._events)
                if (t + len(group)) - ev[4] > max_staleness:
                    skipped.append(ev)
                    if self.policy == "stop":
                        break
                    continue
                ft, _, k, w_new, tau, loss = ev
                group.append((ft, k, w_new, tau, loss))
            for ev in skipped:
                heapq.heappush(self._events, ev)
        return group


def _bound_algorithm(algorithm, fleet):
    """The run's algorithm instance (a name builds one; None is
    ``FedProx``), bound to ``fleet``."""
    alg = algorithms.make_algorithm(
        "fedprox" if algorithm is None else algorithm)
    alg.bind_fleet(fleet)
    return alg


def run_async(params0, cfg: ModelConfig, fed: FedConfig, fleet,
              client_data: Optional[Sequence[Callable[[], Iterable]]] = None,
              iters_per_epoch: int = 1, jitter: float = 0.0,
              eval_fn: Optional[Callable] = None, eval_every: int = 10,
              engine="scan", window: float = 0.0,
              window_policy: str = "skip", algorithm=None,
              device=None) -> SimResult:
    """Virtual-clock run of asynchronous federated learning.

    Each dispatch runs the client's H^k local iterations now and queues
    its receive at the virtual finish time; receives drain in
    ``Scheduler.pop_window`` groups and mix into the server in order
    (``fedasync.server_receive_many``, a group of m ≥ 2 in one call).
    ``fed.clients_per_round`` > 0 keeps that many clients in flight,
    sampling replacements from the rest of the population.

    ``fleet`` is a ``Fleet`` or a ``FleetSpec`` (streamed: a finished
    client's state is released when it leaves the in-flight set); the
    deprecated (profiles, ``client_data``) sequence pair still works
    with a warning (``Fleet.resolve``).

    ``engine="scan"`` (default) runs every dispatch, a lone one or a
    burst of concurrent ones (the kickoff, and with ``window`` > 0 each
    group's re-dispatches), as one ``run_batch`` padded to
    ``fed.local_iters_max`` with one host read of the losses; on the card
    each burst size is one CUDA graph whatever the H^k. ``"loop"`` is the
    per-iteration oracle (``algorithms.client_update_loop``). The
    virtual clock is the same on both.

    ``algorithm``: a ``core.algorithms.FedAlgorithm`` or its name; None
    is ``FedProx``, the paper's step. A stateful algorithm threads each
    client's state through its runs, sends ``(w_new, msg)`` over the wire
    and mixes with ``algorithm.mix`` (which also moves the server
    context). Updates go through the algorithm's codec (FedProx's is the
    int8 / int4 delta round trip) when ``fed.compress_bits`` is set or
    the algorithm asks for it (``wire_always``): per dispatch, after the
    engine's call.
    """
    fleet = Fleet.resolve(fleet, client_data, fed)
    espec = EngineSpec.from_str(engine, allowed=ASYNC_ENGINES)
    alg = _bound_algorithm(algorithm, fleet)
    stateful = alg.stateful
    device = resolve_device(device)
    params0 = {k: v.to(device) for k, v in params0.items()}
    rng = np.random.default_rng(fed.seed)
    sample_rng = np.random.default_rng((fed.seed, 0xA51C))
    if espec is EngineSpec.SCAN:
        run = fed_engine.make_client_run(cfg, fed, algorithm=alg)
    mask = trainable_mask(params0, fed.trainable)
    mix_many = fedasync.make_batched_server_update(fed)
    server = ServerState(params=params0, t=0)

    H: dict = {}
    inflight: set = set()
    m_inflight = fed.clients_per_round or fleet.population

    sched = Scheduler(window, policy=window_policy)
    trace, history = [], []
    staleness_hist: dict = {}
    group_hist: dict = {}

    def _empty_result(k):
        """Out-of-data client: the unchanged global goes back; a stateful
        algorithm still closes the run at zero iterations, so its msg
        (SCAFFOLD's Δc = 0, the low-rank capacity) is well formed."""
        if not stateful:
            return (server.params, [])
        w, st, msg = alg.client_finalize(
            server.params, server.params, alg.state_for(k, server.params),
            torch.zeros((), dtype=torch.int32, device=device),
            alg.ctx_for(server.params), fed)
        alg.store_state(k, st)
        return ((w, msg), [])

    def _run_clients(ks) -> dict:
        """{k: (w_new, losses)} for clients ``ks`` from the current server
        model, w_new being ``(w_new, msg)`` for a stateful algorithm. On
        the scan engine every dispatch, lone or a burst, is one
        ``run_batch`` padded to ``fed.local_iters_max``, so one program
        per burst size covers every H^k; clients whose batch shapes
        differ run as bursts of their own."""
        results = {}
        if espec is EngineSpec.LOOP:
            for k in ks:
                w_new, _, msg, losses = algorithms.client_update_loop(
                    server.params, fleet.data(k)(), cfg, fed, alg,
                    client_id=k, num_iters=H[k], mask=mask,
                    server_ctx=alg.ctx_for(server.params))
                results[k] = ((w_new, msg) if stateful else w_new, losses)
            return results
        bursts: dict = {}
        for k in ks:
            stack = stack_batches(fleet.data(k)(), limit=H[k])
            if stack is None:                        # client out of data
                results[k] = _empty_result(k)
            else:
                bursts.setdefault(fed_engine.stack_shapes(stack),
                                  []).append((k, stack))
        for burst in bursts.values():
            ids = [k for k, _ in burst]
            padded, iters = fed_engine.pad_client_batches(
                [stack for _, stack in burst], H_max=fed.local_iters_max)
            if stateful:
                w_news, new_states, msgs, loss_arr = run.run_batch(
                    server.params, padded, iters, mask=mask, donate=True,
                    server_ctx=alg.ctx_for(server.params),
                    states=alg.stacked_states(server.params, ids))
                outs = run.unstack((w_news, new_states, msgs), len(ids))
            else:
                w_news, loss_arr = run.run_batch(server.params, padded,
                                                 iters, mask=mask,
                                                 donate=True)
                outs = run.unstack(w_news, len(ids))
            la = loss_arr.cpu().numpy()              # one host read
            for j, (k, out) in enumerate(zip(ids, outs)):
                if stateful:
                    w, st, msg = out
                    alg.store_state(k, st)
                    out = (w, msg)
                results[k] = (out, [float(la[j, iters[j] - 1])])
        return results

    def _wire(w_new):
        """What the server receives of ``w_new``: through the algorithm's
        codec, decoded against the model handed out."""
        if not (fed.compress_bits or alg.wire_always):
            return w_new
        w, msg = w_new if stateful else (w_new, ())
        w, msg = alg.decode(alg.encode(w, msg, server.params, fed),
                            server.params, fed)
        return (w, msg) if stateful else w

    def dispatch(ks, now: float):
        tau = server.t
        for k in ks:
            if k not in H:
                H[k] = fleet.iters(k, fed)
            inflight.add(k)
        # the local training runs NOW (numerically); its finish time is
        # virtual
        results = _run_clients(ks)
        for k in ks:
            w_new, losses = results[k]
            dt = _client_time(fleet.profile(k), H[k], iters_per_epoch, rng,
                              jitter)
            sched.push(now + dt, k, _wire(w_new), tau,
                       losses[-1] if losses else math.nan)
            trace.append(TraceEvent(now, "dispatch", k, tau))

    if m_inflight < fleet.population:
        kickoff = [int(k) for k in fleet.sample(sample_rng, m_inflight)]
    else:
        kickoff = list(range(fleet.population))
    dispatch(kickoff, 0.0)

    now = 0.0
    while server.t < fed.global_epochs and len(sched):
        group = sched.pop_window(server.t, fed.max_staleness,
                                 fed.global_epochs - server.t)
        t0 = server.t
        if stateful:
            server, new_ctx, stals, betas = fedasync.server_receive_many(
                server, [(w, msg, tau)
                         for _, _, (w, msg), tau, _ in group], fed,
                algorithm=alg, server_ctx=alg.ctx_for(server.params))
            alg.set_ctx(new_ctx)
        else:
            server, stals, betas = fedasync.server_receive_many(
                server, [(w_new, tau) for _, _, w_new, tau, _ in group],
                fed, mix_many=mix_many)
        for i, ((ft, k, _, _, loss), st, bt) in enumerate(
                zip(group, stals, betas)):
            now = ft
            staleness_hist[st] = staleness_hist.get(st, 0) + 1
            trace.append(TraceEvent(ft, "receive", k, t0 + i + 1, st, bt,
                                    loss))
            history.append((ft, t0 + i + 1, loss))
        group_hist[len(group)] = group_hist.get(len(group), 0) + 1
        if eval_fn is not None and any(
                t % eval_every == 0 for t in range(t0 + 1, server.t + 1)):
            eval_fn(server.t, now, server.params)
        finished = [k for _, k, _, _, _ in group]
        if server.t < fed.global_epochs:
            if m_inflight < fleet.population:
                inflight.difference_update(finished)
                for k in finished:
                    H.pop(k, None)
                fleet.release(finished)
                replacements = [int(k) for k in fleet.sample(
                    sample_rng, len(finished), exclude=inflight)]
                dispatch(replacements, now)
            else:
                dispatch(finished, now)
        else:
            inflight.difference_update(finished)
            if m_inflight < fleet.population:
                fleet.release(finished)

    return SimResult(wall_clock_s=now, history=history, trace=trace,
                     params=server.params, staleness_hist=staleness_hist,
                     group_hist=group_hist, max_inflight=sched.max_inflight)


# ---------------------------------------------------------------------------
# Synchronous FedAvg baseline
# ---------------------------------------------------------------------------

def run_sync(params0, cfg: ModelConfig, fed: FedConfig, fleet,
             client_data: Optional[Sequence[Callable[[], Iterable]]] = None,
             iters_per_epoch: int = 1, jitter: float = 0.0,
             eval_fn: Optional[Callable] = None, eval_every: int = 10,
             engine="scan", algorithm=None, device=None) -> SimResult:
    """Virtual-clock synchronous FedAvg: each round costs the slowest of
    its clients' ``fed.local_iters_max`` local iterations.

    ``fleet`` is a ``Fleet`` or a ``FleetSpec``, or the deprecated
    (profiles, ``client_data``) pair, as for ``run_async``.
    ``fed.clients_per_round`` = m > 0 draws m clients a round uniformly
    without replacement and releases them after it (a streamed fleet
    holds O(m) clients whatever its population); a round then stands
    for m global epochs, so ``rounds = max(global_epochs // m, 1)``. 0
    runs the whole population every round.

    ``engine="scan"`` (default) runs every round as one ``SyncRound``
    call (a CUDA graph replay on the card); ``"shard"`` also splits the
    round's client axis over the process group's ranks
    (``launch.mesh.make_fleet_mesh``, on ``device``'s type: a world of one
    unless ``torchrun`` started more) with one ``all_reduce``;
    ``"hier"`` splits it over a two-level ``("edge", "clients")`` mesh,
    clients reducing to edge aggregators and edges to the server, the
    flat weighted average; ``"loop"`` is the per-client oracle. The
    virtual clock is the same on every engine.

    ``algorithm``: a ``core.algorithms.FedAlgorithm`` or its name; None
    is ``FedProx``, the paper's round. A stateful algorithm keeps each client's
    state on the instance across rounds, keyed by the sampled ids.
    """
    fleet = Fleet.resolve(fleet, client_data, fed)
    espec = EngineSpec.from_str(engine, allowed=SYNC_ENGINES)
    alg = _bound_algorithm(algorithm, fleet)
    device = resolve_device(device)
    rng = np.random.default_rng(fed.seed)
    sample_rng = np.random.default_rng((fed.seed, 0x5A3D))
    if espec is EngineSpec.LOOP:
        step, opt = fedasync.cached_client_step(cfg, fed)
        round_engine = None
    else:
        # before the params move: a launched rank's mesh selects its card
        round_engine = espec.build_sync(cfg, fed, algorithm=alg,
                                        device=device)
    params = {k: v.to(device) for k, v in params0.items()}
    mask = trainable_mask(params, fed.trainable)
    now = 0.0
    history, trace = [], []
    m = fed.clients_per_round or fleet.population
    rounds = max(fed.global_epochs // max(m, 1), 1)
    for r in range(rounds):
        if m < fleet.population:
            ids = [int(k) for k in fleet.sample(sample_rng, m)]
        else:
            ids = list(range(fleet.population))
        batches = [fleet.data(k)() for k in ids]
        if round_engine is not None:
            params, losses = fedavg.fedavg_round(
                params, batches, cfg, fed, engine=round_engine, mask=mask,
                donate_params=True, algorithm=alg, client_ids=ids)
        else:
            params, losses = fedavg.fedavg_round_loop(
                params, batches, cfg, fed, step=step, opt=opt, mask=mask,
                algorithm=alg, client_ids=ids)
        dt = max(_client_time(fleet.profile(k), fed.local_iters_max,
                              iters_per_epoch, rng, jitter)
                 for k in ids)
        if m < fleet.population:
            fleet.release(ids)
        now += dt
        loss = float(np.mean([l[-1] for l in losses if l]))
        history.append((now, r + 1, loss))
        trace.append(TraceEvent(now, "round", -1, r + 1, 0, 0.0, loss))
        if eval_fn is not None and (r + 1) % eval_every == 0:
            eval_fn(r + 1, now, params)
    return SimResult(wall_clock_s=now, history=history, trace=trace,
                     params=params)


# ---------------------------------------------------------------------------
# Analytic speedup model (Table II's claim without training)
# ---------------------------------------------------------------------------

def analytic_speedup(fleet: Sequence[DeviceProfile], epochs: int,
                     local_epochs: int = 3) -> dict:
    """Wall clock of sync vs async on a fleet, ignoring numerics.

    Sync: rounds of max(client), each consuming n_clients global epochs.
    Async: clients stream updates independently, so the server is done
    when ``epochs`` updates arrived at the aggregate rate Σ 1/T_k.
    """
    n = len(fleet)
    per_update = [p.epoch_seconds * local_epochs + p.upload_seconds
                  for p in fleet]
    sync = epochs / n * max(per_update)
    async_ = epochs / sum(1.0 / t for t in per_update)
    return {"sync_s": sync, "async_s": async_,
            "reduction": 1.0 - async_ / sync}

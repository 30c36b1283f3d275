"""Knowledge distillation with teaching assistants (paper §III-B, §V-A).

Port of ``repro/core/distill.py``, stage 1 of the pipeline.

L = α·L_cls + (1-α)·L_KD, with L_KD the temperature-scaled squared error
between teacher and student logits (the paper's choice at T=1). In TA
stages the classification targets are the teacher's hard predictions.

``DistillEngine.step`` runs the teacher forward under ``no_grad``, then
the student forward/backward, global-norm clipping and SGD. ``epoch`` runs
H such steps as one call: on the card one CUDA graph per (H, batch shape),
captured once and replayed (``compile_cache.GraphCache``), the counterpart
of the reference's ``lax.scan`` epoch; on the CPU the same steps eagerly.
The fused KD loss is the hand-written CUDA kernel by default
(``kd_kernel="cuda"``; inside the graph its forward and its backward are
graph nodes, the backward captured from autograd's device thread);
``"eager"`` is the plain torch version.

``CodistillFleet`` trains m peers of heterogeneous capacity on a shared
probe stream, each distilling from the mean of its peers' round-start
logits. Members sharing a ModelConfig form a group; on the card a
group's round-start logits are one CUDA graph and its masked KD run of
H steps another, the members one after another inside it, each with its
budget H^k a tensor input, so the graphs scale with the architectures,
not the members or the budgets. ``chain_time_model`` is the analytic
wall time of a teacher -> TA* -> student chain (host math).
"""
from __future__ import annotations

import functools
import math
import time
from dataclasses import dataclass, field
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch import trees
from repro_torch.core import fed_engine
from repro_torch.core.compile_cache import GraphCache
from repro_torch.data import stack_batches
from repro_torch.device import batch_to, params_device, resolve_device
from repro_torch.kernels import ops, ref
from repro_torch.models import registry
from repro_torch.optim import sgd, value_and_grad
from repro_torch.types import DistillConfig, ModelConfig

KD_KERNELS = ("cuda", "eager")


def _check_kernel(kd_kernel: str):
    if kd_kernel not in KD_KERNELS:
        raise ValueError(
            f"kd_kernel must be one of {KD_KERNELS}, got {kd_kernel!r}")


def kd_loss(student_logits, teacher_logits, labels, alpha: float,
            temperature: float = 1.0, kd_kernel: str = "cuda", valid=None):
    """Mean KD loss over all (valid) rows: α·CE + (1-α)·Σ((s-t)/T)².

    Leading axes flatten to rows. ``valid`` masks rows out of both the sum
    and the denominator.
    """
    _check_kernel(kd_kernel)
    V = student_logits.shape[-1]
    s = student_logits.reshape(-1, V)
    t = teacher_logits.reshape(-1, V)
    lab = labels.reshape(-1)
    v = None if valid is None else valid.reshape(-1)
    rows = ops.kd_loss_rows if kd_kernel == "cuda" else ref.kd_loss_ref
    per_row = rows(s, t, lab, alpha, temperature=temperature, valid=v)
    if v is None:
        return per_row.mean()
    return per_row.sum() / v.float().sum().clamp(min=1.0)


@torch.no_grad()
def clip_by_global_norm(grads: dict, max_norm: float) -> dict:
    """Scale all gradients by min(1, max_norm / ||g||), the norm in f32."""
    gn = torch.sqrt(torch.stack([g.float().square().sum()
                                 for g in grads.values()]).sum())
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return {k: (g * scale).to(g.dtype) for k, g in grads.items()}


def _check_widths(a: ModelConfig, b: ModelConfig):
    if registry.logit_width(a) != registry.logit_width(b):
        raise ValueError(
            f"KD needs equal logit width: {a.name} vs {b.name}")


def _epoch(step, params, mom, stacked, n=None):
    """``step(params, opt_state, batch)`` over a batch dict with leading
    axis H; returns (params, momentum, losses (H,), step count). The body
    of a captured epoch: the stack is already on the params' device
    there. ``n`` is a scheduled rate's step count, a tensor input and
    output of the graph; a constant rate's count is a host int that
    stays outside (``_run_epoch``), and ``None`` comes back."""
    stacked = batch_to(stacked, params_device(params))
    opt_state = {"mom": mom, "step": 0 if n is None else n}
    losses = []
    for i in range(len(stacked["labels"])):
        params, opt_state, loss = step(
            params, opt_state, {k: v[i] for k, v in stacked.items()})
        losses.append(loss)
    return (params, opt_state["mom"], torch.stack(losses),
            None if n is None else opt_state["step"])


def _run_epoch(graphs: GraphCache, body, fixed: tuple, params, opt_state,
               stacked):
    """One epoch through ``graphs``: ``body(*fixed, params, mom, stacked[,
    n])`` captured once per (H, batch shape) on the card, whatever the
    step count: a scheduled rate's tensor step is an input of the graph."""
    step = opt_state["step"]
    scheduled = isinstance(step, torch.Tensor)
    params, mom, losses, n = graphs.call(
        "epoch", body, fixed + (params, opt_state["mom"], stacked)
        + ((step,) if scheduled else ()))
    return (params, {"mom": mom, "step": n if scheduled
                     else step + len(losses)}, losses)


# ---------------------------------------------------------------------------
# Engines
# ---------------------------------------------------------------------------

class DistillEngine:
    """KD steps: teacher forward + student step.

    ``step(teacher_params, params, opt_state, batch)`` returns ``(params,
    opt_state, loss)``; ``epoch(..., stacked)`` runs H steps over a batch
    dict with leading axis H (``data.stack_batches``) as one call (one CUDA
    graph per (H, batch shape) on the card) and returns the losses as one
    (H,) tensor, so a caller syncs with the device once per epoch.
    Gradients are clipped by global norm (the MSE-on-logits term is
    scale-unbounded).
    """

    def __init__(self, teacher_cfg: ModelConfig, student_cfg: ModelConfig,
                 dcfg: DistillConfig, kd_kernel: str = "cuda",
                 use_teacher_targets: bool = True, clip_norm: float = 1.0):
        _check_kernel(kd_kernel)
        _check_widths(teacher_cfg, student_cfg)
        self.teacher_cfg = teacher_cfg
        self.student_cfg = student_cfg
        self.dcfg = dcfg
        self.kd_kernel = kd_kernel
        self.use_teacher_targets = use_teacher_targets
        self.clip_norm = clip_norm
        self.opt = sgd(dcfg.lr, dcfg.momentum, dcfg.weight_decay)
        self._graphs = GraphCache()

    def _loss(self, params, batch, teacher_logits):
        logits = registry.logits_fn(params, self.student_cfg, batch)
        labels = batch["labels"]
        if self.use_teacher_targets:
            labels = torch.argmax(teacher_logits, dim=-1)
        return kd_loss(logits, teacher_logits, labels, self.dcfg.alpha,
                       temperature=self.dcfg.temperature,
                       kd_kernel=self.kd_kernel)

    def step(self, teacher_params, params, opt_state, batch):
        batch = batch_to(batch, params_device(params))
        with torch.no_grad():
            t_logits = registry.logits_fn(teacher_params, self.teacher_cfg,
                                          batch)
        loss, grads = value_and_grad(
            lambda p: self._loss(p, batch, t_logits), params)
        if self.clip_norm:
            grads = clip_by_global_norm(grads, self.clip_norm)
        params, opt_state = self.opt.update(grads, opt_state, params)
        return params, opt_state, loss

    def _epoch(self, teacher_params, params, mom, stacked, n=None):
        return _epoch(functools.partial(self.step, teacher_params), params,
                      mom, stacked, n)

    @property
    def num_compiled(self) -> int:
        """Distinct epoch shapes run: one per (H, batch shape)."""
        return self._graphs.num_compiled

    def epoch(self, teacher_params, params, opt_state, stacked,
              donate: bool = False):
        """``donate`` is the reference's keyword; the stack is copied into
        the graph's input either way."""
        return _run_epoch(self._graphs, self._epoch, (teacher_params,),
                          params, opt_state, stacked)


class ScratchRun:
    """CE-only steps: the paper's 'train from scratch' baseline and the
    server-side teacher pretrain. Same interface as DistillEngine minus the
    teacher: ``epoch(params, opt_state, stacked)``."""

    def __init__(self, cfg: ModelConfig, dcfg: DistillConfig,
                 clip_norm: float = 1.0):
        self.cfg = cfg
        self.dcfg = dcfg
        self.clip_norm = clip_norm
        self.opt = sgd(dcfg.lr, dcfg.momentum, dcfg.weight_decay)
        self._graphs = GraphCache()

    def step(self, params, opt_state, batch):
        batch = batch_to(batch, params_device(params))
        loss, grads = value_and_grad(
            lambda p: registry.loss_fn(p, self.cfg, batch)[0], params)
        if self.clip_norm:
            grads = clip_by_global_norm(grads, self.clip_norm)
        params, opt_state = self.opt.update(grads, opt_state, params)
        return params, opt_state, loss

    def _epoch(self, params, mom, stacked, n=None):
        return _epoch(self.step, params, mom, stacked, n)

    @property
    def num_compiled(self) -> int:
        return self._graphs.num_compiled

    def epoch(self, params, opt_state, stacked, donate: bool = False):
        return _run_epoch(self._graphs, self._epoch, (), params, opt_state,
                          stacked)


def make_distill_engine(teacher_cfg: ModelConfig, student_cfg: ModelConfig,
                        dcfg: DistillConfig, kd_kernel: str = "cuda",
                        use_teacher_targets: bool = True,
                        clip_norm: float = 1.0) -> DistillEngine:
    """Memoized on the whole program's identity (both configs, the
    distill config, the kernel choice) through the fed engines' FIFO
    cache, so repeated pipeline runs replay their captured epochs."""
    key = ("distill", teacher_cfg, student_cfg, dcfg, kd_kernel,
           use_teacher_targets, clip_norm)
    return fed_engine.cached_engine(
        key, lambda: DistillEngine(teacher_cfg, student_cfg, dcfg,
                                   kd_kernel=kd_kernel,
                                   use_teacher_targets=use_teacher_targets,
                                   clip_norm=clip_norm))


def make_scratch_run(cfg: ModelConfig, dcfg: DistillConfig,
                     clip_norm: float = 1.0) -> ScratchRun:
    """A CE-only run, memoized as ``make_distill_engine``."""
    return fed_engine.cached_engine(
        ("scratch", cfg, dcfg, clip_norm),
        lambda: ScratchRun(cfg, dcfg, clip_norm=clip_norm))


# ---------------------------------------------------------------------------
# Evaluation
# ---------------------------------------------------------------------------

def _predict(params, batch, *, cfg: ModelConfig) -> torch.Tensor:
    return torch.argmax(registry.logits_fn(params, cfg, batch), dim=-1)


@torch.no_grad()
def evaluate(params, cfg: ModelConfig, batches) -> float:
    """Top-1 accuracy over batches (per clip for resnet3d, per token for
    the LM families); one device-to-host copy per batch."""
    device = params_device(params)
    hits = tot = 0
    for batch in batches:
        pred = _predict(params, batch_to(batch, device), cfg=cfg)
        pred = pred.cpu().numpy()
        hits += int(np.sum(pred == np.asarray(batch["labels"])))
        tot += int(np.prod(np.shape(batch["labels"])))
    return hits / max(tot, 1)


# ---------------------------------------------------------------------------
# The chain (teacher -> TA* -> student)
# ---------------------------------------------------------------------------

@dataclass
class StageResult:
    teacher: str
    student: str
    losses: list = field(default_factory=list)
    accuracy: float = 0.0
    wall_time_s: float = 0.0


def _run_epochs(run_epoch, it, total_steps: int, epoch_len: int):
    """Stack up to ``epoch_len`` batches per epoch, run it, read its loss
    vector once. Returns the per-step losses (list of float)."""
    losses: list = []
    remaining = total_steps
    while remaining > 0:
        stacked = stack_batches(it, limit=min(epoch_len, remaining))
        if stacked is None:
            break                      # iterator exhausted early
        remaining -= len(stacked["labels"])
        losses.extend(run_epoch(stacked).tolist())
    return losses


def run_chain(chain: Sequence[ModelConfig], dcfg: DistillConfig,
              train_batches: Callable[[], list], eval_batches: list,
              steps_per_stage: int, seed: int = 0,
              teacher_params=None, kd_kernel: str = "cuda",
              trained_teacher_steps: int = 0,
              epoch_len: int | None = None, device=None):
    """Run the teacher -> TA* -> student distillation chain.

    chain[0] is the teacher, pretrained here for ``trained_teacher_steps``
    CE steps when ``teacher_params`` is not given; each later model
    distils from the previous stage's result. Returns
    ``(final_params, [StageResult])``.
    """
    for prev, nxt in zip(chain[:-1], chain[1:]):
        _check_widths(prev, nxt)
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    results = []
    E = epoch_len or max(steps_per_stage, 1)

    tcfg = chain[0]
    if teacher_params is None:
        teacher_params = registry.init_params(gen, tcfg, device)
        if trained_teacher_steps:
            run = make_scratch_run(tcfg, dcfg)
            state = {"params": teacher_params,
                     "opt": run.opt.init(teacher_params)}

            def _pretrain_epoch(stacked):
                state["params"], state["opt"], ls = run.epoch(
                    state["params"], state["opt"], stacked)
                return ls

            _run_epochs(_pretrain_epoch, iter(train_batches()),
                        trained_teacher_steps, E)
            teacher_params = state["params"]
    else:
        teacher_params = {k: v.to(device) for k, v in teacher_params.items()}

    prev_params, prev_cfg = teacher_params, tcfg
    for scfg in chain[1:]:
        params = registry.init_params(gen, scfg, device)
        engine = make_distill_engine(prev_cfg, scfg, dcfg,
                                     kd_kernel=kd_kernel)
        state = {"params": params, "opt": engine.opt.init(params)}
        res = StageResult(teacher=prev_cfg.name, student=scfg.name)
        t0 = time.perf_counter()

        def _kd_epoch(stacked, _teacher=prev_params, _state=state,
                      _engine=engine):
            _state["params"], _state["opt"], ls = _engine.epoch(
                _teacher, _state["params"], _state["opt"], stacked)
            return ls

        res.losses = _run_epochs(_kd_epoch, iter(train_batches()),
                                 steps_per_stage, E)
        res.wall_time_s = time.perf_counter() - t0
        res.accuracy = evaluate(state["params"], scfg, eval_batches)
        results.append(res)
        prev_params, prev_cfg = state["params"], scfg

    return prev_params, results


# ---------------------------------------------------------------------------
# Codistillation across heterogeneous capacities
# ---------------------------------------------------------------------------

class CodistillFleet:
    """m peers of heterogeneous capacity co-training on a shared probe
    stream. Each round: (1) every member's logits on the round's probe
    stack, once (one call a group); (2) each member's masked KD run
    against the mean of its *peers'* round-start logits (teacher signals
    one round stale: that is the algorithm). Members sharing a
    ModelConfig run in one call, one after another, with per-member
    budgets H^k as an int32 tensor input: steps past a member's budget
    leave its params and momentum unchanged and emit NaN, and still run
    the KD kernels, so one graph covers every budget draw.

    The members' params and momenta live on the fleet; ``round`` moves
    them and returns the member-major (m, H) loss tensor. Under a
    scheduled ``dcfg.lr`` each member also keeps its step count, a 0-d
    tensor that its active steps advance and its masked steps leave
    alone, across rounds, as the reference's per-member optimizer state.
    """

    def __init__(self, cfgs: Sequence[ModelConfig], dcfg: DistillConfig,
                 kd_kernel: str = "cuda", clip_norm: float = 1.0):
        if len(cfgs) < 2:
            raise ValueError("codistillation needs >= 2 members")
        _check_kernel(kd_kernel)
        for other in cfgs[1:]:
            _check_widths(cfgs[0], other)
        fam0 = _probe_family(cfgs[0])
        for c in cfgs[1:]:
            if _probe_family(c) != fam0:
                raise ValueError(
                    "codistillation members must share a probe batch "
                    f"format: {cfgs[0].family} vs {c.family}")
        self.cfgs = tuple(cfgs)
        self.dcfg = dcfg
        self.kd_kernel = kd_kernel
        self.clip_norm = clip_norm
        self.opt = sgd(dcfg.lr, dcfg.momentum, dcfg.weight_decay)
        groups: dict = {}                  # cfg -> member indices
        for i, c in enumerate(cfgs):
            groups.setdefault(c, []).append(i)
        self.groups = [(c, tuple(idx)) for c, idx in groups.items()]
        self._params = [None] * len(self.groups)   # a param dict a member
        self._mom = [None] * len(self.groups)      # a momentum dict a member
        self._step = [None] * len(self.groups)     # a step tensor a member
        self._graphs = GraphCache()

    @property
    def num_members(self) -> int:
        return len(self.cfgs)

    @property
    def num_compiled(self) -> int:
        """Distinct (group, program, shape) signatures run."""
        return self._graphs.num_compiled

    def init(self, gen: torch.Generator, device=None):
        """Every member's params from ``gen``, group by group in member
        order, on ``device`` (default: the card)."""
        device = resolve_device(device)
        for gi, (cfg, idx) in enumerate(self.groups):
            self._params[gi] = [registry.init_params(gen, cfg, device)
                                for _ in idx]
            states = [self.opt.init(p) for p in self._params[gi]]
            self._mom[gi] = [st["mom"] for st in states]
            if callable(self.dcfg.lr):
                self._step[gi] = [st["step"] for st in states]
        return self

    def _member(self, i: int) -> tuple:
        """(group, index within the group) of member ``i``."""
        for gi, (_, idx) in enumerate(self.groups):
            if i in idx:
                return gi, idx.index(i)
        raise IndexError(i)

    def member_params(self, i: int) -> dict:
        gi, j = self._member(i)
        return self._params[gi][j]

    def member_step(self, i: int):
        """Member ``i``'s step count under a scheduled rate (a host read,
        a reporting path); ``None`` under a constant one, whose steps no
        graph counts."""
        gi, j = self._member(i)
        return None if self._step[gi] is None else int(self._step[gi][j])

    # -- the captured calls -----------------------------------------------
    @torch.no_grad()
    def _group_logits(self, cfg, members, stacked):
        """(m_g, H, ...logits) of the group's members on the probe."""
        stacked = batch_to(stacked, params_device(members[0]))
        H = fed_engine._batch_len(stacked)
        return torch.stack([
            torch.stack([registry.logits_fn(p, cfg, trees.index(stacked, h))
                         for h in range(H)])
            for p in members])

    def _group_kd(self, cfg, n_total, members, moms, steps, stacked, iters,
                  sum_logits, own_logits):
        """The group's masked KD runs: member j's teacher is
        (Σ_all - own_j) / (n - 1); steps from index ``iters[j]`` on keep
        its carry and emit NaN. ``steps``: the members' step tensors under
        a scheduled rate, else ``None``. Returns (params, momenta, steps,
        losses (m_g, H))."""
        device = params_device(members[0])
        stacked = batch_to(stacked, device)
        iters = torch.as_tensor(iters, device=device)
        H = fed_engine._batch_len(stacked)
        out_p, out_m, out_s, out_l = [], [], [], []
        for j, (params, mom) in enumerate(zip(members, moms)):
            opt_state = {"mom": mom, "step": 0 if steps is None else steps[j]}
            teacher_seq = (sum_logits - own_logits[j]) / (n_total - 1.0)
            losses = []
            for i in range(H):
                batch = trees.index(stacked, i)

                def loss_of(p, batch=batch, t=teacher_seq[i]):
                    return kd_loss(registry.logits_fn(p, cfg, batch), t,
                                   batch["labels"], self.dcfg.alpha,
                                   temperature=self.dcfg.temperature,
                                   kd_kernel=self.kd_kernel)

                loss, grads = value_and_grad(loss_of, params)
                grads = clip_by_global_norm(grads, self.clip_norm)
                new = self.opt.update(grads, opt_state, params)
                active = i < iters[j]
                params, opt_state = fed_engine._where(
                    active, new, (params, opt_state))
                losses.append(torch.where(active, loss, math.nan))
            out_p.append(params)
            out_m.append(opt_state["mom"])
            out_s.append(opt_state["step"])
            out_l.append(torch.stack(losses))
        return (out_p, out_m, None if steps is None else out_s,
                torch.stack(out_l))

    def round(self, stacked_probe, iters=None):
        """One codistillation round over a probe stack (leaves (H, B, ...)).

        ``iters``: (m,) per-member budgets (default: all run the full H).
        Warm rounds at a fixed (H, batch) shape add no signature, whatever
        the budgets. Returns the member-major (m, H) loss tensor.
        """
        H = fed_engine._batch_len(stacked_probe)
        m = self.num_members
        if iters is None:
            iters = np.full((m,), H, np.int32)
        iters = np.asarray(iters, np.int32)
        if iters.shape != (m,):
            raise ValueError(f"iters must be ({m},), got {iters.shape}")

        # (1) round-start logits, one call a group
        group_logits = [
            self._graphs.call(("logits", gi),
                              functools.partial(self._group_logits, cfg),
                              (self._params[gi], stacked_probe))
            for gi, (cfg, _) in enumerate(self.groups)]

        # (2) the peers' sum in the reference's order (members within a
        # group, then the groups), then each group's masked KD runs
        sum_logits = functools.reduce(
            torch.add, [gl.sum(dim=0) for gl in group_logits])
        losses = [None] * m
        for gi, (cfg, idx) in enumerate(self.groups):
            (self._params[gi], self._mom[gi], self._step[gi],
             g_losses) = self._graphs.call(
                ("kd", gi), functools.partial(self._group_kd, cfg, m),
                (self._params[gi], self._mom[gi], self._step[gi],
                 stacked_probe, iters[list(idx)], sum_logits,
                 group_logits[gi]))
            for j, i in enumerate(idx):
                losses[i] = g_losses[j]
        return torch.stack(losses)


def _probe_family(cfg: ModelConfig) -> str:
    """Probe-batch format class: members must agree to share batches."""
    if cfg.family == "resnet3d":
        return "clips"
    if cfg.family in registry.ENCDEC_FAMILIES:
        return "src+tokens"
    return "tokens"


def run_codistill(cfgs: Sequence[ModelConfig], dcfg: DistillConfig,
                  train_batches: Callable[[], list], eval_batches: list,
                  rounds: int, steps_per_round: int, iters=None,
                  seed: int = 0, kd_kernel: str = "cuda", device=None):
    """``rounds`` codistillation rounds of ``steps_per_round`` probe
    batches each, a fresh pass over ``train_batches()`` when it runs dry;
    one host read of each round's losses. Returns ``(fleet, {"losses":
    (rounds, m, H) float array, "accuracy": [m]})``."""
    fleet = CodistillFleet(cfgs, dcfg, kd_kernel=kd_kernel).init(
        torch.Generator().manual_seed(seed), device)
    it = iter(train_batches())
    history = []
    for _ in range(rounds):
        stacked = stack_batches(it, limit=steps_per_round)
        if stacked is None:
            it = iter(train_batches())      # fresh pass over the stream
            stacked = stack_batches(it, limit=steps_per_round)
            if stacked is None:
                break
        history.append(fleet.round(stacked, iters=iters).cpu().numpy())
    accs = [evaluate(fleet.member_params(i), cfgs[i], eval_batches)
            for i in range(len(cfgs))]
    return fleet, {"losses": np.asarray(history), "accuracy": accs}


# ---------------------------------------------------------------------------
# Analytic chain-time model (Table I's shape at full scale; host math)
# ---------------------------------------------------------------------------

def _fwd_flops_per_item(cfg: ModelConfig) -> float:
    """Forward FLOPs per clip or token: 2·MACs for a CNN (its convolutions
    reuse their weights across positions), 2·params otherwise."""
    if cfg.family == "resnet3d":
        from repro_torch.models.resnet3d import macs_per_clip
        return 2.0 * macs_per_clip(cfg)
    return 2.0 * cfg.param_count()


def stage_flops(teacher: ModelConfig, student: ModelConfig,
                tokens_or_clips: float) -> float:
    """FLOPs of one KD stage: teacher fwd + student fwd/bwd (3x fwd)."""
    return (_fwd_flops_per_item(teacher) + 3 * _fwd_flops_per_item(student)) \
        * tokens_or_clips


def chain_time_model(chain: Sequence[ModelConfig], dataset_items: float,
                     epochs: int, device_flops: float = 125e12,
                     mfu: float = 0.15) -> dict:
    """Predicted wall time per stage and in total (seconds): each stage's
    FLOPs over ``device_flops`` × ``mfu``. The defaults model the paper's
    V100 server (125 TFLOP/s tensor peak at a CNN-typical 15%
    utilization). Gives Table I's shape (time grows with each TA while
    accuracy saturates) and its order of magnitude."""
    out = {"stages": [], "total_s": 0.0}
    for t, s in zip(chain[:-1], chain[1:]):
        fl = stage_flops(t, s, dataset_items * epochs)
        sec = fl / (device_flops * mfu)
        out["stages"].append({"teacher": t.name, "student": s.name,
                              "flops": fl, "seconds": sec})
        out["total_s"] += sec
    return out

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
``"eager"`` is the plain torch version. Codistillation and the analytic
chain-time model are still to be ported (ROADMAP Queue 1 item 4).
"""
from __future__ import annotations

import functools
import time
from dataclasses import dataclass, field
from typing import Callable, Sequence

import numpy as np
import torch

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


def _epoch(step, params, mom, stacked):
    """``step(params, opt_state, batch)`` over a batch dict with leading
    axis H; returns (params, momentum, losses (H,)). The body of a
    captured epoch: the stack is already on the params' device there, and
    the step count, a host integer, stays outside (``_run_epoch``)."""
    stacked = batch_to(stacked, params_device(params))
    opt_state = {"mom": mom, "step": 0}
    losses = []
    for i in range(len(stacked["labels"])):
        params, opt_state, loss = step(
            params, opt_state, {k: v[i] for k, v in stacked.items()})
        losses.append(loss)
    return params, opt_state["mom"], torch.stack(losses)


def _run_epoch(graphs: GraphCache, body, fixed: tuple, params, opt_state,
               stacked):
    """One epoch through ``graphs``: ``body(*fixed, params, mom, stacked)``
    captured once per (H, batch shape) on the card."""
    params, mom, losses = graphs.call(
        "epoch", body, fixed + (params, opt_state["mom"], stacked))
    return (params, {"mom": mom, "step": opt_state["step"] + len(losses)},
            losses)


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

    def _epoch(self, teacher_params, params, mom, stacked):
        return _epoch(functools.partial(self.step, teacher_params), params,
                      mom, stacked)

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

    def _epoch(self, params, mom, stacked):
        return _epoch(self.step, params, mom, stacked)

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

@torch.no_grad()
def evaluate(params, cfg: ModelConfig, batches) -> float:
    """Top-1 accuracy over batches; one device-to-host copy per batch."""
    device = params_device(params)
    hits = tot = 0
    for batch in batches:
        logits = registry.logits_fn(params, cfg, batch_to(batch, device))
        pred = logits.argmax(dim=-1).cpu().numpy()
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

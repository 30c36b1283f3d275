"""Convergence-bound evaluator for the paper's Theorem (§IV-B).

After E global updates,

    min_t E||∇F(w_t)||² ≤  E[F(w_0) - F(w_E)] / (β η ε E H_min)
                         + O(η λ³ H_min² / ε)           (local drift)
                         + O(β K λ / ε)                 (staleness, asymptotic)
                         + O(η K² λ² H_min / ε)
                         + O(β² η K² λ² H_min / ε)

and with η = 1/√E the bound → O(βKλ/ε) as E → ∞. The O(·) constants involve
B1, B2 (Assumption 4); we expose them explicitly so the bound is computable
and its monotonicities testable.

Port of ``repro/core/convergence.py``: host arithmetic only.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

from repro_torch.types import FedConfig


@dataclass(frozen=True)
class BoundInputs:
    E: int                  # global epochs
    beta: float             # mixing β
    eta: float              # learning rate η
    eps: float              # ε from the theorem
    K: int                  # max staleness (Assumption 3)
    lam: float              # imbalance ratio λ = H_max / H_min
    H_min: int
    F0_minus_FE: float      # E[F(w_0) - F(w_E)]
    B1: float = 1.0         # ||∇l|| bound
    B2: float = 1.0         # ||∇g|| bound

    @staticmethod
    def from_fed(fed: FedConfig, E: int | None = None,
                 F0_minus_FE: float = 1.0, eps: float = 1.0,
                 B1: float = 1.0, B2: float = 1.0) -> "BoundInputs":
        return BoundInputs(
            E=E if E is not None else fed.global_epochs,
            beta=fed.mixing_beta, eta=fed.lr, eps=eps,
            K=fed.max_staleness, lam=fed.imbalance_ratio,
            H_min=fed.local_iters_min, F0_minus_FE=F0_minus_FE,
            B1=B1, B2=B2)


def bound_terms(b: BoundInputs) -> dict:
    """The five terms of the bound (with explicit B1/B2 constants)."""
    t0 = b.F0_minus_FE / (b.beta * b.eta * b.eps * b.E * b.H_min)
    t1 = b.eta * b.lam ** 3 * b.H_min ** 2 * b.B2 ** 2 / b.eps
    t2 = b.beta * b.K * b.lam * b.B1 * b.B2 / b.eps
    t3 = b.eta * b.K ** 2 * b.lam ** 2 * b.H_min * b.B2 ** 2 / b.eps
    t4 = b.beta ** 2 * b.eta * b.K ** 2 * b.lam ** 2 * b.H_min \
        * b.B2 ** 2 / b.eps
    return {"optimality": t0, "local_drift": t1, "staleness": t2,
            "staleness_sq": t3, "mixing_sq": t4}


def bound(b: BoundInputs) -> float:
    return sum(bound_terms(b).values())


def asymptotic_bound(b: BoundInputs) -> float:
    """lim_{E→∞} with η = 1/√E: O(βKλ/ε) — the only surviving term."""
    return b.beta * b.K * b.lam * b.B1 * b.B2 / b.eps


def theta_condition(theta: float, mu: float, eps: float, B2: float,
                    drift_sq: float) -> bool:
    """Theorem precondition: θ > μ and
    -(1+2θ+ε)B2² + (θ² - θ/2)·||w_{τ,h-1} - w_τ||² ≥ 0."""
    if theta <= mu:
        return False
    lhs = -(1.0 + 2.0 * theta + eps) * B2 ** 2 \
        + (theta ** 2 - theta / 2.0) * drift_sq
    return lhs >= 0.0


def min_theta(mu: float, eps: float, B2: float, drift_sq: float,
              hi: float = 1e6) -> float:
    """Smallest θ satisfying the precondition (bisection; math-only)."""
    if drift_sq <= 0:
        return math.inf
    lo = max(mu, 0.5) + 1e-9
    if not theta_condition(hi, mu, eps, B2, drift_sq):
        return math.inf
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if theta_condition(mid, mu, eps, B2, drift_sq):
            hi = mid
        else:
            lo = mid
    return hi


def lr_schedule_for_asymptotic(E: int) -> float:
    """The theorem's η = 1/√E choice."""
    return 1.0 / math.sqrt(E)

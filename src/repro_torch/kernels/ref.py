"""Plain PyTorch versions of the port's kernels (counterpart of
``repro/kernels/ref.py``). The CPU path and the on-card comparisons use
them; the kernels are held against them."""
from __future__ import annotations

import torch


def kd_loss_ref(student_logits, teacher_logits, labels, alpha: float,
                temperature: float = 1.0, valid=None):
    """Per-row fused KD loss: α·CE + (1-α)·Σ((s-t)/T)².

    student/teacher: (R, V); labels: (R,) int. Returns (R,) float32.
    Rows where ``valid`` == 0 return exactly 0.0 (select, not multiply, so
    garbage logits in masked rows cannot leak NaN/Inf).
    """
    s = student_logits.float()
    t = teacher_logits.float()
    lse = torch.logsumexp(s, dim=-1)
    gold = torch.gather(s, -1, labels.long()[:, None])[:, 0]
    d = (s - t) / temperature
    out = alpha * (lse - gold) + (1.0 - alpha) * torch.sum(d * d, dim=-1)
    if valid is None:
        return out
    return torch.where(valid.float() > 0.0, out, torch.zeros_like(out))

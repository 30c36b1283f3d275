"""Shared losses (port of ``repro/models/common.py``; the LM building
blocks come with the LM stack, ROADMAP Queue 1 item 11)."""
from __future__ import annotations

import torch


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  ignore_index: int = -100) -> torch.Tensor:
    """Mean CE over non-ignored positions. logits (..., V), labels (...)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1,
                        labels.long().clamp(min=0).unsqueeze(-1))[..., 0]
    mask = (labels != ignore_index).float()
    nll = (lse - gold) * mask
    return nll.sum() / mask.sum().clamp(min=1.0)

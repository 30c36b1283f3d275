"""Public entries of the port's kernels (counterpart of
``repro/kernels/ops.py``). Kernels 2-6 of the reference (attention and SSD
scans) are still to be ported: ROADMAP Queue 2."""
from __future__ import annotations

from repro_torch.kernels.kd_loss import kd_loss_rows

__all__ = ["kd_loss_rows"]

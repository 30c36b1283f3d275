"""Public entries of the port's kernels (counterpart of
``repro/kernels/ops.py``). The sliding-window prefill attention and the
SSD chunk scan (kernels 5 and 6 of ROADMAP Queue 2) are still to be
ported."""
from __future__ import annotations

from repro_torch.kernels.decode_attend import (extent_decode_attend,
                                               ring_decode_attend)
from repro_torch.kernels.kd_loss import kd_loss_rows
from repro_torch.kernels.ssd_decode import ssd_decode_step

__all__ = ["extent_decode_attend", "kd_loss_rows", "ring_decode_attend",
           "ssd_decode_step"]

"""Re-startable batch loader (numpy copy of ``repro/data/loader.py``)."""
from __future__ import annotations

from typing import Iterator

import numpy as np


class BatchLoader:
    """Calling it returns a fresh finite iterator — the ``fleet.data(k)()``
    contract of the simulator. Each call is a new local epoch with its own
    seed ``(seed, epoch)``, as in the reference."""

    def __init__(self, dataset, batch_size: int, steps: int,
                 seed: int = 0, indices: np.ndarray | None = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.steps = steps
        self.seed = seed
        self.indices = indices
        self._epoch = 0

    def __call__(self) -> Iterator[dict]:
        self._epoch += 1
        return self.dataset.batches(self.batch_size, self.steps,
                                    seed=(self.seed, self._epoch),
                                    indices=self.indices)

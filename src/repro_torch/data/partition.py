"""Federated data partitioning (numpy copy of ``repro/data/partition.py``)."""
from __future__ import annotations

import numpy as np


def iid_partition(num_items: int, num_clients: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    perm = rng.permutation(num_items)
    return [np.sort(s) for s in np.array_split(perm, num_clients)]

"""Federated data partitioning: IID and Dirichlet non-IID splits (numpy
copy of ``repro/data/partition.py``)."""
from __future__ import annotations

import numpy as np


def iid_partition(num_items: int, num_clients: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    perm = rng.permutation(num_items)
    return [np.sort(s) for s in np.array_split(perm, num_clients)]


def iid_shard(num_items: int, num_clients: int, client: int, seed: int = 0,
              perm: np.ndarray | None = None):
    """ONE client's IID shard, bit-identical to ``iid_partition(num_items,
    num_clients, seed)[client]`` without building every client's list.
    ``perm`` reuses a caller's permutation of the items."""
    if not 0 <= client < num_clients:
        raise ValueError(f"client {client} outside [0, {num_clients})")
    if perm is None:
        perm = np.random.default_rng(seed).permutation(num_items)
    # np.array_split boundaries: the first (num_items % num_clients) shards
    # get one extra item
    q, r = divmod(num_items, num_clients)
    start = client * q + min(client, r)
    stop = start + q + (1 if client < r else 0)
    return np.sort(perm[start:stop])


def dirichlet_partition(labels: np.ndarray, num_clients: int,
                        alpha: float = 0.5, seed: int = 0):
    """Class-skewed split; alpha→∞ recovers IID, alpha→0 one-class clients."""
    rng = np.random.default_rng(seed)
    classes = np.unique(labels)
    shards: list[list[int]] = [[] for _ in range(num_clients)]
    for c in classes:
        idx = np.where(labels == c)[0]
        rng.shuffle(idx)
        props = rng.dirichlet(np.full(num_clients, alpha))
        cuts = (np.cumsum(props) * len(idx)).astype(int)[:-1]
        for k, part in enumerate(np.split(idx, cuts)):
            shards[k].extend(part.tolist())
    return [np.sort(np.array(s, dtype=np.int64)) for s in shards]

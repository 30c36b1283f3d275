"""Client fleets (port of the resident half of ``repro/core/fleet.py``).

``Fleet.from_lists`` holds an explicit small fleet: one ``DeviceProfile``
and one re-startable loader per client (the paper's four Jetsons).
``EngineSpec`` is the one definition of the engine knob. The streaming
``FleetSpec`` populations are still to be ported (ROADMAP Queue 1 item 9).
"""
from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Callable, Iterable, Optional, Sequence, Tuple

import numpy as np


@dataclass(frozen=True)
class DeviceProfile:
    name: str
    epoch_seconds: float        # seconds per local epoch (paper Table IV)
    test_seconds: float = 0.0   # seconds to evaluate the test set (Table V)
    upload_seconds: float = 0.0


# Paper Table IV / V — HMDB51 column.
JETSON_FLEET_HMDB51 = (
    DeviceProfile("jetson-nano", 391.1, 181.4),
    DeviceProfile("jetson-tx2", 293.1, 116.3),
    DeviceProfile("jetson-xavier-nx", 121.3, 89.4),
    DeviceProfile("jetson-agx-xavier", 84.5, 68.3),
)

# Paper Table IV / V — UCF101 column.
JETSON_FLEET_UCF101 = (
    DeviceProfile("jetson-nano", 2691.6, 621.3),
    DeviceProfile("jetson-tx2", 2001.4, 381.2),
    DeviceProfile("jetson-xavier-nx", 821.9, 322.5),
    DeviceProfile("jetson-agx-xavier", 572.1, 217.7),
)


# ---------------------------------------------------------------------------
# EngineSpec — the single definition of the engine knob
# ---------------------------------------------------------------------------

class EngineSpec(enum.Enum):
    """Client-execution engine selector.

    SCAN   the batched engines (``core/fed_engine.py``): a client's H local
           steps, a burst of clients or a whole sync round as one call,
           replayed as one CUDA graph per round shape on the card — the
           default everywhere.
    LOOP   per-iteration dispatch loop; the parity oracle.
    SHARD  SCAN with the sync round's client axis split over devices
           (sync only; ROADMAP Queue 1 item 13).
    HIER   SCAN over a two-level edge / clients mesh (sync only; item 13).
    """

    SCAN = "scan"
    LOOP = "loop"
    SHARD = "shard"
    HIER = "hier"

    @classmethod
    def from_str(cls, value, allowed: Optional[Tuple["EngineSpec", ...]]
                 = None) -> "EngineSpec":
        """Validate ``value`` (a string or an EngineSpec) into a member;
        ``allowed`` restricts the accepted subset, and the error names the
        valid options."""
        if isinstance(value, cls):
            spec = value
        else:
            try:
                spec = cls(value)
            except ValueError:
                raise ValueError(
                    f"engine must be one of "
                    f"{[m.value for m in cls]}, got {value!r}") from None
        if allowed is not None and spec not in allowed:
            raise ValueError(
                f"engine {spec.value!r} not supported here; valid options: "
                f"{[m.value for m in allowed]}")
        return spec

    def build_sync(self, cfg, fed, mesh=None, algorithm=None):
        """The sync-round engine for this member (None for LOOP: the
        caller owns the per-iteration oracle path)."""
        from repro_torch.core import fed_engine
        if self is EngineSpec.SCAN:
            return fed_engine.make_sync_round(cfg, fed, algorithm=algorithm)
        if self is EngineSpec.SHARD:
            return fed_engine.make_sharded_sync_round(cfg, fed, mesh=mesh,
                                                      algorithm=algorithm)
        if self is EngineSpec.HIER:
            return fed_engine.make_hierarchical_sync_round(
                cfg, fed, mesh=mesh, algorithm=algorithm)
        return None


# engine subsets accepted by the two simulator entry points
SYNC_ENGINES = (EngineSpec.SCAN, EngineSpec.LOOP, EngineSpec.SHARD,
                EngineSpec.HIER)
ASYNC_ENGINES = (EngineSpec.SCAN, EngineSpec.LOOP)


class Fleet:
    """Client population handed to ``simulator.run_async``."""

    def __init__(self, profiles: Sequence[DeviceProfile],
                 client_data: Sequence[Callable[[], Iterable]]):
        self.population = len(profiles)
        self._profiles = list(profiles)
        self._client_data = list(client_data)
        self._iters_cache: dict = {}

    @classmethod
    def from_lists(cls, profiles: Sequence[DeviceProfile],
                   client_data: Sequence[Callable[[], Iterable]]) -> "Fleet":
        if len(profiles) != len(client_data):
            raise ValueError(
                f"fleet profiles ({len(profiles)}) and client_data "
                f"({len(client_data)}) must agree")
        if not len(profiles):
            raise ValueError("empty fleet")
        return cls(profiles, client_data)

    def check(self, fed) -> "Fleet":
        """Validate against a FedConfig (population and in-flight size)."""
        if self.population != fed.num_clients:
            raise ValueError(
                f"fleet population ({self.population}) and fed.num_clients "
                f"({fed.num_clients}) must agree")
        m = fed.clients_per_round
        if m < 0 or m > self.population:
            raise ValueError(
                f"fed.clients_per_round ({m}) must be in "
                f"[0, population={self.population}]")
        return self

    def profile(self, k: int) -> DeviceProfile:
        return self._profiles[k]

    def data(self, k: int) -> Callable[[], Iterable]:
        """Client k's own (stateful) fresh-iterator factory."""
        return self._client_data[k]

    def iters(self, k: int, fed) -> int:
        """Resource-aware H^k ∈ [H_min, H_max]: fleet-wide argsort of
        epoch_seconds (ties by position), fastest gets H_max."""
        key = (fed.local_iters_min, fed.local_iters_max)
        if key not in self._iters_cache:
            order = np.argsort([p.epoch_seconds for p in self._profiles])
            H = np.empty(self.population, np.int64)
            for rank, j in enumerate(order):
                frac = rank / max(self.population - 1, 1)
                H[int(j)] = int(round(fed.local_iters_max
                                      - frac * (fed.local_iters_max
                                                - fed.local_iters_min)))
            self._iters_cache[key] = H
        return int(self._iters_cache[key][k])

    def capacity(self, k: int, lo: float = 0.5, hi: float = 1.0) -> float:
        """Relative compute capacity of client k in [lo, hi] by device
        speed rank, the ``iters`` rule's continuous twin (fastest device
        ``hi``, slowest ``lo``); ``algorithms.LowRankSubmodel`` scales its
        per-client budget by it."""
        key = ("capacity", lo, hi)
        if key not in self._iters_cache:
            order = np.argsort([p.epoch_seconds for p in self._profiles])
            caps = np.empty(self.population, np.float64)
            for rank, j in enumerate(order):
                frac = rank / max(self.population - 1, 1)
                caps[int(j)] = hi - frac * (hi - lo)
            self._iters_cache[key] = caps
        return float(self._iters_cache[key][k])

    def release(self, ks) -> None:
        """Resident fleets hold every client for the run: nothing to drop."""

    def sample(self, rng: np.random.Generator, m: int,
               exclude=()) -> np.ndarray:
        """Draw ``m`` distinct client ids uniformly, excluding ``exclude``
        (the in-flight set), with the reference's draws: a permutation
        draw for small populations, rejection sampling for large ones."""
        exclude = set(int(e) for e in exclude)
        if m > self.population - len(exclude):
            raise ValueError(
                f"cannot sample {m} clients from a population of "
                f"{self.population} with {len(exclude)} excluded")
        if self.population <= 4 * (m + len(exclude)) + 1024:
            pool = np.array([k for k in range(self.population)
                             if k not in exclude], np.int64)
            return np.asarray(rng.choice(pool, size=m, replace=False),
                              np.int64)
        out: list = []
        seen = set(exclude)
        while len(out) < m:
            for d in rng.integers(0, self.population, size=m):
                d = int(d)
                if d not in seen:
                    seen.add(d)
                    out.append(d)
                    if len(out) == m:
                        break
        return np.asarray(out, np.int64)

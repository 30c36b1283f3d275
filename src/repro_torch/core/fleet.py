"""Client fleets (port of ``repro/core/fleet.py``).

``FleetSpec`` describes a population without holding it: its size, a
seeded distribution over device profiles and a data rule (a shared
dataset with a ``"shared"`` or ``"iid"`` partition, or a ``data_fn``). A
client's profile, H^k, capacity and loader are pure numpy functions of
(spec, k, visit), equal to the reference's draw for draw.

``Fleet`` is what ``simulator.run_async`` / ``run_sync`` take. Built
``from_lists`` it holds an explicit small fleet (one ``DeviceProfile``
and one re-startable loader per client: the paper's four Jetsons);
built ``from_spec`` it streams: a client's state materializes when it
is sampled and ``release`` drops it when it leaves the sampled or
in-flight set, so ``max_resident`` stays O(m) for sync rounds and
O(in-flight) for async runs whatever the population. ``resolve`` is the
one validated constructor behind both entry points. ``EngineSpec`` is
the one definition of the engine knob.
"""
from __future__ import annotations

import enum
import warnings
from dataclasses import dataclass
from typing import Any, Callable, Iterable, Optional, Sequence, Tuple

import numpy as np

from repro_torch.data import BatchLoader, iid_shard


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
    SHARD  SCAN with the sync round's client axis split over the ranks
           of a 1-D ``("clients",)`` mesh, reduced by one ``all_reduce``
           (sync only; ``launch.mesh.make_fleet_mesh``: a world of one
           unless ``torchrun`` started more ranks).
    HIER   SCAN over a two-level ``("edge", "clients")`` mesh: clients
           reduce to edge aggregators, edges to the server, one
           ``all_reduce`` a level, the flat weighted average (sync only).
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

    def build_sync(self, cfg, fed, mesh=None, algorithm=None, device=None):
        """The sync-round engine for this member (None for LOOP: the
        caller owns the per-iteration oracle path). SHARD and HIER build
        their default mesh on ``device``'s type."""
        from repro_torch.core import fed_engine
        if self is EngineSpec.SCAN:
            return fed_engine.make_sync_round(cfg, fed, algorithm=algorithm)
        if self is EngineSpec.SHARD:
            return fed_engine.make_sharded_sync_round(
                cfg, fed, mesh=mesh, algorithm=algorithm, device=device)
        if self is EngineSpec.HIER:
            return fed_engine.make_hierarchical_sync_round(
                cfg, fed, mesh=mesh, algorithm=algorithm, device=device)
        return None


# engine subsets accepted by the two simulator entry points
SYNC_ENGINES = (EngineSpec.SCAN, EngineSpec.LOOP, EngineSpec.SHARD,
                EngineSpec.HIER)
ASYNC_ENGINES = (EngineSpec.SCAN, EngineSpec.LOOP)


# ---------------------------------------------------------------------------
# FleetSpec — a population described, not materialized
# ---------------------------------------------------------------------------

def _speed_frac(profiles: Sequence[DeviceProfile], i: int) -> float:
    """Profile i's speed rank among ``profiles`` (fastest 0, slowest 1)."""
    speeds = sorted(p.epoch_seconds for p in profiles)
    rank = speeds.index(profiles[i].epoch_seconds)
    return rank / max(len(profiles) - 1, 1)


@dataclass(frozen=True)
class FleetSpec:
    """Seeded description of a client population.

    Client k's profile is an iid draw from ``profiles`` weighted by
    ``profile_weights`` (``profile_index``). Its data is ``data_fn(k)``,
    or a ``BatchLoader`` over ``dataset``: ``"shared"`` draws from the
    whole dataset, ``"iid"`` from client k's ``iid_shard``. H^k and the
    capacity follow the profile's speed rank among ``profiles`` (fastest
    H_max and ``hi``, slowest H_min and ``lo``), O(#profiles) a client.
    """

    population: int
    profiles: Tuple[DeviceProfile, ...]
    profile_weights: Optional[Tuple[float, ...]] = None
    seed: int = 0
    dataset: Any = None
    batch_size: int = 4
    steps: int = 4
    partition: str = "shared"      # "shared" | "iid"
    data_fn: Optional[Callable[[int], Callable[[], Iterable]]] = None

    def __post_init__(self):
        if self.population < 1:
            raise ValueError(f"population must be >= 1, got "
                             f"{self.population}")
        if not self.profiles:
            raise ValueError("FleetSpec needs at least one DeviceProfile")
        if self.profile_weights is not None \
                and len(self.profile_weights) != len(self.profiles):
            raise ValueError(
                f"profile_weights ({len(self.profile_weights)}) must match "
                f"profiles ({len(self.profiles)})")
        if self.partition not in ("shared", "iid"):
            raise ValueError(f"partition must be 'shared' or 'iid', got "
                             f"{self.partition!r}")
        if self.data_fn is None and self.dataset is None:
            raise ValueError("FleetSpec needs a dataset or a data_fn")

    def profile_index(self, k: int) -> int:
        rng = np.random.default_rng((self.seed, 0x9E37, int(k)))
        p = None
        if self.profile_weights is not None:
            w = np.asarray(self.profile_weights, np.float64)
            p = w / w.sum()
        return int(rng.choice(len(self.profiles), p=p))

    def profile(self, k: int) -> DeviceProfile:
        return self.profiles[self.profile_index(k)]

    def iters(self, k: int, fed) -> int:
        frac = _speed_frac(self.profiles, self.profile_index(k))
        return int(round(fed.local_iters_max
                         - frac * (fed.local_iters_max
                                   - fed.local_iters_min)))

    def capacity(self, k: int, lo: float = 0.5, hi: float = 1.0) -> float:
        frac = _speed_frac(self.profiles, self.profile_index(k))
        return float(hi - frac * (hi - lo))

    def data(self, k: int, perm: np.ndarray | None = None,
             visit: int = 0):
        """Client k's fresh-iterator factory for its ``visit``-th
        sampling, a pure function of (spec, k, visit). ``perm`` reuses
        the dataset's IID permutation."""
        if self.data_fn is not None:
            return self.data_fn(k)
        indices = None
        if self.partition == "iid":
            indices = iid_shard(len(self.dataset), self.population, int(k),
                                seed=self.seed, perm=perm)
        seed = int(k) if visit == 0 else int(
            np.random.default_rng((self.seed, 0xDA7A, int(k), int(visit)))
            .integers(np.iinfo(np.int64).max))
        return BatchLoader(self.dataset, self.batch_size, self.steps,
                           seed=seed, indices=indices)


# ---------------------------------------------------------------------------
# Fleet — the runtime surface
# ---------------------------------------------------------------------------

class Fleet:
    """Client population handed to ``run_sync`` / ``run_async``.

    Resident (``from_lists``): profiles and loaders are the caller's
    sequences, held for the run; H^k and capacities by a fleet-wide
    argsort. Streaming (``from_spec``): a client's profile materializes
    into ``_cache`` when first asked for and ``release`` drops it;
    ``max_resident`` is the most clients held at once. Each ``data(k)``
    call is client k's next visit: ``_visits`` keeps one count a client
    ever visited, and the visit seeds the loader, so a client released
    and sampled again draws the stream it would have drawn resident.
    """

    def __init__(self, *, population: int, spec: FleetSpec | None = None,
                 profiles: Sequence[DeviceProfile] | None = None,
                 client_data: Sequence[Callable[[], Iterable]] | None = None):
        self.population = int(population)
        self.spec = spec
        self._profiles = list(profiles) if profiles is not None else None
        self._client_data = (list(client_data) if client_data is not None
                             else None)
        self._cache: dict = {}       # k -> DeviceProfile (resident state)
        self._visits: dict = {}      # k -> samplings so far (kept on release)
        self._pinned = False         # a materialized twin never releases
        self.max_resident = 0 if spec is not None else self.population
        self._iters_cache: dict = {}
        self._iid_perm: np.ndarray | None = None

    @classmethod
    def from_lists(cls, profiles: Sequence[DeviceProfile],
                   client_data: Sequence[Callable[[], Iterable]]) -> "Fleet":
        if len(profiles) != len(client_data):
            raise ValueError(
                f"fleet profiles ({len(profiles)}) and client_data "
                f"({len(client_data)}) must agree")
        if not len(profiles):
            raise ValueError("empty fleet")
        return cls(population=len(profiles), profiles=profiles,
                   client_data=client_data)

    @classmethod
    def from_spec(cls, spec: FleetSpec) -> "Fleet":
        """Streaming fleet: clients materialize on demand."""
        return cls(population=spec.population, spec=spec)

    @classmethod
    def resolve(cls, fleet, client_data, fed) -> "Fleet":
        """The fleet of a simulator call: a ``Fleet``, a ``FleetSpec``
        (streamed), or the deprecated parallel (profiles, client_data)
        pair; validated against ``fed`` (population and m)."""
        if isinstance(fleet, Fleet):
            if client_data is not None:
                raise ValueError(
                    "client_data must be None when passing a Fleet — the "
                    "Fleet already carries each client's data")
            out = fleet
        elif isinstance(fleet, FleetSpec):
            if client_data is not None:
                raise ValueError(
                    "client_data must be None when passing a FleetSpec")
            out = cls.from_spec(fleet)
        else:
            if client_data is None:
                raise ValueError(
                    "pass a Fleet/FleetSpec, or the legacy "
                    "(fleet profiles, client_data) sequence pair")
            warnings.warn(
                "run_sync/run_async with parallel fleet/client_data "
                "sequences is deprecated; pass "
                "Fleet.from_lists(profiles, client_data) (or a FleetSpec "
                "for streaming populations) instead",
                DeprecationWarning, stacklevel=3)
            out = cls.from_lists(fleet, client_data)
        if out.population != fed.num_clients:
            raise ValueError(
                f"fleet population ({out.population}) and fed.num_clients "
                f"({fed.num_clients}) must agree")
        m = getattr(fed, "clients_per_round", 0)
        if m < 0 or m > out.population:
            raise ValueError(
                f"fed.clients_per_round ({m}) must be in "
                f"[0, population={out.population}]")
        return out

    def materialize(self) -> "Fleet":
        """Resident twin of a streaming fleet: every client's profile
        built up front and pinned (``release`` does nothing). Data still
        follows the spec's (k, visit) rule, so any sampling pattern draws
        the streaming fleet's batches. Small populations only."""
        if self.spec is None:
            return self
        out = Fleet(population=self.population, spec=self.spec)
        for k in range(self.population):
            out._materialize_client(k)
        out._pinned = True
        return out

    def _perm(self):
        """The dataset's IID permutation, drawn once a fleet."""
        if self.spec is not None and self.spec.partition == "iid" \
                and self.spec.data_fn is None and self._iid_perm is None:
            self._iid_perm = np.random.default_rng(
                self.spec.seed).permutation(len(self.spec.dataset))
        return self._iid_perm

    def _materialize_client(self, k: int):
        if k not in self._cache:
            self._cache[k] = self.spec.profile(k)
            self.max_resident = max(self.max_resident, len(self._cache))
        return self._cache[k]

    def profile(self, k: int) -> DeviceProfile:
        if self._profiles is not None:
            return self._profiles[k]
        return self._materialize_client(k)

    def data(self, k: int) -> Callable[[], Iterable]:
        """Client k's fresh-iterator factory: a list fleet's own
        (stateful) loader; a spec fleet's loader for k's next visit, so
        every call counts as one."""
        if self._client_data is not None:
            return self._client_data[k]
        self._materialize_client(k)
        visit = self._visits.get(k, 0)
        self._visits[k] = visit + 1
        return self.spec.data(k, perm=self._perm(), visit=visit)

    def iters(self, k: int, fed) -> int:
        """Resource-aware H^k ∈ [H_min, H_max]: a spec fleet ranks k's
        profile among the spec's; a list fleet argsorts epoch_seconds
        fleet-wide (ties by position), fastest gets H_max."""
        if self.spec is not None:
            return self.spec.iters(k, fed)
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
        if self.spec is not None:
            return self.spec.capacity(k, lo, hi)
        key = ("capacity", lo, hi)
        if key not in self._iters_cache:
            order = np.argsort([p.epoch_seconds for p in self._profiles])
            caps = np.empty(self.population, np.float64)
            for rank, j in enumerate(order):
                frac = rank / max(self.population - 1, 1)
                caps[int(j)] = hi - frac * (hi - lo)
            self._iters_cache[key] = caps
        return float(self._iters_cache[key][k])

    @property
    def resident(self) -> int:
        """Clients holding materialized state now."""
        if self.spec is None:
            return self.population
        return len(self._cache)

    def release(self, ks) -> None:
        """Drop the state of clients leaving the sampled / in-flight set
        (a list fleet or a materialized twin keeps everyone)."""
        if self.spec is None or self._pinned:
            return
        for k in np.atleast_1d(ks):
            self._cache.pop(int(k), None)

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

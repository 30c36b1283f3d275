"""Device meshes (port of ``repro/launch/mesh.py``): the LM's production
and host meshes and the fleet mesh of the sharded federated sync round.

The reference's "devices of this host" are here the ranks of the default
``torch.distributed`` process group. Launched by ``torchrun``, that is
the launched world, each rank on ``cuda:LOCAL_RANK`` (or the CPU). With
no process group, ``init_world`` makes a world of one in-process: a
``HashStore``, rank 0, world size 1. One group serves both device types
(gloo for CPU tensors, NCCL for CUDA ones where NCCL is built), so a
process can hold CPU and CUDA meshes at once.

A world the dry run made (``launch/dryrun.py::fake_world``: the ``fake``
backend of ``torch.testing``, no transport) serves any device type.

The LM's meshes are ``("data", "model")`` (or ``("pod", "data",
"model")``) ``DeviceMesh``es over those ranks, row-major: rank
r = (d, m) sits at d·M + m. Every mesh covers the whole process group; one
of another size raises, as the reference's ``jax.make_mesh`` does when
the devices are not there. Functions, not module constants: importing
this module touches no process group.
"""
from __future__ import annotations

import datetime
import math
import os

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

# a lost rank fails its collective after this long instead of hanging
GROUP_TIMEOUT = datetime.timedelta(seconds=60)

# init_device_mesh makes new process groups (a collective) at every call:
# one mesh per (world, device type, shape) for the process's life
_MESHES: dict = {}


def launched() -> bool:
    """Whether a launcher (``torchrun``) started this process as a rank."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def _backend() -> str:
    return "cpu:gloo,cuda:nccl" if dist.is_nccl_available() else "gloo"


def init_world(device=None) -> torch.device:
    """Make the default process group if there is none, and return this
    rank's device: ``device`` as ``resolve_device`` reads it (the card
    unless the CPU is asked for), ``cuda:LOCAL_RANK`` under a launcher."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        if launched() and dev.index is None:
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        elif dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        if launched():
            dist.init_process_group(_backend(), timeout=GROUP_TIMEOUT)
        else:
            dist.init_process_group(_backend(), store=dist.HashStore(),
                                    rank=0, world_size=1,
                                    timeout=GROUP_TIMEOUT)
    need = "nccl" if dev.type == "cuda" else "gloo"
    if need not in dist.get_backend() and dist.get_backend() != "fake":
        raise ValueError(
            f"the process group's backend {dist.get_backend()!r} has no "
            f"{need} for {dev.type} tensors")
    return dev


def rank() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def make_fleet_mesh(n: int | None = None, edges: int | None = None,
                    device=None):
    """``DeviceMesh`` of the sharded federated sync round.

    Default (``edges=None``): the 1-D ``("clients",)`` mesh over every
    rank of the process group (``init_world``: a world of one unless a
    launcher started more), over which the round's client axis splits
    (``core/fed_engine.py::ShardedSyncRound``; specs in
    ``sharding.specs.fed_round_specs``). ``n`` must be the world size: a
    mesh never quietly shrinks or grows.

    ``edges`` asks for the two-level ``("edge", "clients")`` mesh of the
    hierarchical edge-aggregator tree: ``edges`` edge aggregators, each
    owning ``n // edges`` client shards (clients reduce to their edge,
    edges to the server). ``edges=0`` picks the largest divisor of the
    size ≤ its square root: 1 rank gives (1, 1), 4 ranks (2, 2).

    The mesh lies on ``device``'s type (``resolve_device``: the card
    unless the CPU is asked for). The same arguments in one process give
    the same mesh object.
    """
    from torch.distributed.device_mesh import init_device_mesh
    dev = init_world(device)
    world = dist.get_world_size()
    if n is None:
        n = world
    if n != world:
        raise ValueError(
            f"a fleet mesh of {n} needs a process group of {n} ranks; this "
            f"one has {world} (start the ranks with torchrun)")
    if edges == 0:
        edges = max(e for e in range(1, int(n ** 0.5) + 1) if n % e == 0)
    if edges is not None and (edges < 1 or n % edges):
        raise ValueError(
            f"edges ({edges}) must be a positive divisor of the device "
            f"count ({n})")
    key = (dist.group.WORLD, dev.type, n, edges)
    if key not in _MESHES:
        if edges is None:
            _MESHES[key] = init_device_mesh(dev.type, (n,),
                                            mesh_dim_names=("clients",))
        else:
            _MESHES[key] = init_device_mesh(
                dev.type, (edges, n // edges),
                mesh_dim_names=("edge", "clients"))
    return _MESHES[key]


def make_mesh(shape, axis_names, device=None):
    """A ``DeviceMesh`` of ``shape`` over every rank of the process group
    (``init_world``), its dims named ``axis_names``; the counterpart of
    ``jax.make_mesh``. ``prod(shape)`` must be the world size. The same
    arguments in one process give the same mesh object."""
    from torch.distributed.device_mesh import init_device_mesh
    shape, axis_names = tuple(int(n) for n in shape), tuple(axis_names)
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} and axes {axis_names} differ "
                         "in length")
    dev = init_world(device)
    world = dist.get_world_size()
    size = math.prod(shape)
    if size != world:
        raise ValueError(
            f"a {shape} mesh needs a process group of {size} ranks; this "
            f"one has {world} (start the ranks with torchrun)")
    key = (dist.group.WORLD, dev.type, shape, axis_names)
    if key not in _MESHES:
        _MESHES[key] = init_device_mesh(dev.type, shape,
                                        mesh_dim_names=axis_names)
    return _MESHES[key]


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """One pod: 16 x 16 = 256 ranks ``("data", "model")``. Two pods:
    2 x 16 x 16 = 512 ranks ``("pod", "data", "model")``. Raises unless
    the process group has that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def make_host_mesh(device=None):
    """Every rank of the process group on the data axis: ``(world, 1)``
    over ``("data", "model")`` (a world of one: the (1, 1) mesh)."""
    init_world(device)
    return make_mesh((dist.get_world_size(), 1), ("data", "model"), device)


def destroy_world() -> None:
    """Destroy the default process group and forget its meshes and the
    sharded round engines built on them (a launched rank's exit)."""
    from repro_torch.core import fed_engine
    _MESHES.clear()
    fed_engine.drop_sharded_engines()
    if dist.is_initialized():
        dist.destroy_process_group()

"""Placements and level-by-level collectives of the sharded federated sync
round (port of ``repro/sharding/specs.py::fed_round_specs``).

The reference's round is a ``shard_map``: per-client operands (batch
stacks (n, H_max, ...), weights (n,), the H^k vector, losses, states)
shard their leading client axis over the mesh's client axes, and
fleet-global ones (params, mask, the new global) replicate; its weighted
average is a ``psum`` per mesh axis. Here the same split is a
``DeviceMesh`` and a rank's block of the client axis, the ``psum`` per
level is one ``all_reduce`` per level on ``mesh.get_group(level)``,
innermost first, and the replicated per-client outputs are gathered
level by level. ``fed_round_specs`` names the split as
``torch.distributed.tensor`` placements, the counterpart of ``P(axis)``
and ``P()``.

The LM rules (``param_pspecs``, ``batch_pspecs``, ``cache_pspecs``,
``token_pspec``, ``named``, ``data_axes``) are ROADMAP Queue 1 item 13's
LM half.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch import trees

# all_gather_into_tensor was renamed all_gather_single in later torch
_all_gather = (getattr(dist, "all_gather_single", None)
               or dist.all_gather_into_tensor)


def fed_round_specs(mesh) -> dict:
    """The sharded round's split of ``mesh``.

    ``"axis"``: the client axis, ``"clients"`` on a 1-D mesh, or on the
    hierarchical ``("edge", "clients")`` mesh
    (``launch.mesh.make_fleet_mesh(edges=...)``) that tuple, outermost
    first: shard (e, c) holds edge aggregator e's c-th block of clients,
    and the round reduces level by level (clients → edge, edge →
    server). ``"clients"``: the placements of a per-client tensor, its
    leading dim split over the client axes (``Shard(0)`` on each);
    ``"replicated"``: those of a fleet-global one (``Replicate()`` on
    each mesh dim).
    """
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    if {"edge", "clients"} <= set(names):
        axis = ("edge", "clients")
    else:
        axis = "clients" if "clients" in names else names[0]
    split = axis if isinstance(axis, tuple) else (axis,)
    return {"axis": axis,
            "clients": tuple(Shard(0) if n in split else Replicate()
                             for n in names),
            "replicated": tuple(Replicate() for _ in names)}


def levels(mesh) -> tuple:
    """The reduction's levels, innermost (leaf aggregators) first."""
    axis = fed_round_specs(mesh)["axis"]
    return tuple(reversed(axis)) if isinstance(axis, tuple) else (axis,)


def shard_index(mesh) -> tuple:
    """(this rank's block of the client axis, the number of blocks):
    block e·C + c for coordinate (e, c), the row-major order in which
    ``Shard(0)`` on every client dim lays the axis out."""
    names = tuple(mesh.mesh_dim_names)
    coord = dict(zip(names, mesh.get_coordinate()))
    axis = fed_round_specs(mesh)["axis"]
    index, count = 0, 1
    for name in (axis if isinstance(axis, tuple) else (axis,)):
        size = mesh.size(names.index(name))
        index, count = index * size + coord[name], count * size
    return index, count


def _leaves(tree) -> list:
    """``tree``'s tensors in ``trees.tree_map``'s order, the order in
    which it rebuilds the tree."""
    out: list = []
    trees.tree_map(out.append, tree)
    return out


def psum_levels(tree, mesh):
    """Σ over the mesh of ``tree``'s leaves, level by level, innermost
    first: the leaves go into one f32 buffer, so each level is one
    ``all_reduce``, and come back in their own dtypes. An empty tree
    comes back as it is."""
    leaves = _leaves(tree)
    if not leaves:
        return tree
    flat = torch.cat([x.reshape(-1).float() for x in leaves])
    for level in levels(mesh):
        dist.all_reduce(flat, group=mesh.get_group(level))
    parts = iter(flat.split([x.numel() for x in leaves]))
    return trees.tree_map(
        lambda x: next(parts).reshape(x.shape).to(x.dtype), tree)


def gather_levels(tree, mesh):
    """Every rank's block of the per-client leaves of ``tree`` (each
    (b, ...)), gathered in shard order into (b · shards, ...) on every
    rank. The leaves' bytes go into one uint8 buffer of a row a client,
    so each level is one ``all_gather``, innermost first, and any dtype
    (a bool mask, an f32 variate) comes back bit for bit."""
    leaves = _leaves(tree)
    if not leaves:
        return tree
    b = leaves[0].shape[0]
    rows = [x.contiguous().view(torch.uint8).reshape(b, -1) for x in leaves]
    buf = torch.cat(rows, dim=1)
    for level in levels(mesh):
        group = mesh.get_group(level)
        out = buf.new_empty((buf.shape[0] * dist.get_world_size(group),
                             buf.shape[1]))
        _all_gather(out, buf, group=group)
        buf = out
    parts = iter(buf.split([r.shape[1] for r in rows], dim=1))
    return trees.tree_map(
        lambda x: next(parts).contiguous().view(x.dtype).reshape(
            (buf.shape[0],) + tuple(x.shape[1:])), tree)

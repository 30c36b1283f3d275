"""Sharding rules of the port (port of ``repro/sharding/specs.py``): the
placements and level-by-level collectives of the sharded federated sync
round, and the LM's partition rules on the ``("data", "model")`` and
``("pod", "data", "model")`` meshes.

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
``token_pspec``) give each leaf a ``P``: for each tensor dim ``None``, a
mesh axis name, or a tuple of names (the dim split over each, outermost
first), the reference's ``PartitionSpec``. Every rule is
divisibility-guarded: a dim is split only when the axes divide it, else it
replicates. They read a mesh's axis names and sizes only
(``mesh_dim_names``, ``shape``), so they run on a ``DeviceMesh`` and on a
``MeshShape`` stand-in (the production meshes without their 256 or 512
ranks). ``named`` turns specs into ``torch.distributed.tensor``
placements, one a mesh dim; ``place`` distributes plain tensors by them,
the counterpart of ``jax.device_put`` with a ``NamedSharding``.

The helpers at the end cross between a rank's local tensors and the
mesh inside the LM's forward (``launch/steps.py`` on the layers above):
``NamedSpec`` binds a spec to its mesh (a ``PartitionSpec`` under a mesh
context); ``shard_rows`` / ``gather_rows`` redistribute the residual
stream between its sequence-sharded storage and the rank's whole rows;
``psum_axes`` sums over mesh axes with DTensor's ``Partial`` (an
identity backward: every rank already holds the summed value's
gradient).

Tensor-parallel compute (the last section): ``compute_layout`` says, for
each param leaf, whether a layer computes on the rank's ``"model"`` block
of it (a ``Split``: the query heads and the kv heads they read, the
``d_ff`` columns, the experts, the vocabulary rows, the SSM mixer's
``out_proj`` rows), reads the rank's SSD heads' columns of a leaf it
gathers (a ``Pick``: the rest of the SSM mixer) or gathers it over
``"model"``; ``MeshSplit`` runs a step by it on the rank's stored blocks,
with the autograd collectives of Megatron-LM's tensor and sequence
parallelism (all-gather / reduce-scatter pairs over ``"model"``, the
params' all-gather over the data axes whose backward sums the gradient
over them).
"""
from __future__ import annotations

import math
from typing import NamedTuple

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


# ---------------------------------------------------------------------------
# The LM's partition rules
# ---------------------------------------------------------------------------

class P(tuple):
    """A partition spec: for each tensor dim ``None``, an axis name, or a
    tuple of axis names (the dim split over each, outermost first). Equal
    to any tuple of the same entries; ``P()`` replicates every dim."""

    def __new__(cls, *dims):
        return super().__new__(cls, dims)

    def __repr__(self) -> str:
        return "P(" + ", ".join(map(repr, self)) + ")"


class MeshShape:
    """A mesh's axis names and sizes without its ranks (the reference's
    ``AbstractMesh``): enough for the rules, which read nothing else."""

    def __init__(self, shape, names):
        self.shape, self.mesh_dim_names = tuple(shape), tuple(names)

    def __repr__(self) -> str:
        return f"MeshShape({self.shape}, {self.mesh_dim_names})"


def _sizes(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def data_axes(mesh) -> tuple:
    """The batch-parallel axes present in a mesh."""
    names = mesh.mesh_dim_names
    return tuple(a for a in ("pod", "data") if a in names)


def _flat(axes: tuple):
    """The reference's spelling of a set of axes: one name alone, a tuple
    of several, None for none."""
    return axes if len(axes) > 1 else (axes[0] if axes else None)


def _axis_size(mesh, name) -> int:
    if isinstance(name, tuple):
        s = 1
        for n in name:
            s *= _axis_size(mesh, n)
        return s
    return _sizes(mesh).get(name, 0)


def _maybe(mesh, axis, dim: int):
    """axis if it divides dim (and exists), else None."""
    size = _axis_size(mesh, axis)
    if size and dim % size == 0:
        return axis
    return None


def _spec_for(mesh, key: str, shape, fsdp: bool = True) -> P:
    """The rule table, keyed by the parts of a param's flat path
    (``layers/attn/wq`` -> ``["layers", "attn", "wq"]``), as the
    reference's is by its pytree path. The tensor-parallel dim splits over
    ``"model"``; with ``fsdp`` the other large dim also splits over the
    data axes (ZeRO-3). Stacked layers (``layers/``, ``enc_layers/``,
    ``dec_layers/``) keep their leading L dim whole."""
    keys = key.split("/")
    name = keys[-1]
    shape = tuple(shape)
    m = lambda dim: _maybe(mesh, "model", dim)  # noqa: E731
    dp_flat = _flat(data_axes(mesh))

    def d(dim):
        if not fsdp or dp_flat is None:
            return None
        return _maybe(mesh, dp_flat, dim)

    # ---- embeddings / heads ----
    if name == "embed":
        return P(m(shape[0]), d(shape[1]))
    if name == "lm_head":
        return P(d(shape[0]), m(shape[1]))

    stacked = bool({"layers", "enc_layers", "dec_layers"} & set(keys))
    off = 1 if stacked else 0

    def lead(*rest):
        return P(*(((None,) * off) + rest))

    # ---- attention ----
    if len(keys) >= 2 and keys[-2] in ("attn", "xattn"):
        if name in ("wq", "wk", "wv"):
            return lead(d(shape[-2]), m(shape[-1]))
        if name == "wo":
            return lead(m(shape[-2]), d(shape[-1]))

    # ---- dense / shared-expert MLP ----
    if name in ("wg", "wi", "shared_wg", "shared_wi") \
            and len(shape) == 2 + off:
        return lead(d(shape[-2]), m(shape[-1]))
    if name in ("wo", "shared_wo") and len(shape) == 2 + off:
        return lead(m(shape[-2]), d(shape[-1]))

    # ---- MoE experts: expert-parallel when E divides, else 2-D tensor ----
    if name in ("wg", "wi") and len(shape) == 3 + off:
        e = m(shape[off])
        if e is not None:
            return lead(e, d(shape[-2]), None)
        return lead(None, d(shape[-2]), m(shape[-1]))
    if name == "wo" and len(shape) == 3 + off:
        e = m(shape[off])
        if e is not None:
            return lead(e, None, d(shape[-1]))
        return lead(None, m(shape[-2]), d(shape[-1]))
    if name == "router":
        return lead(None, None)

    # ---- SSM ----
    if name == "in_proj":
        return lead(d(shape[-2]), m(shape[-1]))
    if name == "out_proj":
        return lead(m(shape[-2]), d(shape[-1]))

    # ---- everything else (norms, convs, biases) replicates ----
    return P()


def _shape(leaf) -> tuple:
    """A tensor's shape, or a shape given as a tuple."""
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)


def param_pspecs(mesh, cfg, params: dict, fsdp: bool = True) -> dict:
    """Flat dict of ``P`` matching a flat param dict (tensors, meta
    tensors or shapes)."""
    return {k: _spec_for(mesh, k, _shape(v), fsdp=fsdp)
            for k, v in params.items()}


def _dp(mesh):
    """(the data axes in the reference's spelling, their size)."""
    axes = data_axes(mesh)
    return _flat(axes), math.prod(_sizes(mesh)[a] for a in axes)


def batch_pspecs(mesh, cfg, batch: dict) -> dict:
    """The batch dim splits over the data axes when they divide it; every
    other dim (an embedding input's features too) replicates."""
    dp, dp_size = _dp(mesh)

    def spec(leaf):
        shape = _shape(leaf)
        lead = dp if shape[0] % max(dp_size, 1) == 0 else None
        return P(*((lead,) + (None,) * (len(shape) - 1)))

    return {k: spec(v) for k, v in batch.items()}


def cache_pspecs(mesh, cfg, cache: dict, global_batch: int) -> dict:
    """Serving cache placements. Batched decode: the batch dim over the
    data axes, the K/V sequence dim and the SSM heads over ``"model"``.
    One sequence (batch 1, or a batch the data axes do not divide): the
    K/V sequence dim over ``("data", "model")`` (or ``"data"``) and the
    attend combines across them (flash-decoding); SSM states split their
    heads, or the conv state its channels, over ``"model"``. The leading
    L dim never splits."""
    dp, dp_size = _dp(mesh)
    batch_sharded = global_batch % max(dp_size, 1) == 0 and global_batch > 1

    def spec(name, shape):
        if name in ("k_win", "v_win"):
            # ring buffers: their sequence dim is the window; batch only
            return P(None, dp if batch_sharded else None, None, None, None)
        if name in ("k", "v", "enc_k", "enc_v"):          # (L, B, S, KV, hd)
            if batch_sharded:
                return P(None, dp, _maybe(mesh, "model", shape[2]), None,
                         None)
            return P(None, None, _maybe(mesh, ("data", "model"), shape[2])
                     or _maybe(mesh, "data", shape[2]), None, None)
        if name == "ssm_state":                           # (L, B, H, P, N)
            return P(None, dp if batch_sharded else None,
                     _maybe(mesh, "model", shape[2]), None, None)
        if name == "conv_state":                          # (L, B, K-1, C)
            if batch_sharded:
                return P(None, dp, None, None)
            return P(None, None, None, _maybe(mesh, "model", shape[3]))
        raise ValueError(f"unknown cache leaf {name}")

    return {k: spec(k, _shape(v)) for k, v in cache.items()}


def token_pspec(mesh, global_batch: int) -> P:
    dp, dp_size = _dp(mesh)
    if global_batch % max(dp_size, 1) == 0 and global_batch > 1:
        return P(dp)
    return P(None)


def placements(mesh, spec) -> tuple:
    """One spec's DTensor placements, one a mesh dim: ``Shard(d)`` on each
    mesh dim that splits tensor dim d, ``Replicate()`` on the others. A
    tuple of axes on one dim must name them in the mesh's order
    (outermost first), the order in which ``Shard`` nests them."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for dim, axes in enumerate(spec):
        if axes is None:
            continue
        axes = axes if isinstance(axes, tuple) else (axes,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"{spec}: axes {axes} out of the mesh's order "
                             f"{names}")
        for i in idx:
            out[i] = Shard(dim)
    return tuple(out)


def named(mesh, spec_tree):
    """``spec_tree`` (a ``P``, or a dict / tuple / list of them; None stays
    None) with each ``P`` replaced by its placements on ``mesh``."""
    if isinstance(spec_tree, P):
        return placements(mesh, spec_tree)
    if isinstance(spec_tree, dict):
        return {k: named(mesh, v) for k, v in spec_tree.items()}
    if isinstance(spec_tree, (list, tuple)):
        return type(spec_tree)(named(mesh, v) for v in spec_tree)
    return spec_tree


def place(mesh, tree, specs):
    """The plain tensors of ``tree`` (a tensor or a dict of them) as
    DTensors on ``mesh`` laid out by ``specs``: each rank keeps its own
    block of the tensor it holds, so every rank must hold the same
    values (as ``init_params`` from one seed, or a converted checkpoint,
    gives them). A leaf that already is a DTensor is redistributed."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    if isinstance(tree, dict):
        return {k: place(mesh, v, specs[k]) for k, v in tree.items()}
    pl = placements(mesh, specs)
    if isinstance(tree, DTensor):
        return tree.redistribute(mesh, pl)
    return distribute_tensor(tree, mesh, pl, src_data_rank=None)


# ---------------------------------------------------------------------------
# Between a rank's local tensors and the mesh
# ---------------------------------------------------------------------------

class NamedSpec:
    """A ``P`` bound to its mesh: the port's ``PartitionSpec`` under a mesh
    context (``launch.steps.act_pspec``)."""

    def __init__(self, mesh, spec: P):
        self.mesh, self.spec = mesh, P(*spec)

    def __repr__(self) -> str:
        return f"NamedSpec({self.spec}, {tuple(self.mesh.mesh_dim_names)})"


def _even_spec(mesh, spec, shape) -> P:
    """``spec`` with every dim its axes do not divide replicated (the
    divisibility guard, at the tensor's own sizes)."""
    return P(*(a if a is None or dim % _axis_size(mesh, a) == 0 else None
               for a, dim in zip(spec, shape)))


def shard_rows(x, act):
    """A rank's whole rows ``x`` (plain, the same on every rank of the axes
    that do not split the batch) -> the DTensor laid out by ``act`` (a
    ``NamedSpec``): a dim the spec splits over ``"model"`` keeps this
    rank's block, a local slice whose backward gathers."""
    from torch.distributed.tensor import DTensor
    mesh = act.mesh
    spec = P(act.spec[0], *_even_spec(mesh, act.spec[1:], x.shape[1:]))
    rows = P(spec[0], *[None] * (len(spec) - 1))     # the batch dim only
    rows = DTensor.from_local(x, mesh, placements(mesh, rows),
                              run_check=False)
    return rows.redistribute(mesh, placements(mesh, spec))


def gather_rows(x):
    """The DTensor of ``shard_rows`` -> the rank's whole rows, plain: an
    all-gather over the axes that split the other dims, whose backward
    keeps this rank's block of the gradient."""
    from torch.distributed.tensor import Replicate, Shard
    keep = tuple(p if isinstance(p, Shard) and p.dim == 0 else Replicate()
                 for p in x.placements)
    return x.redistribute(x.device_mesh, keep).to_local()


def psum_axes(x, mesh, axes):
    """Σ of the plain ``x`` over the ranks of the mesh ``axes`` (a name, a
    tuple of names, or None for none), the same on every rank. Its
    backward is the identity: each rank's ``x`` receives the sum's
    gradient, which every rank holds."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    axes = () if axes is None else (axes if isinstance(axes, tuple)
                                    else (axes,))
    if not axes:
        return x
    names = tuple(mesh.mesh_dim_names)
    pl = tuple(Partial() if n in axes else Replicate() for n in names)
    return DTensor.from_local(x, mesh, pl, run_check=False).full_tensor()


# ---------------------------------------------------------------------------
# Tensor-parallel compute over "model"
# ---------------------------------------------------------------------------

class Split(NamedTuple):
    """How a leaf meets ``"model"`` in a layer's compute: the layer reads
    block ``coord // ranks`` of the ``M // ranks`` equal blocks of tensor
    dim ``dim`` (negative, so a stacked leaf and its layer's slice
    agree). ``ranks`` 1: the rank's own stored block, never gathered over
    ``"model"``; ``ranks`` > 1: that many neighbouring ranks read one
    block (the kv head of their query group, where ``"model"``
    outnumbers the kv heads), gathered over ``"model"`` and sliced."""
    dim: int
    ranks: int = 1


class Pick(NamedTuple):
    """How an SSM mixer's leaf meets ``"model"`` when the layer computes
    on the rank's block of SSD heads: the leaf is gathered over
    ``"model"`` (or replicated there) and the layer reads, of each
    segment ``(width, split)`` along tensor dim ``dim``, the rank's
    ``width / M`` block where ``split``, the whole segment otherwise (the
    B and C columns every head reads). Its gradient is zero outside what
    the rank read; the gather's backward sums the ranks' parts."""
    dim: int
    parts: tuple


def compute_layout(mesh, cfg, params, moe_fullgrid: bool = False) -> dict:
    """``{key: Split, Pick or None}`` over a flat param dict (tensors or
    shapes): how each leaf meets ``"model"`` in the LM's train and
    scoring forward (``MeshSplit``). None: gathered over ``"model"``, its
    compute replicated there. The splits are ``param_pspecs``'
    tensor-parallel dims under the reference's divisibility guards:

    - attention by whole query heads when ``"model"`` divides
      ``num_heads`` and either divides ``num_kv_heads`` (each rank its
      kv heads) or is a multiple of it (each rank reads the kv head of
      its query group: ``Split(-1, M // KV)``), in every stack
      (``layers``, the encoder-decoder's ``enc_layers`` and
      ``dec_layers``), the decoder's cross-attention (``xattn``) too;
    - the MLP and the shared expert by ``d_ff`` columns when ``"model"``
      divides ``d_ff``, in every stack;
    - the MoE experts over ``"model"`` when it divides E (expert
      parallel), else by each expert's ``d_ff`` columns (the rule's two
      branches), with ``moe_fullgrid`` or without: its dispatch splits
      the tokens over ``"model"`` too, and the rank's buffer meets the
      stored blocks by an all-to-all or a gather along its capacity
      (``models/moe.py``);
    - ``embed`` / ``lm_head`` by vocabulary rows when ``"model"``
      divides V;
    - the SSM mixer by blocks of whole SSD heads when ``"model"`` divides
      ``n_heads = expand · d_model / head_dim`` (the guard of the decode
      state's split, ``cache_pspecs``): ``out_proj`` by its rows, the
      rank's stored block (``Split(-2)``); ``in_proj`` (gathered: its
      stored column blocks do not align with the heads), the conv and
      the per-head and per-channel vectors a ``Pick`` of the rank's z, x
      and dt columns, x channels, heads and norm columns beside every B
      and C column (``MeshSplit.ssm_heads``).

    Every other leaf (norms, the router, any leaf of a mesh whose
    ``"model"`` has one rank) is None.
    """
    out = {k: None for k in params}
    M = _axis_size(mesh, "model")
    if M <= 1:
        return out

    def put(keys, dim, ranks=1):
        for k in keys:
            if k in out:
                out[k] = Split(dim, ranks)

    H, KV, f = cfg.num_heads, cfg.num_kv_heads, cfg.d_ff
    for st in ("layers", "enc_layers", "dec_layers"):
        if H and H % M == 0 and (KV % M == 0 or M % KV == 0):
            for blk in ("attn", "xattn"):
                put((f"{st}/{blk}/wq",), -1)
                put((f"{st}/{blk}/wo",), -2)
                put((f"{st}/{blk}/wk", f"{st}/{blk}/wv"), -1,
                    1 if KV % M == 0 else M // KV)
        if f % M == 0:
            put((f"{st}/mlp/wg", f"{st}/mlp/wi", f"{st}/moe/shared_wg",
                 f"{st}/moe/shared_wi"), -1)
            put((f"{st}/mlp/wo", f"{st}/moe/shared_wo"), -2)
    if cfg.moe is not None:
        if cfg.moe.num_experts % M == 0:
            put(("layers/moe/wg", "layers/moe/wi", "layers/moe/wo"), -3)
        elif f % M == 0:
            put(("layers/moe/wg", "layers/moe/wi"), -1)
            put(("layers/moe/wo",), -2)
    if cfg.vocab_size % M == 0:
        put(("embed",), -2)
        put(("lm_head",), -1)
    ssm = cfg.ssm if cfg.family in ("ssm", "hybrid") else None
    di = ssm.expand * cfg.d_model if ssm else 0
    nh = di // ssm.head_dim if ssm else 0
    if nh and nh % M == 0:
        put(("layers/ssm/out_proj",), -2)
    specs = param_pspecs(mesh, cfg, params)
    for k, s in out.items():
        if s is not None and s.ranks == 1 and specs[k][s.dim] != "model":
            raise ValueError(f"{k}: the layout computes on the model block "
                             f"of dim {s.dim}, which {specs[k]} does not "
                             "store")
    if nh and nh % M == 0:
        BC = (2 * ssm.d_state, False)
        for keys, parts in (
                (("in_proj",), ((di, True), (di, True), BC, (nh, True))),
                (("conv_w", "conv_b"), ((di, True), BC)),
                (("A_log", "D", "dt_bias"), ((nh, True),)),
                (("norm",), ((di, True),))):
            for k in keys:
                if f"layers/ssm/{k}" in out:
                    out[f"layers/ssm/{k}"] = Pick(-1, parts)
    return out


def _wait(x):
    return torch.ops._c10d_functional.wait_tensor(x)


def _gather_along(x, dim: int, group):
    """All-gather ``x`` over ``group`` along ``dim``, the ranks' blocks in
    rank order."""
    t = x.movedim(dim, 0).contiguous()
    out = _wait(torch.ops._c10d_functional.all_gather_into_tensor(
        t, group.size(), group.group_name))
    return out if dim == 0 else out.movedim(0, dim).contiguous()


def _scatter_along(x, dim: int, group):
    """Reduce-scatter (sum) ``x`` over ``group`` along ``dim``: the rank's
    block of the sum."""
    t = x.movedim(dim, 0).contiguous()
    out = _wait(torch.ops._c10d_functional.reduce_scatter_tensor(
        t, "sum", group.size(), group.group_name))
    return out if dim == 0 else out.movedim(0, dim).contiguous()


def _sum_over(x, groups, op: str = "sum"):
    for g in groups:
        x = _wait(torch.ops._c10d_functional.all_reduce(x.contiguous(), op,
                                                        g.group_name))
    return x


class _AllGather(torch.autograd.Function):
    """All-gather along a dim; backward reduce-scatters (sums) the
    gradient back to the rank's block."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gather_along(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _scatter_along(g, ctx.dim, ctx.group), None, None


def _all_to_all(x, group):
    """All-to-all over ``group`` on equal blocks of dim 0: block j goes
    to rank j, and the blocks received stand in the senders' order."""
    n = group.size()
    if x.shape[0] % n:
        raise ValueError(f"dim 0 of {tuple(x.shape)} does not split over "
                         f"{n} ranks")
    sizes = [x.shape[0] // n] * n
    return _wait(torch.ops._c10d_functional.all_to_all_single(
        x.contiguous(), sizes, sizes, group.group_name))


class _AllToAll(torch.autograd.Function):
    """All-to-all along dim 0 (``_all_to_all``); backward the inverse
    all-to-all, which sends each block's gradient back to its sender."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


class _ReduceScatter(torch.autograd.Function):
    """Reduce-scatter of a partial sum along a dim; backward all-gathers
    the gradient."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _scatter_along(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _gather_along(g, ctx.dim, ctx.group), None, None


class _AllReduce(torch.autograd.Function):
    """Σ over ``groups``. Backward: the identity (``sum_grad`` False: the
    sum feeds values whose gradient each rank holds whole, as a loss's)
    or the same sum (a partial sum entering a layer's replicated
    compute, whose gradients are parts)."""

    @staticmethod
    def forward(ctx, x, groups, sum_grad):
        ctx.groups, ctx.sum_grad = groups, sum_grad
        return _sum_over(x, groups)

    @staticmethod
    def backward(ctx, g):
        return (_sum_over(g, ctx.groups) if ctx.sum_grad else g), None, None


class _SumGrad(torch.autograd.Function):
    """The identity; backward sums the gradient over ``groups``."""

    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum_over(g, ctx.groups), None


class _Owned(torch.autograd.Function):
    """``x`` (``keep`` or ``value``) or zeros; backward the gradient where
    ``keep``, zeros elsewhere. Every rank keeps the same graph, so the
    collectives of the backward pass run alike on all of them."""

    @staticmethod
    def forward(ctx, x, keep, value):
        ctx.keep = keep
        return x.view_as(x) if keep or value else torch.zeros_like(x)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.keep else torch.zeros_like(g)), None, None


class MeshSplit:
    """One step's compute on ``mesh`` laid out by ``compute_layout``:
    Megatron-LM's tensor parallelism, with its sequence parallelism when
    ``seq`` (Shoeybi et al. 2019; Korthikanti et al. 2022), on each
    rank's stored blocks (``specs``: ``param_pspecs``).

    Between layers the residual stream is the rank's rows (its block of
    the batch over the data axes), their sequence dim split over
    ``"model"`` when ``seq`` and ``"model"`` divides it (the reference's
    ``act_pspec``), else whole on every ``"model"`` rank. A layer
    ``enter``s it (an all-gather over ``"model"``), computes on the
    rank's blocks, and leaves by ``exit_partial`` (a row-parallel
    product's partial sum, reduce-scattered back to the sequence split,
    or all-reduced without it) or ``exit_replicated`` (the output of
    leaves gathered over ``"model"``, of which the rank keeps its
    sequence block).

    Gradients: inside a layer a value that every ``"model"`` rank holds
    alike carries, on each rank, a part of its gradient, the parts
    summing to the whole over ``"model"`` (so the all-gather's backward
    is a reduce-scatter). The leaves come from ``gather``: the rank's
    stored block all-gathered over the axes the layer does not compute
    on its block of, whose backward reduce-scatters the gradient back to
    the block and sums it over the mesh's other axes (the data axes, and
    ``"model"`` where the leaf is replicated there). A step's gradients
    therefore come back as the rank's blocks, summed.
    """

    def __init__(self, mesh, specs: dict, layout: dict, seq: bool = True):
        self.mesh, self.specs, self.layout = mesh, specs, layout
        self.names = tuple(mesh.mesh_dim_names)
        self.sizes = dict(zip(self.names, mesh.shape))
        self.coords = dict(zip(self.names, mesh.get_coordinate()))
        self.M = self.sizes.get("model", 1)
        self.m = self.coords.get("model", 0)
        self.seq = bool(seq) and self.M > 1
        self.vocab = layout.get("embed") is not None

    def __repr__(self) -> str:
        split = sorted(k for k, v in self.layout.items() if v is not None)
        return (f"MeshSplit({dict(self.sizes)}, seq={self.seq}, "
                f"split={split})")

    def group(self, axis):
        return self.mesh.get_group(axis)

    def splits(self, key: str) -> bool:
        """Whether the layer computes on the rank's block of ``key``."""
        return self.layout.get(key) is not None

    def at_length(self, S: int) -> "MeshSplit":
        """This split for a residual of ``S`` positions: without the
        sequence split where ``"model"`` does not divide S."""
        if not self.seq or S % self.M == 0:
            return self
        out = object.__new__(MeshSplit)
        out.__dict__.update(self.__dict__, seq=False)
        return out

    # -- params -----------------------------------------------------------

    def gather(self, key: str, x: torch.Tensor) -> torch.Tensor:
        """The block of leaf ``key`` (or of its layer's slice) that the
        layer computes on, from the rank's stored block ``x``."""
        split = self.layout.get(key)
        if isinstance(split, Pick):
            return self.pick(self._gather(key, x, None), split)
        return self._gather(key, x, split)

    def _gather(self, key: str, x: torch.Tensor, split) -> torch.Tensor:
        spec = self.specs[key]
        spec = spec[len(spec) - x.dim():]      # a layer's slice drops L
        tp = None if split is None else split.dim % x.dim()
        own = split is not None and split.ranks == 1
        steps = []
        for dim, axes in enumerate(spec):
            axes = () if axes is None else (
                axes if isinstance(axes, tuple) else (axes,))
            for a in reversed(axes):            # innermost first
                if self.sizes[a] > 1 and not (a == "model" and dim == tp
                                              and own):
                    steps.append((dim, a))
        done = {a for _, a in steps} | ({"model"} if own else set())
        rest = [self.group(a) for a in self.names
                if self.sizes[a] > 1 and a not in done]
        if rest:
            x = _SumGrad.apply(x, rest)
        for dim, a in steps:
            x = _AllGather.apply(x, dim, self.group(a))
        if split is not None and split.ranks > 1:
            n = x.shape[tp] * split.ranks // self.M
            x = x.narrow(tp, (self.m // split.ranks) * n, n)
        return x

    def pick(self, x: torch.Tensor, pick: Pick) -> torch.Tensor:
        """The rank's part of the whole ``x`` by ``pick``: of each
        segment the rank's block where it splits, else all of it,
        concatenated (a view where one segment is read)."""
        d = pick.dim % x.dim()
        if sum(w for w, _ in pick.parts) != x.shape[d] or any(
                s and w % self.M for w, s in pick.parts):
            raise ValueError(f"{pick} does not fit dim {d} of {x.shape} on "
                             f"{self.M} ranks")
        out, start = [], 0
        for width, split in pick.parts:
            n = width // self.M if split else width
            out.append(x.narrow(d, start + (self.m * n if split else 0), n))
            start += width
        return out[0] if len(out) == 1 else torch.cat(out, d)

    def unpick(self, t: torch.Tensor, pick: Pick) -> torch.Tensor:
        """``pick``'s inverse on the rank's part ``t``: its split segments
        gathered over ``"model"``, the others as they are (alike on every
        rank). No gradient."""
        d = pick.dim % t.dim()
        out, start = [], 0
        for width, split in pick.parts:
            n = width // self.M if split else width
            part = t.narrow(d, start, n)
            out.append(_gather_along(part, d, self.group("model")) if split
                       else part)
            start += n
        return torch.cat(out, d)

    def layer(self, flat: dict, stack: str = "layers") -> dict:
        """A layer's slices ``{"<stack>/...": block}`` gathered by
        ``gather`` and nested as ``lm.layer_params`` nests them."""
        out: dict = {}
        for k, v in flat.items():
            node = out
            parts = k.split("/")[1:]
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = self.gather(k, v)
        return out

    def layer_at(self, params: dict, i: int, stack: str = "layers") -> dict:
        """Layer ``i``'s blocks of the rank's stored ``params``, gathered
        by ``layer``: the only slices of the stacks a decode holds beyond
        the rank's storage, dropped with the layer."""
        return self.layer({k: v[i] for k, v in params.items()
                           if k.startswith(stack + "/")}, stack)

    def whole(self, t: torch.Tensor, dim: int, key: str) -> torch.Tensor:
        """Every ``"model"`` rank's block of ``t`` along ``dim``, blocks
        as the layout of ``key`` splits that dim, gathered into the whole:
        a block that several ranks read (``Split.ranks`` > 1) is taken
        once. No gradient."""
        s = self.layout[key]
        g = _gather_along(t, dim, self.group("model"))
        if s.ranks > 1:
            n = t.shape[dim]
            g = g.unflatten(dim, (self.M // s.ranks, s.ranks * n)).narrow(
                dim + 1, 0, n).flatten(dim, dim + 1)
        return g

    def own(self, t: torch.Tensor, dim: int, key: str) -> torch.Tensor:
        """The rank's block of the whole ``t`` along ``dim``, as the layout
        of ``key`` reads it: ``whole``'s inverse, a view."""
        s = self.layout[key]
        n = t.shape[dim] * s.ranks // self.M
        return t.narrow(dim, (self.m // s.ranks) * n, n)

    def heads(self, stack: str = "layers",
              block: str = "attn") -> "Heads | None":
        """The attention ``block`` (``attn``, or the decoder's ``xattn``)
        of a layer of ``stack`` on the rank's heads (``Heads``), or None
        where the layout gathers it whole."""
        return Heads(self, stack, block) \
            if self.splits(f"{stack}/{block}/wq") else None

    def ssm_heads(self, stack: str = "layers") -> "SSMHeads | None":
        """The SSM mixer of a layer of ``stack`` on the rank's block of
        SSD heads (``SSMHeads``), or None where the layout gathers it."""
        return SSMHeads(self, stack) if isinstance(
            self.layout.get(f"{stack}/ssm/in_proj"), Pick) else None

    # -- the residual stream ----------------------------------------------

    def enter(self, x):
        """The residual -> the rank's whole rows, alike on every
        ``"model"`` rank."""
        return _AllGather.apply(x, 1, self.group("model")) if self.seq \
            else x

    def exit_partial(self, y):
        """A partial sum over ``"model"`` (row-parallel) -> the residual's
        layout: reduce-scattered over the sequence, or all-reduced."""
        if self.M == 1:
            return y
        if self.seq:
            return _ReduceScatter.apply(y, 1, self.group("model"))
        return self.reduce(y)

    def exit_replicated(self, y):
        """Rows every ``"model"`` rank computed alike -> the residual's
        layout: this rank's sequence block (backward: zeros elsewhere)."""
        if not self.seq:
            return y
        n = y.shape[1] // self.M
        return y.narrow(1, self.m * n, n)

    def reduce(self, y):
        """A partial sum over ``"model"`` -> the sum on every rank, entering
        replicated compute (backward: the gradient's parts summed)."""
        if self.M == 1:
            return y
        return _AllReduce.apply(y, [self.group("model")], True)

    def owned(self, v):
        """A value every ``"model"`` rank computed alike, leaving into the
        loss: its gradient kept on ``"model"`` rank 0 only, so the parts
        sum to the whole once."""
        return _Owned.apply(v, self.m == 0, True)

    def to_partial(self, v):
        """A value every ``"model"`` rank holds alike as a partial sum:
        itself on ``"model"`` rank 0, zeros elsewhere."""
        return _Owned.apply(v, self.m == 0, False)

    # -- sums over axes ---------------------------------------------------

    def psum(self, x, axes):
        """Σ of x over ``axes`` (names), identity backward."""
        groups = [self.group(a) for a in axes if self.sizes[a] > 1]
        return _AllReduce.apply(x, groups, False) if groups else x

    def vocab_sum(self, x):
        return self.psum(x, ("model",))

    def vocab_max(self, x):
        """Max over ``"model"``, no gradient."""
        if self.M == 1:
            return x
        return _sum_over(x.detach(), [self.group("model")], "max")

    def vocab_offset(self, width: int) -> int:
        """The first vocabulary row of this rank's block of ``width``."""
        return self.m * width

    def vocab_argmax(self, logits: torch.Tensor) -> torch.Tensor:
        """``argmax`` over the last dim of the logits whose vocabulary
        ``"model"`` splits, ``logits`` this rank's block: each rank's max
        and first index of it, a MAX all-reduce of the maxima, and among
        the ranks that hold the max the lowest global index (a MIN
        all-reduce): ``argmax``'s first-index rule over the whole row.
        int64, the same on every ``"model"`` rank."""
        V = logits.shape[-1]
        idx = logits.argmax(dim=-1)
        top = logits.gather(-1, idx[..., None])[..., 0]
        groups = [self.group("model")]
        best = _sum_over(top, groups, "max")
        cand = torch.where(top == best, idx + self.vocab_offset(V),
                           V * self.M)
        return _sum_over(cand, groups, "min")

    def vocab_whole(self, logits: torch.Tensor) -> torch.Tensor:
        """Every ``"model"`` rank's vocabulary block of ``logits`` (its
        last dim) gathered into the whole rows."""
        return _gather_along(logits, logits.dim() - 1, self.group("model"))

    def take(self, x, axes):
        """This rank's block of dim 0 over ``axes`` (row-major, outermost
        first); backward: zeros elsewhere."""
        for a in axes:
            n = x.shape[0] // self.sizes[a]
            x = x.narrow(0, self.coords[a] * n, n)
        return x

    def join(self, x, axes):
        """``take``'s inverse: the blocks all-gathered, innermost axis
        first; backward reduce-scatters."""
        for a in reversed(axes):
            if self.sizes[a] > 1:
                x = _AllGather.apply(x, 0, self.group(a))
        return x

    def exchange(self, x, axis: str = "model"):
        """The all-to-all over ``axis``: dim 0 of ``x`` in equal blocks,
        one a rank, block j sent to rank j; the blocks received stand in
        the senders' order. Backward: the inverse all-to-all."""
        return _AllToAll.apply(x, self.group(axis)) \
            if self.sizes[axis] > 1 else x

    def gather_model(self, x, dim: int):
        """Every ``"model"`` rank's ``x`` all-gathered along ``dim``, in
        rank order; backward reduce-scatters the gradient's parts."""
        return _AllGather.apply(x, dim, self.group("model")) \
            if self.M > 1 else x

    def scatter_model(self, x, dim: int):
        """A partial sum over ``"model"`` -> the rank's block of the sum
        along ``dim`` (``gather_model``'s inverse); backward all-gathers."""
        return _ReduceScatter.apply(x, dim, self.group("model")) \
            if self.M > 1 else x


class Heads(NamedTuple):
    """A decode's attention on the rank's heads (``MeshSplit.heads``):
    q (B, S, H / M, hd) and k, v (B, S, KV_rank, hd) come from the rank's
    ``wq`` / ``wk`` / ``wv`` columns. ``whole_q`` / ``whole_kv`` gather
    every rank's heads over ``"model"`` (a cache's row holds every kv
    head); ``own_q`` / ``own_kv`` keep the rank's heads of whole ones (a
    view of a cache, an attend's output). ``block``: the attention's
    leaves under the stack (``attn``, or the decoder's ``xattn``)."""
    split: MeshSplit
    stack: str
    block: str = "attn"

    def whole_q(self, t):
        return self.split.whole(t, 2, f"{self.stack}/{self.block}/wq")

    def whole_kv(self, t):
        return self.split.whole(t, 2, f"{self.stack}/{self.block}/wk")

    def own_q(self, t):
        return self.split.own(t, 2, f"{self.stack}/{self.block}/wq")

    def own_kv(self, t):
        return self.split.own(t, 2, f"{self.stack}/{self.block}/wk")


class SSMHeads(NamedTuple):
    """An SSM mixer on the rank's block of SSD heads
    (``MeshSplit.ssm_heads``): its leaves are the ``Pick``s of
    ``compute_layout``, its ``out_proj`` the rank's rows, so its output
    is a partial sum over ``"model"``. ``M``: the ranks that share the
    heads; ``sum``: Σ over them of a partial sum every rank goes on with
    (the gated norm's sum of squares). A decode's conv state keeps every
    channel on every rank: ``own_conv`` reads the rank's channels of it,
    ``whole_conv`` gathers a new row's x channels over ``"model"``."""
    split: MeshSplit
    stack: str

    @property
    def M(self) -> int:
        return self.split.M

    def sum(self, t):
        return self.split.reduce(t)

    def own_conv(self, t):
        return self.split.pick(t, self.split.layout[
            f"{self.stack}/ssm/conv_b"])

    def whole_conv(self, t):
        return self.split.unpick(t, self.split.layout[
            f"{self.stack}/ssm/conv_b"])

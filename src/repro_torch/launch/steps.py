"""Step functions shared by the trainer, the server and the tests (port of
``repro/launch/steps.py``).

The *FL client local step* (paper Algorithm 1, client side): task
gradients, the proximal term θ(w - w_t), an SGD-momentum update; for the
LM families the forward computes in bf16 by default (f32 params and
gradients), as the reference's. ``make_serve_step`` is one token of
greedy decode against a cache. ``mixing_step`` / ``fedavg_step`` are the
server's aggregation programs, in f32 and cast back.

On a ``("data", "model")`` (or ``("pod", "data", "model")``) mesh
(``launch/mesh.py``), ``jit_train_step`` and ``jit_serve_step`` take and
return the reference's trees as DTensors placed by the rules of
``sharding/specs.py``: params by ``param_pspecs``, momentum like its
param, the batch by ``batch_pspecs``, the cache by ``cache_pspecs``, the
tokens by ``token_pspec``. Each is a wrapper, which places the arguments
and wraps the results on the host, around a body that sees only the
rank's blocks and runs through the step's ``GraphCache`` (``fn.graphs``):
on the card one CUDA graph a signature with its collectives inside, its
first call eager and its second captured, as the reference's ``jax.jit``
compiles one program a shape; on the CPU eagerly. ``fn.eager`` runs the
same body without the cache (a roofline counter counts it).

The train step computes on each rank's stored blocks, laid out by
``sharding.compute_layout`` (Megatron-LM's tensor parallelism, with its
sequence parallelism at the reference's ``act_pspec``): the data axes
split the batch, each rank running its rows, and ``"model"`` splits the
layers' compute, each rank running its query heads (and the kv heads
they read), its SSD heads, its ``d_ff`` columns, its experts and its
vocabulary rows, the residual split over ``"model"`` on its sequence
between layers. Each layer gathers its leaves over the data axes inside
its checkpointed body (and over ``"model"`` where the layout keeps a
leaf whole, as attention whose heads ``"model"`` does not divide, or
reads the rank's SSD heads' columns of it, as the SSM mixer's
``in_proj``). The gathers' backward sums the gradients over the ranks,
so they come back as the rank's blocks and the proximal term and
``sgd`` act on blocks. The encoder-decoder runs the same way on each of
its stacks, the decoder's cross-attention on the rank's heads too. The
serve step decodes the rank's rows on the same layout, one layer's
leaves gathered at a time, as the reference's scanned decode gathers
them; the decode cache's sequence dim stays split over ``"model"`` and
its attend combines across the ranks (``attention.sharded_attend``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.core.compile_cache import GraphCache
from repro_torch.device import batch_to, params_device, same_memory
from repro_torch.models import lm, moe as moe_mod, registry
from repro_torch.models.attention import SeqShard
from repro_torch.optim import proximal_grad, sgd, value_and_grad
from repro_torch.sharding import specs as shspecs
from repro_torch.sharding.specs import P, NamedSpec
from repro_torch.types import FedConfig, ModelConfig, ShapeConfig


def act_pspec(mesh, cfg: ModelConfig, seq_len: int) -> Optional[NamedSpec]:
    """Residual-stream layout between layers (sequence parallelism): the
    batch dim over the data axes, the sequence dim over ``"model"`` when
    it divides ``seq_len``, so the residuals ``remat`` stores are split
    over the model axis. None for resnet3d."""
    if cfg.family == "resnet3d":
        return None
    dp = shspecs._flat(shspecs.data_axes(mesh))
    return NamedSpec(mesh, P(dp, shspecs._maybe(mesh, "model", seq_len),
                             None))


def _mesh_loss_kwargs(cfg: ModelConfig, mesh, seq_len: int,
                      loss_kwargs: dict, constrain_acts: bool) -> dict:
    """The reference's ``act_pspec`` / ``moe_ctx`` defaults on a mesh. The
    port's loss always knows its mesh there (its rows are a block of the
    batch, so its CE sums over the data axes): without ``constrain_acts``
    or ``seq_len`` the residual keeps the rows' layout, unsplit."""
    _check_lm(cfg)
    dp = shspecs._flat(shspecs.data_axes(mesh))
    if constrain_acts and seq_len:
        loss_kwargs.setdefault("act_pspec", act_pspec(mesh, cfg, seq_len))
        if cfg.moe is not None:
            loss_kwargs.setdefault("moe_ctx", {"mesh": mesh, "dp": dp})
    loss_kwargs.setdefault("act_pspec", NamedSpec(mesh, P(dp, None, None)))
    if cfg.moe is not None and "moe_ctx" not in loss_kwargs \
            and _data_size(mesh) > 1:
        raise ValueError("a MoE config on a mesh whose data axes split the "
                         "batch routes with moe_ctx (constrain_acts and "
                         "seq_len)")
    return loss_kwargs


def _check_lm(cfg: ModelConfig) -> None:
    if cfg.family == "resnet3d":
        raise ValueError("the mesh steps take the LM families; resnet3d "
                         "runs multi-device as the sharded sync round "
                         "(core/fed_engine.py::ShardedSyncRound)")


def _data_size(mesh) -> int:
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    return math.prod(sizes[a] for a in shspecs.data_axes(mesh))


def _grad_fn(cfg: ModelConfig, fed: FedConfig, mesh, seq_len: int,
             proximal: bool, loss_kwargs: Optional[dict],
             constrain_acts: bool):
    """``grads_of(params, anchor, batch) -> (loss, grads)``: the loss's
    gradients (on a mesh summed over the ranks that split the compute:
    ``reduce_grads``) plus the proximal term."""
    loss_kwargs = dict(loss_kwargs or {})
    if cfg.family != "resnet3d":
        loss_kwargs.setdefault("dtype", torch.bfloat16)   # bf16 compute
    if mesh is not None:
        loss_kwargs = _mesh_loss_kwargs(cfg, mesh, seq_len, loss_kwargs,
                                        constrain_acts)
    moe_ctx = loss_kwargs.get("moe_ctx")

    def grads_of(params, anchor, batch):
        batch = batch_to(batch, params_device(params))
        l, grads = value_and_grad(
            lambda p: registry.loss_fn(p, cfg, batch, **loss_kwargs)[0],
            params)
        if mesh is not None:
            grads = reduce_grads(grads, mesh, moe_ctx)
        if proximal:
            grads = proximal_grad(grads, params, anchor, fed.prox_theta)
        return l, grads

    return grads_of


def _moe_routed(key: str) -> bool:
    """The MoE block's router and experts: the params the distributed
    dispatch runs on the rank's own tokens only."""
    parts = key.split("/")
    return len(parts) >= 2 and parts[-2] == "moe" and \
        parts[-1] in ("router", "wg", "wi", "wo")


@torch.no_grad()
def reduce_grads(grads: dict, mesh, moe_ctx=None) -> dict:
    """Each rank's gradients of the whole params -> their sums over the
    ranks that split the compute: every param over the data axes (each
    rank ran its rows), the MoE router and experts also over the axes of
    ``moe_ctx``'s dp that split the rows further (``moe_fullgrid``). The
    model axis otherwise replicates the compute, so the gradients there
    are already equal. One all-reduce an axis over a flat f32 buffer; an
    axis of one rank sums nothing."""
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    data = tuple(a for a in shspecs.data_axes(mesh) if sizes[a] > 1)
    extra = tuple(a for a in (moe_mod.split_axes(moe_ctx) if moe_ctx
                              else ()) if sizes[a] > 1)
    out = dict(grads)
    for axes, keys in ((data + extra, [k for k in grads if _moe_routed(k)]),
                       (data, [k for k in grads if not _moe_routed(k)])):
        if not axes or not keys:
            continue
        flat = torch.cat([grads[k].reshape(-1).float() for k in keys])
        for a in axes:
            dist.all_reduce(flat, group=mesh.get_group(a))
        for k, part in zip(keys, flat.split([grads[k].numel()
                                             for k in keys])):
            out[k] = part.reshape(grads[k].shape).to(grads[k].dtype)
    return out


def make_train_step(cfg: ModelConfig, fed: FedConfig, mesh=None,
                    seq_len: int = 0, proximal: bool = True,
                    loss_kwargs: Optional[dict] = None,
                    constrain_acts: bool = True):
    """FL client local step: ``step(params, opt_state, anchor, batch) ->
    (params, opt_state, loss)``; returns ``(step, opt)``. The batch may be
    numpy or tensors; it is moved to the params' device.

    With a ``mesh``, the step runs on one rank's plain tensors: the whole
    params, anchor and optimizer state, and the rank's rows of the batch
    (its block over the data axes). As in the reference, ``seq_len`` with
    ``constrain_acts`` lays the residual out by ``act_pspec`` and gives a
    MoE config the distributed dispatch (``moe_ctx`` over the data axes).
    The loss is the whole batch's and the gradients are summed over the
    ranks (``reduce_grads``), so every rank takes the same step: the
    whole-params twin of ``jit_train_step``, which computes on the
    rank's blocks."""
    opt = sgd(fed.lr, fed.momentum, fed.weight_decay)
    grads_of = _grad_fn(cfg, fed, mesh, seq_len, proximal, loss_kwargs,
                        constrain_acts)

    def step(params, opt_state, anchor, batch):
        l, grads = grads_of(params, anchor, batch)
        params, opt_state = opt.update(grads, opt_state, params)
        return params, opt_state, l

    return step, opt


def make_serve_step(cfg: ModelConfig, unroll: bool = False,
                    window_slice: bool = False, ring: bool = False):
    """``step(params, token, cache, pos) -> (next_token int32, cache)``,
    greedy. ``ring`` decodes against a ``to_ring_cache`` layout;
    ``unroll`` with ``window_slice`` attends each SWA layer against the
    last ``window`` cache positions only."""
    kw = {}
    if unroll and cfg.family in lm.FAMILIES:
        kw = {"unroll": True, "window_slice": window_slice}

    @torch.no_grad()
    def step(params, token, cache, pos):
        if ring and cfg.family in lm.FAMILIES:
            logits, cache = lm.decode_step_ring(params, cfg, token, cache,
                                                pos)
        else:
            logits, cache = registry.decode_step(params, cfg, token, cache,
                                                 pos, **kw)
        return torch.argmax(logits, dim=-1).to(torch.int32), cache

    return step


def mixing_step(beta_t):
    """Paper server update w_t = (1-β_t)·w_{t-1} + β_t·w_new (async FL),
    accumulated in f32 and cast back."""
    @torch.no_grad()
    def step(w_prev: dict, w_new: dict) -> dict:
        return {k: ((1 - beta_t) * a.float()
                    + beta_t * w_new[k].float()).to(a.dtype)
                for k, a in w_prev.items()}
    return step


@torch.no_grad()
def fedavg_step(w_stacked: dict) -> dict:
    """FedAvg of client models stacked on a leading axis: the mean in f32
    as XLA computes it, the clients summed in order and the sum times the
    f32 reciprocal of their count, cast back."""
    def mean(s):
        acc = s[0].float()
        for i in range(1, s.shape[0]):
            acc = acc + s[i].float()
        return (acc * (1.0 / s.shape[0])).to(s.dtype)
    return {k: mean(s) for k, s in w_stacked.items()}


# ---------------------------------------------------------------------------
# Steps over params, state, batches and caches placed on a mesh
# ---------------------------------------------------------------------------

def _dtensor(x, mesh, placements):
    """``x`` as a DTensor laid out by ``placements``: a plain tensor or
    array (every rank holding the same whole value) keeps this rank's
    block, on the mesh's device; a DTensor is redistributed if it is laid
    out otherwise."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    if isinstance(x, DTensor):
        return x if tuple(x.placements) == tuple(placements) \
            else x.redistribute(mesh, placements)
    return distribute_tensor(torch.as_tensor(x), mesh, placements,
                             src_data_rank=None)


def _block(x: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's block of the whole value ``x`` under ``placements``: a
    local slice, no communication."""
    from torch.distributed.tensor import DTensor, Replicate
    rep = [Replicate()] * len(placements)
    return DTensor.from_local(x, mesh, rep, run_check=False).redistribute(
        mesh, placements).to_local()


def _wrap(local: torch.Tensor, like):
    """``local`` as the block of a DTensor laid out as ``like``."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local, like.device_mesh, like.placements,
                              run_check=False, shape=like.shape,
                              stride=like.stride())


def _write(dst: Optional[dict], new: Optional[dict]) -> Optional[dict]:
    """``new``'s tensors written into ``dst``'s (a donated argument);
    returns ``dst``."""
    if dst is not None:
        for k, v in new.items():
            dst[k].copy_(v)
    return dst


def _local(tree: Optional[dict]) -> Optional[dict]:
    return None if tree is None else {k: v.to_local()
                                      for k, v in tree.items()}


def _run(graphs, name: str, body, args: tuple, inplace: tuple):
    """A mesh step's ``body(*args)``: through ``graphs`` under ``name``
    (on the card a CUDA graph a signature, eager on the CPU), or eagerly
    where ``graphs`` is None (``fn.eager``)."""
    if graphs is None:
        return body(*args)
    return graphs.call(name, body, args, inplace=inplace)


def jit_train_step(cfg: ModelConfig, fed: FedConfig, mesh,
                   shape: ShapeConfig, params_shape, batch_shape,
                   proximal: bool = True, constrain_acts: bool = True,
                   donate: bool = True, moe_fullgrid: bool = False,
                   train_kwargs: Optional[dict] = None):
    """Returns ``(fn, (in_specs, out_specs))`` for ``fn(params, opt_state,
    anchor, batch) -> (params, opt_state, loss)`` on ``mesh``.

    Specs: params and anchor by ``param_pspecs``, the momentum like its
    param and the step counter replicated, the batch by ``batch_pspecs``,
    the loss replicated. ``fn`` takes those trees as DTensors (a plain
    tensor, the same on every rank, is placed first) and returns them
    so. ``donate``: the new params and momentum are written into the
    inputs' storage (so the anchor must not share it, as in the
    reference). ``moe_fullgrid``: the MoE dispatch splits the tokens over
    the data axes and ``"model"``.

    Every LM family computes on the rank's blocks (``fn.split``, a
    ``sharding.MeshSplit`` by ``compute_layout``): the loss's gradients
    come back as the rank's blocks, summed over the ranks, and the
    proximal term and ``sgd`` act on the blocks; the residual is split
    over ``"model"`` on its sequence between layers when
    ``constrain_acts`` (the reference's ``act_pspec``; each of the
    encoder-decoder's stacks where ``"model"`` divides its own length)
    and its batch dim keeps the batch's own layout. A MoE batch the data
    axes do not divide has its flat tokens split evenly over them in the
    dispatch.

    The body runs through ``fn.graphs`` under ``"mesh_train"``: the
    anchor's blocks in place (read only: pass the same anchor through a
    client's steps), and so the params' and momentum's when ``donate``;
    otherwise they, the batch's rows and a schedule's step tensor are
    copied in. A constant rate's host-int step never enters the graph:
    the wrapper counts it.
    """
    from torch.distributed.tensor import DTensor, Replicate
    _check_lm(cfg)
    lk = dict(train_kwargs or {})
    bspec = shspecs.batch_pspecs(mesh, cfg, batch_shape)
    lead = next(iter(bspec.values()))[0]
    pspec = shspecs.param_pspecs(mesh, cfg, params_shape)
    ospec = {"mom": pspec if fed.momentum else None, "step": P()}
    if cfg.moe is not None and not (constrain_acts and shape.seq_len) \
            and _data_size(mesh) > 1:
        raise ValueError("a MoE config on a mesh whose data axes split "
                         "the batch routes with moe_ctx (constrain_acts "
                         "and seq_len)")
    split, moe_ctx = mesh_split(cfg, mesh, shape.seq_len, params_shape,
                                rows=_spec_axes(lead), seq=constrain_acts,
                                moe_fullgrid=moe_fullgrid)
    if moe_ctx is not None:
        lk["moe_ctx"] = moe_ctx
    lk.setdefault("dtype", torch.bfloat16)          # bf16 compute
    grads_of = _split_grad_fn(cfg, fed, split, proximal, lk)
    opt = sgd(fed.lr, fed.momentum, fed.weight_decay)
    in_sh = (pspec, ospec, pspec, bspec)
    out_sh = (pspec, ospec, P())
    pl = shspecs.named(mesh, pspec)
    bpl = shspecs.named(mesh, bspec)
    rep = (Replicate(),) * len(mesh.mesh_dim_names)

    def body(local, mom, anchor, rows, step):
        """The step on the rank's blocks and rows (plain tensors): its new
        blocks, momentum, loss and step, the blocks and momentum written
        into ``local`` / ``mom`` when ``donate``."""
        loss, grads = grads_of(local, anchor, rows)
        with torch.no_grad():
            new_p, new_s = opt.update(grads, {"mom": mom, "step": step},
                                      local)
            new_m = new_s["mom"]
            if donate:
                new_p, new_m = _write(local, new_p), _write(mom, new_m)
        return new_p, new_m, loss, new_s["step"]

    def make(graphs):
        def fn(params, opt_state, anchor, batch):
            params = {k: _dtensor(v, mesh, pl[k]) for k, v in params.items()}
            anchor = {k: _dtensor(v, mesh, pl[k]) for k, v in anchor.items()}
            mom = opt_state["mom"]
            if mom is not None:
                mom = {k: _dtensor(v, mesh, pl[k]) for k, v in mom.items()}
            if donate and any(same_memory(anchor[k].to_local(),
                                          params[k].to_local())
                              for k in params):
                raise ValueError("donated params share storage with the "
                                 "anchor")
            rows = {k: _dtensor(v, mesh, bpl[k]).to_local()
                    for k, v in batch.items()}
            # a constant rate's step is a host int no graph reads (its
            # value would key a graph a step); a schedule's is an input
            step = opt_state["step"]
            traced = isinstance(step, torch.Tensor)
            new_p, new_m, loss, new_step = _run(
                graphs, "mesh_train", body,
                (_local(params), _local(mom), _local(anchor), rows,
                 step if traced else 0), (0, 1, 2) if donate else (2,))
            if not donate:
                params = {k: _wrap(new_p[k], params[k]) for k in params}
                mom = None if mom is None else {k: _wrap(new_m[k], mom[k])
                                                for k in mom}
            loss = DTensor.from_local(loss, mesh, rep, run_check=False)
            return params, {"mom": mom, "step": new_step if traced
                            else step + 1}, loss
        fn.graphs = graphs
        return fn

    fn = make(GraphCache())
    fn.eager, fn.opt, fn.split = make(None), opt, split
    return fn, (in_sh, out_sh)


def _spec_axes(entry) -> tuple:
    """A spec entry (None, a name or a tuple of names) as a tuple."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def mesh_split(cfg: ModelConfig, mesh, seq_len: int, params_shape,
               rows=None, seq: bool = True, moe_fullgrid: bool = False):
    """The LM's compute on ``mesh``, as the train step lays it out:
    ``(split, moe_ctx)``. ``split`` is the ``sharding.MeshSplit`` of
    ``compute_layout`` over ``params_shape``'s ``param_pspecs``, the
    residual split over ``"model"`` on its sequence when ``seq`` and
    ``"model"`` divides ``seq_len`` (the reference's ``act_pspec``);
    ``moe_ctx`` (a MoE config only, else None) the distributed dispatch
    over the data axes (and ``"model"`` with ``moe_fullgrid``).
    ``rows``: the axes that split the batch's rows (None: the data axes;
    ``()`` for a batch they do not divide, whose flat tokens the
    dispatch splits over them). The forward takes them as
    ``loss_fn(..., split=split, moe_ctx=moe_ctx)`` on the rank's stored
    blocks and rows."""
    moe_ctx = None
    if cfg.moe is not None:
        moe_ctx = {"mesh": mesh,
                   "dp": tuple(shspecs.data_axes(mesh))
                   + (("model",) if moe_fullgrid else ()),
                   "rows": tuple(shspecs.data_axes(mesh)) if rows is None
                   else tuple(rows)}
    split = shspecs.MeshSplit(
        mesh, shspecs.param_pspecs(mesh, cfg, params_shape),
        shspecs.compute_layout(mesh, cfg, params_shape, moe_fullgrid),
        seq=bool(seq and seq_len and shspecs._maybe(mesh, "model", seq_len)))
    if moe_ctx is not None:
        moe_ctx["split"] = split
    return split, moe_ctx


def _split_grad_fn(cfg: ModelConfig, fed: FedConfig, split, proximal: bool,
                   loss_kwargs: dict):
    """``grads_of(local, anchor, rows) -> (loss, grads)`` on the rank's
    stored blocks under ``split``: the gradients come back as the blocks',
    summed over the ranks by the gathers' backward, plus the proximal
    term on the blocks."""

    def grads_of(local, anchor, rows):
        rows = batch_to(rows, params_device(local))
        l, grads = value_and_grad(
            lambda p: registry.loss_fn(p, cfg, rows, split=split,
                                       **loss_kwargs)[0], local)
        if proximal:
            grads = proximal_grad(grads, local, anchor, fed.prox_theta)
        return l, grads

    return grads_of


_SEQ_SPLIT = {"k": "k", "v": "k", "enc_k": "enc_k", "enc_v": "enc_k"}


def _seq_shard(mesh, spec: P, length: int) -> Optional[SeqShard]:
    """The ``SeqShard`` of a cache entry whose spec splits its sequence
    dim (2) over mesh axes of more than one rank (None otherwise): the
    block index row-major over those axes, outermost first."""
    axes = spec[2]
    if axes is None:
        return None
    axes = axes if isinstance(axes, tuple) else (axes,)
    names = tuple(mesh.mesh_dim_names)
    coord = dict(zip(names, mesh.get_coordinate()))
    sizes = dict(zip(names, mesh.shape))
    if math.prod(sizes[a] for a in axes) == 1:
        return None
    index = 0
    for a in axes:
        index = index * sizes[a] + coord[a]
    return SeqShard(index * length, [mesh.get_group(a) for a in axes])


def jit_serve_step(cfg: ModelConfig, mesh, shape: ShapeConfig,
                   params_shape, cache_shape, donate: bool = True,
                   unroll: bool = False, window_slice: bool = False,
                   ring: bool = False):
    """Returns ``(fn, (in_specs, out_specs))`` for ``fn(params, token,
    cache, pos) -> (next_token, cache)``, one greedy decode step on
    ``mesh``: params by ``param_pspecs``, tokens by ``token_pspec``, the
    cache by ``cache_pspecs`` (the ring layout when ``ring``), ``pos``
    replicated (an int, or the (B,) positions of every row).

    ``fn`` decodes the rank's rows (a block over the data axes when the
    batch is split) on the rank's stored blocks, laid out as the train
    step lays them out (``fn.split``, a ``sharding.MeshSplit`` by
    ``compute_layout``, without a sequence split: a decode has one
    position a row). Each layer gathers its leaves over the data axes
    (and over ``"model"`` where the layout keeps a leaf whole) inside the
    layer loop, as the reference's scanned decode does: no whole param
    is held. The layer computes on the rank's query heads, SSD heads,
    ``d_ff`` columns and experts, its partial sums all-reduced over
    ``"model"``;
    where ``"model"`` splits the vocabulary the embedding looks up the
    rank's rows and the greedy pick is vocabulary-parallel
    (``MeshSplit.vocab_argmax``: ``argmax``'s first index over the whole
    row).

    A cache entry whose sequence dim is split stays split: the rank
    owning a row's position writes every kv head of it (the new k / v
    gathered over ``"model"``), and the attend combines every head
    across the ranks (``SeqShard``), the rank keeping its heads of the
    output. The SSM state, split over ``"model"`` by its heads, is
    decoded in place on the rank's heads where the layout splits the
    mixer (``MeshSplit.ssm_heads``); the conv state is whole on every
    rank, each reading its channels and writing the new row's whole. An
    entry split on another dim (a conv state's channels at batch 1, an
    SSM state the layout gathers) is gathered to the rank's rows for the
    step and split back. ``donate``: the cache is written in place, and
    the DTensors passed in come back. ``fn(..., with_logits=True)`` also
    returns the rank's rows' logits (plain; gathered over ``"model"``
    on that call where it splits the vocabulary), for checks: a signature
    of its own.

    The body runs through ``fn.graphs`` under ``"mesh_serve"``: the
    params' blocks in place (read only), and so the cache's when
    ``donate`` (otherwise a copy of it is copied in); the token and the
    positions are copied in, an int ``pos`` made the rows' (B,)
    positions first, so every position replays one graph.
    """
    from torch.distributed.tensor import DTensor
    step_kw = {}
    if unroll and cfg.family in lm.FAMILIES:
        step_kw = {"unroll": True, "window_slice": window_slice}
    pspec = shspecs.param_pspecs(mesh, cfg, params_shape)
    cspec = shspecs.cache_pspecs(mesh, cfg, cache_shape, shape.global_batch)
    tspec = shspecs.token_pspec(mesh, shape.global_batch)
    split = shspecs.MeshSplit(
        mesh, pspec, shspecs.compute_layout(mesh, cfg, params_shape),
        seq=False)
    # the SSM state decoded in place on the rank's heads, which the cache
    # stores (both under the guard that "model" divides the heads)
    own_state = split.ssm_heads() is not None
    in_sh = (pspec, tspec, cspec, P())
    out_sh = (tspec, cspec)
    pl, cpl = shspecs.named(mesh, pspec), shspecs.named(mesh, cspec)
    tpl = shspecs.placements(mesh, tspec)
    # each entry's layout with only its batch dim split: the rank's rows
    rpl = {k: shspecs.placements(mesh, P(None, s[1], *[None] * (len(s) - 2)))
           for k, s in cspec.items()}

    @torch.no_grad()
    def body(local, tok, cache, pos, with_logits):
        """The step on the rank's blocks, rows and (B,) positions (plain
        tensors): the next tokens (and logits), ``cache`` written in
        place and returned."""
        shards, work, regather = {}, {}, []
        for k, v in cache.items():
            seq = _SEQ_SPLIT.get(k)
            if seq is not None:
                sh = _seq_shard(mesh, cspec[seq], cache[seq].shape[2])
                if sh is not None:
                    shards[seq] = sh
                work[k] = v
            elif cpl[k] != rpl[k] and not (k == "ssm_state" and own_state):
                # every split of the cache is even (cache_pspecs)
                work[k] = DTensor.from_local(
                    v, mesh, cpl[k], run_check=False).redistribute(
                        mesh, rpl[k]).to_local()
                regather.append(k)
            else:
                work[k] = v
        if ring and cfg.family in lm.FAMILIES:
            logits, work = lm.decode_step_ring(local, cfg, tok, work, pos,
                                               seq_shards=shards,
                                               split=split)
        else:
            logits, work = registry.decode_step(local, cfg, tok, work, pos,
                                                seq_shards=shards,
                                                split=split, **step_kw)
        for k in regather:
            cache[k].copy_(DTensor.from_local(
                work[k], mesh, rpl[k], run_check=False).redistribute(
                    mesh, cpl[k]).to_local())
        if split.vocab:
            nxt = split.vocab_argmax(logits).to(torch.int32)
            if with_logits:
                logits = split.vocab_whole(logits)
        else:
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        return (nxt, cache, logits) if with_logits else (nxt, cache)

    def make(graphs):
        @torch.no_grad()
        def fn(params, token, cache, pos, with_logits: bool = False):
            local = {k: _dtensor(v, mesh, pl[k]).to_local()
                     for k, v in params.items()}
            token = _dtensor(token, mesh, tpl)
            tok = token.to_local()
            # the rank's rows' (B,) int32 positions, from every row's or
            # one for all: an int would key a graph a position
            if isinstance(pos, torch.Tensor):
                pos = pos.to(tok.device, torch.int32)
                pos = _block(pos, mesh, tpl) if pos.dim() else \
                    pos.reshape(1).expand(tok.shape[0])
            else:
                pos = lm._decode_pos(pos, tok.shape[0], tok.device)
            cache = {k: _dtensor(v, mesh, cpl[k]) for k, v in cache.items()}
            out = _run(graphs, "mesh_serve", body,
                       (local, tok, _local(cache) if donate else
                        {k: v.to_local().clone() for k, v in cache.items()},
                        pos, with_logits), (0, 2) if donate else (0,))
            nxt = DTensor.from_local(out[0], mesh, tpl, run_check=False,
                                     shape=token.shape,
                                     stride=token.stride())
            if not donate:
                cache = {k: _wrap(out[1][k], cache[k]) for k in cache}
            return (nxt, cache, *out[2:])
        fn.graphs = graphs
        return fn

    fn = make(GraphCache())
    fn.eager, fn.split = make(None), split
    return fn, (in_sh, out_sh)

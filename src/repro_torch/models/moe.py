"""Token-choice top-k MoE with capacity (port of ``repro/models/moe.py``).

The local dispatch: each token's k expert picks get a slot in an
(E, C, d) buffer, in token-major order; a pick past an expert's capacity
C goes to a drop bin (row E·C of the flat buffer), which is sliced off and
never read. The three expert products are batched over E (plain matrix
products, outside any kernel); the combine gathers each pick's output back,
zeroes the dropped ones and sums the k picks with their renormalised
router weights.

The distributed path (``moe_ctx = {"mesh": DeviceMesh, "dp": axis or
tuple}``, the reference's ``shard_map`` over ``dp``): each dp shard
routes its own T_loc tokens with its own capacity C_loc = capacity(T_loc),
dispatches into an (E, C_loc, d) block and combines locally; the blocks
together are the reference's (E, C_loc · shards, d) buffer split over dp
on dim 1, so the expert FFN runs on this rank's block. ``frac`` and
``mean_p`` are averaged over dp before the aux loss. The rank's tokens are
its rows of the batch (split over the data axes); an axis of dp that does
not split the batch (``"model"``, under ``moe_fullgrid``) splits them
further, and the outputs are gathered back over it. With more than one
dp shard this is not the local path's result, since each shard drops by
its own capacity. As in the reference, the distributed path ignores
``dropless`` (ROADMAP Queue 3).

``moe_ctx["rows"]``: the axes that split the rank's rows (the batch's
own split; the data axes when absent). A dp axis that splits no rows
(``"model"`` under ``moe_fullgrid``, the data axes for a batch they do
not divide) splits the flat tokens evenly, as the reference's
``shard_map`` does, and the outputs are gathered back over it.

Under tensor parallelism (``moe_ctx["split"]``, a ``sharding.MeshSplit``:
the train step's and the mesh forward's) the expert weights are the
rank's blocks: its E / M experts (expert parallel) or every expert's
``d_ff`` columns. The router runs on every ``"model"`` rank alike and
the aux loss leaves through ``split.owned``. Without ``"model"`` in dp
every ``"model"`` rank holds the same tokens: the dispatch buffer keeps
only the picks of the rank's experts, or meets its columns, and the
combine is a partial sum over ``"model"`` (``split_partial``), as the
shared expert's on its columns. Under ``moe_fullgrid`` the ``"model"``
ranks hold different tokens, and the rank's (E, C_loc, d) buffer meets
the stored blocks as the reference's compiled step moves it: expert
parallel, one all-to-all sends expert block m to ``"model"`` rank m,
which runs its E / M experts over the M · C_loc rows received and sends
them back by the inverse all-to-all; on ``d_ff`` columns, the buffer is
all-gathered over ``"model"`` along C and the partial sums of ``wo``
reduce-scattered back to the rank's rows. Either way each token's output
comes back whole. The mesh serve step's decode takes the local dropless
path (C = T) on the same blocks (``moe_forward(split=)``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.common import activation, fan_in_init
from repro_torch.sharding.specs import data_axes, psum_axes
from repro_torch.types import MoEConfig


def init_moe_params(gen: torch.Generator, d_model: int, d_ff: int,
                    moe: MoEConfig, num_layers: int,
                    dtype=torch.float32) -> dict:
    init = fan_in_init()
    L, E = num_layers, moe.num_experts
    p = {
        "router": init(gen, (L, d_model, E), dtype),
        "wg": init(gen, (L, E, d_model, d_ff), dtype),
        "wi": init(gen, (L, E, d_model, d_ff), dtype),
        "wo": init(gen, (L, E, d_ff, d_model), dtype),
    }
    if moe.shared_expert:
        p["shared_wg"] = init(gen, (L, d_model, d_ff), dtype)
        p["shared_wi"] = init(gen, (L, d_model, d_ff), dtype)
        p["shared_wo"] = init(gen, (L, d_ff, d_model), dtype)
    return p


def param_shapes(d_model: int, d_ff: int, moe: MoEConfig,
                 num_layers: int) -> dict:
    """The MoE block's keys (under ``layers/moe/``) and shapes."""
    L, E, d, f = num_layers, moe.num_experts, d_model, d_ff
    s = {"router": (L, d, E), "wg": (L, E, d, f), "wi": (L, E, d, f),
         "wo": (L, E, f, d)}
    if moe.shared_expert:
        s.update({"shared_wg": (L, d, f), "shared_wi": (L, d, f),
                  "shared_wo": (L, f, d)})
    return s


def capacity(num_tokens: int, moe: MoEConfig) -> int:
    # host ints in, a host int out: a shape, not a sync
    # repro-lint: disable=R2
    return int(math.ceil(num_tokens / moe.num_experts
                         * moe.capacity_factor * moe.top_k))


def top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k``: the k largest along the last axis, in descending
    order, the lower index first among equal values (a stable sort;
    ``torch.topk`` promises no order on ties)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(router_w, xt, moe: MoEConfig, C: int):
    """Local routing of xt (T, d). Returns (weights (T, k) f32, slot
    (T·k,), keep (T·k,), frac (E,), mean_p (E,), expert_idx (T, k)).

    The router logits are computed in x's dtype and the softmax in f32.
    Pick j of token t (flat index t·k + j, token-major) takes the next
    free position of its expert; ``keep`` is that position < C, and a
    kept pick's slot is expert·C + position, a dropped one's the drop bin
    E·C. ``frac`` counts the top-1 picks only (the switch-style aux)."""
    E, k = moe.num_experts, moe.top_k
    T = xt.shape[0]
    logits = torch.matmul(xt, router_w.to(xt.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    weights, expert_idx = top_k(probs, k)
    weights = weights / weights.sum(dim=-1, keepdim=True)
    e_flat = expert_idx.reshape(T * k)
    onehot = F.one_hot(e_flat, E)
    pos = (torch.cumsum(onehot, dim=0) * onehot).sum(dim=-1) - 1
    keep = pos < C
    slot = torch.where(keep, e_flat * C + torch.clamp(pos, max=C - 1),
                       E * C)
    frac = F.one_hot(expert_idx[:, 0], E).float().mean(dim=0)
    mean_p = probs.mean(dim=0)
    return weights, slot, keep, frac, mean_p, expert_idx


def dispatch(x_rep: torch.Tensor, slot: torch.Tensor, E: int,
             C: int) -> torch.Tensor:
    """(T·k, d) token copies -> (E, C, d). Only dropped picks share an
    index (the drop bin, row E·C), which is sliced off: the rows kept are
    each written once, so the scatter is deterministic where it is read."""
    d = x_rep.shape[-1]
    buf = x_rep.new_zeros((E * C + 1, d)).index_put((slot,), x_rep)
    return buf[:E * C].reshape(E, C, d)


def combine(out_e, slot, keep, weights, T: int, k: int) -> torch.Tensor:
    d = out_e.shape[-1]
    out_pad = torch.cat([out_e.reshape(-1, d), out_e.new_zeros((1, d))])
    g = out_pad[slot] * keep[:, None].to(out_e.dtype)
    return torch.sum(g.reshape(T, k, d)
                     * weights.reshape(T, k, 1).to(out_e.dtype), dim=1)


def expert_ffn(p: dict, eb: torch.Tensor, act: str) -> torch.Tensor:
    """The gated FFN of every expert on its (C, d) rows: three (E, ·, ·)
    batched products."""
    dt = eb.dtype
    g = torch.bmm(eb, p["wg"].to(dt))
    h = torch.bmm(eb, p["wi"].to(dt))
    return torch.bmm(activation(act)(g) * h, p["wo"].to(dt))


def _dp_axes(moe_ctx) -> tuple:
    """The dispatch's dp axes as a tuple of names."""
    dp = moe_ctx["dp"]
    return () if dp is None else (dp if isinstance(dp, tuple) else (dp,))


def split_axes(moe_ctx) -> tuple:
    """The dp axes that split a rank's rows further (not axes of its
    rows): the axes over which the routing's own parameters' gradients
    are partial beyond the rows'."""
    rows = moe_ctx.get("rows", data_axes(moe_ctx["mesh"]))
    return tuple(a for a in _dp_axes(moe_ctx) if a not in rows)


def _exchanged(split, moe_ctx) -> bool:
    """Whether the dispatch buffer meets the rank's stored experts by
    exchange over ``"model"`` (``moe_fullgrid``: ``"model"`` splits the
    tokens, and ``split`` the experts)."""
    return split is not None and moe_ctx is not None and \
        "model" in split_axes(moe_ctx) and split.splits("layers/moe/wi")


def _routed_partial(split, moe_ctx) -> bool:
    """Whether the routed experts' combine is a partial sum over
    ``"model"``: the experts split there and the buffer is not
    exchanged (``_exchanged``, whose combine is whole)."""
    return split.splits("layers/moe/wi") and not _exchanged(split, moe_ctx)


def split_partial(split, moe_ctx=None) -> bool:
    """Whether the MoE block's output is a partial sum over ``"model"``
    under ``split``: its shared expert's or its routed experts'."""
    return split.splits("layers/moe/shared_wi") or \
        _routed_partial(split, moe_ctx)


def _take(xt, mesh, axes, split):
    """This rank's block of the flat tokens over ``axes``."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if split is not None:
        return split.take(xt, axes)
    sub = mesh[axes]
    return DTensor.from_local(xt, sub, [Replicate()] * len(axes),
                              run_check=False).redistribute(
        sub, [Shard(0)] * len(axes)).to_local()


def _join(out, mesh, axes, split):
    """``_take``'s inverse: every rank's block gathered back."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if split is not None:
        return split.join(out, axes)
    sub = mesh[axes]
    return DTensor.from_local(out, sub, [Shard(0)] * len(axes),
                              run_check=False).redistribute(
        sub, [Replicate()] * len(axes)).to_local()


def _exchange_ffn(p, eb: torch.Tensor, act: str, split) -> torch.Tensor:
    """``expert_ffn`` of the rank's whole (E, C, d) buffer on the rank's
    stored blocks, whose other rows every ``"model"`` rank holds: expert
    parallel (``p`` holding E / M experts), block m of the buffer goes to
    ``"model"`` rank m by an all-to-all, which runs its experts over the
    (E / M, M · C, d) rows received and returns them by the inverse; on
    ``d_ff`` columns, the buffers gathered along C meet the rank's
    columns, and ``wo``'s partial sums are reduce-scattered back."""
    E, C, d = eb.shape
    M, E_loc = split.M, p["wg"].shape[0]
    if E_loc == E:
        return split.scatter_model(
            expert_ffn(p, split.gather_model(eb, 1), act), 1)
    got = split.exchange(eb.reshape(M, E_loc, C, d))   # (sender, e, C, d)
    y = expert_ffn(p, got.transpose(0, 1).reshape(E_loc, M * C, d), act)
    back = y.reshape(E_loc, M, C, d).transpose(0, 1)
    return split.exchange(back).reshape(E, C, d)


def _experts(p, xt, weights, slot, keep, C: int, moe: MoEConfig, act: str,
             split, exchange: bool = False):
    """The routed picks of the tokens xt (T, d) through the experts of
    ``p``: every expert, or under expert parallelism (``split``; ``p``
    holding E / M of them) this rank's experts' picks only, the rest
    dropped, so the output is a partial sum over ``"model"``. With
    ``exchange`` every pick runs on the rank's stored blocks by
    ``_exchange_ffn``, and the output is whole."""
    T, k = xt.shape[0], moe.top_k
    if exchange:
        eb = dispatch(torch.repeat_interleave(xt, k, dim=0), slot,
                      moe.num_experts, C)
        return combine(_exchange_ffn(p, eb, act, split), slot, keep,
                       weights, T, k)
    E_loc = p["wg"].shape[0]
    if E_loc != moe.num_experts:     # this rank's experts' picks
        lo = split.m * E_loc * C
        keep = keep & (slot >= lo) & (slot < lo + E_loc * C)
        slot = torch.where(keep, slot - lo, E_loc * C)
    eb = dispatch(torch.repeat_interleave(xt, k, dim=0), slot, E_loc, C)
    return combine(expert_ffn(p, eb, act), slot, keep, weights, T, k)


def _sharded(p, xt, moe: MoEConfig, act: str, moe_ctx):
    """The distributed dispatch of this rank's tokens xt (T_loc, d):
    (out (T_loc, d), frac, mean_p), the last two averaged over dp."""
    mesh, split = moe_ctx["mesh"], moe_ctx.get("split")
    axes, tok = _dp_axes(moe_ctx), split_axes(moe_ctx)
    names = tuple(mesh.mesh_dim_names)
    if not set(data_axes(mesh)) <= set(axes) or not set(axes) <= set(names):
        raise ValueError(f"moe_ctx dp {axes}: must hold the mesh's data "
                         f"axes {data_axes(mesh)} and only axes of {names}")
    sizes = dict(zip(names, mesh.shape))
    n = math.prod(sizes[a] for a in tok)
    if n > 1:
        if xt.shape[0] % n:
            raise ValueError(f"{xt.shape[0]} tokens do not split over "
                             f"{tok} ({n} ranks)")
        xt = _take(xt, mesh, tok, split)
    C = capacity(xt.shape[0], moe)
    weights, slot, keep, frac, mean_p, _ = route(p["router"], xt, moe, C)
    out = _experts(p, xt, weights, slot, keep, C, moe, act, split,
                   _exchanged(split, moe_ctx))
    if n > 1:
        out = _join(out, mesh, tok, split)
    shards = math.prod(sizes[a] for a in axes)
    if split is None:
        frac, mean_p = psum_axes(frac, mesh, axes), psum_axes(mean_p, mesh,
                                                              axes)
    else:
        frac, mean_p = split.psum(frac, axes), split.psum(mean_p, axes)
    return out, frac / shards, mean_p / shards


def moe_forward(p: dict, x: torch.Tensor, moe: MoEConfig, act: str = "silu",
                moe_ctx=None, dropless: bool = False, split=None):
    """x: (B, S, d) -> (out (B, S, d), aux_loss f32 scalar).

    ``dropless=True`` (prefill and decode) sizes the capacity at C = T:
    top-k picks distinct experts, so no expert gets more than T picks and
    no token is dropped. Each token's output then depends on its own
    router logits only, so a batched or padded prefill gives every token
    what it gets alone. Training and scoring (``dropless=False``) drop
    picks past C = ceil(T / E · capacity_factor · k).

    ``split`` (without ``moe_ctx``: the mesh serve step's decode, the
    local dropless path on the rank's rows): ``p`` holds the rank's
    experts or each expert's ``d_ff`` columns, as under ``moe_ctx``'s.
    """
    B, S, d = x.shape
    T = B * S
    E = moe.num_experts
    xt = x.reshape(T, d)
    if moe_ctx is not None:
        split = moe_ctx.get("split")
        out, frac, mean_p = _sharded(p, xt, moe, act, moe_ctx)
    else:
        C = T if dropless else capacity(T, moe)
        weights, slot, keep, frac, mean_p, _ = route(p["router"], xt, moe, C)
        out = _experts(p, xt, weights, slot, keep, C, moe, act, split)
    out = out.reshape(B, S, d)
    if moe.shared_expert:
        dt = x.dtype
        g = torch.matmul(x, p["shared_wg"].to(dt))
        h = torch.matmul(x, p["shared_wi"].to(dt))
        shared = torch.matmul(activation(act)(g) * h, p["shared_wo"].to(dt))
        if split is not None and split_partial(split, moe_ctx):
            # one partial sum over "model": the part every rank holds alike
            # rides on rank 0
            if not _routed_partial(split, moe_ctx):
                out = split.to_partial(out)
            if not split.splits("layers/moe/shared_wi"):
                shared = split.to_partial(shared)
        out = out + shared
    aux = E * torch.sum(frac * mean_p) * moe.router_aux_weight
    if split is not None and (moe_ctx is None
                              or "model" not in _dp_axes(moe_ctx)):
        aux = split.owned(aux)
    return out, aux

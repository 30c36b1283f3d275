"""GQA attention with sliding windows and KV-cache decode (port of
``repro/models/attention.py``).

One code path serves full attention (window == 0) and sliding-window
attention (window > 0). Prefill uses query chunking (exact row softmax
against full K), bounding the score tensor at (B, q_chunk, KV, G, S_k).

The reference decodes one stream at a scalar position and ``vmap``s it
over the serving slots; the port batches the slots natively, so every
decode position here is a per-row ``(B,)`` int tensor: the RoPE angle,
the ring slot ``pos % W`` each row writes, the row's cache write and its
``k_len = pos + 1``. Caches are updated in place (the reference returns
new arrays; the port saves the copy) and returned.

A decode cache whose sequence dim is split over mesh axes (``SeqShard``,
``launch.steps.jit_serve_step``) holds positions ``[offset, offset +
S_local)`` on each rank: the rank that owns a row's position writes it,
and the attend runs over the local keys and combines its max, sum and
weighted values across the ranks (flash-decoding, ``sharded_attend``):
the whole cache is never gathered.

Under tensor parallelism (``sharding.MeshSplit``) the projections are a
rank's blocks: its query heads and the kv heads they read, counted from
the weights' widths, and the row block of ``wo``, whose output is then a
partial sum over ``"model"``; the attend and its kernel run on those
heads alone. A decode on them (``heads``, a ``sharding.Heads``) keeps
the cache's layout, every kv head a row: the new k / v are gathered
over ``"model"`` and written whole, and the rank attends its kv heads'
block of a whole cache, or, against a sequence-split one, every head
(the queries gathered too) before keeping its own.

Kernels: ``"cuda"`` runs the hand-written attends (``kernels/ops.py``):
the causal sliding-window attention of the cache-free scoring forward,
and the ring and extent attends of decode; ``"eager"`` the plain torch
path below — the oracle they are held against.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.kernels import ops
from repro_torch.models.common import apply_rope, fan_in_init

NEG_INF = -1e30
KERNELS = ("cuda", "eager")


def check_kernel(kernel: str) -> None:
    if kernel not in KERNELS:
        raise ValueError(f"kernel {kernel!r}: the scoring or decode kernel "
                         f"must be one of {KERNELS}")


def _rows(x, device) -> torch.Tensor:
    """An int or a (B,) tensor -> a (B or 1, 1) tensor of positions."""
    if isinstance(x, torch.Tensor):
        return x.reshape(-1, 1)
    # x is a host int here: a tensor returned above
    # repro-lint: disable=R2
    return torch.full((1, 1), int(x), dtype=torch.int32, device=device)


def _mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor, window,
               causal: bool) -> torch.Tensor:
    """(..., S_q, S_k) additive bias. window: 0/scalar -> full when 0.
    ``q_pos`` (..., S_q) and ``k_pos`` (..., S_k) may carry a row axis."""
    dq = q_pos[..., :, None]
    dk = k_pos[..., None, :]
    ok = (dq >= dk) if causal else torch.ones_like(dq - dk, dtype=torch.bool)
    if isinstance(window, torch.Tensor):
        w_eff = torch.where(window == 0, 2 ** 30, window)
    else:
        w_eff = window if window else 2 ** 30
    ok = ok & (dq - dk < w_eff) & (dk >= 0)   # dk<0 = unwritten ring slot
    zero = torch.zeros((), dtype=torch.float32, device=ok.device)
    return torch.where(ok, zero, NEG_INF)


def gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  window=0, causal: bool = True, q_offset=0, k_offset=0,
                  k_positions=None, k_len=None, q_chunk: int = 1024,
                  kernel: str = "eager") -> torch.Tensor:
    """q: (B, Sq, H, D); k, v: (B, Sk, KV, D) -> (B, Sq, H, D).

    ``q_offset``/``k_offset`` are the absolute positions of q[0]/k[0], an
    int or a per-row (B,) tensor. ``k_positions`` (Sk,) or (B, Sk)
    overrides them with an arbitrary per-slot position vector (ring
    caches; negative = unwritten slot, always masked). ``k_len`` (int or
    (B,)) masks absolute cache positions >= k_len.

    ``kernel="cuda"`` runs the causal self-attend of the scoring forward
    (Sq == Sk, an int window, no k_positions / k_len) through the
    sliding-window kernel's GQA entry (``kernels.ops.swa_attention_gqa``),
    which reads q, k and v in this layout, kv head h // G for query head
    h: nothing is repeated or folded. Its plain version (CPU tensors) is
    the reference's ``kernel="pallas"``: K and V repeated over the G
    query heads, the heads folded into (B·H, S, D).
    """
    check_kernel(kernel)
    B, Sq, H, D = q.shape
    _, Sk, KV, _ = k.shape
    G = H // KV
    if kernel == "cuda":
        if (k_positions is not None or k_len is not None or not causal
                or Sq != Sk or not isinstance(window, int)):
            raise ValueError(
                "kernel='cuda' supports the causal self-attend only "
                "(Sq == Sk, int window, no k_positions/k_len)")
        return ops.swa_attention_gqa(q, k, v, window)
    dev = q.device
    scale = D ** -0.5
    qg = q.reshape(B, Sq, KV, G, D)
    ar_k = torch.arange(Sk, device=dev)
    if k_positions is not None:
        k_pos = k_positions.reshape(-1, Sk)
    else:
        k_pos = _rows(k_offset, dev) + ar_k[None, :]
    q_pos = _rows(q_offset, dev) + torch.arange(Sq, device=dev)[None, :]
    kl = None if k_len is None else _rows(k_len, dev)
    kf, vf = k.float(), v.float()

    def attend(q_blk, qp):
        # f32 scores and p·V, p cast to q's dtype (the reference's
        # preferred_element_type=f32 einsums)
        s = torch.einsum("bckgd,bskd->bckgs", q_blk.float(), kf) * scale
        bias = _mask_bias(qp, k_pos, window, causal)          # (b, C, Sk)
        if kl is not None:
            zero = torch.zeros((), dtype=torch.float32, device=dev)
            bias = bias + torch.where(k_pos < kl, zero, NEG_INF)[:, None, :]
        s = s + bias[:, :, None, None, :]
        p = torch.softmax(s, dim=-1).to(q.dtype)
        return torch.einsum("bckgs,bskd->bckgd", p.float(), vf).to(q.dtype)

    if Sq <= q_chunk:
        out = attend(qg, q_pos)
    else:
        if Sq % q_chunk != 0:
            raise ValueError(
                f"seq len {Sq} not divisible by q_chunk {q_chunk}")
        out = torch.cat([attend(qg[:, i:i + q_chunk], q_pos[:, i:i + q_chunk])
                         for i in range(0, Sq, q_chunk)], dim=1)
    return out.reshape(B, Sq, H, D)


class SeqShard:
    """This rank's block of a cache whose sequence dim is split over mesh
    axes: its first position ``offset``, and the process groups of those
    axes, over which an attend combines."""

    def __init__(self, offset: int, groups: tuple):
        self.offset, self.groups = offset, tuple(groups)

    def __repr__(self) -> str:
        return f"SeqShard(offset={self.offset})"


def sharded_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   shard: SeqShard, *, window=0, causal: bool = True,
                   q_offset=0, k_len=None) -> torch.Tensor:
    """``gqa_attention`` over a cache split on its sequence dim: k, v
    (B, S_local, KV, D) hold positions ``shard.offset + arange(S_local)``.
    Each rank scores its keys in f32, masks them as ``gqa_attention``
    does, and the ranks of ``shard.groups`` combine the row maxima (a MAX
    all-reduce), then the exponential sums and the weighted values (SUM
    all-reduces); the result is their quotient, the reference's softmax
    up to the order of its sums. q: (B, Sq, H, D) -> (B, Sq, H, D)."""
    B, Sq, H, D = q.shape
    S, KV = k.shape[1], k.shape[2]
    G = H // KV
    dev = q.device
    k_pos = (shard.offset + torch.arange(S, device=dev))[None, :]
    q_pos = _rows(q_offset, dev) + torch.arange(Sq, device=dev)[None, :]
    s = torch.einsum("bckgd,bskd->bckgs",
                     q.reshape(B, Sq, KV, G, D).float(), k.float()) \
        * D ** -0.5
    bias = _mask_bias(q_pos, k_pos, window, causal)
    if k_len is not None:
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        bias = bias + torch.where(k_pos < _rows(k_len, dev), zero,
                                  NEG_INF)[:, None, :]
    s = s + bias[:, :, None, None, :]
    m = s.amax(dim=-1, keepdim=True)
    for g in shard.groups:
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=g)
    e = torch.exp(s - m)
    denom = e.sum(dim=-1, keepdim=True)
    o = torch.einsum("bckgs,bskd->bckgd", e, v.float())
    for g in shard.groups:
        dist.all_reduce(denom, group=g)
        dist.all_reduce(o, group=g)
    return (o / denom).to(q.dtype).reshape(B, Sq, H, D)


# ---------------------------------------------------------------------------
# Full attention layer (projections + rope + cache plumbing)
# ---------------------------------------------------------------------------

def init_attn_params(gen: torch.Generator, cfg, num_layers: int,
                     dtype=torch.float32) -> dict:
    init = fan_in_init()
    d, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    L = num_layers
    return {
        "wq": init(gen, (L, d, H * hd), dtype),
        "wk": init(gen, (L, d, KV * hd), dtype),
        "wv": init(gen, (L, d, KV * hd), dtype),
        "wo": init(gen, (L, H * hd, d), dtype),
    }


def _qkv(p, x, cfg, positions):
    """q (B, Sq, H, hd), k and v (B, Sq, KV, hd): H and KV are the heads
    of the weights given, ``cfg``'s or a rank's block of them
    (``sharding.MeshSplit``)."""
    B, Sq, _ = x.shape
    hd = cfg.head_dim
    H, KV = p["wq"].shape[-1] // hd, p["wk"].shape[-1] // hd
    dt = x.dtype
    q = torch.matmul(x, p["wq"].to(dt)).reshape(B, Sq, H, hd)
    k = torch.matmul(x, p["wk"].to(dt)).reshape(B, Sq, KV, hd)
    v = torch.matmul(x, p["wv"].to(dt)).reshape(B, Sq, KV, hd)
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta), v)


def _out_proj(p, out, x):
    B, Sq, _ = x.shape
    return torch.matmul(out.reshape(B, Sq, -1), p["wo"].to(x.dtype))


def _row_ids(pos: torch.Tensor) -> torch.Tensor:
    return torch.arange(pos.shape[0], device=pos.device)


def positions_like(pos: torch.Tensor) -> torch.Tensor:
    """(B,) decode positions -> (B, 1), the RoPE positions of one token."""
    return pos.reshape(-1, 1)


def _eager_heads(kernel: str, heads) -> None:
    if heads is not None and kernel != "eager":
        raise ValueError("the decode on a rank's heads (tensor parallel) "
                         "attends eagerly, as the reference's mesh serve "
                         "step does (kernel='eager')")


def _whole_kv(k, v, heads):
    """The new k / v of every kv head (a cache row holds them all)."""
    return (k, v) if heads is None else (heads.whole_kv(k),
                                         heads.whole_kv(v))


def ring_decode_attend(p, x, *, cfg, ring_k, ring_v, pos: torch.Tensor,
                       window: int, kernel: str = "eager", heads=None):
    """Decode attention against a ring-buffer cache of ``W`` slots.

    x: (B, 1, d); ring_k/v: (B, W, KV, D), slot s holding the latest
    position p ≡ s (mod W); pos: (B,) int32, each row's position. Every
    row writes its new k/v at its own slot ``pos % W`` (in place), then
    attends. Returns (out, (ring_k, ring_v)).

    ``kernel="cuda"`` runs the attend as the ring kernel
    (``kernels.ops.ring_decode_attend``), which maps slots to positions
    and masks inside the kernel.

    ``heads`` (``sharding.Heads``): ``p`` holds the rank's heads and the
    ring every kv head (it is replicated over ``"model"``): the new k / v
    are gathered over ``"model"`` and written whole, then the rank's
    query heads attend against its kv heads' block of the ring, and the
    output is a partial sum over ``"model"``. Eager only.
    """
    check_kernel(kernel)
    _eager_heads(kernel, heads)
    B, Sq, _ = x.shape
    if Sq != 1:
        raise ValueError(f"ring decode takes one token per row, got {Sq}")
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    W = ring_k.shape[1]
    q, k, v = _qkv(p, x, cfg, positions_like(pos))
    k, v = _whole_kv(k, v, heads)
    rows, slot = _row_ids(pos), pos % W
    ring_k[rows, slot] = k[:, 0].to(ring_k.dtype)
    ring_v[rows, slot] = v[:, 0].to(ring_v.dtype)
    if kernel == "cuda":
        o = ops.ring_decode_attend(q[:, 0].reshape(B, KV, H // KV, hd),
                                   ring_k, ring_v, pos, window)
        out = o.reshape(B, 1, H, hd)
    else:
        # absolute position per slot (negative = not yet written -> masked)
        p_col = pos[:, None]
        k_pos = p_col - (p_col - torch.arange(W, device=pos.device)) % W
        rk, rv = (ring_k, ring_v) if heads is None else (
            heads.own_kv(ring_k), heads.own_kv(ring_v))
        out = gqa_attention(q, rk, rv, window=window, causal=True,
                            q_offset=pos, k_positions=k_pos, q_chunk=1)
    return _out_proj(p, out, x), (ring_k, ring_v)


def attn_forward(p, x, *, cfg, window, positions, causal: bool = True,
                 cache=None, cache_index=None, q_chunk: int = 1024,
                 cache_slice_window: int = 0, k_extent: int = 0,
                 kernel: str = "eager", seq_shard: SeqShard | None = None,
                 heads=None):
    """One attention layer (params already per-layer, no leading L).

    cache: optional {"k": (B, S_max, KV, D), "v": ...}, written in place
    at ``cache_index``: an int (prefill from 0) or a (B,) int32 tensor
    (decode, one token per row at its own position). Returns
    (out, cache).

    ``cache_slice_window`` (decode only): attend against the last
    ``cache_slice_window`` cache positions up to each row's own (a
    per-row slice) instead of the whole buffer, so an SWA layer reads
    O(window) of its cache a step. The slice holds every key the window
    lets the query see, so the attend equals the unsliced one.

    ``k_extent`` (decode only): attend against the first ``k_extent``
    cache positions instead of all S_max. With ``k_extent >= pos + 1`` on
    every row this equals the unsliced attend: the dropped positions are
    the ones the ``k_len`` mask zeroes.

    ``kernel="cuda"``: without a cache, the self-attend runs through the
    sliding-window kernel (``gqa_attention``); with one (decode), the
    attend is the extent kernel (``kernels.ops.extent_decode_attend``),
    which reads only the first ``k_extent`` positions and applies the
    ``k_len`` mask itself.

    ``seq_shard`` (decode only): the cache is this rank's block of a
    sequence-split cache. A row's new k/v is written by the rank whose
    block holds its position, and the attend is ``sharded_attend`` over
    the local keys, masked by window and ``k_len`` (so the window slice
    and the K-extent, which only skip keys those masks zero, are not
    needed). Eager only: the decode kernels read whole caches.

    ``heads`` (decode only; ``sharding.Heads``): ``p`` holds the rank's
    query heads, the kv heads they read and ``wo``'s rows of them, so the
    output is a partial sum over ``"model"``. The cache holds every kv
    head: the new k / v are gathered over ``"model"`` and written whole.
    Against a sequence-split cache the query heads are gathered too, the
    attend combines every head across the ranks as above and the rank
    keeps its heads of the output; against a whole cache the rank's query
    heads attend its kv heads' block of it. Eager only.
    """
    check_kernel(kernel)
    _eager_heads(kernel, heads)
    B, Sq, _ = x.shape
    q, k, v = _qkv(p, x, cfg, positions)
    if seq_shard is not None:
        return _sharded_decode(p, x, q, k, v, cache, cache_index, window,
                               causal, kernel, seq_shard, heads)
    if cache is None:
        out = gqa_attention(q, k, v, window=window, causal=causal,
                            q_chunk=q_chunk, kernel=kernel)
        return _out_proj(p, out, x), None
    ck, cv = cache["k"], cache["v"]
    k, v = _whole_kv(k, v, heads)
    own = (lambda c: c) if heads is None else heads.own_kv
    idx = 0 if cache_index is None else cache_index
    if isinstance(idx, torch.Tensor):
        if Sq != 1:
            raise ValueError("per-row cache positions take one token a row")
        rows = _row_ids(idx)
        ck[rows, idx] = k[:, 0].to(ck.dtype)
        cv[rows, idx] = v[:, 0].to(cv.dtype)
    else:
        ck[:, idx:idx + Sq] = k.to(ck.dtype)
        cv[:, idx:idx + Sq] = v.to(cv.dtype)
    S_max = ck.shape[1]
    # k_extent is a host int (the graph's key), not a tensor
    # repro-lint: disable=R2
    sliced = bool(k_extent) and k_extent < S_max
    w_slice = cache_slice_window
    if kernel == "cuda":
        if Sq != 1 or not isinstance(idx, torch.Tensor) or w_slice:
            raise ValueError("kernel='cuda' is the decode attend: one token "
                             "a row at (B,) positions, without "
                             "cache_slice_window")
        H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        o = ops.extent_decode_attend(q[:, 0].reshape(B, KV, H // KV, hd),
                                     ck, cv, idx, window,
                                     k_extent if sliced else S_max)
        out = o.reshape(B, 1, H, hd)
    elif w_slice and w_slice < S_max:        # decode: (B,) positions
        start = torch.clamp(idx + Sq - w_slice, 0, S_max - w_slice)
        take = start[:, None] + torch.arange(w_slice, device=ck.device)
        rows = _row_ids(idx)[:, None]
        ks, vs = own(ck[rows, take]), own(cv[rows, take])
        out = gqa_attention(q, ks, vs, window=window, causal=causal,
                            q_offset=idx, k_offset=start, k_len=idx + Sq,
                            q_chunk=q_chunk)
    else:
        ks, vs = (ck[:, :k_extent], cv[:, :k_extent]) if sliced else (ck, cv)
        ks, vs = own(ks), own(vs)
        out = gqa_attention(q, ks, vs, window=window, causal=causal,
                            q_offset=idx, k_len=idx + Sq, q_chunk=q_chunk)
    return _out_proj(p, out, x), {"k": ck, "v": cv}


def _sharded_decode(p, x, q, k, v, cache, idx, window, causal, kernel,
                    shard: SeqShard, heads=None):
    """``attn_forward``'s decode against this rank's block of a
    sequence-split cache (see there)."""
    if kernel != "eager" or not isinstance(idx, torch.Tensor) \
            or q.shape[1] != 1:
        raise ValueError("a sequence-split cache decodes one token a row at "
                         "(B,) positions, eagerly (kernel='eager')")
    k, v = _whole_kv(k, v, heads)
    if heads is not None:
        q = heads.whole_q(q)
    ck, cv = cache["k"], cache["v"]
    S = ck.shape[1]
    local = idx.long() - shard.offset
    owned = (local >= 0) & (local < S)
    local = local.clamp(0, S - 1)
    rows = _row_ids(idx)
    for c, new in ((ck, k), (cv, v)):
        c[rows, local] = torch.where(owned[:, None, None],
                                     new[:, 0].to(c.dtype), c[rows, local])
    out = sharded_attend(q, ck, cv, shard, window=window, causal=causal,
                         q_offset=idx, k_len=idx + 1)
    if heads is not None:
        out = heads.own_q(out)
    return _out_proj(p, out, x), {"k": ck, "v": cv}

"""Encoder-decoder transformer, the SeamlessM4T backbone (port of
``repro/models/encdec.py``). The audio frontend is a stub: the encoder
takes precomputed frame embeddings.

Encoder: bidirectional self-attention. Decoder: causal self-attention,
then cross-attention to the encoded source. Params are a flat dict keyed
by the reference checkpoint's paths (``enc_layers/attn/wq``,
``dec_layers/xattn/wk``, ``enc_norm`` ...), the layer stacks keeping their
leading ``L`` axis; where the reference ``lax.scan``s over it, the port
runs a Python loop.

The family runs eagerly, as the reference's does: its encoder and
cross-attention are bidirectional, and the sliding-window kernel is
causal only. ``kernel="cuda"`` is refused.

Decode positions are per-row ``(B,)`` int32 tensors, as in ``lm.py``;
the decoder's self-attention cache is written in place.

On a device mesh, as in ``lm.py``: the train step's, the mesh
forward's and the serve step's ``split`` (a ``sharding.MeshSplit``) hands
every function here the rank's stored blocks of the params. Each layer
gathers its leaves over the data axes inside its (checkpointed) body and
computes on the rank's heads (self- and cross-attention) and ``d_ff``
columns, each stack's residual split over ``"model"`` on its own
sequence where that divides the stack's length. The normed encoder
output is the rank's whole source rows, alike on every ``"model"`` rank,
and each decoder layer's cross-attention computes its kv heads of it;
the embedding, the CE and the greedy pick are vocabulary-parallel where
``"model"`` divides V. Without ``split``, ``act_pspec``
(``make_train_step(mesh=)``) keeps each stack's residual between layers
as a DTensor laid out by it, each layer running on the rank's whole rows
of the whole params. Under either, ``loss_fn``'s CE is the whole
batch's. ``decode_step(seq_shards=)`` attends a sequence-split
self-attention (``"k"``) or source (``"enc_k"``) cache across the ranks.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import mlp as mlp_mod
from repro_torch.models.attention import gqa_attention
from repro_torch.models.common import (chunked_lm_nll, fan_in_init,
                                       normal_init, rms_norm)
from repro_torch.models.lm import (_decode_layer, _decode_logits,
                                   _decode_pos, _embed_token, _logits,
                                   _split_embed, _split_head, _store,
                                   batch_ce, layer_params, lm_head_weight,
                                   mesh_of, split_ce)
from repro_torch.sharding.specs import gather_rows, shard_rows
from repro_torch.types import ModelConfig


def _check_kernel(kernel: str) -> None:
    if kernel != "eager":
        raise ValueError(
            f"kernel {kernel!r}: the encoder-decoder runs eagerly (its "
            "encoder and cross-attention are bidirectional; the "
            "sliding-window kernel is causal only)")


def param_shapes(cfg: ModelConfig) -> dict:
    """Every parameter's flat key and shape (the reference's paths)."""
    d, f, V = cfg.d_model, cfg.d_ff, cfg.vocab_size
    Le, Ld = cfg.num_encoder_layers, cfg.num_layers
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    def attn(L):
        return {"wq": (L, d, H * hd), "wk": (L, d, KV * hd),
                "wv": (L, d, KV * hd), "wo": (L, H * hd, d)}

    def mlp(L):
        return {"wg": (L, d, f), "wi": (L, d, f), "wo": (L, f, d)}

    s = {"embed": (V, d), "enc_norm": (d,), "final_norm": (d,)}
    for stack, L, parts in (("enc_layers", Le, {"attn": attn(Le),
                                                "mlp": mlp(Le)}),
                            ("dec_layers", Ld, {"attn": attn(Ld),
                                                "xattn": attn(Ld),
                                                "mlp": mlp(Ld)})):
        for name, shapes in parts.items():
            s.update({f"{stack}/{name}/{k}": v for k, v in shapes.items()})
        norms = ("ln1", "ln2") if stack == "enc_layers" else \
            ("ln1", "lnx", "ln2")
        s.update({f"{stack}/{n}": (L, d) for n in norms})
    if not cfg.tie_embeddings:
        s["lm_head"] = (d, V)
    return s


def init_params(gen: torch.Generator, cfg: ModelConfig, device=None,
                dtype=torch.float32) -> dict:
    """The reference's initialisers (norms zero, embeddings N(0, 0.02²),
    projections fan-in), drawn from ``gen`` on its device, then moved to
    ``device``. Not the reference's numbers: the parity tests convert
    JAX-initialised params."""
    device = resolve_device(device)
    fan_in, embed = fan_in_init(), normal_init(0.02)
    out = {}
    for k, shape in param_shapes(cfg).items():
        leaf = k.rsplit("/", 1)[-1]
        if k in ("embed", "lm_head"):
            out[k] = embed(gen, shape, dtype)
        elif leaf.startswith("ln") or leaf.endswith("norm"):
            out[k] = torch.zeros(shape, dtype=dtype, device=gen.device)
        else:
            out[k] = fan_in(gen, shape, dtype)
    return {k: v.to(device) for k, v in out.items()}


def _enter(split, x):
    """The residual -> the rank's whole rows (``MeshSplit.enter``)."""
    return x if split is None else split.enter(x)


def _leave(split, y, key: str):
    """A sub-block's output -> the residual's layout: a partial sum over
    ``"model"`` where the layout computes on the rank's block of ``key``,
    else rows every ``"model"`` rank computed alike."""
    if split is None:
        return y
    return split.exit_partial(y) if split.splits(key) \
        else split.exit_replicated(y)


def _leaf(params, key: str, split):
    """A leaf outside the stacks, as the layer reads it."""
    return params[key] if split is None else split.gather(key, params[key])


def _run_stack(params, stack: str, n: int, body, x, remat: bool,
               act_pspec=None, split=None):
    """``x = body(x, lp)`` over the layers of ``stack``, each recomputed
    in the backward pass when ``remat`` and autograd records. Under
    ``act_pspec`` the residual between layers is the DTensor laid out by
    it, and ``body`` runs on the rank's whole rows. Under ``split`` ``lp``
    is the layer's blocks, gathered (``MeshSplit.layer``) inside the
    recomputed body."""
    remat = remat and torch.is_grad_enabled()
    run = body
    if split is not None:
        act_pspec = None
        keys = [k for k in params if k.startswith(stack + "/")]

        def run(x, flat):
            return body(x, split.layer(flat, stack))

        def layer(i):
            return {k: params[k][i] for k in keys}
    else:
        def layer(i):
            return layer_params(params, i, stack)
        if act_pspec is not None:
            def run(x, lp):
                return shard_rows(body(gather_rows(x), lp), act_pspec)
            x = shard_rows(x, act_pspec)
    for i in range(n):
        lp = layer(i)
        x = (checkpoint(run, x, lp, use_reentrant=False) if remat
             else run(x, lp))
    return x if act_pspec is None else gather_rows(x)


def encode(params, cfg: ModelConfig, src_embeds: torch.Tensor,
           remat: bool = True, q_chunk: int = 1024,
           act_pspec=None, split=None) -> torch.Tensor:
    """src_embeds: (B, S_src, d) precomputed frame embeddings -> the
    normed encoder output (B, S_src, d). ``act_pspec``: see
    ``_run_stack``. ``split``: ``params`` are the rank's stored blocks
    and ``src_embeds`` its rows; the residual is split over ``"model"``
    on its sequence where that divides S_src, and the output is the
    rank's whole rows, alike on every ``"model"`` rank (its gradient
    parts summed by the all-gather's backward)."""
    S = src_embeds.shape[1]
    positions = torch.arange(S, device=src_embeds.device)
    x = src_embeds
    if split is not None:
        split = split.at_length(S)
        x = split.exit_replicated(x)

    def body(x, lp):
        h = rms_norm(_enter(split, x), lp["ln1"], cfg.norm_eps)
        a, _ = attn_mod.attn_forward(lp["attn"], h, cfg=cfg, window=0,
                                     positions=positions, causal=False,
                                     q_chunk=q_chunk)
        x = x + _leave(split, a, "enc_layers/attn/wq")
        h2 = rms_norm(_enter(split, x), lp["ln2"], cfg.norm_eps)
        return x + _leave(split, mlp_mod.mlp_forward(lp["mlp"], h2, cfg.act),
                          "enc_layers/mlp/wi")

    x = _run_stack(params, "enc_layers", cfg.num_encoder_layers, body, x,
                   remat, act_pspec, split)
    return rms_norm(_enter(split, x), _leaf(params, "enc_norm", split),
                    cfg.norm_eps)


def _cross_attn(xp, h, enc_k, enc_v, cfg: ModelConfig, q_chunk: int,
                seq_shard=None, heads=None):
    """Cross-attention of ``h`` to the source's k / v, on the heads of
    the weights given (``cfg``'s, or a rank's block: its output then a
    partial sum over ``"model"``). ``seq_shard``: ``enc_k`` / ``enc_v``
    are this rank's block of a sequence-split source, attended across
    the ranks (``sharded_attend``). ``heads`` (a decode on the rank's
    heads, ``sharding.Heads``): the source cache holds every kv head;
    against a sequence-split one the query heads are gathered, every
    head attended and the rank keeps its heads of the output, against a
    whole one the rank's query heads attend its kv heads' block."""
    B, Sq, _ = h.shape
    dt = h.dtype
    q = torch.matmul(h, xp["wq"].to(dt)).reshape(B, Sq, -1, cfg.head_dim)
    if seq_shard is not None:
        if heads is not None:
            q = heads.whole_q(q)
        out = attn_mod.sharded_attend(q, enc_k.to(dt), enc_v.to(dt),
                                      seq_shard, window=0, causal=False)
        if heads is not None:
            out = heads.own_q(out)
    else:
        if heads is not None:
            enc_k, enc_v = heads.own_kv(enc_k), heads.own_kv(enc_v)
        out = gqa_attention(q, enc_k.to(dt), enc_v.to(dt), window=0,
                            causal=False, q_chunk=q_chunk)
    return torch.matmul(out.reshape(B, Sq, -1), xp["wo"].to(dt))


def _enc_kv(xp, enc_out, cfg: ModelConfig):
    """The cross-attention's k and v of the source, (B, S_src, KV, hd):
    the kv heads of the weights given (a rank's block, or ``cfg``'s)."""
    B, Sk, _ = enc_out.shape
    hd = cfg.head_dim
    dt = enc_out.dtype
    k = torch.matmul(enc_out, xp["wk"].to(dt)).reshape(B, Sk, -1, hd)
    v = torch.matmul(enc_out, xp["wv"].to(dt)).reshape(B, Sk, -1, hd)
    return k, v


def _dec_layer(cfg: ModelConfig, lp, x, positions, enc_k, enc_v,
               q_chunk: int, split=None, cache=None, pos=None,
               seq_shards=None):
    """One decoder layer: causal self-attention, cross-attention to the
    source's ``enc_k`` / ``enc_v``, the MLP. Returns (x, the
    self-attention's cache entries, or None without ``cache``).
    ``cache`` (decode): the layer's ``{"k", "v"}``, written in place at
    ``pos``; ``seq_shards`` as in ``decode_step``. Under ``split`` ``x``
    is the residual in its layout and ``lp`` the layer's blocks: each
    sub-block runs on the rank's whole rows, on its heads and ``d_ff``
    columns, and leaves by ``_leave``; a decode's caches hold every kv
    head (``sharding.Heads``)."""
    seq_shards = seq_shards or {}

    def heads(block):
        if split is None or cache is None:
            return None
        return split.heads("dec_layers", block)

    h = rms_norm(_enter(split, x), lp["ln1"], cfg.norm_eps)
    a, ac = attn_mod.attn_forward(
        lp["attn"], h, cfg=cfg, window=0, positions=positions, cache=cache,
        cache_index=pos, q_chunk=q_chunk, seq_shard=seq_shards.get("k"),
        heads=heads("attn"))
    x = x + _leave(split, a, "dec_layers/attn/wq")
    hx = rms_norm(_enter(split, x), lp["lnx"], cfg.norm_eps)
    c = _cross_attn(lp["xattn"], hx, enc_k, enc_v, cfg, q_chunk,
                    seq_shards.get("enc_k"), heads("xattn"))
    x = x + _leave(split, c, "dec_layers/xattn/wq")
    h2 = rms_norm(_enter(split, x), lp["ln2"], cfg.norm_eps)
    y = mlp_mod.mlp_forward(lp["mlp"], h2, cfg.act)
    return x + _leave(split, y, "dec_layers/mlp/wi"), ac


def decode_train(params, cfg: ModelConfig, tokens, enc_out,
                 remat: bool = True, q_chunk: int = 1024, act_pspec=None,
                 split=None):
    """Teacher-forced decoder pass. Returns the normed hidden
    (B, S_tgt, d). ``act_pspec``: see ``_run_stack``. ``split``: the
    rank's blocks and rows, ``enc_out`` the rank's whole source rows
    (``encode(split=)``); the residual is split over ``"model"`` on its
    own sequence where that divides S_tgt, the embedding is
    vocabulary-parallel where ``"model"`` splits V, and the hidden
    returned is the rank's whole rows, alike on every ``"model"``
    rank."""
    S = tokens.shape[1]
    if split is None:
        x = params["embed"][tokens].to(enc_out.dtype)
    else:
        split = split.at_length(S)
        x = _split_embed(params, cfg, tokens, None, enc_out.dtype, split)
    positions = torch.arange(S, device=x.device)

    def body(x, lp):
        ek, ev = _enc_kv(lp["xattn"], enc_out, cfg)
        return _dec_layer(cfg, lp, x, positions, ek, ev, q_chunk, split)[0]

    x = _run_stack(params, "dec_layers", cfg.num_layers, body, x, remat,
                   act_pspec, split)
    return rms_norm(_enter(split, x), _leaf(params, "final_norm", split),
                    cfg.norm_eps)


def logits_fn(params, cfg: ModelConfig, batch: dict, remat: bool = False,
              q_chunk: int = 1024, kernel: str = "eager", split=None):
    """Full decoder logits (B, S_tgt, V), unchunked. batch: src_embeds
    (B, S_src, d), tokens (B, S_tgt). Under ``split`` (the rank's blocks
    and rows) the rank's vocabulary block of them where ``"model"``
    splits V."""
    _check_kernel(kernel)
    enc_out = encode(params, cfg, batch["src_embeds"], remat=remat,
                     q_chunk=q_chunk, split=split)
    hidden = decode_train(params, cfg, batch["tokens"], enc_out,
                          remat=remat, q_chunk=q_chunk, split=split)
    if split is None:
        return _logits(params, cfg, hidden)
    return torch.matmul(hidden, _split_head(params, cfg, split)
                        .to(hidden.dtype))


def loss_fn(params, cfg: ModelConfig, batch: dict, remat: bool = True,
            q_chunk: int = 1024, loss_chunk: int = 512, dtype=None,
            act_pspec=None, kernel: str = "eager", split=None):
    """Next-token CE. batch: src_embeds (B, S_src, d), tokens (B, S_tgt),
    labels (B, S_tgt). Returns (loss, {"ce", "aux"}), aux a zero. Under
    ``act_pspec`` or ``split`` the batch is the rank's rows and the CE
    the whole batch's; under ``split`` it is ``lm.split_ce``'s, on the
    rank's block of the head."""
    _check_kernel(kernel)
    src = batch["src_embeds"]
    if dtype is not None:
        src = src.to(dtype)
    enc_out = encode(params, cfg, src, remat=remat, q_chunk=q_chunk,
                     act_pspec=act_pspec, split=split)
    hidden = decode_train(params, cfg, batch["tokens"], enc_out,
                          remat=remat, q_chunk=q_chunk, act_pspec=act_pspec,
                          split=split)
    if split is None:
        head = lm_head_weight(params, cfg).to(hidden.dtype)
        ce = batch_ce(*chunked_lm_nll(hidden, head, batch["labels"],
                                      chunk=loss_chunk), mesh_of(act_pspec))
    else:
        ce = split_ce(params, cfg, hidden, batch["labels"], loss_chunk,
                      split)
    return ce, {"ce": ce, "aux": torch.zeros((), dtype=torch.float32,
                                             device=ce.device)}


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, src_len: int, tgt_len: int,
               dtype=torch.bfloat16, device=None) -> dict:
    device = resolve_device(device)
    Ld, KV, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim

    def zeros(S):
        return torch.zeros((Ld, batch, S, KV, hd), dtype=dtype,
                           device=device)

    return {"enc_k": zeros(src_len), "enc_v": zeros(src_len),
            "k": zeros(tgt_len), "v": zeros(tgt_len)}


def prefill(params, cfg: ModelConfig, src_embeds, cache,
            q_chunk: int = 1024) -> dict:
    """Encode the source and precompute every decoder layer's
    cross-attention K/V. Returns a new cache dict whose ``enc_k`` /
    ``enc_v`` are the source's (its length, the cache's dtype), the
    self-attention buffers those of ``cache``."""
    enc_out = encode(params, cfg, src_embeds, remat=False, q_chunk=q_chunk)
    ks, vs = zip(*(_enc_kv(layer_params(params, i, "dec_layers")["xattn"],
                           enc_out, cfg) for i in range(cfg.num_layers)))
    cache = dict(cache)
    cache["enc_k"] = torch.stack(ks).to(cache["enc_k"].dtype)
    cache["enc_v"] = torch.stack(vs).to(cache["enc_v"].dtype)
    return cache


def decode_step(params, cfg: ModelConfig, token, cache, pos, dtype=None,
                seq_shards=None, split=None):
    """One target-token step. token: (B,) int; pos: (B,) int32 positions
    (or one int for all rows). Returns (logits (B, V), cache), the
    self-attention cache written in place. ``seq_shards``: ``{"k":
    SeqShard, "enc_k": SeqShard}`` for the entries that are this rank's
    block of a sequence-split cache. ``split`` (a ``sharding.MeshSplit``
    without a sequence split: the mesh serve step): ``params`` are the
    rank's stored blocks, each decoder layer's gathered inside the loop
    and dropped after it; the layer computes on the rank's heads (self-
    and cross-attention against caches that hold every kv head) and
    ``d_ff`` columns, its partial sums all-reduced over ``"model"``; the
    embedding and the logits are the rank's vocabulary block where
    ``"model"`` splits V."""
    x = _embed_token(params, cfg, token, dtype, split)
    pos = _decode_pos(pos, x.shape[0], x.device)
    positions = attn_mod.positions_like(pos)
    for i in range(cfg.num_layers):
        lp = _decode_layer(params, i, split, "dec_layers")
        x, ac = _dec_layer(cfg, lp, x, positions, cache["enc_k"][i],
                           cache["enc_v"][i], 1, split,
                           cache={"k": cache["k"][i], "v": cache["v"][i]},
                           pos=pos, seq_shards=seq_shards)
        for key in ("k", "v"):
            _store(cache, key, i, ac[key])
        del lp
    return _decode_logits(params, cfg, x, split), cache

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

On a device mesh, as in ``lm.py``: ``act_pspec`` keeps each stack's
residual between layers as a DTensor laid out by it (its sequence dim
split over ``"model"`` where that divides the stack's own length), each
layer running on the rank's whole rows; ``loss_fn``'s CE is the whole
batch's; ``decode_step(seq_shards=)`` attends a sequence-split
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
                                   _store, batch_ce, layer_params,
                                   lm_head_weight, mesh_of)
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


def _run_stack(params, stack: str, n: int, body, x, remat: bool,
               act_pspec=None):
    """``x = body(x, lp)`` over the layers of ``stack``, each recomputed
    in the backward pass when ``remat`` and autograd records. Under
    ``act_pspec`` the residual between layers is the DTensor laid out by
    it, and ``body`` runs on the rank's whole rows."""
    remat = remat and torch.is_grad_enabled()
    run = body
    if act_pspec is not None:
        def run(x, lp):
            return shard_rows(body(gather_rows(x), lp), act_pspec)
        x = shard_rows(x, act_pspec)
    for i in range(n):
        lp = layer_params(params, i, stack)
        x = (checkpoint(run, x, lp, use_reentrant=False) if remat
             else run(x, lp))
    return x if act_pspec is None else gather_rows(x)


def encode(params, cfg: ModelConfig, src_embeds: torch.Tensor,
           remat: bool = True, q_chunk: int = 1024,
           act_pspec=None) -> torch.Tensor:
    """src_embeds: (B, S_src, d) precomputed frame embeddings -> the
    normed encoder output (B, S_src, d). ``act_pspec``: see
    ``_run_stack``."""
    positions = torch.arange(src_embeds.shape[1], device=src_embeds.device)

    def body(x, lp):
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        a, _ = attn_mod.attn_forward(lp["attn"], h, cfg=cfg, window=0,
                                     positions=positions, causal=False,
                                     q_chunk=q_chunk)
        x = x + a
        h2 = rms_norm(x, lp["ln2"], cfg.norm_eps)
        return x + mlp_mod.mlp_forward(lp["mlp"], h2, cfg.act)

    x = _run_stack(params, "enc_layers", cfg.num_encoder_layers, body,
                   src_embeds, remat, act_pspec)
    return rms_norm(x, params["enc_norm"], cfg.norm_eps)


def _cross_attn(xp, h, enc_k, enc_v, cfg: ModelConfig, q_chunk: int,
                seq_shard=None):
    B, Sq, _ = h.shape
    H, hd = cfg.num_heads, cfg.head_dim
    q = torch.matmul(h, xp["wq"].to(h.dtype)).reshape(B, Sq, H, hd)
    if seq_shard is not None:
        out = attn_mod.sharded_attend(q, enc_k.to(h.dtype),
                                      enc_v.to(h.dtype), seq_shard,
                                      window=0, causal=False)
    else:
        out = gqa_attention(q, enc_k.to(h.dtype), enc_v.to(h.dtype),
                            window=0, causal=False, q_chunk=q_chunk)
    return torch.matmul(out.reshape(B, Sq, H * hd), xp["wo"].to(h.dtype))


def _enc_kv(xp, enc_out, cfg: ModelConfig):
    B, Sk, _ = enc_out.shape
    KV, hd = cfg.num_kv_heads, cfg.head_dim
    dt = enc_out.dtype
    k = torch.matmul(enc_out, xp["wk"].to(dt)).reshape(B, Sk, KV, hd)
    v = torch.matmul(enc_out, xp["wv"].to(dt)).reshape(B, Sk, KV, hd)
    return k, v


def decode_train(params, cfg: ModelConfig, tokens, enc_out,
                 remat: bool = True, q_chunk: int = 1024, act_pspec=None):
    """Teacher-forced decoder pass. Returns the normed hidden
    (B, S_tgt, d). ``act_pspec``: see ``_run_stack``."""
    x = params["embed"][tokens].to(enc_out.dtype)
    positions = torch.arange(x.shape[1], device=x.device)

    def body(x, lp):
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        a, _ = attn_mod.attn_forward(lp["attn"], h, cfg=cfg, window=0,
                                     positions=positions, q_chunk=q_chunk)
        x = x + a
        hx = rms_norm(x, lp["lnx"], cfg.norm_eps)
        ek, ev = _enc_kv(lp["xattn"], enc_out, cfg)
        x = x + _cross_attn(lp["xattn"], hx, ek, ev, cfg, q_chunk)
        h2 = rms_norm(x, lp["ln2"], cfg.norm_eps)
        return x + mlp_mod.mlp_forward(lp["mlp"], h2, cfg.act)

    x = _run_stack(params, "dec_layers", cfg.num_layers, body, x, remat,
                   act_pspec)
    return rms_norm(x, params["final_norm"], cfg.norm_eps)


def logits_fn(params, cfg: ModelConfig, batch: dict, remat: bool = False,
              q_chunk: int = 1024, kernel: str = "eager"):
    """Full decoder logits (B, S_tgt, V), unchunked. batch: src_embeds
    (B, S_src, d), tokens (B, S_tgt)."""
    _check_kernel(kernel)
    enc_out = encode(params, cfg, batch["src_embeds"], remat=remat,
                     q_chunk=q_chunk)
    hidden = decode_train(params, cfg, batch["tokens"], enc_out,
                          remat=remat, q_chunk=q_chunk)
    return _logits(params, cfg, hidden)


def loss_fn(params, cfg: ModelConfig, batch: dict, remat: bool = True,
            q_chunk: int = 1024, loss_chunk: int = 512, dtype=None,
            act_pspec=None, kernel: str = "eager"):
    """Next-token CE. batch: src_embeds (B, S_src, d), tokens (B, S_tgt),
    labels (B, S_tgt). Returns (loss, {"ce", "aux"}), aux a zero. Under
    ``act_pspec`` the batch is the rank's rows and the CE the whole
    batch's."""
    _check_kernel(kernel)
    src = batch["src_embeds"]
    if dtype is not None:
        src = src.to(dtype)
    enc_out = encode(params, cfg, src, remat=remat, q_chunk=q_chunk,
                     act_pspec=act_pspec)
    hidden = decode_train(params, cfg, batch["tokens"], enc_out,
                          remat=remat, q_chunk=q_chunk, act_pspec=act_pspec)
    head = lm_head_weight(params, cfg).to(hidden.dtype)
    ce = batch_ce(*chunked_lm_nll(hidden, head, batch["labels"],
                                  chunk=loss_chunk), mesh_of(act_pspec))
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
    whose layout keeps every leaf whole: the mesh serve step):
    ``params`` are the rank's stored blocks, each decoder layer's
    gathered inside the loop and dropped after it, the embedding, the
    last norm and the head where they are used."""
    seq_shards = seq_shards or {}
    x = _embed_token(params, cfg, token, dtype, split)
    pos = _decode_pos(pos, x.shape[0], x.device)
    positions = attn_mod.positions_like(pos)
    for i in range(cfg.num_layers):
        lp = _decode_layer(params, i, split, "dec_layers")
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        a, ac = attn_mod.attn_forward(
            lp["attn"], h, cfg=cfg, window=0, positions=positions,
            cache={"k": cache["k"][i], "v": cache["v"][i]}, cache_index=pos,
            q_chunk=1, seq_shard=seq_shards.get("k"))
        x = x + a
        hx = rms_norm(x, lp["lnx"], cfg.norm_eps)
        x = x + _cross_attn(lp["xattn"], hx, cache["enc_k"][i],
                            cache["enc_v"][i], cfg, q_chunk=1,
                            seq_shard=seq_shards.get("enc_k"))
        h2 = rms_norm(x, lp["ln2"], cfg.norm_eps)
        x = x + mlp_mod.mlp_forward(lp["mlp"], h2, cfg.act)
        for key in ("k", "v"):
            _store(cache, key, i, ac[key])
        del lp
    return _decode_logits(params, cfg, x, split), cache

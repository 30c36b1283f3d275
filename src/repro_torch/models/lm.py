"""Decoder-only LM for the dense / moe / ssm / hybrid / vlm families:
params, the scoring forward (``forward_hidden``, ``loss_fn``,
``logits_fn``), bucketed prefill and KV/SSM-cache decode (port of
``repro/models/lm.py``).

Params are a flat dict keyed by the reference checkpoint's paths
(``embed``, ``layers/attn/wq``, ``layers/ssm/in_proj``, ``final_norm``
...). Layer params keep the reference's leading ``L`` axis; where the
reference ``lax.scan``s over it, the port runs a plain Python loop, each
layer's window a Python int. That lets the scoring forward take the
reference's kernel switches of ``gqa_attention`` and ``ssm_forward`` one
level up: ``kernel="cuda"`` runs every layer's attend and SSD scan through
the hand-written kernels, ``"eager"`` (the default) is op for op the
reference's forward. The reference cannot: its scanned window is a traced
scalar, and its attention kernel needs a static one.

Decode positions are per-row ``(B,)`` int32 tensors (the reference
decodes at one scalar position and ``vmap``s over the serving slots).
Caches are updated in place and returned. The ring layout
(``init_ring_cache``, ``to_ring_cache``) is decoded by
``decode_step_grouped`` and ``decode_step_ring``.

The moe family's FFN is ``models/moe.py``: capacity routing in the
scoring and training forward (mode "train"), dropless routing in prefill
and decode, its switch-style aux loss summed over the layers into
``loss_fn``'s loss. The vlm family prepends a prefix of patch embeddings
(``prefix_embeds``) to the token embeddings and attends it causally, as
the reference's forward does.

On a device mesh (``launch/steps.py``) every function here runs on the
rank's own tensors. The train step's and the mesh forward's ``split`` (a
``sharding.MeshSplit``) hands ``forward_hidden`` and ``loss_fn`` the
rank's stored blocks of the params: each layer gathers its leaves over
the data axes inside its checkpointed body and computes on the rank's
heads, SSD heads, ``d_ff`` columns, experts and vocabulary rows, the
residual split over ``"model"`` on its sequence between layers
(``_split_layer``).
The serve step's ``split`` does the same for the decode steps, a layer's
blocks gathered inside the layer loop, on the rank's rows and its block
of the decode cache. Without ``split`` they take whole params and the
rank's rows of the batch (split over the data axes). ``act_pspec`` (a
``sharding.NamedSpec``) keeps the residual stream
between layers as a DTensor laid out by it (its sequence dim split over
``"model"``: sequence parallelism of what ``remat`` stores), and each
layer gathers the rank's whole rows before it runs, so the attend and
the SSD scan, and their kernels, always see whole heads and whole
sequences on plain local tensors. ``moe_ctx`` runs the MoE layers'
distributed dispatch (``models/moe.py``). Under either, ``loss_fn``'s CE
is the whole batch's: its sums over the data axes. ``seq_shards`` on the
decode steps names the cache entries whose sequence dim is split
(``attention.SeqShard``).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device, same_memory
from repro_torch.models import attention as attn_mod
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import chunked_lm_nll, normal_init, rms_norm
from repro_torch.sharding.specs import (data_axes, gather_rows, psum_axes,
                                        shard_rows)
from repro_torch.types import ModelConfig

FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(f"{cfg.family}: not a decoder-only LM family "
                         f"{FAMILIES}")


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

def windows(cfg: ModelConfig) -> torch.Tensor:
    return torch.tensor([cfg.window_for_layer(i)
                         for i in range(cfg.num_layers)], dtype=torch.int32)


def param_shapes(cfg: ModelConfig) -> dict:
    """Every parameter's flat key and shape (the reference's ``_flatten``
    paths; einsum weights keep their (d_in, d_out) layout)."""
    _check_family(cfg)
    L, d, V = cfg.num_layers, cfg.d_model, cfg.vocab_size
    s = {"embed": (V, d), "final_norm": (d,), "layers/ln1": (L, d)}
    if cfg.family != "ssm":
        H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        s.update({"layers/ln2": (L, d),
                  "layers/attn/wq": (L, d, H * hd),
                  "layers/attn/wk": (L, d, KV * hd),
                  "layers/attn/wv": (L, d, KV * hd),
                  "layers/attn/wo": (L, H * hd, d)})
    if cfg.family == "moe":
        s.update({f"layers/moe/{k}": v for k, v in moe_mod.param_shapes(
            d, cfg.d_ff, cfg.moe, L).items()})
    elif cfg.family != "ssm":
        f = cfg.d_ff
        s.update({"layers/mlp/wg": (L, d, f), "layers/mlp/wi": (L, d, f),
                  "layers/mlp/wo": (L, f, d)})
    if cfg.family in ("ssm", "hybrid"):
        di, nh, conv_dim = ssm_mod.dims(d, cfg.ssm)
        proj_out = 2 * di + 2 * cfg.ssm.d_state + nh
        s.update({"layers/ssm/in_proj": (L, d, proj_out),
                  "layers/ssm/conv_w": (L, cfg.ssm.d_conv, conv_dim),
                  "layers/ssm/conv_b": (L, conv_dim),
                  "layers/ssm/A_log": (L, nh), "layers/ssm/D": (L, nh),
                  "layers/ssm/dt_bias": (L, nh), "layers/ssm/norm": (L, di),
                  "layers/ssm/out_proj": (L, di, d)})
    if cfg.family == "hybrid":
        s["layers/branch_norm_attn"] = (L, d)
        s["layers/branch_norm_ssm"] = (L, d)
    if not cfg.tie_embeddings:
        s["lm_head"] = (d, V)
    return s


def init_params(gen: torch.Generator, cfg: ModelConfig, device=None,
                dtype=torch.float32) -> dict:
    """The reference's initialisers, drawn from ``gen`` on the
    generator's device (a CUDA generator draws full-width weights on the
    card), then moved to ``device``. Not the reference's numbers: the
    parity tests convert JAX-initialised params instead."""
    _check_family(cfg)
    device = resolve_device(device)
    L, d = cfg.num_layers, cfg.d_model
    zeros = lambda *shape: torch.zeros(shape, dtype=dtype, device=gen.device)
    layers = {"ln1": zeros(L, d)}
    if cfg.family != "ssm":
        layers["ln2"] = zeros(L, d)
        layers["attn"] = attn_mod.init_attn_params(gen, cfg, L, dtype)
    if cfg.family == "moe":
        layers["moe"] = moe_mod.init_moe_params(gen, d, cfg.d_ff, cfg.moe, L,
                                                dtype)
    elif cfg.family != "ssm":
        layers["mlp"] = mlp_mod.init_mlp_params(gen, d, cfg.d_ff, L, dtype)
    if cfg.family in ("ssm", "hybrid"):
        layers["ssm"] = ssm_mod.init_ssm_params(gen, d, cfg.ssm, L, dtype)
    if cfg.family == "hybrid":
        layers["branch_norm_attn"] = zeros(L, d)
        layers["branch_norm_ssm"] = zeros(L, d)
    flat = {"embed": normal_init(0.02)(gen, (cfg.vocab_size, d), dtype),
            "final_norm": zeros(d)}
    for k, v in layers.items():
        if isinstance(v, dict):
            flat.update({f"layers/{k}/{kk}": vv for kk, vv in v.items()})
        else:
            flat[f"layers/{k}"] = v
    if not cfg.tie_embeddings:
        flat["lm_head"] = normal_init(0.02)(gen, (d, cfg.vocab_size), dtype)
    return {k: v.to(device) for k, v in flat.items()}


def layer_params(params: dict, i: int, stack: str = "layers") -> dict:
    """Layer ``i``'s params as the nested dict the layer body reads
    (``{"ln1": ..., "attn": {"wq": ...}, ...}``), views into the stacks
    keyed ``<stack>/...`` (the encoder-decoder's are ``enc_layers`` and
    ``dec_layers``)."""
    out: dict = {}
    for k, v in params.items():
        if not k.startswith(stack + "/"):
            continue
        parts = k.split("/")[1:]
        node = out
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = v[i]
    return out


def lm_head_weight(params, cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        return params["embed"].T
    return params["lm_head"]


# ---------------------------------------------------------------------------
# Layer body — one code path for train / prefill / decode
# ---------------------------------------------------------------------------

def _run_ssm(cfg: ModelConfig, lp, h, mode: str, cache, seq_lens, kernel,
             heads=None):
    """The layer's SSM mixer: (out, (state, conv state)); under ``heads``
    (a ``sharding.SSMHeads``) on the rank's SSD heads, ``out`` a partial
    sum."""
    if mode == "decode":
        return ssm_mod.ssm_decode_step(lp["ssm"], h, cfg.ssm,
                                       cache["ssm_state"],
                                       cache["conv_state"], kernel=kernel,
                                       heads=heads)
    return ssm_mod.ssm_forward(lp["ssm"], h, cfg.ssm, seq_lens=seq_lens,
                               kernel=kernel if mode == "train" else "eager",
                               heads=heads)


def _run_attn(cfg: ModelConfig, lp, h, window: int, positions, mode: str,
              cache, pos, q_chunk: int, k_extent: int, kernel: str,
              cache_slice_window: int, seq_shard, heads=None):
    """The layer's attention: (out, its cache entries or None)."""
    if mode == "train":
        return attn_mod.attn_forward(lp["attn"], h, cfg=cfg, window=window,
                                     positions=positions, q_chunk=q_chunk,
                                     kernel=kernel)
    if "k_win" in cache:     # ring-buffer SWA decode
        a, (rk, rv) = attn_mod.ring_decode_attend(
            lp["attn"], h, cfg=cfg, ring_k=cache["k_win"],
            ring_v=cache["v_win"], pos=pos, window=window, kernel=kernel,
            heads=heads)
        return a, {"k_win": rk, "v_win": rv}
    idx = 0 if mode == "prefill" else pos
    kern = kernel if mode == "decode" else "eager"
    return attn_mod.attn_forward(
        lp["attn"], h, cfg=cfg, window=window, positions=positions,
        cache={"k": cache["k"], "v": cache["v"]}, cache_index=idx,
        q_chunk=q_chunk, cache_slice_window=cache_slice_window,
        k_extent=k_extent, kernel=kern, seq_shard=seq_shard, heads=heads)


def _layer(cfg: ModelConfig, lp, x, window: int, positions, mode: str,
           cache=None, pos=None, q_chunk: int = 1024, k_extent: int = 0,
           seq_lens=None, kernel: str = "eager",
           cache_slice_window: int = 0, moe_ctx=None, seq_shard=None):
    """One layer. mode: 'train' | 'prefill' | 'decode'. Returns (x, aux,
    new_cache): ``aux`` the MoE layer's load-balance loss (None for the
    other families); 'train' takes no cache and returns None for it. The
    MoE FFN routes with capacity in 'train' and dropless otherwise.

    ``seq_lens`` (B,) marks right-padded bucketed-prefill rows: attention
    needs no mask (pad keys sit at positions the causal mask already
    hides from real queries) but the SSM recurrence does (``ssm_forward``).

    The attention cache is uniform (``{"k", "v"}``) or a ring
    (``{"k_win", "v_win"}``, decode only); ``new_cache`` mirrors it, the
    attention entries being the cache views written in place and the SSM
    entries new tensors (but for the SSM state of a CUDA-kernel decode,
    also updated in place). ``k_extent`` bounds a uniform-cache decode's
    attend, ``cache_slice_window`` slices it to the last positions
    (``attn_forward``). ``kernel`` ("eager" or "cuda") picks the
    scoring kernels in 'train' mode and the decode kernels in 'decode';
    prefill runs eager. ``moe_ctx`` (mode 'train') runs the MoE layer's
    distributed dispatch; ``seq_shard`` (decode) marks a uniform cache as
    this rank's block of a sequence-split one.
    """
    train = mode == "train"
    aux = None
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)

    if cfg.family == "ssm":
        out, (st, cs) = _run_ssm(cfg, lp, h, mode, cache, seq_lens, kernel)
        return x + out, aux, None if train else {"ssm_state": st,
                                                 "conv_state": cs}

    a, new_cache = _run_attn(cfg, lp, h, window, positions, mode, cache, pos,
                             q_chunk, k_extent, kernel, cache_slice_window,
                             seq_shard)
    if cfg.family == "hybrid":
        s, (st, cs) = _run_ssm(cfg, lp, h, mode, cache, seq_lens, kernel)
        mixed = 0.5 * (rms_norm(a, lp["branch_norm_attn"], cfg.norm_eps)
                       + rms_norm(s, lp["branch_norm_ssm"], cfg.norm_eps))
        x = x + mixed.to(x.dtype)
        if not train:
            new_cache = {**new_cache, "ssm_state": st, "conv_state": cs}
    else:
        x = x + a
    h2 = rms_norm(x, lp["ln2"], cfg.norm_eps)
    if cfg.family == "moe":
        y, aux = moe_mod.moe_forward(lp["moe"], h2, cfg.moe, cfg.act,
                                     moe_ctx=moe_ctx, dropless=not train)
    else:
        y = mlp_mod.mlp_forward(lp["mlp"], h2, cfg.act)
    return x + y, aux, new_cache


def _store(cache: dict, key: str, j: int, val: torch.Tensor) -> None:
    """Write layer ``j``'s new ``key`` entry into the stacked cache (the
    attention entries, and a CUDA-kernel decode's SSM state, were written
    in place already)."""
    dst = cache[key][j]
    if not same_memory(val, dst):
        dst.copy_(val)


def _split_layer(cfg: ModelConfig, lp, x, window: int, positions,
                 q_chunk: int, kernel: str, moe_ctx, split,
                 mode: str = "train", cache=None, pos=None,
                 k_extent: int = 0, cache_slice_window: int = 0,
                 seq_shard=None):
    """One layer under tensor parallelism: ``x`` is the residual in
    ``split``'s layout, ``lp`` the blocks ``split.layer`` gathered. Each
    sub-block runs on the rank's whole rows (``enter``): attention on its
    heads, the SSM mixer on its SSD heads (``sharding.SSMHeads``) and the
    MLP on its ``d_ff`` columns, leaving as partial sums
    (``exit_partial``); the leaves gathered over ``"model"`` (a mixer or
    attention whose heads ``"model"`` does not divide) compute alike on
    every rank (``exit_replicated``). In the hybrid block a split
    branch's output is summed (``split.reduce``) before its branch norm.
    Returns (x, aux, new_cache), as ``_layer``.

    mode 'train' scores or trains; 'decode' (the mesh serve step, one
    token a row, ``split`` without a sequence split) reads and writes the
    layer's ``cache`` as ``_layer`` does, the attention on the rank's
    heads (``sharding.Heads``), the SSM mixer on its block of the SSM
    state (the conv state whole on every rank), and a MoE block on the
    local dropless path over the rank's experts or ``d_ff`` columns."""
    train = mode == "train"
    aux = None
    h = rms_norm(split.enter(x), lp["ln1"], cfg.norm_eps)
    heads = split.heads()
    ssm_heads = split.ssm_heads()

    def ssm(h):
        return _run_ssm(cfg, lp, h, mode, cache, None, kernel, ssm_heads)

    if cfg.family == "ssm":
        out, (st, cs) = ssm(h)
        out = split.exit_partial(out) if ssm_heads \
            else split.exit_replicated(out)
        return x + out, aux, None if train else {"ssm_state": st,
                                                 "conv_state": cs}
    a, new_cache = _run_attn(cfg, lp, h, window, positions, mode, cache, pos,
                             q_chunk, k_extent, kernel, cache_slice_window,
                             seq_shard, heads)
    if cfg.family == "hybrid":
        if heads:
            a = split.reduce(a)
        s, (st, cs) = ssm(h)
        if ssm_heads:
            s = split.reduce(s)
        mixed = 0.5 * (rms_norm(a, lp["branch_norm_attn"], cfg.norm_eps)
                       + rms_norm(s, lp["branch_norm_ssm"], cfg.norm_eps))
        x = x + split.exit_replicated(mixed.to(x.dtype))
        if not train:
            new_cache = {**new_cache, "ssm_state": st, "conv_state": cs}
    else:
        x = x + (split.exit_partial(a) if heads
                 else split.exit_replicated(a))
    h2 = rms_norm(split.enter(x), lp["ln2"], cfg.norm_eps)
    if cfg.family == "moe":
        y, aux = moe_mod.moe_forward(lp["moe"], h2, cfg.moe, cfg.act,
                                     moe_ctx=moe_ctx, dropless=not train,
                                     split=split)
        partial = moe_mod.split_partial(split, moe_ctx)
    else:
        y = mlp_mod.mlp_forward(lp["mlp"], h2, cfg.act)
        partial = split.splits("layers/mlp/wi")
    return x + (split.exit_partial(y) if partial
                else split.exit_replicated(y)), aux, new_cache


def _split_embed(params, cfg: ModelConfig, tokens, prefix_embeds, dtype,
                 split):
    """``embed_inputs`` on the rank's block of ``embed``, in ``split``'s
    residual layout. Vocabulary-parallel where ``"model"`` splits V: the
    rank looks up the tokens its rows hold, zeros elsewhere, and the
    partial sums are reduce-scattered (the prefix, every rank's alike,
    rides on ``"model"`` rank 0)."""
    table = split.gather("embed", params["embed"])
    if not split.vocab:
        return split.exit_replicated(embed_inputs(
            {"embed": table}, cfg, tokens, prefix_embeds, dtype))
    V = table.shape[0]
    local = tokens.long() - split.vocab_offset(V)
    own = (local >= 0) & (local < V)
    x = torch.where(own[..., None], table[local.clamp(0, V - 1)], 0.0)
    if dtype is not None:
        x = x.to(dtype)
    if cfg.prefix_len and prefix_embeds is not None:
        x = torch.cat([split.to_partial(prefix_embeds.to(x.dtype)), x],
                      dim=1)
    return split.exit_partial(x)


def _split_head(params, cfg: ModelConfig, split) -> torch.Tensor:
    """The rank's block of the LM head, (d, V / M) where ``"model"``
    splits the vocabulary, else (d, V)."""
    if cfg.tie_embeddings:
        return split.gather("embed", params["embed"]).T
    return split.gather("lm_head", params["lm_head"])


def embed_inputs(params, cfg: ModelConfig, tokens: torch.Tensor,
                 prefix_embeds=None, dtype=None) -> torch.Tensor:
    x = params["embed"][tokens]
    if dtype is not None:
        x = x.to(dtype)
    if cfg.prefix_len and prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    return x


def _logits(params, cfg: ModelConfig, last: torch.Tensor) -> torch.Tensor:
    return torch.matmul(last, lm_head_weight(params, cfg).to(last.dtype))


# ---------------------------------------------------------------------------
# Forward (training / scoring)
# ---------------------------------------------------------------------------

def forward_hidden(params, cfg: ModelConfig, tokens: torch.Tensor,
                   prefix_embeds=None, remat: bool = True,
                   q_chunk: int = 1024, dtype=None, act_pspec=None,
                   moe_ctx=None, kernel: str = "eager", split=None):
    """Returns (hidden (B, S, d), aux_loss).

    ``kernel="cuda"`` runs each layer's attend (``gqa_attention``) and SSD
    scan (``ssm_forward``) through the hand-written kernels, one launch of
    each a layer; they have no backward, so that path scores under
    ``torch.no_grad()``. ``remat`` recomputes each layer in the backward
    pass (``torch.utils.checkpoint``) when autograd records. The MoE
    layers' aux losses are summed in layer order into ``aux_loss`` (an
    f32 zero for the other families).

    ``act_pspec`` (a ``NamedSpec``, ``launch.steps.act_pspec``): between
    layers the residual is a DTensor laid out by it, its sequence dim
    split over ``"model"`` where that divides it; each layer gathers the
    rank's whole rows (``gather_rows``) and its output is split again
    (``shard_rows``), so under ``remat`` the stored residuals are the
    split ones. ``tokens`` are then the rank's rows of the batch, and so
    is the hidden returned. ``moe_ctx``: the MoE layers' distributed
    dispatch (``models/moe.py``).

    ``split`` (a ``sharding.MeshSplit``; ``act_pspec`` then unused):
    ``params`` are the rank's stored blocks, ``tokens`` its rows. Each
    layer's leaves are gathered over the data axes inside its
    checkpointed body (recomputed in the backward pass, as the
    reference's scan does), so a rank holds one layer's blocks beyond its
    own storage; the layer computes on its blocks (``_split_layer``).
    The hidden returned is the rank's whole rows, alike on every
    ``"model"`` rank.
    """
    _check_family(cfg)
    attn_mod.check_kernel(kernel)
    if split is not None:
        return _split_forward(params, cfg, tokens, prefix_embeds, remat,
                              q_chunk, dtype, moe_ctx, kernel, split)
    x = embed_inputs(params, cfg, tokens, prefix_embeds, dtype)
    positions = torch.arange(x.shape[1], device=x.device)
    remat = remat and torch.is_grad_enabled()

    def body(x, lp, window):
        if act_pspec is not None:
            x = gather_rows(x)
        x, a = _layer(cfg, lp, x, window, positions, "train",
                      q_chunk=q_chunk, kernel=kernel, moe_ctx=moe_ctx)[:2]
        return (x if act_pspec is None else shard_rows(x, act_pspec)), a

    if act_pspec is not None:
        x = shard_rows(x, act_pspec)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.num_layers):
        lp, window = layer_params(params, i), cfg.window_for_layer(i)
        x, a = (checkpoint(body, x, lp, window, use_reentrant=False) if remat
                else body(x, lp, window))
        if a is not None:
            aux = aux + a
    if act_pspec is not None:
        x = gather_rows(x)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, aux


def _split_forward(params, cfg, tokens, prefix_embeds, remat, q_chunk,
                   dtype, moe_ctx, kernel, split):
    """``forward_hidden`` under ``split`` (see there)."""
    S = tokens.shape[1] + (cfg.prefix_len if cfg.prefix_len
                           and prefix_embeds is not None else 0)
    split = split.at_length(S)
    x = _split_embed(params, cfg, tokens, prefix_embeds, dtype, split)
    positions = torch.arange(S, device=x.device)
    remat = remat and torch.is_grad_enabled()
    stacks = [k for k in params if k.startswith("layers/")]

    def body(x, flat, window):
        return _split_layer(cfg, split.layer(flat), x, window, positions,
                            q_chunk, kernel, moe_ctx, split)[:2]

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.num_layers):
        flat, window = {k: params[k][i] for k in stacks}, \
            cfg.window_for_layer(i)
        x, a = (checkpoint(body, x, flat, window, use_reentrant=False)
                if remat else body(x, flat, window))
        if a is not None:
            aux = aux + a
    x = rms_norm(split.enter(x),
                 split.gather("final_norm", params["final_norm"]),
                 cfg.norm_eps)
    return x, aux


def mesh_of(act_pspec=None, moe_ctx=None):
    """The device mesh an ``act_pspec`` or a ``moe_ctx`` runs on (None
    without either)."""
    if act_pspec is not None:
        return act_pspec.mesh
    return None if moe_ctx is None else moe_ctx["mesh"]


def batch_ce(nll: torch.Tensor, cnt: torch.Tensor, mesh) -> torch.Tensor:
    """The CE of the whole batch from a rank's summed NLL and label count:
    on a mesh both are summed over the data axes first (the rank's rows
    being its block of the batch)."""
    if mesh is not None:
        axes = data_axes(mesh)
        nll = psum_axes(nll, mesh, axes)
        cnt = psum_axes(cnt.detach(), mesh, axes)
    return nll / torch.clamp(cnt, min=1.0)


def loss_fn(params, cfg: ModelConfig, batch: dict, remat: bool = True,
            q_chunk: int = 1024, loss_chunk: int = 512, dtype=None,
            act_pspec=None, moe_ctx=None, kernel: str = "eager",
            split=None):
    """Next-token CE (+ MoE aux). batch: tokens (B, S), labels (B, S)[,
    prefix_embeds]. With a prefix, labels cover only the token part.
    Returns (loss, {"ce", "aux"}). Under ``act_pspec`` / ``moe_ctx`` /
    ``split`` the batch is the rank's rows and the loss the whole
    batch's, the same on every rank. Under ``split`` the head is the
    rank's block: where ``"model"`` splits the vocabulary the CE is
    vocabulary-parallel (``chunked_lm_nll(split=)``), else every
    ``"model"`` rank computes it alike (``split.owned``)."""
    hidden, aux = forward_hidden(params, cfg, batch["tokens"],
                                 batch.get("prefix_embeds"), remat=remat,
                                 q_chunk=q_chunk, dtype=dtype,
                                 act_pspec=act_pspec, moe_ctx=moe_ctx,
                                 kernel=kernel, split=split)
    if cfg.prefix_len and batch.get("prefix_embeds") is not None:
        hidden = hidden[:, cfg.prefix_len:, :]
    if split is None:
        head = lm_head_weight(params, cfg).to(hidden.dtype)
        nll, cnt = chunked_lm_nll(hidden, head, batch["labels"],
                                  chunk=loss_chunk)
        ce = batch_ce(nll, cnt, mesh_of(act_pspec, moe_ctx))
    else:
        ce = split_ce(params, cfg, hidden, batch["labels"], loss_chunk,
                      split)
    return ce + aux, {"ce": ce, "aux": aux}


def split_ce(params, cfg: ModelConfig, hidden, labels, loss_chunk: int,
             split) -> torch.Tensor:
    """The whole batch's CE from the rank's rows' hidden (alike on every
    ``"model"`` rank) and the rank's block of the head, under ``split``:
    vocabulary-parallel where ``"model"`` splits V
    (``chunked_lm_nll(split=)``), else computed alike on every
    ``"model"`` rank (``split.owned``); the NLL and the label count
    summed over the data axes."""
    head = _split_head(params, cfg, split).to(hidden.dtype)
    nll, cnt = chunked_lm_nll(hidden, head, labels, chunk=loss_chunk,
                              split=split if split.vocab else None)
    if not split.vocab:
        nll = split.owned(nll)
    axes = data_axes(split.mesh)
    return split.psum(nll, axes) / torch.clamp(
        split.psum(cnt.detach(), axes), min=1.0)


def logits_fn(params, cfg: ModelConfig, tokens, prefix_embeds=None,
              remat: bool = False, dtype=None, kernel: str = "eager"):
    """Every position's logits, (B, S, V)."""
    hidden, _ = forward_hidden(params, cfg, tokens, prefix_embeds,
                               remat=remat, dtype=dtype, kernel=kernel)
    return _logits(params, cfg, hidden)


# ---------------------------------------------------------------------------
# KV-cache serving
# ---------------------------------------------------------------------------

def swa_layer_ids(cfg: ModelConfig):
    return [i for i in range(cfg.num_layers) if cfg.window_for_layer(i) > 0]


def global_layer_ids(cfg: ModelConfig):
    return [i for i in range(cfg.num_layers) if cfg.window_for_layer(i) == 0]


def _zeros(shape, dtype, device):
    return torch.zeros(shape, dtype=dtype, device=device)


def _ssm_cache(cfg: ModelConfig, batch: int, dtype, device) -> dict:
    L = cfg.num_layers
    di, nh, conv_dim = ssm_mod.dims(cfg.d_model, cfg.ssm)
    return {"ssm_state": _zeros((L, batch, nh, cfg.ssm.head_dim,
                                 cfg.ssm.d_state), dtype, device),
            "conv_state": _zeros((L, batch, cfg.ssm.d_conv - 1, conv_dim),
                                 dtype, device)}


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> dict:
    """Uniform decode cache: every attention layer keeps ``max_len``
    positions."""
    _check_family(cfg)
    device = resolve_device(device)
    L = cfg.num_layers
    c: dict = {}
    if cfg.family != "ssm":
        kv, hd = cfg.num_kv_heads, cfg.head_dim
        c["k"] = _zeros((L, batch, max_len, kv, hd), dtype, device)
        c["v"] = _zeros((L, batch, max_len, kv, hd), dtype, device)
    if cfg.family in ("ssm", "hybrid"):
        c.update(_ssm_cache(cfg, batch, dtype, device))
    return c


def init_ring_cache(cfg: ModelConfig, batch: int, max_len: int,
                    dtype=torch.bfloat16, device=None) -> dict:
    """Decode cache sized per layer kind: full-attention layers get
    ``max_len`` buffers, SWA layers ring buffers of their window, capped
    at ``max_len`` (positions never exceed it)."""
    _check_family(cfg)
    device = resolve_device(device)
    c: dict = {}
    if cfg.family != "ssm":
        kv, hd = cfg.num_kv_heads, cfg.head_dim
        gl, wl = global_layer_ids(cfg), swa_layer_ids(cfg)
        if gl:
            c["k"] = _zeros((len(gl), batch, max_len, kv, hd), dtype, device)
            c["v"] = _zeros((len(gl), batch, max_len, kv, hd), dtype, device)
        if wl:
            W = min(cfg.sliding_window, max_len)
            c["k_win"] = _zeros((len(wl), batch, W, kv, hd), dtype, device)
            c["v_win"] = _zeros((len(wl), batch, W, kv, hd), dtype, device)
    if cfg.family in ("ssm", "hybrid"):
        c.update(_ssm_cache(cfg, batch, dtype, device))
    return c


def ring_source_positions(last, W: int) -> torch.Tensor:
    """Absolute position each W-ring slot holds once position ``last`` has
    been written: slot ``s`` holds the latest ``p <= last`` with
    ``p ≡ s (mod W)``; negative = never written (decode masks those).
    ``last`` is an int or a ``(B,)`` tensor (a trailing slot axis is
    appended). The one definition of the ring layout, shared by the
    serving install and (transposed) the decode-side mask."""
    last = torch.as_tensor(last, dtype=torch.int64)[..., None]
    return last - (last - torch.arange(W, device=last.device)) % W


def to_ring_cache(cfg: ModelConfig, cache: dict, pos) -> dict:
    """A uniform cache filled up to ``pos`` exclusive (an int, or a (B,)
    tensor of each row's) in the ring layout of ``init_ring_cache``: the
    global layers' buffers, and for the SWA layers W-slot rings, slot s
    holding the latest position p ≡ s (mod W). A new cache; the uniform
    one is left as it is."""
    out = {}
    gl, wl = global_layer_ids(cfg), swa_layer_ids(cfg)
    if "k" in cache:
        ck, cv = cache["k"], cache["v"]
        if gl:
            out["k"], out["v"] = ck[gl], cv[gl]
        if wl:
            S = ck.shape[2]
            W = min(cfg.sliding_window, S)
            take = ring_source_positions(pos - 1, W).clamp(0, S - 1)
            take = take.to(ck.device)
            if take.dim() == 1:
                out["k_win"], out["v_win"] = ck[wl][:, :, take], \
                    cv[wl][:, :, take]
            else:                  # (B, W): each row's own slots
                rows = torch.arange(take.shape[0], device=ck.device)[:, None]
                out["k_win"] = ck[wl][:, rows, take]
                out["v_win"] = cv[wl][:, rows, take]
    for key in ("ssm_state", "conv_state"):
        if key in cache:
            out[key] = cache[key].clone()
    return out


def decode_step_ring(params, cfg: ModelConfig, token, cache, pos,
                     dtype=None, seq_shards=None, split=None):
    """One decode step against a ring cache (``to_ring_cache`` /
    ``init_ring_cache``): SWA layers attend against their W-slot rings,
    full-attention layers against their whole buffer. Eager attends, as
    the reference's, which takes no kernel switch; it is
    ``decode_step_grouped`` with no K-extent. Matches ``decode_step``
    numerically."""
    return decode_step_grouped(params, cfg, token, cache, pos, dtype=dtype,
                               seq_shards=seq_shards, split=split)


def _kind_runs(cfg: ModelConfig):
    """Contiguous same-kind layer runs, in layer order:
    ``[("swa" | "full", [layer ids]), ...]``."""
    runs: list = []
    for i in range(cfg.num_layers):
        kind = "swa" if cfg.window_for_layer(i) > 0 else "full"
        if runs and runs[-1][0] == kind:
            runs[-1][1].append(i)
        else:
            runs.append((kind, [i]))
    return runs


def _decode_pos(pos, batch: int, device) -> torch.Tensor:
    """An int or a (B,) tensor -> the (B,) int32 tensor the decode path
    (and the kernels) take."""
    if isinstance(pos, torch.Tensor):
        return pos.to(device=device, dtype=torch.int32).reshape(batch)
    return torch.full((batch,), int(pos), dtype=torch.int32, device=device)


def _embed_token(params, cfg, token, dtype, split=None):
    """(B,) tokens -> (B, 1, d); under ``split`` the vocabulary-row
    lookup on the rank's block of ``embed``, summed over ``"model"``
    (``_split_embed``)."""
    if split is not None:
        return _split_embed(params, cfg, token[:, None], None, dtype, split)
    x = params["embed"][token][:, None, :]
    return x if dtype is None else x.to(dtype)


def _decode_layer(params, i: int, split, stack: str = "layers") -> dict:
    """Layer ``i``'s params for a decode: views into the stacks, or under
    ``split`` the rank's blocks gathered for this layer alone."""
    return layer_params(params, i, stack) if split is None \
        else split.layer_at(params, i, stack)


def _decode_logits(params, cfg, x, split=None) -> torch.Tensor:
    """The last norm and the head on (B, 1, d): (B, V), or under
    ``split`` the rank's vocabulary block of it where ``"model"`` splits
    V (the norm and a head the layout leaves whole gathered)."""
    if split is None:
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        return _logits(params, cfg, x[:, 0, :])
    x = rms_norm(x, split.gather("final_norm", params["final_norm"]),
                 cfg.norm_eps)[:, 0, :]
    return torch.matmul(x, _split_head(params, cfg, split).to(x.dtype))


def decode_step_grouped(params, cfg: ModelConfig, token, cache, pos,
                        k_ext: int = 0, dtype=None,
                        decode_kernel: str = "eager", seq_shards=None,
                        split=None):
    """One decode step against an ``init_ring_cache`` layout.

    token: (B,) int; pos: (B,) int32 positions (or one int for all rows).
    SWA layers attend against their W-slot rings; full-attention layers
    write their uniform cache in place and attend against its first
    ``k_ext`` positions (0 = all), masked at each row's ``pos + 1``.
    Greedy tokens match ``decode_step`` (ring softmax sums run in slot
    order, so floats may differ in the last ulp).

    ``decode_kernel="cuda"`` runs every decode attend and recurrence
    through the hand-written kernels (``kernels/ops.py``).
    ``seq_shards``: ``{"k": SeqShard}`` when the full-attention layers'
    cache is this rank's block of a sequence-split one. ``split``: as in
    ``decode_step``.
    """
    if cfg.family == "ssm":      # no attention: ring layout == uniform
        return decode_step(params, cfg, token, cache, pos, dtype=dtype,
                           decode_kernel=decode_kernel, split=split)
    shard = (seq_shards or {}).get("k")
    x = _embed_token(params, cfg, token, dtype, split)
    pos = _decode_pos(pos, x.shape[0], x.device)
    positions = attn_mod.positions_like(pos)
    wmap = {layer: j for j, layer in enumerate(swa_layer_ids(cfg))}
    gmap = {layer: j for j, layer in enumerate(global_layer_ids(cfg))}
    has_ssm = cfg.family == "hybrid"
    for kind, ids in _kind_runs(cfg):
        for i in ids:
            if kind == "swa":
                j, keys, win, ext = wmap[i], ("k_win", "v_win"), \
                    cfg.sliding_window, 0
            else:
                j, keys, win, ext = gmap[i], ("k", "v"), 0, k_ext
            cl = {key: cache[key][j] for key in keys}
            if has_ssm:
                cl["ssm_state"] = cache["ssm_state"][i]
                cl["conv_state"] = cache["conv_state"][i]
            x, nc = _decode_layer_step(
                cfg, _decode_layer(params, i, split), x, win, positions, cl,
                pos, split, k_extent=ext, kernel=decode_kernel,
                seq_shard=shard if kind == "full" else None)
            for key, val in nc.items():
                _store(cache, key, j if key in keys else i, val)
    return _decode_logits(params, cfg, x, split), cache


def prefill(params, cfg: ModelConfig, tokens, cache, prefix_embeds=None,
            q_chunk: int = 1024, dtype=None, lengths=None):
    """Fill the cache from position 0; returns (last_logits (B, V), cache).

    ``lengths`` (B,) enables bucketed prefill: each row's tokens beyond
    lengths[b] are right-padding to a shared length. Logits are gathered
    at each row's last real position, the SSM/conv states stop exactly
    there (``ssm_forward``), and the pad keys written into the KV cache
    are causally invisible to every real query and overwritten by decode
    before they could be attended.
    """
    x = embed_inputs(params, cfg, tokens, prefix_embeds, dtype)
    S = x.shape[1]
    seq_lens = None
    if lengths is not None:
        seq_lens = torch.as_tensor(lengths, dtype=torch.int64,
                                   device=x.device)
        if cfg.prefix_len and prefix_embeds is not None:
            seq_lens = seq_lens + cfg.prefix_len
    positions = torch.arange(S, device=x.device)
    for i in range(cfg.num_layers):
        cl = {key: val[i] for key, val in cache.items()}
        x, _, nc = _layer(cfg, layer_params(params, i), x,
                          cfg.window_for_layer(i), positions, "prefill",
                          cache=cl, q_chunk=q_chunk, seq_lens=seq_lens)
        for key, val in nc.items():
            _store(cache, key, i, val)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if seq_lens is None:
        last = x[:, -1, :]
    else:
        last = x[torch.arange(x.shape[0], device=x.device), seq_lens - 1]
    return _logits(params, cfg, last), cache


def _decode_layer_step(cfg, lp, x, window, positions, cache, pos, split,
                       **kw):
    """One decode layer, on the rank's blocks under ``split``: (x, the
    layer's new cache entries)."""
    if split is None:
        x, _, nc = _layer(cfg, lp, x, window, positions, "decode",
                          cache=cache, pos=pos, q_chunk=1, **kw)
    else:
        x, _, nc = _split_layer(cfg, lp, x, window, positions, 1,
                                kw.pop("kernel"), None, split, "decode",
                                cache=cache, pos=pos, **kw)
    return x, nc


def decode_step(params, cfg: ModelConfig, token, cache, pos, dtype=None,
                unroll: bool = False, window_slice: bool = False,
                decode_kernel: str = "eager", seq_shards=None, split=None):
    """One autoregressive step against a uniform cache (the oracle).

    token: (B,) int; pos: (B,) int32 positions (or one int for all rows).
    Returns (logits (B, V), cache).

    The layers always run as a Python loop, each window a Python int, so
    ``unroll`` only selects the reference's unrolled semantics: with
    ``window_slice`` every SWA layer attends against the last ``window``
    positions of its cache (``attn_forward(cache_slice_window=)``), O(window)
    of cache read a step instead of O(S_max). ``decode_kernel="cuda"``
    refuses the slice, as the reference's fused attend does.
    ``seq_shards``: ``{"k": SeqShard}`` when the cache is this rank's
    block of a sequence-split one (its attend then masks by the window
    instead of slicing).

    ``split`` (a ``sharding.MeshSplit`` without a sequence split: the
    mesh serve step): ``params`` are the rank's stored blocks. Each
    layer's blocks are gathered inside the loop and dropped after it, as
    the reference's scanned decode gathers them, and the layer computes
    on the rank's heads, ``d_ff`` columns and experts (``_split_layer``);
    the embedding is the vocabulary-row lookup, and the logits returned
    are the rank's vocabulary block of them where ``"model"`` splits V.
    """
    shard = (seq_shards or {}).get("k")
    x = _embed_token(params, cfg, token, dtype, split)
    pos = _decode_pos(pos, x.shape[0], x.device)
    positions = attn_mod.positions_like(pos)
    for i in range(cfg.num_layers):
        cl = {key: val[i] for key, val in cache.items()}
        w = cfg.window_for_layer(i)
        csw = w if (unroll and window_slice and w > 0) else 0
        x, nc = _decode_layer_step(cfg, _decode_layer(params, i, split), x,
                                   w, positions, cl, pos, split,
                                   kernel=decode_kernel,
                                   cache_slice_window=csw, seq_shard=shard)
        for key, val in nc.items():
            _store(cache, key, i, val)
    return _decode_logits(params, cfg, x, split), cache

"""The reference's sharded LM steps on a CPU mesh, written to npz files:
the oracle of ``tests/test_torch_lm_mesh_ranks.py``.

    XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        python tests/lm_mesh_oracle.py OUT_DIR

Run it in a process of its own: it needs four host devices, which XLA
fixes when JAX starts, and the test process must keep its one. Each case
of ``CASES`` writes ``OUT_DIR/<name>.npz`` with its inputs (the
reference's initial params, the batch, the prefilled cache) and the
reference's outputs (``jit_train_step``'s loss and params after one step
at f32 compute; ``jit_serve_step``'s tokens over ``SERVE_STEPS`` steps and
the cache after them; the MoE layer's distributed and local outputs).
The meshes are ``jax.sharding.Mesh`` over the first devices with Auto
axes: ``jax.make_mesh`` gives Explicit axes in this JAX, which the
reference's ``with_sharding_constraint(x, act_pspec)`` refuses (ROADMAP
Queue 3). Importing this module imports no JAX: the port's ranks read
``CASES`` from it.
"""
from __future__ import annotations

import sys
from pathlib import Path

SEQ = 32               # train: B x SEQ tokens (a VLM's SEQ holds its prefix)
BATCH = 4
PROMPT = 8             # serve: prompt tokens before the decode steps
                       # (a case's "prompt" option replaces it)
SERVE_STEPS = 4
MAX_LEN = 24           # serve: the cache's positions after the prefix
FED = dict(lr=0.05, prox_theta=0.01)
REDUCE = dict(d_model=128, vocab=256)      # ModelConfig.reduced's widths
ANCHOR_SCALE = 0.9     # train: the anchor is the initial params times this

# name -> (mesh shape over ("data", "model"), arch, kind, options)
CASES = {
    "2x2-hymba": ((2, 2), "hymba-1.5b", "train", {}),
    "2x2-mamba2": ((2, 2), "mamba2-130m", "train", {}),
    "2x2-llama4": ((2, 2), "llama4-scout-17b-a16e", "train", {}),
    "2x2-llama4-fullgrid": ((2, 2), "llama4-scout-17b-a16e", "train",
                            {"moe_fullgrid": True}),
    "2x2-seamless": ((2, 2), "seamless-m4t-large-v2", "train", {}),
    # a batch of 15 target tokens beside 16 source frames (the train
    # shape's SEQ 32 splits the residual): "model" splits the encoder's
    # sequence but not the decoder's
    "2x2-seamless-odd-tgt": ((2, 2), "seamless-m4t-large-v2", "train",
                             {"batch_seq": 31}),
    "2x2-paligemma": ((2, 2), "paligemma-3b", "train", {}),
    # 4 / 4 heads, layer 0 windowed (16 < SEQ), layer 1 global
    "2x2-gemma3": ((2, 2), "gemma3-12b", "train",
                   {"config": {"sliding_window": 16, "global_every": 2}}),
    # no sequence split between layers: the partial sums are all-reduced
    "2x2-gemma3-noseq": ((2, 2), "gemma3-12b", "train",
                         {"config": {"sliding_window": 16, "global_every": 2},
                          "constrain_acts": False}),
    # 3 experts: "model" does not divide E, so each expert's d_ff splits
    "2x2-grok1-e3": ((2, 2), "grok-1-314b", "train",
                     {"config": {"experts": 3}}),
    # 3 experts under moe_fullgrid: the dispatch's buffers gathered over
    # "model" along C meet each expert's d_ff columns
    "2x2-grok1-e3-fullgrid": ((2, 2), "grok-1-314b", "train",
                              {"config": {"experts": 3},
                               "moe_fullgrid": True}),
    # a batch of 3 the data axes do not divide: the dispatch splits the
    # flat tokens (3 x SEQ) evenly over them
    "2x2-llama4-b3": ((2, 2), "llama4-scout-17b-a16e", "train",
                      {"batch": 3}),
    "2x2-hymba-serve": ((2, 2), "hymba-1.5b", "serve", {}),
    "2x2-hymba-serve-ring": ((2, 2), "hymba-1.5b", "serve", {"ring": True}),
    "2x2-hymba-serve-b1": ((2, 2), "hymba-1.5b", "serve", {"batch": 1}),
    "2x2-mamba2-serve": ((2, 2), "mamba2-130m", "serve", {}),
    "2x2-llama4-serve": ((2, 2), "llama4-scout-17b-a16e", "serve", {}),
    "2x2-seamless-serve": ((2, 2), "seamless-m4t-large-v2", "serve", {}),
    "2x2-paligemma-serve": ((2, 2), "paligemma-3b", "serve", {}),
    # the serve step on the rank's heads, d_ff columns and vocabulary
    # rows: windowed and global layers, the window (16) inside the 18
    # prompt tokens
    "2x2-gemma3-serve": ((2, 2), "gemma3-12b", "serve",
                         {"config": {"sliding_window": 16, "global_every": 2},
                          "prompt": 18}),
    # 3 experts: each expert's d_ff columns on the decode's local path
    "2x2-grok1-e3-serve": ((2, 2), "grok-1-314b", "serve",
                           {"config": {"experts": 3}}),
    # batch 1: the cache's sequence over ("data", "model")
    "2x2-gemma3-serve-b1": ((2, 2), "gemma3-12b", "serve",
                            {"config": {"sliding_window": 16,
                                        "global_every": 2},
                             "prompt": 18, "batch": 1}),
    "2x1-hymba": ((2, 1), "hymba-1.5b", "train", {}),
    "1x2-hymba": ((1, 2), "hymba-1.5b", "train", {}),
    "2x1-llama4": ((2, 1), "llama4-scout-17b-a16e", "train", {}),
    "1x2-llama4-fullgrid": ((1, 2), "llama4-scout-17b-a16e", "train",
                            {"moe_fullgrid": True}),
    "1x2-hymba-serve": ((1, 2), "hymba-1.5b", "serve", {}),
    # "model" 4 divides the reduced Mamba2's 8 SSD heads: 2 heads a rank
    "1x4-mamba2": ((1, 4), "mamba2-130m", "train", {}),
    "1x4-mamba2-serve": ((1, 4), "mamba2-130m", "serve", {}),
    # 4 / 4 heads on "model" 4: one query and one kv head a rank, in the
    # encoder, the decoder and its cross-attention
    "1x4-seamless": ((1, 4), "seamless-m4t-large-v2", "train", {}),
    "2x1-capacity": ((2, 1), None, "capacity", {}),
}

# the capacity case: E experts, top-1, capacity factor 1, T = 2 x 4 tokens
CAP_E, CAP_D = 4, 8


def cap_inputs():
    """The capacity case's router and tokens (numpy): batch row 0 (data
    shard 0) sends all four tokens to expert 0, row 1 one token to each
    expert. The whole batch's capacity is 2, a shard's 1, so the local
    path keeps token 1 and drops row 1's expert-0 token, and the
    distributed path does the opposite."""
    import numpy as np
    rng = np.random.default_rng(5)
    router = np.zeros((CAP_D, CAP_E), np.float32)
    router[:CAP_E, :CAP_E] = 8 * np.eye(CAP_E, dtype=np.float32)
    x = 0.1 * rng.standard_normal((2, 4, CAP_D)).astype(np.float32)
    x[0, :, 0] += 1.0
    for s in range(4):
        x[1, s, (s + 1) % CAP_E] += 1.0
    w = {k: rng.standard_normal((CAP_E,) + shape).astype(np.float32) * 0.3
         for k, shape in (("wg", (CAP_D, 16)), ("wi", (CAP_D, 16)),
                          ("wo", (16, CAP_D)))}
    return {"router": router, **w}, x


def case_config(get_config, arch, opts):
    """A case's config: ``arch`` reduced to ``REDUCE``'s widths, with the
    fields of ``opts["config"]`` replaced (``experts``: the MoE's expert
    count). ``get_config`` is the reference's or the port's."""
    import dataclasses
    cfg = get_config(arch).reduced(**REDUCE)
    over = dict(opts.get("config", {}))
    if "experts" in over:
        over["moe"] = dataclasses.replace(cfg.moe,
                                          num_experts=over.pop("experts"))
    return dataclasses.replace(cfg, **over)


def _serve_shapes(cfg, opts):
    """A serve case's (batch, prompt tokens, cache positions)."""
    B, P = opts.get("batch", BATCH), opts.get("prompt", PROMPT)
    if cfg.is_encdec:
        return B, P, MAX_LEN
    return B, P, cfg.prefix_len + MAX_LEN


def _run(name, out_dir):
    import dataclasses

    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh
    from repro.checkpoint.ckpt import _flatten
    from repro.configs import get_config
    from repro.launch import steps
    from repro.models import encdec, lm, registry
    from repro.types import FedConfig, ShapeConfig
    shape, arch, kind, opts = CASES[name]
    n = shape[0] * shape[1]
    mesh = Mesh(np.array(jax.devices()[:n]).reshape(shape), ("data", "model"))
    rng = np.random.default_rng(sum(map(ord, name)))
    out = {}
    if kind == "capacity":
        from repro.models import moe as jmoe
        from repro.types import MoEConfig
        p, x = cap_inputs()
        moe = MoEConfig(num_experts=CAP_E, top_k=1, capacity_factor=1.0)
        pj = {k: jnp.asarray(v) for k, v in p.items()}
        with mesh:
            dist_out, dist_aux = jax.jit(lambda p, x: jmoe.moe_forward(
                p, x, moe, "silu", moe_ctx={"mesh": mesh, "dp": "data"}))(
                pj, jnp.asarray(x))
        loc_out, loc_aux = jmoe.moe_forward(pj, jnp.asarray(x), moe, "silu")
        out.update({f"p/{k}": v for k, v in p.items()})
        out.update(x=x, dist_out=np.asarray(dist_out),
                   dist_aux=np.asarray(dist_aux),
                   local_out=np.asarray(loc_out),
                   local_aux=np.asarray(loc_aux))
        np.savez(Path(out_dir) / f"{name}.npz", **out)
        return
    cfg = case_config(get_config, arch, opts)
    params = jax.jit(registry.init_params, static_argnums=(1,))(
        jax.random.PRNGKey(0), cfg)
    pshape = jax.eval_shape(lambda: params)
    out.update({f"p/{k}": np.asarray(v) for k, v in _flatten(params).items()})
    if kind == "train":
        anchor = jax.tree_util.tree_map(
            lambda v: v * np.float32(ANCHOR_SCALE), params)
        sc = ShapeConfig("t", seq_len=SEQ,
                         global_batch=opts.get("batch", BATCH), kind="train")
        batch = registry.synth_batch(rng, cfg, dataclasses.replace(
            sc, seq_len=opts.get("batch_seq", SEQ)))
        bshape = jax.eval_shape(lambda: batch)
        fed = FedConfig(**FED)
        fn, _ = steps.jit_train_step(
            cfg, fed, mesh, sc, pshape, bshape, donate=False,
            moe_fullgrid=opts.get("moe_fullgrid", False),
            constrain_acts=opts.get("constrain_acts", True),
            train_kwargs={"dtype": jnp.float32})
        state = {"mom": jax.tree_util.tree_map(jnp.zeros_like, params),
                 "step": jnp.int32(0)}
        with mesh:
            new, _, loss = fn(params, state, anchor, batch)
        out.update({f"b/{k}": np.asarray(v) for k, v in batch.items()})
        out.update({f"out/{k}": np.asarray(v)
                    for k, v in _flatten(new).items()})
        out["loss"] = np.asarray(loss)
    else:
        B, P, S = _serve_shapes(cfg, opts)
        sc = ShapeConfig("s", seq_len=S, global_batch=B, kind="decode")
        if cfg.is_encdec:
            src = rng.standard_normal((B, P, cfg.d_model)).astype(np.float32)
            cache = encdec.init_cache(cfg, B, P, S, jnp.float32)
            cache = registry.prefill(params, cfg,
                                     {"src_embeds": jnp.asarray(src)}, cache)
            tok, pos = jnp.zeros((B,), jnp.int32), 0
            out["src_embeds"] = src
        else:
            toks = rng.integers(0, cfg.vocab_size, (B, P)).astype(np.int32)
            batch = {"tokens": jnp.asarray(toks)}
            if cfg.prefix_len:
                pre = rng.standard_normal((B, cfg.prefix_len, cfg.d_model))
                batch["prefix_embeds"] = jnp.asarray(pre.astype(np.float32))
            cache = registry.init_cache(cfg, B, S, jnp.float32)
            logits, cache = registry.prefill(params, cfg, batch, cache)
            tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
            pos = cfg.prefix_len + P
            if opts.get("ring"):
                cache = lm.to_ring_cache(cfg, cache, pos)
        out.update({f"c/{k}": np.asarray(v) for k, v in cache.items()})
        out["token"], out["pos"] = np.asarray(tok), np.asarray(pos)
        cshape = jax.eval_shape(lambda: cache)
        fn, _ = steps.jit_serve_step(cfg, mesh, sc, pshape, cshape,
                                     donate=False, ring=opts.get("ring",
                                                                 False))
        picked = []
        with mesh:
            for t in range(SERVE_STEPS):
                tok, cache = fn(params, tok, cache, jnp.int32(pos + t))
                picked.append(np.asarray(tok))
        out["tokens"] = np.stack(picked)
        out.update({f"out/{k}": np.asarray(v) for k, v in cache.items()})
    np.savez(Path(out_dir) / f"{name}.npz", **out)


def main(argv) -> int:
    out_dir = argv[0]
    names = argv[1:] or list(CASES)
    for name in names:
        _run(name, out_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

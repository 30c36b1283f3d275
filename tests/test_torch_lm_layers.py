"""The port's LM building blocks against the reference on the same numpy
inputs: configs, norms, RoPE, activations, the MLP, GQA attention (with
q-chunking, ring positions and the k_len mask), the cached attention
layer with a K-extent, the ring decode layer, and the Mamba2 block
(chunked scan with seq_lens, and the one-token step). rtol 1e-4 /
atol 1e-5 unless a case says otherwise."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

import repro.configs as jcfg
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import mlp as jmlp
from repro.models import ssm as jssm
from repro_torch import configs as tcfg
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models import mlp as tmlp
from repro_torch.models import registry as tregistry
from repro_torch.models import ssm as tssm

RTOL, ATOL = 1e-4, 1e-5
ARCHS = ["hymba-1.5b", "gemma3-12b", "mamba2-130m"]


def close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               rtol=rtol, atol=atol)


def T(a):
    return torch.tensor(np.asarray(a))


def J(a):
    return jnp.asarray(np.asarray(a))


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_configs_equal(arch):
    """Field by field, reduced or not, with the derived quantities."""
    a, b = jcfg.get_config(arch), tcfg.get_config(arch)
    for x, y in ((a, b), (a.reduced(), b.reduced()),
                 (a.reduced(num_layers=3, d_model=128, vocab=64),
                  b.reduced(num_layers=3, d_model=128, vocab=64))):
        assert dataclasses.asdict(x) == dataclasses.asdict(y)
        assert x.param_count() == y.param_count()
        assert (x.attention_free, x.is_encdec, x.sub_quadratic) == \
            (y.attention_free, y.is_encdec, y.sub_quadratic)
        assert [x.window_for_layer(i) for i in range(x.num_layers)] == \
            [y.window_for_layer(i) for i in range(y.num_layers)]


def test_rms_norm_rope_and_activations(rng):
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32) * 3
    scale = rng.standard_normal(16).astype(np.float32) * 0.1
    close(tcommon.rms_norm(T(x), T(scale)), jcommon.rms_norm(J(x), J(scale)))
    # bf16 in, bf16 out, normalised in f32
    xb = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    got = tcommon.rms_norm(T(xb).bfloat16(), T(scale))
    want = jcommon.rms_norm(jnp.asarray(xb, jnp.bfloat16), J(scale))
    assert got.dtype == torch.bfloat16
    close(got.float(), want.astype(jnp.float32), rtol=1e-2, atol=1e-2)
    # RoPE: prefill positions (S,) and per-row decode positions (B, 1)
    close(tcommon.apply_rope(T(x), torch.arange(5), 10_000.0),
          jcommon.apply_rope(J(x), jnp.arange(5), 10_000.0))
    rows = np.asarray([[3], [40]], np.int32)
    close(tcommon.apply_rope(T(x[:, :1]), T(rows), 1e6),
          jcommon.apply_rope(J(x[:, :1]), J(rows), 1e6))
    close(tcommon.rope_freqs(16, 500.0), jcommon.rope_freqs(16, 500.0))
    for name in ("silu", "gelu", "relu"):     # gelu: the tanh approximation
        close(tcommon.activation(name)(T(x)), jcommon.activation(name)(J(x)))
    with pytest.raises(ValueError):
        tcommon.activation("swish")


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_mlp_matches(act, rng):
    p = {k: rng.standard_normal(s).astype(np.float32) * 0.1
         for k, s in (("wg", (32, 48)), ("wi", (32, 48)), ("wo", (48, 32)))}
    x = rng.standard_normal((2, 3, 32)).astype(np.float32)
    close(tmlp.mlp_forward({k: T(v) for k, v in p.items()}, T(x), act),
          jmlp.mlp_forward({k: J(v) for k, v in p.items()}, J(x), act))


def _qkv(rng, B, Sq, Sk, H, KV, D):
    q = rng.standard_normal((B, Sq, H, D)).astype(np.float32)
    k = rng.standard_normal((B, Sk, KV, D)).astype(np.float32)
    v = rng.standard_normal((B, Sk, KV, D)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("case", [
    dict(window=0, causal=True, q_chunk=1024),
    dict(window=5, causal=True, q_chunk=4),        # q-chunked SWA
    dict(window=3, causal=False, q_chunk=1024),
    dict(window=0, causal=True, q_chunk=1024, q_offset=6, k_len=9),
])
def test_gqa_attention_matches(case, rng):
    q, k, v = _qkv(rng, 2, 8, 16 if "k_len" in case else 8, 4, 2, 16)
    kw = dict(case)
    close(tattn.gqa_attention(T(q), T(k), T(v), **kw),
          jattn.gqa_attention(J(q), J(k), J(v), **kw))


def test_gqa_attention_ring_positions_and_unported_kernel(rng):
    q, k, v = _qkv(rng, 2, 1, 8, 4, 2, 16)
    k_pos = 12 - (12 - np.arange(8)) % 8
    close(tattn.gqa_attention(T(q), T(k), T(v), window=5, q_offset=12,
                              k_positions=T(k_pos), q_chunk=1),
          jattn.gqa_attention(J(q), J(k), J(v), window=5, q_offset=12,
                              k_positions=J(k_pos), q_chunk=1))
    # the scoring kernel's path (its plain version on the CPU) against the
    # reference's kernel="pallas"; it takes the causal self-attend only
    qs, ks, vs = _qkv(rng, 1, 16, 16, 4, 2, 64)
    close(tattn.gqa_attention(T(qs), T(ks), T(vs), window=5, kernel="cuda"),
          jattn.gqa_attention(J(qs), J(ks), J(vs), window=5,
                              kernel="pallas"), rtol=2e-4, atol=2e-4)
    with pytest.raises(ValueError, match="causal self-attend"):
        tattn.gqa_attention(T(q), T(k), T(v), kernel="cuda")
    with pytest.raises(ValueError, match="must be one of"):
        tattn.gqa_attention(T(q), T(k), T(v), kernel="pallas")
    with pytest.raises(ValueError, match="q_chunk"):
        q6, k6, v6 = _qkv(rng, 1, 6, 6, 2, 2, 8)
        tattn.gqa_attention(T(q6), T(k6), T(v6), q_chunk=4)


def _attn_params(rng, cfg):
    shapes = {"wq": (cfg.d_model, cfg.num_heads * cfg.head_dim),
              "wk": (cfg.d_model, cfg.num_kv_heads * cfg.head_dim),
              "wv": (cfg.d_model, cfg.num_kv_heads * cfg.head_dim),
              "wo": (cfg.num_heads * cfg.head_dim, cfg.d_model)}
    return {k: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
            for k, s in shapes.items()}


def test_attn_forward_cache_and_k_extent(rng):
    """Prefill 5 tokens into a 32-slot cache, then decode one token per
    row at different positions, full and K-extent-sliced, eager and
    through the extent kernel's wrapper; each row against the reference
    at that row's scalar position."""
    cfg = jcfg.get_config("hymba-1.5b").reduced()
    tc = tcfg.get_config("hymba-1.5b").reduced()
    p = _attn_params(rng, cfg)
    tp, jp = {k: T(v) for k, v in p.items()}, {k: J(v) for k, v in p.items()}
    B, S_max, KV, hd = 2, 32, cfg.num_kv_heads, cfg.head_dim
    x = rng.standard_normal((B, 5, cfg.d_model)).astype(np.float32)
    ck = rng.standard_normal((B, S_max, KV, hd)).astype(np.float32)
    cv = rng.standard_normal((B, S_max, KV, hd)).astype(np.float32)
    out, c = tattn.attn_forward(tp, T(x), cfg=tc, window=0,
                                positions=torch.arange(5),
                                cache={"k": T(ck), "v": T(cv)},
                                cache_index=0)
    jout, jc = jattn.attn_forward(jp, J(x), cfg=cfg, window=0,
                                  positions=jnp.arange(5),
                                  cache={"k": J(ck), "v": J(cv)},
                                  cache_index=0)
    close(out, jout)
    close(c["k"], jc["k"])
    rows = [5, 11]
    xd = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    for ext, kern in ((0, "eager"), (16, "eager"), (16, "cuda"),
                      (0, "cuda")):
        cache = {key: val.clone() for key, val in c.items()}
        pos = torch.tensor(rows, dtype=torch.int32)
        got, _ = tattn.attn_forward(tp, T(xd), cfg=tc, window=0,
                                    positions=pos[:, None], cache=cache,
                                    cache_index=pos, q_chunk=1,
                                    k_extent=ext, kernel=kern)
        for b, r in enumerate(rows):
            want, _ = jattn.attn_forward(
                jp, J(xd[b:b + 1]), cfg=cfg, window=0,
                positions=jnp.asarray([r]),
                cache={key: val[b:b + 1] for key, val in jc.items()},
                cache_index=r, q_chunk=1, k_extent=ext)
            close(got[b:b + 1], want)


def test_ring_decode_attend_layer(rng):
    """The ring layer: per-row slot writes and the attend, eager and
    through the ring kernel's wrapper, against the reference row by row."""
    cfg = jcfg.get_config("hymba-1.5b").reduced()
    tc = tcfg.get_config("hymba-1.5b").reduced()
    p = _attn_params(rng, cfg)
    tp, jp = {k: T(v) for k, v in p.items()}, {k: J(v) for k, v in p.items()}
    B, W = 3, 8
    rk = rng.standard_normal((B, W, cfg.num_kv_heads, cfg.head_dim)) \
        .astype(np.float32)
    rv = rng.standard_normal(rk.shape).astype(np.float32)
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    rows = [2, 8, 21]
    for kern in ("eager", "cuda"):
        ring_k, ring_v = T(rk), T(rv)
        got, (nk, nv) = tattn.ring_decode_attend(
            tp, T(x), cfg=tc, ring_k=ring_k, ring_v=ring_v,
            pos=torch.tensor(rows, dtype=torch.int32), window=5,
            kernel=kern)
        assert nk is ring_k                      # written in place
        for b, r in enumerate(rows):
            want, (jk, jv) = jattn.ring_decode_attend(
                jp, J(x[b:b + 1]), cfg=cfg, ring_k=J(rk[b:b + 1]),
                ring_v=J(rv[b:b + 1]), pos=jnp.int32(r), window=5)
            close(got[b:b + 1], want)
            close(nk[b:b + 1], jk)
            close(nv[b:b + 1], jv)


def _ssm_params(rng, d_model, ssm):
    di, nh, conv_dim = jssm.dims(d_model, ssm)
    p = jax.tree_util.tree_map(
        np.asarray, jssm.init_ssm_params(jax.random.PRNGKey(3), d_model, ssm,
                                         1))
    p = {k: v[0] for k, v in p.items()}
    # non-trivial A, D, dt_bias, norm, conv_b (the init zeros them)
    for k in ("A_log", "D", "dt_bias", "norm", "conv_b"):
        p[k] = (rng.standard_normal(p[k].shape) * 0.3).astype(np.float32)
    return p


def test_ssd_chunked_and_ssm_forward_seq_lens(rng):
    cfg = jcfg.get_config("hymba-1.5b").reduced()
    ssm, d = cfg.ssm, cfg.d_model
    p = _ssm_params(rng, d, ssm)
    tp, jp = {k: T(v) for k, v in p.items()}, {k: J(v) for k, v in p.items()}
    # the chunked scan alone: S not a multiple of the chunk, with h0
    B, S, H, P, N = 2, 45, 3, 4, 8
    xh = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.abs(rng.standard_normal((B, S, H))).astype(np.float32) * 0.5
    A = -np.exp(rng.standard_normal(H) * 0.3).astype(np.float32)
    Bm, Cm = (rng.standard_normal((B, S, N)).astype(np.float32)
              for _ in range(2))
    h0 = rng.standard_normal((B, H, P, N)).astype(np.float32)
    got = tssm.ssd_chunked(*map(T, (xh, dt, A, Bm, Cm)), 16, h0=T(h0))
    want = jssm.ssd_chunked(*map(J, (xh, dt, A, Bm, Cm)), 16, h0=J(h0))
    for g, w in zip(got, want):
        close(g, w, atol=1e-4)
    # the block, right-padded rows: outputs at real positions and both
    # states as the reference's
    x = rng.standard_normal((3, 40, d)).astype(np.float32)
    lens = np.asarray([40, 7, 33], np.int32)
    out, (st, cs) = tssm.ssm_forward(tp, T(x), ssm, seq_lens=T(lens))
    jout, (jst, jcs) = jssm.ssm_forward(jp, J(x), ssm, seq_lens=J(lens))
    for b, n in enumerate(lens):
        close(out[b, :n], jout[b, :n], atol=1e-4)
    close(st, jst, atol=1e-4)
    close(cs, jcs)
    out2, _ = tssm.ssm_forward(tp, T(x), ssm)
    close(out2, jssm.ssm_forward(jp, J(x), ssm)[0], atol=1e-4)
    # the chunk-scan kernel's path (its plain version on the CPU), S = 40
    # padded to the chunk, with right-padded rows, against the reference's
    # kernel="pallas"
    out, (st, _) = tssm.ssm_forward(tp, T(x), ssm, seq_lens=T(lens),
                                    kernel="cuda")
    jout, (jst, _) = jssm.ssm_forward(jp, J(x), ssm, seq_lens=J(lens),
                                      kernel="pallas")
    for b, n in enumerate(lens):
        close(out[b, :n], jout[b, :n], atol=1e-4)
    close(st, jst, atol=1e-4)
    with pytest.raises(ValueError, match="initial state"):
        tssm.ssm_forward(tp, T(x), ssm, state=st, kernel="cuda")
    with pytest.raises(ValueError, match="must be one of"):
        tssm.ssm_forward(tp, T(x), ssm, kernel="pallas")


def test_ssm_decode_step_matches(rng):
    cfg = jcfg.get_config("mamba2-130m").reduced()
    ssm, d = cfg.ssm, cfg.d_model
    di, nh, conv_dim = jssm.dims(d, ssm)
    p = _ssm_params(rng, d, ssm)
    tp, jp = {k: T(v) for k, v in p.items()}, {k: J(v) for k, v in p.items()}
    B = 3
    x = rng.standard_normal((B, 1, d)).astype(np.float32)
    st = rng.standard_normal((B, nh, ssm.head_dim, ssm.d_state)) \
        .astype(np.float32)
    cs = rng.standard_normal((B, ssm.d_conv - 1, conv_dim)).astype(np.float32)
    want = jssm.ssm_decode_step(jp, J(x), ssm, J(st), J(cs))
    for kern in ("eager", "cuda"):
        out, (nst, ncs) = tssm.ssm_decode_step(tp, T(x), ssm, T(st), T(cs),
                                               kernel=kern)
        close(out, want[0], atol=1e-4)
        close(nst, want[1][0], atol=1e-4)
        close(ncs, want[1][1])
    with pytest.raises(ValueError, match="decode kernel"):
        tssm.ssm_decode_step(tp, T(x), ssm, T(st), T(cs), kernel="pallas")


def test_unported_families_raise():
    """The moe and encdec families are ported, the sharded MoE dispatch
    (``moe_ctx``) too: in a world of one it is the local path. The
    encoder-decoder has no ring cache, as in the reference."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.types import MoEConfig
    base = tcfg.get_config("hymba-1.5b").reduced()
    moe = dataclasses.replace(base, family="moe", ssm=None,
                              moe=MoEConfig(num_experts=4))
    params = tregistry.init_params(torch.Generator(), moe, "cpu")
    assert params["layers/moe/wg"].shape == (2, 4, moe.d_model, moe.d_ff)
    toks = torch.zeros((1, 8), dtype=torch.int64)
    ctx = {"mesh": make_host_mesh(device="cpu"), "dp": "data"}
    b = {"tokens": toks, "labels": toks}
    assert torch.equal(tregistry.loss_fn(params, moe, b, moe_ctx=ctx)[0],
                       tregistry.loss_fn(params, moe, b)[0])
    encdec = dataclasses.replace(base, family="encdec", ssm=None)
    assert set(tregistry.init_cache(encdec, 1, 8, device="cpu")) == \
        {"enc_k", "enc_v", "k", "v"}
    with pytest.raises(ValueError, match="ring"):
        tregistry.init_ring_cache(encdec, 1, 8, device="cpu")

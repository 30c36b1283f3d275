"""The plain version of the port's sliding-window attention kernel (and its
wrapper, which computes it on CPU tensors) against the reference's Pallas
kernel in interpret mode, on the same numpy inputs (the cases of
``tests/test_kernels.py``); ``gqa_attention(kernel="cuda")``, through the
kernel's GQA entry, against the reference's ``kernel="pallas"``; the
wrappers' and the switch's refusals; head dim 240 (gemma3-12b), the
attention alone and a reduced gemma3 forward at that head dim."""
import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

import repro.configs as jcfg
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.swa_attention import swa_attention_pallas
from repro.models import attention as jattn
from repro.models import lm as jlm
from repro_torch import configs as tcfg
from repro_torch.checkpoint.convert import params_from_jax
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import swa_attention as tswa
from repro_torch.models import attention as tattn
from repro_torch.models import lm as tlm

from torch_parity import JDT, TDT, jax_params_both


def _qkv(rng, BH, S, D, dt="f32"):
    """The same inputs for both packages: f32 numpy rounded through the
    working dtype, so bf16 values are equal on each side."""
    out = []
    for scale in (0.3, 0.3, 1.0):
        a = rng.standard_normal((BH, S, D)) * scale
        out.append(np.asarray(jnp.asarray(a, JDT[dt]).astype(jnp.float32)))
    return out


@pytest.mark.parametrize("S,D,w", [(256, 64, 32), (256, 64, 100),
                                   (128, 128, 128), (512, 64, 200),
                                   (256, 128, 256)])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_swa_attention_matches_pallas(S, D, w, dt, rng):
    q, k, v = _qkv(rng, 3, S, D, dt)
    want = np.asarray(swa_attention_pallas(
        *(jnp.asarray(a, JDT[dt]) for a in (q, k, v)), w,
        q_block=min(128, S), k_block=min(128, S), interpret=True),
        np.float32)
    tq, tk, tv = (torch.tensor(a).to(TDT[dt]) for a in (q, k, v))
    tol = 2e-5 if dt == "f32" else 3e-2
    for got in (tref.swa_attention_ref(tq, tk, tv, w),
                tops.swa_attention(tq, tk, tv, w)):
        assert got.dtype == TDT[dt]
        np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                                   atol=tol)


@pytest.mark.parametrize("window", [48, 0])
def test_gqa_attention_cuda_matches_pallas(window, rng):
    """K/V repeated over G = 2 query heads and folded, as the reference's
    kernel="pallas"; the eager path agrees too."""
    B, S, H, KV, D = 2, 128, 4, 2, 64
    q = (rng.standard_normal((B, S, H, D)) * 0.3).astype(np.float32)
    k = (rng.standard_normal((B, S, KV, D)) * 0.3).astype(np.float32)
    v = rng.standard_normal((B, S, KV, D)).astype(np.float32)
    want = np.asarray(jattn.gqa_attention(
        *(jnp.asarray(a) for a in (q, k, v)), window=window,
        kernel="pallas"))
    tq, tk, tv = (torch.tensor(a) for a in (q, k, v))
    got = tattn.gqa_attention(tq, tk, tv, window=window, kernel="cuda")
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    eager = tattn.gqa_attention(tq, tk, tv, window=window, q_chunk=64)
    np.testing.assert_allclose(got.numpy(), eager.numpy(), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("G", [1, 5])
def test_gqa_entry_matches_pallas(G, rng):
    """gqa_attention(kernel="cuda") goes through the GQA entry
    (``ops.swa_attention_gqa``), whose plain version repeats, folds and
    unfolds as the reference's kernel="pallas" does: B = 2, two kv heads,
    D = 64, S = 128 and 256, windows 48 and 0 (full)."""
    B, KV, D = 2, 2, 64
    H = G * KV
    for S in (128, 256):
        q = (rng.standard_normal((B, S, H, D)) * 0.3).astype(np.float32)
        k = (rng.standard_normal((B, S, KV, D)) * 0.3).astype(np.float32)
        v = rng.standard_normal((B, S, KV, D)).astype(np.float32)
        tq, tk, tv = (torch.tensor(a) for a in (q, k, v))
        for window in (48, 0):
            want = np.asarray(jattn.gqa_attention(
                *(jnp.asarray(a) for a in (q, k, v)), window=window,
                kernel="pallas"))
            before = tswa.swa_attention.launches
            got = tattn.gqa_attention(tq, tk, tv, window=window,
                                      kernel="cuda")
            assert tswa.swa_attention.launches == before   # plain on a CPU
            assert got.shape == (B, S, H, D)
            np.testing.assert_allclose(got.numpy(), want, rtol=2e-4,
                                       atol=2e-4)
            entry = tops.swa_attention_gqa(tq, tk, tv, window)
            assert torch.equal(entry, got)


def test_head_dim_240_matches_pallas():
    """gemma3-12b's head dim: B = 1, S = 128, H = 2 over KV = 1, D = 240,
    window 64, f32, q and k ~ 0.3 N(0, 1), v ~ N(0, 1). The GQA entry on
    CPU tensors (its plain version; the kernel's own D = 240 is held on the
    card) against the reference's Pallas kernel in interpret mode on the
    repeated, folded heads, to this file's f32 tolerance."""
    gen = np.random.default_rng(0)
    B, S, H, KV, D, w = 1, 128, 2, 1, 240, 64
    q = (0.3 * gen.standard_normal((B, S, H, D))).astype(np.float32)
    k = (0.3 * gen.standard_normal((B, S, KV, D))).astype(np.float32)
    v = gen.standard_normal((B, S, KV, D)).astype(np.float32)
    fold = lambda a: jnp.asarray(np.repeat(a, H // a.shape[2], axis=2)
                                 .transpose(0, 2, 1, 3).reshape(B * H, S, D))
    want = np.asarray(swa_attention_pallas(
        fold(q), fold(k), fold(v), w, q_block=128, k_block=128,
        interpret=True)).reshape(B, H, S, D).transpose(0, 2, 1, 3)
    before = tswa.swa_attention.launches
    got = tops.swa_attention_gqa(*(torch.tensor(a) for a in (q, k, v)), w)
    assert tswa.swa_attention.launches == before
    assert got.shape == (B, S, H, D)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_gemma3_forward_at_head_dim_240(rng):
    """The reduced gemma3 cut to 6 layers (five at window 64, layer 5
    global, as every 6th layer is) at head dim 240, scored with
    kernel="cuda" on CPU tensors, against the reference's forward on
    JAX-initialised params: hidden states to 1e-4, as
    tests/test_torch_lm_forward.py holds the other head dims."""
    jc = dataclasses.replace(
        jcfg.get_config("gemma3-12b").reduced(num_layers=6), head_dim=240)
    tc = dataclasses.replace(
        tcfg.get_config("gemma3-12b").reduced(num_layers=6), head_dim=240)
    jp, flat = jax_params_both(jc, jax.random.PRNGKey(0))
    tp = params_from_jax(flat, tc)
    toks = rng.integers(0, jc.vocab_size, (2, 128)).astype(np.int32)
    with torch.no_grad():
        hidden, _ = tlm.forward_hidden(tp, tc, torch.tensor(toks),
                                       kernel="cuda")
    jhidden, _ = jlm.forward_hidden(jp, jc, jnp.asarray(toks))
    np.testing.assert_allclose(hidden.numpy(), np.asarray(jhidden),
                               rtol=1e-4, atol=1e-4)


def test_window_zero_is_full_causal(rng):
    q, k, v = _qkv(rng, 2, 256, 64)
    tq, tk, tv = (torch.tensor(a) for a in (q, k, v))
    got = tops.swa_attention(tq, tk, tv, 0)
    assert torch.equal(got, tref.swa_attention_ref(tq, tk, tv, 256))
    want = jops.swa_attention(*(jnp.asarray(a) for a in (q, k, v)), window=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_plain_version_keeps_both_modes(rng):
    """The plain version holds the reference's oracle in either mode; only
    the kernel is causal-only."""
    q, k, v = _qkv(rng, 2, 64, 64)
    for causal in (True, False):
        got = tref.swa_attention_ref(*(torch.tensor(a) for a in (q, k, v)),
                                     9, causal=causal)
        want = jref.swa_attention_ref(*(jnp.asarray(a) for a in (q, k, v)),
                                      9, causal=causal)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


def test_wrapper_and_switch_refusals(rng):
    q = torch.zeros((2, 128, 64))
    with pytest.raises(ValueError, match="causal only"):
        tswa.swa_attention(q, q, q, 8, causal=False)
    with pytest.raises(ValueError, match="not divisible"):
        z = torch.zeros((1, 200, 64))
        tops.swa_attention(z, z, z, 8)
    # any head dim on CPU tensors (the plain version); the kernel's own
    # head dims are refused on the card (tests/test_torch_cuda_forward.py)
    z = torch.zeros((2, 128, 32))
    assert torch.equal(tswa.swa_attention(z, z, z, 8),
                       tref.swa_attention_ref(z, z, z, 8))
    bad = [
        (q, q.double(), q),                               # dtypes differ
        (torch.zeros((2, 64, 128))[:, :, ::2], q, q),     # strided
        (q, torch.zeros((2, 64, 64)), q),                 # shapes differ
    ]
    for args in bad:
        with pytest.raises(ValueError):
            tswa.swa_attention(*args, 8)
    with pytest.raises(ValueError, match="window"):
        tswa.swa_attention(q, q, q, 0)
    # no backward: refused under grad mode, fine without it
    qg = q.clone().requires_grad_(True)
    with pytest.raises(ValueError, match="no backward"):
        tswa.swa_attention(qg, q, q, 8)
    with torch.no_grad():
        tswa.swa_attention(qg, q, q, 8)
    # the GQA entry: (B, S, H, D) against (B, S, KV, D), KV dividing H
    q4, k4 = torch.zeros((1, 128, 4, 64)), torch.zeros((1, 128, 2, 64))
    bad4 = [
        (q4, torch.zeros((1, 128, 3, 64)), torch.zeros((1, 128, 3, 64))),
        (q4, k4, torch.zeros((1, 128, 1, 64))),           # v differs from k
        (q4, torch.zeros((1, 64, 2, 64)), torch.zeros((1, 64, 2, 64))),
        (q, k4, k4),                                      # q folded
        (torch.zeros((1, 128, 8, 64))[:, :, ::2], k4, k4),   # strided
        (q4, k4.bfloat16(), k4),                          # dtypes differ
    ]
    for args in bad4:
        with pytest.raises(ValueError):
            tswa.swa_attention_gqa(*args, 8)
    with pytest.raises(ValueError, match="causal only"):
        tswa.swa_attention_gqa(q4, k4, k4, 8, causal=False)
    with pytest.raises(ValueError, match="not divisible"):
        z4 = torch.zeros((1, 200, 2, 64))
        tops.swa_attention_gqa(z4, z4, z4, 8)
    # gqa_attention(kernel="cuda") takes the causal self-attend only
    x = torch.zeros((1, 16, 2, 64))
    for kw in (dict(causal=False), dict(k_len=4),
               dict(k_positions=torch.arange(16)), dict(window=torch.tensor(3))):
        with pytest.raises(ValueError, match="causal self-attend"):
            tattn.gqa_attention(x, x, x, kernel="cuda", **kw)
    with pytest.raises(ValueError, match="causal self-attend"):
        tattn.gqa_attention(x[:, :1], x, x, kernel="cuda")

"""The plain version of the port's SSD chunk-scan kernel (and its wrapper,
which computes it on CPU tensors) against the reference's Pallas scan in
interpret mode and against the O(S) recurrence, on the same numpy inputs
(the cases of ``tests/test_kernels.py``); ``ssm_forward(kernel="cuda")``
against the reference's ``kernel="pallas"``; the wrapper's refusals."""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

import repro.configs as jcfg
from repro.kernels import ref as jref
from repro.kernels.ssd_scan import ssd_scan_pallas
from repro.models import ssm as jssm
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssd_scan as tscan
from repro_torch.models import ssm as tssm

from torch_parity import JDT, TDT


def _inputs(rng, B, S, H, P, N, dt="f32"):
    """x, dt, A, B, C for both packages; x, B, C rounded through the
    working dtype, so bf16 values are equal on each side."""
    rd = lambda a: np.asarray(jnp.asarray(a, JDT[dt]).astype(jnp.float32))
    x = rd(rng.standard_normal((B, S, H, P)))
    dts = np.asarray(jax.nn.softplus(jnp.asarray(
        rng.standard_normal((B, S, H)), jnp.float32)))
    A = (-np.exp(rng.standard_normal(H) * 0.3)).astype(np.float32)
    Bm = rd(rng.standard_normal((B, S, N)) * 0.5)
    Cm = rd(rng.standard_normal((B, S, N)) * 0.5)
    return x, dts, A, Bm, Cm


def _both(args, dt="f32"):
    x, dts, A, Bm, Cm = args
    j = (jnp.asarray(x, JDT[dt]), jnp.asarray(dts), jnp.asarray(A),
         jnp.asarray(Bm, JDT[dt]), jnp.asarray(Cm, JDT[dt]))
    t = (torch.tensor(x).to(TDT[dt]), torch.tensor(dts), torch.tensor(A),
         torch.tensor(Bm).to(TDT[dt]), torch.tensor(Cm).to(TDT[dt]))
    return j, t


@pytest.mark.parametrize("S,H,P,N,chunk", [(128, 2, 32, 16, 32),
                                           (256, 3, 64, 16, 64),
                                           (256, 2, 32, 128, 128),
                                           (64, 1, 64, 64, 64)])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_ssd_scan_matches_pallas(S, H, P, N, chunk, dt, rng):
    j, t = _both(_inputs(rng, 2, S, H, P, N, dt), dt)
    yk, hk = ssd_scan_pallas(*j, chunk, interpret=True)
    tol = 1e-4 if dt == "f32" else 5e-2
    scale = max(1.0, float(jnp.max(jnp.abs(yk.astype(jnp.float32)))))
    for y, h in (tref.ssd_scan_ref(*t, chunk), tops.ssd_scan(*t, chunk)):
        assert y.dtype == h.dtype == TDT[dt]
        for got, want in ((y, yk), (h, hk)):
            np.testing.assert_allclose(got.float().numpy(),
                                       np.asarray(want, np.float32),
                                       rtol=tol, atol=tol * scale)


def test_ssd_scan_matches_sequential_recurrence(rng):
    """The chunked scan against the independent O(S) recurrence, and the
    port's recurrence against the reference's."""
    j, t = _both(_inputs(rng, 2, 128, 2, 16, 8))
    ys, hs = tref.ssd_sequential_ref(*t)
    for got, want in zip((ys, hs), jref.ssd_sequential_ref(*j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
    for got, want in zip(tops.ssd_scan(*t, 32), (ys, hs)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-3,
                                   atol=1e-3)


def test_ssd_chunked_bf16_promotes_like_the_reference(rng):
    """bf16 x and f32 dt: the model's scan runs its mixed einsums in f32,
    as jnp.einsum promotes (torch.einsum would refuse the mix)."""
    j, t = _both(_inputs(rng, 2, 96, 3, 32, 16, "bf16"), "bf16")
    got = tssm.ssd_chunked(*t, 32)
    want = jssm.ssd_chunked(*j, 32)
    scale = max(1.0, float(jnp.max(jnp.abs(want[0].astype(jnp.float32)))))
    # y in the promoted f32, the state back in x's dtype, as the reference
    assert (got[0].dtype, got[1].dtype) == (torch.float32, torch.bfloat16)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32), rtol=5e-2,
                                   atol=5e-2 * scale)


def _ssm_params(rng, d_model, ssm):
    p = jax.tree_util.tree_map(
        np.asarray, jssm.init_ssm_params(jax.random.PRNGKey(3), d_model, ssm,
                                         1))
    p = {k: v[0] for k, v in p.items()}
    for k in ("A_log", "D", "dt_bias", "norm", "conv_b"):
        p[k] = (rng.standard_normal(p[k].shape) * 0.3).astype(np.float32)
    return p


@pytest.mark.parametrize("S,lens", [(64, None), (40, (40, 7, 33))])
def test_ssm_forward_cuda_matches_pallas(S, lens, rng):
    """The block through the scan kernel's path: S a multiple of the chunk,
    and S = 40 padded to it with right-padded rows."""
    cfg = jcfg.get_config("hymba-1.5b").reduced()
    ssm, d = cfg.ssm, cfg.d_model
    p = _ssm_params(rng, d, ssm)
    tp = {k: torch.tensor(v) for k, v in p.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    x = rng.standard_normal((3, S, d)).astype(np.float32)
    kw_t = {} if lens is None else {"seq_lens": torch.tensor(lens)}
    kw_j = {} if lens is None else {"seq_lens": jnp.asarray(lens)}
    out, (st, cs) = tssm.ssm_forward(tp, torch.tensor(x), ssm, kernel="cuda",
                                     **kw_t)
    jout, (jst, jcs) = jssm.ssm_forward(jp, jnp.asarray(x), ssm,
                                        kernel="pallas", **kw_j)
    for b, n in enumerate(lens or (S,) * 3):
        np.testing.assert_allclose(out[b, :n].numpy(), np.asarray(jout[b, :n]),
                                   rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(st.numpy(), np.asarray(jst), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(cs.numpy(), np.asarray(jcs), rtol=1e-5,
                               atol=1e-5)


def test_ssd_scan_wrapper_refusals(rng):
    _, (x, dts, A, Bm, Cm) = _both(_inputs(rng, 1, 64, 2, 32, 16))
    with pytest.raises(ValueError, match="not divisible"):
        tops.ssd_scan(x[:, :48], dts[:, :48], A, Bm[:, :48], Cm[:, :48], 32)
    bad = [
        (x[..., :30], dts, A, Bm, Cm),                     # P % 4
        (x, dts.double(), A, Bm, Cm),                      # dt not f32
        (x, dts, A, Bm.bfloat16(), Cm),                    # B's dtype
        (x, dts, A[:1], Bm, Cm),                           # A's shape
        (x.transpose(1, 2).contiguous().transpose(1, 2), dts, A, Bm, Cm),
    ]
    for args in bad:
        with pytest.raises(ValueError):
            tops.ssd_scan(*args, 32)
    xg = x.clone().requires_grad_(True)
    with pytest.raises(ValueError, match="no backward"):
        tops.ssd_scan(xg, dts, A, Bm, Cm, 32)
    with torch.no_grad():
        tops.ssd_scan(xg, dts, A, Bm, Cm, 32)


def test_block_chunk_fits_shared_memory():
    """The wrapper's constants are the kernels' own (csrc/ssd_scan.cu): the
    kernels' chunk, kQ = 16 kWarps rows, and the largest P and N. That a
    block of that chunk fits shared memory at P = 64, N = 128 is held on
    the card (test_torch_cuda_forward.py, chip_smoke.py's SCAN_SHAPES)."""
    src = (Path(tscan.__file__).parent / "csrc" / "ssd_scan.cu").read_text()
    const = dict(re.findall(r"constexpr int (\w+) = ([^;]+);", src))
    assert const["kQ"] == "16 * kWarps"
    assert 16 * int(const["kWarps"]) == tscan.BLOCK_CHUNK == 64
    assert int(const["kMaxP"]) == tscan.MAX_P
    assert int(const["kMaxN"]) == tscan.MAX_N

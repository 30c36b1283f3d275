"""The algebra of the SSD scan kernel's split across the card
(``csrc/ssd_scan.cu``): a plain torch version of its three passes (chunk
states, state passing across chunks, chunk outputs), kept here, against
the reference's Pallas scan in interpret mode and against the O(S)
recurrence, on the same numpy inputs; rows of dt = 0 (the model's chunk
padding, and the kernels' ragged last chunk) leave the state of the live
rows."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.kernels import ref as jref
from repro.kernels.ssd_scan import ssd_scan_pallas
from repro_torch.kernels import ref as tref

from torch_parity import JDT, TDT


def three_pass(x, dt, A, Bm, Cm, Q: int):
    """The kernels' passes in f32 over chunks of Q rows, the sequence
    padded to a whole chunk with dt = 0 rows. Returns (y, final state)."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    nc = -(-S // Q)
    pad = nc * Q - S

    def chunks(t):      # (B, S, ...) -> (B, nc, Q, ...), f32
        t = torch.nn.functional.pad(t.float(), (0, 0) * (t.dim() - 2)
                                    + (0, pad))
        return t.reshape(B, nc, Q, *t.shape[2:])

    xs, dts, bs, cs = chunks(x), chunks(dt), chunks(Bm), chunks(Cm)
    cum = torch.cumsum(dts * A.float(), dim=2)                # (B,nc,Q,H)
    xdt = xs * dts[..., None]
    # 1. chunk states: contribution and decay of each (b, h, chunk)
    w = torch.exp(cum[:, :, -1:] - cum)
    contrib = torch.einsum("bcqhp,bcqh,bcqn->bhcpn", xdt, w, bs)
    decay = torch.exp(cum[:, :, -1]).permute(0, 2, 1)         # (B,H,nc)
    # 2. state passing: the state entering each chunk, and the final one
    h = torch.zeros((B, H, P, N))
    enter = []
    for c in range(nc):
        enter.append(h)
        h = h * decay[:, :, c, None, None] + contrib[:, :, c]
    enter = torch.stack(enter, dim=2)                         # (B,H,nc,P,N)
    # 3. chunk outputs: the chunk's own rows, then its entering state
    cumh = cum.permute(0, 1, 3, 2)                            # (B,nc,H,Q)
    seg = cumh[..., :, None] - cumh[..., None, :]
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool))
    L = torch.where(tri, torch.exp(seg), torch.zeros(()))
    G = torch.einsum("bcin,bcjn->bcij", cs, bs)
    y = torch.einsum("bchij,bcij,bcjhp->bcihp", L, G, xdt)
    y = y + torch.einsum("bcin,bcih,bhcpn->bcihp", cs, torch.exp(cum), enter)
    y = y.reshape(B, nc * Q, H, P)[:, :S]
    return y.to(x.dtype), h.to(x.dtype)


def _inputs(rng, B, S, H, P, N, dt="f32"):
    """x, dt, A, B, C as numpy; x, B, C rounded through the working dtype,
    so bf16 values are equal on each side."""
    rd = lambda a: np.asarray(jnp.asarray(a, JDT[dt]).astype(jnp.float32))
    x = rd(rng.standard_normal((B, S, H, P)))
    dts = np.asarray(jax.nn.softplus(jnp.asarray(
        rng.standard_normal((B, S, H)), jnp.float32)))
    A = (-np.exp(rng.standard_normal(H) * 0.3)).astype(np.float32)
    Bm = rd(rng.standard_normal((B, S, N)) * 0.5)
    Cm = rd(rng.standard_normal((B, S, N)) * 0.5)
    return x, dts, A, Bm, Cm


def _torch(args, dt="f32"):
    x, dts, A, Bm, Cm = args
    return (torch.tensor(x).to(TDT[dt]), torch.tensor(dts), torch.tensor(A),
            torch.tensor(Bm).to(TDT[dt]), torch.tensor(Cm).to(TDT[dt]))


@pytest.mark.parametrize("nc", [1, 2, 8])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_three_passes_match_pallas(nc, dt, rng):
    """1, 2 and 8 chunks of 32 rows against the Pallas scan in the same
    chunks, to ``test_torch_ssd_scan.py``'s tolerances."""
    Q = 32
    args = _inputs(rng, 2, nc * Q, 3, 32, 16, dt)
    x, dts, A, Bm, Cm = args
    yk, hk = ssd_scan_pallas(jnp.asarray(x, JDT[dt]), jnp.asarray(dts),
                             jnp.asarray(A), jnp.asarray(Bm, JDT[dt]),
                             jnp.asarray(Cm, JDT[dt]), Q, interpret=True)
    y, h = three_pass(*_torch(args, dt), Q)
    assert y.dtype == h.dtype == TDT[dt]
    tol = 1e-4 if dt == "f32" else 5e-2
    scale = max(1.0, float(jnp.max(jnp.abs(yk.astype(jnp.float32)))))
    for got, want in ((y, yk), (h, hk)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), rtol=tol,
                                   atol=tol * scale)


@pytest.mark.parametrize("nc", [1, 2, 8])
def test_three_passes_match_sequential_recurrence(nc, rng):
    """Against the independent O(S) recurrence, in chunks of 16 and of 64
    rows (a chunk longer than the sequence is its ragged last chunk)."""
    args = _torch(_inputs(rng, 2, nc * 16, 2, 16, 8))
    ys, hs = tref.ssd_sequential_ref(*args)
    for Q in (16, 64):
        for got, want in zip(three_pass(*args, Q), (ys, hs)):
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-3,
                                       atol=1e-3)


def test_padded_tail_keeps_the_live_state(rng):
    """dt = 0 rows after the live ones, as ``ssm_forward`` pads to the
    chunk: the final state is that of the live rows alone, through a
    whole padded chunk and a partly padded one; the live rows' y are
    unchanged."""
    S, live, Q = 8 * 32, 8 * 32 - 45, 32
    x, dts, A, Bm, Cm = _inputs(rng, 2, S, 3, 32, 16)
    dts = dts.copy()
    dts[:, live:] = 0.0
    padded = _torch((x, dts, A, Bm, Cm))
    alone = _torch((x[:, :live], dts[:, :live], A, Bm[:, :live],
                    Cm[:, :live]))
    y_pad, h_pad = three_pass(*padded, Q)
    y_live, h_live = three_pass(*alone, Q)
    np.testing.assert_allclose(h_pad.numpy(), h_live.numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(y_pad[:, :live].numpy(), y_live.numpy(),
                               rtol=1e-5, atol=1e-5)
    _, hs = tref.ssd_sequential_ref(*alone)
    np.testing.assert_allclose(h_pad.numpy(), hs.numpy(), rtol=1e-3,
                               atol=1e-3)
    jx, jdt, jA, jB, jC = (jnp.asarray(a) for a in (x, dts, A, Bm, Cm))
    _, hj = jref.ssd_sequential_ref(jx[:, :live], jdt[:, :live], jA,
                                    jB[:, :live], jC[:, :live])
    np.testing.assert_allclose(h_pad.numpy(), np.asarray(hj), rtol=1e-3,
                               atol=1e-3)

"""The plain versions of the port's decode kernels (and their wrappers,
which compute them on CPU tensors) against the reference's Pallas decode
kernels in interpret mode, on the same numpy inputs: the ring attend, the
extent attend and the SSD step (the cases of ``tests/test_kernels.py``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.kernels import ref as jref
from repro.kernels.ssd_scan import ssd_decode_step_pallas
from repro.kernels.swa_attention import (extent_decode_attend_pallas,
                                         ring_decode_attend_pallas)
from repro_torch.kernels import decode_attend as tda
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssd_decode as tsd

TOL = 1e-5


def _attend_inputs(rng, B, KV, G, D, L):
    q = (rng.standard_normal((B, KV, G, D)) * 0.4).astype(np.float32)
    k = (rng.standard_normal((B, L, KV, D)) * 0.4).astype(np.float32)
    v = rng.standard_normal((B, L, KV, D)).astype(np.float32)
    return q, k, v


def _pos(B, p):
    return torch.full((B,), p, dtype=torch.int32)


def _both(got_ref, got_wrap, want):
    for got in (got_ref, got_wrap):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=TOL, atol=TOL)


# odd windows, window 0 (full), W = 1, pos < W (short prompt) and pos >> W
@pytest.mark.parametrize("W,pos,window", [
    (16, 5, 7),        # pos < W: unwritten slots must be masked
    (16, 40, 7),       # wrapped ring, odd window
    (16, 40, 13),      # odd window > half the ring
    (16, 3, 0),        # full attention over a partially written ring
    (1, 0, 1),         # W = 1 edge: only the current token
    (1, 25, 1),
    (17, 33, 17),      # odd ring capacity
])
def test_ring_decode_attend_matches_pallas(W, pos, window, rng):
    B, KV, G, D = 3, 2, 3, 16
    q, k, v = _attend_inputs(rng, B, KV, G, D, W)
    want = ring_decode_attend_pallas(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), jnp.int32(pos),
                                     jnp.int32(window), interpret=True)
    t = [torch.tensor(a) for a in (q, k, v)]
    before = tda.ring_decode_attend.launches
    _both(tref.ring_decode_attend_ref(*t, _pos(B, pos), window),
          tda.ring_decode_attend(*t, _pos(B, pos), window), want)
    assert tda.ring_decode_attend.launches == before   # CPU: no launch


def _per_row(kernel, q, k, v, rows, *args):
    """The reference kernel run row by row at each row's scalar position."""
    return np.concatenate([np.asarray(kernel(
        jnp.asarray(q[b:b + 1]), jnp.asarray(k[b:b + 1]),
        jnp.asarray(v[b:b + 1]), jnp.int32(p), *args, interpret=True))
        for b, p in enumerate(rows)])


def test_ring_decode_attend_per_row_positions(rng):
    """Each row at its own position (the port's batched slots) equals the
    reference kernel run row by row at that row's scalar position. Then
    the visibility splits of the CUDA kernel's design, which divides each
    row's visible keys evenly over a cluster of ceil(L / 64) <= 16 blocks:
    at L = 1024 (16 blocks of 64 keys) a ring row not yet full (41 of
    1024 slots written), a wrapped one, and windows of 5 and 100 keys,
    shorter than or across one block's share; at k_ext = 2048 (16 blocks of
    up to 128) extent rows with pos + 1 < k_ext, windows 0 and 30."""
    B, KV, G, D, W, window = 4, 2, 2, 16, 17, 9
    q, k, v = _attend_inputs(rng, B, KV, G, D, W)
    rows = [3, 16, 40, 100]
    want = _per_row(ring_decode_attend_pallas, q, k, v, rows,
                    jnp.int32(window))
    pos = torch.tensor(rows, dtype=torch.int32)
    t = [torch.tensor(a) for a in (q, k, v)]
    _both(tref.ring_decode_attend_ref(*t, pos, window),
          tda.ring_decode_attend(*t, pos, window), want)

    B, KV, G, D = 2, 1, 2, 16
    q, k, v = _attend_inputs(rng, B, KV, G, D, 1024)
    rows = [40, 1500]
    pos = torch.tensor(rows, dtype=torch.int32)
    t = [torch.tensor(a) for a in (q, k, v)]
    for window in (5, 100):
        want = _per_row(ring_decode_attend_pallas, q, k, v, rows,
                        jnp.int32(window))
        _both(tref.ring_decode_attend_ref(*t, pos, window),
              tda.ring_decode_attend(*t, pos, window), want)
    q, k, v = _attend_inputs(rng, B, KV, G, D, 2048)
    rows = [700, 2046]
    pos = torch.tensor(rows, dtype=torch.int32)
    t = [torch.tensor(a) for a in (q, k, v)]
    for window in (0, 30):
        want = _per_row(extent_decode_attend_pallas, q, k, v, rows,
                        jnp.int32(window), 2048)
        _both(tref.extent_decode_attend_ref(*t, pos, window, 2048),
              tda.extent_decode_attend(*t, pos, window, 2048), want)


# k_ext at every rung of the pow-2 ladder (min_bucket 4 .. S_max 64)
@pytest.mark.parametrize("k_ext", [4, 8, 16, 32, 64])
def test_extent_decode_attend_ladder_matches_pallas(k_ext, rng):
    B, KV, G, D, S_max = 2, 2, 2, 16, 64
    q, k, v = _attend_inputs(rng, B, KV, G, D, S_max)
    t = [torch.tensor(a) for a in (q, k, v)]
    for window in (0, 5):
        # the deepest position the rung serves, and a shallow one whose
        # pad slots are k_len-masked
        for p in (k_ext - 1, 0):
            want = extent_decode_attend_pallas(
                jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                jnp.int32(p), jnp.int32(window), k_ext, interpret=True)
            _both(tref.extent_decode_attend_ref(*t, _pos(B, p), window,
                                                k_ext),
                  tda.extent_decode_attend(*t, _pos(B, p), window, k_ext),
                  want)


def test_extent_decode_attend_rejects_bad_extent():
    q = torch.zeros((1, 1, 1, 8))
    k = torch.zeros((1, 16, 1, 8))
    for k_ext in (0, 17):
        with pytest.raises(ValueError, match="k_ext"):
            tda.extent_decode_attend(q, k, k, _pos(1, 0), 0, k_ext)


def test_decode_attend_wrappers_check_their_inputs():
    q, k = torch.zeros((2, 1, 1, 8)), torch.zeros((2, 4, 1, 8))
    good = _pos(2, 1)
    bad = [
        (q, k, k, good.long()),                  # pos must be int32
        (q, k, k, _pos(3, 1)),                   # one position a row
        (q, k, torch.zeros((2, 4, 1, 4)), good),    # v != k
        (q, k.to(torch.float16), k.to(torch.float16), good),
        (q, torch.zeros((2, 8, 1, 8))[:, ::2], k, good),    # strided
        (q[:, :, :, :4], k, k, good),            # head dims differ
        (torch.zeros((2, 1, 17, 8)), k, k, good),    # G > 16
    ]
    for args in bad:
        with pytest.raises(ValueError):
            tda.ring_decode_attend(*args, 0)
    # no limit on the number of keys: 160000 slots at G = 16
    big = torch.ones((1, 160000, 1, 8))
    out = tda.ring_decode_attend(torch.zeros((1, 1, 16, 8)), big, big,
                                 _pos(1, 159999), 0)
    assert torch.allclose(out, torch.ones((1, 1, 16, 8)), rtol=0, atol=TOL)


def _ssd_inputs(rng, B, H, P, N):
    xh = rng.standard_normal((B, H, P)).astype(np.float32)
    dt = np.array(jax.nn.softplus(jnp.asarray(
        rng.standard_normal((B, H)), jnp.float32)))
    dt[1] = 0.0                      # pad-row: exact no-op on the state
    A = (-np.exp(rng.standard_normal(H) * 0.3)).astype(np.float32)
    Bm = (rng.standard_normal((B, N)) * 0.5).astype(np.float32)
    Cm = (rng.standard_normal((B, N)) * 0.5).astype(np.float32)
    st = rng.standard_normal((B, H, P, N)).astype(np.float32)
    return xh, dt, A, Bm, Cm, st


@pytest.mark.parametrize("B,H,P,N", [(3, 4, 8, 16), (2, 3, 5, 8)])
def test_ssd_decode_step_matches_pallas(B, H, P, N, rng):
    """Plain step and wrapper == the reference kernel, and the dt = 0
    row's state comes back bit for bit."""
    args = _ssd_inputs(rng, B, H, P, N)
    y_want, st_want = ssd_decode_step_pallas(
        *[jnp.asarray(a) for a in args], interpret=True)
    t = [torch.tensor(a) for a in args]
    before = tsd.ssd_decode_step.launches
    for y, st in (tref.ssd_decode_step_ref(*t), tsd.ssd_decode_step(*t)):
        np.testing.assert_allclose(y.numpy(), np.asarray(y_want),
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(st.numpy(), np.asarray(st_want),
                                   rtol=TOL, atol=TOL)
        assert torch.equal(st[1], t[-1][1])
        assert st.dtype == t[-1].dtype and y.dtype == torch.float32
    assert tsd.ssd_decode_step.launches == before


def test_ssd_decode_step_multi_step_vs_sequential(rng):
    """Iterating the step tracks the reference's O(S) recurrence."""
    B, S, H, P, N = 2, 24, 2, 8, 8
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.asarray(jax.nn.softplus(jnp.asarray(
        rng.standard_normal((B, S, H)), jnp.float32)))
    A = (-np.exp(rng.standard_normal(H) * 0.3)).astype(np.float32)
    Bm = (rng.standard_normal((B, S, N)) * 0.5).astype(np.float32)
    Cm = (rng.standard_normal((B, S, N)) * 0.5).astype(np.float32)
    ys_ref, h_ref = jref.ssd_sequential_ref(*[jnp.asarray(a) for a in
                                              (x, dt, A, Bm, Cm)])
    h = torch.zeros((B, H, P, N))
    ys = []
    for s in range(S):
        y, h = tsd.ssd_decode_step(torch.tensor(x[:, s]),
                                   torch.tensor(dt[:, s]), torch.tensor(A),
                                   torch.tensor(Bm[:, s]),
                                   torch.tensor(Cm[:, s]), h)
        ys.append(y)
    np.testing.assert_allclose(torch.stack(ys, 1).numpy(),
                               np.asarray(ys_ref), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_ref), rtol=1e-4,
                               atol=1e-4)


def test_decode_kernels_bf16_caches_match_pallas(rng):
    """bf16 caches and state (the serving cache dtype the reference
    defaults to), f32 activations: the plain versions follow the
    reference's bf16 rounding."""
    B, KV, G, D, W = 2, 2, 2, 16, 16
    q, k, v = _attend_inputs(rng, B, KV, G, D, W)
    kb = np.asarray(jnp.asarray(k, jnp.bfloat16).astype(jnp.float32))
    vb = np.asarray(jnp.asarray(v, jnp.bfloat16).astype(jnp.float32))
    want = ring_decode_attend_pallas(
        jnp.asarray(q), jnp.asarray(kb, jnp.bfloat16),
        jnp.asarray(vb, jnp.bfloat16), jnp.int32(20), jnp.int32(7),
        interpret=True)
    got = tda.ring_decode_attend(torch.tensor(q),
                                 torch.tensor(kb).bfloat16(),
                                 torch.tensor(vb).bfloat16(), _pos(B, 20), 7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    xh, dt, A, Bm, Cm, st = _ssd_inputs(rng, 2, 3, 4, 8)
    stb = np.asarray(jnp.asarray(st, jnp.bfloat16).astype(jnp.float32))
    y_want, st_want = ssd_decode_step_pallas(
        *[jnp.asarray(a) for a in (xh, dt, A, Bm, Cm)],
        jnp.asarray(stb, jnp.bfloat16), interpret=True)
    y, st_got = tsd.ssd_decode_step(
        *[torch.tensor(a) for a in (xh, dt, A, Bm, Cm)],
        torch.tensor(stb).bfloat16())
    assert st_got.dtype == torch.bfloat16 and y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(y_want), rtol=1e-2,
                               atol=1e-2)
    np.testing.assert_allclose(st_got.float().numpy(),
                               np.asarray(st_want.astype(jnp.float32)),
                               rtol=1e-2, atol=1e-2)
    assert torch.equal(st_got[1], torch.tensor(stb).bfloat16()[1])

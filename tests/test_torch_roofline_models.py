"""The hand kernels' analytic models (``repro_torch/roofline/analysis.py``):
the four decode models equal the reference's exactly over a grid; each
model pinned to the formula ``chip_smoke.py`` computed its bound with
before, at the shapes PERF.md's kernel table names; and each kernel
wrapper's count under a counter on the CPU equal to its model exactly,
the plain version's ops unseen."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.roofline import analysis as jan
from repro_torch.kernels import decode_attend as da
from repro_torch.kernels import kd_loss, ref, ssd_decode, ssd_scan
from repro_torch.kernels import swa_attention as swa
from repro_torch.roofline import HW
from repro_torch.roofline import analysis as an
from repro_torch.roofline.counter import Counter

# the figures chip_smoke.py held as constants
HBM, F32, TF32 = 3.35e12, 67e12, 495e12


def test_decode_models_equal_the_reference():
    for n_ctx in (1, 4, 64, 512, 4096):
        for kv, g, d in ((1, 1, 8), (2, 4, 64), (8, 1, 120), (5, 5, 64)):
            for db in (2, 4):
                for fused in (True, False):
                    assert an.attend_decode_bytes(
                        n_ctx, kv, kv * g, d, dtype_bytes=db, fused=fused) \
                        == jan.attend_decode_bytes(
                            n_ctx, kv, kv * g, d, dtype_bytes=db,
                            fused=fused)
            assert an.attend_decode_flops(n_ctx, kv * g, d) \
                == jan.attend_decode_flops(n_ctx, kv * g, d)
    for h, p, n in ((1, 1, 1), (8, 64, 128), (3, 5, 7), (50, 64, 16)):
        for db in (2, 4):
            for fused in (True, False):
                assert an.ssd_decode_bytes(h, p, n, dtype_bytes=db,
                                           fused=fused) \
                    == jan.ssd_decode_bytes(h, p, n, dtype_bytes=db,
                                            fused=fused)
        assert an.ssd_decode_flops(h, p, n) == jan.ssd_decode_flops(h, p, n)
    with pytest.raises(ValueError):
        an.attend_decode_bytes(0, 1, 1, 64)


def _bound_ms(cost) -> tuple:
    s, by = HW().bound_s(*cost)
    return s * 1e3, by


def _old(nbytes, ops_ms) -> tuple:
    bytes_ms = nbytes / HBM * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


@pytest.mark.parametrize("R,V,fwd_ms,bwd_ms", [
    (4, 400, 3.8e-6, 5.7e-6), (256, 50280, 0.03074, 0.04611),
    (256, 32001, 0.01956, 0.02935)])
def test_kd_models_pin_the_old_bounds(R, V, fwd_ms, bwd_ms):
    for cost, nbytes, ops, table in (
            (an.kd_loss_cost(R, V), 2 * R * V * 4 + 3 * R * 4, 7 * R * V,
             fwd_ms),
            (an.kd_loss_bwd_cost(R, V), 3 * R * V * 4 + 3 * R * 4,
             8 * R * V, bwd_ms)):
        assert cost == ({"f32": ops}, nbytes)
        old = _old(nbytes, ops / F32 * 1e3)
        assert _bound_ms(cost) == old
        assert old[0] == pytest.approx(table, rel=2e-2)


def _visible(mask) -> list:
    return [int(r) for r in mask.sum(dim=1)]


def test_decode_models_pin_the_old_bounds_at_hymba():
    """Hymba's decode (B 4, KV 5, G 5, D 64): the ring at W 1024, the
    extent at k_ext 2048, the SSD step at 50 x 64 x 16."""
    B, KV, G, D = 4, 5, 5, 64
    for kind, pos, L, window, table in (
            ("ring", [1100, 1500, 1030, 2000], 1024, 1024, 0.003145),
            ("extent", [2047, 1500, 1100, 1024], 2048, 0, 0.004352)):
        p = torch.tensor(pos, dtype=torch.int32)
        if kind == "ring":
            k_pos = p.long()[:, None] - (p.long()[:, None]
                                         - torch.arange(L)) % L
            mask = ref._window_bias(p, window, k_pos) == 0
            n_vis = an.ring_visible(pos, L, window)
        else:
            k_pos = torch.arange(L)[None, :]
            mask = (ref._window_bias(p, window, k_pos) == 0) \
                & (k_pos <= p.long()[:, None])
            n_vis = an.extent_visible(pos, L, window)
        assert n_vis == _visible(mask)
        n = sum(n_vis)
        nbytes = 2 * n * KV * D * 4 + 2 * B * KV * G * D * 4 + 4 * B
        ops = 4 * n * KV * G * D
        cost = an.decode_attend_cost(n_vis, KV, G, D)
        assert cost == ({"3xtf32": ops}, nbytes)
        assert nbytes == sum(an.attend_decode_bytes(k, KV, KV * G, D)
                             for k in n_vis) + 4 * B
        old = _old(nbytes, ops / F32 * 1e3)
        assert _bound_ms(cost) == (pytest.approx(old[0], rel=1e-12), old[1])
        assert old[0] == pytest.approx(table, rel=1e-3)
    B_, H, P, N = 4, 50, 64, 16
    nbytes = 4 * (2 * B_ * H * P * N + 2 * B_ * H * P + B_ * H + H
                  + 2 * B_ * N)
    cost = an.ssd_step_cost(B_, H, P, N)
    assert cost == ({"f32": B_ * an.ssd_decode_flops(H, P, N)}, nbytes)
    old = _old(nbytes, 6 * B_ * H * P * N / F32 * 1e3)
    assert _bound_ms(cost) == old
    assert old[0] == pytest.approx(0.00052, rel=1e-2)


@pytest.mark.parametrize("B,S,H,KV,D,window,table", [
    (2, 2048, 25, 5, 64, 1024, 0.1221), (2, 2048, 25, 5, 64, 2048, 0.1628),
    (1, 2048, 16, 8, 240, 1024, 0.1465), (1, 2048, 16, 8, 240, 2048, 0.1953),
    (1, 4096, 32, 8, 120, 4096, 0.7811)])
def test_swa_model_pins_the_old_bound(B, S, H, KV, D, window, table):
    nbytes = 2 * (B * S * H * D + B * S * KV * D) * 4
    ops = 4 * D * (B * H) * sum(min(i + 1, window) for i in range(S))
    cost = an.swa_attention_cost(B, S, H, KV, D, window)
    assert cost == ({"3xtf32": ops}, nbytes)
    old = _old(nbytes, 3 * ops / TF32 * 1e3)
    assert _bound_ms(cost) == (pytest.approx(old[0], rel=1e-12), old[1])
    assert old[0] == pytest.approx(table, rel=1e-3)


def test_ssd_scan_model_pins_the_old_bound():
    B, S, H, P, N = 2, 2048, 50, 64, 16
    nbytes = (2 * B * S * H * P * 4 + 4 * B * S * H + 4 * H
              + 2 * B * S * N * 4 + B * H * P * N * 4)
    Q = ssd_scan.BLOCK_CHUNK
    ops = (Q * (Q + 1) * (N + P) + 4 * Q * P * N) * B * H * (S // Q)
    cost = an.ssd_scan_cost(B, S, H, P, N, chunk=Q)
    assert cost == ({"3xtf32": ops}, nbytes)
    old = _old(nbytes, 3 * ops / TF32 * 1e3)
    assert _bound_ms(cost) == (pytest.approx(old[0], rel=1e-12), old[1])
    assert old[0] == pytest.approx(0.03182, rel=1e-3)


def _kd_inputs(R=3, V=10):
    g = torch.Generator().manual_seed(0)
    s, t = torch.randn(R, V, generator=g), torch.randn(R, V, generator=g)
    lab = torch.randint(0, V, (R,), generator=g, dtype=torch.int32)
    return s, t, lab


def _attend_inputs(B=2, KV=2, G=3, D=8, L=16):
    g = torch.Generator().manual_seed(1)
    return (torch.randn(B, KV, G, D, generator=g),
            torch.randn(B, L, KV, D, generator=g),
            torch.randn(B, L, KV, D, generator=g))


def _ssd_step():
    g = torch.Generator().manual_seed(2)
    B, H, P, N = 2, 3, 4, 5
    return ((torch.randn(B, H, P, generator=g), torch.rand(B, H, generator=g),
             -torch.rand(H, generator=g), torch.randn(B, N, generator=g),
             torch.randn(B, N, generator=g),
             torch.randn(B, H, P, N, generator=g)),
            an.ssd_step_cost(B, H, P, N))


def _scan():
    g = torch.Generator().manual_seed(3)
    B, S, H, P, N = 1, 32, 2, 4, 4
    return ((torch.randn(B, S, H, P, generator=g),
             torch.rand(B, S, H, generator=g), -torch.rand(H, generator=g),
             torch.randn(B, S, N, generator=g),
             torch.randn(B, S, N, generator=g)),
            an.ssd_scan_cost(B, S, H, P, N, chunk=ssd_scan.BLOCK_CHUNK))


def _cases():
    s, t, lab = _kd_inputs()
    lse, gr = torch.empty(3), torch.full((3,), 1.0 / 3)
    q, k, v = _attend_inputs()
    pos = torch.tensor([5, 20], dtype=torch.int32)
    qs, ks, vs = (torch.randn(2, 16, 8) for _ in range(3))
    qg, kg, vg = torch.randn(1, 16, 4, 8), torch.randn(1, 16, 2, 8), \
        torch.randn(1, 16, 2, 8)
    step, step_cost = _ssd_step()
    scan, scan_cost = _scan()
    return {
        "kd_loss": (lambda: kd_loss._fused_fwd(s, t, lab, 0.5, 1.0, None,
                                               lse),
                    an.kd_loss_cost(3, 10)),
        "kd_loss_bwd": (lambda: kd_loss.kd_loss_fused_bwd(
            s, t, lab, None, gr, lse, 0.5, 1.0, need_dt=False),
            an.kd_loss_bwd_cost(3, 10)),
        "ring_decode_attend": (
            lambda: da.ring_decode_attend(q, k, v, pos, 8),
            an.decode_attend_cost(an.ring_visible([5, 20], 16, 8), 2, 3, 8)),
        "extent_decode_attend": (
            lambda: da.extent_decode_attend(q, k, v, pos, 0, 12),
            an.decode_attend_cost(an.extent_visible([5, 20], 12, 0), 2, 3,
                                  8)),
        "ssd_decode_step": (lambda: ssd_decode.ssd_decode_step(*step),
                            step_cost),
        "swa_attention": (lambda: swa.swa_attention(qs, ks, vs, 5),
                          an.swa_attention_cost(2, 16, 1, 1, 8, 5)),
        "swa_attention_gqa": (lambda: swa.swa_attention_gqa(qg, kg, vg, 5),
                              an.swa_attention_cost(1, 16, 4, 2, 8, 5)),
        "ssd_scan": (lambda: ssd_scan.ssd_scan(*scan, chunk=16), scan_cost),
    }


@pytest.mark.parametrize("case", ["kd_loss", "kd_loss_bwd",
                                  "ring_decode_attend",
                                  "extent_decode_attend", "ssd_decode_step",
                                  "swa_attention", "swa_attention_gqa",
                                  "ssd_scan"])
def test_wrapper_counts_its_model_exactly(case):
    fn, (flops, nbytes) = _cases()[case]
    plain = fn()                       # outside a counter: the plain version
    with Counter() as c:
        out = fn()
    assert c.ops == 0, "the plain version's ops were counted"
    assert c.flops == flops and c.bytes == nbytes
    name = case.removesuffix("_gqa")
    assert c.kernels == {name: {"launches": 1, "flops": sum(flops.values()),
                                "bytes": nbytes}}
    leaves = lambda t: [x for x in torch.utils._pytree.tree_leaves(t)
                        if isinstance(x, torch.Tensor)]
    for a, b in zip(leaves(out), leaves(plain), strict=True):
        np.testing.assert_array_equal(a.numpy(), b.numpy())

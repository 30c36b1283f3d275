"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card. Needs an NVIDIA GPU and nvcc; elsewhere every test
skips with a reason. Imports no JAX, so the GPU machine runs it alone:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""
import itertools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import distill
from repro_torch.kernels import kd_loss as tkd
from repro_torch.kernels import ref as tref

pytestmark = pytest.mark.cuda

TOL = 1e-4      # |kernel - plain| <= TOL * (1 + |plain|): reduction order


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(rng, R, V, dtype, device):
    s = torch.tensor(rng.standard_normal((R, V)), dtype=torch.float32)
    t = torch.tensor(rng.standard_normal((R, V)), dtype=torch.float32)
    lab = torch.tensor(rng.integers(0, V, R), dtype=torch.int32)
    return s.to(device, dtype), t.to(device, dtype), lab.to(device)


def _close(got, want):
    return bool(((got.float() - want.float()).abs()
                 <= TOL * (1 + want.float().abs())).all())


@pytest.mark.parametrize("R,V", [(4, 400), (128, 400), (37, 1000), (8, 513),
                                 (3, 4096)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kd_loss_kernel_matches_plain(cuda, R, V, dtype, rng):
    s, t, lab = _inputs(rng, R, V, dtype, cuda)
    before = tkd.kd_loss_fused.launches
    got = tkd.kd_loss_fused(s, t, lab, 0.3, temperature=2.0)
    torch.cuda.synchronize()
    assert tkd.kd_loss_fused.launches == before + 1
    assert _close(got, tref.kd_loss_ref(s, t, lab, 0.3, temperature=2.0))


def test_kd_loss_kernel_masked_rows_and_backward(cuda, rng):
    R, V = 8, 400
    s, t, lab = _inputs(rng, R, V, torch.float32, cuda)
    garbage = torch.tensor([[math.nan] * V, [math.inf] * V, [1e30] * V],
                           device=cuda)
    sp = torch.cat([s, garbage]).requires_grad_(True)
    tp = torch.cat([t, garbage])
    lab_pad = torch.cat([lab, torch.zeros(3, dtype=torch.int32,
                                          device=cuda)])
    valid = torch.tensor([1.0] * R + [0.0] * 3, device=cuda)
    out = tkd.kd_loss_rows(sp, tp, lab_pad, 0.5, valid=valid)
    assert torch.equal(out[R:], torch.zeros(3, device=cuda))
    assert torch.equal(out[:R], tkd.kd_loss_fused(s, t, lab, 0.5))
    out.sum().backward()
    assert torch.equal(sp.grad[R:], torch.zeros(3, V, device=cuda))
    sq = s.clone().requires_grad_(True)
    tref.kd_loss_ref(sq, t, lab, 0.5).sum().backward()
    assert _close(sp.grad[:R], sq.grad)


def test_kd_loss_kernel_rejects_mixed_devices_and_strides(cuda):
    s = torch.zeros(4, 8, device=cuda)
    lab = torch.zeros(4, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        tkd.kd_loss_fused(s, torch.zeros(4, 8), lab, 0.5)
    with pytest.raises(ValueError):
        tkd.kd_loss_fused(torch.zeros(8, 4, device=cuda).T, s, lab, 0.5)


def _bwd_close(got, want, dtype):
    """Within TOL of the plain version; in bf16 both round nearly equal f32
    values, so they may also differ by one bf16 step (2^-7 of |ref|)."""
    step = 2.0 ** -7 if dtype == torch.bfloat16 else 0.0
    want = want.float()
    return bool(((got.float() - want).abs()
                 <= TOL * (1 + want.abs()) + step * want.abs()).all())


def test_kd_loss_backward_kernel_matches_plain(cuda, rng):
    """The backward kernel against ``kd_loss_rows_bwd`` from the forward
    kernel's saved logsumexp: 16-byte rows (400, 1000), scalar rows (513),
    one block a row (4096); f32 and bf16; masked rows holding NaN, Inf and
    1e30 give exact zeros; without dt, none is written. At (4, 400) the
    cotangent is also a masked mean's: one value broadcast, stride 0."""
    for (R, V, broadcast), dtype in itertools.product(
            ((4, 400, False), (4, 400, True), (37, 1000, False),
             (8, 513, False), (3, 4096, False)),
            (torch.float32, torch.bfloat16)):
        s, t, lab = _inputs(rng, R, V, dtype, cuda)
        s[1], t[1], s[2] = math.nan, math.inf, 1e30
        valid = torch.ones(R, device=cuda)
        valid[1:3] = 0.0
        if broadcast:
            g = torch.full((1,), 0.5, device=cuda).expand(R)
            assert g.stride(0) == 0
        else:
            g = torch.tensor(rng.standard_normal(R), dtype=torch.float32,
                             device=cuda)
        lse = torch.empty(R, device=cuda)
        fwd = tkd.kd_loss_fused.launches
        out = tkd._fused_fwd(s, t, lab, 0.3, 2.0, valid, lse)
        assert tkd.kd_loss_fused.launches == fwd + 1
        assert torch.equal(out[1:3], torch.zeros(2, device=cuda))
        live = valid > 0
        assert _close(lse[live], torch.logsumexp(s[live].float(), -1))
        want_ds, want_dt = tkd.kd_loss_rows_bwd(s, t, lab, valid, g, 0.3, 2.0)
        for need_dt in (True, False):
            before = tkd.kd_loss_fused_bwd.launches
            ds, dt = tkd.kd_loss_fused_bwd(s, t, lab, valid, g, lse, 0.3,
                                           2.0, need_dt=need_dt)
            torch.cuda.synchronize()
            assert tkd.kd_loss_fused_bwd.launches == before + 1
            assert ds.dtype == dtype and (dt is not None) == need_dt
            assert _bwd_close(ds, want_ds, dtype), (R, V, dtype, need_dt)
            assert torch.equal(ds[1:3], torch.zeros_like(ds[1:3]))
            if need_dt:
                assert _bwd_close(dt, want_dt, dtype), (R, V, dtype)
                assert torch.equal(dt[1:3], torch.zeros_like(dt[1:3]))


def test_distill_kd_loss_goes_through_the_kernel(cuda, rng):
    """``distill.kd_loss`` through both kernels against the eager loss:
    the value, and with a mask the gradients (the masked mean's sum hands
    the backward kernel a stride-0 cotangent)."""
    s, t, lab = _inputs(rng, 4, 400, torch.float32, cuda)
    before = tkd.kd_loss_fused.launches
    got = distill.kd_loss(s, t, lab, 0.5, kd_kernel="cuda")
    assert tkd.kd_loss_fused.launches == before + 1
    want = distill.kd_loss(s, t, lab, 0.5, kd_kernel="eager")
    assert _close(got, want)
    assert np.isfinite(got.item())
    valid = torch.tensor([1.0, 0.0, 1.0, 1.0], device=cuda)
    grads = []
    for kernel in ("cuda", "eager"):
        sp = s.clone().requires_grad_(True)
        tp = t.clone().requires_grad_(True)
        distill.kd_loss(sp, tp, lab, 0.3, temperature=2.0, kd_kernel=kernel,
                        valid=valid).backward()
        grads.append((sp.grad, tp.grad))
    for a, b in zip(*grads):
        assert _close(a, b)
        assert torch.equal(a[1], torch.zeros_like(a[1]))


# ---------------------------------------------------------------------------
# Serving decode kernels: ring attend, extent attend, SSD step
# ---------------------------------------------------------------------------

SERVE_TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-2}


def _serve_close(got, want, tol):
    return bool(((got.float() - want.float()).abs()
                 <= tol * (1 + want.float().abs())).all())


def _attend(rng, B, KV, G, D, L, q_dtype, kv_dtype, device):
    q = torch.tensor(rng.standard_normal((B, KV, G, D)) * 0.4,
                     dtype=torch.float32)
    k = torch.tensor(rng.standard_normal((B, L, KV, D)) * 0.4,
                     dtype=torch.float32)
    v = torch.tensor(rng.standard_normal((B, L, KV, D)), dtype=torch.float32)
    return q.to(device, q_dtype), k.to(device, kv_dtype), \
        v.to(device, kv_dtype)


DTYPE_MIXES = ((torch.float32, torch.float32),
               (torch.float32, torch.bfloat16),
               (torch.bfloat16, torch.bfloat16))


def _tol(*dtypes):
    return SERVE_TOL[torch.bfloat16 if torch.bfloat16 in dtypes
                     else torch.float32]


def test_ring_and_extent_kernels_match_plain(cuda, rng):
    """f32 and bf16 caches. Per-row positions: rings not yet full (the
    floor-mod case), wrapped rings, W = 1 and odd W and windows; the
    extent on every rung with a shallow and the deepest row. D = 18 takes
    the scalar loads, the others the vector loads."""
    from repro_torch.kernels import decode_attend as tda
    for (q_dtype, kv_dtype), (B, KV, G, D) in itertools.product(
            DTYPE_MIXES, ((4, 5, 5, 64), (2, 2, 2, 240), (3, 2, 3, 18))):
        tol = _tol(q_dtype, kv_dtype)
        for W in (1, 17, 64):
            q, k, v = _attend(rng, B, KV, G, D, W, q_dtype, kv_dtype, cuda)
            pos = torch.tensor([W // 2, 3 * W + 5, W - 1, 40][:B],
                               dtype=torch.int32, device=cuda)
            for window in (0, W if W % 2 else W - 1):
                before = tda.ring_decode_attend.launches
                got = tda.ring_decode_attend(q, k, v, pos, window)
                torch.cuda.synchronize()
                assert tda.ring_decode_attend.launches == before + 1
                assert got.dtype == q_dtype
                assert _serve_close(got, tref.ring_decode_attend_ref(
                    q, k, v, pos, window), tol), (B, KV, G, D, W, window)
        q, k, v = _attend(rng, B, KV, G, D, 128, q_dtype, kv_dtype, cuda)
        for k_ext in (8, 16, 32, 64, 128):
            pos = torch.tensor([0, k_ext - 1, k_ext // 2, k_ext - 1][:B],
                               dtype=torch.int32, device=cuda)
            for window in (0, 5):
                got = tda.extent_decode_attend(q, k, v, pos, window, k_ext)
                assert _serve_close(got, tref.extent_decode_attend_ref(
                    q, k, v, pos, window, k_ext), tol), (D, k_ext, window)


def test_extent_kernel_past_the_old_shared_memory_limit(cuda, rng):
    """131072 keys of one row at Hymba's attend heads (KV = 5, G = 5,
    D = 64): far past the ~84k that fit one block's shared memory before
    the kernel split the keys over a cluster in fixed-size tiles. Every key
    visible, then a window of 1000; f32 and bf16 caches."""
    from repro_torch.kernels import decode_attend as tda
    B, KV, G, D, L = 1, 5, 5, 64, 131072
    pos = torch.tensor([L - 1], dtype=torch.int32, device=cuda)
    for q_dtype, kv_dtype in DTYPE_MIXES:
        q, k, v = _attend(rng, B, KV, G, D, L, q_dtype, kv_dtype, cuda)
        for window in (0, 1000):
            got = tda.extent_decode_attend(q, k, v, pos, window, L)
            torch.cuda.synchronize()
            assert _serve_close(got, tref.extent_decode_attend_ref(
                q, k, v, pos, window, L), _tol(q_dtype, kv_dtype)), \
                (q_dtype, kv_dtype, window)


def _ssd_path_views(rng, B, H, P, N, x_dtype, state_dtype, cuda, skew):
    """x, B and C as views of one (B, H*P + 2N + skew) conv output, as
    ``ssm_decode_step`` cuts them; ``skew`` = 1 shifts B and C off their
    16-byte alignment (the scalar path)."""
    di = H * P
    xbc = torch.tensor(rng.standard_normal((B, di + 2 * N + skew)) * 0.5,
                       dtype=torch.float32).to(cuda, x_dtype)
    xh = xbc[:, :di].reshape(B, H, P)
    Bm = xbc[:, di + skew:di + skew + N]
    Cm = xbc[:, di + skew + N:]
    dt = torch.nn.functional.softplus(torch.tensor(
        rng.standard_normal((B, H)), dtype=torch.float32))
    dt[1] = 0.0
    A = -torch.exp(torch.tensor(rng.standard_normal(H) * 0.3,
                                dtype=torch.float32))
    st = torch.tensor(rng.standard_normal((B, H, P, N)))
    return xh, dt.to(cuda), A.to(cuda), Bm, Cm, st.to(cuda, state_dtype)


def test_ssd_decode_kernel_matches_plain(cuda, rng):
    """Contiguous operands, then the path's own views with the state
    written in place (``state_out=state``): Hymba's N = 16 and N = 128 on
    the vector path, N = 6 and a B view off its alignment on the scalar
    path. One launch a call; a dt = 0 row's state stays bit for bit."""
    from repro_torch.kernels import ssd_decode as tsd
    for (x_dtype, state_dtype), (B, H, P, N, skew) in itertools.product(
            DTYPE_MIXES, ((4, 50, 64, 16, 0), (2, 3, 64, 128, 0),
                          (3, 4, 8, 6, 0), (4, 50, 64, 16, 1))):
        tol = _tol(x_dtype, state_dtype)
        args = _ssd_path_views(rng, B, H, P, N, x_dtype, state_dtype, cuda,
                               skew)
        y_ref, st_ref = tref.ssd_decode_step_ref(*args)
        state = args[-1]
        before, ptr = state.clone(), state.data_ptr()
        launches = tsd.ssd_decode_step.launches
        y, st = tsd.ssd_decode_step(*args, state_out=state)
        torch.cuda.synchronize()
        assert tsd.ssd_decode_step.launches == launches + 1
        assert st.data_ptr() == ptr and y.dtype == y_ref.dtype
        assert _serve_close(y, y_ref, tol) and _serve_close(st, st_ref, tol)
        assert torch.equal(st[1], before[1]), (B, H, P, N, skew)
    for (x_dtype, state_dtype), (B, H, P, N) in itertools.product(
            DTYPE_MIXES, ((4, 50, 64, 16), (2, 3, 5, 128), (3, 4, 8, 6))):
        tol = _tol(x_dtype, state_dtype)
        dt = torch.nn.functional.softplus(torch.tensor(
            rng.standard_normal((B, H)), dtype=torch.float32))
        dt[1] = 0.0
        args = (torch.tensor(rng.standard_normal((B, H, P))).to(cuda,
                                                                x_dtype),
                dt.to(cuda),
                -torch.exp(torch.tensor(rng.standard_normal(H) * 0.3,
                                        dtype=torch.float32)).to(cuda),
                torch.tensor(rng.standard_normal((B, N)) * 0.5).to(cuda,
                                                                   x_dtype),
                torch.tensor(rng.standard_normal((B, N)) * 0.5).to(cuda,
                                                                   x_dtype),
                torch.tensor(rng.standard_normal((B, H, P, N))).to(
                    cuda, state_dtype))
        before = tsd.ssd_decode_step.launches
        y, st = tsd.ssd_decode_step(*args)
        torch.cuda.synchronize()
        assert tsd.ssd_decode_step.launches == before + 1
        y_ref, st_ref = tref.ssd_decode_step_ref(*args)
        assert y.dtype == y_ref.dtype and st.dtype == state_dtype
        assert _serve_close(y, y_ref, tol) and _serve_close(st, st_ref, tol)
        assert torch.equal(st[1], args[-1][1])      # dt = 0: exact


def test_decode_kernels_reject_mixed_devices(cuda):
    from repro_torch.kernels import decode_attend as tda
    from repro_torch.kernels import ssd_decode as tsd
    q = torch.zeros(2, 1, 1, 8, device=cuda)
    k = torch.zeros(2, 4, 1, 8, device=cuda)
    pos = torch.zeros(2, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        tda.ring_decode_attend(q, k, k, pos.cpu(), 0)
    with pytest.raises(ValueError):
        tda.extent_decode_attend(q, k.cpu(), k, pos, 0, 4)
    x = torch.zeros(2, 3, 4, device=cuda)
    with pytest.raises(ValueError):
        tsd.ssd_decode_step(x, torch.zeros(2, 3), torch.zeros(3, device=cuda),
                            torch.zeros(2, 8, device=cuda),
                            torch.zeros(2, 8, device=cuda),
                            torch.zeros(2, 3, 4, 8, device=cuda))


def test_serving_on_the_card_goes_through_the_kernels(cuda, rng):
    """Reduced Hymba served on the card: the CUDA decode gives the eager
    decode's tokens, and each eager tick and each capture of a decode
    shape's graph launches each kernel once per layer of its kind (a
    replay runs the captured kernels without the wrappers)."""
    from repro_torch.configs import get_config
    from repro_torch.core.serving import ContinuousBatcher, generate_single
    from repro_torch.kernels import decode_attend as tda
    from repro_torch.kernels import ssd_decode as tsd
    from repro_torch.models import lm, registry
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("hymba-1.5b").reduced()
    params = registry.init_params(torch.Generator().manual_seed(0), cfg,
                                  cuda)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (3, 9, 21, 70)]
    outs = {}
    for kern in ("cuda", "eager"):
        srv = ContinuousBatcher(params, cfg, max_slots=2, max_len=128,
                                min_bucket=4, decode_kernel=kern)
        counts = (tda.ring_decode_attend.launches,
                  tda.extent_decode_attend.launches,
                  tsd.ssd_decode_step.launches)
        for p in prompts:
            srv.submit(p, max_new=12)
        outs[kern] = {r.rid: r.out for r in srv.run()}
        n = srv.decode_compiles + srv._graphs.num_captured \
            if kern == "cuda" else 0
        assert n < srv._steps
        assert (tda.ring_decode_attend.launches,
                tda.extent_decode_attend.launches,
                tsd.ssd_decode_step.launches) == (
            counts[0] + n * len(lm.swa_layer_ids(cfg)),
            counts[1] + n * len(lm.global_layer_ids(cfg)),
            counts[2] + n * cfg.num_layers)
    assert outs["cuda"] == outs["eager"]
    assert outs["cuda"][3] == generate_single(params, cfg, prompts[3], 12,
                                              max_len=128)

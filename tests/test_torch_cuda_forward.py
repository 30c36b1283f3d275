"""The port's scoring kernels (sliding-window attention through both its
entries, the SSD chunk scan's three passes) against their plain PyTorch
versions on the card, and the scoring forward going through them. Needs
an NVIDIA GPU and nvcc; elsewhere every test skips with a reason. Imports
no JAX, so the GPU machine runs it alone:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda_forward.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssd_scan as tscan
from repro_torch.kernels import swa_attention as tswa

pytestmark = pytest.mark.cuda

# |kernel - plain| <= tol * (1 + |plain|): the order of f32 sums, and in
# bf16 one rounding of the output
TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _close(got, want, dtype):
    return bool(((got.float() - want.float()).abs()
                 <= TOL[dtype] * (1 + want.float().abs())).all())


def _t(rng, shape, scale, device, dtype):
    return torch.tensor(rng.standard_normal(shape) * scale,
                        dtype=torch.float32).to(device, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_swa_attention_kernel_matches_plain(cuda, dtype, rng):
    """Every head dim; S below one tile, ragged and several tiles; windows
    of one key, inside a tile, across tiles, S and 0 (full)."""
    for D, S in ((64, 40), (64, 384), (128, 256), (256, 128)):
        q, k = (_t(rng, (3, S, D), 0.3, cuda, dtype) for _ in range(2))
        v = _t(rng, (3, S, D), 1.0, cuda, dtype)
        for w in (1, 33, 100, S, 0):
            before = tswa.swa_attention.launches
            got = ops.swa_attention(q, k, v, w)
            torch.cuda.synchronize()
            assert tswa.swa_attention.launches == before + 1
            assert got.dtype == dtype
            assert _close(got, tref.swa_attention_ref(q, k, v, w or S),
                          dtype), (D, S, w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_swa_attention_gqa_entry_matches_plain(cuda, dtype, rng):
    """The model-layout entry at G = 1, 2 and 5 query heads a kv head and
    every head dim, against its plain version (repeat, fold, attend,
    unfold), one launch a call."""
    B, KV = 2, 2
    for D, S in ((64, 40), (64, 384), (128, 256), (256, 128)):
        k = _t(rng, (B, S, KV, D), 0.3, cuda, dtype)
        v = _t(rng, (B, S, KV, D), 1.0, cuda, dtype)
        for G in (1, 2, 5):
            q = _t(rng, (B, S, G * KV, D), 0.3, cuda, dtype)
            for w in (1, 33, 100, S, 0):
                before = tswa.swa_attention.launches
                got = ops.swa_attention_gqa(q, k, v, w)
                torch.cuda.synchronize()
                assert tswa.swa_attention.launches == before + 1
                assert got.dtype == dtype and got.is_contiguous()
                want = tref.swa_attention_gqa_ref(q, k, v, w or S)
                assert _close(got, want, dtype), (D, S, G, w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_swa_attention_head_dim_240_matches_plain(cuda, dtype, rng):
    """gemma3-12b's head dim 240 through both entries: G = 1 and 2 query
    heads a kv head (gemma3-12b has 2), S below one tile, ragged and
    several tiles, windows of one key up to full, one launch a call."""
    B, KV, D = 1, 2, 240
    for S in (40, 128, 256):
        k = _t(rng, (B, S, KV, D), 0.3, cuda, dtype)
        v = _t(rng, (B, S, KV, D), 1.0, cuda, dtype)
        for G in (1, 2):
            q = _t(rng, (B, S, G * KV, D), 0.3, cuda, dtype)
            for w in (1, 33, 100, S, 0):
                before = tswa.swa_attention.launches
                got = ops.swa_attention_gqa(q, k, v, w)
                torch.cuda.synchronize()
                assert tswa.swa_attention.launches == before + 1
                assert got.dtype == dtype and got.is_contiguous()
                want = tref.swa_attention_gqa_ref(q, k, v, w or S)
                assert _close(got, want, dtype), (S, G, w)
        qf, kf, vf = (_t(rng, (3, S, D), sc, cuda, dtype)
                      for sc in (0.3, 0.3, 1.0))
        for w in (1, 100, 0):
            got = ops.swa_attention(qf, kf, vf, w)
            assert _close(got, tref.swa_attention_ref(qf, kf, vf, w or S),
                          dtype), (S, "folded", w)


@pytest.mark.parametrize("N", [16, 128])
def test_ssd_scan_split_over_chunks(cuda, N, rng):
    """1, 2, 16 and 32 of the kernels' 64-row chunks at Hymba's N = 16
    and Mamba2's N = 128 (P = 64), f32 and bf16, then a padded tail of
    dt = 0 rows whose final state is that of the live rows, one launch a
    call."""
    B, H, P = 2, 3, 64
    Q = tscan.BLOCK_CHUNK
    for dtype in (torch.float32, torch.bfloat16):
        for nc in (1, 2, 16, 32):
            S = nc * Q
            x = _t(rng, (B, S, H, P), 1.0, cuda, dtype)
            dt = torch.nn.functional.softplus(_t(rng, (B, S, H), 1.0, cuda,
                                                 torch.float32))
            A = -torch.exp(_t(rng, (H,), 0.3, cuda, torch.float32))
            Bm, Cm = (_t(rng, (B, S, N), 0.5, cuda, dtype) for _ in range(2))
            before = tscan.ssd_scan.launches
            y, h = ops.ssd_scan(x, dt, A, Bm, Cm, min(128, S))
            torch.cuda.synchronize()
            assert tscan.ssd_scan.launches == before + 1
            y_ref, h_ref = tref.ssd_scan_ref(x, dt, A, Bm, Cm, min(128, S))
            assert _close(y, y_ref, dtype) and _close(h, h_ref, dtype), (
                N, nc, dtype)
        live = S - Q - Q // 2      # a whole padded chunk and half of one
        for t in (x, dt, Bm, Cm):
            t[:, live:] = 0
        _, h = ops.ssd_scan(x, dt, A, Bm, Cm, 128)
        _, h_live = tref.ssd_scan_ref(x[:, :live], dt[:, :live], A,
                                      Bm[:, :live], Cm[:, :live], Q // 2)
        assert _close(h, h_live, dtype), (N, dtype, "padded")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_kernel_matches_plain(cuda, dtype, rng):
    """Hymba's heads, Mamba2's, the reduced config's, P and N that are
    multiples of 4 but not of 8 (padded inside the kernels) in one ragged
    chunk, and trailing dt = 0 rows that leave the state of the live
    rows."""
    for B, S, H, P, N, chunk in ((2, 256, 5, 64, 16, 128),
                                 (1, 512, 3, 64, 128, 256),
                                 (2, 64, 4, 32, 16, 32),
                                 (2, 40, 3, 20, 12, 40)):
        x = _t(rng, (B, S, H, P), 1.0, cuda, dtype)
        dt = torch.nn.functional.softplus(_t(rng, (B, S, H), 1.0, cuda,
                                             torch.float32))
        A = -torch.exp(_t(rng, (H,), 0.3, cuda, torch.float32))
        Bm, Cm = (_t(rng, (B, S, N), 0.5, cuda, dtype) for _ in range(2))
        before = tscan.ssd_scan.launches
        y, h = ops.ssd_scan(x, dt, A, Bm, Cm, chunk)
        torch.cuda.synchronize()
        assert tscan.ssd_scan.launches == before + 1
        y_ref, h_ref = tref.ssd_scan_ref(x, dt, A, Bm, Cm, chunk)
        assert y.dtype == h.dtype == dtype
        assert _close(y, y_ref, dtype) and _close(h, h_ref, dtype), (S, H)
        live = S - S // 4
        for t in (x, dt, Bm, Cm):
            t[:, live:] = 0
        _, h = ops.ssd_scan(x, dt, A, Bm, Cm, chunk)
        _, h_live = tref.ssd_scan_ref(x[:, :live], dt[:, :live], A,
                                      Bm[:, :live], Cm[:, :live], chunk)
        assert _close(h, h_live, dtype), (S, H, "padded")


def test_scoring_kernels_refuse_causal_false_and_strides(cuda):
    q = torch.zeros((2, 128, 64), device=cuda)
    with pytest.raises(ValueError, match="causal only"):
        ops.swa_attention(q, q, q, 8, causal=False)
    with pytest.raises(ValueError):
        ops.swa_attention(torch.zeros((2, 128, 128), device=cuda)[:, :, ::2],
                          q, q, 8)
    with pytest.raises(ValueError):
        ops.swa_attention(q, q.cpu(), q, 8)
    d32 = torch.zeros((2, 128, 32), device=cuda)     # not a kernel head dim
    with pytest.raises(ValueError, match="head dim"):
        ops.swa_attention(d32, d32, d32, 8)
    x = torch.zeros((1, 64, 2, 64), device=cuda)
    dt = torch.zeros((1, 64, 2), device=cuda)
    A = torch.zeros(2, device=cuda)
    bm = torch.zeros((1, 64, 16), device=cuda)
    with pytest.raises(ValueError):
        ops.ssd_scan(x.transpose(1, 2).contiguous().transpose(1, 2), dt, A,
                     bm, bm, 32)
    with pytest.raises(ValueError):
        ops.ssd_scan(x, dt, A.cpu(), bm, bm, 32)


def test_scoring_kernels_refuse_misaligned_and_strided(cuda):
    """Contiguous views 4 bytes off a 16-byte boundary, and strided views,
    are refused by both attention entries and the scan."""
    def off(shape):
        n = 1
        for d in shape:
            n *= d
        return torch.zeros(n + 1, device=cuda)[1:].view(shape)

    q4, k4 = (torch.zeros((1, 128, H, 64), device=cuda) for H in (4, 2))
    for args in ((off(q4.shape), k4, k4), (q4, off(k4.shape), k4),
                 (q4, k4, off(k4.shape))):
        with pytest.raises(ValueError, match="aligned"):
            ops.swa_attention_gqa(*args, 8)
    with pytest.raises(ValueError, match="contiguous"):
        ops.swa_attention_gqa(
            torch.zeros((1, 128, 8, 64), device=cuda)[:, :, ::2], k4, k4, 8)
    q3 = torch.zeros((2, 128, 64), device=cuda)
    with pytest.raises(ValueError, match="aligned"):
        ops.swa_attention(off(q3.shape), q3, q3, 8)
    x = torch.zeros((1, 64, 2, 64), device=cuda)
    dt = torch.zeros((1, 64, 2), device=cuda)
    A = torch.zeros(2, device=cuda)
    bm = torch.zeros((1, 64, 16), device=cuda)
    for args in ((off(x.shape), dt, A, bm, bm), (x, dt, A, off(bm.shape), bm),
                 (x, dt, A, bm, off(bm.shape))):
        with pytest.raises(ValueError, match="aligned"):
            ops.ssd_scan(*args, 32)
    with pytest.raises(ValueError, match="contiguous"):
        ops.ssd_scan(x, dt, A, bm, torch.zeros((1, 64, 32),
                                                device=cuda)[:, :, ::2], 32)


def test_scoring_forward_on_the_card_goes_through_the_kernels(cuda, rng):
    """Reduced Hymba scored on the card: loss_fn and logits_fn through the
    kernels launch each once a layer and match the eager forward."""
    from repro_torch.configs import get_config
    from repro_torch.models import registry
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("hymba-1.5b").reduced()
    params = registry.init_params(torch.Generator().manual_seed(0), cfg,
                                  cuda)
    toks = torch.tensor(rng.integers(0, cfg.vocab_size, (2, 256)),
                        device=cuda)
    batch = {"tokens": toks, "labels": toks.roll(-1, dims=1)}
    out = {}
    for kern in ("cuda", "eager"):
        counts = (tswa.swa_attention.launches, tscan.ssd_scan.launches)
        with torch.no_grad():
            loss, _ = registry.loss_fn(params, cfg, batch, kernel=kern)
            logits = registry.logits_fn(params, cfg, batch, kernel=kern)
        n = 2 * cfg.num_layers if kern == "cuda" else 0
        assert (tswa.swa_attention.launches, tscan.ssd_scan.launches) == (
            counts[0] + n, counts[1] + n)
        out[kern] = (float(loss), logits)
    assert np.isfinite(out["cuda"][0])
    assert abs(out["cuda"][0] - out["eager"][0]) <= 1e-5 * abs(out["eager"][0])
    assert _close(out["cuda"][1], out["eager"][1], torch.float32)

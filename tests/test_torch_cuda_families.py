"""The rest of the LM stack on the card: the sliding-window attention
kernel at the new configs' head dims (120: h2o-danube-3-4b; 128 at G = 5:
llama4-scout; 256 with one kv head: paligemma-3b), the ring and extent
decode kernels at their serving shapes, each against its plain PyTorch
version; and the reduced MoE and VLM configs' scoring forward and
dropless serving, card against CPU. Needs an NVIDIA GPU and nvcc;
elsewhere every test skips with a reason. Imports no JAX:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda_families.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config
from repro_torch.core.serving import ContinuousBatcher
from repro_torch.kernels import decode_attend as da
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import swa_attention as tswa
from repro_torch.models import registry

pytestmark = pytest.mark.cuda

# |kernel - plain| <= tol * (1 + |plain|): the scoring kernel's f32 sums
# in another order (bf16: one rounding of the output); the decode attends'
# as in tests/test_torch_cuda.py
SCORE_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
SERVE_TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, tol):
    return bool(((got.float() - want.float()).abs()
                 <= tol * (1 + want.float().abs())).all())


def _t(rng, shape, scale, device, dtype):
    return torch.tensor(rng.standard_normal(shape) * scale,
                        dtype=torch.float32).to(device, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_swa_attention_at_the_new_head_dims(cuda, dtype, rng):
    """(B, S, H, KV, D): h2o's 32 over 8 heads of 120, llama4's 40 over 8
    of 128, paligemma's 8 over 1 of 256; S below a tile and of several,
    windows inside a tile, across tiles, h2o's 4096 and full."""
    for B, S, H, KV, D in ((1, 384, 32, 8, 120), (2, 40, 4, 4, 120),
                           (1, 256, 40, 8, 128), (2, 256, 8, 1, 256)):
        q = _t(rng, (B, S, H, D), 0.3, cuda, dtype)
        k = _t(rng, (B, S, KV, D), 0.3, cuda, dtype)
        v = _t(rng, (B, S, KV, D), 1.0, cuda, dtype)
        for w in (1, 33, 100, 4096, 0):
            before = tswa.swa_attention.launches
            got = ops.swa_attention_gqa(q, k, v, w)
            torch.cuda.synchronize()
            assert tswa.swa_attention.launches == before + 1
            want = tref.swa_attention_gqa_ref(q, k, v, w or S)
            assert _close(got, want, SCORE_TOL[dtype]), (B, S, H, KV, D, w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attends_at_the_new_shapes(cuda, dtype, rng):
    """The ring kernel at h2o's (KV 8, G 4, D 120, W 4096), rings not yet
    full and wrapped; the extent kernel at llama4's (8, 5, 128), grok-1's
    (8, 6, 128) and paligemma's (1, 8, 256)."""
    B = 4
    q = _t(rng, (B, 8, 4, 120), 0.4, cuda, dtype)
    k = _t(rng, (B, 4096, 8, 120), 0.4, cuda, dtype)
    v = _t(rng, (B, 4096, 8, 120), 1.0, cuda, dtype)
    pos = torch.tensor([5, 4095, 4100, 9000], dtype=torch.int32,
                       device=cuda)
    for window in (4096, 0):
        got = da.ring_decode_attend(q, k, v, pos, window)
        want = tref.ring_decode_attend_ref(q, k, v, pos, window)
        assert _close(got, want, SERVE_TOL[dtype]), window
    for KV, G, D in ((8, 5, 128), (8, 6, 128), (1, 8, 256)):
        q = _t(rng, (B, KV, G, D), 0.4, cuda, dtype)
        k = _t(rng, (B, 2048, KV, D), 0.4, cuda, dtype)
        v = _t(rng, (B, 2048, KV, D), 1.0, cuda, dtype)
        for k_ext in (16, 1024, 2048):
            pos = torch.tensor([0, k_ext - 1, k_ext // 2, k_ext - 1],
                               dtype=torch.int32, device=cuda)
            got = da.extent_decode_attend(q, k, v, pos, 0, k_ext)
            want = tref.extent_decode_attend_ref(q, k, v, pos, 0, k_ext)
            assert _close(got, want, SERVE_TOL[dtype]), (KV, G, D, k_ext)


def _score(params, cfg, batch):
    with torch.no_grad():
        loss, m = registry.loss_fn(params, cfg, batch, kernel="cuda")
        logits = registry.logits_fn(params, cfg, batch, kernel="cuda")
    return loss, m["aux"], logits


@pytest.mark.parametrize("arch", ["llama4-scout-17b-a16e", "grok-1-314b",
                                  "paligemma-3b", "h2o-danube-3-4b"])
def test_reduced_scoring_card_vs_cpu(cuda, arch, rng):
    """The scoring forward through the kernels on the card against its
    plain versions on the CPU (h2o at ``reduced(d_model=480)``: head dim
    120): logits within 1e-4 (1 + |cpu|), loss and aux within 1e-4."""
    d = 480 if arch == "h2o-danube-3-4b" else 256
    cfg = get_config(arch).reduced(d_model=d)
    cpu = registry.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    card = {k: v.to(cuda) for k, v in cpu.items()}
    # 128 positions in all (the kernel takes whole 128-row blocks), a
    # VLM's prefix among them
    toks = rng.integers(0, cfg.vocab_size, (2, 128 - cfg.prefix_len))
    batch = {"tokens": torch.tensor(toks),
             "labels": torch.tensor(np.roll(toks, -1, axis=1))}
    if cfg.prefix_len:
        batch["prefix_embeds"] = torch.tensor(
            rng.standard_normal((2, cfg.prefix_len, cfg.d_model)),
            dtype=torch.float32)
    before = tswa.swa_attention.launches
    got = _score(card, cfg, {k: v.to(cuda) for k, v in batch.items()})
    assert tswa.swa_attention.launches == before + 2 * cfg.num_layers
    want = _score(cpu, cfg, batch)
    for a, b in zip(got[:2], want[:2]):
        assert abs(float(a) - float(b)) <= 1e-4 * max(abs(float(b)), 1e-3)
    assert _close(got[2].cpu(), want[2], 1e-4)


@pytest.mark.parametrize("arch", ["llama4-scout-17b-a16e", "grok-1-314b"])
def test_moe_dropless_serving_card_vs_cpu(cuda, arch, rng):
    """The continuous batcher on a reduced MoE config: bucketed prefill and
    ring decode (the extent kernel on the card, its plain version on the
    CPU), dropless routing: the same tokens."""
    cfg = get_config(arch).reduced()
    cpu = registry.init_params(torch.Generator().manual_seed(1), cfg, "cpu")
    card = {k: v.to(cuda) for k, v in cpu.items()}
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 9, 3, 13, 1)]
    outs = []
    for params in (card, cpu):
        srv = ContinuousBatcher(params, cfg, max_slots=2, max_len=32,
                                min_bucket=4)
        for p in prompts:
            srv.submit(p, max_new=6)
        outs.append({r.rid: r.out for r in srv.run()})
    assert outs[0] == outs[1]

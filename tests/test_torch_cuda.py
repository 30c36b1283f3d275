"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card. Needs an NVIDIA GPU and nvcc; elsewhere every test
skips with a reason. Imports no JAX, so the GPU machine runs it alone:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""
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


def test_distill_kd_loss_goes_through_the_kernel(cuda, rng):
    s, t, lab = _inputs(rng, 4, 400, torch.float32, cuda)
    before = tkd.kd_loss_fused.launches
    got = distill.kd_loss(s, t, lab, 0.5, kd_kernel="cuda")
    assert tkd.kd_loss_fused.launches == before + 1
    want = distill.kd_loss(s, t, lab, 0.5, kd_kernel="eager")
    assert _close(got, want)
    assert np.isfinite(got.item())

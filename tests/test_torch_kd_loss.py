"""Fused KD loss of the port vs the reference's Pallas kernel (interpret
mode, as ``tests/test_kernels.py`` runs it) and its jnp oracle: f32
values, masked rows, and the distillation-level loss and clip.

On the CPU the port's wrapper computes the plain version;
``tests/test_torch_cuda.py`` holds the hand-written kernel against it on
the card. Cases and tolerances mirror ``tests/test_kernels.py``; bf16 is in
``test_torch_kd_loss_bf16.py``, the temperature/alpha extremes, gradients
and input checks in ``test_torch_kd_loss_edges.py``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.core import distill as jdistill
from repro.kernels.kd_loss import kd_loss_pallas
from repro_torch.core import distill as tdistill
from repro_torch.kernels import kd_loss as tkd

from torch_parity import kd_inputs, kd_sweep_case


@pytest.mark.parametrize("R,V", [(8, 512), (37, 1000), (3, 300), (4, 400)])
@pytest.mark.parametrize("dt", ["f32"])
@pytest.mark.parametrize("alpha", [0.0, 0.5, 1.0])
def test_kd_loss_sweep(R, V, dt, alpha, rng):
    kd_sweep_case(R, V, dt, alpha, rng)


def test_kd_loss_masked_rows_exact_noop(rng):
    """Garbage (NaN / Inf / huge) logits in masked rows give exactly 0.0
    and exactly-zero gradients, and leave the live rows untouched."""
    R, V = 8, 256
    s, t, lab = kd_inputs(rng, R, V)
    garbage = np.stack([np.full(V, np.nan), np.full(V, np.inf),
                        np.full(V, 1e30)]).astype(np.float32)
    s_pad, t_pad = np.concatenate([s, garbage]), np.concatenate([t, garbage])
    lab_pad = np.concatenate([lab, np.zeros(3, np.int32)])
    valid = np.concatenate([np.ones(R), np.zeros(3)]).astype(np.float32)
    clean = tkd.kd_loss_fused(torch.tensor(s), torch.tensor(t),
                              torch.tensor(lab), 0.5)
    sp = torch.tensor(s_pad, requires_grad=True)
    tp = torch.tensor(t_pad, requires_grad=True)
    out = tkd.kd_loss_rows(sp, tp, torch.tensor(lab_pad), 0.5,
                           valid=torch.tensor(valid))
    assert torch.equal(out[:R].detach(), clean)
    assert torch.equal(out[R:].detach(), torch.zeros(3))
    want = np.asarray(kd_loss_pallas(jnp.asarray(s_pad), jnp.asarray(t_pad),
                                     jnp.asarray(lab_pad), 0.5,
                                     valid=jnp.asarray(valid),
                                     interpret=True))
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5 * float(np.max(np.abs(want))))
    out.sum().backward()
    assert torch.equal(sp.grad[R:], torch.zeros(3, V))
    assert torch.equal(tp.grad[R:], torch.zeros(3, V))
    assert torch.isfinite(sp.grad[:R]).all() and torch.isfinite(
        tp.grad[:R]).all()


def test_cpu_path_never_counts_a_launch(rng):
    s, t, lab = kd_inputs(rng, 4, 40)
    before = tkd.kd_loss_fused.launches
    tkd.kd_loss_rows(torch.tensor(s), torch.tensor(t), torch.tensor(lab), 0.5)
    assert tkd.kd_loss_fused.launches == before


def test_distill_kd_loss_both_kernels_and_valid_mask(rng):
    """``distill.kd_loss`` (mean over rows, optional row mask) matches the
    reference's, through the kernel's autograd path and the eager one."""
    s = rng.standard_normal((6, 4, 100)).astype(np.float32)
    t = rng.standard_normal((6, 4, 100)).astype(np.float32)
    lab = rng.integers(0, 100, (6, 4)).astype(np.int32)
    valid = (rng.random((6, 4)) > 0.3).astype(np.float32)
    for v in (None, valid):
        want = float(jdistill.kd_loss(
            jnp.asarray(s), jnp.asarray(t), jnp.asarray(lab), 0.5,
            temperature=3.0, kd_kernel="pallas",
            valid=None if v is None else jnp.asarray(v)))
        for kernel in tdistill.KD_KERNELS:
            got = tdistill.kd_loss(
                torch.tensor(s), torch.tensor(t), torch.tensor(lab), 0.5,
                temperature=3.0, kd_kernel=kernel,
                valid=None if v is None else torch.tensor(v))
            np.testing.assert_allclose(got.item(), want, rtol=1e-5)
    with pytest.raises(ValueError, match="kd_kernel"):
        tdistill.kd_loss(torch.zeros(2, 8), torch.zeros(2, 8),
                         torch.zeros(2, dtype=torch.int32), 0.5,
                         kd_kernel="pallas")


def test_clip_by_global_norm_matches(rng):
    g = {"a": rng.standard_normal((3, 4)).astype(np.float32),
         "b": rng.standard_normal(5).astype(np.float32)}
    for max_norm in (0.5, 100.0):
        want = jdistill.clip_by_global_norm(
            {k: jnp.asarray(v) for k, v in g.items()}, max_norm)
        got = tdistill.clip_by_global_norm(
            {k: torch.tensor(v) for k, v in g.items()}, max_norm)
        for k in g:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-6, atol=1e-7)

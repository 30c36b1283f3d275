"""Fused KD loss of the port at its edges: temperature and alpha extremes
against the reference's Pallas kernel (interpret mode), the autograd
Function's gradient against ``jax.grad`` of the reference, and the
kernel wrapper's input checks. Tolerances mirror ``tests/test_kernels.py``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.kernels.kd_loss import kd_loss_pallas
from repro.kernels.kd_loss import kd_loss_rows as jax_kd_loss_rows
from repro_torch.kernels import kd_loss as tkd
from repro_torch.kernels import ref as tref

from torch_parity import kd_both, kd_inputs


# T -> 0+ blows the squared error up by 1/T², T >> 1 squashes it; alpha
# 0 / 1 turn off the CE / KD term
@pytest.mark.parametrize("temperature", [1e-3, 0.5, 1.0, 100.0])
@pytest.mark.parametrize("alpha", [0.0, 1.0])
def test_kd_loss_temperature_alpha_extremes(temperature, alpha, rng):
    s, t, lab = kd_inputs(rng, 16, 384)
    (js, jt, jl), (ts, tt, tl) = kd_both(s, t, lab)
    want = np.asarray(kd_loss_pallas(js, jt, jl, alpha,
                                     temperature=temperature, interpret=True))
    got = tkd.kd_loss_fused(ts, tt, tl, alpha, temperature=temperature)
    scale = max(1.0, float(np.max(np.abs(want))))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * scale)
    if alpha == 1.0:          # pure CE: temperature is a strict no-op
        base = tkd.kd_loss_fused(ts, tt, tl, 1.0, temperature=1.0)
        assert torch.equal(got, base)


@pytest.mark.parametrize("alpha,temperature", [(0.0, 1.0), (1.0, 1.0),
                                               (0.3, 2.0), (0.5, 0.5)])
def test_kd_loss_rows_grad_matches(alpha, temperature, rng):
    """The autograd Function's analytic backward == autograd through the
    plain version == jax.grad of the reference's custom_vjp rows."""
    s, t, lab = kd_inputs(rng, 12, 320)
    w = rng.standard_normal(12).astype(np.float32)     # mixed cotangent

    def f_jax(sp, tp):
        return jnp.sum(jnp.asarray(w) * jax_kd_loss_rows(
            sp, tp, jnp.asarray(lab), alpha, temperature=temperature))

    want = jax.grad(f_jax, argnums=(0, 1))(jnp.asarray(s), jnp.asarray(t))
    scale = max(1.0, float(jnp.max(jnp.abs(want[0]))))
    for rows in (tkd.kd_loss_rows, tref.kd_loss_ref):
        sp = torch.tensor(s, requires_grad=True)
        tp = torch.tensor(t, requires_grad=True)
        (torch.tensor(w) * rows(sp, tp, torch.tensor(lab), alpha,
                                temperature=temperature)).sum().backward()
        for got, ref_grad in zip((sp.grad, tp.grad), want):
            np.testing.assert_allclose(got.numpy(), np.asarray(ref_grad),
                                       rtol=1e-4, atol=1e-5 * scale)


@pytest.mark.parametrize("case", ["rank", "teacher_shape", "dtype",
                                  "labels_dtype", "valid_shape",
                                  "contiguity"])
def test_kernel_wrapper_rejects_bad_inputs(case):
    s = torch.zeros(4, 8)
    t, lab, valid = torch.zeros(4, 8), torch.zeros(4, dtype=torch.int32), \
        torch.ones(4)
    if case == "rank":
        s, t = s[None], t[None]
    elif case == "teacher_shape":
        t = torch.zeros(4, 9)
    elif case == "dtype":
        s, t = s.double(), t.double()
    elif case == "labels_dtype":
        lab = lab.long()
    elif case == "valid_shape":
        valid = torch.ones(5)
    else:
        s = torch.zeros(8, 4).T
    with pytest.raises(ValueError):
        tkd._check(s, t, lab, valid)

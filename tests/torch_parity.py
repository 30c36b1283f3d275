"""Helpers shared by the parity tests of the PyTorch port
(``tests/test_torch_*.py``): JAX-initialised parameters handed to the port
through ``repro_torch.checkpoint.convert``, named-leaf comparisons, and
the KD-loss inputs and sweep case both packages are given."""
from __future__ import annotations

import numpy as np
import torch

import jax
import jax.numpy as jnp

from repro.checkpoint.ckpt import _flatten
from repro.kernels import ref as jref
from repro.kernels.kd_loss import kd_loss_pallas
from repro.models import registry as jax_registry
from repro_torch.checkpoint.convert import params_from_jax, params_to_numpy
from repro_torch.kernels import kd_loss as tkd
from repro_torch.kernels import ref as tref

# The suite runs several pytest workers at once on one host. Each torch
# process would otherwise start one busy-waiting intra-op thread per core,
# and those threads slow every other worker. The port's tests run small
# shapes and need no more than one.
torch.set_num_threads(1)


def jax_flat_params(cfg, key) -> dict:
    """Reference params for ``cfg`` from ``key``, flattened to
    {'/'-joined path: numpy array}."""
    return _flatten(jax.jit(jax_registry.init_params,
                            static_argnums=(1,))(key, cfg))


def jax_params_both(cfg, key):
    """One reference init of ``cfg`` from ``key``: (its pytree, the same
    leaves flattened), so both packages get bit-identical weights."""
    tree = jax.jit(jax_registry.init_params, static_argnums=(1,))(key, cfg)
    return tree, _flatten(tree)


def port_params(flat: dict, cfg, device="cpu") -> dict:
    return params_from_jax(flat, cfg, device=device)


def chain_init(chain, seed: int) -> dict:
    """The initial params ``repro.core.distill.run_chain`` draws: the
    teacher from PRNGKey(seed), then each student from a split — keyed by
    config name."""
    key = jax.random.PRNGKey(seed)
    out = {chain[0].name: jax_flat_params(chain[0], key)}
    for cfg in chain[1:]:
        key, sub = jax.random.split(key)
        out[cfg.name] = jax_flat_params(cfg, sub)
    return out


TDT = {"f32": torch.float32, "bf16": torch.bfloat16}
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}


def kd_inputs(rng, R, V, dt="f32"):
    """The same KD-loss logits for both packages: f32 numpy rounded
    through the working dtype, so bf16 inputs hold equal values on each
    side."""
    s = np.asarray(jnp.asarray(rng.standard_normal((R, V)), JDT[dt])
                   .astype(jnp.float32))
    t = np.asarray(jnp.asarray(rng.standard_normal((R, V)), JDT[dt])
                   .astype(jnp.float32))
    lab = rng.integers(0, V, R).astype(np.int32)
    return s, t, lab


def kd_both(s, t, lab, dt="f32"):
    j = (jnp.asarray(s, JDT[dt]), jnp.asarray(t, JDT[dt]), jnp.asarray(lab))
    p = (torch.tensor(s).to(TDT[dt]), torch.tensor(t).to(TDT[dt]),
         torch.tensor(lab))
    return j, p


def kd_sweep_case(R, V, dt, alpha, rng):
    """The port's plain version and wrapper vs the reference's Pallas
    kernel (interpret mode) and its jnp oracle, at the tolerance
    ``tests/test_kernels.py`` uses for ``dt``."""
    s, t, lab = kd_inputs(rng, R, V, dt)
    (js, jt, jl), (ts, tt, tl) = kd_both(s, t, lab, dt)
    want_pallas = np.asarray(kd_loss_pallas(js, jt, jl, alpha,
                                            interpret=True))
    want_ref = np.asarray(jref.kd_loss_ref(js, jt, jl, alpha))
    tol = 1e-5 if dt == "f32" else 2e-2
    for got in (tref.kd_loss_ref(ts, tt, tl, alpha),
                tkd.kd_loss_fused(ts, tt, tl, alpha)):
        for want in (want_pallas, want_ref):
            np.testing.assert_allclose(
                got.numpy(), want, rtol=tol,
                atol=tol * max(1.0, float(np.max(np.abs(want)))))


def assert_params_close(jax_params, torch_params, rtol, atol):
    """Every leaf of the reference pytree vs the port's flat dict."""
    want = _flatten(jax_params)
    got = params_to_numpy(torch_params)
    assert set(want) == set(got)
    for k in want:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=rtol,
                                   atol=atol, err_msg=k)

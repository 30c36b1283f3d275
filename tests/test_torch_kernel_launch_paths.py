"""The launch paths of the SSD decode step and the fused KD loss, against
the JAX package on seeded numpy inputs (Pallas in interpret mode):

- the SSD step on x, B and C cut as strided views from one (B, conv_dim)
  tensor, as ``ssm_decode_step`` cuts them, with and without the new state
  written over the old (``state_out=state``); a dt = 0 row stays bit
  for bit; the wrapper's stride checks;
- ``ssm_decode_step(kernel="cuda")`` updating the cache's own state, and
  the continuous batcher's tokens through that path;
- the KD loss's gradients (the backward kernel's plain version), the
  teacher without a gradient, masked rows holding NaN and a masked mean's
  broadcast cotangent among them.

On the CPU every wrapper computes its kernel's plain version, so these
tests hold the port's control flow (views, aliasing, optional outputs)
and its arithmetic; the kernels themselves are held against the same
plain versions on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Tolerances: f32 SSD step 1e-5 (rtol and atol; op-for-op the same
roundings, the readout's sum order differs); bf16 state 1e-2 (one bf16
rounding of the state); KD gradients rtol 1e-5, atol 1e-6 (softmax
computed two ways in f32); the reduced model's kernel-path step against
its eager step 1e-6 on the state, 1e-5 on the output (the eager step's
three-operand einsum takes dt·x·B in another order); the batcher's tokens
exactly.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

import repro.configs as jcfg
from repro.core.serving import ContinuousBatcher as JBatcher
from repro.kernels.kd_loss import kd_loss_rows as jax_kd_loss_rows
from repro.kernels.ssd_scan import ssd_decode_step_pallas
from repro_torch import configs as tcfg
from repro_torch.checkpoint.convert import params_from_jax
from repro_torch.core import distill
from repro_torch.core.serving import ContinuousBatcher as TBatcher
from repro_torch.kernels import kd_loss as tkd
from repro_torch.kernels import ops, ssd_decode
from repro_torch.models import registry, ssm
from repro_torch.models.lm import layer_params

from torch_parity import jax_params_both

SSD_TOL = {"f32": 1e-5, "bf16": 1e-2}
KD_RTOL, KD_ATOL = 1e-5, 1e-6


def _path_views(rng, B, H, P, N, x_dtype=torch.float32):
    """xh (B, H, P), Bm and Cm (B, N) as views of one (B, H*P + 2N)
    tensor, the layout of ``ssm_decode_step``'s conv output; dt (B, H)
    with a dt = 0 row; A (H,); a state (B, H, P, N) in f32."""
    di = H * P
    xbc = torch.tensor(rng.standard_normal((B, di + 2 * N)) * 0.5,
                       dtype=torch.float32).to(x_dtype)
    xh = xbc[:, :di].reshape(B, H, P)
    Bm, Cm = xbc[:, di:di + N], xbc[:, di + N:]
    dt = torch.nn.functional.softplus(torch.tensor(
        rng.standard_normal((B, H)), dtype=torch.float32))
    dt[1] = 0.0                       # a pad row: its state must not move
    A = -torch.exp(torch.tensor(rng.standard_normal(H) * 0.3,
                                dtype=torch.float32))
    state = torch.tensor(rng.standard_normal((B, H, P, N)),
                         dtype=torch.float32)
    return xh, dt, A, Bm, Cm, state


def _jax(t):
    """A torch tensor as a JAX array of the same dtype (bf16 exactly) on
    memory of its own: on the CPU ``jnp.asarray`` of a numpy array may
    share the array's buffer, and the port writes the state in place."""
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy(), jnp.bfloat16)
    return jnp.array(t.contiguous().numpy(), copy=True)


@pytest.mark.parametrize("in_place", [False, True])
@pytest.mark.parametrize("mix", ["f32", "bf16"])
def test_ssd_decode_step_on_path_views_matches_pallas(mix, in_place, rng):
    """The wrapper on the strided views, the state kept or overwritten,
    against the reference kernel on the same values; f32 throughout, or
    the serving cache's mix (f32 x, bf16 state)."""
    B, H, P, N = 3, 4, 8, 16
    xh, dt, A, Bm, Cm, state = _path_views(rng, B, H, P, N)
    assert not xh.is_contiguous() and not Bm.is_contiguous()
    if mix == "bf16":
        state = state.bfloat16()
    y_want, st_want = jax.block_until_ready(ssd_decode_step_pallas(
        *[_jax(a) for a in (xh, dt, A, Bm, Cm, state)], interpret=True))
    before = state.clone()
    out = state if in_place else None
    y, st = ssd_decode.ssd_decode_step(xh, dt, A, Bm, Cm, state,
                                       state_out=out)
    assert (st is state) == in_place
    if not in_place:
        assert torch.equal(state, before)
    assert st.dtype == state.dtype and y.dtype == torch.float32
    tol = SSD_TOL[mix]
    np.testing.assert_allclose(y.numpy(), np.asarray(y_want), rtol=tol,
                               atol=tol)
    np.testing.assert_allclose(st.float().numpy(),
                               np.asarray(st_want.astype(jnp.float32)),
                               rtol=tol, atol=tol)
    assert torch.equal(st[1], before[1])          # the dt = 0 row


def test_ssd_decode_step_in_place_keeps_dt0_rows_bit_identical(rng):
    """Ten steps written over one state, every row's dt = 0 on even steps:
    those steps leave the state exactly as it was, bf16 and f32."""
    for dtype in (torch.float32, torch.bfloat16):
        xh, dt, A, Bm, Cm, state = _path_views(rng, 4, 3, 8, 16)
        state = state.to(dtype)
        ptr = state.data_ptr()
        for step in range(10):
            d = torch.zeros_like(dt) if step % 2 == 0 else dt
            before = state.clone()
            _, st = ssd_decode.ssd_decode_step(xh, d, A, Bm, Cm, state,
                                               state_out=state)
            assert st.data_ptr() == ptr
            if step % 2 == 0:
                assert torch.equal(state, before)
            else:
                assert not torch.equal(state, before)


@pytest.mark.parametrize("case", ["head_stride", "p_stride", "b_stride",
                                  "state_out_dtype", "state_out_shape"])
def test_ssd_decode_wrapper_rejects_bad_strides_and_outputs(case, rng):
    xh, dt, A, Bm, Cm, state = _path_views(rng, 2, 4, 8, 16)
    out = None
    if case == "head_stride":        # every other head of a wider tensor
        xh = torch.zeros(2, 8, 8)[:, ::2]
    elif case == "p_stride":
        xh = torch.zeros(2, 4, 16)[:, :, ::2]
    elif case == "b_stride":
        Bm = torch.zeros(2, 32)[:, ::2]
    elif case == "state_out_dtype":
        out = state.bfloat16()
    else:
        out = state[:, :2]
    with pytest.raises(ValueError):
        ssd_decode.ssd_decode_step(xh, dt, A, Bm, Cm, state, state_out=out)


def _hymba_layer(seed=0):
    cfg = tcfg.get_config("hymba-1.5b").reduced()
    params = registry.init_params(torch.Generator().manual_seed(seed), cfg,
                                  "cpu")
    return cfg, layer_params(params, 0)["ssm"]


def test_ssm_decode_step_cuda_path_updates_the_cache_in_place(rng,
                                                              monkeypatch):
    """Reduced Hymba's SSM layer: the kernel path reads the conv output's
    views as they are and returns the cache's own state tensor, holding the
    eager step's values, with the eager step's output."""
    cfg, p = _hymba_layer()
    B = 3
    di, nh, conv_dim = ssm.dims(cfg.d_model, cfg.ssm)
    x = torch.tensor(rng.standard_normal((B, 1, cfg.d_model)),
                     dtype=torch.float32)
    state = torch.tensor(rng.standard_normal(
        (B, nh, cfg.ssm.head_dim, cfg.ssm.d_state)), dtype=torch.float32)
    conv_state = torch.tensor(rng.standard_normal(
        (B, cfg.ssm.d_conv - 1, conv_dim)), dtype=torch.float32)
    cache = state.clone()
    out_e, (st_e, cs_e) = ssm.ssm_decode_step(p, x, cfg.ssm, state,
                                              conv_state, kernel="eager")
    seen = []
    real = ops.ssd_decode_step

    def spy(xh, dt, A, Bm, Cm, st, state_out=None):
        seen.append((xh.is_contiguous(), state_out is st))
        return real(xh, dt, A, Bm, Cm, st, state_out=state_out)

    monkeypatch.setattr(ops, "ssd_decode_step", spy)
    out_k, (st_k, cs_k) = ssm.ssm_decode_step(p, x, cfg.ssm, cache,
                                              conv_state, kernel="cuda")
    assert seen == [(False, True)]      # the views as they are, in place
    assert st_k.data_ptr() == cache.data_ptr()
    assert not torch.equal(cache, state)
    np.testing.assert_allclose(st_k.numpy(), st_e.numpy(), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(out_k.numpy(), out_e.numpy(), rtol=1e-5,
                               atol=1e-5)
    assert torch.equal(cs_k, cs_e)


def test_cuda_decode_batcher_tokens_match_jax_batcher(rng):
    """Reduced Hymba through the continuous batcher, ring decode on the
    kernels' wrappers (the SSD state updated in place), against the
    reference's batcher on the same JAX-initialised params: the same
    greedy tokens."""
    jc = jcfg.get_config("hymba-1.5b").reduced()
    tc = tcfg.get_config("hymba-1.5b").reduced()
    jp, flat = jax_params_both(jc, jax.random.PRNGKey(3))
    tp = params_from_jax(flat, tc)
    prompts = [rng.integers(0, jc.vocab_size, n).astype(np.int32)
               for n in (4, 11, 2, 17)]
    kw = dict(max_slots=2, max_len=48, min_bucket=4, decode_mode="ring")
    outs = []
    for batcher in (JBatcher(jp, jc, **kw),
                    TBatcher(tp, tc, decode_kernel="cuda", **kw)):
        for prompt in prompts:
            batcher.submit(prompt, max_new=10)
        outs.append({r.rid: r.out for r in batcher.run()})
    assert outs[0] == outs[1]


def _kd_inputs(rng, R, V):
    s = rng.standard_normal((R, V)).astype(np.float32)
    t = rng.standard_normal((R, V)).astype(np.float32)
    lab = rng.integers(0, V, R).astype(np.int32)
    w = rng.standard_normal(R).astype(np.float32)       # row cotangent
    return s, t, lab, w


@pytest.mark.parametrize("case", ["both", "teacher_no_grad", "masked_nan",
                                  "masked_mean"])
def test_kd_loss_rows_grads_match_jax_vjp(case, rng):
    """``kd_loss_rows``'s gradients (the backward's plain version) against
    ``jax.vjp`` of the reference rows (Pallas forward, interpret mode). A
    teacher that needs no gradient gets none; masked rows holding NaN and
    Inf give exactly zero loss and gradients. ``masked_mean`` goes through
    ``distill.kd_loss``'s masked mean, whose sum hands the backward a
    cotangent broadcast with stride 0."""
    R, V = 7, 300
    s, t, lab, w = _kd_inputs(rng, R, V)
    valid = None
    if case in ("masked_nan", "masked_mean"):
        s[4], t[4], s[6], t[5] = np.nan, np.inf, -np.inf, np.nan
        valid = np.array([1, 1, 0, 1, 0, 0, 0], np.float32)
        valid[3] = 2.0                  # any positive mask is live
    alpha, temperature = 0.3, 2.0

    def f(sj, tj):
        return jax_kd_loss_rows(sj, tj, jnp.asarray(lab), alpha,
                                temperature=temperature,
                                valid=None if valid is None
                                else jnp.asarray(valid))

    if case == "masked_mean":
        w = np.full(R, 1.0 / valid.sum(), np.float32)
    out_j, vjp = jax.vjp(f, jnp.asarray(s), jnp.asarray(t))
    ds_j, dt_j = vjp(jnp.asarray(w))
    sp = torch.tensor(s, requires_grad=True)
    tp = torch.tensor(t, requires_grad=case != "teacher_no_grad")
    if case == "masked_mean":
        loss = distill.kd_loss(sp, tp, torch.tensor(lab), alpha,
                               temperature=temperature, kd_kernel="cuda",
                               valid=torch.tensor(valid))
        loss.backward()
        np.testing.assert_allclose(loss.item(), float(np.sum(
            np.asarray(out_j) * w)), rtol=KD_RTOL, atol=KD_ATOL)
        np.testing.assert_allclose(sp.grad.numpy(), np.asarray(ds_j),
                                   rtol=KD_RTOL, atol=KD_ATOL)
        np.testing.assert_allclose(tp.grad.numpy(), np.asarray(dt_j),
                                   rtol=KD_RTOL, atol=KD_ATOL)
        return
    out = tkd.kd_loss_rows(sp, tp, torch.tensor(lab), alpha,
                           temperature=temperature,
                           valid=None if valid is None
                           else torch.tensor(valid))
    (torch.tensor(w) * out).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j),
                               rtol=KD_RTOL, atol=KD_ATOL)
    np.testing.assert_allclose(sp.grad.numpy(), np.asarray(ds_j),
                               rtol=KD_RTOL, atol=KD_ATOL)
    if case == "teacher_no_grad":
        assert tp.grad is None
    else:
        np.testing.assert_allclose(tp.grad.numpy(), np.asarray(dt_j),
                                   rtol=KD_RTOL, atol=KD_ATOL)
    if case == "masked_nan":
        dead = valid <= 0
        assert np.all(out.detach().numpy()[dead] == 0.0)
        assert np.all(sp.grad.numpy()[dead] == 0.0)
        assert np.all(tp.grad.numpy()[dead] == 0.0)


def test_kd_backward_wrapper_skips_dt_when_not_needed(rng):
    """``kd_loss_fused_bwd(need_dt=False)`` returns no teacher gradient and
    the same student gradient; nothing is launched on the CPU."""
    s, t, lab, w = _kd_inputs(rng, 5, 64)
    args = (torch.tensor(s), torch.tensor(t), torch.tensor(lab), None,
            torch.tensor(w), None, 0.5, 1.5)
    before = tkd.kd_loss_fused_bwd.launches
    ds, dt = tkd.kd_loss_fused_bwd(*args)
    ds_only, none = tkd.kd_loss_fused_bwd(*args, need_dt=False)
    assert none is None and dt is not None
    assert torch.equal(ds, ds_only)
    assert tkd.kd_loss_fused_bwd.launches == before

"""Port optimizers vs the reference: SGD with momentum and decay, the
proximal term and the trainable mask, over three steps (atol 1e-6);
AdamW and scheduled / Nesterov SGD over five steps (rtol 1e-6); the
schedules within one f32 ulp over steps 0..200; a scheduled lr's step a
tensor on the params' device (the engines under a schedule:
``tests/test_torch_schedules.py``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.checkpoint.ckpt import _flatten
from repro.configs import get_config
from repro.models import registry as jreg
from repro.optim import (adamw as jadamw, apply_mask as japply,
                         proximal_grad as jprox, sgd as jsgd,
                         trainable_mask as jmask)
from repro.optim import schedules as jsched
from repro_torch.optim import (adamw, apply_mask, proximal_grad, sgd,
                               trainable_mask)
from repro_torch.optim import schedules as tsched

SHAPES = {"stem/w": (4, 3), "stages/0/0/w1": (5,), "fc/w": (3, 2),
          "fc/b": (2,)}


def _tree(rng):
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in SHAPES.items()}


@pytest.mark.parametrize("momentum,wd", [(0.9, 1e-3), (0.0, 0.0),
                                         (0.9, 0.0), (0.0, 1e-3)])
def test_sgd_prox_mask_three_steps_match(momentum, wd, rng):
    p0 = _tree(rng)
    anchor = _tree(rng)
    grads = [_tree(rng) for _ in range(3)]
    theta = 0.01
    jo = jsgd(0.05, momentum, wd)
    to = sgd(0.05, momentum, wd)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: torch.tensor(v) for k, v in p0.items()}
    ja = {k: jnp.asarray(v) for k, v in anchor.items()}
    ta = {k: torch.tensor(v) for k, v in anchor.items()}
    # the reference masks by the top-level key of its nested tree; the
    # flat dicts here take the port's mask (pinned against the reference
    # on real resnet params below)
    tm = trainable_mask(tp, "last_layer")
    jm = dict(tm)
    assert tm == {"stem/w": 0.0, "stages/0/0/w1": 0.0, "fc/w": 1.0,
                  "fc/b": 1.0}
    js, ts = jo.init(jp), to.init(tp)
    for g in grads:
        jg = japply(jprox({k: jnp.asarray(v) for k, v in g.items()}, jp, ja,
                          theta), jm)
        tg = apply_mask(proximal_grad({k: torch.tensor(v)
                                       for k, v in g.items()}, tp, ta, theta),
                        tm)
        for k in SHAPES:
            np.testing.assert_allclose(tg[k].numpy(), np.asarray(jg[k]),
                                       rtol=0, atol=1e-6)
        jp, js = jo.update(jg, js, jp)
        tp, ts = to.update(tg, ts, tp)
    for k in SHAPES:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=0, atol=1e-6, err_msg=k)
    assert ts["step"] == int(js["step"]) == 3


@pytest.mark.parametrize("mode", ["all", "last_layer"])
def test_trainable_mask_on_resnet_params(mode):
    cfg = get_config("resnet3d-18").reduced()
    jp = jax.eval_shape(lambda k: jreg.init_params(k, cfg),
                        jax.random.PRNGKey(0))
    want = {k: float(v) for k, v in _flatten(jmask(jp, mode)).items()}
    got = trainable_mask({k: None for k in _flatten(jp)}, mode)
    assert got == want
    if mode == "last_layer":
        assert {k for k, v in got.items() if v} == {"fc/w", "fc/b"}


def test_trainable_mask_rejects_unknown_mode():
    with pytest.raises(ValueError):
        trainable_mask({"fc/w": None}, "half")


def test_proximal_zero_theta_is_identity(rng):
    g = {k: torch.tensor(v) for k, v in _tree(rng).items()}
    assert proximal_grad(g, g, g, 0.0) is g


_SCHED = {"constant": (jsched.constant(0.05), tsched.constant(0.05)),
          "cosine": (jsched.cosine(0.05, 150, warmup=20),
                     tsched.cosine(0.05, 150, warmup=20)),
          "inverse_sqrt": (jsched.inverse_sqrt(0.05, warmup=30),
                           tsched.inverse_sqrt(0.05, warmup=30))}


@pytest.mark.parametrize("name", sorted(_SCHED))
def test_schedules_within_one_ulp(name):
    jf, tf = _SCHED[name]
    steps = np.arange(201, dtype=np.int32)
    want = np.array([np.float32(jf(jnp.int32(i))) for i in steps])
    got = tf(torch.tensor(steps)).numpy()
    assert got.dtype == np.float32
    got = np.broadcast_to(got, want.shape)    # constant ignores the step
    ulp = np.spacing(np.abs(want).astype(np.float32))
    assert np.all(np.abs(got - want) <= ulp), np.max(np.abs(got - want) / ulp)


def _run_both(jo, to, rng, steps=5):
    p0 = _tree(rng)
    grads = [_tree(rng) for _ in range(steps)]
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: torch.tensor(v) for k, v in p0.items()}
    js, ts = jo.init(jp), to.init(tp)
    for g in grads:
        jp, js = jo.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        tp, ts = to.update({k: torch.tensor(v) for k, v in g.items()}, ts,
                           tp)
    for k in SHAPES:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=0, err_msg=k)
    return js, ts


@pytest.mark.parametrize("lr,wd", [("float", 0.0), ("float", 0.01),
                                   ("cosine", 0.01)])
def test_adamw_five_steps_match(lr, wd, rng):
    jl, tl = (0.01, 0.01) if lr == "float" else (
        jsched.cosine(0.01, 8, warmup=2), tsched.cosine(0.01, 8, warmup=2))
    js, ts = _run_both(jadamw(jl, weight_decay=wd),
                       adamw(tl, weight_decay=wd), rng)
    assert int(ts["step"]) == int(js["step"]) == 5
    for k in SHAPES:
        np.testing.assert_allclose(ts["v"][k].numpy(), np.asarray(js["v"][k]),
                                   rtol=1e-6, atol=0)


@pytest.mark.parametrize("nesterov,sched", [(True, "cosine"),
                                            (False, "inverse_sqrt")])
def test_scheduled_sgd_five_steps_match(nesterov, sched, rng):
    jf, tf = _SCHED[sched]
    js, ts = _run_both(jsgd(jf, 0.9, 1e-3, nesterov=nesterov),
                       sgd(tf, 0.9, 1e-3, nesterov=nesterov), rng)
    assert int(ts["step"]) == int(js["step"]) == 5


def test_step_is_a_device_tensor_only_for_a_schedule():
    params = {"w": torch.zeros(3)}
    assert sgd(0.1, 0.9).init(params)["step"] == 0          # host int
    for opt in (sgd(tsched.cosine(0.1, 10), 0.9), adamw(0.1)):
        st = opt.init(params)["step"]
        assert isinstance(st, torch.Tensor) and st.dim() == 0
        assert st.dtype == torch.int32 and st.device == params["w"].device
    # a constant rate keeps the old path's arithmetic, bit for bit
    g = {"w": torch.tensor([0.3, -1.0, 2.0])}
    a, _ = sgd(0.1, 0.9).update(g, sgd(0.1, 0.9).init(params), params)
    b, _ = sgd(tsched.constant(0.1), 0.9).update(
        g, sgd(tsched.constant(0.1), 0.9).init(params), params)
    assert torch.equal(a["w"], b["w"])

"""Port optimizers vs the reference: SGD with momentum and decay, the
proximal term and the trainable mask, over three steps (atol 1e-6)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.checkpoint.ckpt import _flatten
from repro.configs import get_config
from repro.models import registry as jreg
from repro.optim import (apply_mask as japply, proximal_grad as jprox,
                         sgd as jsgd, trainable_mask as jmask)
from repro_torch.optim import (apply_mask, proximal_grad, sgd,
                               trainable_mask)

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

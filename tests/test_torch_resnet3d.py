"""Port ResNet3D vs the reference on JAX-initialised, converted params:
logits, loss gradients, SAME padding, the strided identity shortcut,
parameter and MAC counts, and the checkpoint bridge."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.checkpoint import save_params
from repro.checkpoint.ckpt import _flatten
from repro.configs import get_config as jget
from repro.models import registry as jreg
from repro.models import resnet3d as jres
from repro_torch.checkpoint import convert
from repro_torch.configs import get_config as tget
from repro_torch.models import registry as treg
from repro_torch.models import resnet3d as tres

from torch_parity import port_params

ARCHS = ["resnet3d-18", "resnet3d-34"]


@pytest.mark.parametrize("name", ["resnet3d-18", "resnet3d-26",
                                  "resnet3d-34"])
@pytest.mark.parametrize("reduced", [False, True])
def test_param_count_and_macs_equal(name, reduced):
    jc, tc = jget(name), tget(name)
    if reduced:
        jc, tc = jc.reduced(), tc.reduced()
    assert tres.param_count(tc) == jres.param_count(jc)
    assert tc.param_count() == jc.param_count()
    assert tres.macs_per_clip(tc) == jres.macs_per_clip(jc)
    shapes = jax.eval_shape(lambda k: jreg.init_params(k, jc),
                            jax.random.PRNGKey(0))
    assert sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(
        shapes)) - sum(int(np.prod(s)) for k, s in
                       tres.param_shapes(tc).items()) == 0


def _clips(rng, batch=2, shape=(4, 16, 16)):
    return rng.standard_normal((batch, *shape, 3)).astype(np.float32)


@pytest.mark.parametrize("name", ARCHS)
def test_logits_and_loss_grads_match(name, rng):
    """f32 convolutions sum in another order in each framework, and the
    difference grows over depth 34: logits to atol 1e-4, gradients to
    rtol 1e-3 / atol 1e-5."""
    jc, tc = jget(name).reduced(), tget(name).reduced()
    jp = jax.jit(jreg.init_params, static_argnums=(1,))(
        jax.random.PRNGKey(1), jc)
    tp = port_params(_flatten(jp), tc)
    clips = _clips(rng)
    labels = rng.integers(0, jc.num_classes, 2).astype(np.int32)
    jbatch = {"clips": jnp.asarray(clips), "labels": jnp.asarray(labels)}
    tbatch = {"clips": torch.tensor(clips), "labels": torch.tensor(labels)}

    want = np.asarray(jax.jit(lambda p, b: jreg.logits_fn(p, jc, b))(
        jp, jbatch))
    with torch.no_grad():
        got = treg.logits_fn(tp, tc, tbatch).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)

    jl, jg = jax.jit(jax.value_and_grad(
        lambda p, b: jreg.loss_fn(p, jc, b)[0]))(jp, jbatch)
    tq = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    tl = treg.loss_fn(tq, tc, tbatch)[0]
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    tgrad = convert.params_to_numpy({k: v.grad for k, v in tq.items()})
    for k, v in _flatten(jg).items():
        np.testing.assert_allclose(tgrad[k], v, rtol=1e-3, atol=1e-5,
                                   err_msg=k)


# XLA "SAME": stride 2 puts an odd pad on the high side — the stem's 7x7
# on 16 px pads 2/3, a 3-wide kernel on T=4 at stride 2 pads 0/1, and T=1
# at stride 2 pads 1/1
@pytest.mark.parametrize("dhw,k,stride", [
    ((4, 16, 16), (3, 7, 7), 2),
    ((1, 8, 8), (3, 3, 3), 2),
    ((2, 4, 4), (3, 3, 3), 2),
    ((5, 9, 9), (3, 3, 3), 2),
    ((4, 8, 8), (1, 1, 1), 2),
    ((3, 7, 7), (3, 3, 3), 1),
])
def test_conv3d_same_padding_matches_xla(dhw, k, stride, rng):
    x = rng.standard_normal((2, *dhw, 3)).astype(np.float32)
    w = rng.standard_normal((*k, 3, 5)).astype(np.float32)
    want = np.asarray(jres._conv3d(jnp.asarray(x), jnp.asarray(w), stride))
    got = tres._conv3d(torch.tensor(x).permute(0, 4, 1, 2, 3),
                       torch.tensor(w).permute(4, 3, 0, 1, 2), stride)
    got = got.permute(0, 2, 3, 4, 1).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    for n, kk in zip(dhw, k):
        lo, hi = tres.same_pad(n, kk, stride)
        assert hi - lo in (0, 1)


def test_strided_identity_shortcut_matches(monkeypatch, rng):
    """Constant stage widths remove every projection, so each stage's
    first block takes the strided identity ``x[::2, ::2, ::2]`` shortcut
    (no shipped config reaches it)."""
    monkeypatch.setattr(jres, "STAGE_WIDTHS", (1, 1, 1, 1))
    monkeypatch.setattr(tres, "STAGE_WIDTHS", (1, 1, 1, 1))
    jc, tc = jget("resnet3d-18").reduced(), tget("resnet3d-18").reduced()
    # fresh lambdas: traced after the patch, never from a cached trace
    jp = jax.jit(lambda k: jreg.init_params(k, jc))(jax.random.PRNGKey(2))
    flat = _flatten(jp)
    assert not any(k.endswith("proj") for k in flat)
    tp = port_params(flat, tc)
    clips = _clips(rng, shape=(4, 16, 16))
    want = np.asarray(jax.jit(lambda p, x: jres.forward(p, jc, x))(
        jp, jnp.asarray(clips)))
    with torch.no_grad():
        got = tres.forward(tp, tc, torch.tensor(clips)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_convert_roundtrip_and_reads_reference_checkpoint(tmp_path):
    jc, tc = jget("resnet3d-18").reduced(), tget("resnet3d-18").reduced()
    jp = jax.jit(jreg.init_params, static_argnums=(1,))(
        jax.random.PRNGKey(3), jc)
    flat = _flatten(jp)
    tp = port_params(flat, tc)
    assert {k: tuple(v.shape) for k, v in tp.items()} == \
        tres.param_shapes(tc)
    back = convert.params_to_numpy(tp)
    assert all(back[k].tobytes() == np.asarray(v).tobytes()
               for k, v in flat.items())
    path = str(tmp_path / "student")
    save_params(jp, path)
    loaded = convert.load_jax_checkpoint(path, tc)
    assert all(torch.equal(loaded[k], tp[k]) for k in tp)


def test_convert_rejects_wrong_keys_and_shapes():
    tc = tget("resnet3d-18").reduced()
    flat = convert.params_to_numpy(
        treg.init_params(torch.Generator().manual_seed(0), tc, "cpu"))
    bad = dict(flat)
    del bad["fc/b"]
    with pytest.raises(ValueError, match="keys differ"):
        convert.params_from_jax(bad, tc)
    bad = dict(flat, **{"fc/w": flat["fc/w"].T})
    with pytest.raises(ValueError, match="fc/w"):
        convert.params_from_jax(bad, tc)


def test_port_init_is_seeded_and_device_independent_in_values():
    tc = tget("resnet3d-34").reduced()
    a = treg.init_params(torch.Generator().manual_seed(5), tc, "cpu")
    b = treg.init_params(torch.Generator().manual_seed(5), tc, "cpu")
    assert a.keys() == tres.param_shapes(tc).keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert torch.equal(a["stem/gn"], torch.ones(tc.d_model))
    assert torch.equal(a["fc/b"], torch.zeros(tc.num_classes))

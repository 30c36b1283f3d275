"""The port's LM scoring forward against the reference on JAX-initialised
params: ``forward_hidden`` / ``loss_fn`` / ``logits_fn`` through the
registry, eager and through the scoring kernels' wrappers (their plain
versions on the CPU), on hymba-1.5b, gemma3-12b (also with grouped kv
heads) and mamba2-130m reduced at S = 128 with the reduced window 64, so
the band and the global layers both count; ``chunked_lm_loss``; one
gradient of ``loss_fn`` against ``jax.grad`` (rtol 1e-3: sums over the
batch in another order). Logits to 1e-4, losses to 1e-5 relative."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

import repro.configs as jcfg
from repro.checkpoint.ckpt import _flatten
from repro.models import common as jcommon
from repro.models import lm as jlm
from repro.models import registry as jreg
from repro_torch import configs as tcfg
from repro_torch.checkpoint.convert import params_from_jax
from repro_torch.kernels import ssd_scan as tscan
from repro_torch.kernels import swa_attention as tswa
from repro_torch.models import common as tcommon
from repro_torch.models import lm as tlm
from repro_torch.models import registry as treg
from repro_torch.types import MoEConfig

from torch_parity import jax_params_both

ARCHS = ["hymba-1.5b", "gemma3-12b", "gemma3-12b-kv2", "mamba2-130m"]


def _configs(arch):
    name = arch.removesuffix("-kv2")
    jc, tc = jcfg.get_config(name).reduced(), tcfg.get_config(name).reduced()
    if arch.endswith("-kv2"):        # G = 2 query heads a kv head
        jc = dataclasses.replace(jc, num_kv_heads=2)
        tc = dataclasses.replace(tc, num_kv_heads=2)
    return jc, tc


def _setup(arch, seed=0):
    jc, tc = _configs(arch)
    jp, flat = jax_params_both(jc, jax.random.PRNGKey(seed))
    return jc, tc, jp, params_from_jax(flat, tc)


def _batch(rng, cfg, B=2, S=128):
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = np.concatenate([toks[:, 1:], np.full((B, 1), -100)], axis=1)
    labels[0, 5:9] = -100                      # ignored positions inside
    return toks, labels.astype(np.int32)


def _rel(a, b):
    return abs(float(a) - float(b)) / abs(float(b))


@pytest.mark.parametrize("kernel", ["eager", "cuda"])
@pytest.mark.parametrize("arch", ARCHS)
def test_scoring_forward_matches_reference(arch, kernel, rng):
    jc, tc, jp, tp = _setup(arch)
    toks, labels = _batch(rng, jc)
    tb = {"tokens": torch.tensor(toks), "labels": torch.tensor(labels)}
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    counts = (tswa.swa_attention.launches, tscan.ssd_scan.launches)
    hidden, aux = tlm.forward_hidden(tp, tc, tb["tokens"], kernel=kernel)
    jhidden, jaux = jlm.forward_hidden(jp, jc, jb["tokens"])
    np.testing.assert_allclose(hidden.numpy(), np.asarray(jhidden), rtol=1e-4,
                               atol=1e-4)
    assert float(aux) == float(jaux) == 0.0
    logits = treg.logits_fn(tp, tc, tb, kernel=kernel)
    np.testing.assert_allclose(logits.numpy(),
                               np.asarray(jreg.logits_fn(jp, jc, jb)),
                               rtol=1e-4, atol=1e-4)
    # a loss chunk that leaves a padded tail (128 = 2 x 48 + 32)
    loss, m = treg.loss_fn(tp, tc, tb, loss_chunk=48, kernel=kernel)
    jloss, jm = jreg.loss_fn(jp, jc, jb, loss_chunk=48)
    assert _rel(loss, jloss) < 1e-5 and _rel(m["ce"], jm["ce"]) < 1e-5
    assert float(m["aux"]) == 0.0
    # the CPU runs the kernels' plain versions: no launch is counted
    assert (tswa.swa_attention.launches, tscan.ssd_scan.launches) == counts


def test_chunked_lm_loss_matches_reference(rng):
    B, S, d, V = 2, 37, 16, 50
    hidden = rng.standard_normal((B, S, d)).astype(np.float32)
    head = (rng.standard_normal((d, V)) * 0.3).astype(np.float32)
    labels = rng.integers(0, V, (B, S)).astype(np.int32)
    labels[1, ::3] = -100
    for chunk in (7, 16, 64):
        got = tcommon.chunked_lm_loss(torch.tensor(hidden), torch.tensor(head),
                                      torch.tensor(labels), chunk=chunk)
        want = jcommon.chunked_lm_loss(jnp.asarray(hidden), jnp.asarray(head),
                                       jnp.asarray(labels), chunk=chunk)
        assert _rel(got, want) < 1e-5, chunk
    # every label ignored: the count clamps to 1, the loss is 0
    none = torch.full((B, S), -100, dtype=torch.int32)
    assert float(tcommon.chunked_lm_loss(torch.tensor(hidden),
                                         torch.tensor(head), none)) == 0.0


def test_loss_gradient_matches_jax_grad(rng):
    """loss_fn(kernel="eager") with per-layer and per-chunk recompute
    (remat) under autograd, against jax.grad, every parameter."""
    jc, tc, jp, tp = _setup("hymba-1.5b", seed=1)
    toks, labels = _batch(rng, jc, S=64)
    params = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    loss, _ = treg.loss_fn(params, tc, {"tokens": torch.tensor(toks),
                                        "labels": torch.tensor(labels)},
                           loss_chunk=24)
    loss.backward()
    jgrad = _flatten(jax.grad(lambda p: jreg.loss_fn(
        p, jc, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)},
        loss_chunk=24)[0])(jp))
    assert set(jgrad) == set(params)
    for k, g in jgrad.items():
        g = np.asarray(g)
        np.testing.assert_allclose(params[k].grad.numpy(), g, rtol=1e-3,
                                   atol=1e-5 * max(1.0, np.abs(g).max()),
                                   err_msg=k)


def test_scoring_forward_options_and_refusals(rng):
    _, tc, _, tp = _setup("hymba-1.5b")
    toks = torch.tensor(_batch(rng, tc, S=32)[0])
    # per-layer recompute (where autograd records) leaves the forward as is
    grad_params = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    remat, _ = tlm.forward_hidden(grad_params, tc, toks, remat=True)
    plain, _ = tlm.forward_hidden(grad_params, tc, toks, remat=False)
    assert torch.equal(remat, plain)
    # the residual laid out by act_pspec in a world of one, remat and the
    # kernels' path: the forward as it is
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import act_pspec
    ap = act_pspec(make_host_mesh(device="cpu"), tc, 32)
    assert torch.equal(tlm.forward_hidden(grad_params, tc, toks,
                                          act_pspec=ap)[0], remat)
    with torch.no_grad():
        assert torch.equal(
            tlm.forward_hidden(tp, tc, toks, act_pspec=ap, kernel="cuda")[0],
            tlm.forward_hidden(tp, tc, toks, kernel="cuda")[0])
    with pytest.raises(ValueError, match="must be one of"):
        tlm.forward_hidden(tp, tc, toks, kernel="pallas")
    # the scoring kernels have no backward
    with pytest.raises(ValueError, match="no backward"):
        tlm.forward_hidden(grad_params, tc, toks, kernel="cuda")
    # a MoE config's loss with the sharded dispatch, one dp shard: the
    # local path's
    moe = dataclasses.replace(tc, family="moe", ssm=None,
                              moe=MoEConfig(num_experts=4))
    moe_params = treg.init_params(torch.Generator(), moe, "cpu")
    ctx = {"mesh": ap.mesh, "dp": "data"}
    b = {"tokens": toks, "labels": toks}
    assert torch.equal(treg.loss_fn(moe_params, moe, b, moe_ctx=ctx)[0],
                       treg.loss_fn(moe_params, moe, b)[0])

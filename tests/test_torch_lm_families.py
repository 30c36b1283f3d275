"""The rest of the decoder-only LM stack against the reference, on
JAX-initialised params and the same numpy inputs: internlm2-20b,
h2o-danube-3-4b (sliding window; also at ``reduced(d_model=480)``, four
heads of dim 120), minitron-4b (squared ReLU), paligemma-3b (the patch
prefix, tied embeddings, GeGLU, one kv head), llama4-scout-17b-a16e (top-1
MoE with a shared expert) and grok-1-314b (top-2 MoE), all reduced.

The scoring forward (``registry.logits_fn`` / ``loss_fn``), eager and
through the kernels' wrappers (their plain versions on the CPU), logits
within 1e-4 and the loss within 1e-5 relative, the MoE aux loss with it;
prefill + decode against the reference's, and against the port's own
forward where no capacity drops a pick; one ``make_train_step`` step in
f32 within 1e-5; the continuous batcher's tokens on the two MoE configs
equal to the reference batcher's."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

import repro.configs as jcfg
from repro.core.serving import ContinuousBatcher as JBatcher
from repro.launch import steps as jsteps
from repro.models import registry as jreg
from repro.types import FedConfig as JFed
from repro_torch import configs as tcfg
from repro_torch.core.serving import ContinuousBatcher as TBatcher
from repro_torch.core.serving import generate_single
from repro_torch.kernels import decode_attend, ssd_scan, swa_attention
from repro_torch.launch import steps as tsteps
from repro_torch.models import lm as tlm
from repro_torch.models import registry as treg
from repro_torch.types import FedConfig as TFed

from torch_parity import assert_params_close, jax_params_both, port_params

MOE = ("llama4-scout-17b-a16e", "grok-1-314b")
ARCHS = ("internlm2-20b", "h2o-danube-3-4b", "h2o-danube-3-4b@480",
         "minitron-4b", "paligemma-3b") + MOE


def _both(arch, seed=0):
    name, _, d = arch.partition("@")
    d = int(d or 256)
    jc = jcfg.get_config(name).reduced(d_model=d)
    tc = tcfg.get_config(name).reduced(d_model=d)
    jp, flat = jax_params_both(jc, jax.random.PRNGKey(seed))
    return jc, tc, jp, port_params(flat, tc)


def _batch(rng, cfg, B=2, S=64):
    """numpy tokens, labels (some ignored) and, for a VLM, the prefix."""
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = np.concatenate([toks[:, 1:], np.full((B, 1), -100)], axis=1)
    labels[0, 3:7] = -100
    b = {"tokens": toks, "labels": labels.astype(np.int32)}
    if cfg.prefix_len:
        b["prefix_embeds"] = rng.standard_normal(
            (B, cfg.prefix_len, cfg.d_model)).astype(np.float32)
    return b


def _rel(a, b):
    return abs(float(a) - float(b)) / abs(float(b))


def _launches():
    return (swa_attention.swa_attention.launches, ssd_scan.ssd_scan.launches,
            decode_attend.ring_decode_attend.launches,
            decode_attend.extent_decode_attend.launches)


@pytest.mark.parametrize("arch", ARCHS)
def test_scoring_matches_reference(arch, rng):
    jc, tc, jp, tp = _both(arch)
    if arch.endswith("@480"):
        assert tc.head_dim == 120
    b = _batch(rng, jc)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.tensor(v) for k, v in b.items()}
    jlogits = np.asarray(jreg.logits_fn(jp, jc, jb))
    jloss, jm = jreg.loss_fn(jp, jc, jb, loss_chunk=48)
    before = _launches()
    with torch.no_grad():
        for kernel in ("eager", "cuda"):
            logits = treg.logits_fn(tp, tc, tb, kernel=kernel)
            assert logits.shape == jlogits.shape == \
                (2, 64 + tc.prefix_len, tc.vocab_size)
            np.testing.assert_allclose(logits.numpy(), jlogits, rtol=1e-4,
                                       atol=1e-4)
            loss, m = treg.loss_fn(tp, tc, tb, loss_chunk=48, kernel=kernel)
            assert _rel(loss, jloss) < 1e-5 and _rel(m["ce"], jm["ce"]) < 1e-5
            if tc.family == "moe":
                assert float(m["aux"]) > 0
                assert _rel(m["aux"], jm["aux"]) < 1e-5
            else:
                assert float(m["aux"]) == float(jm["aux"]) == 0.0
    assert _launches() == before        # plain versions on the CPU


@pytest.mark.parametrize("arch", ("internlm2-20b", "h2o-danube-3-4b",
                                  "minitron-4b", "paligemma-3b") + MOE)
def test_prefill_decode_match_reference_and_forward(arch, rng):
    """Prefill S - 1 tokens (after the prefix), decode the last: logits
    within 1e-4 of the reference's prefill and decode_step; without MoE
    capacity, the same logits as the forward's last two positions (the
    reference's smoke test's check, at 1e-4 here)."""
    jc, tc, jp, tp = _both(arch, seed=2)
    S = 16
    b = _batch(rng, jc, S=S)
    pre = {k: v[:, :S - 1] if k == "tokens" else v for k, v in b.items()
           if k != "labels"}
    max_len = S + tc.prefix_len + 4
    jcache = jreg.init_cache(jc, 2, max_len, jnp.float32)
    jpre, jcache = jreg.prefill(jp, jc, {k: jnp.asarray(v)
                                         for k, v in pre.items()}, jcache,
                                q_chunk=32)
    pos = S - 1 + tc.prefix_len
    last = b["tokens"][:, S - 1]
    jdec, _ = jreg.decode_step(jp, jc, jnp.asarray(last), jcache,
                               jnp.int32(pos))
    tcache = treg.init_cache(tc, 2, max_len, torch.float32, "cpu")
    with torch.no_grad():
        tpre, tcache = treg.prefill(tp, tc, {k: torch.tensor(v)
                                             for k, v in pre.items()},
                                    tcache, q_chunk=32)
        tdec, _ = treg.decode_step(tp, tc, torch.tensor(last), tcache, pos)
    np.testing.assert_allclose(tpre.numpy(), np.asarray(jpre), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(tdec.numpy(), np.asarray(jdec), rtol=1e-4,
                               atol=1e-4)
    if tc.family != "moe":
        with torch.no_grad():
            full = treg.logits_fn(tp, tc, {k: torch.tensor(v)
                                           for k, v in b.items()})
        np.testing.assert_allclose(tpre.numpy(), full[:, -2].numpy(),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(tdec.numpy(), full[:, -1].numpy(),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", MOE + ("paligemma-3b",))
def test_train_step_f32_matches_reference(arch, rng):
    """One FL client step (proximal SGD-momentum) in f32 compute, the MoE
    aux loss in the loss, a VLM's prefix in the batch."""
    jc, tc, jp, tp = _both(arch, seed=4)
    b = _batch(rng, jc, S=32)
    fed = dict(lr=0.05, prox_theta=0.01)
    jstep, jopt = jsteps.make_train_step(jc, JFed(**fed), None,
                                         loss_kwargs={"dtype": jnp.float32})
    tstep, topt = tsteps.make_train_step(tc, TFed(**fed),
                                         loss_kwargs={"dtype": torch.float32})
    jp2, _, jl = jax.jit(jstep)(jp, jopt.init(jp), jp,
                                {k: jnp.asarray(v) for k, v in b.items()})
    tp2, _, tl = tstep(tp, topt.init(tp), dict(tp), b)
    assert _rel(tl, jl) < 1e-5
    assert_params_close(jp2, tp2, rtol=0, atol=1e-5)


@pytest.mark.parametrize("arch", MOE)
def test_moe_batcher_matches_reference(arch, rng):
    """Bucketed prefill and ring decode, dropless: the same streams give
    the reference batcher's tokens and the port's own single-request
    generations."""
    jc, tc, jp, tp = _both(arch, seed=6)
    prompts = [rng.integers(0, jc.vocab_size, n).astype(np.int32)
               for n in (5, 9, 3, 13, 1)]
    max_new = (6, 4, 8, 5, 7)
    outs = {}
    before = _launches()
    for cls, p in ((JBatcher, jp), (TBatcher, tp)):
        srv = cls(p, tc if cls is TBatcher else jc, max_slots=2, max_len=32,
                  min_bucket=4)
        for pr, m in zip(prompts, max_new):
            srv.submit(pr, max_new=m)
        outs[cls] = {r.rid: r.out for r in srv.run()}
    assert outs[TBatcher] == outs[JBatcher]
    for rid, (pr, m) in enumerate(zip(prompts, max_new)):
        assert outs[TBatcher][rid] == generate_single(tp, tc, pr, m,
                                                      max_len=32)
    # the port's ring decode went through the extent kernel's wrapper
    # (every layer is global), its plain version on the CPU: no launch
    assert tlm.global_layer_ids(tc) == [0, 1] and _launches() == before

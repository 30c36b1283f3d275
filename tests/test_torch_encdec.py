"""The encoder-decoder (``repro_torch/models/encdec.py``, the
SeamlessM4T backbone) against the reference on JAX-initialised params of
reduced seamless-m4t-large-v2 and the same numpy inputs: ``encode``
(bidirectional), ``decode_train``, ``logits_fn`` and ``loss_fn`` within
1e-4 / 1e-5 relative, the loss's gradient, one f32 ``make_train_step``
step; prefill + greedy decode tokens equal to the reference's static
``serve.py`` path (BOS 0 at position 0); ``batch_spec`` / ``decode_spec``
and ``synth_batch`` byte for byte; and what the family refuses."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

import repro.configs as jcfg
from repro.checkpoint.ckpt import _flatten
from repro.launch import serve as jserve
from repro.launch import steps as jsteps
from repro.models import encdec as jenc
from repro.models import registry as jreg
from repro.types import FedConfig as JFed
from repro.types import ShapeConfig as JShape
from repro_torch import configs as tcfg
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import encdec as tenc
from repro_torch.models import registry as treg
from repro_torch.types import FedConfig as TFed
from repro_torch.types import ShapeConfig as TShape

from torch_parity import assert_params_close, jax_params_both, port_params

ARCH = "seamless-m4t-large-v2"
_DT = {jnp.dtype(jnp.int32): torch.int32,
       jnp.dtype(jnp.float32): torch.float32,
       jnp.dtype(jnp.bfloat16): torch.bfloat16}


def _both(seed=0):
    jc, tc = jcfg.get_config(ARCH).reduced(), tcfg.get_config(ARCH).reduced()
    jp, flat = jax_params_both(jc, jax.random.PRNGKey(seed))
    return jc, tc, jp, port_params(flat, tc)


def _batch(rng, cfg, B=2, S_src=24, S_tgt=20):
    toks = rng.integers(0, cfg.vocab_size, (B, S_tgt)).astype(np.int32)
    labels = np.concatenate([toks[:, 1:], np.full((B, 1), -100)], axis=1)
    return {"src_embeds": rng.standard_normal(
                (B, S_src, cfg.d_model)).astype(np.float32),
            "tokens": toks, "labels": labels.astype(np.int32)}


def _rel(a, b):
    return abs(float(a) - float(b)) / abs(float(b))


def _close(got, want, tol=1e-4):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)


def test_config_is_an_audio_encdec():
    tc = tcfg.get_config(ARCH)
    assert tc.is_encdec and tc.family == "audio"
    assert (tc.num_encoder_layers, tc.num_layers, tc.d_model) == \
        (24, 24, 1024)


def test_encode_and_decode_train_match_reference(rng):
    jc, tc, jp, tp = _both()
    b = _batch(rng, jc)
    with torch.no_grad():
        enc = tenc.encode(tp, tc, torch.tensor(b["src_embeds"]))
        hid = tenc.decode_train(tp, tc, torch.tensor(b["tokens"]), enc)
    jenc_out = jenc.encode(jp, jc, jnp.asarray(b["src_embeds"]))
    _close(enc, jenc_out)
    _close(hid, jenc.decode_train(jp, jc, jnp.asarray(b["tokens"]),
                                  jenc_out))
    # q_chunk smaller than the sequences: chunked query rows, same result
    with torch.no_grad():
        enc8 = tenc.encode(tp, tc, torch.tensor(b["src_embeds"]), q_chunk=8)
    _close(enc8, jenc_out)


def test_logits_and_loss_match_reference(rng):
    jc, tc, jp, tp = _both(seed=1)
    b = _batch(rng, jc)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.tensor(v) for k, v in b.items()}
    with torch.no_grad():
        logits = treg.logits_fn(tp, tc, tb)
        loss, m = treg.loss_fn(tp, tc, tb, loss_chunk=8)
    jlogits = jreg.logits_fn(jp, jc, jb)
    assert logits.shape == (2, 20, tc.vocab_size)
    _close(logits, jlogits)
    jloss, jm = jreg.loss_fn(jp, jc, jb, loss_chunk=8)
    assert _rel(loss, jloss) < 1e-5 and _rel(m["ce"], jm["ce"]) < 1e-5
    assert float(m["aux"]) == float(jm["aux"]) == 0.0


def test_loss_gradient_matches_jax_grad(rng):
    """Per-layer recompute of both stacks under autograd, every
    parameter's gradient against ``jax.grad`` (rtol 1e-3: sums over the
    batch in another order)."""
    jc, tc, jp, tp = _both(seed=2)
    b = _batch(rng, jc, S_src=16, S_tgt=12)
    params = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    loss, _ = treg.loss_fn(params, tc, {k: torch.tensor(v)
                                        for k, v in b.items()})
    loss.backward()
    jgrad = _flatten(jax.grad(lambda p: jreg.loss_fn(
        p, jc, {k: jnp.asarray(v) for k, v in b.items()})[0])(jp))
    assert set(jgrad) == set(params)
    for k, g in jgrad.items():
        g = np.asarray(g)
        np.testing.assert_allclose(params[k].grad.numpy(), g, rtol=1e-3,
                                   atol=1e-5 * max(1.0, np.abs(g).max()),
                                   err_msg=k)


def test_train_step_f32_matches_reference(rng):
    jc, tc, jp, tp = _both(seed=3)
    b = _batch(rng, jc, S_src=16, S_tgt=16)
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


def test_prefill_and_greedy_decode_match_reference(rng):
    """The static serve path's generation: encode 16 source frames, BOS 0
    at position 0, 10 greedy steps; every step's logits within 1e-4 of
    the reference's and the tokens equal."""
    jc, tc, jp, tp = _both(seed=4)
    src = rng.standard_normal((3, 16, jc.d_model)).astype(np.float32)
    jcache = jreg.prefill(jp, jc, {"src_embeds": jnp.asarray(src)},
                          jreg.init_cache(jc, 3, 26, jnp.float32))
    tcache = treg.prefill(tp, tc, {"src_embeds": torch.tensor(src)},
                          treg.init_cache(tc, 3, 26, torch.float32, "cpu"))
    assert tcache["enc_k"].shape == tuple(jcache["enc_k"].shape)
    _close(tcache["enc_k"], jcache["enc_k"])
    jtok = jnp.zeros((3,), jnp.int32)
    ttok = torch.zeros(3, dtype=torch.int32)
    want = [np.asarray(jtok)]
    for i in range(10):
        jl, jcache = jreg.decode_step(jp, jc, jtok, jcache, jnp.int32(i))
        with torch.no_grad():
            tl, tcache = treg.decode_step(tp, tc, ttok, tcache, i)
        _close(tl, jl)
        jtok = jnp.argmax(jl, -1).astype(jnp.int32)
        ttok = torch.argmax(tl, -1).to(torch.int32)
        want.append(np.asarray(jtok))
        assert ttok.tolist() == want[-1].tolist()
    got, _, _ = tserve.generate(tp, tc, {"src_embeds": torch.tensor(src)},
                                26, 11)
    np.testing.assert_array_equal(got, np.stack(want, axis=1))


def test_static_serve_cli_matches_reference(monkeypatch, capsys):
    """``serve.py --arch seamless-m4t-large-v2`` without --continuous: the
    same synthesised source frames and greedy tokens as the reference's
    CLI."""
    jc, tc, jp, tp = _both(seed=5)
    argv = ["--arch", ARCH, "--reduced", "--batch", "2", "--prompt-len",
            "12", "--gen", "6", "--seed", "3"]
    monkeypatch.setattr(jreg, "init_params", lambda key, cfg: jp)
    assert jserve.main(argv) == 0
    want = capsys.readouterr().out
    monkeypatch.setattr(treg, "init_params",
                        lambda gen, cfg, device, dtype=None: tp)
    assert tserve.main(argv + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert got.splitlines()[0] == want.splitlines()[0]
    sample = lambda out: out[out.index("sample generations"):]
    assert sample(got) == sample(want)


@pytest.mark.parametrize("kind", ["train", "decode"])
def test_specs_and_synth_batch_match_reference(kind):
    jc, tc = jcfg.get_config(ARCH).reduced(), tcfg.get_config(ARCH).reduced()
    js, ts = JShape("s", 40, 2, kind), TShape("s", 40, 2, kind)
    want, got = jreg.batch_spec(jc, js), treg.batch_spec(tc, ts)
    assert list(got) == list(want) == ["src_embeds", "tokens", "labels"]
    for k in want:
        assert tuple(got[k].shape) == want[k].shape
        assert got[k].dtype == _DT[jnp.dtype(want[k].dtype)]
    jt, jcache, _ = jreg.decode_spec(jc, js)
    tt, tcache, tpos = treg.decode_spec(tc, ts)
    assert set(tcache) == set(jcache) == {"enc_k", "enc_v", "k", "v"}
    for k in jcache:
        assert tuple(tcache[k].shape) == jcache[k].shape
    wb = jreg.synth_batch(np.random.default_rng(7), jc, js)
    gb = treg.synth_batch(np.random.default_rng(7), tc, ts, device="cpu")
    assert list(gb) == list(wb)
    for k in wb:
        w, g = np.asarray(wb[k]), gb[k].numpy()
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes(), k


def test_refusals(rng):
    """No kernel path (bidirectional attends), no bucketed prefill, no
    ring cache; the trainer refuses the family with the reason the
    reference's trainer fails on. The mesh path (``act_pspec``) runs."""
    _, tc, _, tp = _both()
    tb = {k: torch.tensor(v) for k, v in _batch(rng, tc).items()}
    with pytest.raises(ValueError, match="eagerly"):
        treg.loss_fn(tp, tc, tb, kernel="cuda")
    with pytest.raises(ValueError, match="eagerly"):
        treg.logits_fn(tp, tc, tb, kernel="cuda")
    with pytest.raises(ValueError, match="LM-only"):
        treg.prefill(tp, tc, tb, treg.init_cache(tc, 2, 24, torch.float32,
                                                 "cpu"), lengths=[3, 4])
    with pytest.raises(ValueError, match="ring"):
        treg.init_ring_cache(tc, 2, 24, device="cpu")
    # the mesh path in a world of one: the loss bit for bit
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import act_pspec
    ap = act_pspec(make_host_mesh(device="cpu"), tc, 16)
    assert torch.equal(treg.loss_fn(tp, tc, tb, act_pspec=ap)[0],
                       treg.loss_fn(tp, tc, tb)[0])
    with pytest.raises(ValueError, match="src_embeds"):
        ttrain.main(["--arch", ARCH, "--reduced", "--mode", "central",
                     "--device", "cpu"])

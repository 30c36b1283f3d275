"""The port's ring and window-sliced decoding against the reference's:
``to_ring_cache`` bit for bit, ``decode_step_ring`` and
``decode_step(unroll=True, window_slice=True)`` logits and caches
(rtol 1e-5, atol 1e-5), each also against the uniform decode at the
reference's own tolerance (rtol 2e-3, atol 2e-4,
``tests/test_models_smoke.py``); per-row positions; the serve steps'
greedy tokens; and the static ``serve.py`` path's tokens equal to the
reference's prefill + decode loop. The prompts are longer than the
reduced window (64), so the ring and the slice really cut the cache."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import get_config as jget
from repro.launch import serve as jserve
from repro.launch import steps as jsteps
from repro.models import lm as jlm
from repro.models import registry as jreg
from repro_torch.configs import get_config as tget
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.models import lm as tlm
from repro_torch.models import registry as treg

from torch_parity import jax_params_both, port_params

S = 81                 # prompt S - 1 = 80 tokens (5 chunks of 16) + 1
TOL = dict(rtol=1e-5, atol=1e-5)
UNIFORM_TOL = dict(rtol=2e-3, atol=2e-4)
_MODELS: dict = {}


def _model(arch):
    if arch not in _MODELS:
        jc, tc = jget(arch).reduced(), tget(arch).reduced()
        jp, flat = jax_params_both(jc, jax.random.PRNGKey(2))
        _MODELS[arch] = (jc, tc, jp, port_params(flat, tc))
    return _MODELS[arch]


def _prefilled(arch, rng, B=2):
    """A uniform cache after S - 1 prompt tokens: both packages prefill
    (their caches agree within TOL), then both decode from the port's, so
    each comparison below holds one decode step alone."""
    jc, tc, jp, tp = _model(arch)
    toks = rng.integers(0, jc.vocab_size, (B, S)).astype(np.int32)
    jcache = jreg.init_cache(jc, B, S + 7, jnp.float32)
    _, jcache = jreg.prefill(jp, jc, {"tokens": jnp.asarray(toks[:, :S - 1])},
                             jcache, q_chunk=16)
    tcache = treg.init_cache(tc, B, S + 7, torch.float32, "cpu")
    with torch.no_grad():
        _, tcache = treg.prefill(tp, tc, {"tokens": torch.tensor(
            toks[:, :S - 1])}, tcache, q_chunk=16)
    for k in jcache:
        _close(tcache[k], jcache[k], f"prefilled {k}")
    # copies: the port writes its caches in place, and a JAX array may
    # share a numpy buffer's memory
    jcache = {k: jnp.asarray(v.numpy().copy()) for k, v in tcache.items()}
    return jc, tc, jp, tp, toks, jcache, tcache


def _close(got, want, what, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), err_msg=what,
                               **tol)


@pytest.mark.parametrize("arch", ["gemma3-12b", "hymba-1.5b",
                                  "mamba2-130m"])
def test_ring_decode_matches_reference(arch, rng):
    jc, tc, jp, tp, toks, jcache, tcache = _prefilled(arch, rng)
    jring = jlm.to_ring_cache(jc, jcache, jnp.int32(S - 1))
    tring = tlm.to_ring_cache(tc, tcache, S - 1)
    assert set(tring) == set(jring)
    for k in jring:           # a conversion: bit for bit
        np.testing.assert_array_equal(tring[k].numpy(), np.asarray(jring[k]))
    if tlm.swa_layer_ids(tc):
        assert tring["k_win"].shape[2] == 64 < S
    tok = toks[:, S - 1]
    jl, jring2 = jlm.decode_step_ring(jp, jc, jnp.asarray(tok), jring,
                                      jnp.int32(S - 1))
    with torch.no_grad():
        tl, tring2 = tlm.decode_step_ring(tp, tc, torch.tensor(tok), tring,
                                          S - 1)
        ul, _ = tlm.decode_step(tp, tc, torch.tensor(tok), tcache, S - 1)
    _close(tl, jl, "ring logits")
    for k in jring2:
        _close(tring2[k], jring2[k], k)
    _close(tl, ul, "ring vs uniform", UNIFORM_TOL)


@pytest.mark.parametrize("arch", ["gemma3-12b", "hymba-1.5b"])
def test_window_sliced_decode_matches_reference(arch, rng):
    jc, tc, jp, tp, toks, jcache, tcache = _prefilled(arch, rng)
    tok = toks[:, S - 1]
    jl, jc2 = jlm.decode_step(jp, jc, jnp.asarray(tok), jcache,
                              jnp.int32(S - 1), unroll=True,
                              window_slice=True)
    ju, _ = jlm.decode_step(jp, jc, jnp.asarray(tok), jcache,
                            jnp.int32(S - 1))
    uncut = {k: v.clone() for k, v in tcache.items()}
    with torch.no_grad():
        tl, tc2 = tlm.decode_step(tp, tc, torch.tensor(tok), tcache, S - 1,
                                  unroll=True, window_slice=True)
        ul, _ = tlm.decode_step(tp, tc, torch.tensor(tok), uncut, S - 1)
    _close(tl, jl, "sliced logits")
    for k in jc2:
        _close(tc2[k], jc2[k], k)
    _close(tl, ul, "sliced vs uniform", UNIFORM_TOL)
    _close(ju, jl, "the reference's own slice", UNIFORM_TOL)


def test_per_row_positions_slice_and_ring(rng):
    """Rows at different positions (the port's (B,) decode positions):
    each row's sliced logits and ring slots equal a one-row run's."""
    jc, tc, jp, tp, toks, jcache, tcache = _prefilled("hymba-1.5b", rng)
    tok = torch.tensor(toks[:, S - 1])
    pos = torch.tensor([S - 1, S - 20], dtype=torch.int32)
    ring = tlm.to_ring_cache(tc, tcache, pos)
    with torch.no_grad():
        both, _ = tlm.decode_step(tp, tc, tok, {k: v.clone() for k, v in
                                                tcache.items()}, pos,
                                  unroll=True, window_slice=True)
    for r in range(2):
        one = {k: v[:, r:r + 1].clone() for k, v in tcache.items()}
        ring1 = tlm.to_ring_cache(tc, one, int(pos[r]))
        for k in ring:
            assert torch.equal(ring[k][:, r:r + 1], ring1[k]), k
        with torch.no_grad():
            l1, _ = tlm.decode_step(tp, tc, tok[r:r + 1], one, int(pos[r]),
                                    unroll=True, window_slice=True)
        _close(both[r:r + 1], l1, f"row {r}")


def test_serve_steps_give_the_uniform_tokens(rng):
    """``make_serve_step`` greedy: ring and unrolled-sliced tokens equal
    the uniform step's and the reference's for 6 tokens."""
    jc, tc, jp, tp, toks, jcache, tcache = _prefilled("hymba-1.5b", rng)
    jstep = jsteps.make_serve_step(jc)
    steps = {"uniform": (tsteps.make_serve_step(tc), tcache),
             "ring": (tsteps.make_serve_step(tc, ring=True),
                      tlm.to_ring_cache(tc, tcache, S - 1)),
             "sliced": (tsteps.make_serve_step(tc, unroll=True,
                                               window_slice=True),
                        {k: v.clone() for k, v in tcache.items()})}
    caches = {k: c for k, (_, c) in steps.items()}
    jtok = jnp.asarray(toks[:, S - 1])
    ttok = {k: torch.tensor(toks[:, S - 1]) for k in steps}
    for i in range(6):
        jtok, jcache = jstep(jp, jtok, jcache, jnp.int32(S - 1 + i))
        for name, (step, _) in steps.items():
            ttok[name], caches[name] = step(tp, ttok[name], caches[name],
                                            S - 1 + i)
            assert ttok[name].dtype == torch.int32
            np.testing.assert_array_equal(ttok[name].numpy(),
                                          np.asarray(jtok), err_msg=name)


def test_cuda_attend_refuses_the_cache_slice():
    jc, tc, jp, tp = _model("hymba-1.5b")
    cache = treg.init_cache(tc, 1, 96, torch.float32, "cpu")
    with pytest.raises(ValueError, match="cache_slice_window"):
        tlm.decode_step(tp, tc, torch.zeros(1, dtype=torch.int32), cache, 70,
                        unroll=True, window_slice=True,
                        decode_kernel="cuda")


def test_static_serve_path_matches_reference(monkeypatch, capsys):
    """``serve.py`` without ``--continuous``: the same synthesised prompts,
    prefill and greedy decode loop as the reference's, token for token."""
    jc, tc, jp, tp = _model("hymba-1.5b")
    argv = ["--arch", "hymba-1.5b", "--reduced", "--batch", "3",
            "--prompt-len", "24", "--gen", "10", "--seed", "5"]
    monkeypatch.setattr(jreg, "init_params", lambda key, cfg: jp)
    assert jserve.main(argv) == 0
    want = capsys.readouterr().out
    monkeypatch.setattr(treg, "init_params",
                        lambda gen, cfg, device, dtype=None: tp)
    assert tserve.main(argv + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert got.splitlines()[0] == want.splitlines()[0]     # serving ...
    sample = lambda out: out[out.index("sample generations"):]
    assert sample(got) == sample(want)
    # all 10 tokens, against the reference's loop on its own prompts
    rng = np.random.default_rng(5)
    from repro.types import ShapeConfig
    shape = ShapeConfig("serve", seq_len=24, global_batch=3, kind="decode")
    prompts = jreg.synth_batch(rng, jc, shape)["tokens"]
    cache = jreg.init_cache(jc, 3, 34, jnp.float32)
    logits, cache = jreg.prefill(jp, jc, {"tokens": prompts}, cache,
                                 q_chunk=24)
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    ref = [np.asarray(tok)]
    for i in range(9):
        logits, cache = jreg.decode_step(jp, jc, tok, cache, jnp.int32(24 + i))
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        ref.append(np.asarray(tok))
    toks, _, _ = tserve.generate(tp, tc, torch.tensor(np.asarray(prompts)),
                                 34, 10)
    np.testing.assert_array_equal(toks, np.stack(ref, axis=1))

"""The port's LM against the reference on JAX-initialised params: bucketed
prefill, the uniform decode step at per-row positions and the grouped
ring decode (eager and through the decode kernels' wrappers), on
hymba-1.5b, gemma3-12b and mamba2-130m reduced; the cache layouts; and
the LM param conversion. Logits to rtol 1e-4 / atol 1e-4."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

import repro.configs as jcfg
from repro.models import lm as jlm
from repro.models import registry as jreg
from repro_torch import configs as tcfg
from repro_torch.checkpoint.convert import params_from_jax, params_to_numpy
from repro_torch.models import lm as tlm
from repro_torch.models import registry as treg

from torch_parity import jax_flat_params, jax_params_both

TOL = 1e-4
ARCHS = ["hymba-1.5b", "gemma3-12b", "mamba2-130m"]


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _setup(arch, seed=0):
    jc, tc = jcfg.get_config(arch).reduced(), tcfg.get_config(arch).reduced()
    jp, flat = jax_params_both(jc, jax.random.PRNGKey(seed))
    tp = params_from_jax(flat, tc)
    return jc, tc, jp, tp


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch, rng):
    """A right-padded bucketed prefill, then decode ticks with each row at
    its own position: the uniform oracle and the grouped ring decode
    (eager, and through the kernels' wrappers), each row against the
    reference at that row's scalar position."""
    jc, tc, jp, tp = _setup(arch)
    B, S, max_len = 3, 16, 32
    toks = rng.integers(0, jc.vocab_size, (B, S)).astype(np.int32)
    lens = np.asarray([16, 5, 11], np.int32)
    # bucketed prefill into a uniform cache, per-row last-token logits
    tcache = treg.init_cache(tc, B, max_len, torch.float32, "cpu")
    logits, tcache = treg.prefill(tp, tc, {"tokens": torch.tensor(toks)},
                                  tcache, lengths=torch.tensor(lens),
                                  q_chunk=8)
    jcache = jreg.init_cache(jc, B, max_len, jnp.float32)
    jlogits, jcache = jreg.prefill(jp, jc, {"tokens": jnp.asarray(toks)},
                                   jcache, lengths=jnp.asarray(lens),
                                   q_chunk=8)
    close(logits, jlogits)
    # the reference decodes one stream at a scalar position: hold each
    # port row (its own position) against the reference's row alone
    jrows = [{k: v[:, b:b + 1] for k, v in jcache.items()} for b in range(B)]
    ring = {k: v.clone() for k, v in tcache.items()}
    if tc.family != "ssm":           # a ring layout from the same prefill
        ring = _to_ring(tc, tcache, lens, max_len)
    pos = torch.tensor(lens)
    tok = torch.argmax(logits, -1).to(torch.int32)
    uni = tcache
    for step in range(3):
        got_u, uni = treg.decode_step(tp, tc, tok, uni, pos)
        got_r, ring = treg.decode_step_grouped(
            tp, tc, tok, ring, pos, k_ext=32,
            decode_kernel="cuda" if step % 2 else "eager")
        for b in range(B):
            want, jrows[b] = jreg.decode_step(
                jp, jc, jnp.asarray(tok[b:b + 1].numpy()), jrows[b],
                jnp.int32(int(pos[b])))
            close(got_u[b:b + 1], want)
            close(got_r[b:b + 1], want)
        tok = torch.argmax(got_u, -1).to(torch.int32)
        pos = pos + 1


def _to_ring(cfg, cache, lens, max_len):
    """Ring layout of a uniform cache: full-attention layers keep their
    buffers, SWA layers gather the latest position of each slot."""
    ring = tlm.init_ring_cache(cfg, len(lens), max_len, torch.float32, "cpu")
    gl, wl = tlm.global_layer_ids(cfg), tlm.swa_layer_ids(cfg)
    for key in ("k", "v"):
        if gl:
            ring[key][:] = cache[key][gl]
        if wl:
            W = ring[key + "_win"].shape[2]
            src = tlm.ring_source_positions(torch.tensor(lens) - 1, W)
            rows = torch.arange(len(lens))[:, None]
            g = cache[key][wl][:, rows, src.clamp(min=0)]
            ring[key + "_win"][:] = torch.where(
                (src >= 0)[None, :, :, None, None], g, torch.zeros(()))
    for key in ("ssm_state", "conv_state"):
        if key in cache:
            ring[key][:] = cache[key]
    return ring


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_layouts_and_param_shapes(arch):
    jc, tc = jcfg.get_config(arch).reduced(), tcfg.get_config(arch).reduced()
    for fn_j, fn_t in ((jlm.init_cache, tlm.init_cache),
                       (jlm.init_ring_cache, tlm.init_ring_cache)):
        a = fn_j(jc, 2, 48, jnp.float32)
        b = fn_t(tc, 2, 48, torch.float32, "cpu")
        assert {k: v.shape for k, v in a.items()} == \
            {k: tuple(v.shape) for k, v in b.items()}
    assert tlm.swa_layer_ids(tc) == jlm.swa_layer_ids(jc)
    assert tlm.global_layer_ids(tc) == jlm.global_layer_ids(jc)
    assert tlm._kind_runs(tc) == jlm._kind_runs(jc)
    assert tlm.windows(tc).tolist() == np.asarray(jlm.windows(jc)).tolist()
    # the port's own init: the reference's keys and shapes, on the device
    tp = tlm.init_params(torch.Generator().manual_seed(0), tc, "cpu")
    flat = jax_flat_params(jc, jax.random.PRNGKey(0))
    assert {k: tuple(v.shape) for k, v in tp.items()} == \
        {k: v.shape for k, v in flat.items()} == tlm.param_shapes(tc)
    assert sum(v.numel() for v in tp.values()) == \
        sum(v.size for v in flat.values())


def test_ring_source_positions_match():
    for last, W in ((5, 8), (40, 8), (0, 1), (33, 17)):
        assert tlm.ring_source_positions(last, W).tolist() == \
            np.asarray(jlm.ring_source_positions(last, W)).tolist()
    rows = np.asarray([3, 20, 7])
    assert tlm.ring_source_positions(torch.tensor(rows), 6).tolist() == \
        np.asarray(jlm.ring_source_positions(jnp.asarray(rows), 6)).tolist()


def test_lm_convert_round_trip(tmp_path):
    """Reference params -> port -> reference, bit for bit; a reference
    npz checkpoint loads; wrong keys and shapes are refused."""
    from repro.checkpoint.ckpt import save_params
    from repro_torch.checkpoint.convert import load_jax_checkpoint
    for arch in ARCHS:
        jc, tc = jcfg.get_config(arch).reduced(), \
            tcfg.get_config(arch).reduced()
        tree, flat = jax_params_both(jc, jax.random.PRNGKey(1))
        back = params_to_numpy(params_from_jax(flat, tc))
        assert set(back) == set(flat)
        for k in flat:
            assert back[k].tobytes() == flat[k].tobytes(), k
        path = str(tmp_path / arch)
        save_params(tree, path)
        loaded = load_jax_checkpoint(path, tc)
        assert all(torch.equal(loaded[k], torch.tensor(flat[k]))
                   for k in flat)
        bad = dict(flat)
        bad.pop("embed")
        with pytest.raises(ValueError, match="keys differ"):
            params_from_jax(bad, tc)
        bad = dict(flat, final_norm=np.zeros(3, np.float32))
        with pytest.raises(ValueError, match="final_norm"):
            params_from_jax(bad, tc)

"""Serving's decode through ``GraphCache`` on the CPU, where the graphs'
calls run eagerly and drive the control flow the card replays:
``GraphCache``'s in-place arguments (written where they live, handed back
as themselves, keyed by their address) and ``count``; the reduced Hymba,
Mamba2 and Gemma3 batchers, ring and uniform, against the reference's
batcher (tokens and program counts equal, the cache never copied); and
``launch.serve.generate``, its positions a tensor advanced in place,
against the reference's static decode."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

import repro.configs as jcfg
from repro.core.serving import ContinuousBatcher as JBatcher
from repro.models import registry as jreg
from repro_torch import configs as tcfg
from repro_torch.checkpoint.convert import params_from_jax
from repro_torch.core.compile_cache import GraphCache, ShapeCache
from repro_torch.core.serving import ContinuousBatcher as TBatcher
from repro_torch.launch import serve as tserve

from torch_parity import jax_params_both


def _acc(acc, x):
    acc.add_(x)
    return acc, x * 2


def test_in_place_leaf_is_written_and_returned_as_itself():
    graphs = GraphCache()
    acc = torch.zeros(3)
    for i in range(3):
        x = torch.full((3,), float(i))
        got, twice = graphs.call("f", _acc, (acc, x), inplace=(0,))
        assert got is acc and torch.equal(twice, 2 * x)
    assert torch.equal(acc, torch.full((3,), 3.0))
    assert (graphs.num_compiled, graphs.num_captured) == (1, 0)


def test_another_tensor_in_place_is_another_signature():
    """In place, a tensor's address keys the call; a copied leaf's does
    not."""
    graphs = GraphCache()
    a, b = torch.zeros(3), torch.zeros(3)
    graphs.call("f", _acc, (a, torch.ones(3)), inplace=(0,))
    graphs.call("f", _acc, (a, torch.ones(3)), inplace=(0,))
    assert graphs.num_compiled == 1
    graphs.call("f", _acc, (b, torch.ones(3)), inplace=(0,))
    assert graphs.num_compiled == 2
    graphs.call("f", _acc, (torch.zeros(3), torch.ones(3)))
    graphs.call("f", _acc, (torch.zeros(3), torch.ones(3)))
    assert graphs.num_compiled == 3
    assert torch.equal(a, torch.full((3,), 2.0)) and torch.equal(b, a / 2)
    with pytest.raises(TypeError, match="must be tensors"):
        graphs.call("f", _acc, (np.zeros(3), torch.ones(3)), inplace=(0,))


def test_count_matches_shape_cache_on_tuple_names():
    graphs, shapes = GraphCache(), ShapeCache()
    calls = [("decode", 8), ("decode", 8), ("decode", 16), "decode",
             ("prefill", 4), "prefill", "decoded", ("decoded", 8)]
    for name in calls:
        for n in (2, 3):
            args = (torch.zeros(n),)
            graphs.call(name, torch.neg, args)
            shapes.call(name, torch.neg, args)
    for name in ("decode", ("decode", 8), "prefill", "decoded", "install"):
        assert graphs.count(name) == shapes.count(name), name
    assert graphs.count("decode") == 6
    assert graphs.num_compiled == shapes.num_compiled == 14
    assert graphs.captures("decode") == 0


def _both(arch, seed):
    jc, tc = jcfg.get_config(arch).reduced(), tcfg.get_config(arch).reduced()
    jp, flat = jax_params_both(jc, jax.random.PRNGKey(seed))
    return jc, tc, jp, params_from_jax(flat, tc)


def _run(batcher, prompts, max_new):
    for p, m in zip(prompts, max_new):
        batcher.submit(p, max_new=m)
    return {r.rid: r.out for r in batcher.run()}


@pytest.mark.parametrize("decode_mode", ["ring", "uniform"])
@pytest.mark.parametrize("arch", ["hymba-1.5b", "mamba2-130m",
                                  "gemma3-12b"])
def test_batcher_through_graph_cache_matches_reference(arch, decode_mode,
                                                       rng):
    """A stream whose decode climbs three K-extent rungs (Hymba's global
    layer; the others decode at one shape): the same tokens and prefill /
    decode / total program counts as the reference's, one decode
    signature a shape, and the cache's tensors the ones the batcher made,
    written in place from the first tick to the last."""
    jc, tc, jp, tp = _both(arch, seed=3)
    prompts = [rng.integers(0, jc.vocab_size, n).astype(np.int32)
               for n in (3, 9, 21, 5)]
    max_new = (20, 12, 30, 6)
    kw = dict(max_slots=2, max_len=64, min_bucket=4, decode_mode=decode_mode)
    jb, tb = JBatcher(jp, jc, **kw), TBatcher(tp, tc, **kw)
    ptrs = {k: v.data_ptr() for k, v in tb.cache.items()}
    assert _run(tb, prompts, max_new) == _run(jb, prompts, max_new)
    assert (tb.prefill_compiles, tb.decode_compiles, tb.num_compiled) == \
        (jb.prefill_compiles, jb.decode_compiles, jb.num_compiled)
    assert {k: v.data_ptr() for k, v in tb.cache.items()} == ptrs
    assert tb._graphs.num_compiled == tb.decode_compiles
    assert tb._graphs.num_captured == 0             # no card: all eager
    if decode_mode == "ring" and arch == "hymba-1.5b":
        assert tb.decode_compiles == 3 < len(tb.decode_buckets)
    else:
        assert tb.decode_compiles == 1


def _reference_static(jp, jc, batch, max_len, gen):
    """The reference's static decode (its ``serve.py`` loop): prefill,
    then greedy ``decode_step`` at a scalar position."""
    if jc.is_encdec:
        cache = jreg.prefill(jp, jc, {"src_embeds": batch["src_embeds"]},
                             jreg.init_cache(jc, batch["src_embeds"].shape[0],
                                             max_len, jnp.float32))
        tok, start = jnp.zeros((batch["src_embeds"].shape[0],), jnp.int32), 0
    else:
        B, P = batch["tokens"].shape
        cache = jreg.init_cache(jc, B, max_len, jnp.float32)
        logits, cache = jreg.prefill(jp, jc, {"tokens": batch["tokens"]},
                                     cache, q_chunk=P)
        tok, start = jnp.argmax(logits, -1).astype(jnp.int32), P
    out = [np.asarray(tok)]
    for i in range(gen - 1):
        logits, cache = jreg.decode_step(jp, jc, tok, cache,
                                         jnp.int32(start + i))
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        out.append(np.asarray(tok))
    return np.stack(out, axis=1)


@pytest.mark.parametrize("arch", ["gemma3-12b", "hymba-1.5b",
                                  "seamless-m4t-large-v2"])
def test_generate_with_tensor_positions_matches_reference(arch):
    """``generate``'s decode steps take a (B,) int32 position tensor that
    the step advances in place (the graph's input on the card): the
    tokens equal the reference's static decode of the same batch."""
    jc, tc, jp, tp = _both(arch, seed=6)
    rng = np.random.default_rng(7)
    gen, P = 10, 12
    if jc.is_encdec:
        batch = {"src_embeds": rng.standard_normal(
            (3, P, jc.d_model)).astype(np.float32)}
    else:
        batch = {"tokens": rng.integers(0, jc.vocab_size, (3, P),
                                        dtype=np.int32)}
    want = _reference_static(jp, jc, {k: jnp.asarray(v)
                                      for k, v in batch.items()},
                             P + gen, gen)
    got, _, _ = tserve.generate(tp, tc, {k: torch.from_numpy(v)
                                         for k, v in batch.items()},
                                P + gen, gen)
    np.testing.assert_array_equal(got, want)

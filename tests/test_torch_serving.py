"""The port's continuous batcher against the reference's, on JAX-initialised
params: the same request streams give exactly the same greedy tokens and
the same number of prefill / decode shapes, in both decode modes; the
port's tokens equal its own ``generate_single``; submit's rejections,
early retirement, run exhaustion and the ring install behave as the
reference's do; and the serve CLI runs on the CPU."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

import repro.configs as jcfg
import repro.core.compile_cache as jcc
from repro.core.serving import ContinuousBatcher as JBatcher
from repro_torch import configs as tcfg
from repro_torch.checkpoint.convert import params_from_jax
from repro_torch.core import compile_cache as tcc
from repro_torch.core.serving import ContinuousBatcher as TBatcher
from repro_torch.core.serving import generate_single
from repro_torch.kernels import decode_attend, ssd_decode
from repro_torch.models import lm as tlm
from repro_torch.types import ModelConfig as TConfig

from torch_parity import jax_params_both


def _both(arch, seed=0, cfgs=None):
    jc, tc = cfgs or (jcfg.get_config(arch).reduced(),
                      tcfg.get_config(arch).reduced())
    jp, flat = jax_params_both(jc, jax.random.PRNGKey(seed))
    return jc, tc, jp, params_from_jax(flat, tc)


def _prompts(rng, vocab, lengths):
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lengths]


def _run(batcher, prompts, max_new):
    for p, m in zip(prompts, max_new):
        batcher.submit(p, max_new=m)
    return {r.rid: r.out for r in batcher.run()}


def _serve_both(jc, tc, jp, tp, prompts, max_new, **kw):
    jb, tb = JBatcher(jp, jc, **kw), TBatcher(tp, tc, **kw)
    jo, to = _run(jb, prompts, max_new), _run(tb, prompts, max_new)
    assert to == jo
    assert (tb.prefill_compiles, tb.decode_compiles) == \
        (jb.prefill_compiles, jb.decode_compiles)
    assert (tb.group_admits, tb.bucket_hist) == \
        (jb.group_admits, jb.bucket_hist)
    return tb, to


@pytest.mark.parametrize("decode_mode", ["ring", "uniform"])
def test_hymba_batcher_matches_reference(decode_mode, rng):
    """Hymba (global + SWA + SSM layers): prompts that cross the K-extent
    ladder; the port's ring decode runs through the kernels' wrappers
    (their plain versions on the CPU)."""
    jc, tc, jp, tp = _both("hymba-1.5b", seed=8)
    prompts = _prompts(rng, jc.vocab_size, (3, 9, 21, 5))
    max_new = (20, 12, 30, 6)
    tb, to = _serve_both(jc, tc, jp, tp, prompts, max_new, max_slots=2,
                         max_len=64, min_bucket=4, decode_mode=decode_mode)
    assert tb.decode_kernel == ("cuda" if decode_mode == "ring" else "eager")
    if decode_mode == "ring":
        assert tb.decode_buckets == (4, 8, 16, 32, 64)
        assert 2 <= tb.decode_compiles <= len(tb.decode_buckets)
    for rid, (p, m) in enumerate(zip(prompts, max_new)):
        assert to[rid] == generate_single(tp, tc, p, m, max_len=64)


@pytest.mark.parametrize("arch", ["gemma3-12b", "mamba2-130m"])
def test_dense_and_ssm_batchers_match_reference(arch, rng):
    jc, tc, jp, tp = _both(arch)
    prompts = _prompts(rng, jc.vocab_size, (5, 9, 3, 7))
    max_new = (6, 4, 8, 5)
    for mode in ("ring", "uniform"):
        _, to = _serve_both(jc, tc, jp, tp, prompts, max_new, max_slots=2,
                            max_len=64, min_bucket=4, decode_mode=mode)
    for rid, (p, m) in enumerate(zip(prompts, max_new)):
        assert to[rid] == generate_single(tp, tc, p, m, max_len=64)


def test_ring_wraps_past_a_small_window(rng):
    """Generations far past W = 8: the ring wraps (slot reuse, an install
    gathering only the last W prompt tokens) and still equals uniform
    decode, the reference and generate_single."""
    kw = dict(name="tiny-swa", family="dense", num_layers=2, d_model=64,
              num_heads=2, num_kv_heads=2, d_ff=128, vocab_size=256,
              sliding_window=8, global_every=2)
    from repro.types import ModelConfig as JConfig
    jc, tc, jp, tp = _both(None, seed=12, cfgs=(JConfig(**kw), TConfig(**kw)))
    prompts = _prompts(rng, 256, (3, 17))
    outs = {}
    for mode, kern in (("ring", "cuda"), ("ring", "eager"),
                       ("uniform", "eager")):
        tb = TBatcher(tp, tc, max_slots=2, max_len=64, min_bucket=4,
                      decode_mode=mode, decode_kernel=kern)
        outs[mode, kern] = _run(tb, prompts, (30, 30))
    assert len(set(map(str, outs.values()))) == 1
    jo = _run(JBatcher(jp, jc, max_slots=2, max_len=64, min_bucket=4),
              prompts, (30, 30))
    assert outs["ring", "cuda"] == jo
    for rid, p in enumerate(prompts):
        assert jo[rid] == generate_single(tp, tc, p, 30, max_len=64)


def test_bucketed_and_per_length_admission(rng):
    """16 requests of 8 distinct lengths: bucketed prefill runs at most
    len(buckets) shapes, the per-length oracle one per distinct length,
    both as many as the reference's, and the tokens agree."""
    jc, tc, jp, tp = _both("gemma3-12b", seed=3)
    prompts = _prompts(rng, jc.vocab_size, [3, 4, 5, 7, 9, 12, 17, 23] * 2)
    outs = {}
    for mb in (4, 0):
        tb, outs[mb] = _serve_both(jc, tc, jp, tp, prompts, [4] * 16,
                                   max_slots=4, max_len=64, min_bucket=mb)
        if mb:
            assert tb.buckets == (4, 8, 16, 32, 64)
            assert tb.prefill_compiles <= len(tb.buckets)
            assert any(size > 1 for size in tb.group_admits)
        else:
            assert tb.prefill_compiles == 8
            assert set(tb.group_admits) == {1}
    assert outs[4] == outs[0]


def test_submit_rejects_bad_requests_and_keeps_serving(rng):
    jc, tc, jp, tp = _both("mamba2-130m", seed=9)
    prompt = _prompts(rng, jc.vocab_size, (5,))[0]
    srv = TBatcher(tp, tc, max_slots=2, max_len=32)
    good = srv.submit(prompt, max_new=4)
    srv.step()                                   # in flight
    for bad, kw, match in (
            (_prompts(rng, jc.vocab_size, (30,))[0], {"max_new": 8},
             "too long"),
            (np.zeros((0,), np.int32), {"max_new": 4}, "empty"),
            (np.zeros((2, 3), np.int32), {"max_new": 4}, "1-D"),
            (np.int32(7), {"max_new": 4}, "1-D"),
            (prompt, {"max_new": 0}, "max_new")):
        with pytest.raises(ValueError, match=match):
            srv.submit(bad, **kw)
    done = srv.run()
    assert [r.rid for r in done] == [good]
    assert done[0].out == generate_single(tp, tc, prompt, 4, max_len=32)
    for kw in ({"decode_mode": "paged"}, {"decode_kernel": "pallas"}):
        with pytest.raises(ValueError):
            TBatcher(tp, tc, **kw)


def test_early_retirement_and_run_exhaustion(rng):
    """max_new = 1 and eos retire before decode overshoots; run() out of
    iterations warns, keeps the rest in pending(), and resumes."""
    jc, tc, jp, tp = _both("mamba2-130m", seed=11)
    prompts = _prompts(rng, jc.vocab_size, (4, 6, 5))
    for mb in (8, 0):
        srv = TBatcher(tp, tc, max_slots=2, max_len=32, min_bucket=mb)
        srv.submit(prompts[0], max_new=1)
        assert srv.run()[0].out == generate_single(tp, tc, prompts[0], 1,
                                                   max_len=32)
    ref = generate_single(tp, tc, prompts[0], 8, max_len=32)
    srv = TBatcher(tp, tc, max_slots=1, max_len=32)
    srv.submit(prompts[0], max_new=8, eos_id=int(ref[2]))
    out = srv.run()[0].out
    assert out[-1] == ref[2] and len(out) <= 8
    srv = TBatcher(tp, tc, max_slots=1, max_len=32)
    for p in prompts:
        srv.submit(p, max_new=6)
    with pytest.warns(RuntimeWarning, match="exhausted"):
        done = srv.run(max_iters=2)
    assert len(done) < 3 and len(done) + len(srv.pending()) == 3
    done = srv.run()
    assert len(done) == 3 and srv.pending() == []
    for req, p in zip(done, prompts):
        assert req.out == generate_single(tp, tc, p, 6, max_len=32)


def test_ring_install_zeroes_unwritten_slots(rng):
    """A P < W prompt leaves never-written ring slots: install makes them
    exactly zero, as the reference's does."""
    jc, tc, jp, tp = _both("gemma3-12b")
    P = 3
    prompt = _prompts(rng, jc.vocab_size, (P,))[0]
    caches = []
    for B, params, cfg in ((JBatcher, jp, jc), (TBatcher, tp, tc)):
        srv = B(params, cfg, max_slots=1, max_len=32, min_bucket=4)
        srv.submit(prompt, max_new=2)
        srv._admit()                              # install, no decode
        caches.append({k: np.asarray(v) for k, v in srv.cache.items()})
    W = caches[1]["k_win"].shape[2]
    unwritten = tlm.ring_source_positions(P - 1, W).numpy() < 0
    assert unwritten.any()
    for key in ("k_win", "v_win"):
        buf = caches[1][key][:, 0]
        assert (buf[:, unwritten] == 0).all()
        assert np.abs(buf[:, ~unwritten]).max() > 0
        np.testing.assert_allclose(caches[1][key], caches[0][key],
                                   rtol=1e-4, atol=1e-5)


def test_bucket_helpers_and_shape_counts_match():
    for P, mb, ml in ((1, 8, 64), (9, 8, 64), (64, 8, 64), (40, 4, 48),
                      (3, 0, 16)):
        assert tcc.bucket_for(P, mb, ml) == jcc.bucket_for(P, mb, ml)
    for mb, ml in ((8, 64), (4, 48), (1, 1), (0, 17)):
        assert tcc.bucket_ladder(mb, ml) == jcc.bucket_ladder(mb, ml)
    assert [tcc.next_pow2(n) for n in (1, 2, 3, 1025)] == [1, 2, 4, 2048]
    for bad in ((0, 8, 64), (65, 8, 64)):
        with pytest.raises(ValueError):
            tcc.bucket_for(*bad)
    sc = tcc.ShapeCache()
    t = torch.zeros
    sc.call("prefill", lambda a: a, (t(2, 8),))
    sc.call("prefill", lambda a: a, (t(2, 8),))
    sc.call("prefill", lambda a: a, (t(2, 16),))
    sc.call(("decode", 8), lambda a, b: a, ({"k": t(1)}, 3))
    sc.call(("decode", 16), lambda a, b: a, ({"k": t(1)}, 3))
    assert (sc.count("prefill"), sc.count("decode"), sc.num_compiled) == \
        (2, 2, 4)


def test_serve_cli_on_cpu(capsys):
    from repro_torch.launch import serve
    before = (decode_attend.ring_decode_attend.launches,
              ssd_decode.ssd_decode_step.launches)
    assert serve.main(["--arch", "hymba-1.5b", "--reduced", "--continuous",
                       "--device", "cpu", "--requests", "5",
                       "--prompt-len", "12", "--gen", "6"]) == 0
    out = capsys.readouterr().out
    assert "served 5 requests" in out and "kernel cuda" in out
    assert (decode_attend.ring_decode_attend.launches,
            ssd_decode.ssd_decode_step.launches) == before
    # without --continuous: the static-batch path, ported since; a clip
    # classifier is still refused
    assert serve.main(["--arch", "hymba-1.5b", "--reduced", "--device",
                       "cpu", "--batch", "2", "--prompt-len", "8",
                       "--gen", "3"]) == 0
    assert "sample generations" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        serve.main(["--arch", "resnet3d-18", "--reduced", "--device", "cpu"])
    cfg = dataclasses.replace(tcfg.get_config("hymba-1.5b").reduced(),
                              prefix_len=4)
    with pytest.raises(ValueError, match="prefix"):
        TBatcher({"embed": torch.zeros(1)}, cfg)

"""The port's LM data and specs against the reference: the Markov token
stream and ``synth_batch`` byte for byte, ``batch_spec`` / ``decode_spec``
shapes and dtypes, ``ShapeConfig`` / ``SHAPES`` / ``list_archs`` /
``shape_supported`` equal, and the LM configs the port runs equal."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

import repro.configs as jcfg
import repro.data as jdata
import repro.types as jtypes
from repro.models import registry as jreg
import repro_torch.configs as tcfg
import repro_torch.data as tdata
import repro_torch.types as ttypes
from repro_torch.models import registry as treg

LM_ARCHS = ("hymba-1.5b", "mamba2-130m", "gemma3-12b")
_DT = {jnp.dtype(jnp.int32): torch.int32, jnp.dtype(jnp.float32): torch.float32,
       jnp.dtype(jnp.bfloat16): torch.bfloat16}


def _batches_equal(xs, ys):
    xs, ys = list(xs), list(ys)
    assert len(xs) == len(ys) > 0
    for x, y in zip(xs, ys):
        assert x.keys() == y.keys() == {"tokens", "labels"}
        for k in x:
            assert x[k].dtype == y[k].dtype == np.int32
            assert x[k].tobytes() == y[k].tobytes(), k


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_configs_equal(arch):
    a, b = jcfg.get_config(arch), tcfg.get_config(arch)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert dataclasses.asdict(a.reduced()) == dataclasses.asdict(b.reduced())


@pytest.mark.parametrize("vocab,seq_len,seed", [(512, 64, 1), (97, 13, 4)])
def test_markov_stream_and_loader_byte_identical(vocab, seq_len, seed):
    ja = jdata.SyntheticLMDataset(vocab=vocab, seq_len=seq_len, seed=seed)
    ta = tdata.SyntheticLMDataset(vocab=vocab, seq_len=seq_len, seed=seed)
    assert ja.T.tobytes() == ta.T.tobytes()
    assert not hasattr(ta, "__len__")
    _batches_equal(ja.batches(3, 2, seed=5), ta.batches(3, 2, seed=5))
    jl = jdata.BatchLoader(ja, 2, steps=3, seed=7)
    tl = tdata.BatchLoader(ta, 2, steps=3, seed=7)
    for _ in range(2):                     # each call is a new local epoch
        _batches_equal(jl(), tl())


def test_make_dataset_for_lm_branch():
    cfg = jcfg.get_config("mamba2-130m").reduced()
    ja = jdata.make_dataset_for(cfg, small=True, seed=2)
    ta = tdata.make_dataset_for(tcfg.get_config("mamba2-130m").reduced(),
                                small=True, seed=2)
    assert isinstance(ta, tdata.SyntheticLMDataset)
    assert (ta.vocab, ta.seq_len, ta.seed) == (ja.vocab, ja.seq_len, ja.seed)
    assert ta.T.tobytes() == ja.T.tobytes()
    _batches_equal(ja.batches(2, 2, seed=0), ta.batches(2, 2, seed=0))


def test_shapes_and_archs_equal():
    assert tcfg.list_archs() == jcfg.list_archs()
    assert tcfg.SHAPES.keys() == jcfg.SHAPES.keys()
    for name, s in jcfg.SHAPES.items():
        t = tcfg.SHAPES[name]
        assert dataclasses.asdict(t) == dataclasses.asdict(s)
        assert t.is_decode == s.is_decode
    s = jtypes.ShapeConfig("x", seq_len=8, global_batch=2, kind="train")
    t = ttypes.ShapeConfig("x", seq_len=8, global_batch=2, kind="train")
    assert dataclasses.asdict(s) == dataclasses.asdict(t)
    assert hash(t) == hash(ttypes.ShapeConfig("x", 8, 2, "train"))


def test_shape_supported_equal():
    for arch in LM_ARCHS + ("resnet3d-18",):
        for name in jcfg.SHAPES:
            assert (tcfg.shape_supported(tcfg.get_config(arch),
                                         tcfg.SHAPES[name])
                    == jcfg.shape_supported(jcfg.get_config(arch),
                                            jcfg.SHAPES[name])), (arch, name)


def test_unported_archs_still_raise_naming_the_item():
    """Every assigned arch is ported now: each resolves to the reference's
    config, and a name the registry does not know raises, listing the
    known ones."""
    for arch in tcfg.list_archs():
        assert dataclasses.asdict(tcfg.get_config(arch)) == \
            dataclasses.asdict(jcfg.get_config(arch))
    with pytest.raises(KeyError, match="known"):
        tcfg.get_config("llama4-maverick")


@pytest.mark.parametrize("arch,reduced", [("hymba-1.5b", False),
                                          ("mamba2-130m", False),
                                          ("gemma3-12b", True),
                                          ("resnet3d-18", True)])
def test_specs_match_reference(arch, reduced):
    jc, tc = jcfg.get_config(arch), tcfg.get_config(arch)
    if reduced:
        jc, tc = jc.reduced(), tc.reduced()
    js = jtypes.ShapeConfig("s", seq_len=48, global_batch=3, kind="train")
    ts = ttypes.ShapeConfig("s", seq_len=48, global_batch=3, kind="train")
    want, got = jreg.batch_spec(jc, js), treg.batch_spec(tc, ts)
    assert list(got) == list(want)
    for k in want:
        assert got[k].device.type == "meta"
        assert tuple(got[k].shape) == want[k].shape
        assert got[k].dtype == _DT[jnp.dtype(want[k].dtype)]
    if tc.family == "resnet3d":
        return
    jt, jcache, _ = jreg.decode_spec(jc, js)
    tt, tcache, tpos = treg.decode_spec(tc, ts)
    assert tuple(tt.shape) == jt.shape and tt.dtype == torch.int32
    assert tpos.shape == (3,) and tpos.dtype == torch.int32   # per-row
    assert set(tcache) == set(jcache)
    for k in jcache:
        assert tcache[k].device.type == "meta"
        assert tuple(tcache[k].shape) == jcache[k].shape
        assert tcache[k].dtype == _DT[jnp.dtype(jcache[k].dtype)]


@pytest.mark.parametrize("arch,reduced", [("hymba-1.5b", False),
                                          ("mamba2-130m", False),
                                          ("gemma3-12b", False),
                                          ("resnet3d-18", True)])
def test_synth_batch_byte_identical(arch, reduced):
    jc, tc = jcfg.get_config(arch), tcfg.get_config(arch)
    if reduced:
        jc, tc = jc.reduced(), tc.reduced()
    js = jtypes.ShapeConfig("s", seq_len=32, global_batch=2, kind="decode")
    ts = ttypes.ShapeConfig("s", seq_len=32, global_batch=2, kind="decode")
    want = jreg.synth_batch(np.random.default_rng(11), jc, js)
    got = treg.synth_batch(np.random.default_rng(11), tc, ts, device="cpu")
    assert list(got) == list(want)
    for k in want:
        assert got[k].device.type == "cpu"
        w = np.asarray(want[k])
        g = got[k].numpy()
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes(), k
    if tc.family != "resnet3d":
        assert int(got["tokens"].max()) < tc.vocab_size


def test_encdec_spec_raises_naming_the_item():
    """The encoder-decoder's specs are ported: a source of S - S // 2
    frames and S // 2 target tokens for training, as the reference's
    (tests/test_torch_encdec.py holds the rest)."""
    cfg = dataclasses.replace(tcfg.get_config("gemma3-12b"), family="encdec")
    jc = dataclasses.replace(jcfg.get_config("gemma3-12b"), family="encdec")
    s = ttypes.ShapeConfig("s", seq_len=9, global_batch=1, kind="train")
    js = jtypes.ShapeConfig("s", seq_len=9, global_batch=1, kind="train")
    got, want = treg.batch_spec(cfg, s), jreg.batch_spec(jc, js)
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: v.shape for k, v in want.items()}
    assert tuple(got["src_embeds"].shape) == (1, 5, cfg.d_model)
    b = treg.synth_batch(np.random.default_rng(0), cfg, s, device="cpu")
    assert b["tokens"].shape == (1, 4)

"""The port's LM partition rules (``repro_torch/sharding/specs.py``) equal
the reference's (``repro/sharding/specs.py``) leaf for leaf: every param
of the ten assigned LM configs at full shape, on the single-pod (16, 16)
``("data", "model")`` and the multi-pod (2, 16, 16) ``("pod", "data",
"model")`` meshes, with fsdp on and off; the batch specs at train_4k and
an odd batch; the cache and token specs at decode_32k (B 128), long_500k
(B 1) and an odd batch, uniform and ring caches. No devices: the
reference's side is ``jax.eval_shape`` on an ``AbstractMesh``, the
port's ``checkpoint/convert.py::_shapes`` and meta tensors on a
``MeshShape``. Then the placements ``named`` gives."""
import pytest

torch = pytest.importorskip("torch")

import jax
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as JP

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget
from repro.models import registry as jreg
from repro.sharding import specs as jspecs
from repro_torch.checkpoint.convert import _shapes
from repro_torch.configs import ASSIGNED_ARCHS
from repro_torch.configs import get_config as tget
from repro_torch.models import registry as treg
from repro_torch.sharding import specs as tspecs
from repro_torch.types import ShapeConfig as TShape
from repro.types import ShapeConfig as JShape

MESHES = {"pod": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model"))}


def _meshes(name):
    shape, names = MESHES[name]
    return AbstractMesh(shape, names), tspecs.MeshShape(shape, names)


def _flat(tree, is_leaf=None) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): leaf for path, leaf in flat}


def _jspecs(tree) -> dict:
    return {k: tuple(v) for k, v in
            _flat(tree, is_leaf=lambda x: isinstance(x, JP)).items()}


def _same(got: dict, want: dict, what: str):
    assert set(got) == set(want), what
    for k in want:
        assert tuple(got[k]) == want[k], (what, k, got[k], want[k])


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_param_specs_equal_the_reference(arch):
    jc, tc = jget(arch), tget(arch)
    shapes = jax.eval_shape(
        lambda: jreg.init_params(jax.random.PRNGKey(0), jc))
    assert {k: tuple(v.shape) for k, v in _flat(shapes).items()} == \
        _shapes(tc)
    for mesh in MESHES:
        jm, tm = _meshes(mesh)
        for fsdp in (True, False):
            _same(tspecs.param_pspecs(tm, tc, _shapes(tc), fsdp=fsdp),
                  _jspecs(jspecs.param_pspecs(jm, jc, shapes, fsdp=fsdp)),
                  f"{arch} {mesh} fsdp={fsdp}")


def _cache_cases(jc, tc):
    """(what, B, reference cache shapes, port meta cache) at decode_32k,
    long_500k where the arch runs it, and an odd batch; uniform and, for
    the configs with SWA layers, ring."""
    out = []
    for name, B in (("decode_32k", None), ("long_500k", None),
                    ("decode_32k", 3)):
        s = JSHAPES[name]
        if name == "long_500k" and not tc.sub_quadratic:
            continue
        B = B or s.global_batch
        S = s.seq_len
        out.append((f"{name} B{B}", B,
                    jax.eval_shape(lambda: jreg.init_cache(jc, B, S)),
                    treg.init_cache(tc, B, S, device="meta")))
        if not tc.is_encdec and any(tc.window_for_layer(i)
                                    for i in range(tc.num_layers)):
            out.append((f"{name} B{B} ring", B,
                        jax.eval_shape(lambda: jreg.init_ring_cache(
                            jc, B, S)),
                        treg.init_ring_cache(tc, B, S, device="meta")))
    return out


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_batch_cache_and_token_specs_equal_the_reference(mesh):
    jm, tm = _meshes(mesh)
    for arch in ASSIGNED_ARCHS:
        jc, tc = jget(arch), tget(arch)
        for B in (256, 3):
            jb = jreg.batch_spec(jc, JShape("t", 4096, B, "train"))
            tb = treg.batch_spec(tc, TShape("t", 4096, B, "train"))
            _same(tspecs.batch_pspecs(tm, tc, tb),
                  _jspecs(jspecs.batch_pspecs(jm, jc, jb)),
                  f"{arch} {mesh} batch B{B}")
        for what, B, jcache, tcache in _cache_cases(jc, tc):
            assert {k: tuple(v.shape) for k, v in jcache.items()} == \
                {k: tuple(v.shape) for k, v in tcache.items()}, what
            _same(tspecs.cache_pspecs(tm, tc, tcache, B),
                  _jspecs(jspecs.cache_pspecs(jm, jc, jcache, B)),
                  f"{arch} {mesh} cache {what}")
            assert tuple(tspecs.token_pspec(tm, B)) == tuple(
                jspecs.token_pspec(jm, B)), (mesh, B)


def test_named_placements():
    from torch.distributed.tensor import Replicate, Shard
    _, tm = _meshes("multipod")
    P = tspecs.P
    assert tspecs.named(tm, P(None, ("pod", "data"), "model")) == \
        (Shard(1), Shard(1), Shard(2))
    assert tspecs.named(tm, P()) == (Replicate(),) * 3
    got = tspecs.named(tm, {"a": P("model", None), "b": None,
                            "c": (P(("data", "model")),)})
    assert got == {"a": (Replicate(), Replicate(), Shard(0)), "b": None,
                   "c": ((Replicate(), Shard(0), Shard(0)),)}
    with pytest.raises(ValueError, match="order"):
        tspecs.named(tm, P(("model", "data")))
    # every spec the rules give has its placements, on both meshes
    for mesh in MESHES:
        jm, tm = _meshes(mesh)
        for arch in ("grok-1-314b", "hymba-1.5b"):
            cfg = tget(arch)
            for k, spec in tspecs.param_pspecs(tm, cfg,
                                               _shapes(cfg)).items():
                pl = tspecs.named(tm, spec)
                assert len(pl) == len(MESHES[mesh][1])
                split = {d for d, a in enumerate(spec) if a is not None}
                assert {p.dim for p in pl if isinstance(p, Shard)} == split


def test_divisibility_guard_and_data_axes():
    _, pod = _meshes("pod")
    _, multi = _meshes("multipod")
    assert tspecs.data_axes(pod) == ("data",)
    assert tspecs.data_axes(multi) == ("pod", "data")
    assert tspecs._maybe(pod, "model", 50280) is None      # vocab 50280
    assert tspecs._maybe(multi, ("pod", "data"), 64) == ("pod", "data")
    # hymba's 25 heads of 64: wq's flat 1600 splits over 16, wk's 320 too
    spec = tspecs.param_pspecs(pod, tget("hymba-1.5b"), _shapes(
        tget("hymba-1.5b")))
    assert spec["layers/attn/wk"] == (None, "data", "model")

"""The port's roofline counter (``repro_torch/roofline/counter.py``) against
the reference's loop-aware HLO walker (``repro.roofline.hlo.analyze_hlo``)
on the jitted twin of each program, inside the windows of
``tests/test_roofline.py``; ``RooflineReport`` against the reference's
for the same numbers; and ``GraphCache.call`` refusing to run under a
counter."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

import repro.configs as jcfg
from repro.models import registry as jreg
from repro.models import resnet3d as jres
from repro.roofline.analysis import HW as JHW
from repro.roofline.analysis import RooflineReport as JReport
from repro.roofline.hlo import analyze_hlo
from repro_torch import configs as tcfg
from repro_torch.core.compile_cache import GraphCache
from repro_torch.models import registry as treg
from repro_torch.models import resnet3d as tres
from repro_torch.roofline import HW, RooflineReport, analyze_step
from repro_torch.roofline.counter import Counter

from torch_parity import jax_params_both, port_params


def _hlo(f, *args):
    return analyze_hlo(jax.jit(f).lower(*args).compile().as_text())


def _count(fn):
    with Counter() as c:
        fn()
    return c


def test_single_matmul_flops_and_bytes():
    M, K, N = 128, 512, 256
    a = jax.ShapeDtypeStruct((M, K), jnp.float32)
    b = jax.ShapeDtypeStruct((K, N), jnp.float32)
    h = _hlo(lambda a, b: a @ b, a, b)
    ta, tb = torch.randn(M, K), torch.randn(K, N)
    c = _count(lambda: ta @ tb)
    expected = 2 * M * K * N
    io_bytes = 4 * (M * K + K * N + M * N)
    for flops, nbytes in ((c.total_flops, c.bytes), (h.flops, h.bytes)):
        assert 0.95 * expected < flops < 1.2 * expected
        assert nbytes >= io_bytes * 0.9
    assert c.total_flops == expected and c.bytes == io_bytes
    assert 0.95 < c.total_flops / h.flops < 1.2


def test_loop_trip_count_multiplies_flops():
    """A Python loop of 12 products under the counter against
    ``lax.scan(length=12)``: the trip count multiplies by construction."""
    N, T = 256, 12
    a = jax.ShapeDtypeStruct((N, N), jnp.float32)

    def g(a, b):
        def body(x, _):
            return x @ b, None
        return jax.lax.scan(body, a, None, length=T)[0]

    h = _hlo(g, a, a)
    x, w = torch.randn(N, N), torch.randn(N, N)

    def loop():
        y = x
        for _ in range(T):
            y = y @ w
        return y

    with Counter(loops=[("body", T)]) as c:
        loop()
    expected = T * 2 * N ** 3
    for flops in (c.total_flops, h.flops):
        assert 0.9 * expected < flops < 1.3 * expected
    assert any(trip == T for _, trip in h.loops)
    assert c.loops == [("body", T)]
    assert 0.9 < c.total_flops / h.flops < 1.3


def test_nested_loops_multiply():
    N, T1, T2 = 64, 5, 7
    a = jax.ShapeDtypeStruct((N, N), jnp.float32)

    def g(a, b):
        def outer(x, _):
            def inner(y, _):
                return y @ b, None
            return jax.lax.scan(inner, x, None, length=T2)[0], None
        return jax.lax.scan(outer, a, None, length=T1)[0]

    h = _hlo(g, a, a)
    x, w = torch.randn(N, N), torch.randn(N, N)

    def loops():
        y = x
        for _ in range(T1):
            for _ in range(T2):
                y = y @ w
        return y

    c = _count(loops)
    expected = T1 * T2 * 2 * N ** 3
    for flops in (c.total_flops, h.flops):
        assert 0.9 * expected < flops < 1.4 * expected
    assert 0.9 < c.total_flops / h.flops < 1.4


def test_slice_update_counted_as_update_not_buffer():
    """100 in-place copies of one row into a 64 MiB buffer move the rows,
    as the reference's dynamic-update-slice rule counts them."""
    big = jax.ShapeDtypeStruct((4096, 4096), jnp.float32)
    small = jax.ShapeDtypeStruct((1, 4096), jnp.float32)

    def g(buf, upd):
        def body(b, i):
            return jax.lax.dynamic_update_slice(b, upd, (i, 0)), None
        return jax.lax.scan(body, buf, jnp.arange(100))[0]

    h = _hlo(g, big, small)
    buf, upd = torch.zeros(4096, 4096), torch.randn(1, 4096)

    def updates():
        for i in range(100):
            buf[i:i + 1].copy_(upd)

    c = _count(updates)
    for nbytes in (c.bytes, h.bytes):
        assert nbytes < 50 * 64 * 2 ** 20
    assert c.bytes == 100 * 2 * 4096 * 4       # each row read and written


def test_conv3d_at_the_resnet3d_stem():
    """ResNet3D's stem (3x7x7, 3 -> 64 channels, stride 2, SAME) on the
    main path's clips (batch 4 of 4x16x16): 2·|out|·(Cin·kd·kh·kw)."""
    B, T, S, C, W0 = 4, 4, 16, 3, 64
    x = jax.ShapeDtypeStruct((B, T, S, S, C), jnp.float32)
    w = jax.ShapeDtypeStruct((3, 7, 7, C, W0), jnp.float32)
    h = _hlo(lambda x, w: jres._conv3d(x, w, stride=2), x, w)
    tx, tw = torch.randn(B, C, T, S, S), torch.randn(W0, C, 3, 7, 7)
    c = _count(lambda: tres._conv3d(tx, tw, stride=2))
    expected = 2 * (B * W0 * 2 * 8 * 8) * (C * 3 * 7 * 7)
    # the product in cuDNN's class (TF32 on by default), the SAME padding's
    # copy 1 flop an element beside it
    assert c.flops["tf32"] == expected
    assert 0.95 * expected < c.total_flops < 1.2 * expected
    assert 0.95 * expected < h.flops < 1.2 * expected
    assert 0.95 < c.total_flops / h.flops < 1.2


def test_reduced_dense_lm_forward():
    """The reduced Gemma3 logits (B 2 x S 128) counted eagerly against the
    reference's compiled, layer-scanned forward: the port's flops are
    0.990 of the HLO walker's, its bytes 1.93x (every eager op reads and
    writes HBM, where XLA's fusions keep their insides on chip). The flops
    window is the nested-loop test's."""
    jc = jcfg.get_config("gemma3-12b").reduced()
    tc = tcfg.get_config("gemma3-12b").reduced()
    jp, flat = jax_params_both(jc, jax.random.PRNGKey(0))
    tp = port_params(flat, tc)
    toks = np.random.default_rng(0).integers(0, jc.vocab_size, (2, 128),
                                             dtype=np.int32)
    h = _hlo(lambda p, t: jreg.logits_fn(p, jc, {"tokens": t}), jp,
             jnp.asarray(toks))
    with torch.no_grad():
        c = _count(lambda: treg.logits_fn(tp, tc,
                                          {"tokens": torch.tensor(toks)}))
    ratio = c.total_flops / h.flops
    assert 0.9 < ratio < 1.4, ratio
    assert 1.0 < c.bytes / h.bytes < 4.0, c.bytes / h.bytes


def test_report_terms_equal_the_reference():
    """The reference's report numbers with an ``HW`` of the same figures
    (all flops in the model's one class): every property alike."""
    nums = dict(arch="x", shape="train_4k", mesh="pod", chips=256,
                flops_per_device=197e12, bytes_per_device=819e9 * 2,
                collective_bytes=50e9 * 0.5,
                collectives={"all-gather": 50e9 * 0.5},
                peak_memory_bytes=8e9, model_flops_global=197e12 * 256 * 0.25)
    ref = JReport(**nums, hw=JHW())
    hw = HW(hbm_bw=819e9, hbm_bytes=16e9, f32_flops=197e12, link_bw=50e9)
    rep = RooflineReport(**nums, hw=hw, model_precision="f32")
    for prop in ("compute_s", "memory_s", "collective_s", "dominant",
                 "step_time_s", "useful_flop_ratio", "mfu"):
        assert getattr(rep, prop) == getattr(ref, prop), prop
    d, rd = rep.to_dict(), ref.to_dict()
    for key in ("compute_s", "memory_s", "collective_s", "dominant",
                "step_time_s", "useful_flop_ratio", "mfu", "collectives",
                "peak_memory_bytes", "model_flops_global"):
        assert d[key] == rd[key], key


def test_compute_prices_each_class_at_its_peak():
    hw = HW()
    rep = RooflineReport(
        arch="x", shape="s", mesh="m", chips=1, flops_per_device=3e12,
        bytes_per_device=0.0, collective_bytes=0.0, collectives={},
        peak_memory_bytes=0.0, model_flops_global=1e12,
        flops_by_class={"f32": 1e12, "tf32": 1e12, "3xtf32": 1e12},
        measured_s=0.5)
    want = 1e12 / 67e12 + 1e12 / 495e12 + 3e12 / 495e12
    assert rep.compute_s == pytest.approx(want, rel=1e-12)
    assert rep.dominant == "compute"
    assert rep.mfu == pytest.approx(1e12 / (0.5 * 67e12))
    assert rep.roofline_share == pytest.approx(want / 0.5)
    assert set(rep.to_dict()["flops_by_class"]) == {"f32", "tf32", "3xtf32"}


def test_analyze_step_counts_tf32_convolutions_and_peak_memory():
    """One call through ``analyze_step``: a product in f32 (cuBLAS's TF32
    off) and a convolution in TF32 (cuDNN's on), each in its class, and
    the watched input plus the outputs in the peak."""
    a, b = torch.randn(64, 64), torch.randn(64, 64)
    x, w = torch.randn(1, 2, 4, 8, 8), torch.randn(4, 2, 1, 1, 1)

    def step():
        return a @ b, torch.nn.functional.conv3d(x, w)

    _, rep = analyze_step(step, arch="t", shape="s", mesh_name="none",
                          chips=1, model_flops_global=2 * 64 ** 3,
                          watch=(a, b, x, w))
    assert rep.flops_by_class["f32"] == 2 * 64 ** 3
    assert rep.flops_by_class["tf32"] == 2 * (4 * 4 * 8 * 8) * 2
    held = 4 * (2 * 64 * 64 + 2 * 4 * 64 + 4 * 2) + 4 * (64 * 64 + 4 * 256)
    assert rep.peak_memory_bytes == held


def test_graph_cache_call_under_a_counter_raises():
    graphs = GraphCache()
    x = torch.ones(3)
    assert graphs.call("f", lambda t: t + 1, (x,)).tolist() == [2.0] * 3
    with Counter(), pytest.raises(RuntimeError, match="eager run"):
        graphs.call("f", lambda t: t + 1, (x,))

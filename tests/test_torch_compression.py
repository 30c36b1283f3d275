"""The port's wire codec (``repro_torch.core.compression``) against the
reference's (``repro.core.compression``) on the CPU.

On the same f32 inputs the int8 / int4 codes are bit-equal to the
reference's (rounding half to even on both sides) and the scales equal
to the bit; the byte counts equal the reference's to the byte. The
properties of ``tests/test_properties.py`` (error bound ≤ scale/2, a zero
delta exact, bf16 kept, the int4 packing round trip and its accounting,
bad widths refused) hold on the port, Hypothesis with ``deadline=None``
and a few examples each."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import compression as jc
from repro_torch.core import compression as tc


def _trees(seed, scale=1.0, shapes=((5,), (3, 7), (2, 3, 4))):
    """The same f32 (w_new, anchor) for both packages; the anchor is
    nonzero so that the delta's subtraction is exercised too."""
    r = np.random.default_rng(seed)
    w = {f"l{i}": (r.standard_normal(s) * scale).astype(np.float32)
         for i, s in enumerate(shapes)}
    a = {k: (r.standard_normal(v.shape) * scale).astype(np.float32)
         for k, v in w.items()}
    j = ({k: jnp.asarray(v) for k, v in w.items()},
         {k: jnp.asarray(v) for k, v in a.items()})
    t = ({k: torch.tensor(v) for k, v in w.items()},
         {k: torch.tensor(v) for k, v in a.items()})
    return j, t


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_delta_bit_equal_to_reference(bits, seed):
    (jw, ja), (tw, ta) = _trees(seed, scale=10.0 ** (seed - 1))
    want = jc.quantize_delta(jw, ja, bits)
    got = tc.quantize_delta(tw, ta, bits)
    assert (got.base_bytes, got.wire_bytes, got.bits) == \
        (want.base_bytes, want.wire_bytes, want.bits)
    for k in jw:
        assert got.q[k].dtype == torch.int8
        np.testing.assert_array_equal(got.q[k].numpy(),
                                      np.asarray(want.q[k]))
        assert got.scale[k].numpy().tobytes() == \
            np.asarray(want.scale[k], np.float32).tobytes()
    deq_j = jc.dequantize_delta(want, ja)
    deq_t = tc.dequantize_delta(got, ta)
    for k in jw:
        np.testing.assert_array_equal(deq_t[k].numpy(), np.asarray(deq_j[k]))
    assert tc.compression_ratio(got) == jc.compression_ratio(want)


def test_rounding_is_half_to_even():
    """Deltas that land exactly on .5 quanta round to the even code, as
    ``jnp.round`` does: max |d| = 127 makes the scale 1."""
    d = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5], np.float32)
    zero = np.zeros_like(d)
    want = jc.quantize_delta({"x": jnp.asarray(d)}, {"x": jnp.asarray(zero)})
    got = tc.quantize_delta({"x": torch.tensor(d)}, {"x": torch.tensor(zero)})
    np.testing.assert_array_equal(got.q["x"].numpy(), np.asarray(want.q["x"]))
    np.testing.assert_array_equal(got.q["x"].numpy(),
                                  [127, 0, 2, 2, 0, -2, -2, 4])


def test_byte_counts_match_the_formula():
    """base = Σ numel · element size; wire = Σ packed_nbytes + 4 a leaf;
    a tuple of factors counts like a dict of leaves."""
    shapes = ((512, 400), (400,), (3, 64, 3, 3, 3))
    w = {f"l{i}": torch.randn(s) for i, s in enumerate(shapes)}
    a = {k: torch.zeros_like(v) for k, v in w.items()}
    for bits in (8, 4):
        upd = tc.quantize_delta(w, a, bits)
        n = [int(np.prod(s)) for s in shapes]
        assert upd.base_bytes == 4 * sum(n)
        assert upd.wire_bytes == sum(tc.packed_nbytes(x, bits) + 4
                                     for x in n)
        fac = tuple(w.values())
        fupd = tc.quantize_delta(fac, tuple(a.values()), bits)
        assert (fupd.base_bytes, fupd.wire_bytes) == (upd.base_bytes,
                                                      upd.wire_bytes)
    assert tc.packed_nbytes(7, 4) == 4 and tc.packed_nbytes(7, 8) == 7


@given(seed=st.integers(0, 2**31 - 1), bits=st.sampled_from([4, 8]),
       size=st.integers(1, 33), scale=st.floats(1e-4, 10.0))
@settings(max_examples=15, deadline=None)
def test_quantize_delta_error_bound(seed, bits, size, scale):
    r = np.random.default_rng(seed)
    w = {"a": torch.tensor(r.standard_normal(size) * scale,
                           dtype=torch.float32),
         "b": torch.tensor(r.standard_normal((3, size)) * scale,
                           dtype=torch.float32)}
    anchor = {k: torch.zeros_like(v) for k, v in w.items()}
    upd = tc.quantize_delta(w, anchor, bits)
    assert upd.bits == bits
    deq = tc.dequantize_delta(upd, anchor)
    for k in w:
        err = float((w[k] - deq[k]).abs().max())
        assert err <= float(upd.scale[k]) / 2 + 1e-7


@pytest.mark.parametrize("bits", [4, 8])
def test_zero_delta_exact_and_bf16_kept(bits):
    w = {"x": torch.linspace(-1.0, 1.0, 17)}
    out, upd = tc.roundtrip(w, w, bits)
    assert not upd.q["x"].any()
    assert torch.equal(out["x"], w["x"])
    anchor = {"w": torch.randn(17, generator=torch.Generator()
                               .manual_seed(bits)).to(torch.bfloat16)}
    w = {"w": anchor["w"] + torch.tensor(0.25, dtype=torch.bfloat16)}
    out, _ = tc.roundtrip(w, anchor, bits)
    assert out["w"].dtype == torch.bfloat16
    jout, _ = jc.roundtrip({"w": jnp.asarray(w["w"].float().numpy(),
                                             jnp.bfloat16)},
                           {"w": jnp.asarray(anchor["w"].float().numpy(),
                                             jnp.bfloat16)}, bits)
    np.testing.assert_array_equal(out["w"].float().numpy(),
                                  np.asarray(jout["w"], np.float32))


@given(seed=st.integers(0, 2**31 - 1), size=st.integers(1, 65))
@settings(max_examples=15, deadline=None)
def test_pack_int4_roundtrip(seed, size):
    r = np.random.default_rng(seed)
    q = r.integers(-7, 8, size=size).astype(np.int8)
    packed = tc.pack_int4(q)
    assert packed.nbytes == tc.packed_nbytes(size, 4)
    np.testing.assert_array_equal(packed, jc.pack_int4(q))
    assert (tc.unpack_int4(packed, size) == q).all()


def test_quantize_delta_rejects_bad_bits():
    w = {"x": torch.ones(3)}
    for bits in (0, 2, 16):
        with pytest.raises(ValueError, match="unsupported wire width"):
            tc.quantize_delta(w, w, bits)

"""The port's int8 wire codec (``coinstac_dinunet_tpu_torch.ops.quantize``)
against the JAX package's ``ops/quantize.py``.

Contract: the scales are bit-identical to the JAX package's (numpy path and
TPU-interpreter path); the values come from a different noise stream
(Philox4x32-10 here), so they are held to distributional properties — every
value is floor or floor+1 of x/scale, within ±127, unbiased on average —
and the kernel/plain Philox stream is pinned against an independent
pure-Python Philox4x32-10.  Payloads cross between the packages both ways.
The batched entry point (one launch per payload on the card) writes the
bytes the per-leaf calls write, in the wire's data-section layout.  The
kernel's own tests are in ``test_torch_quantize_card.py``.
"""
import json

import numpy as np
import pytest
import torch

from coinstac_dinunet_tpu.ops import quantize as jq
from coinstac_dinunet_tpu.utils import tensorutils as jtu
from coinstac_dinunet_tpu_torch.ops import quantize as tq
from coinstac_dinunet_tpu_torch.utils import tensorutils as ttu
from test_torch_quantize_card import _vbm_leaves

SHAPES = [(37, 19), (256,), (23 * 128 + 17,), (1,), (3, 3, 3, 4, 8)]

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK = 0xFFFFFFFF


def philox_reference(ctr, key):
    """Philox4x32-10 in plain Python integers (Salmon et al., SC'11)."""
    c0, c1, c2, c3 = ctr
    k0, k1 = key
    for _ in range(10):
        p0, p1 = _M0 * c0, _M1 * c2
        c0, c1, c2, c3 = ((p1 >> 32) ^ c1 ^ k0, p1 & _MASK,
                          (p0 >> 32) ^ c3 ^ k1, p0 & _MASK)
        k0, k1 = (k0 + _W0) & _MASK, (k1 + _W1) & _MASK
    return [c0, c1, c2, c3]


def _x(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _port(x, seed):
    vals, scales, shape = tq.quantize_int8(torch.from_numpy(x), seed=seed)
    return vals.numpy(), scales.numpy(), shape


@pytest.mark.parametrize("shape", SHAPES)
def test_scales_bit_identical_to_jax_numpy(shape):
    x = _x(shape, seed=len(shape))
    _, s_port, shape_port = _port(x, seed=5)
    _, s_jax, shape_jax = jq.quantize_int8(x, seed=5, impl="numpy")
    assert shape_port == shape_jax
    assert s_port.dtype == s_jax.dtype == np.float32
    assert s_port.shape == s_jax.shape
    np.testing.assert_array_equal(s_port.view(np.int32), s_jax.view(np.int32))


@pytest.mark.parametrize("shape", [(256,), (23 * 128 + 17,)])
def test_scales_match_jax_pallas_interpret(shape):
    """Bit-identical on every group where the JAX package's own two paths
    agree.  They do not always: the interpreter lowers ``absmax / 127`` to
    ``absmax * (1/127)``, which is 1 ulp off the IEEE quotient on some
    groups; the port (like the numpy path) divides."""
    if not jq._HAVE_TPU_INTERPRET:
        pytest.skip("this JAX has no pltpu.InterpretParams (no CPU pltpu prng)")
    x = _x(shape, seed=2)
    _, s_port, _ = _port(x, seed=9)
    _, s_np, _ = jq.quantize_int8(x, seed=9, impl="numpy")
    _, s_pi, _ = jq.quantize_int8(x, seed=9, impl="pallas_interpret")
    port, numpy_path, interp = (np.asarray(s).view(np.int32) for s in (s_port, s_np, s_pi))
    agree = numpy_path == interp
    np.testing.assert_array_equal(port[agree], interp[agree])
    assert np.abs(port - interp).max() <= 1
    groups = np.pad(x.reshape(-1), (0, (-x.size) % 128)).reshape(-1, 128)
    recip = np.abs(groups).max(1, keepdims=True) * np.float32(1 / 127.0)
    np.testing.assert_array_equal(interp[~agree], recip.view(np.int32)[~agree])


@pytest.mark.parametrize("shape", SHAPES)
def test_values_are_floor_or_floor_plus_one(shape):
    x = _x(shape, seed=3)
    vals, scales, _ = _port(x, seed=11)
    n = x.size
    groups = np.pad(x.reshape(-1), (0, vals.size - n)).reshape(vals.shape)
    lo = np.floor(groups / scales)
    v = vals.astype(np.float32)
    assert np.all((v == lo) | (v == lo + 1))
    assert np.abs(vals.astype(np.int32)).max() <= 127
    # the zero padding of the ragged tail quantizes to exactly 0
    assert np.all(vals.reshape(-1)[n:] == 0)


def test_roundtrip_error_bounded():
    x = _x((37, 19), seed=0)
    vals, scales, shape = _port(x, seed=1)
    out = tq.dequantize_int8(vals, scales, shape)
    assert out.shape == x.shape
    assert np.abs(out - x).max() <= np.max(np.abs(x)) / 127.0 + 1e-6


def test_stochastic_rounding_unbiased():
    # mirrors tests/test_quantize.py: the mean over many seeds converges to x
    x = np.full((4, 50), 0.33, np.float32)
    acc = np.zeros_like(x)
    n = 200
    for s in range(n):
        vals, scales, shape = _port(x, seed=s)
        acc += tq.dequantize_int8(vals, scales, shape)
    one_step = np.max(np.abs(x)) / 127.0
    assert np.abs(acc / n - x).max() < one_step * 0.2


def test_plain_philox_matches_python_reference():
    # Random123's published known-answer vectors, then the codec's stream
    kat = [
        ((0, 0, 0, 0), (0, 0), [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]),
        ((_MASK,) * 4, (_MASK, _MASK), [0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD]),
        ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
         [0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1]),
    ]
    for ctr, key, want in kat:
        assert philox_reference(ctr, key) == want
        got = tq.philox4x32_10(*[torch.tensor([c], dtype=torch.int64) for c in ctr], *key)
        assert [int(w) for w in got] == want
    rows, seed = 5, 2 ** 31 - 3
    bits = tq.random_bits(rows, seed, torch.device("cpu")).numpy()
    for g in range(rows):
        for lane in range(32):
            words = philox_reference((g, lane, 0, 0), (seed, 0))
            assert list(bits[g, 4 * lane:4 * lane + 4]) == words


def test_noise_differs_across_seeds_and_array_index(tmp_path):
    b0 = tq.random_bits(4, 100, torch.device("cpu"))
    b1 = tq.random_bits(4, 101, torch.device("cpu"))
    assert not torch.equal(b0, b1)
    # save_arrays salts array i with seed + i: two identical arrays must not
    # share their rounding noise
    x = _x((8, 128), seed=6)
    p = tmp_path / "w.bin"
    ttu.save_arrays(p, [x, x], codec="int8", seed=7)
    payload = open(p, "rb").read()
    (mlen,) = np.frombuffer(payload[8:16], "<u8")
    data = payload[16 + int(mlen):]
    v0, v1 = data[:8 * 128], data[8 * 128 + 8 * 4:2 * 8 * 128 + 8 * 4]
    assert v0 != v1


def test_empty_and_large_seed():
    vals, scales, shape = tq.quantize_int8(torch.zeros((0,)))
    assert tuple(vals.shape) == (0, tq.GROUP) and tuple(scales.shape) == (0, 1)
    assert tq.dequantize_int8(vals.numpy(), scales.numpy(), shape).shape == (0,)
    vals, scales, shape = tq.quantize_int8(torch.ones((4, 4)), seed=2 ** 31 + 5)
    assert np.isfinite(tq.dequantize_int8(vals.numpy(), scales.numpy(), shape)).all()


def test_cpu_tensor_takes_plain_version_without_launching():
    before = tq.KERNEL.launches
    tq.quantize_int8(torch.randn(300))
    assert tq.KERNEL.launches == before


def _manifest(payload):
    (mlen,) = np.frombuffer(payload[8:16], "<u8")
    return json.loads(payload[16:16 + int(mlen)])


def test_payloads_cross_between_packages(tmp_path):
    rng = np.random.default_rng(3)
    arrays = [
        rng.normal(size=(33, 7)).astype(np.float32),
        np.arange(10, dtype=np.int64),
        rng.normal(size=(5,)).astype(np.float64),
    ]
    port_p, jax_p = tmp_path / "port.bin", tmp_path / "jax.bin"
    ttu.save_arrays(port_p, arrays, codec="int8", seed=4)
    jtu.save_arrays(jax_p, arrays, codec="int8", seed=4)
    m_port = _manifest(open(port_p, "rb").read())
    m_jax = _manifest(open(jax_p, "rb").read())
    assert m_port.keys() == m_jax.keys()
    assert m_port["size"] == m_jax["size"]
    assert [sorted(e) for e in m_port["e"]] == [sorted(e) for e in m_jax["e"]]
    assert [{k: v for k, v in e.items()} for e in m_port["e"]] == m_jax["e"]
    for reader, path in ((jtu.load_arrays, port_p), (ttu.load_arrays, jax_p)):
        back = reader(path)
        assert back[0].dtype == np.float32 and back[0].shape == (33, 7)
        np.testing.assert_array_equal(back[1], arrays[1])
        for a, b in zip(arrays[::2], back[::2]):
            step = np.max(np.abs(a)) / 127.0
            assert np.abs(np.asarray(b, np.float64) - a).max() <= step + 1e-9
    # scales are bit-identical, so the two payloads differ only in values
    s_port = jq.quantize_int8(arrays[0], seed=4, impl="numpy")[1]
    np.testing.assert_array_equal(_port(arrays[0], 4)[1], s_port)


def _per_leaf_bytes(leaves, seeds):
    """The data section assembled leaf by leaf with ``quantize_int8``."""
    out = b""
    for x, seed in zip(leaves, seeds):
        vals, scales, _ = tq.quantize_int8(x, seed=seed)
        out += vals.numpy().tobytes() + scales.numpy().tobytes()
    return out


def test_many_plain_equals_per_leaf_results_in_wire_order():
    leaves = _vbm_leaves()
    seeds = [2 ** 31 - 5 + i for i in range(len(leaves))]  # wraps modulo 2**31
    buf = tq.quantize_int8_many_plain(leaves, seeds)
    groups = [-(-x.numel() // tq.GROUP) for x in leaves]
    assert sum(groups) == 3423 and buf.numel() == 3423 * 132
    assert buf.numpy().tobytes() == _per_leaf_bytes(leaves, seeds)
    # on the CPU the batched entry point is the plain version
    before = tq.KERNEL.launches
    assert torch.equal(tq.quantize_int8_many(leaves, seeds), buf)
    assert tq.KERNEL.launches == before


def test_wire_layout_is_the_data_section_unpack_reads():
    leaves = [torch.from_numpy(_x(s, seed=i)) for i, s in enumerate([(3, 50), (0,), (128,), (129,)])]
    spans, total = tq.wire_layout([-(-x.numel() // tq.GROUP) for x in leaves])
    assert [(vs.start, vs.stop, ss.start, ss.stop) for vs, ss in spans] == [
        (0, 256, 256, 264), (264, 264, 264, 264), (264, 392, 392, 396), (396, 652, 652, 660)]
    assert total == 5 * 132
    assert all(sl.start % 4 == 0 for span in spans for sl in span)
    payload = ttu.pack_arrays(leaves, codec="int8", seed=21)
    size = _manifest(payload)["size"]
    data = payload[len(payload) - size:]
    assert data == tq.quantize_int8_many_plain(leaves, [21 + i for i in range(4)]).numpy().tobytes()
    for i, (x, (vs, ss), back) in enumerate(zip(leaves, spans, ttu.unpack_arrays(payload))):
        g = -(-x.numel() // tq.GROUP)
        vals = np.frombuffer(data[vs], np.int8).reshape(g, tq.GROUP)
        scales = np.frombuffer(data[ss], np.float32).reshape(g, 1)
        want_v, want_s, shape = _port(x.numpy(), 21 + i)
        np.testing.assert_array_equal(vals, want_v)
        np.testing.assert_array_equal(scales, want_s)
        np.testing.assert_array_equal(back, tq.dequantize_int8(want_v, want_s, shape))


def test_seeds_follow_payload_position_with_integer_arrays():
    x0, x2 = _x((4, 128), seed=1), _x((3, 128), seed=2)
    arrays = [x0, np.arange(7, dtype=np.int32), x2, np.array([True, False])]
    payload = ttu.pack_arrays(arrays, codec="int8", seed=40)
    data = payload[len(payload) - _manifest(payload)["size"]:]
    raw = np.arange(7, dtype=np.int32).tobytes()
    # array 2 is keyed seed + 2 (its payload position), not seed + 1 (its
    # rank among the float arrays)
    want = (_per_leaf_bytes([torch.from_numpy(x0)], [40]) + raw
            + _per_leaf_bytes([torch.from_numpy(x2)], [42]) + b"\x01\x00")
    assert data == want
    assert data != (_per_leaf_bytes([torch.from_numpy(x0)], [40]) + raw
                    + _per_leaf_bytes([torch.from_numpy(x2)], [41]) + b"\x01\x00")


def test_zero_size_leaf_in_the_middle():
    leaves = [torch.from_numpy(_x((300,), 1)), torch.zeros((0, 5)), torch.from_numpy(_x((7,), 2))]
    buf = tq.quantize_int8_many_plain(leaves, [5, 6, 7])
    assert buf.numpy().tobytes() == _per_leaf_bytes(leaves, [5, 6, 7])
    tables, total = tq._segment_tables([t.reshape(-1) for t in leaves], [5, 6, 7])
    assert total == 4 * 132
    assert [(vs.start, ss.start, seed) for _, vs, ss, seed in tables[0]] == [
        (0, 3 * 128, 5), (3 * 132, 3 * 132 + 128, 7)]
    payload = ttu.pack_arrays(leaves, codec="int8", seed=5)
    m = _manifest(payload)["e"]
    assert [e["groups"] for e in m] == [3, 0, 1]
    back = ttu.unpack_arrays(payload)
    assert back[1].shape == (0, 5) and back[2].shape == (7,)


def _emulate_kernel(tables, total):
    """What the kernel's launches write, from the plain version: each
    segment's values and scales at their offsets."""
    out = torch.zeros(total, dtype=torch.int8)
    for segs in tables:
        assert len(segs) <= tq.MAX_SEGMENTS
        for f, vs, ss, seed in segs:
            vals, scales, _ = tq.quantize_int8(f, seed)
            out[vs] = vals.reshape(-1)
            out[ss] = scales.reshape(-1).view(torch.int8)
    return out


def test_more_segments_than_one_launch_takes():
    leaves = [torch.from_numpy(_x((1 + (i * 37) % 128,), seed=i)) for i in range(200)]
    flats = [x.reshape(-1) for x in leaves]
    tables, total = tq._segment_tables(flats, [9 + i for i in range(200)])
    assert [len(t) for t in tables] == [64, 64, 64, 8]
    assert total == 200 * 132
    assert [vs.start for t in tables for _, vs, _, _ in t] == [132 * i for i in range(200)]
    assert [ss.start for t in tables for _, _, ss, _ in t] == [132 * i + 128 for i in range(200)]
    want = tq.quantize_int8_many_plain(leaves, [9 + i for i in range(200)])
    assert torch.equal(_emulate_kernel(tables, total), want)

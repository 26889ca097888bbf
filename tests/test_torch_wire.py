"""The port's COINNTW2 wire (``coinstac_dinunet_tpu_torch.utils.tensorutils``
+ ``resilience/transport.py``) against the JAX package's.

At ``codec=None`` both packages must write the same bytes for the same
arrays, and read each other's files; integrity failures raise the same
typed errors; fan-in loads are issued in sorted order.
"""
import json
import os
import struct

import numpy as np
import pytest
import torch

from coinstac_dinunet_tpu.resilience import transport as jtr
from coinstac_dinunet_tpu.utils import stable_file_id as jax_stable_file_id
from coinstac_dinunet_tpu.utils import tensorutils as jtu
from coinstac_dinunet_tpu_torch.resilience import transport as ttr
from coinstac_dinunet_tpu_torch.resilience.retry import RetryPolicy
from coinstac_dinunet_tpu_torch.utils import stable_file_id
from coinstac_dinunet_tpu_torch.utils import tensorutils as ttu


def _arrays():
    rng = np.random.default_rng(0)
    return [
        rng.normal(size=(33, 7)).astype(np.float32),
        rng.normal(size=(5,)).astype(np.float64),
        rng.normal(size=(3, 3, 3, 2, 4)).astype(np.float16),
        np.arange(10, dtype=np.int64),
        np.asarray(3.5, np.float32),
        np.zeros((0, 4), np.float32),
    ]


def test_pack_byte_identical_to_jax():
    arrays = _arrays()
    assert ttu.pack_arrays(arrays) == jtu.pack_arrays(arrays)
    # torch tensors pack to the same bytes as their numpy arrays
    tensors = [torch.from_numpy(a.copy()) for a in arrays]
    assert ttu.pack_arrays(tensors) == jtu.pack_arrays(arrays)


def test_files_and_manifests_cross_between_packages(tmp_path):
    arrays = _arrays()
    d_port, d_jax = tmp_path / "port", tmp_path / "jax"
    d_port.mkdir()
    d_jax.mkdir()
    n_port = ttu.save_arrays(d_port / "g.npy", arrays)
    n_jax = jtu.save_arrays(d_jax / "g.npy", arrays)
    assert n_port == n_jax
    assert open(d_port / "g.npy", "rb").read() == open(d_jax / "g.npy", "rb").read()
    e_port = ttr.manifest_entry(str(d_port / "g.npy"))
    e_jax = jtr.manifest_entry(str(d_jax / "g.npy"))
    assert {k: e_port[k] for k in ("bytes", "crc32")} == {k: e_jax[k] for k in ("bytes", "crc32")}
    # each package reads the other's file exactly as it reads its own (a
    # 0-d array comes back as shape (1,) from both: reshape([]) quirk)
    for path in (d_port / "g.npy", d_jax / "g.npy"):
        for a, t, j in zip(arrays, ttu.load_arrays(str(path)), jtu.load_arrays(str(path))):
            assert t.dtype == j.dtype == a.dtype and t.shape == j.shape
            np.testing.assert_array_equal(t, j)
            np.testing.assert_array_equal(t.ravel(), a.ravel())


def test_crc_and_truncation_errors_match_jax():
    payload = ttu.pack_arrays(_arrays())
    flipped = bytearray(payload)
    flipped[-3] ^= 0xFF
    cases = [
        (bytes(flipped), ttu.WireCorruption, jtu.WireCorruption),
        (payload[:-5], ttu.WireIncomplete, jtu.WireIncomplete),
        (payload[:4], ttu.WireIncomplete, jtu.WireIncomplete),
        (payload[:12], ttu.WireIncomplete, jtu.WireIncomplete),
        (b"NOTAWIRE" + payload[8:], ttu.WireCorruption, jtu.WireCorruption),
    ]
    for bad, port_exc, jax_exc in cases:
        with pytest.raises(port_exc):
            ttu.unpack_arrays(bad)
        with pytest.raises(jax_exc):
            jtu.unpack_arrays(bad)
    # a stale copy: intact, but not the payload the manifest committed
    crc = json.loads(payload[16:16 + int(np.frombuffer(payload[8:16], "<u8")[0])])["crc"]
    with pytest.raises(ttu.WireIncomplete):
        ttu.unpack_arrays(payload, expected_crc=crc + 1)
    assert issubclass(ttu.WireError, ValueError)


def test_load_retries_then_raises_typed_error(tmp_path):
    path = tmp_path / "g.npy"
    ttu.save_arrays(path, _arrays())
    good = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(good[: len(good) // 2])  # a relay caught mid-copy
    cache = {"wire_retry_attempts": 2, "wire_retry_base_delay": 0.0}
    policy = RetryPolicy.for_wire(cache)
    with pytest.raises(ttu.WireIncomplete):
        ttu.load_arrays(str(path), retry=policy)
    assert cache["wire_retry_stats"]["retries"] == 1
    os.remove(path)
    with pytest.raises(ttu.WireIncomplete):  # the manifest names it: in flight
        ttu.load_arrays(str(path))
    with pytest.raises(FileNotFoundError):
        ttu.load_arrays(str(tmp_path / "never_sent.npy"))


def test_load_arrays_many_issues_sorted_returns_caller_order(tmp_path, monkeypatch):
    """Native reads are issued in one call in sorted-path order; with
    ``COINN_NATIVE=0`` each file goes to ``load_arrays`` on the fan-in pool
    in that order.  Either way the results come back in the caller's."""
    paths = []
    for name in ("c", "a", "b"):
        p = tmp_path / f"{name}.npy"
        ttu.save_arrays(p, [np.full(3, ord(name), np.float32)])
        paths.append(str(p))
    batches = []
    real_many = ttu.native.load_many

    def spy_many(ps):
        batches.append([os.path.basename(p) for p in ps])
        return real_many(ps)

    monkeypatch.setattr(ttu.native, "load_many", spy_many)
    out = ttu.load_arrays_many(paths)
    assert batches == [["a.npy", "b.npy", "c.npy"]]
    assert [int(o[0][0]) for o in out] == [ord("c"), ord("a"), ord("b")]

    issued = []
    real = ttu.load_arrays

    def spy(path, retry=None, mmap=False):
        issued.append(os.path.basename(path))
        return real(path, retry=retry, mmap=mmap)

    monkeypatch.setenv("COINN_NATIVE", "0")
    monkeypatch.setattr(ttu, "load_arrays", spy)
    monkeypatch.setattr(ttu.os, "cpu_count", lambda: 1)  # one worker: issue order is visible
    ttu.shutdown_fan_in_pool()  # the next pool is made with one worker
    try:
        out = ttu.load_arrays_many(paths)
    finally:
        ttu.shutdown_fan_in_pool()
    assert issued == ["a.npy", "b.npy", "c.npy"]
    assert [int(o[0][0]) for o in out] == [ord("c"), ord("a"), ord("b")]


def test_save_wire_seed_rule(tmp_path):
    """``(stable_file_id(salt) + counter) % 2**31``, array i at seed + i,
    the counter advanced in ``cache['_wire_seed']`` — as the JAX package."""
    assert stable_file_id("site_3") == jax_stable_file_id("site_3")
    arrays = [np.random.default_rng(1).normal(size=(4, 40)).astype(np.float32)] * 2
    cache = {"_wire_seed": 5}
    ttu.save_wire(tmp_path / "w.npy", arrays, salt="site_3", cache=cache, precision_bits=8)
    assert cache["_wire_seed"] == 7
    want = ttu.pack_arrays(arrays, codec="int8",
                           seed=(stable_file_id("site_3") + 5) % 2 ** 31)
    assert open(tmp_path / "w.npy", "rb").read() == want
    jax_cache = {"_wire_seed": 5}
    jtu.save_wire(str(tmp_path / "j.npy"), arrays, salt="site_3", cache=jax_cache,
                  precision_bits=8)
    assert jax_cache["_wire_seed"] == cache["_wire_seed"]
    # at 32 bits save_wire writes the JAX package's bytes
    ttu.save_wire(tmp_path / "w32.npy", arrays, salt="x", cache={}, precision_bits=32)
    jtu.save_wire(str(tmp_path / "j32.npy"), arrays, salt="x", cache={}, precision_bits=32)
    assert open(tmp_path / "w32.npy", "rb").read() == open(tmp_path / "j32.npy", "rb").read()


def _pack_leaf_by_leaf(arrays, seed):
    """An int8 payload assembled one leaf at a time: ``quantize_int8`` per
    float array (array ``i`` at ``seed + i``), each result copied to the
    host on its own, raw arrays as they are."""
    from coinstac_dinunet_tpu_torch.ops.quantize import quantize_int8

    entries, blobs = [], []
    for i, a in enumerate(arrays):
        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))
        if t.is_floating_point():
            vals, scales, shape = quantize_int8(t, seed=seed + i)
            entries.append({"shape": list(shape), "dtype": ttu._numpy_dtype(t).str,
                            "codec": "int8", "groups": int(vals.shape[0])})
            blobs += [vals.cpu().numpy().tobytes(), scales.cpu().numpy().tobytes()]
        else:
            h = np.ascontiguousarray(a)
            entries.append({"shape": list(h.shape), "dtype": h.dtype.str})
            blobs.append(h.tobytes())
    manifest = json.dumps({"e": entries, "crc": ttr.crc32(*blobs),
                           "size": sum(len(b) for b in blobs)}).encode("utf-8")
    return b"COINNTW2" + struct.pack("<Q", len(manifest)) + manifest + b"".join(blobs)


def _mixed_payload():
    rng = np.random.default_rng(5)
    return [
        torch.from_numpy(rng.normal(size=(3, 3, 3, 4, 8)).astype(np.float32)),
        np.arange(6, dtype=np.int64),
        torch.from_numpy(rng.normal(size=(40, 9)).astype(np.float32)).t(),  # a to_flax view
        torch.zeros((0, 4)),
        rng.normal(size=(5,)).astype(np.float64),
        np.array([True, False, True]),
        torch.from_numpy(rng.normal(size=(130,)).astype(np.float16)),
        np.asarray(2.5, np.float32),
        torch.from_numpy(rng.normal(size=(501,)).astype(np.float32))[1:],  # misaligned
    ]


def test_save_wire_int8_bytes_equal_the_leaf_by_leaf_payload(tmp_path):
    arrays = _mixed_payload()
    cache = {"_wire_seed": 11}
    ttu.save_wire(tmp_path / "w.npy", arrays, salt="site_1", cache=cache, precision_bits=8)
    seed = (stable_file_id("site_1") + 11) % 2 ** 31
    assert open(tmp_path / "w.npy", "rb").read() == _pack_leaf_by_leaf(arrays, seed)
    # a seed near 2**31: each array's seed wraps on its own
    assert ttu.pack_arrays(arrays, codec="int8", seed=2 ** 31 - 4) == \
        _pack_leaf_by_leaf(arrays, 2 ** 31 - 4)


def test_jax_reads_the_ports_mixed_int8_payload(tmp_path):
    arrays = _mixed_payload()
    path = tmp_path / "g.npy"
    ttu.save_arrays(path, arrays, codec="int8", seed=3)
    got_jax, got_port = jtu.load_arrays(str(path)), ttu.load_arrays(str(path))
    assert len(got_jax) == len(arrays)
    for a, j, t in zip(arrays, got_jax, got_port):
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        assert j.dtype == t.dtype == a.dtype
        np.testing.assert_array_equal(j, t)
        if a.dtype.kind == "f" and a.size:
            # one quantization step, plus the rounding back to the dtype
            top = np.max(np.abs(a.astype(np.float64)))
            err = np.abs(j.astype(np.float64).reshape(-1) - a.astype(np.float64).reshape(-1))
            assert err.max() <= top / 127.0 + top * np.finfo(a.dtype).eps
        else:
            np.testing.assert_array_equal(j.reshape(-1), a.reshape(-1))


@pytest.mark.parametrize("bits", [None, 8, 16, 32, 64])
def test_caste_ndarray_matches_jax(bits):
    """The wire dtype cast: numpy in, the JAX package's array out bit for
    bit; a tensor stays a tensor of the wire's torch dtype."""
    x = np.random.default_rng(3).normal(size=(4, 5)) * 1e3
    got, want = ttu.caste_ndarray(x, bits), jtu.caste_ndarray(x, bits)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    t = ttu.caste_ndarray(torch.from_numpy(x), bits)
    assert isinstance(t, torch.Tensor)
    np.testing.assert_array_equal(t.numpy(), want)


@pytest.mark.parametrize("large,small,axis", [
    ((2, 3, 10, 9), (2, 4, 6, 9), 1),          # U-Net 2-D skip, channels first
    ((1, 2, 9, 8, 7), (1, 5, 5, 4, 7), 1),     # 5-D (the reference's defect case)
    ((2, 10, 11, 3), (2, 6, 7, 4), -1),        # channels last, negative axis
])
def test_safe_concat_matches_jax(large, small, axis):
    rng = np.random.default_rng(4)
    a = rng.normal(size=large).astype(np.float32)
    b = rng.normal(size=small).astype(np.float32)
    got = ttu.safe_concat(torch.from_numpy(a), torch.from_numpy(b), axis=axis)
    want = np.asarray(jtu.safe_concat(a, b, axis=axis))
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="smaller"):
        ttu.safe_concat(torch.from_numpy(b), torch.from_numpy(a), axis=axis)

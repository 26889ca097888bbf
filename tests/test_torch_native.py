"""The port's native wire runtime (``coinstac_dinunet_tpu_torch/native``)
against the JAX package's (``coinstac_dinunet_tpu/native``).

The cases of ``tests/test_native.py`` carried over: the build, pack and
load round trips, parallel loads, a missing and an empty file, the
checksum; and against the JAX package: the port's packed files equal the
JAX package's byte for byte, native and under ``COINN_NATIVE=0``, and the
checksums are equal.  Besides: the library lands in the port's ``_build/``
and nothing is written beside the source, a failing compiler raises
instead of falling back, and ``COUNTS`` counts the native calls.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

from coinstac_dinunet_tpu import native as jax_native
from coinstac_dinunet_tpu.utils import tensorutils as jax_tu
from coinstac_dinunet_tpu_torch import native
from coinstac_dinunet_tpu_torch.utils import tensorutils as tu

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_native_builds_and_loads():
    assert native.enabled() and native.available()
    assert os.path.exists(native.library_path())


def test_pack_load_roundtrip(tmp_path):
    p = str(tmp_path / "x.bin")
    header = b"HDR!" + bytes(range(16))
    bufs = [os.urandom(1000), b"", os.urandom(3)]
    assert native.pack_file(p, header, bufs)
    assert native.load_file(p) == header + b"".join(bufs)
    # buffers the gather-write takes as they are: memoryviews, numpy bytes
    a = np.arange(33, dtype=np.float32)
    q = str(tmp_path / "y.bin")
    assert native.pack_file(q, header, [memoryview(a).cast("B")[4:40], a.tobytes()])
    assert native.load_file(q) == header + a.tobytes()[4:40] + a.tobytes()


def test_load_many_parallel(tmp_path):
    paths, blobs = [], []
    for i in range(12):
        p = str(tmp_path / f"f{i}.bin")
        blob = os.urandom(2048 + i)
        with open(p, "wb") as f:
            f.write(blob)
        paths.append(p)
        blobs.append(blob)
    assert native.load_many(paths) == blobs
    assert native.load_many([]) == []


def test_load_missing_file(tmp_path):
    assert native.load_file(str(tmp_path / "nope.bin")) is None
    assert native.load_many([str(tmp_path / "nope.bin")]) == [None]


def test_empty_file(tmp_path):
    p = str(tmp_path / "empty.bin")
    open(p, "wb").close()
    assert native.load_file(p) == b""
    assert native.load_many([p]) == [b""]


def test_checksum_stable_sensitive_and_equal_to_jax():
    a = native.checksum(b"hello world")
    assert a == native.checksum(b"hello world")
    assert a != native.checksum(b"hello worle")
    assert native.checksum(b"") != native.checksum(b"\x00")
    rng = np.random.default_rng(0)
    for n in (0, 1, 7, 8, 9, 1000, 4099):
        buf = rng.integers(0, 256, size=n, dtype=np.uint8).tobytes()
        assert native.checksum(buf) == jax_native.checksum(buf)
    arr = rng.normal(size=(5, 7)).astype(np.float32)
    assert native.checksum(memoryview(arr).cast("B")) == jax_native.checksum(arr.tobytes())


def _arrays(seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(65, 3)).astype(np.float32), np.arange(7, dtype=np.int32),
            rng.normal(size=(300,)).astype(np.float32), np.zeros((0,), np.float32)]


@pytest.mark.parametrize("codec", [None, "int8"])
def test_save_arrays_native_equals_python_and_jax(tmp_path, codec):
    """The port's native write and the port's packer: the same bytes; and
    the JAX package's file at the float codec (the int8 codec's rounding
    noise is the port's own Philox stream, so there the files differ by
    design: ``PERF.md`` "Port faults")."""
    arrays = _arrays(1)
    before = dict(native.COUNTS)
    p = str(tmp_path / "port.bin")
    tu.save_arrays(p, arrays, codec=codec, seed=3)
    assert native.COUNTS["packs"] == before["packs"] + 1
    got = open(p, "rb").read()
    assert got == tu.pack_arrays(arrays, codec=codec, seed=3)
    back = tu.load_arrays(p)
    for a, b in zip(jax_tu.load_arrays(p), back):  # the JAX reader takes it
        np.testing.assert_array_equal(a, b)
    if codec is None:
        q = str(tmp_path / "jax.bin")
        jax_tu.save_arrays(q, arrays, codec=codec, seed=3)
        assert got == open(q, "rb").read()


def test_fallback_path_parity(tmp_path):
    """``COINN_NATIVE=0``: the Python writer and reader, the same bytes as
    the native writer's and the JAX package's, and no native call."""
    code = """
import numpy as np
from coinstac_dinunet_tpu_torch import native
from coinstac_dinunet_tpu_torch.utils import tensorutils as tu
assert not native.available() and native.pack_file(%r, b"", []) is False
a = [np.arange(12, dtype=np.float32).reshape(3, 4), np.arange(5, dtype=np.int64)]
tu.save_arrays(%r, a)
back = tu.load_arrays_many([%r])[0]
np.testing.assert_array_equal(back[0], a[0])
assert all(v == 0 for v in native.COUNTS.values()), native.COUNTS
print(open(%r, 'rb').read() == tu.pack_arrays(a))
"""
    p = str(tmp_path / "fb.bin")
    env = dict(os.environ, COINN_NATIVE="0", PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code % (str(tmp_path / "x"), p, p, p)],
                       capture_output=True, text=True, env=env, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "True" in r.stdout
    a = [np.arange(12, dtype=np.float32).reshape(3, 4), np.arange(5, dtype=np.int64)]
    q = str(tmp_path / "native.bin")
    tu.save_arrays(q, a)
    j = str(tmp_path / "jax.bin")
    jax_tu.save_arrays(j, a)
    assert open(p, "rb").read() == open(q, "rb").read() == open(j, "rb").read()


def test_reducer_many_load_roundtrip(tmp_path):
    rng = np.random.default_rng(1)
    paths, expect = [], []
    for i in range(4):
        arrays = [rng.normal(size=(10, 10)).astype(np.float32)]
        p = str(tmp_path / f"site{i}.bin")
        tu.save_arrays(p, arrays)
        paths.append(p)
        expect.append(arrays)
    before = dict(native.COUNTS)
    out = tu.load_arrays_many(paths)
    assert native.COUNTS["load_many"] == before["load_many"] + 1
    assert native.COUNTS["load_many_files"] == before["load_many_files"] + 4
    for site_arrays, site_expect in zip(out, expect):
        np.testing.assert_array_equal(site_arrays[0], site_expect[0])
    for site_arrays, theirs in zip(out, jax_tu.load_arrays_many(paths)):
        np.testing.assert_array_equal(site_arrays[0], theirs[0])


def test_library_lands_in_build_and_nothing_beside_the_source():
    assert native.available()
    lib = native.library_path()
    assert os.path.dirname(lib) == os.path.join(REPO, "coinstac_dinunet_tpu_torch", "_build")
    assert os.path.basename(lib).startswith("libcoinnwire.") and lib.endswith(".so")
    beside = sorted(f for f in os.listdir(os.path.dirname(native.SOURCE)) if f != "__pycache__")
    assert beside == ["__init__.py", "wire.cc"]


def test_build_is_atomic_and_named_by_the_source(tmp_path, monkeypatch):
    """A fresh build directory: the library appears under its hashed name
    and no temporary file is left; a second build only finds it."""
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    out = native.build()
    assert os.listdir(tmp_path / "build") == [os.path.basename(out)]
    mtime = os.path.getmtime(out)
    assert native.build() == out and os.path.getmtime(out) == mtime


def test_a_failing_compiler_raises_instead_of_falling_back(tmp_path, monkeypatch):
    """No quiet fallback: a build that fails raises with the compiler's
    output, and the load of a fresh process fails with it."""
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "COMPILER", ("g++", "-DCOINN_BROKEN_BUILD", "-include",
                                             "/nonexistent/header.h"))
    with pytest.raises(RuntimeError, match="native wire build failed.*nonexistent"):
        native.build()
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="COINN_NATIVE=0"):
        native.available()
    monkeypatch.setattr(native, "COMPILER", ("/nonexistent/compiler",))
    with pytest.raises(RuntimeError, match="native wire build failed"):
        native.build()
    assert not os.listdir(tmp_path / "build")  # no half-written library

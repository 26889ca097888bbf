"""ctypes bindings for the port's native wire runtime (``wire.cc``): the
port of the JAX package's ``native/__init__.py``.

- :func:`pack_file` — gather-write a header and a list of buffers with no
  join of the payload (the buffers' memory goes to ``writev`` as it is);
- :func:`load_file` / :func:`load_many` — bulk reads, several files at
  once on native threads (no GIL);
- :func:`checksum` — the 64-bit payload hash.

The files and the checksum are the JAX library's, byte for byte.

The library is built with ``g++`` at first use into
``coinstac_dinunet_tpu_torch/_build/``, named by a hash of the source and
the flags (an edit rebuilds), written to a process-unique temporary name
and ``os.replace``-d into place, so concurrent builds (node processes,
test workers) never leave a half-written library.

What differs from the JAX package: nothing falls back quietly.  A build
or load that fails raises with the compiler's output; ``COINN_NATIVE=0``
is the only way to take the Python path, and then :func:`available` is
False, :func:`pack_file` returns False and :func:`load_file` /
:func:`load_many` return None, as in JAX.  ``COUNTS`` counts the native
calls (packs, single loads, many-loads and the files they read, bytes
written and read), like the kernels' launch counters.
"""
import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_DIR, "wire.cc")
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
#: the compiler command and its flags
COMPILER = ("g++",)
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")
ABI_VERSION = 1

#: native calls made by this process (see :func:`reset_counts`)
COUNTS = {}

_lock = threading.Lock()
_count_lock = threading.Lock()  # the committer thread and the caller both count
_lib = None


def reset_counts():
    """Set every counter of ``COUNTS`` to 0."""
    with _count_lock:
        COUNTS.update(packs=0, loads=0, load_many=0, load_many_files=0,
                      bytes_written=0, bytes_read=0)


def _count(**grew):
    with _count_lock:
        for key, n in grew.items():
            COUNTS[key] += n


reset_counts()


def enabled():
    """False when ``COINN_NATIVE=0`` asks for the Python path."""
    return os.environ.get("COINN_NATIVE", "1") != "0"


def library_path():
    """Where the library is (or will be) built: named by a hash of the
    source, the compiler and the flags."""
    digest = hashlib.sha256(" ".join(COMPILER + FLAGS).encode())
    with open(SOURCE, "rb") as f:
        digest.update(f.read())
    return os.path.join(BUILD_DIR, f"libcoinnwire.{digest.hexdigest()[:16]}.so")


def build():
    """Compile ``wire.cc`` unless its library is built; returns its path.
    Raises ``RuntimeError`` with the compiler's output when the build
    fails."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.tmp.{os.getpid()}.{threading.get_ident()}"
    cmd = [*COMPILER, *FLAGS, SOURCE, "-o", tmp]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except OSError as exc:
        raise RuntimeError(
            f"native wire build failed ({' '.join(cmd)}): {exc}; "
            "COINN_NATIVE=0 takes the Python path") from exc
    try:
        if proc.returncode != 0:
            raise RuntimeError(
                f"native wire build failed ({' '.join(cmd)}, rc {proc.returncode}):\n"
                f"{proc.stderr}{proc.stdout}\nCOINN_NATIVE=0 takes the Python path")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def _load():
    """The loaded library (built first if need be), or None under
    ``COINN_NATIVE=0``."""
    global _lib
    if not enabled():
        return None
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            lib.coinn_abi_version.restype = ctypes.c_int32
            if lib.coinn_abi_version() != ABI_VERSION:
                raise RuntimeError(
                    f"{library_path()}: ABI version {lib.coinn_abi_version()}, "
                    f"expected {ABI_VERSION}")
            lib.coinn_checksum.restype = ctypes.c_uint64
            lib.coinn_checksum.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
            lib.coinn_pack_file.restype = ctypes.c_int32
            lib.coinn_pack_file.argtypes = [
                ctypes.c_char_p, ctypes.c_char_p, ctypes.c_uint64,
                ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_uint64),
                ctypes.c_int32,
            ]
            lib.coinn_load_file.restype = ctypes.c_uint64
            lib.coinn_load_file.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ]
            lib.coinn_load_many.restype = None
            lib.coinn_load_many.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int32,
                ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
                ctypes.POINTER(ctypes.c_uint64),
            ]
            lib.coinn_free.argtypes = [ctypes.c_void_p]
            _lib = lib
    return _lib


def available():
    """True when the native path is on (building and loading the library,
    which raises if that fails); False under ``COINN_NATIVE=0``."""
    return _load() is not None


def _views(buffers):
    """uint8 numpy views of byte buffers (no copy; read-only ones too)."""
    return [np.frombuffer(b, dtype=np.uint8) for b in buffers]


def checksum(buf):
    """The 64-bit payload hash of ``buf``."""
    lib = _load()
    if lib is None:
        raise RuntimeError("the native wire runtime is off (COINN_NATIVE=0)")
    (v,) = _views([buf])
    return int(lib.coinn_checksum(v.ctypes.data, v.size))


def pack_file(path, header, buffers):
    """Write ``header`` then every buffer of ``buffers`` to ``path`` with
    the native gather-write.  True when written; False under
    ``COINN_NATIVE=0`` (the caller writes with Python); raises ``OSError``
    when the write fails."""
    lib = _load()
    if lib is None:
        return False
    views = _views(buffers)
    n = len(views)
    bufs = (ctypes.c_void_p * n)(*[v.ctypes.data if v.size else None for v in views])
    sizes = (ctypes.c_uint64 * n)(*[v.size for v in views])
    header = bytes(header)
    rc = lib.coinn_pack_file(os.fsencode(str(path)), header, len(header), bufs, sizes, n)
    if rc != 0:
        raise OSError(f"native gather-write of {path} failed (rc {rc})")
    _count(packs=1, bytes_written=len(header) + sum(v.size for v in views))
    return True


def _empty_file(path):
    return os.path.exists(path) and os.path.getsize(path) == 0


def load_file(path):
    """The whole file through the native bulk reader: bytes, or None when
    the read failed (or under ``COINN_NATIVE=0``)."""
    lib = _load()
    if lib is None:
        return None
    out = ctypes.POINTER(ctypes.c_uint8)()
    size = lib.coinn_load_file(os.fsencode(str(path)), ctypes.byref(out))
    _count(loads=1, bytes_read=size)
    if size == 0:
        return b"" if _empty_file(path) else None
    try:
        return ctypes.string_at(out, size)
    finally:
        lib.coinn_free(out)


def load_many(paths):
    """Several files read concurrently on native threads: a list of bytes
    (None for a file that failed), or None under ``COINN_NATIVE=0``."""
    lib = _load()
    if lib is None:
        return None
    n = len(paths)
    if n == 0:
        return []
    arr = (ctypes.c_char_p * n)(*[os.fsencode(str(p)) for p in paths])
    outs = (ctypes.POINTER(ctypes.c_uint8) * n)()
    sizes = (ctypes.c_uint64 * n)()
    lib.coinn_load_many(arr, n, outs, sizes)
    _count(load_many=1, load_many_files=n, bytes_read=sum(sizes))
    result = []
    for i in range(n):
        if sizes[i] == 0:
            result.append(b"" if _empty_file(paths[i]) else None)
            continue
        try:
            result.append(ctypes.string_at(outs[i], sizes[i]))
        finally:
            lib.coinn_free(outs[i])
    return result

"""The msgpack subset of ``flax.serialization``, in plain Python.

The JAX package's checkpoints — among them the pretrained weights the
aggregator broadcasts to every site — are
``flax.serialization.msgpack_serialize`` of a dict tree.  The port reads
and writes the same bytes without ``msgpack`` or ``flax``:

- maps (str keys, written sorted, as flax writes them), arrays (lists and
  tuples), str, bin (bytes), ints, floats (written as float64), nil and
  bool — each in the smallest form, as the ``msgpack`` package packs them;
- ext type 1: an ndarray, as the msgpack array ``(shape, dtype name,
  C-order bytes)``; a ``bfloat16`` one is read as the float32 array of the
  same values (numpy has no bfloat16);
- ext type 3: a numpy scalar, as a 0-d ndarray;
- flax's ``__msgpack_chunked_array__`` map of flat chunks, which flax
  writes for an array over 2^30 bytes, is read back as the array; the
  writer refuses such an array (no checkpoint of the port's models comes
  near it).
"""
import struct

import numpy as np

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
#: flax splits arrays above this many bytes into chunks
MAX_CHUNK_SIZE = 2 ** 30
_CHUNKED = "__msgpack_chunked_array__"


# ------------------------------------------------------------------ writing
def _header(out, n, small_base, small_max, codes):
    """A length header: fix form below ``small_max``, else the first of
    ``codes`` (8-, 16-, 32-bit length) that fits."""
    if small_base is not None and n <= small_max:
        out.append(small_base | n)
        return
    for code, fmt, top in zip(codes, (">B", ">H", ">I"), (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= top:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack object of length {n} is too large")


def _pack_int(out, n):
    if -0x20 <= n < 0x80:
        out += struct.pack(">b" if n < 0 else ">B", n)
        return
    if n >= 0:
        forms = ((0xFF, 0xCC, ">B"), (0xFFFF, 0xCD, ">H"), (0xFFFFFFFF, 0xCE, ">I"),
                 (0xFFFFFFFFFFFFFFFF, 0xCF, ">Q"))
        for top, code, fmt in forms:
            if n <= top:
                out.append(code)
                out += struct.pack(fmt, n)
                return
    else:
        forms = ((-0x80, 0xD0, ">b"), (-0x8000, 0xD1, ">h"), (-0x80000000, 0xD2, ">i"),
                 (-0x8000000000000000, 0xD3, ">q"))
        for bottom, code, fmt in forms:
            if n >= bottom:
                out.append(code)
                out += struct.pack(fmt, n)
                return
    raise OverflowError(f"integer {n} does not fit msgpack")


def _pack_bytes(out, b, is_str):
    if is_str:
        _header(out, len(b), 0xA0, 31, (0xD9, 0xDA, 0xDB))
    else:
        _header(out, len(b), None, 0, (0xC4, 0xC5, 0xC6))
    out += b


def _pack_ext(out, code, data):
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if len(data) in fixed:
        out.append(fixed[len(data)])
    else:
        _header(out, len(data), None, 0, (0xC7, 0xC8, 0xC9))
    out += struct.pack(">b", code)
    out += data


def _ndarray_bytes(arr):
    """The ext payload of an array: ``(shape, dtype name, C-order bytes)``."""
    if arr.nbytes > MAX_CHUNK_SIZE:
        raise ValueError(f"array of {arr.nbytes} bytes is over the {MAX_CHUNK_SIZE}-byte "
                         "limit flax writes in chunks")
    out = bytearray()
    _pack(out, [list(arr.shape), arr.dtype.name, arr.tobytes("C")])
    return bytes(out)


def _pack(out, x):
    if x is None:
        out.append(0xC0)
    elif x is True or x is False:
        out.append(0xC3 if x else 0xC2)
    elif isinstance(x, np.generic):
        # before int and float: np.float64 subclasses float, and flax packs
        # every numpy scalar as ext 3
        _pack_ext(out, EXT_NPSCALAR, _ndarray_bytes(np.asarray(x)))
    elif isinstance(x, int):
        _pack_int(out, x)
    elif isinstance(x, float):
        out.append(0xCB)
        out += struct.pack(">d", x)
    elif isinstance(x, str):
        _pack_bytes(out, x.encode("utf-8"), True)
    elif isinstance(x, bytes):
        _pack_bytes(out, x, False)
    elif isinstance(x, dict):
        _header(out, len(x), 0x80, 15, (None, 0xDE, 0xDF))
        for k, v in x.items():
            _pack(out, k)
            _pack(out, v)
    elif isinstance(x, (list, tuple)):
        _header(out, len(x), 0x90, 15, (None, 0xDC, 0xDD))
        for v in x:
            _pack(out, v)
    elif isinstance(x, np.ndarray):
        _pack_ext(out, EXT_NDARRAY, _ndarray_bytes(x))
    else:
        raise TypeError(f"cannot serialize {type(x).__name__} as msgpack")


def _sorted(x):
    """The tree with every map's keys sorted, as flax writes it (flax
    rebuilds the tree through ``jax.tree_util``, which sorts them)."""
    if isinstance(x, dict):
        return {k: _sorted(x[k]) for k in sorted(x)}
    return x


def serialize(tree):
    """``flax.serialization.msgpack_serialize`` of ``tree`` (dicts with str
    keys, lists, python scalars, numpy arrays and scalars)."""
    out = bytearray()
    _pack(out, _sorted(tree))
    return bytes(out)


# ------------------------------------------------------------------ reading
def _array_from(data):
    shape, name, raw = _Reader(data, raw_str=True).read_all()
    name = name.decode("ascii") if isinstance(name, bytes) else name
    if name == "bfloat16":
        bits = np.frombuffer(raw, dtype=np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(raw, dtype=np.dtype(name)).reshape(shape)


class _Reader:
    def __init__(self, data, raw_str=False):
        self.data = memoryview(data)
        self.pos = 0
        self.raw_str = raw_str

    def take(self, n):
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        b = self.data[self.pos:self.pos + n]
        self.pos += n
        return b

    def unpack(self, fmt):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read_all(self):
        x = self.read()
        if self.pos != len(self.data):
            raise ValueError(f"{len(self.data) - self.pos} trailing bytes after msgpack data")
        return x

    def _str(self, n):
        b = bytes(self.take(n))
        return b if self.raw_str else b.decode("utf-8")

    def _ext(self, n):
        code = self.unpack(">b")
        data = bytes(self.take(n))
        if code == EXT_NDARRAY:
            return _array_from(data)
        if code == EXT_NPSCALAR:
            return _array_from(data)[()]
        raise ValueError(f"unknown msgpack ext type {code}")

    def read(self):
        c = self.unpack(">B")
        if c <= 0x7F:
            return c
        if c >= 0xE0:
            return c - 0x100
        if 0x80 <= c <= 0x8F:
            return self._map(c & 0x0F)
        if 0x90 <= c <= 0x9F:
            return [self.read() for _ in range(c & 0x0F)]
        if 0xA0 <= c <= 0xBF:
            return self._str(c & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if c in simple:
            return simple[c]
        lengths = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
        if c in lengths:
            return bytes(self.take(self.unpack(lengths[c])))
        lengths = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        if c in lengths:
            return self._ext(self.unpack(lengths[c]))
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                   0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if c in numbers:
            return self.unpack(numbers[c])
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if c in fixext:
            return self._ext(fixext[c])
        lengths = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if c in lengths:
            return self._str(self.unpack(lengths[c]))
        if c in (0xDC, 0xDD):
            return [self.read() for _ in range(self.unpack(">H" if c == 0xDC else ">I"))]
        if c in (0xDE, 0xDF):
            return self._map(self.unpack(">H" if c == 0xDE else ">I"))
        raise ValueError(f"not msgpack data: byte 0x{c:02x} at offset {self.pos - 1}")

    def _map(self, n):
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out


def _unchunked(x):
    if isinstance(x, dict):
        if _CHUNKED in x:
            shape = tuple(x["shape"][str(i)] for i in range(len(x["shape"])))
            chunks = [x["chunks"][str(i)] for i in range(len(x["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunked(v) for k, v in x.items()}
    return x


def restore(data):
    """``flax.serialization.msgpack_restore``: the tree of ``data`` with
    numpy array leaves (read-only views of ``data`` where not chunked)."""
    return _unchunked(_Reader(data).read_all())

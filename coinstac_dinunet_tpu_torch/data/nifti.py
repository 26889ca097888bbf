"""Dependency-light NIfTI-1 volume I/O: the port's copy of the JAX
package's ``data/nifti.py`` (the same reader and writer, byte for byte the
same files).

- :func:`load_nifti` reads a NIfTI-1 file into a numpy array, applying the
  header's ``scl_slope``/``scl_inter`` scaling (``scl_slope == 0`` means no
  scaling at all, as the NIfTI-1 standard and nibabel have it).  It uses
  nibabel when it is importable and the built-in pure-numpy reader
  otherwise.  The machines this port is tested and run on have no
  nibabel, so the built-in reader is the tested path.
- :func:`save_nifti` writes a minimal single-file NIfTI-1 (``n+1`` magic),
  enough for tests, fixtures and synthetic-data examples.

Scope: single-file NIfTI-1 (``n+1`` magic, little or big endian, gzip by
magic or plain, column-major voxels), the numeric dtypes that appear in
practice, no extensions.  A ``.hdr``/``.img`` pair or a NIfTI-2 file
raises a clear error naming nibabel as the way out.
"""
import gzip
import os
import struct

import numpy as np

__all__ = ["load_nifti", "save_nifti", "HAVE_NIBABEL"]

try:  # soft import: the built-in reader is the fallback, not the default
    import nibabel as _nib

    HAVE_NIBABEL = True
except Exception:  # pragma: no cover - nibabel is optional
    _nib = None
    HAVE_NIBABEL = False

# NIfTI-1 datatype code → numpy dtype (the codes seen in real datasets)
_DTYPES = {
    2: np.uint8, 4: np.int16, 8: np.int32, 16: np.float32, 64: np.float64,
    256: np.int8, 512: np.uint16, 768: np.uint32, 1024: np.int64,
    1280: np.uint64,
}
_HDR_SIZE = 348


def _read_bytes(path):
    with open(path, "rb") as f:
        head = f.read(2)
        f.seek(0)
        if head == b"\x1f\x8b":
            return gzip.decompress(f.read())
        return f.read()


def load_nifti(path, dtype=None):
    """Read a NIfTI-1 volume → numpy array (x, y, z[, t]) with header
    scaling applied.  ``dtype`` casts the result (default: float32 for
    scaled/float data, the stored dtype otherwise)."""
    if _nib is not None:
        img = _nib.load(path)
        arr = np.asanyarray(img.dataobj)
        # same default rule as the built-in reader below, so the public
        # API's dtype never depends on whether nibabel is installed
        if dtype is None:
            dtype = np.float32 if arr.dtype.kind == "f" else arr.dtype
        return np.ascontiguousarray(arr, dtype=dtype)
    raw = _read_bytes(path)
    if len(raw) < _HDR_SIZE:
        raise ValueError(f"{path!r}: too short for a NIfTI-1 header")
    # endianness from sizeof_hdr (348 in the file's byte order)
    for end in ("<", ">"):
        if struct.unpack(end + "i", raw[:4])[0] == _HDR_SIZE:
            break
    else:
        raise ValueError(
            f"{path!r}: not a NIfTI-1 file (sizeof_hdr != 348); for NIfTI-2 "
            "or ANALYZE pairs install nibabel"
        )
    magic = raw[344:348]
    if not magic.startswith(b"n+1"):
        raise ValueError(
            f"{path!r}: magic {magic!r} is not single-file NIfTI-1 ('n+1'); "
            "for .hdr/.img pairs install nibabel"
        )
    dim = struct.unpack(end + "8h", raw[40:56])
    ndim = int(dim[0])
    if not 1 <= ndim <= 7:
        raise ValueError(f"{path!r}: bad ndim {ndim}")
    shape = tuple(int(d) for d in dim[1 : 1 + ndim])
    code = struct.unpack(end + "h", raw[70:72])[0]
    if code not in _DTYPES:
        raise ValueError(
            f"{path!r}: unsupported NIfTI datatype code {code}; "
            "install nibabel for exotic dtypes"
        )
    vox_offset = int(struct.unpack(end + "f", raw[108:112])[0])
    slope, inter = struct.unpack(end + "2f", raw[112:120])
    base = np.dtype(_DTYPES[code]).newbyteorder(end)
    n = int(np.prod(shape))
    arr = np.frombuffer(raw, dtype=base, count=n, offset=vox_offset)
    # NIfTI is column-major (Fortran order) on disk
    arr = arr.reshape(shape, order="F")
    # NIfTI-1 spec: scl_slope == 0 means NO scaling at all (scl_inter is
    # ignored too) — matching nibabel, so the same file loads identically
    # whether or not nibabel is installed (the API-independence contract)
    if slope != 0.0 and (slope != 1.0 or inter != 0.0):
        arr = arr * np.float32(slope) + np.float32(inter)
    if dtype is None:
        dtype = np.float32 if arr.dtype.kind == "f" else arr.dtype
    return np.ascontiguousarray(arr, dtype=dtype)


def save_nifti(path, array, pixdim=1.0):
    """Write ``array`` as a minimal single-file NIfTI-1 (no scaling, no
    extensions).  Gzips when ``path`` ends in ``.gz``.  Fixture/synthetic
    writer — real acquisitions carry affines this minimal header omits."""
    arr = np.asarray(array)
    code = next((c for c, d in _DTYPES.items() if np.dtype(d) == arr.dtype), None)
    if code is None:
        arr = arr.astype(np.float32)
        code = 16
    hdr = bytearray(_HDR_SIZE)
    struct.pack_into("<i", hdr, 0, _HDR_SIZE)
    dim = (arr.ndim, *arr.shape) + (1,) * (7 - arr.ndim)
    struct.pack_into("<8h", hdr, 40, *dim)
    struct.pack_into("<h", hdr, 70, code)
    struct.pack_into("<h", hdr, 72, arr.dtype.itemsize * 8)  # bitpix
    struct.pack_into("<8f", hdr, 76, 1.0, *([float(pixdim)] * arr.ndim),
                     *([1.0] * (7 - arr.ndim)))
    struct.pack_into("<f", hdr, 108, 352.0)  # vox_offset
    struct.pack_into("<2f", hdr, 112, 1.0, 0.0)  # scl_slope/inter
    hdr[344:348] = b"n+1\x00"
    payload = bytes(hdr) + b"\x00" * 4 + arr.tobytes(order="F")
    data = gzip.compress(payload) if str(path).endswith(".gz") else payload
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)
    return path

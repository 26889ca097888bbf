"""Tensor wire serialization (COINNTW2) + gradient flattening.

Port of the JAX package's ``utils/tensorutils.py``; the bytes on the wire
are the same.  A payload is ``b"COINNTW2"``, the manifest length (``<Q``),
a JSON manifest ``{"e": entries, "crc": CRC32, "size": bytes}`` and the data
section.  With ``codec="int8"`` a float array's entry is
``{"shape", "dtype", "codec": "int8", "groups"}`` and its data is the int8
values followed by the float32 scales.

What differs: arrays may be torch tensors on the card.  At the int8 codec
a payload's float tensors are quantized there in one kernel launch, into
one device buffer already in the data section's layout
(``ops/quantize.py``), and only that buffer crosses to the host, in one
copy; the JAX package copies float32 to the host first.

Files are written by the native gather-write and read by the native bulk
reader (``native/``, ``COINN_NATIVE=0`` for the Python path); the
aggregator's fan-in (:func:`load_arrays_many`) reads every site payload at
once on native threads, or maps each one read-only (``mmap=True``, the
reducer's default: ``Federation.WIRE_MMAP``) and verifies it over the map.
With ``cache['async_wire_commit']`` :func:`save_wire` hands the commit to
the background committer (``resilience/transport.py``).

With telemetry on, every payload saved through :func:`save_wire` and
every payload loaded is a ``wire`` record on the ambient recorder (bytes
on disk, arrays, codec, the arrays' bytes before the codec), a fan-in is a
``wire:fan_in`` event and a retried load a ``wire:retry`` event, as in the
JAX package.  What differs: the JAX package writes no ``wire:fan_in``
event for a fan-in through its thread pool (the mmap one); the port writes
one for every fan-in.
"""
import json
import os
import struct
import threading
import time

import numpy as np
import torch

from .. import config, native
from ..config.keys import Retry
from ..interop import from_flax, to_flax, wire_leaves
from ..ops.quantize import GROUP, dequantize_int8, quantize_int8_many, wire_layout
from ..resilience import transport as _transport
from ..telemetry.recorder import get_active as _telemetry
from ..resilience.transport import (  # noqa: F401 (re-export for callers)
    WireCorruption,
    WireError,
    WireIncomplete,
)
from . import stable_file_id

_MAGIC = b"COINNTW1"  # v1 (read-compat: no checksum)
_MAGIC_V2 = b"COINNTW2"  # v2: manifest carries CRC32 + size of the data section


def _numpy_dtype(t):
    """numpy dtype of a torch tensor (the manifest names numpy dtypes)."""
    return torch.empty((), dtype=t.dtype).numpy().dtype


def _host(a):
    """A C-contiguous numpy view or copy of an ndarray or torch tensor."""
    if isinstance(a, torch.Tensor):
        return np.ascontiguousarray(a.detach().cpu().numpy())
    return np.ascontiguousarray(a)


def _quantize_to_host(leaves, seeds):
    """The int8 data section of ``leaves`` (one device) as a host buffer:
    from the card one kernel launch (per ``MAX_SEGMENTS`` leaves), one
    non-blocking copy into pinned memory and one wait for the stream."""
    buf = quantize_int8_many(leaves, seeds)
    if buf.device.type != "cuda":
        return buf
    host = torch.empty(buf.shape, dtype=buf.dtype, pin_memory=True)
    host.copy_(buf, non_blocking=True)
    torch.cuda.current_stream(buf.device).synchronize()
    return host


def _host_parts(arrays, codec=None, seed=0):
    """Each array of a payload as its manifest entry and data blobs on the
    host: ``codec='int8'`` quantizes the float arrays of each device
    together into the data section's layout (array ``i`` of the payload
    seeded ``seed + i``, whatever the kinds of the others) — K1 and the
    copy to the host happen here; other arrays pass raw, as bytes.  The
    blobs are the caller's to keep: a quantized array's are views of one
    fresh host buffer, which they keep alive."""
    quantized = {}
    if codec == "int8":
        by_device = {}
        for i, a in enumerate(arrays):
            t = a if isinstance(a, torch.Tensor) else torch.from_numpy(_host(a))
            if t.is_floating_point():
                by_device.setdefault(t.device, []).append((i, t))
        for items in by_device.values():
            host = _quantize_to_host([t for _, t in items], [seed + i for i, _ in items])
            data = memoryview(host.numpy()).cast("B")
            groups = [-(-t.numel() // GROUP) for _, t in items]
            for (i, t), g, (vs, ss) in zip(items, groups, wire_layout(groups)[0]):
                quantized[i] = t, g, data[vs], data[ss]
    parts = []
    for i, a in enumerate(arrays):
        if i in quantized:
            t, g, vals, scales = quantized[i]
            parts.append(({"shape": list(t.shape), "dtype": _numpy_dtype(t).str,
                           "codec": "int8", "groups": g}, [vals, scales]))
        else:
            h = _host(a)
            parts.append(({"shape": list(h.shape), "dtype": h.dtype.str}, [h.tobytes()]))
    return parts


def _assemble(parts):
    """(header bytes, data blobs, data CRC32) of the parts of
    :func:`_host_parts`."""
    entries = [entry for entry, _ in parts]
    blobs = [b for _, bs in parts for b in bs]
    crc = _transport.crc32(*blobs)
    manifest = json.dumps({
        "e": entries,
        "crc": crc,
        "size": sum(len(b) for b in blobs),
    }).encode("utf-8")
    header = b"".join([_MAGIC_V2, struct.pack("<Q", len(manifest)), manifest])
    return header, blobs, crc


def _pack_parts(arrays, codec=None, seed=0):
    """(header bytes, data blobs, data CRC32) for a list of ndarrays or
    torch tensors (:func:`_host_parts`, :func:`_assemble`)."""
    return _assemble(_host_parts(arrays, codec=codec, seed=seed))


def pack_arrays(arrays, codec=None, seed=0):
    """Pack a list of arrays into one contiguous bytes payload."""
    header, blobs, _ = _pack_parts(list(arrays), codec=codec, seed=seed)
    return b"".join([header] + blobs)


def unpack_arrays(payload, expected_crc=None):
    """Inverse of :func:`pack_arrays` → list of numpy arrays (views).

    A v2 data section shorter than the header promises raises
    :class:`WireIncomplete`; a CRC32 mismatch raises
    :class:`WireCorruption`; ``expected_crc`` (the directory manifest's CRC)
    that differs from the payload's own marks a stale copy
    (:class:`WireIncomplete`)."""
    magic = payload[: len(_MAGIC)]
    if magic not in (_MAGIC, _MAGIC_V2):
        if len(payload) < len(_MAGIC):
            raise WireIncomplete(
                f"payload of {len(payload)} bytes is shorter than the wire "
                "magic — truncated before the header completed"
            )
        raise WireCorruption("Not a COINN tensor-wire payload")
    off = len(_MAGIC)
    if len(payload) < off + 8:
        raise WireIncomplete("payload truncated inside the manifest length")
    (mlen,) = struct.unpack_from("<Q", payload, off)
    off += 8
    if len(payload) < off + mlen:
        raise WireIncomplete("payload truncated inside the manifest")
    try:
        manifest = json.loads(payload[off : off + mlen].decode("utf-8"))
    except (ValueError, UnicodeDecodeError) as exc:
        raise WireCorruption(f"undecodable wire manifest: {exc}") from exc
    off += mlen
    if magic == _MAGIC_V2:
        size = int(manifest["size"])
        if expected_crc is not None and int(manifest["crc"]) != int(expected_crc):
            raise WireIncomplete(
                f"payload embeds CRC {int(manifest['crc'])} but the commit "
                f"manifest expects {int(expected_crc)} — a stale copy of an "
                "earlier payload; the committed one hasn't (fully) arrived"
            )
        data = memoryview(payload)[off : off + size]
        if len(data) < size:
            raise WireIncomplete(
                f"payload data section has {len(data)} of {size} bytes — "
                "truncated write or partial relay"
            )
        if _transport.crc32(data) != int(manifest["crc"]):
            raise WireCorruption(
                "payload data section fails its embedded CRC32 — corrupted "
                "in transit"
            )
        manifest = manifest["e"]
    out = []
    for item in manifest:
        dt = np.dtype(item["dtype"])
        if item.get("codec") == "int8":
            g = int(item["groups"])
            vals = np.frombuffer(payload, np.int8, count=g * GROUP, offset=off)
            off += g * GROUP
            scales = np.frombuffer(payload, np.float32, count=g, offset=off)
            off += g * 4
            out.append(dequantize_int8(
                vals.reshape(g, GROUP), scales.reshape(g, 1), tuple(item["shape"])
            ).astype(dt))
            continue
        n = int(np.prod(item["shape"], dtype=np.int64)) if item["shape"] else 1
        arr = np.frombuffer(payload, dtype=dt, count=n, offset=off)
        out.append(arr.reshape(item["shape"]))
        off += n * dt.itemsize
    return out


def save_arrays(path, arrays, codec=None, seed=0):
    """Atomically commit a list of arrays (or one array) to ``path`` through
    :func:`~..resilience.transport.commit_bytes`; returns the payload size."""
    if not isinstance(arrays, (list, tuple)):
        arrays = [arrays]
    header, blobs, crc = _pack_parts(list(arrays), codec=codec, seed=seed)
    return _transport.commit_bytes(path, header, blobs, crc=crc)


def _read_payload(path, use_mmap=False):
    """A payload file's bytes: a read-only map of it (``use_mmap``; an empty
    file reads as ``b""``, which unpacks as truncated), the native bulk
    read, or Python's under ``COINN_NATIVE=0``.  Arrays unpacked from a map
    are views that keep it alive."""
    if use_mmap:
        import mmap as _mmap

        with open(path, "rb") as f:
            if os.fstat(f.fileno()).st_size == 0:
                return b""  # mmap refuses empty files
            return _mmap.mmap(f.fileno(), 0, access=_mmap.ACCESS_READ)
    payload = native.load_file(path) if native.available() else None
    if payload is None:
        with open(path, "rb") as f:
            payload = f.read()
    return payload


def load_arrays(path, retry=None, mmap=False):
    """Read back a :func:`save_arrays` payload, verifying its checksum and
    the directory manifest's CRC.  ``retry`` (a
    :class:`~..resilience.retry.RetryPolicy`) retries absent, incomplete
    or corrupt payloads with backoff; exhaustion re-raises the typed
    error.  Every failed attempt notifies the transport's load-failure
    hooks (the chaos harness heals a damaged payload there).  ``mmap=True``
    maps the file read-only and returns read-only views into the map."""
    rec = _telemetry()
    t0 = time.perf_counter()
    attempt = 0
    started = time.monotonic()
    saw_integrity_failure = False
    while True:
        attempt += 1
        try:
            payload = _read_payload(path, use_mmap=mmap)
            entry = _transport.manifest_entry(path)
            out = unpack_arrays(
                payload,
                expected_crc=None if entry is None else entry.get("crc32"),
            )
            break
        except (FileNotFoundError, WireError) as exc:
            exc = _transport.classify_load_failure(path, exc)
            saw_integrity_failure = saw_integrity_failure or isinstance(exc, WireError)
            # in-process repair observers (the chaos harness; none by default)
            _transport.notify_load_failure(path, attempt, exc)
            if retry is None or not retry.should_retry(attempt, started):
                raise exc from None
            delay = retry.delay(attempt)
            retry.note("retries")
            rec.event("wire:retry", cat="wire", file=os.path.basename(str(path)),
                      attempt=attempt, delay=round(delay, 4),
                      error=f"{type(exc).__name__}: {exc}"[:300])
            if delay > 0:
                time.sleep(delay)
    if saw_integrity_failure:
        if retry is not None:
            retry.note("recovered")
        rec.event("wire:corruption_recovered", cat="wire",
                  file=os.path.basename(str(path)), attempts=attempt)
    if rec.enabled:
        rec.wire("load", path, nbytes=len(payload), arrays=len(out),
                 raw_bytes=sum(int(a.nbytes) for a in out),
                 dur=time.perf_counter() - t0, payload_kind="tensor")
    return out


# the fan-in's one bounded thread pool, made at first use and kept (no
# thread start and join on every reduce)
_FAN_IN_POOL = None
_FAN_IN_POOL_LOCK = threading.Lock()


def fan_in_pool():
    """The process-wide fan-in executor, at most the host's core count of
    threads (made at first use)."""
    global _FAN_IN_POOL
    with _FAN_IN_POOL_LOCK:
        if _FAN_IN_POOL is None:
            from concurrent.futures import ThreadPoolExecutor

            _FAN_IN_POOL = ThreadPoolExecutor(max_workers=os.cpu_count() or 8,
                                              thread_name_prefix="coinn-fan-in")
        return _FAN_IN_POOL


def shutdown_fan_in_pool(wait=True):
    """Shut the fan-in executor down (nothing when none was made); the next
    :func:`load_arrays_many` makes a new one."""
    global _FAN_IN_POOL
    with _FAN_IN_POOL_LOCK:
        pool, _FAN_IN_POOL = _FAN_IN_POOL, None
    if pool is not None:
        pool.shutdown(wait=wait)


def load_arrays_many(paths, retry=None, mmap=False):
    """Load several payload files at once — the aggregator's fan-in.

    Native threads read every file in one call (:func:`native.load_many`);
    a file the native read missed goes through :func:`load_arrays` with
    its retry fork, and so does one that fails its integrity check.  With
    ``mmap=True`` (the reducer's default) or ``COINN_NATIVE=0`` each file is
    loaded by :func:`load_arrays` on the shared :func:`fan_in_pool`.  Loads
    are issued in sorted-path order (native batch order, pool scheduling
    and retry forks key on the sorted rank) and the results return in the
    caller's order, so the order of a directory listing never changes a
    load's behavior."""
    paths = list(paths)
    if not paths:
        return []
    rec = _telemetry()
    t0 = time.perf_counter()
    order = sorted(range(len(paths)), key=lambda i: paths[i])
    rank = {i: r for r, i in enumerate(order)}

    def fork(i):
        return None if retry is None else retry.fork(rank[i])

    ranked = None if mmap or not native.available() else native.load_many(
        [paths[i] for i in order])
    if ranked is None:
        loaded = list(fan_in_pool().map(
            lambda i: load_arrays(paths[i], retry=fork(i), mmap=mmap), order))
        out = [None] * len(paths)
        for r, i in enumerate(order):
            out[i] = loaded[r]
    else:
        out = []
        for i, p in enumerate(paths):
            payload = ranked[rank[i]]
            if payload is None:  # the native read failed: the retrying reader
                out.append(load_arrays(p, retry=fork(i)))
                continue
            try:
                entry = _transport.manifest_entry(p)
                arrays = unpack_arrays(
                    payload, expected_crc=None if entry is None else entry.get("crc32"))
            except WireError:  # an integrity failure: the retrying reader
                out.append(load_arrays(p, retry=fork(i)))
                continue
            out.append(arrays)
            if rec.enabled:
                rec.wire("load", p, nbytes=len(payload), arrays=len(arrays),
                         raw_bytes=sum(int(a.nbytes) for a in arrays),
                         payload_kind="tensor")
    if rec.enabled:
        rec.event("wire:fan_in", cat="wire", files=len(paths),
                  secs=round(time.perf_counter() - t0, 6))
    return out


def save_wire(path, arrays, salt="", cache=None, precision_bits=None):
    """Serialize an outbound payload at the configured precision — the one
    choke point sites and aggregator share.  At ``precision_bits=8`` the
    int8 codec's seed is ``(stable_file_id(salt) + counter) % 2**31``, array
    ``i`` taking ``seed + i``, and the counter advances in
    ``cache['_wire_seed']`` by the number of arrays, so rounding noise is
    independent across nodes and rounds.

    With ``cache['async_wire_commit']`` the payload's host parts are made
    before this returns — K1 on the card, the copy to the host, raw arrays
    copied to bytes — so the caller may reuse its buffers at once (the next
    backward writes the same gradient tensors); the header, the write, the
    fsync and the manifest run on the background committer, which the node
    flushes before its output JSON names the file.  The file is the
    synchronous path's, byte for byte."""
    cache = cache if cache is not None else {}
    counter = int(cache.get("_wire_seed", 0))
    seed = (stable_file_id(salt) + counter) % (2 ** 31)
    arr_list = list(arrays) if isinstance(arrays, (list, tuple)) else [arrays]
    cache["_wire_seed"] = counter + len(arr_list)
    codec = config.wire_codec(precision_bits)
    rec = _telemetry()
    raw_bytes = sum(_raw_nbytes(a) for a in arr_list) if rec.enabled else 0
    t0 = time.perf_counter() if rec.enabled else 0.0
    if cache.get(Retry.ASYNC_WIRE_COMMIT):
        parts = _host_parts(arr_list, codec=codec, seed=seed)

        def _commit(path=path, parts=parts, n=len(arr_list), rec=rec, t0=t0):
            header, blobs, crc = _assemble(parts)
            nbytes = _transport.commit_bytes(path, header, blobs, crc=crc)
            if rec.enabled:
                rec.wire("save", path, nbytes=nbytes, arrays=n, codec=codec,
                         raw_bytes=raw_bytes, dur=time.perf_counter() - t0,
                         payload_kind="tensor")

        _transport.async_committer().submit(_commit)
        return None
    nbytes = save_arrays(path, arr_list, codec=codec, seed=seed)
    if rec.enabled:
        rec.wire("save", path, nbytes=nbytes, arrays=len(arr_list), codec=codec,
                 raw_bytes=raw_bytes, dur=time.perf_counter() - t0, payload_kind="tensor")
    return nbytes


def _raw_nbytes(a):
    """Bytes of an array or tensor before the codec (no host copy)."""
    if isinstance(a, torch.Tensor):
        return a.numel() * a.element_size()
    return int(getattr(a, "nbytes", 0))


def aslist(x):
    """Normalize a sequence that may come back as an index-keyed dict."""
    if x is None:
        return []
    if isinstance(x, dict):
        return [x[k] for k in sorted(x, key=lambda s: int(s))]
    return list(x)


def caste_ndarray(x, precision_bits=None):
    """Cast to the wire dtype (float{precision_bits}): a numpy array, or a
    tensor of the wire's torch dtype on its own device."""
    if isinstance(x, torch.Tensor):
        return x.to(config.wire_torch_dtype(precision_bits))
    return np.asarray(x).astype(config.wire_dtype(precision_bits))


def extract_grads(models, precision_bits=None):
    """The gradients of a dict of models as a wire list: one tensor per
    parameter, in the JAX package's leaf order and flax layout
    (:func:`~..interop.wire_leaves`), cast to the wire dtype and left on
    the models' device."""
    dtype = config.wire_torch_dtype(precision_bits)
    out = []
    for name, tname in wire_leaves(models):
        p = models[name].get_parameter(tname)
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        out.append(to_flax(models[name], tname, g.detach()).to(dtype).contiguous())
    return out


def grads_like(models, flat_arrays, device=None):
    """Unflatten a wire list (numpy arrays or torch tensors, flax layout)
    back to ``{model: {param name: tensor}}`` in torch layout on ``device``
    (default: each model's own)."""
    leaves = wire_leaves(models)
    if len(leaves) != len(flat_arrays):
        raise ValueError(
            f"Wire payload has {len(flat_arrays)} leaves; expected {len(leaves)}"
        )
    out = {name: {} for name in models}
    for (name, tname), a in zip(leaves, flat_arrays):
        p = models[name].get_parameter(tname)
        if not isinstance(a, torch.Tensor):
            # np.array copies: wire arrays are read-only views of the payload
            a = torch.from_numpy(np.array(a))
        t = a.to(device=device or p.device, dtype=p.dtype)
        out[name][tname] = from_flax(models[name], tname, t)
    return out


def safe_concat(large, small, axis=1):
    """Concatenate ``small`` onto ``large`` along ``axis``, center-cropping
    ``large`` on every other dim where the two differ (U-Net skip
    connections).  Any rank >= 2; dims 0 (batch) and ``axis`` are never
    cropped.  Tensors in, a tensor out."""
    large = torch.as_tensor(large)
    small = torch.as_tensor(small)
    axis = axis % large.ndim  # a negative axis, e.g. -1 for channels last
    slices = []
    for d in range(large.ndim):
        if d in (0, axis) or large.shape[d] == small.shape[d]:
            slices.append(slice(None))
        else:
            diff = large.shape[d] - small.shape[d]
            if diff < 0:
                raise ValueError(
                    f"safe_concat: large dim {d} smaller than small "
                    f"({tuple(large.shape)} vs {tuple(small.shape)})")
            lo = diff // 2
            slices.append(slice(lo, lo + small.shape[d]))
    return torch.cat([large[tuple(slices)], small], dim=axis)

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
"""
import json
import os
import struct
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .. import config
from ..config.keys import Retry
from ..interop import from_flax, to_flax, wire_leaves
from ..ops.quantize import GROUP, dequantize_int8, quantize_int8_many, wire_layout
from ..resilience import transport as _transport
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


def _pack_parts(arrays, codec=None, seed=0):
    """(header bytes, data blobs, data CRC32) for a list of ndarrays or
    torch tensors.  ``codec='int8'`` quantizes the float arrays of each
    device together into the data section's layout (array ``i`` of the
    payload seeded ``seed + i``, whatever the kinds of the others); other
    arrays pass raw.  A quantized array's blobs are views of that one host
    buffer, which they keep alive."""
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
    entries, blobs = [], []
    for i, a in enumerate(arrays):
        if i in quantized:
            t, g, vals, scales = quantized[i]
            entries.append({
                "shape": list(t.shape), "dtype": _numpy_dtype(t).str, "codec": "int8",
                "groups": g,
            })
            blobs += [vals, scales]
        else:
            h = _host(a)
            entries.append({"shape": list(h.shape), "dtype": h.dtype.str})
            blobs.append(h.tobytes())
    crc = _transport.crc32(*blobs)
    manifest = json.dumps({
        "e": entries,
        "crc": crc,
        "size": sum(len(b) for b in blobs),
    }).encode("utf-8")
    header = b"".join([_MAGIC_V2, struct.pack("<Q", len(manifest)), manifest])
    return header, blobs, crc


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


def load_arrays(path, retry=None):
    """Read back a :func:`save_arrays` payload, verifying its checksum and
    the directory manifest's CRC.  ``retry`` (a
    :class:`~..resilience.retry.RetryPolicy`) retries absent, incomplete
    or corrupt payloads with backoff; exhaustion re-raises the typed
    error."""
    attempt = 0
    started = time.monotonic()
    while True:
        attempt += 1
        try:
            with open(path, "rb") as f:
                payload = f.read()
            entry = _transport.manifest_entry(path)
            return unpack_arrays(
                payload,
                expected_crc=None if entry is None else entry.get("crc32"),
            )
        except (FileNotFoundError, WireError) as exc:
            exc = _transport.classify_load_failure(path, exc)
            if retry is None or not retry.should_retry(attempt, started):
                raise exc from None
            delay = retry.delay(attempt)
            retry.note("retries")
            if delay > 0:
                time.sleep(delay)


def load_arrays_many(paths, retry=None):
    """Load several payload files concurrently — the aggregator's fan-in.

    Loads are ISSUED in sorted-path order (each with its own retry fork
    keyed on that rank) and the results return in the caller's order, so
    the order of a directory listing never changes a load's behavior."""
    paths = list(paths)
    if not paths:
        return []
    order = sorted(range(len(paths)), key=lambda i: paths[i])

    def task(rank, i):
        return load_arrays(paths[i], retry=None if retry is None else retry.fork(rank))

    with ThreadPoolExecutor(max_workers=min(len(paths), os.cpu_count() or 1)) as pool:
        ranked = list(pool.map(task, range(len(order)), order))
    out = [None] * len(paths)
    for r, i in enumerate(order):
        out[i] = ranked[r]
    return out


def save_wire(path, arrays, salt="", cache=None, precision_bits=None):
    """Serialize an outbound payload at the configured precision — the one
    choke point sites and aggregator share.  At ``precision_bits=8`` the
    int8 codec's seed is ``(stable_file_id(salt) + counter) % 2**31``, array
    ``i`` taking ``seed + i``, and the counter advances in
    ``cache['_wire_seed']`` by the number of arrays, so rounding noise is
    independent across nodes and rounds."""
    cache = cache if cache is not None else {}
    if cache.get(Retry.ASYNC_WIRE_COMMIT):
        raise NotImplementedError(
            "async_wire_commit (the background committer) is not ported yet "
            "(ROADMAP.md Queue 1: native wire)"
        )
    counter = int(cache.get("_wire_seed", 0))
    seed = (stable_file_id(salt) + counter) % (2 ** 31)
    arr_list = list(arrays) if isinstance(arrays, (list, tuple)) else [arrays]
    cache["_wire_seed"] = counter + len(arr_list)
    return save_arrays(path, arr_list, codec=config.wire_codec(precision_bits),
                       seed=seed)


def aslist(x):
    """Normalize a sequence that may come back as an index-keyed dict."""
    if x is None:
        return []
    if isinstance(x, dict):
        return [x[k] for k in sorted(x, key=lambda s: int(s))]
    return list(x)


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

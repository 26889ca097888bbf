"""Integrity-checked atomic wire transport.

The same contract as the JAX package's ``resilience/transport.py``: payloads
commit through tmp file + fsync + ``os.replace`` and are recorded (bytes +
CRC32) in a per-directory ``.wire_manifest.json``, so a reader sees a
payload absent or complete, never partial, and can tell *not yet relayed*
from *partially relayed* from *corrupted*.  The tmp file is written by the
native gather-write (``native/wire.cc``; the Python writer under
``COINN_NATIVE=0``), the same bytes either way.  Load-failure hooks let the
chaos harness (``resilience/chaos.py``) repair a damaged payload between
two load attempts.

The opt-in background commit (:class:`BackgroundCommitter`, on with
``cache['async_wire_commit']``): a payload's pack, write, fsync and
manifest run on one worker thread, overlapping the caller's next step; a
node flushes it, re-raising the first commit error, before its output JSON
names the files (:func:`flush_async`).
"""
import contextlib
import json
import os
import threading
import zlib

from .. import native

#: name of the per-directory commit manifest written next to payloads
MANIFEST_NAME = ".wire_manifest.json"

_MANIFEST_LOCK = threading.Lock()


class WireError(ValueError):
    """Base for wire-payload integrity failures (a ``ValueError``)."""


class WireCorruption(WireError):
    """Payload bytes fail their embedded checksum, or are not a COINN wire
    payload at all."""


class WireIncomplete(WireError):
    """Payload is shorter than its header/manifest says — a truncated write
    or a relay caught mid-copy.  Retryable."""


def crc32(*buffers):
    """CRC32 over a sequence of byte buffers (the payload data section)."""
    c = 0
    for b in buffers:
        c = zlib.crc32(b, c)
    return c & 0xFFFFFFFF


def _fsync_file(path):
    with open(path, "rb+") as f:
        os.fsync(f.fileno())


def _tmp_name(path):
    """Process- and thread-unique: the committer thread and the caller may
    commit at once."""
    return f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"


def commit_bytes(path, header, blobs, crc=None, fsync=True, manifest=True):
    """Atomically commit ``header + blobs`` to ``path``; returns total bytes.
    tmp file → fsync → ``os.replace``, the tmp file gather-written by the
    native runtime (``native.pack_file``) unless ``COINN_NATIVE=0``.
    ``crc`` (CRC32 of ``blobs``) lands in the directory manifest."""
    path = str(path)
    blobs = list(blobs)
    tmp = _tmp_name(path)
    try:
        if not native.pack_file(tmp, header, blobs):
            with open(tmp, "wb") as f:
                f.write(header)
                for b in blobs:
                    f.write(b)
                if fsync:
                    f.flush()
                    os.fsync(f.fileno())
        elif fsync:
            _fsync_file(tmp)
        os.replace(tmp, path)
    except BaseException:
        with contextlib.suppress(OSError):
            os.unlink(tmp)
        raise
    nbytes = len(header) + sum(len(b) for b in blobs)
    if manifest:
        record_manifest(
            os.path.dirname(path) or ".", os.path.basename(path),
            nbytes, crc if crc is not None else crc32(*blobs),
        )
    return nbytes


def atomic_copy(src, dst):
    """Relay-side atomic file copy: a reader of ``dst`` never observes a
    partial copy."""
    import shutil

    tmp = _tmp_name(dst)
    try:
        shutil.copyfile(src, tmp)
        os.replace(tmp, dst)
    except BaseException:
        with contextlib.suppress(OSError):
            os.unlink(tmp)
        raise


def _manifest_path(dirpath):
    return os.path.join(dirpath, MANIFEST_NAME)


def read_manifest(dirpath):
    """The directory's commit manifest (``{}`` when absent or unreadable)."""
    try:
        with open(_manifest_path(dirpath), "r", encoding="utf-8") as f:
            data = json.load(f)
        return data if isinstance(data, dict) else {}
    except (OSError, ValueError):
        return {}


def record_manifest(dirpath, fname, nbytes, crc):
    """Atomically record one committed payload in the directory manifest."""
    with _MANIFEST_LOCK:
        data = read_manifest(dirpath)
        files = data.setdefault("files", {})
        data["v"] = 1
        seq = int(data.get("seq", 0)) + 1
        data["seq"] = seq
        files[str(fname)] = {"bytes": int(nbytes), "crc32": int(crc), "seq": seq}
        tmp = _tmp_name(_manifest_path(dirpath))
        try:
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(data, f, separators=(",", ":"))
            os.replace(tmp, _manifest_path(dirpath))
        except BaseException:
            with contextlib.suppress(OSError):
                os.unlink(tmp)
            raise


def manifest_entry(path):
    """The manifest entry naming ``path``, or None (no expectation)."""
    d, fname = os.path.split(str(path))
    return read_manifest(d or ".").get("files", {}).get(fname)


def classify_load_failure(path, exc):
    """Map a raw load failure to the most specific typed error: a file the
    manifest names but that is absent or short is :class:`WireIncomplete`;
    anything already typed passes through."""
    if isinstance(exc, WireError):
        return exc
    entry = manifest_entry(path)
    if not os.path.exists(path):
        if entry:
            return WireIncomplete(
                f"{path}: named in the wire manifest ({entry['bytes']} bytes "
                "committed by the sender) but not present — relay incomplete"
            )
        return exc
    if entry:
        size = os.path.getsize(path)
        if size < int(entry["bytes"]):
            return WireIncomplete(
                f"{path}: {size} bytes on disk, manifest says "
                f"{entry['bytes']} — partially relayed"
            )
    return exc


# ------------------------------------------------------- load-failure hooks
# In-process observers notified when a verified load fails (per attempt).
# The chaos harness registers here so a deterministically damaged payload
# can be repaired (the relay completing) between retry attempts.
_LOAD_FAILURE_HOOKS = []


def add_load_failure_hook(fn):
    _LOAD_FAILURE_HOOKS.append(fn)


def remove_load_failure_hook(fn):
    with contextlib.suppress(ValueError):
        _LOAD_FAILURE_HOOKS.remove(fn)


def notify_load_failure(path, attempt, exc):
    """Run the registered hooks; True when any hook says it changed the
    world (e.g. repaired the payload), so another attempt is worth it."""
    changed = False
    for fn in list(_LOAD_FAILURE_HOOKS):
        try:
            changed = bool(fn(path, attempt, exc)) or changed
        except Exception:  # noqa: BLE001 — a hook must never mask the load error
            pass
    return changed


# -------------------------------------------------------- background commit
class BackgroundCommitter:
    """One worker thread that runs outbound commits while the caller goes
    on.  ``submit`` queues a commit thunk; ``flush`` waits until the queue
    drains and re-raises the first error (a payload that never committed
    must fail the round before the protocol names it)."""

    def __init__(self):
        import queue

        self._q = queue.Queue()
        self._errors = []
        self._lock = threading.Lock()
        self._thread = threading.Thread(target=self._worker, name="coinn-wire-commit",
                                        daemon=True)
        self._thread.start()

    def _worker(self):
        while True:
            fn = self._q.get()
            try:
                fn()
            except BaseException as exc:  # noqa: BLE001 — reported at flush
                with self._lock:
                    self._errors.append(exc)
            finally:
                self._q.task_done()

    def submit(self, fn):
        self._q.put(fn)

    def pending(self):
        """Commits queued or running."""
        return self._q.unfinished_tasks

    def flush(self, raise_errors=True):
        """Wait for every pending commit; re-raise the first failure, or,
        with ``raise_errors=False``, return the errors (the drain a failed
        invocation takes, so its errors never reach the next node this
        process serves)."""
        self._q.join()
        with self._lock:
            errors, self._errors = self._errors, []
        if errors and raise_errors:
            raise errors[0]
        return errors


_COMMITTER = None
_COMMITTER_LOCK = threading.Lock()


def async_committer():
    """The process-wide background committer (made at first use)."""
    global _COMMITTER
    with _COMMITTER_LOCK:
        if _COMMITTER is None:
            _COMMITTER = BackgroundCommitter()
        return _COMMITTER


def flush_async(raise_errors=True):
    """Drain the pending background commits (nothing when none was ever
    submitted) and re-raise the first commit error; with
    ``raise_errors=False`` return the errors instead.  Nodes call it before
    the output JSON that names the files leaves them, and without raising
    when an invocation fails."""
    if _COMMITTER is not None:
        return _COMMITTER.flush(raise_errors=raise_errors)
    return []

"""Structured federation telemetry: typed spans/events to per-node JSONL.

Port of the JAX package's ``telemetry/recorder.py`` (pure Python, record
schema v1, byte for byte the same records).  A :class:`Recorder` appends
typed records (spans with wall clock + duration, instantaneous events,
aggregated counters) to a
``telemetry.<node>.jsonl`` file in its output directory, stamped with the
federation context (node, engine round, fold, epoch, phase); the JAX
package's ``telemetry.collect.load_events`` reads the port's files.

What the port wires so far is the ENGINE lane: ``telemetry.engine.jsonl``
in the engine's workdir, written by ``engine.py`` (rounds, invocations,
the relay, heartbeats, invoke retries and timeouts, chaos injections and
heals, site deaths, async stand-ins) and by ``federation/daemon.py``
(worker start, restart, shutdown, frames) and by
``federation/engine.py`` (the site-vectorized engine's rounds, throughput
metrics, heartbeats, membership events, site deaths and quorum).  Deep layers reach the ambient
recorder through :func:`get_active` (the aggregator's quorum and window
decisions, the reducer's staleness discount); the engine makes its lane
the ambient recorder around the aggregator's invocation.  An aggregator in
a process of its own keeps its records in a :class:`CaptureRecorder` and
ships them back with its result, and the engine writes them to its lane
(:meth:`Recorder.replay`).  The port's nodes ignore
``cache['profile']``/``cache['telemetry']``: the node lanes, ``collect``,
``live``, ``doctor`` and ``serve`` are still to port (``ROADMAP.md``
Queue 1: Telemetry and tools).  The JAX package's ``jax.monitoring``
compile-duration bridge and its ``telemetry:degraded`` event have no
counterpart here.

Design constraints, in priority order:

1. **Zero overhead when disabled.**  The engine lane is the
   :data:`NULL_RECORDER` singleton unless an argument channel carries
   ``profile`` (or ``telemetry``); every method on it is a no-op and
   ``span()`` hands back one shared context manager.
2. **Host-side only.**  Telemetry is I/O + wall clock, never inside a
   traced or captured region.
3. **Crash-friendly and tailable.**  Records buffer in memory and flush as
   one appended write, plus a size-bounded and a wall-clock auto-flush
   (``cache['telemetry_flush_interval_s']``, default 5 s).

Record schema v1 (one JSON object per line; absent context fields are
omitted).  The port writes four of its kinds; its ``wire`` records belong
to the node lanes::

    {"v": 1, "kind": "span",    "name": ..., "cat": ..., "t0": epoch-secs,
     "dur": secs, "node": ..., "round": n, "fold": ..., "epoch": n,
     "phase": ..., ...attrs}
    {"v": 1, "kind": "event",   "name": ..., "cat": ..., "t0": ..., ...}
    {"v": 1, "kind": "metric",  "name": ..., "value": float, "t0": ...,
     "site": attributed-site-id?, ...context}
    {"v": 1, "kind": "counter", "name": ..., "n": total, "t0": flush-time,
     ...context}

``t0`` is ``time.time()``; durations are measured with
``time.perf_counter()``.
"""
import contextlib
import json
import os
import threading
import time

SCHEMA_VERSION = 1
FILE_PREFIX = "telemetry."
FILE_SUFFIX = ".jsonl"

# records buffered before an automatic mid-invocation flush
_AUTOFLUSH_AT = 512

# wall-clock seconds between automatic flushes (the live-tailer contract:
# a long invocation must surface progress mid-epoch, not at its end).
# Overridable via cache['telemetry_flush_interval_s'] (0 disables the
# timer and restores size-bounded-only flushing).  Only consulted on the
# ENABLED path — the disabled fast path never reaches _append.
_FLUSH_INTERVAL_S = 5.0


class _NullSpan:
    """Shared, allocation-free no-op context manager."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _NullRecorder:
    """The disabled-mode fast path: every method is a no-op, ``span()``
    returns one shared context manager, and the singleton is falsy so call
    sites can guard bigger attribute computations with ``if rec.enabled:``."""

    __slots__ = ()
    enabled = False

    def __bool__(self):
        return False

    def span(self, name, cat="phase", **attrs):
        return _NULL_SPAN

    def record_span(self, name, t0, dur, cat="phase", **attrs):
        pass

    def event(self, name, cat="event", **attrs):
        pass

    def metric(self, name, value, site=None, **attrs):
        pass

    def replay(self, records):
        pass

    def count(self, name, n=1):
        pass

    def set_context(self, **kw):
        pass

    def flush(self):
        pass


NULL_RECORDER = _NullRecorder()

# Active-recorder stack: index -1 is the ambient recorder that deep layers
# reach through get_active().  Seeded with the null recorder so a lookup
# never branches.  Per process: the engine activates its lane around one
# aggregator invocation at a time.
_STACK = [NULL_RECORDER]


def get_active():
    """The ambient recorder (the null recorder when none is active)."""
    return _STACK[-1]


@contextlib.contextmanager
def activate(recorder):
    """Make ``recorder`` the ambient recorder for the enclosed block."""
    _STACK.append(recorder)
    try:
        yield recorder
    finally:
        _STACK.pop()


class _Span:
    """Measures one section; emits a span record (and, when a cache is
    attached, accumulates ``cache['profile_stats']`` at FULL precision —
    rounding per accumulation drifts by up to 5e-7 s per call)."""

    __slots__ = ("rec", "name", "cat", "attrs", "t0", "p0")

    def __init__(self, rec, name, cat, attrs):
        self.rec = rec
        self.name = name
        self.cat = cat
        self.attrs = attrs

    def __enter__(self):
        self.t0 = time.time()
        self.p0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        dt = time.perf_counter() - self.p0
        self.rec._end_span(self.name, self.cat, self.t0, dt, self.attrs,
                           failed=exc_type is not None)
        if exc_type is not None:
            # a span dying with an exception may be the process's last act —
            # get the timeline (incl. this failed span) to disk now
            self.rec.flush()
        return False


class Recorder:
    """Per-node telemetry sink.

    ``node`` names the timeline lane (site id, ``"remote"``, ``"engine"``);
    ``cache`` (optional) supplies live federation context (round, fold,
    epoch) and receives ``profile_stats``; ``out_dir`` (optional) is where
    the JSONL file lands — without it the recorder is stats-only.
    """

    enabled = True

    def __init__(self, node, cache=None, out_dir=None):
        self.node = str(node)
        self.cache = cache
        self.out_dir = str(out_dir) if out_dir else None
        self._buffer = []
        self._counters = {}
        self._context = {}
        # a recorder may be shared by threads, so buffer/counter mutation
        # and the flush drain are serialized
        self._lock = threading.Lock()
        self._io_lock = threading.Lock()  # keeps concurrent flushes' JSONL lines whole
        # time-based auto-flush (the live-tailer contract; see
        # _FLUSH_INTERVAL_S).  Resolved once at construction — one node
        # invocation never outlives its recorder's config.
        try:
            interval = float(
                (cache or {}).get("telemetry_flush_interval_s",
                                  _FLUSH_INTERVAL_S)
                or 0.0
            )
        except (TypeError, ValueError):
            interval = _FLUSH_INTERVAL_S
        self._flush_interval = max(interval, 0.0)
        self._flush_deadline = (
            time.monotonic() + self._flush_interval
            if self._flush_interval else None
        )

    # -------------------------------------------------------------- recording
    def set_context(self, **kw):
        """Static context stamped on every record (e.g. the engine's round
        counter, the node's current phase).  ``None`` clears a key."""
        for k, v in kw.items():
            if v is None:
                self._context.pop(k, None)
            else:
                self._context[k] = v

    def _ctx(self):
        ctx = {"node": self.node}
        cache = self.cache
        if cache is not None:
            rnd = cache.get("telemetry_round")
            if rnd is not None:
                ctx["round"] = int(rnd)
            fold = cache.get("split_ix")
            if fold is not None:
                ctx["fold"] = str(fold)
            epoch = cache.get("epoch")
            if epoch is not None:
                ctx["epoch"] = int(epoch)
        ctx.update(self._context)
        return ctx

    def _append(self, record):
        if self.out_dir is None:
            return  # stats-only mode: no sink, no buffering
        with self._lock:
            self._buffer.append(record)
            full = len(self._buffer) >= _AUTOFLUSH_AT or (
                self._flush_deadline is not None
                and time.monotonic() >= self._flush_deadline
            )
        if full:
            self.flush()

    def span(self, name, cat="phase", **attrs):
        """Context manager measuring one section as a span record."""
        return _Span(self, name, cat, attrs)

    def record_span(self, name, t0, dur, cat="phase", **attrs):
        """Emit an already-measured span (start wall clock and duration),
        for a section whose bounds are known only afterwards: the
        site-vectorized engine's round, measured hook to hook."""
        self._end_span(name, cat, float(t0), float(dur), attrs)

    def _end_span(self, name, cat, t0, dt, attrs, failed=False):
        rec = {"v": SCHEMA_VERSION, "kind": "span", "name": name, "cat": cat,
               "t0": t0, "dur": dt}
        rec.update(self._ctx())
        if attrs:
            rec.update(attrs)
        if failed:
            rec["failed"] = True
        self._append(rec)
        if self.cache is not None:
            # per-phase stats; full-precision
            # accumulation (JSON round-trips repr exactly, so nothing is
            # lost across fresh-process invocations either)
            stats = self.cache.setdefault("profile_stats", {})
            s = stats.setdefault(name, {"calls": 0, "total_s": 0.0, "max_s": 0.0})
            s["calls"] += 1
            s["total_s"] += dt
            s["max_s"] = max(s["max_s"], dt)

    def event(self, name, cat="event", **attrs):
        """Instantaneous record (worker restarts, retries, failures)."""
        rec = {"v": SCHEMA_VERSION, "kind": "event", "name": name, "cat": cat,
               "t0": time.time()}
        rec.update(self._ctx())
        if attrs:
            rec.update(attrs)
        self._append(rec)

    def metric(self, name, value, site=None, **attrs):
        """One sample of a numeric series (``kind: "metric"``); ``site``
        attributes an aggregator-side sample to the site it is about."""
        rec = {"v": SCHEMA_VERSION, "kind": "metric", "name": str(name),
               "value": float(value), "t0": time.time()}
        if site is not None:
            rec["site"] = str(site)
        rec.update(self._ctx())
        if attrs:
            rec.update(attrs)
        self._append(rec)

    def replay(self, records):
        """Append records another process made (a :class:`CaptureRecorder`
        shipped back with a node's result) as they are; this recorder's
        context fills only the fields they lack."""
        ctx = self._ctx()
        for record in records or ():
            if isinstance(record, dict):
                self._append({**ctx, **record})

    def count(self, name, n=1):
        """Cheap aggregated counter (e.g. compiled steps run); totals are
        emitted as one ``counter`` record per name at flush time."""
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    # ----------------------------------------------------------------- output
    def path(self):
        if not self.out_dir:
            return None
        return os.path.join(
            self.out_dir, f"{FILE_PREFIX}{_sanitize(self.node)}{FILE_SUFFIX}"
        )

    def flush(self):
        """Append buffered records (and drained counters) to the node's
        JSONL file in one write.  Without an ``out_dir`` this only drops the
        buffer (stats-only mode)."""
        with self._lock:
            if self._flush_interval:
                self._flush_deadline = time.monotonic() + self._flush_interval
            if self._counters:
                now = time.time()
                ctx = self._ctx()
                for name, n in sorted(self._counters.items()):
                    rec = {"v": SCHEMA_VERSION, "kind": "counter",
                           "name": name, "n": int(n), "t0": now}
                    rec.update(ctx)
                    self._buffer.append(rec)
                self._counters = {}
            buffered, self._buffer = self._buffer, []
        if not buffered:
            return
        path = self.path()
        if path is None:
            return
        try:
            os.makedirs(self.out_dir, exist_ok=True)
            lines = "".join(
                json.dumps(r, separators=(",", ":"), default=str) + "\n"
                for r in buffered
            )
            with self._io_lock, open(path, "a", encoding="utf-8") as f:
                f.write(lines)
        except OSError:
            pass  # telemetry must never fail the run


def _sanitize(name):
    return "".join(c if (c.isalnum() or c in "-_") else "_" for c in str(name))


class CaptureRecorder(Recorder):
    """A recorder without a file: it keeps its records in :attr:`records`
    for its caller.  A node running in a process of its own records into
    one and returns the records with its result, and the engine writes
    them to its lane (:meth:`Recorder.replay`)."""

    def __init__(self, node):
        super().__init__(node)
        self.records = []

    def _append(self, record):
        with self._lock:
            self.records.append(record)

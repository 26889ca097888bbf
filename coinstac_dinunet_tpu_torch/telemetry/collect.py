"""Federation telemetry collector: merge per-node JSONL into one timeline
(PyTorch port: the JAX package's ``telemetry/collect.py``, pure Python, the
same code, so both packages' lanes give the same summaries and traces).

Every node of a run (site nodes, the aggregator, the engine) appends
``telemetry.<node>.jsonl`` records into its own output directory
(:mod:`.recorder` documents the schema).  This module walks a run's working
directory, merges every node's records into one wall-clock-ordered
federation timeline, renders a per-node/per-phase summary table, and exports
Chrome-trace JSON (the ``traceEvents`` format) loadable by Perfetto
(https://ui.perfetto.dev) or ``chrome://tracing`` — so a whole k-fold
federated run is visually inspectable: site compute lanes, wire transfers
with byte counts, and the aggregator's reduces, all on one timebase.
"""
import json
import math
import os
import re

from ..config.keys import Metric
from .recorder import FILE_PREFIX, FILE_SUFFIX

_FILE_RE = re.compile(
    re.escape(FILE_PREFIX) + r".+" + re.escape(FILE_SUFFIX) + r"$"
)

# stable Perfetto lane order: the engine first, the aggregator next,
# sites after that (alphabetical), anything else last
_NODE_ORDER = {"engine": 0, "remote": 1}


def find_event_files(root):
    """All telemetry JSONL files under ``root`` (recursive, stable order)."""
    root = str(root)
    if os.path.isfile(root):
        return [root]
    out = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames.sort()
        for name in sorted(filenames):
            if _FILE_RE.match(name):
                out.append(os.path.join(dirpath, name))
    return out


def read_jsonl_segment(path, offset=0):
    """Tolerant incremental JSONL read: records from byte ``offset`` to the
    last COMPLETE (newline-terminated) line of ``path``.

    This is the one line reader shared by the post-hoc :func:`load_events`
    and the live tailer (:mod:`.live`): the Recorder writes each record as
    ``line + "\\n"`` in a single append, so an unterminated trailing line is
    by definition a torn write from a dying (or still-mid-append) site — it
    is never parsed (a truncation can otherwise *mis*-parse as a shorter
    valid value), never consumed, and counted instead.

    Returns ``(records, new_offset, bad_lines, has_partial_tail)``:
    ``new_offset`` points just past the last complete line (the resume
    cursor), ``bad_lines`` counts undecodable complete lines (corruption),
    ``has_partial_tail`` flags unterminated trailing bytes left unread.
    """
    with open(path, "rb") as f:
        f.seek(int(offset))
        data = f.read()
    end = data.rfind(b"\n")
    if end < 0:
        return [], int(offset), 0, bool(data)
    records, bad = [], 0
    for line in data[:end].split(b"\n"):
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line.decode("utf-8"))
        except (ValueError, UnicodeDecodeError):
            bad += 1
            continue
        if isinstance(rec, dict):
            records.append(rec)
        else:
            bad += 1
    return records, int(offset) + end + 1, bad, end + 1 < len(data)


class EventLog(list):
    """A merged record list that additionally carries the torn/corrupt line
    count — plain-list compatible, so every existing ``load_events`` caller
    keeps working while :func:`summarize` surfaces ``truncated_lines``."""

    truncated_lines = 0


def load_events(root_or_files):
    """Parse one run's telemetry records, wall-clock ordered.

    ``root_or_files`` is a run directory (recursively scanned) or an
    explicit list of JSONL paths.  Torn trailing lines (a site killed
    mid-append) and undecodable lines are skipped, never fatal — they are
    COUNTED on the returned :class:`EventLog`'s ``truncated_lines`` and
    surfaced by :func:`summarize`.
    """
    if isinstance(root_or_files, (str, os.PathLike)):
        files = find_event_files(root_or_files)
    else:
        files = [str(p) for p in root_or_files]
    events = EventLog()
    truncated = 0
    for path in files:
        try:
            records, _, bad, partial = read_jsonl_segment(path)
        except OSError:
            continue
        truncated += bad + (1 if partial else 0)
        node = _node_from_filename(path)
        for rec in records:
            rec.setdefault("node", node)
        events.extend(records)
    events.sort(key=lambda r: (float(r.get("t0", 0.0)), r.get("node", "")))
    events.truncated_lines = truncated
    return events


def _node_from_filename(path):
    name = os.path.basename(path)
    if name.startswith(FILE_PREFIX) and name.endswith(FILE_SUFFIX):
        return name[len(FILE_PREFIX):-len(FILE_SUFFIX)]
    return "unknown"


def _node_sort_key(node):
    return (_NODE_ORDER.get(node, 2), str(node))


# ------------------------------------------------------------ wire overlap
def _merge_intervals(intervals):
    """Sorted union of (start, end) intervals."""
    merged = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], end))
        else:
            merged.append((start, end))
    return merged


def wire_overlap_ratio(events):
    """Fraction of the engine's WIRE time hidden under site COMPUTE — the
    async round engine's headline overlap metric.

    Wire time is the engine lane's aggregator invocation (the reduce runs
    inside it) plus the broadcast relay (``invoke:remote`` +
    ``engine:relay`` spans); compute time is the site invocation spans
    (``invoke:<site>``).  The ratio is ``|wire ∩ union(compute)| / |wire|``
    over the merged wall-clock timeline: 0 on a strictly serial engine
    (nothing computes while the wire runs), approaching 1 when stragglers
    compute straight through every reduce+relay.  Returns ``None`` when
    the events carry no wire spans (telemetry off / no engine lane)."""
    wire, compute = [], []
    for rec in events:
        if rec.get("kind") != "span" or rec.get("node") != "engine":
            continue
        name = str(rec.get("name", ""))
        try:
            t0 = float(rec["t0"])
            t1 = t0 + float(rec.get("dur", 0.0) or 0.0)
        except (KeyError, TypeError, ValueError):
            continue
        if t1 <= t0:
            continue
        if name == "invoke:remote" or name == "engine:relay":
            wire.append((t0, t1))
        elif name.startswith("invoke:"):
            compute.append((t0, t1))
    if not wire:
        return None
    wire = _merge_intervals(wire)
    compute = _merge_intervals(compute)
    total = sum(e - s for s, e in wire)
    overlap = 0.0
    ci = 0
    for ws, we in wire:
        while ci < len(compute) and compute[ci][1] <= ws:
            ci += 1
        j = ci
        while j < len(compute) and compute[j][0] < we:
            overlap += min(we, compute[j][1]) - max(ws, compute[j][0])
            j += 1
    return overlap / total if total > 0 else None


# ------------------------------------------------------------------ summary
def new_metric_stats():
    """Empty fold state for one metric series (shared with the doctor so
    the summary table and the postmortem can never disagree on semantics)."""
    return {"count": 0, "nonfinite": 0, "last": None, "min": None, "max": None}


def fold_metric_sample(stats, value):
    """Fold one ``metric`` record's value into ``stats``.  ``last``/``min``/
    ``max`` track FINITE samples only (non-finite ones are counted, not
    aggregated).  Returns the finite float, or None for a non-finite/
    non-numeric sample."""
    stats["count"] += 1
    try:
        v = float(value)
    except (TypeError, ValueError):
        v = float("nan")
    if math.isfinite(v):
        stats["last"] = v
        stats["min"] = v if stats["min"] is None else min(stats["min"], v)
        stats["max"] = v if stats["max"] is None else max(stats["max"], v)
        return v
    stats["nonfinite"] += 1
    return None


def summarize(events):
    """Aggregate a merged timeline into per-node tables.

    Returns ``{"nodes": [...], "spans": {node: {name: {calls,total_s,
    max_s}}}, "wire": {node: {saves,save_bytes,save_raw_bytes,loads,
    load_bytes,ratio}}, "counters": {node: {name: n}},
    "events": {node: {name: n}}, "metrics": {node: {name: {count,
    nonfinite,last,min,max}}}, "wall_s": span of the whole run}``.

    ``reduce:nonfinite_skip`` events additionally surface as a per-SITE
    ``nonfinite_skipped`` counter (attributed to the skipped site's lane,
    not the aggregator that noticed) — the skip was previously an
    aggregator event only, invisible in the summary table.
    """
    spans, wire, counters, evcounts, metrics = {}, {}, {}, {}, {}
    t_lo, t_hi = None, None
    for rec in events:
        node = rec.get("node", "unknown")
        t0 = float(rec.get("t0", 0.0))
        t1 = t0 + float(rec.get("dur", 0.0) or 0.0)
        t_lo = t0 if t_lo is None else min(t_lo, t0)
        t_hi = t1 if t_hi is None else max(t_hi, t1)
        kind = rec.get("kind")
        if kind == "span":
            s = spans.setdefault(node, {}).setdefault(
                rec.get("name", "?"), {"calls": 0, "total_s": 0.0, "max_s": 0.0}
            )
            dur = float(rec.get("dur", 0.0) or 0.0)
            s["calls"] += 1
            s["total_s"] += dur
            s["max_s"] = max(s["max_s"], dur)
        elif kind == "wire":
            w = wire.setdefault(node, {
                "saves": 0, "save_bytes": 0, "save_raw_bytes": 0,
                "loads": 0, "load_bytes": 0,
            })
            if rec.get("op") == "save":
                w["saves"] += 1
                w["save_bytes"] += int(rec.get("bytes", 0) or 0)
                w["save_raw_bytes"] += int(
                    rec.get("raw_bytes", rec.get("bytes", 0)) or 0
                )
            else:
                w["loads"] += 1
                w["load_bytes"] += int(rec.get("bytes", 0) or 0)
        elif kind == "counter":
            c = counters.setdefault(node, {})
            name = rec.get("name", "?")
            c[name] = c.get(name, 0) + int(rec.get("n", 0) or 0)
        elif kind == "metric":
            name = rec.get("name", "?")
            m = metrics.setdefault(node, {}).setdefault(
                name, new_metric_stats()
            )
            fold_metric_sample(m, rec.get("value"))
        elif kind == "event":
            e = evcounts.setdefault(node, {})
            name = rec.get("name", "?")
            e[name] = e.get(name, 0) + 1
            if name == "reduce:nonfinite_skip":
                # per-site visibility: credit each skipped SITE's lane with
                # a counter, so the summary table shows who got excluded
                for site in rec.get("sites", []) or []:
                    c = counters.setdefault(str(site), {})
                    c["nonfinite_skipped"] = c.get("nonfinite_skipped", 0) + 1
    for node, w in wire.items():
        w["ratio"] = (
            round(w["save_raw_bytes"] / w["save_bytes"], 4)
            if w["save_bytes"] else None
        )
    nodes = sorted(
        set(spans) | set(wire) | set(counters) | set(evcounts) | set(metrics),
        key=_node_sort_key,
    )
    return {
        "nodes": nodes, "spans": spans, "wire": wire, "counters": counters,
        "events": evcounts, "metrics": metrics,
        "wall_s": (round(t_hi - t_lo, 6) if t_lo is not None else 0.0),
        # torn/corrupt line count carried by load_events' EventLog (0 for a
        # plain list) — a dying site's last write is evidence, not noise
        "truncated_lines": int(getattr(events, "truncated_lines", 0) or 0),
    }


def _fmt_bytes(n):
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024 or unit == "GiB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{int(n)}B"
        n /= 1024.0
    return f"{n}B"


def render_summary(summary):
    """Human-readable per-phase/per-site table for a merged timeline."""
    lines = [f"federation wall-clock: {summary['wall_s']:.3f}s"]
    if summary.get("truncated_lines"):
        lines.append(
            f"!! {summary['truncated_lines']} truncated/undecodable JSONL "
            "line(s) skipped (torn writes from dying writers)"
        )
    for node in summary["nodes"]:
        lines.append(f"\n[{node}]")
        spans = summary["spans"].get(node, {})
        if spans:
            width = max(len(n) for n in spans)
            lines.append(
                f"  {'span'.ljust(width)}  {'calls':>6} {'total_s':>10} "
                f"{'mean_ms':>9} {'max_ms':>9}"
            )
            for name in sorted(spans, key=lambda n: -spans[n]["total_s"]):
                s = spans[name]
                mean_ms = 1e3 * s["total_s"] / max(s["calls"], 1)
                lines.append(
                    f"  {name.ljust(width)}  {s['calls']:>6} "
                    f"{s['total_s']:>10.4f} {mean_ms:>9.2f} "
                    f"{1e3 * s['max_s']:>9.2f}"
                )
        w = summary["wire"].get(node)
        if w:
            ratio = f" (codec ratio {w['ratio']:.2f}x)" if w.get("ratio") else ""
            lines.append(
                f"  wire: out {w['saves']} files / "
                f"{_fmt_bytes(w['save_bytes'])}{ratio}; "
                f"in {w['loads']} files / {_fmt_bytes(w['load_bytes'])}"
            )
        c = summary["counters"].get(node)
        if c:
            lines.append(
                "  counters: " + ", ".join(
                    f"{k}={v}" for k, v in sorted(c.items())
                )
            )
        e = summary["events"].get(node)
        if e:
            lines.append(
                "  events: " + ", ".join(
                    f"{k}×{v}" for k, v in sorted(e.items())
                )
            )
        m = summary.get("metrics", {}).get(node)
        if m:
            parts = []
            for name, st in sorted(m.items()):
                last = "-" if st["last"] is None else f"{st['last']:.4g}"
                nf = f" !{st['nonfinite']}nf" if st["nonfinite"] else ""
                parts.append(f"{name}={last} (n={st['count']}{nf})")
            lines.append("  metrics: " + ", ".join(parts))
    return "\n".join(lines)


# ------------------------------------------------------------- chrome trace
# perf flight-recorder series (telemetry/perf.py) exported as per-node
# "utilization" counter tracks — built from the config/keys.py vocabulary
# so a new perf series can never silently fall back to the plain category
_UTILIZATION_METRICS = frozenset((
    Metric.SAMPLES_PER_SEC, Metric.ACHIEVED_TFLOPS, Metric.MFU,
    Metric.HBM_IN_USE, Metric.HBM_PEAK, Metric.HBM_LIMIT,
    Metric.HBM_UTILIZATION, Metric.ROUNDS_PER_SEC, Metric.SITES_PER_SEC,
))
_CTX_KEYS = ("round", "fold", "epoch", "phase")
_RECORD_KEYS = ("v", "kind", "name", "cat", "t0", "dur", "node", "op",
                "file", "bytes", "arrays", "codec", "raw_bytes", "ratio",
                "n", "value", "site") + _CTX_KEYS


def _args_for(rec):
    """Chrome-trace ``args`` payload: the federation context plus any
    record-specific attributes."""
    args = {k: rec[k] for k in _CTX_KEYS if k in rec}
    for k, v in rec.items():
        if k not in _RECORD_KEYS:
            args[k] = v
    for k in ("file", "bytes", "arrays", "codec", "raw_bytes", "ratio"):
        if k in rec:
            args[k] = rec[k]
    return args


def chrome_trace(events):
    """Merged timeline → Chrome trace-event JSON (Perfetto-loadable).

    One trace "process" per node (pid = stable lane order), spans as
    complete (``ph: "X"``) events, wire transfers as complete events on a
    dedicated wire thread lane, instantaneous events as ``ph: "i"``, and
    cumulative wire-byte counters (``ph: "C"``) so Perfetto plots the
    transfer volume over time.
    """
    nodes = sorted({r.get("node", "unknown") for r in events}, key=_node_sort_key)
    pid = {n: i + 1 for i, n in enumerate(nodes)}
    out = []
    for n in nodes:
        out.append({"name": "process_name", "ph": "M", "pid": pid[n], "tid": 0,
                    "args": {"name": str(n)}})
        out.append({"name": "process_sort_index", "ph": "M", "pid": pid[n],
                    "tid": 0, "args": {"sort_index": pid[n]}})
        for tid, label in ((1, "phases"), (2, "wire"), (3, "events")):
            out.append({"name": "thread_name", "ph": "M", "pid": pid[n],
                        "tid": tid, "args": {"name": label}})
    cum_bytes = {}
    cum_counters = {}
    for rec in events:
        node = rec.get("node", "unknown")
        p = pid[node]
        ts = float(rec.get("t0", 0.0)) * 1e6
        kind = rec.get("kind")
        if kind == "span":
            out.append({
                "name": rec.get("name", "?"), "cat": rec.get("cat", "phase"),
                "ph": "X", "ts": ts,
                "dur": max(float(rec.get("dur", 0.0) or 0.0) * 1e6, 1.0),
                "pid": p, "tid": 1, "args": _args_for(rec),
            })
        elif kind == "wire":
            op = rec.get("op", "save")
            out.append({
                "name": f"wire:{op}:{rec.get('file', '?')}", "cat": "wire",
                "ph": "X", "ts": ts,
                "dur": max(float(rec.get("dur", 0.0) or 0.0) * 1e6, 1.0),
                "pid": p, "tid": 2, "args": _args_for(rec),
            })
            key = (node, op)
            cum_bytes[key] = cum_bytes.get(key, 0) + int(rec.get("bytes", 0) or 0)
            out.append({
                "name": f"wire_bytes_{op}", "cat": "wire", "ph": "C", "ts": ts,
                "pid": p, "tid": 0,
                "args": {"bytes": cum_bytes[key]},
            })
        elif kind == "metric":
            try:
                v = float(rec.get("value"))
            except (TypeError, ValueError):
                v = float("nan")
            name = rec.get("name", "?")
            if math.isfinite(v):
                suffix = f":{rec['site']}" if rec.get("site") else ""
                out.append({
                    "name": f"metric:{name}{suffix}",
                    # perf flight-recorder series get their own Perfetto
                    # category so per-node utilization tracks are filterable
                    "cat": ("utilization" if name in _UTILIZATION_METRICS
                            else "metric"),
                    "ph": "C", "ts": ts, "pid": p, "tid": 0,
                    "args": {"value": v},
                })
            else:
                # a NaN sample breaks Perfetto counter tracks (and strict
                # JSON) — surface it as an instant marker with the value
                # stringified
                args = _args_for(rec)
                args["value"] = str(rec.get("value"))
                if rec.get("site"):
                    args["site"] = rec["site"]
                out.append({
                    "name": f"metric:{name}:nonfinite", "cat": "metric",
                    "ph": "i", "ts": ts, "pid": p, "tid": 3, "s": "t",
                    "args": args,
                })
        elif kind == "counter":
            # counter records are per-flush DELTAS (Recorder.flush drains
            # the counters); accumulate so the Perfetto track is the
            # monotone total, like the wire-bytes track
            key = (node, rec.get("name", "?"))
            cum_counters[key] = (
                cum_counters.get(key, 0) + int(rec.get("n", 0) or 0)
            )
            out.append({
                "name": rec.get("name", "?"), "cat": "counter", "ph": "C",
                "ts": ts, "pid": p, "tid": 0,
                "args": {"n": cum_counters[key]},
            })
        else:  # event
            out.append({
                "name": rec.get("name", "?"), "cat": rec.get("cat", "event"),
                "ph": "i", "ts": ts, "pid": p, "tid": 3, "s": "t",
                "args": _args_for(rec),
            })
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def write_chrome_trace(path, events):
    trace = chrome_trace(events)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(trace, f, separators=(",", ":"))
    return trace

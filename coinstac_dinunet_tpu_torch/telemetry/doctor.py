"""``telemetry doctor`` — merge a run's telemetry into a postmortem report
(PyTorch port: the JAX package's ``telemetry/doctor.py``, pure Python; the
same report for the same records, only :func:`bench_regime` stamps the
port's libraries and card).

The collector (:mod:`.collect`) answers *where did the time and bytes go*;
the doctor answers *what went wrong and who did it*.  It merges every node's
spans + metric series + anomaly events into:

- an **anomaly timeline** (wall-clock ordered watchdog findings with round +
  site attribution),
- a **per-site divergence table** (cosine-to-mean stats, non-finite rounds,
  nonfinite-skip counts, anomaly counts per site),
- a **round-throughput trend** (engine:round span durations, first-half vs
  second-half drift),
- **ranked likely-cause verdicts** — ordered heuristics over the evidence
  (a site shipping NaNs outranks a validation stall outranks a slow round),
- optionally a **benchmark regression check** against a bench history
  JSONL (one ledger line per run; >10% samples/sec/chip drop vs the
  previous entry becomes a verdict).  The check is metric-aware over mixed
  ledgers: EVERY metric's latest same-metric pair is evaluated and the
  worst regression surfaces, so each metric of a mixed ledger regresses
  independently.

Renderers: markdown (the human postmortem, uploaded as a CI artifact), JSON
(machines), and ``--format github`` workflow annotations for CI.
"""
import json
import math
import os
import sys

from .collect import fold_metric_sample, new_metric_stats

#: verdict severity order (rank 0 = most likely the root cause)
_SEVERITY = {"critical": 0, "warning": 1, "info": 2}


def _finite(v):
    try:
        return math.isfinite(float(v))
    except (TypeError, ValueError):
        return False


# ------------------------------------------------------------------ report
def build_report(events, bench_history=None, regression_threshold=0.10):
    """Merged timeline records → postmortem report dict.

    ``bench_history`` is a list of bench JSON dicts (oldest first) as read
    by :func:`load_bench_history`; the last two entries feed the regression
    verdict.
    """
    anomalies = []
    sites = {}
    metrics = {}
    rounds = []
    quarantined = set()
    # resilience-layer evidence: retry pressure, recovered corruption,
    # retry-attributed site deaths, injected chaos faults
    resilience = {"wire_retries": 0, "corruption_recovered": 0,
                  "invoke_retries": 0, "stale_standins": 0,
                  "staleness_blocks": 0}
    dead_sites = {}
    chaos = []
    # perf flight recorder evidence: the backend's roofline constants
    # (perf:backend), retained profiler captures (capture:profile), and
    # cost-analysis degradation (perf:cost_unavailable)
    backend = None
    captures = []
    cost_unavailable = []

    def site_entry(site):
        return sites.setdefault(str(site), {
            "cosine_n": 0, "cosine_sum": 0.0, "cosine_min": None,
            "nonfinite_rounds": 0, "skipped_rounds": 0, "anomalies": 0,
        })

    for rec in events:
        kind = rec.get("kind")
        name = rec.get("name", "")
        if kind == "metric":
            m = metrics.setdefault(name, new_metric_stats())
            v = fold_metric_sample(m, rec.get("value"))
            if name == "site_cosine" and rec.get("site") is not None:
                s = site_entry(rec["site"])
                if v is not None:
                    s["cosine_n"] += 1
                    s["cosine_sum"] += v
                    s["cosine_min"] = v if s["cosine_min"] is None else min(
                        s["cosine_min"], v
                    )
                else:
                    s["nonfinite_rounds"] += 1
        elif kind == "event":
            if name.startswith("anomaly:"):
                entry = {
                    "anomaly": name.split(":", 1)[1],
                    "t0": float(rec.get("t0", 0.0)),
                    "node": rec.get("node"),
                    "round": rec.get("round"),
                    "metric": rec.get("metric"),
                    "value": rec.get("value"),
                    "site": rec.get("site"),
                    "detail": rec.get("detail"),
                }
                anomalies.append(entry)
                if entry["site"] is not None:
                    site_entry(entry["site"])["anomalies"] += 1
            elif name == "reduce:nonfinite_skip":
                for s in rec.get("sites", []) or []:
                    site_entry(s)["skipped_rounds"] += 1
            elif name == "quarantine" and rec.get("site") is not None:
                quarantined.add(str(rec["site"]))
            elif name == "wire:retry":
                resilience["wire_retries"] += 1
            elif name == "wire:corruption_recovered":
                resilience["corruption_recovered"] += 1
            elif name == "invoke:retry":
                resilience["invoke_retries"] += 1
            elif name == "async:stale":
                resilience["stale_standins"] += 1
            elif name == "async:staleness_exceeded":
                resilience["staleness_blocks"] += 1
            elif name == "site_died" and rec.get("site") is not None:
                dead_sites[str(rec["site"])] = {
                    "round": rec.get("round"),
                    "attempts": int(rec.get("attempts", 1) or 1),
                    "retries_exhausted": bool(rec.get("retries_exhausted")),
                    "error": str(rec.get("error", ""))[:300],
                }
            elif name == "chaos:inject":
                chaos.append({
                    "kind": rec.get("fault"),
                    "round": rec.get("fault_round", rec.get("round")),
                    "site": rec.get("site"),
                    "file": rec.get("file"),
                })
            elif name == "perf:backend" and backend is None:
                backend = {
                    "device_kind": rec.get("device_kind"),
                    "devices": rec.get("devices"),
                    "peak_tflops": rec.get("peak_tflops"),
                    "peak_source": rec.get("peak_source"),
                    "ceiling_mfu": rec.get("ceiling_mfu"),
                }
            elif name == "capture:profile":
                captures.append({
                    "anomaly": rec.get("anomaly"),
                    "round": rec.get("round"),
                    "node": rec.get("node"),
                    "path": rec.get("path"),
                })
            elif name == "perf:cost_unavailable":
                cost_unavailable.append(str(rec.get("reason", "")))
        elif kind == "span" and name == "engine:round":
            rounds.append(float(rec.get("dur", 0.0) or 0.0))

    anomalies.sort(key=lambda a: a["t0"])
    # a permanent fault fires once per invocation attempt — collapse to one
    # entry per pinned fault, carrying the firing count
    deduped = {}
    for c in chaos:
        key = (c["kind"], c["round"], c["site"], c["file"])
        if key in deduped:
            deduped[key]["firings"] += 1
        else:
            deduped[key] = dict(c, firings=1)
    chaos = list(deduped.values())
    for s in sites.values():
        n = s.pop("cosine_n")
        total = s.pop("cosine_sum")
        s["cosine_mean"] = round(total / n, 4) if n else None
        if s["cosine_min"] is not None:
            s["cosine_min"] = round(s["cosine_min"], 4)

    round_stats = None
    if rounds:
        half = len(rounds) // 2
        first = rounds[:half] or rounds
        second = rounds[half:] or rounds
        mean = sum(rounds) / len(rounds)
        trend = (
            (sum(second) / len(second)) / max(sum(first) / len(first), 1e-12)
            - 1.0
        )
        round_stats = {
            "count": len(rounds),
            "mean_s": round(mean, 4),
            "max_s": round(max(rounds), 4),
            "trend_pct": round(100.0 * trend, 1),
        }

    bench = _bench_verdict_data(bench_history, regression_threshold)
    report = {
        "anomalies": anomalies,
        "sites": sites,
        "rounds": round_stats,
        "metrics": metrics,
        "quarantined": sorted(quarantined),
        "bench": bench,
        "resilience": resilience,
        "dead_sites": dead_sites,
        "chaos": chaos,
        "roofline": _roofline_data(metrics, backend, cost_unavailable),
        "captures": captures,
        "mfu_floor": _mfu_floor_data(
            bench_history, metrics, regression_threshold
        ),
    }
    report["verdicts"] = _rank_verdicts(report)
    return report


# --------------------------------------------------------------- roofline
_PERF_SERIES = ("achieved_tflops", "mfu", "samples_per_sec",
                "rounds_per_sec", "sites_per_sec")
_MEMORY_SERIES = {
    "in_use_bytes": "hbm_in_use_bytes", "peak_bytes": "hbm_peak_bytes",
    "limit_bytes": "hbm_limit_bytes", "utilization": "hbm_utilization",
}


def _roofline_data(metrics, backend, cost_unavailable):
    """Achieved-vs-ceiling-vs-peak comparison + device-memory summary from
    the folded metric series.  None when the run recorded no perf series
    at all (a pre-flight-recorder trace renders exactly as before)."""
    perf = {k: metrics[k] for k in _PERF_SERIES if k in metrics}
    memory = {k: metrics[m] for k, m in _MEMORY_SERIES.items()
              if m in metrics}
    if not perf and not memory and backend is None:
        return None
    out = {"backend": backend, "memory": memory or None}
    out.update({k: perf.get(k) for k in _PERF_SERIES})
    if cost_unavailable:
        # the series can be truncated/absent for a VISIBLE reason
        out["cost_unavailable"] = sorted(set(cost_unavailable))
    return out


def _mfu_floor_data(bench_history, metrics, threshold):
    """MFU-floor check: the run's best measured MFU vs the ledger's last
    recorded ``mfu`` (a bench writes one per entry).  One entry is
    enough — the floor is an absolute reference, unlike the two-entry
    throughput diff."""
    if not bench_history:
        return None
    ref = next(
        (float(e["mfu"]) for e in reversed(bench_history)
         if _finite(e.get("mfu")) and float(e["mfu"]) > 0),
        None,
    )
    measured = (metrics.get("mfu") or {}).get("max")
    if ref is None or measured is None:
        return None
    return {
        "ledger_mfu": ref,
        # 6 decimals: CPU-host MFU against a nominal peak is legitimately
        # ~1e-6, which a 4-decimal round would display as a confusing 0.0
        "measured_mfu": round(float(measured), 6),
        "threshold_pct": round(100.0 * threshold, 1),
        "below_floor": float(measured) < ref * (1.0 - threshold),
    }


def _installed_version(name):
    """A library's version from the loaded module or the installed
    distribution, without importing it; None when neither knows."""
    version = getattr(sys.modules.get(name), "__version__", None)
    if version is None:
        try:
            from importlib import metadata

            version = metadata.version(name)
        except Exception:  # noqa: BLE001 — stamp what's knowable
            version = None
    return str(version) if version is not None else None


def _card():
    """``(name, power limit)`` of the first card as ``nvidia-smi`` reports
    them, or ``(None, None)`` without one."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None, None
    first = out.strip().splitlines()[0] if out.strip() else ""
    name, _, limit = first.rpartition(",")
    return (name.strip() or None), (limit.strip() or None)


def bench_regime(seed=None):
    """The measurement regime a bench ledger line is produced under: the
    torch, CUDA and numpy versions, the card's name and power limit
    (``nvidia-smi``), the platform triple and the bench seed, so the
    regression verdict can tell a real throughput drop from a library
    upgrade, another card or power limit, or another sampling seed.
    ``"jax": None`` is stamped too: a port line and a JAX line then
    disagree on a key both stamp, and either package's
    :func:`regime_mismatch` refuses to diff them.  Imports no library just
    to stamp it."""
    import platform as _platform

    torch_mod = sys.modules.get("torch")
    cuda = getattr(getattr(torch_mod, "version", None), "cuda", None)
    card, power_limit = _card()
    regime = {
        "jax": None,
        "torch": _installed_version("torch"),
        "cuda": cuda,
        "device": card,
        "power_limit": power_limit,
        "numpy": _installed_version("numpy"),
        "platform": (f"{_platform.system()}-{_platform.machine()}"
                     f"-py{_platform.python_version()}"),
    }
    if seed is not None:
        regime["seed"] = int(seed)
    return regime


def regime_mismatch(prev, last):
    """The regime keys two ledger entries DISAGREE on, or None when they
    are comparable.  An unstamped side (pre-regime ledger lines) is
    comparable — only a key both sides stamped with different values
    refuses the diff."""
    ra, rb = prev.get("regime"), last.get("regime")
    if not isinstance(ra, dict) or not isinstance(rb, dict):
        return None
    bad = sorted(k for k in set(ra) & set(rb) if ra[k] != rb[k])
    return bad or None


def _bench_pair_data(prev, last, threshold):
    pv, lv = prev.get("value"), last.get("value")
    if not (_finite(pv) and _finite(lv)) or float(pv) <= 0:
        return None
    drop = 1.0 - float(lv) / float(pv)
    refused = regime_mismatch(prev, last)
    return {
        "previous": float(pv), "latest": float(lv),
        "drop_pct": round(100.0 * drop, 1),
        # a cross-regime pair is REFUSED, never silently diffed: the
        # drop (or gain) would be attributed to the code when it may be
        # the library, machine, or seed that moved
        "regressed": drop > threshold and not refused,
        "refused": bool(refused),
        "refused_keys": refused or [],
        "threshold_pct": round(100.0 * threshold, 1),
        # name the metric + unit so the verdict reads correctly for any
        # ledger (samples/sec/chip, rounds/sec, per-engine series, ...)
        "metric": str(last.get("metric") or "bench"),
        "unit": str(last.get("unit") or "samples/sec/chip"),
    }


def _bench_verdict_data(bench_history, threshold):
    """Latest same-metric pair comparison over a possibly mixed-metric
    ledger (the engine A/B appends one line per engine kind into
    BENCH_FEDERATION_HISTORY.jsonl — diffing a daemon entry against a
    vectorized one would be apples vs oranges).  EVERY metric's latest
    pair is evaluated; the verdict surfaces the worst regression, or the
    final entry's metric comparison when nothing regressed."""
    if not bench_history or len(bench_history) < 2:
        return None
    latest_pairs = {}  # metric -> (prev, last), walking oldest -> newest
    for e in bench_history:
        m = e.get("metric")
        prev_last = latest_pairs.get(m)
        latest_pairs[m] = ((prev_last[1] if prev_last else None), e)
    candidates = {}
    for m, (prev, last) in latest_pairs.items():
        if prev is None:
            continue
        data = _bench_pair_data(prev, last, threshold)
        if data is not None:
            candidates[m] = data
    if not candidates:
        return None
    regressed = [d for d in candidates.values() if d["regressed"]]
    if regressed:
        return max(regressed, key=lambda d: d["drop_pct"])
    refused = [d for d in candidates.values() if d.get("refused")]
    if refused:
        # a refusal outranks a clean comparison in the verdict: a silent
        # skip is exactly the failure mode the regime stamp exists to fix
        return max(refused, key=lambda d: abs(d["drop_pct"]))
    return candidates.get(
        bench_history[-1].get("metric"),
        next(iter(candidates.values())),
    )


def _rank_verdicts(report):
    """Evidence → ordered likely-cause list.  Severity first, then how much
    evidence backs the verdict."""
    verdicts = []

    def add(severity, cause, evidence, weight=1):
        verdicts.append({
            "severity": severity, "cause": cause, "evidence": evidence,
            "_w": weight,
        })

    # dead sites: the engine's site_died events carry the invocation
    # attempt count, so the verdict attributes the death to *exhausted
    # retries* (the retry/backoff policy ran out) vs a *hard failure*
    # declared on the first invocation (no retry configured)
    for site, d in sorted(report.get("dead_sites", {}).items()):
        if d["retries_exhausted"]:
            how = (
                f"declared dead after exhausting {d['attempts']} invocation "
                "attempts (retry/backoff ran out)"
            )
        else:
            how = "hard failure on its first invocation (no retry configured)"
        add(
            "critical",
            f"site {site} died mid-run",
            how
            + (f" at round {d['round']}" if d.get("round") is not None else "")
            + (f": {d['error']}" if d.get("error") else ""),
            weight=d["attempts"],
        )

    # one-bad-site corruption: the strongest, most attributable signal.
    # nonfinite_rounds (NaN site_cosine samples) and skipped_rounds
    # (reduce:nonfinite_skip events) describe the SAME corrupted reduces
    # from two record kinds — max, not sum, or the blast radius doubles
    for site, s in sorted(report["sites"].items()):
        bad = max(s["nonfinite_rounds"], s["skipped_rounds"])
        if bad:
            first = next(
                (a["round"] for a in report["anomalies"]
                 if a["site"] == site and a["anomaly"] == "nonfinite"),
                None,
            )
            add(
                "critical",
                f"site {site} shipped non-finite gradients",
                f"{bad} affected reduce round(s)"
                + (f", first anomaly at round {first}" if first is not None
                   else "")
                + (", quarantined" if site in report["quarantined"] else
                   ", excluded per-round by the nonfinite guard"),
                weight=bad,
            )
    by_kind = {}
    for a in report["anomalies"]:
        by_kind.setdefault(a["anomaly"], []).append(a)
    for site, s in sorted(report["sites"].items()):
        outliers = [a for a in by_kind.get("divergence_outlier", [])
                    if a["site"] == site]
        if outliers:
            add(
                "critical",
                f"site {site} diverged from the consensus gradient",
                f"{len(outliers)} divergence anomaly(ies); "
                f"mean cosine {s['cosine_mean']}, min {s['cosine_min']}",
                weight=len(outliers),
            )
    for kind, severity, cause in (
        ("grad_explosion", "critical", "gradient explosion"),
        ("memory_pressure", "critical",
         "device memory near its limit (OOM imminent)"),
        ("memory_leak", "warning",
         "device memory grew round over round (leak)"),
        ("compression_spike", "warning",
         "compression reconstruction error spiked"),
        ("rank_collapse", "warning",
         "compression factorization rank collapsed"),
        ("val_stall", "warning", "validation metric stalled"),
    ):
        hits = by_kind.get(kind, [])
        if hits:
            where = sorted({a["node"] for a in hits if a["node"]})
            first = hits[0]
            add(
                severity, cause,
                f"{len(hits)} anomaly(ies) on {', '.join(where) or '?'}; "
                f"first at round {first['round']}: {first['detail'] or ''}",
                weight=len(hits),
            )
    rounds = report.get("rounds")
    if rounds and rounds["count"] >= 4 and rounds["trend_pct"] > 20.0:
        add(
            "warning", "round throughput degraded over the run",
            f"second-half rounds {rounds['trend_pct']:+.1f}% vs first half "
            f"(mean {rounds['mean_s']}s over {rounds['count']} rounds)",
        )
    bench = report.get("bench")
    if bench and bench["regressed"]:
        add(
            "warning",
            "benchmark throughput regressed vs the previous run",
            f"{bench.get('unit', 'samples/sec/chip')} {bench['latest']:g} "
            f"vs {bench['previous']:g} ({bench['drop_pct']:+.1f}% drop, "
            f"threshold {bench['threshold_pct']:g}%)",
        )
    elif bench and bench.get("refused"):
        add(
            "warning",
            "bench regression check refused: cross-regime ledger pair",
            f"{bench['metric']} entries were measured under different "
            f"regimes ({', '.join(bench['refused_keys'])} changed) — "
            f"the {bench['drop_pct']:+.1f}% delta is not attributable to "
            "the code; re-baseline the ledger on the current regime",
        )
    floor = report.get("mfu_floor")
    if floor and floor["below_floor"]:
        add(
            "warning",
            "MFU below the benchmark ledger floor",
            f"measured MFU {floor['measured_mfu']:g} vs ledger "
            f"{floor['ledger_mfu']:g} (threshold "
            f"{floor['threshold_pct']:g}%) — the run sustained less of the "
            "hardware than the last recorded bench",
        )
    roof = report.get("roofline") or {}
    util = (roof.get("memory") or {}).get("utilization") or {}
    if util.get("max") is not None and util["max"] >= 0.9:
        add(
            "warning",
            "device memory headroom below 10%",
            f"peak HBM utilization {util['max']:.1%} — the next allocation "
            "spike is an OOM; shrink the batch or shard the state",
        )
    captures = report.get("captures") or []
    if captures:
        named = "; ".join(
            f"{c['anomaly']} @ round {c['round']} → {c['path']}"
            for c in captures
        )
        add(
            "info",
            f"{len(captures)} profiler capture(s) retained",
            f"anomaly-triggered deep captures attached: {named}",
            weight=len(captures),
        )
    res = report.get("resilience") or {}
    if res.get("corruption_recovered"):
        add(
            "warning",
            "wire payload corruption/truncation recovered via retry",
            f"{res['corruption_recovered']} payload(s) recovered after "
            f"{res['wire_retries']} wire retry(ies) — the data was intact "
            "on arrival, but the relay is flaky",
            weight=res["corruption_recovered"],
        )
    chaos = report.get("chaos") or []
    if chaos:
        named = ", ".join(
            f"{c['kind']} @ round {c['round']}"
            + (f"/{c['site']}" if c.get("site") else "")
            + (f" ({c['file']})" if c.get("file") else "")
            for c in chaos
        )
        add(
            "info",
            f"{len(chaos)} deterministic chaos fault(s) were injected",
            f"fault plan active: {named} — the failures above are expected "
            "and the recovery paths they exercised are the evidence",
            weight=len(chaos),
        )
    if not verdicts:
        add("info", "no anomalies detected",
            "all watched series stayed within bounds")
    verdicts.sort(key=lambda v: (_SEVERITY[v["severity"]], -v["_w"]))
    for rank, v in enumerate(verdicts, 1):
        v.pop("_w")
        v["rank"] = rank
    return verdicts


# --------------------------------------------------------------- renderers
def _stat(series, fmt="{:.4g}"):
    """last (min..max, n) rendering of one folded metric-stats dict."""
    if not series or series.get("last") is None:
        return "-"
    return (fmt.format(series["last"])
            + f" (min {fmt.format(series['min'])}, "
              f"max {fmt.format(series['max'])}, n={series['count']})")


def _gib(series):
    if not series or series.get("last") is None:
        return "-"
    scaled = dict(series)
    for k in ("last", "min", "max"):
        if isinstance(scaled.get(k), (int, float)):
            scaled[k] = scaled[k] / 2**30
    return _stat(scaled, fmt="{:.3f}GiB")


def _render_roofline(report):
    """The roofline + device-memory block: achieved TFLOPS/MFU against the
    structural ceiling and the backend peak, plus the HBM series.  Empty
    list when the run recorded no perf flight-recorder series."""
    roof = report.get("roofline")
    if not roof:
        return []
    lines = ["## Roofline (perf flight recorder)", ""]
    backend = roof.get("backend") or {}
    if backend.get("device_kind"):
        peak = backend.get("peak_tflops")
        lines.append(
            f"Backend: {backend['device_kind']} × "
            f"{backend.get('devices') or '?'}"
            + (f", peak {peak:g} TFLOPS ({backend.get('peak_source')})"
               if peak else ", peak unknown (set cache['peak_tflops'])")
            + (f", structural ceiling {backend['ceiling_mfu']:.0%} MFU "
               "(docs/PERF.md)" if backend.get("ceiling_mfu") else "")
            + "."
        )
        lines.append("")
    rows = [
        ("achieved TFLOPS", _stat(roof.get("achieved_tflops"))),
        ("MFU", _stat(roof.get("mfu"))),
        ("samples/sec", _stat(roof.get("samples_per_sec"))),
    ]
    if roof.get("rounds_per_sec"):
        rows.append(("rounds/sec", _stat(roof["rounds_per_sec"])))
    if roof.get("sites_per_sec"):
        rows.append(("sites/sec", _stat(roof["sites_per_sec"])))
    lines.extend(_md_table(("series", "last (min..max, samples)"), rows))
    lines.append("")
    memory = roof.get("memory")
    if memory:
        rows = [(label, _gib(memory.get(key)) if "bytes" in key
                 else _stat(memory.get(key)))
                for key, label in (
                    ("in_use_bytes", "HBM in use"),
                    ("peak_bytes", "HBM peak"),
                    ("limit_bytes", "HBM limit"),
                    ("utilization", "HBM utilization"),
                ) if memory.get(key)]
        lines.append("### Device memory")
        lines.append("")
        lines.extend(_md_table(("series", "last (min..max, samples)"), rows))
        lines.append("")
    floor = report.get("mfu_floor")
    if floor:
        state = ("**BELOW FLOOR**" if floor["below_floor"]
                 else "at or above the floor")
        lines.append(
            f"MFU floor: measured {floor['measured_mfu']:g} vs ledger "
            f"{floor['ledger_mfu']:g} (threshold {floor['threshold_pct']:g}%)"
            f" — {state}."
        )
        lines.append("")
    if roof.get("cost_unavailable"):
        lines.append(
            "Cost analysis unavailable for some executables: "
            + ", ".join(roof["cost_unavailable"]) + "."
        )
        lines.append("")
    return lines


def _md_table(headers, rows):
    out = ["| " + " | ".join(headers) + " |",
           "|" + "|".join("---" for _ in headers) + "|"]
    for row in rows:
        out.append("| " + " | ".join(str(c) for c in row) + " |")
    return out


def render_markdown(report):
    """The human postmortem (CI artifact / PR comment body)."""
    lines = ["# Federation health postmortem", ""]

    lines.append("## Verdicts (ranked)")
    lines.append("")
    for v in report["verdicts"]:
        lines.append(
            f"{v['rank']}. **[{v['severity']}] {v['cause']}** — {v['evidence']}"
        )
    lines.append("")

    chaos = report.get("chaos") or []
    if chaos:
        lines.append("## Injected chaos faults")
        lines.append("")
        lines.extend(_md_table(
            ("kind", "round", "site", "file", "firings"),
            [(c["kind"], c["round"], c.get("site") or "-",
              c.get("file") or "-", c.get("firings", 1)) for c in chaos],
        ))
        lines.append("")

    dead = report.get("dead_sites") or {}
    res = report.get("resilience") or {}
    if dead or any(res.values()):
        lines.append("## Resilience")
        lines.append("")
        lines.append(
            f"{res.get('wire_retries', 0)} wire retry(ies), "
            f"{res.get('corruption_recovered', 0)} corrupt/truncated "
            f"payload(s) recovered, {res.get('invoke_retries', 0)} "
            "invocation retry(ies)."
            + (f" Async rounds: {res['stale_standins']} straggler "
               f"stand-in(s) delivered, {res.get('staleness_blocks', 0)} "
               "forced block(s) past the staleness window."
               if res.get("stale_standins") or res.get("staleness_blocks")
               else "")
        )
        lines.append("")
        if dead:
            lines.extend(_md_table(
                ("dead site", "round", "attempts", "cause"),
                [(site,
                  d["round"] if d.get("round") is not None else "-",
                  d["attempts"],
                  "retries exhausted" if d["retries_exhausted"]
                  else "hard failure")
                 for site, d in sorted(dead.items())],
            ))
            lines.append("")

    if report["anomalies"]:
        lines.append("## Anomaly timeline")
        lines.append("")
        rows = [
            (a["round"] if a["round"] is not None else "-",
             a["node"] or "-", a["anomaly"], a["site"] or "-",
             a["metric"] or "-", a["value"], a["detail"] or "")
            for a in report["anomalies"]
        ]
        lines.extend(_md_table(
            ("round", "node", "anomaly", "site", "metric", "value", "detail"),
            rows,
        ))
        lines.append("")

    if report["sites"]:
        lines.append("## Per-site divergence")
        lines.append("")
        rows = []
        for site, s in sorted(report["sites"].items()):
            flags = []
            if site in report["quarantined"]:
                flags.append("quarantined")
            rows.append((
                site,
                s["cosine_mean"] if s["cosine_mean"] is not None else "-",
                s["cosine_min"] if s["cosine_min"] is not None else "-",
                s["nonfinite_rounds"], s["skipped_rounds"], s["anomalies"],
                ",".join(flags) or "-",
            ))
        lines.extend(_md_table(
            ("site", "cosine mean", "cosine min", "nonfinite", "skipped",
             "anomalies", "flags"),
            rows,
        ))
        lines.append("")

    rounds = report.get("rounds")
    if rounds:
        lines.append("## Round throughput")
        lines.append("")
        lines.append(
            f"{rounds['count']} engine rounds, mean {rounds['mean_s']}s, "
            f"max {rounds['max_s']}s, second-half trend "
            f"{rounds['trend_pct']:+.1f}%."
        )
        lines.append("")

    lines.extend(_render_roofline(report))

    captures = report.get("captures") or []
    if captures:
        lines.append("## Profiler captures")
        lines.append("")
        lines.extend(_md_table(
            ("anomaly", "round", "node", "profile"),
            [(c["anomaly"] or "-", c["round"] if c["round"] is not None
              else "-", c["node"] or "-", c["path"] or "-")
             for c in captures],
        ))
        lines.append("")

    bench = report.get("bench")
    if bench:
        lines.append("## Benchmark history")
        lines.append("")
        if bench["regressed"]:
            state = "**REGRESSED**"
        elif bench.get("refused"):
            state = ("**REFUSED** (cross-regime: "
                     f"{', '.join(bench['refused_keys'])} changed)")
        else:
            state = "within bounds"
        lines.append(
            f"{bench.get('unit', 'samples/sec/chip')} {bench['latest']:g} "
            f"vs previous {bench['previous']:g} ({bench['drop_pct']:+.1f}%; "
            f"threshold {bench['threshold_pct']:g}%) — {state}."
        )
        lines.append("")

    if report["metrics"]:
        lines.append("## Metric series")
        lines.append("")
        rows = [
            (name, m["count"], m["nonfinite"],
             "-" if m["last"] is None else f"{m['last']:.4g}",
             "-" if m["min"] is None else f"{m['min']:.4g}",
             "-" if m["max"] is None else f"{m['max']:.4g}")
            for name, m in sorted(report["metrics"].items())
        ]
        lines.extend(_md_table(
            ("metric", "samples", "nonfinite", "last", "min", "max"), rows,
        ))
        lines.append("")
    return "\n".join(lines)


def _github_escape(text):
    return str(text).replace("%", "%25").replace("\r", "%0D").replace("\n", "%0A")


def render_github(report):
    """GitHub workflow annotations: one ::error per critical verdict, one
    ::warning per warning verdict (inline on the PR's checks page)."""
    lines = []
    for v in report["verdicts"]:
        if v["severity"] == "info":
            continue
        cmd = "error" if v["severity"] == "critical" else "warning"
        lines.append(
            f"::{cmd} title=telemetry doctor::"
            f"{_github_escape(v['cause'] + ' — ' + v['evidence'])}"
        )
    lines.append(
        f"{len(report['anomalies'])} anomaly(ies), "
        f"{len(report['verdicts'])} verdict(s)"
    )
    return "\n".join(lines)


# ------------------------------------------------------------ bench history
def load_bench_history(path):
    """``BENCH_HISTORY.jsonl`` (one bench JSON line per run, oldest first)
    → list of dicts.  Missing file → empty list; corrupt lines skipped."""
    out = []
    if not path or not os.path.exists(path):
        return out
    try:
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if isinstance(rec, dict):
                    out.append(rec)
    except OSError:
        pass
    return out

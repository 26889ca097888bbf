"""Stdlib-only HTTP exporters for the live ops plane: ``/metrics`` + ``/healthz``
(PyTorch port: the JAX package's ``telemetry/serve.py``, pure Python).

Serves the :class:`~.live.LiveState` snapshot two ways:

- ``GET /metrics`` — Prometheus text exposition format (version 0.0.4):
  per-site round/heartbeat-age/liveness gauges, federation rounds/sec, MFU,
  samples/sec, wire-byte and anomaly/chaos/retry counters, and a
  ``verdicts_total{kind=...}`` counter per in-flight verdict kind.  Every
  metric name is ``coinstac_dinunet_<series>``
  (:attr:`~..config.keys.Live.PROM_PREFIX`); the series suffixes reuse the
  :class:`~..config.keys.Metric` vocabulary verbatim, whose names keep to
  the legal Prometheus charset so the mapping can never mangle a name.
- ``GET /healthz`` — the whole snapshot as JSON, with the top-level
  ``status`` (``ok``/``warning``/``critical``) an orchestrator's liveness
  probe can key on.

No dependencies beyond ``http.server`` — the exporter must work inside the
same minimal site container the engine invokes, which is also why the
server binds loopback by default (an operator exposes it deliberately).
"""
import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..config.keys import Live
from .recorder import get_active as _telemetry

PROM_PREFIX = Live.PROM_PREFIX

_NAME_OK = re.compile(r"^[a-z_][a-z0-9_]*$")
_LABEL_BAD = re.compile(r'[\\"\n]')


def prometheus_name(series):
    """``<PROM_PREFIX>_<series>``, with any character outside the legal
    Prometheus metric charset replaced by ``_``.  The config/keys.py
    vocabularies are lint-pinned to already-legal spellings, so for every
    declared series this mapping is the identity plus the prefix."""
    series = re.sub(r"[^a-z0-9_]", "_", str(series).lower())
    if not _NAME_OK.match(series):
        series = "_" + series
    return f"{PROM_PREFIX}_{series}"


def _label(value):
    return _LABEL_BAD.sub("_", str(value))


class _PromWriter:
    def __init__(self):
        self.lines = []
        self._seen = set()

    def gauge(self, series, value, help_text, labels=None):
        self.sample(series, value, help_text, "gauge", labels)

    def counter(self, series, value, help_text, labels=None):
        self.sample(series, value, help_text, "counter", labels)

    def sample(self, series, value, help_text, kind, labels=None):
        if value is None:
            return
        name = prometheus_name(series)
        if name not in self._seen:
            self._seen.add(name)
            self.lines.append(f"# HELP {name} {help_text}")
            self.lines.append(f"# TYPE {name} {kind}")
        label_s = ""
        if labels:
            label_s = "{" + ",".join(
                f'{k}="{_label(v)}"' for k, v in sorted(labels.items())
            ) + "}"
        # full precision (repr round-trips float64 exactly): %g's 6
        # significant digits would quantize large counters (wire bytes on a
        # long run), making small increments invisible to rate()/increase()
        self.lines.append(f"{name}{label_s} {float(value)!r}")

    def render(self):
        return "\n".join(self.lines) + "\n"


def render_prometheus(snap):
    """LiveState snapshot -> Prometheus text exposition."""
    w = _PromWriter()
    w.gauge("up", 1, "live ops plane exporter is serving")
    w.gauge("round", snap.get("round"), "highest engine round observed")
    w.counter("rounds_total", snap.get("rounds_done"),
              "completed engine:round spans observed")
    w.gauge("rounds_per_sec", snap.get("rounds_per_sec"),
            "EMA of federation round throughput")
    mfu = snap.get("mfu") or {}
    w.gauge("mfu", mfu.get("last"), "latest model FLOPS utilization sample")
    w.gauge("samples_per_sec", snap.get("samples_per_sec"),
            "latest training throughput sample")
    # one loop per FAMILY: the text exposition format requires every line
    # of one metric to form a single contiguous group — interleaving the
    # families per op/site would be rejected by strict collectors
    wire = snap.get("wire") or {}
    for op in ("save", "load"):
        w.counter("wire_bytes_total", wire.get(f"{op}_bytes"),
                  "cumulative wire payload bytes by direction",
                  labels={"op": op})
    for op in ("save", "load"):
        w.gauge("wire_bytes_per_sec", wire.get(f"{op}_rate_bps"),
                "wire payload byte rate over the rolling window",
                labels={"op": op})
    anomalies = snap.get("anomalies") or {}
    w.counter("anomalies_total", anomalies.get("total"),
              "watchdog anomaly events observed")
    w.counter("chaos_injections_total", snap.get("chaos_injections"),
              "deterministic chaos faults injected")
    w.counter("worker_restarts_total", snap.get("worker_restarts"),
              "daemon workers killed and restarted by the supervisor")
    w.counter("wire_retries_total", snap.get("wire_retries"),
              "wire load retries observed")
    w.counter("corruption_recovered_total", snap.get("corruption_recovered"),
              "corrupt/truncated payloads recovered via retry")
    w.counter("truncated_lines_total", snap.get("truncated_lines"),
              "torn/undecodable telemetry JSONL lines skipped by the tailer")
    w.gauge("dead_sites", len(snap.get("dead_sites") or ()),
            "sites declared dead by the engine")
    sites = snap.get("sites") or {}
    for name, s in sites.items():
        w.gauge("site_round", s.get("round"),
                "per-site latest observed round", labels={"site": name})
    for name, s in sites.items():
        w.gauge("site_heartbeat_age_seconds", s.get("heartbeat_age_s"),
                "seconds since the site's last record/heartbeat",
                labels={"site": name})
    for name, s in sites.items():
        w.gauge("site_dead", 1 if s.get("status") == "dead" else 0,
                "1 when the engine declared the site dead",
                labels={"site": name})
    for name, s in sites.items():
        w.counter("site_anomalies_total", s.get("anomalies"),
                  "watchdog anomalies attributed to the site",
                  labels={"site": name})
    for name, s in sites.items():
        w.counter("site_worker_restarts_total", s.get("worker_restarts"),
                  "daemon worker restarts attributed to the site",
                  labels={"site": name})
    for name, s in sites.items():
        # async rounds only: absent (None) outside async mode so lockstep
        # scrapes carry no empty series
        w.gauge("site_staleness", s.get("staleness"),
                "rounds the site's last contribution lags the aggregator "
                "(async staleness window)", labels={"site": name})
    w.gauge("staleness_k", snap.get("staleness_k") or None,
            "configured async staleness bound k (absent on lockstep runs)")
    w.counter("stale_standins_total", snap.get("stale_standins"),
              "straggler stand-ins delivered by the async round engine")
    for name, s in sites.items():
        # run-ahead pipelining only: absent (None) otherwise, so
        # non-pipelined scrapes carry no empty series
        w.gauge("site_run_ahead", s.get("run_ahead"),
                "broadcasts the site's pending invocation is running "
                "ahead of the last one it consumed (run-ahead pipeline)",
                labels={"site": name})
    w.gauge("run_ahead_d", snap.get("run_ahead_d") or None,
            "configured run-ahead pipelining depth d (absent when off)")
    w.counter("reduce_concurrent_seconds_total",
              snap.get("reduce_concurrent_s"),
              "seconds the reduce+relay tail ran while site invocations "
              "were in flight (the pipelining win)")
    w.counter("pipeline_stalls_total", snap.get("pipeline_stalls"),
              "times the engine blocked on the reducer worker at the "
              "run-ahead horizon")
    fb = snap.get("frame_bytes") or {}
    for direction in ("tx", "rx"):
        w.counter("daemon_frame_bytes_total", fb.get(direction),
                  "daemon frame-pipe bytes by direction (the delta-cache "
                  "win is the per-invoke trend)",
                  labels={"dir": direction})
    roster = snap.get("roster") or {}
    w.gauge("roster_size", roster.get("members"),
            "live elastic-membership roster size (absent on fixed-roster "
            "runs)")
    changes = roster.get("changes") or {}
    if roster.get("epoch") or changes:
        for kind in ("join", "leave", "rejoin", "refused"):
            w.counter("membership_changes_total", changes.get(kind, 0),
                      "elastic-membership roster transitions, by kind",
                      labels={"kind": kind})
    by_kind = {}
    for v in snap.get("verdicts") or ():
        by_kind[v["verdict"]] = by_kind.get(v["verdict"], 0) + 1
    for kind in (Live.VERDICT_SILENCE, Live.VERDICT_ROUND_OUTLIER,
                 Live.VERDICT_MFU_COLLAPSE, Live.VERDICT_RETRY_STORM,
                 Live.VERDICT_STALENESS, Live.VERDICT_PIPELINE,
                 Live.VERDICT_QUORUM_EROSION):
        w.counter("verdicts_total", by_kind.get(kind, 0),
                  "in-flight stall verdicts fired, by kind",
                  labels={"kind": kind})
    return w.render()


def render_healthz(snap):
    """LiveState snapshot -> the ``/healthz`` JSON body."""
    return json.dumps(snap, indent=2, sort_keys=True, default=str)


class OpsServer:
    """Threaded loopback HTTP server over a snapshot provider.

    ``snapshot_fn()`` must return the current :meth:`.live.LiveState
    .snapshot` dict — it is called per request, so the scrape always sees
    the freshest ingested state (the watch loop mutates the LiveState from
    one thread; snapshot() only reads, and a slightly-torn read is
    acceptable for monitoring data).
    """

    def __init__(self, snapshot_fn, host="127.0.0.1", port=0):
        self._snapshot_fn = snapshot_fn

        class Handler(BaseHTTPRequestHandler):
            def do_GET(handler):  # noqa: N805 — http.server API
                try:
                    if handler.path.split("?", 1)[0] == "/metrics":
                        body = render_prometheus(snapshot_fn()).encode()
                        ctype = "text/plain; version=0.0.4; charset=utf-8"
                    elif handler.path.split("?", 1)[0] == "/healthz":
                        body = render_healthz(snapshot_fn()).encode()
                        ctype = "application/json"
                    else:
                        handler.send_error(404, "try /metrics or /healthz")
                        return
                except Exception as exc:  # noqa: BLE001 — a scrape must not kill the watch
                    handler.send_error(500, str(exc)[:200])
                    return
                handler.send_response(200)
                handler.send_header("Content-Type", ctype)
                handler.send_header("Content-Length", str(len(body)))
                handler.end_headers()
                handler.wfile.write(body)

            def log_message(handler, *a):  # scrapes are not board output
                pass

        self._httpd = ThreadingHTTPServer((host, int(port)), Handler)
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, kwargs={"poll_interval": 0.2},
            daemon=True, name="telemetry-ops-server",
        )
        self._thread.start()

    @property
    def port(self):
        return self._httpd.server_address[1]

    @property
    def host(self):
        return self._httpd.server_address[0]

    def url(self, path="/metrics"):
        return f"http://{self.host}:{self.port}{path}"

    def scrape(self, path="/metrics", timeout=5.0):
        """A genuine HTTP self-scrape (what CI archives as the artifact)."""
        from urllib.request import urlopen

        with urlopen(self.url(path), timeout=timeout) as resp:
            return resp.read().decode("utf-8")

    def close(self, timeout=2.0):
        """Stop serving and JOIN the serving thread.  Returns True when
        the thread exited within ``timeout``; a thread that failed to
        join (a scrape wedged in a handler) leaves a listener behind
        between CI jobs, so the failure is surfaced as a typed
        ``telemetry:degraded`` event on the ambient recorder — evidence
        in the trace instead of a silent leak."""
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=timeout)
        if self._thread.is_alive():
            _telemetry().event(
                "telemetry:degraded", cat="telemetry",
                what="ops server thread failed to join on close "
                     "(listener may leak until process exit)",
                thread=self._thread.name, timeout_s=float(timeout),
            )
            return False
        return True

"""Live federation ops plane: incremental JSONL tailing + in-flight state
(PyTorch port: the JAX package's ``telemetry/live.py``, pure Python, the
same board, snapshot and verdicts for the same records).

Everything else in :mod:`coinstac_dinunet_tpu_torch.telemetry` is post-hoc — the
collector and the doctor re-read whole files after the run is over, so by
the time a postmortem names a wedged site a 1,000-site federation has been
burning chips for the entire window.  This module watches the SAME per-node
``telemetry.<node>.jsonl`` records *while the run is alive*:

- :func:`~.collect.read_jsonl_segment` (shared with the collector) reads
  complete lines only — an unterminated trailing line from a dying writer
  is counted, never parsed, never consumed.
- :class:`Tailer` turns that into an incremental, rotation/crash-safe
  poller: per-file byte cursors (optionally persisted to a sidecar JSON so
  a restarted tailer resumes without replaying), rotation/truncation
  detection via inode + size regression, and partial-tail carry-over (the
  torn line is re-examined next poll, when the writer may have finished it).
- :class:`LiveState` folds the event vocabulary into a federation-wide
  picture — per-site current round/phase/last heartbeat, rounds/sec and
  MFU EMAs, wire-byte rates, anomaly/chaos/retry counters, dead and
  quarantined sites — and fires **edge-triggered in-flight verdicts**
  (:class:`~..config.keys.Live` kinds) with the doctor's
  ``severity``/``cause``/``evidence`` shape, so the live board and the
  postmortem speak one language.
- :func:`render_board` renders the refreshing ``telemetry watch`` terminal
  status board (:mod:`.__main__`); :mod:`.serve` exports the same snapshot
  as Prometheus ``/metrics`` + ``/healthz``.

The heartbeat feed: both engines emit a lightweight ``engine:heartbeat``
event per node invocation (``engine.py`` site/remote loops; the
site-vectorized engine once per round with the alive count), and the
Recorder's wall-clock auto-flush (default 5 s) gets them to disk
mid-invocation.  Liveness is judged on record ``t0`` wall-clock stamps —
comparable across node processes on one host, the same contract the merged
timeline already relies on.

The persistent engine daemon (:mod:`~..federation.daemon`) plugs in
natively: its warm workers pulse the same ``engine:heartbeat`` per
completed invocation, and the supervisor's ``worker:restart`` events
surface as federation + per-site ``worker_restarts`` counters on the
board, ``/metrics`` and ``/healthz`` — a long-lived worker is exactly the
thing you watch with heartbeats, not autopsies.  Staleness-bounded async
rounds plug into the same substrate.
"""
import json
import os
import statistics
import threading
import time
from collections import deque

from ..config.keys import Daemon, Live, Metric
from .collect import find_event_files, read_jsonl_segment

_EMA_DECAY = 0.8
_ROUND_WINDOW = 32      # rolling round-duration window (median basis)
_ROUND_MIN_SAMPLES = 5  # rounds before the outlier rule can judge
_MFU_MIN_SAMPLES = 5    # MFU samples before the collapse rule can judge
_WIRE_RATE_WINDOW_S = 15.0

#: verdict kind -> doctor severity (the shared vocabulary)
VERDICT_SEVERITY = {
    Live.VERDICT_SILENCE: "critical",
    Live.VERDICT_ROUND_OUTLIER: "warning",
    Live.VERDICT_MFU_COLLAPSE: "warning",
    Live.VERDICT_RETRY_STORM: "warning",
    Live.VERDICT_STALENESS: "warning",
    Live.VERDICT_PIPELINE: "warning",
    Live.VERDICT_QUORUM_EROSION: "warning",
}


# ------------------------------------------------------------------- tailer
class Tailer:
    """Incremental poller over a run directory's telemetry JSONL files.

    ``root`` is the run directory (re-scanned every poll, so lanes that
    appear mid-run — a fresh site's first flush — are picked up) or an
    explicit list of paths.  ``cursor_path`` (optional) persists the
    per-file byte cursors to a sidecar JSON after every poll, so a
    restarted tailer resumes where it left off instead of replaying the
    whole run.

    Crash/rotation safety, in order of the checks :meth:`poll` makes per
    file: an inode change or a size BELOW the cursor means the file was
    rotated/truncated (cursor resets to 0); reads consume complete lines
    only (``read_jsonl_segment``), so a torn trailing line from a dying —
    or merely mid-append — writer is left for the next poll; undecodable
    complete lines are counted on :attr:`truncated_lines` and skipped.
    """

    def __init__(self, root, cursor_path=None):
        self.root = root
        self.cursor_path = str(cursor_path) if cursor_path else None
        self._cursors = {}  # path -> {"offset": int, "ino": int}
        self.truncated_lines = 0
        self.polls = 0
        if self.cursor_path and os.path.exists(self.cursor_path):
            try:
                with open(self.cursor_path, "r", encoding="utf-8") as f:
                    saved = json.load(f)
                if isinstance(saved, dict):
                    self._cursors = {
                        str(p): {"offset": int(c.get("offset", 0)),
                                 "ino": int(c.get("ino", 0))}
                        for p, c in saved.get("files", {}).items()
                        if isinstance(c, dict)
                    }
                    self.truncated_lines = int(saved.get("truncated_lines", 0))
            except (OSError, ValueError):
                self._cursors = {}  # corrupt sidecar: start from scratch

    def _discover(self):
        if isinstance(self.root, (str, os.PathLike)):
            return find_event_files(str(self.root))
        return [str(p) for p in self.root]

    def poll(self):
        """All records appended since the previous poll, wall-clock ordered
        (each stamped with its lane's node name)."""
        from .collect import _node_from_filename

        records = []
        for path in self._discover():
            try:
                st = os.stat(path)
            except OSError:
                continue
            cur = self._cursors.get(path)
            offset = cur["offset"] if cur else 0
            if cur and (st.st_ino != cur["ino"] or st.st_size < offset):
                offset = 0  # rotated or truncated underneath us: re-read
            if st.st_size <= offset:
                self._cursors[path] = {"offset": offset, "ino": st.st_ino}
                continue
            try:
                recs, new_offset, bad, _partial = read_jsonl_segment(
                    path, offset
                )
            except OSError:
                continue
            self.truncated_lines += bad
            node = _node_from_filename(path)
            for rec in recs:
                rec.setdefault("node", node)
            records.extend(recs)
            self._cursors[path] = {"offset": new_offset, "ino": st.st_ino}
        records.sort(key=lambda r: (float(r.get("t0", 0.0)),
                                    r.get("node", "")))
        self.polls += 1
        self._save_cursors()
        return records

    def _save_cursors(self):
        """Atomic sidecar commit (tmp + replace) — a tailer killed
        mid-write must never leave a half-written cursor file that a
        restart would trust."""
        if not self.cursor_path:
            return
        try:
            os.makedirs(os.path.dirname(self.cursor_path) or ".",
                        exist_ok=True)
            tmp = self.cursor_path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump({"files": self._cursors,
                           "truncated_lines": self.truncated_lines}, f)
            os.replace(tmp, self.cursor_path)
        except OSError:
            pass  # the tailer must never fail the watch


# --------------------------------------------------------------- live state
def _site_entry():
    return {"round": 0, "phase": None, "epoch": None, "last_seen": None,
            "last_heartbeat": None, "anomalies": 0, "dead": False,
            "died_retries_exhausted": False, "quarantined": False,
            "worker_restarts": 0, "staleness": None, "run_ahead": None}


class LiveState:
    """Federation-wide in-flight state machine over the merged event stream.

    Feed it batches from a :class:`Tailer` (:meth:`ingest`), then
    :meth:`check` evaluates the edge-triggered liveness rules and returns
    any NEWLY fired verdicts; :meth:`snapshot` is the JSON-able view the
    board, ``/metrics`` and ``/healthz`` all render from.

    Thresholds come from the :class:`~..config.keys.Live` cache-key knobs
    (:meth:`from_cache`) or constructor arguments; liveness is judged on
    record ``t0`` stamps against ``now`` (injectable for tests).
    """

    def __init__(self, silence_after=30.0, round_outlier=4.0,
                 mfu_collapse=0.3, retry_storm=10, retry_window=30.0,
                 quorum_headroom=1):
        self.silence_after = float(silence_after)
        self.round_outlier = float(round_outlier)
        self.mfu_collapse = float(mfu_collapse)
        self.retry_storm = int(retry_storm)
        self.retry_window = float(retry_window)
        self.quorum_headroom = int(quorum_headroom)

        self.sites = {}
        self.round = 0
        self.rounds_done = 0
        self.round_durs = deque(maxlen=_ROUND_WINDOW)
        self.rounds_per_sec = None  # EMA of 1/engine:round duration
        self.mfu_last = None
        self.mfu_ema = None
        self.mfu_n = 0
        self.samples_per_sec = None
        self.wire = {"save_bytes": 0, "saves": 0, "load_bytes": 0, "loads": 0}
        self._wire_window = deque(maxlen=4096)  # (t0, op, bytes)
        self.anomalies = 0
        self.anomalies_by_kind = {}
        self.chaos = 0
        self.worker_restarts = 0
        # async round engine: the staleness bound k (learned from the
        # engine's async:* events) and per-site staleness gauges — the
        # staleness_exceeded verdict judges sites against k
        self.staleness_k = 0
        self.stale_standins = 0
        # run-ahead pipeline (Federation.RUN_AHEAD): the configured depth
        # d (learned from the engine's async:run_ahead/pipeline:* events),
        # per-site run-ahead gauges, the reducer-concurrency counter the
        # decoupling win is measured by, stall counts, and the
        # edge-trigger latches of the pipeline_stall verdict
        self.run_ahead_d = 0
        self.pipeline_stalls = 0
        self.reduce_concurrent_s = 0.0
        self._pipeline_breach = None
        self._pipeline_flowed = False
        # daemon frame-pipe byte counters (daemon:frame events) — the
        # delta-cache win is the tx/rx trend across a run
        self.frame_bytes = {"tx": 0, "rx": 0, "frames": 0}
        # elastic membership: the roster as the membership:*
        # event stream reports it — current epoch, live member count,
        # per-kind transition counters, joiners whose first record has
        # not shown yet, gracefully retired sites, and the quorum need
        # the aggregator's membership events carry when a policy is
        # configured (the quorum_erosion verdict's evidence)
        self.roster_epoch = 0
        self.roster_members = None
        self.membership_changes = {}
        self.joining = set()
        self.left = set()
        self.quorum_need = None
        # event-name counts (bounded by the event vocabulary): the watch
        # CLI's --assert-event gating reads this, it stays out of the
        # snapshot to keep /healthz stable
        self.event_counts = {}
        self.wire_retries = 0
        self._retry_times = deque(maxlen=4096)
        self.corruption_recovered = 0
        self.dead = set()
        self.quarantined = set()
        self.truncated_lines = 0
        self.last_event_t = None
        self.verdicts = []
        self._armed = {}  # rule key -> active verdict (edge-trigger state)
        # the OpsServer scrapes snapshot() from handler threads while the
        # watch loop ingests — iterating the deques/site dict unlocked
        # would intermittently raise "mutated during iteration" and flap
        # the scrape target down with a 500
        self._lock = threading.RLock()

    @classmethod
    def from_cache(cls, cache):
        """Thresholds from the :class:`~..config.keys.Live` cache keys —
        the embedding surface for engines that watch themselves (the
        daemon engine's workers are monitored through exactly these
        records via ``telemetry watch``)."""
        cache = cache or {}
        return cls(
            silence_after=cache.get(Live.SILENCE_AFTER, 30.0),
            round_outlier=cache.get(Live.ROUND_OUTLIER, 4.0),
            mfu_collapse=cache.get(Live.MFU_COLLAPSE, 0.3),
            retry_storm=cache.get(Live.RETRY_STORM, 10),
            retry_window=cache.get(Live.RETRY_WINDOW, 30.0),
            quorum_headroom=cache.get(Live.QUORUM_HEADROOM, 1),
        )

    def site(self, name):
        return self.sites.setdefault(str(name), _site_entry())

    # --------------------------------------------------------------- ingest
    def ingest(self, records):
        """Fold a batch of merged records (the existing event vocabulary —
        nothing here requires a new record kind beyond the heartbeat)."""
        with self._lock:
            self._ingest_locked(records)

    def _ingest_locked(self, records):
        for rec in records:
            t0 = float(rec.get("t0", 0.0) or 0.0)
            # liveness is judged on when the record's section ENDED: a span
            # stamps t0 at its start, so a long compile/epoch span would
            # otherwise make a perfectly live site look stale
            t_live = t0 + float(rec.get("dur", 0.0) or 0.0)
            if t_live:
                self.last_event_t = (t_live if self.last_event_t is None
                                     else max(self.last_event_t, t_live))
            node = str(rec.get("node", "unknown"))
            rnd = rec.get("round")
            if node not in ("engine", "remote", "unknown"):
                s = self.site(node)
                if s["last_seen"] is None or t_live > s["last_seen"]:
                    s["last_seen"] = t_live
                if rnd is not None:
                    s["round"] = max(s["round"], int(rnd))
                if rec.get("phase") is not None:
                    s["phase"] = str(rec["phase"])
                if rec.get("epoch") is not None:
                    s["epoch"] = int(rec["epoch"])
            if rnd is not None:
                self.round = max(self.round, int(rnd))
            kind = rec.get("kind")
            if kind == "event":
                self._ingest_event(rec, t0)
            elif kind == "span":
                if rec.get("name") == "engine:round":
                    self._ingest_round(rec)
            elif kind == "metric":
                self._ingest_metric(rec)
            elif kind == "wire":
                op = "save" if rec.get("op") == "save" else "load"
                nbytes = int(rec.get("bytes", 0) or 0)
                self.wire[f"{op}_bytes"] += nbytes
                self.wire[f"{op}s"] += 1
                self._wire_window.append((t0, op, nbytes))

    def _ingest_event(self, rec, t0):
        name = rec.get("name", "")
        site = rec.get("site")
        self.event_counts[name] = self.event_counts.get(name, 0) + 1
        if name == Live.HEARTBEAT:
            # the aggregator's pulse ("remote") feeds federation liveness
            # (last_event_t) but must NOT become a per-site row: the
            # doctor's per-site view has no remote entry, and the
            # always-invoked-last aggregator would be a standing false
            # candidate for the site silence verdict
            if site is not None and str(site) != "remote":
                s = self.site(site)
                # a joiner's first own record ends its joining grace
                self.joining.discard(str(site))
                if s["last_heartbeat"] is None or t0 > s["last_heartbeat"]:
                    s["last_heartbeat"] = t0
                if s["last_seen"] is None or t0 > s["last_seen"]:
                    s["last_seen"] = t0
                # the engine-lane heartbeat carries the round it pulsed in —
                # for fresh-process sites whose own lanes flush late, this
                # is the board's freshest per-site progress signal
                if rec.get("round") is not None:
                    s["round"] = max(s["round"], int(rec["round"]))
        elif name.startswith("anomaly:"):
            self.anomalies += 1
            kind = name.split(":", 1)[1]
            self.anomalies_by_kind[kind] = (
                self.anomalies_by_kind.get(kind, 0) + 1
            )
            if site is not None:
                self.site(site)["anomalies"] += 1
        elif name == "chaos:inject":
            self.chaos += 1
        elif name in ("async:stale", "async:staleness_exceeded"):
            # the async engine delivered a stand-in for (or was forced to
            # block on) a straggler: per-site staleness gauge + the bound
            # k the staleness_exceeded verdict judges against
            try:
                self.staleness_k = max(self.staleness_k,
                                       int(rec.get("k", 0) or 0))
            except (TypeError, ValueError):
                pass
            if name == "async:stale":
                self.stale_standins += 1
            if site is not None:
                try:
                    lag = int(rec.get("lag", 0))
                except (TypeError, ValueError):
                    lag = 0
                s = self.site(site)
                s["staleness"] = lag
                if name == "async:staleness_exceeded":
                    # latch the breach: the engine blocks right after this
                    # event and the post-block fresh delivery resets the
                    # gauge, usually inside the SAME flush batch — without
                    # the latch check() would never see the bad state
                    s["staleness_breach"] = max(
                        lag, s.get("staleness_breach") or 0
                    )
        elif name == "async:run_ahead":
            # a site was re-submitted ahead of the un-harvested broadcast:
            # per-site depth gauge + the configured horizon d, and a
            # flowing-pipeline signal that re-arms the stall verdict
            try:
                self.run_ahead_d = max(self.run_ahead_d,
                                       int(rec.get("d", 0) or 0))
            except (TypeError, ValueError):
                pass
            if site is not None:
                try:
                    self.site(site)["run_ahead"] = int(rec.get("depth", 0))
                except (TypeError, ValueError):
                    pass
            self._pipeline_flowed = True
        elif name == "pipeline:stall":
            # the reducer worker fell behind the run-ahead horizon: the
            # engine blocked on the oldest in-flight reduce.  Latched —
            # the very next harvest usually clears the gauge inside the
            # same flush batch, and check() must still see the breach.
            self.pipeline_stalls += 1
            try:
                self.run_ahead_d = max(self.run_ahead_d,
                                       int(rec.get("d", 0) or 0))
            except (TypeError, ValueError):
                pass
            self._pipeline_breach = {
                "site": site,
                "reduce_round": rec.get("reduce_round"),
                "waited_s": rec.get("waited_s"),
                "d": rec.get("d"),
            }
        elif name == "pipeline:reduce_concurrent":
            # seconds the reduce+relay ran while site invocations were in
            # flight — the decoupling the pipeline exists to create
            try:
                self.reduce_concurrent_s += float(rec.get("secs", 0) or 0)
            except (TypeError, ValueError):
                pass
            self._pipeline_flowed = True
        elif name == "daemon:frame":
            try:
                self.frame_bytes["tx"] += int(rec.get("tx_bytes", 0) or 0)
                self.frame_bytes["rx"] += int(rec.get("rx_bytes", 0) or 0)
                self.frame_bytes["frames"] += 1
            except (TypeError, ValueError):
                pass
        elif name == Daemon.EVENT_RESTART:
            # the daemon engine replaced a dead/wedged worker — the site
            # SURVIVED (supervision, not quorum), but the board/metrics
            # must show the churn, per site
            self.worker_restarts += 1
            if site is not None and str(site) != "remote":
                self.site(site)["worker_restarts"] += 1
        elif name.startswith("membership:"):
            # elastic-membership roster transitions
            # (federation/membership.py + the engines' churn hooks): the
            # roster line, the membership_changes_total{kind=} exports
            # and the quorum_erosion verdict all key off these
            kind = name.split(":", 1)[1]
            self.membership_changes[kind] = (
                self.membership_changes.get(kind, 0) + 1
            )
            try:
                self.roster_epoch = max(self.roster_epoch,
                                        int(rec.get("epoch", 0) or 0))
            except (TypeError, ValueError):
                pass
            if rec.get("members") is not None:
                try:
                    self.roster_members = int(rec["members"])
                except (TypeError, ValueError):
                    pass
            if rec.get("quorum_need") is not None:
                try:
                    self.quorum_need = int(rec["quorum_need"])
                except (TypeError, ValueError):
                    pass
            if site is not None and kind in ("join", "rejoin", "leave"):
                site = str(site)
                if kind == "leave":
                    self.left.add(site)
                    self.joining.discard(site)
                else:
                    # a (re-)admission heals every prior exclusion: the
                    # fresh incarnation is not the dead/left one
                    self.left.discard(site)
                    self.dead.discard(site)
                    self.joining.add(site)
                    if site in self.sites:
                        self.sites[site]["dead"] = False
        elif name == "wire:retry":
            self.wire_retries += 1
            self._retry_times.append(t0)
        elif name == "wire:corruption_recovered":
            self.corruption_recovered += 1
        elif name == "site_died" and site is not None:
            self.dead.add(str(site))
            s = self.site(site)
            s["dead"] = True
            s["died_retries_exhausted"] = bool(rec.get("retries_exhausted"))
        elif name == "quarantine" and site is not None:
            self.quarantined.add(str(site))
            self.site(site)["quarantined"] = True

    def _ingest_round(self, rec):
        dur = float(rec.get("dur", 0.0) or 0.0)
        if dur <= 0:
            return
        self.rounds_done += 1
        self.round_durs.append(dur)
        rps = 1.0 / dur
        self.rounds_per_sec = (
            rps if self.rounds_per_sec is None
            else _EMA_DECAY * self.rounds_per_sec + (1 - _EMA_DECAY) * rps
        )

    def _ingest_metric(self, rec):
        name = rec.get("name")
        try:
            v = float(rec.get("value"))
        except (TypeError, ValueError):
            return
        if v != v:  # NaN samples belong to the watchdog, not the board
            return
        if name == Metric.MFU:
            self.mfu_last = v
            self.mfu_n += 1
            if self.mfu_ema is None:
                self.mfu_ema = v
            elif v >= self.mfu_collapse * self.mfu_ema:
                # a collapsed sample must not drag the EMA down to itself —
                # freeze it so a sustained collapse stays visible (the
                # watchdog's EMA detectors make the same choice)
                self.mfu_ema = _EMA_DECAY * self.mfu_ema + (1 - _EMA_DECAY) * v
        elif name == Metric.SAMPLES_PER_SEC:
            self.samples_per_sec = v
        elif name == Metric.SITE_STALENESS and rec.get("site") is not None:
            # both the engine (per delivery/stand-in) and the aggregator's
            # window check record the series — latest sample wins
            self.site(rec["site"])["staleness"] = int(v)
        elif name == Metric.SITE_RUN_AHEAD and rec.get("site") is not None:
            # recorded at every pipelined re-submission (0 = consumed the
            # newest broadcast; j = running j broadcasts ahead)
            self.site(rec["site"])["run_ahead"] = int(v)
        elif name == Metric.ROUNDS_PER_SEC:
            # the vectorized engine records the series directly; trust it
            self.rounds_per_sec = (
                v if self.rounds_per_sec is None
                else _EMA_DECAY * self.rounds_per_sec + (1 - _EMA_DECAY) * v
            )

    # --------------------------------------------------------------- verdicts
    def _fire(self, key, verdict_kind, cause, evidence, now, site=None):
        if key in self._armed:
            return None
        v = {
            "verdict": verdict_kind,
            "severity": VERDICT_SEVERITY[verdict_kind],
            "cause": cause,
            "evidence": evidence,
            "round": self.round,
            "t": now,
        }
        if site is not None:
            v["site"] = str(site)
        self._armed[key] = v
        self.verdicts.append(v)
        return v

    def _rearm(self, key):
        self._armed.pop(key, None)

    def check(self, now=None):
        """Evaluate the liveness rules; returns NEWLY fired verdicts (each
        rule is edge-triggered: it fires on the transition into the bad
        state and re-arms when the condition clears)."""
        now = time.time() if now is None else float(now)
        with self._lock:
            return self._check_locked(now)

    def _check_locked(self, now):
        fired = []

        # the federation itself must still be talking — against a finished
        # (or wholly wedged) run every per-site rule would storm, and a
        # dead RUN is the watch CLI's exit condition, not a site verdict
        run_live = (
            self.last_event_t is not None
            and now - self.last_event_t <= self.silence_after
        )

        for name in sorted(self.sites):
            s = self.sites[name]
            key = f"silence:{name}"
            last = max(s["last_seen"] or 0.0, s["last_heartbeat"] or 0.0)
            if not last:
                continue
            age = now - last
            # "silent" = the federation moved MORE THAN ONE round past the
            # site and its lane aged out.  The round-lag guard matters:
            # serial engines invoke sites one after another, so while round
            # r+1 is in progress every not-yet-invoked lane legitimately
            # still shows round r — a one-round lag is the steady state of
            # a healthy serial federation, a two-round lag means a whole
            # round completed without the site.
            lagging = s["round"] < self.round - 1
            if run_live and lagging and age > self.silence_after:
                v = self._fire(
                    key, Live.VERDICT_SILENCE,
                    f"site {name} heartbeat silent mid-run",
                    f"no record for {age:.1f}s (threshold "
                    f"{self.silence_after:g}s) and the federation moved on "
                    f"to round {self.round} while the site is stuck at "
                    f"round {s['round']}"
                    + (", site_died recorded" if s["dead"] else
                       " with no site_died event — wedged, not dropped"),
                    now, site=name,
                )
                if v:
                    fired.append(v)
            elif age <= self.silence_after or not lagging:
                self._rearm(key)

        # async staleness: a site MORE than k rounds behind means the
        # engine had to block on it (or it died and its gauge froze past
        # the window) — the straggler is gating the federation again.
        # Edge-triggered per site; re-arms when the site is back inside
        # the window.  Dead-site attribution reuses the site_died
        # retry-exhaustion evidence (the doctor's vocabulary).
        if self.staleness_k:
            for name in sorted(self.sites):
                s = self.sites[name]
                key = f"staleness:{name}"
                # the latched breach (consumed here) outranks the live
                # gauge: breach + recovery can land in ONE ingest batch
                breach = s.pop("staleness_breach", None)
                st = s.get("staleness")
                if breach is not None and (st is None or breach > st):
                    st = breach
                if st is not None and st > self.staleness_k:
                    if s["dead"]:
                        how = (
                            "site declared dead ("
                            + ("retries exhausted"
                               if s.get("died_retries_exhausted")
                               else "hard failure")
                            + ") — its last contribution ages past the "
                            "window"
                        )
                    else:
                        how = ("the engine must block on it — the "
                               "straggler gates the federation again")
                    v = self._fire(
                        key, Live.VERDICT_STALENESS,
                        f"site {name} fell more than k rounds behind",
                        f"staleness {st} > bound k={self.staleness_k} at "
                        f"round {self.round}; {how}",
                        now, site=name,
                    )
                    if v:
                        fired.append(v)
                elif st is not None and st <= self.staleness_k:
                    self._rearm(key)

        # run-ahead pipeline: the reducer worker fell behind the horizon
        # (a pipeline:stall latched since the last check) — edge-triggered
        # federation-wide; re-arms once the pipeline visibly flows again
        # (a concurrent reduce completed or a run-ahead re-submission
        # happened after the breach).
        breach, self._pipeline_breach = self._pipeline_breach, None
        if breach is not None:
            where = (f" (site {breach['site']} hit the horizon)"
                     if breach.get("site") else "")
            waited = breach.get("waited_s")
            v = self._fire(
                "pipeline_stall", Live.VERDICT_PIPELINE,
                "reducer worker fell behind the run-ahead horizon",
                f"the engine blocked {waited if waited is not None else '?'}s"
                f" on the round-{breach.get('reduce_round')} reduce at "
                f"run-ahead depth d={breach.get('d')}{where}; the wire "
                f"tail is gating compute again "
                f"({self.pipeline_stalls} stall(s) so far)",
                now, site=breach.get("site"),
            )
            if v:
                fired.append(v)
            self._pipeline_flowed = False
        elif self._pipeline_flowed:
            self._rearm("pipeline_stall")
            self._pipeline_flowed = False

        # elastic membership: the live roster eroded to within
        # the configured headroom of the quorum need — one more leave or
        # death fails the run.  Edge-triggered federation-wide, armed only
        # while the aggregator's membership events report a quorum need
        # (i.e. a site_quorum policy is configured); re-arms when joins/
        # rejoins rebuild the headroom.
        if self.quorum_need is not None and self.roster_members is not None:
            alive = self.roster_members - len(self.dead - self.left)
            headroom = alive - self.quorum_need
            if headroom < self.quorum_headroom:
                v = self._fire(
                    "quorum_erosion", Live.VERDICT_QUORUM_EROSION,
                    "live roster eroding toward the quorum floor",
                    f"{alive} live members vs quorum need "
                    f"{self.quorum_need} (headroom {headroom} < "
                    f"{self.quorum_headroom}) at roster epoch "
                    f"{self.roster_epoch}: one more leave or death fails "
                    "the run",
                    now,
                )
                if v:
                    fired.append(v)
            else:
                self._rearm("quorum_erosion")

        if len(self.round_durs) >= _ROUND_MIN_SAMPLES:
            *window, last = self.round_durs
            med = statistics.median(window)
            if med > 0 and last > self.round_outlier * med:
                v = self._fire(
                    "round_outlier", Live.VERDICT_ROUND_OUTLIER,
                    "round duration blew past the rolling median",
                    f"round {self.round} took {last:.3f}s vs rolling median "
                    f"{med:.3f}s (> {self.round_outlier:g}x)",
                    now,
                )
                if v:
                    fired.append(v)
            else:
                self._rearm("round_outlier")

        if (self.mfu_n >= _MFU_MIN_SAMPLES and self.mfu_ema
                and self.mfu_last is not None):
            if self.mfu_last < self.mfu_collapse * self.mfu_ema:
                v = self._fire(
                    "mfu_collapse", Live.VERDICT_MFU_COLLAPSE,
                    "MFU collapsed vs its own running average",
                    f"mfu {self.mfu_last:.4g} below {self.mfu_collapse:g}x "
                    f"EMA {self.mfu_ema:.4g} at round {self.round}",
                    now,
                )
                if v:
                    fired.append(v)
            else:
                self._rearm("mfu_collapse")

        recent = sum(1 for t in self._retry_times
                     if t > now - self.retry_window)
        if recent >= self.retry_storm:
            v = self._fire(
                "retry_storm", Live.VERDICT_RETRY_STORM,
                "wire retries bursting (flaky relay)",
                f"{recent} wire retries in the last {self.retry_window:g}s "
                f"(threshold {self.retry_storm}); "
                f"{self.corruption_recovered} corrupt payload(s) recovered "
                "so far",
                now,
            )
            if v:
                fired.append(v)
        elif recent <= self.retry_storm // 2:
            self._rearm("retry_storm")

        return fired

    # --------------------------------------------------------------- snapshot
    def status(self):
        """'critical' | 'warning' | 'ok' from the currently-ARMED verdicts
        (a fired-and-recovered rule no longer colors the status)."""
        with self._lock:
            sev = {v["severity"] for v in self._armed.values()}
        if "critical" in sev or self.dead:
            return "critical"
        if "warning" in sev:
            return "warning"
        return "ok"

    def _wire_rates(self, now):
        lo = now - _WIRE_RATE_WINDOW_S
        rates = {"save": 0.0, "load": 0.0}
        for t0, op, nbytes in self._wire_window:
            if t0 > lo:
                rates[op] += nbytes / _WIRE_RATE_WINDOW_S
        return rates

    def snapshot(self, now=None):
        """JSON-able federation view — the one structure the watch board,
        ``/metrics`` and ``/healthz`` all render from."""
        now = time.time() if now is None else float(now)
        with self._lock:
            return self._snapshot_locked(now)

    def _snapshot_locked(self, now):
        rates = self._wire_rates(now)
        sites = {}
        for name in sorted(self.sites):
            s = self.sites[name]
            last = max(s["last_seen"] or 0.0, s["last_heartbeat"] or 0.0)
            sites[name] = {
                "round": s["round"],
                "phase": s["phase"],
                "epoch": s["epoch"],
                "heartbeat_age_s": (round(now - last, 3) if last else None),
                "anomalies": s["anomalies"],
                "worker_restarts": s["worker_restarts"],
                "staleness": s["staleness"],
                "run_ahead": s["run_ahead"],
                "status": ("dead" if s["dead"] else
                           "quarantined" if s["quarantined"] else
                           "silent" if f"silence:{name}" in self._armed else
                           "alive"),
            }
        return {
            "status": self.status(),
            "live": (self.last_event_t is not None
                     and now - self.last_event_t <= self.silence_after),
            "now": now,
            "round": self.round,
            "rounds_done": self.rounds_done,
            "rounds_per_sec": self.rounds_per_sec,
            "mfu": {"last": self.mfu_last, "ema": self.mfu_ema,
                    "samples": self.mfu_n},
            "samples_per_sec": self.samples_per_sec,
            "wire": dict(self.wire, save_rate_bps=round(rates["save"], 1),
                         load_rate_bps=round(rates["load"], 1)),
            "anomalies": {"total": self.anomalies,
                          "by_kind": dict(self.anomalies_by_kind)},
            "chaos_injections": self.chaos,
            "worker_restarts": self.worker_restarts,
            "staleness_k": self.staleness_k,
            "stale_standins": self.stale_standins,
            "run_ahead_d": self.run_ahead_d,
            "pipeline_stalls": self.pipeline_stalls,
            "reduce_concurrent_s": round(self.reduce_concurrent_s, 4),
            "frame_bytes": dict(self.frame_bytes),
            "roster": {
                "epoch": self.roster_epoch,
                "members": self.roster_members,
                "joining": sorted(self.joining),
                "left": sorted(self.left),
                "dead": sorted(self.dead - self.left),
                "changes": dict(self.membership_changes),
                "quorum_need": self.quorum_need,
            },
            "wire_retries": self.wire_retries,
            "corruption_recovered": self.corruption_recovered,
            "dead_sites": sorted(self.dead),
            "quarantined_sites": sorted(self.quarantined),
            "truncated_lines": self.truncated_lines,
            "sites": sites,
            "verdicts": list(self.verdicts),
        }


# -------------------------------------------------------------------- board
def _fmt_bytes(n):
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024 or unit == "GiB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{int(n)}B"
        n /= 1024.0
    return f"{n}B"


def _fmt(v, fmt="{:.3g}"):
    return "-" if v is None else fmt.format(v)


def render_board(snap, root=""):
    """The ``telemetry watch`` terminal status board for one snapshot."""
    head = f"federation live board — {root}" if root else "federation live board"
    lines = [head,
             f"status {snap['status'].upper()}"
             + ("" if snap["live"] else " (no recent records — run over or wedged)")]
    lines.append(
        f"round {snap['round']} · {snap['rounds_done']} engine rounds · "
        f"{_fmt(snap['rounds_per_sec'])} rounds/s · "
        f"mfu {_fmt(snap['mfu']['last'])} (ema {_fmt(snap['mfu']['ema'])}) · "
        f"{_fmt(snap['samples_per_sec'])} samples/s"
    )
    w = snap["wire"]
    lines.append(
        f"wire out {w['saves']} files / {_fmt_bytes(w['save_bytes'])} "
        f"({_fmt_bytes(w['save_rate_bps'])}/s) · "
        f"in {w['loads']} files / {_fmt_bytes(w['load_bytes'])} "
        f"({_fmt_bytes(w['load_rate_bps'])}/s) · "
        f"retries {snap['wire_retries']} · "
        f"recovered {snap['corruption_recovered']}"
    )
    lines.append(
        f"anomalies {snap['anomalies']['total']} · "
        f"chaos {snap['chaos_injections']} · "
        f"worker restarts {snap.get('worker_restarts', 0)} · "
        + (f"stale stand-ins {snap.get('stale_standins', 0)} "
           f"(k={snap['staleness_k']}) · "
           if snap.get("staleness_k") else "")
        + (f"run-ahead d={snap['run_ahead_d']} "
           f"(reduce overlap {snap.get('reduce_concurrent_s', 0):.1f}s, "
           f"{snap.get('pipeline_stalls', 0)} stall(s)) · "
           if snap.get("run_ahead_d") else "")
        + f"truncated lines {snap['truncated_lines']} · "
        f"dead: {', '.join(snap['dead_sites']) or '-'} · "
        f"quarantined: {', '.join(snap['quarantined_sites']) or '-'}"
    )
    fb = snap.get("frame_bytes") or {}
    if fb.get("frames"):
        lines.append(
            f"daemon frames {fb['frames']} · tx {_fmt_bytes(fb['tx'])} · "
            f"rx {_fmt_bytes(fb['rx'])}"
        )
    roster = snap.get("roster") or {}
    if roster.get("epoch"):
        # elastic membership only: the line appears once the roster has a
        # versioned epoch (a membership:* event flowed) — fixed-roster
        # boards stay unchanged
        ch = roster.get("changes") or {}
        changes = " ".join(
            f"{k}={ch[k]}" for k in ("join", "leave", "rejoin", "refused")
            if ch.get(k)
        )
        need = roster.get("quorum_need")
        lines.append(
            f"roster epoch {roster['epoch']} · "
            f"members {roster.get('members') if roster.get('members') is not None else '-'} · "
            f"joining: {', '.join(roster.get('joining') or ()) or '-'} · "
            f"left: {', '.join(roster.get('left') or ()) or '-'} · "
            f"dead: {len(roster.get('dead') or ())}"
            + (f" · quorum need {need}" if need is not None else "")
            + (f" · {changes}" if changes else "")
        )
    if snap["sites"]:
        width = max(len(n) for n in snap["sites"])
        # the staleness/run-ahead columns appear only on async/pipelined
        # runs (k and d learned from the engine's async:*/pipeline:*
        # events) — lockstep boards stay unchanged
        k = int(snap.get("staleness_k") or 0)
        d = int(snap.get("run_ahead_d") or 0)
        stale_hdr = f" {'stale':>5}" if k else ""
        ahead_hdr = f" {'ahead':>5}" if d else ""
        lines.append("")
        lines.append(
            f"  {'site'.ljust(width)}  {'round':>5} {'epoch':>5} "
            f"{'phase':<16} {'heartbeat':>10}{stale_hdr}{ahead_hdr} "
            f"{'anoms':>5}  status"
        )
        for name, s in snap["sites"].items():
            age = ("-" if s["heartbeat_age_s"] is None
                   else f"{s['heartbeat_age_s']:.1f}s ago")
            status = s["status"].upper() if s["status"] != "alive" else "alive"
            stale_col = ""
            if k:
                st = s.get("staleness")
                stale_col = f" {'-' if st is None else st:>5}"
            ahead_col = ""
            if d:
                ra = s.get("run_ahead")
                ahead_col = f" {'-' if ra is None else ra:>5}"
            lines.append(
                f"  {name.ljust(width)}  {s['round']:>5} "
                f"{'-' if s['epoch'] is None else s['epoch']:>5} "
                f"{(s['phase'] or '-'):<16} {age:>10}{stale_col}{ahead_col} "
                f"{s['anomalies']:>5}  {status}"
            )
    if snap["verdicts"]:
        lines.append("")
        lines.append("in-flight verdicts:")
        for v in snap["verdicts"]:
            site = f" [{v['site']}]" if v.get("site") else ""
            lines.append(
                f"  [{v['severity']}] {v['verdict']}{site} — "
                f"{v['cause']}: {v['evidence']}"
            )
    return "\n".join(lines)

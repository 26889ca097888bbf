"""proto-conc-*: the tier-5 deterministic interleaving explorer over the
port — the JAX package's ``analysis/schedule_explorer.py``.

The static half (:mod:`.concurrency`) audits lock discipline
syntactically; this half **executes** the port's real async round
machinery — ``InProcessEngine._step_round_async``'s submit/collect/stand-in
loop, the ``.stale`` alias snapshotting, the shared ``_last_site_outs``
replay record, the engine-lane :class:`~..telemetry.recorder.Recorder`,
and the :class:`~..federation.daemon.DaemonEngine` close/restart
supervision — under a **deterministic schedule**.

The switch points are the engine's own seams: the bounded invocation pool
is replaced by a virtual pool whose futures complete exactly when the
schedule says (before the collect, mid-round during the aggregator's turn,
or not at all — the engine's stand-in / forced-block logic then runs for
real), and the collect-phase grace window runs under virtual time.  Site
and aggregator invocations are pure-numpy stubs (phase/mode/reduce + a
CRC-checked wire payload tagged with the submission round), as in the JAX
package, so the engines run on the CPU and a bounded exploration finishes
in seconds; no kernel launches.

Checked round-loop invariants (each a ``proto-conc-*`` rule from
:class:`~..config.keys.Concurrency`):

- the reduce never observes a torn ``.stale`` alias pair — every
  stand-in's payload must load (manifest + CRC verified) to exactly the
  contribution its ``wire_round`` echo claims;
- ``_last_site_outs`` never loses a commit;
- recorder JSONL lines stay whole (:func:`~..telemetry.collect.read_jsonl_segment`);
- ``close()`` never deadlocks against an in-flight supervised worker
  restart, and a worker spawned concurrently with ``close()`` never
  escapes shutdown (the daemon drill, with a fake ``_Worker``: no worker
  process starts).

Every violation is a finding AND a **replayable schedule JSON**
(``--schedules DIR``) that :func:`replay_schedule` re-executes to the same
violation.  The ``_SNAPSHOT_DISABLED`` / ``_DROP_COMMIT`` / ``_TORN_FLUSH``
/ ``_DRILL_UNSERIALIZED_SPAWN`` switches (tests and ``chip_smoke.py``
only) model the broken semantics so each invariant is provably checkable.
Every JAX invariant has its construct in the port.

Deterministic: fixed enumeration order, virtual completion decisions, no
randomness — the same findings on every run.
"""
import ast
import itertools
import json
import os
import tempfile
import threading
import time

from ..config.keys import Concurrency
from .core import Finding

#: broken-semantics switches (tests only; see the tier-4 idiom in
#: model_check.py).  Each models the bug class its invariant patrols:
#: stand-ins referencing LIVE payload names instead of frozen aliases,
#: the replay record dropping a delivered output, an unlocked concurrent
#: flush tearing a JSONL line, and a supervisor spawning workers outside
#: the engine lock so close() can miss one.
_SNAPSHOT_DISABLED = False
_DROP_COMMIT = False
_TORN_FLUSH = False
_DRILL_UNSERIALIZED_SPAWN = False

#: per-site completion choices a schedule assigns each post-warmup round:
#: ``fresh`` — the invocation completes before the collect phase;
#: ``defer`` — it stays in flight (the engine delivers a stand-in inside
#: the window, or blocks on it at the boundary — both real code paths);
#: ``mid`` — it completes DURING the aggregator's turn, exactly the
#: moment a straggler's next commit can race the in-flight reduce.
CHOICES = ("fresh", "defer", "mid")

EXPLORER_RULE_IDS = (
    Concurrency.CLOSE_DEADLOCK,
    Concurrency.CONFIG,
    Concurrency.LOST_COMMIT,
    Concurrency.TORN_JSONL,
    Concurrency.TORN_STALE,
)

#: hard ceiling on schedules per exploration — a runaway bound must
#: degrade to a typed proto-conc-config finding (tier-4's MAX_STATES
#: idiom), never a hung CI job or a silently-partial "clean" result.
#: Covers --schedule-bound 3 at the default 2 sites (9^3 = 729) with room.
MAX_SCHEDULES = 4096

_INVARIANTS = {
    Concurrency.TORN_STALE: "stand-in payloads match their frozen alias",
    Concurrency.LOST_COMMIT: "every delivered output is recorded for replay",
    Concurrency.TORN_JSONL: "telemetry JSONL lines stay whole",
    Concurrency.CLOSE_DEADLOCK: "close() wins against in-flight restarts",
}


class ScheduleConfig:
    """Exploration bound (defaults = the CI gate's contract): ``sites`` ×
    ``rounds`` post-warmup rounds (one all-fresh warmup round precedes
    them — stand-ins need a recorded contribution), window ``k``, pool
    width, and the schedule-count ceiling (a runaway bound degrades to a
    typed report entry, never a hung CI job)."""

    def __init__(self, sites=None, rounds=None, k=None, pool=None,
                 max_schedules=MAX_SCHEDULES):
        self.sites = int(sites if sites is not None
                         else Concurrency.DEFAULT_SITES)
        self.rounds = int(rounds if rounds is not None
                          else Concurrency.DEFAULT_ROUNDS)
        self.k = int(k if k is not None else Concurrency.DEFAULT_STALENESS_K)
        self.pool = int(pool if pool is not None
                        else Concurrency.DEFAULT_POOL)
        self.max_schedules = int(max_schedules)

    def scenario(self):
        return {"sites": self.sites, "rounds": self.rounds,
                "staleness_k": self.k, "pool": self.pool}


class ScheduleResult:
    def __init__(self, findings, plans, report):
        self.findings = findings
        self.plans = plans
        self.report = report


# ------------------------------------------------------------- virtual pool
class _VirtualPool:
    """Deterministic stand-in for the engine's ThreadPoolExecutor: a
    submitted invocation runs exactly when the schedule completes it (or
    inline, when the engine blocks on its future — the real forced-block
    path)."""

    def __init__(self):
        self.pending = {}
        self.complete_on_submit = set()
        self.mid_round = set()
        self.forced = []

    def submit(self, fn, *args, **kwargs):
        from concurrent.futures import Future

        site = args[2]  # the engine submits (policy, rnd, site, inp, rec)

        class _VirtualFuture(Future):
            def run(fut):
                if getattr(fut, "_ran", False) or fut.cancelled():
                    return
                fut._ran = True
                fut.set_running_or_notify_cancel()
                try:
                    fut.set_result(fn(*args, **kwargs))
                except BaseException as exc:  # noqa: BLE001 — future contract
                    fut.set_exception(exc)

            def result(fut, timeout=None):
                if not fut.done():
                    # the engine blocked on a straggler: the real serial
                    # fallback — run the invocation inline, note it
                    self.forced.append(site)
                    fut.run()
                return Future.result(fut, timeout)

        fut = _VirtualFuture()
        self.pending[site] = fut
        if site in self.complete_on_submit:
            fut.run()
        return fut

    def complete(self, site):
        fut = self.pending.get(site)
        if fut is not None and not fut.done():
            fut.run()

    def run_mid_round(self):
        for site in sorted(self.mid_round):
            self.complete(site)

    def shutdown(self, wait=True, cancel_futures=False):
        pass


# ------------------------------------------------------------- stub engine
def _make_engine(workdir, config):
    """A real :class:`~..engine.InProcessEngine` whose node invocations
    are pure-numpy protocol stubs and whose pool/grace switch points are
    under explorer control.  Deferred import so the static tier never
    pays the engine import."""
    import numpy as np

    from ..config.keys import Mode, Phase
    from ..engine import InProcessEngine
    from ..utils.tensorutils import WireError, load_arrays, save_arrays

    class _ExplorerEngine(InProcessEngine):
        #: the pool threads are virtual — no cap, the schedule decides
        _ASYNC_POOL_CAP = None

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self._explorer_pool = _VirtualPool()
            self.violations = []

        # ---- switch points -------------------------------------------
        def _ensure_async_pool(self, size):
            return self._explorer_pool

        def _async_grace(self):
            # virtual time: the schedule decides completion, wall-clock
            # grace is meaningless (and must never sleep)
            return None

        def _async_snapshot_payloads(self, s, out):
            if _SNAPSHOT_DISABLED:
                # broken semantics: the stand-in will reference the LIVE
                # payload names the straggler's next commit overwrites
                self._async_snapshots[s] = {}
                return
            super()._async_snapshot_payloads(s, out)

        def _finish_site_outputs(self, rnd, site_outs, rec, record=True):
            if _DROP_COMMIT:
                return  # broken semantics: the replay record loses them
            super()._finish_site_outputs(rnd, site_outs, rec, record=record)

        # ---- stub node invocations -----------------------------------
        def _site_attempt(self, rnd, s, inp, rec):
            ix = int(s.rsplit("_", 1)[1])
            with rec.span(f"invoke:{s}", cat="invoke", round=rnd):
                path = os.path.join(
                    self.site_states[s]["transferDirectory"], "grads.npy"
                )
                save_arrays(path, [np.array([ix, rnd], dtype=np.int64)])
            return {
                "phase": Phase.COMPUTATION.value, "mode": Mode.TRAIN.value,
                "reduce": True, "grads_file": "grads.npy", "wire_round": rnd,
            }

        def _remote_attempt(self, rnd, site_outs, rec):
            # mid-round completions fire here: the straggler's next commit
            # lands exactly while the reduce is consuming its stand-in
            self._explorer_pool.run_mid_round()
            with rec.span("invoke:remote", cat="invoke"):
                for s in sorted(site_outs):
                    out = site_outs[s]
                    if not out.get("reduce"):
                        continue
                    path = os.path.join(
                        self.site_states[s]["transferDirectory"],
                        out["grads_file"],
                    )
                    claimed = int(out.get("wire_round", rnd))
                    try:
                        arrays = load_arrays(path)
                        tag = int(arrays[0][1])
                    except (WireError, OSError, IndexError,
                            ValueError) as exc:
                        self.violations.append({
                            "rule": Concurrency.TORN_STALE, "round": rnd,
                            "detail": (
                                f"{s}'s payload failed to load during the "
                                f"reduce: {type(exc).__name__}: {exc}"
                            ),
                        })
                        continue
                    if tag != claimed:
                        self.violations.append({
                            "rule": Concurrency.TORN_STALE, "round": rnd,
                            "detail": (
                                f"the reduce consumed round-{tag} data "
                                f"through {s}'s round-{claimed} stand-in "
                                "reference — the stand-in raced the "
                                "straggler's next commit instead of "
                                "reading its frozen .stale alias"
                            ),
                        })
                save_arrays(
                    os.path.join(self.remote_state["transferDirectory"],
                                 "avg_grads.npy"),
                    [np.array([rnd], dtype=np.int64)],
                )
            return {"phase": Phase.COMPUTATION.value, "update": True,
                    "avg_grads_file": "avg_grads.npy"}

    # the stubs are numpy: the engine's own device is the CPU's
    return _ExplorerEngine(
        workdir, config.sites, device="cpu", telemetry=True,
        async_staleness=config.k, async_invoke_pool=config.pool,
    )


def _run_schedule(config, schedule, workdir, report=None):
    """Execute one schedule; returns the violation dicts it produced."""
    from ..telemetry.collect import read_jsonl_segment

    eng = _make_engine(workdir, config)
    rec = eng._recorder()
    if _TORN_FLUSH and rec.enabled:
        # broken semantics: a concurrent unlocked flush appends a torn
        # (unterminated) fragment the next append merges into garbage
        orig_flush = rec.flush

        def torn_flush():
            orig_flush()
            path = rec.path()
            if path:
                with open(path, "a", encoding="utf-8") as f:
                    f.write('{"v": 1, "kind": "ev')

        rec.flush = torn_flush
    violations = []
    try:
        warmup = {s: "fresh" for s in eng.site_ids}
        for decision in [warmup] + list(schedule):
            pool = eng._explorer_pool
            pool.complete_on_submit = {
                s for s, c in decision.items() if c == "fresh"
            }
            pool.mid_round = {s for s, c in decision.items() if c == "mid"}
            # futures still pending from earlier rounds complete now when
            # the schedule marks their site fresh
            for s in sorted(pool.complete_on_submit):
                pool.complete(s)
            site_outs, _remote_out = eng.step_round()
            rnd = eng.rounds
            for s in sorted(site_outs):
                out = site_outs[s]
                recorded = eng._last_site_outs.get(s)
                if recorded is None or (
                    recorded.get("wire_round") != out.get("wire_round")
                ):
                    violations.append({
                        "rule": Concurrency.LOST_COMMIT, "round": rnd,
                        "detail": (
                            f"{s}'s delivered round-"
                            f"{out.get('wire_round')} output is missing "
                            "from _last_site_outs when the round ends — "
                            "a later stand-in/replay would redeliver "
                            f"{'nothing' if recorded is None else 'round-' + str(recorded.get('wire_round'))}"
                        ),
                    })
        violations.extend(eng.violations)
        rec.flush()
        path = rec.path() if rec.enabled else None
        if path and os.path.exists(path):
            _records, _off, bad, partial = read_jsonl_segment(path)
            if bad or partial:
                violations.append({
                    "rule": Concurrency.TORN_JSONL, "round": eng.rounds,
                    "detail": (
                        f"the engine telemetry lane holds {bad} "
                        "undecodable line(s)"
                        + (" and a torn unterminated tail" if partial
                           else "")
                        + " after the bounded run — concurrent appends "
                        "interleaved mid-record"
                    ),
                })
    finally:
        if report is not None:
            report["forced_blocks"] += len(eng._explorer_pool.forced)
        eng.close()
    return violations


# --------------------------------------------------------------- close drill
def run_close_drill(workdir):
    """Deterministic DaemonEngine close-vs-restart interleaving: a
    supervised restart holds the engine's worker lock mid-spawn while
    ``close()`` runs.  The fixed contract — spawn under the lock, the
    closing flag checked first — means close() must block briefly, then
    shut the concurrently-registered worker down too.  Returns violation
    dicts (empty on the healthy tree)."""
    from ..federation import daemon as daemon_mod
    from ..telemetry.recorder import NULL_RECORDER

    spawn_entered = threading.Event()
    release_spawn = threading.Event()
    created = []

    class _FakeWorker:
        def __init__(self, target, script, env=None, log_path=None,
                     start_timeout=None, device=None):
            self.target = str(target)
            self.pid = 0
            self.warm_s = 0.0
            self.stopped = False
            created.append(self)
            spawn_entered.set()
            release_spawn.wait(timeout=5.0)

        def alive(self):
            return not self.stopped

        def shutdown(self, grace=3.0):
            self.stopped = True

        def kill(self):
            self.stopped = True

    eng = daemon_mod.DaemonEngine(
        workdir, 1, local_script="local.py", remote_script="remote.py", device="cpu",
    )
    orig_worker = daemon_mod._Worker
    daemon_mod._Worker = _FakeWorker
    violations = []
    try:
        if _DRILL_UNSERIALIZED_SPAWN:
            # the broken supervisor shape: the spawn happens OUTSIDE the
            # engine lock, so a close() racing it snapshots an empty
            # worker table and the late registration escapes shutdown
            def restart():
                with eng._worker_lock:
                    if eng._closing:
                        return
                w = _FakeWorker("site_0", "local.py")
                with eng._worker_lock:
                    eng._workers["site_0"] = w
        else:
            def restart():
                try:
                    eng._ensure_worker("site_0", "local.py", NULL_RECORDER)
                except RuntimeError:
                    pass  # a closing engine refuses the respawn: correct

        t = threading.Thread(target=restart, daemon=True,
                             name="tier5-drill-restart")
        t.start()
        spawn_entered.wait(timeout=5.0)

        closed = threading.Event()

        def do_close():
            eng.close()
            closed.set()

        c = threading.Thread(target=do_close, daemon=True,
                             name="tier5-drill-close")
        c.start()
        time.sleep(0.05)  # let close() reach the contended worker lock
        release_spawn.set()
        finished = closed.wait(timeout=10.0)
        t.join(timeout=5.0)
        c.join(timeout=1.0)
        if not finished:
            violations.append({
                "rule": Concurrency.CLOSE_DEADLOCK, "round": 0,
                "detail": (
                    "close() did not return within 10 s while a "
                    "supervised worker restart held the worker lock "
                    "mid-spawn — the shutdown path deadlocks against "
                    "the supervisor"
                ),
            })
        else:
            leaked = [w for w in created if w.alive()]
            if leaked:
                violations.append({
                    "rule": Concurrency.CLOSE_DEADLOCK, "round": 0,
                    "detail": (
                        f"{len(leaked)} worker(s) spawned concurrently "
                        "with close() escaped shutdown — the spawn ran "
                        "outside the worker lock, so close()'s snapshot "
                        "missed the late registration"
                    ),
                })
    finally:
        daemon_mod._Worker = orig_worker
        release_spawn.set()
    return violations


# ------------------------------------------------------------------ anchors
#: violation rule -> (module, class, method) its finding anchors to — the
#: real source location whose contract the invariant protects.  Resolution
#: is class-qualified: recorder.py also defines _NullRecorder.flush (a
#: no-op), and anchoring there would send the investigation to dead code.
def _anchor_for(rule):
    if rule == Concurrency.TORN_JSONL:
        from ..telemetry import recorder as mod

        cls, func = "Recorder", "flush"
    elif rule == Concurrency.CLOSE_DEADLOCK:
        from ..federation import daemon as mod

        cls, func = "DaemonEngine", "close"
    else:
        from .. import engine as mod

        cls = "InProcessEngine"
        func = ("_finish_site_outputs" if rule == Concurrency.LOST_COMMIT
                else "_async_snapshot_payloads")
    path = os.path.relpath(mod.__file__).replace(os.sep, "/")
    line = 1
    try:
        with open(mod.__file__, "r", encoding="utf-8") as f:
            tree = ast.parse(f.read())
        fallback = None
        for node in tree.body:
            if isinstance(node, ast.ClassDef):
                for sub in node.body:
                    if isinstance(sub, ast.FunctionDef) and sub.name == func:
                        if node.name == cls:
                            return path, sub.lineno
                        fallback = fallback or sub.lineno
        if fallback:
            line = fallback
    except (OSError, SyntaxError, ValueError):
        pass
    return path, line


def _describe(schedule):
    if not schedule:
        return "warmup only"
    parts = []
    for i, decision in enumerate(schedule):
        non_fresh = [f"{s}={c}" for s, c in sorted(decision.items())
                     if c != "fresh"]
        parts.append(f"r{i + 2}:{','.join(non_fresh) or 'all-fresh'}")
    return " ".join(parts)


# -------------------------------------------------------------- exploration
def _enumerate_schedules(config):
    site_ids = [f"site_{i}" for i in range(config.sites)]
    per_round = list(itertools.product(CHOICES, repeat=len(site_ids)))
    for combo in itertools.product(per_round, repeat=config.rounds):
        yield [dict(zip(site_ids, c)) for c in combo]


def replay_schedule(plan, workdir=None):
    """Re-execute a violation's schedule JSON; returns the violation
    dicts the replay produced (the regression-test contract: the same
    rule fires again)."""
    scenario = dict(plan.get("scenario") or {})
    config = ScheduleConfig(
        sites=scenario.get("sites"), rounds=scenario.get("rounds"),
        k=scenario.get("staleness_k"), pool=scenario.get("pool"),
    )
    schedule = [dict(d) for d in plan.get("schedule") or []]
    if plan.get("rule") == Concurrency.CLOSE_DEADLOCK:
        if workdir is not None:
            return run_close_drill(workdir)
        with tempfile.TemporaryDirectory(prefix="tier5-replay-") as wd:
            return run_close_drill(wd)
    if workdir is not None:
        return _run_schedule(config, schedule, workdir)
    with tempfile.TemporaryDirectory(prefix="tier5-replay-") as wd:
        return _run_schedule(config, schedule, wd)


def run_schedule_explorer(config=None, schedules_dir=None):
    """Explore every schedule within the bound (plus the daemon close
    drill); returns a :class:`ScheduleResult` whose findings flow
    through the same baseline machinery as tiers 1–4."""
    config = config or ScheduleConfig()
    report = {"schedules_run": 0, "forced_blocks": 0, "violations": 0,
              "truncated": 0, "drill_run": False}
    found = {}  # rule -> (Finding, plan)

    def emit(violation, schedule):
        rule = violation["rule"]
        report["violations"] += 1
        if rule in found:
            return
        path, line = _anchor_for(rule)
        plan = {
            "comment": (
                "dinulint tier-5 counterexample — replay with "
                "coinstac_dinunet_tpu_torch.analysis.schedule_explorer."
                "replay_schedule(<this file>)"
            ),
            "rule": rule,
            "invariant": _INVARIANTS[rule],
            "scenario": config.scenario(),
            "schedule": schedule,
            "violation_round": int(violation.get("round", 0)),
        }
        message = (
            f"{violation['detail']} — counterexample schedule: "
            f"[{_describe(schedule)}] (bound: {config.sites} sites x "
            f"{config.rounds} rounds + warmup, k={config.k}, "
            f"pool={config.pool}); replayable schedule JSON via "
            "--schedules"
        )
        found[rule] = (
            Finding(rule=rule, path=path, line=line, col=0, message=message),
            plan,
        )

    try:
        with tempfile.TemporaryDirectory(prefix="dinulint-tier5-") as root:
            total = (len(CHOICES) ** config.sites) ** config.rounds
            for i, schedule in enumerate(_enumerate_schedules(config)):
                if i >= config.max_schedules:
                    # no silent caps: a partially-explored bound must fail
                    # loudly, never read as "covered everything"
                    report["truncated"] = total - i
                    found.setdefault(Concurrency.CONFIG, (Finding(
                        rule=Concurrency.CONFIG,
                        path="coinstac_dinunet_tpu_torch", line=1, col=0,
                        message=(
                            f"schedule ceiling ({config.max_schedules}) "
                            f"exceeded: the bound enumerates {total} "
                            f"schedules and {total - i} were NOT explored "
                            "— shrink --schedule-bound (or the site "
                            "count); a truncated exploration must not "
                            "pass as clean"
                        ),
                    ), None))
                    break
                wd = os.path.join(root, f"s{i:04d}")
                violations = _run_schedule(config, schedule, wd,
                                           report=report)
                report["schedules_run"] += 1
                for v in violations:
                    emit(v, schedule)
            for v in run_close_drill(os.path.join(root, "drill")):
                emit(v, [])
            report["drill_run"] = True
    except Exception as exc:  # noqa: BLE001 — typed error channel
        f = Finding(
            rule=Concurrency.CONFIG, path="coinstac_dinunet_tpu_torch", line=1,
            col=0,
            message=(
                "the tier-5 schedule explorer could not run: "
                f"{type(exc).__name__}: {exc}"
            ),
        )
        return ScheduleResult([f], [None], report)

    order = sorted(found)
    findings = [found[r][0] for r in order]
    plans = [found[r][1] for r in order]
    if schedules_dir:
        os.makedirs(schedules_dir, exist_ok=True)
        for n, (f, plan) in enumerate(zip(findings, plans)):
            if not plan:
                continue  # the config error channel has no schedule
            name = f"{f.rule}-{n:02d}.json"
            with open(os.path.join(schedules_dir, name), "w",
                      encoding="utf-8") as fh:
                json.dump(plan, fh, indent=2, sort_keys=True)
                fh.write("\n")
    return ScheduleResult(findings, plans, report)

"""Deterministic chaos (fault-injection) harness for federated runs.

Port of the JAX package's ``resilience/chaos.py`` (pure Python; the plans,
their validation, the firing order and the ``chaos:inject`` /
``chaos:heal`` records are the same).  A JSON **fault plan** pins each
fault to an engine round (1-based) and a site, so a chaos run is
reproducible and comparable against a golden run.

Fault plan schema (a dict, or a path to a JSON file)::

    {"faults": [
        {"kind": "crash",    "round": 3, "site": "site_2"},
        {"kind": "hang",     "round": 3, "site": "site_1"},
        {"kind": "slow",     "round": 2, "site": "site_0", "seconds": 0.5},
        {"kind": "truncate_payload",  "round": 2, "site": "site_0",
         "file": "grads.npy"},
        {"kind": "corrupt_payload",   "round": 2, "site": "site_1",
         "file": "grads.npy"},
        {"kind": "drop_relay",        "round": 4, "site": "site_0",
         "file": "avg_grads.npy"},
        {"kind": "duplicate_delivery","round": 4, "site": "site_1",
         "file": "avg_grads.npy"},
        {"kind": "stale",    "round": 2, "site": "site_1"},
        {"kind": "reappear", "round": 3, "site": "site_2"},
        {"kind": "worker_kill", "round": 3, "site": "site_1",
         "when": "invoke"}
    ]}

``stale`` replays the site's previous round output in place of a fresh
invocation (a delayed duplicate of the site→aggregator message);
``reappear`` kills the site for good at the pinned round and redelivers
its last output ONE round later (the dropped-site-reappears scenario).
``worker_kill`` SIGKILLs a daemon engine's worker process (``when``:
mid-invocation or between rounds): the expected outcome is a
``worker:restart``, never a dead site; the serial engines without workers
never query it.  ``join``, ``leave`` and ``rejoin`` are elastic-membership
operations, which :meth:`ChaosSession.membership_ops` hands to the engine
at their round: the site-vectorized engine (``federation/engine.py``)
applies them to its roster mask; the serial engines refuse a plan holding
them (``ROADMAP.md`` Queue 1: the other engines and their options).

Optional per-fault keys: ``times`` (firings before the fault heals;
default 1 for payload/relay faults, permanent for crash/hang/reappear)
and ``heal_after`` (failed load attempts before a damaged payload is
repaired, default 1 — the relay completing).

Hook points: the engines call :meth:`ChaosSession.invoke_fault` before
every node invocation attempt (crash/hang raise a :class:`ChaosFault`,
which the retry policy sees as an ordinary failure; slow sleeps),
:meth:`ChaosSession.payload_faults` after a site commits its outbound
payloads, and :meth:`ChaosSession.relay_fault` per relayed file.  The
transport's load-failure hook lets a damaged payload heal between two
load attempts of an in-process reader, and :meth:`heal_for_retry` heals
it between two invocation attempts of a reader in another process.
"""
import contextlib
import json
import math
import os
import random
import time

from . import transport

#: every fault kind the harness understands
FAULT_KINDS = (
    "crash", "hang", "slow",
    "truncate_payload", "corrupt_payload",
    "drop_relay", "duplicate_delivery",
    "stale", "reappear",
    "worker_kill",
    "join", "leave", "rejoin",
)
_INVOKE_KINDS = ("crash", "hang", "slow")
_PAYLOAD_KINDS = ("truncate_payload", "corrupt_payload")
_RELAY_KINDS = ("drop_relay", "duplicate_delivery")
#: site-message replay faults: ``stale`` (the previous output stands in
#: for a fresh invocation) and ``reappear`` (a permanent death, then the
#: last output redelivered one round later)
_REPLAY_KINDS = ("stale", "reappear")
#: elastic-membership roster operations (not faults: roster transitions)
MEMBERSHIP_KINDS = ("join", "leave", "rejoin")
#: the daemon engine's process fault: SIGKILL a worker, ``when`` "invoke"
#: (right as the round's request reaches it) or "idle" (at the relay)
_WORKER_KINDS = ("worker_kill",)
#: bytes XOR-flipped at the payload tail by corrupt_payload (the data
#: section, past the header: the CRC check is what catches it)
_CORRUPT_TAIL = 8


class ChaosFault(RuntimeError):
    """An injected invocation fault (simulated crash/hang)."""

    kind = "chaos"


class ChaosCrash(ChaosFault):
    kind = "crash"


class ChaosHang(ChaosFault):
    """A hung site: the invocation never returns and the engine's timeout
    kills it — simulated by raising instead of invoking (no output, no
    cache advance)."""

    kind = "hang"


class ChaosReappear(ChaosFault):
    """The death half of a ``reappear`` fault: the site dies for good at
    the pinned round, and its last output is redelivered one round
    later."""

    kind = "reappear"


class Fault:
    """One pinned fault of the plan."""

    __slots__ = ("kind", "round", "site", "file", "times", "seconds",
                 "heal_after", "when", "fired")

    def __init__(self, spec, index):
        if not isinstance(spec, dict):
            raise ValueError(f"fault[{index}]: expected an object, got {spec!r}")
        self.kind = spec.get("kind")
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"fault[{index}]: unknown kind {self.kind!r} "
                f"(known: {', '.join(FAULT_KINDS)})"
            )
        if spec.get("round") is None:
            raise ValueError(
                f"fault[{index}] ({self.kind}): 'round' is required — every "
                "fault is pinned to a 1-based engine round for determinism"
            )
        self.round = int(spec["round"])
        self.site = str(spec["site"]) if spec.get("site") is not None else None
        self.file = str(spec["file"]) if spec.get("file") is not None else None
        if self.site is None and self.kind in (
            _INVOKE_KINDS + _PAYLOAD_KINDS + _REPLAY_KINDS + _WORKER_KINDS
            + MEMBERSHIP_KINDS
        ):
            raise ValueError(f"fault[{index}] ({self.kind}): 'site' is required")
        if self.file is None and self.kind in _PAYLOAD_KINDS + _RELAY_KINDS:
            raise ValueError(f"fault[{index}] ({self.kind}): 'file' is required")
        # crash/hang/reappear are permanent by default (a dead process stays
        # dead, so the invocation retries exhaust); the rest fire once
        default_times = None if self.kind in ("crash", "hang", "reappear") else 1
        self.times = int(spec["times"]) if spec.get("times") is not None else default_times
        self.seconds = float(spec.get("seconds", 0.25))
        self.heal_after = int(spec.get("heal_after", 1))
        self.when = str(spec.get("when", "invoke"))
        if self.kind in _WORKER_KINDS and self.when not in ("invoke", "idle"):
            raise ValueError(
                f"fault[{index}] ({self.kind}): 'when' must be 'invoke' "
                f"(kill mid-invocation) or 'idle' (kill between rounds), "
                f"got {self.when!r}"
            )
        self.fired = 0

    def matches(self, rnd, site=None):
        if self.round != int(rnd):
            return False
        return self.site is None or site is None or self.site == str(site)

    def can_fire(self):
        return self.times is None or self.fired < self.times

    def describe(self):
        where = f"round {self.round}"
        if self.site:
            where += f"/{self.site}"
        if self.file:
            where += f" ({self.file})"
        return f"{self.kind} @ {where}"


def fraction_kill_plan(n_sites, fraction, round=2, seed=0, kind="crash"):
    """Permanently kill ``ceil(fraction · n_sites)`` distinct sites (at
    most ``n_sites - 1``) at engine round ``round``; the sites come from a
    ``random.Random(seed)`` shuffle of the roster, so the same arguments
    always kill the same sites.  Returns a plan dict."""
    n_sites = int(n_sites)
    if not 0.0 < float(fraction) < 1.0:
        raise ValueError(
            f"fraction {fraction!r} must be strictly in (0, 1) — killing "
            "nobody or everybody is not a chaos scenario"
        )
    n_kill = min(int(math.ceil(float(fraction) * n_sites)), n_sites - 1)
    roster = [f"site_{i}" for i in range(n_sites)]
    random.Random(int(seed)).shuffle(roster)
    return {"faults": [
        {"kind": str(kind), "round": int(round), "site": s}
        for s in sorted(roster[:n_kill])
    ]}


def slow_site_plan(site="site_0", seconds=0.25, first_round=2, last_round=64):
    """Slow ONE site by ``seconds`` on every engine round in
    ``[first_round, last_round]`` (one ``slow`` fault per round: faults
    stay pinned to rounds) — the straggler the async rounds hide.  The
    sleep runs on the invoking thread, so under the async pool it delays
    only that site's invocation.  Returns a plan dict."""
    first_round, last_round = int(first_round), int(last_round)
    if not 0 < first_round <= last_round:
        raise ValueError(
            f"need 0 < first_round <= last_round, got [{first_round}, {last_round}]"
        )
    return {"faults": [
        {"kind": "slow", "round": r, "site": str(site), "seconds": float(seconds)}
        for r in range(first_round, last_round + 1)
    ]}


def churn_plan(n_sites, fraction, first_round=2, rounds=4, seed=0, min_active_frac=0.5):
    """Elastic-membership churn plan: every round in ``[first_round,
    first_round + rounds)`` accrues ``fraction · active`` of churn credit
    and fires one roster operation per whole credit, cycling leave → join
    → rejoin (fractional credit carries).  The generator simulates the
    roster, so only active sites leave, joins mint fresh ids past the
    founding roster, rejoins re-admit left sites (a join when none has
    left), and the active roster never drops below ``min_active_frac`` of
    the founding size (a leave becomes a join there).  Returns a plan
    dict; the site-vectorized engine applies its operations and the serial
    engines refuse them."""
    n_sites = int(n_sites)
    if not 0.0 < float(fraction) < 1.0:
        raise ValueError(
            f"fraction {fraction!r} must be strictly in (0, 1) — churning "
            "nobody or everybody is not an elasticity drill"
        )
    rng = random.Random(int(seed))
    active = [f"site_{i}" for i in range(n_sites)]
    left = []
    next_new = n_sites
    floor = max(1, int(math.ceil(float(min_active_frac) * n_sites)))
    faults = []
    ops_cycle = ("leave", "join", "rejoin")
    op_ix = 0
    credit = 0.0
    for r in range(int(first_round), int(first_round) + int(rounds)):
        credit += float(fraction) * len(active)
        n_ops = int(credit)
        credit -= n_ops
        for _ in range(n_ops):
            kind = ops_cycle[op_ix % len(ops_cycle)]
            op_ix += 1
            if kind == "rejoin" and not left:
                kind = "join"
            if kind == "leave" and len(active) <= floor:
                kind = "join"
            if kind == "leave":
                site = active.pop(rng.randrange(len(active)))
                left.append(site)
            elif kind == "rejoin":
                site = left.pop(0)
                active.append(site)
            else:  # join
                site = f"site_{next_new}"
                next_new += 1
                active.append(site)
            faults.append({"kind": kind, "round": r, "site": site})
    return {"faults": faults}


def load_fault_plan(spec):
    """Fault plan (dict or JSON file path) → validated list of faults."""
    if isinstance(spec, (str, os.PathLike)):
        with open(spec, "r", encoding="utf-8") as f:
            spec = json.load(f)
    if not isinstance(spec, dict) or not isinstance(spec.get("faults"), list):
        raise ValueError("fault plan must be an object with a 'faults' list")
    return [Fault(s, i) for i, s in enumerate(spec["faults"])]


class _NullChaos:
    """No plan: every hook is a constant-return no-op."""

    __slots__ = ()
    enabled = False
    faults = ()

    def __bool__(self):
        return False

    def invoke_fault(self, rnd, site, rec):
        return None

    def payload_faults(self, rnd, site, dirpath, rec):
        return ()

    def relay_fault(self, rnd, fname, site, rec):
        return None

    def stale_fault(self, rnd, site, rec):
        return None

    def worker_fault(self, rnd, site, rec, when="invoke"):
        return None

    def membership_ops(self, rnd, rec):
        return ()

    def reappear_deliveries(self, rnd, rec):
        return ()

    def heal_for_retry(self, rec=None, target=None):
        return 0

    @contextlib.contextmanager
    def activate(self, rec):
        yield self


NULL_CHAOS = _NullChaos()


class ChaosSession:
    """One engine run's fault injector (firing counts and repairs)."""

    enabled = True

    def __init__(self, plan):
        self.faults = load_fault_plan(plan)
        # abs payload path -> [repair_fn, fault, failed_attempts, reader]:
        # damage a retry can heal.  ``reader`` is the node that reads the
        # damaged path, so a retry of one node heals only its own reads
        self._repairs = {}
        # site -> the round at which a reappear fault redelivers its output
        self._reappear_due = {}
        self._rec = None

    @classmethod
    def from_spec(cls, spec):
        """``None`` → the no-op singleton; anything else → a live session."""
        if spec is None:
            return NULL_CHAOS
        if isinstance(spec, (ChaosSession, _NullChaos)):
            return spec
        return cls(spec)

    # ------------------------------------------------------------ fault query
    def _fire(self, fault, rec, **attrs):
        fault.fired += 1
        if rec is not None:
            # the fault's kind rides as ``fault``: ``kind`` is the record's
            # schema discriminator
            rec.event(
                "chaos:inject", cat="chaos", fault=fault.kind,
                fault_round=fault.round,
                **({"site": fault.site} if fault.site else {}),
                **({"file": fault.file} if fault.file else {}),
                **attrs,
            )

    def invoke_fault(self, rnd, site, rec):
        """Before every node invocation attempt: raises for crash/hang
        (every attempt at the pinned round fires until ``times`` is spent),
        sleeps for slow, and raises the death of a reappear fault."""
        for fault in self.faults:
            if fault.kind not in _INVOKE_KINDS:
                continue
            if not (fault.matches(rnd, site) and fault.can_fire()):
                continue
            self._fire(fault, rec, attempt=fault.fired + 1)
            if fault.kind == "slow":
                time.sleep(fault.seconds)
                continue
            exc_cls = ChaosCrash if fault.kind == "crash" else ChaosHang
            raise exc_cls(f"injected {fault.kind} ({fault.describe()}, firing {fault.fired})")
        for fault in self.faults:
            if fault.kind != "reappear":
                continue
            if not (fault.matches(rnd, site) and fault.can_fire()):
                continue
            self._fire(fault, rec, attempt=fault.fired + 1)
            self._reappear_due.setdefault(str(site), int(rnd) + 1)
            raise ChaosReappear(
                f"injected reappear death ({fault.describe()}, stale "
                f"output redelivers at round {int(rnd) + 1})"
            )
        return None

    # ---------------------------------------------------------- replay faults
    def stale_fault(self, rnd, site, rec):
        """The matching ``stale`` fault of this (round, site), or None: the
        engine skips the invocation and replays the site's last output."""
        for fault in self.faults:
            if fault.kind != "stale":
                continue
            if not (fault.matches(rnd, site) and fault.can_fire()):
                continue
            self._fire(fault, rec)
            return fault
        return None

    def worker_fault(self, rnd, site, rec, when="invoke"):
        """The matching ``worker_kill`` fault of this (round, site, kill
        point), or None; the daemon engine SIGKILLs the target's worker."""
        for fault in self.faults:
            if fault.kind not in _WORKER_KINDS or fault.when != str(when):
                continue
            if not (fault.matches(rnd, site) and fault.can_fire()):
                continue
            self._fire(fault, rec, when=fault.when)
            return fault
        return None

    def membership_ops(self, rnd, rec):
        """The elastic-membership operations pinned to this round, in plan
        order: ``[(kind, site), ...]`` with kind join, leave or rejoin.  The
        engine acts on them; each fires exactly once."""
        ops = []
        for fault in self.faults:
            if fault.kind not in MEMBERSHIP_KINDS:
                continue
            if not (fault.matches(rnd) and fault.can_fire()):
                continue
            self._fire(fault, rec)
            ops.append((fault.kind, fault.site))
        return ops

    def reappear_deliveries(self, rnd, rec):
        """Sites whose reappear redelivery is due this round; each delivers
        exactly once."""
        due = sorted(s for s, r in self._reappear_due.items() if r == int(rnd))
        for s in due:
            del self._reappear_due[s]
            if rec is not None:
                rec.event(
                    "chaos:inject", cat="chaos", fault="reappear",
                    fault_round=int(rnd), site=s, delivery=True,
                )
        return due

    # ---------------------------------------------------------- payload damage
    def payload_faults(self, rnd, site, dirpath, rec):
        """Damage committed payloads in ``dirpath`` (a site's transfer
        directory) per the plan; returns the faults that fired.  The
        original bytes are kept, so a heal restores them exactly."""
        fired = []
        for fault in self.faults:
            if fault.kind not in _PAYLOAD_KINDS + ("drop_relay",):
                continue
            if not (fault.matches(rnd, site) and fault.can_fire()):
                continue
            path = os.path.join(dirpath, fault.file)
            if not os.path.exists(path):
                continue
            with open(path, "rb") as f:
                original = f.read()
            if fault.kind == "truncate_payload":
                damaged = original[: max(len(original) * 3 // 5, 1)]
            elif fault.kind == "corrupt_payload":
                tail = bytes(b ^ 0xFF for b in original[-_CORRUPT_TAIL:])
                damaged = original[:-_CORRUPT_TAIL] + tail
            else:  # drop_relay on a site payload: it vanishes
                damaged = None
            if damaged is None:
                os.unlink(path)
            else:
                with open(path, "wb") as f:  # the damage is deliberately not atomic
                    f.write(damaged)
            # a site's outbound payloads are read by the aggregator
            self._register_repair(path, original, fault, reader="remote")
            self._fire(fault, rec, bytes=len(original))
            fired.append(fault)
        return fired

    def _register_repair(self, path, original, fault, reader=None):
        def repair(path=path, original=original):
            with open(path, "wb") as f:
                f.write(original)

        self._repairs[os.path.abspath(path)] = [repair, fault, 0, reader]

    # ----------------------------------------------------------------- relay
    def relay_fault(self, rnd, fname, site, rec):
        """Relay hook (aggregator → site copies): the matching drop or
        duplicate fault (the engine acts on it), or None."""
        for fault in self.faults:
            if fault.kind not in _RELAY_KINDS or fault.file != fname:
                continue
            if not (fault.matches(rnd, site) and fault.can_fire()):
                continue
            self._fire(fault, rec, target=str(site))
            return fault
        return None

    def deliver_duplicate(self, src, dst, fault, reader, rec):
        """The previous round's payload (already at ``dst``) arrives again
        AFTER the fresh delivery and clobbers it — the stale copy only the
        manifest CRC cross-check can catch.  The repair restores the fresh
        delivery.  A first delivery (nothing stale) is a harmless double
        copy."""
        stale = None
        if os.path.exists(dst):
            with open(dst, "rb") as f:
                stale = f.read()
        transport.atomic_copy(src, dst)  # the fresh delivery lands first
        if stale is None:
            transport.atomic_copy(src, dst)
            return
        with open(dst, "wb") as f:  # the late duplicate overwrites it
            f.write(stale)

        def repair(src=src, dst=dst):
            transport.atomic_copy(src, dst)

        self._repairs[os.path.abspath(dst)] = [repair, fault, 0, reader]

    def register_dropped_relay(self, src, dst, fault, reader=None):
        """A dropped relay: its repair performs the copy; ``reader`` is the
        site that reads ``dst``."""

        def repair(src=src, dst=dst):
            transport.atomic_copy(src, dst)

        self._repairs[os.path.abspath(dst)] = [repair, fault, 0, reader]

    # ------------------------------------------------------------------ heal
    def _heal(self, key, rec):
        repair, fault, _, _ = self._repairs.pop(key)
        repair()
        if rec is not None:
            rec.event("chaos:heal", cat="chaos", fault=fault.kind,
                      file=os.path.basename(key))

    def on_load_failure(self, path, attempt, exc):
        """Transport load-failure hook (in-process readers): repair the
        damaged payload once ``heal_after`` failed attempts accumulated.
        The damage blocking a load may sit on the directory's manifest
        rather than on the loaded file (a dropped or duplicated
        ``.wire_manifest.json`` fails the payload's CRC cross-check), so a
        repair registered on the manifest heals too."""
        key = os.path.abspath(str(path))
        entry = self._repairs.get(key)
        if entry is None:
            key = os.path.abspath(os.path.join(os.path.dirname(str(path)),
                                               transport.MANIFEST_NAME))
            entry = self._repairs.get(key)
        if entry is None:
            return False
        entry[2] += 1
        if entry[2] < entry[1].heal_after:
            return False
        self._heal(key, self._rec)
        return True

    def heal_for_retry(self, rec=None, target=None):
        """Repair the pending damage blocking ``target``'s reads, between
        two invocation attempts (the heal of a reader whose loads run in
        another process).  ``target=None`` heals everything; damage
        registered for another reader stays.  Returns how many payloads
        were repaired."""
        keys = [
            k for k, entry in self._repairs.items()
            if target is None or entry[3] is None or entry[3] == str(target)
        ]
        for key in keys:
            self._heal(key, rec if rec is not None else self._rec)
        return len(keys)

    # -------------------------------------------------------------- lifetime
    @contextlib.contextmanager
    def activate(self, rec):
        """Scope the session over an engine round: registers the transport
        load-failure hook (in-process heal) and pins the telemetry lane."""
        self._rec = rec
        transport.add_load_failure_hook(self.on_load_failure)
        try:
            yield self
        finally:
            transport.remove_load_failure_hook(self.on_load_failure)
            self._rec = None

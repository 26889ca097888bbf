"""proto-model-*: the port's federation protocol model checker
(``--model``), the JAX package's ``analysis/model_check.py`` over the
port's nodes, engine relay and chaos fault alphabet.

The AST half of ``--tier3`` audits each node's phase machine in isolation
and syntactically.  This pass composes the whole federation — N site
machines + the aggregator + the engine's relay channel, all lifted from
the port's AST by :mod:`~.proto_ir` — and **exhaustively explores** the
bounded execution space under the :mod:`~..resilience.chaos` fault
vocabulary:

- per-site invoke faults: ``crash``, ``hang`` (retry exhaustion),
  ``stale`` (a delayed duplicate of the previous site message delivered in
  place of the fresh one), ``reappear`` (death now, stale redelivery one
  round later), ``truncate_payload`` / ``corrupt_payload`` (detectable
  payload damage on the site→aggregator leg);
- per-site relay faults on the broadcast leg: ``drop_relay`` /
  ``duplicate_delivery``, each targeting the payload file or its
  ``.wire_manifest.json`` sidecar (the only witness that an intact,
  self-validating payload is STALE);
- the daemon's worker kills, the async stand-in, run-ahead deliveries and
  the join/leave/rejoin roster transitions.

Exploration is BFS over hashed global states with a configurable bound
(default: :class:`~..config.keys.ModelCheck` — 2 sites × 3 federated
rounds × the full alphabet at fault budget 1, the JAX package's bound),
across both quorum configurations (all-site lockstep and
``site_quorum=1``), both NEXT_RUN dispatch branches (pretrain on/off), the
async window, the run-ahead depth and the elastic roster.  The checked
invariants are the :class:`~..config.keys.ModelCheck` vocabulary:
deadlock-freedom, no lifecycle reset, quorum soundness, exactly-once
gradient contributions and broadcast updates, single-transient-fault
recoverability, roster soundness and the path-sensitive promotion of the
cache read-before-write rule.  ``proto-model-volatile`` is not checked: it
is the JAX package's compiled-step bucket hygiene, and the port compiles no
step (:mod:`~.protocol_flow`).

Every violation is emitted as a ``proto-model-*`` finding through the
same baseline machinery as the static tiers AND as an executable chaos
fault plan (``--model-plans``) whose faults the port's
:func:`~..resilience.chaos.validate_plan` takes, so the plan replays
through the port's engines (``InProcessEngine(..., fault_plan=plan)``).

Deterministic and pure-Python: no ``torch``, no clocks, no randomness —
the same tree, bound and findings on every run.
"""
import collections
import dataclasses
import itertools
import json
import os

from ..config.keys import ModelCheck
from .core import Finding
from .proto_ir import build_protocol_ir

#: the fault alphabet the explorer schedules (``slow`` is
#: protocol-invisible in a lockstep engine and is deliberately absent).
#: ``worker_crash``/``worker_restart`` are the DAEMON
#: supervision actions: the site's long-lived worker process is killed
#: mid-invocation (crash) or between rounds (restart), the supervisor
#: restarts it and the invocation re-runs against the engine's
#: round-tripped cache — so unlike ``crash``/``hang`` the SITE stays
#: alive, and the invariants verify the supervision contract: a restarted
#: worker contributes to the round's reduce exactly once (the crashed
#: attempt's output is discarded by the engine and its payload files are
#: atomically overwritten by the re-invocation), and a restart during the
#: relay never wedges the next round.  Counterexamples replay as
#: ``worker_kill`` chaos plans through a real ``DaemonEngine``.
FAULT_ALPHABET = (
    "crash", "hang", "stale", "reappear",
    "truncate_payload", "corrupt_payload",
    "drop_relay", "duplicate_delivery",
    "worker_crash", "worker_restart",
    # the async round engine's stand-in — the site is not
    # invoked this round and its LAST output (with its lagging wire_round
    # echo) is delivered instead.  Mechanically a delayed duplicate like
    # ``stale``, but scheduled only in scenarios whose staleness window k
    # is positive: the aggregator must ACCEPT it while the echo lags by at
    # most k (the reducer down-weights it — not modeled) and must still
    # refuse anything older.  Repeated firings age the stand-in past the
    # window, which is how the seeded k-violation reaches the boundary.
    "staleness_k",
    # run-ahead pipelining — the site delivers a FRESH
    # contribution computed against the broadcast its PREVIOUS output
    # consumed (the engine re-submitted it while the reduce tail was
    # still in flight on the reducer worker).  The wire_round echo lags
    # by the pipeline depth and ages one more round per consecutive
    # firing; the aggregator must ACCEPT it while the lag is at most
    # k + d (the reducer's gamma**lag discount covers it — not modeled)
    # and refuse anything deeper.  Scheduled only in scenarios whose
    # run-ahead depth d is positive.
    "run_ahead",
    # elastic membership — deterministic ROSTER transitions,
    # not faults (they spend the separate membership budget): ``join``
    # admits the scenario's spare non-member slot mid-run (the joiner's
    # first invocation executes the local join entry and its first
    # contribution is due the FOLLOWING round, exactly once), ``leave``
    # retires a member gracefully (its flagged final contribution still
    # counts, then the roster shrinks — never a dropped site), and
    # ``rejoin`` re-admits a dead or left site with a fresh incarnation
    # whose epoch bump is the refusal boundary for any payload out of the
    # previous life.  Scheduled only in elastic scenarios on trees whose
    # aggregator runs the membership round step (facts.membership_checked).
    "join", "leave", "rejoin",
)

#: elastic-membership roster transitions: scheduled from the
#: separate ``max_membership`` budget so churn composes with the fault
#: alphabet at the default fault budget (a death + a rejoin must fit in
#: one trace)
_MEMBERSHIP_ACTIONS = ("join", "leave", "rejoin")

#: model action -> replayable chaos fault-plan kind (worker actions map to
#: the daemon engine's worker_kill fault with the matching kill point;
#: staleness_k replays as the engines' ``stale`` replay fault)
_WORKER_ACTIONS = {"worker_crash": "invoke", "worker_restart": "idle"}
_STALE_ACTIONS = ("stale", "staleness_k")

#: broken-supervisor semantics switch (tests only): a mis-implemented
#: daemon supervisor might REDELIVER the crashed worker's previous output
#: instead of re-invoking the node — exactly the stale-delivery class the
#: round-stamp invariant exists to catch.  The tests flip this to prove the worker_crash action is checkable, not vacuous:
#: with the ``wire_round`` stamp intact the protocol refuses the
#: redelivery loudly; with the stamp fact flipped, STALE_CONTRIBUTION
#: fires with a worker_kill counterexample plan.
_RESTART_REDELIVERS_LAST_OUTPUT = False

#: broken-window semantics switch (tests only): a mis-implemented async
#: window check might accept a contribution OLDER than the staleness bound
#: k into the reduce — the exact boundary the window-relaxed
#: STALE_CONTRIBUTION invariant patrols.  The tests flip this to prove the staleness_k action is checkable, not vacuous: with
#: the real window semantics a beyond-k echo is refused loudly (clean);
#: with the flip, STALE_CONTRIBUTION fires with a replayable ``stale``
#: chaos plan.
_WINDOW_ACCEPTS_BEYOND_K = False

#: broken-horizon semantics switch (tests only): a mis-implemented
#: run-ahead window might accept a FRESH contribution whose broadcast lag
#: exceeds ``k + d`` into the reduce — the broadcast-lag boundary the
#: widened window patrols (``nodes/remote.py`` reads
#: ``Federation.RUN_AHEAD`` into the window).  The tests flip this to prove the ``run_ahead`` action is checkable, not
#: vacuous: with the real window a beyond-``k+d`` echo is refused loudly
#: (clean); with the flip, STALE_CONTRIBUTION fires with a replayable
#: ``stale`` chaos plan.
_WINDOW_ACCEPTS_BEYOND_RUN_AHEAD = False

#: broken-roster semantics switches (tests only) — each pins one
#: elastic-membership invariant as checkable, not vacuous:
#:
#: - ``_ROSTER_ACCEPTS_STALE_EPOCH``: a mis-implemented membership filter
#:   accepts a payload from a NON-MEMBER (a gracefully left site's late
#:   duplicate) or one whose roster-epoch echo predates the site's current
#:   admission — the redelivery-out-of-a-dead-incarnation class only the
#:   epoch refusal can catch (quorum's reappeared-site filter never sees a
#:   graceful leaver: it was never dropped).  Flipping it makes
#:   ROSTER fire with a replayable leave+stale churn plan.
#: - ``_QUORUM_AGAINST_INIT_ROSTER``: quorum judged against the frozen
#:   founding roster instead of the live member list — a graceful
#:   retirement then counts as a death and erodes (or falsely fails) the
#:   quorum.  Flipping it makes ROSTER fire with a replayable leave plan.
#: - ``_JOIN_CONTRIBUTES_IN_ADMISSION_ROUND``: a mis-implemented engine
#:   invokes the joiner in the SAME round its admission is processed — the
#:   contribution lands twice around the r/r+1 boundary instead of exactly
#:   once at r+1.  Flipping it makes ADMISSION fire with a replayable join
#:   plan.
_ROSTER_ACCEPTS_STALE_EPOCH = False
_QUORUM_AGAINST_INIT_ROSTER = False
_JOIN_CONTRIBUTES_IN_ADMISSION_ROUND = False

#: broadcast-channel components a relay fault can target
_COMPONENTS = ("payload", "manifest")

MODEL_RULE_IDS = (
    ModelCheck.ADMISSION, ModelCheck.CACHE, ModelCheck.CONFIG,
    ModelCheck.DEADLOCK,
    ModelCheck.LOST_CONTRIBUTION, ModelCheck.LOST_UPDATE,
    ModelCheck.PHASE_RESET, ModelCheck.QUORUM, ModelCheck.ROSTER,
    ModelCheck.STALE_CONTRIBUTION, ModelCheck.UNRECOVERABLE,
    ModelCheck.WIRE,
)

#: hard ceiling on explored states per scenario — a runaway bound must
#: degrade to a typed finding, never a hung CI job
MAX_STATES = 250_000


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Exploration bound (defaults = the CI gate's contract).

    ``staleness`` is a scenario dimension like ``quorums``: every bound is
    explored at each listed async window k.  k=0 is today's exact-stamp
    lockstep (every stale delivery refused); k>0 relaxes the stamp to the
    window and schedules the ``staleness_k`` action."""

    sites: int = ModelCheck.DEFAULT_SITES
    rounds: int = ModelCheck.DEFAULT_ROUNDS
    max_faults: int = ModelCheck.DEFAULT_FAULT_BUDGET
    kinds: tuple = FAULT_ALPHABET
    quorums: tuple = (None, 1)
    pretrain: tuple = (False, True)
    staleness: tuple = (0, ModelCheck.DEFAULT_STALENESS_K)
    #: run-ahead depth dimension: d=0 is the blocking wire
    #: tail; d>0 widens the window to k + d and schedules ``run_ahead``
    run_ahead: tuple = (0, ModelCheck.DEFAULT_RUN_AHEAD)
    #: elastic-membership dimension (ModelCheck.DEFAULT_ELASTIC):
    #: elastic scenarios grow one spare non-member slot and schedule the
    #: join/leave/rejoin roster transitions from ``max_membership``
    elastic: tuple = (False, True)
    #: roster-transition budget per trace, separate from ``max_faults`` —
    #: a death (1 fault) + a rejoin (1 transition) must fit in one trace
    max_membership: int = 2

    @property
    def engine_rounds(self):
        """Engine invocation bound: INIT round + the federated rounds."""
        return int(self.rounds) + 1


@dataclasses.dataclass
class ModelResult:
    findings: list
    plans: list          # one plan dict per finding, same order
    report: dict


# --------------------------------------------------------------- state model
# All state is plain hashable tuples.
#
# site:   (alive, redeliver_rnd, applied_tag, cache_keys, any_write,
#          had_comp, last_out, adm, first_rnd)
#         last_out = (phase, keys, contrib, echo_ok, made_rnd, epoch_echo)
#         — made_rnd is the engine round the output was produced in, so a
#         stale delivery's echo lag (rnd - made_rnd) is judged against the
#         scenario's staleness window; epoch_echo is the roster epoch the
#         consumed broadcast carried (the membership filter's refusal
#         basis).  adm is the roster epoch the site was (last)
#         admitted at, or None while it is not a member (never admitted,
#         or gracefully retired); first_rnd is the round a mid-run
#         joiner's first contribution is due (0 for founding members).
# chan:   (payload_tag, manifest_tag, repairs)   repairs ⊆ {components}
# remote: (cache_keys, any_write, dropped, roster_epoch)
# bcast:  (phase, keys, update_tag, roster_epoch)
# state:  (rnd, budget, sites, chans, remote, bcast, reduces, mem_budget)
# scenario: (site_quorum, pretrain, staleness_k, run_ahead, elastic)

_FRESH_SITE = (True, 0, 0, frozenset(), False, False, None, 1, 0)
#: the elastic scenarios' spare slot: alive but never admitted — only the
#: ``join`` action can make it a member
_SPARE_SITE = (True, 0, 0, frozenset(), False, False, None, None, 0)
_FRESH_CHAN = (0, 0, frozenset())


def _initial_state(config, elastic=False):
    n = int(config.sites) + (1 if elastic else 0)
    sites = tuple(
        _SPARE_SITE if elastic and i == int(config.sites) else _FRESH_SITE
        for i in range(n)
    )
    return (
        1, int(config.max_faults),
        sites,
        tuple(_FRESH_CHAN for _ in range(n)),
        (frozenset(), False, frozenset(), 1),
        None,
        0,
        int(config.max_membership) if elastic else 0,
    )


class _Trace:
    """Immutable fault-schedule trace riding alongside a state."""

    __slots__ = ("entries",)

    def __init__(self, entries=()):
        self.entries = tuple(entries)

    def extend(self, rnd, actions):
        return _Trace(
            self.entries + tuple((rnd,) + a for a in actions)
        )

    def describe(self):
        if not self.entries:
            return "no faults"
        parts = []
        for e in self.entries:
            rnd, kind, site = e[0], e[1], e[2]
            comp = e[3] if len(e) > 3 else None
            suffix = f"/{comp}" if comp else ""
            parts.append(f"{kind}@r{rnd}/site_{site}{suffix}")
        return ", ".join(parts)


def _plan_faults(trace, avg_file, manifest_file):
    """Trace → resilience/chaos.py fault-plan entries."""
    faults = []
    for e in trace.entries:
        rnd, kind, site = e[0], e[1], e[2]
        comp = e[3] if len(e) > 3 else None
        entry = {"kind": kind, "round": int(rnd), "site": f"site_{site}"}
        if kind in _WORKER_ACTIONS:
            # the executable counterpart is the daemon engine's
            # worker_kill fault at the matching kill point
            entry["kind"] = "worker_kill"
            entry["when"] = _WORKER_ACTIONS[kind]
        elif kind in ("staleness_k", "run_ahead"):
            # the executable counterpart is the engines' stale replay
            # fault: skip the invocation, redeliver the previous output
            # (for run_ahead it approximates the lagging echo — the
            # delayed-broadcast class the window refuses either way)
            entry["kind"] = "stale"
        elif kind in ("truncate_payload", "corrupt_payload"):
            entry["file"] = "grads.npy"
        elif comp is not None:
            entry["file"] = manifest_file if comp == "manifest" else avg_file
        faults.append(entry)
    return faults


# ---------------------------------------------------------------- IR helpers
def _block_events(node_ir, phases):
    """Ordered executed blocks for an invocation: the unguarded block plus
    each phase in ``phases`` that has a block."""
    blocks = []
    if None in node_ir.blocks:
        blocks.append(node_ir.blocks[None])
    for p in phases:
        b = node_ir.blocks.get(p)
        if b is not None:
            blocks.append(b)
    return blocks


#: within-invocation dispatch rewrites the model follows (phase → the
#: successors reachable without a mode barrier; NEXT_RUN_WAITING/TEST are
#: gated on the test mode, which a bounded steady-state run never reaches)
_CHAIN_GATE = {
    "next_run": ("computation", "pre_computation"),
    "pre_computation": ("computation",),
}


def _local_dispatch(node_ir, incoming, pretrain):
    """(executed phases, out_phase) of a site invocation."""
    if incoming not in node_ir.tested_phases:
        # unhandled broadcast phase: only unguarded code runs; phase echoes
        return [], incoming
    executed, cur = [], incoming
    for _ in range(4):
        block = node_ir.blocks.get(cur)
        if cur in executed or block is None:
            break
        executed.append(cur)
        allowed = [
            p for p in block.outgoing if p in _CHAIN_GATE.get(cur, ())
        ]
        if not allowed:
            break
        if cur == "next_run":
            nxt = ("pre_computation"
                   if pretrain and "pre_computation" in allowed
                   else "computation")
            if nxt not in allowed and allowed:
                nxt = allowed[0]
        else:
            nxt = allowed[0]
        # PRE_COMPUTATION is an *output* phase (the next round dispatches
        # it); COMPUTATION chains into its block within this invocation
        if nxt == "pre_computation":
            return executed, "pre_computation"
        cur = nxt
    return executed, cur


# ------------------------------------------------------------------ explorer
class _Explorer:
    def __init__(self, ir, config):
        self.ir = ir
        self.config = config
        self.findings = {}       # (rule, path, line) -> (Finding, plan)
        self.report = {
            "produced": set(), "consumed": set(),
            "states": 0, "runs": 0,
            "confirmed_cache": set(),
            "exercised_reads": set(),
            "phases_covered": set(),
            "terminal_loud": 0, "terminal_success": 0,
        }

    # ------------------------------------------------------------- findings
    def _emit(self, rule, anchor, message, scenario, trace, invariant):
        path, line = anchor
        key = (rule, path, line)
        if key in self.findings:
            return
        plan = {
            "comment": (
                "dinulint model-checker counterexample of the PyTorch "
                "port — replay with InProcessEngine(..., "
                "fault_plan=<this file>)"
            ),
            "rule": rule,
            "invariant": invariant,
            "scenario": {
                "n_sites": self.config.sites,
                "site_quorum": scenario[0],
                "pretrain": bool(scenario[1]),
                "staleness_k": int(scenario[2]) if len(scenario) > 2 else 0,
                "run_ahead": int(scenario[3]) if len(scenario) > 3 else 0,
                "elastic": bool(scenario[4]) if len(scenario) > 4 else False,
                "engine_rounds": self.config.engine_rounds,
            },
            "faults": _plan_faults(trace, "avg_grads.npy",
                                   ".wire_manifest.json"),
        }
        quorum = scenario[0]
        k = int(scenario[2]) if len(scenario) > 2 else 0
        d_ra = int(scenario[3]) if len(scenario) > 3 else 0
        elastic = bool(scenario[4]) if len(scenario) > 4 else False
        msg = (
            f"{message} — counterexample: site_quorum={quorum}, "
            f"pretrain={bool(scenario[1])}, staleness_k={k}, "
            f"run_ahead={d_ra}, elastic={elastic}, "
            f"faults=[{trace.describe()}] "
            f"(bound: {self.config.sites} sites x {self.config.rounds} "
            f"rounds, budget {self.config.max_faults}); replayable chaos "
            "plan via --model-plans"
        )
        self.findings[key] = (
            Finding(rule=rule, path=path, line=line, col=0, message=msg),
            plan,
        )

    def _anchor(self, name, default_side=None):
        a = self.ir.facts.anchors.get(name)
        if a:
            return a
        side = default_side or self.ir.remote
        return (side.path, 1)

    def _remote_phase_anchor(self):
        b = self.ir.remote.blocks.get(None)
        if b:
            for e in b.produces:
                if e.key == "phase":
                    return (self.ir.remote.path, e.line)
        return (self.ir.remote.path, 1)

    # ------------------------------------------------------------ execution
    def _exec_events(self, node_ir, state_site, executed_phases, incoming,
                     msg_keys, scenario, trace):
        """Run a node invocation's IR events: cache lifecycle checks, wire
        bookkeeping.  Returns (produced keys, new cache, new any_write)."""
        alive, redeliver, applied, cache, any_w, had_comp, last = \
            state_site[:7]
        produced = set()
        writers = node_ir.static_cache_writers()
        cache = set(cache)
        blocks = _block_events(node_ir, executed_phases)
        for block in blocks:
            self.report["phases_covered"].add((node_ir.role, block.phase))
            block_writes = {
                e.key for e in block.cache_writes if e.key != "*"
            }
            block_wild = any(e.key == "*" for e in block.cache_writes)
            for e in block.cache_reads:
                if e.kind != "hard" or e.key.startswith("_"):
                    continue
                if e.key not in writers:
                    continue  # written outside this node: origin unknown
                self.report["exercised_reads"].add((node_ir.path, e.line))
                if any_w or block_wild or e.key in cache or (
                    e.key in block_writes
                ):
                    continue
                self.report["confirmed_cache"].add((node_ir.path, e.line))
                self._emit(
                    ModelCheck.CACHE, (node_ir.path, e.line),
                    f"cache['{e.key}'] is read in the "
                    f"{block.phase or 'unguarded'} block before any write "
                    "of it has executed on this explored path "
                    "(path-sensitive promotion of "
                    "proto-cache-read-before-write)",
                    scenario, trace, "cache write-before-read",
                )
            for e in block.cache_writes:
                if e.key == "*":
                    any_w = True
                    continue
                cache.add(e.key)
            for e in block.produces:
                produced.add(e.key)
                self.report["produced"].add((node_ir.role, e.key, e.line))
            for e in block.consumes:
                if e.key in msg_keys:
                    self.report["consumed"].add((node_ir.role, e.key))
        return produced, frozenset(cache), any_w

    def _site_round(self, i, site, chan, bcast, faults, scenario, trace,
                    rnd, quorum):
        """One site's turn.  Returns (site', chan', out or None,
        loud or None, violations already emitted)."""
        alive, redeliver, applied, cache, any_w, had_comp, last = site[:7]
        adm, first_rnd = site[7], site[8]
        tail = site[7:]
        my_faults = {a[0] for a in faults if a[1] == i}
        if not alive:
            return site, chan, None, None
        if adm is None:
            # not a roster member: a retired or never-admitted
            # site is not invoked — only a late duplicate of a LEFT
            # site's final payload can still arrive (the stale action),
            # which the aggregator's membership filter must refuse as a
            # non-member contribution
            if (my_faults & set(_STALE_ACTIONS)) and last is not None:
                phase, keys, contrib, _, made = last[:5]
                echo_e = last[5] if len(last) > 5 else None
                return site, chan, (phase, keys, contrib, False, made,
                                    echo_e), None
            return site, chan, None, None
        if first_rnd > rnd:
            # admitted this very round: the joiner's first invocation
            # (and first contribution) is due NEXT round — its absence
            # from this round's input is the joining grace, not a drop
            return site, chan, None, None
        if my_faults & {"crash", "hang", "reappear"}:
            if quorum is None:
                return site, chan, None, "site failure without quorum"
            redeliver_rnd = rnd + 1 if "reappear" in my_faults else 0
            return ((False, redeliver_rnd, applied, cache, any_w, had_comp,
                     last) + tail, chan, None, None)
        if (my_faults & set(_STALE_ACTIONS)) and last is not None:
            # delayed duplicate / async stand-in: previous output
            # redelivered, cache frozen — the echo lag (rnd - made_rnd)
            # grows with every repeated firing
            phase, keys, contrib, _, made = last[:5]
            echo_e = last[5] if len(last) > 5 else None
            return site, chan, (phase, keys, contrib, False, made,
                                echo_e), None

        incoming = bcast[0] if bcast else "init_runs"
        executed, out_phase = _local_dispatch(
            self.ir.local, incoming, scenario[1]
        )
        if first_rnd == rnd and "join" in self.ir.local.blocks:
            # a mid-run joiner's FIRST invocation: the local join entry
            # (the carved JOIN_BLOCK — fold adoption, warm start) executes
            # before the steady-state dispatch, exactly once
            executed = ["join"] + list(executed)
        msg_keys = bcast[1] if bcast else frozenset()
        # worker_crash / worker_restart: the site's DAEMON
        # WORKER dies (mid-invocation / between rounds) but the SITE does
        # not.  worker_crash: the crashed attempt half-ran — its cache/
        # wire events executed against the engine's round-tripped cache —
        # then the supervisor restarts the worker and RE-INVOKES, so the
        # invocation's events run a SECOND time below and only the
        # re-invocation's output is delivered (exactly once into the
        # reduce).  worker_restart (between rounds) loses only worker-
        # local state; the protocol state lives entirely in the engine's
        # round-trip, so the next invocation proceeds unchanged.  The
        # invariant sweep judges every path carrying these actions
        # (exactly-once contributions/updates, deadlock freedom), and the
        # broken-supervisor switch above pins the check as non-vacuous.
        if "worker_crash" in my_faults:
            if _RESTART_REDELIVERS_LAST_OUTPUT:
                if last is not None:
                    phase, keys, contrib, _, made = last[:5]
                    echo_e = last[5] if len(last) > 5 else None
                    return site, chan, (phase, keys, contrib, False,
                                        made, echo_e), None
            else:
                _, cache_crash, anyw_crash = self._exec_events(
                    self.ir.local, site, executed, incoming, msg_keys,
                    scenario, trace,
                )
                site = (alive, redeliver, applied, cache_crash, anyw_crash,
                        had_comp, last) + tail
        produced, cache, any_w = self._exec_events(
            self.ir.local, site, executed, incoming, msg_keys, scenario,
            trace,
        )

        # broadcast update application (learner.step semantics)
        update_tag = bcast[2] if bcast else 0
        if update_tag and "update" in msg_keys and (
            "update" in {
                e.key for b in _block_events(self.ir.local, executed)
                for e in b.consumes
            }
        ):
            payload, manifest, repairs = chan
            detected = (payload != manifest) or payload == 0
            if detected:
                healed = set()
                for comp in repairs:
                    if comp == "payload" or (
                        comp == "manifest"
                        and self.ir.facts.heal_bridges_manifest
                    ):
                        healed.add(comp)
                if "payload" in healed:
                    payload = update_tag
                if "manifest" in healed:
                    manifest = update_tag
                repairs = frozenset(repairs - healed)
                chan = (payload, manifest, repairs)
                if (payload != manifest) or payload == 0:
                    # retries exhaust: the transient killed the node
                    self._emit(
                        ModelCheck.UNRECOVERABLE, self._anchor("heal"),
                        "a single transient relay fault on the broadcast "
                        "leg exhausts the wire retries and kills the "
                        "reading site: the chaos repair is registered on "
                        "the damaged file but the failing load is on the "
                        "payload whose manifest it is — the heal never "
                        "fires (the engine relay clobber window)",
                        scenario, trace, "single-fault recoverability",
                    )
                    if quorum is None:
                        return site, chan, None, "wire failure without quorum"
                    return ((False, 0, applied, cache, any_w, had_comp,
                             last) + tail, chan, None, None)
            if payload < update_tag:
                self._emit(
                    ModelCheck.LOST_UPDATE, self._anchor(
                        "relay_duplicate", self.ir.local
                    ),
                    f"a stale broadcast payload (round {payload}) is "
                    f"applied in place of the fresh round-{update_tag} "
                    "update and passes every integrity check (payload and "
                    "manifest are both stale and mutually consistent) — "
                    "the update is silently lost on this site",
                    scenario, trace, "exactly-once update application",
                )
            applied = payload
            chan = (payload, manifest, chan[2])

        had_comp = had_comp or "computation" in executed
        contrib = rnd if "reduce" in produced else 0
        epoch_now = bcast[3] if bcast and len(bcast) > 3 else 1
        if "run_ahead" in my_faults and last is not None:
            # run-ahead pipelining: the invocation ran in full
            # and its contribution is FRESH (contrib == rnd), but it was
            # computed against the broadcast the PREVIOUS output consumed
            # — the echo stays pinned at the previous made-round and ages
            # one more round per consecutive firing, which is how the
            # seeded trace reaches the k + d boundary
            out = (out_phase, frozenset(produced), contrib, False, last[4],
                   last[5] if len(last) > 5 else None)
        else:
            out = (out_phase, frozenset(produced), contrib, True, rnd,
                   epoch_now)
        site = (alive, redeliver, applied, cache, any_w, had_comp,
                out) + tail
        return site, chan, out, None

    def _remote_round(self, state, site_outs, stale_flags, scenario, trace):
        """The aggregator's turn: membership filter, quorum, lockstep
        guards, dispatch, reduce bookkeeping.  Returns (remote', bcast or
        None, loud, reduced)."""
        rnd, budget, sites, chans, remote, bcast, reduces = state[:7]
        quorum = scenario[0]
        r_cache, r_any, dropped = remote[:3]
        epoch = remote[3] if len(remote) > 3 else 1
        facts = self.ir.facts
        elastic = len(scenario) > 4 and bool(scenario[4])

        # elastic membership: this round's roster transitions
        # (trace entries carry them), the per-site ADMISSION epoch as the
        # aggregator sees it after processing admissions at the TOP of its
        # round (process_admissions runs before the payload filter), and
        # the broadcast epoch (admission bumps ride this round's
        # broadcast; graceful-leave bumps land after it)
        mem_now = [(e[1], e[2]) for e in trace.entries
                   if e[0] == rnd and e[1] in _MEMBERSHIP_ACTIONS]
        adm_eff = {i: s[7] for i, s in enumerate(sites)}
        pos = 0
        for kind, i in mem_now:
            if kind in ("join", "rejoin"):
                pos += 1
                adm_eff[i] = epoch + pos
        epoch_out = epoch + pos
        admitted_now = {i for kind, i in mem_now if kind != "leave"}

        filtered = dict(site_outs)
        # ---- the membership filter (federation/membership.py): refuse
        # payloads BY ROSTER EPOCH before quorum/lockstep/reduce see them
        # — non-member outputs (a left site's late duplicate) and echoes
        # older than the site's current admission (a redelivery out of a
        # previous, dead incarnation racing its rejoin)
        mem_refused = set()
        if elastic and facts.membership_checked:
            for i, out in sorted(site_outs.items()):
                adm_i = adm_eff.get(i)
                echo = out[5] if len(out) > 5 else None
                nonmember = adm_i is None
                stale_epoch = (
                    adm_i is not None and echo is not None
                    and int(echo) < int(adm_i)
                )
                if not (nonmember or stale_epoch):
                    continue
                refuses = (
                    not _ROSTER_ACCEPTS_STALE_EPOCH
                    and (nonmember or facts.roster_epoch_refusal)
                )
                if refuses:
                    mem_refused.add(i)
                    filtered.pop(i, None)

        # quorum is judged against the LIVE roster: a gracefully retired
        # site is gone from it (never a death), a never-admitted spare
        # was never in it.  _QUORUM_AGAINST_INIT_ROSTER (tests only)
        # models the grow-only bug: the founding roster stays frozen and
        # a retirement erodes quorum like a death.
        members = {i for i, s in enumerate(sites) if s[7] is not None}
        retired = {
            i for i, s in enumerate(sites)
            if s[7] is None and s[0] and (s[5] or s[6] is not None)
        }
        roster = (
            set(range(self.config.sites)) if _QUORUM_AGAINST_INIT_ROSTER
            else set(members)
        )
        if facts.quorum_checked:
            returned = dropped & set(site_outs)
            if returned and facts.quorum_filters_reappeared:
                for i in returned:
                    filtered.pop(i, None)
            delivered = set(site_outs) - {
                i for i in mem_refused if adm_eff.get(i) is not None
            }
            missing = (roster - delivered) | dropped
            if quorum and (missing & retired):
                self._emit(
                    ModelCheck.ROSTER,
                    self._anchor("membership", self.ir.remote),
                    "quorum is computed against a stale roster: a "
                    "gracefully retired site is still counted as a "
                    "missing member, so its leave erodes quorum exactly "
                    "like a death (the roster the quorum policy reads "
                    "was frozen at INIT)",
                    scenario, trace, "quorum against the live roster",
                )
            new_drops = missing - dropped
            if new_drops:
                if not quorum:
                    return remote, None, "sites dropped without policy", False
                if len(filtered) < max(int(quorum), 1):
                    return remote, None, "quorum unmet", False
                dropped = frozenset(dropped | new_drops)
        # the reducer/trainer input snapshot: membership refusals reach it
        # only when the membership step ran BEFORE the snapshot (its own
        # ordering fact, independent of the quorum one) — otherwise the
        # refused payloads still reach the reduce (the
        # proto-model-stale-contribution ordering hazard, roster flavor)
        base_input = (
            {i: o for i, o in site_outs.items() if i not in mem_refused}
            if facts.membership_before_reduce_input else dict(site_outs)
        )
        reducer_input = (
            filtered if (facts.quorum_checked
                         and facts.quorum_before_reduce_input)
            else base_input
        )

        phases = {out[0] for out in filtered.values()}
        if len(phases) > 1:
            if facts.lockstep_phase_guard:
                return remote, None, "mixed phases refused", False
            self._emit(
                ModelCheck.PHASE_RESET, self._remote_phase_anchor(),
                "a mixed-phase round (a stale site message next to fresh "
                "ones) falls through every dispatch branch and the "
                "aggregator echoes the INIT_RUNS default — every site "
                "re-initializes and the run silently resets mid-training",
                scenario, trace, "no lifecycle reset",
            )
            return remote, None, None, False
        phase = next(iter(phases)) if phases else "init_runs"
        # stale same-phase message: only the echoed round stamp catches it.
        # Under the async window (scenario staleness_k > 0 AND the guard
        # implements the cache-keyed window — facts.round_lockstep_window)
        # an echo lagging by at most k is ACCEPTED: the async engine's
        # stand-in for a straggler, down-weighted by the reducer (not
        # modeled).  Anything older must still be refused loudly; the
        # test-only _WINDOW_ACCEPTS_BEYOND_K switch models a broken window
        # check that lets it through, which the window-relaxed
        # STALE_CONTRIBUTION invariant below must catch.
        window = (
            int(scenario[2])
            if facts.round_lockstep_guard and facts.round_lockstep_window
            else 0
        )
        if (facts.round_lockstep_guard and facts.round_lockstep_window
                and facts.round_lockstep_run_ahead and len(scenario) > 3):
            # run-ahead pipelining widens the window to k + d — the
            # broadcast-lag allowance the real guard reads from
            # Federation.RUN_AHEAD (nodes/remote.py)
            window += int(scenario[3])
        stale_in = {i for i in filtered if stale_flags.get(i)}
        if stale_in and facts.round_lockstep_guard:
            beyond = {
                i for i in stale_in
                if rnd - (filtered[i][4] if len(filtered[i]) > 4 else rnd)
                > window
            }
            # a FRESH contribution with a lagging echo (contrib == rnd)
            # is a run-ahead delivery; a stale redelivery carries an older
            # contrib — each has its own broken-window test switch
            ra_beyond = {i for i in beyond if filtered[i][2] == rnd}
            stale_beyond = beyond - ra_beyond
            if stale_beyond and not _WINDOW_ACCEPTS_BEYOND_K:
                return remote, None, "stale round echo refused", False
            if ra_beyond and not _WINDOW_ACCEPTS_BEYOND_RUN_AHEAD:
                return remote, None, "stale round echo refused", False
            if ra_beyond and _WINDOW_ACCEPTS_BEYOND_RUN_AHEAD:
                for i in sorted(ra_beyond):
                    lag = rnd - filtered[i][4]
                    self._emit(
                        ModelCheck.STALE_CONTRIBUTION,
                        self._anchor("lockstep", self.ir.remote),
                        f"the reduce consumes site_{i}'s fresh round-{rnd} "
                        f"contribution computed {lag} broadcasts behind the "
                        f"stamp — beyond the combined k + d window: the "
                        "run-ahead horizon is unbounded and the staleness "
                        "discount no longer covers the broadcast lag",
                        scenario, trace, "bounded broadcast lag",
                    )

        if phase not in self.ir.remote.tested_phases:
            fallthrough = self.ir.remote.phase_fallthrough
            if rnd > 1 and fallthrough == "init_runs":
                self._emit(
                    ModelCheck.PHASE_RESET, self._remote_phase_anchor(),
                    f"phase '{phase}' reaches the aggregator but its "
                    "dispatch never tests it: the round falls through and "
                    "the echoed INIT_RUNS default silently resets the run",
                    scenario, trace, "no lifecycle reset",
                )
                return remote, None, None, False
            executed = []
        else:
            executed = [phase]

        msg_keys = set()
        for out in filtered.values():
            msg_keys |= out[1]
        shell = (True, 0, 0, r_cache, r_any, False, None)
        produced, r_cache, r_any = self._exec_events(
            self.ir.remote, shell, executed, phase, msg_keys, scenario,
            trace,
        )

        reduced = False
        if phase == "computation" and filtered and all(
            "reduce" in out[1] for out in filtered.values()
        ):
            reduced = True
            if facts.quorum_checked and quorum:
                pass  # unmet quorum already aborted above
            elif not facts.quorum_checked and len(site_outs) < len(roster):
                self._emit(
                    ModelCheck.QUORUM, self._anchor("reduce_input"),
                    f"the reduce proceeds with {len(site_outs)} of "
                    f"{len(roster)} sites and no quorum policy was ever "
                    "evaluated (the quorum check is missing from the "
                    "aggregator's round path)",
                    scenario, trace, "quorum soundness",
                )
            for i, out in sorted(reducer_input.items()):
                contrib = out[2]
                if "reduce" not in out[1]:
                    continue
                if contrib and contrib < rnd:
                    if i not in dropped and rnd - contrib <= window:
                        # in-window stand-in of a LIVE site: the window-
                        # relaxed exactly-once contract accepts it (the
                        # reducer's staleness discount weights it down) —
                        # only contributions OLDER than the window, or a
                        # dropped site's redelivery, violate
                        continue
                    if i in dropped:
                        anchor, why = self._anchor("reduce_input"), (
                            "the reducer's input snapshot is taken before "
                            "the quorum filtering runs, so a dropped "
                            "site's redelivered output is silently "
                            "double-counted into the global average"
                        )
                    else:
                        anchor, why = self._anchor(
                            "lockstep", self.ir.remote
                        ), (
                            "a delayed duplicate of an earlier message "
                            "from a live site carries the same phase as a "
                            "fresh one — only a round stamp echoed on the "
                            "wire (LocalWire.ROUND) can reject it"
                        )
                    self._emit(
                        ModelCheck.STALE_CONTRIBUTION, anchor,
                        f"the reduce consumes a stale round-{contrib} "
                        f"gradient payload from site_{i} in round {rnd}: "
                        + why,
                        scenario, trace, "exactly-once contributions",
                    )
            for i, out in sorted(filtered.items()):
                if out[2] == rnd and "reduce" in out[1] and (
                    i not in reducer_input
                ):
                    self._emit(
                        ModelCheck.LOST_CONTRIBUTION,
                        self._anchor("reduce_input"),
                        f"site_{i}'s fresh round-{rnd} gradient "
                        "contribution is dropped from the reduce while "
                        "the site is alive and participating",
                        scenario, trace, "exactly-once contributions",
                    )
            # ---- roster soundness: nothing from a non-member
            # epoch may enter the reduce
            if elastic:
                for i, out in sorted(reducer_input.items()):
                    if "reduce" not in out[1]:
                        continue
                    adm_i = adm_eff.get(i)
                    echo = out[5] if len(out) > 5 else None
                    if adm_i is None:
                        self._emit(
                            ModelCheck.ROSTER,
                            self._anchor("membership_filter",
                                         self.ir.remote),
                            f"the reduce consumes a payload from site_{i}, "
                            "which is NOT a roster member this round (a "
                            "gracefully retired site's late duplicate) — "
                            "only the membership filter can refuse it: the "
                            "quorum machinery never dropped the site, so "
                            "the reappeared-site filtering does not apply",
                            scenario, trace, "no non-member contributions",
                        )
                    elif echo is not None and int(echo) < int(adm_i):
                        self._emit(
                            ModelCheck.ROSTER,
                            self._anchor("membership_filter",
                                         self.ir.remote),
                            f"the reduce consumes a payload from site_{i} "
                            f"whose roster-epoch echo ({int(echo)}) "
                            "predates the site's current admission "
                            f"(epoch {int(adm_i)}) — a redelivery out of "
                            "its previous, dead incarnation double-counts "
                            "against the fresh one",
                            scenario, trace, "epoch-refused incarnations",
                        )
                # a joiner admitted at round r contributes to round r+1's
                # reduce exactly once — never to round r's
                for i in sorted(admitted_now & set(reducer_input)):
                    if reducer_input[i][2] == rnd:
                        self._emit(
                            ModelCheck.ADMISSION,
                            self._anchor("admission", self.ir.local),
                            f"site_{i} is admitted and contributes to the "
                            f"SAME round-{rnd} reduce: the admission "
                            "handshake requires the joiner's first "
                            "contribution in round r+1 (exactly once) — "
                            "an admission-round contribution lands twice "
                            "around the r/r+1 boundary",
                            scenario, trace, "joiner exactly-once",
                        )
                due = {
                    i for i, s in enumerate(sites)
                    if s[7] is not None and s[0] and s[8] == rnd
                }
                targeted = {e[2] for e in trace.entries if e[0] == rnd}
                for i in sorted(due - set(site_outs) - targeted):
                    self._emit(
                        ModelCheck.ADMISSION,
                        self._anchor("admission", self.ir.local),
                        f"site_{i} was admitted last round and its first "
                        f"contribution is due in round {rnd}, but the "
                        "engine never invoked it and no fault explains "
                        "the absence — the admission was lost",
                        scenario, trace, "joiner exactly-once",
                    )
                if admitted_now and not facts.admission_exactly_once:
                    self._emit(
                        ModelCheck.ADMISSION,
                        self._anchor("admission", self.ir.local),
                        "the local join entry is not exactly-once: no "
                        "negated cache sentinel guards the admission "
                        "block, so a retry (or a re-broadcast admission "
                        "record) re-runs the fold entry and resets the "
                        "joiner's training state mid-run",
                        scenario, trace, "joiner exactly-once",
                    )

        # broadcast phase per the executed dispatch
        if executed:
            block = self.ir.remote.blocks.get(phase)
            outgoing = [p for p in (block.outgoing if block else ())]
            out_phase = outgoing[0] if len(outgoing) >= 1 else phase
            if phase == "computation":
                out_phase = "computation"
        else:
            out_phase = phase  # covered: non-reset fallthrough (round 1)
        update_tag = rnd if reduced else (bcast[2] if bcast else 0)
        keys = frozenset(produced)
        # the broadcast carries the POST-admission epoch (the stamp every
        # site echoes back); graceful-leave bumps land in _step, after the
        # reduce counted the leaver's final contribution
        remote = (r_cache, r_any, dropped, epoch_out)
        return (remote, (out_phase, keys, update_tag, reduced, epoch_out),
                None, reduced)

    # ---------------------------------------------------------------- rounds
    def _round_actions(self, state, scenario):
        """(fault singles, membership singles) available this round, each
        sorted.  The ``staleness_k`` action only exists in scenarios whose
        window is positive — at k=0 the async engine never stands a site
        in.  Membership transitions spend the separate membership budget
        and are scheduled only in elastic scenarios, in the steady state
        (a COMPUTATION broadcast is out), on trees whose aggregator runs
        the membership round step."""
        rnd, budget, sites, chans, remote, bcast, reduces = state[:7]
        mem_budget = state[7] if len(state) > 7 else 0
        elastic = len(scenario) > 4 and bool(scenario[4])
        actions = []
        if budget > 0:
            for i, site in enumerate(sites):
                if not site[0]:
                    continue
                adm, first_rnd = site[7], site[8]
                if adm is None:
                    # a retired (left) site is never invoked again: only
                    # its late duplicate exists (the non-member refusal
                    # path the membership filter patrols)
                    if elastic and site[6] is not None and (
                        "stale" in self.config.kinds
                    ):
                        actions.append(("stale", i))
                    continue
                if first_rnd > rnd:
                    continue  # joining grace: not invocable yet
                for kind in self.config.kinds:
                    if kind in _MEMBERSHIP_ACTIONS:
                        continue  # scheduled from the membership budget
                    if kind in ("drop_relay", "duplicate_delivery"):
                        for comp in _COMPONENTS:
                            actions.append((kind, i, comp))
                    elif kind in _STALE_ACTIONS:
                        if site[6] is None:
                            continue
                        if kind == "staleness_k" and not scenario[2]:
                            continue
                        actions.append((kind, i))
                    elif kind == "run_ahead":
                        # only in scenarios with a positive pipeline depth,
                        # and only once the site has an output whose
                        # consumed broadcast the echo can stay pinned at
                        if site[6] is None:
                            continue
                        if len(scenario) < 4 or not scenario[3]:
                            continue
                        actions.append((kind, i))
                    else:
                        actions.append((kind, i))
        mems = []
        steady = bcast is not None and bcast[0] == "computation"
        if (elastic and mem_budget > 0 and steady
                and self.ir.facts.membership_checked):
            members_alive = [
                i for i, s in enumerate(sites) if s[7] is not None and s[0]
            ]
            for i, site in enumerate(sites):
                adm = site[7]
                if site[0] and adm is None:
                    # never admitted → join; gracefully left → rejoin
                    kind = ("join" if site[6] is None and not site[5]
                            else "rejoin")
                    if kind in self.config.kinds:
                        mems.append((kind, i))
                elif not site[0] and adm is not None:
                    # dead member: re-admission with a fresh incarnation
                    if "rejoin" in self.config.kinds:
                        mems.append(("rejoin", i))
                elif (adm is not None and site[8] <= rnd
                        and len(members_alive) > 1
                        and "leave" in self.config.kinds):
                    mems.append(("leave", i))
        return sorted(actions), sorted(mems)

    def _step(self, state, actions, scenario, trace):
        """Execute one engine round under ``actions``.  Returns the new
        state, or None when the trace terminated (loudly or at bound)."""
        rnd, budget, sites, chans, remote, bcast, reduces = state[:7]
        mem_budget = state[7] if len(state) > 7 else 0
        epoch_prev = remote[3] if len(remote) > 3 else 1
        quorum = scenario[0]
        trace = trace.extend(rnd, actions)
        mem_actions = [a for a in actions if a[0] in _MEMBERSHIP_ACTIONS]
        budget -= len(actions) - len(mem_actions)
        mem_budget -= len(mem_actions)

        site_outs, stale_flags = {}, {}
        new_sites, new_chans = list(sites), list(chans)
        for i in range(len(sites)):
            site, chan, out, loud = self._site_round(
                i, sites[i], chans[i], bcast, actions, scenario, trace,
                rnd, quorum,
            )
            new_sites[i], new_chans[i] = site, chan
            if loud:
                self.report["terminal_loud"] += 1
                return None
            if out is not None:
                site_outs[i] = out
                stale_flags[i] = not out[3]

        # reappear redeliveries (death fired one round earlier)
        for i, site in enumerate(new_sites):
            if not site[0] and site[1] == rnd and site[6] is not None:
                phase, keys, contrib, _, made = site[6][:5]
                echo_e = site[6][5] if len(site[6]) > 5 else None
                site_outs[i] = (phase, keys, contrib, False, made, echo_e)
                stale_flags[i] = True
                new_sites[i] = site[:1] + (0,) + site[2:]

        # a rejoin of a DEAD site races its old incarnation's redelivery
        # into the very round the re-admission is processed — the
        # worst-case interleaving the roster epoch exists to refuse
        for kind, i in mem_actions:
            if (kind == "rejoin" and not new_sites[i][0]
                    and new_sites[i][6] is not None and i not in site_outs):
                last = new_sites[i][6]
                phase, keys, contrib, _, made = last[:5]
                echo_e = last[5] if len(last) > 5 else None
                site_outs[i] = (phase, keys, contrib, False, made, echo_e)
                stale_flags[i] = True
        if _JOIN_CONTRIBUTES_IN_ADMISSION_ROUND:
            # broken-engine semantics (tests only): the joiner is invoked
            # in the round its admission is processed — one round early
            for kind, i in mem_actions:
                if kind in ("join", "rejoin") and i not in site_outs:
                    site_outs[i] = ("computation", frozenset({"reduce"}),
                                    rnd, True, rnd, None)
                    stale_flags[i] = False

        if not site_outs:
            self.report["terminal_loud"] += 1
            return None

        remote, new_bcast, loud, reduced = self._remote_round(
            (rnd, budget, tuple(new_sites), tuple(new_chans), remote,
             bcast, reduces),
            site_outs, stale_flags, scenario, trace,
        )
        if loud:
            self.report["terminal_loud"] += 1
            return None
        if new_bcast is None:
            # a violating fall-through already emitted; stop the trace
            return None
        out_phase, keys, update_tag, reduced, epoch_bcast = new_bcast
        if out_phase == "success":
            self.report["terminal_success"] += 1
            return None

        # ---- apply this round's roster transitions: the
        # aggregator admitted joiners at the top of its round (the epoch
        # bumps already ride the broadcast) and retires leavers AFTER the
        # reduce counted their flagged final contribution
        epoch_now = epoch_bcast
        dropped_set = set(remote[2])
        pos = 0
        for kind, i in mem_actions:
            if kind in ("join", "rejoin"):
                pos += 1
                s = new_sites[i]
                # a fresh incarnation: fresh cache, alive, first
                # contribution due next round; the old incarnation's
                # last output remains only as refusal fodder for late
                # duplicates, and its previous drop no longer applies
                new_sites[i] = (True, 0, 0, frozenset(), False, False,
                                s[6], epoch_prev + pos, rnd + 1)
                dropped_set.discard(i)
            elif kind == "leave" and i in site_outs and not stale_flags.get(
                i
            ):
                # the flagged final contribution was delivered fresh and
                # counted — retire the member (never a dropped site)
                s = new_sites[i]
                new_sites[i] = s[:7] + (None, 0)
                epoch_now += 1
        remote = (remote[0], remote[1], frozenset(dropped_set), epoch_now)

        # relay the broadcast files (the avg payload + its manifest)
        for i, site in enumerate(new_sites):
            if not site[0]:
                continue
            payload, manifest, repairs = new_chans[i]
            if reduced:
                # a fresh relay recopies EVERY file, so damage from earlier
                # rounds that nothing loaded in between heals naturally;
                # only faults fired THIS round leave stale components
                fresh = rnd
                repairs = {
                    a[2] for a in actions
                    if a[0] in ("drop_relay", "duplicate_delivery")
                    and a[1] == i
                }
                if "payload" not in repairs:
                    payload = fresh
                if "manifest" not in repairs:
                    manifest = fresh
                new_chans[i] = (payload, manifest, frozenset(repairs))
        return (
            rnd + 1, budget, tuple(new_sites), tuple(new_chans), remote,
            (out_phase, keys, update_tag, epoch_bcast),
            reduces + (1 if reduced else 0),
            mem_budget,
        )

    # ------------------------------------------------------------ exploration
    def explore(self):
        for quorum in self.config.quorums:
            for pretrain in self.config.pretrain:
                for k in self.config.staleness:
                    for d_ra in self.config.run_ahead:
                        for el in self.config.elastic:
                            if el and not (
                                ModelCheck.DEFAULT_ELASTIC
                                and self.ir.facts.membership_checked
                            ):
                                # the tree has no membership round step —
                                # there is no roster to churn
                                continue
                            self._explore_scenario(
                                (quorum, pretrain, int(k), int(d_ra),
                                 bool(el))
                            )
        findings = [f for f, _ in self.findings.values()]
        plans = [p for _, p in self.findings.values()]
        order = sorted(
            range(len(findings)),
            key=lambda ix: (findings[ix].path, findings[ix].line,
                            findings[ix].rule),
        )
        return [findings[ix] for ix in order], [plans[ix] for ix in order]

    def _explore_scenario(self, scenario):
        elastic = len(scenario) > 4 and bool(scenario[4])
        frontier = collections.deque(
            [(_initial_state(self.config, elastic), _Trace())]
        )
        visited = set()
        bound = self.config.engine_rounds
        while frontier:
            state, trace = frontier.popleft()
            if state in visited:
                continue
            visited.add(state)
            self.report["states"] += 1
            if self.report["states"] > MAX_STATES:
                self._emit(
                    ModelCheck.CONFIG, (self.ir.remote.path, 1),
                    f"state-space ceiling ({MAX_STATES}) exceeded — shrink "
                    "--model-sites/--model-rounds/--model-faults",
                    scenario, trace, "bounded exploration",
                )
                return
            rnd = state[0]
            if rnd > bound:
                self.report["runs"] += 1
                if state[6] == 0:
                    self._emit(
                        ModelCheck.DEADLOCK, self._remote_phase_anchor(),
                        f"the bounded run finishes {bound} engine rounds "
                        "with ZERO reduces and no loud failure — the "
                        "federation is silently wedged (a dispatch "
                        "transition is missing or a barrier never "
                        "releases)",
                        scenario, trace, "deadlock freedom",
                    )
                continue
            singles, mem_singles = self._round_actions(state, scenario)
            subsets = [()]
            # the whole remaining budget may be spent in ONE round: the
            # --model-faults contract is the simultaneous-fault tolerance
            # level verified, so no silent per-round cap
            for k in range(1, state[1] + 1):
                subsets.extend(itertools.combinations(singles, k))
            mem_subsets = [()]
            mem_budget = state[7] if len(state) > 7 else 0
            for k in range(1, mem_budget + 1):
                mem_subsets.extend(itertools.combinations(mem_singles, k))
            for fault_actions in subsets:
                for mem_actions in mem_subsets:
                    actions = fault_actions + mem_actions
                    nxt = self._step(state, actions, scenario, trace)
                    if nxt is not None:
                        frontier.append(
                            (nxt, trace.extend(state[0], actions))
                        )


# ------------------------------------------------------------- wire property
def _wire_findings(ir, explorer, config):
    """Every wire key produced on an explored path must be consumed (with
    the payload actually present) on some explored path of the peer."""
    findings, plans = [], []
    consumed = {(role, key) for role, key in explorer.report["consumed"]}
    peers = {"local": "remote", "remote": "local"}
    seen = set()
    for role, key, line in sorted(explorer.report["produced"]):
        if key in ("phase",) or (role, key) in seen:
            continue
        seen.add((role, key))
        if (peers[role], key) not in consumed:
            node = ir.local if role == "local" else ir.remote
            findings.append(Finding(
                rule=ModelCheck.WIRE, path=node.path, line=line, col=0,
                message=(
                    f"wire key '{key}' is produced on an explored path "
                    f"({role} side) but the peer never consumes it on ANY "
                    f"reachable execution of the bounded model "
                    f"({config.sites} sites x {config.rounds} rounds) — "
                    "the payload is computed and shipped into a round "
                    "that cannot see it"
                ),
            ))
            plans.append({
                "rule": ModelCheck.WIRE, "invariant": "wire reachability",
                "scenario": {"n_sites": config.sites,
                             "engine_rounds": config.engine_rounds},
                "faults": [],
            })
    return findings, plans


# --------------------------------------------------------------- entry point
def run_model_check(config=None, ir=None, plans_dir=None):
    """Explore the bounded model; returns a :class:`ModelResult` whose
    findings flow through the same baseline machinery as tiers 1–3."""
    config = config or ModelConfig()
    try:
        if ir is None:
            ir = build_protocol_ir()
    except (OSError, SyntaxError, ValueError) as exc:
        f = Finding(
            rule=ModelCheck.CONFIG, path="coinstac_dinunet_tpu_torch", line=1,
            col=0, message=f"protocol IR extraction failed: {exc}",
        )
        return ModelResult([f], [None], {})
    explorer = _Explorer(ir, config)
    findings, plans = explorer.explore()
    wf, wp = _wire_findings(ir, explorer, config)
    findings, plans = findings + wf, plans + wp
    order = sorted(
        range(len(findings)),
        key=lambda ix: (findings[ix].path, findings[ix].line,
                        findings[ix].rule),
    )
    findings = [findings[ix] for ix in order]
    plans = [plans[ix] for ix in order]
    if plans_dir:
        os.makedirs(plans_dir, exist_ok=True)
        for n, (f, plan) in enumerate(zip(findings, plans)):
            if not plan:
                continue
            name = f"{f.rule}-{n:02d}.json"
            with open(os.path.join(plans_dir, name), "w",
                      encoding="utf-8") as fh:
                json.dump(plan, fh, indent=2, sort_keys=True)
                fh.write("\n")
    report = dict(explorer.report)
    report["produced"] = sorted(report["produced"])
    report["consumed"] = sorted(report["consumed"])
    report["confirmed_cache"] = sorted(report["confirmed_cache"])
    report["exercised_reads"] = sorted(report["exercised_reads"])
    report["phases_covered"] = sorted(
        (r, p or "<unguarded>") for r, p in report["phases_covered"]
    )
    return ModelResult(findings, plans, report)

"""Federation engines (in-process simulator, fresh process per invocation,
the lifecycle of the planes that run every site in one step) + single-site
runner.

Port of the JAX package's ``engine.py``: :class:`InProcessEngine` runs N
site nodes and one aggregator in one process, relaying each node's output
JSON and transfer files the way an external COINSTAC engine would;
:class:`SubprocessEngine` runs every node invocation as its own ``python
<script>`` process, as the COINSTAC engine does; :class:`SiteRunner`
drives one site through a local pretrain with no aggregator.  Each takes a
``device`` (``cuda`` unless the caller asks for the CPU) and hands it to
every node and trainer (to a child process as ``--device``).

Every engine shares one round template (``step_round``): each node
invocation runs under the invoke retry policy (``invoke_retry_*`` keys,
off by default), and with ``profile`` (or ``telemetry``) on any argument
channel the engine writes its telemetry lane, ``telemetry.engine.jsonl``
in the workdir, as the JAX package does: an ``engine:round`` span, an
``invoke:<site>`` / ``invoke:remote`` span per invocation, an
``engine:relay`` span, an ``engine:heartbeat`` event per completed
invocation, ``invoke:retry`` and ``invoke:timeout`` events.  The nodes write
lanes of their own (``nodes/local.py``, ``nodes/remote.py``): a site's and
the aggregator's records — the aggregator's quorum, window, membership
and reduce decisions among them — land there.  A process-backed engine
seeds the aggregator's cache with the ``profile``/``telemetry`` flag of
its ``first_input``, so the aggregator's lane exists in a process of its
own too (the JAX package's process-backed aggregator learns the flag only
from the ``shared_args`` of the sites' node constructors).

Resilience, as in the JAX package:

- ``fault_plan`` (``resilience/chaos.py``) injects crashes, hangs, slow
  sites, payload damage, relay faults and replays at pinned rounds, with
  ``chaos:inject`` / ``chaos:heal`` events; a retry first heals the
  damage blocking the retried node's reads.
- A failed site invocation raises, unless ``site_quorum`` is configured
  on any channel: then the site is marked dead (``dead_sites``,
  ``site_failures``, a ``site_died`` event), never invoked again, and the
  aggregator judges the quorum.
- Staleness-bounded async rounds (``async_staleness`` = k,
  ``async_invoke_pool``, ``async_stale_discount`` on any channel): sites
  are invoked through a bounded thread pool, and in the COMPUTATION/TRAIN
  steady state a straggler's last contribution may stand in for it for up
  to k rounds (``async:stale``), weighed ``gamma**lag`` by the reducer.
  The in-process engine's pool holds one thread (its nodes share one
  process); the process-backed engines' pools are uncapped.
- Run-ahead pipelining (``run_ahead`` = d on any channel, process-backed
  engines): in the steady state the round's reduce and relay run on a
  reducer thread while every delivered site is re-submitted at once — with
  the newest broadcast it has not applied, else up to d rounds ahead of it
  with the one-shot update keys stripped — so site compute overlaps the
  wire (``pipeline:reduce_concurrent``, ``site_run_ahead``).  Barriers,
  membership rounds and non-steady rounds drain the pipeline
  (``pipeline:drain``) and run the lockstep tail.  The in-process engine
  clamps d to 0, as the JAX package does.

Elastic membership (``federation/membership.py``): ``add_site`` and
``remove_site``, and a plan's ``join``/``leave``/``rejoin`` operations.  A
join is admitted in the steady state through the aggregator's handshake:
the engine queues an admission request with a donor member's alignment
and asks that donor (one without an invocation in flight) to ship its
train state; the aggregator broadcasts the admission record with the
donor's weights, and the joiner is invoked from the next round on, its
first contribution in the round after its admission.  A graceful leaver
computes one flagged last contribution and is never invoked again.  A
rejoin re-admits a dead or left site with a fresh cache.

Directory layout per site ``i`` under ``workdir`` (as in the JAX package)::

    site_<i>/            baseDirectory   (site's private data + inbox)
    site_<i>/out         outputDirectory
    remote_base/site_<i> site's transferDirectory == aggregator's inbox
    remote_xfer          aggregator's transferDirectory (broadcast outbox)

:class:`MeshEngine` is the host lifecycle of the planes that run every
site in one step (folds, lockstep epochs, validation, checkpoints, the
fold test, the score CSV, the results zip, resume); its one plane in the
port is the site-vectorized federation, whose engine
(``federation/engine.py``) also carries elastic membership on its roster
mask.  The daemon engine (warm workers) is ``federation/daemon.py``.

``MeshEngine``'s own plane is ``MeshFederation`` (``parallel/mesh.py``):
the sites as ranks of a rank mesh over ``devices`` (``devices_per_site``
ranks a site), or with ``sequence_parallel``/``tensor_parallel`` its
sequence- and tensor-parallel variants (``parallel/seq_mesh.py``,
``parallel/tp_mesh.py``).
"""
import datetime
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import threading
import time
from collections import deque
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor
from concurrent.futures import wait as futures_wait

import numpy as np

from . import config, telemetry, utils
from .config.keys import (
    Federation,
    Key,
    Live,
    LocalWire,
    Membership,
    Metric,
    Mode,
    Phase,
    RemoteWire,
)
from .data import COINNDataHandle
from .nodes import COINNLocal, COINNRemote
from .resilience import transport as wire_transport
from .resilience.chaos import ChaosSession
from .resilience.retry import RetryExhausted, RetryPolicy
from .telemetry import capture as _capture
from .trainer import COINNTrainer
from .utils import clean_recursive, logger
from .utils.utils import performance_improved_, stop_training_

#: test switch: drain the run-ahead pipeline inside every round, right after
#: its reduce is submitted, so every re-submission sees the newest
#: broadcast — the schedule of d = 0.  A run with it set must equal the
#: d = 0 run bit for bit: the drain path is the lockstep path
_PIPELINE_FORCE_DRAIN = False

#: broadcast keys a run-ahead re-submission strips: one-shot round state
#: (the update, barrier and broadcast side effects) the site consumed when
#: it first received this broadcast — delivering them again would apply the
#: update twice.  Everything else (phase, modes, the wire_round stamp the
#: lag rides on) is carried
_RUN_AHEAD_STRIP = (
    RemoteWire.UPDATE.value,
    RemoteWire.AVG_GRADS_FILE.value,
    RemoteWire.SAVE_CURRENT_AS_BEST.value,
    RemoteWire.PRETRAINED_WEIGHTS.value,
    RemoteWire.HEALTH.value,
    RemoteWire.ADMISSIONS.value,
)

#: broadcast keys that make a round ineligible for run-ahead: the multi-
#: invocation protocols (PowerSGD's P/Q phases, rankDAD's payloads) and the
#: run's transitions count each broadcast exactly once — the engine waits
#: on the reducer thread instead
_RUN_AHEAD_BLOCKERS = (
    RemoteWire.POWERSGD_PHASE.value,
    RemoteWire.POWERSGD_P_FILE.value,
    RemoteWire.POWERSGD_Q_FILE.value,
    RemoteWire.RANK1_FILE.value,
    RemoteWire.DAD_DATA_FILE.value,
    RemoteWire.DAD_REST_FILE.value,
    RemoteWire.GLOBAL_RUNS.value,
    RemoteWire.RESULTS_ZIP.value,
)


class InvokeTimeout(RuntimeError):
    """A fresh-process node invocation exceeded the engine's ``timeout``;
    the message carries the partial stderr the process wrote before it was
    killed."""


def _engine_recorder(eng, chans):
    """The engine lane's recorder (``telemetry.engine.jsonl`` in the
    workdir): on when any argument channel carries ``profile`` or
    ``telemetry``, nested ``*_args`` tiers included (a fresh-process
    engine learns the flag from ``first_input``).  Re-checked until on,
    then kept on the engine."""
    rec = getattr(eng, "_telemetry_rec", None)
    if rec is not None:
        return rec

    def on(d):
        if not isinstance(d, dict):
            return False
        if d.get("profile") or d.get("telemetry"):
            return True
        return any(
            isinstance(v, dict) and (v.get("profile") or v.get("telemetry"))
            for k, v in d.items() if str(k).endswith("_args")
        )

    if any(on(c) for c in chans):
        eng._telemetry_rec = telemetry.Recorder("engine", out_dir=eng.workdir)
        return eng._telemetry_rec
    return telemetry.NULL_RECORDER


def load_inputspec(path, site_index=None):
    """Parse a COINSTAC simulator ``inputspec.json`` into plain args: a list
    of per-site ``{key: {"value": ...}}`` dicts (or one shared dict)."""
    if os.path.isdir(path):
        path = os.path.join(path, "inputspec.json")
    with open(path) as f:
        spec = json.load(f)
    if isinstance(spec, dict):
        spec = [spec]

    def unwrap(site_spec):
        return {
            k: (v["value"] if isinstance(v, dict) and "value" in v else v)
            for k, v in site_spec.items()
        }

    sites = [unwrap(s) for s in spec]
    if site_index is None:
        return sites
    site_index = int(site_index)
    if not 0 <= site_index < len(sites):
        raise IndexError(
            f"site_index {site_index} out of range for {len(sites)}-site inputspec"
        )
    return sites[site_index]


class InProcessEngine:
    """Runs N site nodes + one aggregator, relaying outputs and files.

    ``inputspec`` seeds per-site args like the COINSTAC simulator; explicit
    ``**args`` / ``site_args`` win over it.  ``fault_plan`` (a plan dict or
    a JSON path, ``resilience/chaos.py``) injects its faults, its
    join/leave/rejoin operations among them."""

    #: the async invocation pool's ceiling: one thread in-process (the
    #: nodes share this process and its ambient recorder stack); the
    #: process-backed engines lift it
    _ASYNC_POOL_CAP = 1

    #: the run-ahead depth's ceiling: 0 in process (the aggregator node
    #: activates the process-wide ambient recorder, so the reduce cannot
    #: leave the engine thread); the process-backed engines lift it
    _RUN_AHEAD_CAP = 0

    #: the collect phase waits up to this multiple of the federation's
    #: typical invocation time (the median over sites of each site's best
    #: recent one) for in-flight invocations before a straggler's last
    #: contribution stands in for it
    _ASYNC_GRACE_FACTOR = 2.0

    def __init__(self, workdir, n_sites, trainer_cls=COINNTrainer,
                 dataset_cls=None, datahandle_cls=COINNDataHandle,
                 remote_trainer_cls=None, learner_cls=None, reducer_cls=None,
                 site_args=None, inputspec=None, fault_plan=None, device=None, **args):
        self.device = config.resolve_device(device)
        # None → the no-op session: the fault-free path costs one attribute
        # lookup per hook
        self.chaos = ChaosSession.from_spec(fault_plan)
        self.site_spec = {}
        if inputspec is not None:
            per_site = load_inputspec(inputspec)
            if len(per_site) != 1 and len(per_site) != int(n_sites):
                raise ValueError(
                    f"inputspec has {len(per_site)} per-site entries but the "
                    f"engine was built with n_sites={n_sites}; only a "
                    "single-entry spec broadcasts to every site"
                )
            for i in range(int(n_sites)):
                self.site_spec[f"site_{i}"] = per_site[min(i, len(per_site) - 1)]
        self.workdir = str(workdir)
        self.n_sites = int(n_sites)
        self.trainer_cls = trainer_cls
        self.remote_trainer_cls = remote_trainer_cls or trainer_cls
        self.dataset_cls = dataset_cls
        self.datahandle_cls = datahandle_cls
        self.learner_cls = learner_cls
        self.reducer_cls = reducer_cls
        self.args = args
        self.site_args = site_args or {}

        self.site_ids = [f"site_{i}" for i in range(self.n_sites)]
        self.site_caches = {s: {} for s in self.site_ids}
        self.remote_cache = {}
        self.site_states = {}
        for s in self.site_ids:
            base = os.path.join(self.workdir, s)
            xfer = os.path.join(self.workdir, "remote_base", s)
            outd = os.path.join(base, "out")
            for d in (base, xfer, outd):
                os.makedirs(d, exist_ok=True)
            self.site_states[s] = {
                "baseDirectory": base,
                "outputDirectory": outd,
                "transferDirectory": xfer,
                "clientId": s,
            }
        self.remote_state = {
            "baseDirectory": os.path.join(self.workdir, "remote_base"),
            "transferDirectory": os.path.join(self.workdir, "remote_xfer"),
            "outputDirectory": os.path.join(self.workdir, "remote_out"),
        }
        for d in self.remote_state.values():
            os.makedirs(d, exist_ok=True)

        self.site_inputs = {s: {} for s in self.site_ids}
        self.rounds = 0
        self.success = False
        self.last_remote_out = {}
        self.dead_sites = set()
        self.site_failures = {}
        # elastic membership: sites retired gracefully (never invoked again,
        # no site_died), joins queued by add_site and not yet requested,
        # joins whose admission request is on the wire, leaves queued by
        # remove_site (the site's next input carries ``leave``), the donor
        # asked to ship its train state, and plan operations deferred
        # behind a transition of the same site in flight
        self.left_sites = set()
        self._pending_join = {}  # site -> "join" | "rejoin"
        self._awaiting_admission = {}  # site -> "join" | "rejoin"
        self._pending_leave = set()
        self._sync_donors = set()
        self._deferred_ops = []
        # each site's last delivered output: the chaos replay faults and the
        # async stand-ins re-deliver it
        self._last_site_outs = {}
        # the aggregator judges every round against the FULL founding
        # roster, so a death in the first round counts against n_sites
        self.remote_cache["all_sites"] = list(self.site_ids)
        # async round state, built at the first async round: the pool, each
        # site's pending invocation (submit round, future, policy), the
        # submit round of its last fresh delivery, its frozen payload
        # aliases, and each site's recent invocation times (the first, cold
        # one skipped), which pool threads append to under the lock
        self._async_cfg = None
        self._async_pool = None
        self._async_pending = {}
        self._async_last_sub = {}
        self._async_snapshots = {}
        self._async_invoke_hist = {}
        self._async_warm = set()
        self._async_hist_lock = threading.Lock()
        # run-ahead state, built at the first pipelined round: the reducer
        # thread and its reduces in flight (FIFO: round, future), the
        # broadcast stamp each site last consumed in full, each site's
        # run-ahead depth, the generation-tagged payload aliases, and the
        # sites delivered fresh this round (the re-submission roster)
        self._reduce_pool = None
        self._reduce_pending = []
        self._async_consumed = {}
        self._run_ahead_depth = {}
        self._async_snap_gen = {}
        self._async_snap_files = {}
        self._async_fresh = set()

    def site_data_dir(self, site_id, data_dir="data"):
        d = os.path.join(self.site_states[site_id]["baseDirectory"], data_dir)
        os.makedirs(d, exist_ok=True)
        return d

    # ---------------------------------------------------- elastic membership
    def add_site(self, site_id=None, site_args=None, first_input=None):
        """Queue a mid-run join (or the rejoin of a dead or left site).
        The site is provisioned now (directories, a fresh cache) and
        becomes invocable once the aggregator's admission record comes back
        on the broadcast (``admissions``); it contributes from the round
        after its admission, exactly once.  Returns the site id."""
        if site_id is None:
            ix = len(self.site_ids)
            while f"site_{ix}" in self.site_states:
                ix += 1
            site_id = f"site_{ix}"
        site_id = str(site_id)
        if (site_id in self._alive_site_ids() or site_id in self._pending_join
                or site_id in self._awaiting_admission):
            raise ValueError(f"{site_id} is already a member (or joining)")
        rejoin = site_id in self.dead_sites or site_id in self.left_sites
        base = os.path.join(self.workdir, site_id)
        xfer = os.path.join(self.workdir, "remote_base", site_id)
        outd = os.path.join(base, "out")
        for d in (base, xfer, outd):
            os.makedirs(d, exist_ok=True)
        self.site_states[site_id] = {
            "baseDirectory": base, "outputDirectory": outd,
            "transferDirectory": xfer, "clientId": site_id,
        }
        # a fresh incarnation: nothing of a previous life survives
        self.site_caches[site_id] = {}
        self.site_inputs.setdefault(site_id, {})
        if site_args:
            self.site_args[site_id] = dict(site_args)
        fi = getattr(self, "first_input", None)
        if fi is not None:
            if first_input is not None:
                fi[site_id] = dict(first_input)
            elif site_id not in fi and fi:
                # the process-backed engines resolve a node's arguments from
                # its first input: a joiner inherits the consortium's
                fi[site_id] = dict(next(iter(fi.values())))
            self._first_done.discard(site_id)
        self._pending_join[site_id] = "rejoin" if rejoin else "join"
        return site_id

    def remove_site(self, site_id, graceful=True):
        """Remove a member mid-run.  ``graceful`` (the default) puts
        ``leave`` in the site's next input: it computes one flagged last
        contribution, the reduce counts it, the aggregator retires it, and
        the engine never invokes it again — no ``site_died``, no retry.
        ``graceful=False`` drops it at once, as a death."""
        site_id = str(site_id)
        if site_id not in self._alive_site_ids():
            raise ValueError(f"{site_id} is not an alive member")
        if graceful:
            self._pending_leave.add(site_id)
            return
        self.dead_sites.add(site_id)
        self.site_failures[site_id] = "removed by operator"
        self._recorder().event("site_died", cat="quorum", site=site_id,
                               error="removed by operator", attempts=0,
                               retries_exhausted=False)

    def _membership_busy(self):
        """A join or leave is under way: the round is a barrier (no
        run-ahead re-submission at its tail)."""
        return bool(self._pending_join or self._awaiting_admission or self._pending_leave)

    def _membership_steady(self):
        """The steady state a join is admitted into: the last broadcast is a
        COMPUTATION round and every broadcast mode is TRAIN, so the joiner
        enters mid-epoch in lockstep."""
        out = self.last_remote_out or {}
        if out.get(RemoteWire.PHASE.value) != Phase.COMPUTATION.value:
            return False
        modes = set((out.get(RemoteWire.GLOBAL_MODES.value) or {}).values())
        return not modes or modes == {Mode.TRAIN.value}

    def _apply_membership_op(self, kind, site):
        """One plan operation against the live roster: True when applied
        (or already satisfied), False when it must wait for a transition of
        the same site in flight.  Raises ValueError for a plan fault."""
        in_flight_join = site in self._pending_join or site in self._awaiting_admission
        if kind == "leave":
            # the in-flight check first: a rejoining site is still in
            # left_sites until its admission lands
            if in_flight_join:
                return False
            if site in self.left_sites or site in self._pending_leave:
                return True
            self.remove_site(site, graceful=True)
            return True
        if in_flight_join:
            return True
        if site in self._pending_leave:
            return False
        if site in self._alive_site_ids():
            return True
        self.add_site(site)
        return True

    def _membership_round(self, rnd, rec):
        """The churn hook at the top of every round: apply the plan's
        join/leave/rejoin operations due now (and the deferred ones),
        activate joiners whose admission the last broadcast carries, and in
        the steady state queue the pending admission requests with a donor
        member's alignment.  Any membership activity first drains the
        run-ahead pipeline: a membership round is a barrier.  The donor is
        a member without an invocation in flight, so that its next
        invocation — the one asked to ship its train state — consumes the
        newest broadcast; with none idle the request waits a round."""
        ops = self._deferred_ops + list(self.chaos.membership_ops(rnd, rec))
        self._deferred_ops = []
        if (ops or self._membership_busy()) and self._reduce_pending:
            self._pipeline_drain(rec, reason="membership")
        for kind, site in ops:
            try:
                if not self._apply_membership_op(kind, site):
                    self._deferred_ops.append((kind, site))
            except ValueError as exc:
                logger.warn(f"churn plan op {kind}@{site} skipped: {exc}")
        admissions = (self.last_remote_out or {}).get(RemoteWire.ADMISSIONS.value) or {}
        for s in sorted(set(self._awaiting_admission) & set(admissions)):
            self._activate_joiner(s, rec)
        if self._pending_join and self._membership_steady():
            donor = next((s for s in self._alive_site_ids() if s not in self._async_pending),
                         None)
            if donor is not None:
                reqs = self.remote_cache.setdefault(Membership.REQUESTS, [])
                for s in sorted(self._pending_join):
                    sync = {k: self.site_caches.get(donor, {}).get(k)
                            for k in ("cursor", "epoch", "mode")}
                    reqs.append({"op": self._pending_join[s], "site": s,
                                 "sync": {k: v for k, v in sync.items() if v is not None}})
                    self._awaiting_admission[s] = self._pending_join[s]
                self._pending_join = {}
                # the donor's invocation this round ships the train state
                # the admission broadcast relays to the joiner
                self._sync_donors.add(donor)

    def _activate_joiner(self, s, rec):
        """The admission record of ``s`` arrived: the site becomes a live
        member.  The admission broadcast's files were relayed before it was
        invocable, so the aggregator's outbox is copied into its inbox here,
        and its input is that broadcast — its first invocation enters at
        the steady COMPUTATION phase (``nodes/local.py`` ``_join_run``).
        The aggregator wrote the one ``membership:*`` event already."""
        op = self._awaiting_admission.pop(s, "join")
        rejoin = op == "rejoin" or s in self.dead_sites or s in self.left_sites
        self.dead_sites.discard(s)
        self.left_sites.discard(s)
        self.site_failures.pop(s, None)
        if s not in self.site_ids:
            self.site_ids.append(s)
        # a fresh incarnation: no replay record, staleness history,
        # run-ahead depth or payload alias survives
        for table in (self._last_site_outs, self._async_last_sub, self._async_consumed,
                      self._run_ahead_depth, self._async_snapshots, self._async_snap_gen,
                      self._async_snap_files):
            table.pop(s, None)
        with self._async_hist_lock:
            self._async_invoke_hist.pop(s, None)
            self._async_warm.discard(s)
        self._relay_to_site(s)
        self.site_inputs[s] = dict(self.last_remote_out)
        self._sync_admission(s)
        logger.warn(f"membership: {s} {'re-joined' if rejoin else 'joined'} the federation "
                    f"({len(self._alive_site_ids())} alive members)")

    def _sync_admission(self, s):
        """Re-stamp the joiner's admission with a member's CURRENT alignment
        (cursor, epoch, mode): the request-time one is a round old by the
        joiner's first invocation, and a one-batch skew would dephase its
        epoch barrier for good."""
        admissions = dict(self.site_inputs[s].get(RemoteWire.ADMISSIONS.value) or {})
        adm = dict(admissions.get(s) or {})
        donor = next((x for x in self._alive_site_ids() if x != s), None)
        if not adm or donor is None:
            return
        dc = self.site_caches.get(donor) or {}
        for k in ("cursor", "epoch", "mode"):
            if dc.get(k) is not None:
                adm[k] = dc[k]
        admissions[s] = adm
        self.site_inputs[s][RemoteWire.ADMISSIONS.value] = admissions

    def _relay_to_site(self, s):
        """The catch-up relay of a joiner: the aggregator's whole outbox,
        the manifest last (as :meth:`_relay_broadcast`)."""
        xfer = self.remote_state["transferDirectory"]
        for f in sorted(os.listdir(xfer), key=lambda f: (f == wire_transport.MANIFEST_NAME, f)):
            wire_transport.atomic_copy(
                os.path.join(xfer, f), os.path.join(self.site_states[s]["baseDirectory"], f))

    def _membership_input(self, s, inp):
        """The engine's membership keys in one site's input: the one-shot
        ``membership_sync`` of a donor, and ``leave`` until the leaver's
        flagged contribution is delivered."""
        extra = {}
        if s in self._sync_donors:
            self._sync_donors.discard(s)
            extra["membership_sync"] = True
        if s in self._pending_leave:
            extra["leave"] = True
        return {**inp, **extra} if extra else inp

    def _finalize_leavers(self, site_outs, rec):
        """Every site whose delivered output carried ``leaving`` leaves the
        invocable roster (the aggregator retired it this round, after the
        reduce counted its last contribution)."""
        for s in sorted(self._pending_leave):
            out = site_outs.get(s)
            if out is not None and out.get(LocalWire.LEAVING.value):
                self._pending_leave.discard(s)
                self.left_sites.add(s)
                self.site_inputs.pop(s, None)
                logger.warn(f"membership: {s} left gracefully "
                            f"({len(self._alive_site_ids())} alive members remain)")

    # ------------------------------------------------------------- telemetry
    def _recorder(self):
        """The engine's telemetry lane (see :func:`_engine_recorder`)."""
        chans = [self.args, *self.site_args.values(), *self.site_spec.values(),
                 *self.site_caches.values()]
        chans += list(getattr(self, "first_input", {}).values() or [])
        return _engine_recorder(self, chans)

    # ---------------------------------------------------------- site dropout
    def _alive_site_ids(self):
        return [s for s in self.site_ids
                if s not in self.dead_sites and s not in self.left_sites]

    def _quorum_configured(self):
        """True when ``site_quorum`` is set on any of the engine's channels
        (engine ``**args``, a node cache that resolved it, a fresh-process
        engine's ``first_input``), at the top level or in a ``*_args``
        tier."""

        def has_quorum(d):
            if not isinstance(d, dict):
                return False
            if d.get("site_quorum"):
                return True
            return any(
                isinstance(v, dict) and v.get("site_quorum")
                for k, v in d.items() if str(k).endswith("_args")
            )

        if has_quorum(self.args):
            return True
        if any(has_quorum(c) for c in self.site_caches.values()):
            return True
        fi = getattr(self, "first_input", None)
        return bool(fi) and any(has_quorum(v) for v in fi.values())

    def _site_failure(self, s, exc, attempts=1):
        """Site ``s``'s invocation failed after ``attempts`` tries.  Without
        ``site_quorum`` the failure propagates (all-site lockstep); with it
        the site is marked dead and left out of every later round — the
        aggregator enforces the quorum itself.  The ``site_died`` event
        says whether the retry budget ran out."""
        if not self._quorum_configured():
            raise exc
        self.dead_sites.add(s)
        self.site_failures[s] = f"{type(exc).__name__}: {exc}"
        self._recorder().event(
            "site_died", cat="quorum", site=s, error=self.site_failures[s],
            attempts=int(getattr(exc, "attempts", attempts)),
            retries_exhausted=isinstance(exc, RetryExhausted),
        )
        logger.warn(
            f"site {s} died mid-run ({self.site_failures[s]}) after {attempts} "
            "invocation attempt(s); excluded from the remaining rounds (site_quorum set)"
        )

    # ---------------------------------------------------------- invoke retry
    def _target_config(self, target):
        """The merged configuration of ONE target over its own argument
        channels, so a knob scoped to one site never applies to another:
        ``site_args`` > engine ``**args`` > ``site_spec`` > the node's JSON
        cache > ``first_input`` for a site; every channel for the
        aggregator (its configuration reaches it through a site's first
        input).  Nested ``*_args`` tiers count.  The invoke retry policy,
        the async configuration and the daemon's worker restart policy
        read it."""
        if target == "remote":
            chans = [self.args, self.remote_cache,
                     *self.site_args.values(), *self.site_spec.values(),
                     *self.site_caches.values()]
            chans += list(getattr(self, "first_input", {}).values() or [])
        else:
            fi = getattr(self, "first_input", {}) or {}
            chans = [self.site_args.get(target, {}), self.args,
                     self.site_spec.get(target, {}),
                     self.site_caches.get(target, {}), fi.get(target, {})]
        cfg = {}
        for chan in chans:
            if not isinstance(chan, dict):
                continue
            for k, v in chan.items():
                if isinstance(v, dict) and str(k).endswith("_args"):
                    for k2, v2 in v.items():
                        cfg.setdefault(k2, v2)
                else:
                    cfg.setdefault(k, v)
        return cfg

    def _invoke_policy(self, target):
        """The invocation retry policy of ONE target (default: 1 attempt,
        retry off)."""
        return RetryPolicy.for_invoke(self._target_config(target))

    def _invoke_with_retry(self, policy, attempt_fn, target, rec):
        """One node invocation under the retry policy: every retry first
        heals the chaos damage blocking THIS target's reads, then lands an
        ``invoke:retry`` event on the engine lane."""

        def on_retry(exc, attempt, delay):
            healed = self.chaos.heal_for_retry(rec, target=target)
            rec.event(
                "invoke:retry", cat="invoke", target=str(target),
                attempt=attempt, delay=round(delay, 4), healed=healed,
                error=f"{type(exc).__name__}: {exc}"[:300],
            )

        return policy.run(
            attempt_fn, retryable=(Exception,),
            describe=f"invoke {target}", on_retry=on_retry,
        )

    # ----------------------------------------------------- chaos replay faults
    def _stale_replay(self, rnd, s, rec):
        """A matching ``stale`` fault replays the site's previous output in
        place of a fresh invocation (its payload files are the untouched
        previous round's).  Returns the replayed output, or None."""
        if not self.chaos.enabled:
            return None
        prev = self._last_site_outs.get(s)
        if prev is None:
            return None
        if self.chaos.stale_fault(rnd, s, rec) is None:
            return None
        return dict(prev)

    def _finish_site_outputs(self, rnd, site_outs, rec, record=True):
        """The round barrier after the site loop: record every delivered
        output for later replays FIRST, then deliver the last output of
        each site whose ``reappear`` fault killed it one round earlier (the
        aggregator's quorum filter must refuse it).  ``record=False``: the
        pipelined reduce on the reducer thread, whose outputs the engine
        thread recorded at delivery (a late write could regress the
        record below a newer delivery)."""
        if record:
            self._last_site_outs.update({s: dict(o) for s, o in site_outs.items()})
        if not self.chaos.enabled:
            return
        for s in self.chaos.reappear_deliveries(rnd, rec):
            prev = self._last_site_outs.get(s)
            if prev is not None:
                site_outs[s] = dict(prev)

    # ------------------------------------------------------------- one round
    def _relay_broadcast(self, rnd, rec):
        """Copy the aggregator's transfer files into every surviving site's
        inbox — atomically, in sorted order, with the wire manifest LAST so
        it never describes a payload not yet delivered — applying the chaos
        relay faults (drop, duplicate) per destination."""
        xfer = self.remote_state["transferDirectory"]
        names = sorted(
            os.listdir(xfer), key=lambda f: (f == wire_transport.MANIFEST_NAME, f)
        )
        for f in names:
            src = os.path.join(xfer, f)
            for s in self._alive_site_ids():
                dst = os.path.join(self.site_states[s]["baseDirectory"], f)
                fault = self.chaos.relay_fault(rnd, f, s, rec)
                if fault is not None and fault.kind == "drop_relay":
                    # never arrives this round; a heal performs the copy
                    self.chaos.register_dropped_relay(src, dst, fault, reader=s)
                    continue
                if fault is not None and fault.kind == "duplicate_delivery":
                    self.chaos.deliver_duplicate(src, dst, fault, s, rec)
                    continue
                wire_transport.atomic_copy(src, dst)

    # What differs between engines is only how one node invocation attempt
    # runs: these three hooks.
    def _site_input(self, s):
        """The input of this round's invocation of site ``s`` (computed once
        a round, before the retry loop, so every attempt sees the same),
        with the engine's membership keys."""
        return self._membership_input(s, self.site_inputs[s])

    def _site_attempt(self, rnd, s, inp, rec):
        """One invocation attempt of site ``s``; returns its output.  The
        chaos invoke fault fires inside the span (a slow fault's sleep is
        the site's simulated compute); the round is pinned on the span,
        since a pool thread's invocation may outlive its round."""
        node = COINNLocal(
            cache=self.site_caches[s], input=inp, state=self.site_states[s],
            device=self.device,
            **{**self.site_spec.get(s, {}), **self.args, **self.site_args.get(s, {})},
        )
        with rec.span(f"invoke:{s}", cat="invoke", round=rnd):
            self.chaos.invoke_fault(rnd, s, rec)
            return node(
                trainer_cls=self.trainer_cls,
                dataset_cls=self.dataset_cls,
                datahandle_cls=self.datahandle_cls,
                learner_cls=self.learner_cls,
            )["output"]

    def _remote_attempt(self, rnd, site_outs, rec):
        """One invocation attempt of the aggregator; returns its output and
        records ``success``."""
        self.chaos.invoke_fault(rnd, "remote", rec)
        remote = COINNRemote(
            cache=self.remote_cache, input=site_outs, state=self.remote_state,
            device=self.device,
        )
        with rec.span("invoke:remote", cat="invoke", round=rnd):
            result = remote(trainer_cls=self.remote_trainer_cls,
                            reducer_cls=self.reducer_cls)
        self.success = bool(result.get("success"))
        return result["output"]

    def _remote_and_relay(self, rnd, site_outs, rec, record_outs=True):
        """The round's wire half, shared by the lockstep, async and
        pipelined rounds: the replay barrier, the aggregator's invocation
        under its retry policy, and the relay.  Returns the aggregator's
        output.  The run-ahead pipeline runs it on the reducer thread
        (``record_outs=False``, see :meth:`_finish_site_outputs`)."""
        self._finish_site_outputs(rnd, site_outs, rec, record=record_outs)
        if not site_outs:
            raise RuntimeError(
                f"every site died; nothing to aggregate — failures: {self.site_failures}"
            )
        remote_out = self._invoke_with_retry(
            self._invoke_policy("remote"),
            lambda: self._remote_attempt(rnd, site_outs, rec), "remote", rec,
        )
        rec.event(Live.HEARTBEAT, cat="engine", site="remote")
        self.last_remote_out = remote_out
        with rec.span("engine:relay", cat="relay", round=rnd):
            self._relay_broadcast(rnd, rec)
        return remote_out

    def step_round(self):
        """One full round: every site computes, the aggregator computes on
        the sites' outputs and files, its output and files relay back.
        Returns ``(site outputs, aggregator output)``.  With an async key
        on any channel the round runs :meth:`_step_round_async`."""
        ac = self._async_config()
        if ac["enabled"]:
            return self._step_round_async(ac)
        rec = self._recorder()
        rnd = self.rounds + 1
        rec.set_context(round=rnd)
        self._membership_round(rnd, rec)
        site_outs = {}
        with self.chaos.activate(rec), rec.span("engine:round", cat="engine"):
            for s in self._alive_site_ids():
                replay = self._stale_replay(rnd, s, rec)
                if replay is not None:
                    site_outs[s] = replay
                    continue
                policy = self._invoke_policy(s)
                inp = self._site_input(s)
                try:
                    site_outs[s] = self._invoke_with_retry(
                        policy, lambda s=s, inp=inp: self._site_attempt(rnd, s, inp, rec),
                        s, rec,
                    )
                except Exception as exc:  # noqa: BLE001 — see _site_failure
                    self._site_failure(s, exc, attempts=policy.last_attempts)
                    continue
                rec.event(Live.HEARTBEAT, cat="engine", site=s)
                # payload damage after the site committed its outbound files
                self.chaos.payload_faults(rnd, s, self.site_states[s]["transferDirectory"], rec)
            remote_out = self._remote_and_relay(rnd, site_outs, rec)
            self._finalize_leavers(site_outs, rec)
        rec.flush()
        self.site_inputs = {s: dict(remote_out) for s in self._alive_site_ids()}
        self.rounds += 1
        return site_outs, remote_out

    # ------------------------------------------------------------ async rounds
    # Staleness-bounded async rounds: every idle site is invoked through a
    # bounded pool, and in the COMPUTATION/TRAIN steady state a site still
    # computing when the round's reduce is due may be represented by its
    # last completed contribution for up to k rounds — so one slow site no
    # longer gates the federation, and the reduce + relay of round r
    # overlap the straggler computing its next contribution.  The
    # aggregator accepts the lagging ``wire_round`` echo inside the window
    # and the reducer down-weights it.  INIT, fold transitions and the
    # validation/test barriers stay lockstep: the engine blocks on the
    # straggler there.

    def _async_config(self):
        """The async configuration, resolved once over the aggregator's
        channels: on when any of ``async_staleness``, ``async_invoke_pool``
        or ``run_ahead`` is set anywhere.  ``k=0`` with pool 1 runs the
        async path in strict serial order.  A run-ahead depth above this
        engine's ceiling (``_RUN_AHEAD_CAP``, 0 in process) is clamped, and
        the clamped depth is written into every argument channel the nodes
        read, so that the aggregator's ``k + d`` window is the horizon this
        engine keeps.  Without a pool size the pool follows the live
        roster."""
        if self._async_cfg is not None:
            return self._async_cfg
        cfg = self._target_config("remote")
        k_raw = cfg.get(Federation.ASYNC_STALENESS)
        pool_raw = cfg.get(Federation.ASYNC_POOL)
        ra_raw = cfg.get(Federation.RUN_AHEAD)
        enabled = k_raw is not None or pool_raw is not None or ra_raw is not None
        d = max(int(ra_raw or 0), 0)
        if self._RUN_AHEAD_CAP is not None and d > self._RUN_AHEAD_CAP:
            d = self._RUN_AHEAD_CAP
            for chan in (self.args, *self.site_args.values(), *self.site_spec.values()):
                if not isinstance(chan, dict):
                    continue
                if Federation.RUN_AHEAD in chan:
                    chan[Federation.RUN_AHEAD] = d
                for kk, vv in chan.items():
                    if (isinstance(vv, dict) and str(kk).endswith("_args")
                            and Federation.RUN_AHEAD in vv):
                        vv[Federation.RUN_AHEAD] = d
            logger.warn(
                f"run_ahead={int(ra_raw or 0)} clamped to {d} on this engine (the "
                "in-process aggregator shares the ambient recorder; run-ahead needs a "
                "process-backed engine) — the clamped depth is what shared_args freeze"
            )
        if pool_raw is not None:
            pool = max(int(pool_raw), 1)
        else:
            pool = self.n_sites if enabled else 1
        if self._ASYNC_POOL_CAP is not None:
            pool = min(pool, self._ASYNC_POOL_CAP)
        self._async_cfg = {"enabled": bool(enabled), "k": max(int(k_raw or 0), 0),
                           "pool": pool, "run_ahead": d, "pool_auto": pool_raw is None}
        return self._async_cfg

    def _async_pool_size(self, ac):
        """This round's pool ceiling: the configured size, or without one
        the live member count (a join grows the pool)."""
        if not ac.get("pool_auto"):
            return ac["pool"]
        size = max(len(self._alive_site_ids()), 1)
        if self._ASYNC_POOL_CAP is not None:
            size = min(size, self._ASYNC_POOL_CAP)
        return size

    def _ensure_async_pool(self, size):
        if self._async_pool is None:
            self._async_pool = ThreadPoolExecutor(max_workers=int(size),
                                                  thread_name_prefix="coinn-async")
        elif int(size) > self._async_pool._max_workers:
            # a join grows the pool: the executor starts threads lazily up
            # to its ceiling, so raising the ceiling suffices
            self._async_pool._max_workers = int(size)
        return self._async_pool

    def _ensure_reduce_pool(self):
        """The reducer thread: one worker that runs the pipelined rounds'
        reduce-and-relay tails in submission order while the engine thread
        collects and re-submits sites.  On the daemon engine it only
        drives the aggregator worker's pipe."""
        if self._reduce_pool is None:
            self._reduce_pool = ThreadPoolExecutor(max_workers=1,
                                                   thread_name_prefix="coinn-reducer")
        return self._reduce_pool

    def _async_attempt(self, policy, rnd, s, inp, rec):
        """One site invocation under its retry policy — the pool task.  Its
        wall time feeds the site's recent-invocation window the grace is
        derived from (the first, cold invocation of each site skipped)."""
        t0 = time.monotonic()
        out = self._invoke_with_retry(
            policy, lambda: self._site_attempt(rnd, s, inp, rec), s, rec
        )
        dur = time.monotonic() - t0
        with self._async_hist_lock:
            if s in self._async_warm:
                self._async_invoke_hist.setdefault(s, deque(maxlen=8)).append(dur)
            else:
                self._async_warm.add(s)
        return out

    def _async_grace(self):
        """Seconds the collect phase waits for in-flight invocations: the
        grace factor times the median over sites of each site's BEST recent
        invocation time (a straggler's slow samples shape only its own
        series; the best one washes a contention spike out).  None before
        any warm invocation completed."""
        with self._async_hist_lock:
            per_site = [min(h) for h in self._async_invoke_hist.values() if h]
        if not per_site:
            return None
        return self._ASYNC_GRACE_FACTOR * statistics.median(per_site)

    def _async_standin_ok(self, s):
        """A straggler's last output may stand in only when it is a steady
        TRAIN contribution (phase COMPUTATION, mode TRAIN, a reduce
        payload): barrier outputs drive state counted exactly once."""
        prev = self._last_site_outs.get(s)
        return (
            prev is not None
            and prev.get("phase") == Phase.COMPUTATION.value
            and prev.get("mode") == Mode.TRAIN.value
            and bool(prev.get("reduce"))
        )

    def _async_steady(self, site_outs):
        """True in the COMPUTATION/TRAIN steady state as far as the last
        broadcast and every output so far show — the only regime stand-ins
        and run-ahead are allowed in.  At least one output is needed: a
        round of stand-ins only would re-reduce duplicates."""
        if not site_outs:
            return False
        if self.last_remote_out.get("phase") != Phase.COMPUTATION.value:
            return False
        return all(
            out.get("phase") == Phase.COMPUTATION.value and out.get("mode") == Mode.TRAIN.value
            for out in site_outs.values()
        )

    def _async_deliver(self, rnd, s, rec, site_outs):
        """Deliver site ``s``'s pending invocation (blocking until it
        finishes): its fresh output, heartbeat and payload faults — the
        serial round's per-site tail.  A failure goes to the quorum
        machinery as in the serial round."""
        q, fut, policy = self._async_pending.pop(s)
        try:
            out = fut.result()
        except Exception as exc:  # noqa: BLE001 — see _site_failure
            self._site_failure(s, exc, attempts=policy.last_attempts)
            return
        site_outs[s] = out
        self._async_last_sub[s] = q
        self._async_fresh.add(s)
        rec.event(Live.HEARTBEAT, cat="engine", site=s)
        ac = self._async_cfg
        if ac["k"]:
            rec.metric(Metric.SITE_STALENESS, float(rnd - q), site=s)
        self.chaos.payload_faults(rnd, s, self.site_states[s]["transferDirectory"], rec)
        if ac["k"] or ac["run_ahead"]:
            self._async_snapshot_payloads(s, out)
        if ac["run_ahead"]:
            # the replay record commits here, on the engine thread: the
            # deferred reduce skips it (_finish_site_outputs record=False)
            self._last_site_outs[s] = dict(out)

    def _async_snapshot_payloads(self, s, out):
        """Freeze a fresh contribution's payload files under aliases (atomic
        copies beside them): a stand-in, and under run-ahead the deferred
        reduce, name the aliases, because the site's next invocation commits
        over the live names at any moment.  Under run-ahead the aliases are
        generation-tagged (``<name>.stale<g>``): a reduce still reading
        generation g on the reducer thread is never overwritten by the next
        delivery; generations older than ``k + d + 2`` are removed.  The
        aliases carry their embedded checksum and sit outside the directory
        manifest."""
        xfer = self.site_states[s]["transferDirectory"]
        d = self._async_cfg["run_ahead"]
        gen = None
        if d:
            gen = self._async_snap_gen.get(s, 0) + 1
            self._async_snap_gen[s] = gen
        snaps, paths = {}, []
        for key, val in out.items():
            if not (isinstance(key, str) and key.endswith("_file") and isinstance(val, str)):
                continue
            src = os.path.join(xfer, val)
            if not os.path.exists(src):
                continue
            alias = f"{val}.stale" if gen is None else f"{val}.stale{gen}"
            wire_transport.atomic_copy(src, os.path.join(xfer, alias))
            snaps[key] = alias
            paths.append(os.path.join(xfer, alias))
        self._async_snapshots[s] = snaps
        if gen is not None:
            files = self._async_snap_files.setdefault(s, {})
            files[gen] = paths
            horizon = self._async_cfg["k"] + d + 2
            for old in [g for g in files if g <= gen - horizon]:
                for p in files.pop(old):
                    try:
                        os.remove(p)
                    except OSError:
                        pass

    def _async_alias_out(self, s, out):
        """``out`` with every payload name rewritten to site ``s``'s latest
        frozen alias (an aliased name maps to itself)."""
        out = dict(out)
        for key, alias in self._async_snapshots.get(s, {}).items():
            if key in out:
                out[key] = alias
        return out

    def _async_standin_out(self, s):
        """A straggler's stand-in: its last contribution, naming the frozen
        aliases of its payloads."""
        return self._async_alias_out(s, self._last_site_outs[s])

    # -------------------------------------------------------- run-ahead
    # run_ahead = d >= 1 decouples compute from the wire: the reduce and
    # relay of round r run on the reducer thread while every site whose
    # round-r payload committed is re-submitted at once — with the newest
    # broadcast it has not consumed when one was harvested, else (up to d
    # deep) the last one with the one-shot update keys stripped, so no
    # broadcast is applied twice.  The lag shows as the site's wire_round
    # echo lag, within the aggregator's k + d window, and the reducer's
    # gamma**lag discount weighs it.  Barriers, membership rounds and any
    # non-steady round drain the pipeline and run the inline tail.

    def _pipeline_input(self, s):
        """Site ``s``'s full input when a broadcast it has not consumed is
        at hand (recording the consumption, the run-ahead depth back to 0);
        None when it consumed the newest harvested broadcast already."""
        cur = self.site_inputs.get(s) or {}
        stamp = cur.get(RemoteWire.ROUND.value)
        if stamp is not None and stamp == self._async_consumed.get(s):
            return None
        if stamp is not None:
            self._async_consumed[s] = stamp
        self._run_ahead_depth[s] = 0
        return self._site_input(s)

    def _run_ahead_eligible(self, inp):
        """A plain steady dSGD update a site may compute ahead of; the
        multi-invocation protocols and the run's transitions block it."""
        return bool(inp.get(RemoteWire.UPDATE.value)) and not any(
            key in inp for key in _RUN_AHEAD_BLOCKERS
        )

    def _run_ahead_strip(self, inp):
        return {k: v for k, v in inp.items() if k not in _RUN_AHEAD_STRIP}

    def _reduce_job(self, rnd, site_outs, rec):
        """The reducer thread's unit of work: one round's wire tail.  Notes
        whether a site invocation was in flight at its start or its end
        (the engine re-submits right after handing the job over) for
        ``pipeline:reduce_concurrent``."""
        pending = bool(self._async_pending)
        t0 = time.monotonic()
        out = self._remote_and_relay(rnd, site_outs, rec, record_outs=False)
        pending = pending or bool(self._async_pending)
        return out, time.monotonic() - t0, pending

    def _pipeline_submit_reduce(self, rnd, site_outs, rec):
        fut = self._ensure_reduce_pool().submit(self._reduce_job, rnd, dict(site_outs), rec)
        self._reduce_pending.append((rnd, fut))

    def _pipeline_harvest(self, rec, stall_site=None):
        """Harvest the OLDEST reduce in flight (blocking until it is done),
        make its broadcast the sites' input, and write the pipeline's
        records: ``pipeline:stall`` when ``stall_site`` had to wait on the
        reducer, ``pipeline:reduce_concurrent`` (seconds the tail ran while
        a site computed)."""
        if not self._reduce_pending:
            return None
        red_rnd, fut = self._reduce_pending.pop(0)
        blocked = not fut.done()
        t0 = time.monotonic()
        remote_out, dur, concurrent = fut.result()
        if blocked and stall_site is not None:
            rec.event("pipeline:stall", cat="async", site=stall_site, reduce_round=red_rnd,
                      waited_s=round(time.monotonic() - t0, 4),
                      d=self._async_cfg["run_ahead"])
        if concurrent and dur > 0:
            rec.event("pipeline:reduce_concurrent", cat="async", reduce_round=red_rnd,
                      secs=round(dur, 4))
        self.last_remote_out = remote_out
        self.site_inputs = {s: dict(remote_out) for s in self._alive_site_ids()}
        return remote_out

    def _pipeline_poll(self, rec):
        """Harvest every COMPLETED reduce, oldest first, without blocking."""
        out = None
        while self._reduce_pending and self._reduce_pending[0][1].done():
            out = self._pipeline_harvest(rec)
        return out

    def _pipeline_drain(self, rec, reason=None):
        """Block until every reduce in flight is harvested: from here on
        the round runs the inline (d = 0) schedule."""
        n = len(self._reduce_pending)
        out = None
        while self._reduce_pending:
            out = self._pipeline_harvest(rec)
        if n and reason:
            rec.event("pipeline:drain", cat="async", reason=str(reason), pending=n)
        return out

    def _pipeline_resubmit(self, rnd, s, rec, d):
        """Re-submit a site whose round-``rnd`` payload just committed: its
        full input when a broadcast it has not consumed is at hand, else a
        run-ahead submission up to ``d`` deep; past the depth (or on an
        ineligible broadcast) it waits on the reducer thread."""
        inp = self._pipeline_input(s)
        if inp is None:
            depth = self._run_ahead_depth.get(s, 0)
            base = self.site_inputs.get(s) or {}
            if depth >= d or not self._run_ahead_eligible(base):
                self._pipeline_harvest(rec, stall_site=s)
                inp = self._pipeline_input(s)
                if inp is None:
                    return  # no newer broadcast even after the harvest: idle
            else:
                self._run_ahead_depth[s] = depth + 1
                inp = self._run_ahead_strip(base)
                rec.event("async:run_ahead", cat="async", site=s, depth=depth + 1, d=d)
        rec.metric(Metric.SITE_RUN_AHEAD, float(self._run_ahead_depth.get(s, 0)), site=s)
        policy = self._invoke_policy(s)
        fut = self._async_pool.submit(self._async_attempt, policy, rnd + 1, s, inp, rec)
        self._async_pending[s] = (rnd + 1, fut, policy)

    def _pipeline_round(self, rnd, site_outs, rec, d):
        """The steady pipelined tail: every delivered output names its
        frozen aliases (the site's next commit overwrites the live names
        while the deferred reduce reads), the reduce goes to the reducer
        thread, and every fresh site is re-submitted at once."""
        for s in sorted(site_outs):
            site_outs[s] = self._async_alias_out(s, site_outs[s])
        self._pipeline_submit_reduce(rnd, site_outs, rec)
        if _PIPELINE_FORCE_DRAIN:
            self._pipeline_drain(rec, reason="forced")
        self._pipeline_poll(rec)
        for s in sorted(self._async_fresh):
            if s in self.dead_sites or s in self._async_pending:
                continue
            self._pipeline_resubmit(rnd, s, rec, d)

    def _step_round_async(self, ac):
        """One async round: submit every idle alive site to the bounded
        pool, collect what completed within the grace window, let an
        in-window straggler be represented by its last contribution, then
        run the aggregator and relay — inline, or with run-ahead in the
        steady state on the reducer thread while the sites compute on."""
        rec = self._recorder()
        rnd = self.rounds + 1
        rec.set_context(round=rnd)
        self._membership_round(rnd, rec)
        k, d = ac["k"], ac["run_ahead"]
        site_outs = {}
        self._async_fresh = set()
        with self.chaos.activate(rec), rec.span("engine:round", cat="engine", mode="async"):
            pool = self._ensure_async_pool(self._async_pool_size(ac))
            if d:
                # an idle site must never be handed a broadcast it consumed
                self._pipeline_poll(rec)
            # submit: every alive site without a pending invocation computes
            # this round, against the latest broadcast
            for s in self._alive_site_ids():
                if s in self._async_pending:
                    continue
                replay = self._stale_replay(rnd, s, rec)
                if replay is not None:
                    site_outs[s] = replay
                    continue
                if d:
                    inp = self._pipeline_input(s)
                    if inp is None:
                        # the reducer is behind: wait on it
                        self._pipeline_harvest(rec, stall_site=s)
                        inp = self._pipeline_input(s)
                    if inp is None:
                        inp = self._site_input(s)  # the first rounds: no stamp
                else:
                    inp = self._site_input(s)
                policy = self._invoke_policy(s)
                fut = pool.submit(self._async_attempt, policy, rnd, s, inp, rec)
                self._async_pending[s] = (rnd, fut, policy)

            # collect: this round's submissions get the grace window,
            # anchored at the round's first fresh completion (the peers set
            # the round's baseline); then deliver what completed
            fresh_futs = [
                pend[1] for s in self._alive_site_ids()
                for pend in (self._async_pending.get(s),)
                if pend is not None and pend[0] == rnd
            ]
            if fresh_futs and not all(f.done() for f in fresh_futs):
                grace = self._async_grace()
                if grace:
                    futures_wait(fresh_futs, return_when=FIRST_COMPLETED)
                    if not all(f.done() for f in fresh_futs):
                        futures_wait(fresh_futs, timeout=grace)
            waiting = []
            for s in self._alive_site_ids():
                if s not in self._async_pending:
                    continue
                if self._async_pending[s][1].done():
                    self._async_deliver(rnd, s, rec, site_outs)
                else:
                    waiting.append(s)
            steady = self._async_steady(site_outs)
            for s in waiting:
                q = self._async_pending[s][0]
                # the stand-in's staleness: rounds since the straggler's last
                # FRESH contribution was submitted — the lag its echo shows
                lag = rnd - self._async_last_sub.get(s, q)
                if k and steady and self._async_standin_ok(s) and lag <= k:
                    site_outs[s] = self._async_standin_out(s)
                    rec.event("async:stale", cat="async", site=s, lag=lag, k=k)
                    rec.metric(Metric.SITE_STALENESS, float(lag), site=s)
                    continue
                if k and lag > k:
                    rec.event("async:staleness_exceeded", cat="async", site=s, lag=lag, k=k)
                    rec.metric(Metric.SITE_STALENESS, float(lag), site=s)
                self._async_deliver(rnd, s, rec, site_outs)

            # the pipeline judges steadiness over the COMPLETE delivered set
            # (above it was the fresh outputs only, to gate stand-ins)
            pipelined = (bool(d) and bool(self._async_fresh) and self._async_steady(site_outs)
                         and not self._membership_busy())
            if pipelined:
                self._pipeline_round(rnd, site_outs, rec, d)
                remote_out = dict(self.last_remote_out)
            else:
                if d:
                    # a barrier or transition: the round below runs the
                    # exact inline (d = 0) tail
                    self._pipeline_drain(rec, reason="barrier")
                remote_out = self._remote_and_relay(rnd, site_outs, rec)
            self._finalize_leavers(site_outs, rec)
        rec.flush()
        if not pipelined:
            self.site_inputs = {s: dict(remote_out) for s in self._alive_site_ids()}
        self.rounds += 1
        return site_outs, remote_out

    def run(self, max_rounds=100000, verbose=False):
        """Drive rounds until the aggregator reports SUCCESS."""
        while not self.success and self.rounds < max_rounds:
            _, remote_out = self.step_round()
            if verbose and logger.lazy_debug(self.rounds):
                logger.info(
                    f"round {self.rounds}: phase={remote_out.get('phase')} "
                    f"epoch={self.remote_cache.get('epoch')}",
                    True,
                )
        return self

    def close(self):
        """Release the async invocation pool (pending invocations cancelled;
        running ones finish or fail on their own) and the reducer thread
        (reduces in flight abandoned).  The lockstep rounds build neither,
        so this is a no-op there."""
        pool, self._async_pool = self._async_pool, None
        if pool is not None:
            for _q, fut, _p in self._async_pending.values():
                fut.cancel()
            pool.shutdown(wait=False, cancel_futures=True)
        self._async_pending = {}
        rpool, self._reduce_pool = self._reduce_pool, None
        if rpool is not None:
            for _rnd, fut in self._reduce_pending:
                fut.cancel()
            rpool.shutdown(wait=False, cancel_futures=True)
        self._reduce_pending = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class SubprocessEngine(InProcessEngine):
    """The fresh-process engine: every node invocation is ``python <script>
    --device <cpu|cuda>`` with ``{"cache", "input", "state"}`` on stdin,
    and the last JSON line of its stdout, ``{"output", "cache"}``, is the
    result (the contract of the example entry scripts).  The engine keeps
    each node's JSON cache between invocations, as the COINSTAC engine
    does; the live train state survives through
    ``cache['persist_round_state']`` (``nodes/local.py``).

    ``first_input`` (one dict for every site, or a dict per site id) is
    merged into each site's first input, where the node's arguments
    resolve once.  ``env`` is the children's environment (default this
    process's); ``timeout`` bounds each invocation in seconds.  The async
    pool and the run-ahead depth are uncapped: the pool threads and the
    reducer thread only wait on processes."""

    _ASYNC_POOL_CAP = None
    _RUN_AHEAD_CAP = None

    def __init__(self, workdir, n_sites, local_script, remote_script,
                 first_input=None, env=None, timeout=600, device=None, **kw):
        super().__init__(workdir, n_sites, device=device, **kw)
        # the in-process argument channels never reach a child process: a
        # silently different configuration is worse than an error
        if self.args or self.site_args or self.site_spec:
            raise ValueError(
                "SubprocessEngine nodes run in their own processes: engine "
                "**args / site_args / inputspec are not shipped to them; "
                "pass node args via first_input (merged into the first "
                "invocation's input)"
            )
        self.local_script = str(local_script)
        self.remote_script = str(remote_script)
        self.env = env
        self.timeout = timeout
        first_input = first_input or {}
        if not any(s in first_input for s in self.site_ids):
            first_input = {s: dict(first_input) for s in self.site_ids}
        self.first_input = first_input
        self._first_done = set()
        # the aggregator's own lane: its cache learns the telemetry flag of
        # the sites' arguments here (see the module docstring)
        cfg = self._target_config("remote")
        for key in ("profile", "telemetry"):
            if cfg.get(key):
                self.remote_cache.setdefault(key, cfg[key])

    def _invoke(self, script, payload, target=None, rec=None, rnd=None):
        """Run ``script`` once on ``payload``; returns its result dict.  A
        timeout lands an ``invoke:timeout`` event before it raises."""
        try:
            res = subprocess.run(
                [sys.executable, script, "--device", self.device.type],
                input=json.dumps(clean_recursive(payload)),
                capture_output=True, text=True, env=self.env, timeout=self.timeout,
            )
        except subprocess.TimeoutExpired as exc:
            stderr = exc.stderr or ""
            if isinstance(stderr, bytes):
                stderr = stderr.decode("utf-8", "replace")
            if rec is not None:
                rec.event(
                    "invoke:timeout", cat="invoke", target=str(target),
                    timeout_s=float(self.timeout), script=str(script),
                    stderr=stderr[-1000:],
                )
            raise InvokeTimeout(
                f"{script} timed out after {self.timeout}s"
                f"{f' (target {target})' if target else ''}\n"
                f"--- partial stderr ---\n{stderr[-4000:]}"
            ) from exc
        if res.returncode != 0:
            raise RuntimeError(
                f"{script} exited rc={res.returncode}\n--- stderr ---\n{res.stderr[-4000:]}"
            )
        # the node may print log lines: the LAST JSON line is the result
        for line in reversed(res.stdout.strip().splitlines()):
            line = line.strip()
            if line.startswith("{"):
                try:
                    return json.loads(line)
                except ValueError:
                    continue
        raise RuntimeError(f"{script} produced no JSON result\n--- stdout ---\n{res.stdout[-2000:]}")

    def _site_input(self, s):
        inp = dict(self.site_inputs[s])
        if s not in self._first_done:
            inp.update(self.first_input.get(s, {}))
            self._first_done.add(s)
        return self._membership_input(s, inp)

    def _site_attempt(self, rnd, s, inp, rec):
        # a hung process gives no output until its timeout: the chaos hang
        # raises in its place; a slow fault's sleep is simulated compute
        with rec.span(f"invoke:{s}", cat="invoke", round=rnd):
            self.chaos.invoke_fault(rnd, s, rec)
            res = self._invoke(self.local_script, {
                "cache": self.site_caches[s], "input": inp, "state": self.site_states[s],
            }, target=s, rec=rec, rnd=rnd)
        self.site_caches[s] = res.get("cache", {})
        return res["output"]

    def _remote_attempt(self, rnd, site_outs, rec):
        # the aggregator loads the payloads in its own process, so a damaged
        # payload fails the whole invocation: the retry, which heals first,
        # is the recovery
        self.chaos.invoke_fault(rnd, "remote", rec)
        with rec.span("invoke:remote", cat="invoke", round=rnd):
            res = self._invoke(self.remote_script, {
                "cache": self.remote_cache, "input": site_outs, "state": self.remote_state,
            }, target="remote", rec=rec, rnd=rnd)
        self.remote_cache = res.get("cache", {})
        self.success = bool(res.get("success"))
        return res["output"]


class MeshEngine:
    """The federated lifecycle of the mesh and site-vectorized planes, on
    the host: fold rotation, lockstep epochs, the validation cadence, the
    exact cross-site count merge of metrics, best checkpoints, early stop,
    the per-fold test, the global score CSV and the results zip — the
    aggregator's state machine without its wire — while every training
    round is one call of a federation plane (``_build_federation``) over
    all sites, and evaluation one call per batch index.

    Same per-site data layout and splits, loader order (seeded by ``(seed,
    epoch)``), lockstep ``target_batches`` padding, best/early-stop
    decisions and score artifacts as :class:`InProcessEngine`.  A
    ``pretrain_args`` pretrain runs on the site with the most training
    data, and every site adopts its best weights from the wire checkpoint
    it wrote, as after the broadcast.  Sparse test mode (``load_sparse``)
    tests per site on the host with the same count merge.  An epoch-barrier
    autosave and ``.mesh_resume.json`` make a crashed run resumable
    (``resume``).

    The plane is ``MeshFederation`` over a rank mesh: ``devices`` (default:
    every visible card, each once; a name may repeat, ``["cpu"] * n`` on
    the CPU, ``["cuda:0"] * n`` for several ranks on one card) with
    ``devices_per_site`` ranks a site, or with ``sequence_parallel`` or
    ``tensor_parallel`` ``sp``/``tp`` ranks a site; the site-vectorized
    engine (``federation/engine.py``) overrides ``_build_federation``.  With
    ``capture_on_anomaly`` a round after a watchdog anomaly on the engine's
    cache runs under ``torch.profiler`` (``telemetry/capture.py``), its
    trace kept under the aggregator's output directory."""

    def __init__(self, workdir, n_sites, trainer_cls=COINNTrainer,
                 dataset_cls=None, datahandle_cls=COINNDataHandle,
                 devices=None, devices_per_site=None, site_args=None, device=None,
                 **args):
        self.device = config.resolve_device(device)
        self.devices = devices
        self.devices_per_site = devices_per_site
        self.workdir = str(workdir)
        self.n_sites = int(n_sites)
        self.trainer_cls = trainer_cls
        self.dataset_cls = dataset_cls
        self.datahandle_cls = datahandle_cls
        self.site_args = site_args or {}

        self.cache = dict(COINNLocal._ARG_DEFAULTS)
        self.cache.update(args)
        if self.cache.get("seed") is None:
            self.cache["seed"] = config.current_seed

        self.site_ids = [f"site_{i}" for i in range(self.n_sites)]
        self.site_states = {}
        for s in self.site_ids:
            base = os.path.join(self.workdir, s)
            outd = os.path.join(base, "out")
            for d in (base, outd):
                os.makedirs(d, exist_ok=True)
            self.site_states[s] = {
                "baseDirectory": base, "outputDirectory": outd, "clientId": s,
            }
        self.remote_out_dir = os.path.join(self.workdir, "remote_out")
        os.makedirs(self.remote_out_dir, exist_ok=True)
        self.site_caches = {}
        self.success = False
        self.results_zip = None
        self._trainer = None
        # sites left out of every later round (their train batches and eval
        # loaders degrade to fully-masked placeholders, the path a site
        # without data takes); the site-vectorized engine fills it
        self.dead_sites = set()

    def _site_loads(self, s):
        """Whether site ``s`` gets a live loader this epoch or evaluation
        (else the fully-masked placeholder stream); the site-vectorized
        engine adds its roster."""
        return s not in self.dead_sites

    def site_data_dir(self, site_id, data_dir=None):
        d = os.path.join(
            self.site_states[site_id]["baseDirectory"],
            data_dir or self.cache.get("data_dir", "data"),
        )
        os.makedirs(d, exist_ok=True)
        return d

    # ------------------------------------------------------------- lifecycle
    def run(self):
        """Drive every fold to completion; sets ``success`` at the end."""
        handles = {}
        for s in self.site_ids:
            scache = dict(self.cache)
            scache.update(self.site_args.get(s, {}))
            self.site_caches[s] = scache
            h = self.datahandle_cls(
                cache=scache, state=self.site_states[s],
                dataset_cls=self.dataset_cls,
                dataloader_args=scache.get("dataloader_args"),
            )
            h.prepare_data()
            handles[s] = h
        rc = self.cache
        rc["num_folds"] = len(next(iter(self.site_caches.values()))["splits"])
        rc[Key.GLOBAL_TEST_SERIALIZABLE.value] = []
        # resume only from the record of an interrupted run: a completed
        # run removed its record, so its fold checkpoints never replay
        self._resuming = bool(rc.get("resume")) and os.path.exists(self._run_state_path())
        done_folds = (self._load_run_state().get("completed_folds", {})
                      if self._resuming else {})
        self._write_run_state_marker()
        try:
            for fold in range(int(rc["num_folds"])):
                if str(fold) in done_folds:
                    rc[Key.GLOBAL_TEST_SERIALIZABLE.value].append(done_folds[str(fold)])
                    continue
                self._run_fold(str(fold), handles)
            self._finish()
        finally:
            # the last round's records (its step's samples, a capture) come
            # after the last round hook's flush
            self._recorder().flush()
        return self

    # ------------------------------------------------------- mid-run resume
    def _run_state_path(self):
        return os.path.join(self.workdir, ".mesh_resume.json")

    def _load_run_state(self):
        try:
            with open(self._run_state_path()) as f:
                return json.load(f)
        except (OSError, ValueError):
            return {}

    def _write_run_state(self, run_state):
        utils.atomic_write(self._run_state_path(), json.dumps(run_state).encode())

    def _write_run_state_marker(self):
        """A fresh (not resuming) run resets the record, so a stale record
        of a crashed run never leaks fold results into a later resume."""
        if not getattr(self, "_resuming", False) or not os.path.exists(
                self._run_state_path()):
            self._write_run_state({"completed_folds": {}})

    def _record_fold_done(self, split_ix, payload):
        run_state = self._load_run_state()
        run_state.setdefault("completed_folds", {})[str(split_ix)] = payload
        self._write_run_state(run_state)

    def _epoch_autosave(self, trainer, fed, epoch):
        """The fold's resume point at the epoch barrier: models, optimizers,
        generator, score logs and the plane's state.  Cadence from
        ``cache['autosave_epochs']`` (0 disables)."""
        rc = self.cache
        every = int(rc.get("autosave_epochs", 1) or 0)
        if every <= 0 or int(epoch) % every != 0:
            return
        extra = {
            "epoch": int(epoch),
            "train_log": rc[Key.TRAIN_LOG.value],
            "validation_log": rc[Key.VALIDATION_LOG.value],
            "best_val_epoch": rc.get("best_val_epoch", 0),
            "best_val_score": rc.get("best_val_score"),
            "fed": fed.serialize_comm_state(),
        }
        trainer.save_checkpoint(name=rc["latest_nn_state"], extra=extra)

    def _try_fold_resume(self, trainer, fed):
        """Restart the fold from its latest epoch-barrier autosave; returns
        the epochs completed (0: a fresh fold).  An unreadable autosave
        (a crash mid-write) restarts the fold fresh."""
        rc = self.cache
        path = trainer.checkpoint_path(rc["latest_nn_state"])
        if not (getattr(self, "_resuming", False) and os.path.exists(path)):
            return 0
        try:
            trainer.load_checkpoint(full_path=path)
        except Exception as exc:  # noqa: BLE001 — any decode failure
            # load_checkpoint reads the whole file before it touches a
            # model, so the fresh seeded init from _run_fold is intact
            logger.warn(f"MeshEngine: unreadable autosave {path} ({exc}); "
                        "restarting the fold fresh")
            return 0
        extra = getattr(trainer, "last_checkpoint_extra", {})
        rc[Key.TRAIN_LOG.value] = [list(r) for r in extra.get("train_log", [])]
        rc[Key.VALIDATION_LOG.value] = [list(r) for r in extra.get("validation_log", [])]
        rc["best_val_epoch"] = int(extra.get("best_val_epoch", 0))
        rc["best_val_score"] = extra.get("best_val_score")
        fed.restore_comm_state(dict(extra.get("fed", {})))
        epoch = int(extra.get("epoch", 0))
        logger.info(f"MeshEngine: resuming fold {rc['split_ix']} from epoch {epoch}",
                    rc.get("verbose", True))
        return epoch

    def _run_fold(self, split_ix, handles):
        rc = self.cache
        for s in self.site_ids:
            sc = self.site_caches[s]
            sc["split_ix"] = split_ix
            sc["split_file"] = sc["splits"][split_ix]
        log_dir = os.path.join(self.remote_out_dir, str(rc["task_id"]), f"fold_{split_ix}")
        os.makedirs(log_dir, exist_ok=True)
        rc.update(log_dir=log_dir, split_ix=split_ix, epoch=0,
                  best_val_epoch=0, best_val_score=None)
        rc[Key.TRAIN_LOG.value] = []
        rc[Key.VALIDATION_LOG.value] = []
        rc[Key.TEST_METRICS.value] = []
        tag = f"{rc['task_id']}-{split_ix}"
        rc["best_nn_state"] = f"best.{tag}.ckpt"
        rc["latest_nn_state"] = f"latest.{tag}.ckpt"

        trainer = self.trainer_cls(
            cache=rc, input={}, state={"outputDirectory": self.remote_out_dir},
            data_handle=None, device=self.device,
        )
        trainer.init_nn()
        self._trainer = trainer
        self._mesh_pretrain(trainer, handles)
        fed = self._build_federation(rc)
        self._last_fed = fed
        self._run_fold_loop(split_ix, handles, trainer, fed, rc)

    def _build_federation(self, rc):
        """This fold's federation plane — the hook the site-vectorized
        engine overrides: ``MeshFederation``, or with ``sequence_parallel``
        or ``tensor_parallel`` above 1 its sequence- or tensor-parallel
        variant (one intra-site axis: the two exclude each other, and
        ``devices_per_site`` must not contradict them)."""
        from .parallel.mesh import MeshFederation

        trainer = self._trainer
        sp = int(rc.get("sequence_parallel", 1) or 1)
        tp = int(rc.get("tensor_parallel", 1) or 1)
        engine = str(rc.get("agg_engine", "dSGD"))
        if sp > 1 and tp > 1:
            raise ValueError(
                f"sequence_parallel={sp} and tensor_parallel={tp} are "
                "mutually exclusive (one intra-site mesh axis); pick one"
            )
        if sp > 1:
            if self.devices_per_site not in (None, sp):
                raise ValueError(
                    f"devices_per_site={self.devices_per_site} conflicts "
                    f"with sequence_parallel={sp}: the intra-site axis is "
                    "the sequence axis (sp ranks per site); drop one of the "
                    "two settings"
                )
            from .parallel.seq_mesh import SeqMeshFederation

            return SeqMeshFederation(trainer, self.n_sites, sp=sp, agg_engine=engine,
                                     devices=self.devices)
        if tp > 1:
            if self.devices_per_site not in (None, tp):
                raise ValueError(
                    f"devices_per_site={self.devices_per_site} conflicts "
                    f"with tensor_parallel={tp}: the intra-site axis is the "
                    "tensor axis (tp ranks per site); drop one of the two "
                    "settings"
                )
            from .parallel.tp_mesh import TPMeshFederation

            return TPMeshFederation(trainer, self.n_sites, tp=tp, agg_engine=engine,
                                    devices=self.devices)
        return MeshFederation(trainer, self.n_sites, agg_engine=engine, devices=self.devices,
                              devices_per_site=self.devices_per_site)

    def _recorder(self):
        """The engine's telemetry lane (``telemetry.engine.jsonl``), on
        with ``profile``/``telemetry`` in the engine's or a site's args."""
        return _engine_recorder(self, [self.cache, *self.site_args.values()])

    def _round_hook(self, site_batches):
        """The per-round boundary before the plane's step; the
        site-vectorized engine injects faults and masks sites here."""
        return site_batches

    def _run_fold_loop(self, split_ix, handles, trainer, fed, rc):
        log_dir = rc["log_dir"]
        bs = int(rc.get("batch_size", 16))
        train_sets = {s: handles[s].get_train_dataset() for s in self.site_ids}
        if not any(len(ds) for ds in train_sets.values()):
            raise ValueError(f"fold {split_ix}: every site's train dataset is empty")
        # lockstep epochs: every site pads to the largest batch count (the
        # aggregator's target_batches broadcast)
        target_batches = max(
            (math.ceil(len(ds) / bs) for ds in train_sets.values() if len(ds)), default=1,
        )
        k = max(int(rc.get("local_iterations", 1)), 1)
        epochs = int(rc.get("epochs", 1))
        val_every = max(int(rc.get("validation_epochs", 1)), 1)
        ep_averages, ep_metrics = trainer.new_averages(), trainer.new_metrics()
        epoch = self._try_fold_resume(trainer, fed)
        # the resume point may already meet the stop condition (a crash
        # after the last barrier, before the fold test finished)
        fold_complete = epoch >= epochs or (epoch > 0 and stop_training_(epoch, rc))
        while not fold_complete:
            epoch += 1
            rc["epoch"] = epoch
            # the loader's epoch is 0-based, as the node's cursor has it; a
            # site without train data (or off the roster) rides a
            # fully-masked placeholder stream and contributes nothing
            iters = [
                (iter(handles[s].get_loader(
                    "train", dataset=train_sets[s], shuffle=True,
                    seed=int(rc.get("seed", 0)), epoch=epoch - 1,
                    target_batches=target_batches,
                )) if len(train_sets[s]) and self._site_loads(s) else None)
                for s in self.site_ids
            ]
            done = 0
            while done < target_batches:
                take = min(k, target_batches - done)
                site_batches = [
                    ([next(it) for _ in range(take)] if it is not None else None)
                    for it in iters
                ]
                template = next(b for b in site_batches if b is not None)
                for i, b in enumerate(site_batches):
                    if b is None:
                        site_batches[i] = [
                            {**tb, "_mask": np.zeros_like(np.asarray(tb["_mask"]))}
                            for tb in template
                        ]
                # a watchdog-armed capture (telemetry/capture.py) wraps the
                # whole round; one dict lookup unless armed
                with _capture.captured_round(rc, self.remote_out_dir, self._recorder()):
                    aux = fed.train_step(self._round_hook(site_batches))
                trainer.fold_train_outputs(aux, ep_averages, ep_metrics)
                done += take
            if epoch % val_every != 0:
                # no stop check off the validation cadence: the aggregator
                # judges the epoch limit at the validation barrier only
                continue
            # ---- epoch barrier (the aggregator's VALIDATION_WAITING)
            rc[Key.TRAIN_LOG.value].append([*ep_averages.get(), *ep_metrics.get()])
            ep_averages, ep_metrics = trainer.new_averages(), trainer.new_metrics()
            v_avg, v_met = self._mesh_eval(fed, handles, "validation")
            rc[Key.VALIDATION_LOG.value].append([*v_avg.get(), *v_met.get()])
            # a missing monitor metric fails loudly, as on the aggregator
            score = v_met.extract(rc.get("monitor_metric", "f1"))
            if performance_improved_(epoch, score, rc):
                trainer.save_checkpoint(name=rc["best_nn_state"])
            self._epoch_autosave(trainer, fed, epoch)
            if epoch >= epochs or stop_training_(epoch, rc):
                break

        # ---- fold test with the best models (the sites' test_distributed)
        if os.path.exists(trainer.checkpoint_path(rc["best_nn_state"])):
            trainer.load_checkpoint(name=rc["best_nn_state"])
        t_avg, t_met = self._mesh_eval(fed, handles, "test")
        rc[Key.TEST_METRICS.value].append([*t_avg.get(), *t_met.get()])
        fold_payload = {"averages": t_avg.serialize(), "metrics": t_met.serialize()}
        rc[Key.GLOBAL_TEST_SERIALIZABLE.value].append(fold_payload)
        self._record_fold_done(split_ix, clean_recursive(fold_payload))
        utils.save_scores(rc, log_dir=log_dir, file_keys=[Key.TEST_METRICS.value])
        utils.save_cache(rc, {"outputDirectory": log_dir})

    # --------------------------------------------------------------- pretrain
    def _mesh_pretrain(self, trainer, handles):
        """The designated-site pretrain with the file transport's meaning:
        the site with the most training data trains alone for
        ``pretrain_args['epochs']``, writing its best weights as a wire
        checkpoint into a transfer directory; then every site's state is a
        fresh init with those weights and a fresh optimizer, as after the
        broadcast load."""
        rc = self.cache
        p_args = dict(rc.get("pretrain_args") or {})
        if int(p_args.get("epochs", 0) or 0) <= 0:
            return False
        sizes = {s: len(handles[s].get_train_dataset()) for s in self.site_ids}
        designated = max(sizes, key=sizes.get)
        xfer = os.path.join(self.workdir, "pretrain_xfer")
        os.makedirs(xfer, exist_ok=True)

        # overlay pretrain_args; shield the fold's logs and early-stop
        # state, the resume flag and the checkpoint names (train_local's
        # final autosave must not overwrite the fold's resume point)
        shield = set(p_args) | {
            "pretrain", "weights_file", "autosave_epochs", "resume",
            "latest_nn_state", "best_nn_state",
            Key.TRAIN_LOG.value, Key.VALIDATION_LOG.value,
            "best_val_epoch", "best_val_score", "epoch", "cursor",
        }
        saved = {k: rc.get(k) for k in shield}
        rc.update(p_args)
        rc.update(pretrain=True, weights_file=None, autosave_epochs=0, resume=False,
                  latest_nn_state=f"pretrain.latest.{rc['task_id']}.ckpt",
                  best_nn_state=f"pretrain.best.{rc['task_id']}.ckpt")
        rc[Key.TRAIN_LOG.value] = []
        rc[Key.VALIDATION_LOG.value] = []
        rc.update(best_val_epoch=0, best_val_score=None)
        old_state, old_handle = trainer.state, trainer.data_handle
        trainer.state = dict(old_state, transferDirectory=xfer)
        trainer.data_handle = handles[designated]
        try:
            trainer.train_local(
                handles[designated].get_train_dataset(),
                handles[designated].get_validation_dataset(),
            )
        finally:
            trainer.state, trainer.data_handle = old_state, old_handle
            wfile = rc.get("weights_file")
            for key, v in saved.items():
                if v is None:
                    # absent before the pretrain: removed, so that
                    # `.get(key, default)` still finds its default
                    rc.pop(key, None)
                else:
                    rc[key] = v
        # the broadcast's adoption: a fresh init plus the weights
        trainer.init_nn()
        if wfile and os.path.exists(os.path.join(xfer, wfile)):
            trainer.load_checkpoint(full_path=os.path.join(xfer, wfile),
                                    load_optimizer=False, allow_torch=False)
        logger.info(
            f"MeshEngine: pretrain at {designated} "
            f"({'adopted ' + wfile if wfile else 'no improvement'})",
            rc.get("verbose", True),
        )
        return True

    # ------------------------------------------------------------- evaluation
    def _mesh_eval(self, fed, handles, which):
        """Evaluation reduced over the sites: per-site loaders padded to
        one length, one plane call per batch index."""
        if which == "test" and bool(self.cache.get("load_sparse")):
            return self._host_test_sparse(handles)
        trainer = self._trainer
        bs = int(self.cache.get("batch_size", 16))
        datasets = {
            s: (handles[s].get_validation_dataset() if which == "validation"
                else handles[s].get_test_dataset())
            for s in self.site_ids
        }
        nb = max((math.ceil(len(ds) / bs) for ds in datasets.values() if len(ds)),
                 default=0)
        metrics, averages = trainer.new_metrics(), trainer.new_averages()
        if nb == 0:
            return averages, metrics
        loaders = {
            s: (iter(handles[s].get_loader(which, dataset=datasets[s], shuffle=False,
                                           target_batches=nb))
                if len(datasets[s]) and self._site_loads(s) else None)
            for s in self.site_ids
        }
        for _ in range(nb):
            batches = [(next(loaders[s]) if loaders[s] is not None else None)
                       for s in self.site_ids]
            template = next(b for b in batches if b is not None)
            filled = []
            for b in batches:
                if b is None:  # no data, or off the roster: fully masked
                    b = dict(template)
                    b["_mask"] = np.zeros_like(np.asarray(template["_mask"]))
                filled.append(b)
            m_state, a_state, hs = fed.eval_step(filled)
            if m_state is not None:
                metrics.update(m_state)
            elif hs is not None:
                trainer.add_host_scores(metrics, hs)
            elif not metrics.jit_safe:
                # a host-side metric, but the iteration gives no pred/true
                # to feed it: the exact per-site host evaluation instead
                return self._host_eval(handles, which)
            averages.update(a_state)
        return averages, metrics

    def _host_test_sparse(self, handles):
        """The fold test over per-subject datasets (``load_sparse``), with
        per-subject ``save_predictions`` when asked."""
        return self._host_eval(
            handles, "test",
            datasets_fn=lambda h: h.get_test_dataset(load_sparse=True),
            save_pred=bool(self.cache.get("save_predictions")),
        )

    def _host_eval(self, handles, which, datasets_fn=None, save_pred=False):
        """Per-site evaluation on the host with the exact cross-site merge:
        the sparse test, and the fallback for a host-side metric the plane
        cannot feed.  ``datasets_fn(handle)`` picks the site's dataset (or
        a list of them)."""
        trainer = self._trainer
        metrics, averages = trainer.new_metrics(), trainer.new_averages()
        mode = Mode.VALIDATION if which == "validation" else Mode.TEST
        if datasets_fn is None:
            datasets_fn = ((lambda h: h.get_validation_dataset()) if which == "validation"
                           else (lambda h: h.get_test_dataset()))
        shared_state = trainer.state
        try:
            for s in self.site_ids:
                trainer.data_handle = handles[s]
                # the site's own state during its evaluation: user hooks
                # (save_predictions) see the site's directories, as on the
                # file transport
                trainer.state = self.site_states[s]
                ds = datasets_fn(handles[s])
                ds = ds if isinstance(ds, list) else [ds]
                if not any(len(d) for d in ds):
                    continue
                a, m = trainer.evaluation(mode, ds, save_pred=save_pred)
                metrics.accumulate(m)
                averages.accumulate(a)
        finally:
            trainer.data_handle = None
            trainer.state = shared_state
        return averages, metrics

    # ---------------------------------------------------------------- wrap-up
    def _finish(self):
        """All folds done: reduce the fold scores, write the CSV, zip the
        results (the aggregator's ``_send_global_scores``)."""
        trainer = self._trainer
        if trainer is None:
            # every fold replayed from the run-state record (a resume after
            # a crash inside _finish): the metric shells need no model
            trainer = self.trainer_cls(
                cache=self.cache, input={}, state={"outputDirectory": self.remote_out_dir},
                data_handle=None, device=self.device,
            )
        rc = self.cache
        pairs = rc[Key.GLOBAL_TEST_SERIALIZABLE.value]
        averages = trainer.new_averages().reduce_sites([p["averages"] for p in pairs])
        metrics = trainer.new_metrics().reduce_sites([p["metrics"] for p in pairs])
        rc["global_test_metrics"] = [[*averages.get(), *metrics.get()]]
        task_dir = os.path.join(self.remote_out_dir, str(rc["task_id"]))
        utils.save_scores(rc, log_dir=task_dir, file_keys=["global_test_metrics"])
        stamp = "_".join(str(datetime.datetime.now()).split(" "))
        zip_name = f"{rc['task_id']}_{rc.get('agg_engine')}_{stamp}"
        shutil.make_archive(os.path.join(self.workdir, zip_name), "zip", task_dir)
        self.results_zip = f"{zip_name}.zip"
        # the run completed: remove the resume record, so that a later run
        # in this workdir never replays this run's fold results
        try:
            os.remove(self._run_state_path())
        except OSError:
            pass
        self.success = True


class SiteRunner:
    """Single-site, no-engine debug harness: drives a site through
    INIT_RUNS then NEXT_RUN with ``pretrain=True`` so the full local
    training loop runs without an aggregator.  The directory layout matches
    the COINSTAC simulator's ``input/local{i}/simulatorRun``."""

    def __init__(self, workdir, task_id="task", site_id=None, inputspec=None,
                 site_index=0, device=None, **args):
        self.device = config.resolve_device(device)
        self.workdir = str(workdir)
        if site_id is None:
            site_id = f"local{int(site_index)}"
        if inputspec is not None:
            args = {**load_inputspec(inputspec, site_index=site_index), **args}
        base = os.path.join(self.workdir, "input", site_id, "simulatorRun")
        outd = os.path.join(self.workdir, "output", site_id)
        xfer = os.path.join(self.workdir, "transfer", site_id)
        for d in (base, outd, xfer):
            os.makedirs(d, exist_ok=True)
        self.state = {
            "baseDirectory": base,
            "outputDirectory": outd,
            "transferDirectory": xfer,
            "clientId": site_id,
        }
        args.setdefault("task_id", task_id)
        args.setdefault("pretrain_args", {"epochs": args.get("epochs", 10)})
        self.args = args
        self.cache = {}

    @property
    def data_dir(self):
        d = os.path.join(self.state["baseDirectory"], self.args.get("data_dir", "data"))
        os.makedirs(d, exist_ok=True)
        return d

    def run(self, trainer_cls, dataset_cls=None, datahandle_cls=COINNDataHandle):
        node = COINNLocal(cache=self.cache, input={}, state=self.state,
                          device=self.device, **self.args)
        node(trainer_cls=trainer_cls, dataset_cls=dataset_cls,
             datahandle_cls=datahandle_cls)
        nxt = {
            "phase": Phase.NEXT_RUN.value,
            "global_runs": {
                self.state["clientId"]: {
                    "split_ix": "0", "seed": self.cache.get("seed", 0),
                    "pretrain": True,
                }
            },
        }
        node = COINNLocal(cache=self.cache, input=nxt, state=self.state,
                          device=self.device, **self.args)
        out = node(trainer_cls=trainer_cls, dataset_cls=dataset_cls,
                   datahandle_cls=datahandle_cls)
        return out["output"]

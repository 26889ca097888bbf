"""SiteVectorizedEngine — the federated lifecycle over the site-vectorized
plane.

Port of the JAX package's ``federation/engine.py``.  It runs
:class:`~..engine.MeshEngine`'s lifecycle (folds, lockstep epochs, the
validation cadence, the exact count merge, best checkpoints, early stop,
the results zip) with :class:`~.vector.SiteVectorizedFederation` as the
gradient plane — every simulated site's step in one pass over the card —
and the serial engines' resilience at the per-site round boundary:

- **chaos invoke faults** (``fault_plan=``, :mod:`~..resilience.chaos`)
  fire per round and site as on the serial engines; a crash or hang marks
  the site dead.  There is no per-site invocation to retry (the round is
  one step), so a crash is a dropout at once.
- **site quorum**: without ``site_quorum`` a dead site fails the run; with
  it the site's batches become fully-masked placeholders (weight 0 in the
  reduce, left out of evaluation), and the quorum is judged against the
  current roster with :meth:`~..nodes.remote.COINNRemote._quorum_need`
  (``site_died``, ``quorum:continue``, ``quorum:fail``).
- **elastic membership** on the roster mask, never the shape: the stacked
  site axis is allocated once at a capacity (``n_sites`` founding members
  plus ``spare_capacity`` empty slots, by default one per ``join`` of the
  plan), and a leave, a join into a spare slot or a rejoin after a death
  only switches the slot between live batches and the placeholder stream.
  A join or rejoin arms the slot's loader at the next epoch (its roster
  and quorum effect is immediate); a leave masks it from the next round.
- **telemetry**: with ``profile``/``telemetry`` in the args the engine
  lane records an ``engine:round`` span per round (hook to hook),
  ``rounds_per_sec`` and ``sites_per_sec`` metrics, one
  ``engine:heartbeat`` per round, one device-memory sample per round
  (``telemetry/perf.py``: the card's caching allocator), the plane's
  ``fed_step`` samples/s, the membership events and the quorum records;
  with ``capture_on_anomaly`` the round after a watchdog anomaly runs
  under ``torch.profiler``.
"""
import time

import numpy as np

from ..config.keys import Live, Membership, Metric
from ..engine import MeshEngine
from ..nodes.remote import COINNRemote
from ..resilience.chaos import ChaosFault, ChaosSession
from ..telemetry import perf as _perf
from ..utils import logger
from .vector import SiteVectorizedFederation


class SiteVectorizedEngine(MeshEngine):
    """The full federated lifecycle over the site-vectorized plane, with
    chaos kills, the site quorum and roster churn on a fixed-capacity site
    axis.  Takes ``device`` like every engine (``cuda`` unless the caller
    names the CPU)."""

    def __init__(self, workdir, n_sites, fault_plan=None, site_shards=None,
                 spare_capacity=None, **kw):
        kw.pop("devices_per_site", None)  # no per-site device rank here
        chaos = ChaosSession.from_spec(fault_plan)
        if spare_capacity is None:
            # every join of the plan fills a slot past the founding roster
            spare_capacity = sum(1 for f in chaos.faults if f.kind == "join")
        self.founding_sites = int(n_sites)
        self.capacity = int(n_sites) + int(spare_capacity)
        super().__init__(workdir, self.capacity, **kw)
        self.chaos = chaos
        self.site_shards = site_shards
        self.rounds = 0
        self.site_failures = {}
        # spare slots are allocated but not admitted yet; left slots were
        # members and retired gracefully; a dead site stays a roster
        # member until a rejoin re-admits it or the run ends
        self.spare_sites = set(self.site_ids[self.founding_sites:])
        self.left_sites = set()
        self.roster_epoch = 1
        self._membership_counts = {"join": 0, "leave": 0, "rejoin": 0}
        self._round_t = None  # (wall, perf counter) of the previous hook

    # ---------------------------------------------------- elastic membership
    def _member_ids(self):
        """The current roster: founding members and admitted spares, less
        the retired."""
        return [s for s in self.site_ids
                if s not in self.spare_sites and s not in self.left_sites]

    def _site_loads(self, s):
        """Only live roster members get live loaders: a spare (not admitted
        yet) or retired slot rides fully masked even with data in its
        directory."""
        return (s not in self.dead_sites and s not in self.spare_sites
                and s not in self.left_sites)

    def add_site(self, site_id=None):
        """A mid-run join (a spare slot) or rejoin (a retired or dead slot;
        a death is reversible here).  The roster and quorum effect is
        immediate; the slot's loader arms at the next epoch.  Returns the
        slot's id."""
        rec = self._recorder()
        if site_id is None:
            site_id = next(iter(sorted(self.spare_sites)), None)
            if site_id is None:
                raise ValueError(
                    "no spare capacity left: size the engine's spare_capacity to the "
                    "expected join volume (the stacked site axis cannot grow)"
                )
        site_id = str(site_id)
        if site_id not in self.site_states:
            raise ValueError(f"{site_id} is outside the allocated capacity "
                             f"({self.capacity} slots)")
        rejoin = site_id in self.left_sites or site_id in self.dead_sites
        if not rejoin and site_id not in self.spare_sites:
            raise ValueError(f"{site_id} is already an active member")
        self.spare_sites.discard(site_id)
        self.left_sites.discard(site_id)
        self.dead_sites.discard(site_id)
        self.site_failures.pop(site_id, None)
        self.roster_epoch += 1
        kind = "rejoin" if rejoin else "join"
        self._membership_counts[kind] += 1
        rec.event(
            Membership.EVENT_REJOIN if rejoin else Membership.EVENT_JOIN,
            cat="membership", site=site_id, epoch=self.roster_epoch,
            members=len(self._member_ids()),
        )
        logger.warn(
            f"membership: {site_id} {'re-joined' if rejoin else 'joined'} the vectorized "
            f"federation at roster epoch {self.roster_epoch} ({len(self._member_ids())} "
            "members; data re-arms at the next epoch boundary)"
        )
        return site_id

    def remove_site(self, site_id, graceful=True):
        """A mid-run leave: the slot is masked from the next round on, the
        roster epoch bumps and the quorum is judged against the smaller
        roster.  ``graceful=False`` takes the death path instead (an
        operator's kill)."""
        site_id = str(site_id)
        if site_id not in self._member_ids() or site_id in self.dead_sites:
            raise ValueError(f"{site_id} is not an alive member")
        if not graceful:
            self._site_failure(site_id, RuntimeError("removed by operator"))
            return
        self.left_sites.add(site_id)
        self.roster_epoch += 1
        self._membership_counts["leave"] += 1
        self._recorder().event(
            Membership.EVENT_LEAVE, cat="membership", site=site_id,
            epoch=self.roster_epoch, members=len(self._member_ids()),
        )
        logger.warn(
            f"membership: {site_id} left the vectorized federation gracefully at roster "
            f"epoch {self.roster_epoch} ({len(self._member_ids())} members remain)"
        )

    def _membership_round(self, rec):
        """Apply the plan's roster operations pinned to this round."""
        for kind, s in self.chaos.membership_ops(self.rounds, rec):
            try:
                if kind == "leave":
                    self.remove_site(s, graceful=True)
                else:  # join / rejoin
                    self.add_site(s)
            except ValueError as exc:
                logger.warn(f"churn plan op {kind}@{s} skipped: {exc}")

    # ------------------------------------------------------ federation plane
    def _build_federation(self, rc):
        sp = int(rc.get("sequence_parallel", 1) or 1)
        tp = int(rc.get("tensor_parallel", 1) or 1)
        if sp > 1 or tp > 1:
            raise ValueError(
                "SiteVectorizedEngine vectorizes the SITE axis only; "
                f"sequence_parallel={sp}/tensor_parallel={tp} need the per-rank MeshEngine"
            )
        fed = SiteVectorizedFederation(
            self._trainer, self.n_sites, agg_engine=str(rc.get("agg_engine", "dSGD")),
            devices=self.devices, site_shards=self.site_shards,
        )
        # the engine's lane doubles as the plane's perf sink (fed_step)
        fed.recorder = self._recorder()
        return fed

    # --------------------------------------------------------- site dropout
    def _site_failure(self, s, exc):
        """A fault killed site ``s`` this round.  Without ``site_quorum``
        the failure propagates (all-site lockstep); with it the site is
        dead from this round on, and the quorum is judged against the
        current roster (a retired site neither counts as alive nor raises
        the need; a joiner extends both)."""
        quorum = self.cache.get("site_quorum")
        if not quorum:
            raise exc
        self.dead_sites.add(s)
        self.site_failures[s] = f"{type(exc).__name__}: {exc}"
        rec = self._recorder()
        rec.event("site_died", cat="quorum", site=s, error=self.site_failures[s],
                  attempts=1, retries_exhausted=False)
        logger.warn(f"site {s} died at round {self.rounds} ({self.site_failures[s]}); "
                    "excluded from the remaining rounds (site_quorum set)")
        members = self._member_ids()
        alive = [x for x in members if x not in self.dead_sites]
        need = max(COINNRemote._quorum_need(quorum, len(members)), 1)
        if len(alive) < need:
            rec.event("quorum:fail", cat="quorum", reason="quorum unmet", alive=alive,
                      need=need, dropped=sorted(self.dead_sites))
            raise RuntimeError(
                f"quorum unmet: {len(alive)} sites alive, quorum {quorum} of "
                f"{len(members)} roster members requires >= {need}; "
                f"dead: {sorted(self.dead_sites)}"
            )
        rec.event("quorum:continue", cat="quorum", alive=alive,
                  dropped=sorted(self.dead_sites))

    def _round_hook(self, site_batches):
        """The per-site round boundary of the vectorized plane: this
        round's roster operations, then the chaos invoke faults per member,
        then the roster mask — dead, retired and spare slots become
        fully-masked placeholders, so the step's shape never changes.
        Each hook closes the previous round on the engine lane: an
        ``engine:round`` span (hook to hook), the ``rounds_per_sec`` and
        ``sites_per_sec`` metrics and one device-memory sample."""
        rec = self._recorder()
        now_wall, now = time.time(), time.perf_counter()
        prev, self._round_t = self._round_t, (now_wall, now)
        if prev is not None and rec.enabled:
            dt = now - prev[1]
            rec.record_span("engine:round", prev[0], dt, cat="engine", round=self.rounds)
            if dt > 0:
                alive = len([s for s in self._member_ids() if s not in self.dead_sites])
                rec.metric(Metric.ROUNDS_PER_SEC, 1.0 / dt, round=self.rounds)
                rec.metric(Metric.SITES_PER_SEC, alive / dt, round=self.rounds)
            trainer = self._trainer
            _perf.sample_device_memory(
                self.cache, recorder=rec, device=self.device,
                census=trainer._memory_census if trainer is not None else None)
        self.rounds += 1
        rec.set_context(round=self.rounds)
        # roster operations first: they re-scope the roster before faults
        # fire and the mask applies
        self._membership_round(rec)
        members = self._member_ids()
        if rec.enabled:
            # one liveness pulse per round, not per site
            rec.event(Live.HEARTBEAT, cat="engine",
                      alive=len([s for s in members if s not in self.dead_sites]))
        try:
            for s in members:
                if s in self.dead_sites:
                    continue
                try:
                    self.chaos.invoke_fault(self.rounds, s, rec)
                except ChaosFault as exc:
                    self._site_failure(s, exc)
            if all(s in self.dead_sites for s in self._member_ids()):
                raise RuntimeError(f"every roster member died; failures: {self.site_failures}")
        finally:
            # no node flushes the lane here, so the engine does, also on a
            # quorum-unmet abort, whose records are the postmortem
            rec.flush()
        masked = self.dead_sites | self.left_sites | self.spare_sites
        if masked:
            for i, s in enumerate(self.site_ids):
                if s in masked and site_batches[i] is not None:
                    site_batches[i] = [{**b, "_mask": np.zeros_like(np.asarray(b["_mask"]))}
                                       for b in site_batches[i]]
        return site_batches

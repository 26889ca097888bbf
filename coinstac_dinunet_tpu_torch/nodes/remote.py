"""COINNRemote — the aggregator phase state machine (PyTorch port).

Port of the JAX package's ``nodes/remote.py`` for the lockstep path:
adopts ``shared_args`` from the first site, builds the fold queue,
broadcasts the pretrain site's weights (PRE_COMPUTATION), reduces with the
``agg_engine``'s reducer (dSGD, PowerSGD or rankDAD) when every site
reports ``reduce``, runs the epoch/validation
barriers over the ``*_WAITING`` modes, merges cross-site scores exactly
(count merge), signals best-checkpoint saves, early-stops, rotates folds,
and finally reduces the global test scores, writes the CSV/JSON logs and
ships a results zip.  Every broadcast carries the ``wire_round`` stamp and
the ``roster_epoch``, and every site must echo both.

Elastic membership (``federation/membership.py``), before anything else
reads the round's input: payloads the roster refuses (a non-member, an
echo older than the site's admission) are dropped, the engine's admission
requests become admission records (``admissions``, with the donor's
warm-start weights relayed through the pretrain broadcast's path), and
after the reduce a site that flagged ``leaving`` is retired.  The roster
record is made at INIT.

Quorum: a site missing from the round's input raises on every
invocation unless ``cache['site_quorum']`` is set (an integral value >= 1
is a minimum alive-site count, ``1.0`` included; a fraction in (0, 1) a
share of the current roster); with it the survivors go on, a dropped site
stays dropped (``cache['dropped_sites']``) until it is re-admitted, and its
output is filtered out if it reappears.  A joiner whose first contribution
has not arrived yet counts neither as dropped nor in the need.  Async
rounds: with ``cache['async_staleness'] = k`` and ``cache['run_ahead'] =
d`` the round-stamp check accepts an echo lagging by ``1..k+d`` rounds and
records it in ``cache['site_staleness']``, which the reducer's
``gamma**lag`` discount reads; an echoed roster epoch ahead of the
aggregator's is refused.  The decisions land as ``quorum:drop``,
``quorum:continue``, ``quorum:fail``, ``async:window`` and
``membership:*`` records on the ambient recorder
(``telemetry.get_active()``).

Telemetry, as in the JAX package: with ``profile`` (or ``telemetry``) in
the aggregator's cache (it adopts ``shared_args``), every invocation bumps
``cache['telemetry_round']`` and records into the remote lane,
``telemetry.remote.jsonl`` in its output directory — a ``remote:round``
span, ``remote:reduce``/``remote:epoch_end``/``remote:run_end`` spans, the
quorum, window, membership and reduce records above, the reducer's
site-agreement series, the global ``val_score`` at every epoch barrier,
and the watchdog's anomalies (with ``quarantine_on_anomaly``, the
quarantine: ``cache['quarantined_sites']``).  The federation's health
rollup — the aggregator's own findings merged with every site's shipped
summary — is broadcast as ``RemoteWire.HEALTH``, and each site's reported
samples/s refreshes ``cache['site_capacity']`` (the capacity weighting's
data).

The training curves (``vision/plotter.py``): one PNG per log at the
epochs ``lazy_debug`` picks and at the end of every fold, as in the JAX
package.  What differs: where matplotlib does not import, the plot is
skipped (once logged, one ``plot:skipped`` event) and the run goes on.
"""
import datetime
import math
import os
import shutil
import traceback

from .. import config, telemetry, utils
from ..config.keys import (
    AggEngine,
    Federation,
    GatherMode,
    Key,
    LocalWire,
    Membership,
    Metric,
    Mode,
    Phase,
    RemoteWire,
)
from ..data import EmptyDataHandle
from ..parallel import COINNReducer, DADReducer, PowerSGDReducer
from ..resilience import transport as wire_transport
from ..utils import logger
from ..vision import plotter
from ..utils.utils import performance_improved_, stop_training_
from . import check, gather


class COINNRemote:
    """The aggregator node."""

    def __init__(self, cache=None, input=None, state=None, verbose=False,
                 device=None, **kw):
        self.out = {}
        self.device = config.resolve_device(device)
        self.cache = cache if cache is not None else {}
        self.cache.update(**kw)
        self.input = utils.FrozenDict(input or {})
        self.state = utils.FrozenDict(state or {})
        self.cache.setdefault("verbose", verbose)
        if not self.cache.get(Key.ARGS_CACHED) and self.input:
            site = next(iter(self.input.values()))
            if LocalWire.SHARED_ARGS.value in site:
                self.cache.update(**site[LocalWire.SHARED_ARGS.value])
                self.cache[Key.ARGS_CACHED.value] = True

    # ------------------------------------------------------ elastic membership
    def _check_membership(self):
        """The roster round, before the quorum check and before anything
        takes ``self.input``: refuse payloads by roster epoch (a non-member,
        an echo older than the site's admission), then turn the engine's
        admission requests into admission records, broadcast this round
        with the donor's warm-start weights (the pretrain broadcast's
        path).  Retirement of graceful leavers runs at the end of
        :meth:`compute`, after the reduce counted their last payload."""
        from ..federation import membership

        filtered, refused = membership.filter_membership(self.cache, dict(self.input))
        if refused:
            self.input = utils.FrozenDict(filtered)
        self._admissions = membership.process_admissions(self.cache)
        if self._admissions:
            self.out[RemoteWire.ADMISSIONS.value] = self._admissions
            self.out.update(**self._pre_compute())

    # ---------------------------------------------------------- site dropout
    @staticmethod
    def _quorum_need(quorum, roster_size):
        """``site_quorum`` as a minimum alive-site COUNT: any integral value
        >= 1 (``1``, ``1.0``, ``2.0``) is a count, a fraction strictly in
        (0, 1) is that share of the current roster (``ceil``); anything
        else (``1.5``, values <= 0) is a configuration error."""
        q = float(quorum)
        if 0.0 < q < 1.0:
            return int(math.ceil(q * roster_size))
        if q >= 1.0 and q == int(q):
            return int(q)
        raise ValueError(
            f"site_quorum {quorum!r} is ambiguous: use an integral value "
            ">= 1 for a minimum alive-site count, or a fraction strictly "
            "in (0, 1) for a share of the initial roster"
        )

    def _check_quorum(self):
        """The site-participation contract, at every invocation.  A site
        missing from the round's input raises with the dropped list — on
        EVERY invocation, so a re-invocation can never go on survivor-
        weighted without a policy — unless ``cache['site_quorum']`` is set:
        then the survivors go on as long as the quorum holds (the reduce is
        participation-weighted, so the mean is the survivors' mean).  Once
        dropped, a site stays dropped until it is re-admitted: a reappearing
        site's output is filtered out of the round (its round state is
        stale).  The roster is the current one (``all_sites`` mirrors the
        membership record); a joiner whose first contribution is still on
        its way is left out of it."""
        roster = self.cache.get("all_sites")
        if not roster:
            return
        joining = set((self.cache.get(Membership.ROSTER) or {}).get("joining") or ())
        if joining:
            roster = [s for s in roster if s not in joining]
            if not roster:
                return
        prev = set(self.cache.get("dropped_sites", []))
        returned = prev & set(self.input.keys())
        if returned:
            logger.warn(
                f"sites {sorted(returned)} reappeared after being dropped; "
                "ignoring their output (their round state is stale)"
            )
            self.input = utils.FrozenDict({
                k: v for k, v in self.input.items() if k not in prev
            })
        alive = set(self.input.keys())
        dropped = sorted((set(roster) - alive) | prev)
        if not dropped:
            return
        quorum = self.cache.get("site_quorum")
        new_drops = sorted(set(dropped) - prev)
        if not new_drops and quorum:
            # judged (and recorded) the round the drop happened
            return
        rec = telemetry.get_active()
        if new_drops:
            self.cache["dropped_sites"] = dropped
            rec.event("quorum:drop", cat="quorum", sites=new_drops,
                      alive=sorted(alive), quorum=quorum)
        if not quorum:
            rec.event("quorum:fail", cat="quorum", reason="no site_quorum policy",
                      dropped=dropped)
            raise RuntimeError(
                f"sites {dropped} stopped reporting (round input has "
                f"{sorted(alive)} of {roster}).  The default contract is "
                "all-site lockstep; set cache['site_quorum'] (min alive "
                "count, or fraction of the initial roster) to let the run "
                "continue with survivors."
            )
        need = max(self._quorum_need(quorum, len(roster)), 1)
        if len(alive) < need:
            rec.event("quorum:fail", cat="quorum", reason="quorum unmet",
                      alive=sorted(alive), need=need, dropped=dropped)
            raise RuntimeError(
                f"quorum unmet: {len(alive)} sites alive ({sorted(alive)}), "
                f"quorum {quorum} of {len(roster)} requires >= {need}; "
                f"dropped: {dropped}"
            )
        rec.event("quorum:continue", cat="quorum", alive=sorted(alive), dropped=dropped)
        logger.warn(
            f"sites {dropped} dropped; continuing with {sorted(alive)} "
            f"(quorum {quorum} satisfied) — aggregates are survivor-weighted "
            "from this round on"
        )

    def _check_lockstep_phases(self):
        """Refuse a round whose sites report mixed phases, or echo a round
        stamp outside the window: exactly the last broadcast's stamp in
        lockstep, a lag of ``1..k+d`` under async rounds (``k`` =
        ``cache['async_staleness']``, ``d`` = ``cache['run_ahead']``: a
        fresh contribution computed ahead of a broadcast still in flight
        echoes the one it consumed).  An accepted lag lands in
        ``cache['site_staleness']`` (empty on a fresh round) for the
        reducer's discount; an echo older than the window, or ahead of the
        stamp, is a stale or duplicated message.  An echoed roster epoch
        ahead of the aggregator's is a cross-run or forged message."""
        rec = telemetry.get_active()
        phases = {site_vars.get(LocalWire.PHASE.value) for site_vars in self.input.values()}
        if len(phases) > 1:
            per_site = {s: site_vars.get(LocalWire.PHASE.value)
                        for s, site_vars in self.input.items()}
            rec.event("quorum:fail", cat="quorum", reason="mixed phases", phases=per_site)
            raise RuntimeError(
                f"lockstep phase violation: sites report mixed phases "
                f"{per_site} — a stale or duplicated round message"
            )
        expected = self.cache.get("wire_round")
        if expected is not None:
            self._check_round_window(rec, expected)
        self._check_roster_epochs(rec)

    def _check_round_window(self, rec, expected):
        window = int(self.cache.get(Federation.ASYNC_STALENESS) or 0)
        window += int(self.cache.get(Federation.RUN_AHEAD) or 0)
        stale, behind = {}, {}
        for site, site_vars in self.input.items():
            echo = site_vars.get(LocalWire.ROUND.value)
            if echo is None:
                continue
            lag = int(expected) - int(echo)
            if lag == 0:
                continue
            if 0 < lag <= window:
                stale[site] = lag
            else:
                behind[site] = int(echo)
        if behind:
            rec.event("quorum:fail", cat="quorum", reason="stale round echo",
                      expected=int(expected), behind=behind, window=window)
            raise RuntimeError(
                f"lockstep round violation: expected every site to echo round "
                f"{int(expected)}" + (f" (staleness window {window})" if window else "")
                + f" but got {behind} — a stale or duplicated site message"
            )
        self.cache["site_staleness"] = stale
        if stale:
            rec.event("async:window", cat="async", expected=int(expected),
                      stale=stale, window=window)
            for site, lag in sorted(stale.items()):
                rec.metric(Metric.SITE_STALENESS, float(lag), site=site)

    def _check_roster_epochs(self, rec):
        """Refuse a round in which a site echoes a roster epoch ahead of
        the aggregator's (a lagging echo is legitimate: epoch bumps overtake
        rounds in flight; one older than the site's admission was refused by
        the membership filter already)."""
        cur = (self.cache.get(Membership.ROSTER) or {}).get("epoch")
        if cur is None:
            return
        ahead = {site: int(site_vars[LocalWire.ROSTER_EPOCH.value])
                 for site, site_vars in self.input.items()
                 if site_vars.get(LocalWire.ROSTER_EPOCH.value) is not None
                 and int(site_vars[LocalWire.ROSTER_EPOCH.value]) > int(cur)}
        if ahead:
            rec.event("quorum:fail", cat="quorum", reason="roster epoch ahead",
                      epoch=int(cur), ahead=ahead)
            raise RuntimeError(
                f"roster epoch violation: sites {ahead} echo a roster epoch ahead of "
                f"the aggregator's ({int(cur)}) — a cross-run or forged membership "
                "message; refusing to aggregate"
            )

    # ------------------------------------------------------------- run set-up
    def _init_runs(self):
        if self.cache.get("seed") is None:
            self.cache["seed"] = config.current_seed
        # the engines seed the founding roster; the membership record starts
        # from it at epoch 1, and all_sites mirrors its members from here on
        self.cache.setdefault("all_sites", sorted(self.input.keys()))
        from ..federation import membership

        roster = membership.MembershipRoster.load(self.cache)
        if roster is not None:
            roster.save(self.cache)
        self.cache[Key.GLOBAL_TEST_SERIALIZABLE.value] = []
        self.cache["data_size"] = {
            site: site_vars.get(LocalWire.DATA_SIZE.value)
            for site, site_vars in self.input.items()
        }
        self.cache["folds"] = [
            {"split_ix": str(fold), "seed": self.cache["seed"]}
            for fold in range(int(self.cache["num_folds"]))
        ][::-1]

    def _next_run(self, trainer):
        """Pop a fold; build per-site run assignments (every site pads to
        the global max batches per epoch: lockstep epochs)."""
        self.cache["fold"] = self.cache["folds"].pop()
        split_ix = self.cache["fold"]["split_ix"]
        self.cache["log_dir"] = os.path.join(
            self.state.get("outputDirectory", "."),
            str(self.cache["task_id"]),
            f"fold_{split_ix}",
        )
        os.makedirs(self.cache["log_dir"], exist_ok=True)
        self.cache.update(epoch=0, best_val_epoch=0, best_val_score=None)
        self.cache[Key.TRAIN_LOG.value] = []
        self.cache[Key.VALIDATION_LOG.value] = []
        self.cache[Key.TEST_METRICS.value] = []

        # a site admitted mid-run has no INIT size probe: never the
        # pretrain site, never the pace
        train_sizes = {
            site: (self.cache["data_size"].get(site) or {})
            .get(split_ix, {})
            .get("train", 0)
            for site in self.input
        }
        max_data_site = max(train_sizes, key=train_sizes.get)
        batch_size = int(self.cache.get("batch_size", 16))
        target_batches = max(
            (math.ceil(n / batch_size) for n in train_sizes.values() if n),
            default=1,
        )
        self.cache["target_batches"] = target_batches
        out = {}
        for site in self.input:
            fold = {**self.cache["fold"]}
            fold["pretrain"] = site == max_data_site
            fold["target_batches"] = target_batches
            out[site] = fold
        return out

    # --------------------------------------------------------- score handling
    def _reduce_serialized(self, trainer, payloads):
        """Exact cross-site reduction of serialized {averages, metrics}."""
        pairs = gather(["averages", "metrics"], payloads, GatherMode.APPEND)
        averages = trainer.new_averages().reduce_sites(pairs["averages"])
        metrics = trainer.new_metrics().reduce_sites(pairs["metrics"])
        return averages, metrics

    def _accumulate_epoch_info(self, trainer):
        train = gather(
            [Key.TRAIN_SERIALIZABLE.value], self.input.values(), GatherMode.EXTEND
        )[Key.TRAIN_SERIALIZABLE.value]
        val = gather(
            [Key.VALIDATION_SERIALIZABLE.value], self.input.values(), GatherMode.EXTEND
        )[Key.VALIDATION_SERIALIZABLE.value]
        t_avg, t_met = self._reduce_serialized(trainer, train)
        v_avg, v_met = self._reduce_serialized(trainer, val)
        return {
            "train_averages": t_avg, "train_metrics": t_met,
            "val_averages": v_avg, "val_metrics": v_met,
        }

    def _on_epoch_end(self, trainer):
        info = self._accumulate_epoch_info(trainer)
        self.cache[Key.TRAIN_LOG.value].append(
            [*info["train_averages"].get(), *info["train_metrics"].get()]
        )
        self._save_if_better(**info)
        self.cache[Key.VALIDATION_LOG.value].append(
            [*info["val_averages"].get(), *info["val_metrics"].get()]
        )
        if logger.lazy_debug(self.cache["epoch"]):
            self._plot()
        return info

    def _plot(self):
        """The training and validation curves as PNGs in ``log_dir``."""
        plotter.plot_progress(
            self.cache, self.cache["log_dir"],
            plot_keys=[Key.TRAIN_LOG.value, Key.VALIDATION_LOG.value],
            epoch=self.cache.get("epoch"),
        )

    def _save_if_better(self, **info):
        score = info["val_metrics"].extract(self.cache.get("monitor_metric", "f1"))
        rec = telemetry.get_active()
        if rec.enabled:
            # the GLOBAL monitored-metric trajectory (sites record their own)
            telemetry.health.record_val_score(self.cache, score, recorder=rec)
        self.out[RemoteWire.SAVE_CURRENT_AS_BEST.value] = performance_improved_(
            self.cache["epoch"], score, self.cache
        )

    def _next_epoch(self, **info):
        done = self.cache["epoch"] >= int(self.cache.get("epochs", 1))
        if done or stop_training_(self.cache["epoch"], self.cache):
            return Mode.TEST.value
        return Mode.TRAIN.value

    def _on_run_end(self, trainer):
        """Fold finished: reduce + persist its test scores."""
        test = gather(
            [Key.TEST_SERIALIZABLE.value], self.input.values(), GatherMode.EXTEND
        )[Key.TEST_SERIALIZABLE.value]
        averages, metrics = self._reduce_serialized(trainer, test)
        self.cache[Key.TEST_METRICS.value].append([*averages.get(), *metrics.get()])
        self.cache[Key.GLOBAL_TEST_SERIALIZABLE.value].append(
            {"averages": averages.serialize(), "metrics": metrics.serialize()}
        )
        self._plot()
        utils.save_scores(
            self.cache, log_dir=self.cache["log_dir"],
            file_keys=[Key.TEST_METRICS.value],
        )
        utils.save_cache(self.cache, {"outputDirectory": self.cache["log_dir"]})

    def _send_global_scores(self, trainer):
        """All folds done: reduce fold scores, write the CSV, zip the output."""
        out = {}
        averages, metrics = self._reduce_serialized(
            trainer, self.cache[Key.GLOBAL_TEST_SERIALIZABLE.value]
        )
        self.cache["global_test_metrics"] = [[*averages.get(), *metrics.get()]]
        task_dir = os.path.join(
            self.state.get("outputDirectory", "."), str(self.cache["task_id"])
        )
        utils.save_scores(self.cache, log_dir=task_dir, file_keys=["global_test_metrics"])
        stamp = "_".join(str(datetime.datetime.now()).split(" "))
        out[RemoteWire.RESULTS_ZIP.value] = (
            f"{self.cache['task_id']}_{self.cache.get('agg_engine')}_{stamp}"
        )
        shutil.make_archive(
            os.path.join(self.state.get("transferDirectory", "."),
                         out[RemoteWire.RESULTS_ZIP.value]),
            "zip",
            task_dir,
        )
        return out

    def _pre_compute(self):
        """Broadcast the pretrain site's weights: its ``weights_file`` is
        copied, atomically, to ``pretrained_<weights_file>`` in the
        aggregator's transfer directory."""
        out = {}
        for site, site_vars in self.input.items():
            if site_vars.get(LocalWire.WEIGHTS_FILE.value):
                src = os.path.join(self.state.get("baseDirectory", "."), site,
                                   site_vars[LocalWire.WEIGHTS_FILE.value])
                if os.path.exists(src):
                    out[RemoteWire.PRETRAINED_WEIGHTS.value] = f"pretrained_{config.weights_file}"
                    # no site can ever read a half-copied broadcast
                    wire_transport.atomic_copy(
                        src, os.path.join(self.state.get("transferDirectory", "."),
                                          out[RemoteWire.PRETRAINED_WEIGHTS.value]))
                break
        return out

    def _get_reducer_cls(self, reducer_cls=None):
        """The built-in reducer of ``agg_engine``; another engine name takes
        ``reducer_cls`` (default dSGD), as in the JAX package."""
        builtin = {
            AggEngine.DSGD.value: COINNReducer,
            AggEngine.RANK_DAD.value: DADReducer,
            AggEngine.POWER_SGD.value: PowerSGDReducer,
        }
        return builtin.get(str(self.cache.get("agg_engine")), reducer_cls or COINNReducer)

    def _set_mode(self, mode=None):
        return {
            site: (mode if mode else site_vars.get(LocalWire.MODE.value, "N/A"))
            for site, site_vars in self.input.items()
        }

    # -------------------------------------------------------------- main loop
    def compute(self, trainer_cls=None, reducer_cls=None, **kw):
        # the membership and quorum filters run before the trainer and the
        # reducer take self.input: a filtered site must never reach the reduce
        self._check_membership()
        self._check_quorum()
        self._check_lockstep_phases()
        trainer = trainer_cls(
            cache=self.cache, input=self.input, state=self.state,
            data_handle=EmptyDataHandle(cache=self.cache, input=self.input,
                                        state=self.state),
            device=self.device,
        )
        self.out[RemoteWire.PHASE.value] = self.input.get(LocalWire.PHASE.value, Phase.INIT_RUNS.value)

        if check(all, LocalWire.PHASE.value, Phase.INIT_RUNS.value, self.input):
            self._init_runs()
            self.out[RemoteWire.GLOBAL_RUNS.value] = self._next_run(trainer)
            self.out[RemoteWire.PHASE.value] = Phase.NEXT_RUN.value

        if check(all, LocalWire.PHASE.value, Phase.PRE_COMPUTATION.value, self.input):
            self.out.update(**self._pre_compute())
            self.out[RemoteWire.PHASE.value] = Phase.PRE_COMPUTATION.value

        # the lockstep round stamp, committed to the cache only at the end
        self.out[RemoteWire.ROUND.value] = int(self.cache.get("wire_round") or 0) + 1
        roster = self.cache.get(Membership.ROSTER)
        if isinstance(roster, dict) and "epoch" in roster:
            self.out[RemoteWire.ROSTER_EPOCH.value] = int(roster["epoch"])

        rec = telemetry.get_active()
        self.out[RemoteWire.GLOBAL_MODES.value] = self._set_mode()
        if check(all, LocalWire.PHASE.value, Phase.COMPUTATION.value, self.input):
            reducer = self._get_reducer_cls(reducer_cls)(trainer=trainer)
            self.out[RemoteWire.PHASE.value] = Phase.COMPUTATION.value
            if check(all, LocalWire.REDUCE.value, True, self.input):
                with rec.span("remote:reduce", cat="reduce",
                              engine=str(self.cache.get("agg_engine")), sites=len(self.input)):
                    self.out.update(**reducer.reduce())

            if check(all, LocalWire.MODE.value, Mode.VALIDATION_WAITING.value, self.input):
                self.cache["epoch"] += 1
                if self.cache["epoch"] % int(self.cache.get("validation_epochs", 1)) == 0:
                    self.out[RemoteWire.GLOBAL_MODES.value] = self._set_mode(Mode.VALIDATION.value)
                else:
                    self.out[RemoteWire.GLOBAL_MODES.value] = self._set_mode(Mode.TRAIN.value)

            if check(all, LocalWire.MODE.value, Mode.TRAIN_WAITING.value, self.input):
                with rec.span("remote:epoch_end", cat="barrier"):
                    info = self._on_epoch_end(trainer)
                self.out[RemoteWire.GLOBAL_MODES.value] = self._set_mode(self._next_epoch(**info))

        if check(all, LocalWire.PHASE.value, Phase.NEXT_RUN_WAITING.value, self.input):
            with rec.span("remote:run_end", cat="barrier"):
                self._on_run_end(trainer)
            if self.cache["folds"]:
                self.out[RemoteWire.GLOBAL_RUNS.value] = self._next_run(trainer)
                self.out[RemoteWire.PHASE.value] = Phase.NEXT_RUN.value
            else:
                self.out.update(**self._send_global_scores(trainer))
                self.out[RemoteWire.PHASE.value] = Phase.SUCCESS.value

        # graceful leavers retire after every block above consumed their
        # last contribution
        from ..federation import membership

        membership.retire_leaving(self.cache, {
            site: site_vars for site, site_vars in self.input.items()
            if site_vars.get(LocalWire.LEAVING.value)
        })
        if rec.enabled:
            self._broadcast_health(rec)
        # background commits land, or fail this invocation, before the output
        # JSON naming the broadcast files leaves the node
        wire_transport.flush_async()
        self.cache["wire_round"] = self.out[RemoteWire.ROUND.value]
        return self.out

    def _broadcast_health(self, rec):
        """The federation's health rollup: the aggregator's own watchdog
        findings (reduce-side nonfinite, divergence, stall) merged with every
        site's shipped summary, broadcast so each site can warn (and learn
        it was quarantined); each site's reported samples/s refreshes
        ``cache['site_capacity']``."""
        fed = dict(telemetry.Watchdog(self.cache, rec).summary())
        per_site, caps = {}, {}
        for site, site_vars in self.input.items():
            h = site_vars.get(LocalWire.HEALTH.value)
            if h:
                entry = {"counts": h.get("counts", {})}
                if h.get("perf"):
                    entry["perf"] = h["perf"]
                    sps = h["perf"].get("samples_per_sec")
                    if sps:
                        caps[site] = float(sps)
                per_site[site] = entry
        if caps:
            cap_rec = dict(self.cache.get(Membership.SITE_CAPACITY) or {})
            cap_rec.update(caps)
            self.cache[Membership.SITE_CAPACITY] = cap_rec
        if per_site:
            fed["sites"] = per_site
        if fed:
            self.out[RemoteWire.HEALTH.value] = fed

    def __call__(self, *a, **kw):
        # the remote lane (cache['profile'] or cache['telemetry']): the
        # ambient recorder of the whole invocation
        rec = telemetry.Recorder.for_node(self.cache, self.state, node="remote")
        rec.begin_invocation()
        try:
            with telemetry.activate(rec), rec.span("remote:round", cat="node"):
                self.compute(*a, **kw)
        except NotImplementedError:
            raise
        except Exception as exc:
            rec.event("node_error", cat="error", error=f"{type(exc).__name__}: {exc}")
            traceback.print_exc()
            raise RuntimeError(
                f"Remote node failed ({type(exc).__name__}: {exc}) with "
                f"partial out: {self.out}"
            ) from exc
        finally:
            for exc in wire_transport.flush_async(raise_errors=False):
                logger.warn(f"async wire commit failed: {exc}")
            rec.flush()
        return {
            "output": self.out,
            "success": check(all, LocalWire.PHASE.value, Phase.SUCCESS.value, self.input),
            "cache": utils.clean_recursive({
                k: v for k, v in dict(self.cache).items()
                if not str(k).startswith("_")
            }),
        }

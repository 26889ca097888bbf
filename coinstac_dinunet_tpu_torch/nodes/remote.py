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
the (fixed) ``roster_epoch``, and every site must echo the stamp.

What differs from the JAX package: the training-curve PNGs
(``vision/plotter``) are not drawn — the CSV/JSON logs are the same.  Not
ported yet: quorum (a missing site fails the round), async windows,
elastic membership (and its reuse of the broadcast), health rollups.
"""
import datetime
import math
import os
import shutil
import traceback

from .. import config, utils
from ..config.keys import AggEngine, GatherMode, Key, LocalWire, Mode, Phase, RemoteWire
from ..data import EmptyDataHandle
from ..parallel import COINNReducer, DADReducer, PowerSGDReducer
from ..resilience import transport as wire_transport
from ..utils.utils import performance_improved_, stop_training_
from . import check, gather
from .local import refuse_unported

#: the roster epoch every broadcast carries: without elastic membership the
#: founding roster never changes
ROSTER_EPOCH = 1


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
        refuse_unported(self.cache)

    def _check_roster(self):
        """All-site lockstep: a site missing from the round fails it."""
        roster = self.cache.get("all_sites")
        missing = sorted(set(roster or ()) - set(self.input))
        if missing:
            raise RuntimeError(
                f"sites {missing} stopped reporting (round input has "
                f"{sorted(self.input)} of {roster}); quorum policies are not "
                "ported yet (ROADMAP.md Queue 1: the other engines and their "
                "options)"
            )

    def _check_lockstep_phases(self):
        """Refuse a round whose sites report mixed phases, or echo a round
        stamp other than the one broadcast last (a stale or duplicated
        message)."""
        phases = {sv.get(LocalWire.PHASE.value) for sv in self.input.values()}
        if len(phases) > 1:
            per_site = {s: sv.get(LocalWire.PHASE.value) for s, sv in self.input.items()}
            raise RuntimeError(
                f"lockstep phase violation: sites report mixed phases "
                f"{per_site} — a stale or duplicated round message"
            )
        expected = self.cache.get("wire_round")
        if expected is None:
            return
        behind = {
            s: int(sv[LocalWire.ROUND.value]) for s, sv in self.input.items()
            if sv.get(LocalWire.ROUND.value) is not None
            and int(sv[LocalWire.ROUND.value]) != int(expected)
        }
        if behind:
            raise RuntimeError(
                f"lockstep round violation: expected every site to echo round "
                f"{int(expected)} but got {behind} — a stale or duplicated "
                "site message"
            )

    # ------------------------------------------------------------- run set-up
    def _init_runs(self):
        if self.cache.get("seed") is None:
            self.cache["seed"] = config.current_seed
        self.cache.setdefault("all_sites", sorted(self.input.keys()))
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
        return info

    def _save_if_better(self, **info):
        score = info["val_metrics"].extract(self.cache.get("monitor_metric", "f1"))
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
        self._check_roster()
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
        self.out[RemoteWire.ROSTER_EPOCH.value] = ROSTER_EPOCH

        self.out[RemoteWire.GLOBAL_MODES.value] = self._set_mode()
        if check(all, LocalWire.PHASE.value, Phase.COMPUTATION.value, self.input):
            reducer = self._get_reducer_cls(reducer_cls)(trainer=trainer)
            self.out[RemoteWire.PHASE.value] = Phase.COMPUTATION.value
            if check(all, LocalWire.REDUCE.value, True, self.input):
                self.out.update(**reducer.reduce())

            if check(all, LocalWire.MODE.value, Mode.VALIDATION_WAITING.value, self.input):
                self.cache["epoch"] += 1
                if self.cache["epoch"] % int(self.cache.get("validation_epochs", 1)) == 0:
                    self.out[RemoteWire.GLOBAL_MODES.value] = self._set_mode(Mode.VALIDATION.value)
                else:
                    self.out[RemoteWire.GLOBAL_MODES.value] = self._set_mode(Mode.TRAIN.value)

            if check(all, LocalWire.MODE.value, Mode.TRAIN_WAITING.value, self.input):
                info = self._on_epoch_end(trainer)
                self.out[RemoteWire.GLOBAL_MODES.value] = self._set_mode(self._next_epoch(**info))

        if check(all, LocalWire.PHASE.value, Phase.NEXT_RUN_WAITING.value, self.input):
            self._on_run_end(trainer)
            if self.cache["folds"]:
                self.out[RemoteWire.GLOBAL_RUNS.value] = self._next_run(trainer)
                self.out[RemoteWire.PHASE.value] = Phase.NEXT_RUN.value
            else:
                self.out.update(**self._send_global_scores(trainer))
                self.out[RemoteWire.PHASE.value] = Phase.SUCCESS.value

        self.cache["wire_round"] = self.out[RemoteWire.ROUND.value]
        return self.out

    def __call__(self, *a, **kw):
        try:
            self.compute(*a, **kw)
        except NotImplementedError:
            raise
        except Exception as exc:
            traceback.print_exc()
            raise RuntimeError(
                f"Remote node failed ({type(exc).__name__}: {exc}) with "
                f"partial out: {self.out}"
            ) from exc
        return {
            "output": self.out,
            "success": check(all, LocalWire.PHASE.value, Phase.SUCCESS.value, self.input),
            "cache": utils.clean_recursive({
                k: v for k, v in dict(self.cache).items()
                if not str(k).startswith("_")
            }),
        }

"""COINNLocal — the site-side phase state machine (PyTorch port).

Port of the JAX package's ``nodes/local.py`` for the lockstep path: the
first invocation resolves the three-tier argument override (engine
``input`` > ``<task_id>_args`` > ``<agg_engine>_args`` > constructor
defaults) and freezes a ``shared_args`` snapshot for the aggregator; every
invocation then advances INIT_RUNS → NEXT_RUN [→ PRE_COMPUTATION] →
COMPUTATION → NEXT_RUN_WAITING → SUCCESS, echoing the aggregator's
``wire_round`` and ``roster_epoch`` stamps.  ``agg_engine`` picks the
learner (dSGD, PowerSGD or rankDAD).  With ``pretrain_args.epochs > 0`` the
designated site trains locally first, and in PRE_COMPUTATION every site
loads the weights the aggregator broadcast.  The live train state (models,
optimizers, generator) persists in ``cache['_train_state']`` between
invocations of a persistent process.  An engine that runs every invocation
in a fresh process keeps only the JSON cache: with
``cache['persist_round_state']`` the live state (and the aggregation
engine's, and the epoch's score accumulators) goes to a round file in the
site's output directory after every invocation and comes back from it in
the next; without it a mid-run invocation that finds no live state raises.
Every validation barrier writes a full resume point (``autosave_epochs``,
default every epoch), from which ``cache['resume']`` rebuilds a site that
lost its cache.

Not ported yet, and refused with the ROADMAP item named: quorum, async
rounds and run-ahead, the tree fan-in, quarantine, elastic membership.
"""
import json
import os
import shutil
import time
import traceback

from .. import config, utils
from ..config.keys import AggEngine, Key, LocalWire, Mode, Phase, RemoteWire
from ..data import COINNDataHandle
from ..parallel import COINNLearner, DADLearner, PowerSGDLearner, powersgd, rankdad
from ..utils import logger

# engine/epoch state cleared on every fold transition
_EPHEMERAL_KEYS = (
    "_powersgd_state", "_rankdad_state", "_ep_averages", "_ep_metrics",
    "_train_state", "cursor", "epoch",
)

# options of the JAX package this slice does not carry: any set value is
# refused rather than silently ignored
_UNPORTED_ARGS = (
    "site_quorum", "quarantine_on_anomaly", "reduce_fanin", "async_staleness",
    "async_invoke_pool", "async_stale_discount", "run_ahead",
)


def refuse_unported(cache):
    """Raise NotImplementedError for a configured option this slice of the
    port does not carry."""
    for key in _UNPORTED_ARGS:
        if cache.get(key):
            raise NotImplementedError(
                f"{key} is not ported yet (ROADMAP.md Queue 1: the other "
                "engines and their options)"
            )


class COINNLocal:
    """One federated site."""

    _ARG_DEFAULTS = dict(
        task_id="task",
        mode=Mode.TRAIN.value,
        batch_size=16,
        local_iterations=1,
        epochs=31,
        validation_epochs=1,
        learning_rate=1e-3,
        load_limit=None,
        load_sparse=False,
        pretrained_path=None,
        pretrain_args=None,
        patience=None,
        num_folds=None,
        split_ratio=None,
        split_files=None,
        monitor_metric="f1",
        metric_direction="maximize",
        log_header="loss|precision,recall,f1,accuracy",
        agg_engine=AggEngine.DSGD.value,
        precision_bits=config.default_precision_bits,
        num_classes=2,
        num_averages=1,
        seed=None,
        verbose=False,
        # the JAX package freezes these into shared_args too; the port
        # keeps the keys (the protocol) and refuses set values
        site_quorum=None,
        quarantine_on_anomaly=None,
        reduce_fanin=None,
        async_staleness=None,
        async_invoke_pool=None,
        async_stale_discount=None,
        run_ahead=None,
        matrix_approximation_rank=1,
        start_powerSGD_iter=10,
        dad_reduction_rank=10,
        dad_num_pow_iters=5,
        dataloader_args=None,
    )

    def __init__(self, cache=None, input=None, state=None, device=None, **kw):
        self.out = {}
        self.device = config.resolve_device(device)
        self.cache = cache if cache is not None else {}
        self.input = utils.FrozenDict(input or {})
        self.state = utils.FrozenDict(state or {})
        self._args = dict(self._ARG_DEFAULTS)
        for k, v in kw.items():
            self._args[k] = v  # constructor overrides become new defaults
        if not self.cache.get(Key.ARGS_CACHED):
            self._resolve_args()
            self.cache[Key.ARGS_CACHED.value] = True
        refuse_unported(self.cache)

    def _resolve_args(self):
        """Three-tier override, highest priority last."""
        args = dict(self._args)
        task_id = self.input.get("task_id", args.get("task_id"))
        args.update(self.input.get(f"{args.get('agg_engine')}_args", {}) or {})
        args.update(self.input.get(f"{task_id}_args", {}) or {})
        for k in self._args:
            if k in self.input:
                args[k] = self.input[k]
        data_conf = self.input.get(
            f"{task_id}_data_conf", self.input.get("data_conf", {})
        )
        self.cache.update(args)
        self.cache["data_conf"] = dict(data_conf or {})
        if self.cache.get("seed") is None:
            self.cache["seed"] = config.current_seed
        self.cache.setdefault("cursor", 0)
        self.cache.setdefault("epoch", 0)

    # ------------------------------------------------------------ phase logic
    def _init_runs(self, trainer):
        """Create splits, probe data sizes, share frozen args."""
        import json

        out = {}
        trainer.data_handle.prepare_data()
        self.cache["num_folds"] = len(self.cache["splits"])
        out[LocalWire.DATA_SIZE.value] = {}
        for k, sp in self.cache["splits"].items():
            with open(os.path.join(self.cache["split_dir"], sp)) as f:
                split = json.load(f)
            out[LocalWire.DATA_SIZE.value][k] = {key: len(split.get(key, [])) for key in split}
        frozen = {k: self.cache.get(k) for k in self._args}
        frozen["num_folds"] = self.cache["num_folds"]
        self.cache["frozen_args"] = frozen
        out[LocalWire.SHARED_ARGS.value] = utils.clean_recursive(frozen)
        return out

    def _next_run(self, trainer):
        """Per-fold re-initialization."""
        out = {}
        for k in _EPHEMERAL_KEYS:
            self.cache.pop(k, None)
        self.cache.update(cursor=0, epoch=0)
        self.cache[Key.TRAIN_SERIALIZABLE.value] = []
        self.cache["split_file"] = self.cache["splits"][str(self.cache["split_ix"])]
        self.cache["log_dir"] = os.path.join(
            self.state.get("outputDirectory", "."),
            str(self.cache["task_id"]),
            f"fold_{self.cache['split_ix']}",
        )
        os.makedirs(self.cache["log_dir"], exist_ok=True)
        tag = f"{self.cache['task_id']}-{self.cache['split_ix']}"
        self.cache["best_nn_state"] = f"best.{tag}.ckpt"
        self.cache["latest_nn_state"] = f"latest.{tag}.ckpt"
        trainer.init_nn()
        out[LocalWire.PHASE.value] = Phase.COMPUTATION.value
        return out

    def _pretrain_local(self, trainer):
        """The designated site trains locally (``pretrain_args``) and
        advertises its best weights, which the aggregator broadcasts."""
        out = {LocalWire.PHASE.value: Phase.COMPUTATION.value}
        pretrain_args = self.cache.get("pretrain_args") or {}
        epochs = int(pretrain_args.get("epochs", 0))
        any_pretrains = epochs > 0 and any(
            r.get("pretrain") for r in self.input.get(RemoteWire.GLOBAL_RUNS.value, {}).values()
        )
        if epochs > 0 and self.cache.get("pretrain"):
            saved = {k: self.cache.get(k) for k in ("epochs", "pretrain")}
            self.cache.update(pretrain_args)
            self.cache["pretrain"] = True
            trainer.train_local(
                trainer.data_handle.get_train_dataset(),
                trainer.data_handle.get_validation_dataset(),
            )
            self.cache.update({k: v for k, v in saved.items() if v is not None})
            if self.cache.get("weights_file"):
                out[LocalWire.WEIGHTS_FILE.value] = self.cache["weights_file"]
            out[LocalWire.PHASE.value] = Phase.PRE_COMPUTATION.value
        if any_pretrains:
            out[LocalWire.PHASE.value] = Phase.PRE_COMPUTATION.value
        return out

    # ------------------------------------------ fresh-process round state
    def _round_state_path(self):
        return os.path.join(self.state.get("outputDirectory", "."), ".round_state.ckpt")

    def _engine_state(self, full):
        """The aggregation engine's carried state for a checkpoint's
        ``extra``: PowerSGD's (with its mid-protocol fields when ``full``)
        and rankDAD's (its start-block generator and plan)."""
        extra = {}
        psgd = self.cache.get(powersgd._STATE_KEY)
        if psgd is not None:
            extra["powersgd"] = psgd.serialize(full=full)
        dad = self.cache.get(rankdad._STATE_KEY)
        if dad is not None:
            extra["rankdad"] = dad.serialize()
        return extra

    def _restore_engine_state(self, extra):
        if "powersgd" in extra:
            self.cache[powersgd._STATE_KEY] = powersgd._PowerSGDState.deserialize(
                extra["powersgd"], device=self.device)
        if "rankdad" in extra:
            self.cache[rankdad._STATE_KEY] = rankdad._DADState.deserialize(
                extra["rankdad"], self.cache.get("seed", 0))

    def _persist_round_state(self, trainer):
        """With ``persist_round_state``: the live state to the round file."""
        if not self.cache.get("persist_round_state") or trainer.train_state is None:
            return
        extra = self._engine_state(full=True)
        # the epoch's train-score accumulators span many rounds (popped at
        # the epoch barrier): raw counts, exact across processes
        for key in ("_ep_averages", "_ep_metrics"):
            if self.cache.get(key) is not None:
                extra[key[1:]] = self.cache[key].serialize()
        trainer.save_checkpoint(full_path=self._round_state_path(), extra=extra)

    def _restore_round_state(self, trainer):
        """Rebuild the live state from the previous invocation's round
        file; True on success."""
        path = self._round_state_path()
        if not (self.cache.get("persist_round_state") and os.path.exists(path)):
            return False
        try:
            trainer.init_nn(init_weights=False)  # the round file fills them
            trainer.load_checkpoint(full_path=path)
        except Exception as exc:  # noqa: BLE001 — a damaged file, of any kind
            logger.warn(f"Unreadable round state {path} ({exc})")
            return False
        extra = trainer.last_checkpoint_extra
        self._restore_engine_state(extra)
        if "ep_averages" in extra:
            self.cache["_ep_averages"] = type(trainer.new_averages()).deserialize(
                extra["ep_averages"])
        if "ep_metrics" in extra:
            self.cache["_ep_metrics"] = type(trainer.new_metrics()).deserialize(
                extra["ep_metrics"])
        self.cache["_train_state"] = trainer.train_state
        return True

    def _midrun_state_lost(self):
        """True when this invocation is mid-run but the live state is gone."""
        return (
            int(self.cache.get("epoch", 0) or 0) > 0
            or int(self.cache.get("cursor", 0) or 0) > 0
            or bool(self.cache.get(Key.TRAIN_SERIALIZABLE.value))
        )

    # ------------------------------------------------------- mid-run resume
    def _resume_pointer(self):
        return os.path.join(self.state.get("outputDirectory", "."), ".resume.json")

    def _barrier_autosave(self, trainer):
        """A full resume point at the epoch barrier, every
        ``autosave_epochs`` epochs (0: never): the latest checkpoint
        (models, optimizers, step, generator), the JSON cache and the
        engine's carried state, then a pointer to it."""
        every = int(self.cache.get("autosave_epochs", 1) or 0)
        if every <= 0 or int(self.cache.get("epoch", 0)) % every != 0:
            return
        snapshot = {k: v for k, v in dict(self.cache).items()
                    if not str(k).startswith("_") and k != "resume"}
        extra = {"site_cache": utils.clean_recursive(snapshot), **self._engine_state(full=False)}
        path = trainer.save_checkpoint(name=self.cache["latest_nn_state"], extra=extra)
        utils.atomic_write(self._resume_pointer(), json.dumps({"checkpoint": path}))

    def _try_resume(self, trainer):
        """A fresh-cache COMPUTATION invocation with ``resume`` set: rebuild
        the site from the last epoch-barrier autosave; True on success."""
        ptr = self._resume_pointer()
        try:
            with open(ptr) as f:
                ckpt = json.load(f)["checkpoint"]
            if not os.path.exists(ckpt):
                return False
            trainer.init_nn()
            trainer.load_checkpoint(full_path=ckpt)
        except FileNotFoundError:
            return False
        except Exception as exc:  # noqa: BLE001 — a damaged file, of any kind
            logger.warn(f"Unreadable resume point {ptr} ({exc}); starting fresh")
            return False
        extra = trainer.last_checkpoint_extra
        snapshot = dict(extra.get("site_cache", {}))
        snapshot.pop("resume", None)
        self.cache.update(snapshot)
        self._restore_engine_state(extra)
        self.cache["_train_state"] = trainer.train_state
        logger.info(f"Resumed site from {ckpt} (epoch {self.cache.get('epoch')})",
                    self.cache.get("verbose", True))
        return True

    def _get_learner_cls(self, learner_cls=None):
        """The built-in learner of ``agg_engine``; another engine name takes
        ``learner_cls`` (default dSGD), as in the JAX package."""
        builtin = {
            AggEngine.DSGD.value: COINNLearner,
            AggEngine.RANK_DAD.value: DADLearner,
            AggEngine.POWER_SGD.value: PowerSGDLearner,
        }
        return builtin.get(str(self.cache.get("agg_engine")), learner_cls or COINNLearner)

    # -------------------------------------------------------------- main loop
    def compute(self, trainer_cls=None, dataset_cls=None,
                datahandle_cls=COINNDataHandle, learner_cls=None, **kw):
        trainer = trainer_cls(
            cache=self.cache, input=self.input, state=self.state,
            data_handle=datahandle_cls(
                cache=self.cache, input=self.input, state=self.state,
                dataset_cls=dataset_cls,
                dataloader_args=self.cache.get("dataloader_args"),
            ),
            device=self.device,
        )

        self.out[LocalWire.PHASE.value] = self.input.get(RemoteWire.PHASE.value, Phase.INIT_RUNS.value)
        if self.out[LocalWire.PHASE.value] == Phase.INIT_RUNS.value:
            self.out.update(**self._init_runs(trainer))

        elif self.out[LocalWire.PHASE.value] == Phase.NEXT_RUN.value:
            self.cache.update(
                **self.input[RemoteWire.GLOBAL_RUNS.value][self.state.get("clientId", "site")]
            )
            self.out.update(**self._next_run(trainer))
            if self.cache.get("mode") == Mode.TRAIN.value:
                self.out.update(**self._pretrain_local(trainer))

        elif self.out[LocalWire.PHASE.value] == Phase.PRE_COMPUTATION.value:
            if self.input.get(RemoteWire.PRETRAINED_WEIGHTS.value):
                trainer.init_nn()
                # a file from the aggregator: a wire checkpoint, never a
                # torch pickle
                trainer.load_checkpoint(
                    full_path=os.path.join(
                        self.state.get("baseDirectory", "."),
                        self.input[RemoteWire.PRETRAINED_WEIGHTS.value],
                    ),
                    load_optimizer=False,
                    allow_torch=False,
                )
                self.cache["_train_state"] = trainer.train_state
            self.out[LocalWire.PHASE.value] = Phase.COMPUTATION.value

        if self.input.get(RemoteWire.ADMISSIONS.value):
            raise NotImplementedError(
                "elastic membership is not ported yet (ROADMAP.md Queue 1: "
                "the other engines and their options)"
            )

        if self.out[LocalWire.PHASE.value] == Phase.COMPUTATION.value and trainer.train_state is None:
            if "_train_state" in self.cache:
                trainer.train_state = self.cache["_train_state"]
            elif self._restore_round_state(trainer):
                pass  # a fresh process: rebuilt from the round file
            elif self.cache.get("resume") and self._try_resume(trainer):
                pass  # rebuilt from the epoch-barrier autosave
            elif self._midrun_state_lost():
                raise RuntimeError(
                    "mid-run invocation (epoch="
                    f"{self.cache.get('epoch')}, cursor="
                    f"{self.cache.get('cursor')}) but the live train state "
                    "is gone: the engine runs each invocation in a fresh "
                    "process.  Set cache['persist_round_state']=true (the "
                    "state on disk after every invocation) or run the node in "
                    "a persistent process; cache['resume']=true recovers "
                    "from the last epoch-barrier autosave only."
                )
            else:
                trainer.init_nn()

        learner = self._get_learner_cls(learner_cls)(trainer=trainer)
        client_id = self.state.get("clientId", "site")
        global_modes = self.input.get(RemoteWire.GLOBAL_MODES.value, {})
        self.out[LocalWire.MODE.value] = global_modes.get(client_id, self.cache.get("mode"))
        # echo the aggregator's round stamp and roster epoch verbatim
        if self.input.get(RemoteWire.ROUND.value) is not None:
            self.out[LocalWire.ROUND.value] = self.input[RemoteWire.ROUND.value]
        if self.input.get(RemoteWire.ROSTER_EPOCH.value) is not None:
            self.out[LocalWire.ROSTER_EPOCH.value] = self.input[RemoteWire.ROSTER_EPOCH.value]

        if self.out[LocalWire.PHASE.value] == Phase.COMPUTATION.value:
            if self.input.get(RemoteWire.SAVE_CURRENT_AS_BEST.value):
                trainer.save_checkpoint(name=self.cache["best_nn_state"])

            if self.input.get(RemoteWire.UPDATE.value):
                self.out.update(**learner.step())

            if any(m == Mode.TRAIN.value for m in global_modes.values()) or (
                not global_modes and self.out[LocalWire.MODE.value] == Mode.TRAIN.value
            ):
                self.out.update(**learner.to_reduce())

            if global_modes and all(
                m == Mode.VALIDATION.value for m in global_modes.values()
            ):
                self.out.update(**trainer.validation_distributed())
                self.out.update(**learner.train_serializable())
                self.out[LocalWire.MODE.value] = Mode.TRAIN_WAITING.value
                self._barrier_autosave(trainer)

            if global_modes and all(
                m == Mode.TEST.value for m in global_modes.values()
            ):
                self.out.update(**trainer.test_distributed())
                self.out[LocalWire.MODE.value] = self.cache["frozen_args"]["mode"]
                self.out[LocalWire.PHASE.value] = Phase.NEXT_RUN_WAITING.value
                trainer._autosave(len(self.cache.get("train_log", [])))
                utils.save_cache(self.cache, {"outputDirectory": self.cache["log_dir"]})

        elif self.out[LocalWire.PHASE.value] == Phase.SUCCESS.value:
            zip_name = self.input.get(RemoteWire.RESULTS_ZIP.value)
            if zip_name:
                src = os.path.join(self.state.get("baseDirectory", "."), f"{zip_name}.zip")
                dst = os.path.join(self.state.get("outputDirectory", "."), f"{zip_name}.zip")
                for i in range(3):  # relay may lag; poll briefly
                    time.sleep(i)
                    if os.path.exists(src):
                        os.makedirs(os.path.dirname(dst), exist_ok=True)
                        shutil.copy(src, dst)
                        break

        if trainer.train_state is not None:
            self.cache["_train_state"] = trainer.train_state
        self._persist_round_state(trainer)
        return self.out

    def __call__(self, *a, **kw):
        try:
            self.compute(*a, **kw)
        except NotImplementedError:
            raise
        except Exception as exc:
            traceback.print_exc()
            raise RuntimeError(
                f"Local node failed ({type(exc).__name__}: {exc}) with "
                f"partial out: {self.out}"
            ) from exc
        # "cache" carries the JSON-able node cache back to the engine
        return {
            "output": self.out,
            "cache": utils.clean_recursive({
                k: v for k, v in dict(self.cache).items()
                if not str(k).startswith("_")
            }),
        }


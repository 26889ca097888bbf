"""Protocol vocabulary for the federated control plane (PyTorch port).

The phase/mode/key strings below ARE the wire protocol between site nodes
and the aggregator, so every value is identical to the JAX package's
``coinstac_dinunet_tpu/config/keys.py``.  This is the subset the lockstep
dSGD path, the invocation retries, the daemon engine, the engine's
telemetry lane, quorum, the staleness-bounded async rounds and the
site-vectorized federation use (its membership events among them); the
vocabularies of the features the port does not carry yet (the roster
protocol's cache keys, the live ops plane's knobs and verdicts, analysis
tiers) stay in the JAX package until their slice lands (``ROADMAP.md``
Queue 1).
"""
from enum import Enum


class _StrEnum(str, Enum):
    def __str__(self) -> str:  # plays nicely inside JSON payloads
        return str(self.value)


class Phase(_StrEnum):
    """Run-level lifecycle of a node (coarse state machine)."""
    INIT_RUNS = "init_runs"
    NEXT_RUN = "next_run"
    PRE_COMPUTATION = "pre_computation"
    COMPUTATION = "computation"
    NEXT_RUN_WAITING = "next_run_waiting"
    SUCCESS = "success"


class Mode(_StrEnum):
    """Within-COMPUTATION activity of a site; the ``*_WAITING`` modes are
    the epoch/validation barrier signals."""
    PRE_TRAIN = "pre_train"
    TRAIN = "train"
    VALIDATION = "validation"
    TEST = "test"
    VALIDATION_WAITING = "validation_waiting"
    TRAIN_WAITING = "train_waiting"


class Key(_StrEnum):
    """Well-known cache / wire dictionary keys."""
    TRAIN_SERIALIZABLE = "train_serializable"
    VALIDATION_SERIALIZABLE = "validation_serializable"
    TEST_SERIALIZABLE = "test_serializable"
    TRAIN_LOG = "train_log"
    VALIDATION_LOG = "validation_log"
    TEST_METRICS = "test_metrics"
    GLOBAL_TEST_SERIALIZABLE = "global_test_serializable"
    ARGS_CACHED = "args_cached"
    DATA_CURSOR = "data_cursor"


class LocalWire(_StrEnum):
    """Message keys a SITE writes into its round output (site → aggregator)."""
    PHASE = "phase"
    MODE = "mode"
    DATA_SIZE = "data_size"
    SHARED_ARGS = "shared_args"
    WEIGHTS_FILE = "weights_file"
    REDUCE = "reduce"
    GRADS_FILE = "grads_file"
    GRAD_WEIGHT = "grad_weight"
    TRAIN_SERIALIZABLE = "train_serializable"
    VALIDATION_SERIALIZABLE = "validation_serializable"
    TEST_SERIALIZABLE = "test_serializable"
    POWERSGD_PHASE = "powerSGD_phase"
    POWERSGD_P_FILE = "powerSGD_P_file"
    POWERSGD_Q_FILE = "powerSGD_Q_file"
    RANK1_FILE = "rank1_file"
    DAD_DATA_FILE = "dad_data_file"
    DAD_REST_FILE = "dad_rest_file"
    HEALTH = "health"
    # the aggregator's round counter echoed back verbatim: a delayed
    # duplicate of an earlier site message echoes a STALE counter
    ROUND = "wire_round"
    # the aggregator's roster epoch echoed back verbatim
    ROSTER_EPOCH = "roster_epoch"
    LEAVING = "leaving"


class RemoteWire(_StrEnum):
    """Message keys the AGGREGATOR writes into its round output
    (aggregator → every site)."""
    PHASE = "phase"
    GLOBAL_MODES = "global_modes"
    GLOBAL_RUNS = "global_runs"
    SAVE_CURRENT_AS_BEST = "save_current_as_best"
    PRETRAINED_WEIGHTS = "pretrained_weights"
    RESULTS_ZIP = "results_zip"
    UPDATE = "update"
    AVG_GRADS_FILE = "avg_grads_file"
    POWERSGD_PHASE = "powerSGD_phase"
    POWERSGD_P_FILE = "powerSGD_P_file"
    POWERSGD_Q_FILE = "powerSGD_Q_file"
    RANK1_FILE = "rank1_file"
    DAD_DATA_FILE = "dad_data_file"
    DAD_REST_FILE = "dad_rest_file"
    HEALTH = "health"
    ROUND = "wire_round"
    ROSTER_EPOCH = "roster_epoch"
    ADMISSIONS = "admissions"


class Retry:
    """Retry/backoff cache-key vocabulary (``resilience/retry.py``):
    ``WIRE_*`` configure retries around wire-payload loads (on by
    default), ``INVOKE_*`` retries around whole node invocations
    (``engine.py``; off by default: re-invoking a node has side effects)."""

    WIRE_ATTEMPTS = "wire_retry_attempts"
    WIRE_BASE_DELAY = "wire_retry_base_delay"
    WIRE_MAX_DELAY = "wire_retry_max_delay"
    WIRE_DEADLINE = "wire_retry_deadline"
    INVOKE_ATTEMPTS = "invoke_retry_attempts"
    INVOKE_BASE_DELAY = "invoke_retry_base_delay"
    INVOKE_MAX_DELAY = "invoke_retry_max_delay"
    INVOKE_DEADLINE = "invoke_retry_deadline"
    ASYNC_WIRE_COMMIT = "async_wire_commit"


class Live:
    """Event names the live ops plane keys on: ``HEARTBEAT`` is the event
    the serial engines write to their telemetry lane per completed node
    invocation."""

    HEARTBEAT = "engine:heartbeat"


class Daemon:
    """The daemon engine's vocabulary (``federation/daemon.py``): the
    ``RESTART_*`` cache keys configure the worker supervision policy
    (:meth:`~..resilience.retry.RetryPolicy.for_worker`, on by default),
    and the ``EVENT_*`` names are its events on the engine's telemetry
    lane (a target's first worker, a supervised replacement, an orderly
    shutdown at close)."""

    RESTART_ATTEMPTS = "worker_restart_attempts"
    RESTART_BASE_DELAY = "worker_restart_base_delay"
    RESTART_MAX_DELAY = "worker_restart_max_delay"
    RESTART_DEADLINE = "worker_restart_deadline"

    EVENT_START = "worker:start"
    EVENT_RESTART = "worker:restart"
    EVENT_SHUTDOWN = "worker:shutdown"


class Metric:
    """Metric names of the telemetry ``metric`` records the port writes:
    ``SITE_STALENESS`` is a site's lag in rounds behind the aggregator's
    ``wire_round`` (the async engine per delivery and stand-in, the
    aggregator's window check per accepted stale echo);
    ``ROUNDS_PER_SEC`` and ``SITES_PER_SEC`` are the site-vectorized
    engine's throughput per round (one over the round's wall time, and the
    live members over it)."""

    ROUNDS_PER_SEC = "rounds_per_sec"
    SITES_PER_SEC = "sites_per_sec"
    SITE_STALENESS = "site_staleness"


class Federation:
    """Cache keys of the federation options (``engine.py``,
    ``nodes/remote.py``, ``parallel/reducer.py``):

    - ``ASYNC_STALENESS`` — ``k``: a straggler's last contribution may
      stand in for it for up to ``k`` rounds, and the aggregator accepts an
      echo lagging its ``wire_round`` by ``1..k``;
    - ``ASYNC_POOL`` — the engine's invocation pool size;
    - ``ASYNC_DISCOUNT`` — ``gamma``: the reducer weighs a contribution
      ``j`` rounds stale by ``gamma**j`` (default 0.5);
    - ``SITE_SHARDS`` — the number of cards the site-vectorized
      federation's stacked site axis shards over (``federation/vector.py``;
      one card: 1, a request for more is refused);
    - ``RUN_AHEAD`` and ``REDUCE_FANIN`` — run-ahead pipelining and the
      k-ary tree fan-in, which the port refuses (``ROADMAP.md`` Queue 1).
    """

    REDUCE_FANIN = "reduce_fanin"
    SITE_SHARDS = "site_shards"
    ASYNC_STALENESS = "async_staleness"
    ASYNC_POOL = "async_invoke_pool"
    ASYNC_DISCOUNT = "async_stale_discount"
    RUN_AHEAD = "run_ahead"


class Membership:
    """Elastic-membership events: one roster transition each, carrying the
    new roster epoch and member count.  The site-vectorized engine writes
    them to its telemetry lane (``federation/engine.py``); the roster
    protocol of the serial engines is still to port."""

    EVENT_JOIN = "membership:join"
    EVENT_LEAVE = "membership:leave"
    EVENT_REJOIN = "membership:rejoin"


class AggEngine(_StrEnum):
    """Built-in gradient-aggregation engines."""
    DSGD = "dSGD"
    POWER_SGD = "powerSGD"
    RANK_DAD = "rankDAD"


class GatherMode(_StrEnum):
    """How the aggregator merges a key across sites."""
    APPEND = "append"
    EXTEND = "extend"

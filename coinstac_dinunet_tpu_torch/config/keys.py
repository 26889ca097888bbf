"""Protocol vocabulary for the federated control plane (PyTorch port).

The phase/mode/key strings below ARE the wire protocol between site nodes
and the aggregator, so every value is identical to the JAX package's
``coinstac_dinunet_tpu/config/keys.py``.  This is the subset the lockstep
dSGD path, the invocation retries, the daemon engine, the engine's
telemetry lane, quorum, the staleness-bounded async rounds and the
site-vectorized federation, run-ahead pipelining, the roster protocol
of elastic membership, the mesh axes, the health layer (metrics, anomalies, perf and
capture keys) and the models and torch checkpoint import use; the
vocabularies of the features the port does not carry yet (the live ops
plane's knobs and verdicts, analysis tiers) stay in the JAX package until
their slice lands (``ROADMAP.md`` Queue 1).
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
    """Vocabulary of the live ops plane (``telemetry/live.py``,
    ``telemetry/serve.py``), the JAX package's strings.

    Event name: ``HEARTBEAT``, the ``engine:heartbeat`` event the engines
    write per node invocation (the site-vectorized engine: one per round
    with the alive count); the tailer keys site liveness on it.

    Cache keys: ``FLUSH_INTERVAL`` (seconds between the recorder's
    auto-flushes, default 5; 0 flushes by size only), ``SILENCE_AFTER``
    (seconds of a site's heartbeat silence before the silence verdict,
    default 30), ``ROUND_OUTLIER`` (multiple of the rolling median round
    that fires the outlier verdict, default 4), ``MFU_COLLAPSE`` (fraction
    of the MFU EMA below which a sample fires the collapse verdict, default
    0.3), ``RETRY_STORM``/``RETRY_WINDOW`` (wire retries per rolling window
    of seconds, default 10 per 30 s), ``QUORUM_HEADROOM`` (members above
    the quorum need below which the erosion verdict fires).

    In-flight verdict kinds (edge-triggered, the doctor's verdict shape;
    each also a Prometheus ``verdicts_total{kind=...}`` label): ``VERDICT_*``.
    ``PROM_PREFIX`` prefixes every exported Prometheus metric name.
    """

    HEARTBEAT = "engine:heartbeat"
    FLUSH_INTERVAL = "telemetry_flush_interval_s"
    SILENCE_AFTER = "watch_silence_after_s"
    ROUND_OUTLIER = "watch_round_outlier"
    MFU_COLLAPSE = "watch_mfu_collapse"
    RETRY_STORM = "watch_retry_storm"
    RETRY_WINDOW = "watch_retry_window_s"
    #: members above the quorum need below which quorum_erosion fires
    QUORUM_HEADROOM = "watch_quorum_headroom"
    PROM_PREFIX = "coinstac_dinunet"
    VERDICT_SILENCE = "heartbeat_silence"
    VERDICT_ROUND_OUTLIER = "round_duration_outlier"
    VERDICT_MFU_COLLAPSE = "mfu_collapse"
    VERDICT_RETRY_STORM = "wire_retry_storm"
    VERDICT_STALENESS = "staleness_exceeded"
    VERDICT_PIPELINE = "pipeline_stall"
    VERDICT_QUORUM_EROSION = "quorum_erosion"


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


class MeshAxis:
    """Names of the axes of a rank mesh (``parallel/mesh.py``), the JAX
    package's vocabulary: plain ``str`` constants.

    - ``SITE``   — one rank per federated site.
    - ``DEVICE`` — intra-site data parallelism over a site's ranks.
    - ``DP``     — batch data parallelism (the sharded transformer steps).
    - ``TP``     — tensor parallelism: attention heads / MLP hidden dim.
    - ``SP``     — sequence parallelism (ring/Ulysses attention).
    - ``EP``     — expert parallelism (switch-MoE expert dim).
    - ``PP``     — pipeline parallelism (GPipe stages).
    """

    SITE = "site"
    DEVICE = "device"
    DP = "dp"
    TP = "tp"
    SP = "sp"
    EP = "ep"
    PP = "pp"


class Metric:
    """Metric names of the telemetry ``metric`` records (the JAX package's
    strings, so its collector and doctor read the port's lanes).

    Health series (``telemetry/health.py``): ``GRAD_NORM`` /
    ``GRAD_NORM_EMA`` — a site's global L2 gradient norm per backward round
    and its watchdog EMA; ``UPDATE_NORM`` — the norm of the applied
    (averaged) update; ``TRAIN_LOSS`` — the round's mean training loss;
    ``VAL_SCORE`` — the monitored validation metric per epoch barrier;
    ``SITE_COSINE`` — each site's cosine to the participation-weighted mean
    at the aggregator (NaN for a non-finite site); ``SITE_DISPERSION`` — the
    std-dev of the finite cosines; ``SURVIVORS`` — the sites that count in
    the reduce; ``COMPRESSION_ERROR`` / ``EFFECTIVE_RANK`` — PowerSGD's and
    rankDAD's relative reconstruction error and the entropy effective rank
    of their factors.

    Perf series (``telemetry/perf.py``): ``SAMPLES_PER_SEC`` — a step's
    padded samples over its fenced wall time; ``ACHIEVED_TFLOPS`` / ``MFU``
    — not recorded by the port (no FLOP count of its steps yet);
    ``HBM_IN_USE`` / ``HBM_PEAK`` / ``HBM_LIMIT`` / ``HBM_UTILIZATION`` —
    device memory per round (``torch.cuda.memory_stats``' caching
    allocator; a tensor census on the CPU).

    Engine series: ``SITE_STALENESS`` is a site's lag in rounds behind the
    aggregator's ``wire_round`` (the async engine per delivery and
    stand-in, the aggregator's window check per accepted stale echo);
    ``SITE_RUN_AHEAD`` is a site's run-ahead depth under the pipelined
    async engine, recorded at every re-submission; ``ROUNDS_PER_SEC`` and
    ``SITES_PER_SEC`` are the site-vectorized engine's throughput per round
    (one over the round's wall time, and the live members over it)."""

    GRAD_NORM = "grad_norm"
    GRAD_NORM_EMA = "grad_norm_ema"
    UPDATE_NORM = "update_norm"
    TRAIN_LOSS = "train_loss"
    VAL_SCORE = "val_score"
    SITE_COSINE = "site_cosine"
    SITE_DISPERSION = "site_dispersion"
    SURVIVORS = "survivors"
    COMPRESSION_ERROR = "compression_error"
    EFFECTIVE_RANK = "effective_rank"
    SAMPLES_PER_SEC = "samples_per_sec"
    ACHIEVED_TFLOPS = "achieved_tflops"
    MFU = "mfu"
    HBM_IN_USE = "hbm_in_use_bytes"
    HBM_PEAK = "hbm_peak_bytes"
    HBM_LIMIT = "hbm_limit_bytes"
    HBM_UTILIZATION = "hbm_utilization"
    ROUNDS_PER_SEC = "rounds_per_sec"
    SITES_PER_SEC = "sites_per_sec"
    SITE_STALENESS = "site_staleness"
    SITE_RUN_AHEAD = "site_run_ahead"


class Anomaly:
    """The watchdog's anomaly names (``telemetry/watchdog.py``), one per
    detector, emitted as ``anomaly:<name>`` events: ``NONFINITE`` (a
    watched series went NaN/Inf), ``GRAD_EXPLOSION`` (the gradient norm
    spiked against its EMA), ``DIVERGENCE_OUTLIER`` (a site's cosine to the
    consensus fell below the floor), ``VAL_STALL`` (the monitored
    validation metric stopped improving), ``COMPRESSION_SPIKE``,
    ``RANK_COLLAPSE``, ``MEMORY_LEAK`` (device memory grew N rounds in a
    row) and ``MEMORY_PRESSURE`` (device memory near its limit)."""

    NONFINITE = "nonfinite"
    GRAD_EXPLOSION = "grad_explosion"
    DIVERGENCE_OUTLIER = "divergence_outlier"
    VAL_STALL = "val_stall"
    COMPRESSION_SPIKE = "compression_spike"
    RANK_COLLAPSE = "rank_collapse"
    MEMORY_LEAK = "memory_leak"
    MEMORY_PRESSURE = "memory_pressure"


class Perf:
    """Cache keys of the perf recorder (``telemetry/perf.py``):
    ``PEAK_TFLOPS`` overrides the peak table; ``MFU_CEILING`` is the
    model's structural MFU ceiling (read by the doctor); ``MEMORY_LIMIT``
    is the device-memory budget in bytes where the sample finds none (the
    CPU census), and overrides the card's total."""

    PEAK_TFLOPS = "peak_tflops"
    MFU_CEILING = "mfu_ceiling"
    MEMORY_LIMIT = "memory_limit_bytes"


class Capture:
    """Cache keys of the anomaly-triggered profiler capture
    (``telemetry/capture.py``): ``ON_ANOMALY`` — ``True`` captures the
    round after any watchdog anomaly, a string or list names the
    :class:`Anomaly` kinds that do; ``MAX_PROFILES`` — the captures a node
    keeps per run (default 2)."""

    ON_ANOMALY = "capture_on_anomaly"
    MAX_PROFILES = "capture_max_profiles"


class Model:
    """Cache keys of the models and the checkpoint import, spelled as the
    JAX package reads them:

    - ``FUSED_GROUPNORM`` — the CNNs' norms return the input's dtype, as
      the JAX package's fused GroupNorm does (``ops/groupnorm.py``;
      ``COINN_NO_FUSED_GN`` in the environment still turns it off);
    - ``TORCH_NAME_MAP`` — ``{torch name: flax path}`` overriding the
      positional pairing of a torch checkpoint's entries
      (``utils/torch_import.py``);
    - ``IMPORT_TORCH_OPTIMIZER`` — ``False`` starts an imported model's
      optimizer fresh even when the file carries its Adam state;
    - ``ALLOW_UNSAFE_TORCH_PICKLE`` — loads a torch file that needs full
      unpickling (which runs code from the file): trusted local files only.
    """

    FUSED_GROUPNORM = "fused_groupnorm"
    TORCH_NAME_MAP = "torch_name_map"
    IMPORT_TORCH_OPTIMIZER = "import_torch_optimizer"
    ALLOW_UNSAFE_TORCH_PICKLE = "allow_unsafe_torch_pickle"


class Federation:
    """Cache keys of the federation options (``engine.py``,
    ``nodes/remote.py``, ``parallel/reducer.py``):

    - ``ASYNC_STALENESS`` — ``k``: a straggler's last contribution may
      stand in for it for up to ``k`` rounds, and the aggregator accepts an
      echo lagging its ``wire_round`` by ``1..k``;
    - ``ASYNC_POOL`` — the engine's invocation pool size;
    - ``ASYNC_DISCOUNT`` — ``gamma``: the reducer weighs a contribution
      ``j`` rounds stale by ``gamma**j`` (default 0.5);
    - ``SITE_SHARDS`` — the number of shards the site-vectorized
      federation's stacked site axis splits into, each folded on its own
      device of the shard mesh (``federation/vector.py``; default 1);
    - ``RUN_AHEAD`` — ``d``: a process-backed engine hands the reduce and
      relay to a reducer thread and lets a site compute up to ``d``
      broadcasts ahead of the last one it applied; the aggregator's window
      widens to ``k + d`` (the in-process engine clamps ``d`` to 0);
    - ``REDUCE_FANIN`` — ``k >= 2``: the aggregator streams the site
      payloads through a k-ary tree of partial sums instead of stacking
      them all at once;
    - ``WIRE_MMAP`` — the aggregator's fan-in maps each site payload
      read-only and verifies it over the map instead of reading it into a
      heap copy (``parallel/reducer.py`` through
      ``tensorutils.load_arrays_many(mmap=)``); default on, false for heap
      reads.
    """

    REDUCE_FANIN = "reduce_fanin"
    SITE_SHARDS = "site_shards"
    ASYNC_STALENESS = "async_staleness"
    ASYNC_POOL = "async_invoke_pool"
    ASYNC_DISCOUNT = "async_stale_discount"
    RUN_AHEAD = "run_ahead"
    WIRE_MMAP = "wire_mmap"


class Membership:
    """Elastic membership (``federation/membership.py``): sites join, leave
    and rejoin mid-run under an aggregator-owned roster epoch.

    Cache keys: ``ROSTER`` — the aggregator's versioned membership record
    (``{"epoch", "members": {site: admitted epoch}, "left", "joining",
    "pending"}``), whose member list ``cache['all_sites']`` mirrors;
    ``REQUESTS`` — the engine → aggregator queue of admission requests
    (``[{"op": "join"|"rejoin", "site", "sync": {...}}]``);
    ``CAPACITY_WEIGHT`` — opt-in capacity weighting of the reduce by each
    site's observed throughput, ``SITE_CAPACITY`` (``{site: samples/s}``).

    Events, one per roster transition with the new epoch and member count
    (the aggregator writes them; the site-vectorized engine writes its
    own): ``EVENT_JOIN``, ``EVENT_LEAVE``, ``EVENT_REJOIN``;
    ``EVENT_REFUSED`` — a payload refused by roster epoch."""

    ROSTER = "roster"
    REQUESTS = "membership_requests"
    CAPACITY_WEIGHT = "capacity_weight"
    SITE_CAPACITY = "site_capacity"

    EVENT_JOIN = "membership:join"
    EVENT_LEAVE = "membership:leave"
    EVENT_REJOIN = "membership:rejoin"
    EVENT_REFUSED = "membership:refused"


class AggEngine(_StrEnum):
    """Built-in gradient-aggregation engines."""
    DSGD = "dSGD"
    POWER_SGD = "powerSGD"
    RANK_DAD = "rankDAD"


class GatherMode(_StrEnum):
    """How the aggregator merges a key across sites."""
    APPEND = "append"
    EXTEND = "extend"

"""Federation telemetry (port of the JAX package's ``telemetry/``).

Public surface: :class:`Recorder` / :data:`NULL_RECORDER` — the typed
span/event/metric/wire sink with a zero-overhead disabled mode (record
schema v1, ``SCHEMA_VERSION``), :meth:`Recorder.for_node` for the node
lanes; the ambient recorder stack (:func:`activate`, :func:`get_active`);
the health layer: :class:`Watchdog` and its detectors
(:mod:`.watchdog`), the health series (:mod:`.health`), the perf samples
and the FLOP count behind the ``achieved_tflops`` and ``mfu`` series
(:mod:`.perf`) and the anomaly-triggered profiler capture
(:mod:`.capture`).  The tools read the lanes of either package:

- :mod:`.collect` — every node's JSONL merged into one timeline, the
  summary table and the Perfetto/Chrome-trace export;
- :mod:`.doctor` — the postmortem report (anomaly timeline, per-site
  divergence, roofline and MFU/memory floors, ranked verdicts);
- :mod:`.live` — the live ops plane: rotation- and crash-safe incremental
  tailing into a federation-wide state with edge-triggered verdicts;
- :mod:`.serve` — Prometheus ``/metrics`` and ``/healthz`` over the live
  state on 127.0.0.1;
- the CLI, ``python -m coinstac_dinunet_tpu_torch.telemetry <workdir>
  [--trace t.json]``, ``... doctor <workdir>`` and ``... watch <workdir>``.
"""
from . import capture, health, perf  # noqa: F401
from .recorder import (  # noqa: F401
    NULL_RECORDER,
    SCHEMA_VERSION,
    Recorder,
    activate,
    get_active,
)
from .watchdog import DEFAULT_DETECTORS, Detector, Watchdog, register_detector  # noqa: F401

__all__ = ["Recorder", "NULL_RECORDER", "SCHEMA_VERSION", "activate", "get_active",
           "Watchdog", "Detector", "DEFAULT_DETECTORS", "register_detector",
           "capture", "health", "perf"]

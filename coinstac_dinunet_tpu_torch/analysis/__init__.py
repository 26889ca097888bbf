"""dinulint for the PyTorch port — the JAX package's static analyzer
(``coinstac_dinunet_tpu/analysis``) over the port's own tree and
vocabulary, run as ``python -m coinstac_dinunet_tpu_torch.analysis``.

It parses the port's ``config/keys.py`` and package root, and keeps the
JAX analyzer's rule ids, ``Finding`` shape, suppression comments, baseline
format and exit codes (0 / 1 / 2), so a finding of one analyzer can be held
against the other's.  Its baseline is ``dinulint_torch_baseline.json``
and its wire lockfile ``wire_schema_torch.lock.json``.

Tiers:

- default (pure ``ast``): ``protocol-conformance``,
  ``telemetry-metric-name``, ``wire-atomic-commit``, the ``sharding-*``
  rules over the port's rank meshes (:mod:`.sharding` names the two JAX
  rules with no construct in the port), the ``trace-*`` rules over the
  port's step functions (:mod:`.trace_hazards`; ``trace-telemetry`` has no
  construct in eager code) and ``torch-api-drift`` against the pinned torch
  (:mod:`.jax_api`, ``--torch-version``);
- ``--deep``: the JAX registry's 14 entry points built from the port at
  the JAX stand-ins' shapes and run on ``--device`` (:mod:`.deepcheck`);
- ``--tier3``: ``perf-host-sync``, ``perf-donation``,
  ``perf-dtype-promotion`` and ``perf-constant-capture`` over the deep
  entries' second runs (:mod:`.dataflow`, :mod:`.perf_rules`) and the
  ``proto-flow-*``/``proto-cache-*`` phase-machine model
  (:mod:`.protocol_flow`);
- ``--model``: the bounded federation model checker (:mod:`.model_check`);
- ``--tier5``: the ``conc-*`` lock-discipline rules (:mod:`.concurrency`)
  and the ``proto-conc-*`` interleaving explorer
  (:mod:`.schedule_explorer`);
- ``--wire``: the wire-contract auditor (:mod:`.wire_schema`);
- ``--tier7``: the ``num-*`` rules (:mod:`.numerics`; ``num-accum-narrow``
  over the deep entries' runs on ``--device``) and the
  ``proto-num-parity`` prover (:mod:`.parity`, also ``--parity``).

Only ``--deep``, ``--tier3`` and ``--tier7`` import ``torch`` for the
entries (the explorer and the prover import the engines, with numpy
stubs); nothing here imports JAX or the JAX package.
"""
from .core import (  # noqa: F401
    Finding,
    Module,
    ProjectRule,
    Rule,
    default_rules,
    filter_baselined,
    load_baseline,
    register_rule,
    run_lint,
    write_baseline,
)
from .dataflow import TIER3_RULE_IDS  # noqa: F401  (torch-free to import)
from .protocol import ProtocolConformanceRule, load_vocabulary  # noqa: F401
from .protocol_flow import ProtocolFlowAnalyzer, run_protocol_flow  # noqa: F401
from .sharding import (  # noqa: F401
    AxisLiteralRule,
    MeshArityRule,
    UnknownAxisRule,
    load_mesh_axes,
)

__all__ = [
    "Finding", "Module", "Rule", "ProjectRule", "register_rule",
    "default_rules", "run_lint", "load_baseline", "write_baseline",
    "filter_baselined", "ProtocolConformanceRule", "load_vocabulary",
    "UnknownAxisRule", "MeshArityRule", "AxisLiteralRule", "load_mesh_axes",
    "TIER3_RULE_IDS", "ProtocolFlowAnalyzer", "run_protocol_flow",
]

"""telemetry-metric-name: health-series / anomaly names must come from the
port's ``config/keys.py`` vocabulary (the JAX package's rule and strings).

Metric and anomaly names are the health layer's wire protocol: the watchdog
routes a sample to its detectors by STRING EQUALITY on the series name, and
the doctor's per-site attribution keys on the same strings.  A typo'd name
(``record_metric("gradnorm", ...)``) doesn't crash anything — it silently
produces a series no detector watches and no report aggregates, which is the
exact failure mode the :class:`~..config.keys.Metric`/:class:`~..config.keys.
Anomaly` vocabulary exists to prevent.  Same machinery as the ``sharding-*``
family: the vocabulary is *parsed* out of ``config/keys.py`` (never
imported), ``Metric.X``/``Anomaly.X`` attribute spellings resolve through
it, and fixture tests can substitute a ``keys_source``.

Checked call shapes (names resolvable statically only — dynamic names are
the caller's problem):

- ``record_metric(NAME, ...)`` / ``health.record_metric(NAME, ...)`` — NAME
  must be a declared **metric**.
- ``<recorder>.metric(NAME, ...)`` where ``<recorder>`` is a conventional
  recorder binding (``rec``/``recorder``/``tracer``/``telemetry``) or a
  chained factory call (``get_active().metric(...)``) — declared metric.
- ``register_detector(ANOMALY[, metric=METRIC])`` — ANOMALY must be a
  declared **anomaly**, METRIC (when present and not None) a declared
  metric.
- ``<watchdog>.observe(NAME, ...)`` on a ``Watchdog(...)`` chain or a
  ``wd``/``watchdog`` binding — declared metric.
- ``<recorder>.event(Live.X, ...)`` / any ``Live.X`` spelling — the member
  must exist in the :class:`~..config.keys.Live` vocabulary (event-name
  literals stay free-form; only member spellings are resolvable).

The rule additionally validates the VOCABULARY DEFINITION itself, in any
module that defines a ``Live`` class (in the port: ``config/keys.py``):

- ``Live`` values must use the legal telemetry-name charset, and
  ``Live.HEARTBEAT`` must keep its load-bearing ``engine:`` prefix (the
  live tailer keys site liveness on it).
- ``Live.PROM_PREFIX``, every ``Live.VERDICT_*`` kind and every ``Metric``
  value must already be legal Prometheus metric-name material
  (``[a-z_][a-z0-9_]*``) — the exporter's name mapping
  (``telemetry/serve.py::prometheus_name``) must be the identity plus the
  prefix, never a mangling (a mangled name silently breaks every deployed
  dashboard that scraped the old spelling).
"""
import ast
import os
import re

from .core import Finding, Rule, dotted_name, register_rule

METRIC_CLASS = "Metric"
ANOMALY_CLASS = "Anomaly"
LIVE_CLASS = "Live"

#: legal Prometheus metric-name fragment — the exporter mapping must be the
#: identity on every declared series/verdict/prefix
_PROM_NAME_RE = re.compile(r"^[a-z_][a-z0-9_]*$")
#: legal telemetry event/cache-key charset (colon namespaces event names)
_TELEMETRY_NAME_RE = re.compile(r"^[a-z_][a-z0-9_:.]*$")
#: the heartbeat event's stable prefix (telemetry/live.py keys on it)
_HEARTBEAT_PREFIX = "engine:"

_RECORDER_ROOTS = {"rec", "recorder", "telemetry", "tracer"}
_WATCHDOG_ROOTS = {"wd", "watchdog"}
_FACTORY_SEGMENTS = {"get_active", "for_node"}


def _keys_module_path():
    return os.path.normpath(
        os.path.join(os.path.dirname(__file__), "..", "config", "keys.py")
    )


def load_name_vocab(keys_source=None):
    """Parse ``config/keys.py`` into ``{class_name: {member: value}}`` for
    the :class:`Metric`, :class:`Anomaly` and :class:`Live` vocabularies."""
    if keys_source is None:
        with open(_keys_module_path(), "r", encoding="utf-8") as f:
            keys_source = f.read()
    tree = ast.parse(keys_source)
    vocab = {METRIC_CLASS: {}, ANOMALY_CLASS: {}, LIVE_CLASS: {}}
    for node in tree.body:
        if isinstance(node, ast.ClassDef) and node.name in vocab:
            for stmt in node.body:
                if (
                    isinstance(stmt, ast.Assign)
                    and len(stmt.targets) == 1
                    and isinstance(stmt.targets[0], ast.Name)
                    and isinstance(stmt.value, ast.Constant)
                    and isinstance(stmt.value.value, str)
                ):
                    vocab[node.name][stmt.targets[0].id] = stmt.value.value
    return vocab


def _last(name):
    return name.rsplit(".", 1)[-1] if name else ""


def _resolve_name(node, vocab):
    """expr → ``(value_or_None, kind)``.

    kind: ``'literal'`` (string constant), ``'member'`` (``Metric.X`` /
    ``Anomaly.X`` — value None when the member does not exist), ``'none'``
    (the ``None`` constant), or ``'dynamic'`` (unresolvable)."""
    if isinstance(node, ast.Constant):
        if node.value is None:
            return None, "none"
        if isinstance(node.value, str):
            return node.value, "literal"
        return None, "dynamic"
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    parts.reverse()
    if len(parts) >= 2 and parts[-2] in (METRIC_CLASS, ANOMALY_CLASS,
                                         LIVE_CLASS):
        return vocab[parts[-2]].get(parts[-1]), "member"
    return None, "dynamic"


def _chain_root(node):
    """Innermost Name/Call of an attribute chain (``a.b.c`` → ``a``)."""
    while isinstance(node, ast.Attribute):
        node = node.value
    return node


def _is_recorder_expr(expr):
    """True when ``expr`` conventionally holds a recorder: a known binding
    name, anything mentioning telemetry, or a factory-call chain."""
    if isinstance(expr, ast.Name):
        return expr.id.lower() in _RECORDER_ROOTS or "telemetry" in expr.id.lower()
    if isinstance(expr, ast.Attribute):
        name = (dotted_name(expr, require_name_root=False) or "").lower()
        segs = name.split(".")
        return (
            "telemetry" in name
            or (segs and segs[0] in _RECORDER_ROOTS)
            or (segs and segs[-1] in _RECORDER_ROOTS)
        )
    if isinstance(expr, ast.Call):
        name = (dotted_name(expr.func, require_name_root=False) or "").lower()
        return _last(name) in _FACTORY_SEGMENTS or "telemetry" in name
    return False


def _is_watchdog_expr(expr):
    if isinstance(expr, ast.Name):
        return expr.id.lower() in _WATCHDOG_ROOTS
    if isinstance(expr, ast.Call):
        name = dotted_name(expr.func, require_name_root=False) or ""
        return _last(name) == "Watchdog"
    if isinstance(expr, ast.Attribute):
        name = (dotted_name(expr, require_name_root=False) or "").lower()
        return _last(name) in _WATCHDOG_ROOTS
    return False


@register_rule
class TelemetryMetricNameRule(Rule):
    id = "telemetry-metric-name"
    doc = ("Metric/anomaly names in record_metric()/Recorder.metric()/"
           "Watchdog.observe() calls and register_detector() registrations "
           "must come from the config/keys.py Metric/Anomaly vocabulary "
           "(typos make silently-unwatched series); Live vocabulary members "
           "must exist, keep the heartbeat's engine: prefix, and stay legal "
           "under the Prometheus metric-name mapping of telemetry/serve.py.")

    def __init__(self, keys_source=None):
        self._keys_source = keys_source
        self._vocab = None

    def vocab(self):
        if self._vocab is None:
            self._vocab = load_name_vocab(self._keys_source)
        return self._vocab

    # ----------------------------------------------------------------- checks
    def _check_name(self, module, node, which):
        """One name argument against vocabulary ``which``; returns the
        finding or None."""
        vocab = self.vocab()
        values = set(vocab[which].values())
        resolved, kind = _resolve_name(node, vocab)
        if kind in ("none", "dynamic"):
            return None
        if kind == "member" and resolved is None:
            dotted = dotted_name(node, require_name_root=False) or ""
            segs = dotted.split(".")
            cls = segs[-2] if len(segs) >= 2 else which
            return Finding(
                rule=self.id, path=module.path, line=node.lineno,
                col=node.col_offset,
                message=f"unknown {cls} member '{dotted}' — "
                        f"declare it in config/keys.py {cls}",
            )
        if resolved not in values:
            return Finding(
                rule=self.id, path=module.path, line=node.lineno,
                col=node.col_offset,
                message=f"{which.lower()} name '{resolved}' is not declared "
                        f"in the config/keys.py {which} vocabulary "
                        f"(known: {', '.join(sorted(values))})",
            )
        return None

    def _first_arg(self, call, kwarg=None):
        if call.args and not isinstance(call.args[0], ast.Starred):
            return call.args[0]
        if kwarg:
            for kw in call.keywords:
                if kw.arg == kwarg:
                    return kw.value
        return None

    # ------------------------------------------------- vocabulary definition
    def _definition_findings(self, module):
        """Validate the vocabulary DEFINITION in a module that defines a
        ``Live`` class (config/keys.py; fixture modules in tests): event
        prefix stability, telemetry-name charset, and the Prometheus
        mapping's identity requirement for ``Metric``/``PROM_PREFIX``/
        ``VERDICT_*`` values."""
        classes = {
            node.name: node for node in module.tree.body
            if isinstance(node, ast.ClassDef)
        }
        if LIVE_CLASS not in classes:
            return []
        findings = []

        def members(cls_node):
            for stmt in cls_node.body:
                if (isinstance(stmt, ast.Assign) and len(stmt.targets) == 1
                        and isinstance(stmt.targets[0], ast.Name)
                        and isinstance(stmt.value, ast.Constant)
                        and isinstance(stmt.value.value, str)):
                    yield stmt.targets[0].id, stmt.value.value, stmt

        def bad(stmt, message):
            findings.append(Finding(
                rule=self.id, path=module.path, line=stmt.lineno,
                col=stmt.col_offset, message=message,
            ))

        for member, value, stmt in members(classes[LIVE_CLASS]):
            if member == "HEARTBEAT" and not value.startswith(
                    _HEARTBEAT_PREFIX):
                bad(stmt, f"Live.HEARTBEAT '{value}' must keep the stable "
                          f"'{_HEARTBEAT_PREFIX}' prefix — the live tailer "
                          "keys site liveness on it")
            elif (member == "PROM_PREFIX" or member.startswith("VERDICT_")):
                if not _PROM_NAME_RE.match(value):
                    bad(stmt, f"Live.{member} '{value}' is not legal "
                              "Prometheus metric-name material "
                              "([a-z_][a-z0-9_]*) — the exporter mapping "
                              "(telemetry/serve.py) would mangle it")
            elif not _TELEMETRY_NAME_RE.match(value):
                bad(stmt, f"Live.{member} '{value}' uses characters outside "
                          "the telemetry name charset ([a-z_][a-z0-9_:.]*)")
        if METRIC_CLASS in classes:
            for member, value, stmt in members(classes[METRIC_CLASS]):
                if not _PROM_NAME_RE.match(value):
                    bad(stmt, f"Metric.{member} '{value}' is not a legal "
                              "Prometheus metric-name suffix "
                              "([a-z_][a-z0-9_]*) — the /metrics exporter "
                              "mapping must stay the identity plus the "
                              "prefix")
        return findings

    def visit_module(self, module):
        findings = self._definition_findings(module)
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            name = dotted_name(node.func, require_name_root=False) or ""
            last = _last(name)
            hit = None
            if last == "record_metric":
                arg = self._first_arg(node, kwarg="name")
                if arg is not None:
                    hit = self._check_name(module, arg, METRIC_CLASS)
            elif last == "register_detector":
                arg = self._first_arg(node, kwarg="anomaly")
                if arg is not None:
                    hit = self._check_name(module, arg, ANOMALY_CLASS)
                    if hit:
                        findings.append(hit)
                    hit = None
                metric = None
                if len(node.args) > 1 and not isinstance(node.args[1], ast.Starred):
                    metric = node.args[1]
                else:
                    for kw in node.keywords:
                        if kw.arg == "metric":
                            metric = kw.value
                if metric is not None:
                    hit = self._check_name(module, metric, METRIC_CLASS)
            elif last == "metric" and isinstance(node.func, ast.Attribute):
                if _is_recorder_expr(node.func.value):
                    arg = self._first_arg(node, kwarg="name")
                    if arg is not None:
                        hit = self._check_name(module, arg, METRIC_CLASS)
            elif last == "observe" and isinstance(node.func, ast.Attribute):
                if _is_watchdog_expr(node.func.value):
                    arg = self._first_arg(node, kwarg="name")
                    if arg is not None:
                        hit = self._check_name(module, arg, METRIC_CLASS)
            elif last == "event" and isinstance(node.func, ast.Attribute):
                # event-name LITERALS are free-form; only vocabulary-member
                # spellings are checked (an unknown Live/Metric/Anomaly
                # member is a typo that would emit a name no tailer watches)
                if _is_recorder_expr(node.func.value):
                    arg = self._first_arg(node, kwarg="name")
                    if arg is not None:
                        vocab = self.vocab()
                        resolved, kind = _resolve_name(arg, vocab)
                        if kind == "member" and resolved is None:
                            dotted = dotted_name(
                                arg, require_name_root=False
                            ) or ""
                            cls = dotted.split(".")[-2] if "." in dotted else "?"
                            hit = Finding(
                                rule=self.id, path=module.path,
                                line=arg.lineno, col=arg.col_offset,
                                message=f"unknown {cls} member '{dotted}' "
                                        "in recorder event name — declare "
                                        f"it in config/keys.py {cls}",
                            )
            if hit:
                findings.append(hit)
        return findings

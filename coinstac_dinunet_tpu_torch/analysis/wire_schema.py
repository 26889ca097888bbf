"""The port's wire-contract auditor (``--wire``), the JAX package's
``analysis/wire_schema.py`` over the port's boundary modules.

Everything that crosses a node boundary does so as one of three payload
kinds: **json** (the local↔remote output-dict handshake keys and the
daemon's framed-pipe fields), **tensor** (COINNTW2/``.npy`` payloads
committed through ``resilience/transport.py`` and named by ``*_file`` wire
keys), and **delta** (the daemon's dirty-key ``cache_delta``/``cache_patch``
lanes).  This tier lifts all of it into one typed **wire-schema IR**
(:class:`WireEntry`: key, direction, producer/consumer site-kind, payload
kind, versioning echoes, applicable codec, static byte cost) with the same
pure-``ast`` grammar as ``protocol.py``/``proto_ir.py`` — no ``torch``
import — and checks four rule families over it:

- ``wire-orphan`` — a key consumed on one side with no producer on the
  other (or produced and never consumed): silent schema drift.  Covers the
  daemon frame fields the ``protocol-conformance`` rule never sees.
- ``wire-unversioned`` — a boundary module (or daemon frame lane) that
  ships payloads without echoing the ``wire_round``/``roster_epoch``
  stamps the staleness window and roster machinery refuse deliveries by.
- ``wire-dense`` — a full-tensor path written outside the codec-capable
  ``save_wire`` choke point (``open(..., "wb")``, ``np.save`` or
  ``torch.save`` into a transfer directory) while a registered codec
  (``ops/quantize.py`` int8, ``parallel/powersgd.py``,
  ``parallel/rankdad.py``) could apply; each finding carries the static
  byte-cost model.
- ``wire-lock`` — the lifted schema drifted from the port's checked-in
  lockfile, ``wire_schema_torch.lock.json`` (regenerate with ``--wire
  --write-lock``, which writes that file and nothing else: neither the JAX
  package's ``wire_schema.lock.json`` nor its ``docs/FEDERATION.md``
  table).

The lockfile's entries carry no paths, so the port's schema and the JAX
package's compare entry for entry.  The port's one deliberate protocol
difference, rankDAD's capture plan carried in the site's round file, stays
off the wire (the round file is local state, not a payload), so the two
schemas hold the same entries.

Runtime close-the-loop: ``--reconcile <telemetry dir>`` replays the
``wire`` counter records (and ``daemon:frame`` events) of the port's
telemetry lanes against the static byte ledger, bucketing observed bytes
by their ``payload_kind`` field and reporting anything no schema entry
accounts for as ``wire-unmodeled``.

``wire-config`` is the tier's own error channel; like
``proto-model-config`` it survives any ``--rules`` filter and blocks
``--write-baseline``.

NOTE: the default-tier rule ``wire-atomic-commit`` predates this tier and
shares the ``wire-`` spelling — tier ownership is tracked by the EXACT rule
ids in :data:`WIRE_RULE_IDS`, never by the bare ``wire-`` prefix.
"""
import ast
import json
import os

from ..config.keys import WireContract
from .core import Finding, Module, iter_python_files
from .protocol import (
    PROTOCOL_FILES,
    _Extractor,
    load_vocabulary,
)
from .wire_atomic import (
    _mentions_transfer,
    _open_write_mode,
    _tainted_names,
    save_target,
)
from .core import dotted_name

#: the tier's rule vocabulary — EXACT ids (``wire-atomic-commit`` is a
#: default-tier rule that happens to share the prefix; see module docstring)
WIRE_RULE_IDS = (
    WireContract.ORPHAN,
    WireContract.UNVERSIONED,
    WireContract.DENSE,
    WireContract.LOCK,
    WireContract.UNMODELED,
    WireContract.CONFIG,
)

#: the package the schema is lifted from (display paths start with it)
PACKAGE = "coinstac_dinunet_tpu_torch"

#: boundary files the schema is lifted from, beyond PROTOCOL_FILES
DAEMON_SUFFIX = "federation/daemon.py"
TENSOR_SUFFIX = "utils/tensorutils.py"
TRANSPORT_SUFFIX = "resilience/transport.py"

#: repo-relative suffixes the full lift needs present (a partial scan —
#: single-file lint, editor integration — skips the tier rather than
#: flooding every key of the missing side as an orphan; the package-wide
#: run always has the full set)
WIRE_FILES = tuple(PROTOCOL_FILES) + (
    DAEMON_SUFFIX, TENSOR_SUFFIX, TRANSPORT_SUFFIX,
)

#: version-stamp wire keys (echoed verbatim; LocalWire/RemoteWire.ROUND and
#: ROSTER_EPOCH share these values) and the daemon frame stamp
VERSION_STAMPS = ("wire_round", "roster_epoch")
DAEMON_STAMP = "round"

#: registered wire codecs per tensor key (``None`` → the save_wire int8
#: hook, ``config.wire_codec``, is the applicable codec)
_CODEC_BY_KEY = {
    "powerSGD_P_file": "powerSGD",
    "powerSGD_Q_file": "powerSGD",
    "rank1_file": "powerSGD",
    "dad_data_file": "rankDAD",
    "dad_rest_file": "rankDAD",
}

#: enum members that name file payloads without a ``_FILE`` suffix
_FILE_MEMBERS = {"PRETRAINED_WEIGHTS", "RESULTS_ZIP"}

#: daemon frame fields riding the dirty-key delta lanes
_DELTA_FIELDS = {"cache_patch", "cache_delta", "set", "del"}

#: frame fields carried by the ``{cache, input, state}`` → ``{output,
#: cache}`` node contract itself (produced/consumed outside daemon.py —
#: by engine.py's payload builder and the node scripts); exempt from
#: orphan matching exactly like ENGINE_PROVIDED_KEYS in protocol.py
NODE_CONTRACT_FIELDS = {"cache", "input", "state", "output"}

# ---- daemon frame extraction grammar ---------------------------------------
_WORKER_FUNCS = {"worker_main"}
_ENGINE_CLASSES = {"_Worker", "DaemonEngine", "_FrameReader"}
#: calls whose second (write_frame) / first (.request) argument is a frame
_FRAME_SINKS = {"write_frame", "request"}
#: calls whose assigned result is a received frame (or carries one)
_FRAME_SEEDS = {"read_frame", "_read", "request", "run"}
_CONSUME_METHODS = {"get", "pop", "setdefault"}


class WireEntry:
    """One typed row of the wire-schema IR."""

    __slots__ = ("key", "direction", "producer", "consumer", "payload",
                 "versioned", "codec", "file", "source", "note")

    def __init__(self, key, direction, producer, consumer, payload,
                 versioned, codec=None, file=None, source="handshake",
                 note=None):
        self.key = key
        self.direction = direction
        self.producer = producer
        self.consumer = consumer
        self.payload = payload
        self.versioned = versioned
        self.codec = codec
        self.file = file
        self.source = source
        self.note = note

    def ident(self):
        return (self.direction, self.key)

    def to_dict(self):
        d = {
            "key": self.key, "direction": self.direction,
            "producer": self.producer, "consumer": self.consumer,
            "payload": self.payload, "versioned": self.versioned,
            "codec": self.codec, "file": self.file, "source": self.source,
        }
        if self.payload == "tensor":
            d["bytes_per_round"] = byte_cost_model(self)["formula"]
        if self.note:
            d["note"] = self.note
        return d


class WireSchema:
    """The lifted IR plus the evidence the rule passes anchor findings to."""

    def __init__(self):
        self.entries = []
        #: first (path, line, col) evidence per (direction, key)
        self.uses = {}
        #: {module display path: {"wire_round": bool, "roster_epoch": bool}}
        self.module_stamps = {}
        #: raw (non-choke-point) tensor writes: (path, line, col, how)
        self.raw_writes = []
        #: save_wire choke point carries the codec hook (config.wire_codec)
        # True until the choke point is actually in scope and disproves it:
        # a scan that never read utils/tensorutils.py must not report every
        # tensor entry dense on absence of evidence.
        self.choke_has_codec = True
        #: daemon lanes: {"engine->worker": fields, "worker->engine": fields}
        self.daemon_fields = {}

    def entry(self, direction, key):
        for e in self.entries:
            if e.direction == direction and e.key == key:
                return e
        return None


def byte_cost_model(entry, n_sites="n_sites", dtype_bytes=4):
    """The static byte-cost model of one tensor entry: params × dtype width
    × per-round multiplicity.  Site→agg payloads cross once per site per
    round; agg→site broadcasts are relayed to every site per round — the
    multiplicity is ``n_sites`` either way, which is exactly the
    denominator a codec bench divides observed bytes by."""
    codec = entry.codec
    model = {
        "dtype_bytes": dtype_bytes,
        "multiplicity": f"{n_sites}/round",
        "formula": f"params * {dtype_bytes} B * {n_sites} / round",
        "codec": codec,
    }
    if codec == "int8":
        model["codec_formula"] = (
            f"params * 1 B (+ f32 group scales) * {n_sites} / round"
        )
    elif codec in ("powerSGD", "rankDAD"):
        model["codec_formula"] = (
            f"rank * (rows + cols) * {dtype_bytes} B * {n_sites} / round"
        )
    return model


# --------------------------------------------------------------- daemon lift
class _DaemonLift:
    """Lift the daemon's framed-pipe vocabulary (top-level frame fields +
    the nested delta lanes) from ``federation/daemon.py``.

    Grammar, mirroring ``protocol._Extractor``'s conservatism (only
    statically-resolvable constant keys count):

    - produce: constant keys of dict literals flowing into a
      ``write_frame(stream, X)`` / ``worker.request(X, ...)`` call —
      directly, via a name later passed in, or via constant-key subscript
      stores on such a name (``resp["result"] = clean`` marks ``result``
      produced AND lets ``clean``'s stores contribute nested fields like
      ``cache_delta``/``set``/``del``).
    - consume: ``.get("k")``/``.pop("k")``/``.setdefault("k")`` calls and
      constant-subscript loads on names tainted by a frame-receiving call
      (``read_frame``/``_read``/``request``/``run``), iterated to a fixed
      point through plain assignments.

    Sides: ``worker_main`` is the worker; ``_Worker``/``DaemonEngine``/
    ``_FrameReader`` methods are the engine.
    """

    def __init__(self, module):
        self.module = module
        # side -> {field: (line, col)}
        self.produced = {"engine": {}, "worker": {}}
        self.consumed = {"engine": {}, "worker": {}}

    def run(self):
        for node in self.module.tree.body:
            if isinstance(node, ast.FunctionDef):
                if node.name in _WORKER_FUNCS:
                    self._lift_scope(node, "worker")
            elif isinstance(node, ast.ClassDef):
                if node.name in _ENGINE_CLASSES:
                    for item in node.body:
                        if isinstance(item, ast.FunctionDef):
                            self._lift_scope(item, "engine")
        return self

    @staticmethod
    def _call_name(call):
        f = call.func
        if isinstance(f, ast.Attribute):
            return f.attr
        if isinstance(f, ast.Name):
            return f.id
        return None

    def _record(self, table, side, key, node):
        if isinstance(key, str) and key:
            table[side].setdefault(key, (node.lineno, node.col_offset))

    def _record_dict(self, side, d, node):
        """Record a frame dict literal's constant keys; returns the bare
        names used as field VALUES — those objects ship inside the frame
        (``{"payload": req}`` makes ``req`` itself outbound), so callers
        fold them into the flow."""
        value_names = set()
        for k, v in zip(d.keys, d.values):
            if isinstance(k, ast.Constant) and isinstance(k.value, str):
                self._record(self.produced, side, k.value, node)
            if isinstance(v, ast.Name):
                value_names.add(v.id)
        return value_names

    def _lift_scope(self, fn, side):
        # pass 1: frame objects flowing into a sink — dict literals record
        # their keys directly; only a WHOLE-argument name joins the flow (a
        # name merely interpolated inside an outbound dict, like msg in an
        # error f-string, is not itself an outbound frame)
        flowing = set()
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            name = self._call_name(node)
            if name not in _FRAME_SINKS or not node.args:
                continue
            arg = node.args[1] if (name == "write_frame"
                                   and len(node.args) > 1) else node.args[0]
            if isinstance(arg, ast.Name):
                flowing.add(arg.id)
            for sub in ast.walk(arg):
                if isinstance(sub, ast.Dict):
                    flowing |= self._record_dict(side, sub, sub)
        # pass 2: fixpoint — dict literals / subscript stores on flowing
        # names produce fields; an exact-name value stored into a flowing
        # slot aliases the frame (resp["result"] = clean → clean flows)
        assigns = [n for n in ast.walk(fn) if isinstance(n, ast.Assign)]
        changed = True
        while changed:
            changed = False
            for node in assigns:
                for target in node.targets:
                    if (isinstance(target, ast.Name)
                            and target.id in flowing):
                        joins = set()
                        if isinstance(node.value, ast.Dict):
                            joins |= self._record_dict(side, node.value,
                                                       node)
                        if isinstance(node.value, ast.Name):
                            joins.add(node.value.id)
                        if joins - flowing:
                            flowing |= joins
                            changed = True
                    elif (isinstance(target, ast.Subscript)
                          and isinstance(target.value, ast.Name)
                          and target.value.id in flowing):
                        key = target.slice
                        if (isinstance(key, ast.Constant)
                                and isinstance(key.value, str)):
                            self._record(self.produced, side, key.value,
                                         target)
                        joins = set()
                        if isinstance(node.value, ast.Dict):
                            joins |= self._record_dict(side, node.value,
                                                       node)
                        if isinstance(node.value, ast.Name):
                            joins.add(node.value.id)
                        if joins - flowing:
                            flowing |= joins
                            changed = True
        # pass 3: fixpoint — receiver taint for consumes
        tracked = set()
        changed = True
        while changed:
            changed = False
            for node in assigns:
                seed = False
                for sub in ast.walk(node.value):
                    if (isinstance(sub, ast.Call)
                            and self._call_name(sub) in _FRAME_SEEDS):
                        seed = True
                    if isinstance(sub, ast.Name) and sub.id in tracked:
                        seed = True
                if not seed:
                    continue
                for target in node.targets:
                    names = (target.elts if isinstance(target, ast.Tuple)
                             else [target])
                    for t in names:
                        if isinstance(t, ast.Name) and t.id not in tracked:
                            tracked.add(t.id)
                            changed = True
        # a name that flows into a sink holds an OUTBOUND frame: its reads
        # (the worker re-reading its own resp dict) are not wire consumes
        tracked -= flowing
        for node in ast.walk(fn):
            if isinstance(node, ast.Call):
                f = node.func
                if (isinstance(f, ast.Attribute)
                        and f.attr in _CONSUME_METHODS
                        and isinstance(f.value, ast.Name)
                        and f.value.id in tracked
                        and node.args
                        and isinstance(node.args[0], ast.Constant)
                        and isinstance(node.args[0].value, str)):
                    self._record(self.consumed, side, node.args[0].value,
                                 node)
            elif (isinstance(node, ast.Subscript)
                  and isinstance(node.ctx, ast.Load)
                  and isinstance(node.value, ast.Name)
                  and node.value.id in tracked
                  and isinstance(node.slice, ast.Constant)
                  and isinstance(node.slice.value, str)):
                self._record(self.consumed, side, node.slice.value, node)


# ------------------------------------------------------------- config parse
def _config_file_names(config_source=None):
    """Statically parse ``config/__init__.py``'s wire-filename defaults
    (``grads_file = "grads.npy"`` …) — the runtime basenames reconcile
    matches observed ``wire`` records against.  Never imports."""
    if config_source is None:
        path = os.path.normpath(os.path.join(
            os.path.dirname(__file__), "..", "config", "__init__.py"))
        with open(path, "r", encoding="utf-8") as f:
            config_source = f.read()
    names = {}
    for node in ast.parse(config_source).body:
        if (isinstance(node, ast.Assign)
                and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and isinstance(node.value, ast.Constant)
                and isinstance(node.value.value, str)):
            names[node.targets[0].id] = node.value.value
    return names


def _norm(name):
    return "".join(c for c in name.lower() if c.isalnum())


def _file_for_key(key, config_names):
    """Default runtime basename of a ``*_file`` wire key, or None."""
    by_norm = {_norm(k): v for k, v in config_names.items()}
    hit = by_norm.get(_norm(key))
    if hit:
        return hit
    if key == "pretrained_weights" and "weights_file" in config_names:
        return f"pretrained_{config_names['weights_file']}"
    return None


# ----------------------------------------------------------------- extraction
def _find_package_files(paths):
    """{suffix: filesystem path} for every WIRE_FILES suffix under paths."""
    found = {}
    for path in iter_python_files(list(paths)):
        norm = path.replace(os.sep, "/")
        for suffix in WIRE_FILES:
            # component-boundary match: bare endswith would resolve the
            # "trainer.py" suffix to nn/basetrainer.py
            if norm == suffix or norm.endswith("/" + suffix):
                found[suffix] = path
    return found


def extract_schema(paths=None, files=None, keys_source=None,
                   config_source=None):
    """Lift the wire-schema IR.

    ``files`` (tests/fixtures): ``{suffix: source text}`` — used verbatim,
    no completeness requirement.  Otherwise the boundary modules are
    located under ``paths`` (default: the package) and a partial set
    returns ``None`` (the tier is skipped, mirroring
    ``protocol.ProtocolConformanceRule``'s partial-scan rule).
    """
    if files is None:
        located = _find_package_files(paths or [PACKAGE])
        if set(located) != set(WIRE_FILES):
            return None
        sources = {}
        for suffix, path in located.items():
            with open(path, "r", encoding="utf-8") as f:
                sources[suffix] = (f.read(), path)
    else:
        sources = {
            suffix: (src, f"{PACKAGE}/{suffix}")
            for suffix, src in files.items()
        }

    enum_map, local_vocab, remote_vocab, engine_provided = (
        load_vocabulary(keys_source)
    )
    config_names = _config_file_names(config_source)
    # member names per value, for payload-kind classification
    local_members = {v: m for (cls, m), v in enum_map.items()
                     if cls == "LocalWire"}
    remote_members = {v: m for (cls, m), v in enum_map.items()
                      if cls == "RemoteWire"}

    schema = WireSchema()
    produced = {"site": [], "agg": []}
    consumed = {"site": [], "agg": []}
    modules = {}
    for suffix, (src, display) in sources.items():
        try:
            modules[suffix] = Module(display, src, ast.parse(src))
        except SyntaxError as exc:
            raise ValueError(f"{display}: {exc}") from exc

    for suffix, default_side in PROTOCOL_FILES.items():
        mod = modules.get(suffix)
        if mod is None:
            continue
        ex = _Extractor(mod, default_side, enum_map)
        ex.visit(mod.tree)
        for side in ("site", "agg"):
            produced[side].extend(ex.produced[side])
            consumed[side].extend(ex.consumed[side])
        if suffix in ("nodes/local.py", "nodes/remote.py"):
            own_side = "site" if suffix == "nodes/local.py" else "agg"
            keys = {u.key for u in ex.produced[own_side]}
            schema.module_stamps[mod.path] = {
                stamp: stamp in keys for stamp in VERSION_STAMPS
            }

    def first_use(uses, key):
        hits = [u for u in uses if u.key == key]
        if not hits:
            return None
        u = min(hits, key=lambda u: (u.path, u.line))
        return (u.path, u.line, u.col)

    def classify(key, members):
        member = members.get(key, "")
        if member.endswith("_FILE") or member in _FILE_MEMBERS:
            return "tensor"
        return "json"

    def stamp_ok(suffix):
        mod = modules.get(suffix)
        if mod is None:
            return False
        stamps = schema.module_stamps.get(mod.path, {})
        return all(stamps.get(s) for s in VERSION_STAMPS)

    lanes = (
        ("site->agg", produced["site"], consumed["agg"], local_members,
         "site", "agg", stamp_ok("nodes/local.py")),
        ("agg->site", produced["agg"], consumed["site"], remote_members,
         "agg", "site", stamp_ok("nodes/remote.py")),
    )
    for (direction, prod, cons, members, prod_kind, cons_kind,
         versioned) in lanes:
        prod_keys = {u.key for u in prod}
        cons_keys = {u.key for u in cons}
        for key in sorted(prod_keys | cons_keys):
            payload = classify(key, members)
            is_engine = key in engine_provided
            codec = None
            file_name = None
            if payload == "tensor":
                codec = _CODEC_BY_KEY.get(key, "int8")
                file_name = _file_for_key(key, config_names)
                if key == "results_zip":
                    codec = None
            entry = WireEntry(
                key=key, direction=direction,
                producer=("engine" if is_engine
                          else prod_kind if key in prod_keys else None),
                consumer=cons_kind if key in cons_keys else None,
                payload=payload,
                versioned=bool(versioned) or key in VERSION_STAMPS
                or is_engine,
                codec=codec, file=file_name,
                source="handshake",
                note=("engine-provided (compspec injection)" if is_engine
                      else "version stamp (echoed verbatim)"
                      if key in VERSION_STAMPS else None),
            )
            schema.entries.append(entry)
            use = first_use(list(prod) + list(cons), key)
            if use:
                schema.uses[entry.ident()] = use

    # ---- daemon frames
    daemon_mod = modules.get(DAEMON_SUFFIX)
    if daemon_mod is not None:
        lift = _DaemonLift(daemon_mod).run()
        daemon_lanes = (
            ("engine->worker", lift.produced["engine"],
             lift.consumed["worker"], "daemon-engine", "daemon-worker"),
            ("worker->engine", lift.produced["worker"],
             lift.consumed["engine"], "daemon-worker", "daemon-engine"),
        )
        for direction, prod, cons, prod_kind, cons_kind in daemon_lanes:
            fields = sorted(set(prod) | set(cons))
            schema.daemon_fields[direction] = fields
            versioned = DAEMON_STAMP in prod
            for field in fields:
                entry = WireEntry(
                    key=field, direction=direction,
                    producer=prod_kind if field in prod else None,
                    consumer=cons_kind if field in cons else None,
                    payload=("delta" if field in _DELTA_FIELDS else "json"),
                    versioned=bool(versioned) or field == DAEMON_STAMP,
                    source="daemon",
                    note=("frame round stamp (echoed verbatim)"
                          if field == DAEMON_STAMP else None),
                )
                schema.entries.append(entry)
                at = prod.get(field) or cons.get(field)
                if at:
                    schema.uses[entry.ident()] = (
                        daemon_mod.path, at[0], at[1]
                    )

    # ---- dense-path evidence: raw tensor writes + the codec choke point
    tensor_mod = modules.get(TENSOR_SUFFIX)
    if tensor_mod is not None:
        schema.choke_has_codec = any(
            (isinstance(n, ast.Name) and n.id == "wire_codec")
            or (isinstance(n, ast.Attribute) and n.attr == "wire_codec")
            for n in ast.walk(tensor_mod.tree)
        )
    for suffix, mod in modules.items():
        if suffix in (TRANSPORT_SUFFIX,):
            continue  # the sanctioned writer itself
        tainted = _tainted_names(mod.tree)
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            target = how = None
            func_name = dotted_name(node.func, require_name_root=False) or ""
            if isinstance(node.func, ast.Name) and node.func.id == "open":
                mode = _open_write_mode(node)
                if mode and node.args:
                    target, how = node.args[0], f"open(..., {mode!r})"
            elif save_target(node, func_name) is not None:
                target, how = save_target(node, func_name), f"{func_name}(...)"
            if target is not None and _mentions_transfer(target, tainted):
                schema.raw_writes.append(
                    (mod.path, node.lineno, node.col_offset, how)
                )

    schema.entries.sort(key=lambda e: (e.direction, e.key))
    return schema


# ----------------------------------------------------------------- the rules
def _finding(rule, schema, ident, message, fallback_path):
    use = schema.uses.get(ident) if ident else None
    path, line, col = use if use else (fallback_path, 1, 0)
    return Finding(rule=rule, path=path, line=line, col=col, message=message)


def orphan_findings(schema, fallback_path=PACKAGE):
    out = []
    for e in schema.entries:
        if e.producer == "engine" or e.note and "engine-provided" in e.note:
            continue
        if e.source == "daemon" and e.key in NODE_CONTRACT_FIELDS:
            continue
        if e.producer is None:
            out.append(_finding(
                WireContract.ORPHAN, schema, e.ident(),
                f"{e.direction} {e.payload} key '{e.key}' is consumed but "
                "has no producer on the peer side — silent schema drift "
                "(the consumer reads a field nothing ever sends)",
                fallback_path,
            ))
        elif e.consumer is None:
            out.append(_finding(
                WireContract.ORPHAN, schema, e.ident(),
                f"{e.direction} {e.payload} key '{e.key}' is produced but "
                "never consumed by the peer — dead wire traffic (or the "
                "consumer's read was silently dropped)",
                fallback_path,
            ))
    return out


def unversioned_findings(schema, fallback_path=PACKAGE):
    out = []
    for path, stamps in sorted(schema.module_stamps.items()):
        for stamp in VERSION_STAMPS:
            if not stamps.get(stamp):
                out.append(Finding(
                    rule=WireContract.UNVERSIONED, path=path, line=1, col=0,
                    message=(
                        f"boundary module ships wire payloads without "
                        f"echoing the '{stamp}' version stamp — the "
                        "staleness window / roster-epoch machinery cannot "
                        "refuse stale or dead-incarnation deliveries of "
                        "these payloads"
                    ),
                ))
    for direction in sorted(schema.daemon_fields):
        fields = schema.daemon_fields[direction]
        producer_fields = [
            e.key for e in schema.entries
            if e.source == "daemon" and e.direction == direction
            and e.producer is not None
        ]
        if fields and DAEMON_STAMP not in producer_fields:
            ident = None
            for e in schema.entries:
                if e.source == "daemon" and e.direction == direction:
                    ident = e.ident()
                    break
            out.append(_finding(
                WireContract.UNVERSIONED, schema, ident,
                f"daemon {direction} frames carry no '{DAEMON_STAMP}' "
                "stamp — a response cannot be correlated to the round "
                "that requested it (redelivery/desync is undetectable "
                "on the frame lane)",
                fallback_path,
            ))
    return out


def dense_findings(schema, fallback_path=PACKAGE):
    out = []
    codecs = "int8 (ops/quantize via save_wire), powerSGD, rankDAD"
    for path, line, col, how in schema.raw_writes:
        out.append(Finding(
            rule=WireContract.DENSE, path=path, line=line, col=col,
            message=(
                f"{how} ships a full-tensor wire payload outside the "
                "codec-capable save_wire choke point — byte cost: params "
                "* 4 B * n_sites / round, with registered codecs "
                f"({codecs}) unable to apply"
            ),
        ))
    if not schema.choke_has_codec:
        for e in schema.entries:
            if e.payload != "tensor" or e.codec is None:
                continue
            model = byte_cost_model(e)
            out.append(_finding(
                WireContract.DENSE, schema, e.ident(),
                f"tensor key '{e.key}' rides a choke point with no codec "
                f"hook — byte cost {model['formula']}; registered codec "
                f"'{e.codec}' could apply",
                fallback_path,
            ))
    return out


# ------------------------------------------------------------------ lockfile
LOCK_COMMENT = (
    "dinulint --wire schema lockfile of the PyTorch port: the pinned wire "
    "contract every run is ratcheted against (same contract as "
    "dinulint_torch_baseline.json — any wire-contract change must be "
    "explicit in this file's diff).  Regenerate: python -m "
    "coinstac_dinunet_tpu_torch.analysis coinstac_dinunet_tpu_torch "
    "--wire --write-lock"
)


def lock_payload(schema):
    return {
        "v": 1,
        "comment": LOCK_COMMENT,
        "entries": [e.to_dict() for e in schema.entries],
    }


def write_lock(path, schema):
    payload = lock_payload(schema)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(payload, f, indent=2, sort_keys=True)
        f.write("\n")
    return payload


def load_lock(path):
    with open(path, "r", encoding="utf-8") as f:
        data = json.load(f)
    if not isinstance(data, dict) or not isinstance(
            data.get("entries"), list):
        raise ValueError(f"{path}: not a wire-schema lockfile")
    return data


def lock_findings(schema, lock_data, lock_path):
    """Drift between the extracted schema and the checked-in lockfile."""
    out = []
    current = {e.ident(): e.to_dict() for e in schema.entries}
    locked = {}
    for item in lock_data.get("entries", ()):
        if isinstance(item, dict) and "key" in item and "direction" in item:
            locked[(item["direction"], item["key"])] = item
    for ident in sorted(set(current) - set(locked)):
        out.append(_finding(
            WireContract.LOCK, schema, ident,
            f"wire entry '{ident[1]}' ({ident[0]}) is not in the schema "
            f"lockfile — a new boundary-crossing artifact; regenerate "
            f"{os.path.basename(lock_path)} via --write-lock to accept it",
            lock_path,
        ))
    for ident in sorted(set(locked) - set(current)):
        out.append(Finding(
            rule=WireContract.LOCK, path=lock_path, line=1, col=0,
            message=(
                f"wire entry '{ident[1]}' ({ident[0]}) is in the schema "
                "lockfile but no longer in the code — a removed contract "
                "entry; regenerate via --write-lock to accept the removal"
            ),
        ))
    for ident in sorted(set(locked) & set(current)):
        cur, old = current[ident], locked[ident]
        drifted = sorted(
            k for k in set(cur) | set(old)
            if k not in ("note",) and cur.get(k) != old.get(k)
        )
        if drifted:
            detail = "; ".join(
                f"{k}: {old.get(k)!r} -> {cur.get(k)!r}" for k in drifted
            )
            out.append(_finding(
                WireContract.LOCK, schema, ident,
                f"wire entry '{ident[1]}' ({ident[0]}) drifted from the "
                f"schema lockfile ({detail}); regenerate via --write-lock "
                "to accept the change",
                lock_path,
            ))
    return out


# -------------------------------------------------------------- byte ledger
def build_ledger(schema):
    """The static byte-cost ledger: one row per entry, with the cost model
    evaluated symbolically (params/n_sites are run-shaped) — the per-path
    denominator a codec bench divides observed bytes by."""
    rows = []
    for e in schema.entries:
        row = {"key": e.key, "direction": e.direction,
               "payload": e.payload, "source": e.source}
        if e.payload == "tensor":
            row.update(byte_cost_model(e))
            row["file"] = e.file
        rows.append(row)
    return {
        "v": 1,
        "comment": (
            "dinulint --wire static byte-cost ledger: params * dtype * "
            "per-round multiplicity per tensor path; json/delta lanes "
            "are accounted by --reconcile against observed telemetry"
        ),
        "entries": rows,
    }


def write_ledger(path, schema):
    payload = build_ledger(schema)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(payload, f, indent=2, sort_keys=True)
        f.write("\n")
    return payload


# ---------------------------------------------------------------- reconcile
def _iter_telemetry_records(telemetry_dir):
    for root, _dirs, names in os.walk(telemetry_dir):
        for name in sorted(names):
            if not (name.startswith("telemetry.")
                    and name.endswith(".jsonl")):
                continue
            path = os.path.join(root, name)
            try:
                with open(path, "r", encoding="utf-8") as f:
                    for line in f:
                        line = line.strip()
                        if not line:
                            continue
                        try:
                            yield json.loads(line)
                        except ValueError:
                            continue
            except OSError:
                continue


def _match_tensor_record(rec, tensor_files, tensor_stems):
    base = str(rec.get("file", ""))
    if base in tensor_files:
        return True
    low = _norm(base)
    return any(stem and stem in low for stem in tensor_stems)


def reconcile_findings(schema, telemetry_dir, fallback_path=PACKAGE):
    """Compare the static schema against observed ``wire`` counter
    records (and ``daemon:frame`` events), bucketed by ``payload_kind``.
    Unaccounted observed bytes → ``wire-unmodeled``."""
    tensor_files = {e.file for e in schema.entries
                    if e.payload == "tensor" and e.file}
    tensor_stems = {
        _norm(e.key[: -len("_file")] if e.key.endswith("_file") else e.key)
        for e in schema.entries if e.payload == "tensor"
    }
    daemon_kinds = {e.payload for e in schema.entries
                    if e.source == "daemon"}
    unmodeled = {}  # payload_kind -> [bytes, examples]
    saw_any = False

    def miss(kind, nbytes, example):
        slot = unmodeled.setdefault(kind, [0, []])
        slot[0] += int(nbytes)
        if example and example not in slot[1] and len(slot[1]) < 5:
            slot[1].append(example)

    for rec in _iter_telemetry_records(telemetry_dir):
        kind = rec.get("kind")
        if kind == "wire":
            saw_any = True
            pk = rec.get("payload_kind")
            if pk is None:
                miss("(unlabeled)", rec.get("bytes", 0),
                     str(rec.get("file", "")))
            elif pk == "tensor":
                if not _match_tensor_record(rec, tensor_files,
                                            tensor_stems):
                    miss("tensor", rec.get("bytes", 0),
                         str(rec.get("file", "")))
            elif pk not in ("json", "delta"):
                miss(str(pk), rec.get("bytes", 0),
                     str(rec.get("file", "")))
        elif kind == "event" and rec.get("name") == "daemon:frame":
            saw_any = True
            pk = rec.get("payload_kind")
            nbytes = int(rec.get("tx_bytes", 0)) + int(
                rec.get("rx_bytes", 0))
            if pk is None:
                miss("(unlabeled)", nbytes, "daemon:frame")
            elif pk not in daemon_kinds:
                miss(str(pk), nbytes, "daemon:frame")

    out = []
    if not saw_any:
        out.append(Finding(
            rule=WireContract.CONFIG, path=fallback_path, line=1, col=0,
            message=(
                f"--reconcile {telemetry_dir}: no wire telemetry records "
                "found (telemetry.*.jsonl with kind=wire) — run with "
                "profile=True before reconciling"
            ),
        ))
    for kind in sorted(unmodeled):
        nbytes, examples = unmodeled[kind]
        out.append(Finding(
            rule=WireContract.UNMODELED, path=fallback_path, line=1, col=0,
            message=(
                f"{nbytes} observed wire bytes with payload_kind '{kind}' "
                "match no schema entry (examples: "
                f"{', '.join(examples) or 'n/a'}) — the static byte "
                "ledger under-models the live wire"
            ),
        ))
    return out


# --------------------------------------------------------- the tier's entry
DEFAULT_LOCK = WireContract.LOCKFILE
#: the JAX package's lockfile, which this tier reads in the tests and never
#: writes
JAX_LOCK = "wire_schema.lock.json"


def run_wire(paths=None, lock_path=None, write_lock_file=False,
             reconcile_dir=None, ledger_path=None, files=None,
             keys_source=None, config_source=None):
    """The ``--wire`` tier entry point: lift, check, ratchet, reconcile.
    Returns (findings, schema); schema is None on a partial scan."""
    lock_path = lock_path or DEFAULT_LOCK
    if write_lock_file and os.path.basename(lock_path) == JAX_LOCK:
        return [Finding(
            rule=WireContract.CONFIG, path=lock_path, line=1, col=0,
            message=f"refusing to write {JAX_LOCK}: it is the JAX "
                    f"package's lockfile; the port's is {DEFAULT_LOCK}",
        )], None
    try:
        schema = extract_schema(paths=paths, files=files,
                                keys_source=keys_source,
                                config_source=config_source)
    except (OSError, ValueError) as exc:
        return [Finding(
            rule=WireContract.CONFIG, path=PACKAGE, line=1, col=0,
            message=f"wire-schema extraction failed: {exc}",
        )], None
    if schema is None:
        return [], None

    findings = []
    findings += orphan_findings(schema)
    findings += unversioned_findings(schema)
    findings += dense_findings(schema)

    if write_lock_file:
        write_lock(lock_path, schema)
    elif os.path.exists(lock_path):
        try:
            lock_data = load_lock(lock_path)
            findings += lock_findings(schema, lock_data, lock_path)
        except (OSError, ValueError) as exc:
            findings.append(Finding(
                rule=WireContract.CONFIG, path=lock_path, line=1, col=0,
                message=f"unreadable wire-schema lockfile: {exc}",
            ))
    else:
        findings.append(Finding(
            rule=WireContract.CONFIG, path=lock_path, line=1, col=0,
            message=(
                f"wire-schema lockfile {lock_path} is missing — the "
                "contract ratchet cannot run; generate it with "
                "--write-lock and check it in"
            ),
        ))

    if ledger_path:
        write_ledger(ledger_path, schema)
    if reconcile_dir:
        findings += reconcile_findings(schema, reconcile_dir)

    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings, schema

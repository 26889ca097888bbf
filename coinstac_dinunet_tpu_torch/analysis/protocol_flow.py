"""proto-flow-* / proto-cache-*: the static phase-machine model of the
port's round protocol (the AST half of the analyzer's ``--tier3``).

The ``protocol-conformance`` rule proves every wire key has a producer and
a consumer *somewhere*.  This module models **when**: the
invocation-per-round phase machine (INIT_RUNS → NEXT_RUN →
PRE_COMPUTATION → COMPUTATION… → NEXT_RUN_WAITING → SUCCESS, the
``PHASE_TRANSITIONS`` contract in the port's ``config/keys.py``) is
reconstructed from the AST of its ``nodes/local.py`` / ``nodes/remote.py``
— each ``if out[PHASE] == Phase.X`` / ``check(all, PHASE, Phase.X, input)``
dispatch block is one phase, self-method calls are followed transitively —
and the following are reported:

- ``proto-flow-phase`` — a phase value one side writes into its round
  output that the peer's dispatch never tests: the message arrives and
  falls through every branch (a silently idle round).
- ``proto-flow-unmatched`` — a wire key with no consumer on the peer at
  all, or whose producing block's outgoing phases never overlap the
  phases its only consumers are guarded on (the payload always arrives in
  a round that skips the consuming branch).
- ``proto-cache-read-before-write`` — a hard ``cache[k]`` read in a phase
  that no writing phase can precede under ``PHASE_TRANSITIONS`` (crashes
  the first time that branch runs).
- ``proto-cache-never-read`` — a cache key written by a node that nothing
  in the package ever reads (dead wire-round state).

The JAX package's fifth rule, ``proto-cache-volatile``, has no counterpart
here: it flags a mid-round cache write missing from that package's
``nn/basetrainer.py::_VOLATILE_CACHE_KEYS``, the keys its compiled-step
bucket ignores, because any other write changes the bucket key and the
steady-state round recompiles.  The port compiles no step and keeps no
bucket key (its steps run eagerly), so a cache write costs it nothing of
the kind and there is no list to hold writes against.

Pure stdlib ``ast``, no ``torch``.  Extraction is deliberately
conservative: only statically-resolvable keys and phase values
participate; dynamic writes (``cache.update(**blob)``) are wildcard events
that satisfy, never trigger, the lifecycle checks.
"""
import ast
import os

from .core import Finding, Module
from .protocol import _resolve_key, load_vocabulary

_WILDCARD = "*"


def _package_root():
    return os.path.normpath(
        os.path.join(os.path.dirname(__file__), "..")
    )


def _read_source(path):
    with open(path, "r", encoding="utf-8") as f:
        return f.read()


def load_phase_transitions(keys_source=None):
    """Parse ``config/keys.py``'s ``PHASE_TRANSITIONS`` dict into
    {phase value: (successor values...)}; falls back to the linear
    declaration order of ``Phase`` when the contract is absent."""
    if keys_source is None:
        keys_source = _read_source(
            os.path.join(_package_root(), "config", "keys.py")
        )
    tree = ast.parse(keys_source)
    enum_map, _, _, _ = load_vocabulary(keys_source)
    transitions = {}
    for node in ast.walk(tree):
        if (
            isinstance(node, ast.Assign)
            and any(isinstance(t, ast.Name) and t.id == "PHASE_TRANSITIONS"
                    for t in node.targets)
            and isinstance(node.value, ast.Dict)
        ):
            for k_node, v_node in zip(node.value.keys, node.value.values):
                key = _resolve_key(k_node, enum_map)
                if key is None or not isinstance(v_node, (ast.Tuple, ast.List)):
                    continue
                succ = tuple(
                    s for s in (
                        _resolve_key(elt, enum_map) for elt in v_node.elts
                    ) if s is not None
                )
                transitions[key] = succ
    if transitions:
        return transitions
    # fallback: Phase declaration order as a linear chain
    order = [v for (cls, _), v in enum_map.items() if cls == "Phase"]
    return {a: (b,) for a, b in zip(order, order[1:])} | (
        {order[-1]: ()} if order else {}
    )


def _reachability(transitions):
    """phase -> frozenset of phases reachable from it (reflexive)."""
    out = {}
    for start in transitions:
        seen = {start}
        frontier = [start]
        while frontier:
            for nxt in transitions.get(frontier.pop(), ()):
                if nxt not in seen:
                    seen.add(nxt)
                    frontier.append(nxt)
        out[start] = frozenset(seen)
    return out


# ------------------------------------------------------------- AST events
class _Event:
    __slots__ = ("key", "phase", "line", "col", "kind")

    def __init__(self, key, phase, node, kind):
        self.key, self.phase, self.kind = key, phase, kind
        self.line, self.col = node.lineno, node.col_offset


def _is_cache_base(node):
    return (isinstance(node, ast.Name) and node.id == "cache") or (
        isinstance(node, ast.Attribute) and node.attr == "cache"
    )


def _is_out_base(node):
    return (isinstance(node, ast.Name) and node.id == "out") or (
        isinstance(node, ast.Attribute) and node.attr == "out"
    )


def _contains_input(node):
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name) and sub.id == "input":
            return True
        if isinstance(sub, ast.Attribute) and sub.attr == "input":
            return True
    return False


class _NodeModel:
    """Phase-attributed wire/cache events of one node class (the class in
    the module that defines ``compute``)."""

    def __init__(self, module, enum_map, phase_key="phase"):
        self.module = module
        self.enum_map = enum_map
        self.phase_key = phase_key
        self.produced = []       # _Event (wire out[...] writes)
        self.consumed = []       # _Event (input reads)
        self.outgoing = {}       # phase -> set of PHASE values written there
        self.cache_writes = []   # _Event (kind: 'write'|'wildcard')
        self.cache_reads = []    # _Event (kind: 'hard'|'soft')
        self.tested_phases = set()  # phase values this side dispatches on
        self.methods = {}
        self.class_name = None
        self._find_class()
        if self.methods.get("compute") is not None:
            self._visit_region(self.methods["compute"].body, None, set())
        # phase guards anywhere in the file (e.g. the success check in
        # __call__) count as "this side handles that phase"
        self.tested_phases |= self._phases_tested_anywhere()
        # consumption OUTSIDE the compute tree (constructors adopting
        # shared_args, __call__ guards) still satisfies the matching —
        # recorded phase-less so it matches any arrival phase
        self._consume_anywhere()

    # ------------------------------------------------------------ structure
    def _find_class(self):
        for node in self.module.tree.body:
            if isinstance(node, ast.ClassDef):
                methods = {
                    n.name: n for n in node.body
                    if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
                }
                if "compute" in methods:
                    self.class_name = node.name
                    self.methods = methods
                    return

    def _phases_tested_anywhere(self):
        found = set()
        for node in ast.walk(self.module.tree):
            phase = self._phase_of_test(node)
            if phase is not None:
                found.add(phase)
        return found

    _SITE_VAR_NAMES = ("site", "site_vars")

    def _consume_anywhere(self):
        """File-wide input/site-payload reads, phase-less, deduped against
        the compute-tree events by source location."""
        seen = {(e.line, e.col) for e in self.consumed}

        def add(key, node):
            if key is not None and (node.lineno, node.col_offset) not in seen:
                self.consumed.append(_Event(key, None, node, "consume"))

        def peer_base(base):
            return _contains_input(base) or (
                isinstance(base, ast.Name)
                and base.id in self._SITE_VAR_NAMES
            )

        for node in ast.walk(self.module.tree):
            if isinstance(node, ast.Subscript) and isinstance(
                node.ctx, ast.Load
            ) and peer_base(node.value):
                add(_resolve_key(node.slice, self.enum_map), node)
            elif isinstance(node, ast.Call):
                fn = node.func
                name = fn.attr if isinstance(fn, ast.Attribute) else None
                if name == "get" and node.args and peer_base(fn.value):
                    add(_resolve_key(node.args[0], self.enum_map), node)
                elif name == "check" and len(node.args) >= 2:
                    add(_resolve_key(node.args[1], self.enum_map), node)
            elif isinstance(node, ast.Compare) and len(node.ops) == 1 and (
                isinstance(node.ops[0], (ast.In, ast.NotIn))
            ) and peer_base(node.comparators[0]):
                add(_resolve_key(node.left, self.enum_map), node)

    # ---------------------------------------------------------- phase guard
    def _phase_values(self):
        return {
            v for (cls, _), v in self.enum_map.items() if cls == "Phase"
        }

    def _phase_of_test(self, test):
        """Phase value a guard expression dispatches on, or None.

        Recognizes ``<out/input>[PHASE-key] == Phase.X`` compares and
        ``check(_, PHASE-key, Phase.X, ...)`` calls, anywhere inside the
        expression."""
        phase_values = self._phase_values()
        for node in ast.walk(test) if isinstance(test, ast.AST) else ():
            if isinstance(node, ast.Compare) and len(node.comparators) == 1:
                sides = (node.left, node.comparators[0])
                keys = [_resolve_key(s, self.enum_map) for s in sides]
                if any(
                    isinstance(s, ast.Subscript)
                    and _resolve_key(s.slice, self.enum_map) == self.phase_key
                    for s in sides
                ) and any(k in phase_values for k in keys if k):
                    return next(k for k in keys if k in phase_values)
            if isinstance(node, ast.Call) and len(node.args) >= 3:
                fn = node.func
                name = fn.attr if isinstance(fn, ast.Attribute) else (
                    fn.id if isinstance(fn, ast.Name) else None
                )
                if name == "check":
                    key = _resolve_key(node.args[1], self.enum_map)
                    val = _resolve_key(node.args[2], self.enum_map)
                    if key == self.phase_key and val in phase_values:
                        return val
        return None

    # -------------------------------------------------------------- regions
    def _visit_region(self, stmts, phase, visiting):
        for stmt in stmts:
            if isinstance(stmt, ast.If):
                block_phase = self._phase_of_test(stmt.test)
                if block_phase is not None:
                    self.tested_phases.add(block_phase)
                self._record_expr(stmt.test, phase, visiting)
                self._visit_region(stmt.body, block_phase or phase, visiting)
                self._visit_region(stmt.orelse, phase, visiting)
            elif isinstance(stmt, (ast.For, ast.While, ast.With,
                                   ast.AsyncWith, ast.AsyncFor)):
                for attr in ("iter", "test"):
                    if hasattr(stmt, attr):
                        self._record_expr(getattr(stmt, attr), phase, visiting)
                if hasattr(stmt, "items"):
                    for item in stmt.items:
                        self._record_expr(item.context_expr, phase, visiting)
                self._visit_region(stmt.body, phase, visiting)
                self._visit_region(getattr(stmt, "orelse", []), phase, visiting)
            elif isinstance(stmt, ast.Try):
                self._visit_region(stmt.body, phase, visiting)
                for handler in stmt.handlers:
                    self._visit_region(handler.body, phase, visiting)
                self._visit_region(stmt.orelse, phase, visiting)
                self._visit_region(stmt.finalbody, phase, visiting)
            else:
                self._record_stmt(stmt, phase, visiting)

    # ------------------------------------------------------------ recording
    def _record_stmt(self, stmt, phase, visiting):
        if isinstance(stmt, ast.Assign):
            for target in stmt.targets:
                self._record_store(target, phase, value=stmt.value)
            self._record_expr(stmt.value, phase, visiting)
        elif isinstance(stmt, ast.AugAssign):
            self._record_store(stmt.target, phase)
            if isinstance(stmt.target, ast.Subscript):
                self._record_subscript_read(stmt.target, phase, hard=True)
            self._record_expr(stmt.value, phase, visiting)
        elif isinstance(stmt, (ast.Expr, ast.Return)) and stmt.value is not None:
            self._record_expr(stmt.value, phase, visiting)
        elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
            pass  # nested defs: out of the phase machine
        else:
            for child in ast.iter_child_nodes(stmt):
                if isinstance(child, ast.expr):
                    self._record_expr(child, phase, visiting)

    def _record_store(self, target, phase, value=None):
        # `out = {K: V, ...}` dict-literal rebinds of an out-named local
        # (the learner-method producer idiom) produce every const key
        if (
            isinstance(target, (ast.Name, ast.Attribute))
            and _is_out_base(target)
            and isinstance(value, ast.Dict)
        ):
            for k_node, v_node in zip(value.keys, value.values):
                key = k_node and _resolve_key(k_node, self.enum_map)
                if key is None:
                    continue
                self.produced.append(_Event(key, phase, target, "produce"))
                if key == self.phase_key:
                    self._record_outgoing(v_node, phase)
            return
        if not isinstance(target, ast.Subscript):
            return
        base = target.value
        key = _resolve_key(target.slice, self.enum_map)
        if _is_out_base(base):
            if key is None:
                return
            self.produced.append(_Event(key, phase, target, "produce"))
            if key == self.phase_key:
                self._record_outgoing(value, phase)
        elif _is_cache_base(base):
            self.cache_writes.append(_Event(
                key if key is not None else _WILDCARD, phase, target, "write"
            ))

    def _record_outgoing(self, value_node, phase):
        """``out[PHASE] = <value>``: a resolvable Phase value is a phase
        transition of the current block."""
        if value_node is None:
            return
        val = _resolve_key(value_node, self.enum_map)
        if val in self._phase_values():
            self.outgoing.setdefault(phase, set()).add(val)

    def _record_subscript_read(self, node, phase, hard):
        base = node.value
        key = _resolve_key(node.slice, self.enum_map)
        if _is_cache_base(base) and key is not None:
            self.cache_reads.append(
                _Event(key, phase, node, "hard" if hard else "soft")
            )
        elif _contains_input(base) and key is not None:
            self.consumed.append(_Event(key, phase, node, "consume"))

    def _record_expr(self, expr, phase, visiting):
        if expr is None:
            return
        for node in ast.walk(expr):
            if isinstance(node, ast.Subscript) and isinstance(
                node.ctx, ast.Load
            ):
                self._record_subscript_read(node, phase, hard=True)
            elif isinstance(node, ast.Compare) and len(node.ops) == 1 and (
                isinstance(node.ops[0], (ast.In, ast.NotIn))
            ):
                key = _resolve_key(node.left, self.enum_map)
                target = node.comparators[0]
                if key is not None:
                    if _is_cache_base(target):
                        self.cache_reads.append(
                            _Event(key, phase, node, "soft")
                        )
                    elif _contains_input(target):
                        self.consumed.append(
                            _Event(key, phase, node, "consume")
                        )
            elif isinstance(node, ast.Call):
                self._record_call(node, phase, visiting)

    def _record_call(self, node, phase, visiting):
        fn = node.func
        name = fn.attr if isinstance(fn, ast.Attribute) else (
            fn.id if isinstance(fn, ast.Name) else None
        )
        if name in ("get", "pop", "setdefault") and isinstance(
            fn, ast.Attribute
        ) and node.args:
            key = _resolve_key(node.args[0], self.enum_map)
            base = fn.value
            if key is not None and _is_cache_base(base):
                self.cache_reads.append(_Event(key, phase, node, "soft"))
                if name == "setdefault":
                    self.cache_writes.append(
                        _Event(key, phase, node, "write")
                    )
            elif key is not None and _contains_input(base):
                self.consumed.append(_Event(key, phase, node, "consume"))
        elif name == "update" and isinstance(fn, ast.Attribute) and (
            _is_cache_base(fn.value)
        ):
            for kw in node.keywords:
                if kw.arg is None:
                    # **expr: a dict literal contributes its const keys,
                    # anything else is a wildcard write
                    if isinstance(kw.value, ast.Dict):
                        for k_node in kw.value.keys:
                            key = k_node and _resolve_key(
                                k_node, self.enum_map
                            )
                            if key is not None:
                                self.cache_writes.append(
                                    _Event(key, phase, node, "write")
                                )
                    else:
                        self.cache_writes.append(
                            _Event(_WILDCARD, phase, node, "wildcard")
                        )
                else:
                    self.cache_writes.append(
                        _Event(kw.arg, phase, node, "write")
                    )
            if node.args:
                self.cache_writes.append(
                    _Event(_WILDCARD, phase, node, "wildcard")
                )
        elif name == "check" and len(node.args) >= 2:
            key = _resolve_key(node.args[1], self.enum_map)
            if key is not None:
                self.consumed.append(_Event(key, phase, node, "consume"))
        elif (
            isinstance(fn, ast.Attribute)
            and isinstance(fn.value, ast.Name)
            and fn.value.id == "self"
            and name in self.methods
            and name not in visiting
        ):
            # follow self-method calls transitively (cycle-guarded): their
            # wire/cache events belong to the calling phase
            self._visit_region(
                self.methods[name].body, phase, visiting | {name}
            )


# ------------------------------------------------------------ whole check
class ProtocolFlowAnalyzer:
    """Run the phase-machine checks over a (local, remote) module pair.

    ``read_scan_modules`` (optional) is the wider module set whose cache
    reads keep ``proto-cache-never-read`` honest — pass the whole package
    for real runs, or just the pair for fixtures."""

    def __init__(self, local_module, remote_module, keys_source=None,
                 read_scan_modules=None):
        self.enum_map, self.local_vocab, self.remote_vocab, self.engine_keys \
            = load_vocabulary(keys_source)
        self.transitions = load_phase_transitions(keys_source)
        self.reach = _reachability(self.transitions)
        self.local = _NodeModel(local_module, self.enum_map)
        self.remote = _NodeModel(remote_module, self.enum_map)
        self.read_scan_modules = list(read_scan_modules or [])

    # ------------------------------------------------------------- helpers
    def _precedes(self, write_phase, read_phase):
        """True when some round ordering runs ``write_phase`` before (or
        at) ``read_phase`` — i.e. the read phase is reachable from the
        writing phase under PHASE_TRANSITIONS (reflexive)."""
        if write_phase is None or read_phase is None:
            return True  # unguarded code runs every invocation
        return read_phase in self.reach.get(write_phase, frozenset())

    # -------------------------------------------------------------- checks
    def run(self):
        findings = []
        findings += self._check_phase_dispatch()
        findings += self._check_wire_flow()
        for side in (self.local, self.remote):
            findings += self._check_cache_lifecycle(side)
        findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
        return findings

    def _check_phase_dispatch(self):
        findings = []
        for sender, receiver, direction in (
            (self.local, self.remote, "site->aggregator"),
            (self.remote, self.local, "aggregator->site"),
        ):
            outgoing = set()
            for values in sender.outgoing.values():
                outgoing |= values
            for phase in sorted(outgoing - receiver.tested_phases):
                findings.append(Finding(
                    rule="proto-flow-phase", path=sender.module.path,
                    line=1, col=0,
                    message=(
                        f"{direction}: phase value '{phase}' is written "
                        "into the round output but the peer's dispatch "
                        "never tests it — the next invocation falls "
                        "through every phase branch"
                    ),
                ))
        return findings

    def _check_wire_flow(self):
        findings = []
        for sender, receiver, direction in (
            (self.local, self.remote, "LocalWire"),
            (self.remote, self.local, "RemoteWire"),
        ):
            outgoing_by_phase = sender.outgoing
            consumed_keys = {e.key for e in receiver.consumed}
            consumer_phases = {}
            for e in receiver.consumed:
                consumer_phases.setdefault(e.key, set()).add(e.phase)
            for e in sender.produced:
                if e.key == sender.phase_key:
                    continue
                if e.key not in consumed_keys:
                    findings.append(Finding(
                        rule="proto-flow-unmatched",
                        path=sender.module.path, line=e.line, col=e.col,
                        message=(
                            f"{direction} key '{e.key}' is produced in the "
                            f"{e.phase or 'unguarded'} block but the peer "
                            "node never consumes it (phase-flow model)"
                        ),
                    ))
                    continue
                # phase overlap: the payload arrives with the producing
                # block's outgoing PHASE (or, when no branch fires, the
                # echoed incoming phase — the block's own phase)
                arrival = set(outgoing_by_phase.get(e.phase) or ())
                if e.phase is not None:
                    arrival.add(e.phase)
                guards = consumer_phases.get(e.key, set())
                if not arrival or None in guards:
                    continue  # unknown arrival phase / unguarded consumer
                if arrival.isdisjoint(guards):
                    findings.append(Finding(
                        rule="proto-flow-unmatched",
                        path=sender.module.path, line=e.line, col=e.col,
                        message=(
                            f"{direction} key '{e.key}' arrives with phase "
                            f"{sorted(arrival)} but the peer only consumes "
                            f"it under phase {sorted(g for g in guards)} — "
                            "the consuming branch can never see the payload"
                        ),
                    ))
        return findings

    def _check_cache_lifecycle(self, side):
        findings = []
        writes_by_key = {}
        wildcard_phases = set()
        for e in side.cache_writes:
            if e.key == _WILDCARD:
                wildcard_phases.add(e.phase)
            else:
                writes_by_key.setdefault(e.key, []).append(e)

        # read-before-write: hard reads no write phase can precede
        for e in side.cache_reads:
            if e.kind != "hard" or e.key.startswith("_"):
                continue
            writers = writes_by_key.get(e.key)
            if not writers:
                continue  # written outside this node: origin unknown
            ok = any(
                self._precedes(w.phase, e.phase) for w in writers
            ) or any(self._precedes(p, e.phase) for p in wildcard_phases)
            if not ok:
                findings.append(Finding(
                    rule="proto-cache-read-before-write",
                    path=side.module.path, line=e.line, col=e.col,
                    message=(
                        f"cache['{e.key}'] is read in the "
                        f"{e.phase or 'unguarded'} block but only written "
                        f"in {sorted({w.phase for w in writers})} — no "
                        "phase ordering under PHASE_TRANSITIONS runs a "
                        "write first (KeyError on the first round that "
                        "takes this branch)"
                    ),
                ))

        # never-read: written here, read nowhere in the scanned package
        read_anywhere = self._package_read_keys()
        reported = set()
        for key, writers in sorted(writes_by_key.items()):
            if key.startswith("_") or key in reported:
                continue
            if key in read_anywhere:
                continue
            if any(e.key == key for e in side.cache_reads):
                continue
            reported.add(key)
            w = min(writers, key=lambda e: e.line)
            findings.append(Finding(
                rule="proto-cache-never-read", path=side.module.path,
                line=w.line, col=w.col,
                message=(
                    f"cache['{key}'] is written by this node but never "
                    "read anywhere in the scanned package — dead per-round "
                    "state (it still bloats every persisted cache snapshot)"
                ),
            ))

        return findings

    def _package_read_keys(self):
        """Every key-shaped string the scanned modules mention OUTSIDE a
        store-subscript target — the consumer index for never-read.
        Deliberately over-approximates reads (any literal or resolvable
        enum reference counts): never-read must only fire for keys with no
        conceivable consumer anywhere."""
        if getattr(self, "_read_keys", None) is not None:
            return self._read_keys
        keys = set()
        for mod in self.read_scan_modules:
            if mod.path.replace(os.sep, "/").endswith("config/keys.py"):
                continue  # declarations are not reads
            # the write sites themselves (`x[K] = ...` slices) must not
            # self-satisfy the check: collect their slice subtrees first
            write_nodes = set()
            for node in ast.walk(mod.tree):
                if isinstance(node, ast.Subscript) and not isinstance(
                    node.ctx, ast.Load
                ):
                    for sub in ast.walk(node.slice):
                        write_nodes.add(id(sub))
            for node in ast.walk(mod.tree):
                if id(node) in write_nodes:
                    continue
                if isinstance(node, ast.Constant) and isinstance(
                    node.value, str
                ):
                    keys.add(node.value)
                elif isinstance(node, ast.Attribute):
                    key = _resolve_key(node, self.enum_map)
                    if key is not None:
                        keys.add(key)
        self._read_keys = keys
        return keys


def run_protocol_flow(paths=None, local_path=None, remote_path=None):
    """Analyze the port's node pair (or an explicit pair).

    The never-read consumer scan ALWAYS covers the whole port
    package (plus any extra ``paths``): a scoped single-file lint must
    not shrink the consumer index and fabricate proto-cache-never-read
    findings whose real readers live outside the scanned path.  Missing
    node files make this a silent no-op (a partial checkout is not a
    protocol bug)."""
    root = _package_root()
    local_path = local_path or os.path.join(root, "nodes", "local.py")
    remote_path = remote_path or os.path.join(root, "nodes", "remote.py")
    if not (os.path.exists(local_path) and os.path.exists(remote_path)):
        return []
    from .core import iter_python_files

    def _mod(path):
        rel = os.path.relpath(path).replace(os.sep, "/")
        if "coinstac_dinunet_tpu_torch/" in rel:
            rel = "coinstac_dinunet_tpu_torch/" + rel.split(
                "coinstac_dinunet_tpu_torch/", 1
            )[-1]
        return Module.parse(path, rel)

    scan_files = iter_python_files(list(paths or []) + [root])
    scan_modules, seen_real = [], set()
    for path in scan_files:
        # relative CLI paths + the absolute package root defeat
        # iter_python_files' string dedup — realpath keeps each module
        # parsed once
        real = os.path.realpath(path)
        if real in seen_real:
            continue
        seen_real.add(real)
        try:
            scan_modules.append(_mod(path))
        except (SyntaxError, OSError, UnicodeDecodeError, ValueError):
            continue
    analyzer = ProtocolFlowAnalyzer(
        _mod(local_path), _mod(remote_path),
        read_scan_modules=scan_modules,
    )
    # the node pair consumes its own writes too
    return analyzer.run()

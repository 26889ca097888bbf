"""Protocol transition-system IR of the port — the model checker's input.

The JAX package's ``analysis/proto_ir.py`` over the port's nodes.
:mod:`~.protocol_flow` extracts phase-attributed wire/cache events from
the AST of ``nodes/local.py`` / ``nodes/remote.py`` and judges each node
in isolation.  This module lifts that extraction into an **explicit
transition-system IR** the whole-federation model checker
(:mod:`~.model_check`) executes:

- :class:`PhaseBlock` — one dispatch block of a node's ``compute``: the
  wire keys it produces/consumes, its cache reads/writes, and the phase
  values it writes into the round output (``outgoing``).  Per-node state in
  the composed model is *phase × cache-key set*; actions are
  invoke/relay/fault.
- :class:`NodeIR` — a node's ordered blocks plus the phases its dispatch
  tests, **including** the wire events of the modules it delegates to
  (``parallel/learner.py`` ships the gradients a site's COMPUTATION block
  never touches directly; ``parallel/reducer.py`` consumes them on the
  aggregator) and the cache writes of its constructor path.
- :class:`SemanticFacts` — behaviors the composed model needs that live in
  statement *order*, not in any single event: whether the aggregator's
  quorum filter runs before the reducer's input snapshot (the
  reappearing-stale-site hazard), whether a mixed-phase round fails loudly
  (the silent-INIT_RUNS-reset hazard), and whether the chaos heal bridges
  damage on a directory manifest to the payload load that fails because of
  it (the relay clobber-window hazard).  Extraction is by AST only — the
  recognized guard methods are the canonical ``_check_quorum`` /
  ``_check_lockstep_phases`` names (and the self-methods a lockstep guard
  calls, where the port keeps its round-window check); the chaos heal
  marker is a real behavioral reference (``MANIFEST_NAME`` inside
  ``on_load_failure``).

The JAX package's IR also carries the volatile-key set of its compiled-step
bucket; the port compiles no step (see :mod:`~.protocol_flow`), so its IR
has none and its model checker never checks volatile-key hygiene.

Pure stdlib ``ast``, no ``torch``.
"""
import ast
import dataclasses
import os

from .core import Module
from .protocol import _resolve_key, load_vocabulary
from .protocol_flow import (
    _WILDCARD,
    _NodeModel,
    _contains_input,
    _package_root,
    _read_source,
    load_phase_transitions,
)

#: the package the IR's display paths start with
PACKAGE = "coinstac_dinunet_tpu_torch"

#: delegate modules whose wire events execute inside a node's COMPUTATION
#: block (repo-relative path -> node role they belong to).
#: ``federation/membership.py`` is the aggregator's elastic-membership
#: round processing: it consumes the ``leaving`` flag and the
#: ``roster_epoch`` echo off each site's payload on the remote side.
DELEGATE_FILES = {
    "parallel/learner.py": "local",
    "parallel/reducer.py": "remote",
    "federation/membership.py": "remote",
}

#: methods whose ``return {literal: ...}`` dicts are wire payloads in the
#: delegate modules (mirrors analysis/protocol.py::PRODUCER_METHODS)
_PRODUCER_METHODS = {
    "step", "to_reduce", "backward", "reduce", "train_serializable",
    "validation_distributed", "test_distributed",
}


@dataclasses.dataclass(frozen=True)
class IREvent:
    """One wire/cache event inside a block (kind: produce | consume |
    write | wildcard | hard | soft)."""

    key: str
    kind: str
    line: int


@dataclasses.dataclass(frozen=True)
class PhaseBlock:
    """All events of one dispatch phase (``phase=None`` = unguarded code
    that runs every invocation); ``guard`` is what the dispatch tests —
    ``"out"`` (the local if/elif chain over the rewritten out-phase, so a
    block it rewrites to CHAINS within the same invocation) or ``"input"``
    (the remote ``check(all, ...)`` style, no chaining)."""

    phase: str
    guard: str
    produces: tuple
    consumes: tuple
    cache_reads: tuple
    cache_writes: tuple
    outgoing: tuple


@dataclasses.dataclass
class NodeIR:
    """One node's transition-system view."""

    role: str
    path: str
    blocks: dict              # phase (or None) -> PhaseBlock
    tested_phases: frozenset
    init_writes: tuple        # cache writes on the constructor path
    phase_fallthrough: str    # phase echoed when no dispatch block fires

    def block(self, phase):
        return self.blocks.get(phase)

    def static_cache_writers(self):
        """Keys with at least one non-wildcard compute-tree write — the
        set the read-before-write check may judge (origin known).  Cached:
        the IR is immutable and the explorer calls this once per simulated
        invocation in its hot loop."""
        cached = getattr(self, "_writers", None)
        if cached is None:
            cached = frozenset(
                e.key for b in self.blocks.values()
                for e in b.cache_writes if e.key != _WILDCARD
            )
            self._writers = cached
        return cached


@dataclasses.dataclass
class SemanticFacts:
    """Order/behavior facts the per-event IR cannot carry (see module
    docstring); ``anchors`` maps fact names to (path, line) for finding
    attribution."""

    quorum_checked: bool = True
    quorum_filters_reappeared: bool = True
    quorum_before_reduce_input: bool = True
    # elastic membership: the aggregator runs a membership
    # round step (canonical ``_check_membership`` name, the same
    # convention as ``_check_quorum``) before the reducer/trainer input
    # snapshot, the membership filter refuses payloads by ROSTER EPOCH
    # (an echo older than the site's current admission), and the local
    # join entry is exactly-once (the admission block is guarded by a
    # negated cache sentinel, so a retry after a completed join skips)
    membership_checked: bool = True
    membership_before_reduce_input: bool = True
    roster_epoch_refusal: bool = True
    admission_exactly_once: bool = True
    lockstep_phase_guard: bool = True
    round_lockstep_guard: bool = True
    # the round-stamp guard honors the async staleness WINDOW
    # (Federation.ASYNC_STALENESS): an echo lagging by at most k is
    # accepted instead of refused — the relaxation the staleness_k model
    # action exercises
    round_lockstep_window: bool = True
    # the window additionally honors the run-ahead pipelining depth
    # (Federation.RUN_AHEAD): a FRESH contribution's echo may lag by up
    # to k + d — the widening the run_ahead model action exercises
    round_lockstep_run_ahead: bool = True
    heal_bridges_manifest: bool = True
    anchors: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class ProtocolIR:
    """The composed model's complete input."""

    local: NodeIR
    remote: NodeIR
    transitions: dict
    facts: SemanticFacts
    phase_values: frozenset


# ------------------------------------------------------------- node lifting
def _guard_kinds(module, enum_map, phase_values, phase_key="phase"):
    """phase value -> "out" | "input": what the dispatch guard tests."""
    model = _NodeModel.__new__(_NodeModel)
    model.enum_map = enum_map
    model.phase_key = phase_key
    kinds = {}
    for node in ast.walk(module.tree):
        if not isinstance(node, ast.If):
            continue
        phase = model._phase_of_test(node.test)
        if phase is None or phase in kinds:
            continue
        kind = "input"
        for sub in ast.walk(node.test):
            if isinstance(sub, ast.Compare):
                for side in (sub.left, *sub.comparators):
                    if isinstance(side, ast.Subscript) and (
                        (isinstance(side.value, ast.Name)
                         and side.value.id == "out")
                        or (isinstance(side.value, ast.Attribute)
                            and side.value.attr == "out")
                    ):
                        kind = "out"
        kinds[phase] = kind
    return kinds


def _constructor_writes(module, enum_map):
    """Cache writes on the constructor path (``__init__`` + the self-methods
    it calls), as IREvents — tier-3 ignores them entirely; the executing
    model must not fabricate read-before-write findings for keys the
    constructor populates every invocation."""
    model = _NodeModel.__new__(_NodeModel)
    model.module = module
    model.enum_map = enum_map
    model.phase_key = "phase"
    model.produced, model.consumed = [], []
    model.outgoing, model.cache_writes, model.cache_reads = {}, [], []
    model.tested_phases = set()
    model.methods, model.class_name = {}, None
    model._find_class()
    if model.class_name is None or "__init__" not in model.methods:
        return ()
    model._visit_region(model.methods["__init__"].body, "__init__", set())
    return tuple(
        IREvent(e.key, e.kind if e.kind == "wildcard" else "write", e.line)
        for e in model.cache_writes
    )


def _delegate_events(role, enum_map, extra_modules=None):
    """Wire produce/consume events of the delegate modules for ``role``
    (attached to the node's COMPUTATION block by the model)."""
    produces, consumes = [], []
    mods = []
    root = _package_root()
    for rel, r in DELEGATE_FILES.items():
        if r != role:
            continue
        path = os.path.join(root, *rel.split("/"))
        if os.path.exists(path):
            try:
                mods.append(Module.parse(path, f"{PACKAGE}/{rel}"))
            except (SyntaxError, OSError, ValueError):
                continue
    for mod in extra_modules or ():
        mods.append(mod)
    for mod in mods:
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Subscript) and not isinstance(
                node.ctx, ast.Load
            ):
                base = node.value
                if (isinstance(base, ast.Name) and base.id == "out") or (
                    isinstance(base, ast.Attribute) and base.attr == "out"
                ):
                    key = _resolve_key(node.slice, enum_map)
                    if key:
                        produces.append(IREvent(key, "produce", node.lineno))
            elif isinstance(node, ast.FunctionDef) and (
                node.name in _PRODUCER_METHODS
            ):
                for sub in ast.walk(node):
                    if isinstance(sub, ast.Return) and isinstance(
                        sub.value, ast.Dict
                    ):
                        for k_node in sub.value.keys:
                            key = k_node and _resolve_key(k_node, enum_map)
                            if key:
                                produces.append(
                                    IREvent(key, "produce", sub.lineno)
                                )
            elif isinstance(node, ast.Call):
                fn = node.func
                name = fn.attr if isinstance(fn, ast.Attribute) else None
                if name == "get" and node.args and isinstance(
                    fn, ast.Attribute
                ):
                    # any input-rooted base counts, incl. the reducer's
                    # per-site view ``self.input[s].get(K)`` — and the
                    # per-site payload iteration variables the membership
                    # delegate walks (``for site, site_vars in
                    # input_dict.items()``), the same convention
                    # _NodeModel._consume_anywhere honors
                    if _contains_input(fn.value) or (
                        isinstance(fn.value, ast.Name)
                        and fn.value.id in ("site", "site_vars")
                    ):
                        key = _resolve_key(node.args[0], enum_map)
                        if key:
                            consumes.append(
                                IREvent(key, "consume", node.lineno)
                            )
                elif name == "_load" and node.args:
                    key = _resolve_key(node.args[0], enum_map)
                    if key:
                        consumes.append(IREvent(key, "consume", node.lineno))
    return tuple(produces), tuple(consumes)


#: the synthetic pseudo-phase holding the local join entry's events: the
#: ``_join*`` method a joiner's FIRST invocation executes under the
#: admission guard.  It is not a dispatch phase — the model checker
#: executes it exactly once per admitted joiner, never on a steady-state
#: re-invocation.
JOIN_BLOCK = "join"


def _carve_join_block(module, blocks):
    """Re-attribute the events of the local join-entry method (canonical
    ``_join*`` name, the same convention as ``_check_quorum``) from
    whatever dispatch region its call site sits in to the synthetic
    :data:`JOIN_BLOCK`.  Returns (blocks, join_method_node or None)."""
    methods = _find_class_methods(module.tree)
    join_fn = next(
        (fn for name, fn in sorted(methods.items())
         if name.startswith("_join")), None
    )
    if join_fn is None:
        return blocks, None
    lo = join_fn.lineno
    hi = getattr(join_fn, "end_lineno", lo) or lo
    carved = {"produces": [], "consumes": [],
              "cache_reads": [], "cache_writes": []}
    new_blocks = {}
    for phase, block in blocks.items():
        kept = {}
        for field in carved:
            kept[field] = []
            for e in getattr(block, field):
                (carved if lo <= e.line <= hi else kept)[field].append(e)
        new_blocks[phase] = dataclasses.replace(
            block, **{f: tuple(v) for f, v in kept.items()}
        )
    if any(carved.values()):
        new_blocks[JOIN_BLOCK] = PhaseBlock(
            phase=JOIN_BLOCK, guard="input",
            produces=tuple(carved["produces"]),
            consumes=tuple(carved["consumes"]),
            cache_reads=tuple(carved["cache_reads"]),
            cache_writes=tuple(carved["cache_writes"]),
            outgoing=(),
        )
    return new_blocks, join_fn


def build_node_ir(module, role, enum_map=None, extra_delegates=None,
                  delegates=True):
    """Lift one node module into a :class:`NodeIR`; ``delegates=False``
    skips the package delegate modules (fixture pairs)."""
    if enum_map is None:
        enum_map, _, _, _ = load_vocabulary()
    phase_values = {v for (cls, _), v in enum_map.items() if cls == "Phase"}
    model = _NodeModel(module, enum_map)
    kinds = _guard_kinds(module, enum_map, phase_values)

    phases = set()
    for ev in (model.produced + model.consumed
               + model.cache_writes + model.cache_reads):
        phases.add(ev.phase)
    phases |= set(model.outgoing)
    blocks = {}
    for phase in phases:
        blocks[phase] = PhaseBlock(
            phase=phase,
            guard=kinds.get(phase, "input"),
            produces=tuple(
                IREvent(e.key, "produce", e.line)
                for e in model.produced if e.phase == phase
            ),
            consumes=tuple(
                IREvent(e.key, "consume", e.line)
                for e in model.consumed if e.phase == phase
            ),
            cache_reads=tuple(
                IREvent(e.key, e.kind, e.line)
                for e in model.cache_reads if e.phase == phase
            ),
            cache_writes=tuple(
                IREvent(e.key, e.kind if e.kind == "wildcard" else "write",
                        e.line)
                for e in model.cache_writes if e.phase == phase
            ),
            outgoing=tuple(sorted(model.outgoing.get(phase, ()))),
        )
    # the local join entry is its own synthetic block — carved
    # BEFORE the delegate merge, whose events carry other files' lines
    if role == "local":
        blocks, _ = _carve_join_block(module, blocks)
    # delegate wire events execute inside the COMPUTATION block
    d_prod, d_cons = ((), ())
    if delegates or extra_delegates:
        d_prod, d_cons = _delegate_events(
            role if delegates else "<none>", enum_map,
            extra_modules=extra_delegates,
        )
    comp = blocks.get("computation")
    if comp is None and (d_prod or d_cons):
        comp = PhaseBlock("computation", kinds.get("computation", "input"),
                          (), (), (), (), ())
    if comp is not None:
        blocks["computation"] = dataclasses.replace(
            comp,
            produces=comp.produces + d_prod,
            consumes=comp.consumes + d_cons,
        )

    # the phase echoed when no dispatch fires: the unguarded
    # ``out[PHASE] = input.get(PHASE, <default>)`` default, if resolvable
    fallthrough = "echo"
    for node in ast.walk(module.tree):
        if not (isinstance(node, ast.Assign)
                and isinstance(node.value, ast.Call)):
            continue
        fn = node.value.func
        if not (isinstance(fn, ast.Attribute) and fn.attr == "get"):
            continue
        targets_phase = any(
            isinstance(t, ast.Subscript)
            and _resolve_key(t.slice, enum_map) == "phase"
            for t in node.targets
        )
        if targets_phase and len(node.value.args) >= 2:
            default = _resolve_key(node.value.args[1], enum_map)
            if default in phase_values:
                fallthrough = default
                break
    return NodeIR(
        role=role,
        path=module.path,
        blocks=blocks,
        tested_phases=frozenset(model.tested_phases),
        init_writes=_constructor_writes(module, enum_map),
        phase_fallthrough=fallthrough,
    )


# ------------------------------------------------------------ semantic facts
def _find_class_methods(tree):
    for node in tree.body:
        if isinstance(node, ast.ClassDef):
            methods = {
                n.name: n for n in node.body
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
            }
            if "compute" in methods:
                return methods
    return {}


def _self_calls_in_order(fn):
    """(name, line) of every ``self.<name>(...)`` call and every
    ``<target> = <call>(... input=self.input ...)`` snapshot assignment in
    ``fn``, in source order."""
    events = []
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            f = node.func
            if (isinstance(f, ast.Attribute)
                    and isinstance(f.value, ast.Name)
                    and f.value.id == "self"):
                events.append(("call", f.attr, node.lineno))
            for kw in node.keywords:
                if kw.arg == "input" and isinstance(kw.value, ast.Attribute) \
                        and kw.value.attr == "input":
                    events.append(("input_snapshot", "", node.lineno))
    return sorted(events, key=lambda e: e[2])


def _with_called_methods(names, methods):
    """The bodies of methods ``names`` and of every self-method they call,
    transitively (each once)."""
    seen, stack, bodies = set(), list(names), []
    while stack:
        name = stack.pop()
        body = methods.get(name)
        if body is None or name in seen:
            continue
        seen.add(name)
        bodies.append(body)
        for sub in ast.walk(body):
            if (isinstance(sub, ast.Call) and isinstance(sub.func, ast.Attribute)
                    and isinstance(sub.func.value, ast.Name)
                    and sub.func.value.id == "self"):
                stack.append(sub.func.attr)
    return bodies


def extract_remote_facts(remote_module, facts):
    """Quorum/lockstep ordering facts from the aggregator module."""
    methods = _find_class_methods(remote_module.tree)
    compute = methods.get("compute")
    if compute is None:
        facts.quorum_checked = False
        return facts
    events = _self_calls_in_order(compute)
    quorum_line = next(
        (ln for kind, name, ln in events
         if kind == "call" and name == "_check_quorum"), None
    )
    snapshot_line = next(
        (ln for kind, _, ln in events if kind == "input_snapshot"), None
    )
    facts.quorum_checked = quorum_line is not None
    lockstep_names = [
        name for kind, name, _ in events
        if kind == "call" and "lockstep" in name
    ]
    facts.lockstep_phase_guard = bool(lockstep_names)
    # the stale-in-steady-state defense: the lockstep guard also compares
    # the echoed round stamp (LocalWire.ROUND / the "wire_round" value),
    # and may relax the exact-stamp comparison to the async staleness
    # WINDOW (a reference to Federation.ASYNC_STALENESS /
    # "async_staleness" inside the guard, or inside a self-method the
    # guard calls, is the marker)
    facts.round_lockstep_guard = False
    facts.round_lockstep_window = False
    facts.round_lockstep_run_ahead = False
    for body in _with_called_methods(lockstep_names, methods):
        for sub in ast.walk(body):
            marker = None
            if isinstance(sub, ast.Attribute):
                marker = sub.attr
            elif isinstance(sub, ast.Constant) and isinstance(sub.value, str):
                marker = sub.value
            if marker in ("ROUND", "wire_round"):
                facts.round_lockstep_guard = True
            if marker in ("ASYNC_STALENESS", "async_staleness"):
                facts.round_lockstep_window = True
            if marker in ("RUN_AHEAD", "run_ahead"):
                facts.round_lockstep_run_ahead = True
    # elastic membership: the membership round step (admission
    # processing + the roster-epoch payload filter) must ALSO precede the
    # reducer/trainer input snapshot — the same stale-contribution hazard
    # the quorum ordering fact patrols, for rejoined incarnations
    membership_line = next(
        (ln for kind, name, ln in events
         if kind == "call" and "membership" in name), None
    )
    facts.membership_checked = membership_line is not None
    facts.membership_before_reduce_input = (
        membership_line is not None
        and (snapshot_line is None or membership_line < snapshot_line)
    )
    if membership_line is not None:
        facts.anchors["membership"] = (remote_module.path, membership_line)
    if snapshot_line is not None:
        facts.anchors["reduce_input"] = (remote_module.path, snapshot_line)
    if quorum_line is not None:
        facts.anchors["quorum"] = (remote_module.path, quorum_line)
    lockstep_line = next(
        (ln for kind, name, ln in events
         if kind == "call" and "lockstep" in name), None
    )
    if lockstep_line is not None:
        facts.anchors["lockstep"] = (remote_module.path, lockstep_line)
    facts.quorum_before_reduce_input = (
        quorum_line is not None
        and (snapshot_line is None or quorum_line < snapshot_line)
    )
    # does _check_quorum actually filter reappeared sites (rebind self.input)?
    cq = methods.get("_check_quorum")
    facts.quorum_filters_reappeared = bool(cq) and any(
        isinstance(n, ast.Assign) and any(
            isinstance(t, ast.Attribute) and t.attr == "input"
            for t in n.targets
        )
        for n in ast.walk(cq)
    ) if cq is not None else False
    return facts


def extract_local_facts(local_module, facts):
    """Local-side elastic-membership facts: is the join entry
    exactly-once?  Marker: the ``_join*`` call site's enclosing ``if``
    guard includes a NEGATED cache sentinel (``not self.cache.get(...)``)
    — a retry after a completed join, or a re-broadcast admission record,
    skips the entry instead of resetting the site's fold state."""
    methods = _find_class_methods(local_module.tree)
    join_fn = next(
        (fn for name, fn in sorted(methods.items())
         if name.startswith("_join")), None
    )
    if join_fn is None:
        facts.admission_exactly_once = False
        return facts
    compute = methods.get("compute")
    facts.admission_exactly_once = False
    for node in ast.walk(compute) if compute is not None else ():
        if not isinstance(node, ast.If):
            continue
        calls_join = any(
            isinstance(sub, ast.Call)
            and isinstance(sub.func, ast.Attribute)
            and sub.func.attr == join_fn.name
            for sub in ast.walk(node)
        )
        if not calls_join:
            continue
        facts.anchors["admission"] = (local_module.path, node.lineno)
        for sub in ast.walk(node.test):
            if isinstance(sub, ast.UnaryOp) and isinstance(
                sub.op, ast.Not
            ) and any(
                isinstance(s, ast.Attribute) and s.attr == "cache"
                for s in ast.walk(sub.operand)
            ):
                facts.admission_exactly_once = True
    return facts


def extract_membership_facts(membership_source, facts, membership_path=None):
    """Does the aggregator's membership filter refuse payloads BY ROSTER
    EPOCH?  Marker: a function named ``refuses`` or ``filter_membership``
    references the ``roster_epoch`` wire key (the ``ROSTER_EPOCH`` enum
    member or its value) — the only witness that a rejoined site's fresh
    contribution is distinguishable from a redelivery out of its previous,
    dead incarnation."""
    try:
        tree = ast.parse(membership_source)
    except SyntaxError:
        facts.roster_epoch_refusal = False
        return facts
    facts.roster_epoch_refusal = False
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef) and node.name in (
            "refuses", "filter_membership"
        ):
            facts.anchors.setdefault("membership_filter", (
                membership_path or f"{PACKAGE}/federation/membership.py",
                node.lineno,
            ))
            for sub in ast.walk(node):
                marker = None
                if isinstance(sub, ast.Attribute):
                    marker = sub.attr
                elif isinstance(sub, ast.Constant) and isinstance(
                    sub.value, str
                ):
                    marker = sub.value
                if marker in ("ROSTER_EPOCH", "roster_epoch",
                              "admitted_epoch"):
                    facts.roster_epoch_refusal = True
    return facts


def extract_chaos_facts(chaos_source, facts, chaos_path=None):
    """Does the chaos heal bridge manifest damage to the payload load that
    fails because of it?  Marker: ``on_load_failure`` references
    ``MANIFEST_NAME`` (a behavioral reference, not a declaration)."""
    try:
        tree = ast.parse(chaos_source)
    except SyntaxError:
        facts.heal_bridges_manifest = False
        return facts
    facts.heal_bridges_manifest = False
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef) and (
            node.name == "on_load_failure"
        ):
            facts.anchors["heal"] = (
                chaos_path or f"{PACKAGE}/resilience/chaos.py",
                node.lineno,
            )
            for sub in ast.walk(node):
                name = None
                if isinstance(sub, ast.Name):
                    name = sub.id
                elif isinstance(sub, ast.Attribute):
                    name = sub.attr
                if name == "MANIFEST_NAME":
                    facts.heal_bridges_manifest = True
    return facts


def extract_engine_facts(engine_source, facts, engine_path=f"{PACKAGE}/engine.py"):
    """Anchor the relay clobber window: the ``duplicate_delivery`` branch
    of the engine's broadcast relay (finding attribution only)."""
    try:
        tree = ast.parse(engine_source)
    except SyntaxError:
        return facts
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef) and (
            node.name == "_relay_broadcast"
        ):
            for sub in ast.walk(node):
                if isinstance(sub, ast.Constant) and (
                    sub.value == "duplicate_delivery"
                ):
                    facts.anchors.setdefault(
                        "relay_duplicate", (engine_path, sub.lineno)
                    )
    return facts


# -------------------------------------------------------------- entry point
def build_protocol_ir(local_module=None, remote_module=None,
                      keys_source=None, chaos_source=None, facts=None,
                      delegates=None):
    """Build the composed-model IR for the port (default) or an
    explicit fixture pair (tier-4's unit tests seed protocol bugs into
    synthetic node modules exactly like tier-3's; delegates are merged
    only for the real pair unless overridden)."""
    root = _package_root()
    if delegates is None:
        delegates = local_module is None and remote_module is None

    def _mod(path, rel):
        return Module.parse(path, f"{PACKAGE}/{rel}")

    if local_module is None:
        local_module = _mod(
            os.path.join(root, "nodes", "local.py"), "nodes/local.py"
        )
    if remote_module is None:
        remote_module = _mod(
            os.path.join(root, "nodes", "remote.py"), "nodes/remote.py"
        )
    enum_map, _, _, _ = load_vocabulary(keys_source)
    phase_values = frozenset(
        v for (cls, _), v in enum_map.items() if cls == "Phase"
    )
    if chaos_source is None:
        chaos_path = os.path.join(root, "resilience", "chaos.py")
        chaos_source = _read_source(chaos_path) if os.path.exists(
            chaos_path
        ) else ""
    if facts is None:
        facts = SemanticFacts()
        extract_remote_facts(remote_module, facts)
        extract_local_facts(local_module, facts)
        extract_chaos_facts(chaos_source, facts)
        membership_path = os.path.join(root, "federation", "membership.py")
        if os.path.exists(membership_path):
            extract_membership_facts(_read_source(membership_path), facts)
        else:
            facts.roster_epoch_refusal = False
        engine_path = os.path.join(root, "engine.py")
        if os.path.exists(engine_path):
            extract_engine_facts(_read_source(engine_path), facts)
    return ProtocolIR(
        local=build_node_ir(local_module, "local", enum_map,
                            delegates=delegates),
        remote=build_node_ir(remote_module, "remote", enum_map,
                             delegates=delegates),
        transitions=load_phase_transitions(keys_source),
        facts=facts,
        phase_values=phase_values,
    )

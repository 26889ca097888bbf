"""protocol-conformance: static producer/consumer matching of the
local↔remote JSON handshake — the JAX package's rule over the port's nodes.

Control flows between :class:`~coinstac_dinunet_tpu_torch.nodes.COINNLocal`
and :class:`~coinstac_dinunet_tpu_torch.nodes.COINNRemote` as bare string
keys inside the round ``output`` dicts.  Nothing at runtime checks that a
key one side writes is ever read by the other — a typo'd key silently
degrades the protocol (a site that writes ``"grad_file"`` never reduces;
an aggregator that reads ``"weights"`` never broadcasts).  This rule
extracts both sides' key sets from the AST and reports:

- ``produced but never consumed`` — side A writes a key side B never reads,
- ``consumed but never produced`` — side B reads a key side A never writes,
- ``not declared in config/keys.py`` — a wire key missing from the
  :class:`LocalWire`/:class:`RemoteWire` vocabulary of the port's
  ``config/keys.py`` (the same values as the JAX package's),
- ``declared but never used`` — a vocabulary entry no code references.

Extraction grammar (deliberately conservative — only statically-resolvable
string keys count; dynamic keys are ignored):

- produce: ``out[K] = ...`` / ``self.out[K] = ...`` anywhere in a side's
  class, and ``return {K: ...}`` dict literals inside well-known producer
  methods (``reduce``/``to_reduce``/``step``/``*_distributed``/...).
- consume: ``...input...[K]`` / ``...input....get(K)``, ``site_vars.get(K)``
  / ``site[K]`` / ``K in site``, ``check(_, K, ...)``,
  ``gather([K, ...], <expr involving input>)``, and ``self._load(K)``.

``K`` may be a string literal or a ``Key``/``LocalWire``/``RemoteWire``/
``Phase``/``Mode`` enum reference (``LocalWire.PHASE.value``), resolved by
parsing the port's ``config/keys.py`` — never by importing it.

Sides are assigned per class: ``*Learner``/``*Trainer``/``COINNLocal`` are
site code, ``*Reducer``/``COINNRemote`` aggregator code; module-level code
follows its file (``nodes/local.py`` → site, ``nodes/remote.py`` → agg).
Keys listed in ``ENGINE_PROVIDED_KEYS`` are injected by the engine/compspec
on the first invocation and are exempt from producer matching.
"""
import ast
import os

from .core import Finding, ProjectRule, register_rule

#: repo-relative path suffixes taking part in the handshake, with the side
#: of their module-level (non-class) code.
PROTOCOL_FILES = {
    "nodes/local.py": "site",
    "nodes/remote.py": "agg",
    "parallel/learner.py": "site",
    "parallel/powersgd.py": None,  # Learner + Reducer classes, split per class
    "parallel/rankdad.py": None,
    "parallel/reducer.py": "agg",
    # elastic membership: the aggregator's roster rounds consume the
    # ``leaving`` flag + ``roster_epoch`` echo per site
    "federation/membership.py": "agg",
    "trainer.py": "site",
}

#: methods whose ``return {literal: ...}`` dicts are wire payloads
PRODUCER_METHODS = {
    "compute", "step", "to_reduce", "backward", "reduce",
    "validation_distributed", "test_distributed", "train_serializable",
    "_init_runs", "_next_run", "_pretrain_local", "_pre_compute",
    "_send_global_scores",
}

#: classes whose ``input`` reads are NOT peer messages (COINNTrainer's
#: ``input`` is the engine compspec view, not the aggregator broadcast)
CONSUME_EXEMPT_CLASSES = {"COINNTrainer"}

_ENUM_CLASSES = ("Key", "LocalWire", "RemoteWire", "Phase", "Mode",
                 "AggEngine", "GatherMode")
_SITE_VAR_NAMES = {"site", "site_vars"}


def _class_side(name):
    if name.endswith("Learner") or name.endswith("Trainer") or name == "COINNLocal":
        return "site"
    if name.endswith("Reducer") or name == "COINNRemote":
        return "agg"
    return None


def _keys_module_path():
    return os.path.normpath(
        os.path.join(os.path.dirname(__file__), "..", "config", "keys.py")
    )


def load_vocabulary(keys_source=None):
    """Parse config/keys.py (source text or the port's own copy) into
    ``(enum_map, local_vocab, remote_vocab, engine_provided)``."""
    if keys_source is None:
        with open(_keys_module_path(), "r", encoding="utf-8") as f:
            keys_source = f.read()
    tree = ast.parse(keys_source)
    enum_map, local_vocab, remote_vocab = {}, set(), set()
    engine_provided = set()
    for node in tree.body:
        if isinstance(node, ast.ClassDef):
            for stmt in node.body:
                if (
                    isinstance(stmt, ast.Assign)
                    and len(stmt.targets) == 1
                    and isinstance(stmt.targets[0], ast.Name)
                    and isinstance(stmt.value, ast.Constant)
                    and isinstance(stmt.value.value, str)
                ):
                    member = stmt.targets[0].id
                    value = stmt.value.value
                    enum_map[(node.name, member)] = value
                    if node.name == "LocalWire":
                        local_vocab.add(value)
                    elif node.name == "RemoteWire":
                        remote_vocab.add(value)
        elif isinstance(node, ast.Assign):
            targets = [t.id for t in node.targets if isinstance(t, ast.Name)]
            if "ENGINE_PROVIDED_KEYS" in targets and isinstance(
                node.value, (ast.Tuple, ast.List)
            ):
                for elt in node.value.elts:
                    if isinstance(elt, ast.Constant) and isinstance(elt.value, str):
                        engine_provided.add(elt.value)
    return enum_map, local_vocab, remote_vocab, engine_provided


def _resolve_key(node, enum_map):
    """AST expr → wire-key string, or None if dynamic/unresolvable."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    # Key.X / Key.X.value (possibly through a module alias prefix)
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        parts.reverse()
        if parts and parts[-1] == "value":
            parts = parts[:-1]
        for i in range(len(parts) - 1):
            hit = enum_map.get((parts[i], parts[i + 1]))
            if hit is not None:
                return hit
    return None


def _contains_input(node):
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name) and sub.id == "input":
            return True
        if isinstance(sub, ast.Attribute) and sub.attr == "input":
            return True
    return False


class _Use:
    __slots__ = ("key", "path", "line", "col")

    def __init__(self, key, path, line, col):
        self.key, self.path, self.line, self.col = key, path, line, col


class _Extractor(ast.NodeVisitor):
    """Collects produced/consumed keys from one protocol module."""

    def __init__(self, module, default_side, enum_map):
        self.module = module
        self.enum_map = enum_map
        self.side_stack = [default_side]
        self.class_stack = []
        self.fn_stack = []
        # {'site': [...], 'agg': [...]} of _Use
        self.produced = {"site": [], "agg": []}
        self.consumed = {"site": [], "agg": []}

    # ------------------------------------------------------------- structure
    def visit_ClassDef(self, node):
        side = _class_side(node.name) or self.side_stack[-1]
        self.side_stack.append(side)
        self.class_stack.append(node.name)
        self.generic_visit(node)
        self.class_stack.pop()
        self.side_stack.pop()

    def visit_FunctionDef(self, node):
        self.fn_stack.append(node.name)
        self.generic_visit(node)
        self.fn_stack.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    # ------------------------------------------------------------- recording
    def _side(self):
        return self.side_stack[-1]

    def _record(self, table, key_node, at=None):
        side = self._side()
        if side is None:
            return
        key = _resolve_key(key_node, self.enum_map)
        if key is None:
            return
        at = at or key_node
        table[side].append(
            _Use(key, self.module.path, at.lineno, at.col_offset)
        )

    def _consume_exempt(self):
        return bool(self.class_stack) and (
            self.class_stack[-1] in CONSUME_EXEMPT_CLASSES
        )

    # --------------------------------------------------------------- produce
    def visit_Assign(self, node):
        for target in node.targets:
            if isinstance(target, ast.Subscript):
                base = target.value
                is_out = (
                    isinstance(base, ast.Name) and base.id == "out"
                ) or (
                    isinstance(base, ast.Attribute) and base.attr == "out"
                )
                if is_out:
                    self._record(self.produced, target.slice, at=target)
        self.generic_visit(node)

    def visit_Return(self, node):
        if (
            isinstance(node.value, ast.Dict)
            and self.fn_stack
            and self.fn_stack[-1] in PRODUCER_METHODS
        ):
            for key_node in node.value.keys:
                if key_node is not None:
                    self._record(self.produced, key_node, at=node)
        self.generic_visit(node)

    # --------------------------------------------------------------- consume
    def visit_Subscript(self, node):
        if isinstance(node.ctx, ast.Load) and not self._consume_exempt():
            base = node.value
            if _contains_input(base) or (
                isinstance(base, ast.Name) and base.id in _SITE_VAR_NAMES
            ):
                self._record(self.consumed, node.slice, at=node)
        self.generic_visit(node)

    def visit_Compare(self, node):
        # "key" in site / "key" in site_vars
        if (
            len(node.ops) == 1
            and isinstance(node.ops[0], ast.In)
            and not self._consume_exempt()
        ):
            target = node.comparators[0]
            if _contains_input(target) or (
                isinstance(target, ast.Name) and target.id in _SITE_VAR_NAMES
            ):
                self._record(self.consumed, node.left, at=node)
        self.generic_visit(node)

    def visit_Call(self, node):
        func = node.func
        fname = func.attr if isinstance(func, ast.Attribute) else (
            func.id if isinstance(func, ast.Name) else None
        )
        if self._consume_exempt():
            self.generic_visit(node)
            return
        if fname == "get" and isinstance(func, ast.Attribute) and node.args:
            base = func.value
            if _contains_input(base) or (
                isinstance(base, ast.Name) and base.id in _SITE_VAR_NAMES
            ):
                self._record(self.consumed, node.args[0])
        elif fname == "check" and len(node.args) >= 2:
            self._record(self.consumed, node.args[1])
        elif (
            fname == "gather"
            and len(node.args) >= 2
            and isinstance(node.args[0], (ast.List, ast.Tuple))
            # only gathers over the round ``input`` read wire keys; gathers
            # over nested payloads (e.g. serialized {averages, metrics}
            # blobs) are local data-shuffling, not protocol consumption
            and _contains_input(node.args[1])
        ):
            for elt in node.args[0].elts:
                self._record(self.consumed, elt)
        elif fname == "_load" and node.args:
            self._record(self.consumed, node.args[0])
        self.generic_visit(node)


@register_rule
class ProtocolConformanceRule(ProjectRule):
    id = "protocol-conformance"
    doc = ("Producer/consumer agreement of the local<->remote wire keys, "
           "cross-checked against the LocalWire/RemoteWire vocabulary in "
           "config/keys.py.")

    def __init__(self, keys_source=None, protocol_files=None):
        self._keys_source = keys_source
        self._files = dict(protocol_files or PROTOCOL_FILES)

    def _file_role(self, path):
        # component-boundary match: a bare endswith would take
        # nn/basetrainer.py for trainer.py
        norm = path.replace(os.sep, "/")
        for suffix, side in self._files.items():
            if norm == suffix or norm.endswith("/" + suffix):
                return suffix, side
        return None, None

    def finalize(self, modules):
        relevant, present = [], set()
        for mod in modules:
            suffix, side = self._file_role(mod.path)
            if suffix is not None:
                relevant.append((mod, side))
                present.add(suffix)
        # Producer/consumer matching is a whole-protocol property: with only
        # one side (or one learner) in scope every key on the missing side
        # would be reported unmatched.  Partial scans — single-file lints,
        # editor integration — are skipped rather than flooded with false
        # positives; the package-wide run always has the full file set.
        if present != set(self._files):
            return []
        enum_map, local_vocab, remote_vocab, engine_provided = (
            load_vocabulary(self._keys_source)
        )
        produced = {"site": [], "agg": []}
        consumed = {"site": [], "agg": []}
        for mod, default_side in relevant:
            ex = _Extractor(mod, default_side, enum_map)
            ex.visit(mod.tree)
            for side in ("site", "agg"):
                produced[side].extend(ex.produced[side])
                consumed[side].extend(ex.consumed[side])

        findings = []

        def first(uses, key):
            return min(
                (u for u in uses if u.key == key),
                key=lambda u: (u.path, u.line),
            )

        def check_direction(direction, prod_uses, cons_uses, vocab):
            prod_keys = {u.key for u in prod_uses}
            cons_keys = {u.key for u in cons_uses}
            for key in sorted(prod_keys - cons_keys):
                u = first(prod_uses, key)
                findings.append(Finding(
                    rule=self.id, path=u.path, line=u.line, col=u.col,
                    message=f"{direction} key '{key}' is produced but never "
                            "consumed by the peer",
                ))
            for key in sorted(cons_keys - prod_keys - engine_provided):
                u = first(cons_uses, key)
                findings.append(Finding(
                    rule=self.id, path=u.path, line=u.line, col=u.col,
                    message=f"{direction} key '{key}' is consumed but never "
                            "produced by the peer",
                ))
            for key in sorted((prod_keys | cons_keys) - vocab - engine_provided):
                u = first(list(prod_uses) + list(cons_uses), key)
                findings.append(Finding(
                    rule=self.id, path=u.path, line=u.line, col=u.col,
                    message=f"{direction} key '{key}' is not declared in the "
                            f"config/keys.py {direction} vocabulary",
                ))
            for key in sorted(vocab - prod_keys - cons_keys):
                findings.append(Finding(
                    rule=self.id, path="coinstac_dinunet_tpu_torch/config/keys.py",
                    line=1, col=0,
                    message=f"{direction} vocabulary key '{key}' is declared "
                            "but never produced or consumed",
                ))

        # site -> aggregator: sites produce, aggregator consumes
        check_direction("LocalWire", produced["site"], consumed["agg"],
                        local_vocab)
        # aggregator -> site
        check_direction("RemoteWire", produced["agg"], consumed["site"],
                        remote_vocab)
        return findings

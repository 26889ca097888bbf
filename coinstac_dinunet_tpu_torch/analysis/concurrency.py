"""conc-*: the tier-5 static concurrency auditor (lock-discipline analysis)
over the port — the JAX package's ``analysis/concurrency.py``.

The rules are pure ``ast`` over ``threading`` and
``concurrent.futures``, so the JAX rules apply word for word.  In the port
they read the daemon engine's supervised workers
(``federation/daemon.py``: ``_worker_lock``, ``_closing``), the background
committer (``resilience/transport.py`` ``BackgroundCommitter``), the
shared fan-in pool (``utils/tensorutils.py``), ``device_prefetch``'s
thread (``data/data.py``) and ``engine.py``'s async invocation pool and
run-ahead reducer thread.

- **Guard inference** — a lock is any ``self._x = threading.Lock()`` /
  ``RLock()`` (or module-global equivalent); a *write* is any assignment,
  augmented assignment, subscript store or mutating method call on a
  ``self._*`` attribute or module global; the *held set* at a write is the
  stack of enclosing ``with <lock>:`` blocks.  An attribute's inferred
  guard is the lock set common to every write outside constructors;
  threaded contexts are the closure of ``threading.Thread(target=...)``
  targets and ``.submit(...)`` callables over the module's call graph.
- ``conc-unguarded-shared-write`` — a threaded-context write with an
  empty held set while every other write site holds the inferred guard.
- ``conc-lock-order`` — two locks taken in opposite nesting orders on two
  paths (ABBA), including acquisitions reached through same-module calls.
- ``conc-escape`` — a name handed into ``pool.submit(fn, name, ...)`` is
  container-mutated by the submitting function before the future's
  ``.result()``.
- ``conc-fs-race`` — a transfer-directory payload written outside the
  ``resilience/transport.py`` atomic-commit helpers from a threaded
  context (``wire-atomic-commit``'s taint across the thread boundary;
  ``torch.save`` counts as a payload write beside ``np.save``).

Every JAX rule of this half has its construct in the port.  No torch
import.  The dynamic half is :mod:`.schedule_explorer`.
"""
import ast

from ..config.keys import Concurrency
from .core import Finding, Module, display_path, dotted_name, iter_python_files
from .wire_atomic import (
    _EXEMPT_SUFFIX,
    _mentions_transfer,
    _open_write_mode,
    _tainted_names,
    save_target,
)

TIER5_STATIC_RULE_IDS = (
    Concurrency.ESCAPE,
    Concurrency.FS_RACE,
    Concurrency.LOCK_ORDER,
    Concurrency.UNGUARDED,
)

#: method calls that mutate their receiver in place (dict/list/set/deque
#: vocabulary).  Deliberately excludes the thread-safe ``queue.Queue``
#: verbs (``put``/``get``/``task_done``) — a queue IS the sanctioned
#: cross-thread channel.
_MUTATORS = frozenset({
    "append", "appendleft", "add", "clear", "discard", "extend", "insert",
    "pop", "popitem", "popleft", "remove", "setdefault", "update",
})

#: lock constructors recognised for guard inference
_LOCK_CTORS = ("Lock", "RLock")

#: constructor-like functions whose writes define attributes but never
#: race (they run before any thread exists)
_CTOR_NAMES = ("__init__", "__new__", "__post_init__")


def _is_lock_ctor(value):
    if not isinstance(value, ast.Call):
        return False
    name = dotted_name(value.func, require_name_root=False) or ""
    leaf = name.rsplit(".", 1)[-1]
    return leaf in _LOCK_CTORS


def _attr_token(node):
    """``self.<attr>`` → ``"self.<attr>"``; bare module-global Name →
    its id; anything deeper (``self.a.b``) is out of scope (None)."""
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name) \
            and node.value.id == "self":
        return f"self.{node.attr}"
    if isinstance(node, ast.Name):
        return node.id
    return None


def _callable_ref(node):
    """Same-module name of a callable reference (``self.m`` → ``m``,
    bare ``f`` → ``f``; anything else → None)."""
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name) \
            and node.value.id == "self":
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def _callee_token(call):
    """Same-module callee name of a call: ``self.m(...)`` → ``m``,
    ``f(...)`` → ``f``; anything else → None."""
    return _callable_ref(call.func)


class _Write:
    __slots__ = ("attr", "line", "col", "held", "func", "kind")

    def __init__(self, attr, line, col, held, func, kind="rebind"):
        self.attr, self.line, self.col = attr, line, col
        self.held, self.func = frozenset(held), func
        # "mutate" = in-place container mutation (subscript store,
        # augmented assign, mutator method call); "rebind" = a plain name
        # rebinding, which never touches the object a closure captured
        self.kind = kind


class _FuncFacts:
    """Per-function facts gathered in one AST walk."""

    def __init__(self, name):
        self.name = name
        self.writes = []          # [_Write]
        self.acquires = []        # [(lock, held-before, line)]
        self.calls = []           # [(callee, held, line)]
        self.submits = []         # [(futures-var|None, [arg names], line)]
        self.submit_targets = []  # callables handed to submit/Thread
        self.result_lines = {}    # futures-var -> first .result() line
        self.fs_writes = []       # [(how, target-node, line, col)]
        # Python scoping facts: a bare name plain-assigned anywhere in a
        # function is LOCAL there (unless declared global) — its writes
        # are not shared state no matter what module global it shadows
        self.local_names = set()
        self.global_decls = set()


class _ModuleAudit:
    """One module's lock-discipline analysis."""

    def __init__(self, module):
        self.module = module
        self.locks = set()
        self.funcs = {}           # name -> [_FuncFacts] (overloads share)
        self.nested_parent = {}   # nested def name -> enclosing facts
        # bare-name tokens that really ARE module globals (module-level
        # assignment targets + `global` declarations).  Function-local
        # names that merely shadow a guarded global must never feed the
        # shared-write judgement — no scope tracking means false
        # positives, and this rule's contract is precision over recall.
        self.module_globals = self._find_module_globals(module.tree)

    @staticmethod
    def _find_module_globals(tree):
        names = set()
        for node in tree.body:
            targets = ()
            if isinstance(node, ast.Assign):
                targets = node.targets
            elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
                targets = (node.target,)
            for t in targets:
                for elt in (t.elts if isinstance(t, (ast.Tuple, ast.List))
                            else (t,)):
                    if isinstance(elt, ast.Name):
                        names.add(elt.id)
        for node in ast.walk(tree):
            if isinstance(node, ast.Global):
                names.update(node.names)
        return names

    # ------------------------------------------------------------- gathering
    def run(self):
        self._find_locks(self.module.tree)
        for node in self.module.tree.body:
            self._gather_scope(node)
        findings = []
        findings += self._unguarded_findings()
        findings += self._lock_order_findings()
        findings += self._escape_findings()
        findings += self._fs_race_findings()
        return findings

    def _find_locks(self, tree):
        for node in ast.walk(tree):
            if isinstance(node, ast.Assign) and _is_lock_ctor(node.value):
                for t in node.targets:
                    tok = _attr_token(t)
                    if tok:
                        self.locks.add(tok)

    def _gather_scope(self, node, class_name=None):
        if isinstance(node, ast.ClassDef):
            for sub in node.body:
                self._gather_scope(sub, class_name=node.name)
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            facts = _FuncFacts(node.name)
            self.funcs.setdefault(node.name, []).append(facts)
            self._walk_body(node.body, facts, held=())

    def _lock_of(self, expr):
        """The lock token a with-item acquires, or None.  ``with a, b:``
        items are handled by the caller; ``lock.acquire()`` calls are out
        of scope (the codebase idiom is the with-block)."""
        tok = _attr_token(expr)
        return tok if tok in self.locks else None

    def _walk_body(self, body, facts, held):
        for stmt in body:
            self._walk_stmt(stmt, facts, held)

    def _walk_stmt(self, stmt, facts, held):
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # nested def: a fresh scope whose facts ride with the module
            # (submit targets resolve to it by name); the parent's held
            # set does NOT transfer — the closure runs later
            nested = _FuncFacts(stmt.name)
            self.funcs.setdefault(stmt.name, []).append(nested)
            self.nested_parent[stmt.name] = facts
            self._walk_body(stmt.body, nested, held=())
            return
        if isinstance(stmt, ast.With):
            acquired = list(held)
            for item in stmt.items:
                lock = self._lock_of(item.context_expr)
                if lock is not None:
                    facts.acquires.append((lock, tuple(acquired),
                                           item.context_expr.lineno))
                    acquired.append(lock)
                self._scan_expr(item.context_expr, facts, tuple(acquired))
            self._walk_body(stmt.body, facts, tuple(acquired))
            return
        if isinstance(stmt, (ast.If, ast.While)):
            self._scan_expr(stmt.test, facts, held)
            self._walk_body(stmt.body, facts, held)
            self._walk_body(stmt.orelse, facts, held)
            return
        if isinstance(stmt, ast.For):
            self._scan_expr(stmt.iter, facts, held)
            self._record_store(stmt.target, facts, held)
            self._walk_body(stmt.body, facts, held)
            self._walk_body(stmt.orelse, facts, held)
            return
        if isinstance(stmt, ast.Try):
            self._walk_body(stmt.body, facts, held)
            for h in stmt.handlers:
                self._walk_body(h.body, facts, held)
            self._walk_body(stmt.orelse, facts, held)
            self._walk_body(stmt.finalbody, facts, held)
            return
        if isinstance(stmt, ast.Assign):
            for t in stmt.targets:
                self._record_store(t, facts, held)
            self._scan_expr(stmt.value, facts, held,
                            assign_targets=stmt.targets)
            return
        if isinstance(stmt, ast.AugAssign):
            self._record_store(stmt.target, facts, held, kind="mutate")
            self._scan_expr(stmt.value, facts, held)
            return
        if isinstance(stmt, ast.Expr):
            self._scan_expr(stmt.value, facts, held)
            return
        if isinstance(stmt, ast.Global):
            facts.global_decls.update(stmt.names)
            return
        for child in ast.iter_child_nodes(stmt):
            if isinstance(child, ast.expr):
                self._scan_expr(child, facts, held)
            elif isinstance(child, ast.stmt):
                self._walk_stmt(child, facts, held)

    def _record_store(self, target, facts, held, kind="rebind"):
        """An assignment target: plain attr/global rebinding and subscript
        stores both count as writes of the base token."""
        if isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._record_store(elt, facts, held, kind)
            return
        base = target
        if isinstance(target, ast.Subscript):
            base = target.value
            kind = "mutate"
        elif isinstance(target, ast.Name):
            # a plain bare-name assignment binds the name LOCALLY in this
            # function (Python scoping) — recorded so the shared-write
            # judgement can exclude shadowing locals
            facts.local_names.add(target.id)
        tok = _attr_token(base)
        if tok and tok not in self.locks:
            facts.writes.append(_Write(tok, target.lineno, target.col_offset,
                                       held, facts, kind))

    def _scan_expr(self, expr, facts, held, assign_targets=()):
        for node in ast.walk(expr):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            # mutating method call on a tracked token (one chained hop:
            # ``self.d.setdefault(k, deque()).append(v)`` mutates self.d)
            if isinstance(func, ast.Attribute) and func.attr in _MUTATORS:
                base = func.value
                if isinstance(base, ast.Call) and isinstance(
                        base.func, ast.Attribute):
                    base = base.func.value
                tok = _attr_token(base)
                if tok and tok not in self.locks:
                    facts.writes.append(_Write(
                        tok, node.lineno, node.col_offset, held, facts,
                        kind="mutate"))
            # pool.submit(fn, args...) / Thread(target=fn)
            if isinstance(func, ast.Attribute) and func.attr == "submit" \
                    and node.args:
                callee = _callable_ref(node.args[0])
                if callee:
                    facts.submit_targets.append(callee)
                fut = None
                for t in assign_targets:
                    if isinstance(t, ast.Name):
                        fut = t.id
                arg_names = [a.id for a in node.args[1:]
                             if isinstance(a, ast.Name) and a.id != "self"]
                facts.submits.append((fut, arg_names, node.lineno))
            name = dotted_name(func, require_name_root=False) or ""
            if name.rsplit(".", 1)[-1] == "Thread":
                for kw in node.keywords:
                    if kw.arg == "target":
                        callee = _callable_ref(kw.value)
                        if callee:
                            facts.submit_targets.append(callee)
            # .result() bookkeeping for the escape window
            if isinstance(func, ast.Attribute) and func.attr == "result" \
                    and isinstance(func.value, ast.Name):
                facts.result_lines.setdefault(func.value.id, node.lineno)
            # same-module call for held-lock propagation / threaded closure
            callee = _callee_token(node)
            if callee and callee != facts.name:
                facts.calls.append((callee, frozenset(held), node.lineno))
            # direct payload writes, judged later against threaded contexts
            how = None
            target = None
            if isinstance(func, ast.Name) and func.id == "open":
                mode = _open_write_mode(node)
                if mode and node.args:
                    target = node.args[0]
                    how = f"open(..., {mode!r})"
            else:
                fn = dotted_name(func, require_name_root=False) or ""
                target = save_target(node, fn)
                if target is not None:
                    how = f"{fn}(...)"
            if how is not None:
                facts.fs_writes.append((how, target, node.lineno,
                                        node.col_offset))

    # ----------------------------------------------------- derived relations
    def _threaded_funcs(self):
        """Transitive closure of thread entry points over same-module
        calls (and nested defs declared inside threaded functions)."""
        threaded = set()
        frontier = []
        for flist in self.funcs.values():
            for f in flist:
                frontier.extend(f.submit_targets)
        while frontier:
            name = frontier.pop()
            if name in threaded or name not in self.funcs:
                continue
            threaded.add(name)
            for f in self.funcs[name]:
                for callee, _held, _line in f.calls:
                    if callee not in threaded:
                        frontier.append(callee)
            for nested, parent in self.nested_parent.items():
                if parent.name == name and nested not in threaded:
                    frontier.append(nested)
        return threaded

    def _all_writes(self):
        for flist in self.funcs.values():
            for f in flist:
                yield from f.writes

    # ----------------------------------------------------------------- rules
    def _unguarded_findings(self):
        threaded = self._threaded_funcs()
        by_attr = {}
        for w in self._all_writes():
            if w.func.name in _CTOR_NAMES:
                continue  # constructors run before any thread exists
            if not w.attr.startswith("self."):
                if w.attr not in self.module_globals:
                    continue  # never a module global anywhere
                if w.attr in w.func.local_names and (
                    w.attr not in w.func.global_decls
                ):
                    continue  # a local shadowing the global in this scope
            by_attr.setdefault(w.attr, []).append(w)
        findings = []
        for attr, writes in sorted(by_attr.items()):
            unguarded = [w for w in writes
                         if w.func.name in threaded and not w.held]
            others = [w for w in writes if w not in unguarded]
            if not unguarded or not others:
                continue
            common = None
            for w in others:
                common = w.held if common is None else (common & w.held)
            if not common:
                continue  # no consistent discipline inferred: out of scope
            guard = sorted(common)[0]
            for w in unguarded:
                findings.append(Finding(
                    rule=Concurrency.UNGUARDED, path=self.module.path,
                    line=w.line, col=w.col,
                    message=(
                        f"'{attr}' is written from the threaded context "
                        f"'{w.func.name}' (a Thread target / pool-submitted "
                        f"callable) without '{guard}', the lock every other "
                        "write site of it holds — an unsynchronized shared "
                        "write the inferred lock discipline forbids"
                    ),
                ))
        return findings

    def _lock_order_findings(self):
        # locks transitively acquired inside each function (fixed point)
        trans = {name: set() for name in self.funcs}
        for name, flist in self.funcs.items():
            for f in flist:
                trans[name].update(lock for lock, _h, _l in f.acquires)
        changed = True
        while changed:
            changed = False
            for name, flist in self.funcs.items():
                for f in flist:
                    for callee, _held, _line in f.calls:
                        if callee in trans and not (
                                trans[callee] <= trans[name]):
                            trans[name] |= trans[callee]
                            changed = True
        edges = {}  # (outer, inner) -> (line)
        for flist in self.funcs.values():
            for f in flist:
                for lock, held, line in f.acquires:
                    for outer in held:
                        if outer != lock:
                            edges.setdefault((outer, lock), line)
                for callee, held, line in f.calls:
                    if callee not in trans:
                        continue
                    for inner in trans[callee]:
                        for outer in held:
                            if outer != inner:
                                edges.setdefault((outer, inner), line)
        findings = []
        seen = set()
        for (a, b), line in sorted(edges.items(), key=lambda kv: kv[1]):
            if (b, a) in edges and frozenset((a, b)) not in seen:
                seen.add(frozenset((a, b)))
                other = edges[(b, a)]
                first, second = sorted([(line, a, b), (other, b, a)])
                findings.append(Finding(
                    rule=Concurrency.LOCK_ORDER, path=self.module.path,
                    line=second[0], col=0,
                    message=(
                        f"inconsistent lock order: '{second[1]}' is acquired "
                        f"while '{second[2]}' is held here, but line "
                        f"{first[0]} acquires '{first[1]}' while "
                        f"'{first[2]}' is held — two threads taking the "
                        "opposite orders deadlock (ABBA)"
                    ),
                ))
        return findings

    def _escape_findings(self):
        findings = []
        for flist in self.funcs.values():
            for f in flist:
                for fut, arg_names, submit_line in f.submits:
                    if not arg_names:
                        continue
                    window_end = f.result_lines.get(fut, float("inf"))
                    for w in f.writes:
                        if w.kind == "mutate" and w.attr in arg_names and \
                                submit_line < w.line < window_end:
                            findings.append(Finding(
                                rule=Concurrency.ESCAPE,
                                path=self.module.path,
                                line=w.line, col=w.col,
                                message=(
                                    f"'{w.attr}' was handed into a "
                                    f"pool.submit closure on line "
                                    f"{submit_line} and is mutated here "
                                    "before the future's .result() — the "
                                    "submitted callable and this thread "
                                    "race on the shared object; snapshot "
                                    "it before submitting"
                                ),
                            ))
        return findings

    def _fs_race_findings(self):
        if self.module.path.replace("\\", "/").endswith(_EXEMPT_SUFFIX):
            return []
        threaded = self._threaded_funcs()
        if not threaded:
            return []
        tainted = _tainted_names(self.module.tree)
        findings = []
        for name in sorted(threaded):
            for f in self.funcs.get(name, ()):
                for how, target, line, col in f.fs_writes:
                    if not _mentions_transfer(target, tainted):
                        continue
                    findings.append(Finding(
                        rule=Concurrency.FS_RACE, path=self.module.path,
                        line=line, col=col,
                        message=(
                            f"{how} writes a transfer-directory payload "
                            f"from the threaded context '{name}' outside "
                            "the resilience/transport.py atomic-commit "
                            "helpers — a concurrent reader (or the relay) "
                            "can observe a partial payload; this extends "
                            "wire-atomic-commit's taint across the thread "
                            "boundary"
                        ),
                    ))
        return findings


def analyze_module(module):
    """All tier-5 static findings for one parsed :class:`~.core.Module`."""
    return _ModuleAudit(module).run()


def run_tier5_static(paths=None):
    """The tier-5 static half over ``paths`` (files or directories).
    Parse failures are skipped silently — the base static scan already
    reports them through its own error channel."""
    paths = list(paths) if paths else ["coinstac_dinunet_tpu_torch"]
    findings = []
    for path in iter_python_files(paths):
        display = display_path(path)
        try:
            mod = Module.parse(path, display)
        except (SyntaxError, UnicodeDecodeError, OSError, ValueError):
            continue
        findings.extend(analyze_module(mod))
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings

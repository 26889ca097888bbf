"""num-*: the tier-7 numerics & determinism auditor (static half) over the
port — the JAX package's ``analysis/numerics.py``.

Every acceptance pin of the port is a bit-parity claim (run-ahead d=0 ≡
serial, async k=0 + pool-1 ≡ lockstep, mmap ≡ copy loads, the vectorized
engine ≡ file transport), and the lossy codecs on the wire bend floating
point on every one of those boundaries.  This pass statically guards the
properties the pins rest on, with the JAX rule ids and messages' meaning:

- ``num-prng-reuse`` — a seed value consumed by two or more seeding calls
  (``torch.Generator().manual_seed(s)``, ``torch.manual_seed``,
  ``np.random.default_rng``, ``np.random.SeedSequence``) without an
  intervening re-derivation, or consumed inside a loop that does not
  rebind it: both generators draw identical bits.  A ``torch.Generator``
  is stateful — two draws from one generator differ — so where JAX
  consumes a key by sampling, the port consumes a seed by seeding; a
  derived seed (``seed + k``, a call) is the sanctioned ``fold_in`` and
  never counts.
- ``num-prng-discard`` — ``.spawn(n)[literal]`` of a numpy
  ``SeedSequence``/``Generator``: the port's splittable seed (a
  ``torch.Generator`` has no split), the sibling children dropped.
- ``num-prng-constant`` — a literal-seeded generator built inside a loop
  or a per-step/per-round function: every pass replays identical noise.
- ``num-unordered-reduce`` — a reduce fan-in (``load_arrays_many``,
  ``stack``/``cat``/``concatenate``, ``sum``) whose operand order depends
  on dict/set iteration or an unsorted directory listing.
- ``num-codec-unbounded`` — a module defining wire-codec kernels
  (``compress*``/``quantize*``/…) that neither emits compression telemetry
  (``record_compression_health``, ``rec.event(..., cat="compress")``,
  ``rec.wire(..., codec=...)``) nor is called from a module that does:
  ``ops/quantize.py``, ``parallel/powersgd.py`` and ``parallel/rankdad.py``
  report through ``telemetry/health.py``'s ``record_compression_health``.
- ``num-accum-narrow`` — eager PyTorch has no jaxpr: instead each deep
  entry's watched run (:mod:`.dataflow`, the runs ``perf-host-sync``
  reads) records the result dtype of every sum, mean, cumulative sum and
  optimizer-moment update (``lerp``/``addcmul`` and their ``_foreach``
  forms), and one in bfloat16/float16 is a finding at the op's site.

All rules but ``num-accum-narrow`` are pure stdlib ``ast``; that one runs
the entries on ``--device`` (imports torch).  The dynamic half is
:mod:`.parity`.
"""
import ast
import os

from ..config.keys import Numerics
from .core import Finding, Module, display_path, dotted_name, iter_python_files

NUMERICS_STATIC_RULE_IDS = (
    Numerics.CODEC_UNBOUNDED,
    Numerics.PRNG_CONSTANT,
    Numerics.PRNG_DISCARD,
    Numerics.PRNG_REUSE,
    Numerics.UNORDERED_REDUCE,
)

#: calls that CONSUME a seed value: two of them on one seed give two
#: generators with identical streams
_CONSUMERS = frozenset({"default_rng", "manual_seed", "manual_seed_all", "SeedSequence"})

#: the split-like derivation whose literal subscript drops siblings
_SPLITTERS = frozenset({"spawn"})

#: function-name fragments marking a per-step/per-round path …
_STEPPY = ("step", "round", "batch", "epoch", "iteration")
#: … and the one-time-construction fragments that exempt it
_STEPPY_EXEMPT = ("init", "seed", "make", "build", "setup", "example",
                  "test", "entry", "fixture")

#: fan-in sinks whose operand ORDER is the reduce's parity contract
_SINK_LEAVES = frozenset({
    "cat", "concatenate", "hstack", "load_arrays_many", "stack", "vstack",
})

#: codec-kernel def-name prefixes (num-codec-unbounded scope)
_CODEC_PREFIXES = ("compress", "decompress", "dequantize", "quantize",
                   "reconstruct", "encode_", "decode_")

#: keyword evidence that a ``rec.event(...)`` accounts a codec
_COMPRESS_EVIDENCE_KWARGS = frozenset({
    "compression_ratio", "error_norm", "factored_bytes", "full_bytes",
})


# ------------------------------------------------------------ seed calls
def _seed_leaf(call):
    """The seeding/splitting leaf of a call (``"manual_seed"``,
    ``"default_rng"``, ``"spawn"``, ...), or None."""
    name = dotted_name(call.func, require_name_root=False) or ""
    leaf = name.rsplit(".", 1)[-1]
    return leaf if leaf in _CONSUMERS or leaf in _SPLITTERS else None


def _key_arg_name(call):
    """The consumed seed operand when it is a plain Name (precision over
    recall: attributes and derived seeds are out of scope)."""
    if call.args and isinstance(call.args[0], ast.Name):
        return call.args[0].id
    return None


def _target_names(target, out):
    if isinstance(target, ast.Name):
        out.add(target.id)
    elif isinstance(target, (ast.Tuple, ast.List)):
        for elt in target.elts:
            _target_names(elt, out)
    elif isinstance(target, ast.Starred):
        _target_names(target.value, out)


def _assigned_names(stmts):
    """Every plain name (re)bound anywhere under ``stmts`` — loop-carried
    re-derivation evidence for the loop-reuse check."""
    names = set()
    for stmt in stmts:
        for node in ast.walk(stmt):
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    _target_names(t, names)
            elif isinstance(node, (ast.AugAssign, ast.AnnAssign,
                                   ast.NamedExpr)):
                _target_names(node.target, names)
            elif isinstance(node, (ast.For, ast.AsyncFor)):
                _target_names(node.target, names)
            elif isinstance(node, ast.withitem) and node.optional_vars:
                _target_names(node.optional_vars, names)
    return names


def _stmt_calls(stmt):
    """Calls in one statement, nested defs/lambdas excluded (they are
    their own key scope), in source order."""
    out = []
    stack = [stmt]
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)) and node is not stmt:
            continue
        if isinstance(node, ast.Call):
            out.append(node)
        stack.extend(ast.iter_child_nodes(node))
    out.sort(key=lambda c: (c.lineno, c.col_offset))
    return out


# --------------------------------------------------------------- PRNG scan
class _PrngScan:
    """num-prng-reuse over one function body: a linear walk tracking which
    key names have been consumed, cleansed on rebinding; branches walk on
    copies and merge by union (a key consumed on either branch is consumed
    after the join)."""

    def __init__(self, mod, findings):
        self.mod, self.findings = mod, findings

    def run(self, fn):
        self._block(fn.body, {}, frozenset())

    def _flag(self, call, message):
        self.findings.append(Finding(
            rule=Numerics.PRNG_REUSE, path=self.mod.path,
            line=call.lineno, col=call.col_offset, message=message,
        ))

    def _consume(self, stmt, consumed, loop_locals):
        for call in _stmt_calls(stmt):
            leaf = _seed_leaf(call)
            if leaf not in _CONSUMERS:
                continue
            name = _key_arg_name(call)
            if name is None:
                continue
            if loop_locals is not None and name not in loop_locals:
                self._flag(call, (
                    f"seed '{name}' is consumed by {leaf} inside a loop "
                    "without per-iteration re-derivation — every iteration "
                    "replays identical bits (derive the seed from the loop "
                    "index first)"
                ))
            elif name in consumed:
                first = consumed[name]
                self._flag(call, (
                    f"seed '{name}' already consumed at line {first} is "
                    f"consumed again by {leaf} — both generators draw "
                    "identical bits (derive a distinct seed for each)"
                ))
            else:
                consumed[name] = call.lineno

    def _block(self, stmts, consumed, assigned_in_loops, loop_locals=None):
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue  # nested scopes are scanned separately
            if isinstance(stmt, (ast.For, ast.AsyncFor, ast.While)):
                body_locals = _assigned_names(stmt.body)
                self._block(stmt.body, dict(consumed), assigned_in_loops,
                            loop_locals=body_locals)
                self._block(stmt.orelse, dict(consumed), assigned_in_loops)
                # names the loop rebinds are re-derived from the caller's
                # perspective; the rest keep their pre-loop state
                for n in body_locals:
                    consumed.pop(n, None)
                continue
            if isinstance(stmt, ast.If):
                a, b = dict(consumed), dict(consumed)
                self._block(stmt.body, a, assigned_in_loops, loop_locals)
                self._block(stmt.orelse, b, assigned_in_loops, loop_locals)
                consumed.clear()
                consumed.update(b)
                consumed.update(a)
                continue
            if isinstance(stmt, ast.Try):
                for block in ([stmt.body, stmt.orelse, stmt.finalbody]
                              + [h.body for h in stmt.handlers]):
                    self._block(block, consumed, assigned_in_loops,
                                loop_locals)
                continue
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                self._consume(stmt, consumed, loop_locals)
                self._block(stmt.body, consumed, assigned_in_loops,
                            loop_locals)
                continue
            self._consume(stmt, consumed, loop_locals)
            rebound = set()
            if isinstance(stmt, ast.Assign):
                for t in stmt.targets:
                    _target_names(t, rebound)
            elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign,
                                   ast.NamedExpr)):
                _target_names(stmt.target, rebound)
            for n in rebound:
                consumed.pop(n, None)


def _scan_prng_reuse(mod, findings):
    for node in ast.walk(mod.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            _PrngScan(mod, findings).run(node)


def _scan_prng_discard(mod, findings):
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Subscript):
            continue
        if not isinstance(node.value, ast.Call):
            continue
        if _seed_leaf(node.value) not in _SPLITTERS:
            continue
        ix = node.slice
        if isinstance(ix, ast.UnaryOp) and isinstance(ix.op, ast.USub):
            ix = ix.operand
        if isinstance(ix, ast.Constant) and isinstance(ix.value, int):
            findings.append(Finding(
                rule=Numerics.PRNG_DISCARD, path=mod.path,
                line=node.lineno, col=node.col_offset,
                message=(
                    ".spawn(...)[literal] silently drops the sibling seeds "
                    "— and the kept child can collide with another "
                    "derivation of the same parent.  Unpack the spawn and "
                    "thread every child (or derive from a counter)"
                ),
            ))


def _is_const_seed(call):
    return bool(call.args) and all(
        isinstance(a, ast.Constant) and isinstance(a.value, (int, bool))
        for a in call.args
    )


def _scan_prng_constant(mod, findings):
    def steppy(name):
        low = name.lower()
        return (any(s in low for s in _STEPPY)
                and not any(s in low for s in _STEPPY_EXEMPT))

    def visit(node, fname, in_loop):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            fname, in_loop = node.name, False
        elif isinstance(node, (ast.For, ast.AsyncFor, ast.While)):
            in_loop = True
        elif isinstance(node, ast.Call):
            leaf = _seed_leaf(node)
            if leaf in _CONSUMERS and _is_const_seed(node) and (
                    in_loop or (fname and steppy(fname))):
                where = ("a loop" if in_loop
                         else f"per-step path '{fname}'")
                findings.append(Finding(
                    rule=Numerics.PRNG_CONSTANT, path=mod.path,
                    line=node.lineno, col=node.col_offset,
                    message=(
                        f"constant-seeded {leaf} constructed inside {where} "
                        "— every pass replays identical noise; derive the "
                        "seed from the carried generator (or the step "
                        "counter)"
                    ),
                ))
        for child in ast.iter_child_nodes(node):
            visit(child, fname, in_loop)

    visit(mod.tree, None, False)


# ------------------------------------------------------- unordered fan-in
_UNORDERED_ITER_LEAVES = {
    "keys": "dict key iteration order",
    "values": "dict value iteration order",
    "items": "dict item iteration order",
    "listdir": "an unsorted os.listdir enumeration",
    "iterdir": "an unsorted Path.iterdir enumeration",
    "scandir": "an unsorted os.scandir enumeration",
    "glob": "an unsorted glob enumeration",
}


def _unordered_reason(node, tainted):
    """Why this expression's element ORDER is unstable, or None."""
    if isinstance(node, ast.Name):
        return tainted.get(node.id)
    if isinstance(node, (ast.Set, ast.SetComp)):
        return "set iteration order"
    if isinstance(node, (ast.ListComp, ast.GeneratorExp)):
        for gen in node.generators:
            reason = _unordered_reason(gen.iter, tainted)
            if reason:
                return reason
        return None
    if isinstance(node, ast.Starred):
        return _unordered_reason(node.value, tainted)
    if isinstance(node, ast.Call):
        name = dotted_name(node.func, require_name_root=False) or ""
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("sorted",):
            return None  # explicit ordering cleanses
        if leaf in _UNORDERED_ITER_LEAVES:
            return _UNORDERED_ITER_LEAVES[leaf]
        if leaf == "set":
            return "set iteration order"
        if leaf in ("list", "tuple", "reversed", "enumerate", "iter"):
            return (_unordered_reason(node.args[0], tainted)
                    if node.args else None)
    return None


def _scan_unordered_reduce(mod, findings):
    for fn in ast.walk(mod.tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        tainted = {}
        for stmt in ast.walk(fn):
            if isinstance(stmt, ast.Assign):
                reason = _unordered_reason(stmt.value, tainted)
                names = set()
                for t in stmt.targets:
                    _target_names(t, names)
                for n in names:
                    if reason:
                        tainted[n] = reason
                    else:
                        tainted.pop(n, None)
        for call in ast.walk(fn):
            if not isinstance(call, ast.Call):
                continue
            name = dotted_name(call.func, require_name_root=False) or ""
            leaf = name.rsplit(".", 1)[-1]
            if leaf not in _SINK_LEAVES and not (
                    leaf == "sum" and isinstance(call.func, ast.Name)):
                continue
            if not call.args:
                continue
            reason = _unordered_reason(call.args[0], tainted)
            if reason:
                findings.append(Finding(
                    rule=Numerics.UNORDERED_REDUCE, path=mod.path,
                    line=call.lineno, col=call.col_offset,
                    message=(
                        f"reduce fan-in '{leaf}' consumes operands in "
                        f"{reason} — fp addition does not commute "
                        "bitwise, so operand order IS the parity "
                        "contract; sort the enumeration first"
                    ),
                ))


# ------------------------------------------------------- codec accounting
class _CodecAudit:
    __slots__ = ("path", "codec_defs", "evidence", "called")

    def __init__(self, path):
        self.path = path
        self.codec_defs = []   # [(name, line, col)]
        self.evidence = False
        self.called = set()    # leaf names of every call in the module


def _audit_codecs(mod):
    audit = _CodecAudit(mod.path)
    for node in ast.walk(mod.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if node.name.lstrip("_").startswith(_CODEC_PREFIXES):
                audit.codec_defs.append(
                    (node.name, node.lineno, node.col_offset)
                )
        elif isinstance(node, ast.Call):
            name = dotted_name(node.func, require_name_root=False) or ""
            leaf = name.rsplit(".", 1)[-1]
            if leaf:
                audit.called.add(leaf)
            if leaf == "record_compression_health":
                audit.evidence = True
            elif leaf == "event":
                for kw in node.keywords:
                    if kw.arg in _COMPRESS_EVIDENCE_KWARGS:
                        audit.evidence = True
                    if (kw.arg == "cat"
                            and isinstance(kw.value, ast.Constant)
                            and kw.value.value == "compress"):
                        audit.evidence = True
            elif leaf == "wire":
                if any(kw.arg == "codec" for kw in node.keywords):
                    audit.evidence = True
    return audit


def _codec_findings(audits):
    findings = []
    for audit in audits:
        if not audit.codec_defs or audit.evidence:
            continue
        defined = {name for name, _l, _c in audit.codec_defs}
        accounted = any(
            other.evidence and (other.called & defined)
            for other in audits if other is not audit
        )
        if accounted:
            continue
        name, line, col = audit.codec_defs[0]
        findings.append(Finding(
            rule=Numerics.CODEC_UNBOUNDED, path=audit.path,
            line=line, col=col,
            message=(
                f"codec kernel(s) {sorted(defined)} never emit "
                "error/compression-ratio telemetry — neither this module "
                "nor any consumer calls record_compression_health / "
                "rec.event(cat='compress') / rec.wire(codec=...); a lossy "
                "wire path would ship unaccounted"
            ),
        ))
    return findings


# ---------------------------------------------------------------- tier run
def run_tier7_static(paths=None):
    """The tier-7 static half over ``paths`` (files or directories).
    Parse failures are skipped silently — the base static scan already
    reports them through its own error channel."""
    paths = list(paths) if paths else ["coinstac_dinunet_tpu_torch"]
    findings, audits = [], []
    for path in iter_python_files(paths):
        display = display_path(path)
        try:
            mod = Module.parse(path, display)
        except (SyntaxError, UnicodeDecodeError, OSError, ValueError):
            continue
        _scan_prng_reuse(mod, findings)
        _scan_prng_discard(mod, findings)
        _scan_prng_constant(mod, findings)
        _scan_unordered_reduce(mod, findings)
        audits.append(_audit_codecs(mod))
    findings.extend(_codec_findings(audits))
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings


# ------------------------------------------------ num-accum-narrow (runs)
#: accumulation ops whose result dtype is the accumulator's
_ACCUM_OPS = frozenset({
    "sum", "mean", "cumsum", "nansum", "lerp", "lerp_", "addcmul", "addcmul_",
    "_foreach_lerp", "_foreach_lerp_", "_foreach_addcmul", "_foreach_addcmul_",
})

#: dtypes too narrow to accumulate in (the mantissa loses low-order terms)
_NARROW = frozenset({"bfloat16", "float16"})


def accum_narrow_findings(runs):
    """``num-accum-narrow`` over entry runs (:class:`.deepcheck.EntryRun`
    with their watched ops): one finding per site where an accumulation
    came out in bfloat16/float16, naming the entries and ops."""
    from .dataflow import op_site

    sites = {}
    for run in runs:
        for ev in run.ops or ():
            if ev.kind != "accum" or not (set(ev.out_dtypes) & _NARROW):
                continue
            at = op_site(ev.stack)
            site = sites.setdefault(at, {})
            for dt in sorted(set(ev.out_dtypes) & _NARROW):
                key = (run.name, ev.op, dt)
                site[key] = site.get(key, 0) + 1
    findings = []
    for (path, line), counts in sorted(sites.items()):
        detail = ", ".join(f"entry '{name}': {op} in {dt} x{n}"
                           for (name, op, dt), n in sorted(counts.items()))
        findings.append(Finding(
            rule=Numerics.ACCUM_NARROW, path=path, line=line, col=0,
            message=(
                f"accumulation comes out in a narrow dtype ({detail}) — "
                "low-order contributions round away; accumulate in float32 "
                "and cast at the boundary"
            ),
        ))
    return findings


def run_accum_narrow(names=None, device="cuda"):
    """``num-accum-narrow`` over the deep entries' watched runs on
    ``device`` (the runs ``--tier3``/``--deep`` share: each entry runs
    twice per process).  An entry that fails is ``--deep``'s to report;
    an error of the audit itself is the typed ``num-config`` finding."""
    try:
        from . import deepcheck

        wanted = set(names) if names else None
        runs = [deepcheck.run_entry(name, device)
                for name in sorted(deepcheck.list_entry_points())
                if wanted is None or name in wanted]
        findings = accum_narrow_findings(runs)
    except Exception as exc:  # noqa: BLE001 — typed error channel
        findings = [Finding(
            rule=Numerics.CONFIG,
            path="coinstac_dinunet_tpu_torch/analysis/numerics.py", line=1, col=0,
            message=("the num-accum-narrow audit could not run: "
                     f"{type(exc).__name__}: {exc}"),
        )]
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings

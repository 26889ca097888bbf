"""perf-*: the port's performance-hazard rules of ``--tier3`` — the JAX
package's ``analysis/perf_rules.py``.

The JAX rules read each entry's jaxpr and jit metadata.  Eager PyTorch has
neither, so each rule reads the same deep entry's watched second run
(:func:`.deepcheck.run_entry`: its arguments, its output, its step
callable and the ops :func:`.dataflow.watch_ops` recorded), the runs
``perf-host-sync`` reads:

- ``perf-donation`` — an argument that is a multi-leaf state tree
  (params / optimizer state) whose exact successor (the same structure and
  leaf shapes and dtypes) comes back as the output or one element of it,
  in fresh storage: both generations stay live every step.  The port's
  donation is the in-place update (``parallel/sequence.py`` ``sgd_step
  (donate=True)``, the JAX package's ``donate_argnums``), so a successor
  that shares its argument's storage is donated.
- ``perf-dtype-promotion`` — dtype traffic inside a step: an argument of
  float32/float64 cast down to bfloat16/float16 inside the step (the cast
  belongs at batch staging), a reduced-precision tensor cast up to float32
  and fed into a matrix product or convolution in a step whose other
  products run reduced, or the same tensor (same storage, view and
  version) cast to the same dtype twice.
- ``perf-constant-capture`` — a large tensor the step callable closes over
  (its closure cells, the closures of the functions it closes over, and
  the containers in them) instead of taking it as an argument: it is
  invisible to the caller's donation and device placement.  Parameters
  (``requires_grad``) are module state, not constants.

``perf-host-sync`` is :func:`.dataflow.host_sync_findings` (a
synchronizing CUDA call of the second run).  Thresholds are constructor
parameters, as in the JAX package; the defaults keep the rules quiet on
the registry's miniature stand-ins except where structure is the signal
(donation has no byte floor).  Findings anchor at the code that decides:
the step function that returned the fresh tree (the innermost one of the
port's package the entry's callable closes over, else the entry's own),
the cast's call site, the function whose closure holds the tensor.
"""
import inspect
import os

from .core import Finding

#: dtype-promotion findings need the tensor to be worth a memory pass
DEFAULT_DTYPE_MIN_BYTES = 64 * 1024
#: constants below this are the normal mask/index noise
DEFAULT_CONST_MIN_BYTES = 1024 * 1024

_REDUCED_FLOATS = ("bfloat16", "float16")

_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ANALYSIS_ROOT = os.path.dirname(os.path.abspath(__file__))


def _human(nbytes):
    for unit in ("B", "KiB", "MiB", "GiB"):
        if nbytes < 1024 or unit == "GiB":
            return f"{nbytes:.1f} {unit}" if unit != "B" else f"{int(nbytes)} B"
        nbytes /= 1024


def _display(path):
    rel = os.path.relpath(path)
    return (path if rel.startswith("..") else rel).replace(os.sep, "/")


def _code_of(fn):
    fn = inspect.unwrap(getattr(fn, "__func__", fn))
    return getattr(fn, "__code__", None)


def _in_port(path):
    path = os.path.abspath(path)
    return path.startswith(_PKG_ROOT + os.sep) and not path.startswith(_ANALYSIS_ROOT + os.sep)


def _closure_values(fn):
    fn = getattr(fn, "__func__", fn)
    for cell in getattr(fn, "__closure__", None) or ():
        try:
            yield cell.cell_contents
        except ValueError:  # an empty cell
            continue


def _callables(fn, depth=3):
    """``fn`` and the functions its closure holds, breadth first, to
    ``depth`` levels."""
    seen, level, out = set(), [fn], []
    for _ in range(depth + 1):
        nxt = []
        for f in level:
            if id(f) in seen or _code_of(f) is None:
                continue
            seen.add(id(f))
            out.append(f)
            nxt += [v for v in _closure_values(f) if callable(v)]
        level = nxt
    return out


def step_site(run):
    """Where a step's donation is decided: the innermost function of the
    port's package (outside the analyzer) that the entry's callable closes
    over, else the callable itself, as ``(path, line)``."""
    funcs = _callables(run.fn)
    port = [f for f in funcs if _in_port(_code_of(f).co_filename)]
    f = port[-1] if port else (funcs[0] if funcs else None)
    if f is None:
        return run.path, 1
    code = _code_of(f)
    return _display(code.co_filename), code.co_firstlineno


def _tensor_leaves(tree):
    return _signature(tree)[2]


def _signature(tree):
    import torch
    from torch.utils._pytree import tree_flatten

    leaves, spec = tree_flatten(tree)
    sig = tuple((tuple(t.shape), str(t.dtype)) if isinstance(t, torch.Tensor)
                else type(t).__name__ for t in leaves)
    return spec, sig, [t for t in leaves if isinstance(t, torch.Tensor)]


class DonationRule:
    """perf-donation: state-tree arguments returned updated in fresh
    storage (see the module docstring)."""

    id = "perf-donation"
    doc = ("Params/opt-state-shaped step arguments whose successor the step "
           "returns in fresh storage instead of updating them in place.")

    def __init__(self, min_leaves=2, min_bytes=0):
        self.min_leaves = int(min_leaves)
        self.min_bytes = int(min_bytes)

    def check(self, run):
        if run.rule is not None or run.args is None:
            return []
        from .dataflow import _storage_ptr

        cands = [run.out] + (list(run.out) if isinstance(run.out, (tuple, list)) else [])
        outs = [_signature(c) for c in cands]
        try:  # the step's parameter names label the arguments, as arg_names in JAX
            names = list(inspect.signature(run.fn).parameters)
        except (TypeError, ValueError):
            names = []
        findings = []
        for i, arg in enumerate(run.args):
            spec, sig, leaves = _signature(arg)
            if len(leaves) < self.min_leaves:
                continue
            total = sum(t.numel() * t.element_size() for t in leaves)
            if total < self.min_bytes:
                continue
            for o_spec, o_sig, o_leaves in outs:
                if (o_spec, o_sig) != (spec, sig):
                    continue
                held = [(a, b) for a, b in zip(leaves, o_leaves)
                        if _storage_ptr(a) and _storage_ptr(b)]
                if not held or all(_storage_ptr(a) == _storage_ptr(b) for a, b in held):
                    continue  # updated in place: donated
                path, line = step_site(run)
                findings.append(Finding(
                    rule=self.id, path=path, line=line, col=0,
                    message=(
                        f"entry '{run.name}': argument {i}"
                        f"{f' ({names[i]})' if i < len(names) else ''} is a {len(leaves)}-leaf state "
                        f"tree ({_human(total)}) whose exact successor the step returns "
                        "in fresh storage — both generations stay live every step "
                        "(device memory doubles); update it in place (donate=True, as "
                        "parallel/sequence.py's sgd_step)"
                    ),
                ))
                break
        return findings


class DtypePromotionRule:
    """perf-dtype-promotion: hoistable argument downcasts, float32 upcasts
    feeding products in a reduced-precision step, repeated casts."""

    id = "perf-dtype-promotion"
    doc = ("f32 upcasts feeding matmuls, staging-hoistable argument casts, "
           "and repeated casts inside a reduced-precision step.")

    def __init__(self, min_bytes=DEFAULT_DTYPE_MIN_BYTES):
        self.min_bytes = int(min_bytes)

    def check(self, run):
        from .dataflow import op_site, tensor_key

        if run.rule is not None or not run.ops:
            return []
        arg_keys = {tensor_key(t) for t in _tensor_leaves(run.args)} if run.args else set()
        computes = [ev for ev in run.ops if ev.kind == "compute"]
        reduced_compute = any(set(ev.in_dtypes) & set(_REDUCED_FLOATS) for ev in computes)
        compute_ptrs = {p for ev in computes for p in ev.in_ptrs if p}
        findings, seen = [], set()

        def report(ev, msg):
            path, line = op_site(ev.stack)
            findings.append(Finding(rule=self.id, path=path, line=line, col=0,
                                    message=f"entry '{run.name}': {msg}"))

        for ev in run.ops:
            if ev.kind != "cast" or ev.nbytes < self.min_bytes:
                continue
            src_dt, dst_dt = ev.in_dtypes[0], ev.out_dtypes[0]
            shape = "x".join(map(str, ev.src[2])) or "scalar"
            if ev.src in arg_keys and src_dt in ("float32", "float64") \
                    and dst_dt in _REDUCED_FLOATS:
                report(ev, f"step argument ({shape} {src_dt}, {_human(ev.nbytes)}) is cast "
                           f"to {dst_dt} inside the step — hoist the cast to batch staging "
                           "so the step consumes the compute dtype directly")
            if reduced_compute and src_dt in _REDUCED_FLOATS and dst_dt == "float32" \
                    and any(p in compute_ptrs for p in ev.out_ptrs if p):
                report(ev, f"{shape} {src_dt} tensor ({_human(ev.nbytes)}) is upcast to "
                           "float32 and fed into a matmul/conv — accidental float32 compute "
                           f"inside a reduced-precision step (the {src_dt} path's bytes and "
                           "tensor-core rate lost)")
            key = (ev.src, dst_dt)
            if key in seen:
                report(ev, f"{shape} {src_dt} tensor ({_human(ev.nbytes)}) is converted to "
                           f"{dst_dt} more than once in the same step — cast once and reuse "
                           "(each repeat is a full memory pass)")
            seen.add(key)
        return findings


class ConstantCaptureRule:
    """perf-constant-capture: large tensors the step closes over."""

    id = "perf-constant-capture"
    doc = ("Large tensors closure-captured by the step callable instead of "
           "passed as arguments.")

    def __init__(self, min_bytes=DEFAULT_CONST_MIN_BYTES):
        self.min_bytes = int(min_bytes)

    def check(self, run):
        import torch

        if run.rule is not None or run.fn is None:
            return []
        findings, seen = [], set()
        for f in _callables(run.fn):
            code = _code_of(f)
            for value in _closure_values(f):
                if callable(value):
                    continue
                for t in _tensor_leaves(value):
                    if id(t) in seen or t.requires_grad or isinstance(t, torch.nn.Parameter):
                        continue
                    seen.add(id(t))
                    nbytes = t.numel() * t.element_size()
                    if nbytes < self.min_bytes:
                        continue
                    shape = "x".join(map(str, t.shape)) or "scalar"
                    findings.append(Finding(
                        rule=self.id, path=_display(code.co_filename),
                        line=code.co_firstlineno, col=0,
                        message=(
                            f"entry '{run.name}': a {shape} "
                            f"{str(t.dtype).replace('torch.', '')} tensor ({_human(nbytes)}) "
                            f"is closure-captured by '{code.co_name}' — the step holds it "
                            "out of the caller's sight (no donation, no placement); pass "
                            "it as an explicit argument"
                        ),
                    ))
        return findings


def default_perf_rules():
    """The rules :func:`perf_findings` runs (``perf-host-sync`` is
    :func:`.dataflow.host_sync_findings`)."""
    return [DonationRule(), DtypePromotionRule(), ConstantCaptureRule()]


def perf_findings(runs, rules=None):
    """The perf rules' findings over entry runs, one finding per site and
    message."""
    findings, seen = [], set()
    for run in runs:
        for rule in rules or default_perf_rules():
            for f in rule.check(run):
                key = (f.rule, f.path, f.line, f.message)
                if key not in seen:
                    seen.add(key)
                    findings.append(f)
    return findings

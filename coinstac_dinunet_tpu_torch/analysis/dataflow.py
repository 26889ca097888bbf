"""The port's ``--tier3``: the ``perf-*`` rules over the deep entries' runs,
and the static phase-machine model.

The JAX package's tier 3 lowers every deep entry to its jaxpr and runs four
``perf-*`` rules over it.  Of those, this slice ports ``perf-host-sync``,
the one with a counterpart the card can observe: where the JAX rule finds a
host callback traced into the step, here each deep entry's second run
(:func:`.deepcheck.run_entry`) goes under ``torch.cuda.set_sync_debug_mode
("warn")``, every synchronizing CUDA call (``.item()``, a device-to-host
copy, a ``nonzero``, an explicit synchronize) is recorded with its Python
stack, and each is anchored to the innermost frame inside
``coinstac_dinunet_tpu_torch/`` (the analyzer's own modules aside; an entry
registered from outside the package anchors to its own code): one finding
per site, naming the entries that reached it.  On a CPU device nothing can
be observed, and the rule reports exactly one ``tier3-config`` finding
that says so — the JAX package's contract for a tier that could not run.

The same second run is watched op by op (:func:`watch_ops`, a
``TorchDispatchMode``): every dtype cast, matrix product and convolution,
and accumulation, with the cast's and a narrow accumulation's Python stack.
``perf-donation``, ``perf-dtype-promotion`` and ``perf-constant-capture``
(:mod:`.perf_rules`) read those records, the run's arguments, output and
step callable, on any device; ``num-accum-narrow`` (:mod:`.numerics`)
reads the accumulations.  ``tier3-lower`` keeps its JAX name for an entry
that could not be built or run under ``--tier3`` alone.

The proto-* half is :mod:`.protocol_flow` (pure AST).
"""
import contextlib
import dataclasses
import os

from .core import Finding

#: every rule id this tier can emit (docs + ``--list-rules``)
TIER3_RULE_IDS = (
    "tier3-config",
    "tier3-lower",
    "perf-host-sync",
    "perf-donation",
    "perf-dtype-promotion",
    "perf-constant-capture",
    "proto-flow-phase",
    "proto-flow-unmatched",
    "proto-cache-read-before-write",
    "proto-cache-never-read",
)

#: the text of torch's warning for a synchronizing call in "warn" mode
_SYNC_WARNING = "called a synchronizing CUDA operation"

_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ANALYSIS_ROOT = os.path.dirname(os.path.abspath(__file__))


@contextlib.contextmanager
def watch_syncs(device):
    """Record the synchronizing CUDA calls made inside the block: yields a
    list that fills with ``(message, stack)`` pairs (``stack`` a
    ``traceback.StackSummary``, innermost last).  On a CPU device it yields
    ``None``: there is nothing to observe."""
    if device.type != "cuda":
        yield None
        return
    import traceback
    import warnings

    import torch

    events = []
    previous = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        shown = warnings.showwarning

        def show(message, category, filename, lineno, file=None, line=None):
            # the mode's own notice on switching it on is no sync
            if _SYNC_WARNING in str(message):
                events.append((str(message), traceback.extract_stack()[:-1]))
            else:
                shown(message, category, filename, lineno, file, line)

        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield events
        finally:
            torch.cuda.set_sync_debug_mode(previous)


#: aten ops a watched run records, by kind
_CAST_OPS = frozenset({"_to_copy"})
_COMPUTE_OPS = frozenset({"mm", "addmm", "bmm", "baddbmm", "convolution", "_convolution"})
_ACCUM_OPS = frozenset({
    "sum", "mean", "cumsum", "nansum", "lerp", "lerp_", "addcmul", "addcmul_",
    "_foreach_lerp", "_foreach_lerp_", "_foreach_addcmul", "_foreach_addcmul_",
})
_NARROW = ("bfloat16", "float16")


@dataclasses.dataclass
class OpEvent:
    """One recorded op of a watched run.  ``kind`` is ``cast`` (``src`` the
    source tensor's identity, ``src_ptr`` its storage, ``nbytes`` its size),
    ``compute`` (``in_ptrs`` the operands' storages) or ``accum``;
    ``stack`` is the Python stack of casts and narrow accumulations."""

    kind: str
    op: str
    in_dtypes: tuple
    out_dtypes: tuple
    out_ptrs: tuple = ()
    in_ptrs: tuple = ()
    src: tuple = None
    src_ptr: int = None
    nbytes: int = 0
    stack: object = None


def _dtype_name(t):
    return str(t.dtype).replace("torch.", "")


def _storage_ptr(t):
    try:
        return int(t.untyped_storage().data_ptr())
    except Exception:  # noqa: BLE001 — meta and other storage-less tensors
        return 0


def tensor_key(t):
    """A tensor's identity within one run: storage, offset, shape, strides
    and version counter (an in-place update makes it another tensor)."""
    return (_storage_ptr(t), int(t.storage_offset()), tuple(t.shape), tuple(t.stride()),
            int(t._version))


@contextlib.contextmanager
def watch_ops():
    """Record the casts, matrix products, convolutions and accumulations of
    the aten ops run inside the block: yields a list of :class:`OpEvent`.
    The ops themselves run unchanged (kernel launches and their counts
    included)."""
    import traceback

    import torch
    from torch.utils._pytree import tree_leaves
    from torch.utils._python_dispatch import TorchDispatchMode

    events = []

    def tensors(tree):
        return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]

    class _Watch(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            name = func.overloadpacket.__name__
            kind = ("cast" if name in _CAST_OPS else "compute" if name in _COMPUTE_OPS
                    else "accum" if name in _ACCUM_OPS else None)
            ins = tensors((args, kwargs)) if kind else ()
            key = tensor_key(ins[0]) if kind == "cast" and ins else None
            out = func(*args, **kwargs)
            if kind is None:
                return out
            outs = tensors(out)
            ev = OpEvent(kind, name, tuple(_dtype_name(t) for t in ins),
                         tuple(_dtype_name(t) for t in outs),
                         out_ptrs=tuple(_storage_ptr(t) for t in outs))
            if kind == "cast":
                if not ins or ev.out_dtypes == ev.in_dtypes[:1]:
                    return out  # a copy, no cast
                ev.src, ev.src_ptr = key, key[0]
                ev.nbytes = ins[0].numel() * ins[0].element_size()
                ev.stack = traceback.extract_stack()[:-1]
            elif kind == "compute":
                ev.in_ptrs = tuple(_storage_ptr(t) for t in ins)
            elif set(ev.out_dtypes) & set(_NARROW):
                ev.stack = traceback.extract_stack()[:-1]
            events.append(ev)
            return out

    with _Watch():
        yield events


def _display(path):
    rel = os.path.relpath(path)
    return (path if rel.startswith("..") else rel).replace(os.sep, "/")


def sync_site(stack, runner=None):
    """The frame a synchronizing call is charged to: the innermost frame in
    the port's package outside the analyzer; else the entry's own frame,
    the one :func:`.deepcheck.run_entry` called (``runner`` is that
    function's file; an entry registered outside the package); else the
    innermost frame.  Returns ``(path, line)``."""
    frames = list(stack)
    if runner is not None:
        calls = [i for i, fr in enumerate(frames)
                 if fr.name == "run_entry" and os.path.abspath(fr.filename) == runner]
        if calls and calls[-1] + 1 < len(frames):
            frames = frames[calls[-1] + 1:]
        else:
            runner = None
    for fr in reversed(frames):
        path = os.path.abspath(fr.filename)
        if path.startswith(_PKG_ROOT + os.sep) and not path.startswith(
                _ANALYSIS_ROOT + os.sep):
            return _display(path), fr.lineno
    fr = frames[0] if runner is not None else frames[-1]
    return _display(fr.filename), fr.lineno


def op_site(stack):
    """The frame an op of an entry's run is charged to (:func:`sync_site`
    with the runner's frame): ``(path, line)``."""
    from . import deepcheck

    return sync_site(stack or [], os.path.abspath(deepcheck.__file__))


def host_sync_findings(runs):
    """``perf-host-sync`` findings of entry runs (:class:`.deepcheck.
    EntryRun`): one per synchronizing site, naming the entries."""
    from . import deepcheck

    runner = os.path.abspath(deepcheck.__file__)
    sites = {}
    for run in runs:
        for message, stack in run.syncs or ():
            at = sync_site(stack, runner)
            entry = sites.setdefault(at, {"entries": {}, "message": message})
            entry["entries"][run.name] = entry["entries"].get(run.name, 0) + 1
    findings = []
    for (path, line), site in sorted(sites.items()):
        names = ", ".join(f"'{n}' x{c}" for n, c in sorted(site["entries"].items()))
        findings.append(Finding(
            rule="perf-host-sync", path=path, line=line, col=0,
            message=(f"synchronizing CUDA call on the second run of entry {names}: "
                     f"{site['message'].splitlines()[0]} — the host waits for the card "
                     "inside the step"),
        ))
    return findings


def run_tier3(names=None, paths=None, device="cuda", entries=True):
    """The ``--tier3`` pass: the phase-machine model (``paths`` scopes its
    never-read scan), and unless ``entries`` is False the deep entries' runs
    on ``device`` with ``perf-host-sync`` and the :mod:`.perf_rules` over
    their second runs.  Returns findings; a ``device`` that is not there
    raises."""
    from ..config import resolve_device
    from . import deepcheck
    from .perf_rules import perf_findings
    from .protocol_flow import run_protocol_flow

    findings = list(run_protocol_flow(paths=paths))
    if entries:
        device = resolve_device(device)
        wanted = set(names) if names else None
        runs = [deepcheck.run_entry(name, device)
                for name in sorted(deepcheck.list_entry_points())
                if wanted is None or name in wanted]
        for run in runs:
            if run.rule is not None:
                findings.append(Finding(
                    rule="tier3-lower", path=run.path, line=1, col=0,
                    message=f"entry '{run.name}': {run.message}",
                ))
        if device.type != "cuda":
            findings.append(Finding(
                rule="tier3-config",
                path="coinstac_dinunet_tpu_torch/analysis/dataflow.py", line=1, col=0,
                message="perf-host-sync watches synchronizing CUDA calls and the entries "
                        "ran on a CPU device: nothing was observed (run with --device cuda "
                        "on a card)",
            ))
        findings += host_sync_findings(runs)
        findings += perf_findings(runs)
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings

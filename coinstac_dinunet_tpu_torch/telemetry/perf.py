"""Perf recorder — the FLOP count of a step, per-round utilization and
the device-memory series (PyTorch port).

Port of the JAX package's ``telemetry/perf.py``, as a layer on the
:class:`~.recorder.Recorder`:

- :func:`step_cost` and :func:`step_flops` — the model FLOPs of one call of
  a step, with a typed failure reason (:data:`COST_UNAVAILABLE`,
  ``count_failed: ...``) instead of a silent ``None``.
- :func:`record_jit_cost` — the trainers call it on the step they leave out
  of the throughput series (a model's first step, or one on new batch
  shapes: where the JAX package builds an executable): a ``jit_cost`` event
  and the FLOPs under ``cache['_perf_flops'][key]``, one ``perf:backend``
  event per recorder with the roofline constants.
- :func:`record_step_perf` and :class:`StepTimer` — the per-round
  ``samples_per_sec``, ``achieved_tflops`` and ``mfu`` series of a step from
  its fenced wall time, and a JSON-able rollup under
  ``cache['health']['perf']`` that rides the ``HEALTH`` wire keys, so the
  aggregator sees every site's throughput (and refreshes
  ``cache['site_capacity']`` from it).
- :func:`sample_device_memory` — one device-memory sample a round: the
  ``hbm_in_use_bytes``/``hbm_peak_bytes``/``hbm_limit_bytes`` series and
  ``hbm_utilization`` when a limit is known, feeding the watchdog's leak
  and pressure detectors.
- :data:`PEAK_TFLOPS_BY_DEVICE_KIND` and :func:`resolve_peak_flops` — the
  peak table (the H100 SXM's dense bf16 rate), ``cache['peak_tflops']``
  overriding it.

What the count counts: ``torch.utils.flop_counter.FlopCounterMode`` over
one real call of the step (no extra step is run), so the products the call
dispatches, forward and backward (matrix products and convolutions, every
multiply-add of the padded operands), plus the attention operators, which
it counts from their shapes (``ops/flash_attention.py``,
:func:`~..ops.flash_attention.attention_flops`) on the card and on the CPU
alike.  Elementwise work, norms and the optimizer's update count nothing.
XLA's cost analysis, which the JAX package reads, counts the
multiply-adds on unpadded inputs only, adds elementwise operations and sees
no Pallas call: the two packages' counts of one step differ by that much
(``PERF.md``, "Port faults").  The counter gives no byte count, so
``jit_cost`` carries no ``bytes_accessed``.

What the memory series count: on the card, PyTorch's caching allocator
(``torch.cuda.memory_stats``: ``allocated_bytes.all.current`` and
``.peak``, the bytes of live tensors; its reserved but free blocks are not
counted) over the card's total memory (``torch.cuda.mem_get_info``), where
the JAX package reports XLA's own pool (``bytes_in_use`` over
``bytes_limit``).  On the CPU torch keeps no allocator statistics, so the
sample is a census of the bytes of the tensors the caller holds (the
trainer's parameters, gradients and optimizer state: the port's
counterpart of ``jax.live_arrays()``), over ``cache['memory_limit_bytes']``
when set.

Zero overhead when disabled: every helper returns at once on the null
recorder, and no step runs under the counter.
"""
import time

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..config.keys import Metric, Perf
from .health import record_metric
from .recorder import get_active

__all__ = [
    "COST_UNAVAILABLE", "PEAK_TFLOPS_BY_DEVICE_KIND", "peak_flops_for",
    "resolve_peak_flops", "step_cost", "step_flops", "record_jit_cost",
    "record_step_perf", "sample_device_memory", "StepTimer",
]

#: typed reason when the counter saw no product in the call
COST_UNAVAILABLE = "cost_analysis_unavailable"

#: dense bf16 peak (TFLOP/s, no sparsity) by device-name prefix — the MFU
#: denominator.  The H100 SXM (80 GB HBM3) at 989 TFLOP/s; no CPU entry on
#: purpose: set ``cache['peak_tflops']`` for a device the table lacks.
PEAK_TFLOPS_BY_DEVICE_KIND = {
    "NVIDIA H100 80GB HBM3": 989.0,
}

#: FLOPs-registry cache key (leading underscore: a private cache entry, as
#: in the JAX package), written by :func:`record_jit_cost`, read by
#: :func:`record_step_perf`
FLOPS_CACHE_KEY = "_perf_flops"


def peak_flops_for(device_kind):
    """Peak FLOP/s for a device name from the table, or None."""
    kind = str(device_kind)
    for prefix, tflops in PEAK_TFLOPS_BY_DEVICE_KIND.items():
        if kind.startswith(prefix):
            return tflops * 1e12
    return None


def resolve_peak_flops(cache=None, device=None):
    """The MFU denominator in FLOP/s: ``cache['peak_tflops']`` wins, else
    the table entry of the card ``device``, else None."""
    if cache:
        override = cache.get(Perf.PEAK_TFLOPS)
        if override:
            return float(override) * 1e12
    if device is not None and torch.device(device).type == "cuda":
        return peak_flops_for(torch.cuda.get_device_name(device))
    return None


def _device_kind(device):
    """``(device name, device count)`` for the ``perf:backend`` event."""
    if device is not None and torch.device(device).type == "cuda":
        return torch.cuda.get_device_name(device), torch.cuda.device_count()
    return "cpu", 1


# ----------------------------------------------------------------- the count
def _counted_call(fn, args):
    """``fn(*args)`` once under a ``FlopCounterMode``: ``(out, cost,
    reason)``.  ``cost`` is ``{'flops', 'ops'}`` (the total and its split by
    operator name) or None, and then ``reason`` is the typed failure.  An
    exception of ``fn`` itself propagates: it is the step's, not the
    count's."""
    counter = FlopCounterMode(display=False)
    try:
        counter.__enter__()
    except Exception as exc:  # noqa: BLE001 — the reason is the contract
        return fn(*args), None, f"count_failed: {exc}"[:300]
    try:
        out = fn(*args)
    finally:
        counter.__exit__(None, None, None)
    ops = {str(op): int(n) for op, n in counter.get_flop_counts().get("Global", {}).items()}
    flops = sum(ops.values())
    if flops <= 0:
        return out, None, COST_UNAVAILABLE
    return out, {"flops": float(flops), "ops": ops}, None


def step_cost(fn, *args):
    """The model FLOPs of one call ``fn(*args)`` — the call runs once, for
    real, under the counter (what it does to its arguments, it does).

    Returns ``(cost, reason)``: ``cost`` is ``{'flops', 'ops'}`` (the total
    and its split by operator) or None, and then ``reason`` is the typed
    failure (:data:`COST_UNAVAILABLE` when the call dispatched no product
    the counter knows, ``count_failed: ...`` when the counter itself
    failed)."""
    _, cost, reason = _counted_call(fn, args)
    return cost, reason


def step_flops(fn, *args):
    """:func:`step_cost`'s total: ``(flops, reason)``, exactly one of the
    two None."""
    cost, reason = step_cost(fn, *args)
    return (None, reason) if cost is None else (cost["flops"], None)


def record_jit_cost(cache, key, fn, args, recorder=None, device=None):
    """Run one step ``fn(*args)`` under the counter and flight-record its
    FLOPs: a ``jit_cost`` event (``flops``, ``cat=compile``, as the JAX
    package names it) and ``cache['_perf_flops'][key]`` for
    :func:`record_step_perf`, after this recorder's ``perf:backend``
    event.  A count that fails is a ``perf:cost_unavailable`` event with the
    typed reason — visible in the trace, never silent, and the step is not
    run again.  Returns ``(out, flops)``: the step's result (the count is
    of the real call) and the FLOPs or None.  With the recorder disabled the
    step runs uncounted."""
    rec = recorder if recorder is not None else get_active()
    if not rec.enabled:
        return fn(*args), None
    _emit_backend_event(cache, rec, device)
    out, cost, reason = _counted_call(fn, args)
    if cost is None:
        rec.event("perf:cost_unavailable", cat="perf", fn=str(key), reason=reason)
        return out, None
    rec.event("jit_cost", cat="compile", fn=str(key), flops=cost["flops"])
    if cache is not None:
        cache.setdefault(FLOPS_CACHE_KEY, {})[str(key)] = cost["flops"]
    return out, cost["flops"]


def _emit_backend_event(cache, rec, device=None):
    """One ``perf:backend`` event per recorder: the device's name and
    count, the peak TFLOP/s and its source, and the structural MFU ceiling
    — the roofline constants the doctor reads back out of the merged
    timeline (it keeps the first)."""
    if getattr(rec, "_perf_backend_emitted", False):
        return
    try:
        rec._perf_backend_emitted = True
    except AttributeError:  # a slotted custom sink: emit every time
        pass
    kind, count = _device_kind(device)
    override = (cache or {}).get(Perf.PEAK_TFLOPS)
    peak = resolve_peak_flops(cache, device)
    attrs = {"device_kind": str(kind), "devices": int(count)}
    if peak:
        attrs["peak_tflops"] = round(peak / 1e12, 3)
        attrs["peak_source"] = "cache" if override else "table"
    ceiling = (cache or {}).get(Perf.MFU_CEILING)
    if ceiling:
        attrs["ceiling_mfu"] = float(ceiling)
    rec.event("perf:backend", cat="perf", **attrs)


# ------------------------------------------------------- per-round metrics
def record_step_perf(cache, key, dur_s, samples, recorder=None, device=None):
    """Per-round throughput from one step's fenced wall time.

    ``key`` names the step (``grads``, ``train``, ``fed_step``), ``dur_s``
    the wall seconds, ``samples`` the padded sample count the step
    consumed.  Records ``samples_per_sec`` always, ``achieved_tflops`` when
    the FLOPs registry knows the step (:func:`record_jit_cost`), ``mfu``
    when the peak is known too; mirrors the latest values into
    ``cache['health']['perf']``.
    """
    rec = recorder if recorder is not None else get_active()
    if not rec.enabled or not dur_s or dur_s <= 0:
        return
    sps = float(samples) / dur_s
    record_metric(Metric.SAMPLES_PER_SEC, sps, recorder=rec, fn=str(key))
    roll = {"samples_per_sec": round(sps, 2), "step_s": round(dur_s, 6)}
    flops = (cache.get(FLOPS_CACHE_KEY) or {}).get(str(key)) if cache else None
    if flops:
        tflops = flops / dur_s / 1e12
        record_metric(Metric.ACHIEVED_TFLOPS, tflops, recorder=rec, fn=str(key))
        roll["achieved_tflops"] = round(tflops, 4)
        peak = resolve_peak_flops(cache, device)
        if peak:
            mfu = tflops * 1e12 / peak
            record_metric(Metric.MFU, mfu, recorder=rec, fn=str(key))
            roll["mfu"] = round(mfu, 4)
    if cache is not None:
        health = cache.setdefault("health", {})
        health.setdefault("perf", {}).update(roll)


def _tensor_census(tensors):
    """Bytes of distinct tensor storages among ``tensors``."""
    seen, total = set(), 0
    for t in tensors:
        if not isinstance(t, torch.Tensor):
            continue
        key = (t.device.type, t.untyped_storage().data_ptr())
        if key in seen:
            continue
        seen.add(key)
        total += t.untyped_storage().nbytes()
    return total


def sample_device_memory(cache, recorder=None, leak_watch=True, device=None,
                         census=None):
    """One device-memory sample: the in-use/peak/limit series plus
    ``hbm_utilization`` when a limit is known, feeding the watchdog's leak
    and pressure detectors; returns the in-use bytes, or None.

    On a CUDA ``device``: the caching allocator's ``allocated_bytes.all``
    current and peak, over ``cache['memory_limit_bytes']`` when set, else
    the card's total (``torch.cuda.mem_get_info``).  Elsewhere: a census of
    the tensors ``census`` yields (a callable returning an iterable, or the
    iterable), over ``cache['memory_limit_bytes']`` when set.

    ``leak_watch=False`` records the in-use sample without feeding the
    leak detector — for out-of-cadence samples (the validation phase),
    whose allocation spike would reset the detector's growth streak.  The
    pressure detector sees the utilization either way.
    """
    rec = recorder if recorder is not None else get_active()
    if not rec.enabled:
        return None
    override = cache.get(Perf.MEMORY_LIMIT) if cache else None
    if device is not None and torch.device(device).type == "cuda":
        stats = torch.cuda.memory_stats(device)
        in_use = float(stats.get("allocated_bytes.all.current", 0) or 0)
        peak = stats.get("allocated_bytes.all.peak")
        limit = override or torch.cuda.mem_get_info(device)[1]
        source = "memory_stats"
    else:
        if census is None:
            return None
        tensors = census() if callable(census) else census
        in_use = float(_tensor_census(tensors))
        peak, limit = None, override
        source = "tensor_census"
    record_metric(Metric.HBM_IN_USE, in_use,
                  cache=(cache if leak_watch else None), recorder=rec,
                  source=source)
    if peak is not None:
        record_metric(Metric.HBM_PEAK, float(peak), recorder=rec)
    roll = {"hbm_in_use_bytes": in_use, "memory_source": source}
    if peak is not None:
        roll["hbm_peak_bytes"] = float(peak)
    if limit:
        record_metric(Metric.HBM_LIMIT, float(limit), recorder=rec)
        util = in_use / float(limit)
        record_metric(Metric.HBM_UTILIZATION, util, cache=cache, recorder=rec)
        roll["hbm_limit_bytes"] = float(limit)
        roll["hbm_utilization"] = round(util, 4)
    if cache is not None:
        health = cache.setdefault("health", {})
        health.setdefault("perf", {}).update(roll)
    return in_use


class StepTimer:
    """The per-round timing pattern: construct when the recorder is
    enabled, ``done(...)`` after the host fence."""

    __slots__ = ("t0",)

    def __init__(self):
        self.t0 = time.perf_counter()

    def done(self, cache, key, samples, recorder=None, device=None):
        record_step_perf(cache, key, time.perf_counter() - self.t0, samples,
                         recorder=recorder, device=device)

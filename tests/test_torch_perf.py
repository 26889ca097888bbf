"""The port's perf recorder, profiler capture and profiling helpers
(``telemetry/perf.py``, ``telemetry/capture.py``, ``utils/profiling.py``)
against the JAX package's, on the CPU.

- ``record_step_perf``: the same series and ``health['perf']`` rollup as
  the JAX package's for the same wall time, samples, FLOPs and peak.
- ``sample_device_memory`` on the CPU: a census of the tensors given (the
  counterpart of ``jax.live_arrays()``), the pressure anomaly over a tiny
  ``memory_limit_bytes``; ``leak_watch=False`` leaves the leak detector
  alone, as in JAX.  The card's allocator path needs the card
  (``chip_smoke.py`` path 10).
- Capture: arming, the budget, the name filter, the marker consumed
  without an output directory, and a profiler failure as a
  ``capture:failed`` event — the same in both packages, with
  ``device_trace`` stubbed as ``tests/test_perf.py`` stubs it; the real
  ``device_trace`` writes a Chrome trace.
- The trainer's rounds: no throughput sample on a step's counted first
  call, a memory sample every round; the site-vectorized engine's
  ``fed_step`` samples/s, its memory sample per round and its capture of
  the round after an anomaly.
- With telemetry off the perf helpers cost one attribute lookup.
"""
import json
import os
import time

import numpy as np
import pytest
import torch

from coinstac_dinunet_tpu_torch import telemetry
from coinstac_dinunet_tpu_torch.telemetry import capture, perf
from coinstac_dinunet_tpu_torch.utils import profiling


def _jax_tel():
    from coinstac_dinunet_tpu import telemetry as jax_telemetry
    from coinstac_dinunet_tpu.telemetry import capture as jax_capture
    from coinstac_dinunet_tpu.telemetry import perf as jax_perf
    from coinstac_dinunet_tpu.utils import profiling as jax_profiling

    return jax_telemetry, jax_capture, jax_perf, jax_profiling


def _load(out_dir):
    recs = []
    for name in sorted(os.listdir(out_dir)):
        if name.startswith("telemetry."):
            with open(os.path.join(out_dir, name)) as f:
                recs += [json.loads(line) for line in f]
    return recs


def _metrics(records):
    out = {}
    for r in records:
        if r.get("kind") == "metric":
            out.setdefault(r["name"], []).append(r)
    return out


def test_record_step_perf_series_and_rollup_match_jax(tmp_path):
    jt, _, jperf, _ = _jax_tel()
    got = []
    for tel, mod, name in ((telemetry, perf, "port"), (jt, jperf, "jax")):
        cache = {"profile": True, "_perf_flops": {"train": 2e9}, "peak_tflops": 100.0}
        rec = tel.Recorder("t", cache=cache, out_dir=str(tmp_path / name))
        mod.record_step_perf(cache, "train", 0.01, 128, recorder=rec)
        rec.flush()
        series = {k: [(r["value"], r.get("fn")) for r in v]
                  for k, v in _metrics(_load(tmp_path / name)).items()}
        got.append((series, cache["health"]["perf"],
                    tel.Watchdog(cache, tel.NULL_RECORDER).summary()["perf"]))
    assert got[0] == got[1]
    assert got[0][0]["samples_per_sec"] == [(pytest.approx(12800.0), "train")]
    assert perf.peak_flops_for("NVIDIA H100 80GB HBM3") == 989.0e12
    assert perf.peak_flops_for("cpu") is None
    assert perf.resolve_peak_flops({"peak_tflops": 2.0}, torch.device("cpu")) == 2.0e12
    assert perf.resolve_peak_flops({}, torch.device("cpu")) is None


def test_sample_device_memory_census_and_pressure(tmp_path):
    keep = [torch.ones(256, 256), torch.zeros(10, dtype=torch.float64)]
    view = keep[0][:10]  # a view: its storage counts once
    cache = {"profile": True, "memory_limit_bytes": float(keep[0].nbytes)}
    rec = telemetry.Recorder("t", cache=cache, out_dir=str(tmp_path))
    in_use = perf.sample_device_memory(cache, recorder=rec, device=torch.device("cpu"),
                                       census=lambda: [*keep, view])
    rec.flush()
    assert in_use == keep[0].nbytes + keep[1].nbytes
    by_name = {k: v[-1] for k, v in _metrics(_load(tmp_path)).items()}
    assert by_name["hbm_in_use_bytes"]["value"] == in_use
    assert by_name["hbm_in_use_bytes"]["source"] == "tensor_census"
    assert by_name["hbm_limit_bytes"]["value"] == keep[0].nbytes
    assert by_name["hbm_utilization"]["value"] >= 1.0
    assert "hbm_peak_bytes" not in by_name  # the census has no peak
    assert cache["health"]["anomalies"][-1]["anomaly"] == "memory_pressure"
    assert cache["health"]["perf"]["memory_source"] == "tensor_census"
    # no census and no card: nothing to sample
    assert perf.sample_device_memory({}, recorder=rec, device=torch.device("cpu")) is None


def test_leak_watch_false_skips_the_leak_detector_as_in_jax(tmp_path):
    cache = {"profile": True}
    rec = telemetry.Recorder("t", cache=cache, out_dir=str(tmp_path))
    census = [torch.ones(64, 64)]
    perf.sample_device_memory(cache, recorder=rec, leak_watch=False,
                              device=torch.device("cpu"), census=census)
    assert "memory_leak" not in cache.get("health", {}).get("detectors", {})
    perf.sample_device_memory(cache, recorder=rec, device=torch.device("cpu"), census=census)
    assert "memory_leak" in cache["health"]["detectors"]


# ------------------------------------------------------------------- capture
class _StubTrace:
    """``device_trace`` stand-in: makes the directory and one file (the
    retention contract) without touching the real profiler."""

    calls = []

    def __init__(self, path):
        self.path = str(path)

    def __enter__(self):
        os.makedirs(self.path, exist_ok=True)
        with open(os.path.join(self.path, "trace.stub"), "w") as f:
            f.write("x")
        type(self).calls.append(self.path)
        return self.path

    def __exit__(self, *exc):
        return False


class _Boom:
    def __init__(self, path):
        pass

    def __enter__(self):
        raise RuntimeError("profiler already active")

    def __exit__(self, *exc):
        return False


def _capture_run(tel, cap, prof, monkeypatch, out):
    monkeypatch.setattr(prof, "device_trace", _StubTrace)
    _StubTrace.calls = []
    cache = {"profile": True, "capture_on_anomaly": True, "telemetry_round": 4}
    rec = tel.Recorder("site_0", cache=cache, out_dir=str(out))
    tel.Watchdog(cache, rec).observe("grad_norm", float("nan"))
    pending = dict(cache["health"]["capture_pending"])
    cache["telemetry_round"] = 5
    with cap.captured_round(cache, str(out), rec) as path:
        taken = os.path.relpath(path, str(out)), list(_StubTrace.calls) == [path]
    _StubTrace.calls = []
    with cap.captured_round(cache, str(out), rec):
        pass
    rec.flush()
    names = [r["name"] for r in _load(out) if r.get("kind") == "event"]
    return pending, taken, _StubTrace.calls, cache["health"], names


def test_anomaly_arms_and_next_round_captures_as_in_jax(tmp_path, monkeypatch):
    jt, jcap, _, jprof = _jax_tel()
    ours = _capture_run(telemetry, capture, profiling, monkeypatch, tmp_path / "port")
    theirs = _capture_run(jt, jcap, jprof, monkeypatch, tmp_path / "jax")
    assert ours[:4] == theirs[:4]
    assert ours[4] == theirs[4] == ["anomaly:nonfinite", "capture:armed", "capture:profile"]
    assert ours[1] == (os.path.join("profile_capture", "round5_nonfinite"), True)
    assert ours[3]["captures_taken"] == 1 and "capture_pending" not in ours[3]


def test_capture_budget_and_name_filter_as_in_jax():
    _, jcap, _, _ = _jax_tel()
    results = []
    for cap, null in ((capture, telemetry.NULL_RECORDER), (jcap, None)):
        null = null if null is not None else _jax_tel()[0].NULL_RECORDER
        cache = {"capture_on_anomaly": "nonfinite", "capture_max_profiles": 1}
        steps = [cap.maybe_arm(cache, "nonfinite", null)]
        cache["health"].pop("capture_pending")
        cache["health"]["captures_taken"] = 1
        steps.append(cap.maybe_arm(cache, "nonfinite", null))  # budget spent
        cache2 = {"capture_on_anomaly": ["memory_leak"]}
        steps += [cap.maybe_arm(cache2, "nonfinite", null),
                  cap.maybe_arm(cache2, "memory_leak", null),
                  cap.maybe_arm(cache2, "memory_leak", null),  # one pending at a time
                  cap.maybe_arm({}, "nonfinite", null),
                  cap.capture_wanted({"capture_on_anomaly": 3}, "nonfinite")]
        results.append(steps)
    assert results[0] == results[1] == [True, False, False, True, False, False, False]


@pytest.mark.parametrize("failure", ["no_out_dir", "profiler_error"])
def test_a_capture_failure_is_an_event_not_a_crash(tmp_path, monkeypatch, failure):
    jt, jcap, _, jprof = _jax_tel()
    got = []
    for tel, cap, prof, name in ((telemetry, capture, profiling, "port"),
                                 (jt, jcap, jprof, "jax")):
        monkeypatch.setattr(prof, "device_trace", _Boom)
        cache = {"capture_on_anomaly": True,
                 "health": {"capture_pending": {"anomaly": "nonfinite"}}}
        out = tmp_path / name
        rec = tel.Recorder("t", cache=cache, out_dir=str(out))
        with cap.captured_round(cache, None if failure == "no_out_dir" else str(out), rec):
            ran = True  # the round itself runs unharmed
        rec.flush()
        (fail,) = [r for r in _load(out) if r.get("name") == "capture:failed"]
        got.append((ran, fail["error"], "capture_pending" in cache["health"],
                    cap.maybe_arm(cache, "nonfinite", tel.NULL_RECORDER)))
    assert got[0] == got[1]
    want = ("no outputDirectory" if failure == "no_out_dir" else "profiler already active")
    assert want in got[0][1] and got[0][2:] == (False, True)


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with profiling.device_trace(tmp_path / "cap") as path:
        with profiling.annotate("round"):
            torch.ones(8).sum()
    with open(os.path.join(path, profiling.TRACE_FILE)) as f:
        trace = json.load(f)
    assert any(e.get("name") == "round" for e in trace["traceEvents"])


def test_phase_timer_keeps_the_stats_contract():
    cache = {"profile": True}
    timer = profiling.PhaseTimer(cache)
    for _ in range(3):
        with timer("fwd"):
            pass
    assert cache["profile_stats"]["fwd"]["calls"] == 3
    off = {}
    with profiling.PhaseTimer(off)("fwd"):
        pass
    assert off == {}


# ------------------------------------------------------------- the rounds
def _fsv_trainer(tmp_path, cache):
    from coinstac_dinunet_tpu_torch.models import FSVTrainer

    t = FSVTrainer(cache=cache, state={"outputDirectory": str(tmp_path)}, device="cpu")
    t.init_nn()
    batch = {"inputs": np.ones((4, 12), np.float32), "labels": np.zeros(4, np.int32),
             "_mask": np.ones(4, np.float32)}
    return t, t._stack_batches([batch, batch])


def test_trainer_rounds_emit_health_and_perf_series(tmp_path):
    cache = {"profile": True, "input_size": 12, "hidden_sizes": [8], "seed": 0}
    trainer, batches = _fsv_trainer(tmp_path, cache)
    rec = telemetry.Recorder("site_0", cache=cache, out_dir=str(tmp_path))
    with telemetry.activate(rec):
        for _ in range(3):
            grads, _ = trainer.compute_grads(batches)
        trainer.apply_grads(grads)
        trainer.train_step(batches)
        trainer.train_step(batches)
    rec.flush()
    lane = _load(tmp_path)
    by = _metrics(lane)
    # each step's first call (the fresh model's) runs under the FLOP
    # counter: memory, no throughput
    assert [r["fn"] for r in by["samples_per_sec"]] == ["grads", "grads", "train"]
    assert all(r["value"] > 0 for r in by["samples_per_sec"])
    assert [r["fn"] for r in lane if r.get("name") == "jit_cost"] == ["grads", "train"]
    assert [r["fn"] for r in by["achieved_tflops"]] == ["grads", "grads", "train"]
    assert "mfu" not in by  # no peak for the CPU
    assert len(by["hbm_in_use_bytes"]) == 5
    assert len(by["grad_norm"]) == 3 and len(by["train_loss"]) == 3
    assert len(by["update_norm"]) == 1
    want = float(torch.sqrt(sum(torch.sum(g.float() ** 2)
                                for m in grads.values() for g in m.values())))
    assert by["grad_norm"][-1]["value"] == pytest.approx(want, rel=1e-6)
    roll = cache["health"]["perf"]
    assert roll["samples_per_sec"] > 0 and roll["memory_source"] == "tensor_census"
    params = sum(p.numel() * 4 for p in trainer.nn["fsv_net"].parameters())
    assert roll["hbm_in_use_bytes"] >= 4 * params  # params, grads, Adam's two moments


def test_trainer_without_telemetry_records_nothing(tmp_path):
    cache = {"input_size": 12, "hidden_sizes": [8], "seed": 0}
    trainer, batches = _fsv_trainer(tmp_path, cache)
    trainer.compute_grads(batches)
    trainer.train_step(batches)
    assert "health" not in cache and not os.listdir(tmp_path)


def test_site_vectorized_engine_perf_and_capture(tmp_path, monkeypatch):
    """``profile`` + ``capture_on_anomaly`` on the vectorized engine: per
    round an ``engine:round`` span, ``rounds_per_sec``/``sites_per_sec``, a
    memory sample and (after the plane's first step) a ``fed_step``
    samples/s; a memory-pressure anomaly on the engine's cache captures the
    next round under the (stubbed) profiler, the trace under the
    aggregator's output directory."""
    from coinstac_dinunet_tpu_torch.federation import SiteVectorizedEngine
    from coinstac_dinunet_tpu_torch.models import FSVDataset, FSVTrainer
    from test_torch_subprocess_engine import ARGS, TASK, fill_sites

    monkeypatch.setattr(profiling, "device_trace", _StubTrace)
    _StubTrace.calls = []
    eng = SiteVectorizedEngine(tmp_path, n_sites=2, trainer_cls=FSVTrainer,
                               dataset_cls=FSVDataset, device="cpu", task_id=TASK,
                               profile=True, capture_on_anomaly="memory_pressure",
                               memory_limit_bytes=1.0, **ARGS)
    fill_sites(eng)
    eng.run()
    assert eng.success
    lane = _load(tmp_path)
    by = _metrics(lane)
    rounds = [r for r in lane if r.get("name") == "engine:round"]
    assert len(rounds) == eng.rounds - 1 == len(by["rounds_per_sec"])
    assert len(by["hbm_in_use_bytes"]) == len(rounds)
    fed = [r for r in by["samples_per_sec"] if r["fn"] == "fed_step"]
    assert len(fed) == eng.rounds - 1 and all(r["value"] > 0 for r in fed)
    (armed,) = [r for r in lane if r.get("name") == "capture:armed"]
    assert armed["anomaly"] == "memory_pressure"
    (cap,) = [r for r in lane if r.get("name") == "capture:profile"]
    assert cap["path"].startswith(os.path.join(str(tmp_path), "remote_out", "profile_capture"))
    assert _StubTrace.calls == [cap["path"]] and os.path.isdir(cap["path"])


def test_disabled_perf_path_overhead_is_bounded():
    cache = {}
    null = telemetry.NULL_RECORDER
    t0 = time.perf_counter()
    for _ in range(200_000):
        perf.record_step_perf(cache, "train", 0.01, 128, recorder=null)
    dt = time.perf_counter() - t0
    assert dt < 1.0, f"disabled perf-metric path cost {dt:.3f}s for 200k"
    t0 = time.perf_counter()
    for _ in range(200_000):
        perf.sample_device_memory(cache, recorder=null)
    dt = time.perf_counter() - t0
    assert dt < 1.0, f"disabled memory-sample path cost {dt:.3f}s for 200k"
    assert cache == {}

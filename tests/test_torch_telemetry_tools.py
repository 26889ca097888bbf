"""The port's telemetry tools (``telemetry/{collect,doctor,live,serve,
__main__}.py``) against the JAX package's, on the CPU.

- On both packages' lanes of a 3-site federation (the XOR MLP of
  ``tests/test_torch_node_lanes.py`` with PowerSGD, site_1's inputs NaN
  from its second epoch, every series on): the merged events, the summary
  and its table, the Chrome trace, the doctor's report (JSON), markdown
  and GitHub annotations are bit for bit the JAX tools'; the doctor ranks
  site_1 first.
- The CLI: the same exit codes and written files as the JAX CLI for the
  summary, ``--trace``, ``--summary-json``, ``doctor --json --markdown``,
  an empty directory, a ``watch`` snapshot, ``watch --until-exit`` without
  a command, an assertion that fails, and a watched child process.
- The live plane, mirroring ``tests/test_live.py``: the torn-tail reader,
  the ``Tailer`` across the sidecar, rotation and a torn tail, each
  in-flight verdict, the board, ``/metrics`` and ``/healthz`` served on
  port 0 of 127.0.0.1 and scraped, the server's close; the same outputs as
  the JAX tools for the same records.
- The doctor's roofline, MFU floor, memory headroom and capture sections,
  mirroring ``tests/test_perf.py``, on the port's own ``perf:backend``
  record (``NVIDIA H100 80GB HBM3`` at 989 TFLOP/s).
- The regime stamp: torch, CUDA, the card and ``"jax": None``, so either
  package's ``regime_mismatch`` refuses to diff a port ledger line against
  a JAX one.
"""
import json
import os
import sys
import textwrap
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import coinstac_dinunet_tpu.telemetry.collect as jcollect
import coinstac_dinunet_tpu.telemetry.doctor as jdoctor
import coinstac_dinunet_tpu.telemetry.live as jlive
import coinstac_dinunet_tpu.telemetry.serve as jserve
import coinstac_dinunet_tpu_torch.telemetry.collect as pcollect
import coinstac_dinunet_tpu_torch.telemetry.doctor as pdoctor
import coinstac_dinunet_tpu_torch.telemetry.live as plive
import coinstac_dinunet_tpu_torch.telemetry.serve as pserve
from coinstac_dinunet_tpu.config.keys import Live as JaxLive
from coinstac_dinunet_tpu.telemetry.__main__ import main as jax_main
from coinstac_dinunet_tpu_torch.config.keys import Live
from coinstac_dinunet_tpu_torch.telemetry.__main__ import main as port_main

PACKAGES = {"port": (pcollect, pdoctor, plive, pserve, port_main),
            "jax": (jcollect, jdoctor, jlive, jserve, jax_main)}


def _line(**rec):
    rec.setdefault("v", 1)
    return json.dumps(rec) + "\n"


def _canon(obj):
    return json.dumps(obj, sort_keys=True, default=str)


# ------------------------------------------------------------------ the runs
@pytest.fixture(scope="module")
def lanes(tmp_path_factory):
    """Both packages' lanes of the 3-site NaN-site federation."""
    import jax

    from coinstac_dinunet_tpu.engine import InProcessEngine as JaxEngine
    from coinstac_dinunet_tpu_torch import InProcessEngine
    from test_health import NaNXorDataset
    from test_torch_node_lanes import XOR_ARGS, PortXorDataset, PortXorTrainer, _provision
    from test_trainer import XorTrainer

    root = tmp_path_factory.mktemp("lanes")
    jt = XorTrainer(cache={"input_shape": (2,), "seed": 11, "local_data_parallel": False})
    jt.init_nn()
    PortXorTrainer.jax_init = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), jt.train_state.params["net"])
    engines = {
        "jax": JaxEngine(root / "jax", n_sites=3, trainer_cls=XorTrainer,
                         dataset_cls=NaNXorDataset, input_shape=(2,),
                         local_data_parallel=False, **XOR_ARGS),
        "port": InProcessEngine(root / "port", n_sites=3, trainer_cls=PortXorTrainer,
                                dataset_cls=PortXorDataset, device="cpu", **XOR_ARGS),
    }
    for eng in engines.values():
        _provision(eng, per_site=16)
        eng.run(max_rounds=600)
        assert eng.success
    return {name: str(root / name) for name in engines}


@pytest.mark.parametrize("which", ["port", "jax"])
def test_summaries_traces_and_doctor_match_jax_bit_for_bit(lanes, which):
    out = {}
    for pkg, (collect, doctor, *_rest) in PACKAGES.items():
        events = collect.load_events(lanes[which])
        summary = collect.summarize(events)
        report = doctor.build_report(events)
        out[pkg] = (_canon(list(events)), events.truncated_lines, _canon(summary),
                    collect.render_summary(summary), _canon(collect.chrome_trace(events)),
                    _canon(report), doctor.render_markdown(report),
                    doctor.render_github(report))
    assert out["port"] == out["jax"]
    summary = json.loads(out["port"][2])
    assert {"site_0", "site_1", "site_2", "remote", "engine"} <= set(summary["nodes"])
    trace = json.loads(out["port"][4])
    lanes_named = {e["args"]["name"] for e in trace["traceEvents"]
                   if e.get("ph") == "M" and e.get("name") == "process_name"}
    assert {"site_0", "site_1", "site_2", "remote", "engine"} <= lanes_named


@pytest.mark.parametrize("which", ["port", "jax"])
def test_doctor_ranks_the_nan_site_first(lanes, which):
    report = pdoctor.build_report(pcollect.load_events(lanes[which]))
    top = report["verdicts"][0]
    assert top["severity"] == "critical" and "site_1" in top["cause"], top
    assert "site_1" in pdoctor.render_markdown(report)


def _trace_cases():
    """``tests/test_telemetry.py``'s and ``tests/test_perf.py``'s Chrome
    trace cases: counters across flushes, utilization tracks, a span, an
    event and a wire record on one lane."""
    return {
        "counters": [{"kind": "counter", "name": "grad_steps", "n": 512, "t0": 1.0, "node": "s"},
                     {"kind": "counter", "name": "grad_steps", "n": 40, "t0": 2.0, "node": "s"}],
        "utilization": _perf_events(),
        "mixed": [{"kind": "span", "name": "ok", "t0": 1.0, "dur": 0.5, "node": "x"},
                  {"kind": "event", "name": "e", "t0": 2.0, "node": "x"},
                  {"kind": "wire", "op": "save", "node": "x", "t0": 1.5, "bytes": 64,
                   "arrays": 1, "file": "g.npy"},
                  {"kind": "metric", "name": "grad_norm", "node": "x", "t0": 1.2, "value": 1.0}],
    }


@pytest.mark.parametrize("case", ["counters", "mixed", "utilization"])
def test_chrome_trace_cases_match_jax(case):
    events = _trace_cases()[case]
    ours = pcollect.chrome_trace(events)
    assert _canon(ours) == _canon(jcollect.chrome_trace(events))
    counters = [e for e in ours["traceEvents"] if e.get("ph") == "C"]
    if case == "counters":
        assert [e["args"]["n"] for e in counters if e["name"] == "grad_steps"] == [512, 552]
    elif case == "utilization":
        util = {e["name"] for e in counters if e.get("cat") == "utilization"}
        assert {"metric:mfu", "metric:achieved_tflops", "metric:hbm_in_use_bytes"} <= util
    else:  # the span and the wire record are slices, the event an instant
        slices = [e["name"] for e in ours["traceEvents"] if e.get("ph") == "X"]
        assert sorted(slices) == ["ok", "wire:save:g.npy"]


# ------------------------------------------------------------------- the CLI
def _cli(main, args, capsys):
    try:
        rc = main(args)
    except SystemExit as exc:
        rc = exc.code
    return rc, capsys.readouterr().out


def test_cli_outputs_and_exit_codes_match_jax(lanes, tmp_path, capsys):
    got = {}
    empty = tmp_path / "empty"
    empty.mkdir()
    for pkg, (*_mods, main) in PACKAGES.items():
        d = tmp_path / pkg
        d.mkdir()
        runs = [
            _cli(main, [lanes["port"], "--trace", str(d / "t.json"),
                        "--summary-json", str(d / "s.json")], capsys),
            _cli(main, ["doctor", lanes["port"], "--json", str(d / "r.json"),
                        "--markdown", str(d / "r.md")], capsys),
            _cli(main, ["doctor", lanes["jax"], "--format", "github"], capsys),
            _cli(main, [str(empty)], capsys),
            _cli(main, ["doctor", str(empty)], capsys),
            _cli(main, ["watch", lanes["port"], "--quiet", "--snapshot", str(d / "b.txt"),
                        "--json", str(d / "h.json"), "--metrics-out", str(d / "m.prom")],
                 capsys),
            _cli(main, ["watch", str(empty), "--until-exit"], capsys),
            _cli(main, ["watch", lanes["port"], "--quiet",
                        "--assert-verdict", Live.VERDICT_RETRY_STORM], capsys),
        ]
        files = {name: (d / name).read_text() for name in ("t.json", "s.json", "r.json", "r.md")}
        healthz = json.loads((d / "h.json").read_text())
        got[pkg] = ([rc for rc, _ in runs],
                    [out.replace(str(d), "<out>") for _, out in runs[:3]], files,
                    sorted(healthz["sites"]), healthz["round"],
                    sorted(healthz["anomalies"]), (d / "m.prom").read_text().count("\n"))
    assert got["port"] == got["jax"]
    assert got["port"][0] == [0, 0, 0, 1, 1, 0, 2, 3]
    trace = json.loads(got["port"][2]["t.json"])
    assert any(e.get("args", {}).get("name") == "site_1" for e in trace["traceEvents"])


_CHILD = textwrap.dedent("""
    import json, os, sys, time
    d = sys.argv[1]
    os.makedirs(d, exist_ok=True)
    def emit(node, rec):
        rec.setdefault("v", 1)
        with open(os.path.join(d, f"telemetry.{node}.jsonl"), "a") as f:
            f.write(json.dumps(rec) + "\\n")
    for r in range(1, 4):   # both sites beating
        t = time.time()
        for s in ("site_0", "site_1"):
            emit("engine", {"kind": "event", "name": "engine:heartbeat",
                            "cat": "engine", "t0": t, "site": s, "round": r})
        emit("engine", {"kind": "span", "name": "engine:round", "t0": t,
                        "dur": 0.1, "round": r})
        time.sleep(0.15)
    for r in range(4, 16):  # site_1 goes dark; the engine keeps going
        t = time.time()
        emit("engine", {"kind": "event", "name": "engine:heartbeat",
                        "cat": "engine", "t0": t, "site": "site_0",
                        "round": r})
        emit("engine", {"kind": "span", "name": "engine:round", "t0": t,
                        "dur": 0.1, "round": r})
        time.sleep(0.15)
""")


def test_watch_follows_a_child_and_asserts_in_flight(tmp_path):
    root = tmp_path / "run"
    rc = port_main([
        "watch", str(root), "--until-exit", "--quiet", "--interval", "0.1",
        "--silence-after", "0.6", "--serve", "0",
        "--assert-verdict", Live.VERDICT_SILENCE, "--assert-event", Live.HEARTBEAT,
        "--snapshot", str(tmp_path / "b.txt"), "--metrics-out", str(tmp_path / "m.prom"),
        "--json", str(tmp_path / "h.json"),
        "--", sys.executable, "-c", _CHILD, str(root),
    ])
    assert rc == 0
    assert Live.VERDICT_SILENCE in (tmp_path / "b.txt").read_text()
    vals = _prom_values((tmp_path / "m.prom").read_text())
    assert vals['coinstac_dinunet_site_round{site="site_0"}'] == 15
    assert vals['coinstac_dinunet_site_round{site="site_1"}'] == 3
    snapshot = json.loads((tmp_path / "h.json").read_text())
    assert any(v["verdict"] == Live.VERDICT_SILENCE and v["during_run"]
               for v in snapshot["verdicts"])


# ---------------------------------------------------------- the live plane
def test_live_vocabulary_is_the_jax_packages():
    theirs = {k: v for k, v in vars(JaxLive).items() if not k.startswith("_")}
    ours = {k: v for k, v in vars(Live).items() if not k.startswith("_")}
    assert ours == theirs


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_read_jsonl_segment_skips_a_torn_tail(tmp_path, pkg):
    collect = PACKAGES[pkg][0]
    p = tmp_path / "telemetry.site_0.jsonl"
    p.write_text(_line(kind="event", name="a", t0=1.0) + "{corrupt-complete-line}\n"
                 + _line(kind="event", name="b", t0=2.0)
                 + '{"kind":"event","name":"torn","t0":3.0')
    records, offset, bad, partial = collect.read_jsonl_segment(str(p))
    assert [r["name"] for r in records] == ["a", "b"] and bad == 1 and partial
    with open(p, "a") as f:
        f.write(',"late":true}\n')
    records, _, bad, partial = collect.read_jsonl_segment(str(p), offset)
    assert [r["name"] for r in records] == ["torn"] and records[0]["late"]
    assert bad == 0 and not partial
    events = collect.load_events(str(tmp_path))
    assert events.truncated_lines == 1
    assert "truncated/undecodable" in collect.render_summary(collect.summarize(events))


def _tail_script(live, tmp_path):
    """The ``Tailer`` through a sidecar resume, a rotation to a smaller
    file, an inode replacement and a torn tail: what each poll returns."""
    tmp_path.mkdir()
    p = tmp_path / "telemetry.site_0.jsonl"
    cursors = tmp_path / "cursors.json"
    seen = []

    def poll(t):
        seen.append([(r["name"], r.get("node")) for r in t.poll()])

    p.write_text(_line(kind="event", name="a", t0=1.0))
    t = live.Tailer(str(tmp_path), cursor_path=str(cursors))
    poll(t)
    poll(t)
    with open(p, "a") as f:
        f.write(_line(kind="event", name="b", t0=2.0))
    poll(t)
    t2 = live.Tailer(str(tmp_path), cursor_path=str(cursors))  # resumes
    poll(t2)
    p.write_text(_line(kind="event", name="rotated", t0=3.0))  # smaller: rotation
    poll(t2)
    alt = tmp_path / "replacement"
    alt.write_text(_line(kind="event", name="replaced", t0=4.0)
                   + _line(kind="event", name="tail", t0=5.0))
    os.replace(alt, p)
    poll(t2)
    with open(p, "a") as f:
        f.write('{"kind":"event","name":"torn","t0":6.0')
    poll(t2)
    with open(p, "a") as f:
        f.write("}\n{undecodable}\n")
    poll(t2)
    return seen, t2.truncated_lines


def test_tailer_across_rotation_and_a_torn_tail(tmp_path):
    ours, bad = _tail_script(plive, tmp_path / "port")
    assert ours[0] == [("a", "site_0")] and ours[1] == [] and ours[2] == [("b", "site_0")]
    assert ours[3] == []  # the sidecar resumes without a replay
    assert ours[4] == [("rotated", "site_0")]
    assert ours[5] in ([("replaced", "site_0"), ("tail", "site_0")], [("tail", "site_0")])
    assert ours[6] == [] and ours[7] == [("torn", "site_0")] and bad == 1
    theirs = _tail_script(jlive, tmp_path / "jax")
    assert (ours, bad) == theirs


def _verdict_script(live):
    st = live.LiveState(silence_after=5.0, round_outlier=4.0, mfu_collapse=0.3,
                        retry_storm=3, retry_window=10.0)
    fired = []
    st.ingest([{"kind": "event", "name": Live.HEARTBEAT, "t0": 100.0, "node": "engine",
                "site": "site_1", "round": 1},
               {"kind": "span", "name": "engine:round", "t0": 100.0, "dur": 0.5,
                "node": "engine", "round": 1}])
    fired.append(st.check(now=102.0))
    for r, t in ((2, 108.0), (3, 109.0)):
        st.ingest([{"kind": "span", "name": "engine:round", "t0": t, "dur": 0.5,
                    "node": "engine", "round": r}])
        fired.append(st.check(now=t + 1.0))
    fired.append(st.check(now=111.0))
    now = 1000.0
    recs = [{"kind": "span", "name": "engine:round", "node": "engine", "t0": now + i,
             "dur": dur, "round": 10 + i} for i, dur in enumerate([0.1] * 6 + [1.0])]
    recs += [{"kind": "metric", "name": "mfu", "node": "engine", "t0": now + i, "value": v}
             for i, v in enumerate([0.2] * 6 + [0.01])]
    recs += [{"kind": "event", "name": "wire:retry", "node": "remote", "t0": now + 6 + 0.1 * i}
             for i in range(3)]
    recs += [{"kind": "event", "name": Live.HEARTBEAT, "t0": now + 6, "node": "engine",
              "site": "site_1", "round": 16}]
    st.ingest(recs)
    fired.append(st.check(now=now + 7))
    fired.append(st.check(now=now + 7.5))
    return ([[(v["verdict"], v.get("site"), v["severity"]) for v in f] for f in fired],
            st.status(), _canon(st.snapshot(now=now + 8)),
            live.render_board(st.snapshot(now=now + 8), root="/runs/demo"))


def test_in_flight_verdicts_and_board_match_jax():
    ours = _verdict_script(plive)
    fired = ours[0]
    assert fired[:3] == [[], [], [(Live.VERDICT_SILENCE, "site_1", "critical")]]
    assert fired[3] == [] and fired[5] == []  # edge-triggered
    assert {v for v, _, _ in fired[4]} == {Live.VERDICT_ROUND_OUTLIER, Live.VERDICT_MFU_COLLAPSE,
                                           Live.VERDICT_RETRY_STORM}
    assert "/runs/demo" in ours[3] and "site_1" in ours[3]
    assert ours == _verdict_script(jlive)


def _prom_values(text):
    out = {}
    for line in text.splitlines():
        if line.startswith("#") or not line.strip():
            continue
        name, value = line.rsplit(" ", 1)
        out[name] = float(value)
    return out


def _golden_events():
    events = []
    for r in range(1, 7):
        t = 100.0 + r
        for s in ("site_0", "site_1"):
            events.append({"kind": "event", "name": Live.HEARTBEAT, "node": "engine",
                           "site": s, "t0": t, "round": r})
        events.append({"kind": "span", "name": "engine:round", "node": "engine", "t0": t,
                       "dur": 0.5, "round": r})
        events.append({"kind": "metric", "name": "mfu", "node": "engine", "t0": t,
                       "value": 0.19, "round": r})
    events.append({"kind": "event", "name": "anomaly:grad_explosion", "node": "site_1",
                   "site": "site_1", "t0": 105.5, "round": 4, "metric": "grad_norm",
                   "value": 99.0})
    events.append({"kind": "wire", "op": "save", "node": "site_0", "t0": 103.0,
                   "bytes": 4096, "arrays": 2, "file": "g.npy"})
    return events


def test_metrics_and_healthz_on_port_zero_of_loopback():
    events = _golden_events()
    st = plive.LiveState(silence_after=30.0)
    st.ingest(events)
    st.check(now=106.5)
    report = pdoctor.build_report(events)
    server = pserve.OpsServer(lambda: st.snapshot(now=106.5), port=0)
    try:
        assert server.url("").startswith("http://127.0.0.1:")
        assert not server.url("").endswith(":0")
        with urllib.request.urlopen(server.url("/metrics"), timeout=10) as resp:
            text = resp.read().decode()
        with urllib.request.urlopen(server.url("/healthz"), timeout=10) as resp:
            hz = json.loads(resp.read().decode())
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(server.url("/nope"), timeout=10)
        assert exc.value.code == 404
    finally:
        assert server.close() is True
    vals = _prom_values(text)
    assert vals['coinstac_dinunet_site_round{site="site_0"}'] == 6
    assert vals["coinstac_dinunet_rounds_total"] == report["rounds"]["count"]
    assert vals["coinstac_dinunet_mfu"] == report["metrics"]["mfu"]["last"]
    assert vals["coinstac_dinunet_anomalies_total"] == len(report["anomalies"])
    assert vals['coinstac_dinunet_wire_bytes_total{op="save"}'] == 4096
    for name in vals:
        bare = name.split("{", 1)[0]
        assert pserve.prometheus_name(bare[len(Live.PROM_PREFIX) + 1:]) == bare
    assert hz["status"] == "ok" and hz["round"] == 6 and set(hz["sites"]) == {"site_0", "site_1"}
    # the JAX exporter renders the same text for the same state
    jst = jlive.LiveState(silence_after=30.0)
    jst.ingest(events)
    jst.check(now=106.5)
    assert jserve.render_prometheus(jst.snapshot(now=106.5)) == text
    assert pserve.render_prometheus(st.snapshot(now=106.5)) == text


def test_ops_server_close_joins_or_reports_degraded(tmp_path):
    from coinstac_dinunet_tpu_torch.telemetry import Recorder, activate

    st = plive.LiveState(silence_after=30.0)
    server = pserve.OpsServer(lambda: st.snapshot(now=100.0))
    assert server.close() is True
    server2 = pserve.OpsServer(lambda: st.snapshot(now=100.0))
    wedge = threading.Event()
    stuck = threading.Thread(target=wedge.wait, daemon=True, name="wedged-scrape")
    stuck.start()
    real = server2._thread
    server2._thread = stuck  # a handler wedged mid-scrape
    rec = Recorder("engine", out_dir=str(tmp_path))
    try:
        with activate(rec):
            ok = server2.close(timeout=0.1)
    finally:
        wedge.set()
        real.join(timeout=10)
    assert ok is False and not real.is_alive()
    rec.flush()
    records, _, bad, _ = pcollect.read_jsonl_segment(rec.path())
    assert bad == 0
    assert any("ops server" in str(r.get("what", "")) for r in records
               if r.get("name") == "telemetry:degraded")


# ---------------------------------------------------------- the doctor's roofline
def _perf_events(kind="NVIDIA H100 80GB HBM3", peak=989.0):
    ev = [{"kind": "event", "name": "perf:backend", "cat": "perf", "node": "site_0",
           "t0": 100.0, "device_kind": kind, "devices": 1, "peak_tflops": peak,
           "peak_source": "table", "ceiling_mfu": 0.25}]
    for rnd in range(1, 5):
        t = 100.0 + rnd
        for name, value in (("achieved_tflops", 60.0 + rnd), ("mfu", (60.0 + rnd) / peak),
                            ("samples_per_sec", 1200.0 + rnd), ("hbm_in_use_bytes", 9.0e9),
                            ("hbm_limit_bytes", 80.0e9), ("hbm_utilization", 9.0 / 80.0)):
            ev.append({"kind": "metric", "name": name, "node": "site_0", "t0": t,
                       "value": value, "round": rnd, "fn": "grads"})
    return ev


def _doctor_cases():
    base = _perf_events()
    return {
        "roofline": (base, None),
        "floor": (base, [{"value": 1300.0, "unit": "samples/sec/chip", "mfu": 0.30}]),
        "floor_met": (base, [{"value": 1.0, "mfu": 0.01}]),
        "headroom": (base + [{"kind": "metric", "name": "hbm_utilization", "node": "site_0",
                              "t0": 200.0, "value": 0.97}], None),
        "capture": (base + [{"kind": "event", "name": "capture:profile", "cat": "capture",
                             "node": "site_1", "t0": 103.0, "round": 3, "anomaly": "nonfinite",
                             "path": "/out/profile_capture/round3_nonfinite"}], None),
        "empty": ([], None),
        "backend_only": ([{"kind": "event", "name": "perf:backend", "node": "n", "t0": 1.0,
                           "device_kind": "cpu"}], None),
        "ledger_no_series": ([], [{"value": 1.0, "mfu": 0.3}]),
    }


@pytest.mark.parametrize("case", sorted(_doctor_cases()))
def test_doctor_sections_match_jax(case):
    events, ledger = _doctor_cases()[case]
    out = []
    for doctor in (pdoctor, jdoctor):
        report = doctor.build_report(events, bench_history=ledger)
        out.append((_canon(report), doctor.render_markdown(report), doctor.render_github(report)))
    assert out[0] == out[1]
    report = json.loads(out[0][0])
    md = out[0][1]
    if case == "roofline":
        assert report["roofline"]["backend"]["device_kind"] == "NVIDIA H100 80GB HBM3"
        assert report["roofline"]["backend"]["peak_tflops"] == 989.0
        assert "NVIDIA H100 80GB HBM3" in md and "989" in md
        assert report["roofline"]["mfu"]["last"] == pytest.approx(64.0 / 989.0)
    elif case == "floor":
        assert report["mfu_floor"]["below_floor"] and "BELOW FLOOR" in md
    elif case == "floor_met":
        assert not report["mfu_floor"]["below_floor"]
    elif case == "headroom":
        assert any("memory headroom" in v["cause"] for v in report["verdicts"])
    elif case == "capture":
        assert "## Profiler captures" in md and "round3_nonfinite" in md
    elif case == "empty":
        assert report["roofline"] is None and "# Federation health postmortem" in md
    elif case == "backend_only":
        assert "peak unknown" in md
    else:
        assert report["mfu_floor"] is None


# ------------------------------------------------------------ regime stamp
def test_regime_stamp_refuses_a_cross_package_diff(monkeypatch):
    import torch

    monkeypatch.setattr(pdoctor, "_card", lambda: ("NVIDIA H100 80GB HBM3", "700.00 W"))
    ours = pdoctor.bench_regime(seed=3)
    assert ours["jax"] is None and ours["torch"] == str(torch.__version__)
    assert ours["cuda"] == torch.version.cuda
    assert ours["device"] == "NVIDIA H100 80GB HBM3" and ours["power_limit"] == "700.00 W"
    assert ours["seed"] == 3
    theirs = jdoctor.bench_regime(seed=3)
    port_line = {"value": 100.0, "regime": ours}
    jax_line = {"value": 10.0, "regime": theirs}
    for doctor in (pdoctor, jdoctor):
        assert "jax" in doctor.regime_mismatch(jax_line, port_line)
    report = pdoctor.build_report([], bench_history=[jax_line, port_line])
    assert report["bench"]["refused"] and not report["bench"]["regressed"]
    # two port lines of one regime compare
    assert pdoctor.regime_mismatch({"regime": ours}, {"regime": dict(ours)}) is None


def test_card_reads_nvidia_smi_or_nothing(monkeypatch):
    import subprocess

    def absent(*a, **k):
        raise FileNotFoundError("nvidia-smi")

    monkeypatch.setattr(subprocess, "run", absent)
    assert pdoctor._card() == (None, None)

    class Done:
        stdout = "NVIDIA H100 80GB HBM3, 700.00 W\n"

    monkeypatch.setattr(subprocess, "run", lambda *a, **k: Done)
    assert pdoctor._card() == ("NVIDIA H100 80GB HBM3", "700.00 W")


def test_cli_starts_in_a_fresh_process(tmp_path):
    import subprocess

    (tmp_path / "telemetry.site_0.jsonl").write_text(
        _line(kind="span", name="local:computation", t0=time.time(), dur=0.1, node="site_0"))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": repo}
    proc = subprocess.run([sys.executable, "-m", "coinstac_dinunet_tpu_torch.telemetry",
                           str(tmp_path), "--trace", str(tmp_path / "t.json")],
                          capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "local:computation" in proc.stdout and (tmp_path / "t.json").exists()

"""The port's analyzer (``coinstac_dinunet_tpu_torch.analysis``): its
default tier, engine and CLI, held against the JAX package's analyzer.

The fixture sources are the JAX rule tests' (``tests/test_analysis_rules.py``,
``tests/test_health.py``, ``tests/test_live.py``,
``tests/test_analysis_tier3.py``).  Run through both analyzers, each gives
the same findings — rule, line, column and message — for
``protocol-conformance``, ``telemetry-metric-name``, ``wire-atomic-commit``,
the ported ``sharding-*`` rules and ``proto-flow-*``/``proto-cache-*``
(``proto-cache-volatile`` is not ported: the port keeps no compiled-step
bucket).  The rest: the port's own constructs, the engine (parse errors,
baseline, suppressions), and the CLI's exit codes and refusals.  The
self-check and the ratchet are ``tests/test_torch_analysis_selfcheck.py``.
"""
import ast
import json
import os
import textwrap

import pytest

from coinstac_dinunet_tpu.analysis import protocol as jax_protocol
from coinstac_dinunet_tpu.analysis import protocol_flow as jax_flow
from coinstac_dinunet_tpu.analysis import sharding as jax_sharding
from coinstac_dinunet_tpu.analysis import telemetry_names as jax_tel
from coinstac_dinunet_tpu.analysis import wire_atomic as jax_wire
from coinstac_dinunet_tpu.analysis.core import Module as JaxModule
from coinstac_dinunet_tpu_torch.analysis import (
    Finding,
    Module,
    filter_baselined,
    load_baseline,
    run_lint,
    write_baseline,
)
from coinstac_dinunet_tpu_torch.analysis import protocol, protocol_flow, sharding
from coinstac_dinunet_tpu_torch.analysis import telemetry_names, wire_atomic
from coinstac_dinunet_tpu_torch.analysis.__main__ import main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "coinstac_dinunet_tpu_torch")


def _mods(cls, source, path="fixture.py"):
    source = textwrap.dedent(source)
    return cls(path, source, ast.parse(source))


def _key(findings, drop=()):
    """Findings as (rule, line, column, message): the path of a vocabulary
    finding is each package's own ``config/keys.py``."""
    return [(f.rule, f.line, f.col, f.message) for f in findings if f.rule not in drop]


# ------------------------------------------------------- protocol fixtures
_KEYS = """
class LocalWire:
    PHASE = "phase"
    GRADS = "grads_file"

class RemoteWire:
    PHASE = "phase"
    UPDATE = "update"

ENGINE_PROVIDED_KEYS = ("task_id",)
"""

_ENUM_KEYS = """
class LocalWire:
    PHASE = "phase"
    GRADS = "grads_file"

class RemoteWire:
    PHASE = "phase"
    UPDATE = "update"

ENGINE_PROVIDED_KEYS = ()
"""

PROTOCOL_CASES = {
    "matched": (_KEYS, """
        def compute(out, input):
            out["phase"] = input.get("phase", "init")
            out["grads_file"] = "g.npz"
            up = input["update"]
            task = input["task_id"]
            return up, task
        """, """
        def compute(out, input):
            out["update"] = True
            out["phase"] = input.get("phase")
            check(all, "grads_file", input)
            return out
        """),
    "unmatched_undeclared": (_KEYS, """
        def compute(out, input):
            out["phase"] = "done"
            out["grads_fil"] = "g.npz"       # typo'd producer
            return input["update"]
        """, """
        def compute(out, input):
            out["update"] = True
            out["phase"] = input.get("phase")
            check(all, "grads_file", input)  # consumer of the intended key
            return out
        """),
    "declared_unused": (_KEYS, """
        def compute(out, input):
            out["phase"] = "x"
            return input["update"]
        """, """
        def compute(out, input):
            out["update"] = True
            out["phase"] = input.get("phase")
            return out
        """),
    "enums_and_sides": (_ENUM_KEYS, """
        from config.keys import LocalWire

        class XLearner:
            def step(self):
                return {LocalWire.GRADS.value: "g.npz"}
        """, """
        class XReducer:
            def reduce(self):
                check(all, "grads_file", self.input)
                return {"update": True}

        class COINNRemote:
            def compute(self):
                self.out["phase"] = self.input.get("phase")
        """),
    "nested_gather": (_KEYS, """
        def compute(out, input):
            out["phase"] = "x"
            out["grads_file"] = "g"
            return input["update"]
        """, """
        def compute(out, input):
            out["update"] = True
            out["phase"] = input.get("phase")
            check(all, "grads_file", input)
            pairs = gather(["averages", "metrics"], payloads)
            return pairs
        """),
    "partial_scan": (_KEYS, """
        def compute(out, input):
            out["phase"] = "x"
            return input["update"]
        """, None),
}


@pytest.mark.parametrize("case", sorted(PROTOCOL_CASES))
def test_protocol_conformance_matches_jax(case):
    keys, local, remote = PROTOCOL_CASES[case]
    files = {"nodes/local.py": "site", "nodes/remote.py": "agg"}
    out = []
    for rule_cls, mod_cls in ((jax_protocol.ProtocolConformanceRule, JaxModule),
                              (protocol.ProtocolConformanceRule, Module)):
        rule = rule_cls(keys_source=textwrap.dedent(keys), protocol_files=files)
        mods = [_mods(mod_cls, local, "pkg/nodes/local.py")]
        if remote is not None:
            mods.append(_mods(mod_cls, remote, "pkg/nodes/remote.py"))
        out.append(_key(rule.finalize(mods)))
    assert out[0] == out[1]
    assert (out[1] == []) == (case in ("matched", "partial_scan"))


def test_protocol_file_roles_match_components_not_suffixes():
    """``trainer.py`` is a protocol file; ``nn/basetrainer.py`` is not (a
    bare suffix match would take it, and its ``out[...]`` writes)."""
    rule = protocol.ProtocolConformanceRule()
    assert rule._file_role("coinstac_dinunet_tpu_torch/trainer.py")[0] == "trainer.py"
    assert rule._file_role("coinstac_dinunet_tpu_torch/nn/basetrainer.py") == (None, None)


# ------------------------------------------------------ telemetry fixtures
_TEL_KEYS = """
class Metric:
    GRAD_NORM = "grad_norm"
    VAL_SCORE = "val_score"

class Anomaly:
    NONFINITE = "nonfinite"
"""

_LIVE_KEYS = """
class Metric:
    GRAD_NORM = "grad_norm"

class Anomaly:
    NONFINITE = "nonfinite"

class Live:
    HEARTBEAT = "engine:heartbeat"
    PROM_PREFIX = "coinstac_dinunet"
    VERDICT_SILENCE = "heartbeat_silence"
    FLUSH_INTERVAL = "telemetry_flush_interval_s"
"""

TELEMETRY_CASES = {
    "typo_literal": (_TEL_KEYS, """
        from pkg.telemetry import health

        def f(cache):
            health.record_metric("gradnorm", 1.0, cache=cache)
        """, 1),
    "vocabulary_spellings": (_TEL_KEYS, """
        from pkg.keys import Anomaly, Metric
        from pkg.telemetry import health, register_detector

        def f(rec, cache, wd):
            health.record_metric(Metric.GRAD_NORM, 1.0, cache=cache)
            health.record_metric("val_score", 0.5)
            rec.metric(Metric.GRAD_NORM, 2.0)
            wd.observe(Metric.VAL_SCORE, 0.5)
            name = compute()
            rec.metric(name, 2.0)

        @register_detector(Anomaly.NONFINITE, metric=Metric.GRAD_NORM)
        class D:
            pass

        @register_detector(Anomaly.NONFINITE, metric=None)
        class E:
            pass
        """, 0),
    "unknown_member_and_registrations": (_TEL_KEYS, """
        from pkg.keys import Anomaly, Metric
        from pkg.telemetry import register_detector

        def f(rec):
            rec.metric(Metric.BOGUS, 1.0)

        @register_detector("weird_anomaly", metric=Metric.GRAD_NORM)
        class D:
            pass

        @register_detector(Anomaly.NONFINITE, metric="not_a_metric")
        class E:
            pass
        """, 3),
    "unrelated_calls": (_TEL_KEYS, """
        def f(metrics, df):
            metrics.extract("f1")
            df.metric("whatever")
            observe("thing", 1.0)
        """, 0),
    "live_members_in_events": (_LIVE_KEYS, """
        from pkg.keys import Live

        def f(rec):
            rec.event(Live.HEARTBEAT, cat="engine", site="s")
            rec.event("free_form_event")
            rec.event(Live.HEARTBEET)
        """, 1),
    "live_definition": (_LIVE_KEYS, """
        class Metric:
            GRAD_NORM = "grad_norm"
            BAD = "Grad Norm!"

        class Live:
            HEARTBEAT = "heartbeat"
            PROM_PREFIX = "9coinstac-dinunet"
            VERDICT_SILENCE = "Heartbeat-Silence"
            FLUSH_INTERVAL = "telemetry_flush_interval_s"
        """, 4),
    "clean_definition": (_LIVE_KEYS, _LIVE_KEYS, 0),
}


@pytest.mark.parametrize("case", sorted(TELEMETRY_CASES))
def test_telemetry_metric_name_matches_jax(case):
    keys, source, n = TELEMETRY_CASES[case]
    jax_f = jax_tel.TelemetryMetricNameRule(keys_source=textwrap.dedent(keys)).visit_module(
        _mods(JaxModule, source, "pkg/fixture.py"))
    port_f = telemetry_names.TelemetryMetricNameRule(
        keys_source=textwrap.dedent(keys)).visit_module(_mods(Module, source, "pkg/fixture.py"))
    assert _key(jax_f) == _key(port_f)
    assert len(port_f) == n


def test_port_vocabulary_passes_its_own_definition_checks():
    path = os.path.join(PORT, "config", "keys.py")
    with open(path) as f:
        src = f.read()
    assert telemetry_names.TelemetryMetricNameRule().visit_module(
        Module(path, src, ast.parse(src))) == []


# ---------------------------------------------------- wire-atomic fixtures
WIRE_ATOMIC_CASES = {
    "flags_writes": ("fixture.py", """
        import os
        import numpy as np

        def ship(state, arrays):
            p = os.path.join(state["transferDirectory"], "grads.npy")
            with open(p, "wb") as f:
                f.write(arrays)

        class L:
            def _transfer_path(self, f):
                return f

            def ship2(self, a):
                np.save(self._transfer_path("g.npy"), a)

        def ship3(xfer_dir, a):
            np.save(os.path.join(xfer_dir, "g.npy"), a)
        """, 3),
    "clean": ("fixture.py", """
        import numpy as np

        def fine(state, out_dir, a):
            with open(state["transferDirectory"] + "/g.npy", "rb") as f:
                f.read()
            np.save(out_dir + "/scores.npy", a)
            with open(out_dir + "/log.txt", "w") as f:
                f.write("x")
        """, 0),
    "transport_exempt": ("pkg/resilience/transport.py", """
        def commit(xfer_dir, data):
            with open(xfer_dir + "/g.npy", "wb") as f:
                f.write(data)
        """, 0),
    "mode_kwarg": ("fixture.py", """
        def ship(xfer, data, m):
            with open(xfer + "/g.npy", mode="wb") as f:
                f.write(data)
            with open(xfer + "/g.npy", m) as f:
                f.write(data)
        """, 1),
}


@pytest.mark.parametrize("case", sorted(WIRE_ATOMIC_CASES))
def test_wire_atomic_commit_matches_jax(case):
    path, source, n = WIRE_ATOMIC_CASES[case]
    jax_f = jax_wire.WireAtomicCommitRule().visit_module(_mods(JaxModule, source, path))
    port_f = wire_atomic.WireAtomicCommitRule().visit_module(_mods(Module, source, path))
    assert _key(jax_f) == _key(port_f) and len(port_f) == n


def test_wire_atomic_commit_flags_torch_save_into_a_transfer_dir():
    """The port writes tensors with ``torch.save`` too."""
    found = wire_atomic.WireAtomicCommitRule().visit_module(_mods(Module, """
        import os
        import torch

        def ship(state, t, out_dir):
            torch.save(t, os.path.join(state["transferDirectory"], "w.ckpt"))
            torch.save(t, os.path.join(out_dir, "w.ckpt"))
        """))
    assert [f.line for f in found] == [6] and "torch.save(...)" in found[0].message


# ------------------------------------------------------- sharding fixtures
_MESH_KEYS = """
class MeshAxis:
    SITE = "site"
    DEVICE = "device"
    SP = "sp"
"""

#: the JAX rule tests' fixtures of the rules the port carries (a JAX-only
#: construct — PartitionSpec, a positional collective axis — is no port
#: construct, see analysis/sharding.py)
SHARDING_CASES = {
    "unknown_axis_typo": ("UnknownAxisRule", """
        from jax.sharding import Mesh
        mesh = Mesh(arr.reshape(2, 4), ("site", "devcie"))
        """, 1),
    "constants_resolve": ("UnknownAxisRule", """
        from jax.sharding import Mesh
        from pkg.config.keys import MeshAxis
        from pkg.config import keys

        mesh = Mesh(arr.reshape(2, 4), (MeshAxis.SITE, keys.MeshAxis.DEVICE))
        """, 0),
    "mesh_arity_reshape": ("MeshArityRule", """
        from jax.sharding import Mesh
        mesh = Mesh(arr.reshape(2, 4, 1), ("site", "device"))
        """, 1),
    "mesh_duplicate_axis": ("MeshArityRule", """
        from jax.sharding import Mesh
        bad = Mesh(arr.reshape(2, 4), ("site", "site"))
        good = Mesh(arr.reshape(2, 4), ("site", "device"))
        """, 1),
    "axis_kwarg_positions": ("AxisLiteralRule", """
        import jax.numpy as jnp

        def f(model, x):
            y = model(x, sp_axis="sp")
            return jnp.sum(y, axis=0)
        """, 1),
}

#: fixtures over a JAX collective, ``psum(x, axis_name=...)``: the port
#: reads its ``axis_name`` kwarg as any other (kind "axis-kwarg", where the
#: JAX rule says "collective"), once per call site — the same findings but
#: for that label
COLLECTIVE_KWARG_CASES = {
    "kwarg_axis_once_typo": ("UnknownAxisRule", """
        import jax
        x = jax.lax.psum(x, axis_name="stie")
        """, 1),
    "kwarg_axis_once_literal": ("AxisLiteralRule", """
        import jax
        from jax.sharding import Mesh
        mesh = Mesh(arr, axis_names=("site",))
        y = jax.lax.psum(x, axis_name="site")
        """, 2),
}


def _sharding(module, rule_cls, source, mod_cls):
    rule = getattr(module, rule_cls)(keys_source=textwrap.dedent(_MESH_KEYS))
    mod = _mods(mod_cls, source, "pkg/parallel/fixture.py")
    return rule.visit_module(mod) + rule.finalize([mod])


@pytest.mark.parametrize("case", sorted(SHARDING_CASES))
def test_sharding_rules_match_jax(case):
    rule_cls, source, n = SHARDING_CASES[case]
    jax_f = _sharding(jax_sharding, rule_cls, source, JaxModule)
    port_f = _sharding(sharding, rule_cls, source, Module)
    assert _key(jax_f) == _key(port_f) and len(port_f) == n


@pytest.mark.parametrize("case", sorted(COLLECTIVE_KWARG_CASES))
def test_sharding_collective_kwargs_match_jax_but_for_the_label(case):
    rule_cls, source, n = COLLECTIVE_KWARG_CASES[case]
    jax_f = _sharding(jax_sharding, rule_cls, source, JaxModule)
    port_f = _sharding(sharding, rule_cls, source, Module)
    relabel = [(r, ln, c, m.replace("(collective)", "(axis-kwarg)"))
               for r, ln, c, m in _key(jax_f)]
    assert relabel == _key(port_f) and len(port_f) == n


PORT_SHARDING_CASES = {
    # the sharded steps' constructor: sizes tuple against the names
    "build_mesh_arity": ("MeshArityRule", """
        from pkg.config.keys import MeshAxis
        mesh = build_mesh((2, 2, 2), (MeshAxis.SITE, MeshAxis.SP), devices)
        """, ["mesh axis tuple has 2 name(s) but the device array is reshaped to rank 3"]),
    # grid() is always (rows, per_row)
    "grid_arity": ("MeshArityRule", """
        from pkg.config.keys import MeshAxis
        mesh = grid(devices, 2, 2, (MeshAxis.SITE, MeshAxis.DEVICE, MeshAxis.SP))
        """, ["mesh axis tuple has 3 name(s) but the device array is reshaped to rank 2"]),
    # a module-level axis tuple, as parallel/sequence.py's TSP_AXES
    "module_axis_tuple": ("UnknownAxisRule", """
        AXES = ("site", "spp")
        mesh = build_mesh((2, 4), AXES, devices)
        """, ["axis name 'spp' (mesh)"]),
    # the axis lookups and RankAxis views
    "lookups": ("UnknownAxisRule", """
        from pkg.config.keys import MeshAxis
        ring = mesh.axis("stie", 0)
        n = mesh.shape["tpp"]
        view = RankAxis("devce", devices)
        fine = mesh.axis(MeshAxis.SP, (0, 0))
        """, ["axis name 'stie' (lookup)", "axis name 'tpp' (lookup)",
              "axis name 'devce' (rank-axis)"]),
    "lookup_literals": ("AxisLiteralRule", """
        n = mesh.shape["sp"]
        mesh2 = mesh.rename(("site", "sp"))
        m3 = build_tsp_mesh(1, 2, 2, 2, devices=devs, split="sp")
        """, ["bare mesh-axis literal 'sp' (lookup)", "bare mesh-axis literal 'site' (mesh)",
              "bare mesh-axis literal 'sp' (mesh)", "bare mesh-axis literal 'sp' (axis-kwarg)"]),
    # look-alikes that are no axis positions
    "not_axes": ("UnknownAxisRule", """
        import os
        os.rename("a.txt", "b.txt")
        dataset = load(split="train")
        x = torch.cat(xs, axis=0)
        n = t.shape[0]
        """, []),
}


@pytest.mark.parametrize("case", sorted(PORT_SHARDING_CASES))
def test_sharding_rules_read_the_ports_constructs(case):
    rule_cls, source, want = PORT_SHARDING_CASES[case]
    found = _sharding(sharding, rule_cls, source, Module)
    assert len(found) == len(want)
    for f, w in zip(found, want):
        assert w in f.message


def test_port_mesh_axis_vocabulary_is_the_jax_packages():
    assert sharding.load_mesh_axes() == jax_sharding.load_mesh_axes()
    assert set(sharding.load_mesh_axes().values()) == {
        "site", "device", "dp", "tp", "sp", "ep", "pp"}


def test_port_meshes_are_seen_and_clean():
    """The rules read every mesh the port builds, and find nothing."""
    from coinstac_dinunet_tpu_torch.analysis.core import iter_python_files

    axes = sharding.load_mesh_axes()
    meshes = {}
    for path in iter_python_files([PORT]):
        info = sharding._collect(Module.parse(path, path), axes)
        for m in info.meshes:
            meshes[os.path.relpath(path, PORT)] = m.axes
    assert meshes["parallel/sequence.py"] == ("dp", "tp", "sp", "ep")
    assert meshes["parallel/pipeline.py"] == ("pp", "dp")
    assert meshes["parallel/hosts.py"] == ("site", "device")
    rules = [sharding.UnknownAxisRule(), sharding.MeshArityRule(), sharding.AxisLiteralRule()]
    assert run_lint([PORT], rules=rules) == ([], [])


# --------------------------------------------------- proto-flow fixtures
_FIXTURE_REMOTE = """
class FixtureRemote:
    def compute(self):
        if check(all, "phase", "init_runs", self.input):
            self.out["phase"] = "next_run"
        if check(all, "phase", "computation", self.input):
            self.out["phase"] = "computation"
        return self.out
"""

FLOW_CASES = {
    "unconsumed_key": ("""
        class FixtureLocal:
            def compute(self):
                if self.out["phase"] == "init_runs":
                    self.out["orphan_key"] = 1
                    self.out["phase"] = "next_run"
                return self.out
        """, _FIXTURE_REMOTE, {"proto-flow-unmatched"}),
    "consumer_never_reachable": ("""
        class FixtureLocal:
            def compute(self):
                if self.out["phase"] == "init_runs":
                    self.out["stranded"] = 1
                    self.out["phase"] = "next_run"
                return self.out
        """, """
        class FixtureRemote:
            def compute(self):
                if check(all, "phase", "init_runs", self.input):
                    self.out["phase"] = "next_run"
                if check(all, "phase", "computation", self.input):
                    use(self.input.get("stranded"))
                return self.out
        """, {"proto-flow-unmatched"}),
    "unhandled_phase": ("""
        class FixtureLocal:
            def compute(self):
                if self.out["phase"] == "init_runs":
                    self.out["phase"] = "pre_computation"
                if self.out["phase"] == "next_run":
                    pass
                if self.out["phase"] == "computation":
                    pass
                return self.out
        """, _FIXTURE_REMOTE, {"proto-flow-phase"}),
    "read_before_write": ("""
        class FixtureLocal:
            def compute(self):
                if self.out["phase"] == "init_runs":
                    roster = self.cache["roster"]
                    self.out["phase"] = "next_run"
                if self.out["phase"] == "computation":
                    self.cache["roster"] = [1]
                return self.out
        """, _FIXTURE_REMOTE, {"proto-cache-read-before-write"}),
    "read_after_earlier_write": ("""
        class FixtureLocal:
            def compute(self):
                if self.out["phase"] == "init_runs":
                    self.cache["roster"] = [1]
                    self.out["phase"] = "next_run"
                if self.out["phase"] == "computation":
                    roster = self.cache["roster"]
                return self.out
        """, _FIXTURE_REMOTE, set()),
    "never_read": ("""
        class FixtureLocal:
            def compute(self):
                if self.out["phase"] == "computation":
                    self.cache["scratch_blob"] = 2
                return self.out
        """, _FIXTURE_REMOTE, {"proto-cache-never-read"}),
}


@pytest.mark.parametrize("case", sorted(FLOW_CASES))
def test_protocol_flow_matches_jax(case):
    local, remote, rules = FLOW_CASES[case]
    pair = [("fx/local.py", local), ("fx/remote.py", remote)]
    jax_f = jax_flow.ProtocolFlowAnalyzer(
        *(_mods(JaxModule, s, p) for p, s in pair), volatile_keys={"roster"}).run()
    port_f = protocol_flow.ProtocolFlowAnalyzer(*(_mods(Module, s, p) for p, s in pair)).run()
    assert _key(jax_f, drop={"proto-cache-volatile"}) == _key(port_f)
    assert {f.rule for f in port_f} >= rules
    assert "proto-cache-volatile" not in {f.rule for f in port_f}


def test_phase_transitions_are_the_jax_packages():
    assert protocol_flow.load_phase_transitions() == jax_flow.load_phase_transitions()


def test_port_node_pair_flow_is_clean_but_its_baselined_finding():
    """The port's nodes give one proto-flow finding, the one its baseline
    holds: cache['joined_epoch'] is written by the join entry and read
    nowhere (the JAX package reads the name only in its volatile-key list)."""
    found = protocol_flow.run_protocol_flow(paths=[PORT])
    assert [(f.rule, f.path, f.line) for f in found] == [
        ("proto-cache-never-read", "coinstac_dinunet_tpu_torch/nodes/local.py",
         found[0].line)]
    assert "joined_epoch" in found[0].message


# --------------------------------------------------------------- the engine
def test_parse_errors_are_reported_under_what_ast_parse_raises(tmp_path):
    """A NUL byte is a ValueError for ``ast.parse`` before Python 3.12 and a
    SyntaxError from it on: the run reports whichever it raised."""
    bad = tmp_path / "bad.py"
    bad.write_text("def broken(:\n")
    nul = tmp_path / "nul.py"
    nul.write_bytes(b"import torch\x00\n")
    try:
        ast.parse(b"import torch\x00\n".decode())
        raise AssertionError("ast.parse took a NUL byte")
    except (SyntaxError, ValueError) as exc:
        nul_class = type(exc).__name__
    findings, errors = run_lint([str(bad), str(nul)])
    assert findings == []
    by_file = {os.path.basename(p): e for p, e in errors}
    assert by_file["bad.py"].startswith("SyntaxError")
    assert by_file["nul.py"].startswith(nul_class)


def test_baseline_roundtrip_and_new_finding_detection(tmp_path):
    f1 = Finding("r", "a.py", 3, 0, "legacy problem")
    f2 = Finding("r", "a.py", 9, 4, "fresh problem")
    path = str(tmp_path / "baseline.json")
    write_baseline(path, [f1])
    counts = load_baseline(path)
    new, baselined = filter_baselined([f1, f2], counts)
    assert [f.message for f in baselined] == ["legacy problem"]
    assert [f.message for f in new] == ["fresh problem"]
    moved = Finding("r", "a.py", 77, 0, "legacy problem")  # fingerprints are line-free
    assert filter_baselined([moved], counts) == ([], [moved])
    assert len(filter_baselined([f1, moved], counts)[0]) == 1  # counts cap duplicates


_TRANSFER_WRITE = 'open(xfer + "/g.npy", "wb")'


def test_inline_and_file_suppressions_and_inert_strings(tmp_path):
    hit = tmp_path / "hit.py"
    hit.write_text(f"a = {_TRANSFER_WRITE}\n"
                   f"b = {_TRANSFER_WRITE}  # dinulint: disable=wire-atomic-commit\n")
    silenced = tmp_path / "silenced.py"
    silenced.write_text(f"# dinulint: disable-file=wire-atomic-commit\na = {_TRANSFER_WRITE}\n")
    documented = tmp_path / "documented.py"
    documented.write_text('"""``# dinulint: disable-file=wire-atomic-commit``."""\n'
                          f"a = {_TRANSFER_WRITE}\n")
    rules = [wire_atomic.WireAtomicCommitRule()]
    findings, errors = run_lint([str(hit), str(silenced), str(documented)], rules=rules)
    assert errors == []
    assert [(os.path.basename(f.path), f.line) for f in findings] == [
        ("documented.py", 2), ("hit.py", 1)]


def test_explicit_files_are_scanned_regardless_of_extension(tmp_path):
    script = tmp_path / "tool"
    script.write_text(f"a = {_TRANSFER_WRITE}\n")
    findings, errors = run_lint([str(script)], rules=[wire_atomic.WireAtomicCommitRule()])
    assert errors == [] and len(findings) == 1


# ------------------------------------------------------------------ the CLI
def test_cli_json_format_exit_codes_and_baseline(tmp_path, capsys):
    src = tmp_path / "ship.py"
    src.write_text(f"a = {_TRANSFER_WRITE}\n")
    rc = main([str(src), "--format", "json"])
    payload = json.loads(capsys.readouterr().out)
    assert rc == 1 and [f["rule"] for f in payload["new"]] == ["wire-atomic-commit"]
    baseline = tmp_path / "baseline.json"
    assert main([str(src), "--write-baseline", "--baseline", str(baseline)]) == 0
    capsys.readouterr()
    assert main([str(src), "--baseline", str(baseline)]) == 0
    assert "0 new finding(s), 1 baselined" in capsys.readouterr().out
    assert main([str(src), "--format", "github", "--baseline",
                 str(tmp_path / "none.json")]) == 1
    out = capsys.readouterr().out
    assert "::error file=" in out and "title=dinulint wire-atomic-commit" in out


def test_cli_write_baseline_keeps_entries_of_tiers_not_run(tmp_path, capsys):
    src = tmp_path / "ship.py"
    src.write_text(f"a = {_TRANSFER_WRITE}\n")
    baseline = tmp_path / "bl.json"
    baseline.write_text(json.dumps({"findings": [
        {"rule": "deep-eval-shape", "path": "pkg/entry.py", "message": "m", "count": 1},
        {"rule": "perf-host-sync", "path": "pkg/step.py", "message": "s", "count": 1},
        {"rule": "wire-orphan", "path": "pkg/n.py", "message": "o", "count": 1}]}))
    assert main([str(src), "--write-baseline", "--baseline", str(baseline)]) == 0
    assert "3 entries kept from tiers not run" in capsys.readouterr().out
    rules = sorted(e["rule"] for e in json.loads(baseline.read_text())["findings"])
    assert rules == ["deep-eval-shape", "perf-host-sync", "wire-atomic-commit", "wire-orphan"]


@pytest.mark.parametrize("argv,rc,err", [
    (["--tier5"], 0, ""),
    (["--schedules", "1"], 2, "require --tier5"),
    (["--schedule-bound", "1"], 2, "require --tier5"),
    (["--tier7", "--device", "cpu"], 0, ""),
    (["--parity"], 0, ""),
    (["--parity-plans", "1"], 2, "requires --tier7 or --parity"),
    (["--jax-version", "1"], 2, "use --torch-version"),
])
def test_cli_flags_of_the_jax_tiers_5_and_7_are_carried(argv, rc, err, tmp_path, capsys):
    """The JAX analyzer's tier-5 and tier-7 flags run their tiers (an empty
    tree: nothing static to find, the explorer and prover clean); their
    knobs require the tier, and ``--jax-version`` names ``--torch-version``."""
    assert main([str(tmp_path), *argv]) == rc
    assert err in capsys.readouterr().err


@pytest.mark.parametrize("argv,err", [
    (["--deep-entries", "ring-attention"], "--deep-entries requires --deep"),
    (["--device", "cpu"], "--device requires --deep, --tier3 or --tier7"),
    (["--model-sites", "2"], "require --model"),
    (["--write-lock"], "require --wire"),
    (["--rules", "perf-host-sync"], "requires --tier3"),
    (["--rules", "proto-model-quorum"], "requires --model"),
    (["--rules", "wire-orphan"], "requires --wire"),
    (["--rules", "sharding-spec-arity"], "unknown rule id"),
    (["--deep", "--deep-entries", "nope", "--device", "cpu"], "unknown deep entry"),
    (["--model", "--model-rounds", "0"], "at least 1 federated round"),
])
def test_cli_usage_errors_exit_2(argv, err, capsys):
    assert main([PORT, *argv]) == 2
    assert err in capsys.readouterr().err


def test_cli_deep_without_a_card_is_a_usage_error(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is visible: --device cuda runs")
    assert main([PORT, "--deep"]) == 2
    assert "no CUDA device is available" in capsys.readouterr().err

"""The port's tier 5 (``--tier5``): the static ``conc-*`` rules and the
interleaving explorer, against the JAX package's.

- **Static rules** — the JAX tests' fixtures (``tests/test_analysis_tier5.py``,
  read from that file) are pure ``threading`` code, so both analyzers run
  on the same sources and must give the same findings: rule, line, column
  and message.  Over the port tree the rules are clean.
- **Explorer** — at the default bound the port's explorer drives the port's
  own ``InProcessEngine`` async round loop and ``DaemonEngine`` close drill
  (a fake ``_Worker``: no worker process) and must enumerate as many
  schedules as the JAX explorer, force as many blocks and find nothing;
  each broken-semantics switch gives the JAX explorer's rule, anchored at
  the port's seam, and its schedule JSON replays to the same violation.
- **CLI** — ``--tier5`` exits 0 over the port against its baseline; the
  knobs require the tier.
"""
import ast
import json
import os
import textwrap

import pytest

from coinstac_dinunet_tpu.analysis import concurrency as jax_conc
from coinstac_dinunet_tpu.analysis import schedule_explorer as jax_se
from coinstac_dinunet_tpu.analysis.core import Module as JaxModule
from coinstac_dinunet_tpu_torch.analysis import concurrency, schedule_explorer as se
from coinstac_dinunet_tpu_torch.analysis.__main__ import main
from coinstac_dinunet_tpu_torch.analysis.core import Module
from coinstac_dinunet_tpu_torch.config.keys import Concurrency

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "coinstac_dinunet_tpu_torch")
BASELINE = os.path.join(REPO, "dinulint_torch_baseline.json")


def _jax_fixtures():
    """``(test name, source, module name)`` of every ``src`` fixture in the
    JAX package's tier-5 tests."""
    path = os.path.join(REPO, "tests", "test_analysis_tier5.py")
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read())
    out = []
    for fn in tree.body:
        if not isinstance(fn, ast.FunctionDef):
            continue
        src = name = None
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and any(
                    isinstance(t, ast.Name) and t.id == "src" for t in node.targets) and \
                    isinstance(node.value, ast.Constant):
                src = node.value.value
            if isinstance(node, ast.Call) and getattr(node.func, "id", None) == "_findings":
                name = next((kw.value.value for kw in node.keywords if kw.arg == "name"), None)
        if src is not None:
            out.append((fn.name, src, name or "fx/threaded.py"))
    return out


FIXTURES = _jax_fixtures()


def _key(findings):
    return [(f.rule, f.line, f.col, f.message) for f in findings]


def test_the_jax_fixtures_were_found():
    assert len(FIXTURES) >= 10


@pytest.mark.parametrize("test,src,name", FIXTURES, ids=[t for t, _, _ in FIXTURES])
def test_static_rules_match_jax_on_its_fixtures(test, src, name):
    src = textwrap.dedent(src)
    want = jax_conc.analyze_module(JaxModule(name, src, ast.parse(src)))
    got = concurrency.analyze_module(Module(name, src, ast.parse(src)))
    assert _key(got) == _key(want)


def test_static_rules_read_torch_save_as_a_payload_write():
    """The port's payload writer is ``torch.save(obj, path)`` as well as
    ``np.save(path, a)``: from a threaded context into a transfer directory
    both are ``conc-fs-race``."""
    src = textwrap.dedent("""
    import threading
    import torch

    def worker(state):
        torch.save(state, "/x/transfer/grads.pt")

    def run(state):
        threading.Thread(target=worker, args=(state,)).start()
    """)
    got = concurrency.analyze_module(Module("fx/w.py", src, ast.parse(src)))
    assert [(f.rule, f.line) for f in got] == [(Concurrency.FS_RACE, 6)]


def test_static_rules_are_clean_over_the_port():
    assert [f.render() for f in concurrency.run_tier5_static([PORT])] == []


def test_explorer_matches_jax_at_the_default_bound():
    got = se.run_schedule_explorer()
    want = jax_se.run_schedule_explorer()
    assert [f.render() for f in got.findings] == []
    assert got.report == want.report
    assert got.report["schedules_run"] == (len(se.CHOICES) ** Concurrency.DEFAULT_SITES
                                           ) ** Concurrency.DEFAULT_ROUNDS
    assert got.report["forced_blocks"] > 0 and got.report["drill_run"]


@pytest.mark.parametrize("switch,rule,anchor", [
    ("_SNAPSHOT_DISABLED", Concurrency.TORN_STALE, "engine.py"),
    ("_DROP_COMMIT", Concurrency.LOST_COMMIT, "engine.py"),
    ("_TORN_FLUSH", Concurrency.TORN_JSONL, "telemetry/recorder.py"),
    ("_DRILL_UNSERIALIZED_SPAWN", Concurrency.CLOSE_DEADLOCK, "federation/daemon.py"),
])
def test_each_switch_gives_the_jax_finding_and_replays(monkeypatch, tmp_path, switch, rule,
                                                        anchor):
    monkeypatch.setattr(se, switch, True)
    monkeypatch.setattr(jax_se, switch, True)
    cfg = dict(config=se.ScheduleConfig(rounds=1))
    got = se.run_schedule_explorer(schedules_dir=str(tmp_path / "plans"), **cfg)
    want = jax_se.run_schedule_explorer(config=jax_se.ScheduleConfig(rounds=1))
    assert [f.rule for f in got.findings] == [f.rule for f in want.findings] == [rule]
    assert got.report == want.report
    # the same message, anchored at the port's seam
    assert got.findings[0].message == want.findings[0].message
    assert got.findings[0].path == f"coinstac_dinunet_tpu_torch/{anchor}"
    assert got.plans[0]["schedule"] == want.plans[0]["schedule"]
    files = os.listdir(tmp_path / "plans")
    with open(tmp_path / "plans" / files[0]) as f:
        plan = json.load(f)
    assert rule in {v["rule"] for v in se.replay_schedule(plan, workdir=str(tmp_path / "r"))}
    monkeypatch.setattr(se, switch, False)
    assert se.replay_schedule(plan, workdir=str(tmp_path / "fixed")) == []


def test_cli_tier5_is_clean_over_the_port(capsys):
    assert main([PORT, "--tier5", "--baseline", BASELINE]) == 0
    assert "0 new finding(s)" in capsys.readouterr().out


@pytest.mark.parametrize("argv,err", [
    (["--schedules", "d"], "--schedules/--schedule-bound require --tier5"),
    (["--schedule-bound", "2"], "--schedules/--schedule-bound require --tier5"),
    (["--tier5", "--schedule-bound", "0"], "needs at least 1 post-warmup round"),
    (["--rules", Concurrency.UNGUARDED], "requires --tier5"),
])
def test_cli_tier5_knobs_require_the_tier(capsys, argv, err):
    assert main([PORT, *argv]) == 2
    assert err in capsys.readouterr().err

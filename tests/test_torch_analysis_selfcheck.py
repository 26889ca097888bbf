"""The port's analyzer over its own tree: the whole package lints clean
against ``dinulint_torch_baseline.json``, the CLI runs the static, model
and wire tiers without JAX (the chip machine has none), and the baseline
is a ratchet that neither grows nor goes stale.
"""
import collections
import json
import os
import subprocess
import sys

from coinstac_dinunet_tpu_torch.analysis import Finding, filter_baselined, load_baseline, run_lint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "coinstac_dinunet_tpu_torch")
BASELINE = os.path.join(REPO, "dinulint_torch_baseline.json")


def test_cli_lists_every_tiers_rules_and_the_entries():
    code = ("import sys; from coinstac_dinunet_tpu_torch.analysis.__main__ import main; "
            "main(['--list-rules']); main(['--list-deep'])")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, check=True).stdout
    for rid in ("sharding-unknown-axis", "perf-host-sync", "proto-model-roster",
                "wire-lock", "deep-recompile", "tsp-moe-train-step:"):
        assert rid in out
    for rid in ("sharding-spec-arity", "sharding-collective-scope", "proto-cache-volatile",
                "proto-model-volatile", "jax-api-drift"):
        assert rid not in out


# ----------------------------------------------------- self-check, ratchet
def test_port_lints_clean_against_its_baseline():
    findings, errors = run_lint([PORT])
    assert errors == []
    new, _ = filter_baselined(findings, load_baseline(BASELINE))
    assert new == [], "\n".join(f.render() for f in new)


def test_cli_model_and_wire_exit_zero_without_jax():
    """The chip machine has no JAX: the port's CLI must not reach for it."""
    code = ("import sys; from coinstac_dinunet_tpu_torch.analysis.__main__ import main; "
            "rc = main(['coinstac_dinunet_tpu_torch', '--model', '--wire', '--baseline', "
            "'dinulint_torch_baseline.json']); "
            "bad = sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'optax', 'coinstac_dinunet_tpu'}); "
            "print('RC', rc, 'LOADED', bad)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, check=True).stdout
    assert "RC 0 LOADED []" in out, out


def test_protocol_rule_reports_zero_unmatched_wire_keys():
    findings, _ = run_lint([PORT], rule_ids=["protocol-conformance"])
    assert findings == [], "\n".join(f.render() for f in findings)


#: the baseline is a one-way valve: it may shrink, never grow or go stale
#: without a decision recorded here.  1 entry: joined_epoch, above.  18 more
#: with the default tier's trace-host-sync and tier 7 (CHANGES.md):
#: 17 host<->device transfers reached from the step functions (the seven
#: perf-host-sync observed on the card among them: PERF.md "Port faults")
#: and telemetry/perf.py's sum of integer FLOP counts, whose order cannot
#: change bits.
MAX_BASELINE_FINDINGS = 19


def _baseline_entries():
    with open(BASELINE, encoding="utf-8") as f:
        return json.load(f)["findings"]


def _stale(entries, findings):
    fired = collections.Counter(f.fingerprint() for f in findings)
    return [e for e in entries
            if fired[(e["rule"], e["path"], e["message"])] < int(e.get("count", 1))]


def test_baseline_ratchet_has_not_grown():
    assert sum(int(e.get("count", 1)) for e in _baseline_entries()) <= MAX_BASELINE_FINDINGS


def test_baseline_ratchet_has_no_stale_suppressions():
    """Every entry still fires in the tier that owns it (the tiers the CPU
    can run: the default, tier 3's AST half, the model checker, the wire
    auditor, tier 7's static half; the perf-host-sync half needs the card)."""
    from coinstac_dinunet_tpu_torch.analysis.dataflow import run_tier3
    from coinstac_dinunet_tpu_torch.analysis.model_check import run_model_check
    from coinstac_dinunet_tpu_torch.analysis.wire_schema import run_wire

    entries = _baseline_entries()
    assert not [e for e in entries if e["rule"].startswith(("perf-", "deep-"))], (
        "a card-only finding in the baseline cannot be checked for staleness here")
    findings = run_lint([PORT])[0] + run_tier3(paths=[PORT], entries=False)
    if any(e["rule"].startswith("num-") for e in entries):
        from coinstac_dinunet_tpu_torch.analysis.numerics import run_tier7_static

        findings += run_tier7_static([PORT])
    if any(e["rule"].startswith("proto-model-") for e in entries):
        findings += run_model_check().findings
    if any(e["rule"].startswith("wire-") for e in entries):
        findings += run_wire(paths=[PORT])[0]
    assert _stale(entries, findings) == []


def test_stale_detector_catches_dead_and_partial_entries():
    live = Finding(rule="r", path="p.py", line=3, col=0, message="m")
    entries = [{"rule": "r", "path": "p.py", "message": "m", "count": 1},
               {"rule": "r", "path": "p.py", "message": "gone", "count": 1}]
    assert _stale(entries, [live]) == [entries[1]]
    multi = [{"rule": "r", "path": "p.py", "message": "m", "count": 2}]
    assert _stale(multi, [live]) == multi and _stale(multi, [live, live]) == []

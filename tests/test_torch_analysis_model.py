"""The port's model checker (``--model``) against the JAX package's.

Both find no violation at the default bound and explore the same number
of states; the JAX model-check tests' seeded fixture pairs give the same
findings (``proto-model-volatile`` aside: the port has no compiled-step
bucket); and each broken-semantics switch of the checker (a test-only
flag that models a mis-implemented window, supervisor or roster) makes
both packages report the same invariant, with the same message and a
counterexample plan the port's chaos engine loads.
"""
import ast
import textwrap

import pytest

from coinstac_dinunet_tpu.analysis import model_check as jax_model
from coinstac_dinunet_tpu.analysis import proto_ir as jax_ir
from coinstac_dinunet_tpu.analysis.core import Module as JaxModule
from coinstac_dinunet_tpu_torch.analysis import model_check, proto_ir
from coinstac_dinunet_tpu_torch.analysis.core import Module
from coinstac_dinunet_tpu_torch.config.keys import ModelCheck
from coinstac_dinunet_tpu_torch.resilience.chaos import load_fault_plan


# ----------------------------------------------------------------- --model
def test_both_model_checkers_are_clean_at_the_default_bound_with_equal_states():
    port, jax_res = model_check.run_model_check(), jax_model.run_model_check()
    assert port.findings == [] and jax_res.findings == []
    assert port.report["states"] == jax_res.report["states"] > 0
    assert port.report["runs"] == jax_res.report["runs"]
    assert ModelCheck.VOLATILE not in model_check.MODEL_RULE_IDS


_LOCAL = """
class FixtureLocal:
    def compute(self):
        self.out["phase"] = self.input.get("phase", "init_runs")
        if self.out["phase"] == "init_runs":
            self.out["data_size"] = 1
            self.out["shared_args"] = {}
        elif self.out["phase"] == "next_run":
            self.cache["ready"] = True
            self.out["phase"] = "computation"
        if self.out["phase"] == "computation":
            if self.input.get("update"):
                self.input.get("avg_grads_file")
            self.out["grads_file"] = "grads.npy"
            self.out["reduce"] = True
        return self.out
"""

_REMOTE = """
class FixtureRemote:
    def compute(self):
        self.out["phase"] = self.input.get("phase", "init_runs")
        self._check_quorum()
        self._check_lockstep_phases()
        for site, site_vars in self.input.items():
            site_vars.get("data_size")
            site_vars.get("shared_args")
        if check(all, "phase", "init_runs", self.input):
            self.out["phase"] = "next_run"
        if check(all, "phase", "computation", self.input):
            self.out["phase"] = "computation"
            if check(all, "reduce", True, self.input):
                self._reduce()
        return self.out

    def _check_quorum(self):
        prev = set(self.cache.get("dropped_sites", []))
        if prev & set(self.input.keys()):
            self.input = {k: v for k, v in self.input.items()
                          if k not in prev}

    def _check_lockstep_phases(self):
        rounds = {v.get("wire_round") for v in self.input.values()}

    def _reduce(self):
        for site, site_vars in self.input.items():
            site_vars.get("grads_file")
        self.out["update"] = True
        self.out["avg_grads_file"] = "avg.npy"
"""

#: the JAX model-check tests' seeded pairs: (local, remote, rule)
MODEL_CASES = {
    "clean": (_LOCAL, _REMOTE, None),
    "dropped_quorum": (_LOCAL, _REMOTE.replace("        self._check_quorum()\n", ""),
                       ModelCheck.QUORUM),
    "consumed_one_phase_early": (
        _LOCAL.replace('            self.cache["ready"] = True\n',
                       '            self.cache["ready"] = True\n'
                       '            self.input.get("bonus_file")\n'),
        _REMOTE.replace('        self.out["update"] = True\n',
                        '        self.out["bonus_file"] = "b.npy"\n'
                        '        self.out["update"] = True\n'),
        ModelCheck.WIRE),
    "read_before_write": (
        _LOCAL.replace('            self.out["grads_file"] = "grads.npy"\n',
                       '            x = self.cache["warmup"]\n'
                       '            self.out["grads_file"] = "grads.npy"\n').replace(
            "        return self.out\n",
            '        if self.out["phase"] == "success":\n'
            '            self.cache["warmup"] = 1\n'
            "        return self.out\n"),
        _REMOTE, ModelCheck.CACHE),
}


def _fixture_ir(ir_module, mod_cls, local, remote, **kw):
    return ir_module.build_protocol_ir(
        local_module=mod_cls("fx/local.py", local, ast.parse(local)),
        remote_module=mod_cls("fx/remote.py", remote, ast.parse(remote)), **kw)


@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_seeded_model_fixtures_match_jax(case):
    local, remote, rule = MODEL_CASES[case]
    local, remote = textwrap.dedent(local), textwrap.dedent(remote)
    cfg = model_check.ModelConfig(elastic=(False,))
    jax_res = jax_model.run_model_check(
        config=jax_model.ModelConfig(elastic=(False,)),
        ir=_fixture_ir(jax_ir, JaxModule, local, remote, volatile_keys={"ready"}))
    port = model_check.run_model_check(config=cfg,
                                       ir=_fixture_ir(proto_ir, Module, local, remote))
    assert [f.render() for f in port.findings] == [f.render() for f in jax_res.findings]
    assert [f.rule for f in port.findings] == ([rule] if rule else [])
    assert port.report["states"] == jax_res.report["states"]
    for plan in port.plans:
        assert load_fault_plan({"faults": plan["faults"]}) is not None


def test_port_ir_reads_the_ports_node_facts():
    """The port splits the round-window check out of the lockstep guard;
    the IR follows the guard's self-calls to its window markers."""
    facts = proto_ir.build_protocol_ir().facts
    assert facts.round_lockstep_guard and facts.round_lockstep_window
    assert facts.round_lockstep_run_ahead and facts.membership_checked
    assert facts.quorum_before_reduce_input and facts.roster_epoch_refusal
    assert facts.heal_bridges_manifest and facts.admission_exactly_once
    assert facts.anchors["relay_duplicate"][0] == "coinstac_dinunet_tpu_torch/engine.py"


#: switch -> (the bound that reaches it, whether the round stamp is dropped
#: from the IR's facts, the invariant it breaks); the JAX tests' bounds
SWITCHES = {
    "_WINDOW_ACCEPTS_BEYOND_K": (dict(kinds=("staleness_k",), max_faults=2), False,
                                 ModelCheck.STALE_CONTRIBUTION),
    "_WINDOW_ACCEPTS_BEYOND_RUN_AHEAD": (dict(kinds=("run_ahead",), max_faults=2), False,
                                         ModelCheck.STALE_CONTRIBUTION),
    "_ROSTER_ACCEPTS_STALE_EPOCH": (dict(kinds=("join", "leave", "rejoin", "stale")), False,
                                    ModelCheck.ROSTER),
    "_QUORUM_AGAINST_INIT_ROSTER": (dict(kinds=("join", "leave", "rejoin")), False,
                                    ModelCheck.ROSTER),
    "_JOIN_CONTRIBUTES_IN_ADMISSION_ROUND": (dict(kinds=("join",)), False,
                                             ModelCheck.ADMISSION),
    "_RESTART_REDELIVERS_LAST_OUTPUT": (dict(kinds=("worker_crash",)), True,
                                        ModelCheck.STALE_CONTRIBUTION),
}


@pytest.mark.parametrize("switch", sorted(SWITCHES))
def test_broken_semantics_switches_fire_as_in_jax(switch, monkeypatch):
    bound, no_stamp, rule = SWITCHES[switch]
    out = []
    for mod, ir_mod in ((model_check, proto_ir), (jax_model, jax_ir)):
        assert mod.run_model_check(config=mod.ModelConfig(**bound)).findings == []
        monkeypatch.setattr(mod, switch, True)
        ir = ir_mod.build_protocol_ir()
        if no_stamp:  # the supervisor's fault shows once the round stamp is gone
            ir.facts.round_lockstep_guard = False
        res = mod.run_model_check(config=mod.ModelConfig(**bound), ir=ir)
        out.append(([(f.rule, f.message) for f in res.findings],
                    [p["faults"] for p in res.plans]))
    assert out[0] == out[1]
    assert {r for r, _ in out[0][0]} == {rule}
    for faults in out[0][1]:
        assert load_fault_plan({"faults": faults})

"""The port's ``perf-donation``, ``perf-dtype-promotion`` and
``perf-constant-capture`` (``--tier3``), against the JAX package's tier 3.

The JAX tests' fixtures (``tests/test_analysis_tier3.py``) are jitted
steps; here each is the same step in eager PyTorch, registered as a deep
entry and run on the CPU, with the thresholds the JAX tests set.  Where
JAX reads ``donate_argnums`` the port reads whether the successor tree
came back in the argument's storage (the in-place update of
``parallel/sequence.py``'s ``sgd_step(donate=True)``).  Over the 14 deep
entries on the CPU the rules give the same (rule, entry) pairs as JAX's
tier 3 on its 14 entries: none.
"""
import os

import pytest
import torch

from coinstac_dinunet_tpu_torch.analysis import deepcheck
from coinstac_dinunet_tpu_torch.analysis.dataflow import run_tier3
from coinstac_dinunet_tpu_torch.analysis.perf_rules import (
    ConstantCaptureRule,
    DonationRule,
    DtypePromotionRule,
    perf_findings,
)

HERE = "tests/test_torch_analysis_perf.py"
PERF_RULES = ("perf-donation", "perf-dtype-promotion", "perf-constant-capture")


@pytest.fixture
def registry():
    deepcheck._register_builtin_entries()
    saved = dict(deepcheck.DEEP_REGISTRY)
    deepcheck.clear_run_cache()
    yield deepcheck.DEEP_REGISTRY
    deepcheck.DEEP_REGISTRY.clear()
    deepcheck.DEEP_REGISTRY.update(saved)
    deepcheck.clear_run_cache()


def _entry(name, fn, *args):
    deepcheck.register_entry_point(name, HERE)(lambda device: (fn, args))
    run = deepcheck.run_entry(name, "cpu")
    assert run.rule is None, run.message
    return run


def _line(marker):
    with open(__file__, encoding="utf-8") as f:
        return next(i for i, text in enumerate(f, 1) if marker in text)


def test_donation_fires_on_a_step_that_returns_fresh_params(registry):
    def step(params, x):  # the non-donating step
        return ({k: v - 0.1 * v for k, v in params.items()}, (x @ params["w"]).sum())

    run = _entry("fixture-no-donate", step, {"w": torch.ones(64, 64), "b": torch.ones(64)},
                 torch.ones(8, 64))
    found = DonationRule().check(run)
    assert [f.rule for f in found] == ["perf-donation"]
    assert "argument 0 (params)" in found[0].message
    assert (found[0].path, found[0].line) == (HERE, _line("# the non-donating step"))


def test_donation_quiet_when_updated_in_place(registry):
    def step(params, x):
        with torch.no_grad():
            for v in params.values():
                v.sub_(0.1 * v)
        return params, (x @ params["w"]).sum()

    run = _entry("fixture-donated", step, {"w": torch.ones(64, 64), "b": torch.ones(64)},
                 torch.ones(8, 64))
    assert DonationRule().check(run) == []


def test_donation_ignores_bare_tensor_shape_coincidences(registry):
    run = _entry("fixture-attention-like", lambda q, k: q + k, torch.ones(4, 16),
                 torch.ones(4, 16))
    assert DonationRule().check(run) == []


def test_dtype_rule_flags_an_in_step_staging_cast(registry):
    w = torch.ones(256, 256, dtype=torch.bfloat16)

    def step(x, w):
        return x.to(torch.bfloat16) @ w  # the staging cast

    run = _entry("fixture-staging-cast", step, torch.ones(256, 256), w)
    found = DtypePromotionRule(min_bytes=1024).check(run)
    assert [f.rule for f in found] == ["perf-dtype-promotion"]
    assert "hoist the cast to batch staging" in found[0].message
    assert (found[0].path, found[0].line) == (HERE, _line("# the staging cast"))


def test_dtype_rule_flags_an_f32_upcast_feeding_a_matmul(registry):
    def step(x, w):
        h = (x @ w).to(torch.float32)
        return h @ h.T

    run = _entry("fixture-upcast", step, *(torch.ones(256, 256, dtype=torch.bfloat16)
                                           for _ in range(2)))
    found = DtypePromotionRule(min_bytes=1024).check(run)
    assert [f.rule for f in found] == ["perf-dtype-promotion"]
    assert "upcast to float32" in found[0].message


def test_dtype_rule_flags_the_same_tensor_cast_twice(registry):
    def step(x):
        return x.to(torch.bfloat16) + x.to(torch.bfloat16).sum()

    run = _entry("fixture-cast-twice", step, torch.ones(256, 256))
    found = DtypePromotionRule(min_bytes=1024).check(run)
    assert "more than once" in found[-1].message


def test_dtype_rule_quiet_on_a_clean_bf16_step(registry):
    run = _entry("fixture-clean-bf16", lambda x, w: x @ w,
                 *(torch.ones(256, 256, dtype=torch.bfloat16) for _ in range(2)))
    assert DtypePromotionRule(min_bytes=1024).check(run) == []


def test_constant_capture_flags_a_closure_tensor(registry):
    big = torch.ones(1024, 1024)

    def step(x):  # closes over a 4 MiB matrix
        return x @ big

    run = _entry("fixture-const", step, torch.ones(8, 1024))
    found = ConstantCaptureRule().check(run)
    assert [f.rule for f in found] == ["perf-constant-capture"]
    assert "closure-captured" in found[0].message
    assert (found[0].path, found[0].line) == (HERE, _line("# closes over a 4 MiB matrix"))


def test_constant_capture_skips_parameters(registry):
    lin = torch.nn.Linear(1024, 1024)
    w = lin.weight

    def step(x):
        return x @ w

    run = _entry("fixture-param", step, torch.ones(8, 1024))
    assert ConstantCaptureRule().check(run) == []


def test_the_ports_entries_give_jaxs_pairs_none(registry):
    """The 14 entries (the JAX registry's names) on the CPU: no perf-*
    finding, as JAX's tier 3 on its entries (its run on the 8 virtual
    devices reports none either)."""
    found = [f for f in run_tier3(device="cpu") if f.rule in PERF_RULES]
    assert found == [], [f.render() for f in found]
    runs = [deepcheck.run_entry(n, "cpu") for n in deepcheck.list_entry_points()]
    assert len(runs) == 14 and all(r.ops is not None for r in runs)
    assert perf_findings(runs) == []


def test_jax_tier3_perf_rules_find_nothing_on_its_entries():
    from coinstac_dinunet_tpu.analysis.dataflow import run_tier3 as jax_run_tier3

    found = [f for f in jax_run_tier3(paths=[os.devnull]) if f.rule in PERF_RULES]
    assert found == []

"""The port's ``torch-api-drift`` (``jax-api-drift``'s counterpart) and its
``--torch-version`` flag.

The JAX tests' fixtures (``tests/test_analysis_rules.py``) in their torch
translation: a symbol past its window is flagged, one inside it is not, the
``hasattr``/``getattr`` guards are exempt.  Every table entry the table
says exists at this container's torch resolves here; ``chip_smoke.py``
checks the same at the card machine's.
"""
import ast
import os
import textwrap

import pytest

from coinstac_dinunet_tpu_torch.analysis import jax_api as torch_api
from coinstac_dinunet_tpu_torch.analysis.__main__ import main
from coinstac_dinunet_tpu_torch.analysis.core import Module

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "coinstac_dinunet_tpu_torch")
BASELINE = os.path.join(REPO, "dinulint_torch_baseline.json")


def _module(src):
    src = textwrap.dedent(src)
    return Module("fixture.py", src, ast.parse(src))


def _rule(version):
    return torch_api.TorchApiDriftRule(torch_version=version)


def test_drift_flags_custom_op_before_its_window():
    mod = _module("import torch\n\n@torch.library.custom_op('a::b', mutates_args=())\n"
                  "def f(x: torch.Tensor) -> torch.Tensor:\n    return x\n")
    found = _rule("2.3.0").visit_module(mod)
    assert [(f.rule, f.line) for f in found] == [("torch-api-drift", 3)]
    assert "does not exist in torch 2.3.0" in found[0].message
    assert _rule("2.4.0").visit_module(mod) == []


def test_drift_resolves_import_aliases_and_from_imports():
    mod = _module("from torch.utils.flop_counter import register_flop_formula\n"
                  "import torch.cuda.amp as camp\nscaler = camp.GradScaler()\n")
    found = _rule("2.11.0").visit_module(mod)
    assert [(f.line, "deprecated" in f.message) for f in found] == [(3, True)]
    # before 2.4 the amp spelling is current; before 2.3 the formula hook is missing
    assert [f.line for f in _rule("2.2.0").visit_module(mod)] == [1]


def test_drift_flags_removed_and_deprecated_symbols():
    mod = _module("import torch\nfrom torch._six import inf\n"
                  "torch.nn.utils.stateless.functional_call(m, p, x)\n")
    found = _rule("2.11.0").visit_module(mod)
    assert [(f.line, "does not exist" in f.message) for f in found] == [(2, True), (3, False)]


def test_drift_hasattr_guard_and_else_branch_are_exempt():
    mod = _module("""
        import torch

        if hasattr(torch.library, "custom_op"):
            op = torch.library.custom_op
        else:
            op = torch.library.impl_abstract

        unguarded = torch.library.custom_op
        """)
    found = _rule("2.3.0").visit_module(mod)
    assert [f.line for f in found] == [mod.source.splitlines().index(
        "unguarded = torch.library.custom_op") + 1]


def test_drift_getattr_or_fallback_is_exempt():
    mod = _module("""
        import torch

        fake = getattr(torch.library, "register_fake", None) or torch.library.impl_abstract
        unguarded = torch.library.impl_abstract
        """)
    found = _rule("2.11.0").visit_module(mod)
    assert [f.line for f in found] == [5]


def test_symbol_status_longest_prefix_match():
    status, sym, _ = torch_api.symbol_status("torch._six.inf", "2.11.0")
    assert (status, sym) == ("missing", "torch._six")
    assert torch_api.symbol_status("torch.nn.Linear", "2.11.0")[0] == "ok"


def test_the_pinned_version_comes_from_metadata_without_importing_torch():
    from importlib.metadata import version

    assert torch_api.installed_torch_version() == version("torch")


@pytest.mark.parametrize("dotted", sorted(torch_api.SYMBOL_TABLE))
def test_every_entry_present_here_resolves(dotted):
    status, resolves = torch_api.table_resolution()[dotted]
    assert resolves == (status != "missing")


@pytest.mark.parametrize("version", ["2.11.0", "2.13.0"])
def test_cli_torch_version_is_clean_over_the_port(capsys, version):
    assert main([PORT, "--torch-version", version, "--baseline", BASELINE]) == 0
    assert "0 new finding(s)" in capsys.readouterr().out


def test_cli_jax_version_is_a_usage_error(capsys):
    assert main([PORT, "--jax-version", "0.4.37"]) == 2
    assert "--torch-version" in capsys.readouterr().err

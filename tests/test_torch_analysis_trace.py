"""The port's ``trace-*`` rules: host hazards inside its step functions.

Eager PyTorch traces nothing, so the step functions (the deep entries'
callables, the ``*_step`` functions built by ``make_*``/``_build_*``, and
``forward``/``backward`` of each ``torch.autograd.Function``) and the
functions they reach take the place of JAX's traced context.  The JAX
tests' fixtures (``tests/test_analysis_rules.py``) in their torch-idiom
translation give the same rule at the same line; ``trace-host-sync`` finds,
without a card, each of the seven sites ``perf-host-sync`` observed on the
card (``PERF.md``).
"""
import ast
import os
import textwrap

import pytest

from coinstac_dinunet_tpu.analysis.core import Module as JaxModule
from coinstac_dinunet_tpu.analysis import trace_hazards as jax_trace
from coinstac_dinunet_tpu_torch.analysis import trace_hazards as trace
from coinstac_dinunet_tpu_torch.analysis.core import Module, run_lint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "coinstac_dinunet_tpu_torch")
RULES = [trace.HostSyncRule, trace.ImpureCallRule, trace.PyControlFlowRule,
         trace.SetIterationRule]

# the sites perf-host-sync found on the card (PERF.md)
CARD_SYNC_SITES = [
    ("coinstac_dinunet_tpu_torch/metrics/metrics.py", 128),
    ("coinstac_dinunet_tpu_torch/metrics/metrics.py", 131),
    ("coinstac_dinunet_tpu_torch/nn/basetrainer.py", 133),
    ("coinstac_dinunet_tpu_torch/nn/basetrainer.py", 722),
    ("coinstac_dinunet_tpu_torch/ops/power_iteration.py", 78),
    ("coinstac_dinunet_tpu_torch/parallel/mesh.py", 490),
    ("coinstac_dinunet_tpu_torch/parallel/mesh.py", 492),
]


def _mod(cls, src, path="fixture.py"):
    src = textwrap.dedent(src)
    return cls(path, src, ast.parse(src))


def _port(rule, src):
    return rule().finalize([_mod(Module, src)])


# (JAX fixture, torch-idiom translation, JAX rule, port rule); the lines match
TRANSLATED = {
    "host_sync_item": ("""
        import jax

        @jax.jit
        def step(x):
            return x.sum().item()
        """, """
        import torch

        def make_step():
            def step(x):
                return x.sum().item()
            return step
        """, jax_trace.HostSyncRule, trace.HostSyncRule),
    "py_control": ("""
        import jax

        @jax.jit
        def step(x):
            if x > 0:
                return x
            return -x
        """, """
        import torch

        def make_step():
            def step(x):
                if x > 0:
                    return x
                return -x
        """, jax_trace.PyControlFlowRule, trace.PyControlFlowRule),
    "py_control_mixed_boolop": ("""
        import jax

        @jax.jit
        def step(x):
            if x is None or x.sum() > 0:
                return x
        """, """
        import torch

        def make_step():
            def step(x):
                if x is None or x.sum() > 0:
                    return x
        """, jax_trace.PyControlFlowRule, trace.PyControlFlowRule),
    "py_control_static": ("""
        import jax

        @jax.jit
        def step(x):
            if x.ndim == 2:
                return x
            if x is None:
                return x
        """, """
        import torch

        def make_step():
            def step(x):
                if x.ndim == 2:
                    return x
                if x is None:
                    return x
        """, jax_trace.PyControlFlowRule, trace.PyControlFlowRule),
    "set_iter": ("""
        import jax

        @jax.jit
        def step(tree):
            return [tree[k] for k in set(tree)]
        """, """
        import torch

        def make_step():
            def step(tree):
                return [tree[k] for k in set(tree)]
        """, jax_trace.SetIterationRule, trace.SetIterationRule),
    "impure_in_build_step": ("""
        import time

        def _build_train_step():
            def train_step(x):
                t0 = time.time()
                return x
            return train_step
        """, """
        import numpy as np

        def _build_train_step():
            def train_step(x):
                t0 = np.random.rand()
                return x
            return train_step
        """, jax_trace.ImpureCallRule, trace.ImpureCallRule),
    "host_code_untraced": ("""
        import jax

        def report(x):
            return float(x.sum().item())
        """, """
        import torch

        def report(x):
            return float(x.sum().item())
        """, jax_trace.HostSyncRule, trace.HostSyncRule),
}


@pytest.mark.parametrize("case", sorted(TRANSLATED))
def test_trace_rules_match_jax_on_translated_fixtures(case):
    jax_src, torch_src, jax_rule, port_rule = TRANSLATED[case]
    want = jax_rule().visit_module(_mod(JaxModule, jax_src))
    got = _port(port_rule, torch_src)
    assert [(f.rule, f.line) for f in got] == [(f.rule, f.line) for f in want]


def test_host_sync_follows_calls_into_helpers():
    got = _port(trace.HostSyncRule, """
        import torch

        def helper(x):
            n = torch.tensor(3.0, device=x.device)
            return float(n * x.sum())

        def make_step():
            def step(x):
                return helper(x)
            return step
        """)
    assert [(f.line, "called from a step function" in f.message) for f in got] == [
        (5, True), (6, True)]


def test_host_sync_in_an_autograd_function_backward():
    got = _port(trace.HostSyncRule, """
        import torch

        class Op(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x):
                return x

            @staticmethod
            def backward(ctx, g):
                return g.cpu()
        """)
    assert [f.line for f in got] == [11]
    assert "backward of torch.autograd.Function `Op`" in got[0].message


def test_impure_flags_the_global_torch_generator_only():
    got = _port(trace.ImpureCallRule, """
        import numpy as np
        import torch

        def make_step():
            def step(x, gen):
                a = torch.randn(3, generator=gen)
                b = torch.randn(3)
                c = np.random.default_rng(7)
                return a + b
        """)
    assert [f.line for f in got] == [8]


def test_host_sync_finds_the_seven_card_sync_sites():
    found, errors = run_lint([PORT], rules=[trace.HostSyncRule()])
    assert errors == []
    sites = {(f.path, f.line) for f in found}
    assert [s for s in CARD_SYNC_SITES if s not in sites] == []


def test_the_rules_are_registered_and_torch_free():
    from coinstac_dinunet_tpu_torch.analysis.core import default_rules

    ids = {r.id for r in default_rules()}
    assert {"trace-host-sync", "trace-impure", "trace-py-control", "trace-set-iter",
            "torch-api-drift"} <= ids
    assert "trace-telemetry" not in ids  # no construct in eager code (PERF.md)
    with open(trace.__file__, encoding="utf-8") as f:
        tree = ast.parse(f.read())
    imported = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import)
                for a in n.names}
    assert "torch" not in imported and "jax" not in imported

"""The port's tier 7 (``--tier7``, ``--parity``): the static ``num-*`` rules,
``num-accum-narrow`` over the entry runs, and the bit-parity prover,
against the JAX package's.

- **Static rules** — the JAX tests' fixtures (``tests/test_analysis_tier7.py``)
  in their torch-idiom translation where they are JAX code (a seed consumed
  by ``manual_seed``/``default_rng`` where JAX consumes a key by sampling,
  numpy's ``SeedSequence.spawn`` where JAX splits): the same rule at the
  same line.  The fixtures with no JAX in them run unchanged through both
  analyzers and give the same rule, line, column and message.
- **Parity** — the stubs, seeds and recurrences are the JAX prover's, so
  each contract's per-round trajectories equal the JAX prover's bit for
  bit; each ``_BREAK_*`` switch bisects to the same round, tensor and ULP
  distance, and its plan replays (and replays clean with the switch off).
- **num-accum-narrow** — a planted entry whose cumulative sum stays in
  bfloat16 is flagged at its line; a float32 one is not; the port's 14
  entries are clean on the CPU, as JAX's are.
"""
import os

import numpy as np
import pytest

from coinstac_dinunet_tpu.analysis import numerics as jax_numerics
from coinstac_dinunet_tpu.analysis import parity as jax_parity
from coinstac_dinunet_tpu_torch.analysis import deepcheck, numerics, parity
from coinstac_dinunet_tpu_torch.analysis.__main__ import main
from coinstac_dinunet_tpu_torch.config.keys import Numerics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "coinstac_dinunet_tpu_torch")
BASELINE = os.path.join(REPO, "dinulint_torch_baseline.json")

# (JAX fixture, its torch-idiom translation, line by line)
TRANSLATED = {
    "reuse": (
        "import jax\n\ndef step(key, x):\n"
        "    a = jax.random.normal(key, (3,))\n"
        "    b = jax.random.uniform(key, (3,))\n"
        "    return a + b\n",
        "import numpy as np\nimport torch\ndef step(seed, x):\n"
        "    a = torch.Generator().manual_seed(seed)\n"
        "    b = np.random.default_rng(seed)\n"
        "    return a, b\n"),
    "reuse_rebound": (
        "import jax\n\ndef step(key, x):\n"
        "    key, sub = jax.random.split(key)\n"
        "    a = jax.random.normal(sub, (3,))\n"
        "    key, sub = jax.random.split(key)\n"
        "    return a + jax.random.uniform(sub, (3,))\n",
        "import numpy as np\nimport torch\ndef step(seed, x):\n"
        "    seed, sub = seed + 1, 2 * seed + 1\n"
        "    a = torch.Generator().manual_seed(sub)\n"
        "    seed, sub = seed + 1, 2 * seed + 1\n"
        "    return a, np.random.default_rng(sub)\n"),
    "reuse_in_loop": (
        "import jax\n\ndef step(key, xs):\n"
        "    for x in xs:\n"
        "        x = x + jax.random.normal(key, (3,))\n"
        "    return xs\n",
        "import torch\n\ndef step(seed, xs):\n"
        "    for x in xs:\n"
        "        x = torch.Generator().manual_seed(seed)\n"
        "    return xs\n"),
    "discard": (
        "import jax\n\ndef advance(key):\n"
        "    return jax.random.split(key)[0]\n",
        "import numpy as np\n\ndef advance(seed):\n"
        "    return np.random.SeedSequence(seed).spawn(2)[0]\n"),
    "constant": (
        "import jax\n\ndef train_step(x):\n"
        "    key = jax.random.PRNGKey(0)\n"
        "    return jax.random.normal(key, (2,))\n",
        "import torch\n\ndef train_step(x):\n"
        "    gen = torch.Generator().manual_seed(0)\n"
        "    return torch.randn(2, generator=gen)\n"),
}
# the fixtures with no JAX in them: one source for both analyzers
SHARED = {
    "unordered": "import numpy as np\n\ndef total(parts):\n"
                 "    vals = parts.values()\n    return np.stack(vals)\n",
    "unordered_sorted": "import numpy as np\n\ndef total(parts):\n"
                        "    vals = sorted(parts.values())\n    return np.stack(vals)\n",
    "codec": "def compress_block(x):\n    return x[:4]\n\n"
             "def decompress_block(x, n):\n    return list(x) + [0.0] * n\n",
}


def _scan(mod, tmp_path, src):
    p = tmp_path / "fixture.py"
    p.write_text(src)
    return mod.run_tier7_static([str(p)])


@pytest.mark.parametrize("case", sorted(TRANSLATED))
def test_static_prng_rules_match_jax_on_translated_fixtures(tmp_path, case):
    jax_src, torch_src = TRANSLATED[case]
    want = _scan(jax_numerics, tmp_path, jax_src)
    got = _scan(numerics, tmp_path, torch_src)
    assert [(f.rule, f.line) for f in got] == [(f.rule, f.line) for f in want]
    if case != "reuse_rebound":
        assert got, "the fixture must fire"


@pytest.mark.parametrize("case", sorted(SHARED))
def test_static_rules_match_jax_on_shared_fixtures(tmp_path, case):
    want = _scan(jax_numerics, tmp_path, SHARED[case])
    got = _scan(numerics, tmp_path, SHARED[case])
    assert [(f.rule, f.line, f.col, f.message) for f in got] == \
        [(f.rule, f.line, f.col, f.message) for f in want]


def test_torch_cat_is_a_fan_in_sink(tmp_path):
    got = _scan(numerics, tmp_path, "import torch\n\ndef total(parts):\n"
                                    "    return torch.cat(list(set(parts)))\n")
    assert [(f.rule, f.line) for f in got] == [(Numerics.UNORDERED_REDUCE, 4)]


def test_the_ports_codecs_are_accounted():
    """ops/quantize.py, parallel/powersgd.py and parallel/rankdad.py define
    codec kernels; their telemetry goes through record_compression_health."""
    found = numerics.run_tier7_static([PORT])
    assert not [f for f in found if f.rule == Numerics.CODEC_UNBOUNDED]
    # the one baselined finding (a sum of integer FLOP counts), nothing else
    assert [(f.rule, f.path) for f in found] == [
        (Numerics.UNORDERED_REDUCE, "coinstac_dinunet_tpu_torch/telemetry/perf.py")]


def _trajectories(mod, name, root):
    return mod._run_contract(name, mod.ParityConfig(), str(root))


@pytest.mark.parametrize("contract", parity.CONTRACTS)
def test_parity_trajectories_equal_jax_bit_for_bit(tmp_path, contract):
    got = _trajectories(parity, contract, tmp_path / "port")
    want = _trajectories(jax_parity, contract, tmp_path / "jax")
    assert len(got) == len(want) == 2
    for arm_got, arm_want in zip(got, want):
        assert len(arm_got) == len(arm_want) == Numerics.DEFAULT_ROUNDS
        for r_got, r_want in zip(arm_got, arm_want):
            assert sorted(r_got) == sorted(r_want)
            for k in r_got:
                assert r_got[k].dtype == r_want[k].dtype
                assert r_got[k].tobytes() == r_want[k].tobytes(), (contract, k)
    assert parity.prove_contract(contract, workdir=str(tmp_path / "p")) is None


@pytest.mark.parametrize("switch,contract", [
    ("_BREAK_RUN_AHEAD_EPS", "run-ahead-0-vs-serial"),
    ("_BREAK_ASYNC_REUSED_KEY", "async-k0-pool1-vs-lockstep"),
    ("_BREAK_MMAP_TAINT", "mmap-vs-copy"),
    ("_BREAK_UNSORTED_FAN_IN", "vectorized-vs-file-transport"),
    ("_BREAK_RANK_DROP", "codec-full-rank-vs-dense"),
])
def test_each_switch_bisects_as_jax_and_replays(monkeypatch, tmp_path, switch, contract):
    monkeypatch.setattr(parity, switch, True)
    monkeypatch.setattr(jax_parity, switch, True)
    got = parity.run_parity_prover(plans_dir=str(tmp_path / "plans"), contracts=[contract])
    want = jax_parity.run_parity_prover(contracts=[contract])
    assert [f.rule for f in got.findings] == [Numerics.PARITY]
    assert got.plans[0]["violation"] == want.plans[0]["violation"]
    assert got.findings[0].message == want.findings[0].message
    assert got.findings[0].path.startswith("coinstac_dinunet_tpu_torch/")
    plan = got.plans[0]
    assert parity.replay_parity(plan)[0]["round"] == plan["violation"]["round"]
    monkeypatch.setattr(parity, switch, False)
    fixed = dict(plan, switches={k: False for k in plan["switches"]})
    assert parity.replay_parity(fixed) == []


@pytest.fixture
def registry():
    deepcheck._register_builtin_entries()
    saved = dict(deepcheck.DEEP_REGISTRY)
    deepcheck.clear_run_cache()
    yield deepcheck.DEEP_REGISTRY
    deepcheck.DEEP_REGISTRY.clear()
    deepcheck.DEEP_REGISTRY.update(saved)
    deepcheck.clear_run_cache()


def _plant(name, dtype):
    import torch

    def build(device):
        def step(x):
            return torch.cumsum(x, 0)  # the narrow accumulation

        return step, (torch.ones(16, dtype=dtype, device=device),)

    deepcheck.register_entry_point(name, "tests/test_torch_analysis_tier7.py")(build)
    return build


def test_accum_narrow_flags_a_bf16_cumsum_at_its_line(registry):
    import torch

    _plant("fixture-bf16-cumsum", torch.bfloat16)
    _plant("fixture-f32-cumsum", torch.float32)
    found = numerics.run_accum_narrow(names=["fixture-bf16-cumsum", "fixture-f32-cumsum"],
                                      device="cpu")
    assert [f.rule for f in found] == [Numerics.ACCUM_NARROW]
    line = next(i for i, text in enumerate(open(__file__, encoding="utf-8"), 1)
                if "# the narrow accumulation" in text)
    assert (found[0].path, found[0].line) == ("tests/test_torch_analysis_tier7.py", line)
    assert "'fixture-bf16-cumsum': cumsum in bfloat16 x1" in found[0].message


def test_accum_narrow_is_clean_on_the_ports_entries_as_on_jaxs(registry):
    assert numerics.run_accum_narrow(device="cpu") == []


def test_cli_tier7_is_clean_over_the_port(capsys, tmp_path):
    assert main([PORT, "--tier7", "--device", "cpu", "--baseline", BASELINE,
                 "--parity-plans", str(tmp_path)]) == 0
    assert "0 new finding(s)" in capsys.readouterr().out
    assert os.listdir(tmp_path) == []  # a clean prover writes no plan
    assert main([PORT, "--parity", "--baseline", BASELINE]) == 0


@pytest.mark.parametrize("argv,err", [
    (["--parity-plans", "d"], "--parity-plans requires --tier7 or --parity"),
    (["--rules", Numerics.PRNG_REUSE], "requires --tier7"),
    (["--rules", Numerics.PARITY], "requires --tier7 or --parity"),
    (["--parity", "--write-baseline"], "refresh with --tier7 instead"),
    (["--jax-version", "0.4.37"], "use --torch-version"),
])
def test_cli_tier7_usage_errors(capsys, argv, err):
    assert main([PORT, *argv]) == 2
    assert err in capsys.readouterr().err


def test_ulp_distance_is_the_jax_provers():
    a = np.array([1.0, -0.0, 3.5, -2.0], dtype=np.float64)
    b = np.array([np.nextafter(1.0, 2.0), 0.0, 3.5, 2.0], dtype=np.float64)
    assert list(parity.ulp_diff(a, b)) == list(jax_parity.ulp_diff(a, b))
    assert parity.max_ulp_diff(a, b.astype(np.float32)) == jax_parity.max_ulp_diff(
        a, b.astype(np.float32))

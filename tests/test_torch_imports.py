"""The port stands alone: importing ``coinstac_dinunet_tpu_torch`` and
every module under it, or its example entry scripts, pulls in neither JAX
(nor flax/optax) nor msgpack (which the card's machine does not have) nor
any module of the JAX package, and its entry points default to the card —
without one they raise unless given ``device="cpu"``."""
import glob
import os
import pkgutil
import subprocess
import sys
import textwrap

import pytest
import torch

import coinstac_dinunet_tpu_torch as port
from coinstac_dinunet_tpu_torch import COINNLocal, COINNRemote, InProcessEngine, SiteRunner
from coinstac_dinunet_tpu_torch.models import SeqTrainer, VBMTrainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_no_jax_and_no_jax_package():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import coinstac_dinunet_tpu_torch as port
        names = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
        for name in names:
            importlib.import_module(name)
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "msgpack")
                     or m == "coinstac_dinunet_tpu" or m.startswith("coinstac_dinunet_tpu."))
        assert len(names) >= 20, names
        print("BAD", bad)
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "BAD []"


def test_daemon_and_telemetry_modules_import_no_jax():
    """The daemon engine's and the chaos harness's modules alone, in a
    fresh interpreter: nothing of JAX, msgpack or the JAX package."""
    code = textwrap.dedent("""
        import importlib, sys
        for name in ("federation", "federation.daemon", "telemetry", "telemetry.recorder",
                     "resilience", "resilience.chaos"):
            importlib.import_module("coinstac_dinunet_tpu_torch." + name)
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "msgpack")
                     or m == "coinstac_dinunet_tpu" or m.startswith("coinstac_dinunet_tpu."))
        print("BAD", bad)
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "BAD []"


def test_vectorized_federation_modules_import_no_jax():
    """The site-vectorized federation's modules and ``MeshEngine``'s, alone
    in a fresh interpreter: nothing of JAX, msgpack or the JAX package."""
    code = textwrap.dedent("""
        import importlib, sys
        for name in ("federation.vector", "federation.engine", "engine", "metrics.loss"):
            importlib.import_module("coinstac_dinunet_tpu_torch." + name)
        from coinstac_dinunet_tpu_torch.federation import (
            SiteVectorizedEngine, SiteVectorizedFederation, resolve_site_shards)
        from coinstac_dinunet_tpu_torch.engine import MeshEngine
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "msgpack")
                     or m == "coinstac_dinunet_tpu" or m.startswith("coinstac_dinunet_tpu."))
        print("BAD", bad)
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "BAD []"


def test_vectorized_engines_need_a_card_unless_given_cpu(tmp_path, monkeypatch):
    from coinstac_dinunet_tpu_torch.engine import MeshEngine
    from coinstac_dinunet_tpu_torch.federation import SiteVectorizedEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cls in (MeshEngine, SiteVectorizedEngine):
        for dev in (None, "cuda"):
            with pytest.raises(RuntimeError, match="CUDA"):
                cls(tmp_path / cls.__name__, n_sites=2, device=dev)
        assert cls(tmp_path / cls.__name__, n_sites=2, device="cpu").device == torch.device("cpu")


def test_daemon_worker_without_a_script_prints_its_usage():
    out = subprocess.run(
        [sys.executable, "-m", "coinstac_dinunet_tpu_torch.federation.daemon"],
        capture_output=True, text=True, env=dict(os.environ, PYTHONPATH=REPO), timeout=300)
    assert out.returncode == 2
    assert "usage: python -m coinstac_dinunet_tpu_torch.federation.daemon" in out.stderr
    assert out.stdout == ""


def test_entry_scripts_import_no_jax(tmp_path):
    """The example entry scripts (``examples/*/{local,remote}.py``, which
    COINSTAC runs as ``python local.py``) load from any directory without
    the package installed, and pull in nothing of JAX either."""
    scripts = sorted(glob.glob(os.path.join(REPO, "coinstac_dinunet_tpu_torch", "examples",
                                            "*", "*.py")))
    assert len(scripts) == 6, scripts
    code = textwrap.dedent("""
        import importlib.util, sys
        for i, path in enumerate(sys.argv[1:]):
            spec = importlib.util.spec_from_file_location(f"entry{i}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            assert callable(mod.compute), path
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "msgpack")
                     or m == "coinstac_dinunet_tpu" or m.startswith("coinstac_dinunet_tpu."))
        print("BAD", bad)
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code, *scripts], capture_output=True,
                         text=True, env=env, cwd=tmp_path, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "BAD []"


def test_every_port_module_has_a_reference_module():
    """The port mirrors the JAX package's tree file for file where it
    ports a module (its own additions: interop, the csrc build helper and
    the msgpack codec that stands in for flax's)."""
    names = [m.name.split(".", 1)[1] for m in
             pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
    own = {"interop", "ops._cuda", "utils.flax_msgpack"}
    for name in names:
        if name in own:
            continue
        rel = os.path.join(REPO, "coinstac_dinunet_tpu", *name.split("."))
        assert os.path.exists(rel + ".py") or os.path.isdir(rel), name


def test_entry_points_need_a_card_unless_given_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (
        lambda dev: InProcessEngine(tmp_path / "e", n_sites=1, device=dev),
        lambda dev: SiteRunner(tmp_path / "s", device=dev),
        lambda dev: VBMTrainer(cache={}, device=dev),
        lambda dev: SeqTrainer(cache={}, device=dev),
        lambda dev: COINNLocal(cache={}, device=dev),
        lambda dev: COINNRemote(cache={}, device=dev),
    ):
        with pytest.raises(RuntimeError, match="CUDA"):
            make(None)
        with pytest.raises(RuntimeError, match="CUDA"):
            make("cuda")
        obj = make("cpu")
        assert obj.device == torch.device("cpu")


def test_unported_options_are_refused(tmp_path):
    for args in ({"run_ahead": 1}, {"quarantine_on_anomaly": True}, {"reduce_fanin": 2}):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            COINNLocal(cache={}, device="cpu", **args)
    # carried since quorum and async rounds were ported
    for key, value in (("site_quorum", 1), ("async_staleness", 1), ("async_invoke_pool", 2),
                       ("async_stale_discount", 0.5)):
        assert COINNLocal(cache={}, device="cpu", **{key: value}).cache[key] == value
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        port.metrics.new_metrics(num_classes=3)


def test_every_aggregation_engine_is_carried():
    """dSGD, PowerSGD and rankDAD each pick their own learner and reducer."""
    from coinstac_dinunet_tpu_torch import parallel

    want = {"dSGD": (parallel.COINNLearner, parallel.COINNReducer),
            "powerSGD": (parallel.PowerSGDLearner, parallel.PowerSGDReducer),
            "rankDAD": (parallel.DADLearner, parallel.DADReducer)}
    for engine, (learner, reducer) in want.items():
        local = COINNLocal(cache={}, device="cpu", agg_engine=engine)
        remote = COINNRemote(cache={"agg_engine": engine}, device="cpu")
        assert local._get_learner_cls() is learner
        assert remote._get_reducer_cls() is reducer

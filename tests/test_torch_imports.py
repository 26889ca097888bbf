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

import numpy as np
import pytest
import torch

import coinstac_dinunet_tpu_torch as port
from coinstac_dinunet_tpu_torch import COINNLocal, COINNRemote, InProcessEngine, SiteRunner
from coinstac_dinunet_tpu_torch.models import (MultiNetTrainer, ResNetTrainer, SeqTrainer,
                                               VBMTrainer)

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
    """The daemon engine's, the chaos harness's and the health layer's
    modules alone, in a fresh interpreter: nothing of JAX, msgpack or the
    JAX package."""
    code = textwrap.dedent("""
        import importlib, sys
        for name in ("federation", "federation.daemon", "telemetry", "telemetry.recorder",
                     "telemetry.watchdog", "telemetry.health", "telemetry.perf",
                     "telemetry.capture", "utils.profiling", "resilience", "resilience.chaos"):
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


def test_metrics_and_data_modules_import_no_jax():
    """The other metrics and data (the NIfTI reader, the prefetch thread,
    ``NiftiVBMDataset``, ``ConfusionMatrix`` and the AUC metric), alone in
    a fresh interpreter: nothing of JAX, msgpack or the JAX package, and
    nibabel only if it is there."""
    code = textwrap.dedent("""
        import importlib, sys
        for name in ("data.nifti", "data.data", "metrics.metrics", "models.cnn3d"):
            importlib.import_module("coinstac_dinunet_tpu_torch." + name)
        from coinstac_dinunet_tpu_torch.data import device_prefetch
        from coinstac_dinunet_tpu_torch.data.nifti import load_nifti, save_nifti
        from coinstac_dinunet_tpu_torch.metrics import AUCROCMetrics, ConfusionMatrix
        from coinstac_dinunet_tpu_torch.models import NiftiVBMDataset
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "msgpack")
                     or m == "coinstac_dinunet_tpu" or m.startswith("coinstac_dinunet_tpu."))
        print("BAD", bad)
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "BAD []"


def test_mesh_plane_modules_import_no_jax():
    """The mesh planes (``parallel/{mesh,seq_mesh,tp_mesh,hosts,
    ring_attention}.py``), alone in a fresh interpreter: nothing of JAX,
    msgpack or the JAX package."""
    code = textwrap.dedent("""
        import importlib, sys
        for name in ("parallel.mesh", "parallel.seq_mesh", "parallel.tp_mesh",
                     "parallel.hosts", "parallel.ring_attention"):
            importlib.import_module("coinstac_dinunet_tpu_torch." + name)
        from coinstac_dinunet_tpu_torch.parallel import hosts, ring_attention
        from coinstac_dinunet_tpu_torch.parallel.mesh import MeshFederation
        assert hosts.initialize_multihost() is False  # one process: a no-op
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "msgpack")
                     or m == "coinstac_dinunet_tpu" or m.startswith("coinstac_dinunet_tpu."))
        print("BAD", bad)
    """)
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=dict(env, PYTHONPATH=REPO), cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "BAD []"


def test_sharded_step_modules_import_no_jax():
    """The sharded transformer steps (``parallel/{sequence,pipeline}.py``),
    alone in a fresh interpreter: nothing of JAX, msgpack or the JAX
    package."""
    code = textwrap.dedent("""
        import importlib, sys
        for name in ("parallel.sequence", "parallel.pipeline"):
            importlib.import_module("coinstac_dinunet_tpu_torch." + name)
        from coinstac_dinunet_tpu_torch.parallel import pipeline, sequence
        from coinstac_dinunet_tpu_torch.parallel.pipeline import (
            build_pp_mesh, make_pp_train_step, shard_pp_batch, shard_pp_params, stack_layers)
        from coinstac_dinunet_tpu_torch.parallel.sequence import (
            TSPConfig, build_tsp_mesh, init_tsp_params, make_tsp_train_step, shard_tsp_batch,
            shard_tsp_params, transformer_block, tsp_forward)
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "msgpack")
                     or m == "coinstac_dinunet_tpu" or m.startswith("coinstac_dinunet_tpu."))
        print("BAD", bad)
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "BAD []"


def test_sharded_steps_need_a_card_unless_given_cpu(monkeypatch):
    """The meshes default to every visible card and the weights to the
    card: without one they raise; named CPU ranks run."""
    from coinstac_dinunet_tpu_torch.parallel import pipeline, sequence

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    for build in (sequence.build_tsp_mesh, pipeline.build_pp_mesh):
        with pytest.raises(RuntimeError, match="CUDA"):
            build()
        with pytest.raises(RuntimeError, match="CUDA"):
            build(devices=["cuda:0"] * 4)
    cfg = sequence.TSPConfig(d_model=16, num_heads=2, num_layers=1, max_len=8)
    for dev in (None, "cuda"):
        with pytest.raises(RuntimeError, match="CUDA"):
            sequence.init_tsp_params(torch.Generator(), cfg, device=dev)
    params = sequence.init_tsp_params(torch.Generator(), cfg, device="cpu")
    assert params["pos"].device == torch.device("cpu")
    assert sequence.build_tsp_mesh(devices=["cpu"]).shape == {"dp": 1, "tp": 1, "sp": 1,
                                                               "ep": 1}


def test_telemetry_tools_and_flop_count_import_no_jax():
    """The collector, the doctor, the live plane, the exporter, the CLI
    (run as ``python -m``) and the FLOP count's modules, alone in a fresh
    interpreter: nothing of JAX, msgpack or the JAX package."""
    code = textwrap.dedent("""
        import importlib, runpy, sys
        for name in ("telemetry.collect", "telemetry.doctor", "telemetry.live",
                     "telemetry.serve", "telemetry.__main__", "telemetry.perf",
                     "models.flops", "ops.flash_attention"):
            importlib.import_module("coinstac_dinunet_tpu_torch." + name)
        sys.argv = ["telemetry", "--help"]
        try:
            runpy.run_module("coinstac_dinunet_tpu_torch.telemetry", run_name="__main__")
        except SystemExit as exc:
            assert exc.code == 0, exc.code
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "msgpack")
                     or m == "coinstac_dinunet_tpu" or m.startswith("coinstac_dinunet_tpu."))
        print("BAD", bad)
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "python -m coinstac_dinunet_tpu_torch.telemetry" in out.stdout
    assert out.stdout.strip().splitlines()[-1] == "BAD []"


def test_models_groupnorm_and_checkpoint_import_modules_import_no_jax():
    """ResNet-18, the two-network scheme, the GroupNorm and the
    torch checkpoint import, alone in a fresh interpreter: nothing of JAX,
    msgpack or the JAX package."""
    code = textwrap.dedent("""
        import importlib, sys
        for name in ("ops.groupnorm", "models.resnet", "models.multinet",
                     "utils.torch_import", "models.flops", "interop"):
            importlib.import_module("coinstac_dinunet_tpu_torch." + name)
        from coinstac_dinunet_tpu_torch.models import (
            MultiNetTrainer, ResNet18, ResNetTrainer, SyntheticImageDataset)
        from coinstac_dinunet_tpu_torch.ops.groupnorm import group_norm, norm_relu
        from coinstac_dinunet_tpu_torch.utils.torch_import import read_torch_file
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "msgpack")
                     or m == "coinstac_dinunet_tpu" or m.startswith("coinstac_dinunet_tpu."))
        print("BAD", bad)
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "BAD []"


def test_native_wire_and_vision_modules_import_no_jax():
    """The native wire runtime and the plots, alone in a fresh interpreter,
    with the native library loaded: nothing of JAX, msgpack or the JAX
    package."""
    code = textwrap.dedent("""
        import importlib, sys
        for name in ("native", "vision", "vision.imageutils", "vision.plotter",
                     "resilience.transport", "utils.tensorutils"):
            importlib.import_module("coinstac_dinunet_tpu_torch." + name)
        from coinstac_dinunet_tpu_torch import native
        from coinstac_dinunet_tpu_torch.resilience import flush_async
        from coinstac_dinunet_tpu_torch.vision import plot_progress
        assert native.available()
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
    COINSTAC runs as ``python local.py``, and the simulations
    ``run_sim.py`` of all four examples and ``run_local.py`` of FSV and VBM)
    load from any directory without the package installed, and pull in
    nothing of JAX either."""
    scripts = sorted(glob.glob(os.path.join(REPO, "coinstac_dinunet_tpu_torch", "examples",
                                            "*", "*.py")))
    assert len(scripts) == 14, scripts
    code = textwrap.dedent("""
        import importlib.util, os, sys
        for i, path in enumerate(sys.argv[1:]):
            spec = importlib.util.spec_from_file_location(f"entry{i}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            entry = "main" if os.path.basename(path).startswith("run_") else "compute"
            assert callable(getattr(mod, entry)), path
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
    ports a module (its own additions: interop, the csrc build helper, the
    msgpack codec that stands in for flax's and the closed-form FLOP counts
    of its models)."""
    names = [m.name.split(".", 1)[1] for m in
             pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
    own = {"interop", "ops._cuda", "utils.flax_msgpack", "models.flops"}
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
        lambda dev: ResNetTrainer(cache={}, device=dev),
        lambda dev: MultiNetTrainer(cache={}, device=dev),
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
    # carried since the health layer was ported: the node freezes the
    # option as the JAX node does, and a cache holding it quarantines a
    # site its watchdog finds non-finite, as the JAX watchdog does
    from coinstac_dinunet_tpu.nodes.local import COINNLocal as JaxLocal
    from coinstac_dinunet_tpu.telemetry import NULL_RECORDER as JAX_NULL
    from coinstac_dinunet_tpu.telemetry import Watchdog as JaxWatchdog

    ours = COINNLocal(cache={}, device="cpu", quarantine_on_anomaly=True).cache
    theirs = JaxLocal(cache={}, quarantine_on_anomaly=True).cache
    assert ours["quarantine_on_anomaly"] is theirs["quarantine_on_anomaly"] is True
    for cache, wd in ((ours, port.telemetry.Watchdog(ours, port.telemetry.NULL_RECORDER)),
                      (theirs, JaxWatchdog(theirs, JAX_NULL))):
        wd.observe("site_cosine", float("nan"), site="site_1")
        assert cache["quarantined_sites"] == ["site_1"]
    # carried since quorum, async rounds, run-ahead and the tree fan-in were
    # ported
    for key, value in (("site_quorum", 1), ("async_staleness", 1), ("async_invoke_pool", 2),
                       ("async_stale_discount", 0.5), ("run_ahead", 1), ("reduce_fanin", 2)):
        assert COINNLocal(cache={}, device="cpu", **{key: value}).cache[key] == value
    # carried since the other metrics and data were ported; batches placed
    # over several devices since the mesh planes were (a rank mesh and an
    # axis: one part per rank)
    assert isinstance(port.metrics.new_metrics(num_classes=3), port.metrics.ConfusionMatrix)
    assert isinstance(port.metrics.new_metrics(2, binary_as_auc=True),
                      port.metrics.AUCROCMetrics)
    from coinstac_dinunet_tpu_torch.parallel.mesh import build_site_only_mesh

    mesh = build_site_only_mesh(2, ["cpu"] * 2)
    parts = next(port.data.device_prefetch(iter([{"x": np.arange(4.0)}]), size=2,
                                           sharding=(mesh, "site")))
    assert [p["x"].tolist() for p in parts] == [[0.0, 1.0], [2.0, 3.0]]


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

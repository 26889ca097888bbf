"""The port stands alone: importing ``coinstac_dinunet_tpu_torch`` and
every module under it pulls in neither JAX (nor flax/optax) nor any module
of the JAX package, and its entry points default to the card — without
one they raise unless given ``device="cpu"``."""
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
                     if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax")
                     or m == "coinstac_dinunet_tpu" or m.startswith("coinstac_dinunet_tpu."))
        assert len(names) >= 20, names
        print("BAD", bad)
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "BAD []"


def test_every_port_module_has_a_reference_module():
    """The port mirrors the JAX package's tree file for file where it
    ports a module (its own additions: interop, csrc build helper)."""
    names = [m.name.split(".", 1)[1] for m in
             pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
    own = {"interop", "ops._cuda"}
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
    for args in ({"agg_engine": "powerSGD"}, {"site_quorum": 1}, {"async_staleness": 1},
                 {"reduce_fanin": 2}):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            COINNLocal(cache={}, device="cpu", **args)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        port.metrics.new_metrics(num_classes=3)

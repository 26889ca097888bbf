"""coinstac_dinunet_tpu_torch — the PyTorch/CUDA port of coinstac_dinunet_tpu.

A second package beside the JAX one, with the same module tree where it
ports a module, the same wire protocol (phase/mode/key strings, COINNTW2
payloads, gradient leaf order and layout) and the same federated phase
machine.  It imports torch and numpy and never the JAX package.  Entry
points (:class:`InProcessEngine`, :class:`SiteRunner`, the trainers) run on
``cuda`` unless given ``device="cpu"``.  The hand-written Hopper kernels
live in ``csrc/`` and build at first use (``ops/_cuda.py``).

``ROADMAP.md`` lists what is still to port.
"""
from . import config
from .config.keys import AggEngine, Key, LocalWire, Mode, Phase, RemoteWire
from .data import COINNDataHandle, COINNDataLoader, COINNDataset
from .engine import InProcessEngine, SiteRunner, load_inputspec
from .metrics import AUCROCMetrics, COINNAverages, COINNMetrics, ConfusionMatrix, Prf1a
from .nn import NNTrainer
from .nodes import COINNLocal, COINNRemote
from .parallel import COINNLearner, COINNReducer
from .trainer import COINNTrainer

__all__ = [
    "config",
    "AggEngine", "Key", "LocalWire", "Mode", "Phase", "RemoteWire",
    "COINNDataset", "COINNDataHandle", "COINNDataLoader",
    "InProcessEngine", "SiteRunner", "load_inputspec",
    "COINNMetrics", "COINNAverages", "Prf1a", "ConfusionMatrix", "AUCROCMetrics",
    "NNTrainer", "COINNTrainer",
    "COINNLocal", "COINNRemote",
    "COINNLearner", "COINNReducer",
]

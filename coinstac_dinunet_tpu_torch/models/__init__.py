from .cnn3d import SyntheticVBMDataset, VBM3DNet, VBMTrainer, fit_volume
from .transformer import (
    MultiHeadSelfAttention,
    SeqClassifier,
    SeqTrainer,
    SyntheticSeqDataset,
    TPDense,
    TransformerBlock,
)

__all__ = [
    "VBM3DNet", "SyntheticVBMDataset", "VBMTrainer", "fit_volume",
    "TPDense", "MultiHeadSelfAttention", "TransformerBlock", "SeqClassifier",
    "SyntheticSeqDataset", "SeqTrainer",
]

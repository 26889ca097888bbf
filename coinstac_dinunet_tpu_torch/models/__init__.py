from .cnn3d import NiftiVBMDataset, SyntheticVBMDataset, VBM3DNet, VBMTrainer, fit_volume
from .mlp import FSVDataset, FSVNet, FSVTrainer
from .multinet import MultiNetTrainer
from .resnet import ResBlock, ResNet18, ResNetTrainer, SyntheticImageDataset
from .transformer import (
    MultiHeadSelfAttention,
    SeqClassifier,
    SeqTrainer,
    SyntheticSeqDataset,
    TPDense,
    TransformerBlock,
)

__all__ = [
    "VBM3DNet", "SyntheticVBMDataset", "NiftiVBMDataset", "VBMTrainer", "fit_volume",
    "FSVNet", "FSVDataset", "FSVTrainer",
    "TPDense", "MultiHeadSelfAttention", "TransformerBlock", "SeqClassifier",
    "SyntheticSeqDataset", "SeqTrainer",
    "ResBlock", "ResNet18", "SyntheticImageDataset", "ResNetTrainer", "MultiNetTrainer",
]

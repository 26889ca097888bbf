from .loss import classification_outputs, cross_entropy
from .metrics import (
    AUCROCMetrics,
    COINNAverages,
    COINNMetrics,
    ConfusionMatrix,
    Prf1a,
    new_metrics,
)

__all__ = [
    "COINNMetrics",
    "COINNAverages",
    "Prf1a",
    "ConfusionMatrix",
    "AUCROCMetrics",
    "new_metrics",
    "cross_entropy",
    "classification_outputs",
]

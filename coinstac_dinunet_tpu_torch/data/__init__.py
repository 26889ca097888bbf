from .data import (
    COINNDataHandle,
    COINNDataLoader,
    COINNDataset,
    EmptyDataHandle,
    device_prefetch,
    safe_collate,
    to_device,
)
from .datautils import (
    create_k_fold_splits,
    create_ratio_split,
    init_k_folds,
    split_place_holder,
)

__all__ = [
    "COINNDataset",
    "COINNDataHandle",
    "COINNDataLoader",
    "EmptyDataHandle",
    "safe_collate",
    "device_prefetch",
    "to_device",
    "create_k_fold_splits",
    "create_ratio_split",
    "split_place_holder",
    "init_k_folds",
]

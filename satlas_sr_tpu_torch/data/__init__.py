"""Data registry package (importing registers the datasets)."""

from .loader import (PrefetchLoader, SequentialEvalLoader, build_dataset, build_train_loader,
                     default_collate)
from .s2naip import S2NAIPDataset, has_black_pixels

__all__ = [
    "S2NAIPDataset",
    "has_black_pixels",
    "PrefetchLoader",
    "SequentialEvalLoader",
    "build_train_loader",
    "build_dataset",
    "default_collate",
]

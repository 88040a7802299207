"""Data registry package (importing registers the datasets)."""

from .loader import SequentialEvalLoader, build_dataset, default_collate
from .s2naip import S2NAIPDataset, has_black_pixels

__all__ = [
    "S2NAIPDataset",
    "has_black_pixels",
    "SequentialEvalLoader",
    "build_dataset",
    "default_collate",
]

"""Training data: the pre-resized uint8 cache and its shuffled loader."""

from .dataset import Uint8CacheDataset, cache_path_for, infinite_loader, open_dataset

__all__ = ["Uint8CacheDataset", "cache_path_for", "infinite_loader", "open_dataset"]

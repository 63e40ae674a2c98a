"""Training data: the pre-resized uint8 cache and its shuffled loader; image
folders for the real-image statistics."""

from .dataset import (
    ImageFolderDataset, Uint8CacheDataset, cache_path_for, infinite_loader, open_dataset)

__all__ = ["ImageFolderDataset", "Uint8CacheDataset", "cache_path_for", "infinite_loader",
           "open_dataset"]

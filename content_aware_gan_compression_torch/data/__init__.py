"""Training data: image folders decoded per read, the pre-resized uint8
cache and its builder, the prefetching loader and the native batch
transform."""

from .dataset import (
    FFHQDataset, Uint8CacheDataset, build_uint8_cache, cache_path_for, data_loader,
    infinite_loader, open_dataset)

__all__ = ["FFHQDataset", "Uint8CacheDataset", "build_uint8_cache",
           "cache_path_for", "data_loader", "infinite_loader", "open_dataset"]

"""Checkpoint I/O, image grids and device selection."""

from .checkpoint import (
    build_generator_from_state_dict,
    load_checkpoint,
    load_generator,
    load_torch_checkpoint,
    pytree_to_torch_state_dict,
    save_checkpoint,
    state_dict_from_jax,
    torch_state_dict_to_pytree,
)
from .logging import save_image_grid
from .runtime import resolve_device

__all__ = [
    "build_generator_from_state_dict",
    "load_checkpoint",
    "load_generator",
    "load_torch_checkpoint",
    "pytree_to_torch_state_dict",
    "save_checkpoint",
    "state_dict_from_jax",
    "torch_state_dict_to_pytree",
    "save_image_grid",
    "resolve_device",
]

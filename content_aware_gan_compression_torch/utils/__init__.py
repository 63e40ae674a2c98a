"""Checkpoint I/O, experiment logs, image grids and device selection."""

from .checkpoint import (
    build_bisenet_from_state_dict,
    build_discriminator_from_state_dict,
    build_generator_from_state_dict,
    build_inception_from_state_dict,
    build_lpips_from_state_dict,
    load_checkpoint,
    load_generator,
    load_optimizer_state,
    load_torch_checkpoint,
    load_training_checkpoint,
    optimizer_state_to_jax,
    pytree_to_torch_state_dict,
    save_checkpoint,
    state_dict_from_jax,
    torch_state_dict_to_pytree,
)
from .logging import ExperimentLogger, NullLogger, save_image_grid
from .runtime import resolve_device

__all__ = [
    "build_bisenet_from_state_dict",
    "build_discriminator_from_state_dict",
    "build_generator_from_state_dict",
    "build_inception_from_state_dict",
    "build_lpips_from_state_dict",
    "load_checkpoint",
    "load_generator",
    "load_optimizer_state",
    "load_torch_checkpoint",
    "load_training_checkpoint",
    "optimizer_state_to_jax",
    "pytree_to_torch_state_dict",
    "save_checkpoint",
    "state_dict_from_jax",
    "torch_state_dict_to_pytree",
    "ExperimentLogger",
    "NullLogger",
    "save_image_grid",
    "resolve_device",
]

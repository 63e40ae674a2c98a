"""Checkpoint I/O: reference torch checkpoints, the JAX package's ``.npz``
format, and the bridge from JAX parameter trees to the port's state dicts.

The port's module names mirror the JAX parameter tree's key paths, which in
turn mirror the reference torch state dict ('conv1.conv.weight' ==
tree['conv1']['conv']['weight']). So converting between the three is a split
or join on '.'. FIR-tap buffers ('...blur.kernel', '...upsample.kernel') are
functions of the config and are dropped on import.

``.npz`` checkpoints: one array per leaf under '<tree>/<a>/<b>/<c>', plus a
JSON manifest (``__manifest__``) listing each tree's keys, the metadata, and
the dtype of leaves numpy cannot type (bfloat16, stored as its uint16 bits).
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

# Buffers in reference state dicts that are recomputed from config here.
_DROPPED_LEAF = "kernel"


def _bf16_from_bits(arr: np.ndarray) -> torch.Tensor:
    """A bfloat16 tensor from an array of its 16-bit patterns (no
    ml_dtypes needed)."""
    return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)


def _to_tensor(value) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value
    arr = np.asarray(value)
    if arr.dtype.name == "bfloat16":  # ml_dtypes' numpy bfloat16 (JAX arrays)
        return _bf16_from_bits(arr)
    return torch.from_numpy(np.array(arr))


def torch_state_dict_to_pytree(state_dict) -> dict:
    """Nest a flat {'a.b.c': tensor} state dict into {'a': {'b': {'c': ...}}},
    dropping FIR-kernel buffers."""
    tree: dict = {}
    for key, value in state_dict.items():
        parts = key.split(".")
        if parts[-1] == _DROPPED_LEAF:
            continue
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return tree


def pytree_to_torch_state_dict(tree, prefix: str = "") -> dict:
    """Flatten a nested dict to '.'-joined keys (a flat dict passes through)."""
    flat: dict = {}
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            flat.update(pytree_to_torch_state_dict(v, key))
        else:
            flat[key] = v
    return flat


def state_dict_from_jax(tree) -> dict[str, torch.Tensor]:
    """JAX params (a nested dict of numpy or JAX arrays, or a flat torch-style
    state dict) -> the port's state dict of CPU tensors, FIR buffers dropped.
    ``Generator.load_state_dict(..., strict=True)`` takes it as it is."""
    flat = pytree_to_torch_state_dict(tree)
    return {k: _to_tensor(v) for k, v in flat.items()
            if k.split(".")[-1] != _DROPPED_LEAF}


def load_torch_checkpoint(path: str) -> dict:
    """Load a reference ``.pt``/``.pth`` checkpoint on the CPU.

    Reference checkpoints pickle more than tensors (e.g. training args), so
    this unpickles in full (``weights_only=False``): load only files you
    trust."""
    return torch.load(path, map_location="cpu", weights_only=False)


def save_checkpoint(path: str, trees: dict, metadata: dict | None = None) -> None:
    """Save {'g_ema': state dict or nested dict, ...} as one ``.npz`` with a
    JSON manifest, in the format the JAX package's ``load_checkpoint`` reads."""
    arrays: dict[str, np.ndarray] = {}
    manifest: dict = {"trees": {}, "metadata": metadata or {}, "dtypes": {}}
    for name, tree in trees.items():
        keys = []
        for leaf_key, value in pytree_to_torch_state_dict(tree).items():
            key = name + "/" + leaf_key.replace(".", "/")
            t = _to_tensor(value).detach().cpu()
            if t.dtype == torch.bfloat16:
                manifest["dtypes"][key] = "bfloat16"
                arr = t.view(torch.int16).numpy().view(np.uint16)
            else:
                arr = t.numpy()
            arrays[key] = arr
            keys.append(key)
        manifest["trees"][name] = keys
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        np.savez(f, __manifest__=np.frombuffer(json.dumps(manifest).encode(), dtype=np.uint8),
                 **arrays)


def load_checkpoint(path: str) -> tuple[dict, dict]:
    """Inverse of ``save_checkpoint`` (and reader of the JAX package's
    ``.npz``). Returns ({name: nested dict of CPU tensors}, metadata)."""
    with np.load(path, allow_pickle=False) as z:
        manifest = json.loads(bytes(z["__manifest__"].tobytes()).decode())
        dtypes = manifest.get("dtypes", {})
        out: dict = {}
        for name, keys in manifest["trees"].items():
            tree: dict = {}
            for key in keys:
                parts = key.split("/")[1:]
                node = tree
                for p in parts[:-1]:
                    node = node.setdefault(p, {})
                arr = z[key]
                if key in dtypes:
                    if dtypes[key] != "bfloat16":
                        raise ValueError(f"{path}: leaf {key} has unsupported dtype {dtypes[key]}")
                    t = _bf16_from_bits(arr)
                else:
                    t = torch.from_numpy(np.array(arr))
                node[parts[-1]] = t
            out[name] = tree
    return out, manifest["metadata"]


def build_generator_from_state_dict(state_dict, size: int, style_dim: int = 512,
                                    n_mlp: int = 8, *, device="cuda"):
    """A ``Generator`` holding ``state_dict`` (flat or nested; FIR buffers
    dropped). Net widths are read off the tensors, never from config — the
    analogue of the reference's Build_Generator_From_Dict."""
    from ..models.stylegan2 import Generator, GeneratorConfig, net_shape_from_params

    sd = state_dict_from_jax(state_dict)
    config = GeneratorConfig(size=size, style_dim=style_dim, n_mlp=n_mlp,
                             net_shape=net_shape_from_params(sd))
    g = Generator(config, device=device)
    g.load_state_dict(sd, strict=True)
    return g


def load_generator(path: str, size: int, style_dim: int = 512, n_mlp: int = 8, *,
                   device="cuda", tree: str = "g_ema"):
    """The generator ``tree`` of a ``.npz`` (JAX or port) or reference ``.pt``."""
    if path.endswith(".npz"):
        trees, _ = load_checkpoint(path)
        sd = trees[tree]
    else:
        sd = load_torch_checkpoint(path)[tree]
    return build_generator_from_state_dict(sd, size, style_dim, n_mlp, device=device)

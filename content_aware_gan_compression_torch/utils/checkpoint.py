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
import re

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
            # optax tree-path keys ('[0].nu[...]') stay whole, as the JAX
            # package writes them; module paths ('a.b.c') become 'a/b/c'
            key = name + "/" + (leaf_key if leaf_key.startswith("[")
                                else leaf_key.replace(".", "/"))
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


def build_discriminator_from_state_dict(state_dict, size: int, channel_multiplier: int = 2,
                                        *, device="cuda"):
    """A ``Discriminator`` holding ``state_dict`` (flat or nested, the JAX
    tree or a reference one), its widths read off the tensors."""
    from ..models.stylegan2 import Discriminator, discriminator_config_from_params

    sd = state_dict_from_jax(state_dict)
    d = Discriminator(discriminator_config_from_params(sd, size, channel_multiplier),
                      device=device)
    d.load_state_dict(sd, strict=True)
    return d


def build_lpips_from_state_dict(state_dict, *, device="cuda"):
    """An ``LPIPS`` holding ``state_dict`` (the JAX ``lpips_init`` tree, flat
    or nested), its widths read off the conv weights."""
    from ..models.lpips import LPIPS, VGG16_CONVS

    sd = state_dict_from_jax(state_dict)
    widths = tuple(int(sd[f"vgg.{idx}.weight"].shape[0]) for idx, _, _ in VGG16_CONVS)
    net = LPIPS(widths, device=device)
    net.load_state_dict(sd, strict=True)
    return net


def build_inception_from_state_dict(state_dict, *, device="cuda"):
    """An ``InceptionV3`` holding ``state_dict`` (the JAX ``inception_init``
    tree, flat or nested, or the pytorch-fid keys without ``fc.*``,
    ``AuxLogits.*`` and ``num_batches_tracked``), its width scale read off
    Conv2d_2b's 64 channels."""
    from ..models.inception import InceptionV3

    sd = state_dict_from_jax(state_dict)
    net = InceptionV3(sd["Conv2d_2b_3x3.conv.weight"].shape[0] / 64, device=device)
    net.load_state_dict(sd, strict=True)
    return net


def build_bisenet_from_state_dict(state_dict, *, device="cuda"):
    """A ``BiSeNet`` holding ``state_dict`` (the JAX ``bisenet_init`` tree or
    a reference one without ``num_batches_tracked``), its widths and class
    count read off the tensors."""
    from ..models.bisenet import BiSeNet

    sd = state_dict_from_jax(state_dict)
    widths = tuple(int(sd[f"cp.resnet.{key}.weight"].shape[0]) for key in (
        "conv1", "layer2.0.conv1", "layer3.0.conv1", "layer4.0.conv1"))
    net = BiSeNet(widths, int(sd["conv_out.conv_out.weight"].shape[0]), device=device)
    net.load_state_dict(sd, strict=True)
    return net


# ---------------------------------------------------------------------------
# optimizer state
# ---------------------------------------------------------------------------
#
# The JAX package saves its optax state keyed by tree path: '[0].count' and
# "[0].nu['conv1']['conv']['weight']" for every leaf of the parameter tree,
# which for the generator includes the noise buffers. The port's AdamNoMu
# keeps the same numbers as param_groups[0]['step'] and
# state[p]['exp_avg_sq'].

_NU_KEY = re.compile(r"^\[0\]\.nu((?:\['[^']*'\])+)$")


def _jax_nu_key(name: str) -> str:
    return "[0].nu" + "".join(f"['{part}']" for part in name.split("."))


def optimizer_state_to_jax(optimizer, module) -> dict[str, torch.Tensor]:
    """``optimizer``'s state as the JAX package's flat tree for ``module``'s
    leaves. Buffers (the generator's noise maps) take a zero second moment,
    which is what JAX holds for leaves that never get a gradient. ``nu``
    keeps its storage type (``state_dtype``): a bfloat16 one is written as
    bfloat16, as the JAX package writes its optax state."""
    params = dict(module.named_parameters())
    state_dtype = getattr(optimizer, "state_dtype", None)
    tree = {"[0].count": torch.tensor(optimizer.param_groups[0]["step"], dtype=torch.int32)}
    for name, value in module.state_dict().items():
        state = optimizer.state.get(params[name], {}) if name in params else {}
        # a buffer, or a parameter before the first step: zero
        nu = state.get("exp_avg_sq", torch.zeros_like(value, dtype=state_dtype))
        tree[_jax_nu_key(name)] = nu.detach().cpu()
    return tree


def load_optimizer_state(optimizer, module, tree) -> None:
    """Load a saved optimizer state into ``optimizer`` for ``module``'s
    parameters: the JAX package's flat tree (``optimizer_state_to_jax``'s
    format; entries of buffers are dropped) or a reference torch Adam
    ``state_dict`` ({'state', 'param_groups'}, whose first moment the b1 == 0
    optimizer does not need). ``nu`` is stored in the optimizer's
    ``state_dtype`` (the parameter's type if it has none), whatever type
    the file holds it in."""
    named = dict(module.named_parameters())
    if "state" in tree and "param_groups" in tree:
        order = list(named.values())
        state = tree["state"]
        steps = {int(torch.as_tensor(s["step"]).item()) for s in state.values()}
        if len(steps) > 1:
            raise ValueError(f"torch optimizer state has parameters at steps {sorted(steps)}")
        nus = {order[int(i)]: torch.as_tensor(s["exp_avg_sq"]) for i, s in state.items()}
        step = steps.pop() if steps else 0
    else:
        flat = pytree_to_torch_state_dict(tree) if any(
            isinstance(v, dict) for v in tree.values()) else tree
        nus, step = {}, None
        for key, value in flat.items():
            if key == "[0].count":
                step = int(_to_tensor(value).item())
                continue
            m = _NU_KEY.match(key)
            if m is None:
                raise ValueError(f"unknown optimizer state entry {key!r}")
            name = ".".join(re.findall(r"\['([^']*)'\]", m.group(1)))
            if name in named:
                nus[named[name]] = _to_tensor(value)
        if step is None:
            raise ValueError("optimizer state has no '[0].count'")
    missing = [n for n, p in named.items() if p not in nus]
    if missing:
        raise ValueError(f"optimizer state lacks {len(missing)} parameters, e.g. {missing[:3]}")
    for group in optimizer.param_groups:
        group["step"] = step
    state_dtype = getattr(optimizer, "state_dtype", None)
    for p, nu in nus.items():
        if nu.shape != p.shape:
            raise ValueError(f"optimizer state shape {tuple(nu.shape)} != parameter "
                             f"{tuple(p.shape)}")
        optimizer.state[p]["exp_avg_sq"] = nu.to(device=p.device,
                                                 dtype=state_dtype or p.dtype).clone()


def load_training_checkpoint(path: str) -> tuple[dict, dict]:
    """Load {'g', 'd', 'g_ema'[, 'g_optim', 'd_optim']} from a ``.npz`` (the
    JAX package's or the port's) or a reference ``.pt``/``.pth``. Returns
    (trees, metadata); a ``.pt`` has no metadata."""
    if path.endswith(".npz"):
        return load_checkpoint(path)
    ckpt = load_torch_checkpoint(path)
    return {k: ckpt[k] for k in ("g", "d", "g_ema", "g_optim", "d_optim") if k in ckpt}, {}

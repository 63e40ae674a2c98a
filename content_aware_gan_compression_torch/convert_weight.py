"""Official TF-StyleGAN2 weight converter (the JAX package's root
convert_weight.py, itself the reference's Miscellaneous/convert_weight.py):

    python -m content_aware_gan_compression_torch.convert_weight ffhq_vars.npz

PATH is a numpy dict of the TF generator's variables under their official
names (the JAX script's docstring says how to dump one with the official
repository). The names and layouts map as in the reference's
convert_modconv / convert_torgb / convert_dense / convert_conv
(convert_weight.py:14-92), ``Conv0_up`` weights flipped in both spatial
axes. Writes ``<name>.npz`` in the working directory ({'g_ema'[, 'g', 'd',
'latent_avg']}, metadata {'size'}), the same arrays and metadata as the JAX
script's, so either package loads it; ``--gen`` and ``--disc`` add the
trees of ``<PATH>_g.npz`` and ``<PATH>_d.npz`` where they exist.

Then a fixed-seed render (reference convert_weight.py:249-275): z from
``RandomState(0)``, truncation 0.5 towards ``dlatent_avg`` when the variables
hold it, the stored noise maps (``randomize_noise=False``), written as the
grid ``<name>.png`` with the zlib PNG writer. With ``--tf_output`` (a ``.npy``
of the TF model's images on the same z) it prints the largest and the mean
difference and writes TF, the port and the difference in one grid. The
render runs on ``cuda`` unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import math
import os

import numpy as np


def convert_modconv(vars, source, flip=False):
    """TF conv vars -> StyledConv subtree (reference convert_weight.py:14-39)."""
    weight = np.asarray(vars[source + "/weight"])
    out = {
        "conv": {
            "weight": np.expand_dims(weight.transpose(3, 2, 0, 1), 0),
            "modulation": {
                "weight": np.asarray(vars[source + "/mod_weight"]).transpose(1, 0),
                "bias": np.asarray(vars[source + "/mod_bias"]) + 1,
            },
        },
        "noise": {"weight": np.array([np.asarray(vars[source + "/noise_strength"])]).reshape(1)},
        "activate": {"bias": np.asarray(vars[source + "/bias"])},
    }
    if flip:
        out["conv"]["weight"] = out["conv"]["weight"][:, :, :, ::-1, ::-1].copy()
    return out


def convert_torgb(vars, source):
    """TF ToRGB vars -> ToRGB subtree (reference convert_weight.py:60-79)."""
    weight = np.asarray(vars[source + "/weight"])
    return {
        "conv": {
            "weight": np.expand_dims(weight.transpose(3, 2, 0, 1), 0),
            "modulation": {
                "weight": np.asarray(vars[source + "/mod_weight"]).transpose(1, 0),
                "bias": np.asarray(vars[source + "/mod_bias"]) + 1,
            },
        },
        "bias": np.asarray(vars[source + "/bias"]).reshape(1, 3, 1, 1),
    }


def convert_dense(vars, source):
    return {"weight": np.asarray(vars[source + "/weight"]).transpose(1, 0),
            "bias": np.asarray(vars[source + "/bias"])}


def convert_conv(vars, source, bias=True, start=0):
    out = {str(start): {"weight": np.asarray(vars[source + "/weight"]).transpose(3, 2, 0, 1)}}
    if bias:
        out[str(start + 1)] = {"bias": np.asarray(vars[source + "/bias"])}
    return out


def generator_tree_from_tf_vars(vars, size, n_mlp=8):
    """The generator's tree (reference fill_statedict,
    convert_weight.py:141-200)."""
    log_size = int(math.log2(size))
    tree = {"style": {}, "convs": {}, "to_rgbs": {}, "noises": {}}
    for i in range(n_mlp):
        tree["style"][str(i + 1)] = convert_dense(vars, f"G_mapping/Dense{i}")
    tree["input"] = {"input": np.asarray(vars["G_synthesis/4x4/Const/const"])}
    tree["to_rgb1"] = convert_torgb(vars, "G_synthesis/4x4/ToRGB")
    tree["conv1"] = convert_modconv(vars, "G_synthesis/4x4/Conv")
    for i in range(log_size - 2):
        reso = 4 * 2 ** (i + 1)
        tree["to_rgbs"][str(i)] = convert_torgb(vars, f"G_synthesis/{reso}x{reso}/ToRGB")
        tree["convs"][str(2 * i)] = convert_modconv(
            vars, f"G_synthesis/{reso}x{reso}/Conv0_up", flip=True)
        tree["convs"][str(2 * i + 1)] = convert_modconv(vars, f"G_synthesis/{reso}x{reso}/Conv1")
    for i in range((log_size - 2) * 2 + 1):
        tree["noises"][f"noise_{i}"] = np.asarray(vars[f"G_synthesis/noise{i}"])
    return tree


def discriminator_tree_from_tf_vars(vars, size):
    """The discriminator's tree (reference discriminator_fill_statedict,
    convert_weight.py:109-138)."""
    log_size = int(math.log2(size))
    tree = {"convs": {"0": convert_conv(vars, f"{size}x{size}/FromRGB")}}
    conv_i = 1
    for i in range(log_size - 2, 0, -1):
        reso = 4 * 2 ** i
        tree["convs"][str(conv_i)] = {
            "conv1": convert_conv(vars, f"{reso}x{reso}/Conv0"),
            "conv2": convert_conv(vars, f"{reso}x{reso}/Conv1_down", start=1),
            "skip": convert_conv(vars, f"{reso}x{reso}/Skip", start=1, bias=False),
        }
        conv_i += 1
    tree["final_conv"] = convert_conv(vars, "4x4/Conv")
    tree["final_linear"] = {"0": convert_dense(vars, "4x4/Dense0"),
                            "1": convert_dense(vars, "Output")}
    return tree


def sorted_tree(tree):
    """``tree`` with every dict's keys in sorted order, the order in which
    the JAX package flattens (and so writes) a tree."""
    return {k: sorted_tree(v) if isinstance(v, dict) else v for k, v in sorted(tree.items())}


def infer_size(vars) -> int:
    """The resolution: the side of the last noise map."""
    noise_keys = [k for k in vars if k.startswith("G_synthesis/noise")]
    return int(vars[max(noise_keys, key=lambda k: int(k.rsplit("noise", 1)[1]))].shape[-1])


def render_batch(size: int) -> int:
    """Images in the fixed-seed render (reference convert_weight.py:249)."""
    return {256: 16, 512: 9, 1024: 4}.get(size, 25)


def main(argv=None):
    """Returns the rendered images, float32 [batch, 3, size, size] on the CPU."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--gen", action="store_true",
                        help="also convert the training generator's vars (<PATH>_g.npz)")
    parser.add_argument("--disc", action="store_true",
                        help="also convert the discriminator's vars (<PATH>_d.npz)")
    parser.add_argument("--channel_multiplier", type=int, default=2)
    parser.add_argument("--size", type=int, default=None,
                        help="inferred from the noise maps' shapes if omitted")
    parser.add_argument("--tf_output", type=str, default=None,
                        help=".npy of the TF model's images on seed-0 z for the parity check")
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("path", metavar="PATH", help=".npz of g_ema's TF vars")
    args = parser.parse_args(argv)

    import torch

    from .utils import build_generator_from_state_dict, resolve_device, save_checkpoint
    from .utils.logging import save_image_grid

    device = resolve_device(args.device)
    vars = dict(np.load(args.path))
    size = args.size or infer_size(vars)

    tree = sorted_tree(generator_tree_from_tf_vars(vars, size))
    ckpt = {"g_ema": tree}
    if "dlatent_avg" in vars:
        ckpt["latent_avg"] = {"latent_avg": np.asarray(vars["dlatent_avg"])}
    if args.gen:
        g_vars_path = args.path.replace(".npz", "_g.npz")
        if os.path.exists(g_vars_path):
            ckpt["g"] = sorted_tree(generator_tree_from_tf_vars(dict(np.load(g_vars_path)), size))
    if args.disc:
        d_vars_path = args.path.replace(".npz", "_d.npz")
        if os.path.exists(d_vars_path):
            ckpt["d"] = sorted_tree(discriminator_tree_from_tf_vars(dict(np.load(d_vars_path)),
                                                                    size))
    name = os.path.splitext(os.path.basename(args.path))[0]
    out_path = name + ".npz"
    save_checkpoint(out_path, ckpt, metadata={"size": size})
    print(f"saved {out_path}")

    g = build_generator_from_state_dict(tree, size, device=device)
    batch = render_batch(size)
    z = torch.from_numpy(np.random.RandomState(0).randn(batch, 512).astype("float32"))
    trunc = (torch.from_numpy(np.asarray(vars["dlatent_avg"], np.float32))[None].to(device)
             if "dlatent_avg" in vars else None)
    with torch.inference_mode():
        img = g([z.to(device)], truncation=0.5 if trunc is not None else 1,
                truncation_latent=trunc, randomize_noise=False).float().cpu()
    if args.tf_output and os.path.exists(args.tf_output):
        img_tf = np.load(args.tf_output)
        diff = np.clip((img.numpy() + 1) / 2, 0, 1) - np.clip((img_tf + 1) / 2, 0, 1)
        print(f"parity vs TF: max|diff| {np.abs(diff).max():.5f}, "
              f"mean|diff| {np.abs(diff).mean():.6f}")
        save_image_grid(np.concatenate([img_tf, img.numpy(), diff], axis=0), name + ".png",
                        nrow=batch)
    else:
        save_image_grid(img, name + ".png", nrow=batch)
    print(f"saved {name}.png")
    return img


if __name__ == "__main__":
    main()

"""Content-aware pruning CLI, with the flags of the reference's and the JAX
package's ``prune.py``:

    python -m content_aware_gan_compression_torch.prune --ckpt g.pt \\
        --parsing_ckpt 79999_iter.pth

Loads a checkpoint's ``g_ema`` (``.npz`` from either package, or a
reference ``.pt``/``.pth``), scores channels with the content-aware metric
(``--metric content-aware``, the paper's) or one of the baseline metrics,
removes ``int(width * remove_ratio)`` channels from every layer, and saves
``{'g', 'd', 'g_ema'}`` with ``g == g_ema == pruned`` as an ``.npz`` (the
JAX package reads it) and a ``.pth`` (reference prune.py:60-64). Without
the BiSeNet file the whole image counts as content, with a warning. Runs on
``cuda`` unless ``--device cpu`` is given; every draw comes from one
``torch.Generator(device)`` seeded with ``--seed``.
"""

from __future__ import annotations

import argparse
import datetime
import os
import time

import numpy as np
import torch


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--generated_img_size", type=int, default=256)
    parser.add_argument("--ckpt", type=str, default="./Model/full_size_model/256px_full_size.pt")
    parser.add_argument("--n_sample", type=int, default=400)
    parser.add_argument("--batch_size", type=int, default=10)
    parser.add_argument("--noise_prob", type=float, default=0.05)
    parser.add_argument("--remove_ratio", type=float, default=0.7)
    parser.add_argument("--info_print", action="store_true", default=False)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--latent", type=int, default=512)
    parser.add_argument("--n_mlp", type=int, default=8)
    parser.add_argument("--parsing_ckpt", type=str, default="./Model/face_parsing/79999_iter.pth",
                        help="BiSeNet weights; if missing, the whole image is treated as "
                             "content (with a warning)")
    parser.add_argument("--out_dir", type=str, default="./Model/pruned_model")
    parser.add_argument("--keep_multiple", type=int, default=1,
                        help="round kept channel counts up to this multiple (1: the "
                             "reference's exact ratio)")
    parser.add_argument("--metric", type=str, default="content-aware",
                        help="content-aware (the paper's) or a baseline metric: Random/ASV/"
                             "l1-map/l1-norm-ASV/l2-norm-ASV/l1-in/l1-out/l1-style")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    from .models import load_bisenet, make_parse_fn
    from .pruning import (
        METRIC_LIST, generate_prune_mask_list, get_content_aware_pruning_score,
        get_network_score_list, get_uniform_remove_list, mask_the_generator)
    from .utils import (
        build_generator_from_state_dict, load_checkpoint, load_torch_checkpoint, resolve_device,
        save_checkpoint, state_dict_from_jax)

    if args.metric != "content-aware" and args.metric not in METRIC_LIST:
        parser.error(f"--metric must be content-aware or one of {METRIC_LIST}")
    device = resolve_device(args.device)

    # -- load the generator --------------------------------------------------
    if args.ckpt.endswith(".npz"):
        ckpt, _ = load_checkpoint(args.ckpt)
    else:
        ckpt = load_torch_checkpoint(args.ckpt)
    g = build_generator_from_state_dict(ckpt["g_ema"], args.generated_img_size, args.latent,
                                        args.n_mlp, device=device)
    net_shape = list(g.config.net_shape)
    generator = torch.Generator(device).manual_seed(args.seed)

    # -- score ---------------------------------------------------------------
    start_time = time.time()
    if args.metric == "content-aware":
        parse_fn = None
        if os.path.exists(args.parsing_ckpt):
            parse_fn = make_parse_fn(load_bisenet(args.parsing_ckpt, device=device).eval(),
                                     "NHWC")
        else:
            print(f"WARNING: BiSeNet weights not found at {args.parsing_ckpt}; scoring with "
                  "the full image as content-of-interest")
        batch_scores = get_content_aware_pruning_score(
            g, parse_fn=parse_fn, n_sample=args.n_sample, batch_size=args.batch_size,
            noise_prob=args.noise_prob, generator=generator, info_print=args.info_print)
        score = [np.zeros(w) for w in net_shape]
        for scores in batch_scores:
            for i, s in enumerate(scores):
                score[i] = score[i] + s
    else:
        z = torch.randn(args.n_sample, g.config.style_dim, generator=generator, device=device)
        score = get_network_score_list(g, z, args.metric, generator=generator,
                                       batch_size=args.batch_size)
    print(f"The content-aware metric scoring takes: {round(time.time() - start_time, 4)} "
          "seconds")

    # -- prune ---------------------------------------------------------------
    rmve_list = get_uniform_remove_list(net_shape, args.remove_ratio,
                                        keep_multiple=args.keep_multiple)
    masks = generate_prune_mask_list(score, net_shape, rmve_list, info_print=args.info_print)
    pruned = {k: v.cpu() for k, v in mask_the_generator(g.state_dict(), masks).items()}

    # -- save ----------------------------------------------------------------
    os.makedirs(args.out_dir, exist_ok=True)
    m_time = datetime.datetime.now().strftime("%Y-%m-%d_%H:%M:%S")
    base = os.path.join(args.out_dir, f"content_aware_pruned_{args.remove_ratio}_"
                                      f"{args.generated_img_size}px_model_{m_time}")
    trees = {"g": pruned, "g_ema": pruned}
    if ckpt.get("d") is not None:
        trees["d"] = state_dict_from_jax(ckpt["d"])  # flat, FIR buffers dropped
    save_checkpoint(base + ".npz", trees, metadata={"size": args.generated_img_size,
                                                    "remove_ratio": args.remove_ratio,
                                                    "metric": args.metric})
    print(f"saved pruned checkpoint to {base}.npz")
    torch.save(trees, base + ".pth")
    print(f"saved torch export to {base}.pth")
    return base + ".npz"


if __name__ == "__main__":
    main()

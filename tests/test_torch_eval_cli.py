"""The port's evaluation CLIs and the in-loop FID, on the CPU, in-process at
16px: ``calc_inception`` against the JAX package's root ``calc_inception``
on the same uint8 cache (mean and covariance within 1e-4 of their largest
value; the features agree within 1e-4 of the largest, test_torch_inception),
``get_fid`` from a statistics pickle and from an image folder, ``get_ppl``
from seeded VGG16 and LPIPS-head files in the reference's schemas, the
``Trainer``'s FID every ``model_save_freq`` iterations (logged with the
iteration it scored, equal overlapped and synchronous), and the train CLI
with ``--inception_ckpt`` and ``--real_stats``.
"""

import json
import os
import pickle
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from content_aware_gan_compression_torch import calc_inception, get_fid, get_ppl, train
from content_aware_gan_compression_torch.models import (
    Discriminator, DiscriminatorConfig, Generator, GeneratorConfig)
from content_aware_gan_compression_torch.train.__main__ import main as train_main
from content_aware_gan_compression_torch.utils import save_checkpoint
from torch_eval_util import inception_tree, lpips_tree, write_fid_inception, write_lpips_files
from torch_train_util import torch_threads  # noqa: F401

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import calc_inception as jax_calc_inception  # noqa: E402  (the JAX package's root CLI)

SIZE, STYLE, N_MLP = 16, 16, 1
DIM = 256  # pool3_dim at width 1/8


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A seeded generator checkpoint {'g', 'g_ema', 'd'}, the Inception file
    in the pytorch-fid schema, a uint8 cache and an image folder."""
    from PIL import Image

    d = tmp_path_factory.mktemp("eval_files")
    init = torch.Generator().manual_seed(0)
    g = Generator(GeneratorConfig(size=SIZE, style_dim=STYLE, n_mlp=N_MLP,
                                  net_shape=(16, 12, 12, 8, 8, 8)), device="cpu", generator=init)
    disc = Discriminator(DiscriminatorConfig(size=SIZE, channel_max=16), device="cpu",
                         generator=init)
    ckpt = str(d / "g.npz")
    save_checkpoint(ckpt, {"g": g.state_dict(), "g_ema": g.state_dict(),
                           "d": disc.state_dict()})
    images = np.random.RandomState(0).randint(0, 256, (10, SIZE, SIZE, 3), np.uint8)
    cache = str(d / "real16.npy")
    np.save(cache, images)
    folder = d / "folder"
    folder.mkdir()
    for i, img in enumerate(images[:6]):
        Image.fromarray(img).save(folder / f"{i:05d}.png")
    return {"ckpt": ckpt, "cache": cache, "folder": str(folder), "dir": d,
            "inception": write_fid_inception(d / "pt_inception.pth", inception_tree())}


def test_calc_inception_matches_the_jax_cli_on_a_uint8_cache(files, tmp_path):
    port_out, jax_out = str(tmp_path / "port.pkl"), str(tmp_path / "jax.pkl")
    args = [files["cache"], "--size", str(SIZE), "--batch", "4",
            "--inception_ckpt", files["inception"]]
    assert calc_inception.main([*args, "--output", port_out, "--device", "cpu"]) == port_out
    jax_calc_inception.main([*args, "--output", jax_out])
    with open(port_out, "rb") as f:
        got = pickle.load(f)
    with open(jax_out, "rb") as f:
        want = pickle.load(f)
    assert set(got) == {"mean", "cov", "size", "path"}
    assert got["size"] == SIZE and got["path"] == files["cache"]
    assert got["mean"].shape == (DIM,) and got["cov"].shape == (DIM, DIM)
    for key in ("mean", "cov"):
        np.testing.assert_allclose(got[key], want[key], rtol=0,
                                   atol=1e-4 * float(np.abs(want[key]).max()), err_msg=key)


def test_calc_inception_reads_an_image_folder_and_refuses_a_size_mismatch(files, tmp_path):
    """An image folder decodes with Pillow (Lanczos to --size), tail tiled
    and dropped; a cache baked at another size than --size is refused."""
    out = str(tmp_path / "folder.pkl")
    calc_inception.main([files["folder"], "--size", str(SIZE), "--batch", "4",
                         "--inception_ckpt", files["inception"], "--output", out,
                         "--device", "cpu"])
    with open(out, "rb") as f:
        stats = pickle.load(f)
    cache_out = str(tmp_path / "cache.pkl")
    calc_inception.main([files["cache"], "--size", str(SIZE), "--batch", "4", "--n_sample", "6",
                         "--inception_ckpt", files["inception"], "--output", cache_out,
                         "--device", "cpu"])
    with open(cache_out, "rb") as f:
        from_cache = pickle.load(f)
    # the same 6 images, one batch of 4 and a tiled tail of 2: the same statistics
    np.testing.assert_allclose(stats["mean"], from_cache["mean"], rtol=1e-6, atol=1e-9)
    with pytest.raises(SystemExit, match="--size 32 does not match"):
        calc_inception.main([files["cache"], "--size", "32", "--inception_ckpt",
                             files["inception"], "--device", "cpu"])


def test_get_fid_cli_from_a_pickle_and_from_an_image_folder(files, tmp_path):
    stats = str(tmp_path / "real.pkl")
    calc_inception.main([files["cache"], "--size", str(SIZE), "--batch", "4",
                         "--inception_ckpt", files["inception"], "--output", stats,
                         "--device", "cpu"])
    common = ["--ckpt", files["ckpt"], "--generated_img_size", str(SIZE), "--latent", str(STYLE),
              "--n_mlp", str(N_MLP), "--n_sample", "10", "--batch_size", "4",
              "--inception_ckpt", files["inception"], "--device", "cpu"]
    fid = get_fid.main([*common, "--real_stats", stats])
    assert np.isfinite(fid) and fid > 0
    assert get_fid.main([*common, "--real_stats", stats]) == fid  # seeded draws
    assert get_fid.main([*common, "--real_stats", stats, "--seed", "1"]) != fid
    from_folder = get_fid.main([*common, "--real_images", files["folder"]])
    assert np.isfinite(from_folder) and from_folder > 0
    with pytest.raises(ValueError, match="real_stats or --real_images"):
        get_fid.main(common)


def test_get_ppl_cli_from_the_reference_schemas(files, tmp_path):
    vgg, lins = write_lpips_files(tmp_path, lpips_tree())
    common = ["--ckpt", files["ckpt"], "--generated_img_size", str(SIZE), "--latent", str(STYLE),
              "--n_mlp", str(N_MLP), "--n_sample", "6", "--batch_size", "4", "--eps", "1e-2",
              "--lpips_vgg_ckpt", vgg, "--lpips_lins_ckpt", lins, "--device", "cpu"]
    ppl = get_ppl.main(common)
    assert np.isfinite(ppl) and ppl > 0
    np.testing.assert_allclose(get_ppl.main([*common, "--divide_eps_sq"]), ppl / 1e-4, rtol=1e-6)
    with pytest.raises(FileNotFoundError, match="vgg16"):
        get_ppl.main([*common[:-6], "--lpips_vgg_ckpt", str(tmp_path / "none.pth"),
                      "--lpips_lins_ckpt", lins, "--device", "cpu"])


def _fid_records(exp_dir):
    with open(os.path.join(exp_dir, "metrics.jsonl")) as f:
        return [r for r in map(json.loads, f) if "fid" in r]


def _run(files, root, **kw):
    """A 5-iteration run with the FID of 8 samples in batches of 4 every 2
    iterations, against unit statistics; its FID records."""
    cfg = train.TrainConfig(data_folder=files["cache"], generated_img_size=SIZE, latent=STYLE,
                            n_mlp=N_MLP, batch_size=4, ckpt=files["ckpt"], training_iters=5,
                            val_sample_freq=100, model_save_freq=2, fid_n_sample=8,
                            fid_batch=4, **kw)
    trainer = train.Trainer(cfg, device="cpu", exp_root=str(root),
                            inception_params=inception_tree(),
                            real_stats={"mean": np.zeros(DIM), "cov": np.eye(DIM)})
    logger = trainer.run()
    logger.close()
    with open(next(Path(logger.exp_dir).glob("*_training_log.out"))) as f:
        assert f.read().count("Evaluated FID: ") == 2
    return _fid_records(logger.exp_dir)


def test_trainer_logs_the_fid_with_the_iteration_it_scored(files, tmp_path):
    """FID at iterations 2 and 4. Overlapped, 2 batches per iteration: the
    eval started at 2 completes at 3, the one started at 4 is drained before
    ``run`` returns. Each record carries the iteration of the g_ema it
    scored, and the scores equal the synchronous ones."""
    overlapped = _run(files, tmp_path / "overlap")
    sync = _run(files, tmp_path / "sync", fid_overlap=False)
    assert [r["iter"] for r in overlapped] == [r["iter"] for r in sync] == [2, 4]
    assert all(np.isfinite(r["fid"]) and r["fid"] > 0 for r in overlapped)
    np.testing.assert_allclose([r["fid"] for r in overlapped], [r["fid"] for r in sync],
                               rtol=0, atol=0)
    # the snapshots differ: the student trained between them
    assert overlapped[0]["fid"] != overlapped[1]["fid"]


def test_train_cli_runs_the_in_loop_fid_with_real_stats(files, tmp_path):
    """``--real_stats`` with an Inception file present loads it and scores
    g_ema every ``--model_save_freq`` iterations; without the file the FID
    is skipped, as in the JAX CLI."""
    stats = str(tmp_path / "real.pkl")
    calc_inception.main([files["cache"], "--size", str(SIZE), "--batch", "4",
                         "--inception_ckpt", files["inception"], "--output", stats,
                         "--device", "cpu"])
    common = ["--path", files["cache"], "--size", str(SIZE), "--latent", str(STYLE),
              "--n_mlp", str(N_MLP), "--ckpt", files["ckpt"], "--batch_size", "4",
              "--iter", "3", "--n_sample", "4", "--val_sample_freq", "100",
              "--model_save_freq", "2", "--fid_n_sample", "8", "--fid_batch", "4",
              "--real_stats", stats, "--device", "cpu"]
    for label, inception in (("with", files["inception"]), ("without", "absent.pth")):
        root = tmp_path / label
        train_main([*common, "--inception_ckpt", inception, "--exp_root", str(root)])
        (exp,) = [p for p in root.iterdir() if p.name.startswith("Exp_")]
        recs = _fid_records(exp)
        if label == "with":
            assert [r["iter"] for r in recs] == [2] and np.isfinite(recs[0]["fid"])
        else:
            assert recs == []
        assert (exp / "ckpt" / "000002.npz").exists()

"""The port's sparsity baseline (train/sparsity.py) and the generator's style
scalars against the JAX package's, on the CPU:

- ``return_style_scalars`` at 16px and 32px with W+ mixing: the scalars of
  conv1, every StyledConv and the last ToRGB, 1e-5 of each one's largest;
- ``l1_style_sparse_loss`` and ``vgg_perceptual_loss`` (raw [-1, 1] images
  into a width-0.25 VGG trunk, no LPIPS scaling): 1e-5 relative;
- ``avg_pool_to_256`` at 512 -> 256 (1e-6) and the identity at 256;
- both mask modes on the two packages' l1-style scores (exact where the
  scores' gap at a cut exceeds their tolerance), Layer_Uniform's 256px base,
  and Global_Number's strict ``>``, which removes every score tied with the
  threshold;
- a 3-iteration ``SparsityTrainer`` run against JAX's ``run_sparsity`` with
  a teacher (KD-L1 Intermediate and the VGG percept term of a width-0.25
  LPIPS) and a prune event at iteration 2 (Global_Number, l1-style on the
  500 latents JAX drew): every metric to 1e-4 relative (1e-5 absolute),
  every parameter of g, g_ema and D to 1e-4 of its tensor's largest value,
  the new net_shape and the FLOPs % exactly. JAX's draws are rebuilt from
  its keys at each step, after the splits ``run_sparsity`` takes for the
  sample latents and grid.
"""

import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from jax import random
from PIL import Image

from content_aware_gan_compression_tpu.models import (
    GeneratorConfig as JaxGeneratorConfig, generator_apply)
from content_aware_gan_compression_tpu.pruning import get_network_score_list as jax_scores
from content_aware_gan_compression_tpu.train import TrainConfig as JaxTrainConfig
from content_aware_gan_compression_tpu.train import sparsity as jax_sparsity
from content_aware_gan_compression_tpu.utils.logging import ExperimentLogger as JaxLogger
from content_aware_gan_compression_torch.models import default_net_shape
from content_aware_gan_compression_torch.pruning import (
    get_network_score_list, get_uniform_remove_list)
from content_aware_gan_compression_torch.train import TrainConfig
from content_aware_gan_compression_torch.train import sparsity
from content_aware_gan_compression_torch.utils import (
    build_generator_from_state_dict, build_lpips_from_state_dict, state_dict_from_jax)
from torch_eval_util import generator_tree, lpips_tree
from torch_prune_util import assert_masks_match
from torch_train_util import (
    G_CFG, STYLE, N_MLP, T_CFG, aux_trees, d_draws, g_draws, g_reg_draws, jax_params,
    train_kw, write_checkpoints)
from torch_train_util import torch_threads  # noqa: F401

RTOL, ATOL = 1e-4, 1e-5
SCORE_RTOL = 1e-5


@pytest.mark.parametrize("size,net_shape", [(16, (16, 12, 12, 8, 8, 6)),
                                            (32, (16, 16, 12, 12, 10, 8, 8, 6))])
def test_style_scalars_match_jax(size, net_shape):
    cfg = JaxGeneratorConfig(size=size, style_dim=STYLE, n_mlp=N_MLP, net_shape=net_shape)
    tree = generator_tree(3, cfg)
    g = build_generator_from_state_dict(tree, size, STYLE, N_MLP, device="cpu")
    rng = np.random.RandomState(size)
    zs = [rng.randn(3, STYLE).astype(np.float32) for _ in range(2)]
    noise = [rng.randn(3, 2 ** ((i + 5) // 2), 2 ** ((i + 5) // 2), 1).astype(np.float32)
             for i in range(cfg.num_layers)]
    jax_fn = jax.jit(lambda p, z, n, i: generator_apply(  # one trace for both indices
        p, cfg, z, inject_index=i, noise=n, return_style_scalars=True))
    for index in (2, cfg.n_latent - 1):
        img_j, styles_j = jax_fn(tree, [jnp.asarray(z) for z in zs],
                                 [jnp.asarray(n) for n in noise], jnp.asarray(index))
        with torch.no_grad():
            img, styles = g([torch.from_numpy(z) for z in zs], inject_index=torch.tensor(index),
                            noise=[torch.from_numpy(n) for n in noise],
                            return_style_scalars=True)
        # conv1, every StyledConv, the last ToRGB
        assert len(styles) == len(styles_j) == len(net_shape)
        for s, sj in zip(styles, styles_j):
            sj = np.asarray(sj)
            np.testing.assert_allclose(s.numpy(), sj, rtol=0,
                                       atol=SCORE_RTOL * np.abs(sj).max())
        np.testing.assert_allclose(img.numpy(), np.asarray(img_j), rtol=0, atol=1e-4)
    # with the rgb list, as the sparse step takes them
    with torch.no_grad():
        rgbs, styles2 = g([torch.from_numpy(zs[0])], noise=[torch.from_numpy(n) for n in noise],
                          return_rgb_list=True, return_style_scalars=True)
    assert len(rgbs) == cfg.log_size - 1 and len(styles2) == len(net_shape)


def test_losses_match_jax():
    rng = np.random.RandomState(0)
    styles = [rng.randn(4, c).astype(np.float32) for c in (16, 12, 8)]
    want = float(jax_sparsity.l1_style_sparse_loss([jnp.asarray(s) for s in styles], 1e-3))
    got = float(sparsity.l1_style_sparse_loss([torch.from_numpy(s) for s in styles], 1e-3))
    np.testing.assert_allclose(got, want, rtol=1e-5)

    tree = lpips_tree()
    lpips = build_lpips_from_state_dict(tree, device="cpu")
    a, b = (np.tanh(rng.randn(2, 3, 32, 32)).astype(np.float32) for _ in range(2))
    want = float(jax.jit(jax_sparsity.vgg_perceptual_loss)(tree, a, b))
    with torch.no_grad():
        got = float(sparsity.vgg_perceptual_loss(lpips, torch.from_numpy(a), torch.from_numpy(b)))
        got_nhwc = float(sparsity.vgg_perceptual_loss(
            lpips, torch.from_numpy(a).permute(0, 2, 3, 1), torch.from_numpy(b).permute(0, 2, 3, 1),
            "NHWC"))
        # not LPIPS: the trunk sees the raw images
        scaled = lpips(torch.from_numpy(a), torch.from_numpy(b)).mean().item()
    np.testing.assert_allclose([got, got_nhwc], [want, want], rtol=1e-5)
    assert got > 0 and abs(got - scaled) > 1e-3 * got


def test_avg_pool_to_256_matches_jax():
    x = np.random.RandomState(1).randn(2, 3, 512, 512).astype(np.float32)
    want = np.asarray(jax_sparsity._avg_pool_to_256(jnp.asarray(x), 512))
    got = sparsity.avg_pool_to_256(torch.from_numpy(x).permute(0, 2, 3, 1), 512)
    assert got.shape == (2, 256, 256, 3)
    np.testing.assert_allclose(got.permute(0, 3, 1, 2).numpy(), want, rtol=0, atol=1e-6)
    y = torch.randn(1, 256, 256, 3)
    assert sparsity.avg_pool_to_256(y, 256) is y


@functools.cache
def _scores(size=16, net_shape=(16, 16, 12, 12, 8, 8)):
    """Both packages' l1-style scores of one generator, computed once for the
    two mask tests (which only read them)."""
    cfg = JaxGeneratorConfig(size=size, style_dim=STYLE, n_mlp=N_MLP, net_shape=net_shape)
    tree = generator_tree(1, cfg)
    g = build_generator_from_state_dict(tree, size, STYLE, N_MLP, device="cpu")
    z = np.random.RandomState(2).randn(64, STYLE).astype(np.float32)
    got = get_network_score_list(g, torch.from_numpy(z), "l1-style")
    want = jax_scores(tree, cfg, jnp.asarray(z), "l1-style")
    return got, want, list(net_shape)


def test_layer_uniform_masks_match_jax():
    got_s, want_s, net_shape = _scores()
    kw = dict(pruning_mode="Layer_Uniform", lay_rmve_ratio=0.3, num_rmve_channel=0)
    got = sparsity.get_network_prune_mask(got_s, net_shape, full_shape_256=net_shape, **kw)
    want = jax_sparsity.get_network_prune_mask(want_s, net_shape, full_shape_256=net_shape, **kw)
    assert_masks_match(got, want, want_s, get_uniform_remove_list(net_shape, 0.3), SCORE_RTOL)
    assert [int(m.sum()) for m in got] == [c - int(0.3 * c) for c in net_shape]
    # at 256px the remove counts come from the full 256px shape, whatever the
    # model's own widths: a pruned 256px model loses int(c_full * ratio) more
    pruned = [c // 2 for c in default_net_shape(256)]
    scores = [np.random.RandomState(i).rand(c).astype(np.float32) for i, c in enumerate(pruned)]
    got = sparsity.get_network_prune_mask(scores, pruned, **kw)
    want = jax_sparsity.get_network_prune_mask(scores, pruned, **kw)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert [int((~m).sum()) for m in got] == [int(0.3 * c) for c in default_net_shape(256)]


def test_global_number_masks_match_jax():
    got_s, want_s, net_shape = _scores()
    kw = dict(pruning_mode="Global_Number", lay_rmve_ratio=0.1)
    for n in (5, 17.0):
        got = sparsity.get_network_prune_mask(got_s, net_shape, num_rmve_channel=n, **kw)
        want = jax_sparsity.get_network_prune_mask(want_s, net_shape, num_rmve_channel=n, **kw)
        flat = np.sort(np.concatenate([np.asarray(s, np.float64) for s in want_s]))
        tol = SCORE_RTOL * flat.max()
        thres = flat[int(n)]
        assert flat[int(n) + 1] - thres > tol and thres - flat[int(n) - 1] > tol
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        # the strict '>' removes one more than asked when the scores differ
        assert sum(int((~m).sum()) for m in got) == int(n) + 1
    # a tie at the threshold: every tied score goes
    tied = [np.array([0.1, 0.2, 0.2], np.float32), np.array([0.2, 0.5], np.float32)]
    got = sparsity.get_network_prune_mask(tied, [3, 2], num_rmve_channel=1, **kw)
    want = jax_sparsity.get_network_prune_mask(tied, [3, 2], num_rmve_channel=1, **kw)
    assert [m.tolist() for m in got] == [m.tolist() for m in want] == [
        [False, False, False], [False, True]]
    with pytest.raises(ValueError):
        sparsity.get_network_prune_mask(tied, [3, 2], pruning_mode="Uniform",
                                        lay_rmve_ratio=0.1, num_rmve_channel=1)


# -- the trainer ---------------------------------------------------------------

N_ITERS = 3
OPTS = dict(sparsity_eta=1e-2, model_prune_freq=2, num_rmve_channel=9,
            pruning_mode="Global_Number", prune_metric="l1-style", kd_percept_mode="VGG")


def sparsity_draws(jax_trainer, iter_idx):
    """The draws JAX's Trainer.step takes at ``iter_idx`` when the fused D+G
    step is off, as in the sparsity trainer: d and g take their keys as
    they are."""
    cfg, g_cfg = jax_trainer.cfg, jax_trainer.g_config
    _, k_d, k_g, k_greg = random.split(jax_trainer.rng, 4)
    draws = {"d": d_draws(k_d, cfg, g_cfg), "g": g_draws(k_g, cfg, g_cfg, T_CFG)}
    if iter_idx % cfg.g_reg_freq == 0:
        draws["g_reg"] = g_reg_draws(k_greg, cfg, g_cfg)
    return draws


@pytest.fixture(scope="module")
def jax_sparsity_run(tmp_path_factory):
    """JAX's run_sparsity for N_ITERS iterations from seeded checkpoints and
    a folder of images, with each step's batch, draws and metrics and the
    prune event's latents and result recorded."""
    d = tmp_path_factory.mktemp("jax_sparsity")
    student, teacher = write_checkpoints(d, jax_params())
    data = d / "images"
    data.mkdir()
    rng = np.random.RandomState(0)
    for i in range(8):
        Image.fromarray((rng.rand(G_CFG.size, G_CFG.size, 3) * 255).astype(np.uint8)).save(
            data / f"{i}.png")
    kw = train_kw(ckpt=student, teacher=teacher, data_folder=str(data), kd_l1_lambda=1.0,
                  kd_lpips_lambda=3.0, kd_mode="Intermediate", d_reg_freq=16, g_reg_freq=2,
                  val_sample_num=4, val_sample_freq=1000, model_save_freq=10000)
    lp_tree, _ = aux_trees()
    jt = jax_sparsity.SparsityTrainer(JaxTrainConfig(**kw, n_devices=1, steps_per_dispatch=1),
                                      OPTS, lpips_params=lp_tree, exp_root=str(d))
    rec = {"batches": [], "draws": [], "metrics": []}
    step, prune = jt.step, jt.prune_in_training

    def recording_step(it, real, mpl):
        rec["batches"].append(np.asarray(real).transpose(0, 2, 3, 1))  # NCHW floats -> NHWC
        rec["draws"].append(sparsity_draws(jt, it))
        m, mpl = step(it, real, mpl)
        rec["metrics"].append({k: float(v) for k, v in m.items()})
        rec["mpl"] = float(mpl)
        return m, mpl

    def recording_prune(key):
        rec["prune_z"] = np.asarray(random.normal(key, (sparsity.PRUNE_SAMPLES, STYLE)))
        rec["prune"] = prune(key)
        return rec["prune"]

    jt.step, jt.prune_in_training = recording_step, recording_prune
    jt.run_sparsity(max_iters=N_ITERS, logger=JaxLogger(str(d), name="jax"))
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    rec.update(kw=kw, lp_tree=lp_tree, g=to_np(jt.g_params), g_ema=to_np(jt.g_ema_params),
               d=to_np(jt.d_params), net_shape=tuple(jt.g_config.net_shape))
    return rec


def _params_close(module, tree, what):
    want = state_dict_from_jax(tree)
    got = module.state_dict()
    assert set(got) == set(want), what
    for name, w in want.items():
        scale = float(w.abs().max()) or 1.0
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=0, atol=RTOL * scale,
                                   err_msg=f"{what} {name}")


def test_sparsity_trajectory_matches_jax(jax_sparsity_run):
    """Iterations 0-2 of the sparse objective (D, R1 at 0, the sparse G step
    with KD-L1 Intermediate and the VGG term, path length at 0 and 2, EMA),
    then the prune event: the same new net_shape and FLOPs %, and the cut
    g, g_ema and D; the optimizers start again from scratch."""
    r = jax_sparsity_run
    lp_tree = r["lp_tree"]
    pt = sparsity.SparsityTrainer(TrainConfig(**r["kw"]), OPTS, device="cpu",
                                  lpips_params=lp_tree)
    assert pt.lpips is not None and pt.parser is None
    mpl = torch.zeros(())
    for it in range(N_ITERS):
        m, mpl = pt.step(it, torch.from_numpy(r["batches"][it]), mpl, draws=r["draws"][it])
        got = {k: float(v) for k, v in m.items()}
        want = r["metrics"][it]
        assert set(got) == set(want), it
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL,
                                       err_msg=f"iteration {it} {k}")
        assert got["sparse"] > 0 and got["kd_percept_loss"] > 0 and got["kd_l1_loss"] > 0
    np.testing.assert_allclose(float(mpl), r["mpl"], rtol=RTOL)
    old_opt = pt.g_opt
    new_shape, flops_pct = pt.prune_in_training(z=torch.from_numpy(np.array(r["prune_z"])))
    want_shape, want_pct = r["prune"]
    assert tuple(new_shape) == tuple(want_shape) == r["net_shape"]
    assert flops_pct == want_pct
    assert sum(G_CFG.net_shape) - sum(new_shape) >= OPTS["num_rmve_channel"] + 1
    for module, key in ((pt.g, "g"), (pt.g_ema, "g_ema"), (pt.d, "d")):
        _params_close(module, r[key], key)
    assert pt.g_opt is not old_opt and pt.g_opt.param_groups[0]["step"] == 0
    assert not any(p.requires_grad for p in pt.g_ema.parameters())

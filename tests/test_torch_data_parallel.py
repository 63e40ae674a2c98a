"""The port's data parallel (``parallel``) on the CPU, 2 and 4 gloo ranks
spawned by ``torch_dp_util.spawn``, at a tiny size (torch_train_util.py),
global batch 8:

- the Trainer's 5-iteration trajectory (R1 at 0, path length at 0, 2 and 4)
  on 2 ranks, each drawing the global batch from the seeded stream and
  keeping its rows, against one process on the same stream, which
  test_torch_trainer.py holds to the JAX Trainer (and the JAX package holds
  its 2-device mesh equal to one device: tests/test_train.py,
  tests/test_mesh_training.py), at test_torch_trainer.py's tolerance (1e-4
  relative, 1e-5 absolute), metric for metric and in every weight; the
  ranks' weights bit-equal;
- the minibatch stddev through ``gather_rows`` (2 ranks, groups 4 and 8;
  4 ranks, group 4: a rank's rows fewer than the group) against one process
  on the whole batch, forward and R1's parameter gradient (second order
  through the gather), in float64 parameters; the 2-rank checks share one
  spawn;
- the path-length step's parameter gradient on 2 ranks against one process
  on the same global draws (the cross term of ``global_mean``), in float64
  parameters.

The float64 checks hold at 1e-6 of the largest value: the stddev and the
path lengths are computed in float32 inside the float64 networks. A
per-rank stddev or path mean moves the same numbers by far more, which the
tests check as well, so that the bound has teeth.
"""

import numpy as np
import pytest
import torch

from content_aware_gan_compression_torch.models import (
    Discriminator, DiscriminatorConfig, Generator, GeneratorConfig)
from content_aware_gan_compression_torch.models.stylegan2 import minibatch_stddev
from torch_dp_util import coupled_terms_and_trainer, r1_and_path_grads, run_trainer, spawn
from torch_train_util import (
    D_CHANNEL_MAX, G_CFG, N_MLP, SIZE, STYLE, train_kw, write_checkpoints)
from torch_train_util import torch_threads  # noqa: F401

N_ITERS = 5
GLOBAL_BATCH = 8
RTOL, ATOL = 1e-4, 1e-5
CADENCE = dict(d_reg_freq=4, g_reg_freq=2)  # test_torch_trainer.py's window
F64_TOL = 1e-6  # of the largest value: float32 stddev and path lengths inside


def reals(n, seed=3, size=SIZE):
    return (np.random.RandomState(seed).rand(n, GLOBAL_BATCH, size, size, 3) * 255).astype(
        np.uint8)


@pytest.fixture(scope="module")
def one_process(tmp_path_factory):
    """The port's Trainer in one process for N_ITERS iterations on its own
    seeded draws, from the JAX package's checkpoints."""
    d = tmp_path_factory.mktemp("dp")
    student, teacher = write_checkpoints(d)
    kw = train_kw(ckpt=student, teacher=teacher, batch_size=GLOBAL_BATCH, **CADENCE)
    batches = reals(N_ITERS)
    return dict(kw=kw, batches=batches, one=run_trainer(kw, batches))


def test_two_ranks_follow_the_jax_mesh_trajectory(one_process, two_ranks):
    """Iterations 0-4 on 2 ranks: D, R1 at 0, G with KD-L1, path length at
    0, 2 and 4, and EMA, the metrics averaged over ranks against one
    process's (the trajectory test_torch_trainer.py holds to the JAX
    Trainer), metric for metric; the ranks end with bit-equal weights,
    within 1e-4 of each tensor's largest value of one process's.

    The name is that of the check this replaced, against the JAX Trainer
    on a 2-device mesh; it now holds 2 ranks against one process of the
    port on the same seeded stream. Measured on the CPU: the metrics
    1.3e-5 relative (9.5e-7 absolute) and the weights 9.7e-7 of a tensor's
    largest value apart."""
    one = one_process["one"]
    ranks = [r["trainer"] for r in two_ranks]
    for it in range(N_ITERS):
        got, want = ranks[0]["metrics"][it], one["metrics"][it]
        assert set(got) == set(want), it
        assert ("r1" in want) == (it % 4 == 0) and ("path" in want) == (it % 2 == 0), it
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL,
                                       err_msg=f"iteration {it} {k}")
        assert ranks[1]["metrics"][it] == got
    np.testing.assert_allclose(ranks[0]["mpl"], one["mpl"], rtol=RTOL)
    for net in ("g", "d", "g_ema"):
        for k, v in ranks[0][net].items():
            assert torch.equal(v, ranks[1][net][k]), f"{net} {k}"
            want = one[net][k]
            scale = max(float(want.abs().max()), 1e-12)
            assert float((v - want).abs().max()) <= RTOL * scale, f"{net} {k} vs one process"


# -- the coupled terms, float64 parameters --------------------------------------

D16 = DiscriminatorConfig(size=SIZE, channel_max=D_CHANNEL_MAX)
G16 = GeneratorConfig(size=SIZE, style_dim=STYLE, n_mlp=N_MLP, net_shape=G_CFG.net_shape)
KW64 = train_kw(batch_size=GLOBAL_BATCH, path_reg_batch_shrink=1)


def _f64_inputs():
    """(D state, real batch, G state, path-length draws), float64, from
    seeds; the path batch is the global batch of 8."""
    d = Discriminator(D16, device="cpu", generator=torch.Generator().manual_seed(2)).double()
    g = Generator(G16, device="cpu", generator=torch.Generator().manual_seed(0)).double()
    rng = np.random.RandomState(4)
    real = torch.from_numpy(rng.uniform(-1, 1, (GLOBAL_BATCH, SIZE, SIZE, 3)))
    z = [torch.from_numpy(rng.randn(GLOBAL_BATCH, STYLE)) for _ in range(2)]
    noise = [torch.from_numpy(rng.randn(*n.shape)) for n in g.make_noise(GLOBAL_BATCH)]
    # the second half's path lengths 4x the first's, so that a per-half path
    # mean is far from the global one
    ppl_noise = rng.randn(GLOBAL_BATCH, SIZE, SIZE, 3)
    ppl_noise[GLOBAL_BATCH // 2:] *= 4
    draws = {"z": z, "inject_index": torch.tensor(3), "noise": noise,
             "ppl_noise": torch.from_numpy(ppl_noise)}
    return d.state_dict(), real, g.state_dict(), draws


def _close(got, want, what, tol=F64_TOL):
    scale = max(float(want.abs().max()), 1e-30)
    err = float((got - want).abs().max()) / scale
    assert err <= tol, f"{what}: {err:.3g} of the largest value"
    return err


def _grad_dist(a, b):
    """Largest |a - b| over every tensor, over the largest |b|."""
    scale = max(float(v.abs().max()) for v in b.values())
    return max(float((a[k] - b[k]).abs().max()) for k in b) / scale


@pytest.fixture(scope="module")
def f64_case():
    d_state, real, g_state, draws = _f64_inputs()
    one = r1_and_path_grads(d_state, D16, real, g_state, G16, KW64, draws)
    # the terms as plain DDP would compute them: each half of the batch with
    # its own stddev and path mean, the gradients averaged
    halves = [r1_and_path_grads(
        d_state, D16, real[h * 4:(h + 1) * 4], g_state, G16, {**KW64, "batch_size": 4},
        {k: v if k == "inject_index" else
         [t[h * 4:(h + 1) * 4] for t in v] if isinstance(v, list) else v[h * 4:(h + 1) * 4]
         for k, v in draws.items()}) for h in range(2)]
    per_rank = {key: {k: (halves[0][key][k] + halves[1][key][k]) / 2 for k in one[key]}
                for key in ("d_grads", "g_grads")}
    return dict(inputs_kw=(d_state, D16, real, g_state, G16, KW64, draws), one=one,
                per_rank=per_rank)


STDDEV_X = np.random.RandomState(5).randn(GLOBAL_BATCH, 4, 4, 8)
STDDEV_GROUPS = (4, 8)


@pytest.fixture(scope="module")
def two_ranks(f64_case, one_process, tmp_path_factory):
    """One 2-rank spawn for every 2-rank check: the float64 R1 and
    path-length gradients, ``minibatch_stddev`` on the ranks' rows of
    STDDEV_X at each of STDDEV_GROUPS, and the Trainer's trajectory on
    one_process's batches (under ``"trainer"``)."""
    return spawn(coupled_terms_and_trainer, 2, tmp_path_factory.mktemp("two_ranks"),
                 (f64_case["inputs_kw"], torch.from_numpy(STDDEV_X), STDDEV_GROUPS),
                 (one_process["kw"], one_process["batches"]))


@pytest.mark.parametrize("world", [2, 4])
def test_stddev_r1_and_path_length_match_one_process(f64_case, two_ranks, world, tmp_path):
    """D's scores (the stddev over the global batch), R1's gradient of D's
    parameters and the path-length step's gradient of G's, on ``world``
    ranks (4 or 2 rows each, the stddev group 4) against one process on
    the whole batch; every rank holds the same all-reduced gradients. A
    per-rank stddev and path mean are far off."""
    one = f64_case["one"]
    ranks = two_ranks if world == 2 else spawn(r1_and_path_grads, world, tmp_path,
                                               *f64_case["inputs_kw"])
    _close(torch.cat([r["scores"] for r in ranks]), one["scores"], "scores")
    for key in ("d_grads", "g_grads"):
        err = _grad_dist(ranks[0][key], one[key])
        assert err <= F64_TOL, f"{key}: {err:.3g}"
        for r in ranks[1:]:
            assert all(torch.equal(r[key][k], ranks[0][key][k]) for k in one[key]), key
        if world == 2:
            assert _grad_dist(f64_case["per_rank"][key], one[key]) > 100 * F64_TOL, key


@pytest.mark.parametrize("group", STDDEV_GROUPS)
def test_minibatch_stddev_groups_across_ranks(two_ranks, group):
    """``minibatch_stddev`` on 2 ranks' rows equals the one-process function
    on the whole batch, row for row, at a group of 4 (stride 2: every group
    spans both ranks) and of 8 (one group, larger than a rank's rows)."""
    x = torch.from_numpy(STDDEV_X)
    want = minibatch_stddev(x, group, 1)
    assert torch.equal(torch.cat([r["stddev"][group] for r in two_ranks]), want)
    local = torch.cat([minibatch_stddev(x[:4], group, 1), minibatch_stddev(x[4:], group, 1)])
    assert not torch.allclose(local, want)

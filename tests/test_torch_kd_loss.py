"""The content-aware KD objective of the port against the JAX package's, on
the CPU: the resizes, the parse and mask helpers (pruning/content_aware.py)
and ``kd_loss`` with the mask and LPIPS (train/losses.py).

Tolerances:
  * bilinear resizes 1e-6 absolute on values in [-1, 1] (the same two-tap
    weights, applied in another order);
  * class maps equal except where JAX's top-2 logit gap is below 1e-4 of
    the largest logit (an argmax tie either way is right); masks equal;
  * ``kd_loss``, both sides given the same parse, 1e-5 relative, and its
    gradient in the student image 1e-4 of its largest value. In the case
    that resizes 64 -> 256 for LPIPS, JAX's own fp32 gradient departs from
    float64 at the image's edge rows by more than that, so there the
    port's is held against its own float64 run, within 5e-4: the 4x
    upsample spreads each masked pixel into a shallow dip, whose max-pool
    windows hold near-ties that fp32 rounds either way.

The parse given to ``kd_loss`` masks isolated pixels (background and cloth
in a sparse lattice), so that the mask leaves no constant region: in one,
VGG's max-pools meet exact ties, and which element of a window takes the
gradient depends on the last bit of each convolution (see
test_torch_train_steps.py).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from content_aware_gan_compression_tpu.models import bisenet as jb
from content_aware_gan_compression_tpu.models import lpips as jl
from content_aware_gan_compression_tpu.pruning import content_aware as jca
from content_aware_gan_compression_tpu.train.losses import kd_loss as jax_kd_loss
from content_aware_gan_compression_torch import pruning
from content_aware_gan_compression_torch.models import make_parse_fn
from content_aware_gan_compression_torch.train import kd_loss
from content_aware_gan_compression_torch.utils import (
    build_bisenet_from_state_dict, build_lpips_from_state_dict)
from torch_train_util import PARSER_SEED, bisenet_tree
from torch_train_util import torch_threads  # noqa: F401


def _images(n, size, seed, nhwc=True):
    rng = np.random.RandomState(seed)
    shape = (n, size, size, 3) if nhwc else (n, 3, size, size)
    return np.tanh(rng.randn(*shape)).astype(np.float32)


@pytest.mark.parametrize("src,dst", [(256, 512), (512, 256), (64, 512), (512, 64)])
@pytest.mark.parametrize("data_format", ["NCHW", "NHWC"])
def test_bilinear_resize_matches_jax_image_resize(src, dst, data_format):
    """F.interpolate(bilinear, align_corners=False, antialias=False) against
    jax.image.resize(bilinear, antialias=False) at the sizes the objective
    uses, both ways, edges included."""
    x = _images(2, src, src + dst, nhwc=data_format == "NHWC")
    out_shape = ((2, dst, dst, 3) if data_format == "NHWC" else (2, 3, dst, dst))
    want = np.asarray(jax.image.resize(x, out_shape, method="bilinear", antialias=False))
    got = pruning.bilinear_resize(torch.from_numpy(x), dst, dst, data_format).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("data_format", ["NCHW", "NHWC"])
def test_parse_and_mask_match_jax(data_format):
    nhwc = data_format == "NHWC"
    img = _images(2, 32, 11, nhwc=nhwc)
    tree = bisenet_tree(0.25, seed=PARSER_SEED)
    net = build_bisenet_from_state_dict(tree, device="cpu")
    norm_j = (jca.normalize_for_parsing_nhwc if nhwc else jca.normalize_for_parsing)(img)
    norm = pruning.normalize_for_parsing(torch.from_numpy(img), data_format)
    np.testing.assert_allclose(norm.numpy(), np.asarray(norm_j), rtol=0, atol=1e-5)

    apply = jb.bisenet_apply_nhwc if nhwc else jb.bisenet_apply
    logits = np.asarray(jax.jit(lambda p, x: apply(p, x)[0])(tree, norm_j))
    logits = np.moveaxis(logits, 1, -1) if not nhwc else logits
    want = np.argmax(logits, axis=-1)
    got = pruning.batch_img_parsing(torch.from_numpy(img), make_parse_fn(net, data_format),
                                    data_format).numpy()
    top2 = np.sort(logits, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 1e-4 * np.abs(logits).max()
    assert clear.mean() > 0.99
    np.testing.assert_array_equal(got[clear], want[clear])

    coi = pruning.coi_mask_from_parsing(torch.from_numpy(want))
    np.testing.assert_array_equal(coi.numpy(), np.asarray(jca.coi_mask_from_parsing(want)))
    share = float(coi.float().mean())
    assert 0.0 < share < 1.0, share
    mask_j = (jca.get_masked_tensor_nhwc if nhwc else jca.get_masked_tensor)(img, want)
    masked = pruning.get_masked_tensor(torch.from_numpy(img), torch.from_numpy(want),
                                       data_format)
    np.testing.assert_array_equal(masked.numpy(), np.asarray(mask_j))
    assert 0.0 < float((masked == 0).float().mean()) < 1.0


def _fixed_parse_jax(class_map, nhwc):
    """A parse_fn whose logits are one-hot in ``class_map``: each package
    masks with the same classes."""
    one_hot = jax.nn.one_hot(class_map, 19)
    return lambda x: one_hot if nhwc else jnp.moveaxis(one_hot, -1, 1)


def _fixed_parse(class_map, nhwc):
    one_hot = torch.nn.functional.one_hot(class_map, 19).float()
    return lambda x: one_hot if nhwc else one_hot.permute(0, 3, 1, 2)


def _lattice_class_map(size):
    """Random face classes at 512, with background (0) or cloth (16) on the
    512px blocks of every third image pixel in each direction: the mask at
    ``size`` drops isolated pixels only."""
    rng = np.random.RandomState(23)
    classes = rng.choice([c for c in range(1, 19) if c != 16], (2, 512, 512))
    block = 512 // size
    lattice = np.zeros((size, size), bool)
    lattice[::3, ::3] = True
    cells = np.kron(lattice, np.ones((block, block), bool))
    classes[:, cells] = rng.choice([0, 16], (2, int(cells.sum())))
    return torch.from_numpy(classes)


# (kd_mode, masked, lpips_image_size, data_format) as tests/test_loss_parity.py:131-135
KD_CASES = [("Output_Only", True, 256, "NHWC"), ("Output_Only", True, 32, "NHWC"),
            ("Output_Only", False, 256, "NHWC"), ("Intermediate", True, 256, "NHWC"),
            ("Output_Only", True, 256, "NCHW")]


@pytest.mark.parametrize("kd_mode,masked,lpips_image_size,data_format", KD_CASES)
def test_kd_loss_matches_jax(kd_mode, masked, lpips_image_size, data_format):
    """Masked; masked with the downsample (size > lpips_image_size); unmasked;
    Intermediate, whose rgb-list L1 is unmasked and whose LPIPS sees the
    unmasked teacher; and the NCHW layout."""
    nhwc = data_format == "NHWC"
    size = 64
    fake, teacher = _images(2, size, 21, nhwc), _images(2, size, 22, nhwc)
    half = (fake[:, ::2, ::2] if nhwc else fake[:, :, ::2, ::2]).copy()
    half_t = (teacher[:, ::2, ::2] if nhwc else teacher[:, :, ::2, ::2]).copy()
    lp_tree = jax.tree_util.tree_map(np.asarray, jl.lpips_init(jax.random.PRNGKey(5),
                                                               width_scale=0.25))
    teacher_t = torch.from_numpy(teacher)
    class_map = _lattice_class_map(size)
    kw = dict(kd_l1_lambda=3.0, kd_lpips_lambda=3.0, kd_mode=kd_mode, size=size,
              lpips_image_size=lpips_image_size, data_format=data_format)

    def jax_loss(x):
        l1, lp = jax_kd_loss(x, [jnp.asarray(half), x], [jnp.asarray(half_t), teacher],
                             lpips_params=lp_tree,
                             parse_fn=(_fixed_parse_jax(jnp.asarray(class_map.numpy()), nhwc)
                                       if masked else None), **kw)
        return l1 + lp, (l1, lp)

    (_, (want_l1, want_lp)), want_grad = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(
        fake)
    lpips = build_lpips_from_state_dict(lp_tree, device="cpu").requires_grad_(False)
    x = torch.from_numpy(fake).requires_grad_(True)
    l1, lp = kd_loss(x, [torch.from_numpy(half), x],
                     [torch.from_numpy(half_t), teacher_t], lpips=lpips,
                     parse_fn=_fixed_parse(class_map, nhwc) if masked else None, **kw)
    (l1 + lp).backward()
    l1, lp = float(l1.detach()), float(lp.detach())
    np.testing.assert_allclose(l1, float(want_l1), rtol=1e-5)
    np.testing.assert_allclose(lp, float(want_lp), rtol=1e-5)
    assert l1 > 0 and lp > 0
    want_grad = np.asarray(want_grad)
    if lpips_image_size < size:
        x64 = torch.from_numpy(fake).double().requires_grad_(True)
        sum(kd_loss(x64, [torch.from_numpy(half).double(), x64],
                    [torch.from_numpy(half_t).double(), teacher_t.double()],
                    lpips=lpips.double(), parse_fn=_fixed_parse(class_map, nhwc), **kw)).backward()
        want_grad = x64.grad.numpy()
    tol = 5e-4 if lpips_image_size < size else 1e-4
    np.testing.assert_allclose(x.grad.numpy(), want_grad, rtol=0,
                               atol=tol * float(np.abs(want_grad).max()))
    if masked and kd_mode == "Output_Only":
        # the mask zeroes the student's gradient outside the content of
        # interest: one pixel in 9
        dropped = float((x.grad == 0).all(dim=-1 if nhwc else 1).float().mean())
        assert abs(dropped - 1 / 9) < 0.01, dropped

"""The port's BiSeNet (models/bisenet.py) against the JAX package's, on the
CPU. The same ``bisenet_init`` tree, with its batch-norm statistics drawn at
random so that the folded scale and shift are not the identity, goes
through ``bisenet_apply``/``bisenet_apply_nhwc``, jitted, and
``BiSeNet.forward``.

Tolerance: each head's logits within 1e-4 of their largest magnitude (fp32
convolutions and the align-corners resize in another order).
"""

import numpy as np
import pytest
import jax
import torch

from content_aware_gan_compression_tpu.models import bisenet as jb
from content_aware_gan_compression_torch.models import (
    BiSeNet, bisenet_widths, load_bisenet, make_parse_fn)
from content_aware_gan_compression_torch.utils import (
    build_bisenet_from_state_dict, pytree_to_torch_state_dict)
from torch_train_util import bisenet_tree
from torch_train_util import torch_threads  # noqa: F401

TOL = 1e-4


def _close(got, want):
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * float(np.abs(want).max()))


@pytest.mark.parametrize("width_scale,size,data_format", [
    (1.0, 32, "NCHW"),   # full width, forward only
    (0.25, 64, "NHWC"),
    (0.25, 48, "NCHW"),  # sizes that are not powers of 2 in the trunk
])
def test_bisenet_heads_match_jax(width_scale, size, data_format):
    tree = bisenet_tree(width_scale)
    rng = np.random.RandomState(size)
    shape = (2, 3, size, size) if data_format == "NCHW" else (2, size, size, 3)
    x = rng.randn(*shape).astype(np.float32)
    apply = jb.bisenet_apply if data_format == "NCHW" else jb.bisenet_apply_nhwc
    want = jax.jit(apply)(tree, x)
    net = build_bisenet_from_state_dict(tree, device="cpu")
    with torch.no_grad():
        got = net(torch.from_numpy(x), data_format=data_format)
        head0 = net(torch.from_numpy(x), data_format=data_format, heads=1)
        parse = make_parse_fn(net, data_format)(torch.from_numpy(x))
    assert len(got) == 3 and len(head0) == 1
    for g, w in zip(got, want):
        _close(g.numpy(), w)
    torch.testing.assert_close(head0[0], got[0], rtol=0, atol=0)
    torch.testing.assert_close(parse, got[0], rtol=0, atol=0)


def test_seeded_init_mirrors_bisenet_init():
    """Widths scale as bisenet_init's; keys are its tree's paths; convs are
    He-normal and batch norms start at the identity."""
    tree = jax.eval_shape(lambda key: jb.bisenet_init(key, width_scale=0.5),
                          jax.random.PRNGKey(0))  # shapes only: no weights drawn
    want = {k: tuple(v.shape) for k, v in pytree_to_torch_state_dict(tree).items()}
    net = BiSeNet(bisenet_widths(0.5), device="cpu", generator=torch.Generator().manual_seed(0))
    sd = net.state_dict()
    assert {k: tuple(v.shape) for k, v in sd.items()} == want
    w = sd["cp.resnet.layer3.0.conv1.weight"]
    assert abs(float(w.std()) * np.sqrt(w[0].numel() / 2.0) - 1.0) < 0.1
    torch.testing.assert_close(sd["ffm.convblk.bn.running_var"], torch.ones(128))
    assert bisenet_widths(1.0) == (64, 128, 256, 512) and bisenet_widths(0.01) == (4, 4, 4, 5)


def test_load_bisenet_reads_the_reference_schema(tmp_path):
    """A seeded parser saved as 79999_iter.pth is (``num_batches_tracked``
    in every batch norm): the port and the JAX package load the same
    weights, and the port's module holds them with strict=True."""
    tree = bisenet_tree(0.25, seed=4)
    sd = {k: torch.from_numpy(np.array(v)) for k, v in pytree_to_torch_state_dict(tree).items()}
    for k in list(sd):
        if k.endswith("running_var"):
            sd[k[:-len("running_var")] + "num_batches_tracked"] = torch.tensor(79999)
    path = str(tmp_path / "79999_iter.pth")
    torch.save(sd, path)
    net = load_bisenet(path, device="cpu")
    want = pytree_to_torch_state_dict(jb.load_bisenet(path))
    got = net.state_dict()
    assert set(got) == set(want)
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(want[k]), err_msg=k)
    with pytest.raises(RuntimeError, match="num_batches_tracked"):
        BiSeNet(bisenet_widths(0.25), device="cpu").load_state_dict(sd, strict=True)

"""The port's LPIPS (models/lpips.py) against the JAX package's, on the CPU.
The same seeded numpy images and the same ``lpips_init`` tree (loaded into
the port with strict=True) go through ``lpips_apply``, jitted, and
``LPIPS.forward``.

Tolerances: the value and each layer's value 1e-5 relative (fp32 sums of up
to 512 terms in another order); the input gradient 1e-4 of its largest
value. The importers are held to the JAX importers on seeded files in
torchvision's (``features.N.*``) and the reference's (``lin{k}.model.1.weight``)
schemas.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from content_aware_gan_compression_tpu.models import lpips as jl
from content_aware_gan_compression_torch.models import (
    LPIPS, LPIPS_CHANNELS, VGG16_CONVS, import_lpips_lins, import_vgg16_features, load_lpips,
    vgg16_widths)
from content_aware_gan_compression_torch.utils import build_lpips_from_state_dict
from torch_train_util import torch_threads  # noqa: F401

RTOL = 1e-5


def _tree(width_scale, seed=0):
    return jax.tree_util.tree_map(np.asarray, jl.lpips_init(jax.random.PRNGKey(seed),
                                                            width_scale=width_scale))


def _images(shape, seed, low=-1.0):
    rng = np.random.RandomState(seed)
    return [rng.uniform(low, 1.0, shape).astype(np.float32) for _ in range(2)]


@pytest.mark.parametrize("width_scale,size,normalize,data_format", [
    (1.0, 32, False, "NCHW"),   # full width, forward only
    (0.25, 64, False, "NHWC"),
    (0.25, 48, True, "NCHW"),   # [0, 1] inputs
])
def test_lpips_matches_jax(width_scale, size, normalize, data_format):
    tree = _tree(width_scale)
    shape = (2, 3, size, size) if data_format == "NCHW" else (2, size, size, 3)
    a, b = _images(shape, size, low=0.0 if normalize else -1.0)
    want, want_layers = jax.jit(lambda p, x, y: jl.lpips_apply(
        p, x, y, normalize=normalize, ret_per_layer=True, data_format=data_format))(tree, a, b)
    net = build_lpips_from_state_dict(tree, device="cpu")
    with torch.no_grad():
        got, got_layers = net(torch.from_numpy(a), torch.from_numpy(b), normalize=normalize,
                              ret_per_layer=True, data_format=data_format)
    assert got.shape == (2, 1, 1, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)
    assert len(got_layers) == 5
    for k, (g, w) in enumerate(zip(got_layers, want_layers)):
        np.testing.assert_allclose(g.numpy().ravel(), np.asarray(w).ravel(), rtol=RTOL,
                                   err_msg=f"layer {k}")
    assert float(got.min()) > 0
    # spatial maps of 5 sizes do not sum, in either package
    with pytest.raises(RuntimeError):
        net(torch.from_numpy(a), torch.from_numpy(b), spatial=True, data_format=data_format)


def test_lpips_input_gradient_matches_jax():
    """The student's side of the KD term: d LPIPS / d in0 through the
    unit-normalize and the VGG trunk."""
    tree = _tree(0.25, seed=1)
    a, b = _images((2, 32, 32, 3), 7)

    def f(x):
        return jnp.sum(jl.lpips_apply(tree, x, jnp.asarray(b), data_format="NHWC"))

    want = np.asarray(jax.jit(jax.grad(f))(a))
    net = build_lpips_from_state_dict(tree, device="cpu").requires_grad_(False)
    x = torch.from_numpy(a).requires_grad_(True)
    net(x, torch.from_numpy(b), data_format="NHWC").sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), want, rtol=0,
                               atol=1e-4 * float(np.abs(want).max()))
    assert np.isfinite(want).all() and float(np.abs(want).max()) > 0


def test_seeded_init_mirrors_lpips_init():
    """He-normal convs, zero biases, heads at 1/C; widths scale as
    lpips_init's and the keys are its tree's paths."""
    net = LPIPS(vgg16_widths(0.25), device="cpu", generator=torch.Generator().manual_seed(0))
    again = LPIPS(vgg16_widths(0.25), device="cpu", generator=torch.Generator().manual_seed(0))
    tree = _tree(0.25)
    want = {f"vgg.{i}.{n}": v for i, d in tree["vgg"].items() for n, v in d.items()}
    want.update({f"lins.{k}.weight": d["weight"] for k, d in tree["lins"].items()})
    sd = net.state_dict()
    assert set(sd) == set(want)
    for k, v in sd.items():
        assert tuple(v.shape) == want[k].shape, k
        torch.testing.assert_close(v, again.state_dict()[k], rtol=0, atol=0)
    for idx, cin, _ in VGG16_CONVS:
        w = sd[f"vgg.{idx}.weight"]
        fan = w.shape[1] * 9
        assert abs(float(w.std()) * np.sqrt(fan / 2.0) - 1.0) < 0.15, idx
        assert float(sd[f"vgg.{idx}.bias"].abs().max()) == 0.0
    for k, c in enumerate(LPIPS_CHANNELS):
        c = max(4, int(c * 0.25))
        torch.testing.assert_close(sd[f"lins.{k}.weight"], torch.full((1, c, 1, 1), 1.0 / c))


def _write_vgg(path, schema, seed=3):
    """A seeded VGG16 (widths scaled 0.25) in torchvision's layout: the
    features' convs under ``features.N`` with a classifier beside them, a
    bare ``N.*`` features dict, or either under 'state_dict'."""
    gen = torch.Generator().manual_seed(seed)
    feats = {}
    cin = 3
    for (idx, _, _), c in zip(VGG16_CONVS, vgg16_widths(0.25)):
        feats[f"{idx}.weight"] = torch.randn(c, cin, 3, 3, generator=gen) * 0.1
        feats[f"{idx}.bias"] = torch.randn(c, generator=gen) * 0.1
        cin = c
    if schema == "torchvision":
        sd = {f"features.{k}": v for k, v in feats.items()}
        sd["classifier.0.weight"] = torch.zeros(4, 4)
    elif schema == "bare":
        sd = feats
    else:
        sd = {"state_dict": {f"features.{k}": v for k, v in feats.items()}}
    torch.save(sd, path)
    return feats


def _write_lins(path, negative=False):
    gen = torch.Generator().manual_seed(4)
    sd = {f"lin{k}.model.1.weight": torch.rand(1, max(4, int(c * 0.25)), 1, 1, generator=gen)
          for k, c in enumerate(LPIPS_CHANNELS)}
    if negative:
        sd["lin2.model.1.weight"][0, 0] = -0.5
    torch.save(sd, path)
    return sd


@pytest.mark.parametrize("schema", ["torchvision", "bare", "state_dict"])
def test_importers_read_the_reference_schemas(tmp_path, schema):
    vgg_path, lins_path = str(tmp_path / "vgg16.pth"), str(tmp_path / "vgg.pth")
    feats = _write_vgg(vgg_path, schema)
    lins = _write_lins(lins_path, negative=schema == "bare")
    got_vgg = import_vgg16_features(vgg_path)
    want_vgg = jl.import_vgg16_features(vgg_path)
    assert set(got_vgg) == set(feats)
    for k, v in got_vgg.items():
        idx, name = k.split(".")
        np.testing.assert_array_equal(v.numpy(), np.asarray(want_vgg[idx][name]))
    got_lins = import_lpips_lins(lins_path)
    want_lins = jl.import_lpips_lins(lins_path)
    for k in range(5):
        np.testing.assert_array_equal(got_lins[f"{k}.weight"].numpy(),
                                      np.asarray(want_lins[str(k)]["weight"]))
        # the JAX rule, as written: a file with a negative weight keeps it
        np.testing.assert_array_equal(got_lins[f"{k}.weight"].numpy(),
                                      lins[f"lin{k}.model.1.weight"].numpy())
    net = load_lpips(vgg_path, lins_path, device="cpu")
    want_tree = jl.load_lpips(vgg_path, lins_path)
    a, b = _images((2, 3, 32, 32), 5)
    with torch.no_grad():
        got = net(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(jl.lpips_apply(want_tree, a, b)),
                               rtol=RTOL)


def test_load_lpips_needs_vgg_weights(tmp_path):
    lins_path = str(tmp_path / "vgg.pth")
    _write_lins(lins_path)
    with pytest.raises(FileNotFoundError, match="lpips_vgg_ckpt"):
        load_lpips(None, lins_path, device="cpu")

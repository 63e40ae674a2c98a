"""FID InceptionV3 (pool3 features), the JAX package's models/inception.py,
itself a port of the reference's TF-ported FID network
(Evaluation/inception.py:16-310).

torchvision's InceptionV3 stem and Mixed blocks with the FID patches: the
average pools of the A and C blocks and of Mixed_7b leave the padding out of
their counts (``count_include_pad=False``), and Mixed_7c's ``branch_pool`` is a
3x3 max pool (reference inception.py:302-307). The input goes through a
bilinear resize to 299 (``align_corners=False``, no antialias, for the 256px
upscale and for the 512/1024px downscales alike) and, with
``normalize_input``, the ``2x - 1`` rescale. The FID callers pass
``normalize_input=False`` and feed [-1, 1] images as they are, as the
reference's ``load_patched_inception_v3`` does (calc_inception.py:54).

Batch norm runs in eval mode, eps 1e-3, folded into the convolution: the
weight is scaled by ``weight * rsqrt(running_var + eps)`` and the shift is the
convolution's bias, so each BasicConv2d is one convolution and a ReLU. (The
JAX package scales after the convolution; the two round differently, within
the tests' tolerance.) Activations are channels-last, so cuDNN takes every
convolution without a layout copy.

State-dict keys are the JAX tree's paths, which are torchvision's names
(``Mixed_5b.branch1x1.conv.weight``, ``Mixed_5b.branch1x1.bn.running_var``);
no ``num_batches_tracked`` buffer is kept. ``load_fid_inception`` reads the
pytorch-fid release (pt_inception-2015-12-05-6726825d.pth), which must be
provided locally.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.runtime import resolve_device

POOL3_DIM = 2048
BN_EPS = 1e-3


class BasicConv2d(nn.Module):
    """A bias-free conv, eval batch norm (eps 1e-3) and ReLU, with a
    He-normal weight and unit batch norm at init (``_init_bc``)."""

    def __init__(self, cin, cout, kernel, *, stride=1, padding=0, generator=None):
        super().__init__()
        kh, kw = (kernel, kernel) if isinstance(kernel, int) else kernel
        self.conv = nn.Module()
        self.conv.weight = nn.Parameter(torch.randn(cout, cin, kh, kw, generator=generator)
                                        * math.sqrt(2.0 / (cin * kh * kw)))
        self.bn = nn.Module()
        self.bn.weight = nn.Parameter(torch.ones(cout))
        self.bn.bias = nn.Parameter(torch.zeros(cout))
        self.bn.register_buffer("running_mean", torch.zeros(cout))
        self.bn.register_buffer("running_var", torch.ones(cout))
        self.stride = stride
        self.padding = (padding, padding) if isinstance(padding, int) else padding

    def forward(self, x):
        bn = self.bn
        scale = bn.weight * torch.rsqrt(bn.running_var + BN_EPS)
        shift = bn.bias - bn.running_mean * scale
        w = self.conv.weight * scale[:, None, None, None]
        return torch.relu(F.conv2d(x, w.to(x.dtype), shift.to(x.dtype), stride=self.stride,
                                   padding=self.padding))


def _maxpool(x, k=3, s=2, p=0):
    return F.max_pool2d(x, k, s, p)


def _avgpool_excl_pad(x):
    """3x3/1 average over the valid elements of each window."""
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)


def _cat(xs):
    return torch.cat(xs, dim=1)


class InceptionA(nn.Module):  # Mixed_5b, 5c, 5d
    def __init__(self, cin, pool, w, g):
        super().__init__()
        self.branch1x1 = BasicConv2d(w(cin), w(64), 1, generator=g)
        self.branch5x5_1 = BasicConv2d(w(cin), w(48), 1, generator=g)
        self.branch5x5_2 = BasicConv2d(w(48), w(64), 5, padding=2, generator=g)
        self.branch3x3dbl_1 = BasicConv2d(w(cin), w(64), 1, generator=g)
        self.branch3x3dbl_2 = BasicConv2d(w(64), w(96), 3, padding=1, generator=g)
        self.branch3x3dbl_3 = BasicConv2d(w(96), w(96), 3, padding=1, generator=g)
        self.branch_pool = BasicConv2d(w(cin), w(pool), 1, generator=g)

    def forward(self, x):
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return _cat([self.branch1x1(x), self.branch5x5_2(self.branch5x5_1(x)), b3,
                     self.branch_pool(_avgpool_excl_pad(x))])


class InceptionB(nn.Module):  # Mixed_6a
    def __init__(self, cin, w, g):
        super().__init__()
        self.branch3x3 = BasicConv2d(w(cin), w(384), 3, stride=2, generator=g)
        self.branch3x3dbl_1 = BasicConv2d(w(cin), w(64), 1, generator=g)
        self.branch3x3dbl_2 = BasicConv2d(w(64), w(96), 3, padding=1, generator=g)
        self.branch3x3dbl_3 = BasicConv2d(w(96), w(96), 3, stride=2, generator=g)

    def forward(self, x):
        d = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return _cat([self.branch3x3(x), d, _maxpool(x)])


class InceptionC(nn.Module):  # Mixed_6b-6e
    def __init__(self, c7, w, g):
        super().__init__()
        self.branch1x1 = BasicConv2d(w(768), w(192), 1, generator=g)
        self.branch7x7_1 = BasicConv2d(w(768), w(c7), 1, generator=g)
        self.branch7x7_2 = BasicConv2d(w(c7), w(c7), (1, 7), padding=(0, 3), generator=g)
        self.branch7x7_3 = BasicConv2d(w(c7), w(192), (7, 1), padding=(3, 0), generator=g)
        self.branch7x7dbl_1 = BasicConv2d(w(768), w(c7), 1, generator=g)
        self.branch7x7dbl_2 = BasicConv2d(w(c7), w(c7), (7, 1), padding=(3, 0), generator=g)
        self.branch7x7dbl_3 = BasicConv2d(w(c7), w(c7), (1, 7), padding=(0, 3), generator=g)
        self.branch7x7dbl_4 = BasicConv2d(w(c7), w(c7), (7, 1), padding=(3, 0), generator=g)
        self.branch7x7dbl_5 = BasicConv2d(w(c7), w(192), (1, 7), padding=(0, 3), generator=g)
        self.branch_pool = BasicConv2d(w(768), w(192), 1, generator=g)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        d = self.branch7x7dbl_1(x)
        for k in range(2, 6):
            d = getattr(self, f"branch7x7dbl_{k}")(d)
        return _cat([self.branch1x1(x), b7, d, self.branch_pool(_avgpool_excl_pad(x))])


class InceptionD(nn.Module):  # Mixed_7a
    def __init__(self, w, g):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(w(768), w(192), 1, generator=g)
        self.branch3x3_2 = BasicConv2d(w(192), w(320), 3, stride=2, generator=g)
        self.branch7x7x3_1 = BasicConv2d(w(768), w(192), 1, generator=g)
        self.branch7x7x3_2 = BasicConv2d(w(192), w(192), (1, 7), padding=(0, 3), generator=g)
        self.branch7x7x3_3 = BasicConv2d(w(192), w(192), (7, 1), padding=(3, 0), generator=g)
        self.branch7x7x3_4 = BasicConv2d(w(192), w(192), 3, stride=2, generator=g)

    def forward(self, x):
        b7 = x
        for k in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{k}")(b7)
        return _cat([self.branch3x3_2(self.branch3x3_1(x)), b7, _maxpool(x)])


class InceptionE(nn.Module):  # Mixed_7b (average pool), Mixed_7c (max pool)
    def __init__(self, cin, pool, w, g):
        super().__init__()
        self.pool = pool
        self.branch1x1 = BasicConv2d(w(cin), w(320), 1, generator=g)
        self.branch3x3_1 = BasicConv2d(w(cin), w(384), 1, generator=g)
        self.branch3x3_2a = BasicConv2d(w(384), w(384), (1, 3), padding=(0, 1), generator=g)
        self.branch3x3_2b = BasicConv2d(w(384), w(384), (3, 1), padding=(1, 0), generator=g)
        self.branch3x3dbl_1 = BasicConv2d(w(cin), w(448), 1, generator=g)
        self.branch3x3dbl_2 = BasicConv2d(w(448), w(384), 3, padding=1, generator=g)
        self.branch3x3dbl_3a = BasicConv2d(w(384), w(384), (1, 3), padding=(0, 1), generator=g)
        self.branch3x3dbl_3b = BasicConv2d(w(384), w(384), (3, 1), padding=(1, 0), generator=g)
        self.branch_pool = BasicConv2d(w(cin), w(192), 1, generator=g)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = _cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)])
        d = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        d = _cat([self.branch3x3dbl_3a(d), self.branch3x3dbl_3b(d)])
        # FIDInceptionE_1 averages without the padding, FIDInceptionE_2
        # takes the max (reference inception.py:302-307)
        bp = _avgpool_excl_pad(x) if self.pool == "avg" else _maxpool(x, 3, 1, 1)
        return _cat([self.branch1x1(x), b3, d, self.branch_pool(bp)])


class InceptionV3(nn.Module):
    """The FID InceptionV3 up to pool3 (the JAX package's ``inception_init``
    and ``inception_pool3``).

    ``width_scale`` < 1 shrinks every internal width to ``max(4, int(c *
    width_scale))`` (topology unchanged; pick 1/2, 1/4 or 1/8, which divide
    every width, so concatenated widths match their consumers). Weights are
    drawn from ``generator`` (a CPU ``torch.Generator``) and moved to
    ``device``; real FID needs the imported weights (``load_fid_inception``).
    """

    def __init__(self, width_scale: float = 1.0, *, device="cuda", generator=None):
        super().__init__()
        device = resolve_device(device)

        def w(c):
            return c if c == 3 else max(4, int(c * width_scale))

        g = generator
        self.Conv2d_1a_3x3 = BasicConv2d(3, w(32), 3, stride=2, generator=g)
        self.Conv2d_2a_3x3 = BasicConv2d(w(32), w(32), 3, generator=g)
        self.Conv2d_2b_3x3 = BasicConv2d(w(32), w(64), 3, padding=1, generator=g)
        self.Conv2d_3b_1x1 = BasicConv2d(w(64), w(80), 1, generator=g)
        self.Conv2d_4a_3x3 = BasicConv2d(w(80), w(192), 3, generator=g)
        self.Mixed_5b = InceptionA(192, 32, w, g)
        self.Mixed_5c = InceptionA(256, 64, w, g)
        self.Mixed_5d = InceptionA(288, 64, w, g)
        self.Mixed_6a = InceptionB(288, w, g)
        self.Mixed_6b = InceptionC(128, w, g)
        self.Mixed_6c = InceptionC(160, w, g)
        self.Mixed_6d = InceptionC(160, w, g)
        self.Mixed_6e = InceptionC(192, w, g)
        self.Mixed_7a = InceptionD(w, g)
        self.Mixed_7b = InceptionE(1280, "avg", w, g)
        self.Mixed_7c = InceptionE(2048, "max", w, g)
        self.to(device)

    def forward(self, img_nchw, *, resize_input: bool = True, normalize_input: bool = True):
        """[N, 3, H, W] images (any memory format) -> pool3 features
        [N, pool3_dim] (blocks 0-3 of the reference's InceptionV3,
        inception.py:84-124)."""
        x = img_nchw
        if resize_input:
            x = F.interpolate(x, size=(299, 299), mode="bilinear", align_corners=False,
                              antialias=False)
        if normalize_input:
            x = 2 * x - 1
        x = x.contiguous(memory_format=torch.channels_last)
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = _maxpool(x)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = _maxpool(x)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b", "Mixed_6c",
                     "Mixed_6d", "Mixed_6e", "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            x = getattr(self, name)(x)
        return x.mean(dim=(2, 3))  # adaptive average pool to 1x1


def pool3_dim(params) -> int:
    """The feature width of ``params`` (an ``InceptionV3``, its state dict or
    a JAX tree): 2048 at full width, less for a width-scaled net; the Mixed_7c
    concatenation's width."""
    from ..utils.checkpoint import state_dict_from_jax

    sd = params.state_dict() if isinstance(params, nn.Module) else state_dict_from_jax(params)
    return sum(int(sd[f"Mixed_7c.{k}.conv.weight"].shape[0]) for k in (
        "branch1x1", "branch3x3_2a", "branch3x3_2b", "branch3x3dbl_3a", "branch3x3dbl_3b",
        "branch_pool"))


def load_fid_inception(path: str, *, device="cuda") -> InceptionV3:
    """The pytorch-fid release (or a torchvision ``inception_v3`` state
    dict): ``fc.*``, ``AuxLogits.*`` and ``num_batches_tracked`` are
    dropped."""
    from ..utils.checkpoint import build_inception_from_state_dict, load_torch_checkpoint

    sd = load_torch_checkpoint(path)
    sd = {k: v for k, v in sd.items() if not k.endswith("num_batches_tracked")
          and not k.startswith(("fc.", "AuxLogits."))}
    return build_inception_from_state_dict(sd, device=device)

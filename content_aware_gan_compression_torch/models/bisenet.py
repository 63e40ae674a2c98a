"""BiSeNet face parser (19 classes), the JAX package's models/bisenet.py, for
inference only.

Architecture as the reference's Util/face_parsing/BiSeNet.py:230-254: a
ResNet-18 context path, ARM16/ARM32, FFM and three output heads (the spatial
path is the res8 feature, as in the reference). Batch norm runs in eval mode,
folded to a scale and shift. Module names are the state-dict paths of the
published ``79999_iter.pth`` (``cp.resnet.layer1.0.conv1.weight``,
``...bn1.running_var``, ...), which are also the JAX tree's paths; no
``num_batches_tracked`` buffer is kept, so a JAX tree loads with
``strict=True`` and ``load_bisenet`` drops that key from a reference file.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.runtime import resolve_device

N_CLASSES = 19
# the four internal widths of the ResNet-18 trunk and the heads
BISENET_WIDTHS = (64, 128, 256, 512)


def bisenet_widths(width_scale: float = 1.0) -> tuple[int, ...]:
    """``BISENET_WIDTHS`` scaled as ``bisenet_init``: ``max(4, int(c * s))``."""
    return tuple(max(4, int(c * width_scale)) for c in BISENET_WIDTHS)


class Conv(nn.Module):
    """A bias-free conv with a He-normal weight (``_init_conv``)."""

    def __init__(self, cin, cout, k, *, stride=1, padding=0, generator=None):
        super().__init__()
        self.weight = nn.Parameter(torch.randn(cout, cin, k, k, generator=generator)
                                   * math.sqrt(2.0 / (cin * k * k)))
        self.stride, self.padding = stride, padding

    def forward(self, x):
        return F.conv2d(x, self.weight.to(x.dtype), stride=self.stride, padding=self.padding)


class FoldedBatchNorm(nn.Module):
    """Eval-mode batch norm as ``x * scale + shift``, ``scale = weight *
    rsqrt(running_var + eps)`` (the JAX package's ``_bn``)."""

    def __init__(self, c, eps=1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))
        self.eps = eps

    def forward(self, x):
        scale = self.weight * torch.rsqrt(self.running_var + self.eps)
        shift = self.bias - self.running_mean * scale
        return x * scale.to(x.dtype)[:, None, None] + shift.to(x.dtype)[:, None, None]


class ConvBNReLU(nn.Module):
    def __init__(self, cin, cout, k=3, *, padding=None, generator=None):
        super().__init__()
        self.conv = Conv(cin, cout, k, padding=k // 2 if padding is None else padding,
                         generator=generator)
        self.bn = FoldedBatchNorm(cout)

    def forward(self, x):
        return torch.relu(self.bn(self.conv(x)))


class BasicBlock(nn.Module):
    def __init__(self, cin, cout, stride=1, *, generator=None):
        super().__init__()
        self.conv1 = Conv(cin, cout, 3, stride=stride, padding=1, generator=generator)
        self.bn1 = FoldedBatchNorm(cout)
        self.conv2 = Conv(cout, cout, 3, padding=1, generator=generator)
        self.bn2 = FoldedBatchNorm(cout)
        if cin != cout or stride != 1:
            self.downsample = nn.Sequential(Conv(cin, cout, 1, stride=stride, generator=generator),
                                            FoldedBatchNorm(cout))
        else:
            self.downsample = None

    def forward(self, x):
        r = torch.relu(self.bn1(self.conv1(x)))
        r = self.bn2(self.conv2(r))
        if self.downsample is not None:
            x = self.downsample(x)
        return torch.relu(x + r)


class ResNet18(nn.Module):
    def __init__(self, w, *, generator=None):
        super().__init__()
        g = generator
        self.conv1 = Conv(3, w[0], 7, stride=2, padding=3, generator=g)
        self.bn1 = FoldedBatchNorm(w[0])
        self.layer1 = nn.Sequential(BasicBlock(w[0], w[0], generator=g),
                                    BasicBlock(w[0], w[0], generator=g))
        self.layer2 = nn.Sequential(BasicBlock(w[0], w[1], 2, generator=g),
                                    BasicBlock(w[1], w[1], generator=g))
        self.layer3 = nn.Sequential(BasicBlock(w[1], w[2], 2, generator=g),
                                    BasicBlock(w[2], w[2], generator=g))
        self.layer4 = nn.Sequential(BasicBlock(w[2], w[3], 2, generator=g),
                                    BasicBlock(w[3], w[3], generator=g))

    def forward(self, x):
        x = torch.relu(self.bn1(self.conv1(x)))
        # 3x3/s2/p1 max-pool; its padding is -inf
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        x = self.layer1(x)
        feat8 = self.layer2(x)
        feat16 = self.layer3(feat8)
        return feat8, feat16, self.layer4(feat16)


def _global_avg_pool(x):
    return torch.mean(x, dim=(2, 3), keepdim=True)


def _nearest(x, size):
    # floor((i + 0.5) * in / out), jax.image.resize's "nearest"
    return F.interpolate(x, size=size, mode="nearest-exact")


class AttentionRefinement(nn.Module):
    def __init__(self, cin, cout, *, generator=None):
        super().__init__()
        self.conv = ConvBNReLU(cin, cout, generator=generator)
        self.conv_atten = Conv(cout, cout, 1, generator=generator)
        self.bn_atten = FoldedBatchNorm(cout)

    def forward(self, x):
        feat = self.conv(x)
        atten = torch.sigmoid(self.bn_atten(self.conv_atten(_global_avg_pool(feat))))
        return feat * atten


class ContextPath(nn.Module):
    def __init__(self, w, *, generator=None):
        super().__init__()
        g = generator
        self.resnet = ResNet18(w, generator=g)
        self.arm16 = AttentionRefinement(w[2], w[1], generator=g)
        self.arm32 = AttentionRefinement(w[3], w[1], generator=g)
        self.conv_head32 = ConvBNReLU(w[1], w[1], generator=g)
        self.conv_head16 = ConvBNReLU(w[1], w[1], generator=g)
        self.conv_avg = ConvBNReLU(w[3], w[1], 1, generator=g)

    def forward(self, x):
        feat8, feat16, feat32 = self.resnet(x)
        avg_up = _nearest(self.conv_avg(_global_avg_pool(feat32)), feat32.shape[2:])
        feat32_up = self.conv_head32(_nearest(self.arm32(feat32) + avg_up, feat16.shape[2:]))
        feat16_up = self.conv_head16(_nearest(self.arm16(feat16) + feat32_up, feat8.shape[2:]))
        return feat8, feat16_up, feat32_up


class FeatureFusion(nn.Module):
    def __init__(self, cin, cout, mid, *, generator=None):
        super().__init__()
        self.convblk = ConvBNReLU(cin, cout, 1, generator=generator)
        self.conv1 = Conv(cout, mid, 1, generator=generator)
        self.conv2 = Conv(mid, cout, 1, generator=generator)

    def forward(self, fsp, fcp):
        feat = self.convblk(torch.cat([fsp, fcp], dim=1))
        atten = torch.sigmoid(self.conv2(torch.relu(self.conv1(_global_avg_pool(feat)))))
        return feat * atten + feat


class OutputHead(nn.Module):
    def __init__(self, cin, mid, n_classes, *, generator=None):
        super().__init__()
        self.conv = ConvBNReLU(cin, mid, generator=generator)
        self.conv_out = Conv(mid, n_classes, 1, generator=generator)

    def forward(self, x):
        return self.conv_out(self.conv(x))


class BiSeNet(nn.Module):
    """BiSeNet for face parsing (the JAX package's ``bisenet_init`` /
    ``bisenet_apply``). ``widths`` are the trunk's four widths
    (``bisenet_widths(width_scale)``). Weights are drawn from ``generator``
    (a CPU ``torch.Generator``) and moved to ``device``."""

    def __init__(self, widths: tuple[int, ...] = BISENET_WIDTHS, n_classes: int = N_CLASSES, *,
                 device="cuda", generator=None):
        super().__init__()
        device = resolve_device(device)
        w, g = widths, generator
        self.cp = ContextPath(w, generator=g)
        self.ffm = FeatureFusion(w[2], w[2], w[0], generator=g)
        self.conv_out = OutputHead(w[2], w[2], n_classes, generator=g)
        self.conv_out16 = OutputHead(w[1], w[0], n_classes, generator=g)
        self.conv_out32 = OutputHead(w[1], w[0], n_classes, generator=g)
        self.to(device)

    def forward(self, img, *, data_format: str = "NCHW", heads: int = 3):
        """ImageNet-normalized images [N, 3, H, W] (or [N, H, W, 3] with
        ``data_format="NHWC"``) -> a tuple of the first ``heads`` logits
        heads, each [N, 19, H, W] (or [N, H, W, 19]), align-corners bilinear
        back to the input size. ``heads=1`` computes only head 0, the one
        parsing uses; the context path runs in full either way."""
        if data_format not in ("NCHW", "NHWC"):
            raise ValueError(f"unknown data_format {data_format!r}")
        x = img.permute(0, 3, 1, 2) if data_format == "NHWC" else img
        size = x.shape[2:]
        feat_res8, feat_cp8, feat_cp16 = self.cp(x)
        feats = [(self.conv_out, self.ffm(feat_res8, feat_cp8)), (self.conv_out16, feat_cp8),
                 (self.conv_out32, feat_cp16)]
        outs = []
        for head, feat in feats[:heads]:
            out = F.interpolate(head(feat), size=size, mode="bilinear", align_corners=True)
            outs.append(out.permute(0, 2, 3, 1) if data_format == "NHWC" else out)
        return tuple(outs)


def make_parse_fn(net: BiSeNet, data_format: str = "NCHW", dtype=None):
    """Head-0 logits in float32, for ``pruning.content_aware.batch_img_parsing``;
    the net runs in ``dtype`` (the input's type if None), as the JAX
    training step's parse_fn."""
    def parse_fn(normalized):
        x = normalized if dtype is None else normalized.to(dtype)
        return net(x, data_format=data_format, heads=1)[0].float()
    return parse_fn


def load_bisenet(path: str, *, device="cuda") -> BiSeNet:
    """The reference's pretrained parser
    (Util/face_parsing/pretrained_model/79999_iter.pth)."""
    from ..utils.checkpoint import build_bisenet_from_state_dict, load_torch_checkpoint

    sd = load_torch_checkpoint(path)
    sd = {k: v for k, v in sd.items() if not k.endswith("num_batches_tracked")}
    return build_bisenet_from_state_dict(sd, device=device)

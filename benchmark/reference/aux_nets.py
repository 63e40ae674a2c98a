"""The networks beside the generator, in plain PyTorch on NCHW tensors:
LPIPS with a VGG16 trunk (Zhang et al., arXiv:1801.03924; net-lin, the
reference's vendored ``lpips``), the BiSeNet face parser (Yu et al.,
arXiv:1808.00897; zllrunning/face-parsing.PyTorch, 19 classes) and FID's
InceptionV3 to pool3 (Heusel et al., arXiv:1706.08500; the pytorch-fid
network with its FID patches). Parameter names are those of the published
weights. Each ``init_rule`` says how the benchmark draws a network's tensors:
He-normal convolutions, identity batch norms, LPIPS heads at 1/C.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from . import ops


def _empty(*shape):
    return nn.Parameter(torch.empty(*shape))


# -- LPIPS -------------------------------------------------------------------------
VGG16_CONVS = [(0, 3, 64), (2, 64, 64), (5, 64, 128), (7, 128, 128), (10, 128, 256),
               (12, 256, 256), (14, 256, 256), (17, 256, 512), (19, 512, 512),
               (21, 512, 512), (24, 512, 512), (26, 512, 512), (28, 512, 512)]
SLICE_ENDS = (3, 8, 15, 22, 29)
POOLS = (4, 9, 16, 23)
LPIPS_CHANNELS = (64, 128, 256, 512, 512)
SHIFT = (-0.030, -0.088, -0.188)
SCALE = (0.458, 0.448, 0.450)


def lpips_rule(name: str, shape) -> tuple[float, float]:
    if name.startswith("lins."):
        return 0.0, 1.0 / shape[1]
    if len(shape) == 4:
        return math.sqrt(2.0 / math.prod(shape[1:])), 0.0
    return 0.0, 0.0


class LPIPS(nn.Module):
    """LPIPS(a, b) per image, [N] for [-1, 1] NCHW images."""

    def __init__(self):
        super().__init__()
        self.vgg = nn.Module()
        for idx, cin, cout in VGG16_CONVS:
            conv = nn.Module()
            conv.weight, conv.bias = _empty(cout, cin, 3, 3), _empty(cout)
            self.vgg.add_module(str(idx), conv)
        self.lins = nn.ModuleList()
        for c in LPIPS_CHANNELS:
            head = nn.Module()
            head.weight = _empty(1, c, 1, 1)
            self.lins.append(head)

    def features(self, x):
        feats, seq = [], 0
        while len(feats) < len(SLICE_ENDS):
            if seq in POOLS:
                x, seq = F.max_pool2d(x, 2), seq + 1
                continue
            conv = getattr(self.vgg, str(seq))
            x = torch.relu(ops.conv2d(x, conv.weight, conv.bias, padding=1))
            seq += 2
            if seq - 1 in SLICE_ENDS:
                feats.append(x)
        return feats

    def forward(self, a, b):
        shift = torch.tensor(SHIFT, device=a.device).reshape(1, 3, 1, 1)
        scale = torch.tensor(SCALE, device=a.device).reshape(1, 3, 1, 1)
        total = 0
        for fa, fb, lin in zip(self.features((a - shift) / scale),
                               self.features((b - shift) / scale), self.lins):
            na = fa / (fa.square().sum(1, keepdim=True).sqrt() + 1e-10)
            nb = fb / (fb.square().sum(1, keepdim=True).sqrt() + 1e-10)
            total = total + ((na - nb).square() * lin.weight).sum(1).mean((1, 2))
        return total


# -- BiSeNet -----------------------------------------------------------------------
class Conv(nn.Module):
    def __init__(self, cin, cout, k, stride=1, padding=0):
        super().__init__()
        self.weight = _empty(cout, cin, k, k)
        self.stride, self.padding = stride, padding

    def forward(self, x):
        return ops.conv2d(x, self.weight, stride=self.stride, padding=self.padding)


class BatchNorm(nn.Module):
    """Eval-mode batch norm, eps 1e-5."""

    def __init__(self, c):
        super().__init__()
        self.weight, self.bias = _empty(c), _empty(c)
        self.register_buffer("running_mean", torch.empty(c))
        self.register_buffer("running_var", torch.empty(c))

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            False, 0.0, 1e-5)


def bisenet_rule(name: str, shape) -> tuple[float, float]:
    """He-normal convolutions; batch norms as the identity."""
    if len(shape) == 4:
        return math.sqrt(2.0 / math.prod(shape[1:])), 0.0
    if name.endswith("running_var") or name.endswith("weight"):
        return 0.0, 1.0
    return 0.0, 0.0


class ConvBNReLU(nn.Module):
    def __init__(self, cin, cout, k=3):
        super().__init__()
        self.conv, self.bn = Conv(cin, cout, k, padding=k // 2), BatchNorm(cout)

    def forward(self, x):
        return torch.relu(self.bn(self.conv(x)))


class BasicBlock(nn.Module):
    def __init__(self, cin, cout, stride=1):
        super().__init__()
        self.conv1, self.bn1 = Conv(cin, cout, 3, stride, 1), BatchNorm(cout)
        self.conv2, self.bn2 = Conv(cout, cout, 3, 1, 1), BatchNorm(cout)
        self.downsample = (nn.Sequential(Conv(cin, cout, 1, stride), BatchNorm(cout))
                           if cin != cout or stride != 1 else None)

    def forward(self, x):
        r = self.bn2(self.conv2(torch.relu(self.bn1(self.conv1(x)))))
        return torch.relu((x if self.downsample is None else self.downsample(x)) + r)


class ResNet18(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1, self.bn1 = Conv(3, 64, 7, 2, 3), BatchNorm(64)
        self.layer1 = nn.Sequential(BasicBlock(64, 64), BasicBlock(64, 64))
        self.layer2 = nn.Sequential(BasicBlock(64, 128, 2), BasicBlock(128, 128))
        self.layer3 = nn.Sequential(BasicBlock(128, 256, 2), BasicBlock(256, 256))
        self.layer4 = nn.Sequential(BasicBlock(256, 512, 2), BasicBlock(512, 512))

    def forward(self, x):
        x = F.max_pool2d(torch.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        f8 = self.layer2(self.layer1(x))
        f16 = self.layer3(f8)
        return f8, f16, self.layer4(f16)


def _gap(x):
    return x.mean((2, 3), keepdim=True)


def _nearest(x, size):
    return F.interpolate(x, size=size, mode="nearest-exact")


class AttentionRefinement(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv, self.conv_atten, self.bn_atten = ConvBNReLU(cin, cout), Conv(cout, cout, 1), \
            BatchNorm(cout)

    def forward(self, x):
        feat = self.conv(x)
        return feat * torch.sigmoid(self.bn_atten(self.conv_atten(_gap(feat))))


class ContextPath(nn.Module):
    def __init__(self):
        super().__init__()
        self.resnet = ResNet18()
        self.arm16, self.arm32 = AttentionRefinement(256, 128), AttentionRefinement(512, 128)
        self.conv_head32, self.conv_head16 = ConvBNReLU(128, 128), ConvBNReLU(128, 128)
        self.conv_avg = ConvBNReLU(512, 128, 1)

    def forward(self, x):
        f8, f16, f32 = self.resnet(x)
        avg = _nearest(self.conv_avg(_gap(f32)), f32.shape[2:])
        up32 = self.conv_head32(_nearest(self.arm32(f32) + avg, f16.shape[2:]))
        up16 = self.conv_head16(_nearest(self.arm16(f16) + up32, f8.shape[2:]))
        return f8, up16


class FeatureFusion(nn.Module):
    def __init__(self, cin, cout, mid):
        super().__init__()
        self.convblk, self.conv1, self.conv2 = ConvBNReLU(cin, cout, 1), Conv(cout, mid, 1), \
            Conv(mid, cout, 1)

    def forward(self, fsp, fcp):
        feat = self.convblk(torch.cat([fsp, fcp], 1))
        return feat * torch.sigmoid(self.conv2(torch.relu(self.conv1(_gap(feat))))) + feat


class OutputHead(nn.Module):
    def __init__(self, cin, mid, n_classes):
        super().__init__()
        self.conv, self.conv_out = ConvBNReLU(cin, mid), Conv(mid, n_classes, 1)

    def forward(self, x):
        return self.conv_out(self.conv(x))


class BiSeNet(nn.Module):
    """Head 0's logits [N, 19, H, W] of ImageNet-normalized NCHW images. The
    other two heads, which parsing never reads, hold weights but are not
    run."""

    def __init__(self, n_classes=19):
        super().__init__()
        self.cp = ContextPath()
        self.ffm = FeatureFusion(256, 256, 64)
        self.conv_out = OutputHead(256, 256, n_classes)
        self.conv_out16 = OutputHead(128, 64, n_classes)
        self.conv_out32 = OutputHead(128, 64, n_classes)

    def forward(self, x):
        f8, cp8 = self.cp(x)
        return ops.resize(self.conv_out(self.ffm(f8, cp8)), x.shape[2:], align_corners=True)


IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
CLOTH = 16


def coi_mask(parser, img):
    """The content-aware KD mask of [-1, 1] NCHW images: BiSeNet's head-0
    argmax at 512px, every class but background and cloth, resized to the
    images' size and thresholded at 0.5. Returns a float [N, 1, H, W]."""
    with torch.no_grad():
        x = ops.resize(torch.clamp((img + 1) / 2, 0, 1), (512, 512))
        mean = torch.tensor(IMAGENET_MEAN, device=img.device).reshape(1, 3, 1, 1)
        std = torch.tensor(IMAGENET_STD, device=img.device).reshape(1, 3, 1, 1)
        cls = parser((x - mean) / std).argmax(1)
        mask = ((cls > 0) & (cls != CLOTH)).float()[:, None]
        return (ops.resize(mask, img.shape[2:]) > 0.5).float()


# -- FID InceptionV3 -----------------------------------------------------------------
class BasicConv2d(nn.Module):
    """Convolution, eval batch norm (eps 1e-3), ReLU."""

    def __init__(self, cin, cout, k, stride=1, padding=0):
        super().__init__()
        kh, kw = (k, k) if isinstance(k, int) else k
        self.conv = nn.Module()
        self.conv.weight = _empty(cout, cin, kh, kw)
        self.bn = nn.Module()
        self.bn.weight, self.bn.bias = _empty(cout), _empty(cout)
        self.bn.register_buffer("running_mean", torch.empty(cout))
        self.bn.register_buffer("running_var", torch.empty(cout))
        self.stride, self.padding = stride, padding

    def forward(self, x):
        x = ops.conv2d(x, self.conv.weight, stride=self.stride, padding=self.padding)
        bn = self.bn
        return torch.relu(F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight, bn.bias,
                                       False, 0.0, 1e-3))


def _avg(x):
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)


class InceptionA(nn.Module):
    def __init__(self, cin, pool):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, 1)
        self.branch5x5_1, self.branch5x5_2 = BasicConv2d(cin, 48, 1), BasicConv2d(48, 64, 5, 1, 2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, 1, 1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, 1, 1)
        self.branch_pool = BasicConv2d(cin, pool, 1)

    def forward(self, x):
        d = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), self.branch5x5_2(self.branch5x5_1(x)), d,
                          self.branch_pool(_avg(x))], 1)


class InceptionB(nn.Module):
    def __init__(self, cin):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, 2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, 1, 1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, 2)

    def forward(self, x):
        d = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), d, F.max_pool2d(x, 3, 2)], 1)


class InceptionC(nn.Module):
    def __init__(self, c7):
        super().__init__()
        self.branch1x1 = BasicConv2d(768, 192, 1)
        self.branch7x7_1 = BasicConv2d(768, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), 1, (0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), 1, (3, 0))
        self.branch7x7dbl_1 = BasicConv2d(768, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), 1, (3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), 1, (0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), 1, (3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), 1, (0, 3))
        self.branch_pool = BasicConv2d(768, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        d = x
        for k in range(1, 6):
            d = getattr(self, f"branch7x7dbl_{k}")(d)
        return torch.cat([self.branch1x1(x), b7, d, self.branch_pool(_avg(x))], 1)


class InceptionD(nn.Module):
    def __init__(self):
        super().__init__()
        self.branch3x3_1, self.branch3x3_2 = BasicConv2d(768, 192, 1), BasicConv2d(192, 320, 3, 2)
        self.branch7x7x3_1 = BasicConv2d(768, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), 1, (0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), 1, (3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, 2)

    def forward(self, x):
        b7 = x
        for k in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{k}")(b7)
        return torch.cat([self.branch3x3_2(self.branch3x3_1(x)), b7, F.max_pool2d(x, 3, 2)], 1)


class InceptionE(nn.Module):
    def __init__(self, cin, pool):
        super().__init__()
        self.pool = pool
        self.branch1x1 = BasicConv2d(cin, 320, 1)
        self.branch3x3_1 = BasicConv2d(cin, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), 1, (0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), 1, (1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, 1, 1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), 1, (0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), 1, (1, 0))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        d = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bp = _avg(x) if self.pool == "avg" else F.max_pool2d(x, 3, 1, 1)
        return torch.cat([self.branch1x1(x), self.branch3x3_2a(b3), self.branch3x3_2b(b3),
                          self.branch3x3dbl_3a(d), self.branch3x3dbl_3b(d),
                          self.branch_pool(bp)], 1)


def inception_rule(name: str, shape) -> tuple[float, float]:
    return bisenet_rule(name, shape)


class InceptionV3(nn.Module):
    """[-1, 1] NCHW images fed raw (as the FID callers do), resized to 299
    -> pool3 features [N, 2048]."""

    def __init__(self):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, 2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, 1, 1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b, self.Mixed_5c, self.Mixed_5d = (InceptionA(192, 32), InceptionA(256, 64),
                                                       InceptionA(288, 64))
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b, self.Mixed_6c = InceptionC(128), InceptionC(160)
        self.Mixed_6d, self.Mixed_6e = InceptionC(160), InceptionC(192)
        self.Mixed_7a = InceptionD()
        self.Mixed_7b, self.Mixed_7c = InceptionE(1280, "avg"), InceptionE(2048, "max")

    def forward(self, img):
        x = ops.resize(img, (299, 299))
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(F.max_pool2d(x, 3, 2)))
        x = F.max_pool2d(x, 3, 2)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b", "Mixed_6c",
                     "Mixed_6d", "Mixed_6e", "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            x = getattr(self, name)(x)
        return x.mean((2, 3))

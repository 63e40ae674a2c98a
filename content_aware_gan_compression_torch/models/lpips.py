"""LPIPS perceptual distance (net-lin, VGG16), the JAX package's
models/lpips.py.

Math as the reference's vendored lpips package (lpips/networks_basic.py:27-110):
scaling layer -> VGG16 features at relu{1_2,2_2,3_3,4_3,5_3} -> per-layer
unit-normalize over channels (eps 1e-10 outside the sqrt,
lpips/__init__.py:42-44) -> squared difference -> learned 1x1 heads without
bias -> spatial mean -> sum over the 5 layers.

State-dict keys are the JAX tree's paths: ``vgg.<features index>.weight`` and
``.bias``, ``lins.<k>.weight`` [1, C, 1, 1]. Weights come from torchvision's
VGG16 (``features.N.*``, ``import_vgg16_features``) and the reference's
calibration heads (``lin{k}.model.1.weight``, ``import_lpips_lins``), or are
drawn from a seed (``LPIPS(generator=...)``), which keeps the metric's
structure but not its values.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.runtime import resolve_device

# torchvision vgg16 cfg 'D' conv layout: (features index, in_ch, out_ch)
VGG16_CONVS = [
    (0, 3, 64), (2, 64, 64),
    (5, 64, 128), (7, 128, 128),
    (10, 128, 256), (12, 256, 256), (14, 256, 256),
    (17, 256, 512), (19, 512, 512), (21, 512, 512),
    (24, 512, 512), (26, 512, 512), (28, 512, 512),
]
# features indices after which a slice output is captured (relu outputs)
SLICE_ENDS = (3, 8, 15, 22, 29)
# maxpool positions in the features sequence
POOL_POSITIONS = (4, 9, 16, 23)
LPIPS_CHANNELS = (64, 128, 256, 512, 512)

SHIFT = (-0.030, -0.088, -0.188)
SCALE = (0.458, 0.448, 0.450)


def vgg16_widths(width_scale: float = 1.0) -> tuple[int, ...]:
    """Output widths of the 13 convs, each ``max(4, int(c * width_scale))``
    (the JAX package's ``lpips_init``; topology unchanged)."""
    return tuple(max(4, int(c * width_scale)) for _, _, c in VGG16_CONVS)


def _parameters(**tensors) -> nn.Module:
    """A module holding ``tensors`` as its parameters (a conv's weight and
    bias, applied by its owner), so that keys follow the JAX tree."""
    module = nn.Module()
    for name, value in tensors.items():
        module.register_parameter(name, nn.Parameter(value))
    return module


def _to_nchw(x, data_format):
    if data_format not in ("NCHW", "NHWC"):
        raise ValueError(f"unknown data_format {data_format!r}")
    return x.permute(0, 3, 1, 2) if data_format == "NHWC" else x


class VGG16Features(nn.Module):
    """The VGG16 trunk up to relu5_3: 3x3 conv + bias + ReLU, 2x2 max-pool at
    positions 4, 9, 16 and 23. Submodules are named by their index in
    torchvision's ``features`` Sequential, so ``features.N.*`` loads once the
    prefix is dropped."""

    def __init__(self, widths: tuple[int, ...] = vgg16_widths(), *, generator=None):
        super().__init__()
        cin = 3
        for (idx, _, _), cout in zip(VGG16_CONVS, widths, strict=True):
            # He-normal, zero bias (lpips_init)
            self.add_module(str(idx), _parameters(
                weight=torch.randn(cout, cin, 3, 3, generator=generator)
                * math.sqrt(2.0 / (cin * 9)), bias=torch.zeros(cout)))
            cin = cout

    def forward(self, x_nchw):
        """Scaled NCHW images (any memory format) -> the 5 relu slice outputs,
        NCHW."""
        feats = []
        x = x_nchw
        seq = 0
        while len(feats) < len(SLICE_ENDS):
            if seq in POOL_POSITIONS:
                x = F.max_pool2d(x, 2)
                seq += 1
                continue
            conv = getattr(self, str(seq))
            x = torch.relu(F.conv2d(x, conv.weight, conv.bias, padding=1))
            seq += 2
            if seq - 1 in SLICE_ENDS:
                feats.append(x)
        return feats


class LPIPS(nn.Module):
    """LPIPS-VGG16 (the JAX package's ``lpips_init`` / ``lpips_apply``).

    ``widths`` are the 13 conv widths (``vgg16_widths(width_scale)``); the
    heads take the slice widths and start at ``1/C``. Weights are drawn from
    ``generator`` (a CPU ``torch.Generator``) and moved to ``device``.
    """

    def __init__(self, widths: tuple[int, ...] = vgg16_widths(), *, device="cuda",
                 generator=None):
        super().__init__()
        device = resolve_device(device)
        self.vgg = VGG16Features(widths, generator=generator)
        slice_widths = [w for (idx, _, _), w in zip(VGG16_CONVS, widths)
                        if idx + 1 in SLICE_ENDS]
        self.lins = nn.ModuleList(_parameters(weight=torch.full((1, c, 1, 1), 1.0 / c))
                                  for c in slice_widths)
        self.to(device)

    def forward(self, in0, in1, *, normalize: bool = False, spatial: bool = False,
                ret_per_layer: bool = False, data_format: str = "NCHW"):
        """LPIPS(in0, in1) for images in [-1, 1] (or [0, 1] with
        ``normalize``), NCHW or NHWC. Returns [N, 1, 1, 1] as the reference,
        and the per-layer values with ``ret_per_layer``. ``spatial`` keeps
        each layer's map ([N, 1, H, W]) instead of its mean; as in the JAX
        function, summing the maps needs them to share a size.

        An input that does not require grad, through frozen weights, builds
        no graph: the teacher's branch of the KD loss costs a forward only."""
        x0, x1 = _to_nchw(in0, data_format), _to_nchw(in1, data_format)
        if normalize:
            x0, x1 = 2 * x0 - 1, 2 * x1 - 1
        shift = torch.tensor(SHIFT, dtype=x0.dtype, device=x0.device).reshape(1, 3, 1, 1)
        scale = torch.tensor(SCALE, dtype=x0.dtype, device=x0.device).reshape(1, 3, 1, 1)
        f0 = self.vgg((x0 - shift) / scale)
        f1 = self.vgg((x1 - shift) / scale)
        res = []
        for a, b, lin in zip(f0, f1, self.lins):
            # unit-normalize over channels, eps outside the sqrt; the heads
            # are 1x1 convs without bias
            na = a / (torch.sqrt(torch.sum(torch.square(a), dim=1, keepdim=True)) + 1e-10)
            nb = b / (torch.sqrt(torch.sum(torch.square(b), dim=1, keepdim=True)) + 1e-10)
            diff = torch.square(na - nb)
            head = torch.sum(diff * lin.weight.to(diff.dtype), dim=1, keepdim=True)
            res.append(head if spatial else torch.mean(head, dim=(2, 3), keepdim=True))
        val = sum(res[1:], res[0])
        if ret_per_layer:
            return val, res
        return val


def import_lpips_lins(path: str) -> dict[str, torch.Tensor]:
    """The reference's calibration heads (lpips/weights/v0.1/vgg.pth; keys
    ``lin{k}.model.1.weight``) as the state dict of ``LPIPS.lins``."""
    from ..utils.checkpoint import load_torch_checkpoint

    sd = load_torch_checkpoint(path)
    lins = {}
    for k in range(len(LPIPS_CHANNELS)):
        w = torch.as_tensor(sd[f"lin{k}.model.1.weight"]).float()
        lins[f"{k}.weight"] = w.clamp(min=0)
        # as the JAX package: the published weights are non-negative; a file
        # with any negative weight keeps its raw weights
        if (w < 0).any():
            lins[f"{k}.weight"] = w
    return lins


def import_vgg16_features(path: str) -> dict[str, torch.Tensor]:
    """torchvision VGG16 weights (``features.N.weight``) or a bare features
    state dict (``N.weight``), optionally under ``state_dict``, as the state
    dict of ``LPIPS.vgg``."""
    from ..utils.checkpoint import load_torch_checkpoint

    sd = load_torch_checkpoint(path)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    out = {}
    for idx, _, _ in VGG16_CONVS:
        for name in ("weight", "bias"):
            key = f"features.{idx}.{name}"
            if key not in sd:
                key = f"{idx}.{name}"
            out[f"{idx}.{name}"] = torch.as_tensor(sd[key])
    return out


def load_lpips(vgg_path: str | None, lins_path: str, *, device="cuda") -> LPIPS:
    """LPIPS from torchvision's VGG16 file and the reference's heads file.
    ``vgg_path=None`` raises: the weights cannot be downloaded here."""
    from ..utils.checkpoint import build_lpips_from_state_dict

    if vgg_path is None:
        raise FileNotFoundError(
            "LPIPS needs torchvision vgg16 weights; pass --lpips_vgg_ckpt "
            "(they are not downloaded)")
    vgg, lins = import_vgg16_features(vgg_path), import_lpips_lins(lins_path)
    return build_lpips_from_state_dict(
        {**{f"vgg.{k}": v for k, v in vgg.items()}, **{f"lins.{k}": v for k, v in lins.items()}},
        device=device)

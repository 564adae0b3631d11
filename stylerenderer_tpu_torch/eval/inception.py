"""The FID InceptionV3 (counterpart of ``stylerenderer_tpu/eval/inception.py``).

The pt_inception-2015-12-05 network that FID is defined with (the
pytorch-fid port of the TF-slim graph), NCHW, with that network's torch
module names (``Conv2d_1a_3x3.conv.weight``,
``Mixed_5b.branch1x1.bn.running_mean``, ...), so its published state dict
loads as it is. The FID patches:

- the InceptionA/C/E average pools leave the padding out of the count
  (``count_include_pad=False``);
- the last InceptionE block (``Mixed_7c``) pools with a 3x3 stride-1 max
  pool, padded by 1;
- the max pools of the stem and of InceptionB/D are 3x3, stride 2,
  unpadded;
- batch norm always uses its stored statistics, eps 1e-3;
- images in [-1, 1] go in as they are, resized to 299x299 by the linear
  resize of ``jax.image.resize`` (antialiased when shrinking).

No weights are in the repository. ``load_patched_inception_v3`` loads a
local torch state dict (the FID checkpoint or torchvision's inception_v3);
without one it draws a fixed-seed random network as the JAX package's
random-feature mode does: flax's default kernels (truncated normal over
the fan-in) times sqrt(2), batch norm at identity. Without the sqrt(2) the
~90 conv + ReLU layers collapse every input to one point and FID reads 0.
FID in that mode is self-consistent, not comparable to published numbers.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from stylerenderer_tpu_torch.device import resolve_device
from stylerenderer_tpu_torch.ops.resize import resize_linear

# flax's truncated_normal initializer: a unit normal cut at +-2 has this
# standard deviation, which variance_scaling divides out
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(weight: torch.Tensor, generator: torch.Generator | None,
                  gain: float = 1.0) -> torch.Tensor:
    """In place, flax's default kernel init (``lecun_normal``: truncated
    normal at +-2 standard deviations, variance 1/fan_in) times ``gain``."""
    fan_in = weight[0].numel()
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
        weight.mul_(gain)
    return weight


class BasicConv2d(nn.Module):
    """conv (no bias) + batch norm (stored statistics, eps 1e-3) + ReLU."""

    def __init__(self, cin: int, cout: int, kernel_size, stride=1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel_size, stride, padding, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=1e-3)

    def forward(self, x):
        bn = self.bn
        x = F.batch_norm(self.conv(x), bn.running_mean, bn.running_var, bn.weight, bn.bias,
                         False, 0.0, bn.eps)
        return F.relu(x)


def _avgpool3(x):
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)


def _maxpool(x):
    return F.max_pool2d(x, 3, 2)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, 1)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(cin, pool_features, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avgpool3(x))
        return torch.cat([b1, b5, b3, bp], 1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3(x)
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([b3, bd, _maxpool(x)], 1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 192, 1)
        self.branch7x7_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for i in range(2, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        bp = self.branch_pool(_avgpool3(x))
        return torch.cat([b1, b7, bd, bp], 1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_1(x)
        for i in range(2, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, _maxpool(x)], 1)


class InceptionE(nn.Module):
    """``pool="max"``: the FID network's last block (``Mixed_7c``)."""

    def __init__(self, cin: int, pool: str = "avg"):
        super().__init__()
        self.pool = pool
        self.branch1x1 = BasicConv2d(cin, 320, 1)
        self.branch3x3_1 = BasicConv2d(cin, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        bp = F.max_pool2d(x, 3, 1, 1) if self.pool == "max" else _avgpool3(x)
        return torch.cat([b1, b3, bd, self.branch_pool(bp)], 1)


class InceptionV3(nn.Module):
    """FID feature extractor: images ``[B, 3, H, W]`` in [-1, 1] -> pool3
    features ``[B, 2048]``."""

    MIXED = ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b", "Mixed_6c",
             "Mixed_6d", "Mixed_6e", "Mixed_7a", "Mixed_7b", "Mixed_7c")

    def __init__(self, resize_input: bool = True):
        super().__init__()
        self.resize_input = resize_input
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, "avg")
        self.Mixed_7c = InceptionE(2048, "max")

    def forward(self, x):
        if self.resize_input:
            x = resize_linear(x.permute(0, 2, 3, 1), 299, 299).permute(0, 3, 1, 2)
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(_maxpool(x)))
        x = _maxpool(x)
        for name in self.MIXED:
            x = getattr(self, name)(x)
        return x.mean(dim=(2, 3))


def random_inception_(model: InceptionV3, seed: int = 0) -> InceptionV3:
    """In place, the random-feature mode: every conv kernel drawn as flax's
    default init times sqrt(2) from ``seed``, batch norm at identity."""
    g = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, BasicConv2d):
            lecun_normal_(m.conv.weight, g, gain=math.sqrt(2.0))
            m.bn.reset_parameters()
    return model


def load_patched_inception_v3(weights_path: str | None = None, *, seed: int = 0,
                              resize_input: bool = True, device="cuda") -> InceptionV3:
    """The FID network on ``device`` (``"cuda"`` unless asked otherwise), in
    eval mode with its parameters frozen. With ``weights_path`` (a torch
    state dict of the FID Inception or torchvision's inception_v3; keys the
    network does not have, such as torchvision's ``fc`` and ``AuxLogits``,
    are ignored) its weights are loaded; otherwise it is the fixed-seed
    random-feature network."""
    device = resolve_device(device)
    model = InceptionV3(resize_input=resize_input)
    if weights_path:
        sd = torch.load(weights_path, map_location="cpu")
        if hasattr(sd, "state_dict"):
            sd = sd.state_dict()
        own = model.state_dict()
        for k in own:
            if k in sd:
                own[k] = sd[k]
            elif not k.endswith("num_batches_tracked"):
                raise KeyError(f"{weights_path}: no {k}")
        model.load_state_dict(own, strict=True)
    else:
        random_inception_(model, seed)
    return model.to(device).eval().requires_grad_(False)

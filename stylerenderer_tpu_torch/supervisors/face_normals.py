"""The shape-from-shading normal estimator, a resnet18-encoder UNet
(counterpart of ``stylerenderer_tpu/supervisors/face_normals.py``), NCHW.

The reference's ``sfs`` supervisor (``train.py:504-509``) builds
face_normals' ``ResNetUNet(n_class=3)`` and loads ``data/model.pth``. The
modules carry that layout's names: torchvision's resnet18 trunk
(``conv1``, ``bn1``, ``layer{1-4}.{0,1}.conv1/bn1/conv2/bn2/downsample``),
the ``convrelu`` Sequentials (``layer{0-4}_1x1``, ``conv_up{0-3}``,
``conv_original_size{0-2}``, conv at ``.0``) and ``conv_last``; batch norm
eps 1e-5, with its stored statistics. The 2x upsampling is bilinear with
``align_corners=True``, ``F.interpolate``'s own (the JAX package builds the
same interpolation as two matrices).

Output ``(normals, raw)``: the raw 3-channel prediction unit-normalized,
with the clamp inside the sqrt, and the raw prediction.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from stylerenderer_tpu_torch.supervisors.convert import BatchNorm


class BasicBlock(nn.Module):
    """torchvision's resnet18 BasicBlock."""

    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, stride, 1, bias=False)
        self.bn1 = BatchNorm(cout)
        self.conv2 = nn.Conv2d(cout, cout, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm(cout)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(nn.Conv2d(cin, cout, 1, stride, bias=False),
                                            BatchNorm(cout))

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return F.relu(y + (x if self.downsample is None else self.downsample(x)))


def _convrelu(cin: int, cout: int, kernel: int, padding: int):
    return nn.Sequential(nn.Conv2d(cin, cout, kernel, padding=padding), nn.ReLU())


def _up(x):
    return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=True)


class ResNetUNet(nn.Module):
    """``[B, 3, H, W]`` images (H, W multiples of 32) -> ``(normals, raw)``,
    each ``[B, n_class, H, W]``."""

    def __init__(self, n_class: int = 3):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm(64)
        self.layer1 = nn.Sequential(BasicBlock(64, 64), BasicBlock(64, 64))
        self.layer2 = nn.Sequential(BasicBlock(64, 128, 2), BasicBlock(128, 128))
        self.layer3 = nn.Sequential(BasicBlock(128, 256, 2), BasicBlock(256, 256))
        self.layer4 = nn.Sequential(BasicBlock(256, 512, 2), BasicBlock(512, 512))
        self.layer0_1x1 = _convrelu(64, 64, 1, 0)
        self.layer1_1x1 = _convrelu(64, 64, 1, 0)
        self.layer2_1x1 = _convrelu(128, 128, 1, 0)
        self.layer3_1x1 = _convrelu(256, 256, 1, 0)
        self.layer4_1x1 = _convrelu(512, 512, 1, 0)
        self.conv_up3 = _convrelu(256 + 512, 512, 3, 1)
        self.conv_up2 = _convrelu(128 + 512, 256, 3, 1)
        self.conv_up1 = _convrelu(64 + 256, 256, 3, 1)
        self.conv_up0 = _convrelu(64 + 256, 128, 3, 1)
        self.conv_original_size0 = _convrelu(3, 64, 3, 1)
        self.conv_original_size1 = _convrelu(64, 64, 3, 1)
        self.conv_original_size2 = _convrelu(64 + 128, 64, 3, 1)
        self.conv_last = nn.Conv2d(64, n_class, 1)

    def forward(self, x):
        x_original = self.conv_original_size1(self.conv_original_size0(x))
        l0 = F.relu(self.bn1(self.conv1(x)))
        l1 = self.layer1(F.max_pool2d(l0, 3, 2, 1))
        l2 = self.layer2(l1)
        l3 = self.layer3(l2)
        l4 = self.layer4(l3)
        y = _up(self.layer4_1x1(l4))
        y = _up(self.conv_up3(torch.cat([y, self.layer3_1x1(l3)], 1)))
        y = _up(self.conv_up2(torch.cat([y, self.layer2_1x1(l2)], 1)))
        y = _up(self.conv_up1(torch.cat([y, self.layer1_1x1(l1)], 1)))
        y = _up(self.conv_up0(torch.cat([y, self.layer0_1x1(l0)], 1)))
        out = self.conv_last(self.conv_original_size2(torch.cat([y, x_original], 1)))
        n2 = torch.sum(out * out, dim=1, keepdim=True)
        return out / torch.sqrt(torch.clamp(n2, min=1e-12)), out

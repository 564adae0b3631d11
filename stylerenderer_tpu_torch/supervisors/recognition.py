"""The InceptionResnetV1 face embedding (counterpart of
``stylerenderer_tpu/supervisors/recognition.py``), NCHW.

The reference's ``feat`` supervisor (``train.py:523-526``) is
facenet-pytorch's ``InceptionResnetV1`` with the vggface2 weights. The
modules carry facenet-pytorch's names: the stem ``conv2d_{1a,2a,2b,3b,4a,
4b}``, ``repeat_1`` (5 Block35, scale 0.17), ``mixed_6a``, ``repeat_2``
(10 Block17, scale 0.10), ``mixed_7a``, ``repeat_3`` (5 Block8, scale 0.20)
and ``block8`` (no activation), each BasicConv2d a ``conv`` without bias
and a ``bn`` (eps 1e-3, stored statistics), each block's ``conv2d`` 1x1
with a bias; ``last_linear`` without a bias and ``last_bn`` in inference
form. The max pools are 3x3, stride 2, unpadded.

Input ``[B, 3, S, S]`` in [-1, 1] (S >= 75: the unpadded convs and pools);
output the ``[B, 512]`` embedding, L2-normalized with a 1e-8 clamp.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from stylerenderer_tpu_torch.supervisors.convert import BatchNorm


class BasicConv2d(nn.Module):
    def __init__(self, cin: int, cout: int, kernel, stride=1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride, padding, bias=False)
        self.bn = BatchNorm(cout, eps=1e-3)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def _maxpool(x):
    return F.max_pool2d(x, 3, 2)


class Block35(nn.Module):
    def __init__(self, scale: float = 0.17):
        super().__init__()
        self.scale = scale
        self.branch0 = BasicConv2d(256, 32, 1)
        self.branch1 = nn.Sequential(BasicConv2d(256, 32, 1), BasicConv2d(32, 32, 3, 1, 1))
        self.branch2 = nn.Sequential(BasicConv2d(256, 32, 1), BasicConv2d(32, 32, 3, 1, 1),
                                     BasicConv2d(32, 32, 3, 1, 1))
        self.conv2d = nn.Conv2d(96, 256, 1)

    def forward(self, x):
        up = self.conv2d(torch.cat([self.branch0(x), self.branch1(x), self.branch2(x)], 1))
        return F.relu(x + self.scale * up)


class Block17(nn.Module):
    def __init__(self, scale: float = 0.10):
        super().__init__()
        self.scale = scale
        self.branch0 = BasicConv2d(896, 128, 1)
        self.branch1 = nn.Sequential(BasicConv2d(896, 128, 1),
                                     BasicConv2d(128, 128, (1, 7), 1, (0, 3)),
                                     BasicConv2d(128, 128, (7, 1), 1, (3, 0)))
        self.conv2d = nn.Conv2d(256, 896, 1)

    def forward(self, x):
        up = self.conv2d(torch.cat([self.branch0(x), self.branch1(x)], 1))
        return F.relu(x + self.scale * up)


class Block8(nn.Module):
    def __init__(self, scale: float = 0.20, noReLU: bool = False):
        super().__init__()
        self.scale, self.noReLU = scale, noReLU
        self.branch0 = BasicConv2d(1792, 192, 1)
        self.branch1 = nn.Sequential(BasicConv2d(1792, 192, 1),
                                     BasicConv2d(192, 192, (1, 3), 1, (0, 1)),
                                     BasicConv2d(192, 192, (3, 1), 1, (1, 0)))
        self.conv2d = nn.Conv2d(384, 1792, 1)

    def forward(self, x):
        y = x + self.scale * self.conv2d(torch.cat([self.branch0(x), self.branch1(x)], 1))
        return y if self.noReLU else F.relu(y)


class Mixed_6a(nn.Module):
    def __init__(self):
        super().__init__()
        self.branch0 = BasicConv2d(256, 384, 3, 2)
        self.branch1 = nn.Sequential(BasicConv2d(256, 192, 1), BasicConv2d(192, 192, 3, 1, 1),
                                     BasicConv2d(192, 256, 3, 2))

    def forward(self, x):
        return torch.cat([self.branch0(x), self.branch1(x), _maxpool(x)], 1)


class Mixed_7a(nn.Module):
    def __init__(self):
        super().__init__()
        self.branch0 = nn.Sequential(BasicConv2d(896, 256, 1), BasicConv2d(256, 384, 3, 2))
        self.branch1 = nn.Sequential(BasicConv2d(896, 256, 1), BasicConv2d(256, 256, 3, 2))
        self.branch2 = nn.Sequential(BasicConv2d(896, 256, 1), BasicConv2d(256, 256, 3, 1, 1),
                                     BasicConv2d(256, 256, 3, 2))

    def forward(self, x):
        return torch.cat([self.branch0(x), self.branch1(x), self.branch2(x), _maxpool(x)], 1)


class InceptionResnetV1(nn.Module):
    def __init__(self, emb_dim: int = 512):
        super().__init__()
        self.conv2d_1a = BasicConv2d(3, 32, 3, 2)
        self.conv2d_2a = BasicConv2d(32, 32, 3)
        self.conv2d_2b = BasicConv2d(32, 64, 3, 1, 1)
        self.conv2d_3b = BasicConv2d(64, 80, 1)
        self.conv2d_4a = BasicConv2d(80, 192, 3)
        self.conv2d_4b = BasicConv2d(192, 256, 3, 2)
        self.repeat_1 = nn.Sequential(*[Block35() for _ in range(5)])
        self.mixed_6a = Mixed_6a()
        self.repeat_2 = nn.Sequential(*[Block17() for _ in range(10)])
        self.mixed_7a = Mixed_7a()
        self.repeat_3 = nn.Sequential(*[Block8() for _ in range(5)])
        self.block8 = Block8(noReLU=True)
        self.last_linear = nn.Linear(1792, emb_dim, bias=False)
        self.last_bn = BatchNorm(emb_dim, eps=1e-3)

    def forward(self, x):
        x = self.conv2d_2b(self.conv2d_2a(self.conv2d_1a(x)))
        x = self.conv2d_4b(self.conv2d_4a(self.conv2d_3b(_maxpool(x))))
        x = self.repeat_3(self.mixed_7a(self.repeat_2(self.mixed_6a(self.repeat_1(x)))))
        x = torch.mean(self.block8(x), dim=(2, 3))
        x = self.last_bn(self.last_linear(x))
        return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-8)

"""The PFLD landmark regressor (counterpart of
``stylerenderer_tpu/supervisors/landmark.py``), NCHW.

The reference's ``lmk`` supervisor (``train.py:513-519``) is
pytorch_face_landmark's ``PFLDInference`` with
``pfld_model_best.pth.tar['state_dict']``. The modules carry PFLD-pytorch's
names: MobileNet-v2 inverted residuals (``conv3_1``, ``block3_{2-5}``,
``conv4_1``, ``conv5_1``, ``block5_{2-6}``, ``conv6_1``), each a ``conv``
Sequential with the 1x1 expansion, the depthwise 3x3 (``groups=hidden``)
and the 1x1 projection at indices 0, 3 and 6 and their batch norms at 1, 4
and 7; ``conv7`` a conv-bn-relu Sequential; ``conv8`` 7x7, unpadded, with a
bias; ``fc``. Batch norm eps 1e-5, with its stored statistics. The head
pools three scales (the 14x14 16-channel map, the 7x7 32-channel map, the
1x1 128-channel map) into 176 features.

Input ``[B, 3, 112, 112]`` in [0, 1]; output ``[B, 2 * n_points]``
landmarks in [0, 1] of the crop.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from stylerenderer_tpu_torch.supervisors.convert import BatchNorm


class InvertedResidual(nn.Module):
    """1x1 expand, bn, relu; 3x3 depthwise, bn, relu; 1x1 project, bn; plus
    the input when ``use_res`` and the shapes allow."""

    def __init__(self, cin: int, cout: int, stride: int, use_res: bool, expand: int):
        super().__init__()
        self.use_res_connect = use_res and stride == 1 and cin == cout
        hidden = cin * expand
        self.conv = nn.Sequential(
            nn.Conv2d(cin, hidden, 1, 1, 0, bias=False),
            BatchNorm(hidden),
            nn.ReLU(),
            nn.Conv2d(hidden, hidden, 3, stride, 1, groups=hidden, bias=False),
            BatchNorm(hidden),
            nn.ReLU(),
            nn.Conv2d(hidden, cout, 1, 1, 0, bias=False),
            BatchNorm(cout),
        )

    def forward(self, x):
        y = self.conv(x)
        return x + y if self.use_res_connect else y


class PFLDInference(nn.Module):
    def __init__(self, n_points: int = 68):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 3, 2, 1, bias=False)
        self.bn1 = BatchNorm(64)
        self.conv2 = nn.Conv2d(64, 64, 3, 1, 1, groups=64, bias=False)
        self.bn2 = BatchNorm(64)
        self.conv3_1 = InvertedResidual(64, 64, 2, False, 2)
        for i in range(2, 6):
            setattr(self, f"block3_{i}", InvertedResidual(64, 64, 1, True, 2))
        self.conv4_1 = InvertedResidual(64, 128, 2, False, 2)
        self.conv5_1 = InvertedResidual(128, 128, 1, False, 4)
        for i in range(2, 7):
            setattr(self, f"block5_{i}", InvertedResidual(128, 128, 1, True, 4))
        self.conv6_1 = InvertedResidual(128, 16, 1, False, 2)
        self.conv7 = nn.Sequential(nn.Conv2d(16, 32, 3, 2, 1, bias=False), BatchNorm(32),
                                   nn.ReLU())
        self.conv8 = nn.Conv2d(32, 128, 7, 1, 0)
        self.fc = nn.Linear(176, 2 * n_points)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.conv3_1(y)
        for i in range(2, 6):
            y = getattr(self, f"block3_{i}")(y)
        y = self.conv5_1(self.conv4_1(y))
        for i in range(2, 7):
            y = getattr(self, f"block5_{i}")(y)
        y = self.conv6_1(y)
        s1 = torch.mean(y, dim=(2, 3))
        y = self.conv7(y)
        s2 = torch.mean(y, dim=(2, 3))
        s3 = F.relu(self.conv8(y)).flatten(1)
        return self.fc(torch.cat([s1, s2, s3], 1))

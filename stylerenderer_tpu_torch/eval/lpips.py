"""LPIPS perceptual distance, net-lin over VGG16 or AlexNet (counterpart of
``stylerenderer_tpu/eval/lpips.py``).

Images in [-1, 1] are shifted and scaled by the reference's constants and
run through the backbone; at each of five taps the channel vectors are
unit-normalized, their squared difference is weighted by a non-negative
1x1 head, averaged over space and summed over the taps. NCHW.

State-dict names: the backbone is torchvision's ``features`` (``features.
{index}.weight``), the heads are the published ``lin{i}.model.1.weight``
``[1, C, 1, 1]``, so both load as they are. No weights are in the
repository: without a backbone state dict ``load_lpips`` draws a
fixed-seed random one (flax's default init, as the JAX package's random
mode), and without head weights each head is ``1/C`` (the JAX package's
default). Distances are then self-consistent, not the published metric.
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F
from torch import nn

from stylerenderer_tpu_torch.device import resolve_device
from stylerenderer_tpu_torch.eval.inception import lecun_normal_

# the reference's ScalingLayer constants
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

# torchvision's ``features``, cut after the last tap: channels, or "M" for
# a 2x2 max pool (VGG16); (out, kernel, stride, padding) or "M" for a 3x3
# stride-2 max pool (AlexNet)
VGG16_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
             512, 512, 512)
ALEX_CFG = ((64, 11, 4, 2), "M", (192, 5, 1, 2), "M", (384, 3, 1, 1), (256, 3, 1, 1),
            (256, 3, 1, 1))
CHANNELS = {"vgg": (64, 128, 256, 512, 512), "alex": (64, 192, 384, 256, 256)}
# indices in ``features`` of the convs, and of the ReLUs that are tapped
CONV_INDICES = {"vgg": (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28),
                "alex": (0, 3, 6, 8, 10)}
TAPS = {"vgg": (3, 8, 15, 22, 29), "alex": (1, 4, 7, 9, 11)}
# the published heads' default place, inside the checkout; absent, the
# heads stay at 1/C
HEADS_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "weights", "lpips", "v0.1")


def _features(net: str) -> nn.Sequential:
    layers, cin = [], 3
    if net == "vgg":
        for v in VGG16_CFG:
            if v == "M":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers += [nn.Conv2d(cin, v, 3, padding=1), nn.ReLU()]
                cin = v
    else:
        for v in ALEX_CFG:
            if v == "M":
                layers.append(nn.MaxPool2d(3, 2))
            else:
                cout, k, s, p = v
                layers += [nn.Conv2d(cin, cout, k, s, p), nn.ReLU()]
                cin = cout
    return nn.Sequential(*layers)


class _LinHead(nn.Module):
    """A published head's layout (dropout, then a bias-free 1x1 conv); only
    its weight is used."""

    def __init__(self, channels: int):
        super().__init__()
        self.model = nn.Sequential(nn.Dropout(), nn.Conv2d(channels, 1, 1, bias=False))
        with torch.no_grad():
            self.model[1].weight.fill_(1.0 / channels)


def _unit_normalize(f, eps: float = 1e-10):
    """``f`` over its channel norm, the clamp inside the sqrt: the
    reference's ``sqrt(sum f^2) + eps`` has a NaN gradient with respect to
    a feature vector that is exactly zero (a flat render's background), and
    inversion differentiates through LPIPS. Values differ only where
    ``||f|| < eps``, where the term is ~0 anyway."""
    n2 = torch.sum(f * f, dim=1, keepdim=True)
    return f / torch.sqrt(torch.clamp(n2, min=eps * eps))


class LPIPS(nn.Module):
    """``lpips(x0, x1)``: images ``[B, 3, H, W]`` in [-1, 1] -> ``[B]``."""

    def __init__(self, net: str = "vgg"):
        super().__init__()
        if net not in CHANNELS:
            raise ValueError(f"net {net!r}: 'vgg' or 'alex'")
        self.net = net
        self.features = _features(net)
        for i, c in enumerate(CHANNELS[net]):
            self.add_module(f"lin{i}", _LinHead(c))
        self.register_buffer("shift", torch.tensor(_SHIFT).view(1, 3, 1, 1), persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE).view(1, 3, 1, 1), persistent=False)

    def taps(self, x):
        """The five tapped ReLU outputs of the scaled images."""
        x = (x - self.shift) / self.scale
        out, taps = [], TAPS[self.net]
        for i, layer in enumerate(self.features[:taps[-1] + 1]):
            x = layer(x)
            if i in taps:
                out.append(x)
        return out

    def forward(self, x0, x1):
        b = x0.shape[0]
        total = 0.0
        for i, f in enumerate(self.taps(torch.cat([x0, x1.to(x0.dtype)]))):
            d = (_unit_normalize(f[:b]) - _unit_normalize(f[b:])) ** 2
            w = F.relu(getattr(self, f"lin{i}").model[1].weight)  # [1, C, 1, 1]
            total = total + torch.sum(d * w, dim=1).mean(dim=(1, 2))
        return total


def load_lpips(net: str = "vgg", backbone_weights: str | None = None,
               linear_weights: str | None = None, *, seed: int = 0,
               device="cuda") -> LPIPS:
    """An ``LPIPS`` module on ``device`` (``"cuda"`` unless asked
    otherwise), in eval mode with its parameters frozen.

    ``backbone_weights``: a torchvision VGG16 / AlexNet state dict, whose
    ``features`` convs are loaded (other keys are ignored); without it the
    backbone is drawn from ``seed``. ``linear_weights``: the published heads
    (``lin{i}.model.1.weight``); by default ``HEADS_DIR/{net}.pth`` when that
    file exists, else every head is ``1/C``."""
    device = resolve_device(device)
    model = LPIPS(net)
    g = torch.Generator().manual_seed(seed)
    for tid in CONV_INDICES[net]:
        conv = model.features[tid]
        lecun_normal_(conv.weight, g)
        nn.init.zeros_(conv.bias)
    sd = model.state_dict()
    if linear_weights is None:
        cand = os.path.join(HEADS_DIR, f"{net}.pth")
        linear_weights = cand if os.path.exists(cand) else None
    for path, prefixes in ((backbone_weights, ("features.",)), (linear_weights, ("lin",))):
        if path:
            src = torch.load(path, map_location="cpu")
            if hasattr(src, "state_dict"):
                src = src.state_dict()
            sd.update({k: v for k, v in src.items()
                       if k in sd and k.startswith(prefixes)})
    model.load_state_dict(sd, strict=True)
    return model.to(device).eval().requires_grad_(False)

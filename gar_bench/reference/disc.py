"""The StyleGAN2 residual discriminator in plain PyTorch, for the benchmark's
check (Karras et al. 2020, arXiv:1912.04958, config F's residual D).

A 1x1 from-RGB conv, ResBlocks from ``size`` down to 4 px (conv3x3, then
[1, 3, 3, 1] blur and a stride-2 conv3x3, beside a blurred stride-2 1x1
skip, summed over sqrt(2)), the minibatch-stddev channel, a 3x3 conv and
two linears. Equalised learning rate (weights scaled by ``1 / sqrt(fan_in)``
at run time), bias + LeakyReLU(0.2) times sqrt(2). NCHW.

Departures from the published description, as the GAR reference's model
(whose state-dict names ``param_spec`` gives) has them:

- an activated conv keeps its own bias beside the activation's
  (``conv.0.bias`` and ``conv.1.bias``; rosinality's model drops the first);
- the 4x4 features are flattened (C, H, W) before the first linear.

``q`` rounds every conv's operands and every layer's output, ``qm`` the
linears' operands (identity in the check; in the control, the precision
below the one the configuration states for the synthesis's convolutions
and for the matrix products).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from gar_bench.reference.gar import _blur, _same, channels, lrelu


def _conv_spec(p, cin, cout, k, down: bool, bias: bool = True, act: bool = True):
    i = 1 if down else 0
    spec = [(f"{p}.{i}.weight", (cout, cin, k, k), "w")]
    if bias:
        spec.append((f"{p}.{i}.bias", (cout,), "b"))
    if act:
        spec.append((f"{p}.{i + 1}.bias", (cout,), "b"))
    return spec


def param_spec(cfg: dict) -> list[tuple[str, tuple, str]]:
    """``(name, shape, kind)`` of every parameter of the discriminator of
    ``cfg`` (its ``discriminator`` group and ``size``). Kinds: ``w`` N(0, 1),
    ``b`` 0.1 N(0, 1)."""
    dc, size = cfg["discriminator"], cfg["size"]
    ch = channels(dc["channel_multiplier"])
    spec = _conv_spec("convs.0", 3, ch[size], 1, False)
    cin, n = ch[size], 1
    r = size
    while r > 4:
        cout = ch[r // 2]
        spec += _conv_spec(f"convs.{n}.conv1", cin, cin, 3, False)
        spec += _conv_spec(f"convs.{n}.conv2", cin, cout, 3, True)
        spec += _conv_spec(f"convs.{n}.skip", cin, cout, 1, True, bias=False, act=False)
        cin, n, r = cout, n + 1, r // 2
    spec += _conv_spec("final_conv", cin + dc["stddev_feat"], ch[4], 3, False)
    spec += [("final_linear.0.weight", (ch[4], ch[4] * 16), "w"),
             ("final_linear.0.bias", (ch[4],), "b"),
             ("final_linear.1.weight", (1, ch[4]), "w"),
             ("final_linear.1.bias", (1,), "b")]
    return spec


def weights(cfg: dict, normal: torch.Tensor) -> dict[str, torch.Tensor]:
    """The parameters by name from one flat N(0, 1) draw ``normal`` of
    ``n_params(cfg)`` elements, scaled by kind."""
    out, at = {}, 0
    for name, shape, kind in param_spec(cfg):
        n = math.prod(shape)
        t = normal[at:at + n].reshape(shape)
        at += n
        out[name] = (0.1 * t if kind == "b" else t).contiguous()
    return out


def n_params(cfg: dict) -> int:
    return sum(math.prod(shape) for _, shape, _ in param_spec(cfg))


def _kernel(cfg, device):
    k = torch.tensor(cfg["blur_kernel"], dtype=torch.float32, device=device)
    k = k[None, :] * k[:, None]
    return k / k.sum()


def _conv(P, p, x, k, down: bool, k2, q, bias=True, act=True):
    """``convs``/``final_conv`` layer ``p``: [blur,] conv, bias, activation."""
    i = 1 if down else 0
    W = P[f"{p}.{i}.weight"]
    if down:
        pad = len(k2) - 2 + (k - 1)
        x = q(_blur(x, k2, ((pad + 1) // 2, pad // 2)))
    y = F.conv2d(q(x), q(W * (1.0 / math.sqrt(W[0].numel()))), stride=2 if down else 1,
                 padding=0 if down else k // 2)
    if bias:
        y = y + P[f"{p}.{i}.bias"][None, :, None, None]
    y = q(y)
    return q(lrelu(y, P[f"{p}.{i + 1}.bias"])) if act else y


def minibatch_stddev(x, group: int, feat: int):
    """Samples grouped as ``reshape(g, b // g, ...)``, ``g = min(b, group)``:
    per group, the biased std over its ``g`` members (+1e-8 inside the
    sqrt), averaged over (C / f, H, W), appended as ``f`` channels."""
    b, c, h, w = x.shape
    g = min(b, group)
    y = x.reshape(g, b // g, feat, c // feat, h, w)
    std = torch.sqrt(torch.var(y, dim=0, unbiased=False) + 1e-8).mean(dim=(2, 3, 4))
    std = std[None, :, :, None, None].expand(g, b // g, feat, h, w).reshape(b, feat, h, w)
    return torch.cat([x, std], 1)


def forward(P, x, cfg, q=_same, qm=_same):
    """Logits ``[B, 1]`` of images ``x`` ``[B, 3, size, size]``."""
    dc, k2 = cfg["discriminator"], _kernel(cfg, x.device)
    out = _conv(P, "convs.0", x, 1, False, k2, q)
    n, r = 1, cfg["size"]
    while r > 4:
        h = _conv(P, f"convs.{n}.conv1", out, 3, False, k2, q)
        h = _conv(P, f"convs.{n}.conv2", h, 3, True, k2, q)
        s = _conv(P, f"convs.{n}.skip", out, 1, True, k2, q, bias=False, act=False)
        out = q((h + s) / math.sqrt(2.0))
        n, r = n + 1, r // 2
    out = q(minibatch_stddev(out, dc["stddev_group"], dc["stddev_feat"]))
    out = _conv(P, "final_conv", out, 3, False, k2, q).reshape(x.shape[0], -1)
    W0, W1 = P["final_linear.0.weight"], P["final_linear.1.weight"]
    out = q(lrelu(qm(out) @ qm(W0 * (1.0 / math.sqrt(W0.shape[1]))).t(),
                  P["final_linear.0.bias"]))
    return qm(out) @ qm(W1 * (1.0 / math.sqrt(W1.shape[1]))).t() + P["final_linear.1.bias"]

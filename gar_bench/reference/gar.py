"""The GAR in plain PyTorch, for the benchmark's check: the mapping network
and the synthesis network of StyleGAN2 config-f conditioned on a pyramid of
normal maps (Karras et al. 2020, arXiv:1912.04958, with the GAR's per-level
ResBlocks whose (scale, shift) maps modulate each styled conv between the
conv and the noise).

Weights are a dict by the reference model's state-dict names
(``param_spec``), drawn by the benchmark. Layers follow the published
equations: equalised learning rate (weights scaled by ``lr_mul /
sqrt(fan_in)`` at run time), the modulated conv ``demod * conv(x * style,
W)``, the transposed conv of an upsampling layer counted at its input
resolution and followed by the [1, 3, 3, 1] blur, bias + LeakyReLU(0.2)
times sqrt(2), ToRGB without demodulation with the upsampled skip. NCHW.

``q`` rounds every conv's and linear's operands and every layer's output
(identity in the check, a lower precision in the control).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

SQRT2 = math.sqrt(2.0)


def _same(t):
    return t


def channels(cm: int) -> dict[int, int]:
    return {4: 512, 8: 512, 16: 512, 32: 512, 64: 256 * cm, 128: 128 * cm,
            256: 64 * cm, 512: 32 * cm, 1024: 16 * cm}


def levels(size: int) -> list[int]:
    """Resolutions of the synthesis, 4 .. size."""
    return [2 ** i for i in range(2, int(math.log2(size)) + 1)]


def n_latent(size: int) -> int:
    return int(math.log2(size)) * 2 - 2


def noise_shapes(size: int) -> list[int]:
    """Resolution of each noise layer: 4, then two per level 8 .. size."""
    return [4] + [r for r in levels(size)[1:] for _ in (0, 1)]


def _resblock_spec(p, cin, cout):
    return [(f"{p}.conv1.0.weight", (cin, cin, 3, 3), "w"), (f"{p}.conv1.0.bias", (cin,), "b"),
            (f"{p}.conv1.1.bias", (cin,), "b"),
            (f"{p}.conv2.0.weight", (cout, cin, 3, 3), "w"), (f"{p}.conv2.0.bias", (cout,), "b"),
            (f"{p}.conv2.1.bias", (cout,), "b"),
            (f"{p}.skip.0.weight", (cout, cin, 1, 1), "w")]


def _modconv_spec(p, cin, cout, k, dim):
    return [(f"{p}.weight", (1, cout, cin, k, k), "w"),
            (f"{p}.modulation.weight", (cin, dim), "w"),
            (f"{p}.modulation.bias", (cin,), "b_mod")]


def _styled_spec(p, cin, cout, dim):
    return _modconv_spec(f"{p}.conv", cin, cout, 3, dim) + [
        (f"{p}.noise.weight", (1,), "noise"), (f"{p}.activate.bias", (cout,), "b")]


def _torgb_spec(p, cin, dim):
    return _modconv_spec(f"{p}.conv", cin, 3, 1, dim) + [(f"{p}.bias", (1, 3, 1, 1), "b")]


def param_spec(cfg: dict) -> list[tuple[str, tuple, str]]:
    """``(name, shape, kind)`` of every parameter of the GAR of ``cfg``
    (``n_stylemap`` 3). Kinds: ``w`` N(0, 1); ``w_map`` N(0, 1) / lr_mul;
    ``b_map`` 0; ``b`` 0.1 N(0, 1); ``b_mod`` 1 + 0.1 N(0, 1); ``noise``
    0.1 N(0, 1)."""
    if cfg["n_stylemap"] != 3:
        raise ValueError("the reference GAR takes n_stylemap 3")
    dim, ch = cfg["style_dim"], channels(cfg["channel_multiplier"])
    spec = []
    for i in range(1, cfg["n_mlp"] + 1):
        spec += [(f"style.{i}.weight", (dim, dim), "w_map"), (f"style.{i}.bias", (dim,), "b_map")]
    spec.append(("input.input", (1, ch[4], 4, 4), "w"))
    spec += _resblock_spec("norm1", 3, 2)
    spec += _styled_spec("conv1", ch[4], ch[4], dim)
    spec += _torgb_spec("to_rgb1", ch[4], dim)
    cin = ch[4]
    for n, r in enumerate(levels(cfg["size"])[1:]):
        spec += _styled_spec(f"convs.{2 * n}", cin, ch[r], dim)
        spec += _styled_spec(f"convs.{2 * n + 1}", ch[r], ch[r], dim)
        spec += _resblock_spec(f"norm_to_style.{n}", 3, 4)
        spec += _torgb_spec(f"to_rgbs.{n}", ch[r], dim)
        cin = ch[r]
    return spec


def lrelu(x, b=None):
    if b is not None:
        x = x + b.reshape((1, -1) + (1,) * (x.ndim - 2))
    return F.leaky_relu(x, 0.2) * SQRT2


def mapping(P, z, cfg, q=_same):
    """PixelNorm, then ``n_mlp`` equalised linears with bias and LeakyReLU."""
    lr, dim = cfg["lr_mlp"], cfg["style_dim"]
    x = z * torch.rsqrt(torch.mean(z * z, dim=-1, keepdim=True) + 1e-8)
    for i in range(1, cfg["n_mlp"] + 1):
        W = P[f"style.{i}.weight"] * (lr / math.sqrt(dim))
        x = q(lrelu(q(x) @ q(W).t(), P[f"style.{i}.bias"] * lr))
    return x


def _blur(x, k, pad):
    """True convolution of every channel with ``k`` after padding ``pad``."""
    C, kh = x.shape[1], k.shape[0]
    x = F.pad(x, [pad[0], pad[1], pad[0], pad[1]])
    return F.conv2d(x, torch.flip(k, (0, 1))[None, None].expand(C, 1, kh, kh), groups=C)


def _up2(x, k):
    """2x FIR upsampling (zero-stuffed, ``k`` of 4 taps scaled by 4, pads
    (2, 1)) as a depthwise transposed conv: 4 taps an output pixel."""
    C, n = x.shape[1], x.shape[2]
    y = F.conv_transpose2d(x, k[None, None].expand(C, 1, 4, 4), stride=2, groups=C)
    return y[:, :, 1:2 * n + 1, 1:2 * n + 1]


def fir(cfg, device):
    k = torch.tensor(cfg["blur_kernel"], dtype=torch.float32, device=device)
    k = k[None, :] * k[:, None]
    return k / k.sum() * 4.0


def modconv(P, p, x, style, demod: bool, up: bool, q=_same, qm=_same, k4=None):
    """The modulated conv ``p`` on ``x`` for ``style`` ``[B, D]``."""
    W = P[f"{p}.weight"][0]
    cout, cin, k, _ = W.shape
    w = W * (1.0 / math.sqrt(cin * k * k))
    M = P[f"{p}.modulation.weight"]
    s = qm(style) @ qm(M * (1.0 / math.sqrt(M.shape[1]))).t() + P[f"{p}.modulation.bias"]
    xs = q(x * s[:, :, None, None])
    if up:
        y = F.conv_transpose2d(xs, q(w).transpose(0, 1), stride=2)
    else:
        y = F.conv2d(xs, q(w), padding=k // 2)
    y = q(y)
    if demod:
        d = torch.rsqrt((s * s) @ torch.sum(w * w, dim=(2, 3)).t() + 1e-8)
        y = q(y * d[:, :, None, None])
    if up:
        y = q(_blur(y, k4, (1, 1)))
    return y


def _conv(P, p, x, pad, q, bias=True):
    W = P[f"{p}.weight"]
    y = F.conv2d(q(x), q(W * (1.0 / math.sqrt(W[0].numel()))), padding=pad)
    return q(y + P[f"{p}.bias"][None, :, None, None]) if bias else q(y)


def resblock(P, p, x, q=_same):
    h = q(lrelu(_conv(P, f"{p}.conv1.0", x, 1, q), P[f"{p}.conv1.1.bias"]))
    h = q(lrelu(_conv(P, f"{p}.conv2.0", h, 1, q), P[f"{p}.conv2.1.bias"]))
    return q((h + _conv(P, f"{p}.skip.0", x, 0, q, bias=False)) / SQRT2)


def _styled(P, p, x, style, film, noise, q, qm, k4, up=False):
    x = modconv(P, f"{p}.conv", x, style, True, up, q, qm, k4)
    x = q(x * film[:, 0:1] + film[:, 1:2])
    x = q(x + P[f"{p}.noise.weight"] * noise)
    return q(lrelu(x, P[f"{p}.activate.bias"]))


def _torgb(P, p, x, style, skip, q, qm, k4):
    y = q(modconv(P, f"{p}.conv", x, style, False, False, q, qm) + P[f"{p}.bias"])
    return y if skip is None else q(y + q(_up2(skip, k4)))


def synthesis(P, latent, maps, noise, cfg, q=_same, qm=_same):
    """Image ``[B, 3, size, size]`` from per-layer latents ``[B, n_latent,
    D]``, normal maps ``[B, s, s, 3]`` (4 .. size) and noise ``[B or 1, 1,
    r, r]`` per layer."""
    k4 = fir(cfg, latent.device)
    maps = [q(m.permute(0, 3, 1, 2)) for m in maps]
    B = latent.shape[0]
    x = P["input.input"].expand(B, -1, -1, -1)
    x = _styled(P, "conv1", x, latent[:, 0], resblock(P, "norm1", maps[0], q), noise[0],
                q, qm, k4)
    skip = _torgb(P, "to_rgb1", x, latent[:, 1], None, q, qm, k4)
    i = 1
    for n in range(len(maps) - 1):
        film = resblock(P, f"norm_to_style.{n}", maps[n + 1], q)
        x = _styled(P, f"convs.{2 * n}", x, latent[:, i], film[:, :2], noise[1 + 2 * n],
                    q, qm, k4, up=True)
        x = _styled(P, f"convs.{2 * n + 1}", x, latent[:, i + 1], film[:, 2:],
                    noise[2 + 2 * n], q, qm, k4)
        skip = _torgb(P, f"to_rgbs.{n}", x, latent[:, i + 2], skip, q, qm, k4)
        i += 2
    return skip

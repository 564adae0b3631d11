"""Inputs and a float64 oracle for the styled conv's epilogue
(``ops/fused_act.py::fused_bias_act``), shared by the CPU tests and the
card tests (torch only, no JAX)."""

import torch

# (channels, size) of the styled convs at 1024 px (config-f's table; the
# 256 px synthesis's are its first seven), and of the ResBlocks' 2-, 3- and
# 4-channel maps
SYNTH_1024 = ((512, 4), (512, 8), (512, 16), (512, 32), (512, 64), (256, 128), (128, 256),
              (64, 512), (32, 1024))
RESBLOCK = ((2, 4), (3, 64), (4, 1024))
# the noise maps: per sample, shared by the batch, the projector's one zero
NOISE_KINDS = ("batch", "shared", "scalar")


def bits(t: torch.Tensor) -> torch.Tensor:
    """The tensor's bits, so that -0.0 and +0.0 (and NaNs) compare apart."""
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int16)


def inputs(n, c, h, w, dtype, film=True, noise="batch", demod=True, seed=0, device="cpu"):
    """Random ``fused_bias_act`` arguments: ``y`` and ``film`` (a
    ``[n, 2, h, w]`` view of a 4-channel map, as the GAR passes it) in
    ``dtype``, float32 ``demod``, ``bias``, ``noise`` (``noise`` one of
    ``NOISE_KINDS`` or None) and its weight."""
    g = torch.Generator().manual_seed(seed)
    a = {"y": torch.randn(n, c, h, w, generator=g).to(dtype),
         "bias": 0.5 * torch.randn(c, generator=g)}
    if demod:
        a["demod"] = 0.5 + torch.rand(n, c, generator=g)
    if film:
        a["film"] = torch.randn(n, 4, h, w, generator=g).to(dtype)[:, 2:]
    if noise is not None:
        shape = {"batch": (n, 1, h, w), "shared": (1, 1, h, w), "scalar": (1, 1, 1, 1)}[noise]
        a["noise"] = (torch.zeros(shape) if noise == "scalar"
                      else torch.randn(shape, generator=g))
        a["noise_weight"] = torch.tensor([0.3])
    return {k: v.to(device) for k, v in a.items()}


def rounded_once(y, **terms):
    """What the kernel computes: the plain chain in float32 on the
    arguments widened to float32, the gain rounded to ``y``'s dtype, the
    result rounded once to ``y``'s dtype."""
    from stylerenderer_tpu_torch.ops.fused_act import fused_bias_act_ref

    wide = {k: v.float() if k in ("film", "noise") else v for k, v in terms.items()}
    gain = float(torch.tensor(2 ** 0.5, dtype=y.dtype))
    return fused_bias_act_ref(y.float(), **wide, scale=gain).to(y.dtype)


def oracle(y, bias=None, demod=None, film=None, noise=None, noise_weight=None,
           negative_slope=0.2, scale=2 ** 0.5):
    """-> (the epilogue in float64 on the given values, the gain rounded to
    ``y``'s dtype as the port rounds it; the sum of its terms' magnitudes
    times the gain, which bounds float32's rounding of the sum)."""
    t = y.double()
    if demod is not None:
        t = t * demod.double()[:, :, None, None]
    mag = t.abs()
    if film is not None:
        t = t * film[:, 0:1].double()
        mag = t.abs() + film[:, 1:2].double().abs()
        t = t + film[:, 1:2].double()
    if noise is not None:
        t = t + noise_weight.double() * noise.double()
        mag = mag + (noise_weight.double() * noise.double()).abs()
    if bias is not None:
        b = bias.double().reshape([1, -1] + [1] * (y.ndim - 2))
        t, mag = t + b, mag + b.abs()
    gain = float(torch.tensor(scale, dtype=y.dtype))
    return torch.where(t >= 0, t, t * negative_slope) * gain, mag * gain


def max_gap(out: torch.Tensor, ref: torch.Tensor, mag: torch.Tensor) -> float:
    """The largest gap of ``out`` from the float64 ``ref`` in units of one
    rounding of ``out``: an ulp of ``out``'s value in its dtype, plus the
    float32 rounding of a sum of terms of magnitude ``mag`` (2^-21 of it:
    its five roundings), which is what remains where the terms cancel."""
    o = out.double()
    e = torch.floor(torch.log2(o.abs().clamp_min(2.0 ** -126)))
    ulp = 2.0 ** (e - (7 if out.dtype == torch.bfloat16 else 23))
    return float(((o - ref.double().to(o.device)).abs() / (ulp + 2.0 ** -21 * mag)).max())

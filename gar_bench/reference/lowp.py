"""Rounding to a lower precision, for the control of the benchmark's check.

The control puts the reference in the program's place with each part
computed one step below the precision that the configuration states for
it: float32 with TF32 off -> TF32; float32 whose convolutions run in TF32
-> bfloat16; bfloat16 -> float8 (e4m3, scaled per tensor to its largest
magnitude). Rounding is emulated: each operand or result is rounded, then
computed in float32.
"""

from __future__ import annotations

import torch

FP8_MAX = 448.0


def same(t):
    return t


def _tf32(t):
    i = t.float().contiguous().view(torch.int32)
    i = (i + (0xFFF + ((i >> 13) & 1))) & ~0x1FFF
    return i.view(torch.float32).to(t.dtype)


def _bf16(t):
    return t.to(torch.bfloat16).to(t.dtype)


def _fp8(t):
    scale = torch.clamp(t.abs().amax(), min=1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale


class _Round(torch.autograd.Function):
    """A rounding in the forward whose backward rounds the gradient alike."""

    @staticmethod
    def forward(ctx, t, fn):
        ctx.fn = fn
        return fn(t.detach())

    @staticmethod
    def backward(ctx, g):
        return ctx.fn(g), None


def tf32(t):
    """Round float32 to TF32's 10-bit mantissa, to nearest even."""
    return _Round.apply(t, _tf32)


def bf16(t):
    return _Round.apply(t, _bf16)


def fp8(t):
    """float8 e4m3, scaled per tensor to its largest magnitude."""
    return _Round.apply(t, _fp8)


# the precision a configuration states for a part -> its control's rounding
BELOW = {"float32": tf32, "tf32": bf16, "bfloat16": fp8}


class Precision:
    """Roundings of the three parts: ``geo`` (the 3DMM and the pose),
    ``map`` (the mapping network and the styles' linears), ``syn`` (the
    synthesis: its convs and every layer's output). ``Precision()`` is the
    reference itself (float32, no rounding)."""

    def __init__(self, geo=same, map=same, syn=same):
        self.geo, self.map, self.syn = geo, map, syn

    @classmethod
    def below(cls, cfg: dict) -> "Precision":
        """The control's roundings for the precisions ``cfg`` states."""
        p = cfg["precision"]
        return cls(BELOW[p["geometry"]], BELOW[p["mapping"]], BELOW[p["synthesis"]])

"""Floating-point operations of the GAR's forward, from the configuration's
shapes alone (2 per multiply-add), whatever implements it.

Counted: the mapping network's linears; each modulated conv's style linear,
its demodulation product (``[B, in] @ [in, out]``) and its conv (a 3x3
conv at its output resolution, an upsampling transposed conv at its input
resolution); the 4x4 blur after each upsampling conv at its output
resolution; each ToRGB's 1x1 conv and its skip's 2x upsampling (4 taps an
output pixel: the zero-stuffed taps are no work); the normal maps'
ResBlocks (two 3x3 convs and the 1x1 skip). Not counted: elementwise work
(modulation, demodulation, FiLM, noise, bias, activation, PixelNorm).
"""

from __future__ import annotations

from gar_bench.reference.gar import channels, levels


def _resblock(r: int, cin: int, cout: int) -> int:
    return 2 * r * r * (cin * cin * 9 + cin * cout * 9 + cin * cout)


def _modconv(dim: int, cin: int, cout: int, k: int, pixels: int, demod: bool) -> int:
    return 2 * (dim * cin + (cin * cout if demod else 0) + cin * cout * k * k * pixels)


def forward_flops(cfg: dict) -> int:
    """Operations of one image's forward through the mapping network and
    the synthesis (the normal pyramid is counted apart)."""
    dim, ch = cfg["style_dim"], channels(cfg["channel_multiplier"])
    res = levels(cfg["size"])[1:]
    n = cfg["n_mlp"] * 2 * dim * dim
    n += _resblock(4, 3, 2) + _modconv(dim, ch[4], ch[4], 3, 16, True)
    n += _modconv(dim, ch[4], 3, 1, 16, False)
    cin = ch[4]
    for r in res:
        c = ch[r]
        n += _resblock(r, 3, 4)
        n += _modconv(dim, cin, c, 3, (r // 2) ** 2, True) + 2 * 16 * c * r * r
        n += _modconv(dim, c, c, 3, r * r, True)
        n += _modconv(dim, c, 3, 1, r * r, False) + 2 * 4 * 3 * r * r
        cin = c
    return n

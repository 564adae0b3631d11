"""Floating-point operations of the GAR's training (2 per multiply-add), from
the configuration's shapes and the job alone, whatever implements them.

``disc_flops``: one image through the residual D, counted as ``flops.py``
counts G: each conv at its output resolution (the stride-2 convs at the
halved one), the 4x4 blur ahead of each stride-2 conv at its output
resolution (16 taps a pixel), the two linears; elementwise work (bias,
activation, the sqrt(2) sums, the stddev channel) is not counted.
``flops.forward_flops`` gives G's forward (mapping and synthesis; the
normal pyramid is counted apart, and not here).

The multipliers, with F_G and F_D one image's forwards:

- a first-order backward to inputs and weights is twice its forward (one
  product for the inputs' gradient, one for the weights'), one to the
  inputs alone is once its forward;
- D step: G's fakes outside the gradient (F_G), D on the reals and on the
  fakes with its backward (2 x 3 F_D): F_G + 6 F_D an image;
- G step: G with its backward (3 F_G), D with the backward to its input
  alone (2 F_D): 3 F_G + 2 F_D an image;
- R1 (every ``d_reg_every`` steps, on the batch of reals): D's forward and
  its backward to the image (2 F_D), and the double backward, which
  differentiates that graph to D's weights and so costs twice it (4 F_D):
  6 F_D a real;
- path length (every ``g_reg_every`` steps, on ``batch //
  path_batch_shrink`` images): G's forward and its backward to W+ and the
  pyramid (2 F_G), and the double backward (4 F_G): 6 F_G an image.
"""

from __future__ import annotations

from gar_bench.flops import forward_flops
from gar_bench.reference.gar import channels


def _conv(pixels: int, cin: int, cout: int, k: int) -> int:
    return 2 * pixels * cin * cout * k * k


def disc_flops(cfg: dict) -> int:
    """Operations of one image's forward through the discriminator."""
    dc, r = cfg["discriminator"], cfg["size"]
    ch = channels(dc["channel_multiplier"])
    n = _conv(r * r, 3, ch[r], 1)
    cin = ch[r]
    while r > 4:
        cout, h = ch[r // 2], r // 2
        n += _conv(r * r, cin, cin, 3)  # conv1
        n += 2 * 16 * cin * (r + 1) ** 2 + _conv(h * h, cin, cout, 3)  # blur, conv2
        n += 2 * 16 * cin * (r - 1) ** 2 + _conv(h * h, cin, cout, 1)  # blur, skip
        cin, r = cout, h
    n += _conv(16, cin + dc["stddev_feat"], ch[4], 3)
    return n + 2 * (16 * ch[4] * ch[4] + ch[4])


def step_flops(cfg: dict, job: dict) -> dict:
    """Operations of each part of a step: ``plain`` (the D and G steps, every
    step), ``r1`` and ``path`` (the regularizers' extra, on the steps that
    run them)."""
    fg, fd, b = forward_flops(cfg), disc_flops(cfg), job["batch"]
    return {"plain": b * (4 * fg + 8 * fd), "r1": b * 6 * fd,
            "path": job["batch"] // job["path_batch_shrink"] * 6 * fg}


def cycle_flops(cfg: dict, job: dict) -> int:
    """Operations of ``d_reg_every`` steps: one R1 step and ``d_reg_every /
    g_reg_every`` path steps."""
    s, n = step_flops(cfg, job), job["d_reg_every"]
    return n * s["plain"] + s["r1"] + n // job["g_reg_every"] * s["path"]

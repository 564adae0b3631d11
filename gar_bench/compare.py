"""The comparisons that decide ``correct``: each number compared, worked out
from an answer and the reference's answer to the same inputs, and held to
its limit (``gar_bench/limits/<workload>.json``)."""

from __future__ import annotations

import math

import torch

# a normal-map pixel whose channels differ from the reference's by more
# than this has another winner or another triangle's values
PIXEL_TOL = 1e-4


def rel_l2(a, b) -> float:
    """``|a - b| / |b|`` over the whole tensors, in float64."""
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def norm_gaps(prog: dict, ref: dict, counted) -> dict:
    """By leaf, the gap of norms: ``| |prog_k| - |ref_k| |`` over the larger
    of ``|ref_k|`` and the median leaf's ``|ref|``, for the leaves in
    ``counted``."""
    pn = {k: float(torch.linalg.vector_norm(prog[k].double())) for k in counted}
    rn = {k: float(torch.linalg.vector_norm(ref[k].double())) for k in counted}
    med = sorted(rn.values())[len(rn) // 2]
    return {k: abs(pn[k] - rn[k]) / max(rn[k], med) for k in counted}


def median(values) -> float:
    v = sorted(values)
    return v[len(v) // 2] if len(v) % 2 else 0.5 * (v[len(v) // 2 - 1] + v[len(v) // 2])


def counted_leaves(ref_grads: dict) -> list[str]:
    """Leaves whose reference gradient is not nought to rounding: a norm of
    at least a thousandth of the median leaf's."""
    n = {k: float(torch.linalg.vector_norm(g.double())) for k, g in ref_grads.items()}
    med = sorted(n.values())[len(n) // 2]
    return [k for k, v in n.items() if v >= 1e-3 * med]


def moved_elements(ref_grads: dict) -> dict:
    """By leaf, the elements whose reference gradient is not nought to
    rounding: at least a thousandth of the median leaf's root-mean-square
    element. Adam moves an element whose gradient is rounding (the
    translation along the view axis, which orthographic rendering does not
    see) by up to its learning rate either way, whatever the gradient's
    size."""
    rms = {k: float(torch.sqrt(torch.mean(g.double() ** 2))) for k, g in ref_grads.items()}
    floor = 1e-3 * sorted(rms.values())[len(rms) // 2]
    return {k: g.abs() >= floor for k, g in ref_grads.items()}


class RenderTally:
    """The generation check over sampled images: the worst image's relative
    L2 gap, and the share of normal-map pixels (all levels) off the
    reference's."""

    def __init__(self):
        self.image_rel_l2, self.off, self.pixels, self.images = 0.0, 0, 0, 0

    def add(self, maps, img, ref_maps, ref_img):
        for m, r in zip(maps, ref_maps):
            m = m.to(r.device).float().reshape(r.shape)
            self.off += int(((m - r).abs().amax(-1) > PIXEL_TOL).sum())
            self.pixels += r.shape[0] * r.shape[1] * r.shape[2]
        g = rel_l2(img.to(ref_img.device).float().reshape(ref_img.shape), ref_img)
        self.image_rel_l2 = max(self.image_rel_l2, g if math.isfinite(g) else math.inf)
        self.images += 1

    def numbers(self) -> dict:
        return {"image_rel_l2": self.image_rel_l2,
                "pyramid_off_share": self.off / max(self.pixels, 1)}


def invert_numbers(prog: dict, ref: dict) -> tuple[dict, dict]:
    """The inversion check -> (the numbers compared, the look behind them).

    ``prog`` and ``ref`` each hold ``losses`` (the first steps' losses),
    ``grad`` (the first step's gradients by leaf, as the optimizer got them
    after the clip), ``p0`` and ``p3`` (the parameters before the first
    step and after the third). Compared: ``grad_gap``, the worst leaf's gap
    of gradient norms; ``change_gap``, the median leaf's gap of the norms of
    the change over the three steps, on the elements that
    ``moved_elements`` keeps (the worst leaf's swings with the rounding of
    the small geometry leaves). Shown only: each step's loss gap and every
    leaf's gaps (the losses have no reading that a lower precision or a
    planted fault lifts to three times the program's)."""
    leaves = counted_leaves(ref["grad"])
    moved = moved_elements(ref["grad"])
    d_prog = {k: (prog["p3"][k] - prog["p0"][k]) * moved[k] for k in leaves}
    d_ref = {k: (ref["p3"][k] - ref["p0"][k]) * moved[k] for k in leaves}
    grad = norm_gaps(prog["grad"], ref["grad"], leaves)
    change = norm_gaps(d_prog, d_ref, leaves)
    out = {"grad_gap": max(grad.values()), "change_gap": median(change.values())}
    look = {"loss_gap": max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"])),
            "change_gap_worst_leaf": max(change.values()),
            "leaves": {k: {"grad": grad[k], "change": change[k], "moved": int(moved[k].sum()),
                           "of": moved[k].numel()} for k in leaves}}
    return {k: (v if math.isfinite(v) else math.inf) for k, v in out.items()}, look


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """-> (every number that has a limit within it, ``{name: {value,
    limit}}``); a limit with no number is an error."""
    shown = {k: {"value": numbers[k], "limit": v} for k, v in limits.items()}
    return all(numbers[k] <= v for k, v in limits.items()), shown

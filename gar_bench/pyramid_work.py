"""The least work of the normal pyramid, from its inputs: the vertices and
normals ``[B, nv, 3]`` and the triangles ``[nf, 3]`` read once, each
level's maps (3 float32 values and a 32-bit winner id a pixel) written
once; and the candidate math of every (pixel, triangle) pair whose clamped
bbox holds the pixel, for front-facing triangles of the projected mesh, plus
the interpolation of each written pixel. It reads shapes and the posed
vertices that the benchmark computes itself (``reference/``), never an
intermediate of the program.
"""

from __future__ import annotations

import torch

from gar_bench import peaks
from gar_bench.reference import raster

# float32 operations per bbox pair: bbox test 4, three edge functions 12,
# inside test 3, coefficient sum and guard 5, reciprocal 1, normalise 3,
# clamp 6, depth 5, depth test 2; per written pixel and channel: 5
OPS_PER_PAIR, OPS_PER_VALUE = 41, 5


@torch.no_grad()
def bbox_pairs(verts, tri, sizes, eps: float = 1e-6) -> int:
    """Pairs of (pixel, front-facing triangle) whose clamped bbox at each
    level holds the pixel, summed over the batch and the levels."""
    n = 0
    for s in sizes:
        _, _, nx, ny, _ = raster.bbox_candidates(verts.float(), tri.long(), s, eps)
        n += int((nx * ny).sum())
    return n


def work(verts, tri, sizes, n_attr: int = 3) -> dict:
    """``bytes``, ``ops``, ``pairs`` and ``bound_s`` (the larger of bytes
    over HBM bandwidth and ops over the float32 rate) of one pyramid."""
    B, nv, _ = verts.shape
    pixels = B * sum(s * s for s in sizes)
    nbytes = B * nv * 3 * 4 + B * nv * n_attr * 4 + tri.shape[0] * 3 * 4 + pixels * 4 * (n_attr + 1)
    pairs = bbox_pairs(verts, tri, sizes)
    ops = pairs * OPS_PER_PAIR + pixels * n_attr * OPS_PER_VALUE
    bound = max(nbytes / peaks.HBM_BYTES_PER_S, ops / peaks.F32_OPS_PER_S)
    return {"bytes": nbytes, "ops": ops, "pairs": pairs, "bound_s": bound}

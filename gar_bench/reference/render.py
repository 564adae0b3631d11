"""One image of the generation path in plain PyTorch: the 3DMM, the Euler
pose, the normals, every pyramid level and the GAR (mapping, synthesis),
from the benchmark's draws and weights."""

from __future__ import annotations

from gar_bench.reference import gar, geometry, raster
from gar_bench.reference.lowp import Precision


def posed(face, x, pose, prec: Precision = Precision()):
    return geometry.euler_pose(geometry.morph(x, face["basis"], face["mean"], prec.geo),
                               pose, prec.geo)


def image(P, face, tri, cfg, draws, j: int, prec: Precision = Precision()):
    """Image ``j`` of a batch's ``draws`` -> (its normal maps ``[1, s, s, 3]``
    for s = 4 .. size, its image ``[1, 3, size, size]``)."""
    row = slice(j, j + 1)
    v = posed(face, draws["x"][row], draws["pose"][row], prec)
    n = geometry.normals(v, tri)
    maps = [raster.interpolate(v, n, tri, raster.winners(v, tri, s), s)
            for s in gar.levels(cfg["size"])]
    w = gar.mapping(P, draws["z"][row], cfg, prec.map)
    latent = w[:, None, :].expand(1, gar.n_latent(cfg["size"]), w.shape[1])
    img = gar.synthesis(P, latent, maps, [nz[row] for nz in draws["noise"]], cfg,
                        prec.syn, prec.map)
    return maps, img

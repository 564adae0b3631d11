"""Small meshes for the rasterizer tests, made with numpy from seeds.

Shared by the CPU tests (which hand them to both packages), the card tests
and ``chip_smoke.py``; imports neither JAX nor torch, so it runs on a
machine that has only one of them."""

import numpy as np


def mesh_random(perspective, seed=0, nv=40, nf=120, B=2, scale=0.5):
    """Random triangles over random vertices; behind the camera (z < 0)
    when ``perspective``."""
    rng = np.random.RandomState(seed)
    v = rng.randn(B, nv, 3).astype(np.float32) * scale
    if perspective:
        v[:, :, 2] -= 3.0
    tri = rng.randint(0, nv, (nf, 3)).astype(np.int32)
    return v, tri


def mesh_sphere(seed=0, B=2, nu=16, nv=32, radius=0.6):
    """A closed UV sphere (the faces of ``sphere_face_mesh``), every vertex
    jittered and the whole mesh shifted per batch item."""
    th = np.linspace(1e-3, np.pi - 1e-3, nu)
    ph = np.linspace(0, 2 * np.pi, nv, endpoint=False)
    T, P = np.meshgrid(th, ph, indexing="ij")
    pts = np.stack([radius * np.sin(T) * np.cos(P), radius * np.cos(T),
                    radius * np.sin(T) * np.sin(P)], -1).reshape(-1, 3)
    idx = np.arange(nu * nv).reshape(nu, nv)
    tri = []
    for i in range(nu - 1):
        a, b = idx[i], np.roll(idx[i], -1)
        c, d = np.roll(idx[i + 1], -1), idx[i + 1]
        tri += [np.stack([a, b, c], -1), np.stack([a, c, d], -1)]
    rng = np.random.RandomState(seed)
    v = pts[None] + rng.randn(B, *pts.shape) * 0.01 + rng.randn(B, 1, 3) * 0.1
    return v.astype(np.float32), np.concatenate(tri).astype(np.int32)


def mesh_big_triangles():
    """An image-filling triangle (the XL tier) and a small one in front."""
    v = np.asarray([[[-1, -1, 0.0], [-1, 1, 0], [1, 0, 0],
                     [-0.05, -0.05, 0.5], [-0.05, 0.05, 0.5], [0.05, 0, 0.5]]], np.float32)
    return v, np.asarray([[2, 1, 0], [5, 4, 3]], np.int32)


def mesh_degenerate():
    """A normal triangle, a segment, a point, a big back triangle and one
    with an out-of-range vertex id; the segment and the point sit on the
    16 px pixel lattice so the degenerate fallbacks cover pixel centers."""
    y_row = 1.0 - 7.5 / 8.0
    x_pt = (12 + 0.5) / 8.0 - 1.0
    y_pt = 1.0 - 3.5 / 8.0
    v = np.asarray([[[-0.6, -0.6, 0.0], [0.6, -0.6, 0.0], [0.0, 0.6, 0.0],
                     [-0.5, y_row, 0.5], [0.5, y_row, 0.5],
                     [x_pt, y_pt, 0.9],
                     [-1, -1, -0.2], [-1, 1, -0.2], [1, 0, -0.2]]], np.float32)
    tri = np.asarray([[2, 1, 0], [3, 4, 4], [5, 5, 5], [8, 7, 6], [0, 1, 9]], np.int32)
    return v, tri


def mesh_lattice(seed=0, B=2, top=64, nf=240):
    """Small triangles (and a few larger ones) whose corners lie exactly on
    the pixel lattice of some level k <= 4 of a ``top`` px pyramid, many on
    tile and warp-rectangle edges at that level: corner px at level k is
    ``m``, so its NDC x is ``(m + 0.5) * 2^k * 2 / top - 1``, exact in f32.
    Each triangle has its own three vertices; half face away."""
    rng = np.random.RandomState(seed)
    v = np.zeros((B, 3 * nf, 3), np.float32)
    for b in range(B):
        for f in range(nf):
            k = rng.randint(0, 5)
            s = top >> k
            edges = [0, 1, s // 2 - 1, s // 2, s - 2, s - 1, -1, s]
            anchor = [rng.choice(edges) if rng.rand() < 0.6 else rng.randint(-1, s + 1)
                      for _ in range(2)]
            reach = 24 if rng.rand() < 0.1 else 3
            for c in range(3):
                m = np.asarray(anchor) + (rng.randint(0, reach, 2) if c else 0)
                x = (m[0] + 0.5) * (1 << k) * 2.0 / top - 1.0
                y = 1.0 - (m[1] + 0.5) * (1 << k) * 2.0 / top
                v[b, 3 * f + c] = (x, y, rng.randn())
    tri = np.arange(3 * nf, dtype=np.int32).reshape(nf, 3)
    return v, tri


def mesh_dense_tile(seed=0, B=2, top=64, nf=4000, size=12.0):
    """``nf`` triangles of up to ``size`` px stacked over one 16 px tile of a
    ``top`` px image (pixels 16..31, which holds the center of the 1 px
    level), each with its own vertices and a random depth: thousands of
    candidates in one tile, most with coarse levels to queue, so the
    kernel's queue of coarse-level work fills and is worked through several
    times per tile."""
    rng = np.random.RandomState(seed)
    c = rng.uniform(16.0, 32.0, (B, nf, 1, 2))
    m = c + rng.uniform(-size / 2, size / 2, (B, nf, 3, 2))
    # every triangle facing front (the winding of mesh_degenerate's first)
    d1, d2 = m[..., 1, :] - m[..., 0, :], m[..., 2, :] - m[..., 0, :]
    back = d1[..., 0] * d2[..., 1] - d1[..., 1] * d2[..., 0] > 0
    m[back] = m[back][:, ::-1]
    x = (m[..., 0] + 0.5) * 2.0 / top - 1.0
    y = 1.0 - (m[..., 1] + 0.5) * 2.0 / top
    z = np.repeat(rng.randn(B, nf, 1), 3, -1)
    v = np.stack([x, y, z], -1).reshape(B, 3 * nf, 3).astype(np.float32)
    tri = np.arange(3 * nf, dtype=np.int32).reshape(nf, 3)
    return v, tri


def mesh_ties_nan():
    """Depth ties between -0.0 and +0.0, and a NaN vertex: a small triangle
    at z = +0.0 (id 0) inside two copies of a big one at z = -0.0 (id 1)
    and +0.0 (id 2): all three tie, so id 0 wins inside the small one and
    id 1 elsewhere (a z-test that put -0.0 below +0.0 would give id 2);
    then a triangle in front with a NaN x (id 3), which is invalid. (A NaN
    depth is left out: the dense oracle takes the max over a chunk of
    triangles, so a NaN there hides the other triangles of its chunk.)"""
    big = [[-0.8, -0.8], [0.8, -0.8], [0.0, 0.8]]
    v = [[0.1, 0.1, 0.0], [0.3, 0.1, 0.0], [0.2, 0.3, 0.0]]
    for z in (-0.0, 0.0):
        v += [[x, y, z] for x, y in big]
    v += [[-0.5, -0.5, 3.0], [np.nan, -0.5, 3.0], [0.0, 0.5, 3.0]]
    v = np.asarray(v, np.float32)
    v = np.stack([v, v + np.asarray([0.05, -0.03, 0.0], np.float32)])
    tri = np.arange(len(v[0]), dtype=np.int32).reshape(-1, 3)
    return v, tri


def _pixel_mesh(m, z, h, w):
    """Corners in pixel coords m [B, nf, 3, 2] and depths z [B, nf, 3] of an
    h x w image -> (v, tri), each triangle with its own three vertices:
    pixel m is NDC ((m_x + 0.5) * 2 / w - 1, 1 - (m_y + 0.5) * 2 / h), exact
    in f32 when w and h are powers of two."""
    B, nf = m.shape[:2]
    x = (m[..., 0] + 0.5) * 2.0 / w - 1.0
    y = 1.0 - (m[..., 1] + 0.5) * 2.0 / h
    v = np.stack([x, y, z], -1).reshape(B, 3 * nf, 3).astype(np.float32)
    return v, np.arange(3 * nf, dtype=np.int32).reshape(nf, 3)


def _front(m):
    """Corners m [..., 3, 2] with every triangle turned to face front (the
    winding of mesh_degenerate's first)."""
    d1, d2 = m[..., 1, :] - m[..., 0, :], m[..., 2, :] - m[..., 0, :]
    back = d1[..., 0] * d2[..., 1] - d1[..., 1] * d2[..., 0] > 0
    m[back] = m[back][:, ::-1]
    return m


def mesh_lattice_single(seed=0, B=2, h=32, w=64, tile=8, nf=240):
    """Small triangles (and a few larger ones) with every corner exactly on
    a pixel center of an h x w image, most anchored on tile edges (pixels
    tile*j - 1 and tile*j) and on the image's border and just outside it,
    so that bboxes start and end exactly on a tile's first or last pixel;
    half face away."""
    rng = np.random.RandomState(seed)
    m = np.zeros((B, nf, 3, 2))
    for n, axis in ((w, 0), (h, 1)):
        edges = sorted({e for j in range(n // tile + 1) for e in (tile * j - 1, tile * j)}
                       | {0, n - 1, -1, n})
        anchor = np.where(rng.rand(B, nf) < 0.7, rng.choice(edges, (B, nf)),
                          rng.randint(-1, n + 1, (B, nf)))
        reach = np.where(rng.rand(B, nf) < 0.1, 24, 3)
        off = (rng.rand(B, nf, 3) * reach[..., None]).astype(np.int64)
        off[..., 0] = 0
        m[..., axis] = anchor[..., None] + off
    return _pixel_mesh(m, rng.randn(B, nf, 3), h, w)


def mesh_big_single(seed=0, B=2, h=96, w=64):
    """Big triangles over an h x w image, for 32 px tiles: one that fills
    the image, six of 40-150 px (the span-16 tier at 8 px tiles), twenty of
    10-40 px, two degenerate segments across the image (XL) and a hundred
    small triangles of 1-4 px, all facing front at random depths, so that
    many clips fill a whole 32 px tile (1,024 px)."""
    rng = np.random.RandomState(seed)
    parts = []
    for n, lo, hi in ((6, 40, 150), (20, 10, 40), (100, 1, 4)):
        c = rng.uniform(0, [w, h], (B, n, 1, 2))
        parts.append(c + rng.uniform(-1, 1, (B, n, 3, 2)) * rng.uniform(lo, hi, (B, n, 1, 1)) / 2)
    fill = np.asarray([[-0.4 * w, -0.4 * h], [1.6 * w, 0.5 * h], [0.2 * w, 1.6 * h]])
    parts.insert(0, np.broadcast_to(fill, (B, 1, 3, 2)).copy())
    a, b = rng.uniform(0, [w, h], (2, B, 2, 1, 2))
    parts.append(np.concatenate([a, b, b], 2))  # a segment: det 0
    m = _front(np.concatenate(parts, 1))
    z = np.repeat(rng.randn(B, m.shape[1], 1), 3, -1)
    return _pixel_mesh(m, z, h, w)


# (mesh function, top, n_levels, tile, perspective): the kernel's cases,
# from the tile-16 main-path layout with its sparse coarse levels to tiles
# 8 and 32, perspective, degenerate triangles, the XL tier and corners on
# the pixel lattice of the coarse levels (bboxes that touch tile edges),
# depth ties between -0.0 and +0.0, a NaN vertex, and thousands of
# triangles in one tile (the kernel's coarse-level queue fills)
KERNEL_CASES = {
    "random": (lambda: mesh_random(False, seed=3, nv=50, nf=160, scale=0.6), 32, 6, 16, False),
    "random_persp": (lambda: mesh_random(True, seed=3, nv=50, nf=160, scale=0.6), 32, 5, 16,
                     True),
    "random_tile8": (lambda: mesh_random(False, seed=3, nv=50, nf=160, scale=0.6), 64, 5, 8,
                     False),
    "random_tile32": (lambda: mesh_random(False, seed=4, nv=50, nf=160, scale=0.6), 64, 5, 32,
                      False),
    "random_top64": (lambda: mesh_random(False, seed=5, nv=60, nf=200, scale=0.6), 64, 7, 16,
                     False),
    "degenerate": (mesh_degenerate, 16, 2, 16, False),
    "big_triangles": (mesh_big_triangles, 32, 3, 16, False),
    "lattice": (mesh_lattice, 64, 7, 16, False),
    "ties_nan": (mesh_ties_nan, 32, 4, 16, False),
    "dense_tile": (mesh_dense_tile, 64, 7, 16, False),
}


def kernel_case(name):
    """-> (v, tri, attrs, top, n_levels, tile, perspective) for ``name``."""
    make, top, n_levels, tile, persp = KERNEL_CASES[name]
    v, tri = make()
    attrs = np.random.RandomState(8).randn(*v.shape).astype(np.float32)
    return v, tri, attrs, top, n_levels, tile, persp


def keys_of_bins(ids, starts):
    """Per-triangle sort keys [B, nf] of a binning's sorted ids [B, nf] and
    segment starts [B, K+1]: the segment of each triangle's sorted position,
    K past the valid prefix (numpy arrays)."""
    B, nf = ids.shape
    K = starts.shape[1] - 1
    keys = np.empty((B, nf), np.int64)
    for b in range(B):
        seg = np.searchsorted(starts[b], np.arange(nf), side="right") - 1
        keys[b, ids[b]] = np.minimum(seg, K)
    return keys


# (mesh function, h, w, tile, perspective): the single-level kernel's
# cases. The first six are the JAX package's own cases for its kernel
# (tests/test_rasterize_pallas.py); then rectangular images, tile 32, edge
# tiles that stick out of the image (40 x 24 at tile 16), corners on the
# pixel lattice and on tile edges, depth ties between -0.0 and +0.0 with a
# NaN vertex, thousands of triangles over one tile (many rounds of the
# kernel's block), and big triangles at tile 32 (clips of up to 1,024 px,
# XL; a 96 px image has at most 3 tiles of 32 px, so the span-16 tier shows
# at the 8 px tiles the card tests also run).
SINGLE_CASES = {
    "random": (lambda: mesh_random(False), 24, 24, 8, False),
    "random_persp": (lambda: mesh_random(True), 24, 24, 8, True),
    "sphere": (mesh_sphere, 32, 32, 8, False),
    "big_triangles": (mesh_big_triangles, 32, 32, 8, False),
    "degenerate": (mesh_degenerate, 16, 16, 8, False),
    "random_tile16": (lambda: mesh_random(False, seed=2), 32, 32, 16, False),
    "rect_40x24": (lambda: mesh_random(False, seed=5, nv=60, nf=200, scale=0.6), 40, 24, 8,
                   False),
    "rect_24x40_persp": (lambda: mesh_random(True, seed=6, nv=60, nf=200, scale=0.6), 24, 40,
                         8, True),
    "random_tile32": (lambda: mesh_random(False, seed=4, nv=50, nf=160, scale=0.6), 64, 64, 32,
                      False),
    "edge_tiles_40x24_tile16": (lambda: mesh_random(False, seed=7, nv=60, nf=200, scale=0.6),
                                40, 24, 16, False),
    "lattice": (mesh_lattice_single, 32, 64, 8, False),
    "ties_nan": (mesh_ties_nan, 24, 24, 8, False),
    "dense_tile": (lambda: mesh_dense_tile(nf=3000), 64, 64, 16, False),
    "big_triangles_96x64_tile32": (mesh_big_single, 96, 64, 32, False),
}


def single_case(name):
    """-> (v, tri, h, w, tile, perspective) for ``name``."""
    make, h, w, tile, persp = SINGLE_CASES[name]
    v, tri = make()
    return v, tri, h, w, tile, persp

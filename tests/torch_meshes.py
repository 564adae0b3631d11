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


# (mesh function, top, n_levels, tile, perspective): the kernel's cases,
# from the tile-16 main-path layout with its sparse coarse levels to tiles
# 8 and 32, perspective, degenerate triangles and the XL tier
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
}


def kernel_case(name):
    """-> (v, tri, attrs, top, n_levels, tile, perspective) for ``name``."""
    make, top, n_levels, tile, persp = KERNEL_CASES[name]
    v, tri = make()
    attrs = np.random.RandomState(8).randn(*v.shape).astype(np.float32)
    return v, tri, attrs, top, n_levels, tile, persp


# (mesh function, h, w, tile, perspective): the single-level kernel's
# cases. The first six are the JAX package's own cases for its kernel
# (tests/test_rasterize_pallas.py); then rectangular images, tile 32, and
# edge tiles that stick out of the image (40 x 24 at tile 16).
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
}


def single_case(name):
    """-> (v, tri, h, w, tile, perspective) for ``name``."""
    make, h, w, tile, persp = SINGLE_CASES[name]
    v, tri = make()
    return v, tri, h, w, tile, persp

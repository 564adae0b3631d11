"""The port's binned winner search against its dense search and the JAX
package's binned search, on the cases of ``tests/test_rasterize_binned.py``:
a random mesh with and without perspective, the sphere, an image-filling
triangle routed to the dense pass, an empty and a degenerate mesh; the
overflow count, also past ``big_cap``. (NaN depths:
``test_torch_rasterize.py::test_nan_depth_binned``.)

Inputs are made with numpy from seeds and handed to both packages; the
winners are compared bit for bit with the jitted JAX search. The overflow
counts are compared with JAX's ``big_overflow_count`` run eagerly: compiled,
XLA contracts the multiply-adds of the back-face test, and on the random
mesh (seed 0) that culls a degenerate triangle (two equal projected
vertices, span 10) that eager JAX and the port keep, so the compiled count
is one lower there (it covers no pixel center; the winners agree).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from stylerenderer_tpu.face3d import synthetic_face as j_synthetic_face
from stylerenderer_tpu.ops.rasterize_binned import (
    big_overflow_count as j_big_overflow_count,
    rasterize_winners_binned as j_rasterize_winners_binned,
)

from torch_meshes import mesh_big_triangles, mesh_degenerate, mesh_random

from stylerenderer_tpu_torch.ops.rasterize import rasterize_winners
from stylerenderer_tpu_torch.ops.rasterize_binned import (
    big_overflow_count,
    rasterize_winners_binned,
)
from torch_threads import _one_thread  # noqa: F401


def _both(v, tri, h, w, persp=False, **kw):
    """(port, JAX) binned winners and overflow counts, as numpy: the port's
    count from ``return_overflow``, JAX's from an eager ``big_overflow_count``."""
    win, n = rasterize_winners_binned(torch.from_numpy(v), torch.from_numpy(tri), h, w, persp,
                                      return_overflow=True, **kw)
    jwin = j_rasterize_winners_binned(jnp.asarray(v), jnp.asarray(tri), h, w, persp, **kw)
    with jax.disable_jit():
        jn = j_big_overflow_count(jnp.asarray(v), tri, h, w, persp,
                                  k_list=kw.get("k_list", (8, 32)))
    assert win.dtype == torch.int32 and win.shape == (v.shape[0], h, w)
    np.testing.assert_array_equal(
        big_overflow_count(torch.from_numpy(v), torch.from_numpy(tri), h, w, persp,
                           k_list=kw.get("k_list", (8, 32))).numpy(), n.numpy())
    return win.numpy(), n.numpy(), np.asarray(jwin), np.asarray(jn)


def _check(v, tri, h, w, persp=False, **kw):
    win, n, jwin, jn = _both(v, tri, h, w, persp, **kw)
    dense = rasterize_winners(torch.from_numpy(v), torch.from_numpy(tri), h, w, persp).numpy()
    np.testing.assert_array_equal(win, dense)
    np.testing.assert_array_equal(win, jwin)
    np.testing.assert_array_equal(n, jn)
    return win, n


@pytest.mark.parametrize("perspective", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_matches_dense_and_jax_random_mesh(perspective, seed):
    v, tri = mesh_random(perspective, seed, nv=40, nf=120, B=2)
    win, _ = _check(v, tri, 24, 24, perspective, k_list=(4, 8), big_cap=64)
    assert (win >= 0).any()


def test_matches_dense_and_jax_sphere_mesh():
    face, tri = j_synthetic_face(16, 32, 6, 3)
    v = np.array(face(face.random_input(jax.random.PRNGKey(0), 2)))
    win, _ = _check(v, np.array(tri), 32, 32)
    assert (win >= 0).mean() > 0.2  # the sphere fills the frame


def test_big_triangle_routed_to_dense_pass():
    """The image-filling triangle goes to the dense pass (its span is over
    ``max(k_list)``), the small one in front to a window."""
    v = np.asarray([[[-1, -1, 0.0], [-1, 1, 0], [1, 0, 0],
                     [-0.1, -0.1, 0.5], [-0.1, 0.1, 0.5], [0.1, 0, 0.5]]], np.float32)
    tri = np.asarray([[2, 1, 0], [5, 4, 3]], np.int32)
    win, n = _check(v, tri, 16, 16, k_list=(4,), big_cap=4)
    assert {0, 1} <= set(win.reshape(-1).tolist()) and n.tolist() == [1]


def test_empty_and_degenerate():
    """All vertices at one point, and the mesh of a segment, a point, a back
    face and an out-of-range vertex id on the 16 px lattice."""
    win, _ = _check(np.zeros((1, 3, 3), np.float32), np.asarray([[0, 1, 2]], np.int32), 8, 8)
    assert (win == -1).all()
    v, tri = mesh_degenerate()
    _check(v, tri, 16, 16, k_list=(4, 8), big_cap=8)
    v, tri = mesh_big_triangles()
    _check(v, tri, 16, 24, k_list=(4,), big_cap=2)


@pytest.mark.parametrize("seed", [0, 1])
def test_overflow_past_big_cap(seed):
    """More big triangles than ``big_cap``: both packages count them alike,
    and the winners, no longer exact, differ from the dense search's."""
    v, tri = mesh_random(False, seed, nv=40, nf=120, B=2)
    win, n, _, jn = _both(v, tri, 24, 24, k_list=(4,), big_cap=8)
    np.testing.assert_array_equal(n, jn)
    assert (n > 8).all()
    dense = rasterize_winners(torch.from_numpy(v), torch.from_numpy(tri), 24, 24).numpy()
    assert (win != dense).any()

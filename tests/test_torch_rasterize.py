"""The port's rasterizer against the JAX package.

- the dense oracle: winner maps bit-equal to JAX ``rasterize_winners``,
  values of ``rasterize`` to f32 rounding;
- binning: ``starts`` equal to JAX ``build_bins_multi``'s, the same
  triangle ids in every segment;
- the pyramid functions, and first-order gradients of
  ``rasterize_pyramid_fused`` against ``jax.grad``.

The multi-level kernel's plain version against the JAX Pallas kernel, its
host build and NaN depths: ``test_torch_rasterize_multi.py`` (split from
this file so that two test processes share the cost). Inputs are made with
numpy from seeds and handed to both packages.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import stylerenderer_tpu.ops.rasterize_pallas as jrp
from stylerenderer_tpu.ops.rasterize import (
    rasterize as j_rasterize,
    rasterize_index_coeff as j_rasterize_index_coeff,
    rasterize_pyramid as j_rasterize_pyramid,
    rasterize_winners as j_rasterize_winners,
)
from stylerenderer_tpu.face3d import mesh_point_normal as j_mesh_point_normal
from stylerenderer_tpu.face3d import synthetic_face as j_synthetic_face

from stylerenderer_tpu_torch.ops.rasterize import (
    rasterize,
    rasterize_index_coeff,
    rasterize_pyramid,
    rasterize_pyramid_fused,
    rasterize_winners,
)
from torch_meshes import mesh_big_triangles, mesh_degenerate, mesh_random

from stylerenderer_tpu_torch.ops.rasterize_multi import MULTI_N_TIERS, build_bins_multi
from torch_threads import _one_thread  # noqa: F401


def _t(a):
    return torch.from_numpy(np.array(a))


def mesh_sphere(seed=0, B=2):
    face, tri = j_synthetic_face(16, 32, 6, 3)
    x = np.random.RandomState(seed).randn(B, 9).astype(np.float32) * np.asarray(face.sigma)
    return np.asarray(face(jnp.asarray(x))), np.asarray(tri)


DENSE_CASES = {
    "random": (lambda: mesh_random(False), 24, False),
    "random_persp": (lambda: mesh_random(True), 24, True),
    "sphere": (mesh_sphere, 32, False),
    "big_triangles": (mesh_big_triangles, 32, False),
    "degenerate": (mesh_degenerate, 16, False),
}


@pytest.mark.parametrize("case", sorted(DENSE_CASES))
def test_dense_winners_equal_jax(case):
    make, h, persp = DENSE_CASES[case]
    v, tri = make()
    ref = np.asarray(j_rasterize_winners(jnp.asarray(v), jnp.asarray(tri), h, h, persp))
    out = rasterize_winners(_t(v), _t(tri), h, h, persp).numpy()
    np.testing.assert_array_equal(out, ref)
    assert (out >= 0).any()
    if case == "degenerate":
        assert {1, 2} <= set(out.reshape(-1))  # the segment and the point won pixels


@pytest.mark.parametrize("perspective", [False, True])
def test_rasterize_values_match_jax(perspective):
    v, tri = mesh_random(perspective, seed=3, nv=50, nf=160, scale=0.6)
    attrs = np.random.RandomState(4).randn(2, 50, 3).astype(np.float32)
    for s in (32, 16):
        ref = np.asarray(j_rasterize(jnp.asarray(v), jnp.asarray(attrs),
                                     jnp.asarray(tri), s, s, perspective))
        out = rasterize(_t(v), _t(attrs), _t(tri), s, s, perspective).numpy()
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)


def test_index_coeff_match_jax():
    """The reference op's outputs: per-pixel vertex ids equal, coefficients
    to f32 rounding, both zero on background; the degenerate mesh's segment
    and point exercise the fallback coefficients."""
    v, tri = mesh_degenerate()
    ref_idx, ref_c = j_rasterize_index_coeff(jnp.asarray(v), jnp.asarray(tri), 16)
    idx, coeff = rasterize_index_coeff(_t(v), _t(tri), 16)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    np.testing.assert_allclose(coeff.numpy(), np.asarray(ref_c), rtol=0, atol=1e-6)
    assert (coeff.numpy() == 1.0).any()  # the point's corner takes it all


MULTI_MESHES = {
    "random": (lambda: mesh_random(False, seed=3, nv=50, nf=160, scale=0.6), False),
    "random_persp": (lambda: mesh_random(True, seed=3, nv=50, nf=160, scale=0.6), True),
    "sphere": (mesh_sphere, False),
}


@pytest.mark.parametrize("case", sorted(MULTI_MESHES))
def test_build_bins_matches_jax(case):
    make, persp = MULTI_MESHES[case]
    v, tri = make()
    top, n_levels, tile = 64, 5, 16
    jdat, jstarts = jrp.build_bins_multi(jnp.asarray(v), jnp.asarray(tri), top, n_levels,
                                         persp, 1e-6, tile)
    jstarts = np.asarray(jstarts)
    jids = np.asarray(jdat)[:, 9, :].astype(np.int64)
    dat, ids, starts = build_bins_multi(_t(v), _t(tri), top, n_levels, persp, 1e-6, tile)
    np.testing.assert_array_equal(starts.numpy(), jstarts)
    assert starts.shape[-1] == MULTI_N_TIERS * (top // tile) ** 2 + 1
    ids = ids.numpy()
    for b in range(v.shape[0]):
        for lo, hi in zip(jstarts[b, :-1], jstarts[b, 1:]):
            assert set(ids[b, lo:hi]) == set(jids[b, lo:hi])
    # each sorted row carries its triangle's projected corners
    px = (1.0 + v[..., 0]) * (top / 2.0) - 0.5 if not persp else None
    if px is not None:
        np.testing.assert_array_equal(dat[0, :, 0].numpy(), px[0, tri[ids[0], 0]])


def test_pyramid_matches_per_level_rasterize():
    v, tri = mesh_sphere(seed=7)
    n = np.asarray(j_mesh_point_normal(jnp.asarray(v), jnp.asarray(tri)))
    sizes = [4, 8, 16, 32]
    fused = rasterize_pyramid_fused(_t(v), _t(n), _t(tri), sizes)
    plain = rasterize_pyramid(_t(v), _t(n), _t(tri), sizes)
    for s, a, b in zip(sizes, fused, plain):
        ref = rasterize(_t(v), _t(n), _t(tri), s, s)
        torch.testing.assert_close(a, ref, rtol=0, atol=0)
        torch.testing.assert_close(b, ref, rtol=0, atol=0)


@pytest.mark.parametrize("perspective,scale", [(False, 1e-3), (True, 0.1)])
def test_fused_pyramid_gradients_match_jax(perspective, scale):
    """First-order gradients of the port's rasterize_pyramid_fused in v and
    tex against jax.grad of JAX rasterize_pyramid. The cotangents are scaled
    so that the largest vertex gradient is of order 1: the vertex gradient
    is a sum over pixels in another order than JAX's segment sum, so the
    absolute tolerance is one of f32 rounding at that scale (unscaled, the
    sphere's vertex gradients reach ~750 and the sums differ by ~1e-3)."""
    if perspective:
        v, tri = mesh_random(True, seed=3, nv=50, nf=160, scale=0.6)
    else:
        v, tri = mesh_sphere(seed=7)
    tex = np.random.RandomState(9).randn(*v.shape).astype(np.float32)
    sizes = [4, 8, 16, 32]
    w = [np.random.RandomState(10 + i).randn(2, s, s, 3).astype(np.float32) * scale
         for i, s in enumerate(sizes)]

    def j_loss(v_, t_):
        maps = j_rasterize_pyramid(v_, t_, jnp.asarray(tri), sizes, perspective)
        return sum(jnp.sum(m * jnp.asarray(wi)) for m, wi in zip(maps, w))

    gv_j, gt_j = jax.grad(j_loss, argnums=(0, 1))(jnp.asarray(v), jnp.asarray(tex))
    vt = _t(v).requires_grad_(True)
    tt = _t(tex).requires_grad_(True)
    maps = rasterize_pyramid_fused(vt, tt, _t(tri), sizes, perspective)
    sum((m * _t(wi)).sum() for m, wi in zip(maps, w)).backward()
    np.testing.assert_allclose(vt.grad.numpy(), np.asarray(gv_j), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(gt_j), rtol=0, atol=1e-5)
    assert 0.1 < np.abs(np.asarray(gv_j)).max() < 10
    assert np.abs(np.asarray(gt_j)).max() > 1e-4

"""The port's face geometry against the JAX package: the synthetic face
mesh (numpy on both sides, so exactly equal), vertex normals, the linear
morphable model, Euler rotations and the random pose."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from stylerenderer_tpu.face3d import (
    euler_mat as j_euler_mat,
    make_linear_morphable_model as j_make_lmm,
    mesh_point_normal as j_mesh_point_normal,
    normalize as j_normalize,
    sphere_face_mesh as j_sphere_face_mesh,
    synthetic_face as j_synthetic_face,
)

from stylerenderer_tpu_torch.face3d import (
    euler_mat,
    make_linear_morphable_model,
    mesh_point_normal,
    normalize,
    random_apply_pose3D,
    sphere_face_mesh,
    synthetic_face,
)
from torch_threads import _one_thread  # noqa: F401


@pytest.mark.parametrize("shape", [(12, 24, 4, 2), (48, 96, 80, 29)])
def test_synthetic_face_arrays_equal(shape):
    jf, jtri = j_synthetic_face(*shape)
    pf, ptri = synthetic_face(*shape, device="cpu")
    np.testing.assert_array_equal(ptri.numpy(), np.asarray(jtri))
    for name in ("basis", "mean", "sigma"):
        np.testing.assert_array_equal(getattr(pf, name).numpy(), np.asarray(getattr(jf, name)),
                                      err_msg=name)
    assert pf.dim == jf.dim
    pts, tri = sphere_face_mesh(8, 16)
    jpts, jtri2 = j_sphere_face_mesh(8, 16)
    np.testing.assert_array_equal(pts, jpts)
    np.testing.assert_array_equal(tri, jtri2)


def test_morphable_forward_and_regulation_match_jax():
    jf, _ = j_synthetic_face(12, 24, 4, 2)
    pf, _ = synthetic_face(12, 24, 4, 2, device="cpu")
    x = np.random.RandomState(0).randn(3, 6).astype(np.float32) * np.asarray(jf.sigma)
    ref = np.asarray(jf(jnp.asarray(x)))
    out = pf(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == (3, 12 * 24, 3)
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(pf.regulation(torch.from_numpy(x))),
                               float(jf.regulation(jnp.asarray(x))), rtol=1e-6)
    # the random-uniform fill of missing pieces is numpy-seeded on both sides
    jm = j_make_lmm(10, 3, 2, seed=4)
    pm = make_linear_morphable_model(10, 3, 2, seed=4)
    np.testing.assert_array_equal(pm.basis.numpy(), np.asarray(jm.basis))
    np.testing.assert_array_equal(pm.mean.numpy(), np.asarray(jm.mean))
    np.testing.assert_array_equal(pm.sigma.numpy(), np.asarray(jm.sigma))
    g = torch.Generator().manual_seed(0)
    assert pm.random_input(5, g).shape == (5, 5)


def test_mesh_point_normal_matches_jax():
    """index_add in the port, segment_sum in JAX: the scatter order differs,
    so the unit normals agree to f32 rounding."""
    jf, tri = j_synthetic_face(16, 32, 6, 3)
    x = np.random.RandomState(1).randn(2, 9).astype(np.float32) * np.asarray(jf.sigma)
    v = np.array(jf(jnp.asarray(x)))
    tri = np.array(tri)
    ref = np.asarray(j_mesh_point_normal(jnp.asarray(v), tri))
    out = mesh_point_normal(torch.from_numpy(v), torch.from_numpy(tri))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-6)
    # unbatched input
    out1 = mesh_point_normal(torch.from_numpy(v[0]), torch.from_numpy(tri))
    np.testing.assert_allclose(out1.numpy(), ref[0], rtol=0, atol=1e-6)
    z = np.zeros((4, 3), np.float32)
    z[1] = [3.0, 4.0, 0.0]
    np.testing.assert_allclose(normalize(torch.from_numpy(z)).numpy(),
                               np.asarray(j_normalize(jnp.asarray(z))), rtol=0, atol=1e-7)


def test_euler_mat_and_random_pose():
    ang = np.random.RandomState(2).randn(4, 3).astype(np.float32)
    for order in ("yxz", "xyz", "zyx"):
        np.testing.assert_allclose(euler_mat(torch.from_numpy(ang), order).numpy(),
                                   np.asarray(j_euler_mat(jnp.asarray(ang), order)),
                                   rtol=0, atol=1e-6)
    np.testing.assert_allclose(euler_mat(torch.from_numpy(ang[0])).numpy(),
                               np.asarray(j_euler_mat(jnp.asarray(ang[0]))), rtol=0, atol=1e-6)
    # the draws differ from JAX's; the transform is a scaled rotation plus a
    # shift, and zero stddevs leave the vertices as they are
    v = torch.from_numpy(np.random.RandomState(3).randn(2, 10, 3).astype(np.float32))
    np.testing.assert_array_equal(random_apply_pose3D(None, v, p=(0,) * 7).numpy(), v.numpy())
    g = torch.Generator().manual_seed(5)
    out = random_apply_pose3D(g, v, p=(0.5, 0.1, 0.05, 0.1, 0.1, 0.1, 0.0))
    d_in = torch.cdist(v, v)
    d_out = torch.cdist(out, out)
    torch.testing.assert_close(d_out, d_in, rtol=1e-5, atol=1e-5)
    again = random_apply_pose3D(torch.Generator().manual_seed(5), v,
                                p=(0.5, 0.1, 0.05, 0.1, 0.1, 0.1, 0.0))
    torch.testing.assert_close(out, again, rtol=0, atol=0)

"""The port's ADA augmentation against the JAX package: the draw-free cores
(color matrix, color application, the zero-padded bilinear sampler, the
2D pose warp, the gated ``ada_augment``) are fed the JAX functions' own
draws (the same key splits) and held to 1e-5, the 2D pose on camera
matrices to rtol 1e-6; plus the identity, gray-axis, border, gating and
camera identity and flip checks of ``tests/test_augment.py``."""

import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from stylerenderer_tpu.face3d.augment import (
    _bilinear_sample as j_bilinear_sample,
    ada_augment as j_ada_augment,
    apply_color as j_apply_color,
    random_pose2d_cam as j_random_pose2d_cam,
    random_color_matrix as j_random_color_matrix,
    random_pose2d as j_random_pose2d,
)
from stylerenderer_tpu.face3d.transforms import rodrigues as j_rodrigues

from stylerenderer_tpu_torch.face3d.augment import (
    AugDraws,
    ada_augment,
    apply_color,
    aug_draws,
    bilinear_sample,
    color_matrix_from,
    pose2d_cam_from,
    pose2d_from,
    random_pose2d_cam,
)
from stylerenderer_tpu_torch.face3d.transforms import rodrigues
from torch_threads import _one_thread  # noqa: F401


def _t(x):
    return torch.from_numpy(np.array(x))


def _nchw(x):
    return torch.from_numpy(np.transpose(np.asarray(x), (0, 3, 1, 2)).copy())


def _nhwc(t):
    return np.transpose(t.numpy(), (0, 2, 3, 1))


def _j_color_draws(key, b):
    """The draws ``random_color_matrix(key, b)`` takes."""
    k1, k2, k3 = jax.random.split(key, 3)
    return (jax.random.normal(k1, (b, 2)), jax.random.uniform(k2, (b, 1)),
            jax.random.normal(k3, (b, 2)))


def _j_pose_draws(key, b):
    """The draws ``random_pose2d(key, img)`` takes."""
    k1, k2, k3 = jax.random.split(key, 3)
    return (jax.random.normal(k1, (b, 3)), jax.random.normal(k2, (b, 1)),
            jax.random.uniform(k3, (b, 1)))


def _torch(tree):
    return [_t(x) for x in tree]


# each JAX reference is jitted once with its draws, which eager JAX would
# compile op by op
@jax.jit
def _j_rodrigues_and_grad(r):
    return j_rodrigues(r), jax.grad(lambda v: jnp.sum(j_rodrigues(v)))(r)


@functools.partial(jax.jit, static_argnames=("b", "p"))
def _j_color(key, img, b, p):
    C = j_random_color_matrix(key, b, p=p)
    return _j_color_draws(key, b), C, j_apply_color(img, C)


@functools.partial(jax.jit, static_argnames=("p",))
def _j_pose(key, img, p):
    return _j_pose_draws(key, img.shape[0]), j_random_pose2d(key, img, p=p)


@jax.jit
def _j_ada(key, img):
    b = img.shape[0]
    k1, k2, k3 = jax.random.split(key, 3)
    draws = (*_j_pose_draws(k1, b), *_j_color_draws(k2, b),
             jax.random.uniform(k3, (b, 1, 1, 1)).reshape(b))
    return draws, j_ada_augment(key, img, 0.5)


def test_rodrigues_matches_jax():
    """Rotations, the small-angle series (r = 0 and r below eps) and their
    gradients."""
    r = np.random.RandomState(0).randn(6, 3).astype(np.float32)
    r[0] = 0.0
    r[1] = 1e-9
    Rj, gj = _j_rodrigues_and_grad(jnp.asarray(r))
    np.testing.assert_allclose(rodrigues(_t(r)).numpy(), np.asarray(Rj), rtol=1e-6, atol=1e-6)
    x = _t(r).requires_grad_(True)
    (g,) = torch.autograd.grad(rodrigues(x).sum(), x)
    assert torch.isfinite(g).all()
    np.testing.assert_allclose(g.numpy(), np.asarray(gj), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("p", [(0.2, 0.3, 0.0, 0.15, 0.5), (0.4, 0.3, 0.5, 0.3, 0.5)])
def test_color_matrix_and_apply_match_jax(p):
    b = 6
    img = np.random.RandomState(1).rand(b, 5, 7, 3).astype(np.float32) * 2 - 1
    draws, Cj, want = _j_color(jax.random.PRNGKey(3), jnp.asarray(img), b, p)
    C = color_matrix_from(*_torch(draws), p=p)
    np.testing.assert_allclose(C.numpy(), np.asarray(Cj), rtol=1e-5, atol=1e-5)
    out = apply_color(_nchw(img), C)
    np.testing.assert_allclose(_nhwc(out), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_bilinear_sampler_matches_jax():
    """Coordinates inside and past the border (zero padding), exact pixel
    centers included."""
    rng = np.random.RandomState(2)
    img = rng.rand(3, 9, 12, 4).astype(np.float32)
    x = rng.uniform(-1.3, 1.3, (3, 7, 5)).astype(np.float32)
    y = rng.uniform(-1.3, 1.3, (3, 7, 5)).astype(np.float32)
    x[0, 0] = (2 * np.arange(5) + 1) / 12 - 1
    out = bilinear_sample(_nchw(img), _t(x), _t(y))
    want = jax.jit(j_bilinear_sample)(img, x, y)
    np.testing.assert_allclose(_nhwc(out), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("hw", [(16, 16), (12, 20)])
def test_pose2d_matches_jax(hw):
    h, w = hw
    img = np.random.RandomState(3).rand(5, h, w, 3).astype(np.float32)
    p = (0.2, 0.2, 0.3, 0.2, 0.1, 0.5)
    draws, want = _j_pose(jax.random.PRNGKey(4), jnp.asarray(img), p)
    out = pose2d_from(*_torch(draws), _nchw(img), p=p)
    np.testing.assert_allclose(_nhwc(out), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_ada_augment_matches_jax():
    b = 8
    img = np.random.RandomState(4).rand(b, 16, 16, 3).astype(np.float32) * 2 - 1
    draws, want = _j_ada(jax.random.PRNGKey(5), jnp.asarray(img))
    draws = AugDraws(*_torch(draws))
    out = ada_augment(_nchw(img), torch.tensor(0.5), draws)
    np.testing.assert_allclose(_nhwc(out), np.asarray(want), rtol=1e-5, atol=1e-5)
    kept = (draws.keep < 0.5).numpy()
    assert 0 < kept.sum() < b
    np.testing.assert_array_equal(_nhwc(out)[~kept], img[~kept])


def test_color_matrix_identity_when_p_zero():
    g = torch.Generator().manual_seed(0)
    C = color_matrix_from(torch.randn(4, 2, generator=g), torch.rand(4, 1, generator=g),
                          torch.randn(4, 2, generator=g), p=(0, 0, 0, 0, 0))
    want = np.tile(np.concatenate([np.eye(3), np.zeros((3, 1))], 1), (4, 1, 1))
    np.testing.assert_allclose(C.numpy(), want, atol=1e-6)


def test_color_preserves_gray_axis_under_hue():
    g = torch.Generator().manual_seed(1)
    C = color_matrix_from(torch.randn(8, 2, generator=g), torch.rand(8, 1, generator=g),
                          torch.randn(8, 2, generator=g), p=(0, 0, 0, 0.5, 0))
    out = apply_color(torch.full((8, 3, 2, 2), 0.37), C)
    np.testing.assert_allclose(out.numpy(), 0.37, atol=1e-5)


def test_pose2d_identity_when_p_zero():
    img = torch.from_numpy(np.random.RandomState(0).rand(2, 3, 16, 16).astype(np.float32))
    g = torch.Generator().manual_seed(0)
    out = pose2d_from(torch.randn(2, 3, generator=g), torch.randn(2, 1, generator=g),
                      torch.rand(2, 1, generator=g), img, p=(0, 0, 0, 0, 0, 0))
    np.testing.assert_allclose(out.numpy(), img.numpy(), atol=1e-4)


def test_pose2d_border_safe():
    """The minimum zoom keeps every sample inside: a constant image stays
    (almost) constant, no zero border leaks in."""
    g = torch.Generator().manual_seed(1)
    out = pose2d_from(torch.randn(4, 3, generator=g), torch.randn(4, 1, generator=g),
                      torch.rand(4, 1, generator=g), torch.ones(4, 3, 32, 32),
                      p=(0.2, 0.2, 0.3, 0.2, 0, 0.5))
    assert float(out.min()) > 0.95, float(out.min())


def test_ada_gating_and_gradient():
    """p = 0 returns the input; p = 1 augments every sample; the image
    gradient passes through."""
    g = torch.Generator().manual_seed(0)
    img = torch.zeros(16, 3, 8, 8)
    torch.testing.assert_close(ada_augment(img, 0.0, aug_draws(g, 16)), img, rtol=0, atol=0)
    x = img.clone().requires_grad_(True)
    out = ada_augment(x, 1.0, aug_draws(g, 16))
    assert float(out.detach().abs().max()) > 0
    (gx,) = torch.autograd.grad(out.pow(2).sum() + out.sum(), x)
    assert torch.isfinite(gx).all() and float(gx.abs().max()) > 0


# ---- the 2D pose on camera matrices --------------------------------------------

_CAM_P = (0.1, 0.1, 0.05, 0.15, 0.05, 0.5)


@functools.partial(jax.jit, static_argnames=("in_size", "out_size"))
def _j_pose_cam(key, cam, in_size, out_size):
    return _j_pose_draws(key, cam.shape[0]), j_random_pose2d_cam(
        key, cam, p=_CAM_P, in_size=in_size, out_size=out_size)


@pytest.mark.parametrize("in_size,out_size", [(None, None), (256, 128), (64, None)])
def test_pose2d_cam_matches_jax(in_size, out_size):
    """The same draws (``random_pose2d_cam``'s key splits) through both
    packages: to rtol 1e-6, normalized (both sizes) and in pixels, flips
    included; one ``[3, 3]`` camera as the first of the batch."""
    rs = np.random.RandomState(4)
    b = 8
    normalized = bool(in_size) and bool(out_size)
    f = rs.uniform(1.0, 1.5, b) if normalized else rs.uniform(200.0, 300.0, b)
    c = rs.uniform(0.3, 0.7, (b, 2)) if normalized else rs.uniform(20.0, 40.0, (b, 2))
    cam = np.zeros((b, 3, 3), np.float32)
    cam[:, 0, 0], cam[:, 1, 1], cam[:, 0, 1] = f, f * 1.01, 0.01
    cam[:, :2, 2], cam[:, 2, 2] = c, 1.0
    draws, want = _j_pose_cam(jax.random.PRNGKey(7), jnp.asarray(cam), in_size, out_size)
    z, s, coin = _torch(draws)
    assert 0 < int((coin < 0.5).sum()) < b  # some flipped, some not
    out = pose2d_cam_from(z, s, coin, _t(cam), _CAM_P, in_size, out_size)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-6, atol=0)
    one = pose2d_cam_from(z[:1], s[:1], coin[:1], _t(cam[0]), _CAM_P, in_size, out_size)
    assert one.shape == (3, 3)
    np.testing.assert_allclose(one.numpy(), np.asarray(want)[0], rtol=1e-6, atol=0)


def test_pose2d_cam_identity_and_flip():
    """``tests/test_augment.py``'s checks: no pose keeps a normalized camera;
    a certain flip mirrors its principal point (0.5 stays, 0.3 goes to
    0.7). The draws come from a ``torch.Generator``."""
    cam_n = torch.tensor([[[1.2, 0, 0.5], [0, 1.2, 0.5], [0, 0, 1.0]]])
    g = torch.Generator().manual_seed(0)
    out = random_pose2d_cam(g, cam_n, p=(0, 0, 0, 0, 0, 0), in_size=256, out_size=256)
    np.testing.assert_allclose(out.numpy(), cam_n.numpy(), atol=1e-5)
    out_f = random_pose2d_cam(g, cam_n, p=(0, 0, 0, 0, 0, 1.0), in_size=256, out_size=256)
    np.testing.assert_allclose(float(out_f[0, 0, 2]), 0.5, atol=1e-5)
    cam_off = cam_n.clone()
    cam_off[0, 0, 2] = 0.3
    out_f2 = random_pose2d_cam(g, cam_off, p=(0, 0, 0, 0, 0, 1.0), in_size=256, out_size=256)
    np.testing.assert_allclose(float(out_f2[0, 0, 2]), 0.7, atol=1e-5)

"""The port's elementwise and resampling ops against the JAX package.

``fused_leaky_relu`` and ``upfirdn2d`` (up, down, blur, negative pads) take
the same numpy inputs as the JAX ops and as the numpy float64 oracle
``upfirdn2d_ref``; f32, atol 1e-5. ``upfirdn2d``'s gradients are held
against JAX's VJP and checked to second order in float64. NCHW on the port's side, NHWC on JAX's:
the tests transpose at the boundary."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from stylerenderer_tpu.ops.fused_act import fused_leaky_relu as j_fused_leaky_relu
from stylerenderer_tpu.ops.fused_act import scaled_leaky_relu as j_scaled_leaky_relu
from stylerenderer_tpu.ops.upfirdn2d import (
    blur as j_blur,
    downsample2d as j_downsample2d,
    make_kernel as j_make_kernel,
    upfirdn2d as j_upfirdn2d,
    upsample2d as j_upsample2d,
)

from stylerenderer_tpu_torch.ops.fused_act import (
    FusedLeakyReLU,
    fused_leaky_relu,
    scaled_leaky_relu,
)
from stylerenderer_tpu_torch.ops.upfirdn2d import (
    blur,
    downsample2d,
    make_kernel,
    upfirdn2d,
    upfirdn2d_ref,
    upsample2d,
)
from torch_threads import _one_thread  # noqa: F401


def _rand(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def _nhwc(t):
    return np.transpose(t.numpy(), (0, 2, 3, 1))


def test_fused_leaky_relu_matches_jax():
    x = _rand((2, 5, 6, 7))
    b = _rand((7,), seed=1)
    ref = np.asarray(j_fused_leaky_relu(jnp.asarray(x), jnp.asarray(b)))
    out = _nhwc(fused_leaky_relu(_nchw(x), torch.from_numpy(b)))
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)
    # the linear layers' form: bias on the last axis
    y = _rand((4, 9), seed=2)
    c = _rand((9,), seed=3)
    np.testing.assert_allclose(
        fused_leaky_relu(torch.from_numpy(y), torch.from_numpy(c), dim=-1).numpy(),
        np.asarray(j_fused_leaky_relu(jnp.asarray(y), jnp.asarray(c))), rtol=0, atol=1e-5)
    np.testing.assert_allclose(
        _nhwc(scaled_leaky_relu(_nchw(x))), np.asarray(j_scaled_leaky_relu(jnp.asarray(x))),
        rtol=0, atol=1e-5)
    m = FusedLeakyReLU(7)
    with torch.no_grad():
        m.bias.copy_(torch.from_numpy(b))
    np.testing.assert_allclose(_nhwc(m(_nchw(x)).detach()), ref, rtol=0, atol=1e-5)


UPFIRDN_CASES = [
    # (in_h, in_w, kh, kw, up, down, pad)
    (8, 8, 4, 4, 1, 1, (1, 2)),
    (8, 8, 4, 4, 2, 1, (2, 1)),  # up
    (8, 8, 4, 4, 1, 2, (1, 1)),  # down
    (7, 9, 3, 5, 2, 1, (2, 2)),
    (6, 6, 3, 3, 1, 1, (-1, -1)),  # negative pads crop
    (8, 8, 4, 4, 2, 2, (1, 1)),
    (5, 5, 2, 2, 3, 1, (1, 0)),
    (12, 10, 4, 4, 1, 3, (2, 1)),
    (8, 8, 4, 4, 2, 1, (2, -1)),  # mixed sign pads
    (9, 7, 4, 3, 2, 2, (1, 2, 0, -1)),  # per-axis pads
]


@pytest.mark.parametrize("case", UPFIRDN_CASES)
def test_upfirdn2d_matches_jax_and_oracle(case):
    in_h, in_w, kh, kw, up, down, pad = case
    x = _rand((2, in_h, in_w, 3))
    k = _rand((kh, kw), seed=1)
    ref = np.asarray(j_upfirdn2d(jnp.asarray(x), jnp.asarray(k), up, down, pad))
    out = _nhwc(upfirdn2d(_nchw(x), torch.from_numpy(k), up, down, pad))
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)
    oracle = np.transpose(upfirdn2d_ref(np.transpose(x, (0, 3, 1, 2)), k, up, down, pad),
                          (0, 2, 3, 1))
    np.testing.assert_allclose(out, oracle, rtol=0, atol=1e-5)


@pytest.mark.parametrize("case", UPFIRDN_CASES)
def test_upfirdn2d_gradients(case):
    """The gradient, itself an ``upfirdn2d``, equals JAX's VJP (1e-5), and
    first and second derivatives pass ``gradcheck`` in float64 (its fast
    mode: a random projection of each Jacobian)."""
    in_h, in_w, kh, kw, up, down, pad = case
    x = _rand((2, in_h, in_w, 3))
    k = _rand((kh, kw), seed=1)
    y, vjp = jax.vjp(lambda v: j_upfirdn2d(v, jnp.asarray(k), up, down, pad), jnp.asarray(x))
    ct = _rand(y.shape, seed=2)
    xp = _nchw(x).requires_grad_(True)
    (gx,) = torch.autograd.grad(upfirdn2d(xp, torch.from_numpy(k), up, down, pad), xp,
                                _nchw(ct))
    np.testing.assert_allclose(_nhwc(gx.detach()), np.asarray(vjp(jnp.asarray(ct))[0]), rtol=0,
                               atol=1e-5)
    x64 = _nchw(x).double()[:1, :1].requires_grad_(True)
    k64 = torch.from_numpy(k).double()
    def f(v):
        return upfirdn2d(v, k64, up, down, pad)

    assert torch.autograd.gradcheck(f, (x64,), fast_mode=True)
    assert torch.autograd.gradgradcheck(f, (x64,), fast_mode=True)


def test_upfirdn2d_rejects_empty_output():
    with pytest.raises(ValueError, match="empty output"):
        upfirdn2d(torch.zeros(1, 1, 2, 2), torch.ones(4, 4), pad=(-1, -1))


def test_resampling_wrappers_match_jax():
    x = _rand((2, 16, 16, 4))
    kj = j_make_kernel([1, 3, 3, 1])
    kp = make_kernel([1, 3, 3, 1])
    np.testing.assert_array_equal(kp.numpy(), np.asarray(kj))
    xp = _nchw(x)
    pairs = [
        (upsample2d(xp, kp, 2), j_upsample2d(jnp.asarray(x), kj, 2)),
        (downsample2d(xp, kp, 2), j_downsample2d(jnp.asarray(x), kj, 2)),
        (blur(xp, kp, (2, 1)), j_blur(jnp.asarray(x), kj, (2, 1))),
        (blur(xp, kp, (2, 2), upsample_factor=2), j_blur(jnp.asarray(x), kj, (2, 2), 2)),
    ]
    for out, ref in pairs:
        ref = np.asarray(ref)
        assert _nhwc(out).shape == ref.shape
        np.testing.assert_allclose(_nhwc(out), ref, rtol=0, atol=1e-5)

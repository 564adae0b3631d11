"""The port's elementwise and resampling ops against the JAX package.

``fused_leaky_relu`` and ``upfirdn2d`` (up, down, blur, negative pads) take
the same numpy inputs as the JAX ops and as the numpy float64 oracle
``upfirdn2d_ref``; f32, atol 1e-5. ``upfirdn2d``'s gradients are held
against JAX's VJP and checked to second order in float64. NCHW on the port's side, NHWC on JAX's:
the tests transpose at the boundary.

``upfirdn2d``'s kernel (``csrc/upfirdn2d.cu``) is held here through its host
build (g++, the same math, tiling, launch shape and indexing): against the
float64 oracle and the plain version in float32 and float64, in bfloat16
equal to its own float32 sums rounded once, on strided inputs, at the forms
the benchmark's cells run and their adjoints; its gradients to second order
and the GAR's forward with the host build standing in for the card.

The styled conv's epilogue kernel (``fused_bias_act``) is held here through
its host build (g++, the same math, vector width, launch shape and
indexing): bit for bit against the plain chain in float32; in bfloat16 bit
for bit against the float32 chain rounded once, and within one rounding of
a float64 oracle; its dispatch rule; and the
styled layers' kernel path, with the host build standing in for the card."""

import importlib

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

import torch_fused_act as tfa
import torch_upfirdn2d as tu
from stylerenderer_tpu_torch.ops import fused_act
from stylerenderer_tpu_torch.ops.fused_act import (
    FusedLeakyReLU,
    fused_bias_act,
    fused_bias_act_host,
    fused_bias_act_ref,
    fused_leaky_relu,
    scaled_leaky_relu,
)
from stylerenderer_tpu_torch.ops.upfirdn2d import (
    blur,
    downsample2d,
    make_kernel,
    upfirdn2d,
    upfirdn2d_cuda,
    upfirdn2d_host,
    upfirdn2d_plain,
    upfirdn2d_ref,
    upsample2d,
)
from torch_threads import _one_thread  # noqa: F401

ufd_mod = importlib.import_module("stylerenderer_tpu_torch.ops.upfirdn2d")


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


# ---- upfirdn2d's kernel through its host build --------------------------------

def _forms():
    """The forms the cells run (``torch_upfirdn2d``), cut to 2 x 5 planes at
    the 8 and 32 px levels, and their adjoints: G's blur on the transposed
    conv's 2H+1 maps, ToRGB's Upsample, D's blurs with pads (2, 2) and
    (1, 1) (odd outputs), ``Downsample``; the adjoints' pads are negative
    where the forward's sizes do not divide. -> {id: (shape, up, down, pad)}."""
    calls = tu.synthesis_calls(32, 2)[::4] + tu.synthesis_calls(32, 2)[1:2]
    calls += tu.discriminator_calls(16, 2)[:2]
    calls += [((2, 5, 17, 17), 1, 2, (1, 1, 1, 1)), ((2, 5, 9, 11), 1, 2, (1, 1, 1, 1))]
    calls = [((b, min(c, 5), h, w), up, down, pad) for (b, c, h, w), up, down, pad in calls]
    forms = {}
    for call in calls + [tu.adjoint(c) for c in calls]:
        (b, c, h, w), up, down, pad = call
        forms[f"{h}x{w}_up{up}_down{down}_pad{'_'.join(map(str, pad))}"] = call
    return forms


UPFIRDN_FORMS = _forms()


def _host_cases():
    """(id, x shape, taps, up, down, pad): ``UPFIRDN_CASES`` with random 2-D
    taps, and the cells' forms with ``make_kernel([1, 3, 3, 1])`` (an outer
    product: the kernel's separable sums) and with 2-D taps (tap by tap)."""
    cases = []
    for i, (in_h, in_w, kh, kw, up, down, pad) in enumerate(UPFIRDN_CASES):
        cases.append((f"case{i}", (2, 3, in_h, in_w), ("rand", kh, kw), up, down, pad))
    for name, (shape, up, down, pad) in UPFIRDN_FORMS.items():
        cases.append((f"{name}_1d", shape, ("1331", up), up, down, pad))
        cases.append((f"{name}_2d", shape, ("rand", 4, 4), up, down, pad))
    return cases


def _taps(spec):
    if spec[0] == "1331":
        return make_kernel([1, 3, 3, 1]) * (4 if spec[1] == 2 else 1)
    return torch.from_numpy(_rand(spec[1:], seed=1))


@pytest.mark.parametrize("case", _host_cases(), ids=lambda c: c[0])
def test_upfirdn2d_host_matches_plain_and_oracle(case):
    """float32 within 1e-5 of the float64 oracle and of the plain version,
    float64 within 1e-12 of the oracle; bfloat16 bit-equal to the kernel's
    float32 sums of the same inputs rounded once."""
    _, shape, spec, up, down, pad = case
    x = torch.from_numpy(_rand(shape))
    k = _taps(spec)
    out = upfirdn2d_host(x, k, up, down, pad)
    oracle = upfirdn2d_ref(x.numpy(), k.numpy(), up, down, pad)
    assert out.shape == oracle.shape and out.is_contiguous()
    np.testing.assert_allclose(out.numpy(), oracle, rtol=0, atol=1e-5)
    torch.testing.assert_close(out, upfirdn2d_plain(x, k, up, down, pad), rtol=0, atol=1e-5)
    out64 = upfirdn2d_host(x.double(), k.double(), up, down, pad)
    np.testing.assert_allclose(out64.numpy(), upfirdn2d_ref(x.double().numpy(),
                                                             k.double().numpy(), up, down, pad),
                               rtol=0, atol=1e-12)
    xb = x.to(torch.bfloat16)
    assert torch.equal(upfirdn2d_host(xb, k, up, down, pad).view(torch.int16),
                       upfirdn2d_host(xb.float(), k, up, down, pad).to(torch.bfloat16)
                       .view(torch.int16))


@pytest.mark.parametrize("name", sorted(UPFIRDN_FORMS))
def test_upfirdn2d_host_takes_strides_as_given(name):
    """A channels-last map, a column slice and a transposed view (the
    strided rows gathered, not bulk-copied) give the contiguous input's
    bits."""
    shape, up, down, pad = UPFIRDN_FORMS[name]
    b, c, h, w = shape
    x = torch.from_numpy(_rand((b, c, h, w + 3)))[..., 1:w + 1]
    k = _taps(("1331", up))
    want = upfirdn2d_host(x.contiguous(), k, up, down, pad)
    for view in (x, x.contiguous(memory_format=torch.channels_last),
                 x.transpose(2, 3).contiguous().transpose(2, 3)):
        assert torch.equal(upfirdn2d_host(view, k, up, down, pad), want)


def _shape(call, dtype_code=1, unit_w=1, kh=4, kw=4):
    from stylerenderer_tpu_torch.ops._build import library

    return tu.launch_shape(library("upfirdn2d_host").sr_upfirdn2d_shape_host, call, dtype_code,
                           unit_w, kh, kw)


def test_upfirdn2d_launch_shape():
    """The tiling follows the plane: a 1024 px level's blur takes 128 x 32
    output tiles of one plane (32 x 8 threads of 4 x 4 outputs), bulk
    copies and vector stores; the 8 px level's 8192 planes share items, 15
    of them, leaving 547 items; the upsample's tiles are 256 x 32; an odd
    pad moves tile 0 to -1 and takes scalar stores; a channels-last map is
    gathered, planes first; other geometries take one output a thread."""
    s = _shape(((16, 32, 1025, 1025), 1, 1, (1, 1, 1, 1)))
    assert (s["kind"], s["tx"], s["ty"], s["rx"], s["ry"], s["tp"]) == (0, 32, 8, 4, 4, 1)
    assert (s["tiles_x"], s["tiles_y"], s["items"], s["in_w"], s["in_h"]) == (8, 32, 131072,
                                                                              131, 35)
    assert (s["pitch"], s["raw_pitch"], s["bulk"], s["vec"]) == (132, 304, 1, 1)
    assert s["smem"] <= 48 * 1024
    s = _shape(((16, 512, 9, 9), 1, 1, (1, 1, 1, 1)))
    assert (s["tx"], s["ty"], s["tp"], s["groups"], s["items"]) == (2, 2, 15, 547, 547)
    s = _shape(((16, 3, 512, 512), 2, 1, (2, 1, 2, 1)))
    assert (s["kind"], s["tx"] * s["rx"], s["ty"] * s["ry"], s["sx"], s["vec"]) == (1, 256, 32,
                                                                                    0, 1)
    s = _shape(((2, 4, 64, 64), 2, 1, (1, 2, 1, 2)))
    assert (s["kind"], s["sx"], s["sy"], s["vec"]) == (1, -1, -1, 0)
    s = _shape(((16, 128, 256, 256), 1, 2, (1, 1, 1, 1)))
    assert (s["kind"], s["rx"], s["ry"], s["in_w"]) == (2, 2, 4, 130)
    assert _shape(((16, 128, 256, 256), 1, 1, (2, 2, 2, 2)), unit_w=0)["bulk"] == 0
    s = _shape(((2, 3, 12, 10), 1, 3, (2, 1, 2, 1)))
    assert (s["kind"], s["rx"], s["ry"], s["vec"]) == (3, 1, 1, 0)
    assert _shape(((2, 3, 8, 8), 1, 1, (1, 1, 1, 1)), dtype_code=2)["pitch"] % 4 == 0


@pytest.mark.parametrize("name", sorted(UPFIRDN_FORMS)[::2])
def test_upfirdn2d_gradients_through_host_build(monkeypatch, name):
    """With the host build standing in for the card at every order
    (``_UpFirDn2d`` calls itself in its backward), float64 first and second
    derivatives pass ``gradcheck`` and equal the plain path's."""
    shape, up, down, pad = UPFIRDN_FORMS[name]
    x = torch.from_numpy(_rand((1, 2) + shape[2:])).double()
    k = _taps(("1331", up)).double()
    ct = torch.from_numpy(_rand((1, 2) + tu.out_shape(((1, 2) + shape[2:], up, down, pad))[2:],
                                seed=2)).double()

    def grads():
        xp = x.clone().requires_grad_(True)
        y = upfirdn2d(xp, k, up, down, pad)
        (gx,) = torch.autograd.grad((y * y * ct).sum(), xp, create_graph=True)
        (ggx,) = torch.autograd.grad((gx * gx).sum(), xp)
        return gx.detach(), ggx

    plain = grads()
    calls = []

    def host(*args):
        calls.append(args[0].shape)
        return upfirdn2d_host(*args)

    monkeypatch.setattr(ufd_mod, "upfirdn2d_plain", host)
    kernel = grads()
    assert len(calls) >= 3  # the forward, its adjoint, and the adjoint's own backward
    for a, b in zip(kernel, plain):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)

    def f(v):
        return upfirdn2d(v, k, up, down, pad)

    xp = x.clone().requires_grad_(True)
    assert torch.autograd.gradcheck(f, (xp,), fast_mode=True)
    assert torch.autograd.gradgradcheck(f, (xp,), fast_mode=True)


def test_upfirdn2d_kernel_refuses_what_it_does_not_take():
    """The card path takes float32, bfloat16 and float64 and raises on any
    other type (before it looks at the device), on a CPU tensor and on a
    kernel of more than 8 taps; a CPU tensor takes the plain version, bit
    for bit, and launches nothing."""
    k = make_kernel([1, 3, 3, 1])
    x = torch.from_numpy(_rand((1, 2, 8, 8)))
    for dtype in (torch.float16, torch.int32):
        with pytest.raises(ValueError, match="float32, bfloat16 or float64"):
            upfirdn2d_cuda(x.to(dtype), k, pad=(1, 1))
        with pytest.raises(ValueError, match="float32, bfloat16 or float64"):
            upfirdn2d_host(x.to(dtype), k, pad=(1, 1))
    with pytest.raises(ValueError, match="CUDA tensors"):
        upfirdn2d_cuda(x, k, pad=(1, 1))
    with pytest.raises(ValueError, match="8 x 8 taps"):
        upfirdn2d_host(x, torch.ones(9, 9), pad=(4, 4))
    before = upfirdn2d.launches
    assert torch.equal(upfirdn2d(x, k, pad=(1, 2)), upfirdn2d_plain(x, k, pad=(1, 2)))
    assert upfirdn2d.launches == before


def test_gar_forward_through_upfirdn2d_host_build(monkeypatch):
    """``GeneratorWithMap(32, 64, 2)`` with the host build standing in for
    the card: a no-grad forward calls it twice a level from 8 px (the
    upsampling conv's blur, ToRGB's Upsample: 6 at 32 px), and its image is
    the plain path's to float32 rounding."""
    from stylerenderer_tpu_torch.face3d import (
        mesh_point_normal, random_apply_pose3D, synthetic_face,
    )
    from stylerenderer_tpu_torch.models import GeneratorWithMap, make_noise

    gen = GeneratorWithMap(32, 64, 2, seed=3, device="cpu").eval()
    face, tri = synthetic_face(12, 24, 4, 2, device="cpu")
    g = torch.Generator().manual_seed(4)
    v = random_apply_pose3D(g, face(face.random_input(2, g)))
    mesh = (v, mesh_point_normal(v, tri), tri)
    z, noise = torch.randn(2, 64, generator=g), make_noise(32, 2, g)
    with torch.no_grad():
        plain = gen([z], mesh, noise=noise)[0]
    calls = []

    def host(*args):
        calls.append(tuple(args[0].shape))
        return upfirdn2d_host(*args)

    monkeypatch.setattr(ufd_mod, "upfirdn2d_plain", host)
    with torch.no_grad():
        img = gen([z], mesh, noise=noise)[0]
    assert len(calls) == 6, calls
    rel = float((img.double() - plain.double()).norm() / plain.double().norm())
    assert rel < 1e-6, rel


# ---- the styled conv's epilogue (fused_bias_act) -------------------------------

# (N, C, H, W): 16-byte vectors along W, a W that takes none (7x9), many
# channels on a 4x4 map (the block follows the channels), a 1x1 map
EPILOGUE_SHAPES = ((2, 5, 8, 8), (2, 3, 7, 9), (3, 512, 4, 4), (2, 4, 16, 16), (1, 6, 1, 1))
# the terms present: (demod, film, noise)
EPILOGUE_TERMS = {"bias only": (False, False, None), "demod": (True, False, None),
                  "film": (False, True, None), "noise batch": (False, False, "batch"),
                  "noise shared": (False, False, "shared"),
                  "noise scalar": (False, False, "scalar"), "all": (True, True, "batch"),
                  "all, shared noise": (True, True, "shared")}


@pytest.mark.parametrize("terms", sorted(EPILOGUE_TERMS))
def test_fused_bias_act_host_bit_equal_in_float32(terms):
    """float32: the host build gives the plain chain's bits, every shape."""
    demod, film, noise = EPILOGUE_TERMS[terms]
    for i, shape in enumerate(EPILOGUE_SHAPES):
        a = tfa.inputs(*shape, torch.float32, film=film, noise=noise, demod=demod, seed=i)
        out = fused_bias_act_host(**a)
        assert torch.equal(tfa.bits(out), tfa.bits(fused_bias_act_ref(**a))), shape


@pytest.mark.parametrize("terms", ["bias only", "all", "all, shared noise"])
def test_fused_bias_act_host_rounds_bfloat16_once(terms):
    """bfloat16: widened, computed in float32, rounded once: the float32
    chain's result rounded to bfloat16, bit for bit, and so within one
    rounding of the float64 oracle (the plain chain rounds every op)."""
    demod, film, noise = EPILOGUE_TERMS[terms]
    for i, shape in enumerate(EPILOGUE_SHAPES):
        a = tfa.inputs(*shape, torch.bfloat16, film=film, noise=noise, demod=demod, seed=i)
        out = fused_bias_act_host(**a)
        assert out.dtype == torch.bfloat16
        assert torch.equal(tfa.bits(out), tfa.bits(tfa.rounded_once(**a))), shape
        assert tfa.max_gap(out, *tfa.oracle(**a)) <= 1.0, shape


@pytest.mark.parametrize("noise_dtype", [torch.bfloat16, torch.float16, torch.float64])
def test_fused_bias_act_host_takes_float32_noise_only(noise_dtype):
    """The kernel reads float32 noise, as every caller makes it: the host
    build refuses another type; the card's wrapper widens it first."""
    a = tfa.inputs(2, 4, 8, 8, torch.bfloat16)
    a["noise"] = a["noise"].to(noise_dtype)
    with pytest.raises(ValueError, match="noise"):
        fused_bias_act_host(**a)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_bias_act_host_signed_zeros_and_slope(dtype):
    """Both sides of the slope, signed zeros, infinities and NaN: without a
    bias -0.0 stays -0.0, with a zero bias it becomes +0.0, as in the plain
    chain; float32 bit for bit."""
    v = torch.tensor([0.0, -0.0, 1.5, -1.5, 3e-3, -3e-3, float("inf"), -float("inf"),
                      float("nan"), 7.0, -7.0, 0.25, -0.25, 1e-30, -1e-30, 2.0])
    y = v.reshape(1, 1, 4, 4).to(dtype)
    for bias in (None, torch.zeros(1)):
        out, ref = fused_bias_act_host(y, bias), fused_bias_act_ref(y, bias)
        assert torch.equal(torch.signbit(out[~out.isnan()]), torch.signbit(ref[~ref.isnan()]))
        assert torch.equal(out.isnan(), ref.isnan())
        if dtype == torch.float32:
            ok = ~ref.isnan()
            assert torch.equal(tfa.bits(out)[ok], tfa.bits(ref)[ok])
    assert bool(torch.signbit(fused_bias_act_host(y, None)[0, 0, 0, 1]))
    assert not bool(torch.signbit(fused_bias_act_host(y, torch.zeros(1))[0, 0, 0, 1]))
    # the slope side: -1.5 -> -1.5 * 0.2 * gain, the gain rounded to the dtype
    gain = float(torch.tensor(2 ** 0.5, dtype=dtype))
    assert float(fused_bias_act_host(y, None)[0, 0, 0, 3]) == float(
        torch.tensor(-1.5 * float(torch.tensor(0.2, dtype=torch.float32)) * gain, dtype=dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_bias_act_host_channels_last(dtype):
    """The layouts the GAR gives: a channels-last y (the ResBlocks' convs
    on the pyramid's ``[B, s, s, C]`` maps) with its bias, kept channels-last;
    FiLM read from a channels-last map: float32 the plain chain's bits,
    bfloat16 the float32 chain's rounded once."""
    for i, (n, c, h, w) in enumerate(((2, 3, 8, 8), (2, 4, 7, 9), (1, 3, 16, 16))):
        g = torch.Generator().manual_seed(i)
        y = torch.randn(n, c, h, w, generator=g).to(dtype).contiguous(
            memory_format=torch.channels_last)
        b = torch.randn(c, generator=g)
        out = fused_bias_act_host(y, b)
        assert out.is_contiguous(memory_format=torch.channels_last)
        a = tfa.inputs(n, 5, h, w, dtype, seed=i)
        a["film"] = torch.randn(n, 4, h, w, generator=g).to(dtype).contiguous(
            memory_format=torch.channels_last)[:, 2:]
        fused = fused_bias_act_host(**a)
        if dtype == torch.float32:
            assert torch.equal(tfa.bits(out), tfa.bits(fused_bias_act_ref(y, b)))
            assert torch.equal(tfa.bits(fused), tfa.bits(fused_bias_act_ref(**a)))
        else:
            assert torch.equal(tfa.bits(out), tfa.bits(tfa.rounded_once(y, bias=b)))
            assert torch.equal(tfa.bits(fused), tfa.bits(tfa.rounded_once(**a)))


def test_fused_bias_act_host_linear_layers_form():
    """The mapping network's ``[B, 512]`` with the bias on the last axis
    (``dim=-1``): the host build gives the plain chain's bits."""
    g = torch.Generator().manual_seed(0)
    y, b = torch.randn(16, 512, generator=g), torch.randn(512, generator=g)
    assert torch.equal(tfa.bits(fused_bias_act_host(y, b, dim=-1)),
                       tfa.bits(fused_bias_act_ref(y, b, dim=-1)))
    assert torch.equal(tfa.bits(fused_leaky_relu(y, b, dim=-1)),
                       tfa.bits(fused_bias_act_ref(y, b, dim=-1)))


@pytest.mark.parametrize("shape,dtype,want", [
    # (N, C, H, W), dtype -> (V, tx, ty, tiles, chunks, chunk, rows)
    ((16, 32, 1024, 1024), 1, (8, 256, 1, 512, 1, 32, 0)),  # a block owns 2048 pixels
    ((16, 64, 512, 512), 1, (8, 256, 1, 128, 1, 64, 0)),
    ((16, 512, 4, 4), 1, (8, 2, 128, 1, 4, 128, 0)),        # the block follows the channels
    ((16, 128, 256, 256), 0, (4, 256, 1, 64, 2, 64, 0)),    # chunks fill one wave
    ((16, 512, 1, 1), 0, (4, 256, 1, 8, 1, 512, 1)),        # the mapping's [B, 512]: a run
    ((16 * 64 * 64, 3, 1, 1), 1, (8, 256, 1, 96, 1, 3, 1)),  # a channels-last 3-channel map
])
def test_fused_bias_act_launch_shape(shape, dtype, want):
    """The launch shape follows (C, H*W): large maps loop over the
    channels in a tile of pixels, small ones spread the channels."""
    import ctypes

    from stylerenderer_tpu_torch.ops._build import library

    out = (ctypes.c_int * 7)()
    assert library("fused_act_host").sr_fused_bias_act_shape_host(
        *shape, dtype, 1, ctypes.cast(out, ctypes.c_void_p)) == 0
    assert tuple(out) == want


def test_fused_bias_act_dispatch_rule():
    """CPU tensors take the plain chain (bit for bit, no launch counted);
    autograd records when grad mode is on and an input requires grad, and
    only then."""
    a = tfa.inputs(2, 4, 8, 8, torch.float32)
    before = fused_bias_act.launches
    assert torch.equal(tfa.bits(fused_bias_act(**a)), tfa.bits(fused_bias_act_ref(**a)))
    assert torch.equal(tfa.bits(fused_leaky_relu(a["y"], a["bias"])),
                       tfa.bits(fused_bias_act_ref(a["y"], a["bias"])))
    w = a["bias"].clone().requires_grad_(True)
    out = fused_bias_act(a["y"], w)
    assert out.requires_grad and fused_bias_act.launches == before
    assert not fused_act.takes_kernel(a["y"])
    assert fused_act.records(a["y"], w) and not fused_act.records(a["y"], None)
    with torch.no_grad():
        assert not fused_act.records(a["y"], w)
    with pytest.raises(ValueError, match="film"):
        fused_bias_act_host(a["y"], a["bias"], film=a["film"].float()[:, :1])
    with pytest.raises(ValueError, match="CUDA"):
        fused_act.fused_bias_act_cuda(**a)


def test_fused_bias_act_rule_keeps_sharded_layers_plain(monkeypatch):
    """With the tensors taken for a card's: no grad, the rule takes the
    kernel; under autograd, or inside a ``sharded`` mesh over more than one
    band, it does not (a one-band mesh is no mesh)."""
    import types

    from stylerenderer_tpu_torch.parallel import spatial

    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    y, w = torch.ones(2, 3, 4, 4), torch.ones(3, requires_grad=True)
    with torch.no_grad():
        assert fused_act.takes_kernel(y, w)
        for n_space, takes in ((2, False), (1, True)):
            with spatial.sharded(types.SimpleNamespace(n_space=n_space)):
                assert fused_act.takes_kernel(y, w) is takes, n_space
    assert not fused_act.takes_kernel(y, w) and fused_act.takes_kernel(y)


@pytest.mark.parametrize("form", ["plain", "upsample", "downsample"])
def test_modulated_conv_undemodulated_then_demodulated_is_forward(form):
    """``ModulatedConv2d.undemodulated`` times its ``demod`` is ``forward``:
    bit for bit for the plain and downsampling convs; for the upsampling
    conv, whose blur now comes before the demodulation, within float32
    rounding."""
    from stylerenderer_tpu_torch.nn.layers import ModulatedConv2d

    conv = ModulatedConv2d(6, 5, 3, 8, upsample=form == "upsample",
                           downsample=form == "downsample")
    g = torch.Generator().manual_seed(1)
    x, style = torch.randn(2, 6, 8, 8, generator=g), torch.randn(2, 8, generator=g)
    with torch.no_grad():
        want = conv(x, style)
        y, demod = conv.undemodulated(x, style)
    got = y * demod[:, :, None, None]
    if form == "upsample":
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    else:
        assert torch.equal(got, want)
    assert y.shape == want.shape and demod.shape == (2, 5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_styled_layers_take_the_epilogue_kernel(monkeypatch, dtype):
    """``GeneratorWithMap(32, 64, 2)`` with the host build standing in for
    the card: a no-grad forward launches the epilogue once per styled conv
    (7), ResBlock activation (8) and mapping layer (2), and its image is the
    plain path's (float32: to rounding, the upsampling convs demodulating
    after their blur; bfloat16: the relative L2 of one bfloat16 rounding
    against nine); a forward under autograd launches nothing and is the plain
    path, bit for bit."""
    from stylerenderer_tpu_torch.face3d import (
        mesh_point_normal, random_apply_pose3D, synthetic_face,
    )
    from stylerenderer_tpu_torch.models import GeneratorWithMap, make_noise

    gen = GeneratorWithMap(32, 64, 2, seed=3, dtype=dtype, device="cpu").eval()
    with torch.no_grad():
        for m in gen.modules():
            if type(m).__name__ == "NoiseInjection":
                m.weight.fill_(0.3)
            if type(m).__name__ == "FusedLeakyReLU":
                m.bias.normal_(0, 0.1, generator=torch.Generator().manual_seed(2))
    face, tri = synthetic_face(12, 24, 4, 2, device="cpu")
    g = torch.Generator().manual_seed(4)
    v = random_apply_pose3D(g, face(face.random_input(2, g)))
    mesh = (v, mesh_point_normal(v, tri), tri)
    z, noise = torch.randn(2, 64, generator=g), make_noise(32, 2, g)
    with torch.no_grad():
        plain = gen([z], mesh, noise=noise)[0]

    def host_launch(y, bias=None, *rest):
        fused_bias_act.launches += 1
        return fused_bias_act_host(y, None if bias is None else bias.float(), *rest)

    monkeypatch.setattr(fused_act, "takes_kernel",
                        lambda x, *inputs: not fused_act.records(x, *inputs))
    monkeypatch.setattr(fused_act, "fused_bias_act_cuda", host_launch)
    before = fused_bias_act.launches
    with torch.no_grad():
        fused = gen([z], mesh, noise=noise)[0]
    assert fused_bias_act.launches == before + 7 + 8 + 2
    img = gen([z], mesh, noise=noise)[0]
    assert fused_bias_act.launches == before + 17 and img.requires_grad
    assert torch.equal(img.detach(), plain)
    rel = float((fused.double() - plain.double()).norm() / plain.double().norm())
    assert rel < (1e-6 if dtype == torch.float32 else 0.02), rel

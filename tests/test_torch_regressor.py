"""The port's Regressor slice against the JAX package: the dominant
singular pair, ``SpectralEqualConv2d`` (power iteration and exact sigma:
output, updated ``u`` and ``v``, gradient in ``weight_bar``),
``ConvLayer(activate="sp")``, the ``Regressor`` at 16 and 32 px (its
``fc0`` flatten permutation at 4x4xC), one ``regressor_step`` against the
JAX loss and ``value_and_grad``, the self-supervised training's falling
loss and the projector's init hook.

The same numpy-seeded inputs go through both packages; the JAX parameters
are built from ``jax.eval_shape`` and carried to the port by
``utils/weights.py::regressor_state_dict_from_jax``. Tolerances: the
singular pair, the spectral conv and the Regressor to 1e-5; the loss to
1e-6 relative, its gradients to 1e-4 of each tensor's largest magnitude.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from stylerenderer_tpu.models import Regressor as JRegressor
from stylerenderer_tpu.nn.layers import ConvLayer as JConvLayer
from stylerenderer_tpu.nn.spectral import SpectralEqualConv2d as JSpectralEqualConv2d
from stylerenderer_tpu.nn.spectral import batch_eigen_max as j_batch_eigen_max

from stylerenderer_tpu_torch.face3d import mesh_point_normal, synthetic_face
from stylerenderer_tpu_torch.inversion import ProjectorConfig, make_projector
from stylerenderer_tpu_torch.models import GeneratorWithMap, Regressor
from stylerenderer_tpu_torch.nn.layers import ConvLayer
from stylerenderer_tpu_torch.nn.spectral import (
    SpectralEqualConv2d, batch_eigen_max, spectral_sigma_exact,
)
from stylerenderer_tpu_torch.train import (
    init_regressor_state, make_regressor_fn, make_regressor_trainer, regressor_step,
)
from stylerenderer_tpu_torch.utils.weights import _conv_layer, regressor_state_dict_from_jax

STYLE, N_MLP = 32, 2


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs files in parallel processes,
    where torch's thread pools would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(np.asarray(x), (0, 3, 1, 2))))


def _nhwc(x):
    return np.transpose(np.asarray(x), (0, 2, 3, 1))


def _params_like(module, inputs, fill):
    """A flax params tree of ``module`` made with numpy, without running
    its init: ``fill(path, shape)`` gives each leaf."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *inputs)["params"]
    return jax.tree_util.tree_map_with_path(
        lambda path, s: np.asarray(fill(jax.tree_util.keystr(path), s.shape), np.float32),
        shapes)


def _assert_rel(port, ref, rel, what=""):
    """max |port - ref| <= rel * max |ref|."""
    a, b = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    err, scale = np.abs(a - b).max(), np.abs(b).max()
    assert err <= rel * max(scale, 1e-30), f"{what}: max err {err:.3e}, scale {scale:.3e}"


# ---- the dominant singular pair -----------------------------------------------------

@pytest.mark.parametrize("shape", [(3, 5, 7), (2, 6, 4)])
def test_batch_eigen_max_matches_jax(shape):
    """``u`` with its sign (``u[-1] >= 0``) and ``sigma`` to 1e-5, and the
    exact sigma of a conv weight against numpy's SVD."""
    A = np.random.RandomState(sum(shape)).randn(*shape).astype(np.float32)
    u_j, s_j = j_batch_eigen_max(jnp.asarray(A))
    u, s = batch_eigen_max(torch.from_numpy(A))
    assert (u[:, -1] >= 0).all()
    np.testing.assert_allclose(u.numpy(), np.asarray(u_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_j), rtol=1e-5, atol=1e-5)
    w = np.random.RandomState(1).randn(6, 4, 3, 3).astype(np.float32)
    np.testing.assert_allclose(float(spectral_sigma_exact(torch.from_numpy(w))),
                               np.linalg.svd(w.reshape(6, -1))[1][0], rtol=1e-5)


# ---- the spectral-norm conv -----------------------------------------------------------

def _spectral_inputs(cin, cout, k, seed):
    rs = np.random.RandomState(seed)
    w_bar = rs.randn(cout, cin, k, k).astype(np.float32)
    bias = (rs.randn(cout) * 0.1).astype(np.float32)
    u = rs.randn(cout).astype(np.float32)
    v = rs.randn(cin * k * k).astype(np.float32)
    u, v = u / np.linalg.norm(u), v / np.linalg.norm(v)
    x = rs.randn(2, 9, 9, cin).astype(np.float32)
    return w_bar, bias, u, v, x


@pytest.mark.parametrize("power_iterations,stride,padding", [(1, 1, 1), (0, 2, 0), (3, 1, 0)])
def test_spectral_conv_matches_jax(power_iterations, stride, padding):
    """Carried ``weight_bar``, ``bias``, ``u`` and ``v``: the output, the
    power iteration's ``u`` and ``v`` (training mode) and the gradient of
    ``sum(y * cot)`` in ``weight_bar`` against ``jax.grad``, to 1e-5
    relative; in eval mode ``u`` and ``v`` stay."""
    cin, cout, k = 4, 6, 3
    w_bar, bias, u, v, x = _spectral_inputs(cin, cout, k, power_iterations + stride)
    jm = JSpectralEqualConv2d(cout, k, stride, padding, power_iterations=power_iterations)
    params = {"weight_bar": jnp.asarray(w_bar), "bias": jnp.asarray(bias)}
    spectral = {"u": jnp.asarray(u), "v": jnp.asarray(v)} if power_iterations else None

    def apply(p):
        if spectral is None:
            return jm.apply({"params": p}, jnp.asarray(x)), {}
        y, mut = jm.apply({"params": p, "spectral": spectral}, jnp.asarray(x),
                          mutable=["spectral"])
        return y, mut["spectral"]

    y_j, new_j = apply(params)
    cot = np.random.RandomState(7).randn(*y_j.shape).astype(np.float32)
    g_j = jax.grad(lambda p: jnp.sum(apply(p)[0] * cot))(params)["weight_bar"]

    conv = SpectralEqualConv2d(cin, cout, k, stride, padding,
                               power_iterations=power_iterations)
    sd = {"weight_bar": torch.from_numpy(w_bar), "bias": torch.from_numpy(bias)}
    if power_iterations:
        sd.update(u=torch.from_numpy(u), v=torch.from_numpy(v))
    conv.load_state_dict(sd, strict=True)
    y = conv.train()(_nchw(x))
    (y * _nchw(cot)).sum().backward()
    _assert_rel(_nhwc(y.detach()), y_j, 1e-5, "output")
    _assert_rel(conv.weight_bar.grad.numpy(), g_j, 1e-5, "grad weight_bar")
    if power_iterations:
        _assert_rel(conv.u.numpy(), new_j["u"], 1e-5, "u")
        _assert_rel(conv.v.numpy(), new_j["v"], 1e-5, "v")
        u1 = conv.u.clone()
        with torch.no_grad():
            conv.eval()(_nchw(x))
        assert torch.equal(conv.u, u1)


@pytest.mark.parametrize("downsample", [False, True])
def test_conv_layer_sp_matches_jax(downsample):
    """``ConvLayer(activate="sp")`` (Blur first when downsampling, then the
    spectral conv, no activation): output and updated ``u``, ``v`` to 1e-5
    through the converter's ``conv_sp`` branch; ``True``/``False`` still
    build the EqualConv2d layer."""
    cin, cout, k = 4, 5, 3
    w_bar, bias, u, v, x = _spectral_inputs(cin, cout, k, 11 + downsample)
    x = np.random.RandomState(3).randn(2, 8, 8, cin).astype(np.float32)
    jm = JConvLayer(cout, k, downsample=downsample, activate="sp")
    params = {"conv_sp": {"weight_bar": jnp.asarray(w_bar), "bias": jnp.asarray(bias)}}
    spectral = {"conv_sp": {"u": jnp.asarray(u), "v": jnp.asarray(v)}}
    y_j, mut = jm.apply({"params": params, "spectral": spectral}, jnp.asarray(x),
                        mutable=["spectral"])
    layer = ConvLayer(cin, cout, k, downsample=downsample, activate="sp")
    sd = {}
    blur = layer[0].kernel if downsample else None
    _conv_layer(sd, "L", params, blur, spectral)
    layer.load_state_dict({key[2:]: val for key, val in sd.items()}, strict=True)
    y = layer.train()(_nchw(x))
    assert len(layer) == 1 + downsample and isinstance(layer[-1], SpectralEqualConv2d)
    _assert_rel(_nhwc(y.detach()), y_j, 1e-5, "output")
    _assert_rel(layer[-1].u.numpy(), mut["spectral"]["conv_sp"]["u"], 1e-5, "u")
    _assert_rel(layer[-1].v.numpy(), mut["spectral"]["conv_sp"]["v"], 1e-5, "v")
    assert [type(m).__name__ for m in ConvLayer(cin, cout, k, activate=True)] == [
        "EqualConv2d", "FusedLeakyReLU"]
    assert [type(m).__name__ for m in ConvLayer(cin, cout, k, activate="lrelu")] == [
        "EqualConv2d", "FusedLeakyReLU"]
    assert [type(m).__name__ for m in ConvLayer(cin, cout, k, activate=False)] == [
        "EqualConv2d"]


# ---- the Regressor --------------------------------------------------------------------

def _regressor_params(size, seed):
    rs = np.random.RandomState(seed)

    def fill(path, shape):
        if "fc" in path and path.endswith("['weight']"):
            return rs.randn(*shape) / 0.01  # EqualLinear's N(0, 1) / lr_mul
        if path.endswith("['weight']"):
            return rs.randn(*shape)
        return rs.randn(*shape) * 0.1  # the conv and activation biases

    return _params_like(JRegressor(size, STYLE, N_MLP, channel_multiplier=1),
                        [jnp.zeros((1, size, size, 3))], fill)


@pytest.fixture(scope="module")
def regressors():
    """JAX params, the jitted JAX apply and the port's net, per size."""
    out = {}
    for size in (16, 32):
        jreg = JRegressor(size, STYLE, N_MLP, channel_multiplier=1)
        params = _regressor_params(size, size)
        net = Regressor(size, STYLE, N_MLP, channel_multiplier=1, device="cpu")
        net.load_state_dict(regressor_state_dict_from_jax(params), strict=True)
        out[size] = dict(params=params, net=net,
                         apply=jax.jit(lambda p, x, m=jreg: m.apply({"params": p}, x)))
    return out


@pytest.mark.parametrize("size", [16, 32])
def test_regressor_matches_jax(regressors, size):
    """``[B, style]`` latents to 1e-5; ``fc0`` takes 2 x the channels of
    every scale's statistics, then the 4x4xC features (permuted)."""
    r = regressors[size]
    x = np.random.RandomState(size + 1).uniform(-1, 1, (2, size, size, 3)).astype(np.float32)
    want = np.asarray(r["apply"](r["params"], jnp.asarray(x)))
    with torch.no_grad():
        got = r["net"](_nchw(x)).numpy()
    assert got.shape == (2, STYLE) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert r["net"].fc0.weight.shape[1] == r["net"].n_stats + 16 * 512


def test_regressor_step_matches_jax(regressors):
    """One ``regressor_step`` on given ``(img, w)``: the loss against the
    JAX loss to 1e-6 relative, the gradients (left on the parameters)
    against ``value_and_grad`` to 1e-4 of each tensor's largest magnitude,
    and the update Adam's first step, ``p - lr g / (|g| + eps)``."""
    size = 16
    r = regressors[size]
    rs = np.random.RandomState(5)
    img = rs.uniform(-1, 1, (3, size, size, 3)).astype(np.float32)
    w = (rs.randn(3, STYLE) * 2 + 0.5).astype(np.float32)
    jreg = JRegressor(size, STYLE, N_MLP, channel_multiplier=1)

    @jax.jit
    def loss_and_grad(p):
        def f(pp):
            w_pred = jreg.apply({"params": pp}, jnp.asarray(img))
            w_dir = w / jnp.sqrt(jnp.mean(w ** 2, -1, keepdims=True) + 1e-8)
            return jnp.mean((w_pred - w_dir) ** 2)
        return jax.value_and_grad(f)(p)

    loss_j, grads_j = loss_and_grad(r["params"])
    net = Regressor(size, STYLE, N_MLP, channel_multiplier=1, device="cpu")
    net.load_state_dict(regressor_state_dict_from_jax(r["params"]), strict=True)
    state = init_regressor_state(net, lr=1e-4)
    before = {n: p.detach().clone() for n, p in net.named_parameters()}
    m = regressor_step(state, _nchw(img), torch.from_numpy(w))
    assert state.step == 1 and set(m) == {"regressor_loss"}
    np.testing.assert_allclose(float(m["regressor_loss"]), float(loss_j), rtol=1e-6)
    want = regressor_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, grads_j))
    for name, p in net.named_parameters():
        _assert_rel(p.grad.numpy(), want[name].numpy(), 1e-4, name)
        g = p.grad.double().numpy()
        np.testing.assert_allclose(p.detach().numpy(),
                                   before[name].double().numpy() - 1e-4 * g / (np.abs(g) + 1e-8),
                                   rtol=1e-6, atol=1e-6)


# ---- self-supervised training and the projector's hook ------------------------------

@pytest.fixture(scope="module")
def tiny_gar():
    face, tri = synthetic_face(6, 12, 4, 2, device="cpu")
    gen = GeneratorWithMap(16, STYLE, N_MLP, channel_multiplier=1, seed=1, device="cpu")
    return gen, face, tri


def test_regressor_training_reduces_loss(tiny_gar):
    """30 steps at B=4, lr 3e-4 on the GAR's own renders (the JAX test's
    sizes): every loss finite, the last 5 below the first 5 on average;
    the sampler's draws come from the state's generator, so the run
    repeats bit for bit."""
    gen, face, tri = tiny_gar

    def run(n):
        reg = Regressor(16, STYLE, N_MLP, channel_multiplier=1, seed=2, device="cpu")
        init_fn, step_fn = make_regressor_trainer(reg, gen, face, tri, batch=4, lr=3e-4)
        state = init_fn(3)
        return [float(step_fn(state)["regressor_loss"]) for _ in range(n)]

    losses = run(30)
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5]), losses[:3] + losses[-3:]
    assert run(2) == losses[:2]


def test_regressor_fn_sets_the_projector_init(tiny_gar):
    """``make_regressor_fn`` is the fit's starting point: with both learning
    rates 0, ``w_plus`` is ``R(target) * mean_w_norm`` at every layer, and
    the first loss differs from the mean-latent init's; the Regressor keeps
    its own (training) mode."""
    gen, face, tri = tiny_gar
    reg = Regressor(16, STYLE, N_MLP, channel_multiplier=1, seed=4, device="cpu")
    fn = make_regressor_fn(reg, mean_w_norm=1.5)
    cfg = ProjectorConfig(iters=2, lr=0.0, lr_geom=0.0, w_lpips=0.0, w_lmk=0.0)
    target = torch.rand(2, 3, 16, 16, generator=torch.Generator().manual_seed(5)) * 2 - 1
    out = make_projector(gen, face, tri, cfg, regressor_fn=fn)(0, target)
    w0 = (reg(target) * 1.5).detach()
    assert reg.training
    assert torch.equal(out["w_plus"], w0[:, None, :].expand(-1, gen.n_latent, -1))
    mean = make_projector(gen, face, tri, cfg)(0, target)
    assert np.isfinite(out["loss_history"].numpy()).all()
    assert float(out["loss_history"][0]) != float(mean["loss_history"][0])


def test_oracle_regressor_init_beats_mean_latent(tiny_gar):
    """The projector's init hook with an oracle encoder (the latent the
    target was rendered from) starts below half the mean-latent init's
    loss and stays ahead after 8 steps (the JAX package's composition
    test)."""
    gen, face, tri = tiny_gar
    g = torch.Generator().manual_seed(7)
    with torch.no_grad():
        w_true = gen.get_latent(torch.randn(2, STYLE, generator=g))
        v0 = face(torch.zeros(2, face.sigma.shape[0]))
        pyramid = gen.normal_pyramid((v0, mesh_point_normal(v0, tri), tri))
        target = gen.synthesize(w_true[:, None].repeat(1, gen.n_latent, 1), pyramid,
                                [torch.zeros(1, 1, 1, 1)] * gen.num_layers)
    cfg = ProjectorConfig(iters=8, w_lpips=0.0, w_lmk=0.0, w_prior=0.0, w_pose=0.0)
    h_mean = make_projector(gen, face, tri, cfg)(3, target)["loss_history"].numpy()
    h_orac = make_projector(gen, face, tri, cfg,
                            regressor_fn=lambda img: w_true)(3, target)["loss_history"].numpy()
    assert np.isfinite(h_mean).all() and np.isfinite(h_orac).all()
    assert h_orac[0] < h_mean[0] * 0.5, (h_orac[0], h_mean[0])
    assert h_orac[-1] < h_mean[-1], (h_orac[-1], h_mean[-1])


def test_regressor_refuses_missing_card(monkeypatch):
    """The Regressor and the heads run on the card unless asked otherwise,
    and never fall back to the CPU."""
    from stylerenderer_tpu_torch.supervisors import make_extra_heads

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Regressor(16, STYLE, N_MLP, channel_multiplier=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_extra_heads(0, lmk=True)

"""The port's evaluation layer against the JAX package: the FID
InceptionV3, LPIPS (values and gradients), FID's statistics and distance,
the stats pickle, PPL's interpolations, filter and distances, the LPIPS
harness, and the FID chain from the GAR's samples to the distance.

The same numpy-seeded inputs go through both packages, the JAX parameters
carried across by ``utils/weights.py``'s converters. The JAX networks are
applied jitted, one compile per input shape; the port runs on the CPU,
whose convolutions sum in another order than XLA's (hence the stated
tolerances). A 2048-dimensional FID takes a scipy ``sqrtm`` of ~10 s on
the CPU, so only the chain and ``cli.fid`` compute one; the distance
itself is held at 64 dimensions, where it is the same code.
"""

import os
import pickle

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from stylerenderer_tpu.eval import fid as j_fid
from stylerenderer_tpu.eval import lpips_harness as j_harness
from stylerenderer_tpu.eval import ppl as j_ppl
from stylerenderer_tpu.eval.inception import InceptionV3 as JInceptionV3
from stylerenderer_tpu.eval.lpips import LPIPS as JLPIPS
from stylerenderer_tpu.face3d import mesh_point_normal as j_mesh_point_normal
from stylerenderer_tpu.face3d import synthetic_face as j_synthetic_face
from stylerenderer_tpu.models import Generator as JGenerator
from stylerenderer_tpu.models import GeneratorWithMap as JGeneratorWithMap
from stylerenderer_tpu.utils.torch_import import import_generator

from stylerenderer_tpu_torch.eval import fid, lpips_harness, ppl
from stylerenderer_tpu_torch.eval.inception import (
    BasicConv2d, InceptionV3, load_patched_inception_v3,
)
from stylerenderer_tpu_torch.eval.lpips import LPIPS, _unit_normalize, load_lpips
from stylerenderer_tpu_torch.models import Generator, GeneratorWithMap
from stylerenderer_tpu_torch.utils.weights import (
    generator_state_dict_from_jax,
    inception_state_dict_from_jax,
    lpips_state_dict_from_jax,
    state_dict_from_jax,
)

from test_eval_fidelity import (
    TFIDInception, TVGG16Features, _randomize_bn_stats, _t_pnetlin,
)


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


def _params_like(module, inputs, fill):
    """A flax params tree of ``module`` made with numpy, without running
    its init: ``fill(path, shape)`` gives each leaf."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *inputs)["params"]
    return jax.tree_util.tree_map_with_path(
        lambda path, s: np.asarray(fill(jax.tree_util.keystr(path), s.shape), np.float32),
        shapes)


# ---- the FID InceptionV3 ------------------------------------------------------

@pytest.fixture(scope="module")
def inception():
    """JAX Inception params with He-scaled kernels and batch norm off
    identity (so a swap of its four arrays shows), the port's network with
    the same weights, and the jitted JAX apply."""
    rs = np.random.RandomState(0)

    def fill(path, shape):
        if path.endswith("['kernel']"):
            return rs.randn(*shape) * np.sqrt(2.0 / np.prod(shape[:-1]))
        if "bn_scale" in path:
            return rs.uniform(0.75, 1.25, shape)
        if "bn_var" in path:
            return rs.uniform(0.5, 1.5, shape)
        return rs.randn(*shape) * 0.1  # bn_bias, bn_mean

    params = _params_like(JInceptionV3(), [jnp.zeros((1, 75, 75, 3))], fill)
    sd = inception_state_dict_from_jax(params)
    nets = {}
    for resize in (False, True):
        nets[resize] = InceptionV3(resize_input=resize)
        nets[resize].load_state_dict(sd, strict=True)
        nets[resize].eval()
    apply = {r: jax.jit(lambda p, x, r=r: JInceptionV3(resize_input=r).apply({"params": p}, x))
             for r in (False, True)}
    return dict(params=params, nets=nets, apply=apply)


@pytest.mark.parametrize("size,batch,resize", [(96, 2, False), (64, 4, True), (320, 4, True)])
def test_inception_matches_jax(inception, size, batch, resize):
    """pool3 features to rtol/atol 1e-4 (as the JAX package's own torch
    check): at 96 px without the resize, and resized to 299 from 64 px (an
    upsample) and from 320 px (the antialiased shrink)."""
    x = np.random.RandomState(size).rand(batch, size, size, 3).astype(np.float32) * 2 - 1
    ref = np.asarray(inception["apply"][resize](inception["params"], x))
    with torch.no_grad():
        got = inception["nets"][resize](_nchw(x)).numpy()
    assert got.shape == ref.shape == (batch, 2048)
    assert np.isfinite(got).all() and got.std() > 1e-3
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_inception_state_dict_names(tmp_path):
    """The FID Inception's torch names: the torch mirror's state dict (the
    reference module names) loads strictly, through ``load_patched_
    inception_v3`` from a file too, and computes the mirror's features; the
    converter writes exactly those names."""
    torch.manual_seed(0)
    mirror = TFIDInception().eval()
    _randomize_bn_stats(mirror, 1)
    path = tmp_path / "fid_inception.pth"
    torch.save(mirror.state_dict(), str(path))
    net = load_patched_inception_v3(str(path), resize_input=False, device="cpu")
    x = torch.from_numpy(np.random.RandomState(2).rand(2, 3, 96, 96).astype(np.float32) * 2 - 1)
    with torch.no_grad():
        np.testing.assert_allclose(net(x).numpy(), mirror(x).numpy(), rtol=1e-5, atol=1e-5)
    params = _params_like(JInceptionV3(), [jnp.zeros((1, 75, 75, 3))],
                          lambda path, shape: np.zeros(shape))
    assert set(inception_state_dict_from_jax(params)) == set(mirror.state_dict())


def test_inception_random_feature_mode():
    """Without weights: kernels are flax's lecun_normal (truncated at 2
    standard deviations) times sqrt(2), batch norm at identity, and the
    network tells inputs apart (no collapse to one point)."""
    net = load_patched_inception_v3(device="cpu", resize_input=False)
    conv = net.Mixed_6c.branch7x7_2.conv.weight  # 160 x 160 x 1 x 7
    std = np.sqrt(2.0 / (160 * 7))
    w = conv.numpy() / std
    assert np.abs(w).max() <= 2.0 / 0.87962566103423978 + 1e-5
    np.testing.assert_allclose(w.std(), 1.0, atol=0.05)
    for m in net.modules():
        if isinstance(m, BasicConv2d):
            assert torch.equal(m.bn.weight, torch.ones_like(m.bn.weight))
            assert not m.bn.bias.any() and not m.bn.running_mean.any()
    rs = np.random.RandomState(3)
    with torch.no_grad():
        f = net(torch.from_numpy(rs.rand(4, 3, 96, 96).astype(np.float32) * 2 - 1)).numpy()
    assert np.isfinite(f).all()
    assert np.abs(f[0] - f[1]).mean() > 1e-2 * np.abs(f).mean()
    again = load_patched_inception_v3(device="cpu", resize_input=False)
    assert all(torch.equal(a, b) for a, b in zip(net.state_dict().values(),
                                                 again.state_dict().values()))


# ---- LPIPS ----------------------------------------------------------------------

@pytest.fixture(scope="module", params=["vgg", "alex"])
def lpips_pair(request):
    """JAX LPIPS params (He-scaled backbone, biases and heads at random; a
    few head entries negative, which both packages clip to 0) and the port's
    module with the same weights."""
    net = request.param
    rs = np.random.RandomState(4)

    def fill(path, shape):
        if path.endswith("['kernel']"):
            return rs.randn(*shape) * np.sqrt(2.0 / np.prod(shape[:-1]))
        if path.endswith("['bias']"):
            return rs.randn(*shape) * 0.05
        return rs.uniform(-0.2, 1.8, shape) / shape[0]  # lin{i}

    dummy = jnp.zeros((1, 64, 64, 3))
    model = JLPIPS(net=net)
    params = _params_like(model, [dummy, dummy], fill)
    port = LPIPS(net)
    port.load_state_dict(lpips_state_dict_from_jax(params, net), strict=True)
    port.eval().requires_grad_(False)
    @jax.jit
    def value_and_grad(a, b):
        """Distances ``[B]`` and the gradient of their sum in ``a``."""
        d, vjp = jax.vjp(lambda x: model.apply({"params": params}, x, b), a)
        return d, vjp(jnp.ones_like(d))[0]

    return dict(net=net, port=port, value_and_grad=value_and_grad)


@pytest.mark.parametrize("flat", [False, True])
def test_lpips_matches_jax(lpips_pair, flat):
    """Distances to 1e-5 relative (and 1e-6 absolute: each distance is a
    sum of squared differences of unit feature vectors, so the features'
    f32 rounding of ~1e-7 sets an absolute floor under it) and the gradient
    with respect to the first image to 1e-4 of its largest magnitude, at
    64 px; ``flat`` makes the first image one colour (a blank render),
    where the gradient must stay finite."""
    rs = np.random.RandomState(5)
    x0 = rs.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    x1 = rs.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    if flat:
        x0[:] = -0.6
    ref, gref = (np.asarray(a) for a in lpips_pair["value_and_grad"](x0, x1))
    a = _nchw(x0).requires_grad_(True)
    d = lpips_pair["port"](a, _nchw(x1))
    (g,) = torch.autograd.grad(d.sum(), a)
    g = np.transpose(g.numpy(), (0, 2, 3, 1))
    assert np.isfinite(g).all() and np.isfinite(gref).all()
    np.testing.assert_allclose(d.detach().numpy(), ref, rtol=1e-5, atol=1e-6)
    scale = np.abs(gref).max()
    assert scale > 0
    np.testing.assert_allclose(g / scale, gref / scale, rtol=0, atol=1e-4)


def test_lpips_gradient_finite_where_features_vanish():
    """The unit normalization's gradient at a zero feature vector is finite
    (the reference's ``f / (sqrt(sum f^2) + eps)`` gives NaN there); with
    backbone biases far below zero every tapped ReLU feature is zero, the
    distance is 0 and its gradient finite; identical images give 0."""
    f = torch.zeros(1, 8, 2, 2, requires_grad=True)
    assert torch.isfinite(torch.autograd.grad(_unit_normalize(f).sum(), f)[0]).all()
    reference = f / (torch.sqrt(torch.sum(f * f, 1, keepdim=True)) + 1e-10)
    assert torch.isnan(torch.autograd.grad(reference.sum(), f)[0]).all()
    net = load_lpips("vgg", device="cpu")
    with torch.no_grad():
        for tid in (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28):
            net.features[tid].bias.fill_(-1e3)
    a = torch.zeros(1, 3, 32, 32, requires_grad=True)
    d = net(a, torch.rand(1, 3, 32, 32) * 2 - 1)
    (g,) = torch.autograd.grad(d.sum(), a)
    assert float(d.detach()) == 0.0 and torch.isfinite(g).all()
    x = torch.rand(2, 3, 32, 32) * 2 - 1
    assert not load_lpips("alex", device="cpu")(x, x).any()


@pytest.mark.parametrize("net", ["vgg", "alex"])
def test_lpips_state_dict_names(tmp_path, net):
    """torchvision's ``features.{index}`` backbone names and the published
    heads' ``lin{i}.model.1.weight``: a torch backbone saved with those
    names and heads saved with those names load through ``load_lpips``
    (other keys ignored), and give the reference's distance (the torch
    mirror of PNetLin, for VGG); without heads every head is 1/C; the
    converter writes exactly the module's names."""
    torch.manual_seed(3)
    if net == "vgg":
        mirror = TVGG16Features().eval()
    else:
        mirror = torch.nn.Module()
        mirror.features = LPIPS("alex").features
    backbone = tmp_path / "backbone.pth"
    torch.save(dict(mirror.state_dict(), **{"classifier.0.weight": torch.zeros(2)}),
               str(backbone))
    chans = LPIPS(net).state_dict()
    g = torch.Generator().manual_seed(4)
    lins = [torch.rand(chans[f"lin{i}.model.1.weight"].shape[1], generator=g) * 0.01
            for i in range(5)]
    heads = tmp_path / "heads.pth"
    torch.save({f"lin{i}.model.1.weight": w.view(1, -1, 1, 1) for i, w in enumerate(lins)},
               str(heads))
    port = load_lpips(net, backbone_weights=str(backbone), linear_weights=str(heads),
                      device="cpu")
    for k, v in mirror.state_dict().items():
        assert torch.equal(port.state_dict()[k], v), k
    x0 = torch.rand(2, 3, 64, 64) * 2 - 1
    x1 = torch.rand(2, 3, 64, 64) * 2 - 1
    if net == "vgg":
        with torch.no_grad():
            ref = _t_pnetlin(mirror, lins, x0, x1)
        np.testing.assert_allclose(port(x0, x1).numpy(), ref.numpy(), rtol=1e-5)
    default = load_lpips(net, device="cpu")
    for i in range(5):
        w = default.state_dict()[f"lin{i}.model.1.weight"]
        torch.testing.assert_close(w, torch.full_like(w, 1.0 / w.shape[1]), rtol=0, atol=0)
    params = _params_like(JLPIPS(net=net), [jnp.zeros((1, 64, 64, 3))] * 2,
                          lambda path, shape: np.zeros(shape))
    assert set(lpips_state_dict_from_jax(params, net)) == set(port.state_dict())


# ---- FID: statistics, distance, pickles ------------------------------------------

def test_fid_functions_match_jax():
    """``feature_stats``, ``frechet_distance`` (also where the square root
    needs the singular offset) and ``compute_fid``: to 1e-10 relative, at
    64 dimensions."""
    rs = np.random.RandomState(6)
    a = rs.randn(40, 64).astype(np.float32)
    b = (rs.randn(50, 64) * 1.3 + 0.2).astype(np.float32)
    for x in (a, b):
        for mine, theirs in zip(fid.feature_stats(x), j_fid.feature_stats(x)):
            np.testing.assert_allclose(mine, theirs, rtol=1e-10, atol=0)
    mu_b, cov_b = j_fid.feature_stats(b)
    mu_a, cov_a = j_fid.feature_stats(a)
    d = fid.frechet_distance(mu_a, cov_a, mu_b, cov_b)
    assert d > 0
    np.testing.assert_allclose(d, j_fid.frechet_distance(mu_a, cov_a, mu_b, cov_b), rtol=1e-10)
    np.testing.assert_allclose(fid.compute_fid(a, mu_b, cov_b), j_fid.compute_fid(a, mu_b, cov_b),
                               rtol=1e-10)
    # rank 3 against rank 3: a singular product, its square root complex
    few, other = rs.randn(4, 64), rs.randn(4, 64)
    args = (*j_fid.feature_stats(few), *j_fid.feature_stats(other))
    np.testing.assert_allclose(fid.frechet_distance(*args), j_fid.frechet_distance(*args),
                               rtol=1e-10)


def test_stats_pickle_loads_in_both_packages(tmp_path):
    rs = np.random.RandomState(7)
    mu, cov = rs.randn(8), rs.randn(8, 8)
    j_fid.save_stats(str(tmp_path / "jax.pkl"), mu, cov, meta={"size": 16})
    for m, c in (fid.load_stats(str(tmp_path / "jax.pkl")),):
        np.testing.assert_array_equal(m, mu)
        np.testing.assert_array_equal(c, cov)
    fid.save_stats(str(tmp_path / "port.pkl"), mu * 2, cov * 2, meta={"n": 3})
    m, c = j_fid.load_stats(str(tmp_path / "port.pkl"))
    np.testing.assert_array_equal(m, mu * 2)
    np.testing.assert_array_equal(c, cov * 2)
    with open(tmp_path / "port.pkl", "rb") as f:
        assert pickle.load(f)["meta"] == {"n": 3}


def test_extract_features_slices_the_residual():
    """Full batches are asked for and the last one's residual is sliced
    off; a dataset iterator stops at ``n_samples``."""
    asked = []

    def sample(generator, batch):
        asked.append(batch)
        return torch.randn(batch, 3, generator=generator)

    feats = fid.extract_features_from_samples(sample, lambda x: x * 2, 10, 4,
                                              torch.Generator().manual_seed(0))
    assert asked == [4, 4, 4] and feats.shape == (10, 3)
    g = torch.Generator().manual_seed(0)
    want = torch.cat([torch.randn(4, 3, generator=g) for _ in range(3)])[:10] * 2
    np.testing.assert_array_equal(feats, want.numpy())
    it = (torch.full((3, 2), float(i)) for i in range(5))
    out = fid.extract_features_from_dataset(it, lambda x: x, 7)
    assert out.shape == (7, 2) and out[-1, 0] == 2.0


# ---- PPL ------------------------------------------------------------------------

def test_lerp_slerp_match_jax():
    rs = np.random.RandomState(8)
    a, b = rs.randn(6, 16).astype(np.float32), rs.randn(6, 16).astype(np.float32)
    t = rs.rand(6, 1).astype(np.float32)
    np.testing.assert_allclose(ppl.lerp(torch.from_numpy(a), torch.from_numpy(b),
                                        torch.from_numpy(t)).numpy(),
                               np.asarray(j_ppl.lerp(a, b, t)), rtol=1e-6, atol=1e-6)
    for tt in (t, t * 0, t * 0 + 1):
        np.testing.assert_allclose(
            ppl.slerp(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(tt)).numpy(),
            np.asarray(j_ppl.slerp(jnp.asarray(a), jnp.asarray(b), jnp.asarray(tt))),
            rtol=1e-6, atol=1e-6)


def test_ppl_filtered_mean_exact():
    d = np.random.RandomState(9).lognormal(size=257)
    assert ppl.ppl_filtered_mean(d) == j_ppl.ppl_filtered_mean(d)
    assert ppl.ppl_filtered_mean(d, 5.0, 90.0) == j_ppl.ppl_filtered_mean(d, 5.0, 90.0)


PPL_SIZE, PPL_LATENT = 32, 16


@pytest.fixture(scope="module")
def ppl_models():
    """``Generator(32, 16, 2)`` with perturbed weights in both packages (the
    port's drawn, carried to JAX by ``import_generator`` and back), one
    noise set, and both packages' VGG LPIPS with the same weights."""
    gen = Generator(PPL_SIZE, PPL_LATENT, 2, device="cpu", seed=5)
    rs = np.random.RandomState(10)
    sd = {k: v.numpy() + 0.2 * rs.randn(*v.shape).astype(np.float32)
          for k, v in gen.state_dict().items() if "kernel" not in k}
    params = import_generator(sd, PPL_SIZE, 2, with_map=False)
    gen.load_state_dict(generator_state_dict_from_jax(params), strict=True)
    gen.eval().requires_grad_(False)
    noise = [rs.randn(2, r, r, 1).astype(np.float32) for r in (4, 8, 8, 16, 16, 32, 32)]
    jlp = JLPIPS(net="vgg")
    dummy = jnp.zeros((1, 64, 64, 3))

    def fill(path, shape):
        if path.endswith("['kernel']"):
            return rs.randn(*shape) * np.sqrt(2.0 / np.prod(shape[:-1]))
        return np.full(shape, 1.0 / shape[0]) if "lin" in path else np.zeros(shape)

    lparams = _params_like(jlp, [dummy, dummy], fill)
    port_lpips = LPIPS("vgg")
    port_lpips.load_state_dict(lpips_state_dict_from_jax(lparams), strict=True)
    port_lpips.eval().requires_grad_(False)
    jgen = JGenerator(PPL_SIZE, PPL_LATENT, 2)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jnoise = [jnp.asarray(n) for n in noise]

    def j_map(z):
        return jgen.apply({"params": jparams}, z, method=jgen.get_latent)

    def j_synth(latents, input_is_latent):
        return jgen.apply({"params": jparams}, [latents], input_is_latent=input_is_latent,
                          noise=jnoise)[0]

    def p_synth(latents, input_is_latent):
        return gen([latents], input_is_latent=input_is_latent,
                   noise=[_nchw(n) for n in noise])[0]

    return dict(port=(gen.get_latent, p_synth, port_lpips),
                jax=(j_map, j_synth, lambda a, b: jlp.apply({"params": lparams}, a, b)))


def _jax_draws(key, batch, sampling):
    """``eval/ppl.py``'s own draws from ``key``: ``split(key, 3)``, two
    normals and ``t``."""
    k1, k2, k3 = jax.random.split(key, 3)
    z0 = jax.random.normal(k1, (batch, PPL_LATENT))
    z1 = jax.random.normal(k2, (batch, PPL_LATENT))
    t = jax.random.uniform(k3, (batch, 1)) if sampling == "full" else jnp.zeros((batch, 1))
    return z0, z1, t


@pytest.mark.parametrize("space,sampling", [("w", "end"), ("w", "full"), ("z", "end"),
                                            ("z", "full")])
def test_ppl_distances_match_jax(ppl_models, space, sampling):
    """The JAX sampler (eager) and ``ppl_distances`` on the JAX sampler's
    own draws, crop on (32 px -> 16 px), the same weights and noise: to
    rtol 1e-3 at eps=1e-2."""
    key = jax.random.PRNGKey({"end": 1, "full": 2}[sampling])
    sampler = j_ppl.make_ppl_sampler(*ppl_models["jax"], PPL_LATENT, space=space,
                                     sampling=sampling, eps=1e-2, crop=True)
    ref = np.asarray(sampler(key, 2))
    z0, z1, t = (torch.from_numpy(np.array(a)) for a in _jax_draws(key, 2, sampling))
    got = ppl.ppl_distances(*ppl_models["port"], z0, z1, t, space=space, eps=1e-2,
                            crop=True).numpy()
    assert np.isfinite(got).all() and (got > 0).all()
    np.testing.assert_allclose(got, ref, rtol=1e-3)


def test_ppl_default_eps_finite(ppl_models):
    """At the default eps=1e-4 the distance is f32 rounding of two nearly
    equal images divided by 1e-8, in both packages, so the packages are not
    held to each other there: both give finite, non-negative values."""
    key = jax.random.PRNGKey(3)
    sampler = j_ppl.make_ppl_sampler(*ppl_models["jax"], PPL_LATENT, crop=True)
    ref = np.asarray(sampler(key, 2))
    got = ppl.ppl_distances(*ppl_models["port"], *(torch.from_numpy(np.array(a)) for a in
                                                   _jax_draws(key, 2, "end")),
                            crop=True).numpy()
    for d in (ref, got):
        assert np.isfinite(d).all() and (d >= 0).all()


def test_ppl_draw_and_compute():
    """``ppl_draw``: ``t`` zero at ``"end"``, in [0, 1) at ``"full"``;
    ``compute_ppl`` takes full batches and the filtered mean of the first
    ``n_samples``."""
    z0, z1, t = ppl.ppl_draw(torch.Generator().manual_seed(0), 5, 7, "end")
    assert z0.shape == z1.shape == (5, 7) and not t.any() and not torch.equal(z0, z1)
    _, _, t = ppl.ppl_draw(torch.Generator().manual_seed(0), 5, 7, "full")
    assert t.shape == (5, 1) and bool(((t >= 0) & (t < 1)).all()) and t.any()
    with pytest.raises(ValueError):
        ppl.ppl_draw(torch.Generator(), 2, 3, "mid")
    calls = []

    def sampler(generator, batch):
        calls.append(batch)
        return torch.arange(len(calls) * batch, (len(calls) + 1) * batch, dtype=torch.float32)

    got = ppl.compute_ppl(sampler, torch.Generator(), 10, 4)
    assert calls == [4, 4, 4]
    assert got == j_ppl.ppl_filtered_mean(np.arange(4, 14, dtype=np.float32))


# ---- the LPIPS harness ------------------------------------------------------------

def test_harness_matches_jax():
    """``l2``, ``psnr``, ``ssim``, ``dssim``, ``score_2afc``, ``score_jnd``
    and ``voc_ap``: to 1e-5."""
    rs = np.random.RandomState(11)
    p0 = rs.uniform(-1, 1, (3, 20, 24, 3)).astype(np.float32)
    p1 = np.clip(p0 + rs.randn(*p0.shape).astype(np.float32) * 0.3, -1, 1)
    t0, t1 = _nchw(p0), _nchw(p1)
    for mine, theirs in ((lpips_harness.l2_distance, j_harness.l2_distance),
                         (lpips_harness.dssim_distance, j_harness.dssim_distance)):
        np.testing.assert_allclose(mine(t0, t1).numpy(), np.asarray(theirs(p0, p1)),
                                   rtol=1e-5, atol=1e-5)
    u0, u1 = (p0 + 1) * 127.5, (p1 + 1) * 127.5
    np.testing.assert_allclose(lpips_harness.psnr(_nchw(u0), _nchw(u1)).numpy(),
                               np.asarray(j_harness.psnr(u0, u1)), rtol=1e-5)
    np.testing.assert_allclose(lpips_harness.ssim(_nchw(u0), _nchw(u1)).numpy(),
                               np.asarray(j_harness.ssim(u0, u1)), rtol=1e-5, atol=1e-5)
    d0, d1 = rs.rand(50), rs.rand(50)
    d1[:5] = d0[:5]  # ties count half
    gts = rs.rand(50)
    s, per = lpips_harness.score_2afc(d0, d1, gts)
    js, jper = j_harness.score_2afc(d0, d1, gts)
    np.testing.assert_allclose(s, js, rtol=1e-5)
    np.testing.assert_allclose(per, jper, rtol=1e-5)
    ds, sames = rs.rand(60), (rs.rand(60) < 0.4).astype(np.float64)
    np.testing.assert_allclose(lpips_harness.score_jnd(ds, sames), j_harness.score_jnd(ds, sames),
                               rtol=1e-5)
    rec, prec = np.sort(rs.rand(20)), rs.rand(20)
    np.testing.assert_allclose(lpips_harness.voc_ap(rec, prec), j_harness.voc_ap(rec, prec),
                               rtol=1e-5)


# ---- the slice as a whole: the FID chain ---------------------------------------

def test_fid_chain_matches_jax(inception):
    """``GeneratorWithMap(16, 32, 2)`` with JAX weights and the same z, mesh
    and noise, sampled by both packages (JAX jitted: eager JAX takes ~18 s
    here and differs from it by ~1e-5 on sliver pixels); each package's
    Inception (the resize to 299 included, B=4), ``feature_stats`` and
    ``frechet_distance`` against the same stats: the FIDs agree to rtol
    1e-3."""
    size, latent, B = 16, 32, 4
    gen = GeneratorWithMap(size, latent, 2, channel_multiplier=1, device="cpu", seed=6)
    rs = np.random.RandomState(12)
    sd = {k: v.numpy() + 0.2 * rs.randn(*v.shape).astype(np.float32)
          for k, v in gen.state_dict().items() if "kernel" not in k}
    params = import_generator(sd, size, 2, with_map=True)
    gen.load_state_dict(state_dict_from_jax(params), strict=True)
    gen.eval()
    face, tri = j_synthetic_face(12, 24, 4, 2)
    x = rs.randn(B, 6).astype(np.float32) * np.asarray(face.sigma)
    vert = np.array(face(jnp.asarray(x)))
    norm = np.array(j_mesh_point_normal(jnp.asarray(vert), tri))
    tri = np.array(tri)
    z = rs.randn(B, latent).astype(np.float32)
    noise = [rs.randn(B, r, r, 1).astype(np.float32) for r in (4, 8, 8, 16, 16)]
    jg = JGeneratorWithMap(size, latent, 2, channel_multiplier=1)
    jtri = jnp.asarray(tri)
    jimg = jax.jit(lambda p, z, v, n, nz: jg.apply({"params": p}, [z], (v, n, jtri),
                                                   noise=nz)[0])(params, z, vert, norm, noise)
    jfeats = np.asarray(inception["apply"][True](inception["params"], jimg))
    with torch.no_grad():
        img = gen([torch.from_numpy(z)], (torch.from_numpy(vert), torch.from_numpy(norm),
                                          torch.from_numpy(tri).long()),
                  noise=[_nchw(n) for n in noise])[0]
        feats = inception["nets"][True](img).numpy()
    real = rs.randn(2048).astype(np.float64) * 0.1, np.diag(rs.uniform(0.5, 1.5, 2048))
    mine = fid.frechet_distance(*fid.feature_stats(feats), *real)
    theirs = j_fid.frechet_distance(*j_fid.feature_stats(jfeats), *real)
    assert np.isfinite(mine) and mine > 0
    np.testing.assert_allclose(mine, theirs, rtol=1e-3)


# ---- the CLIs on the CPU ------------------------------------------------------------

TINY = ["--size", "16", "--latent", "32", "--n_mlp", "2", "--channel_multiplier", "1",
        "--device", "cpu"]


@pytest.fixture(scope="module")
def tiny_ckpt(tmp_path_factory):
    """A ``cli.train`` checkpoint at size 16, and a 6-image shard of the
    port's synthetic-face writer."""
    from stylerenderer_tpu_torch.data import write_synth_dataset
    from stylerenderer_tpu_torch.train import init_train_state
    from stylerenderer_tpu_torch.utils.checkpoint import save_checkpoint
    from stylerenderer_tpu_torch.utils.config import TrainConfig

    root = tmp_path_factory.mktemp("eval_cli")
    cfg = TrainConfig(size=16, latent=32, n_mlp=2, channel_multiplier=1, batch=2)
    save_checkpoint(str(root / "ckpt"), 1, init_train_state(cfg, "cpu", seed=3), cfg)
    shard = str(root / "faces16.srpack")
    assert write_synth_dataset(shard, 6, size=16, batch=6, device="cpu") == 6
    return root, str(root / "ckpt"), shard


def test_cli_calc_inception_fid_ppl(tiny_ckpt, capsys):
    """``cli.calc_inception`` on the port writer's shard writes the stats
    pickle (JAX's ``load_stats`` reads it); ``cli.fid --with_map`` and
    ``cli.ppl`` (GAR and unconditioned) on a port checkpoint print finite
    numbers."""
    from stylerenderer_tpu_torch.cli import calc_inception, fid as cli_fid, ppl as cli_ppl

    root, ckpt, shard = tiny_ckpt
    stats = str(root / "stats.pkl")
    assert calc_inception.main([shard, "--size", "16", "--batch", "3", "--device", "cpu",
                                "--out", stats]) == stats
    mu, cov = j_fid.load_stats(stats)
    assert mu.shape == (2048,) and cov.shape == (2048, 2048) and np.isfinite(cov).all()
    with open(stats, "rb") as f:
        assert pickle.load(f)["meta"] == {"size": 16, "n": 6, "pretrained": False}
    value = cli_fid.main(["--ckpt", ckpt, "--inception", stats, "--with_map", "--n_sample",
                          "5", "--batch", "2"] + TINY)
    assert np.isfinite(value) and value > 0
    for extra in (["--with_map"], ["--space", "z", "--sampling", "full", "--crop"]):
        argv = ["--ckpt", ckpt, "--n_sample", "3", "--batch", "2"] + TINY + extra
        if "--with_map" not in extra:  # an unconditioned generator's checkpoint
            argv[1] = str(_generator_ckpt(root))
            argv[argv.index("--size") + 1] = "32"
        assert np.isfinite(cli_ppl.main(argv))
    out = capsys.readouterr().out
    assert "fid: " in out and out.count("ppl: ") == 2


def _generator_ckpt(root):
    """A checkpoint directory holding an unconditioned ``Generator(32, 32,
    2)``'s ``g_ema`` (``crop`` needs 32 px for VGG's five taps)."""
    path = root / "gen_ckpt"
    if not path.exists():
        path.mkdir()
        from stylerenderer_tpu_torch.utils.config import TrainConfig

        g = Generator(32, 32, 2, channel_multiplier=1, device="cpu", seed=2)
        torch.save({"g_ema": g.state_dict(),
                    "args": TrainConfig(size=32, latent=32, n_mlp=2,
                                        channel_multiplier=1).to_dict()},
                   path / "000001.pt")
    return path


@pytest.mark.parametrize("cli,argv", [
    ("calc_inception", ["DIR"]),
    ("fid", ["--ckpt", "x", "--inception", "y", "--bfm", "b.mat"]),
    ("ppl", ["--ckpt", "x", "--bfm", "b.mat"]),
])
def test_eval_clis_refuse_unported(tmp_path, capsys, cli, argv):
    """An image folder (``calc_inception``) and ``--bfm`` are refused."""
    import importlib

    mod = importlib.import_module(f"stylerenderer_tpu_torch.cli.{cli}")
    argv = [str(tmp_path) if a == "DIR" else a for a in argv] + ["--device", "cpu"]
    with pytest.raises(SystemExit):
        mod.main(argv)
    why = "image-folder data is not ported" if cli == "calc_inception" else mod.NOT_PORTED["bfm"]
    assert why in capsys.readouterr().err

"""The port's generators against the JAX package: weights carried across by
``utils/weights.py``, layer parity, the whole GAR and unconditioned
Generator forwards at a small size, the generation CLI, and the port's
isolation from JAX.

Inputs are made with numpy from seeds and handed to both packages; the
port runs on the CPU (convolutions there sum in another order than XLA's,
hence the stated tolerances)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from stylerenderer_tpu.models.generator import (
    Generator as JGenerator,
    GeneratorWithMap as JGeneratorWithMap,
    StyledConv as JStyledConv,
    StyledMapConv as JStyledMapConv,
    ToRGB as JToRGB,
    stored_noise as j_stored_noise,
)
from stylerenderer_tpu.nn.layers import (
    ModulatedConv2d as JModulatedConv2d,
    ResBlock as JResBlock,
)
from stylerenderer_tpu.utils.torch_import import import_generator
from stylerenderer_tpu.face3d import mesh_point_normal as j_mesh_point_normal
from stylerenderer_tpu.face3d import synthetic_face as j_synthetic_face
from stylerenderer_tpu.ops.rasterize import rasterize_winners as j_rasterize_winners

from stylerenderer_tpu_torch.models import (
    Generator, GeneratorWithMap, StyledConv, StyledMapConv, ToRGB,
)
from stylerenderer_tpu_torch.nn.layers import ModulatedConv2d, ResBlock
from stylerenderer_tpu_torch.ops.rasterize_multi import rasterize_winners_multi
from stylerenderer_tpu_torch.utils.weights import (
    generator_state_dict_from_jax, noise_from_jax, state_dict_from_jax,
)
from torch_threads import _one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _nchw(x):
    return torch.from_numpy(np.transpose(np.asarray(x), (0, 3, 1, 2)).copy())


def _nhwc(t):
    return np.transpose(t.detach().numpy(), (0, 2, 3, 1))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_tree_equal(a, b, path=""):
    assert isinstance(b, dict) == isinstance(a, dict), path
    if isinstance(a, dict):
        assert set(a) == set(b), (path, set(a) ^ set(b))
        for k in a:
            _assert_tree_equal(a[k], b[k], f"{path}/{k}")
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, (path, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=path)


def _load_layer(port_layer, jax_params, mapping):
    """Copy flax params into a port layer via ``mapping(sd, params)``."""
    sd = {}
    mapping(sd, jax_params)
    state = port_layer.state_dict()
    state.update(sd)
    port_layer.load_state_dict(state, strict=True)
    return port_layer


def _sd_modconv(prefix):
    def fill(sd, p):
        sd[f"{prefix}weight"] = torch.from_numpy(
            np.transpose(np.asarray(p["weight"]), (3, 2, 0, 1))[None].copy())
        sd[f"{prefix}modulation.weight"] = torch.from_numpy(
            np.asarray(p["modulation"]["weight"]).T.copy())
        sd[f"{prefix}modulation.bias"] = torch.from_numpy(
            np.asarray(p["modulation"]["bias"]).copy())
    return fill


def _randomize(params, seed):
    """Replace every leaf by seeded noise, so zero-initialized biases and
    noise strengths are exercised too."""
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda x: jnp.asarray(np.asarray(rng.randn(*np.shape(x)), np.float32) * 0.5), params)


@pytest.fixture(scope="module")
def small_gar():
    """JAX GAR at size 32 (style_dim 64, n_mlp 2) with randomized params, the
    same weights in the port, and one mesh batch (B=2) for both."""
    size, sd_dim, n_mlp, B = 32, 64, 2, 2
    jg = JGeneratorWithMap(size, sd_dim, n_mlp)
    face, tri = j_synthetic_face(12, 24, 4, 2)
    rng = np.random.RandomState(0)
    x = rng.randn(B, 6).astype(np.float32) * np.asarray(face.sigma)
    vert = np.array(face(jnp.asarray(x)))
    norm = np.array(j_mesh_point_normal(jnp.asarray(vert), tri))
    tri = np.array(tri)
    z0 = jnp.zeros((B, sd_dim))
    params = jax.jit(jg.init)(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
        [z0], (jnp.asarray(vert), jnp.asarray(norm), jnp.asarray(tri)))["params"]
    params = _np_tree(_randomize(params, 1))
    pg = GeneratorWithMap(size, sd_dim, n_mlp, device="cpu")
    pg.load_state_dict(state_dict_from_jax(params), strict=True)
    return dict(jg=jg, pg=pg, params=params, vert=vert, norm=norm, tri=tri,
                size=size, style_dim=sd_dim, B=B)


def test_weights_round_trip(small_gar):
    """JAX params -> port state_dict -> load(strict) -> state_dict ->
    import_generator gives back the same arrays exactly."""
    sd = {k: v.numpy() for k, v in small_gar["pg"].state_dict().items()}
    back = import_generator(sd, small_gar["size"], n_mlp=2, with_map=True)
    _assert_tree_equal(small_gar["params"], back)
    # the carried noise list lands in the noises.* buffers, NHWC -> NCHW
    noise = [np.random.RandomState(i).randn(1, r, r, 1).astype(np.float32)
             for i, r in enumerate([4, 8, 8, 16, 16, 32, 32])]
    sd2 = state_dict_from_jax(small_gar["params"], noise=noise)
    for i, n in enumerate(noise):
        np.testing.assert_array_equal(sd2[f"noises.noise_{i}"].numpy()[0, 0], n[0, ..., 0])
    assert [t.shape for t in noise_from_jax(noise)][0] == (1, 1, 4, 4)


@pytest.mark.parametrize("upsample", [False, True])
def test_modulated_conv_parity(upsample):
    rng = np.random.RandomState(2)
    B, cin, cout, sdim, h = 2, 8, 6, 16, 8
    x = rng.randn(B, h, h, cin).astype(np.float32)
    style = rng.randn(B, sdim).astype(np.float32)
    jm = JModulatedConv2d(cout, 3, sdim, upsample=upsample)
    p = _np_tree(_randomize(jm.init(jax.random.PRNGKey(0), x, style)["params"], 3))
    ref = np.asarray(jm.apply({"params": p}, x, style))
    pm = _load_layer(ModulatedConv2d(cin, cout, 3, sdim, upsample=upsample), p,
                     _sd_modconv(""))
    out = _nhwc(pm(_nchw(x), torch.from_numpy(style)))
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_styled_map_conv_and_to_rgb_parity():
    rng = np.random.RandomState(4)
    B, cin, cout, sdim, h = 2, 8, 6, 16, 8
    x = rng.randn(B, h, h, cin).astype(np.float32)
    style = rng.randn(B, sdim).astype(np.float32)
    smap = rng.randn(B, 2 * h, 2 * h, 2).astype(np.float32)
    noise = rng.randn(B, 2 * h, 2 * h, 1).astype(np.float32)
    jm = JStyledMapConv(cout, 3, sdim, upsample=True)
    p = _np_tree(_randomize(jm.init(jax.random.PRNGKey(0), x, style, smap, noise)["params"], 5))
    ref = np.asarray(jm.apply({"params": p}, x, style, smap, noise))

    def fill(sd, q):
        _sd_modconv("conv.")(sd, q["conv"])
        sd["noise.weight"] = torch.tensor([float(q["noise"]["weight"])])
        sd["activate.bias"] = torch.from_numpy(q["act_bias"].copy())

    pm = _load_layer(StyledMapConv(cin, cout, 3, sdim, upsample=True), p, fill)
    out = _nhwc(pm(_nchw(x), torch.from_numpy(style), _nchw(smap), _nchw(noise)))
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)

    skip = rng.randn(B, h, h, 3).astype(np.float32)
    xr = rng.randn(B, 2 * h, 2 * h, cin).astype(np.float32)
    jr = JToRGB(sdim)
    pr = _np_tree(_randomize(jr.init(jax.random.PRNGKey(1), xr, style, skip)["params"], 6))
    ref = np.asarray(jr.apply({"params": pr}, xr, style, skip))

    def fill_rgb(sd, q):
        _sd_modconv("conv.")(sd, q["conv"])
        sd["bias"] = torch.from_numpy(np.asarray(q["bias"]).reshape(1, 3, 1, 1).copy())

    prgb = _load_layer(ToRGB(cin, sdim), pr, fill_rgb)
    out = _nhwc(prgb(_nchw(xr), torch.from_numpy(style), _nchw(skip)))
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("upsample", [False, True])
def test_styled_conv_parity(upsample):
    rng = np.random.RandomState(9)
    B, cin, cout, sdim, h = 2, 8, 6, 16, 8
    ho = 2 * h if upsample else h
    x = rng.randn(B, h, h, cin).astype(np.float32)
    style = rng.randn(B, sdim).astype(np.float32)
    noise = rng.randn(B, ho, ho, 1).astype(np.float32)
    jm = JStyledConv(cout, 3, sdim, upsample=upsample)
    p = _np_tree(_randomize(jm.init(jax.random.PRNGKey(0), x, style, noise)["params"], 10))
    ref = np.asarray(jm.apply({"params": p}, x, style, noise))

    def fill(sd, q):
        _sd_modconv("conv.")(sd, q["conv"])
        sd["noise.weight"] = torch.tensor([float(q["noise"]["weight"])])
        sd["activate.bias"] = torch.from_numpy(q["act_bias"].copy())

    pm = _load_layer(StyledConv(cin, cout, 3, sdim, upsample=upsample), p, fill)
    out = _nhwc(pm(_nchw(x), torch.from_numpy(style), _nchw(noise)))
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def small_gen():
    """The unconditioned Generator at size 16 (style_dim 32, n_mlp 2,
    channel multiplier 1): the port's weights, perturbed, carried to JAX by
    ``import_generator`` and back by ``generator_state_dict_from_jax``,
    with the JAX package's stored noise in the ``noises.*`` buffers."""
    size, D = 16, 32
    pg = Generator(size, D, 2, channel_multiplier=1, device="cpu", seed=7)
    rng = np.random.RandomState(13)
    sd = {k: v.numpy() + 0.2 * rng.randn(*v.shape).astype(np.float32)
          for k, v in pg.state_dict().items() if "kernel" not in k}
    params = import_generator(sd, size, 2, with_map=False)
    jnoise = [np.asarray(n) for n in j_stored_noise(pg.num_layers)]
    pg.load_state_dict(generator_state_dict_from_jax(params, noise=jnoise), strict=True)
    return dict(pg=pg.eval(), jg=JGenerator(size, D, 2, channel_multiplier=1),
                params=params, size=size, style_dim=D, B=2)


def test_generator_weights_round_trip(small_gen):
    """JAX Generator params -> port state dict -> load(strict) -> state
    dict -> ``import_generator(with_map=False)``: the same arrays exactly;
    the GAR's converter adds only the normal-map blocks."""
    pg = small_gen["pg"]
    sd = {k: v.numpy() for k, v in pg.state_dict().items()}
    back = import_generator(sd, small_gen["size"], n_mlp=2, with_map=False)
    _assert_tree_equal(small_gen["params"], back)
    assert not any(k.startswith(("norm1", "norm_to_style")) for k in sd)
    gar = GeneratorWithMap(small_gen["size"], small_gen["style_dim"], 2, channel_multiplier=1,
                           device="cpu")
    extra = set(gar.state_dict()) - set(sd)
    assert extra and all(k.startswith(("norm1.", "norm_to_style.")) for k in extra)
    assert set(sd) < set(gar.state_dict())


@pytest.mark.parametrize("mode", ["explicit_noise", "stored_noise_mixed_truncated"])
def test_generator_forward_parity(small_gen, mode):
    """The whole Generator forward: same weights and latents, with explicit
    noise or the stored buffers (``randomize_noise=False``), with and
    without truncation and two-style mixing: images to rtol/atol 1e-4."""
    g = small_gen
    jg, pg, B, D = g["jg"], g["pg"], g["B"], g["style_dim"]
    rng = np.random.RandomState(14)
    z1, z2 = (rng.randn(B, D).astype(np.float32) for _ in range(2))
    jparams = {"params": jax.tree_util.tree_map(jnp.asarray, g["params"])}
    if mode == "explicit_noise":
        noise = [rng.randn(B, r, r, 1).astype(np.float32) for r in (4, 8, 8, 16, 16)]
        kw_j = dict(noise=[jnp.asarray(n) for n in noise])
        kw_p = dict(noise=[_nchw(n) for n in noise])
        styles_j, styles_p = [jnp.asarray(z1)], [torch.from_numpy(z1)]
    else:
        tl = rng.randn(1, D).astype(np.float32)
        kw = dict(randomize_noise=False, truncation=0.7, inject_index=3)
        kw_j = dict(kw, truncation_latent=jnp.asarray(tl))
        kw_p = dict(kw, truncation_latent=torch.from_numpy(tl))
        styles_j = [jnp.asarray(z1), jnp.asarray(z2)]
        styles_p = [torch.from_numpy(z1), torch.from_numpy(z2)]
    img_j, lat_j = jg.apply(jparams, styles_j, return_latents=True, **kw_j)
    with torch.no_grad():
        img_p, lat_p = pg(styles_p, return_latents=True, **kw_p)
    np.testing.assert_allclose(lat_p.numpy(), np.asarray(lat_j), rtol=1e-5, atol=1e-5)
    img_p = _nhwc(img_p)
    assert img_p.shape == (B, 16, 16, 3)
    assert np.isfinite(img_p).all() and np.abs(img_p).max() > 1e-3
    np.testing.assert_allclose(img_p, np.asarray(img_j), rtol=1e-4, atol=1e-4)
    mean_w = pg.mean_latent(64, torch.Generator().manual_seed(0))
    assert mean_w.shape == (1, D)


def test_resblock_parity():
    rng = np.random.RandomState(7)
    x = rng.randn(2, 8, 8, 3).astype(np.float32)
    jb = JResBlock(4, downsample=False)
    p = _np_tree(_randomize(jb.init(jax.random.PRNGKey(0), x)["params"], 8))
    ref = np.asarray(jb.apply({"params": p}, x))

    def fill(sd, q):
        for name in ("conv1", "conv2", "skip"):
            sd[f"{name}.0.weight"] = torch.from_numpy(
                np.transpose(q[name]["conv"]["weight"], (3, 2, 0, 1)).copy())
            if "bias" in q[name]["conv"]:
                sd[f"{name}.0.bias"] = torch.from_numpy(q[name]["conv"]["bias"].copy())
            if "act_bias" in q[name]:
                sd[f"{name}.1.bias"] = torch.from_numpy(q[name]["act_bias"].copy())

    pb = _load_layer(ResBlock(3, 4, downsample=False), p, fill)
    np.testing.assert_allclose(_nhwc(pb(_nchw(x))), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", ["single", "mixed_truncated"])
def test_gar_forward_parity(small_gar, mode):
    """The whole GeneratorWithMap forward: same weights, mesh, noise and
    latents; images to rtol/atol 1e-4, normal maps to f32 rounding, and the
    pyramid's winner maps equal."""
    g = small_gar
    jg, pg, B, D = g["jg"], g["pg"], g["B"], g["style_dim"]
    rng = np.random.RandomState(11)
    z1 = rng.randn(B, D).astype(np.float32)
    z2 = rng.randn(B, D).astype(np.float32)
    noise = [rng.randn(B, r, r, 1).astype(np.float32)
             for r in [4, 8, 8, 16, 16, 32, 32]]
    mesh_j = (jnp.asarray(g["vert"]), jnp.asarray(g["norm"]), jnp.asarray(g["tri"]))
    mesh_p = (torch.from_numpy(g["vert"]), torch.from_numpy(g["norm"]),
              torch.from_numpy(g["tri"]).long())
    if mode == "single":
        styles_j, styles_p, kw = [jnp.asarray(z1)], [torch.from_numpy(z1)], {}
    else:
        styles_j = [jnp.asarray(z1), jnp.asarray(z2)]
        styles_p = [torch.from_numpy(z1), torch.from_numpy(z2)]
        tl = rng.randn(1, D).astype(np.float32)
        kw = dict(truncation=0.7, inject_index=3)
        kw_j = dict(kw, truncation_latent=jnp.asarray(tl))
        kw_p = dict(kw, truncation_latent=torch.from_numpy(tl))
    img_j, lat_j, nm_j = jg.apply(
        {"params": jax.tree_util.tree_map(jnp.asarray, g["params"])}, styles_j, mesh_j,
        return_normals=True, return_latents=True,
        noise=[jnp.asarray(n) for n in noise], **(kw_j if kw else {}))
    with torch.no_grad():
        img_p, lat_p, nm_p = pg(styles_p, mesh_p, return_normals=True,
                                return_latents=True,
                                noise=[_nchw(n) for n in noise], **(kw_p if kw else {}))
    np.testing.assert_allclose(lat_p.numpy(), np.asarray(lat_j), rtol=1e-5, atol=1e-5)
    for a, b in zip(nm_p, nm_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6)
    img_p = _nhwc(img_p)
    assert np.isfinite(img_p).all() and np.abs(img_p).max() > 1e-3
    np.testing.assert_allclose(img_p, np.asarray(img_j), rtol=1e-4, atol=1e-4)
    wins_p = rasterize_winners_multi(mesh_p[0], mesh_p[2], 32, 4)
    for k, w in enumerate(wins_p):
        s = 32 >> k
        np.testing.assert_array_equal(
            w.numpy(), np.asarray(j_rasterize_winners(mesh_j[0], mesh_j[2], s, s)),
            err_msg=f"level {s}")


@pytest.mark.parametrize("fused", [True, False])
def test_gar_downsample_forward_parity(small_gar, fused):
    """``pyramid_mode="downsample"`` against the JAX class with the same
    weights (carried by ``state_dict_from_jax`` unchanged), mesh, noise and
    latents: images to rtol/atol 1e-4, normal maps to 1e-6. The fused and
    unfused pyramids are bit-equal."""
    g = small_gar
    B, D, size = g["B"], g["style_dim"], g["size"]
    jg = JGeneratorWithMap(size, D, 2, pyramid_mode="downsample", fused_pyramid=fused)
    pg = GeneratorWithMap(size, D, 2, pyramid_mode="downsample", fused_pyramid=fused,
                          device="cpu")
    pg.load_state_dict(state_dict_from_jax(g["params"]), strict=True)
    rng = np.random.RandomState(12)
    z = rng.randn(B, D).astype(np.float32)
    noise = [rng.randn(B, r, r, 1).astype(np.float32) for r in [4, 8, 8, 16, 16, 32, 32]]
    mesh_j = (jnp.asarray(g["vert"]), jnp.asarray(g["norm"]), jnp.asarray(g["tri"]))
    mesh_p = (torch.from_numpy(g["vert"]), torch.from_numpy(g["norm"]),
              torch.from_numpy(g["tri"]).long())
    img_j, _, nm_j = jg.apply({"params": jax.tree_util.tree_map(jnp.asarray, g["params"])},
                              [jnp.asarray(z)], mesh_j, return_normals=True,
                              noise=[jnp.asarray(n) for n in noise])
    with torch.no_grad():
        img_p, _, nm_p = pg([torch.from_numpy(z)], mesh_p, return_normals=True,
                            noise=[_nchw(n) for n in noise])
    assert [tuple(m.shape) for m in nm_p] == [(B, s, s, 3) for s in (4, 8, 16, 32)]
    for a, b in zip(nm_p, nm_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6)
    img_p = _nhwc(img_p)
    assert np.isfinite(img_p).all() and np.abs(img_p).max() > 1e-3
    np.testing.assert_allclose(img_p, np.asarray(img_j), rtol=1e-4, atol=1e-4)
    other = GeneratorWithMap(size, D, 2, pyramid_mode="downsample", fused_pyramid=not fused,
                             device="cpu")
    for a, b in zip(nm_p, other.normal_pyramid(mesh_p)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    # the downsampled levels differ from rasterizing each level
    each = g["pg"].normal_pyramid(mesh_p)
    assert float((nm_p[1] - each[1]).abs().max()) > 1e-3


def test_stored_noise_buffers_drive_forward(small_gar):
    """randomize_noise=False reads the noises.* buffers, so two calls agree
    and differ from a call with fresh noise."""
    g, pg = small_gar, small_gar["pg"]
    z = torch.from_numpy(np.random.RandomState(3).randn(2, 64).astype(np.float32))
    mesh = (torch.from_numpy(g["vert"]), torch.from_numpy(g["norm"]),
            torch.from_numpy(g["tri"]).long())
    with torch.no_grad():
        a = pg([z], mesh, randomize_noise=False)[0]
        b = pg([z], mesh, randomize_noise=False)[0]
        c = pg([z], mesh, generator=torch.Generator().manual_seed(0))[0]
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert (a - c).abs().max() > 0


def test_fused_and_gather_pyramid_agree(small_gar):
    """``fused_pyramid=False`` (winners from the kernel's winners-only mode,
    values from the gather interpolation) renders the same normal maps and
    image as the fused pyramid."""
    g = small_gar
    pg2 = GeneratorWithMap(g["size"], g["style_dim"], 2, fused_pyramid=False, device="cpu")
    pg2.load_state_dict(g["pg"].state_dict(), strict=True)
    z = torch.from_numpy(np.random.RandomState(5).randn(2, 64).astype(np.float32))
    mesh = (torch.from_numpy(g["vert"]), torch.from_numpy(g["norm"]),
            torch.from_numpy(g["tri"]).long())
    with torch.no_grad():
        a = g["pg"]([z], mesh, randomize_noise=False, return_normals=True)
        b = pg2([z], mesh, randomize_noise=False, return_normals=True)
    for ma, mb in zip(a[2], b[2]):
        torch.testing.assert_close(ma, mb, rtol=0, atol=0)
    torch.testing.assert_close(a[0], b[0], rtol=0, atol=0)


def test_cli_generate_writes_png(tmp_path):
    from stylerenderer_tpu_torch.cli.generate import main

    paths = main(["--with_map", "--size", "16", "--sample", "2", "--pics", "1",
                  "--device", "cpu", "--save_normals", "--truncation", "0.7",
                  "--truncation_mean", "16", "--out", str(tmp_path)])
    assert len(paths) == 1
    with open(paths[0], "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    assert (tmp_path / "000000_norm.png").exists()


def test_cli_generate_without_map_writes_png(tmp_path, monkeypatch):
    """``cli.generate`` without ``--with_map`` renders the unconditioned
    Generator, truncation included, and launches no rasterizer."""
    import stylerenderer_tpu_torch.models.generator as generator_mod
    from stylerenderer_tpu_torch.cli.generate import main

    monkeypatch.setattr(generator_mod, "rasterize_pyramid_fused", None)
    paths = main(["--size", "16", "--latent", "32", "--n_mlp", "2", "--channel_multiplier",
                  "1", "--sample", "4", "--pics", "2", "--device", "cpu", "--truncation",
                  "0.7", "--truncation_mean", "16", "--out", str(tmp_path)])
    assert [os.path.basename(p) for p in paths] == ["000000.png", "000001.png"]
    for p in paths:
        with open(p, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    assert sorted(os.listdir(tmp_path)) == ["000000.png", "000001.png"]


def test_entry_points_refuse_missing_card(monkeypatch):
    from stylerenderer_tpu_torch.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        GeneratorWithMap(8, 16, 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        Generator(8, 16, 1)
    assert resolve_device("cpu").type == "cpu"


def _port_modules():
    """Every module of the port's package tree (directories without an
    ``__init__.py``, such as the kernel build directory, are not part of it)."""
    pkg = os.path.join(REPO, "stylerenderer_tpu_torch")
    mods = []
    for root, dirs, files in os.walk(pkg):
        dirs[:] = [d for d in dirs if os.path.exists(os.path.join(root, d, "__init__.py"))]
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, f), REPO)[:-3]
                mod = rel.replace(os.sep, ".")
                mods.append(mod[:-len(".__init__")] if mod.endswith(".__init__") else mod)
    return sorted(mods)


def test_port_imports_without_jax():
    """Every port module imports with ``jax`` unimportable, and no source
    line imports the JAX package."""
    mods = _port_modules()
    assert len(mods) >= 60
    assert {"stylerenderer_tpu_torch.ops.rasterize_single", "stylerenderer_tpu_torch.ops.resize",
            "stylerenderer_tpu_torch.data.srpack", "stylerenderer_tpu_torch.data.synth",
            "stylerenderer_tpu_torch.face3d.alignment"} <= set(mods)
    assert {f"stylerenderer_tpu_torch.{m}" for m in (
        "utils.config", "models.discriminator", "train.losses", "train.state", "train.step",
        "face3d.augment", "utils.guards", "data.dataset", "utils.checkpoint",
        "utils.logging", "cli.train", "inversion", "inversion.project",
        "cli.project", "eval", "eval.inception", "eval.lpips", "eval.fid", "eval.ppl",
        "eval.lpips_harness", "cli.fid", "cli.ppl", "cli.calc_inception", "nn.spectral",
        "models.regressor", "train.regressor", "supervisors", "supervisors.face_normals",
        "supervisors.landmark", "supervisors.recognition", "supervisors.hub",
        "supervisors.convert", "face3d.alignment", "face3d.io", "face3d.morphable",
        "face3d.transforms", "data.prepare", "data.dataset", "cli.align",
        "cli.prepare_data", "parallel", "parallel.mesh")} <= set(mods)
    code = ("import sys; sys.modules['jax'] = None; import importlib\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "assert not any(k == 'stylerenderer_tpu' or k.startswith('stylerenderer_tpu.')"
            " for k in sys.modules)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    import re

    pat = re.compile(r"^\s*(from|import)\s+(jax|flax|stylerenderer_tpu)(\.|\s|$)")
    for mod in mods:
        path = os.path.join(REPO, *mod.split(".")) + ".py"
        if not os.path.exists(path):
            path = os.path.join(REPO, *mod.split("."), "__init__.py")
        with open(path) as f:
            for n, line in enumerate(f, 1):
                assert not pat.match(line), f"{path}:{n}: {line.strip()}"

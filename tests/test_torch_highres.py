"""The 1024 px slice of the port against the JAX package, at small sizes:

- K1's plain version and its host build (g++) at top 512 (8 levels) and
  top 1024 (9 levels) with 32 px tiles, the shapes of the 1024 px GAR's
  fused pyramid: winners equal to the JAX dense oracle at every level,
  the host build's winners and values bit-equal to the plain version
  (whose values are the port's dense interpolation ``_interp_from_win``);
- ``remat`` (``torch.utils.checkpoint`` around each styled conv) in both
  generators at size 16, the sizes of ``tests/test_remat.py``: the same
  images and gradients as without it (outputs rtol 1e-5, atol 1e-6;
  gradients rtol 1e-4), including a path-length step through
  ``train_step`` and a forward with ``noise=None`` under a fixed
  ``torch.Generator``, and the JAX ``remat=True`` models' images;
- ``n_stylemap`` 1 and 4 against JAX ``GeneratorWithMap(16, n_stylemap=...)``
  through ``state_dict_from_jax``, and the weights' round trip;
- the profiler trace's start and stop, and ``trace_ctx``'s spans nest.

JAX parameters come from ``jax.eval_shape`` of the init, filled with
seeded numpy values; each JAX model is applied jitted, once."""

import json

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from stylerenderer_tpu.face3d import mesh_point_normal as j_mesh_point_normal
from stylerenderer_tpu.face3d import synthetic_face as j_synthetic_face
from stylerenderer_tpu.models.generator import (
    Generator as JGenerator,
    GeneratorWithMap as JGeneratorWithMap,
)
from stylerenderer_tpu.ops.rasterize import rasterize_winners as j_rasterize_winners
from stylerenderer_tpu.utils.torch_import import _conv_layer as j_conv_layer
from stylerenderer_tpu.utils.torch_import import import_generator

import stylerenderer_tpu_torch.train.step as step_mod
from stylerenderer_tpu_torch.face3d import synthetic_face
from stylerenderer_tpu_torch.models import Generator, GeneratorWithMap
from stylerenderer_tpu_torch.ops.rasterize import default_tile
from stylerenderer_tpu_torch.ops.rasterize_multi import (
    rasterize_winners_multi_host,
    rasterize_winners_multi_ref,
)
from stylerenderer_tpu_torch.train import init_train_state, sample_draws, train_step
from stylerenderer_tpu_torch.utils.config import TrainConfig
from stylerenderer_tpu_torch.utils.logging import (
    start_profiler_trace, stop_profiler_trace, trace_ctx,
)
from stylerenderer_tpu_torch.utils.weights import (
    generator_state_dict_from_jax, noise_from_jax, state_dict_from_jax,
)
from torch_threads import _one_thread  # noqa: F401

SIZE, STYLE, N_MLP, CM, B = 16, 32, 2, 1, 2  # tests/test_remat.py's model
NOISE_RES = (4, 8, 8, 16, 16)


def _nhwc(t):
    return np.transpose(t.detach().numpy(), (0, 2, 3, 1))


# ---- K1 at the 1024 px GAR's shapes --------------------------------------

def mesh_highres(seed=0):
    """22 triangles of a 1024 px image (each with its own vertices and a
    random depth; B=1): 8 of 1-24 px anywhere (most inside one 32 px
    tile, half facing away), 6 of 2-6 px around the pixel centers of the
    three sparse levels (16, 8 and 4 px at top 1024: pixels of 64, 128
    and 256 px), 4 of 30-120 px (two-tile and larger tiers), 2 that
    reach past the image (XL), a segment across it and a point."""
    top = 1024
    rng = np.random.RandomState(seed)
    parts = []
    c = rng.uniform(0, top, (8, 1, 2))
    parts.append(c + rng.uniform(-1, 1, (8, 3, 2)) * rng.uniform(1, 24, (8, 1, 1)) / 2)
    for k in (6, 7, 8):
        s = 1 << k  # a level-k pixel's edge in top pixels
        j = rng.randint(0, top // s, (2, 1, 2))
        centre = (j + 0.5) * s - 0.5
        parts.append(centre + rng.uniform(-3, 3, (2, 3, 2)))
    for n, lo, hi in ((4, 30, 120), (2, 600, 1600)):
        c = rng.uniform(0, top, (n, 1, 2))
        parts.append(c + rng.uniform(-1, 1, (n, 3, 2)) * rng.uniform(lo, hi, (n, 1, 1)) / 2)
    a, b = rng.uniform(0, top, (2, 1, 1, 2))
    parts.append(np.concatenate([a, b, b], 1))  # a segment: det 0
    p = np.round(rng.uniform(0, top, (1, 1, 2)))
    parts.append(np.repeat(p, 3, 1))  # a point on a pixel center
    m = np.concatenate(parts, 0)  # [nf, 3, 2]
    d1, d2 = m[:, 1] - m[:, 0], m[:, 2] - m[:, 0]
    back = d1[:, 0] * d2[:, 1] - d1[:, 1] * d2[:, 0] > 0
    back[:4] = ~back[:4]  # four of the small ones face away
    m[back] = m[back][:, ::-1]
    nf = m.shape[0]
    x = (m[..., 0] + 0.5) * 2.0 / top - 1.0
    y = 1.0 - (m[..., 1] + 0.5) * 2.0 / top
    z = np.repeat(rng.randn(nf, 1), 3, -1)
    v = np.stack([x, y, z], -1).reshape(1, 3 * nf, 3).astype(np.float32)
    return v, np.arange(3 * nf, dtype=np.int32).reshape(nf, 3)


def _eager_winners(v, tri, s, pixels):
    """The JAX dense oracle's candidate math run eagerly (op by op) at the
    ``(y, x)`` ``pixels`` of an ``s`` px image (B=1): the max depth among
    covering triangles, the lowest id on ties, -1 where none covers."""
    from stylerenderer_tpu.ops.rasterize import _eval_candidate, _project_verts

    pts = jnp.asarray(v[0][tri])[:, None]  # [nf, 1, 3, 3]
    px, py, z, ok = _project_verts(pts, s, s, False, 1e-6)
    X = jnp.asarray(pixels[:, 1], jnp.float32)[None, :]
    Y = jnp.asarray(pixels[:, 0], jnp.float32)[None, :]
    _, depth, cov = _eval_candidate(px, py, z, ok, X, Y, s, s, False, 1e-6)
    depth = np.where(np.asarray(cov), np.asarray(depth), -np.inf)  # [nf, npix]
    best = depth.max(0)
    win = np.where(depth == best, np.arange(len(tri))[:, None], len(tri)).min(0)
    return np.where(np.isfinite(best), win, -1)


@pytest.mark.parametrize("top,n_levels", [(512, 8), (1024, 9)])
def test_k1_tile32_matches_jax_dense(top, n_levels):
    """K1's plain version (what ``rasterize_winners_multi`` runs on the CPU)
    at the 1024 px GAR's tile: winners equal to the JAX dense oracle at
    every level, sparse levels included; its host build (the card's
    binning, per-tile schedule and candidate math) bit-equal to it in
    winners and values at every level.

    The JAX oracle's ``lax.scan`` is compiled, and XLA contracts its
    multiply-adds; at 1024 px a sliver's edge functions cancel terms of
    ~1e5 down to below their f32 rounding, so compiled and eager JAX can
    disagree on its coverage (``ROADMAP.md``: compare against eager JAX).
    At the few pixels where the compiled oracle differs from the port
    (at most 2 a level), the oracle's candidate math run eagerly gives the
    port's winner."""
    assert default_tile(top) == 32
    v, tri = mesh_highres()
    attrs = np.random.RandomState(1).randn(*v.shape).astype(np.float32)
    tv, ttri, ta = torch.from_numpy(v), torch.from_numpy(tri), torch.from_numpy(attrs)
    ref = rasterize_winners_multi_ref(tv, ttri, top, n_levels, attrs=ta, tile=32)
    host = rasterize_winners_multi_host(tv, ttri, top, n_levels, attrs=ta, tile=32)
    for k, ((rv, rw), (hv, hw)) in enumerate(zip(ref, host)):
        s = top >> k
        rw_np = rw.numpy()
        jw = np.asarray(j_rasterize_winners(jnp.asarray(v), jnp.asarray(tri), s, s))
        diff = np.argwhere(rw_np != jw)[:, 1:]
        assert len(diff) <= 2, f"{s} px: {len(diff)} winners differ from the JAX oracle"
        if len(diff):
            np.testing.assert_array_equal(rw_np[0][tuple(diff.T)],
                                          _eager_winners(v, tri, s, diff), err_msg=f"{s} px")
        assert len(np.unique(jw[jw >= 0])) >= (2 if s >= 8 else 1), f"{s} px: too few winners"
        np.testing.assert_array_equal(hw.numpy(), rw_np, err_msg=f"{s} px")
        np.testing.assert_array_equal(hv.numpy(), rv.numpy(), err_msg=f"{s} px")


# ---- remat -----------------------------------------------------------------

def _jax_params(model, *args):
    """Seeded numpy values of the shapes ``model.init`` would give."""
    shapes = jax.eval_shape(model.init, {"params": jax.random.PRNGKey(0),
                                         "noise": jax.random.PRNGKey(1)}, *args)["params"]
    rng = np.random.RandomState(3)
    return jax.tree_util.tree_map(
        lambda s: np.asarray(rng.randn(*s.shape), np.float32) * 0.5, shapes)


@pytest.fixture(scope="module")
def mesh16():
    face, tri = j_synthetic_face(12, 24, 4, 2)
    rng = np.random.RandomState(0)
    x = rng.randn(B, 6).astype(np.float32) * np.asarray(face.sigma)
    vert = np.asarray(face(jnp.asarray(x)))
    norm = np.asarray(j_mesh_point_normal(jnp.asarray(vert), tri))
    tri = np.asarray(tri)
    z = rng.randn(B, STYLE).astype(np.float32)
    noise = [rng.randn(B, r, r, 1).astype(np.float32) for r in NOISE_RES]
    return dict(vert=vert, norm=norm, tri=tri, z=z, noise=noise,
                mesh_j=tuple(jnp.asarray(a) for a in (vert, norm, tri)),
                mesh_p=(torch.from_numpy(vert), torch.from_numpy(norm),
                        torch.from_numpy(tri).long()))


def _assert_grads_close(a, b, rtol=1e-4):
    for i, (x, y) in enumerate(zip(a, b)):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=rtol,
                                   atol=rtol * float(y.abs().max()) + 1e-12,
                                   err_msg=f"parameter {i}")


@pytest.mark.parametrize("with_map", [True, False])
def test_remat_matches_plain_and_jax(mesh16, with_map):
    """``remat=True`` against ``remat=False`` on the same weights (the JAX
    ``remat=True`` model's, perturbed noise strengths included): the image
    with explicit noise (rtol 1e-5, atol 1e-6); with ``noise=None`` under
    one ``torch.Generator`` seed, the same images, the parameter gradients
    of ``mean(img^2)`` (rtol 1e-4) and the generator left at the same place
    in its stream. The JAX ``remat=True``
    model's image to rtol/atol 1e-4 (XLA sums convolutions in another
    order), as the GAR parity tests hold it."""
    m = mesh16
    jcls, pcls = (JGeneratorWithMap, GeneratorWithMap) if with_map else (JGenerator, Generator)
    jg = jcls(SIZE, STYLE, N_MLP, channel_multiplier=CM, remat=True)
    z_j = [jnp.asarray(m["z"])]
    extra_j = (m["mesh_j"],) if with_map else ()
    params = _jax_params(jg, z_j, *extra_j)
    noise_j = [jnp.asarray(n) for n in m["noise"]]
    img_j = jax.jit(lambda p: jg.apply({"params": p}, z_j, *extra_j, noise=noise_j)[0])(params)

    to_sd = state_dict_from_jax if with_map else generator_state_dict_from_jax
    gens = []
    for remat in (False, True):
        g = pcls(SIZE, STYLE, N_MLP, channel_multiplier=CM, remat=remat, device="cpu")
        g.load_state_dict(to_sd(params), strict=True)
        gens.append(g)
    z = [torch.from_numpy(m["z"])]
    extra = (m["mesh_p"],) if with_map else ()
    noise = noise_from_jax(m["noise"])

    def image(g, **kw):
        return g(z, *extra, **kw)[0]

    with torch.no_grad():
        imgs = [image(g, noise=noise) for g in gens]
    np.testing.assert_allclose(imgs[1].numpy(), imgs[0].numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_nhwc(imgs[1]), np.asarray(img_j), rtol=1e-4, atol=1e-4)

    # fresh noise from a caller's generator: the noise strengths are not 0
    # (perturbed weights), so noise drawn again in a recompute would show
    assert all(float(mod.weight.abs()) > 0 for mod in gens[1].modules()
               if type(mod).__name__ == "NoiseInjection")
    res = []
    for g in gens:
        rng = torch.Generator().manual_seed(11)
        img = image(g, generator=rng)
        res.append((img, torch.autograd.grad(img.square().mean(), list(g.parameters()),
                                             allow_unused=True, materialize_grads=True),
                    torch.randn(4, generator=rng)))
    np.testing.assert_allclose(res[1][0].detach().numpy(), res[0][0].detach().numpy(),
                               rtol=1e-5, atol=1e-6)
    _assert_grads_close(res[1][1], res[0][1])
    np.testing.assert_array_equal(res[1][2].numpy(), res[0][2].numpy())
    assert not torch.allclose(res[0][0].detach(), imgs[0])  # the drawn noise mattered


def test_remat_path_length_step(monkeypatch):
    """One ``train_step`` with the path-length term (the double backward
    through every checkpointed conv and ``_UpFirDn2d``'s own adjoint), G in
    ``remat`` against G without it, from the same state and draws: every
    Adam update's gradients to rtol 1e-4, the same metrics."""
    cfg = TrainConfig(size=SIZE, latent=STYLE, n_mlp=N_MLP, channel_multiplier=CM, batch=B,
                      d_reg_every=4, g_reg_every=2, path_batch_shrink=2)
    face, tri = synthetic_face(12, 24, 4, 2, device="cpu")
    adam = step_mod._adam_step
    updates = []

    def record(opt, params, grads):
        updates[-1].append([g.clone() for g in grads])
        adam(opt, params, grads)

    monkeypatch.setattr(step_mod, "_adam_step", record)
    runs = []
    for remat in (False, True):
        st = init_train_state(cfg, "cpu", seed=5)
        st.g.remat = st.g_ema.remat = remat
        st.step = 2  # the path term's step, not R1's
        with torch.no_grad():  # noise strengths away from 0
            for mod in st.g.modules():
                if type(mod).__name__ == "NoiseInjection":
                    mod.weight.fill_(0.3)
        real = torch.rand(B, 3, SIZE, SIZE, generator=torch.Generator().manual_seed(2)) * 2 - 1
        draws = sample_draws(torch.Generator().manual_seed(3), cfg, face, B, st.g.n_latent)
        updates.append([])
        runs.append(train_step(st, real, draws, cfg, face, tri))
    (up0, up1), (m0, m1) = updates, runs
    assert len(up0) == len(up1) == 3  # D, G, path
    assert float(m0["path"]) > 0
    for a, b in zip(up1, up0):
        _assert_grads_close(a, b)
    for k in ("d", "g", "path", "path_length"):
        np.testing.assert_allclose(float(m1[k]), float(m0[k]), rtol=1e-5)



# ---- n_stylemap ---------------------------------------------------------------

@pytest.mark.parametrize("n_stylemap", [1, 4])
def test_n_stylemap_matches_jax(mesh16, n_stylemap):
    """``GeneratorWithMap(n_stylemap=...)`` with ``norm1_pre`` and
    ``norm_to_style_pre.{i}``: JAX params -> ``state_dict_from_jax`` ->
    ``load_state_dict(strict=True)``; the state dict carried back
    (``import_generator`` and the JAX package's ``ConvLayer`` reader) gives
    the same arrays; the image with explicit noise to rtol/atol 1e-4, as
    ``test_gar_forward_parity``, and the normal maps to 1e-4 (the JAX model
    is jitted: compiled and eager JAX differ by up to 3.1e-5 on sliver
    pixels, ``ROADMAP.md``)."""
    m = mesh16
    jg = JGeneratorWithMap(SIZE, STYLE, N_MLP, n_stylemap=n_stylemap, channel_multiplier=CM)
    z_j = [jnp.asarray(m["z"])]
    params = _jax_params(jg, z_j, m["mesh_j"])
    pg = GeneratorWithMap(SIZE, STYLE, N_MLP, n_stylemap=n_stylemap, channel_multiplier=CM,
                          device="cpu")
    pg.load_state_dict(state_dict_from_jax(params), strict=True)
    assert pg.norm1_pre[0].weight.shape == (n_stylemap, 3, 3, 3)
    assert pg.norm_to_style[0].conv1[0].weight.shape[1] == n_stylemap

    sd = {k: v.numpy() for k, v in pg.state_dict().items()}
    back = import_generator(sd, SIZE, n_mlp=N_MLP, with_map=True)
    back["norm1_pre"] = j_conv_layer(sd, "norm1_pre", False)
    for i in range(len(pg.to_rgbs)):
        back[f"norm_to_style_pre_{i}"] = j_conv_layer(sd, f"norm_to_style_pre.{i}", False)
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    back_flat = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat) == len(back_flat)
    for path, leaf in flat:
        np.testing.assert_array_equal(np.asarray(back_flat[path]), leaf, err_msg=str(path))

    noise_j = [jnp.asarray(n) for n in m["noise"]]
    img_j, _, nm_j = jax.jit(lambda p: jg.apply({"params": p}, z_j, m["mesh_j"], noise=noise_j,
                                                return_normals=True))(params)
    with torch.no_grad():
        img_p, _, nm_p = pg([torch.from_numpy(m["z"])], m["mesh_p"],
                            noise=noise_from_jax(m["noise"]), return_normals=True)
    for a, b in zip(nm_p, nm_j):  # compiled JAX: ROADMAP's 3.1e-5 on slivers
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-4)
    img_p = _nhwc(img_p)
    assert np.isfinite(img_p).all() and np.abs(img_p).max() > 1e-3
    np.testing.assert_allclose(img_p, np.asarray(img_j), rtol=1e-4, atol=1e-4)


def test_n_stylemap_3_keeps_the_names():
    """The default builds no ``*_pre`` layer: the state dict is the one a
    reference checkpoint and every earlier slice use."""
    names = set(GeneratorWithMap(SIZE, STYLE, N_MLP, channel_multiplier=CM,
                                 device="cpu").state_dict())
    assert not any("_pre" in n for n in names)
    assert {"norm1.conv1.0.weight", "norm_to_style.1.skip.0.weight"} <= names


# ---- the profiler window -----------------------------------------------------

def test_profiler_trace_spans_nest(tmp_path):
    """``start_profiler_trace``/``stop_profiler_trace`` write one Chrome
    trace; spans of ``trace_ctx`` nest in it; a second start, and a stop
    with no trace running, are refused. (``cli.train --profile_steps``
    writes its window through them: ``test_torch_supervisors.py``.)"""
    start_profiler_trace(str(tmp_path / "nest"))
    with pytest.raises(RuntimeError, match="already running"):
        start_profiler_trace(str(tmp_path / "other"))
    with trace_ctx("outer"):
        with trace_ctx("inner"):
            torch.ones(8).sum()
    path = stop_profiler_trace()
    with pytest.raises(RuntimeError, match="no profiler trace"):
        stop_profiler_trace()
    assert path == str(tmp_path / "nest" / "trace.json")
    with open(path) as f:
        spans = {e["name"]: e for e in json.load(f)["traceEvents"]
                 if e.get("name") in ("outer", "inner")}
    outer, inner = spans["outer"], spans["inner"]
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]

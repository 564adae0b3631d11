"""The port's spatial sharding on the CPU (``parallel/mesh.py::
make_mesh_2d``, ``parallel/spatial.py``, the banded layers, K1 by band)
against the port in one process and against the JAX package, at the sizes
of ``tests/test_spatial_sharding.py``: ``Discriminator(32,
channel_multiplier=1)`` on ``[4, 3, 32, 32]`` and ``GeneratorWithMap(16,
32, 2, channel_multiplier=1)`` on ``synthetic_face(6, 12, 4, 2)``, B=4,
with given noise maps.

Four gloo ranks are spawned once for the module (``torch_parallel.Ranks``,
scenario ``"spatial"``) and lay the one world out twice, 2 x 2 and 1 x 4
(``split_mesh``); each test checks one thing of their results. JAX
parameters come from ``jax.eval_shape`` of the init, filled with seeded
numpy values, and are carried to the port by ``utils/weights.py``; the
inputs are seeded numpy arrays; the JAX models are applied jitted, on one
device. Tolerances: the image bands and logits to ``rtol=1e-4,
atol=1e-5`` against both (JAX's own for the same comparison); the
gradients against one port process to 1e-5 of each tensor's largest
magnitude. The losses weight the logits and the image with positive
weights: with signed ones the rows' contributions cancel in D's first
blocks, and one process's float32 gradients there are already 2e-5 off
float64 (1.7e-6 with these). K1's plain version and host build by band
are bit-equal to the whole image's result cut to the band."""

import shutil

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from stylerenderer_tpu.face3d import mesh_point_normal as j_mesh_point_normal
from stylerenderer_tpu.face3d import synthetic_face as j_synthetic_face
from stylerenderer_tpu.models import Discriminator as JDiscriminator
from stylerenderer_tpu.models import GeneratorWithMap as JGeneratorWithMap

from stylerenderer_tpu_torch.models import Discriminator, GeneratorWithMap
from stylerenderer_tpu_torch.ops.rasterize import default_tile
from stylerenderer_tpu_torch.ops.rasterize_multi import (
    bin_multi_host,
    build_bins_multi,
    rasterize_winners_multi,
    rasterize_winners_multi_host,
    rasterize_winners_multi_ref,
    space_band,
)
from stylerenderer_tpu_torch.parallel import Mesh, make_mesh_2d, split_mesh
from stylerenderer_tpu_torch.parallel.spatial import band_rows
from stylerenderer_tpu_torch.utils.weights import (
    discriminator_state_dict_from_jax,
    state_dict_from_jax,
)
from torch_meshes import BAND_CASES, kernel_case, keys_of_bins
from torch_parallel import Ranks
from torch_threads import _one_thread  # noqa: F401

B, D_SIZE, G_SIZE, STYLE, N_MLP, CM = 4, 32, 16, 32, 2, 1
NOISE_RES = (4, 8, 8, 16, 16)
LAYOUTS = ((2, 2), (1, 4))
WORLD = 4


def _jax_params(model, seed, *args):
    """Seeded numpy values (N(0, 0.5^2)) of the shapes ``model.init``
    would give."""
    shapes = jax.eval_shape(model.init, {"params": jax.random.PRNGKey(0),
                                         "noise": jax.random.PRNGKey(1)}, *args)["params"]
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda s: np.asarray(rng.randn(*s.shape), np.float32) * 0.5, shapes)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(np.asarray(x), (0, 3, 1, 2))))


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The inputs, both packages' models on the same weights, and the
    ranks (started first, so that they run while JAX compiles). The ranks'
    files (~1 GB: every gradient of both layouts) are removed once
    read."""
    rng = np.random.RandomState(0)
    jface, jtri = j_synthetic_face(6, 12, 4, 2)
    xf = rng.randn(B, 6).astype(np.float32) * np.asarray(jface.sigma)
    vert = np.asarray(jface(jnp.asarray(xf)))
    norm = np.asarray(j_mesh_point_normal(jnp.asarray(vert), jtri))
    tri = np.asarray(jtri)
    z = rng.randn(B, STYLE).astype(np.float32)
    noise = [rng.randn(1, r, r, 1).astype(np.float32) for r in NOISE_RES]
    x = rng.randn(B, D_SIZE, D_SIZE, 3).astype(np.float32)
    x_w = (0.5 + rng.rand(B)).astype(np.float32)
    img_w = (0.5 + rng.rand(B, 3, G_SIZE, G_SIZE)).astype(np.float32)
    mesh_j = (jnp.asarray(vert), jnp.asarray(norm), jnp.asarray(tri))

    jd = JDiscriminator(D_SIZE, channel_multiplier=CM)
    jg = JGeneratorWithMap(G_SIZE, STYLE, N_MLP, channel_multiplier=CM)
    dp = _jax_params(jd, 1, jnp.asarray(x))
    gp = _jax_params(jg, 2, [jnp.asarray(z)], mesh_j)
    d_state = discriminator_state_dict_from_jax(dp, D_SIZE)
    g_state = state_dict_from_jax(gp)
    t = {k: torch.from_numpy(v) for k, v in dict(z=z, vert=vert, norm=norm, x_w=x_w,
                                                  img_w=img_w).items()}
    t.update(x=_nchw(x), tri=torch.from_numpy(tri).long(), noise=[_nchw(n) for n in noise])
    spec = dict(device="cpu", run=["spatial"], spatial=dict(
        t, d=((D_SIZE,), dict(channel_multiplier=CM)), d_state=d_state,
        g=((G_SIZE, STYLE, N_MLP), dict(channel_multiplier=CM)), g_state=g_state,
        layouts=LAYOUTS))
    out_dir = tmp_path_factory.mktemp("spatial_ranks")
    ranks = Ranks(WORLD, spec, str(out_dir), timeout=400)
    try:
        logits_j = jax.jit(lambda p, img: jd.apply({"params": p}, img))(dp, jnp.asarray(x))
        noise_j = [jnp.asarray(n) for n in noise]
        img_j = jax.jit(lambda p: jg.apply({"params": p}, [jnp.asarray(z)], mesh_j,
                                           noise=noise_j)[0])(gp)

        # the port in one process on the global batch
        d = Discriminator(D_SIZE, channel_multiplier=CM, device="cpu")
        d.load_state_dict(d_state, strict=True)
        g = GeneratorWithMap(G_SIZE, STYLE, N_MLP, channel_multiplier=CM, device="cpu")
        g.load_state_dict(g_state, strict=True)
        xx = t["x"].clone().requires_grad_(True)
        logits = d(xx)
        dg = torch.autograd.grad((logits[:, 0] * t["x_w"]).sum(), [xx] + list(d.parameters()))
        vv = t["vert"].clone().requires_grad_(True)
        nn_ = t["norm"].clone().requires_grad_(True)
        img = g([t["z"]], (vv, nn_, t["tri"]), noise=t["noise"])[0]
        gg = torch.autograd.grad((img * t["img_w"]).sum(), [vv, nn_] + list(g.parameters()))
        results = ranks.wait()
    finally:
        ranks.kill()
        shutil.rmtree(out_dir, ignore_errors=True)
    return dict(results=results, logits_j=np.asarray(logits_j),
                img_j=np.transpose(np.asarray(img_j), (0, 3, 1, 2)),
                logits=logits.detach(), d_x_grad=dg[0], d_grads=dg[1:],
                d_names=[n for n, _ in d.named_parameters()], image=img.detach(),
                vert_grad=gg[0], norm_grad=gg[1], g_grads=gg[2:],
                g_names=[n for n, _ in g.named_parameters()])


def _each_rank(case, layout):
    key = f"{layout[0]}x{layout[1]}"
    return [r["spatial"][key] for r in case["results"]]


def _close(port, ref, rel, what):
    err = float((port - ref).abs().max())
    scale = float(ref.abs().max())
    assert err <= rel * max(scale, 1e-30), f"{what}: max err {err:.3e}, scale {scale:.3e}"


@pytest.mark.parametrize("layout", LAYOUTS)
def test_mesh_2d_layout_and_image_sharding(case, layout):
    """JAX's ``reshape(n_data, n_space)``: rank ``r`` has data index
    ``r // n_space`` and space index ``r % n_space``; its data group is its
    column, its space group its row; ``is_main`` is global rank 0;
    ``image_sharding`` gives its rows of the batch and its band of the
    image."""
    nd, ns = layout
    for r, res in enumerate(_each_rank(case, layout)):
        d, s = r // ns, r % ns
        assert (res["n_data"], res["n_space"]) == layout
        assert (res["data_index"], res["space_index"]) == (d, s)
        assert res["is_main"] == (r == 0)
        assert res["data_ranks"] == [i * ns + s for i in range(nd)]
        assert res["space_ranks"] == [d * ns + i for i in range(ns)]
        n, h = B // nd, D_SIZE // ns
        assert res["rows"] == slice(d * n, (d + 1) * n)
        assert res["band"] == slice(s * h, (s + 1) * h)
        assert res["gband"] == slice(s * G_SIZE // ns, (s + 1) * G_SIZE // ns)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_discriminator_logits_match_one_process_and_jax(case, layout):
    """Each rank's logits (of its rows, replicated over ``'space'``) equal
    those rows of one port process's and of JAX's."""
    for r, res in enumerate(_each_rank(case, layout)):
        rows = res["rows"]
        np.testing.assert_allclose(res["logits"].numpy(), case["logits"][rows].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=f"rank {r}")
        np.testing.assert_allclose(res["logits"].numpy(), case["logits_j"][rows],
                                   rtol=1e-4, atol=1e-5, err_msg=f"rank {r} vs JAX")


@pytest.mark.parametrize("layout", LAYOUTS)
def test_discriminator_gradients_match_one_process(case, layout):
    """The gradient in each rank's block (R1's gradient) is that block of
    one process's; every parameter's gradient reduced by
    ``average_gradients`` (a sum over ``'space'``, a mean over
    ``'data'``) is one process's over ``n_data``."""
    for r, res in enumerate(_each_rank(case, layout)):
        rows, band = res["rows"], res["band"]
        _close(res["d_x_grad"], case["d_x_grad"][rows][:, :, band], 1e-5, f"rank {r} x")
        for name, a, b in zip(case["d_names"], res["d_grads"], case["d_grads"]):
            _close(a, b / res["n_data"], 1e-5, f"rank {r} {name}")


@pytest.mark.parametrize("layout", LAYOUTS)
def test_no_gradient_n_space_times_too_large(case, layout):
    """The usual fault of the adjoint convention is a gradient ``n_space``
    times too large (a whole gradient summed over ``'space'``): every
    reduced parameter gradient of D (``final_linear``'s, from replicated
    compute, among them) and of the GAR (the mapping network's, upstream
    of the band), and the vertex and normal gradients, have one process's
    norm to 1e-4."""
    nd = layout[0]
    for r, res in enumerate(_each_rank(case, layout)):
        pairs = ([(f"D {n}", a, b / nd) for n, a, b in
                  zip(case["d_names"], res["d_grads"], case["d_grads"])]
                 + [(f"G {n}", a, b / nd) for n, a, b in
                    zip(case["g_names"], res["g_grads"], case["g_grads"])]
                 + [("vert", res["vert_grad"], case["vert_grad"][res["rows"]]),
                    ("norm", res["norm_grad"], case["norm_grad"][res["rows"]])])
        assert any(n.startswith("D final_linear") for n, _, _ in pairs)
        assert any(n.startswith("G style.") for n, _, _ in pairs)
        for name, a, b in pairs:
            ref = float(b.norm())
            if ref > 0:
                ratio = float(a.norm()) / ref
                assert abs(ratio - 1) < 1e-4, f"rank {r} {name}: norm ratio {ratio}"


@pytest.mark.parametrize("layout", LAYOUTS)
def test_gar_image_band_matches_one_process_and_jax(case, layout):
    """Each rank's image is its band of its rows of one port process's
    image and of JAX's (given noise maps, cut to the band in the port)."""
    for r, res in enumerate(_each_rank(case, layout)):
        rows, band = res["rows"], res["gband"]
        img = res["image"].numpy()
        assert img.shape == (B // layout[0], 3, G_SIZE // layout[1], G_SIZE)
        np.testing.assert_allclose(img, case["image"][rows][:, :, band].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=f"rank {r}")
        np.testing.assert_allclose(img, case["img_j"][rows][:, :, band], rtol=1e-4,
                                   atol=1e-5, err_msg=f"rank {r} vs JAX")
        assert res["k1"] == (0, 0)  # CPU tensors take the plain version


@pytest.mark.parametrize("layout", LAYOUTS)
def test_gar_gradients_match_one_process(case, layout):
    """The vertex and normal gradients (summed over ``'space'`` as they
    leave the banded pyramid) are one process's rows; every reduced
    parameter gradient is one process's over ``n_data``."""
    for r, res in enumerate(_each_rank(case, layout)):
        rows = res["rows"]
        _close(res["vert_grad"], case["vert_grad"][rows], 1e-5, f"rank {r} vert")
        _close(res["norm_grad"], case["norm_grad"][rows], 1e-5, f"rank {r} norm")
        for name, a, b in zip(case["g_names"], res["g_grads"], case["g_grads"]):
            _close(a, b / res["n_data"], 1e-5, f"rank {r} {name}")


@pytest.mark.parametrize("layout", LAYOUTS)
def test_halo_reaches_past_neighbours(case, layout):
    """``halo`` with 2 rows above and 3 below on 1-row bands (rows of
    ranks 2 and 3 away, zeros past the edges): the zero-padded whole map's
    rows; its adjoint adds each rank's weights at the rows they padded."""
    ns = layout[1]
    full = torch.arange(2.0 * ns * 3).reshape(1, 2, ns, 3) + 1
    padded = torch.nn.functional.pad(full, [0, 0, 2, 3])
    w = [torch.arange(36.0).reshape(1, 2, 6, 3) + 100 * q for q in range(ns)]
    for res in _each_rank(case, layout):
        s = res["space_index"]
        out, grad = res["halo"]
        np.testing.assert_array_equal(out.numpy(), padded[:, :, s:s + 6].numpy())
        want = sum(w[q][:, :, s - q + 2:s - q + 3] for q in range(ns) if 0 <= s - q + 2 < 6)
        np.testing.assert_array_equal(grad.numpy(), want.numpy())


@pytest.mark.parametrize("layout", LAYOUTS)
def test_band_layers_match_whole_map(case, layout):
    """Each banded layer (``Downsample``, a lone ``Blur`` and the
    downsampling ``ModulatedConv2d`` among them, which D and the GAR do not
    reach) on a rank's band: the whole map's output rows and input
    gradient rows, to 1e-5 of their largest magnitude."""
    for r, res in enumerate(_each_rank(case, layout)):
        assert len(res["layers"]) == 8
        for name, (fwd, grad) in res["layers"].items():
            assert fwd <= 1e-5 and grad <= 1e-5, (r, name, fwd, grad)


# ---- K1 by band, plain version and host build ------------------------------

@pytest.fixture(scope="module")
def host_build():
    import shutil

    if shutil.which("g++") is None:
        pytest.skip("no g++ on PATH: the host build of the kernel's math cannot be made")
    from stylerenderer_tpu_torch.ops._build import library

    return library("multi_host")


def _assert_band_cut(band_out, full_out, rows_of, with_attrs, what):
    for k, (a, b) in enumerate(zip(band_out, full_out)):
        y0, y1 = rows_of(k)
        for x, y in (zip(a, b) if with_attrs else [(a, b)]):
            assert x.shape[1] == y1 - y0, (what, k, x.shape)
            np.testing.assert_array_equal(x.numpy(), y[:, y0:y1].numpy(),
                                          err_msg=f"{what} level {k}")


@pytest.mark.parametrize("name,n_levels,n_space,tile", BAND_CASES)
def test_k1_band_plain_and_host_equal_full_cut(host_build, name, n_levels, n_space, tile):
    """Every space band of the pyramid: the plain version (dense search on
    the band's rows) and the host build of the card's binning and kernel
    (triangles whose tile rows meet the band, the band's tiles; with
    values and winners-only), equal the whole image's plain result cut to
    the band at every level, bit for bit; the host binning of the band has
    the plain binning's keys and starts, and keeps no more triangles than
    the whole image's."""
    v, tri, attrs, top, _, _, persp = kernel_case(name)
    v, tri, attrs = (torch.from_numpy(a) for a in (v, tri, attrs))
    full_tile = space_band(top, n_levels, 1, 0, tile)[0]
    full = rasterize_winners_multi_ref(v, tri, top, n_levels, persp, attrs=attrs, tile=full_tile)
    full_win = [w for _, w in full]
    for index in range(n_space):
        t, band = space_band(top, n_levels, n_space, index, tile)
        assert band[1] * t == top // n_space

        def rows_of(k, t=t, band=band):
            return (band[0] * t) >> k, ((band[0] + band[1]) * t) >> k

        _, starts, _, keys = bin_multi_host(v, tri, top, n_levels, persp, 1e-6, t, attrs, band)
        _, ids, pstarts = build_bins_multi(v, tri, top, n_levels, persp, 1e-6, t, attrs, band)
        np.testing.assert_array_equal(starts.numpy(), pstarts.numpy())
        np.testing.assert_array_equal(keys.numpy(), keys_of_bins(ids.numpy(), pstarts.numpy()))
        whole = build_bins_multi(v, tri, top, n_levels, persp, 1e-6, t, attrs)[2]
        assert (starts[:, -1] <= whole[:, -1]).all()

        for fn, what in ((rasterize_winners_multi_ref, "plain"),
                         (rasterize_winners_multi_host, "host")):
            _assert_band_cut(fn(v, tri, top, n_levels, persp, attrs=attrs, tile=t, band=band),
                             full, rows_of, True, f"{what} band {index}")
        # the plain winners-only mode is the same dense search as above
        _assert_band_cut(rasterize_winners_multi_host(v, tri, top, n_levels, persp, tile=t,
                                                      band=band),
                         full_win, rows_of, False, f"host winners band {index}")


def test_k1_any_band_of_tile_rows(host_build):
    """A band that is not one of ``space_band``'s (tile rows [1, 3) of 4 at
    tile 8, top 32, 3 levels), through the CPU wrapper and the host build:
    those rows of the whole result."""
    v, tri, attrs, top, _, _, persp = kernel_case("random")
    v, tri, attrs = (torch.from_numpy(a) for a in (v, tri, attrs))
    full = rasterize_winners_multi_ref(v, tri, top, 3, persp, attrs=attrs, tile=8)
    for fn in (rasterize_winners_multi, rasterize_winners_multi_host):
        _assert_band_cut(fn(v, tri, top, 3, persp, attrs=attrs, tile=8, band=(1, 2)), full,
                         lambda k: (8 >> k, 24 >> k), True, fn.__name__)


def test_band_refusals():
    """``space_band`` refuses a split that some level's height does not
    take (3 bands, or 8 of a pyramid whose smallest level has 4 rows); a
    band of tile rows outside the grid, or not whole rows at a level,
    raises; ``make_mesh_2d`` refuses a world other than ``n_data *
    n_space`` before making a group, and ``split_mesh`` likewise;
    ``band_rows`` refuses rows that do not split."""
    assert space_band(16, 3, 4, 1) == (4, (1, 1))
    assert space_band(256, 7, 2, 1) == (16, (8, 8)) and default_tile(256) == 16
    for n_space in (3, 8):
        with pytest.raises(ValueError, match="multiple of"):
            space_band(16, 3, n_space, 0)
    v, tri, _, top, _, _, _ = kernel_case("random")
    v, tri = torch.from_numpy(v), torch.from_numpy(tri)
    with pytest.raises(ValueError, match="outside"):
        rasterize_winners_multi(v, tri, 32, 2, tile=16, band=(1, 2))
    with pytest.raises(ValueError, match="whole rows"):
        rasterize_winners_multi(v, tri, 32, 6, tile=16, band=(0, 1))
    with pytest.raises(ValueError, match="needs 4 ranks"):
        make_mesh_2d(2, 2, "cpu", rank=0, world_size=3)
    with pytest.raises(ValueError, match="needs 2 ranks"):
        split_mesh(Mesh(), 2, 1)
    with pytest.raises(ValueError, match="do not split"):
        band_rows(Mesh(rank=1, world=4, n_space=4), 6)


def test_one_space_rank_is_the_unsharded_model():
    """A 1 x 1 mesh (``make_mesh_2d`` without a launcher) and the 1-D mesh
    split 1 x 1 are the 1-D mesh: D's logits and the GAR's image are
    bit-equal to no mesh."""
    mesh = make_mesh_2d(1, 1, "cpu")
    assert mesh.group is None and mesh.n_space == 1 and split_mesh(mesh, 1, 1) is mesh
    rng = np.random.RandomState(5)
    d = Discriminator(8, channel_multiplier=CM, device="cpu")
    x = torch.from_numpy(rng.randn(2, 3, 8, 8).astype(np.float32))
    assert torch.equal(d(x, mesh), d(x))
    g = GeneratorWithMap(8, 16, 1, channel_multiplier=CM, device="cpu")
    from stylerenderer_tpu_torch.face3d import mesh_point_normal, synthetic_face

    face, tri = synthetic_face(6, 12, 4, 2, device="cpu")
    vert = face(torch.from_numpy(rng.randn(2, 6).astype(np.float32)) * face.sigma)
    norm = mesh_point_normal(vert, tri)
    z = [torch.from_numpy(rng.randn(2, 16).astype(np.float32))]
    a = g(z, (vert, norm, tri), randomize_noise=False)[0]
    b = g(z, (vert, norm, tri), randomize_noise=False, device_mesh=mesh)[0]
    assert torch.equal(a, b)

"""The port's face models and loaders against the JAX package: BFM,
FaceWarehouse and FLAME files in the published layouts (made with numpy,
``tests/torch_face_models.py``) through both packages' loaders, the
blendshape and skinning models' forwards, priors and gradients, the
transform builders, the priors' moments, a BFM mesh through the GAR, and
``--bfm`` in every CLI on the CPU."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import scipy.io
import scipy.special
import torch

from torch_face_models import FLAME_KINTREE, bfm_dict, facewarehouse_dict, flame_dict

from stylerenderer_tpu.face3d import io as jio
from stylerenderer_tpu.face3d import transforms as jtf
from stylerenderer_tpu.face3d.geometry import mesh_point_normal as j_mesh_point_normal
from stylerenderer_tpu.face3d.morphable import (
    make_blendshape_model as j_make_blendshape_model,
    make_lbs_model as j_make_lbs_model,
)
from stylerenderer_tpu.models.generator import GeneratorWithMap as JGeneratorWithMap

from stylerenderer_tpu_torch.face3d import (
    io, load_bfm, load_bfm_texture, load_facewarehouse, load_flame, make_blendshape_model,
    make_lbs_model, mesh_point_normal, rotate_mat, scale_mat, translate_mat,
)
from stylerenderer_tpu_torch.models import GeneratorWithMap
from stylerenderer_tpu_torch.utils.weights import noise_from_jax, state_dict_from_jax
from torch_threads import _one_thread  # noqa: F401

# a reordered FLAME tree: the root is joint 1, joint 2 its child, the rest
# children of joint 2 (the loaders reorder parents first)
SHUFFLED_KINTREE = np.asarray([[2, 4294967295, 1, 2, 2], [0, 1, 2, 3, 4]], np.uint32)


def _eq(a, b, what=""):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=what)


@pytest.mark.parametrize("source", ["dict", "mat", "mat_cell_tri"])
def test_load_bfm_matches_jax(tmp_path, source):
    """The same BFM dict or ``.mat`` file gives equal arrays and triangles,
    exactly; the 1e-5 scale, the centring and ``sigma_shape`` are applied."""
    data = bfm_dict(cell_tri=source == "mat_cell_tri")
    if source != "dict":
        path = str(tmp_path / "bfm.mat")
        scipy.io.savemat(path, data)
        data = path
    jm, jtri = jio.load_bfm(data)
    pm, ptri = load_bfm(data, device="cpu")
    for name in ("basis", "mean", "sigma"):
        _eq(getattr(pm, name).numpy(), getattr(jm, name), name)
    assert (pm.shape_dim, pm.expression_dim) == (jm.shape_dim, jm.expression_dim) == (6, 3)
    assert ptri.dtype == torch.int64 and int(ptri.min()) == 0
    _eq(ptri.numpy(), jtri, "tri")
    assert abs(float(pm.mean.reshape(-1, 3).mean(0).abs().max())) < 1e-6  # centred


@pytest.mark.parametrize("layout", ["rows", "columns", "none"])
def test_load_bfm_texture_matches_jax(layout):
    data = bfm_dict()
    if layout == "rows":
        data["tex"] = data["tex"].T.copy()
    elif layout == "none":
        del data["tex"]
    jt, pt = jio.load_bfm_texture(data), load_bfm_texture(data)
    if layout == "none":
        assert jt is None and pt is None
    else:
        assert pt.shape == (len(data["v"][0]), 3) and pt.dtype == np.float32
        _eq(pt, jt)


def test_load_facewarehouse_matches_jax(tmp_path):
    data = facewarehouse_dict()
    path = str(tmp_path / "fw.mat")
    scipy.io.savemat(path, data)
    for src in (data, path):
        jm, jtri = jio.load_facewarehouse(src)
        pm, ptri = load_facewarehouse(src, device="cpu")
        _eq(pm.weight.numpy(), jm.weight, "weight")
        _eq(pm.beta.numpy(), jm.beta, "beta")
        assert (pm.shape_dim, pm.expression_dim) == (jm.shape_dim, jm.expression_dim) == (4, 3)
        _eq(ptri.numpy(), jtri, "tri")


@pytest.mark.parametrize("case", ["flame", "sparse_regressor", "shuffled_tree", "mat"])
def test_load_flame_matches_jax(tmp_path, case):
    """FLAME's ``kintree_table`` (root marked 2^32 - 1), a scipy sparse
    ``J_regressor``, a tree whose file order puts children first, and a
    ``.mat`` file: equal arrays, parents and triangles."""
    data = flame_dict(sparse=case == "sparse_regressor",
                      kintree=SHUFFLED_KINTREE if case == "shuffled_tree" else FLAME_KINTREE)
    if case == "mat":
        path = str(tmp_path / "flame.mat")
        scipy.io.savemat(path, data)
        data = path
    jm, jtri = jio.load_flame(data)
    pm, ptri = load_flame(data, device="cpu")
    for name in ("shapedirs", "posedirs", "v_template", "lbs_weights", "j_regressor", "sigma",
                 "pose_mean", "pose_cov"):
        _eq(getattr(pm, name).numpy(), getattr(jm, name), name)
    assert pm.parents == jm.parents and pm.shape_dim == jm.shape_dim == 10
    _eq(ptri.numpy(), jtri, "tri")


@pytest.mark.parametrize("loader", ["bfm", "facewarehouse", "flame", "face_model"])
def test_loaders_default_to_the_card(monkeypatch, loader):
    """Without ``device`` a loader asks for the card, and raises where there
    is none; it never falls back to the CPU on its own."""
    load = {"bfm": lambda: load_bfm(bfm_dict()),
            "facewarehouse": lambda: load_facewarehouse(facewarehouse_dict()),
            "flame": lambda: load_flame(flame_dict()),
            "face_model": lambda: io.load_face_model()}[loader]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load()


@pytest.mark.parametrize("kintree", [
    FLAME_KINTREE, SHUFFLED_KINTREE, np.asarray([-1, 0, 1, 1]), np.asarray([0, 1, 1]),
    np.asarray([[-1, 0], [0, 1], [1, 2], [1, 3]])])
def test_order_kintree_matches_jax(kintree):
    nj = 5 if np.ndim(kintree) == 2 and kintree.shape[0] == 2 else 4
    parents, order = io._order_kintree(kintree, nj)
    jp, jo = jio._order_kintree(kintree, nj)
    assert parents == jp
    _eq(order, jo)


@pytest.mark.parametrize("kw", [
    dict(), dict(sigma_pose=[0.1, 0.2, 0.3]), dict(sigma_pose=np.arange(1, 10) * 0.1),
    dict(sigma_pose=np.arange(1, 28) * 0.05, mean_pose=[0.1, -0.2, 0.3]),
    dict(mean_pose=np.arange(9) * 0.1, sigma_shape=[2.0, 0.5])])
def test_make_lbs_model_matches_jax(kw):
    """Without a file: the random fill, the nearest-joint skinning weights,
    and each layout of the pose prior's scales and mean."""
    jm, pm = j_make_lbs_model(30, 4, 5, **kw), make_lbs_model(30, 4, 5, device="cpu", **kw)
    for name in ("shapedirs", "posedirs", "v_template", "lbs_weights", "j_regressor", "sigma",
                 "pose_mean", "pose_cov"):
        _eq(getattr(pm, name).numpy(), getattr(jm, name), name)
    assert pm.parents == jm.parents == (0, 0, 0)


def _blendshape_models():
    rng = np.random.RandomState(0)
    bs = rng.randn(5, 4, 30).astype(np.float32)  # covers 4 identities of 5, 10 vertices
    kw = dict(beta_shape=[0.5, 1.0, 2.0, 3.0, 1.5], beta_expression=[1.0, 10.0, 2.0, 5.0, 0.7, 3.0])
    return (j_make_blendshape_model(12, 4, 3, bs, **kw),
            make_blendshape_model(12, 4, 3, bs, device="cpu", **kw))


def _lbs_models():
    data = flame_dict()
    return jio.load_flame(data)[0], load_flame(data, device="cpu")[0]


def _x(model, seed, scale):
    rng = np.random.RandomState(seed)
    return (rng.randn(3, sum(model.dim[:2])) * scale).astype(np.float32)


@pytest.mark.parametrize("kind", ["blendshape", "lbs"])
def test_model_forward_prior_and_gradient_match_jax(kind):
    """``__call__`` and ``regulation`` on the same ``x`` to 1e-5 of the
    largest value; their gradients with respect to ``x`` to 1e-4."""
    jm, pm = _blendshape_models() if kind == "blendshape" else _lbs_models()
    if kind == "blendshape":
        _eq(pm.weight.numpy(), jm.weight)
        _eq(pm.beta.numpy(), jm.beta)
    x = _x(pm, 1, 0.8 if kind == "blendshape" else 0.3)
    rng = np.random.RandomState(2)
    cot = rng.randn(3, pm.dim[2] // 3, 3).astype(np.float32)
    vj = np.asarray(jax.jit(lambda x: jm(x))(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    vp = pm(xt)
    assert vp.shape == vj.shape == (3, pm.dim[2] // 3, 3)
    np.testing.assert_allclose(vp.detach().numpy(), vj, rtol=0, atol=1e-5 * np.abs(vj).max())
    rj, rp = float(jax.jit(lambda x: jm.regulation(x))(jnp.asarray(x))), pm.regulation(xt)
    np.testing.assert_allclose(float(rp.detach()), rj, rtol=1e-5)

    def j_loss(x):
        return jnp.sum(jm(x) * cot) + 0.1 * jm.regulation(x)

    gj = np.asarray(jax.jit(jax.grad(j_loss))(jnp.asarray(x)))
    (gp,) = torch.autograd.grad((vp * torch.from_numpy(cot)).sum() + 0.1 * rp, xt)
    np.testing.assert_allclose(gp.numpy(), gj, rtol=0, atol=1e-4 * np.abs(gj).max())


def _within(sample, mean, var, what, n_se=4.0):
    """Sample mean and variance of each column within ``n_se`` standard
    errors of ``mean`` and ``var`` (the variance's from the sample's fourth
    central moment)."""
    n = sample.shape[0]
    m = sample.mean(0)
    c = sample - m
    v = (c ** 2).mean(0)
    se_m = np.sqrt(var / n)
    se_v = np.sqrt(np.maximum((c ** 4).mean(0) - v ** 2, 1e-30) / n)
    assert (np.abs(m - mean) <= n_se * se_m).all(), (what, m, mean, se_m)
    assert (np.abs(v - var) <= n_se * se_v).all(), (what, v, var, se_v)


def test_random_input_moments():
    """``random_input`` of each model against its prior's moments at
    N = 4096, within 4 standard errors: the BFM's Gaussian, the skinning
    model's shape Gaussian and per-joint rotations ``N(mean, cov^T cov)``,
    and the blendshape model's centred Dirichlet log ratios (digamma and
    trigamma of the concentrations) and Beta logits."""
    n = 4096
    bfm, _ = load_bfm(bfm_dict(), device="cpu")
    x = bfm.random_input(n, torch.Generator().manual_seed(0)).numpy().astype(np.float64)
    _within(x, 0.0, bfm.sigma.numpy().astype(np.float64) ** 2, "bfm")

    lbs = _lbs_models()[1]
    x = lbs.random_input(n, torch.Generator().manual_seed(1)).numpy().astype(np.float64)
    S = lbs.shape_dim
    _within(x[:, :S], 0.0, lbs.sigma[:S].numpy().astype(np.float64) ** 2, "lbs shape")
    cov = lbs.pose_cov.numpy().astype(np.float64)
    pose_var = np.concatenate([np.diag(c.T @ c) for c in cov])
    _within(x[:, S:], lbs.pose_mean.numpy(), pose_var, "lbs pose")

    bs = _blendshape_models()[1]
    S, E = bs.shape_dim, bs.expression_dim
    x = bs.random_input(n, torch.Generator().manual_seed(2)).numpy().astype(np.float64)
    beta = bs.beta.numpy().astype(np.float64)
    alpha, ab = beta[: S + 1], beta[S + 1:].reshape(E, 2)
    mean_y = scipy.special.digamma(alpha[:S]) - scipy.special.digamma(alpha[S])
    cov_y = np.diag(scipy.special.polygamma(1, alpha[:S])) + scipy.special.polygamma(1, alpha[S])
    C = np.eye(S) - 1.0 / S
    _within(x[:, :S], C @ mean_y, np.diag(C @ cov_y @ C.T), "blendshape identity")
    _within(x[:, S:], scipy.special.digamma(ab[:, 0]) - scipy.special.digamma(ab[:, 1]),
            scipy.special.polygamma(1, ab[:, 0]) + scipy.special.polygamma(1, ab[:, 1]),
            "blendshape expression")


@pytest.mark.parametrize("kind", ["bfm", "blendshape", "lbs"])
def test_random_input_follows_its_generator(kind):
    """The same generator state gives the same samples, a generator of
    another seed others, and no generator draws from the CPU's default."""
    model = {"bfm": lambda: load_bfm(bfm_dict(), device="cpu")[0],
             "blendshape": lambda: _blendshape_models()[1],
             "lbs": lambda: _lbs_models()[1]}[kind]()
    a = model.random_input(8, torch.Generator().manual_seed(5))
    b = model.random_input(8, torch.Generator().manual_seed(5))
    c = model.random_input(8, torch.Generator().manual_seed(6))
    assert a.shape == (8, sum(model.dim[:2])) and bool(torch.isfinite(a).all())
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)
    torch.manual_seed(0)
    d = model.random_input(8)
    torch.manual_seed(0)
    torch.testing.assert_close(d, model.random_input(8), rtol=0, atol=0)


def test_log_gamma_small_shape_stays_finite():
    """FaceWarehouse's identity prior (concentration 0.01): the Gamma
    variates underflow in float32, their logs stay finite, and so do the
    model's samples and vertices."""
    model, _ = load_facewarehouse(facewarehouse_dict(), device="cpu")
    x = model.random_input(64, torch.Generator().manual_seed(0))
    assert bool(torch.isfinite(x).all())
    assert bool(torch.isfinite(model(x)).all())


@pytest.mark.parametrize("shape", [(3,), (4, 2), (2, 3, 3)])
def test_transform_mats_match_jax(shape):
    rng = np.random.RandomState(len(shape))
    t = rng.randn(*shape).astype(np.float32)
    if t.ndim <= 2:
        np.testing.assert_allclose(translate_mat(torch.from_numpy(t)).numpy(),
                                   np.asarray(jtf.translate_mat(t)), rtol=0, atol=1e-6)
    np.testing.assert_allclose(rotate_mat(torch.from_numpy(t)).numpy(),
                               np.asarray(jtf.rotate_mat(t)), rtol=0, atol=1e-6)
    np.testing.assert_allclose(scale_mat(torch.from_numpy(t)).numpy(),
                               np.asarray(jtf.scale_mat(t)), rtol=0, atol=1e-6)
    np.testing.assert_allclose(scale_mat(torch.from_numpy(t[..., 0]), 3).numpy(),
                               np.asarray(jtf.scale_mat(t[..., 0], 3)), rtol=0, atol=1e-6)


def test_bfm_through_the_gar_matches_jax():
    """A ``load_bfm`` model's vertices, normals and the GAR's image with the
    same weights, ``x``, latents and noise: vertices and normals to 1e-6,
    the image to rtol/atol 1e-4 (``tests/test_torch_generator.py``'s)."""
    data = bfm_dict(12, 24, 4, 2)
    jm, jtri = jio.load_bfm(data)
    pm, ptri = load_bfm(data, device="cpu")
    rng = np.random.RandomState(3)
    x = (rng.randn(2, 6) * np.asarray(jm.sigma)).astype(np.float32)
    vj = jm(jnp.asarray(x))
    vp = pm(torch.from_numpy(x))
    np.testing.assert_allclose(vp.numpy(), np.asarray(vj), rtol=0, atol=1e-6)
    nj = j_mesh_point_normal(vj, jtri)
    npn = mesh_point_normal(vp, ptri)
    np.testing.assert_allclose(npn.numpy(), np.asarray(nj), rtol=0, atol=1e-6)

    size, dim = 16, 32
    jg = JGeneratorWithMap(size, dim, 1, channel_multiplier=1)
    z = rng.randn(2, dim).astype(np.float32)
    mesh_j = (vj, nj, jtri)
    variables = jax.jit(jg.init)({"params": jax.random.PRNGKey(0),
                                  "noise": jax.random.PRNGKey(1)}, [jnp.asarray(z)], mesh_j)
    noise = [rng.randn(2, r, r, 1).astype(np.float32) for r in (4, 8, 8, 16, 16)]
    img_j = jax.jit(lambda v, z, n: jg.apply(v, [z], mesh_j, noise=n)[0])(
        variables, jnp.asarray(z), [jnp.asarray(n) for n in noise])
    pg = GeneratorWithMap(size, dim, 1, channel_multiplier=1, device="cpu").eval()
    pg.load_state_dict(state_dict_from_jax(jax.tree_util.tree_map(np.asarray,
                                                                  variables["params"])))
    with torch.no_grad():
        img_p = pg([torch.from_numpy(z)], (vp, npn, ptri), noise=noise_from_jax(noise))[0]
    img_p = img_p.permute(0, 2, 3, 1).numpy()
    assert np.isfinite(img_p).all() and np.abs(img_p).max() > 1e-3
    np.testing.assert_allclose(img_p, np.asarray(img_j), rtol=1e-4, atol=1e-4)


def test_cli_generate_takes_bfm(tmp_path):
    """``cli.generate --with_map --bfm`` renders on the BFM file's mesh
    (its normal maps written beside the grid)."""
    from stylerenderer_tpu_torch.cli.generate import main

    bfm = str(tmp_path / "bfm.mat")
    scipy.io.savemat(bfm, bfm_dict(12, 24, 4, 2))
    paths = main(["--with_map", "--bfm", bfm, "--size", "16", "--latent", "32", "--n_mlp", "1",
                  "--channel_multiplier", "1", "--sample", "2", "--pics", "1",
                  "--save_normals", "--device", "cpu", "--out", str(tmp_path / "out")])
    assert len(paths) == 1 and (tmp_path / "out" / "000000_norm.png").exists()
    with pytest.raises(FileNotFoundError):
        main(["--with_map", "--bfm", str(tmp_path / "missing.mat"), "--size", "16",
              "--device", "cpu", "--out", str(tmp_path / "out")])

"""The JAX reference pieces of one train step at a tiny size, and the
helpers that carry weights and draws between the two packages; shared by
``test_torch_train.py`` and ``test_torch_parallel.py``.

``size=8``, ``latent=16``, ``n_mlp=1``, ``channel_multiplier=1``, B=4,
``synthetic_face(6, 12, 4, 2)``, as ``tests/test_train.py::tiny_cfg``.
The ``tiny`` fixture draws the port's weights, perturbs them, carries
them to JAX (``import_generator`` / ``import_discriminator``) and jits
the reference pieces: the posed mesh, the fakes, the D loss, R1, the G
loss (also with the deterministic stand-in heads of
``tests/test_train.py::test_train_step_spmd_heads_and_augment``) and the
path penalty, each with its gradients."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from stylerenderer_tpu.face3d import mesh_point_normal as j_mesh_point_normal
from stylerenderer_tpu.face3d import synthetic_face as j_synthetic_face
from stylerenderer_tpu.face3d.transforms import euler_mat as j_euler_mat
from stylerenderer_tpu.models.generator import _mix_styles as j_mix_styles
from stylerenderer_tpu.train import losses as jl
from stylerenderer_tpu.train import make_models as j_make_models
from stylerenderer_tpu.train.step import _smooth_l1 as j_smooth_l1
from stylerenderer_tpu.utils.config import TrainConfig as JTrainConfig
from stylerenderer_tpu.utils.torch_import import import_discriminator, import_generator

from stylerenderer_tpu_torch.face3d import synthetic_face
from stylerenderer_tpu_torch.face3d.geometry import POSE3D_P
from stylerenderer_tpu_torch.train import init_train_state
from stylerenderer_tpu_torch.train.step import StepDraws, StyleDraws
from stylerenderer_tpu_torch.utils.config import TrainConfig
from stylerenderer_tpu_torch.utils.weights import (
    discriminator_state_dict_from_jax,
    state_dict_from_jax,
)

SIZE, LATENT, N_MLP, B = 8, 16, 1, 4
B2 = 2  # the batch of the schedule, ADA and screen tests
CFG = dict(size=SIZE, latent=LATENT, n_mlp=N_MLP, channel_multiplier=1, batch=B,
           d_reg_every=2, g_reg_every=2, path_batch_shrink=2, mixing=0.9)
NOISE_RES = [4, 8, 8]


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(np.asarray(x), (0, 3, 1, 2))))


def _nhwc(x):
    return np.transpose(np.asarray(x), (0, 2, 3, 1))


def _perturb(params, seed):
    """Every leaf plus seeded N(0, 0.2^2) noise, so zero-initialized biases
    and noise strengths take part."""
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32)
        + 0.2 * np.asarray(rng.randn(*np.shape(x)), np.float32),
        params)


def _chw_to_hwc(w):
    """``final_linear.0`` rows from the port's (C, H, W) flatten to JAX's
    (H, W, C)."""
    c = w.shape[0] // 16
    return np.transpose(w.reshape(c, 4, 4, -1), (1, 2, 0, 3)).reshape(16 * c, -1)


def _jax_g(named):
    """Port G parameters (or gradients) by name -> a JAX params tree."""
    return import_generator({k: np.asarray(v) for k, v in named.items()}, SIZE, N_MLP,
                            with_map=True)


def _jax_d(named):
    tree = import_discriminator({k: np.asarray(v) for k, v in named.items()}, SIZE)
    tree["final_linear0"]["weight"] = _chw_to_hwc(tree["final_linear0"]["weight"])
    return tree


def _named(module, tensors=None):
    names = [n for n, _ in module.named_parameters()]
    tensors = [p for _, p in module.named_parameters()] if tensors is None else tensors
    return {n: t.detach().numpy() for n, t in zip(names, tensors)}


def _assert_tree_close(port, ref, rel, path=""):
    """Leafwise: max |port - ref| <= rel * max |ref| (each tensor against its
    own largest magnitude)."""
    if isinstance(ref, dict):
        assert set(port) == set(ref), (path, set(port) ^ set(ref))
        for k in ref:
            _assert_tree_close(port[k], ref[k], rel, f"{path}/{k}")
        return
    a, b = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    assert a.shape == b.shape, (path, a.shape, b.shape)
    err, scale = np.abs(a - b).max(), np.abs(b).max()
    assert err <= rel * max(scale, 1e-30), f"{path}: max err {err:.3e}, scale {scale:.3e}"


def _close(a, b, rel):
    a = a.detach() if isinstance(a, torch.Tensor) else a
    np.testing.assert_allclose(float(a), float(b), rtol=rel, atol=rel * 1e-3)


@pytest.fixture(scope="module")
def tiny():
    """The JAX models, perturbed weights (drawn by the port, carried to JAX
    by ``import_generator`` / ``import_discriminator``), the face model of
    both packages, and the jitted JAX reference pieces of a step."""
    jcfg = JTrainConfig(**CFG)
    jgen, jdisc = j_make_models(jcfg)
    jface, jtri = j_synthetic_face(6, 12, shape_dim=4, expression_dim=2)
    st = init_train_state(TrainConfig(**CFG), "cpu")
    gp, dp = _perturb(_jax_g(_named(st.g)), 4), _perturb(_jax_d(_named(st.d)), 5)
    face, tri = synthetic_face(6, 12, 4, 2, device="cpu")
    np.testing.assert_array_equal(tri.numpy(), np.asarray(jtri))

    def disc(p, img):
        return jdisc.apply({"params": p}, img)

    @jax.jit
    def posed(x, z):
        v = jface(x)
        R = jnp.exp(z[:, -1])[:, None, None] * j_euler_mat(z[:, :3], "yxz")
        v = jnp.einsum("bnk,bkj->bnj", v, R) + z[:, None, 3:6]
        return v, j_mesh_point_normal(v, jtri)

    @jax.jit
    def fake(g, styles, inject, vert, norm, noise):
        return jgen.apply({"params": g}, styles, (vert, norm, jtri), inject_index=inject,
                          noise=noise)[0]

    @jax.jit
    def d_step(d, real, fake_img):
        return jax.value_and_grad(
            lambda p: jl.d_logistic_loss(disc(p, real), disc(p, fake_img)))(d)

    @jax.jit
    def r1(d, real):
        def f(p):
            r = jl.r1_penalty(disc, p, real)
            return jcfg.r1 / 2.0 * r * jcfg.d_reg_every, r
        return jax.value_and_grad(f, has_aux=True)(d)

    @jax.jit
    def g_step(g, d, styles, inject, vert, norm, noise):
        def f(p):
            img = jgen.apply({"params": p}, styles, (vert, norm, jtri), inject_index=inject,
                             noise=noise)[0]
            return jl.g_nonsaturating_loss(disc(d, img))
        return jax.value_and_grad(f)(g)

    @jax.jit
    def path(g, styles, inject, vert, norm, noise, key, mpl):
        pyramid = jgen.apply({"params": g}, (vert, norm, jtri), method=jgen.normal_pyramid)
        pyramid = [jax.lax.stop_gradient(m) for m in pyramid]

        def f(p):
            w = [jgen.apply({"params": p}, s, method=jgen.get_latent) for s in styles]
            latent = j_mix_styles(w, jgen.n_latent, inject, None, None)

            def synth(lat, *maps):
                return jgen.apply({"params": p}, lat, list(maps), method=jgen.synthesize,
                                  noise=noise)

            pl = jl.path_lengths_multi(synth, key, (latent, *pyramid))
            penalty, new_mean = jl.path_regularize(pl, mpl)
            return jcfg.path_regularize * jcfg.g_reg_every * penalty, (penalty, new_mean, pl)
        return jax.value_and_grad(f, has_aux=True)(g)

    jheads = jax_stand_in_heads()

    @jax.jit
    def g_step_heads(g, d, styles, inject, vert, norm, noise):
        half, res = (vert.shape[0] + 1) // 2, vert.shape[0] // 2

        def f(p):
            img, _, norms = jgen.apply({"params": p}, styles, (vert, norm, jtri),
                                       inject_index=inject, noise=noise, return_normals=True)
            nm = norms[-1]
            mask = (jnp.sum(nm * nm, -1, keepdims=True) > 1e-3).astype(nm.dtype)
            sfs = j_smooth_l1(mask * jheads["sfs"](img), mask * nm)
            feat = jheads["feat"](img)
            fl = jnp.mean((feat[:res] - feat[half:]) ** 2)
            lmk = jheads["lmk"](img)
            ll = j_smooth_l1(lmk[:res * 2:2], lmk[1::2])
            loss = jl.g_nonsaturating_loss(disc(d, img)) + 0.01 * sfs + 0.001 * fl + 1e-5 * ll
            return loss, {"sfs": sfs, "feature": fl, "lmk": ll}
        return jax.value_and_grad(f, has_aux=True)(g)

    return dict(jcfg=jcfg, jgen=jgen, jdisc=jdisc, gp=gp, dp=dp, face=face, tri=tri,
                posed=posed, fake=fake, d_step=d_step, r1=r1, g_step=g_step, path=path,
                g_step_heads=g_step_heads, disc=jax.jit(disc))


def _state(tiny, **kw):
    """A fresh port state on the CPU carrying the fixture's weights."""
    cfg = TrainConfig(**dict(CFG, **kw))
    st = init_train_state(cfg, "cpu")
    st.g.load_state_dict(state_dict_from_jax(tiny["gp"]), strict=True)
    st.g_ema.load_state_dict(state_dict_from_jax(tiny["gp"]), strict=True)
    st.d.load_state_dict(discriminator_state_dict_from_jax(tiny["dp"], SIZE), strict=True)
    return cfg, st


def _draws(tiny, seed, batch=B):
    """Seeded numpy draws -> (port ``StepDraws``, the same draws for JAX)."""
    rng = np.random.RandomState(seed)
    pb = batch // 2
    sigma = tiny["face"].sigma.numpy()
    n_latent = tiny["jgen"].n_latent

    def styles(b):
        z1, z2 = (rng.randn(b, LATENT).astype(np.float32) for _ in range(2))
        return z1, z2, bool(rng.rand() < 0.9), int(rng.randint(1, n_latent))

    def noise(b):
        return [rng.randn(b, 1, r, r).astype(np.float32) for r in NOISE_RES]

    def mesh():
        return ((rng.randn(batch, 6) * sigma).astype(np.float32),
                (rng.randn(batch, 7) * np.asarray(POSE3D_P)).astype(np.float32))

    ds, (dx, dz), dn = styles(batch), mesh(), noise(batch)
    gs, (gx, gz), gn = styles(batch), mesh(), noise(batch)
    ps, pn = styles(pb), noise(pb)
    key = jax.random.PRNGKey(seed)
    probe = np.asarray(jax.random.normal(key, (pb, SIZE, SIZE, 3)))

    def sd(s):
        z1, z2, mix, inject = s
        return StyleDraws(torch.from_numpy(z1), torch.from_numpy(z2), torch.tensor(mix),
                          torch.tensor(inject))

    t = torch.from_numpy
    draws = StepDraws(sd(ds), t(dx), t(dz), [t(n) for n in dn], sd(gs), t(gx), t(gz),
                      [t(n) for n in gn], sd(ps), [t(n) for n in pn], _nchw(probe))

    def jstyles(s):
        z1, z2, mix, inject = s
        return [jnp.asarray(z1), jnp.asarray(z2 if mix else z1)], inject

    def jnoise(ns):
        return [jnp.asarray(np.transpose(n, (0, 2, 3, 1))) for n in ns]

    jd = dict(d_styles=jstyles(ds), d_mesh=(dx, dz), d_noise=jnoise(dn),
              g_styles=jstyles(gs), g_mesh=(gx, gz), g_noise=jnoise(gn),
              p_styles=jstyles(ps), p_noise=jnoise(pn), key=key)
    return draws, jd


def _real(seed, batch=B):
    return np.random.RandomState(seed).uniform(-1, 1, (batch, SIZE, SIZE, 3)).astype(np.float32)



def jax_stand_in_heads():
    """The deterministic stand-in heads of JAX ``tests/test_train.py``
    (NHWC); ``torch_parallel.stand_in_heads`` are the port's."""
    return {
        "sfs": lambda img: jnp.tanh(img),
        "feat": lambda img: jnp.mean(img, axis=(1, 2)),
        "lmk": lambda img: jnp.mean(jnp.abs(img), axis=3).reshape(img.shape[0], -1)[:, :16],
    }

"""The port's render inverting against the JAX package's, at the JAX tests'
size (``GeneratorWithMap(16, 32, 2, channel_multiplier=1)``,
``synthetic_face(8, 16, 4, 2)``), B=2, every loss term on and the geometry
clip triggering.

Adam's first step is about ``lr * sign(g)``, so rounding turns into
parameter differences of ``lr``: the port's own trajectory is recorded and
the JAX projector is evaluated at the parameters each port step saw (its
loss before the update, and its gradients: the first moment of an Adam
state started at zero, ``mu / (1 - b1)``, is the gradient, clipped for the
geometry). One jitted JAX projector serves every call (one compile, ~30 s
on the CPU). The outputs at JAX's own final parameters are held against
eager JAX, which differs from jitted JAX by up to 3.1e-5 on sliver pixels.
"""

import copy
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch

from stylerenderer_tpu.face3d import mesh_point_normal as j_mesh_point_normal
from stylerenderer_tpu.face3d import save_obj as j_save_obj
from stylerenderer_tpu.face3d import synthetic_face as j_synthetic_face
from stylerenderer_tpu.inversion import ProjectorConfig as JProjectorConfig
from stylerenderer_tpu.inversion import make_projector as j_make_projector
from stylerenderer_tpu.inversion.project import _apply_pose as j_apply_pose
from stylerenderer_tpu.eval.lpips import LPIPS as JLPIPS
from stylerenderer_tpu.models import GeneratorWithMap as JGeneratorWithMap
from stylerenderer_tpu.utils.torch_import import import_generator

from stylerenderer_tpu_torch.eval.lpips import LPIPS
from stylerenderer_tpu_torch.face3d import mesh_point_normal, save_obj, synthetic_face
from stylerenderer_tpu_torch.face3d.morphable import LinearMorphableModel
from stylerenderer_tpu_torch.inversion import (
    ProjectorConfig, make_projector, make_projector_jit,
)
from stylerenderer_tpu_torch.inversion.project import GEO, _apply_pose, fit_segmented
from stylerenderer_tpu_torch.models import GeneratorWithMap
from stylerenderer_tpu_torch.models.generator import make_noise
from stylerenderer_tpu_torch.utils.weights import lpips_state_dict_from_jax, state_dict_from_jax

SIZE, LATENT, N_MLP, B = 16, 32, 2, 2
LMK = [0, 5, 17, 33, 60]
# every term on; the clip far below the geometry gradient's norm
CFG = dict(iters=1, lr=0.05, lr_geom=0.01, w_pixel_l2=1.0, w_pixel_l1=0.5, w_lpips=0.3,
           w_lmk=1e-2, w_prior=1e-3, w_pose=0.1, w_reg_w=0.2, geo_grad_clip=1e-3)
FIT_KEYS = ["face_params", "log_scale", "loss_history", "rvec", "tvec", "w_plus"]
CLI_OUTPUTS = ["fit.npz", "mesh_000.obj", "render.png", "target.png"]
B1 = 0.9


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs files in parallel processes,
    where torch's thread pools would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _perturb(sd, seed):
    """Every float tensor plus seeded N(0, 0.2^2) noise, so zero-initialized
    biases and noise strengths take part."""
    rng = np.random.RandomState(seed)
    return {k: np.asarray(v, np.float32) + 0.2 * rng.randn(*v.shape).astype(np.float32)
            for k, v in sd.items() if v.dtype.is_floating_point and "kernel" not in k}


def _lpips_port(a, b):
    return torch.mean(torch.abs(a - b), dim=(1, 2, 3))


def _lpips_jax(a, b):
    return jnp.mean(jnp.abs(a - b), axis=(1, 2, 3))


@pytest.fixture(scope="module")
def tiny():
    """Both generators with one set of perturbed weights (drawn by the port,
    carried to JAX by ``import_generator`` and back by
    ``state_dict_from_jax``), both face models, a target and landmarks."""
    gen = GeneratorWithMap(SIZE, LATENT, N_MLP, channel_multiplier=1, device="cpu", seed=4)
    params = import_generator(_perturb(gen.state_dict(), 5), SIZE, N_MLP, with_map=True)
    gen.load_state_dict(state_dict_from_jax(params), strict=True)
    face, tri = synthetic_face(8, 16, shape_dim=4, expression_dim=2, device="cpu")
    jface, jtri = j_synthetic_face(8, 16, shape_dim=4, expression_dim=2)
    rs = np.random.RandomState(0)
    target = rs.uniform(-1, 1, (B, SIZE, SIZE, 3)).astype(np.float32)  # JAX layout
    lmk = rs.uniform(0, SIZE, (B, len(LMK), 2)).astype(np.float32)
    return dict(gen=gen, params=params, face=face, tri=tri, jface=jface, jtri=jtri,
                target=target, lmk=lmk, jgen=JGeneratorWithMap(SIZE, LATENT, N_MLP,
                                                               channel_multiplier=1))


@pytest.fixture(scope="module")
def jref(tiny):
    """The jitted JAX projector (one signature: always a state, one step,
    the state returned), the zeroed optimizer state, and the mean latent
    that its rng gives."""
    jgen, params = tiny["jgen"], tiny["params"]
    proj = j_make_projector(jgen, params, tiny["jface"], tiny["jtri"], JProjectorConfig(**CFG),
                            lpips_fn=_lpips_jax, lmk_vidx=jnp.asarray(LMK))
    rng = jax.random.PRNGKey(5)
    args = (rng, jnp.asarray(tiny["target"]), jnp.asarray(tiny["lmk"]))
    # the projector's optimizer (project.py:129-142) at zero; a state of any
    # other structure would not pass its scan
    tx = optax.multi_transform(
        {"lat": optax.adam(CFG["lr"]),
         "geo": optax.chain(optax.clip_by_global_norm(CFG["geo_grad_clip"]),
                            optax.adam(CFG["lr_geom"]))},
        {"w": "lat", **{k: "geo" for k in GEO}})
    zopt = tx.init({k: jnp.asarray(v) for k, v in _init_point(tiny, None).items()})
    jit = jax.jit(proj, static_argnames=("n_steps", "return_state"))
    mean_w = np.array(jgen.apply({"params": params}, jax.random.split(rng)[0], 4096,
                                 method=jgen.mean_latent))
    return dict(at=lambda p: _jax_at(jit, args, zopt, p), mean_w=mean_w, args=args,
                zopt=zopt)


def _jax_at(jit, args, zopt, p):
    """A jitted JAX projector at port parameters p -> (loss, gradients, its
    one-step output)."""
    p = {k: jnp.asarray(v.numpy() if isinstance(v, torch.Tensor) else v)
         for k, v in p.items()}
    out = jit(*args, state=(p, zopt), n_steps=1, return_state=True)
    opt = out["state"][1]
    assert jax.tree_util.tree_structure(opt) == jax.tree_util.tree_structure(zopt)
    geo = opt.inner_states["geo"].inner_state[1][0].mu
    g = {"w": opt.inner_states["lat"].inner_state[0].mu["w"], **{k: geo[k] for k in GEO}}
    return (float(out["loss_history"][0]),
            {k: np.asarray(g[k]) / (1 - B1) for k in ("w",) + GEO}, out)


def _port_projector(tiny, **kw):
    return make_projector(tiny["gen"], tiny["face"], tiny["tri"],
                          ProjectorConfig(**dict(CFG, **kw)), lpips_fn=_lpips_port,
                          lmk_vidx=LMK)


def _port_target(tiny):
    return _t(tiny["target"]).permute(0, 3, 1, 2).contiguous()


def zeroed(opt_state):
    """A copy of a torch Adam state dict with its moments and step counts
    at zero: resumed, Adam takes its first step."""
    opt_state = copy.deepcopy(opt_state)
    for st in opt_state["state"].values():
        for v in st.values():
            v.zero_()
    return opt_state


def _port_grads(project, tiny, mean_w, p, zopt):
    """The port's gradients at p: Adam's first moment from a zeroed state
    over ``1 - b1``."""
    out = project(0, _port_target(tiny), _t(tiny["lmk"]), state=(p, zopt), n_steps=1,
                  return_state=True, mean_latent=mean_w)
    st = out["state"][1]["state"]
    return {k: st[i]["exp_avg"].numpy() / (1 - B1) for i, k in enumerate(("w",) + GEO)}


def _init_point(tiny, mean_w):
    """The projector's init: the mean latent at every layer (zeros without
    one), zero geometry."""
    if mean_w is None:
        mean_w = np.zeros((1, LATENT), np.float32)
    w = np.tile(mean_w[:, None, :], (B, tiny["gen"].n_latent, 1))
    zeros = {"x": (B, 6), "rvec": (B, 3), "tvec": (B, 3), "log_scale": (B, 1)}
    return dict(w=w, **{k: np.zeros(s, np.float32) for k, s in zeros.items()})


def test_projector_losses_and_gradients_match_jax(tiny, jref):
    """The port's init and 3 steps; at the parameters each step saw and
    after the last, the total loss to 1e-5 relative and every variable's
    gradient (the geometry's clipped) to 1e-4 of its largest magnitude,
    against JAX at the same parameters. The clip triggers at every point."""
    project = _port_projector(tiny)
    mean_w = jref["mean_w"]
    points, losses, state = [_init_point(tiny, jref["mean_w"])], [], None
    for _ in range(3):
        out = project(0, _port_target(tiny), _t(tiny["lmk"]), state=state, n_steps=1,
                      return_state=True, mean_latent=mean_w)
        losses.append(float(out["loss_history"][0]))
        state = out["state"]
        points.append(state[0])
    losses.append(float(project(0, _port_target(tiny), _t(tiny["lmk"]), state=state,
                                n_steps=1, mean_latent=mean_w)["loss_history"][0]))
    assert losses[-1] < losses[0]
    zopt = zeroed(state[1])
    for k, p in enumerate(points):
        jloss, jg, _ = jref["at"](p)
        np.testing.assert_allclose(losses[k], jloss, rtol=1e-5, err_msg=f"point {k}")
        g = _port_grads(project, tiny, mean_w, p, zopt)
        for name, ref in jg.items():
            s = np.abs(ref).max()
            assert s > 0, name
            np.testing.assert_allclose(g[name] / s, ref / s, rtol=0, atol=1e-4,
                                       err_msg=f"point {k} {name}")
        for grads in (g, jg):
            norm = np.sqrt(sum(np.sum(grads[n].astype(np.float64) ** 2) for n in GEO))
            np.testing.assert_allclose(norm, CFG["geo_grad_clip"], rtol=1e-4)


def test_projector_final_outputs_match_eager_jax(tiny, jref):
    """At the parameters JAX's own step reaches: every loss term equal to
    JAX's (to 1e-5 relative), the vertices (to 1e-6) and the render (to
    1e-4) to JAX's pose, normals and pyramid run eagerly (where jitted JAX
    rounds sliver pixels otherwise) and its synthesis. The port evaluates
    there with lr = 0, so its step leaves the parameters where they are."""
    _, _, jout = jref["at"](_init_point(tiny, jref["mean_w"]))
    p1 = {k: np.array(v) for k, v in jout["state"][0].items()}
    jgen, params, jtri = tiny["jgen"], tiny["params"], tiny["jtri"]
    vert = j_apply_pose(tiny["jface"](jnp.asarray(p1["x"])), jnp.asarray(p1["rvec"]),
                        jnp.asarray(p1["tvec"]), jnp.asarray(p1["log_scale"]))
    norm = j_mesh_point_normal(vert, jtri)
    pyramid = jgen.apply({"params": params}, (vert, norm, jtri), method=jgen.normal_pyramid)
    synthesize = jax.jit(lambda w, pyr: jgen.apply(
        {"params": params}, w, pyr, [jnp.zeros((1, 1, 1, 1))] * jgen.num_layers,
        method=jgen.synthesize))
    img = synthesize(jnp.asarray(p1["w"]), pyramid)
    project = _port_projector(tiny, lr=0.0, lr_geom=0.0)
    args = (0, _port_target(tiny), _t(tiny["lmk"]))
    zopt = zeroed(project(*args, n_steps=1, return_state=True)["state"][1])
    out = project(*args, state=(p1, zopt), n_steps=1, mean_latent=jref["mean_w"])
    for k in ("w_plus", "face_params", "rvec", "tvec", "log_scale"):
        key = {"w_plus": "w", "face_params": "x"}.get(k, k)
        np.testing.assert_array_equal(out[k].numpy(), p1[key])
    assert set(out["losses"]) == set(jout["losses"]) == {
        "pixel_l2", "pixel_l1", "lpips", "lmk", "prior", "pose", "w_reg", "total"}
    for k, v in jout["losses"].items():
        np.testing.assert_allclose(float(out["losses"][k]), float(v), rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(out["vertices"].numpy(), np.asarray(vert), rtol=0, atol=1e-6)
    np.testing.assert_allclose(out["render"].permute(0, 2, 3, 1).numpy(), np.asarray(img),
                               rtol=1e-4, atol=1e-4)


def _lpips_params(seed):
    """JAX VGG LPIPS params made with numpy (He-scaled kernels, small
    biases, heads around 1/C), without running its init."""
    rs = np.random.RandomState(seed)
    dummy = jnp.zeros((1, 64, 64, 3))
    shapes = jax.eval_shape(JLPIPS(net="vgg").init, jax.random.PRNGKey(0), dummy,
                            dummy)["params"]

    def fill(path, s):
        path = jax.tree_util.keystr(path)
        if path.endswith("['kernel']"):
            x = rs.randn(*s.shape) * np.sqrt(2.0 / np.prod(s.shape[:-1]))
        elif path.endswith("['bias']"):
            x = rs.randn(*s.shape) * 0.05
        else:
            x = rs.uniform(0.5, 1.5, s.shape) / s.shape[0]
        return np.asarray(x, np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def test_projector_lpips_step_matches_jax(tiny, jref):
    """One step with the paper's ``w_lpips=0.8`` through the real LPIPS
    (VGG16 at the generator's 16 px), the JAX weights carried to the port by
    ``lpips_state_dict_from_jax``: at the init, the total loss to 1e-5
    relative and every gradient to 1e-4 of its largest magnitude against
    the JAX projector with the JAX LPIPS."""
    lparams = _lpips_params(21)
    jl = JLPIPS(net="vgg")
    cfg = dict(CFG, w_lpips=0.8)
    proj = j_make_projector(tiny["jgen"], tiny["params"], tiny["jface"], tiny["jtri"],
                            JProjectorConfig(**cfg),
                            lpips_fn=lambda a, b: jl.apply({"params": lparams}, a, b),
                            lmk_vidx=jnp.asarray(LMK))
    jit = jax.jit(proj, static_argnames=("n_steps", "return_state"))
    port_lpips = LPIPS("vgg")
    port_lpips.load_state_dict(lpips_state_dict_from_jax(lparams), strict=True)
    port_lpips.eval().requires_grad_(False)
    project = make_projector(tiny["gen"], tiny["face"], tiny["tri"], ProjectorConfig(**cfg),
                             lpips_fn=port_lpips, lmk_vidx=LMK)
    mean_w = jref["mean_w"]
    p = _init_point(tiny, mean_w)
    zopt = zeroed(project(0, _port_target(tiny), _t(tiny["lmk"]), n_steps=1,
                          return_state=True, mean_latent=mean_w)["state"][1])
    out = project(0, _port_target(tiny), _t(tiny["lmk"]), state=(p, zopt), n_steps=1,
                  mean_latent=mean_w)
    jloss, jg, _ = _jax_at(jit, jref["args"], jref["zopt"], p)
    np.testing.assert_allclose(float(out["loss_history"][0]), jloss, rtol=1e-5)
    g = _port_grads(project, tiny, mean_w, p, zopt)
    for name, ref in jg.items():
        s = np.abs(ref).max()
        assert s > 0, name
        np.testing.assert_allclose(g[name] / s, ref / s, rtol=0, atol=1e-4, err_msg=name)
    assert float(out["losses"]["lpips"]) > 0


# ---- the port alone: init, noise, segments, validation ----------------------

def test_projector_init_by_formula(tiny):
    """With lr = 0 the fit stays at its init: w+ is the mean latent over
    4096 draws of the caller's generator at every layer (or the Regressor's
    code of the target), the geometry zero; an int seed is that generator."""
    gen, target = tiny["gen"], _port_target(tiny)
    project = _port_projector(tiny, lr=0.0, lr_geom=0.0)
    out = project(torch.Generator().manual_seed(7), target, n_steps=1)
    mean_w = gen.mean_latent(4096, torch.Generator().manual_seed(7))
    torch.testing.assert_close(out["w_plus"], mean_w[:, None].expand(B, gen.n_latent, -1),
                               rtol=0, atol=0)
    for k in ("face_params", "rvec", "tvec", "log_scale"):
        assert not out[k].any(), k
    torch.testing.assert_close(project(7, target, n_steps=1)["w_plus"], out["w_plus"],
                               rtol=0, atol=0)

    def regressor(img):
        return img.mean(dim=(2, 3)).repeat(1, LATENT // 3 + 1)[:, :LATENT]

    project = make_projector(gen, tiny["face"], tiny["tri"],
                             ProjectorConfig(**dict(CFG, lr=0.0, lr_geom=0.0)),
                             regressor_fn=regressor)
    out = project(7, target, n_steps=1)
    torch.testing.assert_close(out["w_plus"], regressor(target)[:, None].expand(
        B, gen.n_latent, -1), rtol=0, atol=0)


def test_projector_random_noise_drawn_once(tiny):
    """``noise_mode="random"``: one set of noise maps, drawn from the
    caller's generator after the mean latent, serves every step: at fixed
    parameters (lr = 0) every step's loss is the same, and the render is
    the synthesis with exactly that set."""
    gen, target = tiny["gen"], _port_target(tiny)
    project = _port_projector(tiny, lr=0.0, lr_geom=0.0, noise_mode="random", w_reg_w=0.0)
    out = project(3, target, _t(tiny["lmk"]), n_steps=3)
    hist = out["loss_history"]
    assert torch.equal(hist, hist[:1].expand(3))
    rng = torch.Generator().manual_seed(3)
    gen.mean_latent(4096, rng)
    noise = make_noise(SIZE, B, rng, "cpu")
    with torch.no_grad():
        vert = _apply_pose(tiny["face"](out["face_params"]), out["rvec"], out["tvec"],
                           out["log_scale"])
        pyramid = gen.normal_pyramid((vert, mesh_point_normal(vert, tiny["tri"]),
                                      tiny["tri"]))
        img = gen.synthesize(out["w_plus"], pyramid, noise)
        zero = gen.synthesize(out["w_plus"], pyramid, [torch.zeros(1, 1, 1, 1)] * len(noise))
    torch.testing.assert_close(out["render"], img, rtol=0, atol=0)
    assert not torch.equal(zero, img)


def test_fit_segmented_equals_one_segment(tiny):
    """Three steps in segments of 2 and 1 carry (params, Adam state) through
    the host: bit-equal to one segment, random noise included. The
    segmented fit runs through ``make_projector_jit``'s call shape, which
    loads its state dict into a generator of other weights first."""
    target = _port_target(tiny)
    project = _port_projector(tiny, noise_mode="random")
    one = fit_segmented(project, torch.Generator().manual_seed(1), target, _t(tiny["lmk"]),
                        iters=3, segments=1)
    assert one["loss_history"].shape == (3,)
    gen = GeneratorWithMap(SIZE, LATENT, N_MLP, channel_multiplier=1, device="cpu", seed=9)
    run = make_projector_jit(gen, tiny["face"], tiny["tri"],
                             ProjectorConfig(**dict(CFG, iters=3, noise_mode="random")),
                             lpips=_lpips_port, lmk_vidx=LMK)
    two = run(tiny["gen"].state_dict(), torch.Generator().manual_seed(1), target,
              _t(tiny["lmk"]), segments=2)
    for k in ("w_plus", "face_params", "rvec", "tvec", "log_scale", "render", "vertices",
              "loss_history"):
        torch.testing.assert_close(two[k], one[k], rtol=0, atol=0, msg=k)
    assert not gen.training and not any(p.requires_grad for p in gen.parameters())


@pytest.mark.parametrize("case", ["iters", "segments", "n_steps", "size", "face", "noise"])
def test_projector_refuses_bad_arguments(tiny, case):
    target = _port_target(tiny)
    project = _port_projector(tiny)
    with pytest.raises((ValueError, TypeError)):
        if case == "iters":
            fit_segmented(project, 0, target, iters=0, segments=1)
        elif case == "segments":
            make_projector_jit(tiny["gen"], tiny["face"], tiny["tri"])(None, 0, target,
                                                                      segments=0)
        elif case == "n_steps":
            project(0, target, n_steps=0)
        elif case == "size":
            project(0, target[..., :8, :8], n_steps=1)
        elif case == "face":
            face = tiny["face"]
            blend = LinearMorphableModel(face.basis, face.mean, None, 4, 2)
            make_projector(tiny["gen"], blend, tiny["tri"])
        else:
            make_projector(tiny["gen"], tiny["face"], tiny["tri"],
                           ProjectorConfig(noise_mode="fresh"))


@pytest.mark.parametrize("with_normals", [False, True])
def test_save_obj_same_bytes_as_jax(tmp_path, with_normals):
    rng = np.random.RandomState(2)
    v = rng.randn(40, 3).astype(np.float32)
    tri = rng.randint(0, 40, (60, 3))
    vn = rng.randn(40, 3).astype(np.float32) if with_normals else ()
    assert save_obj(str(tmp_path / "port.obj"), v, tri, vn)
    j_save_obj(str(tmp_path / "jax.obj"), v, tri, vn)
    port = (tmp_path / "port.obj").read_bytes()
    assert port == (tmp_path / "jax.obj").read_bytes()
    assert (b"vn " in port) == with_normals


# ---- the CLIs on the CPU --------------------------------------------------------

TINY_ARGS = ["--size", str(SIZE), "--latent", str(LATENT), "--n_mlp", str(N_MLP),
             "--channel_multiplier", "1", "--device", "cpu"]


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A checkpoint of ``cli.train``'s format at the tiny size: G, D and
    G-EMA of a fresh train state, G-EMA's weights perturbed."""
    from stylerenderer_tpu_torch.train import init_train_state
    from stylerenderer_tpu_torch.utils.checkpoint import save_checkpoint
    from stylerenderer_tpu_torch.utils.config import TrainConfig

    cfg = TrainConfig(size=SIZE, latent=LATENT, n_mlp=N_MLP, channel_multiplier=1, batch=2)
    st = init_train_state(cfg, "cpu", seed=3)
    st.g_ema.load_state_dict({k: _t(v) for k, v in _perturb(st.g_ema.state_dict(), 6).items()},
                             strict=False)
    path = str(tmp_path_factory.mktemp("ckpt"))
    save_checkpoint(path, 1, st, cfg)
    return path, st


def _photo(path):
    from PIL import Image

    img = (np.random.RandomState(4).rand(24, 24, 3) * 255).astype(np.uint8)
    Image.fromarray(img).save(path)
    return path


def _record(monkeypatch, module, name, arg=0):
    """Wrap ``module.name`` to record the generator it is given (its
    positional argument ``arg``)."""
    seen = []
    fn = getattr(module, name)

    def wrapper(*a, **k):
        seen.append(a[arg])
        return fn(*a, **k)

    monkeypatch.setattr(module, name, wrapper)
    return seen


def _same_weights(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    return sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa)


@pytest.mark.parametrize("with_ckpt", [False, True])
def test_cli_project(tmp_path, monkeypatch, ckpt, with_ckpt):
    """``cli.project`` writes the JAX CLI's outputs (render, target, one
    mesh per photo, ``fit.npz`` with its keys) and fits with the
    checkpoint's G-EMA (``--ckpt``) or the seed's random weights."""
    import stylerenderer_tpu_torch.inversion as inversion
    from stylerenderer_tpu_torch.cli import project as cli

    seen = _record(monkeypatch, inversion, "make_projector_jit")
    out_dir = tmp_path / "out"
    argv = [_photo(str(tmp_path / "a.png")), "--iters", "2", "--segments", "2",
            "--out", str(out_dir)] + TINY_ARGS
    if with_ckpt:
        argv += ["--ckpt", ckpt[0]]
    cli.main(argv)
    assert sorted(os.listdir(out_dir)) == CLI_OUTPUTS
    fit = np.load(out_dir / "fit.npz")
    assert sorted(fit.files) == FIT_KEYS
    assert fit["w_plus"].shape == (1, 6, LATENT)
    hist = fit["loss_history"]
    assert hist.shape == (2,) and np.isfinite(hist).all() and hist[1] < hist[0]
    obj = (out_dir / "mesh_000.obj").read_text().splitlines()
    assert sum(ln.startswith("v ") for ln in obj) == 48 * 96
    assert sum(ln.startswith("f ") for ln in obj) == 2 * 96 * 47
    want = ckpt[1].g_ema if with_ckpt else GeneratorWithMap(
        SIZE, LATENT, N_MLP, channel_multiplier=1, device="cpu", seed=0)
    assert len(seen) == 1 and _same_weights(seen[0], want)


def test_cli_generate_with_ckpt(tmp_path, monkeypatch, ckpt):
    """``cli.generate --with_map --ckpt`` renders with the checkpoint's
    G-EMA loaded into its generator; ``load_generator_weights`` falls back
    to G and refuses a checkpoint with neither."""
    import stylerenderer_tpu_torch.utils.checkpoint as checkpoint
    from stylerenderer_tpu_torch.cli import generate

    seen = _record(monkeypatch, checkpoint, "load_generator_weights", arg=1)
    out = tmp_path / "ema"
    generate.main(["--with_map", "--sample", "2", "--ckpt", ckpt[0], "--out", str(out)]
                  + TINY_ARGS)
    assert (out / "000000.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert len(seen) == 1 and _same_weights(seen[0], ckpt[1].g_ema)

    gen = GeneratorWithMap(SIZE, LATENT, N_MLP, channel_multiplier=1, device="cpu", seed=8)
    only_g = tmp_path / "only_g"
    only_g.mkdir()
    torch.save({"g": ckpt[1].g.state_dict(), "args": _cfg_dict()}, only_g / "000001.pt")
    checkpoint.load_generator_weights(str(only_g), gen)
    assert _same_weights(gen, ckpt[1].g)
    torch.save({"args": _cfg_dict()}, only_g / "000002.pt")
    with pytest.raises(KeyError, match="neither"):
        checkpoint.load_generator_weights(str(only_g), gen)


def _cfg_dict():
    from stylerenderer_tpu_torch.utils.config import TrainConfig

    return TrainConfig(size=SIZE, latent=LATENT, n_mlp=N_MLP, channel_multiplier=1).to_dict()


@pytest.mark.parametrize("flag", [["--bfm", "x"]])
def test_cli_project_refuses_unported(tmp_path, capsys, flag):
    from stylerenderer_tpu_torch.cli import project as cli

    with pytest.raises(SystemExit):
        cli.main([str(tmp_path / "a.png")] + TINY_ARGS + flag)
    assert cli.NOT_PORTED[flag[0][2:]] in capsys.readouterr().err


@pytest.mark.parametrize("vgg_weights", [False, True])
def test_cli_project_with_lpips(tmp_path, monkeypatch, vgg_weights):
    """``cli.project --w_lpips 0.8`` fits with the port's VGG LPIPS in the
    loss: random, or with ``--vgg_weights`` a torchvision state dict's
    backbone loaded into it."""
    import stylerenderer_tpu_torch.inversion as inversion
    from stylerenderer_tpu_torch.cli import project as cli

    seen = []
    make = inversion.make_projector_jit

    def record(*a, **k):
        seen.append(k["lpips"])
        return make(*a, **k)

    monkeypatch.setattr(inversion, "make_projector_jit", record)
    argv = [_photo(str(tmp_path / "a.png")), "--iters", "2", "--w_lpips", "0.8",
            "--out", str(tmp_path / "out")] + TINY_ARGS
    backbone = LPIPS("vgg").features
    if vgg_weights:
        torch.save({f"features.{k}": v for k, v in backbone.state_dict().items()},
                   str(tmp_path / "vgg16.pth"))
        argv += ["--vgg_weights", str(tmp_path / "vgg16.pth")]
    cli.main(argv)
    hist = np.load(tmp_path / "out" / "fit.npz")["loss_history"]
    assert hist.shape == (2,) and np.isfinite(hist).all()
    assert len(seen) == 1 and isinstance(seen[0], LPIPS) and seen[0].net == "vgg"
    w = seen[0].features[0].weight
    assert torch.equal(w, backbone[0].weight) == vgg_weights

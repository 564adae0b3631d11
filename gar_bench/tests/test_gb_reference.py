"""The plain reference against the port at tiny sizes on the CPU: the
geometry, every pyramid level's winners and values (the port's dense
oracle, which its kernels equal bit for bit), the GAR's image, and the
first steps of the inversion."""

import pytest
import torch

from gar_bench import inputs, spec
from gar_bench.common import load_weights
from gar_bench.reference import gar, geometry, invert, raster
from gar_bench.tests.tiny import shrink


def _posed(seed, B=2, mesh=None):
    cfg = shrink(spec.config("gar1024"))
    m = mesh or cfg["mesh"]
    face, tri = inputs.face_model(m, seed, "cpu")
    d = inputs.render_draws(seed, 0, B, cfg, spec.traffic("render.b16"), face, "cpu")
    return face, tri, d


def test_geometry_equals_the_port():
    from stylerenderer_tpu_torch.face3d import LinearMorphableModel
    from stylerenderer_tpu_torch.face3d.geometry import apply_pose3D, mesh_point_normal
    from stylerenderer_tpu_torch.face3d.transforms import rodrigues

    face, tri, d = _posed(3)
    model = LinearMorphableModel(face["basis"], face["mean"], face["sigma"], 4, 3)
    v_port = apply_pose3D(model(d["x"]), d["pose"])
    v_ref = geometry.euler_pose(geometry.morph(d["x"], face["basis"], face["mean"]), d["pose"])
    torch.testing.assert_close(v_ref, v_port, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(geometry.normals(v_ref, tri), mesh_point_normal(v_ref, tri),
                               rtol=1e-6, atol=1e-6)
    r = torch.randn(4, 3) * torch.tensor([[1.0], [1e-9], [0.0], [2.0]])
    torch.testing.assert_close(geometry.rodrigues(r), rodrigues(r), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pyramid_equals_the_ports_oracle(seed):
    from stylerenderer_tpu_torch.ops.rasterize import rasterize, rasterize_winners

    mesh = dict(shrink(spec.config("gar1024"))["mesh"], nu=20, nv=24)
    face, tri, d = _posed(seed, mesh=mesh)
    v = geometry.euler_pose(geometry.morph(d["x"], face["basis"], face["mean"]), d["pose"])
    n = geometry.normals(v, tri)
    for s in (4, 8, 16, 32, 64):
        win = raster.winners(v, tri, s)
        assert torch.equal(win, rasterize_winners(v, tri, s, s).long())
        torch.testing.assert_close(raster.interpolate(v, n, tri, win, s),
                                   rasterize(v, n, tri, s, s, method="dense"),
                                   rtol=0, atol=1e-6)


def test_pyramid_ties_nan_and_degenerate_triangles():
    from stylerenderer_tpu_torch.ops.rasterize import rasterize_winners

    v = torch.tensor([[[-0.9, -0.9, 0.0], [0.9, -0.9, 0.0], [0.0, 0.9, 0.0],
                       [-0.5, 0.0, 0.1], [0.5, 0.0, 0.1], [0.0, 0.0, 0.1],
                       [0.2, 0.2, float("nan")], [0.3, 0.2, 0.5], [0.2, 0.3, 0.5]]])
    tri = torch.tensor([[0, 1, 2], [2, 1, 0], [0, 1, 2], [3, 4, 5], [6, 7, 8], [0, 0, 2],
                        [1, 1, 1], [0, 9, 1]])
    for s in (8, 16):
        assert torch.equal(raster.winners(v, tri, s), rasterize_winners(v, tri, s, s).long())


def test_gar_image_equals_the_port():
    from stylerenderer_tpu_torch.models import GeneratorWithMap

    cfg = shrink(spec.config("gar256"))
    P = inputs.weights(cfg, 4, "cpu")
    gen = GeneratorWithMap(cfg["size"], cfg["style_dim"], cfg["n_mlp"], device="cpu").eval()
    load_weights(gen, P)
    face, tri, d = _posed(4)
    v = geometry.euler_pose(geometry.morph(d["x"], face["basis"], face["mean"]), d["pose"])
    n = geometry.normals(v, tri)
    with torch.no_grad():
        img, _, maps = gen([d["z"]], (v, n, tri), return_normals=True, noise=d["noise"])
        w = gar.mapping(P, d["z"], cfg)
        latent = w[:, None].expand(2, gar.n_latent(cfg["size"]), w.shape[1])
        ref = gar.synthesis(P, latent, maps, d["noise"], cfg)
    torch.testing.assert_close(ref, img, rtol=1e-4, atol=1e-4 * float(ref.abs().max()))


def test_inversion_steps_equal_the_port():
    from stylerenderer_tpu_torch.face3d import LinearMorphableModel
    from stylerenderer_tpu_torch.inversion import ProjectorConfig, make_projector
    from stylerenderer_tpu_torch.models import GeneratorWithMap

    cfg = shrink(spec.config("gar256"))
    pc = spec.traffic("invert.b32")["projector"]
    P = inputs.weights(cfg, 6, "cpu")
    gen = GeneratorWithMap(cfg["size"], cfg["style_dim"], cfg["n_mlp"], device="cpu")
    load_weights(gen, P)
    face, tri = inputs.face_model(cfg["mesh"], 6, "cpu")
    model = LinearMorphableModel(face["basis"], face["mean"], face["sigma"], 4, 3)
    target = inputs.targets(6, 2, cfg["size"], 8, "cpu")
    project = make_projector(gen, model, tri, ProjectorConfig(w_lpips=0.0))
    mean_w = gar.mapping(P, torch.randn(16, cfg["style_dim"]), cfg).mean(0, keepdim=True)
    out = project(0, target, n_steps=3, mean_latent=mean_w)
    p0 = invert.init_params(mean_w, 2, cfg, 7)
    losses, _, p3 = invert.steps(P, p0, target, face, tri, cfg, pc, 3)
    assert max(abs(a - b) / b for a, b in zip(out["loss_history"].tolist(), losses)) < 1e-5
    torch.testing.assert_close(p3["w"], out["w_plus"], rtol=0, atol=1e-5)
    torch.testing.assert_close(p3["rvec"], out["rvec"], rtol=0, atol=1e-5)

"""The port's Hopper kernels on the card, bit for bit against their plain
versions (marker ``gpu``; each test skips when no CUDA card is present).

This file imports no JAX, so it also runs on a machine without it; there
``-o markers=`` registers the marker that ``tests/conftest.py`` registers
otherwise:

    python -m pytest --noconftest -o 'markers=gpu: needs a CUDA card' -m gpu \
        tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from torch_meshes import (
    KERNEL_CASES, NAN_DEPTH_PIXELS_16, SINGLE_CASES, kernel_case, keys_of_bins, single_case,
)

import stylerenderer_tpu_torch.ops.rasterize_multi as rasterize_multi_mod
import stylerenderer_tpu_torch.ops.rasterize_single as rasterize_single_mod

from stylerenderer_tpu_torch.face3d import (
    mesh_point_normal, random_apply_pose3D, synthetic_face,
)
from stylerenderer_tpu_torch.ops.rasterize import rasterize, rasterize_pyramid_fused
from stylerenderer_tpu_torch.ops.rasterize_multi import (
    build_bins_multi,
    launch_bin_multi,
    rasterize_winners_multi,
    rasterize_winners_multi_ref,
)
from stylerenderer_tpu_torch.ops.rasterize_single import (
    build_bins,
    launch_bin_single,
    rasterize_winners_single,
    rasterize_winners_single_ref,
)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("with_attrs", [False, True])
@pytest.mark.parametrize("case", sorted(KERNEL_CASES))
def test_cuda_kernel_bitexact(cuda, case, with_attrs):
    v, tri, attrs, top, n_levels, tile, persp = kernel_case(case)
    v, tri = torch.from_numpy(v).to(cuda), torch.from_numpy(tri).to(cuda)
    attrs = torch.from_numpy(attrs).to(cuda) if with_attrs else None
    before = rasterize_winners_multi.launches
    out = rasterize_winners_multi(v, tri, top, n_levels, persp, attrs=attrs, tile=tile)
    torch.cuda.synchronize()
    assert rasterize_winners_multi.launches == before + 1
    ref = rasterize_winners_multi_ref(v, tri, top, n_levels, persp, attrs=attrs, tile=tile)
    for k, (a, b) in enumerate(zip(out, ref)):
        if with_attrs:
            np.testing.assert_array_equal(a[1].cpu().numpy(), b[1].cpu().numpy(),
                                          err_msg=f"win {k}")
            np.testing.assert_array_equal(a[0].cpu().numpy(), b[0].cpu().numpy(),
                                          err_msg=f"val {k}")
        else:
            np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy(), err_msg=f"win {k}")


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(KERNEL_CASES))
def test_cuda_binning_matches_plain(cuda, case):
    """The card's binning passes: the plain binning's keys and starts, the
    same ids in every segment, and each id's slot."""
    v, tri, attrs, top, n_levels, tile, persp = kernel_case(case)
    v, tri, attrs = (torch.from_numpy(x).to(cuda) for x in (v, tri, attrs))
    rows, starts, slots, keys = launch_bin_multi(v, tri, top, n_levels, persp, 1e-6, tile, attrs)
    dat, ids, pstarts = build_bins_multi(v, tri, top, n_levels, persp, 1e-6, tile, attrs)
    pstarts, ids = pstarts.cpu().numpy(), ids.cpu().numpy()
    np.testing.assert_array_equal(starts.cpu().numpy(), pstarts)
    np.testing.assert_array_equal(keys.cpu().numpy(), keys_of_bins(ids, pstarts))
    rid = rows[..., dat.shape[-1]].contiguous().view(torch.int32).cpu().numpy()
    slots = slots.cpu().numpy()
    for b in range(rows.shape[0]):
        for lo, hi in zip(pstarts[b, :-1], pstarts[b, 1:]):
            assert set(rid[b, lo:hi]) == set(ids[b, lo:hi])
        n = pstarts[b, -1]
        np.testing.assert_array_equal(slots[b, rid[b, :n]], np.arange(n))


@pytest.mark.gpu
def test_cuda_call_never_takes_plain_binning(cuda, monkeypatch):
    """A CUDA call bins on the card: the plain binning and the plain
    version are never reached, even when patched to fail."""
    def refuse(*args, **kwargs):
        raise AssertionError("the CUDA path reached a plain version")

    v, tri, attrs, top, n_levels, tile, persp = kernel_case("random")
    v, tri, attrs = (torch.from_numpy(x).to(cuda) for x in (v, tri, attrs))
    ref = rasterize_winners_multi_ref(v, tri, top, n_levels, persp, attrs=attrs, tile=tile)
    monkeypatch.setattr(rasterize_multi_mod, "build_bins_multi", refuse)
    monkeypatch.setattr(rasterize_multi_mod, "rasterize_winners_multi_ref", refuse)
    out = rasterize_winners_multi(v, tri, top, n_levels, persp, attrs=attrs, tile=tile)
    for (a, wa), (b, wb) in zip(out, ref):
        assert torch.equal(wa, wb) and torch.equal(a, b)


@pytest.mark.gpu
def test_cuda_fused_pyramid_gradients_match_cpu(cuda):
    """The fused pyramid's forward through the kernel and its backward
    through the coefficient recompute, on the card against the CPU."""
    v, tri, attrs, *_ = kernel_case("random")
    sizes = [2, 4, 8, 16, 32]
    w = [torch.from_numpy(np.random.RandomState(i).randn(2, s, s, 3).astype(np.float32))
         for i, s in enumerate(sizes)]
    grads = []
    for dev in ("cpu", cuda):
        vt = torch.from_numpy(v).to(dev).requires_grad_(True)
        tt = torch.from_numpy(attrs).to(dev).requires_grad_(True)
        maps = rasterize_pyramid_fused(vt, tt, torch.from_numpy(tri).to(dev), sizes)
        sum((m * wi.to(dev)).sum() for m, wi in zip(maps, w)).backward()
        grads.append((vt.grad.cpu(), tt.grad.cpu()))
    torch.testing.assert_close(grads[1][0], grads[0][0], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(grads[1][1], grads[0][1], rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(SINGLE_CASES))
def test_cuda_single_kernel_bitexact(cuda, case):
    """The single-level kernel at every tile the card path may take (8, 16
    and 32) and the case's own: rectangular images, edge tiles that stick
    out, perspective, degenerate and XL triangles, corners on tile edges,
    -0/+0 ties, many rounds in one tile, clips of up to 1,024 px."""
    v, tri, h, w, tile, persp = single_case(case)
    v, tri = torch.from_numpy(v).to(cuda), torch.from_numpy(tri).to(cuda)
    ref = rasterize_winners_single_ref(v, tri, h, w, persp).cpu().numpy()
    for t in sorted({tile, 8, 16, 32}):
        before = rasterize_winners_single.launches
        out = rasterize_winners_single(v, tri, h, w, persp, tile=t)
        torch.cuda.synchronize()
        assert rasterize_winners_single.launches == before + 1
        np.testing.assert_array_equal(out.cpu().numpy(), ref, err_msg=f"tile {t}")


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(SINGLE_CASES))
def test_cuda_single_binning_matches_plain(cuda, case):
    """The card's single-level binning: the plain binning's keys and starts
    and the same ids in every segment, at every tile."""
    v, tri, h, w, tile, persp = single_case(case)
    v, tri = torch.from_numpy(v).to(cuda), torch.from_numpy(tri).to(cuda)
    for t in sorted({tile, 8, 16, 32}):
        rows, starts, keys = launch_bin_single(v, tri, h, w, persp, 1e-6, t)
        _, ids, pstarts = build_bins(v, tri, h, w, persp, 1e-6, t)
        pstarts, ids = pstarts.cpu().numpy(), ids.cpu().numpy()
        np.testing.assert_array_equal(starts.cpu().numpy(), pstarts, err_msg=f"tile {t}")
        np.testing.assert_array_equal(keys.cpu().numpy(), keys_of_bins(ids, pstarts),
                                      err_msg=f"tile {t}")
        rid = rows[..., 9].contiguous().view(torch.int32).cpu().numpy()
        for b in range(rows.shape[0]):
            for lo, hi in zip(pstarts[b, :-1], pstarts[b, 1:]):
                assert set(rid[b, lo:hi]) == set(ids[b, lo:hi])


@pytest.mark.gpu
def test_cuda_single_call_never_takes_plain_binning(cuda, monkeypatch):
    """A CUDA call of the single-level kernel bins on the card: the plain
    binning and the plain version are never reached, even when patched to
    fail."""
    def refuse(*args, **kwargs):
        raise AssertionError("the CUDA path reached a plain version")

    v, tri, h, w, tile, persp = single_case("rect_40x24")
    v, tri = torch.from_numpy(v).to(cuda), torch.from_numpy(tri).to(cuda)
    ref = rasterize_winners_single_ref(v, tri, h, w, persp)
    monkeypatch.setattr(rasterize_single_mod, "build_bins", refuse)
    monkeypatch.setattr(rasterize_single_mod, "rasterize_winners_single_ref", refuse)
    out = rasterize_winners_single(v, tri, h, w, persp)
    assert torch.equal(out, ref)
    out = rasterize(v, torch.ones_like(v), tri, h, w, persp, method="pallas")
    assert out.shape == (v.shape[0], h, w, 3)


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(KERNEL_CASES))
def test_cuda_multi_one_level_bitexact(cuda, case):
    """The multi-level kernel at one level (the fused top of the
    ``downsample`` pyramid): winners and values."""
    v, tri, attrs, top, _, tile, persp = kernel_case(case)
    v, tri, attrs = (torch.from_numpy(x).to(cuda) for x in (v, tri, attrs))
    (val, win), = rasterize_winners_multi(v, tri, top, 1, persp, attrs=attrs, tile=tile)
    (rval, rwin), = rasterize_winners_multi_ref(v, tri, top, 1, persp, attrs=attrs, tile=tile)
    np.testing.assert_array_equal(win.cpu().numpy(), rwin.cpu().numpy())
    np.testing.assert_array_equal(val.cpu().numpy(), rval.cpu().numpy())


@pytest.mark.gpu
def test_cuda_rasterize_production_size_takes_single_kernel(cuda):
    """``rasterize`` at ``nf*h*w > 2^24`` launches the single-level kernel
    once and neither the dense search nor the multi-level kernel; its
    values equal the dense method's."""
    face, tri = synthetic_face(48, 96, 80, 29, device=cuda)
    g = torch.Generator().manual_seed(0)
    vert = random_apply_pose3D(g, face(face.random_input(2, g)))
    norm = mesh_point_normal(vert, tri)
    single, multi = rasterize_winners_single.launches, rasterize_winners_multi.launches
    out = rasterize(vert, norm, tri, 256, 192)
    torch.cuda.synchronize()
    assert rasterize_winners_single.launches == single + 1
    assert rasterize_winners_multi.launches == multi
    ref = rasterize(vert, norm, tri, 256, 192, method="dense")
    np.testing.assert_array_equal(out.cpu().numpy(), ref.cpu().numpy())


def _to(obj, device):
    """A step's draws (dataclasses, lists, tensors) moved to ``device``."""
    import dataclasses

    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, list):
        return [_to(x, device) for x in obj]
    if dataclasses.is_dataclass(obj):
        return type(obj)(**{f.name: _to(getattr(obj, f.name), device)
                            for f in dataclasses.fields(obj)})
    return obj


@pytest.mark.gpu
def test_cuda_train_step_matches_cpu(cuda, monkeypatch):
    """One train step (R1 and path both fire; K1 renders the pyramids) at
    the same weights and draws on the card and on the CPU, TF32 off. The
    card's step runs first and records each update's gradients and the
    parameters it produced; the CPU's step then takes those parameters at
    each update instead of its own Adam step (Adam's first step is about
    ``lr * sign(g)``, which would turn rounding into parameter differences
    of ``lr``), so every loss and gradient is taken at the same parameters:
    metrics to 1e-4, each update's gradients to 1e-3 of each tensor's
    largest magnitude. K1 launches three times on the card."""
    import stylerenderer_tpu_torch.train.step as step_mod
    from stylerenderer_tpu_torch.train import init_train_state, sample_draws, train_step
    from stylerenderer_tpu_torch.utils.config import TrainConfig

    cfg = TrainConfig(size=16, latent=32, n_mlp=2, channel_multiplier=1, batch=4,
                      d_reg_every=2, g_reg_every=2)
    face, tri = synthetic_face(12, 24, 4, 2, device="cpu")
    face_card = synthetic_face(12, 24, 4, 2, device=cuda)[0]
    states = {"cpu": init_train_state(cfg, "cpu", seed=1), "cuda": init_train_state(cfg, cuda)}
    for name in ("g", "d", "g_ema"):
        getattr(states["cuda"], name).load_state_dict(getattr(states["cpu"], name).state_dict())
    draws = sample_draws(torch.Generator().manual_seed(2), cfg, face, 4, states["cpu"].g.n_latent)
    real = torch.rand(4, 3, 16, 16, generator=torch.Generator().manual_seed(3)) * 2 - 1
    adam = step_mod._adam_step
    card, cpu = [], []

    def on_card(opt, params, grads):
        adam(opt, params, grads)
        card.append(([g.detach().to("cpu", copy=True) for g in grads],
                     [p.detach().to("cpu", copy=True) for p in params]))

    def on_cpu(opt, params, grads):
        cpu.append([g.detach().clone() for g in grads])
        with torch.no_grad():
            for p, q in zip(params, card[len(cpu) - 1][1]):
                p.copy_(q)

    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        monkeypatch.setattr(step_mod, "_adam_step", on_card)
        before = rasterize_winners_multi.launches
        m_card = train_step(states["cuda"], real.to(cuda), _to(draws, cuda), cfg, face_card,
                            tri.to(cuda))
        assert rasterize_winners_multi.launches == before + 3
        monkeypatch.setattr(step_mod, "_adam_step", on_cpu)
        m_cpu = train_step(states["cpu"], real, draws, cfg, face, tri)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    for k, v in m_cpu.items():
        np.testing.assert_allclose(float(m_card[k]), float(v), rtol=1e-4, atol=1e-6, err_msg=k)
    assert len(card) == len(cpu) == 4
    for u, ((gg, _), gc) in enumerate(zip(card, cpu)):
        for i, (a, b) in enumerate(zip(gg, gc)):
            err, scale = float((a - b).abs().max()), float(b.abs().max())
            assert err <= 1e-3 * max(scale, 1e-30), (u, i, err, scale)


@pytest.mark.gpu
def test_cuda_finite_screen(cuda):
    """The screen's max-abs norms see a NaN or an infinity anywhere on the
    card."""
    from stylerenderer_tpu_torch.train.step import all_finite

    ts = [torch.randn(1000, device=cuda), torch.randn(3, 7, device=cuda)]
    assert all_finite([torch.tensor(1.0, device=cuda)], ts)
    for bad in (float("nan"), float("inf"), -float("inf")):
        t = ts[0].clone()
        t[517] = bad
        assert not all_finite([], [ts[1], t])
        assert not all_finite([torch.tensor(bad, device=cuda)], ts)


@pytest.mark.gpu
def test_cuda_discriminator_r1_finite_at_256(cuda):
    """R1 through the 256 px Discriminator (channel multiplier 2) at B=4:
    a finite penalty and finite gradients in every parameter."""
    from stylerenderer_tpu_torch.models import Discriminator
    from stylerenderer_tpu_torch.train import r1_penalty

    d = Discriminator(256, 2, device=cuda)
    real = torch.rand(4, 3, 256, 256, generator=torch.Generator().manual_seed(0)) * 2 - 1
    r1 = r1_penalty(d, real.to(cuda))
    grads = torch.autograd.grad(r1, list(d.parameters()), allow_unused=True,
                                materialize_grads=True)
    assert torch.isfinite(r1) and float(r1.detach()) > 0
    assert all(bool(torch.isfinite(g).all()) for g in grads)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["nan_depth", "nan_depth_chunks"])
def test_cuda_nan_depth_blanks_pixels(cuda, case):
    """A covered NaN depth gives -1 and the background value at its pixels
    in K1 (every level) and K2, as in the plain versions; elsewhere the
    finite triangle in front wins."""
    v, tri, attrs, top, n_levels, tile, _ = kernel_case(case)
    v, tri, attrs = (torch.from_numpy(x).to(cuda) for x in (v, tri, attrs))
    out = rasterize_winners_multi(v, tri, top, n_levels, attrs=attrs, tile=tile)
    ref = rasterize_winners_multi_ref(v, tri, top, n_levels, attrs=attrs, tile=tile)
    for (a, wa), (b, wb) in zip(out, ref):
        assert torch.equal(wa, wb) and torch.equal(a, b)
    win2 = rasterize_winners_single(v, tri, top, top)
    assert torch.equal(win2, rasterize_winners_single_ref(v, tri, top, top))
    idx = tuple(torch.tensor(NAN_DEPTH_PIXELS_16).T)
    for win, val in ((out[0][1], out[0][0]), (win2, None)):
        assert (win[idx] == -1).all()
        assert (win >= 0).sum() > 100
        if val is not None:
            assert (val[idx] == 0).all()


def _projector_inputs(device):
    from stylerenderer_tpu_torch.models import GeneratorWithMap

    gen = GeneratorWithMap(16, 32, 2, channel_multiplier=1, device="cpu", seed=4)
    with torch.no_grad():
        for i, p in enumerate(gen.parameters()):
            p.add_(torch.randn(p.shape, generator=torch.Generator().manual_seed(i)) * 0.2)
    mean_w = gen.mean_latent(4096, torch.Generator().manual_seed(0))
    rs = np.random.RandomState(0)
    p = {"w": mean_w[:, None].repeat(2, gen.n_latent, 1)
         + torch.from_numpy(rs.randn(2, gen.n_latent, 32).astype(np.float32)) * 0.1}
    for k, n in (("x", 6), ("rvec", 3), ("tvec", 3), ("log_scale", 1)):
        p[k] = torch.from_numpy(rs.randn(2, n).astype(np.float32)) * 0.1
    target = torch.from_numpy(rs.uniform(-1, 1, (2, 3, 16, 16)).astype(np.float32))
    lmk = torch.from_numpy(rs.uniform(0, 16, (2, 4, 2)).astype(np.float32))
    return gen.to(device), mean_w.to(device), p, target.to(device), lmk.to(device)


@pytest.mark.gpu
def test_cuda_projector_step_matches_cpu(cuda):
    """One projector step at the small size, every loss term on and the
    geometry clip triggering, on the card and on the CPU from the same
    parameters, TF32 off: the loss to 1e-5 relative, each variable's
    gradient (the first moment of an Adam started at zero, over 1 - b1) to
    1e-4 of its largest magnitude. K1 launches twice: the step and the
    final render."""
    from stylerenderer_tpu_torch.inversion import ProjectorConfig, make_projector

    cfg = ProjectorConfig(iters=1, w_pixel_l1=0.5, w_lpips=0.3, w_lmk=1e-2, w_prior=1e-3,
                          w_pose=0.1, w_reg_w=0.2, geo_grad_clip=1e-3)
    res = {}
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for dev in ("cpu", cuda):
            gen, mean_w, p, target, lmk = _projector_inputs(dev)
            face, tri = synthetic_face(8, 16, 4, 2, device=dev)
            project = make_projector(gen, face, tri, cfg, lmk_vidx=[0, 5, 17, 33],
                                     lpips_fn=lambda a, b: (a - b).abs().mean(dim=(1, 2, 3)))
            # an Adam state at zero: resumed, Adam takes its first step
            zopt = project(0, target, lmk, n_steps=1, return_state=True)["state"][1]
            for st in zopt["state"].values():
                for v in st.values():
                    v.zero_()
            before = rasterize_winners_multi.launches
            out = project(0, target, lmk, state=(p, zopt), n_steps=1, return_state=True,
                          mean_latent=mean_w)
            launched = rasterize_winners_multi.launches - before
            st = out["state"][1]["state"]
            res[str(dev)] = (float(out["loss_history"][0]), launched,
                             [st[i]["exp_avg"].cpu() / 0.1 for i in range(5)])
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    (l_cpu, n_cpu, g_cpu), (l_card, n_card, g_card) = res["cpu"], res["cuda"]
    assert (n_cpu, n_card) == (0, 2)
    np.testing.assert_allclose(l_card, l_cpu, rtol=1e-5)
    for i, (a, b) in enumerate(zip(g_card, g_cpu)):
        scale = float(b.abs().max())
        assert scale > 0 and float((a - b).abs().max()) <= 1e-4 * scale, i
    geo = torch.sqrt(sum((g.double() ** 2).sum() for g in g_card[1:]))
    np.testing.assert_allclose(float(geo), 1e-3, rtol=1e-4)


@pytest.mark.gpu
def test_cuda_cli_project(cuda, tmp_path):
    """``cli.project`` on the card at a small size: its outputs, a finite
    and falling loss, and K1 launched once per step and once for the final
    render of each of its two segments."""
    from PIL import Image

    from stylerenderer_tpu_torch.cli import project as cli

    photo = str(tmp_path / "a.png")
    Image.fromarray((np.random.RandomState(4).rand(24, 24, 3) * 255).astype(np.uint8)).save(photo)
    before = rasterize_winners_multi.launches
    cli.main([photo, "--size", "16", "--latent", "32", "--n_mlp", "2",
              "--channel_multiplier", "1", "--iters", "4", "--segments", "2",
              "--out", str(tmp_path / "out")])
    assert rasterize_winners_multi.launches - before == 4 + 2
    assert sorted(p.name for p in (tmp_path / "out").iterdir()) == [
        "fit.npz", "mesh_000.obj", "render.png", "target.png"]
    hist = np.load(tmp_path / "out" / "fit.npz")["loss_history"]
    assert hist.shape == (4,) and np.isfinite(hist).all() and hist[-1] < hist[0]


def _tf32_off():
    """Turn TF32 off; returns the flags to restore."""
    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    return flags


def _restore_tf32(flags):
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags


@pytest.mark.gpu
@pytest.mark.parametrize("net", ["generator", "inception", "lpips"])
def test_cuda_eval_nets_match_cpu(cuda, net):
    """The unconditioned Generator (16 px, explicit noise; to 1e-4), the FID
    InceptionV3's pool3 (64 px resized to 299, random-feature mode; to 1e-3
    of its largest magnitude) and LPIPS VGG16 (64 px; to 1e-4 relative) on
    the card equal their CPU results, TF32 off."""
    from stylerenderer_tpu_torch.eval import load_lpips, load_patched_inception_v3
    from stylerenderer_tpu_torch.models import Generator, make_noise

    g = torch.Generator().manual_seed(0)
    flags = _tf32_off()
    try:
        res = {}
        for dev in ("cpu", cuda):
            if net == "generator":
                m = Generator(16, 32, 2, channel_multiplier=1, seed=3, device=dev).eval()
                g.manual_seed(0)
                z = torch.randn(2, 32, generator=g)
                noise = make_noise(16, 2, g)
                with torch.no_grad():
                    out = m([z.to(dev)], noise=[n.to(dev) for n in noise])[0]
            elif net == "inception":
                m = load_patched_inception_v3(device=dev)
                g.manual_seed(0)
                x = torch.rand(2, 3, 64, 64, generator=g) * 2 - 1
                with torch.no_grad():
                    out = m(x.to(dev))
            else:
                m = load_lpips("vgg", device=dev)
                g.manual_seed(0)
                a, b = (torch.rand(2, 3, 64, 64, generator=g) * 2 - 1 for _ in range(2))
                with torch.no_grad():
                    out = m(a.to(dev), b.to(dev))
            res[str(dev)] = out.cpu()
    finally:
        _restore_tf32(flags)
    card, cpu = res["cuda"], res["cpu"]
    assert torch.isfinite(card).all()
    if net == "generator":
        torch.testing.assert_close(card, cpu, rtol=1e-4, atol=1e-4)
    elif net == "inception":
        assert float((card - cpu).abs().max()) <= 1e-3 * float(cpu.abs().max())
    else:
        torch.testing.assert_close(card, cpu, rtol=1e-4, atol=0)


@pytest.mark.gpu
def test_cuda_lpips_gradient_finite_on_flat_render(cuda):
    """LPIPS' gradient through a flat render (one colour) is finite on the
    card and equals the CPU's to 1e-4 of its largest magnitude, TF32 off."""
    from stylerenderer_tpu_torch.eval import load_lpips

    target = torch.rand(2, 3, 64, 64, generator=torch.Generator().manual_seed(1)) * 2 - 1
    flags = _tf32_off()
    try:
        grads = {}
        for dev in ("cpu", cuda):
            lp = load_lpips("vgg", device=dev)
            x = torch.full((2, 3, 64, 64), -0.6, device=dev, requires_grad=True)
            (gx,) = torch.autograd.grad(lp(x, target.to(dev)).sum(), x)
            grads[str(dev)] = gx.cpu()
    finally:
        _restore_tf32(flags)
    assert torch.isfinite(grads["cuda"]).all()
    scale = float(grads["cpu"].abs().max())
    assert scale > 0 and float((grads["cuda"] - grads["cpu"]).abs().max()) <= 1e-4 * scale


@pytest.mark.gpu
def test_cuda_fid_batch_k1_bitexact(cuda):
    """K1 on a ``cli.fid --with_map`` batch's posed mesh (the sampler's own
    draws, B=8): winners and values bit-equal to the plain version at all 7
    levels, in one launch."""
    from stylerenderer_tpu_torch.cli.fid import make_sampler
    from stylerenderer_tpu_torch.models import GeneratorWithMap

    face, tri = synthetic_face(48, 96, 80, 29, device=cuda)
    seen = []

    class Recorder(GeneratorWithMap):
        def normal_pyramid(self, mesh):
            seen.append(mesh)
            return super().normal_pyramid(mesh)

    gen = Recorder(256, 64, 1, channel_multiplier=1, device=cuda).eval()
    before = rasterize_winners_multi.launches
    with torch.no_grad():
        img = make_sampler(gen, (face, tri))(torch.Generator().manual_seed(0), 8)
    torch.cuda.synchronize()
    assert rasterize_winners_multi.launches == before + 1
    assert img.shape == (8, 3, 256, 256) and torch.isfinite(img).all()
    vert, norm, _ = seen[0]
    out = rasterize_winners_multi(vert, tri, 256, 7, attrs=norm)
    ref = rasterize_winners_multi_ref(vert, tri, 256, 7, attrs=norm)
    for k, ((va, wa), (vb, wb)) in enumerate(zip(out, ref)):
        assert torch.equal(wa, wb), f"winners, level {k}"
        assert torch.equal(va, vb), f"values, level {k}"


@pytest.mark.gpu
@pytest.mark.parametrize("net", ["resnet_unet", "pfld", "facenet", "regressor"])
def test_cuda_regressor_and_supervisors_match_cpu(cuda, net):
    """The supervisor nets (``ResNetUNet`` at 64 px, ``PFLDInference`` at
    112, ``InceptionResnetV1`` at 160, fixed-seed stand-ins) and the
    ``Regressor(32, 64, 2)`` (its forward and one ``regressor_step``'s
    loss) on the card equal their CPU results to 1e-4 of the largest
    output, TF32 off."""
    from stylerenderer_tpu_torch.models import Regressor
    from stylerenderer_tpu_torch.supervisors import (
        InceptionResnetV1, PFLDInference, ResNetUNet, random_stand_in_,
    )
    from stylerenderer_tpu_torch.train import init_regressor_state, regressor_step

    nets = {"resnet_unet": (ResNetUNet, 64), "pfld": (PFLDInference, 112),
            "facenet": (InceptionResnetV1, 160)}
    g = torch.Generator().manual_seed(0)
    flags = _tf32_off()
    try:
        res = {}
        for dev in ("cpu", cuda):
            g.manual_seed(0)
            if net == "regressor":
                m = Regressor(32, 64, 2, channel_multiplier=1, seed=1, device=dev)
                x = torch.rand(2, 3, 32, 32, generator=g) * 2 - 1
                w = torch.randn(2, 64, generator=g)
                with torch.no_grad():
                    out = m(x.to(dev))
                loss = regressor_step(init_regressor_state(m), x.to(dev), w.to(dev))
                out = torch.cat([out.flatten(), loss["regressor_loss"].reshape(1)])
            else:
                cls, size = nets[net]
                m = random_stand_in_(cls(), torch.Generator().manual_seed(1)).eval().to(dev)
                x = torch.rand(2, 3, size, size, generator=g) * 2 - 1
                with torch.no_grad():
                    out = m(x.to(dev))
                out = out[1] if net == "resnet_unet" else out
            res[str(dev)] = out.cpu()
    finally:
        _restore_tf32(flags)
    card, cpu = res["cuda"], res["cpu"]
    assert torch.isfinite(card).all()
    assert float((card - cpu).abs().max()) <= 1e-4 * float(cpu.abs().max())


@pytest.mark.gpu
def test_cuda_train_step_with_heads(cuda):
    """A train step at 32 px, B=4, with ``sfs``, ``lmk`` and ``feat`` on
    the card: finite terms, K1 launched twice (the D and G steps' meshes),
    the heads' nets frozen."""
    from stylerenderer_tpu_torch.supervisors import make_extra_heads
    from stylerenderer_tpu_torch.train import init_train_state, sample_draws, train_step
    from stylerenderer_tpu_torch.utils.config import TrainConfig

    cfg = TrainConfig(size=32, latent=32, n_mlp=2, channel_multiplier=1, batch=4,
                      d_reg_every=16, g_reg_every=4)
    face, tri = synthetic_face(12, 24, 4, 2, device=cuda)
    st = init_train_state(cfg, cuda, seed=0)
    st.step = 1
    heads = make_extra_heads(1, sfs=True, lmk=True, feat=True, image_size=32, device=cuda)
    real = torch.rand(4, 3, 32, 32, device=cuda) * 2 - 1
    before = rasterize_winners_multi.launches
    m = train_step(st, real, sample_draws(st.generator, cfg, face, 4, st.g.n_latent, heads),
                   cfg, face, tri, heads)
    torch.cuda.synchronize()
    assert rasterize_winners_multi.launches == before + 2
    assert st.step == 2 and m["nonfinite_steps"] == 0
    for k in ("g", "sfs", "feature", "lmk"):
        assert np.isfinite(float(m[k])), k

"""The port's Hopper kernels on the card, bit for bit against their plain
versions (marker ``gpu``; each test skips when no CUDA card is present).

This file imports no JAX, so it also runs on a machine without it; there
``-o markers=`` registers the marker that ``tests/conftest.py`` registers
otherwise:

    python -m pytest --noconftest -o 'markers=gpu: needs a CUDA card' -m gpu \
        tests/test_torch_gpu.py
"""

import shutil

import numpy as np
import pytest
import torch

import torch_fused_act as tfa
import torch_upfirdn2d as tu
from torch_meshes import (
    BAND_CASES, KERNEL_CASES, NAN_DEPTH_PIXELS_16, SINGLE_CASES, kernel_case, keys_of_bins,
    single_case,
)

import stylerenderer_tpu_torch.ops.rasterize_multi as rasterize_multi_mod
import stylerenderer_tpu_torch.ops.rasterize_single as rasterize_single_mod

from stylerenderer_tpu_torch.face3d import (
    mesh_point_normal, random_apply_pose3D, synthetic_face,
)
from stylerenderer_tpu_torch.ops.rasterize import rasterize, rasterize_pyramid_fused
from stylerenderer_tpu_torch.ops.upfirdn2d import (
    make_kernel,
    upfirdn2d,
    upfirdn2d_cuda,
    upfirdn2d_plain,
)
from stylerenderer_tpu_torch.ops.rasterize_multi import (
    build_bins_multi,
    launch_bin_multi,
    rasterize_winners_multi,
    rasterize_winners_multi_ref,
    space_band,
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


@pytest.mark.gpu
def test_cuda_auto_takes_single_kernel_not_binned(cuda, monkeypatch):
    """``"auto"`` on a CUDA tensor above ``2^24`` pairs calls the
    single-level kernel's wrapper, which launches once, and never the binned
    search, patched here to fail; named, the binned search runs on the card
    and gives the same winners."""
    import stylerenderer_tpu_torch.ops.rasterize_binned as rasterize_binned_mod

    face, tri = synthetic_face(48, 96, 80, 29, device=cuda)
    g = torch.Generator().manual_seed(1)
    vert = random_apply_pose3D(g, face(face.random_input(2, g)))
    binned = rasterize_binned_mod.rasterize_winners_binned(vert, tri, 256, 256)
    assert binned.is_cuda

    def refuse(*args, **kwargs):
        raise AssertionError("'auto' on a CUDA tensor reached the binned search")

    monkeypatch.setattr(rasterize_binned_mod, "rasterize_winners_binned", refuse)
    single = rasterize_winners_single.launches
    out = rasterize(vert, mesh_point_normal(vert, tri), tri, 256, 256)
    torch.cuda.synchronize()
    assert rasterize_winners_single.launches == single + 1 and out.is_cuda
    win = rasterize_winners_single(vert, tri, 256, 256)
    np.testing.assert_array_equal(binned.cpu().numpy(), win.cpu().numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(SINGLE_CASES))
def test_cuda_binned_matches_plain(cuda, case):
    """The binned search on CUDA tensors equals the plain version (the dense
    search) on every single-level case, with no kernel launched."""
    from stylerenderer_tpu_torch.ops.rasterize_binned import rasterize_winners_binned

    v, tri, h, w, tile, persp = single_case(case)
    v, tri = torch.from_numpy(v).to(cuda), torch.from_numpy(tri).to(cuda)
    single, multi = rasterize_winners_single.launches, rasterize_winners_multi.launches
    out = rasterize_winners_binned(v, tri, h, w, persp)
    assert (rasterize_winners_single.launches, rasterize_winners_multi.launches) == (single, multi)
    ref = rasterize_winners_single_ref(v, tri, h, w, persp)
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


def _in_float64(net: torch.nn.Module) -> torch.nn.Module:
    """``net`` with its parameters and its compute type in float64."""
    for m in net.modules():
        if isinstance(getattr(m, "dtype", None), torch.dtype):
            m.dtype = torch.float64
    return net.double()


def _lockstep(monkeypatch, card_state, cpu_states, cfg, face, face_card, tri, real, draws):
    """One train step at the same weights and draws on the card and on the
    CPU, TF32 off. The card's step runs first and records each update's
    gradients and the parameters it produced; each CPU state's step then
    takes those parameters at each update instead of its own Adam step
    (Adam's first step is about ``lr * sign(g)``, which would turn
    rounding into parameter differences of ``lr``), so every loss and
    gradient is taken at the same parameters. -> (card metrics, per CPU
    state: (its metrics, [(card gradients, its gradients)] per update)).
    K1 launches three times on the card, and upfirdn2d's kernel takes every
    blur, adjoint and second order of the card's step."""
    import stylerenderer_tpu_torch.train.step as step_mod
    from stylerenderer_tpu_torch.train import train_step

    adam = step_mod._adam_step
    card = []

    def on_card(opt, params, grads):
        adam(opt, params, grads)
        card.append(([g.detach().to("cpu", copy=True) for g in grads],
                     [p.detach().to("cpu", copy=True) for p in params]))

    def following(cpu):
        def on_cpu(opt, params, grads):
            cpu.append([g.detach().clone() for g in grads])
            with torch.no_grad():
                for p, q in zip(params, card[len(cpu) - 1][1]):
                    p.copy_(q)
        return on_cpu

    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    out = []
    try:
        monkeypatch.setattr(step_mod, "_adam_step", on_card)
        before, ups = rasterize_winners_multi.launches, upfirdn2d.launches
        cuda = face_card.device
        m_card = train_step(card_state, real.to(cuda), _to(draws, cuda), cfg, face_card,
                            tri.to(cuda))
        assert rasterize_winners_multi.launches == before + 3
        # every blur and its adjoints, R1's and the path term's second order too
        assert upfirdn2d.launches > ups
        for st in cpu_states:
            cpu = []
            monkeypatch.setattr(step_mod, "_adam_step", following(cpu))
            m_cpu = train_step(st, real, draws, cfg, face, tri)
            assert len(card) == len(cpu) == 4
            out.append((m_cpu, [(gg, gc) for (gg, _), gc in zip(card, cpu)]))
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    return m_card, out


def _step_states(cuda, cfg):
    """(the CPU and card train states at the same weights, the CPU and
    card face models, the triangles, a real batch, the step's draws on the
    CPU) at ``cfg``, batch 4."""
    from stylerenderer_tpu_torch.train import init_train_state, sample_draws

    face, tri = synthetic_face(12, 24, 4, 2, device="cpu")
    face_card = synthetic_face(12, 24, 4, 2, device=cuda)[0]
    states = {"cpu": init_train_state(cfg, "cpu", seed=1), "cuda": init_train_state(cfg, cuda)}
    for name in ("g", "d", "g_ema"):
        getattr(states["cuda"], name).load_state_dict(getattr(states["cpu"], name).state_dict())
    draws = sample_draws(torch.Generator().manual_seed(2), cfg, face, 4, states["cpu"].g.n_latent)
    real = torch.rand(4, 3, cfg.size, cfg.size, generator=torch.Generator().manual_seed(3)) * 2 - 1
    return states, face, face_card, tri, real, draws


def _step_against_cpu(cuda, monkeypatch, card_d_float64: bool):
    """One train step (R1 and path both fire; K1 renders the pyramids) in
    ``_lockstep``, the CPU's D in float64 and the card's in float64
    (``card_d_float64``, with cuDNN's deterministic algorithms) or float32:
    metrics to 1e-4, each update's gradients to 1e-3 of each tensor's
    largest magnitude."""
    from stylerenderer_tpu_torch.train.state import make_optimizers
    from stylerenderer_tpu_torch.utils.config import TrainConfig

    cfg = TrainConfig(size=16, latent=32, n_mlp=2, channel_multiplier=1, batch=4,
                      d_reg_every=2, g_reg_every=2)
    states, face, face_card, tri, real, draws = _step_states(cuda, cfg)
    for dev, st in states.items():
        if dev == "cpu" or card_d_float64:
            _in_float64(st.d)
        st.g_optim, st.d_optim = make_optimizers(cfg, st.g, st.d)
    if card_d_float64:
        monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
        monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    m_card, [(m_cpu, grads)] = _lockstep(monkeypatch, states["cuda"], [states["cpu"]], cfg,
                                         face, face_card, tri, real, draws)
    for k, v in m_cpu.items():
        np.testing.assert_allclose(float(m_card[k]), float(v), rtol=1e-4, atol=1e-6, err_msg=k)
    for u, (gg, gc) in enumerate(grads):
        for i, (a, b) in enumerate(zip(gg, gc)):
            err, scale = float((a - b).abs().max()), float(b.abs().max())
            assert err <= 1e-3 * max(scale, 1e-30), (u, i, err, scale)


@pytest.mark.gpu
def test_cuda_train_step_matches_cpu(cuda, monkeypatch):
    """The step with D in float64 on both sides (``_step_against_cpu``).

    At this size the R1 gradient is ill-conditioned in float32: on the CPU
    alone, float32 is 1.1e-2 of the largest off the float64 gradient for
    ``final_conv``'s weight, and the parameters after the card's D update
    differ between runs (``tests/torch_r1_conditioning.py``), so two
    float32 orders of summation could not agree to 1e-3."""
    _step_against_cpu(cuda, monkeypatch, card_d_float64=True)


@pytest.mark.gpu
def test_cuda_train_step_float32_matches_cpu_float64(cuda, monkeypatch):
    """The card's step at training precision, D in float32, held against
    the CPU's step with D in float64 (``_step_against_cpu``): the card's
    float32 R1 gradient is well within 1e-3 of float64
    (``tests/torch_r1_conditioning.py``)."""
    _step_against_cpu(cuda, monkeypatch, card_d_float64=False)


def _record_input_types(monkeypatch):
    """Record the device and input type of every ``F.conv2d``,
    ``F.conv_transpose2d``, ``F.linear`` and ``upfirdn2d`` call -> the list
    it fills. ``upfirdn2d`` is one op on either device (the kernel on the
    card, the plain version's depthwise ``F.conv2d`` on the CPU), so the
    convolutions inside it are not recorded apart."""
    import importlib

    import torch.nn.functional as F

    ufd = importlib.import_module("stylerenderer_tpu_torch.ops.upfirdn2d")
    seen, inside = [], []
    for name in ("conv2d", "conv_transpose2d", "linear"):
        def call(x, *args, _fn=getattr(F, name), _name=name, **kwargs):
            if not inside:
                seen.append((x.device.type, _name, x.dtype))
            return _fn(x, *args, **kwargs)

        monkeypatch.setattr(F, name, call)
    for name in ("upfirdn2d_cuda", "upfirdn2d_plain"):
        def op(x, *args, _fn=getattr(ufd, name)):
            seen.append((x.device.type, "upfirdn2d", x.dtype))
            inside.append(x)
            try:
                return _fn(x, *args)
            finally:
                inside.pop()

        monkeypatch.setattr(ufd, name, op)
    return seen


def _rel_l2(xs, ys) -> float:
    """||xs - ys|| / ||ys|| over all the tensors of two gradient lists."""
    num = sum(float((x - y).double().square().sum()) for x, y in zip(xs, ys))
    return (num / sum(float(y.double().square().sum()) for y in ys)) ** 0.5


@pytest.mark.gpu
@pytest.mark.parametrize("augment", [False, True])
def test_cuda_train_step_bfloat16_matches_cpu(cuda, monkeypatch, augment):
    """One train step with ``compute_dtype="bfloat16"`` (R1 and path both
    fire; with ``augment``, ADA's augmentations at p = 0.5 on the reals and
    on the D and G steps' fakes, and its controller firing) on the card
    against the same step in bf16 and in float32 on the CPU, all at the
    card's parameters (``_lockstep``).

    - Every conv and linear call takes the same input type on the card as
      in the CPU's bf16 step, and most take bf16: a missing or wrong cast
      shows here.
    - Every metric to one bf16 step (rtol 2**-7): the losses and scores
      are bf16 scalars, and the card's and the CPU's sums, added in other
      orders, may round to neighbours (on an H100 up to 6.7e-3 apart, one
      step of the G loss).
    - Each update's gradients, as ``_rel_l2`` over all tensors: the card's
      bf16 gradients are closer to the CPU's bf16 gradients than the CPU's
      bf16 gradients are to float32's at the same parameters, so the
      tolerance is what bf16 rounding itself moves (on an H100 the ratio
      was at most 0.59). A per-tensor bound cannot tell the two apart:
      sums that cancel, rounded in bf16, leave small tensors (biases of 3
      to 512 entries) 0.31 of their largest magnitude apart between two
      bf16 runs and 1.0 between bf16 and float32."""
    import dataclasses

    from stylerenderer_tpu_torch.train import init_train_state
    from stylerenderer_tpu_torch.utils.config import TrainConfig

    cfg = TrainConfig(size=16, latent=32, n_mlp=2, channel_multiplier=1, batch=4,
                      d_reg_every=2, g_reg_every=2, compute_dtype="bfloat16", augment=augment,
                      ada_every=4, ada_target=0.1, ada_length=100)
    states, face, face_card, tri, real, draws = _step_states(cuda, cfg)
    states["float32"] = init_train_state(dataclasses.replace(cfg, compute_dtype="float32"),
                                         "cpu", seed=1)
    assert states["cuda"].g.dtype == states["cuda"].d.dtype == torch.bfloat16
    if augment:
        for st in states.values():
            st.ada_p.fill_(0.5)
    seen = _record_input_types(monkeypatch)
    m_card, [(m_cpu, grads), (_, grads_f32)] = _lockstep(
        monkeypatch, states["cuda"], [states["cpu"], states["float32"]], cfg, face, face_card,
        tri, real, draws)
    on_card = [(n, t) for d, n, t in seen if d == "cuda"]
    assert on_card == [(n, t) for d, n, t in seen if d == "cpu"][:len(on_card)]
    n_bf16 = sum(t == torch.bfloat16 for _, t in on_card)
    assert n_bf16 > len(on_card) // 2, (n_bf16, len(on_card))
    for k, v in m_cpu.items():
        np.testing.assert_allclose(float(m_card[k]), float(v), rtol=2.0 ** -7, atol=1e-6,
                                   err_msg=k)
    if augment:
        assert float(m_card["ada_p"]) != 0.5
    for u, ((gg, gc), (_, gf)) in enumerate(zip(grads, grads_f32)):
        card_cpu, bf16_f32 = _rel_l2(gg, gc), _rel_l2(gc, gf)
        assert card_cpu <= bf16_f32, (u, card_cpu, bf16_f32)


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


# ---- face models and alignment --------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("border", ["constant", "reflect"])
def test_cuda_warp_affine_matches_cpu(cuda, border):
    """The alignment warp on the card against the CPU: random similarities
    on a non-square batch, to 1e-2 grey levels before rounding."""
    from stylerenderer_tpu_torch.face3d.alignment import warp_affine

    rng = np.random.RandomState(0)
    img = torch.from_numpy(rng.randint(0, 256, (3, 3, 60, 80)).astype(np.float32))
    M = []
    for _ in range(3):
        th, s = rng.uniform(-0.5, 0.5), rng.uniform(0.7, 1.3)
        M.append([[s * np.cos(th), -s * np.sin(th), rng.uniform(-9, 9)],
                  [s * np.sin(th), s * np.cos(th), rng.uniform(-9, 9)]])
    card = warp_affine(img.to(cuda), np.asarray(M), (50, 70), border).cpu()
    cpu = warp_affine(img, np.asarray(M), (50, 70), border)
    assert card.shape == (3, 3, 50, 70)
    assert float((card - cpu).abs().max()) <= 1e-2


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["facewarehouse", "flame"])
def test_cuda_face_models_match_cpu(cuda, kind):
    """The blendshape and skinning models loaded on the card: the same
    ``random_input`` for a CPU generator; at a moderate ``x`` (the
    blendshape prior's own samples overflow its energy's ``exp`` in
    float32, in the JAX package too), forwards to 1e-5 of the largest value
    and gradients of the vertices and the prior with respect to ``x`` to
    1e-4 (TF32 off)."""
    from torch_face_models import facewarehouse_dict, flame_dict

    from stylerenderer_tpu_torch.face3d import load_facewarehouse, load_flame

    load, data = ((load_facewarehouse, facewarehouse_dict(20, 30, 12, 8)) if kind ==
                  "facewarehouse" else (load_flame, flame_dict(20, 30, 20)))
    flags = _tf32_off()
    try:
        res = []
        for dev in ("cpu", cuda):
            model, _ = load(data, device=dev)
            drawn = model.random_input(4, torch.Generator().manual_seed(3))
            assert drawn.device.type == torch.device(dev).type
            x = torch.from_numpy(np.random.RandomState(3).randn(*drawn.shape).astype(np.float32))
            x = (x * 0.5).to(dev).requires_grad_(True)
            v = model(x)
            cot = torch.randn(v.shape, generator=torch.Generator().manual_seed(4)).to(dev)
            loss = (v * cot).sum() + 0.1 * model.regulation(x)
            (gx,) = torch.autograd.grad(loss, x)
            res.append((drawn.cpu(), v.detach().cpu(), gx.cpu()))
    finally:
        _restore_tf32(flags)
    (xc, vc, gc), (xg, vg, gg) = res
    torch.testing.assert_close(xg, xc, rtol=0, atol=0)
    assert float((vg - vc).abs().max()) <= 1e-5 * float(vc.abs().max())
    assert float((gg - gc).abs().max()) <= 1e-4 * float(gc.abs().max())


@pytest.mark.gpu
def test_cuda_bfm_k1_bitexact(cuda, tmp_path):
    """A small BFM ``.mat`` through ``load_bfm`` on the card, posed, its
    normals through K1: winners and values bit-equal to the plain version
    at every level, one launch."""
    import scipy.io
    from torch_face_models import bfm_dict

    from stylerenderer_tpu_torch.face3d import load_bfm

    path = str(tmp_path / "bfm.mat")
    scipy.io.savemat(path, bfm_dict(40, 60, 20, 6))
    face, tri = load_bfm(path, device=cuda)
    assert tri.device.type == "cuda" and tri.dtype == torch.int64
    g = torch.Generator().manual_seed(5)
    vert = random_apply_pose3D(g, face(face.random_input(4, g)))
    norm = mesh_point_normal(vert, tri)
    before = rasterize_winners_multi.launches
    out = rasterize_winners_multi(vert, tri, 64, 5, attrs=norm)
    torch.cuda.synchronize()
    assert rasterize_winners_multi.launches == before + 1
    ref = rasterize_winners_multi_ref(vert, tri, 64, 5, attrs=norm)
    for k, ((va, wa), (vb, wb)) in enumerate(zip(out, ref)):
        assert torch.equal(wa, wb), f"level {k}: winners differ"
        assert torch.equal(va, vb), f"level {k}: values differ"
    assert float((ref[0][1] >= 0).float().mean()) > 0.05


@pytest.mark.gpu
@pytest.mark.parametrize("top,n_levels", [(512, 8), (1024, 9)])
def test_cuda_k1_tile32_bitexact(cuda, top, n_levels):
    """K1 at the 1024 px GAR's shapes (tile 32, the 16, 8 and 4 px levels
    sparse at top 1024) on the 9,024-triangle training mesh at B=1, C=3:
    winners and values bit-equal to the plain version at every level, one
    launch."""
    face, tri = synthetic_face(48, 96, 80, 29, device=cuda)
    g = torch.Generator().manual_seed(9)
    vert = random_apply_pose3D(g, face(face.random_input(1, g)))
    norm = mesh_point_normal(vert, tri)
    before = rasterize_winners_multi.launches
    out = rasterize_winners_multi(vert, tri, top, n_levels, attrs=norm)
    torch.cuda.synchronize()
    assert rasterize_winners_multi.launches == before + 1
    ref = rasterize_winners_multi_ref(vert, tri, top, n_levels, attrs=norm, tile=32)
    for k, ((va, wa), (vb, wb)) in enumerate(zip(out, ref)):
        assert torch.equal(wa, wb), f"level {k}: winners differ"
        assert torch.equal(va, vb), f"level {k}: values differ"
        assert (wb >= 0).any(), f"level {k}: no face pixel"


@pytest.mark.gpu
def test_cuda_remat_gradients_match_plain(cuda):
    """``remat`` on the card: ``GeneratorWithMap(32, 64, 2)`` f32 (TF32 off,
    deterministic cuDNN) with noise drawn from one card generator seed and
    non-zero noise strengths, an image loss plus a path-length term (the
    double backward through the checkpointed convs): the images equal and
    every parameter gradient to rtol 1e-4 of the plain run's, as
    ``tests/test_remat.py`` holds them."""
    from stylerenderer_tpu_torch.models import GeneratorWithMap
    from stylerenderer_tpu_torch.train import path_lengths_multi

    flags = _tf32_off()
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        face, tri = synthetic_face(12, 24, 4, 2, device=cuda)
        g = torch.Generator().manual_seed(2)
        vert = random_apply_pose3D(g, face(face.random_input(2, g)))
        mesh = (vert, mesh_point_normal(vert, tri), tri)
        z = torch.randn(2, 64, generator=g).to(cuda)
        probe = torch.randn(2, 3, 32, 32, generator=g).to(cuda)
        res = []
        for remat in (False, True):
            gen = GeneratorWithMap(32, 64, 2, remat=remat, seed=4, device=cuda)
            with torch.no_grad():
                for mod in gen.modules():
                    if type(mod).__name__ == "NoiseInjection":
                        mod.weight.fill_(0.3)
            rng = torch.Generator(cuda).manual_seed(7)
            img = gen([z], mesh, generator=rng)[0]
            latent = gen.get_latent(z)[:, None].repeat(1, gen.n_latent, 1)
            maps = gen.normal_pyramid(mesh)
            pl = path_lengths_multi(
                lambda lat, *m: gen.synthesize(lat, list(m), generator=rng), probe,
                (latent, *maps))
            loss = img.square().mean() + pl.mean()
            grads = torch.autograd.grad(loss, list(gen.parameters()), allow_unused=True,
                                        materialize_grads=True)
            res.append((img.detach(), [t.cpu() for t in grads]))
    finally:
        torch.backends.cudnn.deterministic = det
        _restore_tf32(flags)
    (img0, g0), (img1, g1) = res
    assert torch.equal(img1, img0)
    for i, (a, b) in enumerate(zip(g1, g0)):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6, msg=f"parameter {i}")
    assert max(float(t.abs().max()) for t in g0) > 0


@pytest.mark.gpu
def test_cuda_n_stylemap_matches_cpu(cuda):
    """``GeneratorWithMap(256, 512, 8, n_stylemap=4)`` at full width on the
    card against the CPU, TF32 off, explicit noise: normal maps equal (K1
    on the card, the plain version on the CPU), images to 1e-4."""
    from stylerenderer_tpu_torch.models import GeneratorWithMap, make_noise

    flags = _tf32_off()
    try:
        g = torch.Generator().manual_seed(3)
        face, tri = synthetic_face(48, 96, 80, 29, device="cpu")
        vert = random_apply_pose3D(g, face(face.random_input(1, g)))
        norm = mesh_point_normal(vert, tri)
        z = torch.randn(1, 512, generator=g)
        noise = make_noise(256, 1, g)
        res = {}
        for dev in ("cpu", cuda):
            gen = GeneratorWithMap(256, 512, 8, n_stylemap=4, seed=5, device=dev).eval()
            assert gen.norm1_pre[0].weight.shape[0] == 4
            with torch.no_grad():
                img, _, nm = gen([z.to(dev)], (vert.to(dev), norm.to(dev), tri.to(dev)),
                                 noise=[n.to(dev) for n in noise], return_normals=True)
            res[str(dev)] = img.cpu(), [m.cpu() for m in nm]
    finally:
        _restore_tf32(flags)
    (img_c, nm_c), (img_g, nm_g) = res["cpu"], res["cuda"]
    for a, b in zip(nm_g, nm_c):
        assert torch.equal(a, b)
    assert float(img_c.abs().max()) > 1e-3
    torch.testing.assert_close(img_g, img_c, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_cuda_world1_nccl_step_equals_no_group(cuda, monkeypatch):
    """A step at world 1 under NCCL (``make_mesh`` as rank 0 of 1) is the
    step without a group, bit for bit: every metric, and every parameter,
    Adam moment and statistic after a step with R1 and the path term. The
    collectives then copy, and the gradient average divides by 1. The
    test takes deterministic algorithms (by default ``mesh_point_normal``'s
    ``index_add`` sums with atomics, and cuDNN may pick nondeterministic
    algorithms), and two steps without a group are held equal first, so
    that a difference can only come from the mesh."""
    from torch_parallel import free_port

    from stylerenderer_tpu_torch.parallel import make_mesh
    from stylerenderer_tpu_torch.train import init_train_state, sample_draws, train_step
    from stylerenderer_tpu_torch.utils.config import TrainConfig

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    cfg = TrainConfig(size=32, latent=64, n_mlp=2, channel_multiplier=1, batch=4,
                      d_reg_every=1, g_reg_every=1)
    face, tri = synthetic_face(12, 24, 4, 2, device=cuda)
    real = torch.rand(4, 3, 32, 32, generator=torch.Generator(cuda).manual_seed(4),
                      device=cuda) * 2 - 1

    def run(mesh):
        st = init_train_state(cfg, cuda)
        draws = sample_draws(torch.Generator(cuda).manual_seed(3), cfg, face, 4, st.g.n_latent)
        m = train_step(st, real, draws, cfg, face, tri, mesh=mesh)
        tensors = [t for mod in (st.g, st.d, st.g_ema) for t in mod.state_dict().values()]
        tensors += [t for o in (st.g_optim, st.d_optim) for s in o.state.values()
                    for t in s.values()]
        tensors += [st.mean_path_length, st.ada_p]
        return m, tensors, st.step

    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    mesh = make_mesh("cuda", rank=0, world_size=1, init_method=f"tcp://localhost:{free_port()}")
    try:
        assert mesh.backend == "nccl" and mesh.group is not None
        runs = [run(None), run(None), run(mesh)]
    finally:
        mesh.destroy()
        torch.use_deterministic_algorithms(was)
    m0, t0, s0 = runs[0]
    assert s0 == 1 and float(m0["r1"]) != 0 and float(m0["path"]) != 0
    for what, (m, ts, s) in zip(("again without a group", "world 1 under NCCL"), runs[1:]):
        assert s == s0 and m.keys() == m0.keys(), what
        for k in m0:
            assert torch.equal(torch.as_tensor(m[k]), torch.as_tensor(m0[k])), (what, k)
        for a, b in zip(ts, t0):
            assert torch.equal(a, b), what


# ---- spatial sharding ---------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("name,n_levels,n_space,tile", BAND_CASES)
def test_cuda_k1_band_matches_full_cut(cuda, name, n_levels, n_space, tile):
    """K1 by band on the card (values and winners-only): every band equal,
    bit for bit, to the whole image's launch cut to the band and to the
    plain version of the band; the card binning's keys those of the plain
    binning of the band; each banded launch counted in ``launches`` and
    ``band_launches``."""
    v, tri, attrs, top, _, _, persp = kernel_case(name)
    v, tri, attrs = (torch.from_numpy(a).to(cuda) for a in (v, tri, attrs))
    full = rasterize_winners_multi(v, tri, top, n_levels, persp, attrs=attrs,
                                   tile=space_band(top, n_levels, 1, 0, tile)[0])
    for index in range(n_space):
        t, band = space_band(top, n_levels, n_space, index, tile)
        before = (rasterize_winners_multi.launches, rasterize_winners_multi.band_launches)
        out = rasterize_winners_multi(v, tri, top, n_levels, persp, attrs=attrs, tile=t, band=band)
        wins = rasterize_winners_multi(v, tri, top, n_levels, persp, tile=t, band=band)
        torch.cuda.synchronize()
        assert (rasterize_winners_multi.launches - before[0],
                rasterize_winners_multi.band_launches - before[1]) == (2, 2)
        ref = rasterize_winners_multi_ref(v, tri, top, n_levels, persp, attrs=attrs, tile=t,
                                          band=band)
        for k, ((a, wa), (b, wb), (fa, fw), w) in enumerate(zip(out, ref, full, wins)):
            y0, y1 = (band[0] * t) >> k, ((band[0] + band[1]) * t) >> k
            for x, y in ((wa, wb), (a, b), (wa, fw[:, y0:y1]), (a, fa[:, y0:y1]), (w, wb)):
                assert torch.equal(x, y), f"band {index} level {k}"
        _, _, _, keys = launch_bin_multi(v, tri, top, n_levels, persp, 1e-6, t, attrs, band)
        _, ids, starts = build_bins_multi(v, tri, top, n_levels, persp, 1e-6, t, attrs, band)
        np.testing.assert_array_equal(keys.cpu().numpy(),
                                      keys_of_bins(ids.cpu().numpy(), starts.cpu().numpy()))


@pytest.mark.gpu
def test_cuda_spatial_forward_matches_world1(cuda, tmp_path):
    """Four gloo ranks on the one card, laid out 2 x 2 and 1 x 4, against
    one process on the card (TF32 off): D's logits and the GAR's image
    bands to 1e-4, D's block gradient and the reduced parameter gradients
    to 1e-4 of each tensor's largest magnitude; K1 launched once, banded,
    in each rank's GAR forward."""
    from torch_parallel import Ranks

    from stylerenderer_tpu_torch.models import Discriminator, GeneratorWithMap, make_noise

    gen = torch.Generator().manual_seed(0)
    face, tri = synthetic_face(6, 12, 4, 2, device="cpu")
    vert = face(face.random_input(4, gen))
    sp = dict(d=((32,), dict(channel_multiplier=1, seed=1)),
              g=((16, 32, 2), dict(channel_multiplier=1, seed=2)),
              x=torch.randn(4, 3, 32, 32, generator=gen), x_w=0.5 + torch.rand(4, generator=gen),
              z=torch.randn(4, 32, generator=gen), vert=vert, norm=mesh_point_normal(vert, tri),
              tri=tri, noise=make_noise(16, 1, gen),
              img_w=0.5 + torch.rand(4, 3, 16, 16, generator=gen), layouts=[(2, 2), (1, 4)])
    ranks = Ranks(4, dict(device="cuda", backend="gloo", one_card=True, tf32=False,
                          run=["spatial"], spatial=sp), str(tmp_path), timeout=600)
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        d = Discriminator(32, channel_multiplier=1, seed=1, device=cuda)
        g = GeneratorWithMap(16, 32, 2, channel_multiplier=1, seed=2, device=cuda)
        x = sp["x"].to(cuda).requires_grad_(True)
        logits = d(x)
        dg = torch.autograd.grad((logits[:, 0] * sp["x_w"].to(cuda)).sum(),
                                 [x] + list(d.parameters()))
        img = g([sp["z"].to(cuda)], (sp["vert"].to(cuda), sp["norm"].to(cuda), tri.to(cuda)),
                noise=[n.to(cuda) for n in sp["noise"]])[0]
        gg = torch.autograd.grad((img * sp["img_w"].to(cuda)).sum(), list(g.parameters()))
        results = ranks.wait()
    finally:
        ranks.kill()
        shutil.rmtree(tmp_path, ignore_errors=True)  # the ranks' gradients, ~1 GB
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32

    def close(a, b, what):
        b = b.detach().cpu()
        err, scale = float((a - b).abs().max()), float(b.abs().max())
        assert err <= 1e-4 * max(scale, 1e-30), f"{what}: {err:.3e} of {scale:.3e}"

    for layout in ("2x2", "1x4"):
        for r, res in enumerate(rr["spatial"][layout] for rr in results):
            rows, band, gband, nd = res["rows"], res["band"], res["gband"], res["n_data"]
            torch.testing.assert_close(res["logits"], logits.detach().cpu()[rows], rtol=1e-4,
                                       atol=1e-4)
            torch.testing.assert_close(res["image"], img.detach().cpu()[rows][:, :, gband],
                                       rtol=1e-4, atol=1e-4)
            close(res["d_x_grad"], dg[0][rows][:, :, band], f"{layout} rank {r} x")
            for i, (a, b) in enumerate(zip(res["d_grads"], dg[1:])):
                close(a, b / nd, f"{layout} rank {r} D parameter {i}")
            for i, (a, b) in enumerate(zip(res["g_grads"], gg)):
                close(a, b / nd, f"{layout} rank {r} G parameter {i}")
            assert res["k1"] == (1, 1), (layout, r, res["k1"])


# ---- the styled conv's epilogue kernel (ops/fused_act.py) ----------------------

@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,h", tfa.SYNTH_1024 + tfa.RESBLOCK)
def test_cuda_fused_bias_act_matches_plain(cuda, c, h, dtype):
    """The kernel at every (C, H) of the 1024 and 256 px synthesis and of the
    ResBlocks' maps, B=2, with and without FiLM (a view of a 4-channel map,
    contiguous or channels-last as the ResBlocks give it), with noise
    ``[B,1,H,W]``, ``[1,1,H,W]`` and ``[1,1,1,1]``: float32 gives the plain
    chain's bits on the same ``y``; bfloat16 the host build's bits and the
    float32 chain's rounded once, within one rounding of the float64
    oracle. Each call is one launch."""
    from stylerenderer_tpu_torch.ops.fused_act import (
        fused_bias_act, fused_bias_act_host, fused_bias_act_ref,
    )

    for i, (film, noise, last) in enumerate([(f, n, cl) for f in (False, True)
                                             for n in tfa.NOISE_KINDS
                                             for cl in ((False, True) if f else (False,))]):
        a = tfa.inputs(2, c, h, h, dtype, film=film, noise=noise, seed=i, device=cuda)
        if last:
            a["film"] = a["film"].contiguous(memory_format=torch.channels_last)
        what = f"C={c} H={h} {dtype} film={film} channels_last={last} noise={noise}"
        before = fused_bias_act.launches
        with torch.no_grad():
            out = fused_bias_act(**a)
        torch.cuda.synchronize()
        assert fused_bias_act.launches == before + 1, what
        if dtype == torch.float32:
            assert torch.equal(tfa.bits(out), tfa.bits(fused_bias_act_ref(**a))), what
        else:
            host = fused_bias_act_host(**{k: v.cpu() for k, v in a.items()})
            assert torch.equal(tfa.bits(out.cpu()), tfa.bits(host)), what
            assert torch.equal(tfa.bits(out), tfa.bits(tfa.rounded_once(**a))), what
            assert tfa.max_gap(out, *tfa.oracle(**a)) <= 1.0, what


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_fused_leaky_relu_forms(cuda, dtype):
    """The activation alone in the forms the port calls it: the mapping's
    ``[16, 512]`` (bias on the last axis), a ResBlock conv's channels-last
    ``[2, 3, 64, 64]`` (kept channels-last), a transposed map (made
    contiguous first), no bias: float32 bit for bit against the plain chain,
    bfloat16 against the host build."""
    from stylerenderer_tpu_torch.ops.fused_act import (
        fused_bias_act_host, fused_bias_act_ref, fused_leaky_relu,
    )

    g = torch.Generator().manual_seed(0)
    y2 = torch.randn(16, 512, generator=g)
    y4 = torch.randn(2, 3, 64, 64, generator=g)
    cases = [(y2, torch.randn(512, generator=g), -1),
             (y4.contiguous(memory_format=torch.channels_last), torch.randn(3, generator=g), 1),
             (y4.transpose(2, 3), torch.randn(3, generator=g), 1), (y4, None, 1)]
    for y, b, dim in cases:
        y = y.to(dtype)
        with torch.no_grad():
            out = fused_leaky_relu(y.to(cuda), None if b is None else b.to(cuda), dim=dim)
        if y.is_contiguous(memory_format=torch.channels_last) and not y.is_contiguous():
            assert out.is_contiguous(memory_format=torch.channels_last)
        want = (fused_bias_act_ref(y, b, dim=dim) if dtype == torch.float32
                else fused_bias_act_host(y.contiguous(), b, dim=dim))
        assert torch.equal(tfa.bits(out.cpu().contiguous()), tfa.bits(want.contiguous()))


def _gar_and_inputs(cuda, size, dtype, batch=2):
    """``GeneratorWithMap(size, 512, 8)`` with noise strengths 0.1 and
    activation biases away from 0, and a forward's inputs."""
    from stylerenderer_tpu_torch.models import GeneratorWithMap, make_noise

    gen = GeneratorWithMap(size, 512, 8, dtype=dtype, seed=1, device=cuda).eval()
    gb = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for m in gen.modules():
            if type(m).__name__ == "NoiseInjection":
                m.weight.fill_(0.1)
            if type(m).__name__ == "FusedLeakyReLU":
                m.bias.copy_(0.1 * torch.randn(m.bias.shape, generator=gb))
    face, tri = synthetic_face(24, 48, 8, 4, device=cuda)
    g = torch.Generator().manual_seed(2)
    vert = random_apply_pose3D(g, face(face.random_input(batch, g)))
    z = torch.randn(batch, 512, generator=g).to(cuda)
    noise = [n.to(cuda) for n in make_noise(size, batch, g)]
    return gen, ([z], (vert, mesh_point_normal(vert, tri), tri)), noise


@pytest.mark.gpu
@pytest.mark.parametrize("size,launches", [(256, 13 + 14 + 8), (1024, 17 + 18 + 8)])
def test_cuda_gar_forward_takes_fused_epilogue(cuda, monkeypatch, size, launches):
    """A no-grad bf16 ``GeneratorWithMap(size, 512, 8)`` forward launches the
    epilogue once per styled conv, ResBlock activation and mapping layer
    and never the plain chain; its image is the plain path's within the
    render cell's ``image_rel_l2`` limit (0.07; one rounding against
    nine). A forward under autograd launches nothing and matches the plain
    path's image bit for bit."""
    from stylerenderer_tpu_torch.ops import fused_act

    gen, args, noise = _gar_and_inputs(cuda, size, torch.bfloat16)
    real = fused_act.takes_kernel
    with torch.no_grad():
        monkeypatch.setattr(fused_act, "takes_kernel", lambda *a: False)
        before = fused_act.fused_bias_act.launches
        plain = gen(*args, noise=noise)[0].float()
        assert fused_act.fused_bias_act.launches == before
        monkeypatch.setattr(fused_act, "takes_kernel", real)

        def refuse(*a, **k):
            raise AssertionError("a no-grad forward on the card reached the plain chain")

        monkeypatch.setattr(fused_act, "fused_bias_act_ref", refuse)
        fused = gen(*args, noise=noise)[0].float()
        torch.cuda.synchronize()
        assert fused_act.fused_bias_act.launches == before + launches
    monkeypatch.undo()
    rel = float((fused - plain).norm() / plain.norm())
    assert rel < 0.07, rel
    img = gen(*args, noise=noise)[0]
    assert fused_act.fused_bias_act.launches == before + launches
    assert img.requires_grad and torch.equal(img.detach().float(), plain)


@pytest.mark.gpu
def test_cuda_gar_forward_fused_float32_matches_plain(cuda, monkeypatch):
    """float32, TF32 off: the kernel path's 256 px image is the plain
    path's to 1e-5 (the kernel gives the chain's bits; the upsampling convs
    demodulate after their blur)."""
    from stylerenderer_tpu_torch.ops import fused_act

    gen, args, noise = _gar_and_inputs(cuda, 256, torch.float32)
    flags = _tf32_off()
    try:
        with torch.no_grad():
            fused = gen(*args, noise=noise)[0]
            monkeypatch.setattr(fused_act, "takes_kernel", lambda *a: False)
            plain = gen(*args, noise=noise)[0]
    finally:
        _restore_tf32(flags)
    torch.testing.assert_close(fused, plain, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "float64"])
@pytest.mark.parametrize("cell", sorted(tu.CELLS))
def test_cuda_upfirdn2d_matches_plain(cuda, cell, dtype):
    """upfirdn2d's kernel at every call a cell runs (forward, adjoints; a
    second order takes the forward forms again) and at tu.EXTRA_CALLS'
    negative pads, in bfloat16, float32 and float64 (B=2), against the
    plain version: float32 within 1e-5,
    float64 1e-12, bfloat16 within one rounding and bit-equal to the
    kernel's float32 sums rounded once; channels-last and sliced inputs give
    the contiguous input's bits; each call one launch."""
    calls = list(dict.fromkeys(tu.CELLS[cell][0]))
    dt = getattr(torch, dtype)
    g = torch.Generator(cuda).manual_seed(0)
    for call in calls + tu.EXTRA_CALLS:
        (b, c, h, w), up, down, pad = call
        b = 2 if dt == torch.float64 else b
        x = torch.randn(b, c, h, w, generator=g, device=cuda).to(dt)
        k = (make_kernel(list(tu.KERNEL)) * (4 if up == 2 else 1)).to(cuda)
        before = upfirdn2d.launches
        out = upfirdn2d_cuda(x, k, up, down, pad)
        assert upfirdn2d.launches == before + 1
        ref = upfirdn2d_plain(x, k, up, down, pad)
        assert out.shape == ref.shape and out.is_contiguous(), call
        if dt == torch.bfloat16:
            once = upfirdn2d_cuda(x.float(), k, up, down, pad).to(torch.bfloat16)
            assert torch.equal(out.view(torch.int16), once.view(torch.int16)), call
            torch.testing.assert_close(out.float(), ref.float(), rtol=2 ** -7, atol=2 ** -7)
        else:
            tol = 1e-12 if dt == torch.float64 else 1e-5
            torch.testing.assert_close(out, ref, rtol=tol, atol=tol)
        if dt == torch.float32 and c > 3:
            xs = torch.randn(b, c, h, w + 5, generator=g, device=cuda)[..., 2:w + 2]
            want = upfirdn2d_cuda(xs.contiguous(), k, up, down, pad)
            for view in (xs, xs.contiguous(memory_format=torch.channels_last)):
                assert torch.equal(upfirdn2d_cuda(view, k, up, down, pad), want), call
        del x, out, ref


@pytest.mark.gpu
@pytest.mark.parametrize("size,launches", [(256, 12), (1024, 16)])
def test_cuda_gar_forward_takes_upfirdn2d_kernel(cuda, monkeypatch, size, launches):
    """A no-grad bf16 ``GeneratorWithMap(size, 512, 8)`` forward launches
    upfirdn2d's kernel twice a level from 8 px (the upsampling conv's blur,
    ToRGB's Upsample) and never reaches the plain version."""
    gen, args, noise = _gar_and_inputs(cuda, size, torch.bfloat16)

    def refuse(*a, **k):
        raise AssertionError("a card tensor reached upfirdn2d's plain version")

    import importlib

    monkeypatch.setattr(importlib.import_module("stylerenderer_tpu_torch.ops.upfirdn2d"),
                        "upfirdn2d_plain", refuse)
    with torch.no_grad():
        before = upfirdn2d.launches
        img = gen(*args, noise=noise)[0]
        torch.cuda.synchronize()
    assert upfirdn2d.launches == before + launches
    assert bool(torch.isfinite(img.float()).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype_code", [0, 1, 2])
def test_cuda_upfirdn2d_launch_shape_is_the_host_builds(cuda, dtype_code):
    """At every call of the four cells and ``tu.EXTRA_CALLS``, the launch
    shape the card works out (plane packing from the blocks it measures
    resident) is the host build's, whose fixed block count is an H100's:
    the CPU tests' tiling is the card's."""
    from stylerenderer_tpu_torch.ops._build import library

    card = library("upfirdn2d").sr_upfirdn2d_shape
    host = library("upfirdn2d_host").sr_upfirdn2d_shape_host
    calls = [c for cell in sorted(tu.CELLS) for c in tu.CELLS[cell][0]] + tu.EXTRA_CALLS
    for call in dict.fromkeys(calls):
        for unit_w in (1, 0):
            assert (tu.launch_shape(card, call, dtype_code, unit_w)
                    == tu.launch_shape(host, call, dtype_code, unit_w)), call

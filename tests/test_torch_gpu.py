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

from torch_meshes import KERNEL_CASES, SINGLE_CASES, kernel_case, single_case

from stylerenderer_tpu_torch.face3d import (
    mesh_point_normal, random_apply_pose3D, synthetic_face,
)
from stylerenderer_tpu_torch.ops.rasterize import rasterize, rasterize_pyramid_fused
from stylerenderer_tpu_torch.ops.rasterize_multi import (
    rasterize_winners_multi,
    rasterize_winners_multi_ref,
)
from stylerenderer_tpu_torch.ops.rasterize_single import (
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
    """The single-level kernel: tiles 8, 16 and 32, rectangular images,
    edge tiles that stick out, perspective, degenerate and XL triangles."""
    v, tri, h, w, tile, persp = single_case(case)
    v, tri = torch.from_numpy(v).to(cuda), torch.from_numpy(tri).to(cuda)
    before = rasterize_winners_single.launches
    out = rasterize_winners_single(v, tri, h, w, persp, tile=tile)
    torch.cuda.synchronize()
    assert rasterize_winners_single.launches == before + 1
    ref = rasterize_winners_single_ref(v, tri, h, w, persp)
    np.testing.assert_array_equal(out.cpu().numpy(), ref.cpu().numpy())


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

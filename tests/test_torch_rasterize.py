"""The port's rasterizer against the JAX package, and the multi-level
kernel's math against the port's own plain version.

- the dense oracle: winner maps bit-equal to JAX ``rasterize_winners``,
  values of ``rasterize`` to f32 rounding;
- binning: ``starts`` equal to JAX ``build_bins_multi``'s, the same
  triangle ids in every segment;
- the plain version ``rasterize_winners_multi_ref`` against the JAX Pallas
  kernel in interpret mode: winners equal, values to the interpret mode's
  own rounding;
- first-order gradients of ``rasterize_pyramid_fused`` against ``jax.grad``;
- the host build (g++) of the card's binning against the plain binning
  ``build_bins_multi``, and of the kernel's per-tile logic and math, bit
  for bit against the plain version, in any order within a segment (the
  CUDA passes themselves: ``test_torch_gpu.py``).

Inputs are made with numpy from seeds and handed to both packages.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import stylerenderer_tpu.ops.rasterize_pallas as jrp
from stylerenderer_tpu.ops.rasterize import (
    rasterize as j_rasterize,
    rasterize_index_coeff as j_rasterize_index_coeff,
    rasterize_pyramid as j_rasterize_pyramid,
    rasterize_winners as j_rasterize_winners,
)
from stylerenderer_tpu.face3d import mesh_point_normal as j_mesh_point_normal
from stylerenderer_tpu.face3d import synthetic_face as j_synthetic_face

from stylerenderer_tpu_torch.ops.rasterize import (
    _multi_levels,
    rasterize,
    rasterize_index_coeff,
    rasterize_pyramid,
    rasterize_pyramid_fused,
    rasterize_winners,
)
from torch_meshes import (
    KERNEL_CASES,
    kernel_case,
    keys_of_bins,
    mesh_big_triangles,
    mesh_degenerate,
    mesh_random,
)

from stylerenderer_tpu_torch.ops.rasterize_multi import (
    MULTI_N_TIERS,
    _sparse_sp,
    bin_multi_host,
    build_bins_multi,
    launch_bin_multi,
    rasterize_bins_multi_host,
    rasterize_winners_multi,
    rasterize_winners_multi_host,
    rasterize_winners_multi_ref,
)


def _t(a):
    return torch.from_numpy(np.array(a))


def mesh_sphere(seed=0, B=2):
    face, tri = j_synthetic_face(16, 32, 6, 3)
    x = np.random.RandomState(seed).randn(B, 9).astype(np.float32) * np.asarray(face.sigma)
    return np.asarray(face(jnp.asarray(x))), np.asarray(tri)


DENSE_CASES = {
    "random": (lambda: mesh_random(False), 24, False),
    "random_persp": (lambda: mesh_random(True), 24, True),
    "sphere": (mesh_sphere, 32, False),
    "big_triangles": (mesh_big_triangles, 32, False),
    "degenerate": (mesh_degenerate, 16, False),
}


@pytest.mark.parametrize("case", sorted(DENSE_CASES))
def test_dense_winners_equal_jax(case):
    make, h, persp = DENSE_CASES[case]
    v, tri = make()
    ref = np.asarray(j_rasterize_winners(jnp.asarray(v), jnp.asarray(tri), h, h, persp))
    out = rasterize_winners(_t(v), _t(tri), h, h, persp).numpy()
    np.testing.assert_array_equal(out, ref)
    assert (out >= 0).any()
    if case == "degenerate":
        assert {1, 2} <= set(out.reshape(-1))  # the segment and the point won pixels


@pytest.mark.parametrize("perspective", [False, True])
def test_rasterize_values_match_jax(perspective):
    v, tri = mesh_random(perspective, seed=3, nv=50, nf=160, scale=0.6)
    attrs = np.random.RandomState(4).randn(2, 50, 3).astype(np.float32)
    for s in (32, 16):
        ref = np.asarray(j_rasterize(jnp.asarray(v), jnp.asarray(attrs),
                                     jnp.asarray(tri), s, s, perspective))
        out = rasterize(_t(v), _t(attrs), _t(tri), s, s, perspective).numpy()
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)


def test_index_coeff_match_jax():
    """The reference op's outputs: per-pixel vertex ids equal, coefficients
    to f32 rounding, both zero on background; the degenerate mesh's segment
    and point exercise the fallback coefficients."""
    v, tri = mesh_degenerate()
    ref_idx, ref_c = j_rasterize_index_coeff(jnp.asarray(v), jnp.asarray(tri), 16)
    idx, coeff = rasterize_index_coeff(_t(v), _t(tri), 16)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    np.testing.assert_allclose(coeff.numpy(), np.asarray(ref_c), rtol=0, atol=1e-6)
    assert (coeff.numpy() == 1.0).any()  # the point's corner takes it all


MULTI_MESHES = {
    "random": (lambda: mesh_random(False, seed=3, nv=50, nf=160, scale=0.6), False),
    "random_persp": (lambda: mesh_random(True, seed=3, nv=50, nf=160, scale=0.6), True),
    "sphere": (mesh_sphere, False),
}


@pytest.mark.parametrize("case", sorted(MULTI_MESHES))
def test_build_bins_matches_jax(case):
    make, persp = MULTI_MESHES[case]
    v, tri = make()
    top, n_levels, tile = 64, 5, 16
    jdat, jstarts = jrp.build_bins_multi(jnp.asarray(v), jnp.asarray(tri), top, n_levels,
                                         persp, 1e-6, tile)
    jstarts = np.asarray(jstarts)
    jids = np.asarray(jdat)[:, 9, :].astype(np.int64)
    dat, ids, starts = build_bins_multi(_t(v), _t(tri), top, n_levels, persp, 1e-6, tile)
    np.testing.assert_array_equal(starts.numpy(), jstarts)
    assert starts.shape[-1] == MULTI_N_TIERS * (top // tile) ** 2 + 1
    ids = ids.numpy()
    for b in range(v.shape[0]):
        for lo, hi in zip(jstarts[b, :-1], jstarts[b, 1:]):
            assert set(ids[b, lo:hi]) == set(jids[b, lo:hi])
    # each sorted row carries its triangle's projected corners
    px = (1.0 + v[..., 0]) * (top / 2.0) - 0.5 if not persp else None
    if px is not None:
        np.testing.assert_array_equal(dat[0, :, 0].numpy(), px[0, tri[ids[0], 0]])


def _jax_multi(v, tri, top, n_levels, persp, attrs, tile):
    return jrp.rasterize_winners_pallas_multi(
        jnp.asarray(v), jnp.asarray(tri), top, n_levels, persp, 1e-6, interpret=True,
        attrs=None if attrs is None else jnp.asarray(attrs), tile=tile)


# (mesh, top, n_levels, tile, with_attrs). Tile 16 as on the main path; the
# levels whose pixels are larger than a tile are sparse (rows owned by one
# tile): the 1 px level at top=32, the 2 and 1 px levels at top=64.
MULTI_CASES = [
    ("random", 32, 6, 16, False), ("random", 32, 6, 16, True),
    ("random_persp", 32, 5, 16, True), ("sphere", 32, 4, 16, True),
    ("random", 64, 7, 16, False), ("random", 64, 7, 16, True),
]


@pytest.mark.parametrize("case,top,n_levels,tile,with_attrs", MULTI_CASES)
def test_multi_ref_matches_jax_interpret(case, top, n_levels, tile, with_attrs):
    """The plain version against the JAX Pallas kernel (interpret mode) at
    every level: winners bit for bit. Values bit for bit against the dense
    ``rasterize`` at that level (held against the JAX package's by
    test_rasterize_values_match_jax). The interpret-mode kernel itself rounds
    differently from the JAX dense oracle on the CPU (XLA fuses its
    arithmetic differently): on these meshes by up to 2.6e-4, at the
    sphere's sliver pixels where the coefficient sums cancel, so against it
    values hold to 5e-4."""
    make, persp = MULTI_MESHES[case]
    v, tri = make()
    attrs = (np.random.RandomState(5).randn(*v.shape).astype(np.float32)
             if with_attrs else None)
    ref = rasterize_winners_multi_ref(_t(v), _t(tri), top, n_levels, persp,
                                      attrs=None if attrs is None else _t(attrs), tile=tile)
    jout = _jax_multi(v, tri, top, n_levels, persp, attrs, tile)
    assert len(ref) == len(jout) == n_levels
    for k, (a, b) in enumerate(zip(ref, jout)):
        if with_attrs:
            s = top >> k
            np.testing.assert_array_equal(a[1].numpy(), np.asarray(b[1]), err_msg=f"win {k}")
            dense = rasterize(_t(v), _t(attrs), _t(tri), s, s, persp)
            np.testing.assert_array_equal(a[0].numpy(), dense.numpy(), err_msg=f"val {k}")
            np.testing.assert_allclose(a[0].numpy(), np.asarray(b[0]), rtol=0, atol=5e-4,
                                       err_msg=f"val {k}")
        else:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f"win {k}")


def test_multi_degenerate_and_xl_matches_jax():
    v, tri = mesh_degenerate()
    attrs = np.random.RandomState(6).randn(*v.shape).astype(np.float32)
    ref = rasterize_winners_multi_ref(_t(v), _t(tri), 16, 2, attrs=_t(attrs))
    jout = _jax_multi(v, tri, 16, 2, False, attrs, 16)
    for k, ((va, wa), (vb, wb)) in enumerate(zip(ref, jout)):
        np.testing.assert_array_equal(wa.numpy(), np.asarray(wb))
        dense = rasterize(_t(v), _t(attrs), _t(tri), 16 >> k, 16 >> k)
        np.testing.assert_array_equal(va.numpy(), dense.numpy())
        np.testing.assert_allclose(va.numpy(), np.asarray(vb), rtol=0, atol=1e-4)
    assert {1, 2} <= set(ref[0][1].numpy().reshape(-1))


def test_cpu_wrapper_takes_plain_version():
    v, tri = mesh_random(False, seed=3, nv=50, nf=160, scale=0.6)
    before = rasterize_winners_multi.launches
    out = rasterize_winners_multi(_t(v), _t(tri), 32, 3)
    ref = rasterize_winners_multi_ref(_t(v), _t(tri), 32, 3)
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert rasterize_winners_multi.launches == before  # no kernel on the CPU


def test_card_binning_refuses_cpu_tensors():
    v, tri = mesh_random(False, seed=3, nv=50, nf=160, scale=0.6)
    with pytest.raises(ValueError, match="CUDA"):
        launch_bin_multi(_t(v), _t(tri), 32, 3, False, 1e-6, 16)


@pytest.mark.parametrize("lo,hi", [(-1.1, 1.1), (-100.0, 100.0), (-1e-3, 1e-3)])
def test_level_rescale_equals_projection(lo, hi):
    """The kernel stores corners projected at the top level and rescales
    them per level, ``px*2^-k + (2^-(k+1) - 0.5)``; the plain version
    projects at the level, ``(1+x)*(s/2) - 0.5``. The two are equal in f32
    (``1+x`` is a multiple of 2^-24, so the shifted sum is exact), which is
    what lets the kernel's values equal the plain version's bit for bit."""
    f = np.float32
    x = np.random.RandomState(0).uniform(lo, hi, 200_000).astype(f)
    t = f(1) + x
    for top in (256, 64):
        ptop = t * f(top / 2) - f(0.5)
        for k in range(1, 7):
            inv = f(1.0 / (1 << k))
            resc = ptop * inv + (inv * f(0.5) - f(0.5))
            direct = t * f((top >> k) / 2) - f(0.5)
            np.testing.assert_array_equal(resc, direct, err_msg=f"top {top} level {k}")


def test_fused_rule_and_sparse_assert():
    assert _multi_levels([4, 8, 16, 32], "auto", 3) == [32, 16, 8, 4]
    assert _multi_levels([4, 8, 32], "auto", 3) == [32]
    assert _multi_levels([4, 8, 16, 32], "auto", 8) == []  # > 7 channels
    assert _multi_levels([4, 8, 16, 24], "auto", 3) == []  # top % tile
    assert _multi_levels([4, 8, 16, 32], "dense", 3) == []
    assert _sparse_sp(256, 8, 16) == (2, 0)
    assert _sparse_sp(256, 4, 16) == (4, 1)
    with pytest.raises(ValueError, match="power of two"):
        _sparse_sp(48, 4, 16)
    with pytest.raises(ValueError, match="multiple of the tile"):
        rasterize_winners_multi(torch.zeros(1, 3, 3), torch.zeros(1, 3), 40, 2, tile=16)


def test_pyramid_matches_per_level_rasterize():
    v, tri = mesh_sphere(seed=7)
    n = np.asarray(j_mesh_point_normal(jnp.asarray(v), jnp.asarray(tri)))
    sizes = [4, 8, 16, 32]
    fused = rasterize_pyramid_fused(_t(v), _t(n), _t(tri), sizes)
    plain = rasterize_pyramid(_t(v), _t(n), _t(tri), sizes)
    for s, a, b in zip(sizes, fused, plain):
        ref = rasterize(_t(v), _t(n), _t(tri), s, s)
        torch.testing.assert_close(a, ref, rtol=0, atol=0)
        torch.testing.assert_close(b, ref, rtol=0, atol=0)


@pytest.mark.parametrize("perspective,scale", [(False, 1e-3), (True, 0.1)])
def test_fused_pyramid_gradients_match_jax(perspective, scale):
    """First-order gradients of the port's rasterize_pyramid_fused in v and
    tex against jax.grad of JAX rasterize_pyramid. The cotangents are scaled
    so that the largest vertex gradient is of order 1: the vertex gradient
    is a sum over pixels in another order than JAX's segment sum, so the
    absolute tolerance is one of f32 rounding at that scale (unscaled, the
    sphere's vertex gradients reach ~750 and the sums differ by ~1e-3)."""
    if perspective:
        v, tri = mesh_random(True, seed=3, nv=50, nf=160, scale=0.6)
    else:
        v, tri = mesh_sphere(seed=7)
    tex = np.random.RandomState(9).randn(*v.shape).astype(np.float32)
    sizes = [4, 8, 16, 32]
    w = [np.random.RandomState(10 + i).randn(2, s, s, 3).astype(np.float32) * scale
         for i, s in enumerate(sizes)]

    def j_loss(v_, t_):
        maps = j_rasterize_pyramid(v_, t_, jnp.asarray(tri), sizes, perspective)
        return sum(jnp.sum(m * jnp.asarray(wi)) for m, wi in zip(maps, w))

    gv_j, gt_j = jax.grad(j_loss, argnums=(0, 1))(jnp.asarray(v), jnp.asarray(tex))
    vt = _t(v).requires_grad_(True)
    tt = _t(tex).requires_grad_(True)
    maps = rasterize_pyramid_fused(vt, tt, _t(tri), sizes, perspective)
    sum((m * _t(wi)).sum() for m, wi in zip(maps, w)).backward()
    np.testing.assert_allclose(vt.grad.numpy(), np.asarray(gv_j), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(gt_j), rtol=0, atol=1e-5)
    assert 0.1 < np.abs(np.asarray(gv_j)).max() < 10
    assert np.abs(np.asarray(gt_j)).max() > 1e-4


# ---- the kernel's math built for the host ---------------------------------

def _host_case(name):
    if name == "sphere":
        v, tri = mesh_sphere(seed=7)
        return v, tri, np.random.RandomState(8).randn(*v.shape).astype(np.float32), 32, 4, 16, False
    return kernel_case(name)


@pytest.fixture(scope="module")
def host_build():
    import shutil

    if shutil.which("g++") is None:
        pytest.skip("no g++ on PATH: the host build of the kernel's math cannot be made")
    from stylerenderer_tpu_torch.ops._build import library

    return library("multi_host")


def _host_bins_case(case):
    """-> (v, tri, attrs, top, n_levels, tile, perspective): the
    ``MULTI_MESHES`` meshes at the layout of test_build_bins_matches_jax,
    or a ``KERNEL_CASES`` entry."""
    if case.startswith("multi:"):
        make, persp = MULTI_MESHES[case[6:]]
        v, tri = make()
        return v, tri, np.random.RandomState(8).randn(*v.shape).astype(np.float32), 64, 5, 16, persp
    return kernel_case(case)


@pytest.mark.parametrize("case", [f"multi:{m}" for m in sorted(MULTI_MESHES)]
                         + sorted(KERNEL_CASES))
def test_host_binning_matches_plain(host_build, case):
    """The card's binning passes built for the host: the plain binning's
    keys and starts, the same ids in every segment, the same row (corner
    px, py, z, corner attributes) for every id, and each id's slot."""
    v, tri, attrs, top, n_levels, tile, persp = _host_bins_case(case)
    rows, starts, slots, keys = bin_multi_host(_t(v), _t(tri), top, n_levels, persp, 1e-6,
                                               tile, _t(attrs))
    dat, ids, pstarts = build_bins_multi(_t(v), _t(tri), top, n_levels, persp, 1e-6, tile,
                                         _t(attrs))
    np.testing.assert_array_equal(starts.numpy(), pstarts.numpy())
    np.testing.assert_array_equal(keys.numpy(), keys_of_bins(ids.numpy(), pstarts.numpy()))
    R = dat.shape[-1]
    rid = rows[..., R].contiguous().view(torch.int32).numpy()
    ids = ids.numpy()
    for b in range(v.shape[0]):
        st = pstarts[b].numpy()
        for lo, hi in zip(st[:-1], st[1:]):
            assert set(rid[b, lo:hi]) == set(ids[b, lo:hi])
        n = st[-1]
        mine = rows[b, :n, :R].numpy()[np.argsort(rid[b, :n])]
        plain = dat[b, :n].numpy()[np.argsort(ids[b, :n])]
        np.testing.assert_array_equal(mine, plain)
        np.testing.assert_array_equal(slots[b].numpy()[rid[b, :n]], np.arange(n))
    assert starts[:, -1].min() > 0


@pytest.mark.parametrize("with_attrs", [False, True])
@pytest.mark.parametrize("case", sorted(KERNEL_CASES))
def test_host_kernel_order_independent(host_build, case, with_attrs):
    """The card's atomic slots order each segment differently from run to
    run: the kernel's per-tile logic (host build) on every segment reversed,
    each id's slot following its row, gives the same winners and values."""
    v, tri, attrs, top, n_levels, tile, persp = kernel_case(case)
    attrs = _t(attrs) if with_attrs else None
    n_attr = 0 if attrs is None else attrs.shape[-1]
    rows, starts, slots, _ = bin_multi_host(_t(v), _t(tri), top, n_levels, persp, 1e-6, tile,
                                            attrs)
    rev, rev_slots = rows.clone(), slots.clone()
    for b in range(rows.shape[0]):
        st = starts[b].tolist()
        for lo, hi in zip(st[:-1], st[1:]):
            rev[b, lo:hi] = rows[b, lo:hi].flip(0)
        n = st[-1]
        ids = rev[b, :n, 9 + 3 * n_attr].contiguous().view(torch.int32).long()
        rev_slots[b, ids] = torch.arange(n, dtype=torch.int32)
    assert not torch.equal(rev, rows)
    args = (top, n_levels, tile, n_attr, persp, 1e-6)
    out = rasterize_bins_multi_host(rows, starts, slots, *args)
    out_rev = rasterize_bins_multi_host(rev, starts, rev_slots, *args)
    for k, (a, b) in enumerate(zip(out, out_rev)):
        for x, y in zip(a, b) if with_attrs else [(a, b)]:
            np.testing.assert_array_equal(x.numpy(), y.numpy(), err_msg=f"level {k}")


@pytest.mark.parametrize("case", sorted(KERNEL_CASES))
def test_host_kernel_queue_flush(host_build, case):
    """The kernel's per-tile schedule with its coarse-level queue worked
    through between rounds: rounds of 4 candidates and a queue that holds
    one round's pushes (a flush after nearly every round) give the same
    winners and values as the kernel's own sizes, and the ``dense_tile``
    case fills the kernel's own queue several times."""
    v, tri, attrs, top, n_levels, tile, persp = kernel_case(case)
    rows, starts, slots, _ = bin_multi_host(_t(v), _t(tri), top, n_levels, persp, 1e-6, tile,
                                            _t(attrs))
    args = (rows, starts, slots, top, n_levels, tile, attrs.shape[-1], persp, 1e-6)
    card, small = {}, {}
    out = rasterize_bins_multi_host(*args, stats=card)
    out_small = rasterize_bins_multi_host(*args, round_size=4, queue=4 * (n_levels - 1),
                                          stats=small)
    for k, (a, b) in enumerate(zip(out, out_small)):
        np.testing.assert_array_equal(a[1].numpy(), b[1].numpy(), err_msg=f"win {k}")
        np.testing.assert_array_equal(a[0].numpy(), b[0].numpy(), err_msg=f"val {k}")
    assert small["flushes"] > 0
    if case == "dense_tile":
        assert card["flushes"] >= 2 * v.shape[0]
    with pytest.raises(RuntimeError, match="rejected"):
        rasterize_bins_multi_host(*args, round_size=4, queue=4 * (n_levels - 1) - 1)


@pytest.mark.parametrize("with_attrs", [False, True])
@pytest.mark.parametrize("case", sorted(KERNEL_CASES) + ["sphere"])
def test_host_kernel_math_bitexact(host_build, case, with_attrs):
    """The card's binning and the kernel's per-tile logic and candidate math
    (g++, -ffp-contract=off) equal the plain version bit for bit at every
    level."""
    v, tri, attrs, top, n_levels, tile, persp = _host_case(case)
    attrs = _t(attrs) if with_attrs else None
    host = rasterize_winners_multi_host(_t(v), _t(tri), top, n_levels, persp,
                                        attrs=attrs, tile=tile)
    ref = rasterize_winners_multi_ref(_t(v), _t(tri), top, n_levels, persp,
                                      attrs=attrs, tile=tile)
    for k, (a, b) in enumerate(zip(host, ref)):
        if with_attrs:
            np.testing.assert_array_equal(a[1].numpy(), b[1].numpy(), err_msg=f"win {k}")
            np.testing.assert_array_equal(a[0].numpy(), b[0].numpy(), err_msg=f"val {k}")
        else:
            np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=f"win {k}")
    assert (ref[0][1] if with_attrs else ref[0]).max() >= 0

"""The multi-level kernel's math against the JAX package and against the
port's own plain version (split from ``test_torch_rasterize.py``).

- the plain version ``rasterize_winners_multi_ref`` against the JAX Pallas
  kernel in interpret mode: winners equal, values to the interpret mode's
  own rounding; the CPU wrapper, the level rescale, the fused rule;
- the host build (g++) of the card's binning against the plain binning
  ``build_bins_multi``, and of the kernel's per-tile logic and math, bit
  for bit against the plain version, in any order within a segment (the
  CUDA passes themselves: ``test_torch_gpu.py``);
- NaN depths in every backend, the binned search's included.

Inputs are made with numpy from seeds and handed to both packages.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import stylerenderer_tpu.ops.rasterize_pallas as jrp
from stylerenderer_tpu.ops.rasterize import rasterize_winners as j_rasterize_winners

from stylerenderer_tpu_torch.ops.rasterize import (
    _multi_levels,
    rasterize,
    rasterize_pyramid_fused,
    rasterize_winners,
)
from torch_meshes import (
    KERNEL_CASES,
    NAN_DEPTH_PIXELS_16,
    kernel_case,
    keys_of_bins,
    mesh_degenerate,
    mesh_nan_depth,
    mesh_nan_depth_chunks,
    mesh_random,
)

from stylerenderer_tpu_torch.ops.rasterize_multi import (
    _sparse_sp,
    bin_multi_host,
    build_bins_multi,
    launch_bin_multi,
    rasterize_bins_multi_host,
    rasterize_winners_multi,
    rasterize_winners_multi_host,
    rasterize_winners_multi_ref,
)
from test_torch_rasterize import MULTI_MESHES, _t, mesh_sphere
from torch_threads import _one_thread  # noqa: F401


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


# ---- NaN depths --------------------------------------------------------------

def _jax_k2_interpret(monkeypatch, v, tri, h):
    from jax.experimental import pallas as pl

    orig = pl.pallas_call
    monkeypatch.setattr(jrp.pl, "pallas_call",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))
    return np.asarray(jrp.rasterize_winners_pallas(jnp.asarray(v), jnp.asarray(tri), h, h))


@pytest.mark.parametrize("case,nan_id,winner", [("nan_depth", 1, 2),
                                                ("nan_depth_chunks", 2, 0)])
def test_nan_depth_six_backends(host_build, monkeypatch, case, nan_id, winner):
    """A covered NaN depth blanks its pixel at that level: -1 and the
    background value, in the JAX Pallas kernels (K2, and K1 at every level,
    interpret mode), the port's dense oracle at any chunk, its plain K1,
    and the host builds of K1 and K2; elsewhere the finite triangle in
    front wins. The JAX dense oracle agrees while the NaN shares a chunk
    with every triangle, but at ``chunk=2`` on the two-chunk mesh it skips
    only the NaN's chunk, so the winner in front keeps those pixels: a
    caveat of the reference, recorded here as it is."""
    from stylerenderer_tpu_torch.ops.rasterize_single import rasterize_winners_single_host

    v, tri, attrs, top, n_levels, tile, _ = kernel_case(case)
    big = rasterize_winners(_t(v), _t(tri[[winner]]), 16, 16).numpy() >= 0
    front = np.where(big, winner, -1).astype(np.int32)
    expect = front.copy()
    expect[tuple(np.asarray(NAN_DEPTH_PIXELS_16).T)] = -1
    assert (front[expect == -1] == winner).sum() == len(NAN_DEPTH_PIXELS_16)

    np.testing.assert_array_equal(
        np.asarray(j_rasterize_winners(jnp.asarray(v), jnp.asarray(tri), 16, 16)), expect)
    np.testing.assert_array_equal(
        np.asarray(j_rasterize_winners(jnp.asarray(v), jnp.asarray(tri), 16, 16, chunk=2)),
        front if case == "nan_depth_chunks" else np.where(expect == -1, front, expect))
    np.testing.assert_array_equal(_jax_k2_interpret(monkeypatch, v, tri, 16), expect)
    for chunk in (1, 2, None):
        np.testing.assert_array_equal(
            rasterize_winners(_t(v), _t(tri), 16, 16, chunk=chunk).numpy(), expect)
    np.testing.assert_array_equal(
        rasterize_winners_single_host(_t(v), _t(tri), 16, 16, tile=8).numpy(), expect)

    jk1 = _jax_multi(v, tri, top, n_levels, False, attrs, tile)
    ref = rasterize_winners_multi_ref(_t(v), _t(tri), top, n_levels, attrs=_t(attrs),
                                      tile=tile)
    host = rasterize_winners_multi_host(_t(v), _t(tri), top, n_levels, attrs=_t(attrs),
                                        tile=tile)
    for k, ((jv, jw), (rv, rw), (hv, hw)) in enumerate(zip(jk1, ref, host)):
        s = top >> k
        if k == 0:
            np.testing.assert_array_equal(rw.numpy(), expect)
        plain = rasterize_winners(_t(v), _t(tri), s, s).numpy()
        np.testing.assert_array_equal(rw.numpy(), plain, err_msg=f"level {k}")
        np.testing.assert_array_equal(np.asarray(jw), plain, err_msg=f"level {k}")
        np.testing.assert_array_equal(hw.numpy(), plain, err_msg=f"level {k}")
        np.testing.assert_array_equal(hv.numpy(), rv.numpy(), err_msg=f"level {k}")
        assert (rv.numpy()[plain == -1] == 0).all()
        np.testing.assert_allclose(rv.numpy(), np.asarray(jv), rtol=0, atol=1e-6)
    assert (ref[1][1].numpy() == -1).sum() > (rasterize_winners(
        _t(v), _t(tri[[winner]]), 8, 8).numpy() == -1).sum()  # blanked at 8 px too


@pytest.mark.parametrize("case", ["nan_depth", "nan_depth_chunks"])
def test_nan_depth_binned(case):
    """The binned search, the port's and JAX's, blanks a covered NaN depth
    like the other backends: -1 at all nine pixels, the dense winners
    elsewhere."""
    from stylerenderer_tpu.ops.rasterize_binned import rasterize_winners_binned as j_binned

    from stylerenderer_tpu_torch.ops.rasterize_binned import rasterize_winners_binned

    v, tri = {"nan_depth": mesh_nan_depth, "nan_depth_chunks": mesh_nan_depth_chunks}[case]()
    expect = rasterize_winners(_t(v), _t(tri), 16, 16).numpy()
    assert (expect[tuple(np.asarray(NAN_DEPTH_PIXELS_16).T)] == -1).all()
    for k_list in ((8, 32), (4,)):
        np.testing.assert_array_equal(
            rasterize_winners_binned(_t(v), _t(tri), 16, 16, k_list=k_list).numpy(), expect)
        np.testing.assert_array_equal(
            np.asarray(j_binned(jnp.asarray(v), jnp.asarray(tri), 16, 16, k_list=k_list)), expect)


def test_nan_depth_gradients():
    """A pixel that a NaN depth blanks passes no gradient to the vertices or
    the attributes, in the dense ``rasterize`` and the fused pyramid, and
    the gradients of the whole map stay finite."""
    v, tri = mesh_nan_depth()
    tex = np.random.RandomState(3).randn(*v.shape).astype(np.float32)
    b, y, x = NAN_DEPTH_PIXELS_16[0]
    for fn in (lambda vt, tt: rasterize(vt, tt, _t(tri), 16, 16),
               lambda vt, tt: rasterize_pyramid_fused(vt, tt, _t(tri), [16, 8, 4])[0]):
        for pixel_only in (True, False):
            vt = _t(v).requires_grad_(True)
            tt = _t(tex).requires_grad_(True)
            out = fn(vt, tt)
            assert (out[b, y, x] == 0).all()
            (out[b, y, x].sum() if pixel_only else out.sum()).backward()
            gv, gt = vt.grad.numpy(), tt.grad.numpy()
            if pixel_only:
                assert (gv == 0).all() and (gt == 0).all()
            else:
                assert np.isfinite(gv).all() and np.isfinite(gt).all()
                assert np.abs(gt).max() > 0 and (gv[:, 3:6] == 0).all()

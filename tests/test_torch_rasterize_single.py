"""The port's single-level tile rasterizer against the JAX package and
against its own plain version.

- the host build (g++) of the card's binning, bit for bit against the plain
  binning ``build_bins`` (keys, starts, ids per segment, rows), and of the
  kernel's math, worklists and per-tile schedule, bit for bit against the
  plain version, in any order within a segment and at any round size (the
  CUDA kernel and binning themselves: ``test_torch_gpu.py``);
- binning: ``starts`` equal to JAX ``build_bins``', the same triangle ids
  in every segment;
- the plain version and the host build against the JAX Pallas kernel in
  interpret mode: winners equal;
- the method names: the dispatch rule, ``"pallas"`` and ``"binned"`` in
  ``rasterize``, ``"pallas_multi"`` in the pyramid functions only.

Inputs are made with numpy from seeds and handed to both packages.
"""

import importlib
import shutil

import numpy as np
import pytest
import jax.numpy as jnp
import torch
from jax.experimental import pallas as pl

import stylerenderer_tpu.ops.rasterize_pallas as jrp
from stylerenderer_tpu.ops.rasterize import rasterize_winners as j_rasterize_winners

from torch_meshes import SINGLE_CASES, keys_of_bins, single_case

from stylerenderer_tpu_torch.ops import rasterize_single as rs
from stylerenderer_tpu_torch.ops.rasterize import (
    rasterize, rasterize_index_coeff, rasterize_pyramid, rasterize_pyramid_fused,
)
from torch_threads import _one_thread  # noqa: F401


# the module, which the package's ``rasterize`` function shadows
port_rasterize = importlib.import_module("stylerenderer_tpu_torch.ops.rasterize")


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def host_build():
    if shutil.which("g++") is None:
        pytest.skip("no g++ on PATH: the host build of the kernel's math cannot be made")
    from stylerenderer_tpu_torch.ops._build import library

    return library("single_host")


@pytest.fixture
def interpret_mode(monkeypatch):
    """The JAX Pallas kernel in interpret mode, as the JAX package's own
    tests run it on the CPU."""
    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(jrp.pl, "pallas_call", patched)


@pytest.mark.parametrize("case", sorted(SINGLE_CASES))
def test_host_kernel_math_bitexact(host_build, case):
    """The card's binning and the kernel's candidate math, worklists and
    schedule (g++, -ffp-contract=off) equal the plain version bit for bit,
    at tiles 8, 16 and 32, on square and rectangular images and with edge
    tiles that stick out."""
    v, tri, h, w, tile, persp = single_case(case)
    host = rs.rasterize_winners_single_host(_t(v), _t(tri), h, w, persp, tile=tile)
    ref = rs.rasterize_winners_single_ref(_t(v), _t(tri), h, w, persp)
    assert host.shape == (v.shape[0], h, w)
    np.testing.assert_array_equal(host.numpy(), ref.numpy())
    assert (ref >= 0).any()
    if case == "degenerate":
        assert {1, 2} <= set(ref.numpy().reshape(-1))  # the segment and the point won pixels


@pytest.mark.parametrize("case", sorted(SINGLE_CASES))
def test_host_binning_matches_plain(host_build, case):
    """The card's binning passes built for the host: the plain binning's
    keys and starts, the same ids in every segment and the same row
    (corner px, py, z) for every id."""
    v, tri, h, w, tile, persp = single_case(case)
    rows, starts, keys = rs.bin_single_host(_t(v), _t(tri), h, w, persp, 1e-6, tile)
    dat, ids, pstarts = rs.build_bins(_t(v), _t(tri), h, w, persp, 1e-6, tile)
    np.testing.assert_array_equal(starts.numpy(), pstarts.numpy())
    np.testing.assert_array_equal(keys.numpy(), keys_of_bins(ids.numpy(), pstarts.numpy()))
    rid = rows[..., 9].contiguous().view(torch.int32).numpy()
    ids = ids.numpy()
    for b in range(v.shape[0]):
        st = pstarts[b].numpy()
        for lo, hi in zip(st[:-1], st[1:]):
            assert set(rid[b, lo:hi]) == set(ids[b, lo:hi])
        n = st[-1]
        mine = rows[b, :n, :9].numpy()[np.argsort(rid[b, :n])]
        plain = dat[b, :n].numpy()[np.argsort(ids[b, :n])]
        np.testing.assert_array_equal(mine, plain)
    assert starts[:, -1].min() > 0


@pytest.mark.parametrize("case", sorted(SINGLE_CASES))
def test_host_kernel_order_independent(host_build, case):
    """The card's atomic slots order each segment differently from run to
    run: the kernel's per-tile schedule (host build) on every segment
    reversed gives the same winners."""
    v, tri, h, w, tile, persp = single_case(case)
    rows, starts, _ = rs.bin_single_host(_t(v), _t(tri), h, w, persp, 1e-6, tile)
    rev = rows.clone()
    for b in range(rows.shape[0]):
        st = starts[b].tolist()
        for lo, hi in zip(st[:-1], st[1:]):
            rev[b, lo:hi] = rows[b, lo:hi].flip(0)
    if (starts.diff(dim=-1) > 1).any():  # some segment holds two triangles
        assert not torch.equal(rev, rows)
    out = rs.rasterize_bins_single_host(rows, starts, h, w, tile, persp)
    out_rev = rs.rasterize_bins_single_host(rev, starts, h, w, tile, persp)
    np.testing.assert_array_equal(out.numpy(), out_rev.numpy())


@pytest.mark.parametrize("case", sorted(SINGLE_CASES))
def test_host_kernel_small_rounds(host_build, case):
    """The kernel's schedule in rounds of 4 candidates (a partial warp each)
    and of two warps equals the dense oracle bit for bit, as its own block
    size does; the ``dense_tile`` case runs many rounds of the kernel's own
    block in one tile."""
    v, tri, h, w, tile, persp = single_case(case)
    rows, starts, _ = rs.bin_single_host(_t(v), _t(tri), h, w, persp, 1e-6, tile)
    ref = rs.rasterize_winners_single_ref(_t(v), _t(tri), h, w, persp)
    for round_size in (4, 64):
        out = rs.rasterize_bins_single_host(rows, starts, h, w, tile, persp,
                                            round_size=round_size)
        np.testing.assert_array_equal(out.numpy(), ref.numpy(), err_msg=f"rounds {round_size}")
    if case == "dense_tile":
        assert starts[:, -1].min() > 8 * 256  # valid triangles, all within 3 x 3 tiles
    for bad in (-1, 48):
        with pytest.raises(RuntimeError, match="rejected"):
            rs.rasterize_bins_single_host(rows, starts, h, w, tile, persp, round_size=bad)


def test_card_binning_refuses_cpu_tensors():
    v, tri, h, w, tile, persp = single_case("random")
    with pytest.raises(ValueError, match="CUDA tensors"):
        rs.launch_bin_single(_t(v), _t(tri), h, w, persp, 1e-6, tile)


# perspective and rectangular, the sphere's dense tier-0 bins, tile 32
BINS_CASES = ["rect_24x40_persp", "sphere", "random_tile32"]


@pytest.mark.parametrize("case", BINS_CASES)
def test_build_bins_matches_jax(case):
    v, tri, h, w, tile, persp = single_case(case)
    jdat, jstarts = jrp.build_bins(jnp.asarray(v), jnp.asarray(tri), h, w, persp, 1e-6, tile)
    jstarts = np.asarray(jstarts)
    jids = np.asarray(jdat)[:, 9, :].astype(np.int64)
    dat, ids, starts = rs.build_bins(_t(v), _t(tri), h, w, persp, 1e-6, tile)
    assert starts.shape[-1] == rs.N_TIERS * (h // tile) * (w // tile) + 1
    np.testing.assert_array_equal(starts.numpy(), jstarts)
    ids = ids.numpy()
    for b in range(v.shape[0]):
        for lo, hi in zip(jstarts[b, :-1], jstarts[b, 1:]):
            assert set(ids[b, lo:hi]) == set(jids[b, lo:hi])
        # each sorted row carries its triangle's projected corners, as JAX's
        n = int(jstarts[b, -1])
        order = np.argsort(jids[b, :n], kind="stable")
        mine = np.argsort(ids[b, :n], kind="stable")
        np.testing.assert_array_equal(dat[b, mine, :].numpy(),
                                      np.asarray(jdat)[b, :9, order].reshape(n, 9))


def test_bins_reach_every_tier():
    """The cases route triangles to every span tier and to XL."""
    seen = set()
    for case in SINGLE_CASES:
        v, tri, h, w, tile, persp = single_case(case)
        _, _, starts = rs.build_bins(_t(v), _t(tri), h, w, persp, 1e-6, tile)
        ntiles = -(-h // tile) * -(-w // tile)
        for tier in range(rs.N_TIERS):
            if (starts[:, (tier + 1) * ntiles] > starts[:, tier * ntiles]).any():
                seen.add(tier)
    assert seen == set(range(rs.N_TIERS))


# perspective; degenerate triangles and the XL tier; a rectangular image
# (each case compiles the interpret-mode kernel anew, ~8 s on the CPU)
JAX_CASES = ["random_persp", "degenerate", "rect_40x24"]


@pytest.mark.parametrize("case", JAX_CASES)
def test_single_matches_jax_interpret(host_build, interpret_mode, monkeypatch, case):
    """The plain version and the host build against JAX
    ``rasterize_winners_pallas`` (interpret mode) and the JAX dense oracle:
    winners equal."""
    v, tri, h, w, tile, persp = single_case(case)
    monkeypatch.setattr(jrp, "_tile_for", lambda h_, w_: tile)
    jout = np.asarray(jrp.rasterize_winners_pallas(jnp.asarray(v), jnp.asarray(tri), h, w,
                                                   persp))
    jdense = np.asarray(j_rasterize_winners(jnp.asarray(v), jnp.asarray(tri), h, w, persp))
    np.testing.assert_array_equal(jout, jdense)
    ref = rs.rasterize_winners_single_ref(_t(v), _t(tri), h, w, persp)
    host = rs.rasterize_winners_single_host(_t(v), _t(tri), h, w, persp, tile=tile)
    np.testing.assert_array_equal(ref.numpy(), jout)
    np.testing.assert_array_equal(host.numpy(), jout)


def test_tile_for_matches_jax():
    for h, w in [(8, 8), (256, 256), (256, 192), (264, 264), (512, 384), (520, 8), (1024, 1024)]:
        assert rs.tile_for(h, w) == jrp._tile_for(h, w)


def test_card_tile():
    """The card path's tile: 16 px up to 256 px on the longer side, 32
    beyond; the wrapper takes it when no tile is given."""
    for h, w, tile in [(8, 8, 16), (256, 256, 16), (256, 192, 16), (192, 257, 32),
                       (512, 512, 32), (1024, 1024, 32)]:
        assert rs.card_tile(h, w) == tile, (h, w)
    assert rs._check_args(torch.zeros(1, 3, 3), 256, 192, None) == 16


def test_cpu_wrapper_takes_plain_version():
    v, tri, h, w, tile, persp = single_case("rect_40x24")
    before = rs.rasterize_winners_single.launches
    out = rs.rasterize_winners_single(_t(v), _t(tri), h, w, persp, tile=tile)
    ref = rs.rasterize_winners_single_ref(_t(v), _t(tri), h, w, persp)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    assert rs.rasterize_winners_single.launches == before  # no kernel on the CPU
    with pytest.raises(ValueError, match="1 to 32"):
        rs.rasterize_winners_single(_t(v), _t(tri), h, w, tile=64)


def _spy(monkeypatch, module, name):
    calls = []
    orig = getattr(module, name)

    def spy(*args, **kwargs):
        calls.append(name)
        return orig(*args, **kwargs)

    monkeypatch.setattr(module, name, spy)
    return calls


def test_auto_dispatch_rule(monkeypatch):
    """``"auto"`` on a CPU tensor takes the binned search exactly when
    ``nf*h*w > 2^24`` and h, w are multiples of 8 (the JAX rule off the
    TPU), and the dense search otherwise; never the single-level kernel's
    wrapper (the card's ``"auto"``: ``test_torch_gpu.py``)."""
    import stylerenderer_tpu_torch.ops.rasterize_binned as rb

    single = _spy(monkeypatch, rs, "rasterize_winners_single")
    binned = _spy(monkeypatch, rb, "rasterize_winners_binned")
    dense = _spy(monkeypatch, port_rasterize, "rasterize_winners")
    v = torch.zeros(1, 3, 3)
    tri = torch.zeros(1 << 11, 3, dtype=torch.long)  # all triangles degenerate, off
    for h, w, big in [(96, 96, True), (88, 96, True), (90, 96, False), (64, 64, False)]:
        for calls in (single, binned, dense):
            calls.clear()
        win = port_rasterize._dispatch_winners(v, tri, h, w, False, 1e-6, "auto")
        assert win.shape == (1, h, w) and bool((win == -1).all())
        assert (len(single), len(binned), len(dense)) == ((0, 1, 0) if big else (0, 0, 1)), (h, w)


def test_method_names():
    """The JAX method names. ``"pallas"`` (the single-level kernel) and
    ``"auto"`` give the dense winners in ``rasterize`` and
    ``rasterize_index_coeff``; ``"pallas_multi"`` names the pyramid
    functions' multi-level pass and gives the per-size dense maps there,
    while ``rasterize`` refuses it, as JAX's does; ``"binned"``, the JAX
    package's XLA scatter search, gives the dense winners in ``rasterize``
    and ``rasterize_index_coeff``."""
    v, tri, h, w, tile, persp = single_case("sphere")
    attrs = _t(np.random.RandomState(1).randn(*v.shape).astype(np.float32))
    ref = rasterize(_t(v), attrs, _t(tri), h, w, persp, method="dense")
    for method in ("pallas", "auto"):
        out = rasterize(_t(v), attrs, _t(tri), h, w, persp, method=method)
        torch.testing.assert_close(out, ref, rtol=0, atol=0)
        idx, coeff = rasterize_index_coeff(_t(v), _t(tri), h, w, persp, method=method)
        ridx, rcoeff = rasterize_index_coeff(_t(v), _t(tri), h, w, persp, method="dense")
        torch.testing.assert_close(idx, ridx, rtol=0, atol=0)
        torch.testing.assert_close(coeff, rcoeff, rtol=0, atol=0)
    rect = rasterize(_t(v), attrs, _t(tri), 40, 24, persp, method="pallas")
    torch.testing.assert_close(rect, rasterize(_t(v), attrs, _t(tri), 40, 24, persp),
                               rtol=0, atol=0)
    sizes = [4, 8, 16, 32]
    assert port_rasterize._multi_levels(sizes, "pallas_multi", 3) == [32, 16, 8, 4]
    for fn in (rasterize_pyramid, rasterize_pyramid_fused):
        maps = fn(_t(v), attrs, _t(tri), sizes, persp, method="pallas_multi")
        for s, m in zip(sizes, maps):
            torch.testing.assert_close(
                m, rasterize(_t(v), attrs, _t(tri), s, s, persp, method="dense"),
                rtol=0, atol=0)
    torch.testing.assert_close(rasterize(_t(v), attrs, _t(tri), h, w, persp, method="binned"),
                               ref, rtol=0, atol=0)
    idx, coeff = rasterize_index_coeff(_t(v), _t(tri), h, w, persp, method="binned")
    ridx, rcoeff = rasterize_index_coeff(_t(v), _t(tri), h, w, persp, method="dense")
    torch.testing.assert_close(idx, ridx, rtol=0, atol=0)
    torch.testing.assert_close(coeff, rcoeff, rtol=0, atol=0)
    for method in ("pallas_multi", "nope"):
        with pytest.raises(ValueError, match="unknown"):
            rasterize(_t(v), attrs, _t(tri), h, w, method=method)

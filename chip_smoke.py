#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's hand-written kernels from ``stylerenderer_tpu_torch/csrc``
(one ``nvcc`` per source, all started together), holds each bit for bit
against its plain PyTorch version, drives the port's paths through the
entry points a user calls, and prints what it measured:

- the 256 px GAR forward, ``GeneratorWithMap(256, 512, 8)`` in bf16 on the
  50,400-vertex synthetic face mesh, B=16, ``pyramid_mode="each"`` (the
  multi-level kernel K1) and ``"downsample"`` with the fused pyramid (K1 at
  one level) and without it (the single-level kernel K2);
- the synthetic-face dataset writer at 256 px, B=16 (K2);
- GAR training through ``cli/train.py``: 5 steps at full width
  (``size=256``, ``latent=512``, ``n_mlp=8``, ``channel_multiplier=2``),
  B=16, f32, on the writer's 64-image shard, with ``--d_reg_every 16
  --g_reg_every 4`` so that steps with R1 + path, path only and neither
  all run (K1 twice a step, three times with the path term), a checkpoint
  and a sample grid; then each kind of step timed alone, its peak memory,
  and K1's share of its device time from the profiler;
- ``render_mean_face`` at 256 x 192 (K2);
- render inverting at full width (f32) on the 100,240-triangle face mesh
  against targets rendered from a known latent, 3DMM input and pose, 20
  Adam steps of pixel, landmark, prior and pose terms: ``each`` at B=8
  and B=16 (K1 at 7 levels every step, with vertex gradients through the
  fused pyramid), ``downsample`` fused (K1 at one level) and unfused (K2)
  at B=8, each timed, counted, profiled and held to a finite, falling
  loss; K1 bit for bit on the fitted vertices;
- evaluation on the training phase's checkpoint (phase 4f): ``cli.
  calc_inception`` on the writer's shard, ``cli.fid --with_map`` (K1 once a
  batch, bit for bit on a batch's mesh) and ``cli.ppl --with_map`` (K1
  twice a batch), the LPIPS projector (``w_lpips=0.8``, ``each`` B=8, K1
  every step), the unconditioned ``Generator(256, 512, 8)`` at B=16 and
  ``cli.generate`` without ``--with_map``, each timed, with LPIPS' share of
  the projector's device time; the FID network, LPIPS and the Generator
  against the CPU at a small size (phase 5);
- the Regressor and the supervisor heads (phase 4g): ``ResNetUNet`` at
  256 px, ``PFLDInference`` at 112 and ``InceptionResnetV1`` at 160 on the
  card against the CPU; ``Regressor(256, 512, 8)`` trained for 50 steps at
  B=8 on the training checkpoint's ``g_ema`` (K1 once a step, the loss
  falling), then as the init of a 20-step ``each`` fit at B=8 (K1 21
  times); ``cli.train --sfs --lmk --feat`` for 3 steps at B=16 and each
  kind of step with the heads timed beside phase 4a's;
- the GAR at 1024 px (phase 4i): K1 at top 1024 (9 levels) and 512 (8)
  with 32 px tiles on the production mesh at B=16, held level by level to
  K2, to the plain version on one image and to the dense search, and to
  its plain version on the training mesh; K2 at 1024^2, held to the plain
  version on one production image and on the training mesh; ``GeneratorWithMap(1024, 512, 8)`` in bf16 (``each``,
  ``downsample`` fused and unfused) at the largest batch that fits;
  ``remat`` against no remat (images equal, gradients to 1e-4, peak
  memory); ``cli.generate`` at its default 1024 px; ``cli.train`` in bf16
  with ``--profile_steps 2`` (its trace names K1's kernel) and each kind
  of step timed, and with ADA (``p`` moving);
- the binned search (phase 4j; plain PyTorch, the JAX package's XLA
  scatter search) on CUDA tensors, bit-equal to the plain version and to
  K2 on the training mesh and the production mesh at 256^2, B=16, and on
  image 0 of the production mesh at 1024^2, timed beside K2 (the training
  mesh at 1024^2 overflows ``big_cap``: its count is reported); ``"auto"``
  on the card launches K2;
- the six demonstration scripts (phase 4k) at cut sizes: ``train_demo``
  (4 steps at 64 px, its FID), ``train_demo256`` and
  ``train_demo256_ada`` (3 steps each at 256^2, B=16), ``recon_demo`` (4
  faces, 10 iterations), ``recon_demo256`` (20 Regressor steps, 10 and 20
  iterations) and ``parity_eval --dry_run``;
- data-parallel training (phase 4l, ``parallel/mesh.py``): ``cli.train``
  at world 1 under NCCL against the same run without a group, both with
  deterministic algorithms (metrics and checkpoint bit-equal), the
  ``torch.distributed.run`` launcher at one process, two ranks spawned on
  the card through gloo (one step at step 0, TF32 off, against world 1
  at the doubled batch to 1e-4; each rank's K1 launches counted), and
  each kind of step timed at world 1 with and without the group, with
  the collectives' time;
- spatial sharding (phase 4m, ``parallel/spatial.py``): K1 by band of
  tile rows against the whole launch cut to the band and against its
  plain version, timed beside its bound; a 1 x 1 mesh under NCCL
  bit-equal to no mesh; four gloo ranks on the card laid out 2 x 2 and
  1 x 4 (``make_mesh_2d``), the full-width GAR at global B=16 and
  ``Discriminator(256)`` on their bands against world 1 (images, logits,
  gradients), each rank's K1 launches, the banded forward and its halo
  exchanges timed;
- the generation CLI, and both CLIs (``generate``, ``project``) on the
  training phase's checkpoint (``--ckpt``);
- the styled conv's epilogue kernel (phase 3c, ``csrc/fused_act.cu``):
  at B=16 against its plain chain at every (C, H) of the 1024 px
  synthesis, the ResBlocks' channels-last maps and the mapping's
  ``[16, 512]``, its launch shape, its time alone at 1024^2 (B=16, C=32)
  and 512^2 (C=64) in bf16 beside its byte bound, and its launches in one
  no-grad GAR forward at 1024 and 256 px, its image against the plain
  path's; every path below reports its own epilogue launches, and the
  banded no-grad forwards of phase 4m only the mapping's;
- upfirdn2d's kernel (phase 3d, ``csrc/upfirdn2d.cu``): at the render cells'
  shapes (the 1024 px synthesis's 16 calls at B=16 in bf16, the 256 px
  synthesis's 12 at B=64 in f32) against its plain version, each call's
  time alone and the whole forward's launches back to back (both replayed
  from a CUDA graph) beside the byte bound, the plain version's time and
  ATen's depthwise ``F.conv2d`` on the stuffed, padded input (the
  yardstick: the port never calls it on a card), per level and summed,
  with the launch shape; every call of the inversion and training cells
  (the adjoints, with their negative pads) in f32 and odd, cropping calls
  in f32, bf16 and f64 against the plain version; phase 3c's forwards
  launch it 16 and 12 times, and every path below reports its launches.

K1 is timed at the ``each`` shapes (7 levels, C=3), at the training
shapes (the 9,024-triangle mesh at B=16 and B=8, 7 levels, C=3) and at
one level,
with its binning on the card held against the plain binning
``build_bins_multi`` (keys and starts equal) and timed beside it. K2 is
timed at tiles 8, 16 and 32 on the synth writer's mesh and on the
production mesh at 256 px (and at 512 px), its binning on the card held
against the plain binning ``build_bins`` and timed beside it, with the
kernel's launch shape. Each card binning is timed by replaying its
launches from a CUDA graph, so that the host's calls between them do not
count, and also per call with the host in the loop.

Each path runs with the kernels' launch counts set to 0 just before it and
read just after. Every phase fails loudly; the last line is
``{"ok": true, "device": {...}}`` only when all of them passed. Without a
CUDA card it exits non-zero and prints no result. Weights, meshes and data
are random, made from fixed seeds.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

TOP, N_LEVELS, TILE, EPS = 256, 7, 16, 1e-6
BATCH = 16
FORWARDS = 10      # timed forwards of the "each" path
DS_FORWARDS = 5    # timed forwards of each "downsample" path
SYNTH_IMAGES = 64
TRAIN_STEPS = 5    # through the CLI: R1 + path, plain x3, path
TRAIN_REPS = 3     # timed steps of each kind afterwards
PAR_REPS = 1       # phase 4l: timed steps of each kind in each turn
# phase 4m: the meshes over four ranks, the timed banded forwards, and the
# parameters whose reduced gradients are held to world 1's (a band conv's
# and the replicated tail's of D; the mapping network's and a band conv's
# of the GAR)
SPATIAL_LAYOUTS = ((2, 2), (1, 4))
SPATIAL_REPS = 3
SPATIAL_D_PARAMS = ("convs.1.conv1.0.weight", "final_linear.1.weight")
SPATIAL_G_PARAMS = ("style.1.weight", "convs.6.conv.weight")
# state.step values that schedule each kind of step at d_reg_every=16,
# g_reg_every=4
STEP_KINDS = {"plain": 9, "path": 8, "R1 + path": 16}
BIN_KERNELS = ("bin_classify", "bin_scan", "bin_scatter", "bin_single_classify",
               "bin_single_scatter")
INV_ITERS = 20     # Adam steps of each timed fit
# (pyramid_mode, fused_pyramid, batch) of the inversion runs
INV_RUNS = (("each", True, 8), ("each", True, 16), ("downsample", True, 8),
            ("downsample", False, 8))
INV_LANDMARKS = 68
# phase 4f: cli.fid's samples and batch, cli.ppl's pairs and batch, the
# LPIPS projector's batch and steps, the Generator's timed forwards
FID_SAMPLES, FID_BATCH, PPL_SAMPLES, PPL_BATCH = 128, 32, 64, 16
LPIPS_INV_BATCH = 8
GEN_FORWARDS = 10
# phase 4g: the Regressor's training steps and batch, the Regressor-initialized
# fit's batch, the CLI steps with --sfs --lmk --feat, the supervisor nets'
# batch on the card against the CPU
REG_STEPS, REG_BATCH, REG_INV_BATCH, HEADS_STEPS, SUP_BATCH = 50, 8, 8, 3, 4
# phase 4h: the face-model files at their published sizes over sphere meshes
# (rows, columns; basis widths), the photos of the pipeline, its steps
BFM_MESH, BFM_DIMS = (178, 300), (199, 29)  # 53,400 vertices, 106,200 triangles
FW_MESH, FW_DIMS = (85, 135), (150, 47)     # 11,475 vertices; identities, expressions
FLAME_MESH, FLAME_SHAPE = (51, 98), 400     # 4,998 vertices; 300 shape + 100 expression
PHOTOS, PIPE_STEPS, PIPE_FID, PIPE_PPL = 32, 2, (64, 32), (16, 16)
# the GAR at full width: phase 4h's models and CLIs
GAR = dict(size=256, latent=512, n_mlp=8, channel_multiplier=2)
# phase 4i: the GAR at 1024 px (the reference channel table's top): K1's
# pyramid, K2's image, the forwards' timed calls and the batches tried in
# turn (the largest that fits is kept), remat's batch (its path term takes
# half, as the trainer's path_batch_shrink), the bf16 and ADA runs' steps
HR_TOP, HR_LEVELS, HR_TILE = 1024, 9, 32
HR_FORWARDS, HR_BATCHES, REMAT_BATCH = 3, (16, 4, 1), 4
ADA_STEPS, ADA_ARGS = 8, ("--ada_every", "4", "--ada_target", "0.1", "--ada_length", "2000")
# phase 4j: the binned search's timed calls and its big-triangle capacity
BINNED_ITERS, BIG_CAP = 20, 512
# phase 4k: the demonstration scripts, in the order they run (each later one
# reads an earlier one's checkpoint)
SCRIPTS = ("train_demo", "train_demo256", "train_demo256_ada", "recon_demo", "recon_demo256",
           "parity_eval")
MEAN_FACE_HW = (256, 192)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_OPS_PER_S = 67e12      # H100 SXM data sheet, f32 outside the tensor cores
# f32 operations of the kernels' candidate math per (pixel, candidate whose
# clamped bbox holds the pixel): bbox test 4, three edge functions 12, inside
# test 3, coefficient sum and guard 5, reciprocal 1, normalize 3, clamp 6,
# depth 5, z-test 2, interpolation 5 per channel; and per (triangle, level)
# setup: rescale 12 (levels below the top only), adjugate and det 11,
# orientation 16, bbox 12, longest edge and picks 25.
OPS_PER_PAIR_BASE, OPS_PER_PAIR_CHANNEL, OPS_PER_SETUP, OPS_RESCALE = 41, 5, 76, 12


def log(*args):
    print(*args, flush=True)


def cuda_ms(torch, fn, iters: int) -> float:
    """Mean device time of ``fn`` in ms over ``iters`` calls after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(torch, fn, iters: int) -> float:
    """Mean device time in ms of the launches ``fn`` makes: captured once in
    a CUDA graph (its allocations and launch calls run once, at capture),
    then ``iters`` replays timed with CUDA events, so no host work falls
    between the launches."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    ms = cuda_ms(torch, graph.replay, iters)
    del graph
    return ms


def once_ms(torch, fn):
    """(result, device time in ms) of one call of ``fn``."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def compare_multi(out, ref, with_attrs: bool, what: str) -> float:
    """Winners equal and values equal at every level -> max |value error|."""
    err = 0.0
    for k, (a, b) in enumerate(zip(out, ref)):
        wa, wb = (a[1], b[1]) if with_attrs else (a, b)
        if not bool((wa == wb).all()):
            n = int((wa != wb).sum())
            raise AssertionError(f"{what}: level {k}: {n} winners differ")
        if with_attrs:
            d = float((a[0] - b[0]).abs().max())
            err = max(err, d)
            if d != 0.0:
                raise AssertionError(f"{what}: level {k}: values differ by up to {d}")
    return err


def compare_wins(out, ref, what: str) -> float:
    """Winner maps equal -> max |id difference| (0)."""
    if out.shape != ref.shape or not bool((out == ref).all()):
        n = int((out != ref).sum()) if out.shape == ref.shape else -1
        raise AssertionError(f"{what}: {n} winners differ (shapes {tuple(out.shape)}, "
                             f"{tuple(ref.shape)})")
    return float((out - ref).abs().max())


def bbox_pairs(torch, dat, n_valid, h, w, n_levels, rows=None):
    """(pixel, triangle) pairs whose clamped bbox at each level holds the
    pixel, over the valid rows of binned triangles (corner px, py at the
    top level in columns 0-5); with ``rows = (y0, y1)``, only the pixels of
    those top-level rows (``y0 >> k`` to ``y1 >> k`` at level k)."""
    y_lo, y_hi = (0, h) if rows is None else rows
    pairs = 0
    for b in range(dat.shape[0]):
        t = dat[b, : int(n_valid[b])]
        px, py = t[:, 0:3], t[:, 3:6]
        for k in range(n_levels):
            wl, hl = w >> k, h >> k
            inv = 1.0 / (1 << k)
            sh = inv * 0.5 - 0.5
            qx, qy = (px * inv + sh, py * inv + sh) if k else (px, py)
            x0 = torch.clamp(torch.ceil(qx.amin(-1)), min=0.0)
            x1 = torch.clamp(torch.floor(qx.amax(-1)), max=wl - 1.0)
            y0 = torch.clamp(torch.ceil(qy.amin(-1)), min=float(y_lo >> k))
            y1 = torch.clamp(torch.floor(qy.amax(-1)), max=min(hl, y_hi >> k) - 1.0)
            n = torch.clamp(x1 - x0 + 1, min=0) * torch.clamp(y1 - y0 + 1, min=0)
            pairs += int(n.double().sum())
    return pairs


def bound(nbytes: int, ops: int):
    """(bound_ms, bound_by): the larger of the byte and operation times."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def k1_bound(torch, dat, starts, top, n_levels, n_attr, rows=None):
    """Least time for K1's work on these inputs: (bound_ms, bound_by, bytes,
    operations, pairs, valid triangles). Bytes: the rows of the valid
    binned triangles (data and id) read once, the segment starts, and the
    maps written once; invalid triangles are sorted past every tile's
    segments and never read. Operations: the candidate math for every
    (pixel, triangle) pair whose clamped bbox at that level holds the
    pixel, plus one setup per (valid triangle, level). With a band of
    top-level ``rows`` (and the binning of that band), its pixels only."""
    B, nf, R = dat.shape
    y0, y1 = (0, top) if rows is None else rows
    pixels = B * sum((top >> k) * ((y1 >> k) - (y0 >> k)) for k in range(n_levels))
    n_valid = starts[:, -1].long()  # invalid triangles sort past the last key
    nbytes = (int(n_valid.sum()) * (R + 1) * 4 + starts.numel() * 4
              + pixels * 4 * (1 + n_attr))
    pairs = bbox_pairs(torch, dat, n_valid, top, top, n_levels, rows)
    setups = int(n_valid.sum()) * n_levels
    ops = pairs * (OPS_PER_PAIR_BASE + OPS_PER_PAIR_CHANNEL * n_attr) + setups * OPS_PER_SETUP
    return (*bound(nbytes, ops), nbytes, ops, pairs, int(n_valid.sum()))


def k2_bound(torch, dat, starts, h, w):
    """Least time for K2's work on these inputs, as ``k1_bound``: the valid
    rows (9 f32 and an i32 id) read once, the segment starts, the winner
    map written once; the winners-only candidate math per bbox pair, plus
    one top-level setup (no rescale) per valid triangle."""
    B = dat.shape[0]
    n_valid = starts[:, -1].long()  # invalid triangles sort past the last key
    nbytes = int(n_valid.sum()) * 10 * 4 + starts.numel() * 4 + B * h * w * 4
    pairs = bbox_pairs(torch, dat, n_valid, h, w, 1)
    ops = pairs * OPS_PER_PAIR_BASE + int(n_valid.sum()) * (OPS_PER_SETUP - OPS_RESCALE)
    return (*bound(nbytes, ops), nbytes, ops, pairs, int(n_valid.sum()))


def k1_measure(torch, np, vert, tri, n_levels, norm, keys_of_bins, top=TOP, tile=TILE,
               band=None):
    """K1 at these shapes (top ``top``, tile ``tile``, values of ``norm`` or
    winners only, the band of tile rows ``band`` or the whole image): the
    card's binning held against the plain binning (keys and starts equal),
    then timed with CUDA events over many launches after a warm-up: the
    plain binning, the card's binning (its launches replayed from a CUDA
    graph, and per call with the host in the loop), the kernel; the bound
    from the plain binning's output; the kernel's launch shape (threads,
    shared memory, registers, spills, resident blocks per SM)."""
    import ctypes

    from stylerenderer_tpu_torch.ops import _build
    from stylerenderer_tpu_torch.ops.rasterize_multi import (
        build_bins_multi, launch_bin_multi, launch_rasterize_multi,
    )

    n_attr = 0 if norm is None else norm.shape[-1]
    dat, ids, starts = build_bins_multi(vert, tri, top, n_levels, False, EPS, tile, attrs=norm,
                                        band=band)
    rows, cstarts, slots, keys = launch_bin_multi(vert, tri, top, n_levels, False, EPS, tile,
                                                  attrs=norm, band=band)
    if not torch.equal(cstarts, starts):
        raise AssertionError(f"K1 {n_levels} levels: the card's starts differ from the plain "
                             "binning's")
    want = keys_of_bins(ids.cpu().numpy(), starts.cpu().numpy())
    if not np.array_equal(keys.cpu().numpy(), want):
        raise AssertionError(f"K1 {n_levels} levels: the card's keys differ from the plain "
                             "binning's")
    plain_bins_ms = cuda_ms(torch, lambda: build_bins_multi(vert, tri, top, n_levels, False,
                                                            EPS, tile, attrs=norm, band=band), 5)
    def bin_multi():
        return launch_bin_multi(vert, tri, top, n_levels, False, EPS, tile, attrs=norm, band=band)
    bins_ms = graph_ms(torch, bin_multi, 50)
    bins_call_ms = cuda_ms(torch, bin_multi, 50)
    ms = cuda_ms(torch, lambda: launch_rasterize_multi(rows, cstarts, slots, top, n_levels, tile,
                                                       n_attr, False, EPS, band), 50)
    rows_top = None if band is None else (band[0] * tile, (band[0] + band[1]) * tile)
    bound_ms, by, nbytes, ops, pairs, n_valid = k1_bound(torch, dat, starts, top, n_levels,
                                                         n_attr, rows_top)
    shape = (ctypes.c_int * 6)()
    rc = _build.library("multi").sr_rasterize_multi_shape(top, n_levels, tile, n_attr, shape)
    if rc != 0:
        raise AssertionError(f"K1 launch shape query failed: {rc}")
    del dat, ids, rows, slots
    return {"ms": ms, "bins_ms": bins_ms, "bins_call_ms": bins_call_ms,
            "plain_bins_ms": plain_bins_ms, "bound_ms": bound_ms,
            "bound_by": by, "bytes": nbytes, "ops": ops, "pairs": pairs, "n_valid": n_valid,
            "binned": int(vert.shape[0] * tri.shape[0]),
            "shape": dict(zip(("threads", "dynamic_smem", "static_smem", "registers",
                               "local_bytes", "blocks_per_sm"), shape))}


def k2_measure(torch, np, vert, tri, h, w, tile, keys_of_bins, ref=None):
    """K2 at tile ``tile`` on an ``h x w`` image: the card's binning held
    against the plain binning ``build_bins`` (keys and starts equal), the
    kernel's winners against ``ref`` when given, then timed with CUDA
    events after a warm-up: the plain binning, the card's binning (its
    launches replayed from a CUDA graph, and per call with the host in the
    loop), the kernel; the kernel's launch shape (threads, shared memory,
    registers, spills, resident blocks per SM)."""
    import ctypes

    from stylerenderer_tpu_torch.ops import _build
    from stylerenderer_tpu_torch.ops.rasterize_single import (
        build_bins, launch_bin_single, launch_rasterize_single,
    )

    _, ids, starts = build_bins(vert, tri, h, w, False, EPS, tile)
    rows, cstarts, keys = launch_bin_single(vert, tri, h, w, False, EPS, tile)
    if not torch.equal(cstarts, starts):
        raise AssertionError(f"K2 {h}x{w} tile {tile}: the card's starts differ from the plain "
                             "binning's")
    if not np.array_equal(keys.cpu().numpy(), keys_of_bins(ids.cpu().numpy(),
                                                           starts.cpu().numpy())):
        raise AssertionError(f"K2 {h}x{w} tile {tile}: the card's keys differ from the plain "
                             "binning's")
    del ids, starts
    plain_bins_ms = cuda_ms(torch, lambda: build_bins(vert, tri, h, w, False, EPS, tile), 5)
    def bin_single():
        return launch_bin_single(vert, tri, h, w, False, EPS, tile)
    bins_ms = graph_ms(torch, bin_single, 20)
    bins_call_ms = cuda_ms(torch, bin_single, 20)

    def run():
        return launch_rasterize_single(rows, cstarts, h, w, tile, False, EPS)
    if ref is not None:
        compare_wins(run(), ref, f"K2 {h}x{w} tile {tile}")
    ms = cuda_ms(torch, run, 20)
    shape = (ctypes.c_int * 6)()
    rc = _build.library("single").sr_rasterize_single_shape(tile, shape)
    if rc != 0:
        raise AssertionError(f"K2 launch shape query failed: {rc}")
    return {"ms": ms, "bins_ms": bins_ms, "bins_call_ms": bins_call_ms,
            "plain_bins_ms": plain_bins_ms,
            "shape": dict(zip(("threads", "dynamic_smem", "static_smem", "registers",
                               "local_bytes", "blocks_per_sm"), shape))}


def k2_report(what: str, by_tile) -> str:
    return f"{what}: " + "; ".join(
        f"tile {t}: kernel {m['ms']:.4f} ms, card binning {m['bins_ms']:.4f} ms (graph replay; "
        f"{m['bins_call_ms']:.4f} ms per call with the host in the loop), plain binning "
        f"{m['plain_bins_ms']:.4f} ms, launch shape {m['shape']}" for t, m in by_tile.items())


def k1_report(what: str, m) -> str:
    return (f"{what}: kernel {m['ms']:.4f} ms, card binning {m['bins_ms']:.4f} ms (graph "
            f"replay; {m['bins_call_ms']:.4f} ms per call with the host in the loop; keys and "
            f"starts equal to the plain binning's), plain binning {m['plain_bins_ms']:.4f} ms; "
            f"bound {m['bound_ms']:.4f} ms by {m['bound_by']} ({m['bytes']} bytes, {m['ops']} "
            f"f32 ops, {m['pairs']} bbox pairs, {m['n_valid']} valid of {m['binned']} binned "
            f"triangles); kernel launch shape {m['shape']}")


def profile_forwards(torch, gen, inputs, top_n: int = 12):
    """Device time by the host op that launched it over a few forwards
    (torch.profiler), and the device's busy share of the host-clock window
    (profiler on)."""
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for z, mesh in inputs:
            gen([z], mesh)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side events (kernels, copies) give the busy time; the host ops
    # that launched them report the same time again, by op name
    events = prof.key_averages()
    on_device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in on_device)
    if busy_us == 0:
        log("profile: the profiler saw no device time; busy share not measured")
        return
    n = len(inputs)
    log(f"profile ({n} forwards, profiler on): device busy {busy_us / n / 1e3:.3f} ms per "
        f"forward of {wall_us / n / 1e3:.3f} ms host clock, busy share "
        f"{busy_us / wall_us:.3f}; {sum(e.count for e in on_device) // n} device events "
        f"per forward")
    by_op = sorted(((e.self_device_time_total, e.count, e.key) for e in events
                    if e.device_type == torch.autograd.DeviceType.CPU
                    and e.self_device_time_total > 0), reverse=True)
    for t, count, name in by_op[:top_n]:
        log(f"  {t / n / 1e3:9.3f} ms/forward  {t / busy_us:6.1%}  {count // n:4d} calls  "
            f"{name}")


def profile_step(torch, fn, top_n: int = 8):
    """One call of ``fn`` (a train step or a projector call) under
    torch.profiler -> host-clock ms, device busy ms, device ms of the
    rasterizer kernels, of their card binnings and of ``_FusedLevels``'
    backward (its children's device time), the number of device events,
    and the ``top_n`` host ops by the device time they launched."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    on_device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    on_host = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU]

    def dev_ms(names):
        return sum(e.self_device_time_total for e in on_device
                   if any(k in e.key for k in names)) / 1e3

    bwd = [e.device_time_total for e in on_host if "_FusedLevelsBackward" in e.key]
    by_op = sorted(((e.self_device_time_total / 1e3, e.count, e.key) for e in on_host
                    if e.self_device_time_total > 0), reverse=True)[:top_n]
    return {"wall_ms": wall_ms,
            "busy_ms": sum(e.self_device_time_total for e in on_device) / 1e3,
            "kernel_ms": dev_ms(("rasterize_multi_kernel", "rasterize_single_kernel")),
            "bins_ms": dev_ms(BIN_KERNELS),
            "fused_bwd_ms": max(bwd) / 1e3 if bwd else 0.0,
            "events": sum(e.count for e in on_device), "by_op": by_op}


def real_batch(torch, np, shard, dev):
    """The first BATCH images of the 256 px ``shard`` as a training batch."""
    from stylerenderer_tpu_torch.data import SRPackDataset, to_train_tensor

    ds = SRPackDataset(shard, 256)
    real = to_train_tensor(ds.read_batch(np.arange(BATCH)), np.random.default_rng(0)).to(dev)
    ds.reader.close()
    return real


def time_step_kinds(torch, state, cfg, real, face, tri, run_path, label, heads=(),
                    note=None):
    """Each kind of step alone on ``state`` (with the supervisor ``heads``
    when given): timed (host clock, each step ends in its finite-flag sync;
    mean of TRAIN_REPS after one), its peak memory, counted (K1 2 or 3
    times) and profiled once (idle share, K1's share, the top host ops)
    -> ms by kind; fails on a screened step. ``note(kind, metrics)`` adds
    to each kind's line."""
    from stylerenderer_tpu_torch.train import sample_draws, train_step

    step_ms = {}
    for kind, at in STEP_KINDS.items():
        def one(at=at):
            state.step = at
            draws = sample_draws(state.generator, cfg, face, BATCH, state.g.n_latent, heads)
            return train_step(state, real, draws, cfg, face, tri, heads)

        one()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(TRAIN_REPS):
            m = one()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / TRAIN_REPS
        kind_peak = torch.cuda.max_memory_allocated()
        _, counts = run_path(f"{label}, {kind}", one)
        n_k1 = 2 if kind == "plain" else 3
        if raster(counts) != {"rasterize_multi": n_k1, "rasterize_single": 0}:
            raise AssertionError(f"{label} ({kind}): launches {counts}")
        prof = profile_step(torch, one)
        wall, busy, n_events = prof["wall_ms"], prof["busy_ms"], prof["events"]
        k1_ms = prof["kernel_ms"] + prof["bins_ms"]
        if state.nonfinite_count:
            raise AssertionError(f"{label} ({kind}): {state.nonfinite_count} non-finite steps")
        step_ms[kind] = ms
        k1_share = f"{k1_ms / busy:.4f}" if busy else "not measured"
        # device events that overlap sum to more than the window they fill
        idle = (f"idle share {1 - busy / wall:.3f}" if busy <= wall else
                "idle share not measured: the device events' times overlap")
        log(f"{label}, {kind}: {ms:.1f} ms (host clock, mean of {TRAIN_REPS}), "
            f"{BATCH * 1e3 / ms:.1f} images/s; peak memory {kind_peak / 2 ** 30:.2f} GiB; "
            f"K1 launches {n_k1}; profiled once: device events {busy:.1f} ms in {wall:.1f} ms "
            f"host clock ({idle}), {n_events} device events, K1 and "
            f"its binning {k1_ms:.3f} ms of device time (share {k1_share})"
            + (f"; {note(kind, m)}" if note else ""))
        for t, n, name in prof["by_op"]:
            log(f"    {t:9.3f} ms  {t / busy:6.1%}  {n:5d} calls  {name}")
    return step_ms


def train_phase(torch, np, dev, shard, out, run_path, face, tri, check_k1):
    """GAR training on ``shard`` through the CLI, then each kind of step
    timed, counted and profiled alone; fails loudly on any check."""
    from stylerenderer_tpu_torch.cli.train import main as train_main
    from stylerenderer_tpu_torch.train import sample_draws, train_step
    from stylerenderer_tpu_torch.utils.config import TrainConfig

    # K1 at the training shapes, before training: B=16 (D and G steps) and
    # B=8 (the path step's pyramid), 7 levels, C=3, on the training mesh
    from stylerenderer_tpu_torch.face3d import mesh_point_normal, random_apply_pose3D

    g = torch.Generator().manual_seed(7)
    vert = random_apply_pose3D(g, face(face.random_input(BATCH, g)))
    norm = mesh_point_normal(vert, tri)
    for b in (BATCH, BATCH // 2):
        check_k1(vert[:b].contiguous(), norm[:b].contiguous(), b)

    # why upfirdn2d has its own backward: ATen's double backward of the same
    # depthwise convolution, beside the port's, at B=16, 128 channels, 64^2
    import torch.nn.functional as F

    from stylerenderer_tpu_torch.ops.upfirdn2d import make_kernel, upfirdn2d

    x = torch.randn(BATCH, 128, 64, 64, device=dev, requires_grad=True)
    k = make_kernel([1, 3, 3, 1], device=dev)
    blurs = {"port": lambda v: upfirdn2d(v, k, pad=(1, 2)),
             "ATen": lambda v: F.conv2d(F.pad(v, [1, 2, 1, 2]),
                                        torch.flip(k, (0, 1)).expand(128, 1, 4, 4), groups=128)}

    def second_order(fn):
        (gx,) = torch.autograd.grad(fn(x).square().sum(), x, create_graph=True)
        return torch.autograd.grad(gx.square().sum(), x)[0]

    grads = {n: second_order(f) for n, f in blurs.items()}
    torch.testing.assert_close(grads["port"], grads["ATen"], rtol=1e-4, atol=1e-4)
    log("upfirdn2d double backward (B=16, 128 channels, 64^2, 4x4 blur; CUDA events): "
        + ", ".join(f"{n} {cuda_ms(torch, lambda f=f: second_order(f), 3):.3f} ms"
                    for n, f in blurs.items()) + "; equal to 1e-4")
    del x, grads

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, counts = run_path("train", lambda: train_main([
        shard, "--iter", str(TRAIN_STEPS), "--batch", str(BATCH), "--d_reg_every", "16",
        "--g_reg_every", "4", "--log_every", "1", "--sample_every", str(TRAIN_STEPS),
        "--ckpt_every", str(TRAIN_STEPS), "--seed", "0", "--out_dir", out]))
    train_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    kinds = ["R1 + path" if i % 16 == 0 else "path" if i % 4 == 0 else "plain"
             for i in range(TRAIN_STEPS)]
    want = {"rasterize_multi": sum(3 if k != "plain" else 2 for k in kinds) + 1,
            "rasterize_single": 0}  # + 1: the EMA sample grid
    if raster(counts) != want:
        raise AssertionError(f"train path: launches {counts}, expected {want}")
    rows = metrics_rows(out, TRAIN_STEPS, "train path")
    for r, kind in zip(rows, kinds):
        if (r["r1"] != 0) != (kind == "R1 + path") or (r["path"] != 0) != (kind != "plain"):
            raise AssertionError(f"train path: step {r['step']} ({kind}) ran the wrong terms: {r}")
    for name in ("checkpoint/%06d.pt" % TRAIN_STEPS, "sample/%06d.png" % (TRAIN_STEPS - 1),
                 "sample/%06d_norm.png" % (TRAIN_STEPS - 1)):
        if not os.path.getsize(os.path.join(out, name)):
            raise AssertionError(f"train path: {name} is empty")
    ckpt_mb = os.path.getsize(os.path.join(out, "checkpoint/%06d.pt" % TRAIN_STEPS)) / 2 ** 20
    log(f"train path: cli.train, GeneratorWithMap(256, 512, 8, channel_multiplier=2) + "
        f"Discriminator(256, 2), f32 (cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}, "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}), B={BATCH}, "
        f"{TRAIN_STEPS} steps in {train_s:.1f} s (set-up, checkpoint and sample grid "
        f"included); launches {counts}; peak memory {peak / 2 ** 30:.2f} GiB; checkpoint "
        f"{ckpt_mb:.0f} MiB")
    for r, kind in zip(rows, kinds):
        log(f"  step {r['step']} ({kind}): {r['step_ms']:.1f} ms host clock; d {r['d']:.4f}, "
            f"g {r['g']:.4f}, r1 {r['r1']:.4f}, path {r['path']:.4f}, path length "
            f"{r['path_length']:.4f}")

    # each kind of step alone, on the trained state
    cfg = TrainConfig(batch=BATCH, d_reg_every=16, g_reg_every=4)
    real = real_batch(torch, np, shard, dev)
    step_ms = time_step_kinds(torch, state, cfg, real, face, tri, run_path, "train step")
    # what the finite screen costs a plain step (the copy it restores from,
    # the max-abs norms and the one host synchronisation): the same steps
    # with it taken out, in turns with it in
    import stylerenderer_tpu_torch.train.step as step_mod

    screen = (step_mod._take_backup, step_mod.all_finite)

    def plain_ms(with_screen):
        if not with_screen:
            step_mod._take_backup, step_mod.all_finite = (lambda st: [],
                                                          lambda *args: True)
        try:
            state.step = STEP_KINDS["plain"]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(TRAIN_REPS):
                draws = sample_draws(state.generator, cfg, face, BATCH, state.g.n_latent)
                train_step(state, real, draws, cfg, face, tri)
                state.step = STEP_KINDS["plain"]
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3 / TRAIN_REPS
        finally:
            step_mod._take_backup, step_mod.all_finite = screen

    turns = [plain_ms(w) for w in (True, False, False, True)]
    log(f"finite screen: plain steps {turns[0]:.1f}, {turns[3]:.1f} ms with it, {turns[1]:.1f}, "
        f"{turns[2]:.1f} ms without it (host clock, mean of {TRAIN_REPS} each): it costs "
        f"{(turns[0] + turns[3] - turns[1] - turns[2]) / 2:.1f} ms a step")

    # the regularization cycle of 16 steps: 1 with R1 + path, 3 path, 12 plain
    cycle = (step_ms["R1 + path"] + 3 * step_ms["path"] + 12 * step_ms["plain"]) / 16
    log(f"train: {cycle:.1f} ms per step over the 16-step cycle, {BATCH * 1e3 / cycle:.1f} "
        f"images/s")
    return step_ms


def inversion_phase(torch, np, dev, face, tri, run_path, check_fitted):
    """Render inverting at full width through ``make_projector``: targets
    rendered from a known latent, 3DMM input and pose with zero noise (as
    ``scripts/recon_demo.py``), then each of ``INV_RUNS`` fitted for
    ``INV_ITERS`` steps after a warm-up fit, timed (host clock, CUDA
    events), counted, profiled (a 1-step and a 2-step call; their difference
    is one step), and held to finite,
    falling losses; ``check_fitted`` takes the B=16 ``each`` fit's
    vertices. Returns the targets ``[16, 3, 256, 256]`` in [-1, 1], their
    landmarks and the landmark vertex ids."""
    from stylerenderer_tpu_torch.face3d import mesh_point_normal
    from stylerenderer_tpu_torch.inversion import ProjectorConfig, make_projector
    from stylerenderer_tpu_torch.inversion.project import _apply_pose
    from stylerenderer_tpu_torch.models import GeneratorWithMap

    nv = face.mean.shape[0] // 3
    lmk_vidx = torch.linspace(0, nv - 1, INV_LANDMARKS).long()
    gens = {(mode, fused): GeneratorWithMap(256, 512, 8, channel_multiplier=2, seed=0,
                                            pyramid_mode=mode, fused_pyramid=fused,
                                            device=dev)
            for mode, fused, _ in INV_RUNS}
    B = max(b for _, _, b in INV_RUNS)
    g = torch.Generator().manual_seed(11)
    z = torch.randn(B, 512, generator=g).to(dev)
    x = face.random_input(B, g)
    pose = [(torch.randn(B, n, generator=g) * s).to(dev)
            for n, s in ((3, 0.15), (3, 0.05), (1, 0.05))]
    with torch.no_grad():
        vert = _apply_pose(face(x), *pose)
        gen = gens[("each", True)].eval()
        target = gen([z], (vert, mesh_point_normal(vert, tri), tri),
                     noise=[torch.zeros(1, 1, 1, 1, device=dev)] * gen.num_layers)[0]
        target = target.clamp(-1, 1)
        lv = vert[:, lmk_vidx]
        target_lmk = torch.stack([(1 + lv[..., 0]) * 256 / 2 - 0.5,
                                  (1 - lv[..., 1]) * 256 / 2 - 0.5], -1)
    cfg = ProjectorConfig(iters=INV_ITERS, w_lpips=0.0)
    log(f"inversion: GeneratorWithMap(256, 512, 8, channel_multiplier=2) f32 "
        f"(cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}), synthetic_face(180, 280, 80, "
        f"29) ({tri.shape[0]} triangles), {INV_LANDMARKS} landmarks, ProjectorConfig("
        f"iters={INV_ITERS}, w_lpips=0): pixel L2, landmarks, prior, pose; self-rendered "
        f"targets")
    for mode, fused, b in INV_RUNS:
        project = make_projector(gens[(mode, fused)], face, tri, cfg, lmk_vidx=lmk_vidx)
        tgt, lmk = target[:b], target_lmk[:b]
        project(0, tgt, lmk, n_steps=2)  # warm-up: cuDNN plans, the allocator
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        name = f"inversion {mode}{'' if fused else ' unfused'} B={b}"
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out, counts = run_path(name, lambda: project(0, tgt, lmk, return_state=True))
        end.record()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        ev_ms = start.elapsed_time(end)
        peak = torch.cuda.max_memory_allocated()
        kernel = "rasterize_multi" if fused else "rasterize_single"
        want = {"rasterize_multi": 0, "rasterize_single": 0}
        want[kernel] = INV_ITERS + 1  # one forward a step, one for the final render
        if raster(counts) != want:
            raise AssertionError(f"{name}: launches {counts}, expected {want}")
        hist = out["loss_history"].cpu().numpy()
        if hist.shape != (INV_ITERS,) or not np.isfinite(hist).all() or not hist[-1] < hist[0]:
            raise AssertionError(f"{name}: loss history {hist}")
        for k in ("render", "vertices", "w_plus"):
            if not bool(torch.isfinite(out[k]).all()):
                raise AssertionError(f"{name}: non-finite {k}")
        if tuple(out["render"].shape) != (b, 3, 256, 256):
            raise AssertionError(f"{name}: render {tuple(out['render'].shape)}")
        # one step's device time: the profiled calls of 2 steps and of 1 step
        # (each with its final render) differ by one step; the profiler slows
        # the host, not the device, so the busy share is taken against the
        # unprofiled host clock
        prof = [profile_step(torch, lambda n=n: project(0, tgt, lmk, state=out["state"],
                                                        n_steps=n), top_n=6) for n in (1, 2)]
        step = {k: prof[1][k] - prof[0][k] for k in ("busy_ms", "kernel_ms", "bins_ms",
                                                     "fused_bwd_ms", "events")}
        busy = step["busy_ms"]
        log(f"{name}: {INV_ITERS} steps in {wall_ms:.1f} ms host clock, "
            f"{wall_ms / INV_ITERS:.1f} ms per step ({ev_ms / INV_ITERS:.1f} ms per step "
            f"between CUDA events; both include the init and the final render); launches "
            f"{counts}; peak memory {peak / 2 ** 30:.2f} GiB; loss {hist[0]:.5f} -> "
            f"{hist[-1]:.5f}; final terms "
            + ", ".join(f"{k} {float(v):.5f}" for k, v in out["losses"].items()))
        log(f"  one step (profiled 2-step call minus 1-step call): device busy {busy:.1f} ms "
            f"(busy share {busy / (wall_ms / INV_ITERS):.3f} of the unprofiled host ms per "
            f"step), {step['events']} device events; {kernel} kernel "
            f"{step['kernel_ms']:.3f} ms, its card binning {step['bins_ms']:.3f} ms (share "
            f"{(step['kernel_ms'] + step['bins_ms']) / busy:.4f}), _FusedLevels backward "
            f"{step['fused_bwd_ms']:.3f} ms (share {step['fused_bwd_ms'] / busy:.4f}); the "
            f"2-step call under the profiler: {prof[1]['busy_ms']:.1f} ms busy of "
            f"{prof[1]['wall_ms']:.1f} ms host clock")
        for t, n, op in prof[1]["by_op"]:
            log(f"    {t:9.3f} ms  {t / prof[1]['busy_ms']:6.1%}  {n:5d} calls  {op}")
        if (mode, b) == ("each", B):
            check_fitted(out["vertices"])
        del out
    return target, target_lmk, lmk_vidx


def eval_phase(torch, np, dev, smi, shard, ckpt, face, tri, synth_mesh, targets, run_path,
               check_k1):
    """Evaluation on the training checkpoint ``ckpt``: ``cli.calc_inception``
    on ``shard``, ``cli.fid --with_map`` (K1 once a batch; ``check_k1``
    takes its first batch's mesh), ``cli.ppl --with_map`` (K1 twice a
    batch), the LPIPS projector on the inversion ``targets`` (K1 every
    step), the unconditioned Generator and ``cli.generate`` without
    ``--with_map``: each counted, checked and timed."""
    from stylerenderer_tpu_torch.cli.calc_inception import main as calc_main
    from stylerenderer_tpu_torch.cli.fid import main as fid_main, make_sampler
    from stylerenderer_tpu_torch.cli.generate import main as generate_main
    from stylerenderer_tpu_torch.cli.ppl import main as ppl_main
    from stylerenderer_tpu_torch.cli.ppl import make_sampler as make_ppl_sampler
    from stylerenderer_tpu_torch.eval import (
        extract_features_from_samples, load_lpips, load_patched_inception_v3, load_stats,
    )
    from stylerenderer_tpu_torch.inversion import ProjectorConfig, make_projector
    from stylerenderer_tpu_torch.models import Generator, GeneratorWithMap
    from stylerenderer_tpu_torch.utils.checkpoint import load_generator_weights

    none = {"rasterize_multi": 0, "rasterize_single": 0}
    t_phase = time.perf_counter()
    # 1. the real statistics of the writer's shard
    stats = os.path.join(os.path.dirname(shard), "inception_faces256.pkl")
    t0 = time.perf_counter()
    out, counts = run_path("eval calc_inception",
                           lambda: calc_main([shard, "--size", "256", "--out", stats]))
    calc_s = time.perf_counter() - t0
    mu, cov = load_stats(stats)
    if (out != stats or raster(counts) != none or mu.shape != (2048,)
            or cov.shape != (2048, 2048) or not (np.isfinite(mu).all() and np.isfinite(cov).all())):
        raise AssertionError(f"cli calc_inception: {out}, launches {counts}, stats "
                             f"{mu.shape} {cov.shape}")
    log(f"eval: cli.calc_inception on the synth shard ({SYNTH_IMAGES} images, 256 px): "
        f"{calc_s:.1f} s host clock (set-up included), launches {counts}")

    # 2. cli.fid: the meshes its batches render are recorded on the way
    seen = []
    pyramid = GeneratorWithMap.normal_pyramid

    def recording(self, mesh):
        seen.append(mesh)
        return pyramid(self, mesh)

    GeneratorWithMap.normal_pyramid = recording
    try:
        t0 = time.perf_counter()
        fid, counts = run_path("eval fid", lambda: fid_main([
            "--with_map", "--ckpt", ckpt, "--inception", stats, "--size", "256",
            "--n_sample", str(FID_SAMPLES), "--batch", str(FID_BATCH)]))
        fid_s = time.perf_counter() - t0
    finally:
        GeneratorWithMap.normal_pyramid = pyramid
    n_batches = FID_SAMPLES // FID_BATCH
    if raster(counts) != {"rasterize_multi": n_batches, "rasterize_single": 0}:
        raise AssertionError(f"cli fid: launches {counts}, expected {n_batches} of K1")
    if not (np.isfinite(fid) and fid > 0) or len(seen) != n_batches:
        raise AssertionError(f"cli fid: {fid}, {len(seen)} batches rendered")
    vert, norm, _ = seen[0]
    check_k1(vert, norm, f"the cli.fid first batch's posed mesh (B={FID_BATCH})")
    del seen
    log(f"eval: cli.fid --with_map --ckpt, {FID_SAMPLES} samples, B={FID_BATCH}: fid "
        f"{fid:.4f} (random-feature Inception), {fid_s:.1f} s host clock (set-up and the "
        f"2048-d sqrtm included), launches {counts}; {smi}")
    # FID sampling alone: the CLI's sampler and network on the checkpoint
    gen = GeneratorWithMap(256, 512, 8, channel_multiplier=2, seed=0, device=dev).eval()
    load_generator_weights(ckpt, gen)
    inception = load_patched_inception_v3(device=dev)
    sample = make_sampler(gen, synth_mesh, torch.Generator(device=dev).manual_seed(1))
    rng = torch.Generator().manual_seed(2)
    with torch.no_grad():
        imgs = sample(rng, FID_BATCH)
        gar_ms = cuda_ms(torch, lambda: sample(rng, FID_BATCH), 5)
        inc_ms = cuda_ms(torch, lambda: inception(imgs), 5)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    feats = extract_features_from_samples(sample, inception, FID_SAMPLES, FID_BATCH, rng)
    torch.cuda.synchronize()
    fid_rate = FID_SAMPLES / (time.perf_counter() - t0)
    fid_peak = torch.cuda.max_memory_allocated()
    if feats.shape != (FID_SAMPLES, 2048) or not np.isfinite(feats).all():
        raise AssertionError(f"fid sampling: features {feats.shape}")
    log(f"eval: FID sampling, GAR f32 (cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}) + "
        f"InceptionV3, B={FID_BATCH}: {fid_rate:.1f} images/s (host clock, {FID_SAMPLES} "
        f"images); per batch (CUDA events): sampler (z, posed mesh, GAR forward) "
        f"{gar_ms:.3f} ms, Inception (resize to 299 included) {inc_ms:.3f} ms; peak memory "
        f"{fid_peak / 2 ** 30:.2f} GiB; {smi}")
    del imgs, inception, sample

    # 3. cli.ppl
    t0 = time.perf_counter()
    ppl, counts = run_path("eval ppl", lambda: ppl_main([
        "--with_map", "--ckpt", ckpt, "--size", "256", "--n_sample", str(PPL_SAMPLES),
        "--batch", str(PPL_BATCH)]))
    ppl_s = time.perf_counter() - t0
    want = {"rasterize_multi": 2 * PPL_SAMPLES // PPL_BATCH, "rasterize_single": 0}
    if raster(counts) != want or not np.isfinite(ppl):
        raise AssertionError(f"cli ppl: {ppl}, launches {counts}, expected {want}")
    log(f"eval: cli.ppl --with_map --ckpt, {PPL_SAMPLES} pairs, B={PPL_BATCH}: ppl {ppl:.4f} "
        f"(random-feature LPIPS), {ppl_s:.1f} s host clock (set-up included), launches "
        f"{counts}")
    # PPL sampling alone, with the CLI's sampler on the checkpoint
    lpips = load_lpips("vgg", device=dev)
    sampler = make_ppl_sampler(gen, lpips, PPL_BATCH, synth_mesh)
    g = torch.Generator().manual_seed(3)
    sampler(g, PPL_BATCH)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    d = torch.cat([sampler(g, PPL_BATCH) for _ in range(PPL_SAMPLES // PPL_BATCH)])
    torch.cuda.synchronize()
    ppl_rate = PPL_SAMPLES / (time.perf_counter() - t0)
    if not bool(torch.isfinite(d).all()):
        raise AssertionError("ppl sampling: non-finite distances")
    log(f"eval: PPL sampling (space w, eps 1e-4, two GAR forwards and LPIPS VGG16 a batch), "
        f"B={PPL_BATCH}: {ppl_rate:.1f} pairs/s (host clock, {PPL_SAMPLES} pairs); {smi}")
    del gen

    # 4. the LPIPS projector: the paper's inversion loss, each B=8
    target, target_lmk, lmk_vidx = targets
    target, target_lmk = target[:LPIPS_INV_BATCH], target_lmk[:LPIPS_INV_BATCH]
    gen = GeneratorWithMap(256, 512, 8, channel_multiplier=2, seed=0, device=dev)
    projects = {w: make_projector(gen, face, tri, ProjectorConfig(iters=INV_ITERS, w_lpips=w),
                                  lpips_fn=lpips, lmk_vidx=lmk_vidx) for w in (0.8, 0.0)}
    project = projects[0.8]
    project(0, target, target_lmk, n_steps=2)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    name = f"eval lpips inversion each B={LPIPS_INV_BATCH}"
    t0 = time.perf_counter()
    out, counts = run_path(name, lambda: project(0, target, target_lmk, return_state=True))
    inv_ms = (time.perf_counter() - t0) * 1e3 / INV_ITERS
    inv_peak = torch.cuda.max_memory_allocated()
    want = {"rasterize_multi": INV_ITERS + 1, "rasterize_single": 0}
    hist = out["loss_history"].cpu().numpy()
    if raster(counts) != want:
        raise AssertionError(f"{name}: launches {counts}, expected {want}")
    if (hist.shape != (INV_ITERS,) or not np.isfinite(hist).all() or not hist[-1] < hist[0]
            or "lpips" not in out["losses"] or not float(out["losses"]["lpips"]) > 0):
        raise AssertionError(f"{name}: loss history {hist}, terms {list(out['losses'])}")
    # one step's device time with and without the LPIPS term (profiled 2-step
    # minus 1-step calls from the same state): their difference is LPIPS'
    busy = {}
    for w, proj in projects.items():
        prof = [profile_step(torch, lambda n=n: proj(0, target, target_lmk, state=out["state"],
                                                      n_steps=n)) for n in (1, 2)]
        busy[w] = prof[1]["busy_ms"] - prof[0]["busy_ms"]
    img = out["render"].detach().requires_grad_(True)
    lp_ms = cuda_ms(torch, lambda: torch.autograd.grad(lpips(img, target).sum(), img), 5)
    share = (busy[0.8] - busy[0.0]) / busy[0.8]
    log(f"eval: {name}, ProjectorConfig(iters={INV_ITERS}, w_lpips=0.8), f32: "
        f"{inv_ms:.1f} ms per step (host clock over the fit, init and final render "
        f"included); launches {counts}; peak memory {inv_peak / 2 ** 30:.2f} GiB; loss "
        f"{hist[0]:.5f} -> {hist[-1]:.5f}; final terms "
        + ", ".join(f"{k} {float(v):.5f}" for k, v in out["losses"].items()) + "; " + smi)
    log(f"  one step's device busy (profiled 2-step minus 1-step call): {busy[0.8]:.1f} ms with "
        f"LPIPS, {busy[0.0]:.1f} ms without: LPIPS' share {share:.3f}; LPIPS VGG16 forward "
        f"and backward alone at B={LPIPS_INV_BATCH}, 256 px (CUDA events): {lp_ms:.3f} ms")
    del out, gen, projects, project, lpips

    # 5. the unconditioned Generator, and cli.generate without --with_map
    gen = Generator(256, 512, 8, channel_multiplier=2, seed=0, device=dev).eval()
    zs = [torch.randn(BATCH, 512, generator=g).to(dev) for _ in range(GEN_FORWARDS + 1)]
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        gen([zs[0]])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        images, counts = run_path("eval generator", lambda: [gen([z])[0] for z in zs[1:]])
        gen_rate = BATCH * GEN_FORWARDS / (time.perf_counter() - t0)
        fwd_ms = cuda_ms(torch, lambda: gen([zs[0]]), 5)
    gen_peak = torch.cuda.max_memory_allocated()
    if raster(counts) != none or any(tuple(i.shape) != (BATCH, 3, 256, 256)
                             or not bool(torch.isfinite(i).all()) for i in images):
        raise AssertionError(f"generator: launches {counts} or bad images")
    del images, gen
    with tempfile.TemporaryDirectory() as tmp:
        paths, counts = run_path("eval cli generate", lambda: generate_main([
            "--size", "256", "--sample", "4", "--pics", "1", "--out", tmp]))
        with open(paths[0], "rb") as f:
            if raster(counts) != none or f.read(8) != b"\x89PNG\r\n\x1a\n":
                raise AssertionError(f"cli generate without --with_map: launches {counts}")
    log(f"eval: Generator(256, 512, 8, channel_multiplier=2) f32, B={BATCH}: {gen_rate:.1f} "
        f"renders/s (host clock, {GEN_FORWARDS} forwards), {fwd_ms:.3f} ms a forward (CUDA "
        f"events), peak memory {gen_peak / 2 ** 30:.2f} GiB; cli.generate without --with_map "
        f"wrote a PNG; {smi}")
    log(f"eval phase: {time.perf_counter() - t_phase:.1f} s")

def regressor_heads_phase(torch, np, dev, smi, work, synth_mesh, mesh, targets, run_path,
                          plain_step_ms):
    """Phase 4g: the three supervisor nets on the card against the CPU; the
    Regressor trained on the training checkpoint's ``g_ema`` (K1 once a
    step, a falling loss); the Regressor-initialized fit on the inversion
    targets (K1 21 times); ``cli.train --sfs --lmk --feat`` on the synth
    shard, then each kind of step with the heads timed and counted. Fails
    loudly on any check."""
    from stylerenderer_tpu_torch.cli.train import main as train_main
    from stylerenderer_tpu_torch.inversion import ProjectorConfig, make_projector
    from stylerenderer_tpu_torch.models import GeneratorWithMap, Regressor
    from stylerenderer_tpu_torch.supervisors import (
        InceptionResnetV1, PFLDInference, ResNetUNet, make_extra_heads, random_stand_in_,
    )
    from stylerenderer_tpu_torch.train import (
        init_regressor_state, make_regressor_fn, regressor_step, sample_regressor_batch,
    )
    from stylerenderer_tpu_torch.utils.checkpoint import load_generator_weights
    from stylerenderer_tpu_torch.utils.config import TrainConfig

    t_phase = time.perf_counter()
    shard = os.path.join(work, "faces256.srpack")
    ckpt = os.path.join(work, "train", "checkpoint")
    # 1. the supervisor nets (fixed-seed stand-ins) on the card against the
    # CPU, TF32 off
    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for cls, size in ((ResNetUNet, 256), (PFLDInference, 112), (InceptionResnetV1, 160)):
            net = random_stand_in_(cls(), torch.Generator().manual_seed(1)).eval()
            x = torch.rand(SUP_BATCH, 3, size, size, generator=torch.Generator().manual_seed(2))
            x = x * 2 - 1
            with torch.no_grad():
                cpu = net(x)
                card = net.to(dev)(x.to(dev))
            outs = zip(cpu, card) if cls is ResNetUNet else [(cpu, card)]
            errs = []
            for a, b in outs:
                err, scale = float((b.cpu() - a).abs().max()), float(a.abs().max())
                if not (bool(torch.isfinite(b).all()) and err <= 1e-4 * scale):
                    raise AssertionError(f"{cls.__name__} at {size} px: card vs CPU {err:.3e} "
                                         f"of {scale:.3e}")
                errs.append(f"max |diff| {err:.3e} of {scale:.3e}")
            log(f"check: {cls.__name__} at {size} px, B={SUP_BATCH} (TF32 off, card vs CPU): "
                + "; ".join(errs) + " (tolerance 1e-4 of the largest output)")
            del net, cpu, card
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags

    # 2. the Regressor's self-supervised training on the checkpoint's g_ema
    face, tri = synth_mesh
    gen = GeneratorWithMap(256, 512, 8, channel_multiplier=2, seed=0, device=dev)
    load_generator_weights(ckpt, gen)
    gen.eval().requires_grad_(False)
    reg = Regressor(256, 512, 8, channel_multiplier=2, seed=0, device=dev)
    state = init_regressor_state(reg, seed=0)

    def reg_step():
        img, w = sample_regressor_batch(gen, face, tri, REG_BATCH, state.generator)
        return regressor_step(state, img, w)["regressor_loss"]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    hist, counts = run_path("regressor train", lambda: [reg_step() for _ in range(REG_STEPS)])
    reg_s = time.perf_counter() - t0
    reg_peak = torch.cuda.max_memory_allocated()
    hist = torch.stack(hist).cpu().numpy()
    if raster(counts) != {"rasterize_multi": REG_STEPS, "rasterize_single": 0}:
        raise AssertionError(f"regressor train: launches {counts}, expected {REG_STEPS} of K1")
    first, last = float(hist[:10].mean()), float(hist[-10:].mean())
    if not (np.isfinite(hist).all() and last < first):
        raise AssertionError(f"regressor train: losses {hist}")
    img, w = sample_regressor_batch(gen, face, tri, REG_BATCH, state.generator)
    sampler_ms = cuda_ms(torch, lambda: sample_regressor_batch(gen, face, tri, REG_BATCH,
                                                               state.generator), 5)
    step_ms = cuda_ms(torch, lambda: regressor_step(state, img, w), 5)
    prof = profile_step(torch, reg_step, top_n=6)
    log(f"regressor train: Regressor(256, 512, 8, channel_multiplier=2) f32 "
        f"(cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}) on the training checkpoint's "
        f"g_ema, B={REG_BATCH}, Adam lr 1e-4: {REG_STEPS} steps in {reg_s:.2f} s host clock "
        f"({reg_s * 1e3 / REG_STEPS:.1f} ms per step); launches {counts}; loss "
        f"{hist[0]:.5f} -> {hist[-1]:.5f}, mean of the first 10 {first:.5f}, of the last 10 "
        f"{last:.5f}; peak memory {reg_peak / 2 ** 30:.2f} GiB; per step (CUDA events, mean "
        f"of 5): sampler {sampler_ms:.2f} ms (z, mapping, posed mesh, K1, synthesis), step "
        f"{step_ms:.2f} ms (forward, backward, Adam); one step profiled: device busy "
        f"{prof['busy_ms']:.1f} ms of {prof['wall_ms']:.1f} ms host clock (busy share "
        f"{prof['busy_ms'] / prof['wall_ms']:.3f}), {prof['events']} device events, K1 and "
        f"its binning {prof['kernel_ms'] + prof['bins_ms']:.3f} ms; {smi}")
    for t, n, op in prof["by_op"]:
        log(f"    {t:9.3f} ms  {t / prof['busy_ms']:6.1%}  {n:5d} calls  {op}")
    del gen, img, w

    # 3. the Regressor-initialized fit on the inversion targets (the
    # checkpoint's g_ema on the inversion mesh)
    pface, ptri = mesh
    target, target_lmk, lmk_vidx = targets
    tgt, lmk = target[:REG_INV_BATCH], target_lmk[:REG_INV_BATCH]
    pgen = GeneratorWithMap(256, 512, 8, channel_multiplier=2, seed=0, device=dev)
    load_generator_weights(ckpt, pgen)
    cfg = ProjectorConfig(iters=INV_ITERS, w_lpips=0.0)
    project = make_projector(pgen, pface, ptri, cfg, lmk_vidx=lmk_vidx,
                             regressor_fn=make_regressor_fn(reg))
    project(0, tgt, lmk, n_steps=2)  # warm-up
    name = f"regressor inversion each B={REG_INV_BATCH}"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, counts = run_path(name, lambda: project(0, tgt, lmk))
    inv_ms = (time.perf_counter() - t0) * 1e3 / INV_ITERS
    if raster(counts) != {"rasterize_multi": INV_ITERS + 1, "rasterize_single": 0}:
        raise AssertionError(f"{name}: launches {counts}, expected {INV_ITERS + 1} of K1")
    ihist = out["loss_history"].cpu().numpy()
    if ihist.shape != (INV_ITERS,) or not np.isfinite(ihist).all() or not ihist[-1] < ihist[0]:
        raise AssertionError(f"{name}: loss history {ihist}")
    mean_first = float(make_projector(pgen, pface, ptri, cfg, lmk_vidx=lmk_vidx)(
        0, tgt, lmk, n_steps=1)["loss_history"][0])
    log(f"{name}: the checkpoint's g_ema, {INV_ITERS} steps, {inv_ms:.1f} ms per step (host "
        f"clock, init and final render included); launches {counts}; loss {ihist[0]:.5f} -> "
        f"{ihist[-1]:.5f}; first loss {ihist[0]:.5f} from the Regressor's init, "
        f"{mean_first:.5f} from the mean latent's (a figure, not a gate)")
    del out, pgen, project

    # 4. training with the three heads through the CLI, then each kind of
    # step with the heads alone
    out_dir = os.path.join(work, "train_heads")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tstate, counts = run_path("train heads", lambda: train_main([
        shard, "--sfs", "--lmk", "--feat", "--iter", str(HEADS_STEPS), "--batch", str(BATCH),
        "--d_reg_every", "16", "--g_reg_every", "4", "--log_every", "1", "--sample_every",
        str(HEADS_STEPS), "--ckpt_every", str(HEADS_STEPS), "--seed", "0",
        "--out_dir", out_dir]))
    heads_s = time.perf_counter() - t0
    kinds = ["R1 + path" if i % 16 == 0 else "path" if i % 4 == 0 else "plain"
             for i in range(HEADS_STEPS)]
    want = {"rasterize_multi": sum(3 if k != "plain" else 2 for k in kinds) + 1,
            "rasterize_single": 0}  # + 1: the EMA sample grid
    if raster(counts) != want:
        raise AssertionError(f"train heads: launches {counts}, expected {want}")
    with open(os.path.join(out_dir, "logs", "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    if [r["step"] for r in rows] != list(range(HEADS_STEPS)):
        raise AssertionError(f"train heads: logged steps {[r['step'] for r in rows]}")
    for r in rows:
        if (not all(k in r and np.isfinite(r[k]) for k in ("sfs", "feature", "lmk", "g", "d"))
                or r["nonfinite_steps"] != 0):
            raise AssertionError(f"train heads: step {r['step']}: {r}")
    log(f"train heads: cli.train --sfs --lmk --feat, 256 px, B={BATCH}, {HEADS_STEPS} steps "
        f"in {heads_s:.1f} s (set-up, checkpoint and sample grid included); launches "
        f"{counts}; peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    for r, kind in zip(rows, kinds):
        log(f"  step {r['step']} ({kind}): {r['step_ms']:.1f} ms host clock; g {r['g']:.4f}, "
            f"sfs {r['sfs']:.5f}, feature {r['feature']:.6f}, lmk {r['lmk']:.5f}")
    heads = make_extra_heads(1, sfs=True, lmk=True, feat=True, image_size=256, device=dev)
    tcfg = TrainConfig(batch=BATCH, d_reg_every=16, g_reg_every=4)
    time_step_kinds(torch, tstate, tcfg, real_batch(torch, np, shard, dev), *synth_mesh,
                    run_path, "train heads step", heads,
                    lambda kind, m: (f"against {plain_step_ms[kind]:.1f} ms without the heads "
                                     f"(phase 4a); sfs {float(m['sfs']):.5f}, feature "
                                     f"{float(m['feature']):.6f}, lmk {float(m['lmk']):.5f}"))
    log(f"phase 4g: {time.perf_counter() - t_phase:.1f} s; {smi}")


def raster(counts):
    """A path's launch counts of the rasterizer kernels (K1, K2), which its
    checks fix; the epilogue's are reported beside them."""
    return {k: counts[k] for k in ("rasterize_multi", "rasterize_single")}


def check_launches(counts, want, what):
    if raster(counts) != want:
        raise AssertionError(f"{what}: launches {counts}, expected {want}")


def warp_plain(np, img, M, size, border):
    """``cv2.warpAffine(img, M, size[::-1], INTER_LINEAR, BORDER_CONSTANT or
    BORDER_REFLECT)`` in numpy float64, the plain version of the port's
    ``warp_affine`` (uint8 ``[H, W, C]`` in and out): ``M`` maps source to
    destination pixels, pixel centres at integer coordinates, each bilinear
    tap outside the image 0 or mirrored (``fedcba|abcdefgh|hgfedcb``)."""
    H, W = img.shape[:2]
    inv = np.linalg.inv(np.vstack([np.asarray(M, np.float64), [0.0, 0.0, 1.0]]))
    ys, xs = np.mgrid[:size[0], :size[1]].astype(np.float64)
    sx = inv[0, 0] * xs + inv[0, 1] * ys + inv[0, 2]
    sy = inv[1, 0] * xs + inv[1, 1] * ys + inv[1, 2]
    x0, y0 = np.floor(sx), np.floor(sy)
    fx, fy = (sx - x0)[..., None], (sy - y0)[..., None]
    src = img.astype(np.float64)

    def tap(yy, xx):
        if border == "reflect":
            xx, yy = np.mod(xx, 2 * W), np.mod(yy, 2 * H)
            xx, yy = np.where(xx >= W, 2 * W - 1 - xx, xx), np.where(yy >= H, 2 * H - 1 - yy, yy)
            return src[yy.astype(int), xx.astype(int)]
        ok = ((xx >= 0) & (xx < W) & (yy >= 0) & (yy < H))[..., None]
        return np.where(ok, src[np.clip(yy, 0, H - 1).astype(int),
                                np.clip(xx, 0, W - 1).astype(int)], 0.0)

    out = ((1 - fy) * ((1 - fx) * tap(y0, x0) + fx * tap(y0, x0 + 1))
           + fy * ((1 - fx) * tap(y0 + 1, x0) + fx * tap(y0 + 1, x0 + 1)))
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def face_models_phase(torch, np, dev, smi, work, run_path, max_err, keys_of_bins):
    """Phase 4h: the real face models and the data pipeline. A BFM ``.mat``
    of the BFM 2009's size through ``load_bfm`` (K1 on its mesh,
    ``render_mean_face`` at 256^2 through K2, both bit-equal to their plain
    versions and timed beside their bounds); FaceWarehouse and FLAME at
    their published sizes (forward on the card against the CPU, the
    ``each`` GAR on their meshes, K1 bit-equal); then photos rendered from
    the BFM by the training checkpoint, moved by known similarities,
    through ``cli.align``, ``align_dataset`` with the PFLD detector,
    ``cli.prepare_data`` (raw and JPEG), ``cli.train --bfm`` on the folder
    and the JPEG shard, and ``generate``, ``project``, ``fid`` and ``ppl``
    with ``--bfm``: each counted and checked. Fails loudly on any check."""
    import io

    import scipy.io
    from PIL import Image
    from torch_face_models import bfm_dict, facewarehouse_dict, flame_dict

    from stylerenderer_tpu_torch.cli.align import main as align_main
    from stylerenderer_tpu_torch.cli.fid import main as fid_main
    from stylerenderer_tpu_torch.cli.generate import main as generate_main
    from stylerenderer_tpu_torch.cli.ppl import main as ppl_main
    from stylerenderer_tpu_torch.cli.prepare_data import main as prepare_main
    from stylerenderer_tpu_torch.cli.project import main as project_main
    from stylerenderer_tpu_torch.cli.train import main as train_main
    from stylerenderer_tpu_torch.data import SRPackReader
    from stylerenderer_tpu_torch.face3d import (
        load_bfm, load_bfm_texture, load_facewarehouse, load_flame, mesh_point_normal,
        random_apply_pose3D,
    )
    from stylerenderer_tpu_torch.face3d.alignment import (
        LandmarksDetectorTorch, align_dataset, build_canonical_reference, read_bgr,
        render_mean_face, solve_affine, warp_affine,
    )
    from stylerenderer_tpu_torch.models import GeneratorWithMap
    from stylerenderer_tpu_torch.ops.rasterize_multi import (
        rasterize_winners_multi, rasterize_winners_multi_ref,
    )
    from stylerenderer_tpu_torch.ops.rasterize_single import (
        build_bins, card_tile, rasterize_winners_single, rasterize_winners_single_ref,
    )
    from stylerenderer_tpu_torch.supervisors import PFLDInference, random_stand_in_
    from stylerenderer_tpu_torch.utils.checkpoint import load_generator_weights
    from stylerenderer_tpu_torch.utils.image import write_png

    none = {"rasterize_multi": 0, "rasterize_single": 0}
    size = GAR["size"]
    gar_args = [f"--{k}={v}" for k, v in GAR.items()]
    t_phase = time.perf_counter()

    def k1_on(what, vert, norm, tri):
        """K1 at 7 levels with C=3 values on ``vert``: samples 0-1 bit-equal
        to the plain version, then timed at the whole batch beside its
        bound."""
        out = rasterize_winners_multi(vert[:2], tri, TOP, N_LEVELS, attrs=norm[:2])
        ref, plain_ms = once_ms(torch, lambda: rasterize_winners_multi_ref(
            vert[:2], tri, TOP, N_LEVELS, attrs=norm[:2]))
        max_err["rasterize_multi"] = max(max_err["rasterize_multi"], compare_multi(
            out, ref, True, f"K1 on {what}"))
        del out, ref
        m = k1_measure(torch, np, vert, tri, N_LEVELS, norm, keys_of_bins)
        log(k1_report(f"K1 on {what}, B={vert.shape[0]}, {N_LEVELS} levels, C=3; samples 0-1 "
                      f"bit-equal to the plain version ({plain_ms:.1f} ms once, B=2)", m))
        return m

    # 1. a BFM .mat of the BFM 2009's size, loaded on the card
    t0 = time.perf_counter()
    bfm = os.path.join(work, "bfm.mat")
    scipy.io.savemat(bfm, bfm_dict(*BFM_MESH, *BFM_DIMS))
    face, tri = load_bfm(bfm, device=dev)
    tex = load_bfm_texture(bfm)
    nv = face.mean.shape[0] // 3
    log(f"bfm: a BFM .mat over a sphere mesh {BFM_MESH}: {nv} vertices, {tri.shape[0]} "
        f"triangles, {face.shape_dim} shape and {face.expression_dim} expression directions, "
        f"{os.path.getsize(bfm) / 2 ** 20:.0f} MiB; written and loaded on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    g = torch.Generator().manual_seed(11)
    vert = random_apply_pose3D(g, face(face.random_input(BATCH, g)))
    norm = mesh_point_normal(vert, tri)
    gen = GeneratorWithMap(GAR["size"], GAR["latent"], GAR["n_mlp"],
                           channel_multiplier=GAR["channel_multiplier"], seed=0,
                           device=dev).eval()
    meshes = {"BFM": (vert, norm, tri)}
    k1_rows = {"BFM": k1_on(f"the BFM mesh ({tri.shape[0]} triangles)", vert, norm, tri)}

    # render_mean_face on the BFM mesh at 256^2: K2
    img, counts = run_path("bfm render_mean_face",
                           lambda: render_mean_face(face, tex, tri, size, size))
    check_launches(counts, {"rasterize_multi": 0, "rasterize_single": 1},
                   "render_mean_face on the BFM mesh")
    v0 = face(torch.zeros(1, face.sigma.shape[0], device=dev))
    ref, k2_plain_ms = once_ms(torch, lambda: rasterize_winners_single_ref(v0, tri, size, size))
    max_err["rasterize_single"] = max(max_err["rasterize_single"], compare_wins(
        rasterize_winners_single(v0, tri, size, size), ref, "K2 on the BFM mean face"))
    tile = card_tile(size, size)
    k2m = k2_measure(torch, np, v0, tri, size, size, tile, keys_of_bins, ref)
    dat, _, starts = build_bins(v0, tri, size, size, False, EPS, tile)
    k2b_ms, k2_by, nbytes, ops, pairs, n_valid = k2_bound(torch, dat, starts, size, size)
    covered = float((ref >= 0).float().mean())
    del dat, starts, ref
    log(k2_report(f"K2 render_mean_face on the BFM mesh, {size}^2, B=1, bit-equal to its plain "
                  f"version ({k2_plain_ms:.1f} ms once); launches {counts}; face pixels "
                  f"{covered:.3f}", {tile: k2m})
        + f"; bound {k2b_ms:.4f} ms by {k2_by} ({nbytes} bytes, {ops} f32 ops, {pairs} bbox "
        f"pairs, {n_valid} valid triangles)")

    # 2. FaceWarehouse and FLAME at their published sizes: forward on the card
    # against the CPU (TF32 off), the each GAR on their meshes
    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    for name, load, data in (
            ("FaceWarehouse", load_facewarehouse, lambda: facewarehouse_dict(*FW_MESH, *FW_DIMS)),
            ("FLAME", load_flame, lambda: flame_dict(*FLAME_MESH, FLAME_SHAPE))):
        d = data()
        t0 = time.perf_counter()
        model, mtri = load(d, device=dev)
        load_s = time.perf_counter() - t0
        model_cpu, _ = load(d, device="cpu")
        del d
        x = model_cpu.random_input(BATCH, torch.Generator().manual_seed(12))
        if not torch.equal(model.random_input(BATCH, torch.Generator().manual_seed(12)).cpu(),
                           x):
            raise AssertionError(f"{name}: random_input differs between the card's model and "
                                 "the CPU's for the same generator")
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        try:
            with torch.no_grad():
                v_cpu = model_cpu(x)
                v_card = model(x.to(dev))
                fwd_ms = cuda_ms(torch, lambda: model(x.to(dev)), 5)
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
        err, scale = float((v_card.cpu() - v_cpu).abs().max()), float(v_cpu.abs().max())
        if not err <= 1e-5 * scale:
            raise AssertionError(f"{name}: card vs CPU {err:.3e} of {scale:.3e}")
        vert = random_apply_pose3D(g, v_card)
        norm = mesh_point_normal(vert, mtri)
        z = torch.randn(BATCH, GAR["latent"], generator=g).to(dev)
        with torch.no_grad():
            gen([z], (vert, norm, mtri))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            img, counts = run_path(f"{name} each", lambda: gen([z], (vert, norm, mtri))[0])
            each_ms = (time.perf_counter() - t0) * 1e3
        check_launches(counts, {"rasterize_multi": 1, "rasterize_single": 0}, f"{name} each")
        if tuple(img.shape) != (BATCH, 3, size, size) or not bool(torch.isfinite(img).all()):
            raise AssertionError(f"{name} each: image {tuple(img.shape)}")
        log(f"{name}: {model.dim[2] // 3} vertices, {mtri.shape[0]} triangles, dims "
            f"{model.dim[:2]}; loaded on the card in {load_s:.1f} s; forward B={BATCH} (TF32 off) card vs "
            f"CPU max |diff| {err:.3e} of {scale:.3e} (tolerance 1e-5 of it), "
            f"{fwd_ms:.3f} ms (CUDA events); random_input equal on both; each GAR f32 "
            f"B={BATCH} {each_ms:.1f} ms host clock, launches {counts}")
        meshes[name] = (vert, norm, mtri)
        k1_rows[name] = k1_on(f"the {name} mesh ({mtri.shape[0]} triangles)", vert, norm, mtri)
        del model, model_cpu, v_cpu, v_card, img
    del gen, meshes

    # 3. the pipeline at full width on the training checkpoint
    ckpt = os.path.join(work, "train", "checkpoint")
    pgen = GeneratorWithMap(GAR["size"], GAR["latent"], GAR["n_mlp"],
                            channel_multiplier=GAR["channel_multiplier"], seed=0, device=dev)
    load_generator_weights(ckpt, pgen)
    pgen.eval()
    lmk_vidx = np.linspace(0, nv - 1, 68).astype(np.int64)

    def to_px(v):
        """NDC -> pixel coordinates (``build_canonical_reference``'s map)."""
        v = v.cpu().numpy()
        return np.stack([(1 + v[..., 0]) * size / 2 - 0.5, (1 - v[..., 1]) * size / 2 - 0.5],
                        -1)

    # 3.1 photos: the GAR's renders of posed BFM faces, moved by known
    # similarities with the port's warp, as PNGs with a landmark manifest
    def render_photos():
        outs, lmks = [], []
        with torch.no_grad():
            for _ in range(PHOTOS // BATCH):
                z = torch.randn(BATCH, GAR["latent"], generator=g).to(dev)
                v = random_apply_pose3D(g, face(face.random_input(BATCH, g)))
                outs.append(pgen([z], (v, mesh_point_normal(v, tri), tri))[0])
                lmks.append(to_px(v[:, lmk_vidx]))
        return torch.cat(outs), np.concatenate(lmks)

    t0 = time.perf_counter()
    (renders, lmk), photo_counts = run_path("pipeline photos", render_photos)
    render_s = time.perf_counter() - t0
    check_launches(photo_counts, {"rasterize_multi": PHOTOS // BATCH, "rasterize_single": 0},
                   "photos")
    rgb = torch.clamp(torch.round((renders + 1) * 127.5), 0, 255)
    bgr = rgb.flip(1)  # the photos as cv2 holds them: BGR
    rng = np.random.RandomState(13)
    S = []
    for _ in range(PHOTOS):
        th, sc = rng.uniform(-0.3, 0.3), rng.uniform(0.85, 1.15)
        A = sc * np.asarray([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
        c = np.asarray([size / 2 - 0.5] * 2)
        S.append(np.concatenate([A, (c - A @ c + rng.uniform(-20, 20, 2))[:, None]], 1))
    S = np.stack(S)
    warp_ms = cuda_ms(torch, lambda: warp_affine(bgr, S, size), 5)
    moved = torch.clamp(torch.round(warp_affine(bgr, S, size)), 0, 255)
    moved_u8 = moved.permute(0, 2, 3, 1).to(torch.uint8).cpu().numpy()
    renders_u8 = bgr.permute(0, 2, 3, 1).to(torch.uint8).cpu().numpy()
    refl = torch.clamp(torch.round(warp_affine(bgr[:4], S[:4], size, "reflect")), 0, 255)
    refl_u8 = refl.permute(0, 2, 3, 1).to(torch.uint8).cpu().numpy()
    warp_err = 0
    for i in range(PHOTOS):
        warp_err = max(warp_err, int(np.abs(moved_u8[i].astype(int) - warp_plain(
            np, renders_u8[i], S[i], (size, size), "constant")).max()))
    for i in range(4):
        warp_err = max(warp_err, int(np.abs(refl_u8[i].astype(int) - warp_plain(
            np, renders_u8[i], S[i], (size, size), "reflect")).max()))
    if warp_err > 1:
        raise AssertionError(f"warp_affine on the card vs its plain version: {warp_err} levels")
    photos_dir, aligned = os.path.join(work, "photos"), os.path.join(work, "aligned")
    os.makedirs(photos_dir)
    moved_lmk = np.einsum("bij,bnj->bni", S[:, :, :2], lmk) + S[:, None, :, 2]
    manifest = os.path.join(work, "landmarks.txt")
    with open(manifest, "w") as f:
        for i in range(PHOTOS):
            write_png(os.path.join(photos_dir, f"face{i:03d}.png"), moved_u8[i][:, :, ::-1])
            f.write(f"face{i:03d}.png " + " ".join(f"{v:.6f}" for v in moved_lmk[i].reshape(-1))
                    + "\n")
    log(f"pipeline photos: {PHOTOS} BFM faces rendered by the training checkpoint's g_ema "
        f"(f32, B={BATCH}) in {render_s:.2f} s, launches {photo_counts}; "
        f"moved by random similarities (rotation up to 0.3 rad, scale 0.85-1.15, shift up "
        f"to 20 px) with warp_affine on the card ({warp_ms:.3f} ms for {PHOTOS} at {size}^2, "
        f"CUDA events, the host's f64 inversion included): zeros and mirrored borders within "
        f"{warp_err} grey level of the plain "
        f"warp (cv2.warpAffine's semantics in numpy f64; tolerance 1)")

    # 3.2 cli.align with the manifest and the BFM's landmark vertices
    t0 = time.perf_counter()
    n, counts = run_path("pipeline align", lambda: align_main([
        photos_dir, "--out", aligned, "--lmk_manifest", manifest, "--bfm", bfm, "--size",
        str(size), "--lmk_vidx", ",".join(str(i) for i in lmk_vidx)]))
    align_s = time.perf_counter() - t0
    check_launches(counts, none, "cli align")
    if n != PHOTOS or len(os.listdir(aligned)) != PHOTOS:
        raise AssertionError(f"cli align: {n} photos aligned")
    ref = build_canonical_reference(face, tri, lmk_vidx, size)
    align_err, comp = 0, []
    ones = np.full((size, size, 3), 255, np.uint8)
    for i in range(PHOTOS):
        got = read_bgr(os.path.join(aligned, f"face{i:03d}.png"))
        M = solve_affine(moved_lmk[i], ref)
        align_err = max(align_err, int(np.abs(got.astype(int) - warp_plain(
            np, moved_u8[i], M, (size, size), "constant")).max()))
        # the aligned photo against the one warp of its unmoved render, where
        # both are inside their sources (two resamplings against one)
        direct = warp_plain(np, renders_u8[i], solve_affine(lmk[i], ref), (size, size),
                            "constant")
        inside = (warp_plain(np, warp_plain(np, ones, S[i], (size, size), "constant"), M,
                             (size, size), "constant") == 255).all(-1)
        inside &= (warp_plain(np, ones, solve_affine(lmk[i], ref), (size, size),
                              "constant") == 255).all(-1)
        comp.append(float(np.abs(got.astype(int) - direct)[inside].mean()))
    if align_err > 1 or max(comp) > 8.0:
        raise AssertionError(f"cli align: {align_err} levels from the plain warp, mean "
                             f"{max(comp):.2f} levels from the direct warp")
    log(f"pipeline align: cli.align --lmk_manifest --bfm --lmk_vidx (68 vertices), {PHOTOS} "
        f"photos at {size}^2 in {align_s:.2f} s: {PHOTOS / align_s:.1f} photos/s (host clock, "
        f"set-up included); launches {counts}; each aligned photo within {align_err} grey "
        f"level of the plain warp by solve_affine(its landmarks, the reference) (tolerance "
        f"1), and a mean of {np.mean(comp):.3f} (at most {max(comp):.3f}) grey levels from "
        f"the one warp of its unmoved render where both lie inside (tolerance a mean of 8: "
        f"two bilinear resamplings against one blur the edges; a warp the wrong way round "
        f"moves the face)")

    # 3.3 align_dataset with the PFLD detector on the card, the reference
    # detected on the BFM's textured mean face rendered at 256^2 (K2)
    pfld = random_stand_in_(PFLDInference(), torch.Generator().manual_seed(14)).eval().to(dev)
    t0 = time.perf_counter()
    n, counts = run_path("pipeline align render_ref", lambda: align_dataset(
        photos_dir, os.path.join(work, "aligned_pfld"), LandmarksDetectorTorch(pfld), face, tri,
        size=size, tex=tex))
    pfld_s = time.perf_counter() - t0
    check_launches(counts, {"rasterize_multi": 0, "rasterize_single": 1},
                   "align_dataset with the rendered reference")
    if n != PHOTOS:
        raise AssertionError(f"align_dataset: {n} photos aligned")
    log(f"pipeline align_dataset(tex=...) with LandmarksDetectorTorch over the PFLD stand-in on "
        f"the card: {PHOTOS} photos in {pfld_s:.2f} s ({PHOTOS / pfld_s:.1f} photos/s, the "
        f"reference render included); launches {counts}")

    # 3.4 cli.prepare_data on the aligned folder, raw and JPEG
    shards = {}
    for codec in ("raw", "jpeg"):
        shards[codec] = os.path.join(work, f"aligned_{codec}.srpack")
        t0 = time.perf_counter()
        n, counts = run_path(f"pipeline prepare {codec}", lambda c=codec: prepare_main([
            aligned, "--out", shards[c], "--size", f"{size // 2},{size}", "--codec", c]))
        prep_s = time.perf_counter() - t0
        check_launches(counts, none, f"cli prepare_data {codec}")
        with SRPackReader(shards[codec]) as r:
            if (r.n_items, r.sizes, r.codec) != (PHOTOS, [size // 2, size], int(codec == "jpeg")):
                raise AssertionError(f"prepare {codec}: {r.n_items} items, sizes {r.sizes}")
            item = r.decode(size, PHOTOS - 1)
        want = read_bgr(os.path.join(aligned, f"face{PHOTOS - 1:03d}.png"))[:, :, ::-1]
        if codec == "jpeg":  # PIL's round trip at quality 100, as prepare encodes
            buf = io.BytesIO()
            Image.fromarray(np.ascontiguousarray(want)).save(buf, format="jpeg", quality=100)
            want = np.asarray(Image.open(buf).convert("RGB"))
        if not np.array_equal(item, want):
            raise AssertionError(f"prepare {codec}: the last item differs from its photo")
        log(f"pipeline prepare: cli.prepare_data --codec {codec} --size {size // 2},{size} (8 "
            f"worker processes): {PHOTOS} items in {prep_s:.2f} s, {PHOTOS / prep_s:.1f} items/s "
            f"(host clock, the pool's start included); {os.path.getsize(shards[codec])} bytes; "
            f"the last item at {size} px equal to its photo"
            + (" through PIL's JPEG round trip at quality 100" if codec == "jpeg" else ""))

    # 3.5 cli.train --bfm on the aligned folder and on the JPEG shard
    train_ms = {}
    kinds = ["R1 + path" if i % 16 == 0 else "path" if i % 4 == 0 else "plain"
             for i in range(PIPE_STEPS)]
    for src, data in (("folder", aligned), ("jpeg shard", shards["jpeg"])):
        out = os.path.join(work, f"train_bfm_{src.split()[0]}")
        t0 = time.perf_counter()
        state, counts = run_path(f"pipeline train bfm {src}", lambda d=data, o=out: train_main([
            d, "--bfm", bfm, "--iter", str(PIPE_STEPS), "--batch", str(BATCH),
            "--d_reg_every", "16", "--g_reg_every", "4", "--log_every", "1", "--sample_every",
            str(PIPE_STEPS), "--ckpt_every", str(PIPE_STEPS), "--seed", "0", "--out_dir", o]
            + gar_args))
        run_s = time.perf_counter() - t0
        check_launches(counts, {"rasterize_multi": sum(3 if k != "plain" else 2 for k in kinds)
                                + 1, "rasterize_single": 0}, f"cli train --bfm on the {src}")
        with open(os.path.join(out, "logs", "metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        if [r["step"] for r in rows] != list(range(PIPE_STEPS)) or not all(
                np.isfinite(v) for r in rows for v in r.values()) or state.nonfinite_count:
            raise AssertionError(f"cli train --bfm on the {src}: {rows}")
        train_ms[src] = [r["step_ms"] for r in rows]
        log(f"pipeline train: cli.train --bfm on the aligned {src}, B={BATCH}, {PIPE_STEPS} "
            f"steps in {run_s:.1f} s (set-up, checkpoint and sample grid included); launches "
            f"{counts}; " + ", ".join(f"step {r['step']} ({k}) {r['step_ms']:.1f} ms"
                                      for r, k in zip(rows, kinds)) + " (host clock)")

    # 3.6 generate, project, fid and ppl with --bfm on the training checkpoint
    t0 = time.perf_counter()
    paths, counts = run_path("pipeline generate bfm", lambda: generate_main([
        "--with_map", "--bfm", bfm, "--ckpt", ckpt, "--sample", "4", "--pics", "1", "--out",
        os.path.join(work, "gen_bfm")] + gar_args))
    check_launches(counts, {"rasterize_multi": 1, "rasterize_single": 0}, "cli generate --bfm")
    log(f"pipeline cli: generate --with_map --bfm --ckpt: {time.perf_counter() - t0:.1f} s, "
        f"launches {counts}, wrote {os.path.basename(paths[0])}")
    out_dir = os.path.join(work, "recon_bfm")
    pngs = [os.path.join(aligned, f"face{i:03d}.png") for i in range(2)]
    t0 = time.perf_counter()
    res, counts = run_path("pipeline project bfm", lambda: project_main(
        pngs + ["--bfm", bfm, "--ckpt", ckpt, "--iters", "10", "--segments", "2", "--out",
                out_dir] + gar_args))
    check_launches(counts, {"rasterize_multi": 10 + 2, "rasterize_single": 0},
                   "cli project --bfm")
    hist = res["loss_history"].cpu().numpy()
    if tuple(res["vertices"].shape) != (2, nv, 3) or not np.isfinite(hist).all():
        raise AssertionError(f"cli project --bfm: vertices {tuple(res['vertices'].shape)}, "
                             f"losses {hist}")
    log(f"pipeline cli: project --bfm --ckpt on 2 aligned photos, --iters 10 --segments 2: "
        f"{time.perf_counter() - t0:.1f} s, launches {counts}, loss {hist[0]:.5f} -> "
        f"{hist[-1]:.5f}, meshes of {nv} vertices")
    stats = os.path.join(work, "inception_faces256.pkl")
    t0 = time.perf_counter()
    fid, counts = run_path("pipeline fid bfm", lambda: fid_main([
        "--with_map", "--bfm", bfm, "--ckpt", ckpt, "--inception", stats, "--n_sample",
        str(PIPE_FID[0]), "--batch", str(PIPE_FID[1])] + gar_args))
    check_launches(counts, {"rasterize_multi": PIPE_FID[0] // PIPE_FID[1],
                            "rasterize_single": 0}, "cli fid --bfm")
    if not (np.isfinite(fid) and fid > 0):
        raise AssertionError(f"cli fid --bfm: {fid}")
    log(f"pipeline cli: fid --with_map --bfm, {PIPE_FID[0]} samples, B={PIPE_FID[1]}: fid "
        f"{fid:.4f} against the synth shard's statistics (random-feature Inception), "
        f"{time.perf_counter() - t0:.1f} s (the 2048-d sqrtm included), launches {counts}")
    t0 = time.perf_counter()
    ppl, counts = run_path("pipeline ppl bfm", lambda: ppl_main([
        "--with_map", "--bfm", bfm, "--ckpt", ckpt, "--n_sample", str(PIPE_PPL[0]), "--batch",
        str(PIPE_PPL[1])] + gar_args))
    check_launches(counts, {"rasterize_multi": 2 * PIPE_PPL[0] // PIPE_PPL[1],
                            "rasterize_single": 0}, "cli ppl --bfm")
    if not np.isfinite(ppl):
        raise AssertionError(f"cli ppl --bfm: {ppl}")
    log(f"pipeline cli: ppl --with_map --bfm, {PIPE_PPL[0]} pairs: ppl {ppl:.4f}, "
        f"{time.perf_counter() - t0:.1f} s, launches {counts}")
    for name, m in k1_rows.items():
        log(f"phase 4h K1 on the {name} mesh: {m['ms']:.4f} ms at B={BATCH}, bound "
            f"{m['bound_ms']:.4f} ms by {m['bound_by']} ({m['ms'] / m['bound_ms']:.1f}x)")
    log(f"phase 4h K2 on the BFM mean face (render_mean_face, {size}^2, B=1): "
        f"{k2m['ms']:.4f} ms, bound {k2b_ms:.4f} ms by {k2_by}, plain {k2_plain_ms:.1f} ms")
    log(f"phase 4h: {time.perf_counter() - t_phase:.1f} s; {smi}")
    return {"k1": k1_rows, "k2": (k2m, k2b_ms, k2_by, k2_plain_ms), "train_ms": train_ms}


def metrics_rows(out, steps, what):
    """The logged rows of a ``cli.train`` run in ``out``: one per step,
    every metric finite, no step screened out."""
    import math

    with open(os.path.join(out, "logs", "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    if [r["step"] for r in rows] != list(range(steps)):
        raise AssertionError(f"{what}: logged steps {[r['step'] for r in rows]}")
    for r in rows:
        if not all(math.isfinite(v) for v in r.values()) or r["nonfinite_steps"] != 0:
            raise AssertionError(f"{what}: step {r['step']}: {r}")
    return rows


def highres_phase(torch, np, dev, smi, work, shard, face, tri, synth_mesh, run_path, max_err,
                  keys_of_bins, binned_cases):
    """Phase 4i: the GAR at 1024 px. K1 at top 1024 (9 levels) and 512 (8),
    tile 32, on the production mesh at B=16, held level by level to K2 and,
    on image 0, to the plain version (the levels of 32 px and up) and to
    the dense search (below), its values to ``_interp_from_win`` over those
    winners, and to its plain version on the training mesh at B=1, then
    timed beside its bound; K2 at 1024^2, tiles 8, 16 and 32 agreeing at
    B=16, equal to the plain version on image 0 and on the training mesh
    at B=1, timed beside its bound; the 1024 px GAR
    in bf16 (``each``, ``downsample`` fused and unfused) at the largest
    batch of HR_BATCHES that fits, timed, split, profiled, its fused and
    unfused pyramids equal; ``remat`` against no remat (f32, TF32 off): the
    same images and gradients, peak memory and time of each;
    ``cli.generate`` at its defaults; ``cli.train`` in bf16 with
    ``--profile_steps 2`` and each kind of step timed, and with ADA.
    Adds image 0 at 1024^2 and the training mesh at B=1 with their plain
    versions to ``binned_cases``. Returns K1's and K2's 1024 px
    measurements; fails loudly."""
    from PIL import Image

    from stylerenderer_tpu_torch.cli.generate import main as generate_main
    from stylerenderer_tpu_torch.cli.train import main as train_main
    from stylerenderer_tpu_torch.face3d import mesh_point_normal, random_apply_pose3D
    from stylerenderer_tpu_torch.models import GeneratorWithMap
    from stylerenderer_tpu_torch.ops.rasterize import (
        _interp_from_win, _triangle_table, rasterize_winners,
    )
    from stylerenderer_tpu_torch.ops.rasterize_multi import (
        rasterize_winners_multi, rasterize_winners_multi_ref,
    )
    from stylerenderer_tpu_torch.ops.rasterize_single import (
        build_bins, card_tile, rasterize_winners_single, rasterize_winners_single_ref,
    )
    from stylerenderer_tpu_torch.train import path_lengths_multi
    from stylerenderer_tpu_torch.utils.config import TrainConfig

    t_phase = time.perf_counter()
    g = torch.Generator().manual_seed(21)
    vert = random_apply_pose3D(g, face(face.random_input(BATCH, g)))
    norm = mesh_point_normal(vert, tri)
    synth_face, synth_tri = synth_mesh
    tv = random_apply_pose3D(g, synth_face(synth_face.random_input(1, g)))
    tn = mesh_point_normal(tv, synth_tri)

    # 1. the plain version (the dense search) on image 0 of the batch at each
    # size of 32 px and up: the 1024^2 image of K2 and K1's levels at both
    # tops are held to it below (all 16 images would take minutes)
    dense, dense_ms = {}, {}
    for k in range(HR_LEVELS):
        s = HR_TOP >> k
        if s >= HR_TILE:
            dense[s], dense_ms[s] = once_ms(torch, lambda: rasterize_winners_single_ref(
                vert[:1], tri, s, s))
    log(f"plain version (dense search), production mesh, image 0: "
        + ", ".join(f"{s} px {t:.1f} ms" for s, t in dense_ms.items()) + f" ({smi})")

    # 2. K1 at top 1024 and 512, tile 32, C=3: level by level against K2
    # at B=16 and the plain version on image 0 (levels of 32 px and up)
    # and the dense search at B=16 (below), then against the plain version
    # on the training mesh at B=1
    k1_hr = {}
    for top, n_levels in ((HR_TOP, HR_LEVELS), (HR_TOP // 2, HR_LEVELS - 1)):
        out = rasterize_winners_multi(vert, tri, top, n_levels, attrs=norm)
        tbl = _triangle_table(vert, norm, tri)
        witness = []
        for k, (val, win) in enumerate(out):
            s = top >> k
            if s >= HR_TILE:
                ref_w = rasterize_winners_single(vert, tri, s, s)
                compare_wins(win[:1], dense[s], f"K1 top {top}, level {s} px, image 0, "
                                                "against the plain version")
                by = f"K2 (tile {card_tile(s, s)}) and image 0 the plain version"
            else:
                ref_w, by = rasterize_winners(vert, tri, s, s), "dense"
            compare_wins(win, ref_w, f"K1 top {top}, level {s} px, against {by}")
            ref_v = _interp_from_win(vert, norm, tri, win, s, s, False, EPS, tbl=tbl)
            if not torch.equal(val, ref_v):
                raise AssertionError(f"K1 top {top}, level {s} px: values differ from "
                                     f"_interp_from_win by {float((val - ref_v).abs().max())}")
            witness.append(f"{s} px {by}")
            del ref_w, ref_v
        del out, tbl
        ref, plain_ms = once_ms(torch, lambda: rasterize_winners_multi_ref(
            tv, synth_tri, top, n_levels, attrs=tn, tile=HR_TILE))
        max_err["rasterize_multi"] = max(max_err["rasterize_multi"], compare_multi(
            rasterize_winners_multi(tv, synth_tri, top, n_levels, attrs=tn), ref, True,
            f"K1 top {top}, training mesh B=1"))
        if top == HR_TOP:
            train_ref = ref[0][1]  # the plain version's 1024^2 winners, for K2
        del ref
        m = k1_measure(torch, np, vert, tri, n_levels, norm, keys_of_bins, top=top, tile=HR_TILE)
        m["plain_ms"] = plain_ms
        k1_hr[top] = m
        log(f"check: K1 top {top}, {n_levels} levels, tile {HR_TILE}, C=3, production mesh "
            f"B={BATCH}: winners bit-equal level by level ({'; '.join(witness)}), values "
            f"bit-equal to _interp_from_win over them; on the training mesh at B=1 bit-equal to "
            f"the plain version ({plain_ms:.1f} ms once)")
        log(k1_report(f"K1 rasterize_multi at top {top}, {n_levels} levels, tile {HR_TILE}, "
                      f"B={BATCH}, C=3 ({smi})", m))

    # 3. K2 at 1024^2: at B=16 on the production mesh the tiles agree and
    # image 0 equals the plain version; on the training mesh at B=1 every
    # tile equals the plain version; timed beside its bound
    k2_hr = {t: k2_measure(torch, np, vert, tri, HR_TOP, HR_TOP, t, keys_of_bins)
             for t in (8, 16, 32)}
    outs = [rasterize_winners_single(vert, tri, HR_TOP, HR_TOP, tile=t) for t in (8, 16, 32)]
    for t, o in zip((8, 16, 32), outs):
        max_err["rasterize_single"] = max(max_err["rasterize_single"], compare_wins(
            o[:1], dense[HR_TOP], f"K2 {HR_TOP}^2 tile {t}, image 0, against the plain version"))
        if t != 8:
            compare_wins(o, outs[0], f"K2 {HR_TOP}^2 tile {t} against tile 8")
        max_err["rasterize_single"] = max(max_err["rasterize_single"], compare_wins(
            rasterize_winners_single(tv, synth_tri, HR_TOP, HR_TOP, tile=t), train_ref,
            f"K2 {HR_TOP}^2 tile {t}, training mesh B=1, against the plain version"))
    covered = float((outs[0] >= 0).float().mean())
    binned_cases.append((f"production mesh {HR_TOP}^2 image 0", vert[:1], tri, HR_TOP, HR_TOP,
                         dense[HR_TOP]))
    binned_cases.append((f"training mesh {HR_TOP}^2 B=1", tv, synth_tri, HR_TOP, HR_TOP,
                         train_ref))
    del outs, train_ref
    tile = card_tile(HR_TOP, HR_TOP)
    dat, _, starts = build_bins(vert, tri, HR_TOP, HR_TOP, False, EPS, tile)
    k2b_ms, k2_by, nbytes, ops, pairs, n_valid = k2_bound(torch, dat, starts, HR_TOP, HR_TOP)
    del dat, starts
    k2_hr[tile].update(bound_ms=k2b_ms, bound_by=k2_by, plain_ms_image0=dense_ms[HR_TOP])
    del dense
    log(f"check: K2 {HR_TOP}^2 at tiles 8, 16 and 32: B={BATCH} on the production mesh, the "
        f"tiles bit-equal and image 0 bit-equal to the plain version "
        f"({dense_ms[HR_TOP]:.1f} ms once for the image); B=1 on the training mesh, bit-equal "
        f"to the plain version")
    log(k2_report(f"K2 on the production mesh, {HR_TOP}^2, B={BATCH} ({smi})", k2_hr)
        + f"; bound at tile {tile} (the card path's) {k2b_ms:.4f} ms by "
        f"{k2_by} ({nbytes} bytes, {ops} f32 ops, {pairs} bbox pairs, {n_valid} valid "
        f"triangles); covered {covered:.3f}")

    # 4. the 1024 px GAR in bf16: each, downsample fused and unfused
    gen = GeneratorWithMap(HR_TOP, 512, 8, channel_multiplier=2, dtype=torch.bfloat16, seed=0,
                           device=dev).eval()
    modes = (("each", True), ("downsample", True), ("downsample", False))

    def inputs(b, n):
        res = []
        for _ in range(n):
            v = random_apply_pose3D(g, face(face.random_input(b, g)))
            res.append((torch.randn(b, 512, generator=g).to(dev),
                        (v, mesh_point_normal(v, tri), tri)))
        return res

    hr_batch = None
    for b in HR_BATCHES:
        try:
            with torch.no_grad():
                z, mesh = inputs(b, 1)[0]
                for mode, fused in modes:
                    gen.pyramid_mode, gen.fused_pyramid = mode, fused
                    gen([z], mesh)
                torch.cuda.synchronize()
        except torch.cuda.OutOfMemoryError:
            log(f"1024 px GAR: B={b} does not fit in the card's memory")
            torch.cuda.empty_cache()
            continue
        hr_batch = b
        break
    if hr_batch is None:
        raise AssertionError(f"1024 px GAR: none of the batches {HR_BATCHES} fits")
    for mode, fused in modes:
        gen.pyramid_mode, gen.fused_pyramid = mode, fused
        name = f"1024 {mode}{'' if fused else ' unfused'}"
        batches = inputs(hr_batch, HR_FORWARDS)
        with torch.no_grad():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            images, counts = run_path(name, lambda: [gen([z], m)[0] for z, m in batches])
            elapsed = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated()
            check_launches(counts, {"rasterize_multi": HR_FORWARDS if fused else 0,
                                    "rasterize_single": 0 if fused else HR_FORWARDS}, name)
            for img in images:
                if (tuple(img.shape) != (hr_batch, 3, HR_TOP, HR_TOP)
                        or not bool(torch.isfinite(img.float()).all())):
                    raise AssertionError(f"{name}: bad image {tuple(img.shape)}")
            std = float(images[-1].float().std())
            del images
            z, mesh = batches[-1]
            latent = gen.get_latent(z)[:, None, :].repeat(1, gen.n_latent, 1)
            maps = gen.normal_pyramid(mesh)
            pyr_ms = cuda_ms(torch, lambda: gen.normal_pyramid(mesh), 3)
            syn_ms = cuda_ms(torch, lambda: gen.synthesize(latent, maps), 3)
            fwd_ms = cuda_ms(torch, lambda: gen([z], mesh), 3)
            del maps
        log(f"{name}: GeneratorWithMap(1024, 512, 8, channel_multiplier=2) bf16, "
            f"B={hr_batch}, {HR_FORWARDS} forwards in {elapsed:.4f} s: "
            f"{hr_batch * HR_FORWARDS / elapsed:.2f} renders/s (host clock); launches {counts}; "
            f"peak memory {peak / 2 ** 30:.2f} GiB; split (CUDA events): normal pyramid "
            f"{pyr_ms:.3f} ms, synthesis {syn_ms:.3f} ms, whole forward {fwd_ms:.3f} ms; "
            f"image std {std:.4f} ({smi})")
        log(f"{name}, profiled:")
        profile_forwards(torch, gen, batches)
    # the fused pyramids bit-equal to the unfused ones
    z, mesh = inputs(hr_batch, 1)[0]
    with torch.no_grad():
        for mode in ("each", "downsample"):
            gen.pyramid_mode = mode
            gen.fused_pyramid = True
            fused_maps = gen.normal_pyramid(mesh)
            gen.fused_pyramid = False
            for k, (a, b) in enumerate(zip(fused_maps, gen.normal_pyramid(mesh))):
                if a.shape != b.shape or not torch.equal(a, b):
                    raise AssertionError(f"1024 {mode}: level {k}: fused and unfused pyramids "
                                         "differ")
            del fused_maps
    log(f"check: 1024 px normal pyramids (each: K1 fused against K1 winners with the gather "
        f"interpolation, rasterize_pyramid; downsample: K1 at one level against K2), fused "
        f"and unfused bit-equal at all {gen.log_size - 1} levels, B={hr_batch}")
    del gen
    torch.cuda.empty_cache()

    # 5. remat against no remat: f32, TF32 off and deterministic cuDNN, the
    # noise strengths at 0.1 and the noise drawn from one card generator
    # seed, an image loss at B=4 and a path-length double backward at B=2
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    try:
        rgen = GeneratorWithMap(HR_TOP, 512, 8, channel_multiplier=2, seed=0, device=dev)
        with torch.no_grad():
            for mod in rgen.modules():
                if type(mod).__name__ == "NoiseInjection":
                    mod.weight.fill_(0.1)
        params = list(rgen.parameters())
        z, mesh = inputs(REMAT_BATCH, 1)[0]
        pb = REMAT_BATCH // 2
        probe = torch.randn(pb, 3, HR_TOP, HR_TOP, generator=g).to(dev)
        with torch.no_grad():
            maps = [m[:pb] for m in rgen.normal_pyramid(mesh)]

        def image_and_grads():
            """-> (image, gradients of both terms, path length, and per
            term: host-clock ms to a sync, peak memory)."""
            rng = torch.Generator(dev).manual_seed(7)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            img = rgen([z], mesh, generator=rng)[0]
            grads = torch.autograd.grad(img.square().mean(), params, allow_unused=True,
                                        materialize_grads=True)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            peak_img = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            latent = rgen.get_latent(z[:pb])[:, None, :].repeat(1, rgen.n_latent, 1)
            pl = path_lengths_multi(
                lambda lat, *m: rgen.synthesize(lat, list(m), generator=rng), probe,
                (latent, *maps))
            pgrads = torch.autograd.grad(pl.mean(), params, allow_unused=True,
                                         materialize_grads=True)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            return (img.detach(), [a + b for a, b in zip(grads, pgrads)],
                    float(pl.detach().mean()), (t1 - t0) * 1e3, peak_img, (t2 - t1) * 1e3,
                    torch.cuda.max_memory_allocated())

        remat = {}
        for on in (False, True):
            rgen.remat = on
            image_and_grads()  # warm-up
            remat[on] = image_and_grads()
    finally:
        (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.deterministic) = flags
    (img0, g0, pl0, *cost0), (img1, g1, pl1, *cost1) = remat[False], remat[True]
    if not torch.equal(img1, img0):
        raise AssertionError(f"remat: images differ by {float((img1 - img0).abs().max())}")
    rel = 0.0
    for i, (a, b) in enumerate(zip(g1, g0)):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6, msg=f"remat: parameter {i}")
        rel = max(rel, float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30))
    if not cost1[1] < cost0[1]:
        raise AssertionError(f"remat: the image loss's peak memory {cost1[1]} is not below "
                             f"{cost0[1]}")

    def cost(c):
        return (f"image loss {c[0]:.1f} ms, peak {c[1] / 2 ** 30:.2f} GiB; path term "
                f"{c[2]:.1f} ms, peak {c[3] / 2 ** 30:.2f} GiB")

    log(f"remat: GeneratorWithMap(1024, 512, 8, channel_multiplier=2) f32 (TF32 off, "
        f"deterministic cuDNN), image loss at B={REMAT_BATCH} + path length at B={pb} (double "
        f"backward), noise from one card generator seed: images equal, path length "
        f"{pl0:.6f} / {pl1:.6f}, every gradient within rtol 1e-4 (largest difference "
        f"{rel:.3e} of its tensor's largest magnitude); without remat: {cost(cost0)}; with "
        f"remat: {cost(cost1)} (host clock to a sync; {smi})")
    del rgen, params, maps, probe, remat, g0, g1, img0, img1
    torch.cuda.empty_cache()

    # 6. cli.generate at its defaults (1024 px): the GAR, with truncation,
    # and the unconditioned Generator
    with tempfile.TemporaryDirectory() as tmp:
        for name, argv, n_k1 in (("cli generate 1024", ["--with_map"], 1),
                                 ("cli generate 1024 truncation",
                                  ["--with_map", "--truncation", "0.7"], 1),
                                 ("cli generate 1024 generator", [], 0)):
            out = os.path.join(tmp, name.replace(" ", "_"))
            t0 = time.perf_counter()
            paths, counts = run_path(name, lambda: generate_main(argv + ["--out", out]))
            check_launches(counts, {"rasterize_multi": n_k1, "rasterize_single": 0}, name)
            if len(paths) != 1 or Image.open(paths[0]).size != (HR_TOP, HR_TOP):
                raise AssertionError(f"{name}: wrote {paths}")
            log(f"cli: generate {' '.join(argv)} (its default --size {HR_TOP}): "
                f"{time.perf_counter() - t0:.1f} s, launches {counts}, PNG {HR_TOP} x {HR_TOP}")

    # 7. training in bf16 with the profiler window, then each kind of step;
    # training with ADA
    out = os.path.join(work, "train_bf16")
    t0 = time.perf_counter()
    state, counts = run_path("train bf16", lambda: train_main([
        shard, "--iter", str(TRAIN_STEPS), "--batch", str(BATCH), "--d_reg_every", "16",
        "--g_reg_every", "4", "--log_every", "1", "--sample_every", str(TRAIN_STEPS),
        "--ckpt_every", str(TRAIN_STEPS), "--seed", "0", "--compute_dtype", "bfloat16",
        "--profile_steps", "2", "--out_dir", out]))
    train_s = time.perf_counter() - t0
    kinds = ["R1 + path" if i % 16 == 0 else "path" if i % 4 == 0 else "plain"
             for i in range(TRAIN_STEPS)]
    check_launches(counts, {"rasterize_multi": sum(2 if k == "plain" else 3 for k in kinds) + 1,
                            "rasterize_single": 0}, "train bf16")
    rows = metrics_rows(out, TRAIN_STEPS, "train bf16")
    if state.g.dtype != torch.bfloat16 or state.d.dtype != torch.bfloat16:
        raise AssertionError("train bf16: the models do not compute in bf16")
    trace = os.path.join(out, "profile", "trace.json")
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    # the host's ranges (the card's timeline repeats them as gpu_user_annotation)
    steps_traced = sum(1 for e in events
                       if e.get("name") == "train.step" and e.get("cat") == "user_annotation")
    k1_events = sum(1 for e in events if "rasterize_multi_kernel" in e.get("name", ""))
    if steps_traced != 2 or not k1_events:
        raise AssertionError(f"train bf16: the trace of steps 1-2 lacks a step or K1 "
                             f"({k1_events} K1 events)")
    log(f"train bf16: cli.train --compute_dtype bfloat16 --profile_steps 2, B={BATCH}, "
        f"{TRAIN_STEPS} steps in {train_s:.1f} s; launches {counts}; the trace "
        f"({os.path.getsize(trace) / 2 ** 20:.1f} MiB, {len(events)} events) holds steps 1 "
        f"and 2 and {k1_events} K1 kernel events (rasterize_multi_kernel)")
    for r, kind in zip(rows, kinds):
        log(f"  step {r['step']} ({kind}): {r['step_ms']:.1f} ms host clock; d {r['d']:.4f}, "
            f"g {r['g']:.4f}, r1 {r['r1']:.4f}, path {r['path']:.4f}")
    cfg = TrainConfig(batch=BATCH, d_reg_every=16, g_reg_every=4, compute_dtype="bfloat16")
    real = real_batch(torch, np, shard, dev)
    bf16_ms = time_step_kinds(torch, state, cfg, real, *synth_mesh, run_path, "train bf16 step")
    cycle = (bf16_ms["R1 + path"] + 3 * bf16_ms["path"] + 12 * bf16_ms["plain"]) / 16
    log(f"train bf16: {cycle:.1f} ms per step over the 16-step cycle, "
        f"{BATCH * 1e3 / cycle:.1f} images/s ({smi})")
    del state

    out = os.path.join(work, "train_ada")
    t0 = time.perf_counter()
    _, counts = run_path("train ada", lambda: train_main([
        shard, "--iter", str(ADA_STEPS), "--batch", str(BATCH), "--augment", *ADA_ARGS,
        "--log_every", "1", "--sample_every", str(10 * ADA_STEPS), "--seed", "0",
        "--out_dir", out]))
    ada_s = time.perf_counter() - t0
    kinds = ["R1 + path" if i % 16 == 0 else "path" if i % 4 == 0 else "plain"
             for i in range(ADA_STEPS)]
    check_launches(counts, {"rasterize_multi": sum(2 if k == "plain" else 3 for k in kinds),
                            "rasterize_single": 0}, "train ada")
    rows = metrics_rows(out, ADA_STEPS, "train ada")
    if not max(r["ada_p"] for r in rows) > 0:
        raise AssertionError(f"train ada: p stayed 0 ({rows})")
    log(f"train ada: cli.train --augment {' '.join(ADA_ARGS)}, f32, B={BATCH}, {ADA_STEPS} "
        f"steps in {ada_s:.1f} s; launches {counts}; p by step: "
        + ", ".join(f"{r['ada_p']:.5f}" for r in rows)
        + "; step ms " + ", ".join(f"{r['step_ms']:.1f}" for r in rows))
    log(f"phase 4i: {time.perf_counter() - t_phase:.1f} s; {smi}")
    return k1_hr[HR_TOP], k2_hr[tile]


def median_ms(torch, fn, iters: int) -> float:
    """Median device time of ``fn`` in ms over ``iters`` calls after one
    warm-up, each call between its own CUDA events (host work inside the
    call counts)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[iters // 2]


def epilogue_phase(torch, dev, smi, face, tri, run_path):
    """Phase 3c: the styled conv's epilogue kernel (``ops/fused_act.py``).
    At B=16, bit for bit, at every (C, H) of the 1024 px synthesis with and
    without FiLM (a view of a channels-last map) and ``[B,1,H,W]`` float32
    noise, at the ResBlocks' channels-last maps and at the mapping's
    ``[16, 512]``: float32 the plain chain's bits, bfloat16 the float32
    chain's rounded once (each call one launch, the counts at 0 before);
    at 1024^2, B=2, bfloat16 within one rounding of the float64 oracle. Its
    launch shapes; its time alone at 1024^2 (B=16, C=32) and 512^2 (C=64)
    in bf16 beside its byte bound and the plain chain's time. One no-grad
    GAR forward at 1024 and 256 px with the counts at 0 (43 and 35
    launches), its image against the plain path's within the render cell's
    ``image_rel_l2`` limit, and the synthesis timed on both paths. -> the
    kernel's numbers for the kernels line."""
    import ctypes

    import torch_fused_act as tfa

    from stylerenderer_tpu_torch.face3d import mesh_point_normal, random_apply_pose3D
    from stylerenderer_tpu_torch.models import GeneratorWithMap, make_noise
    from stylerenderer_tpu_torch.ops import _build, fused_act

    def inputs(b, c, s, dtype, film=True, film_last=True):
        """The GAR's epilogue arguments at one level: FiLM a view of the
        ResBlock's channels-last 4-channel map, per-sample float32 noise."""
        g = torch.Generator(dev).manual_seed(c * s)
        a = {"y": torch.randn(b, c, s, s, generator=g, device=dev).to(dtype),
             "bias": 0.1 * torch.randn(c, generator=g, device=dev),
             "demod": 0.5 + torch.rand(b, c, generator=g, device=dev),
             "noise": torch.randn(b, 1, s, s, generator=g, device=dev),
             "noise_weight": torch.full((1,), 0.1, device=dev)}
        if film:
            maps = torch.randn(b, 4, s, s, generator=g, device=dev).to(dtype)
            if film_last:
                maps = maps.contiguous(memory_format=torch.channels_last)
            a["film"] = maps[:, :2]
        return a

    def nbytes(a):
        y, film = a["y"], a["film"]
        return (2 * y.numel() * y.element_size() + 2 * film[:, 0].numel() * film.element_size()
                + a["noise"].numel() * a["noise"].element_size())

    max_err = 0.0

    def check(out, a, what):
        """``out`` against the plain chain (float32) or the float32 chain
        rounded once (bfloat16), bit for bit."""
        nonlocal max_err
        f32 = out.dtype == torch.float32
        ref = fused_act.fused_bias_act_ref(**a) if f32 else tfa.rounded_once(**a)
        if not torch.equal(tfa.bits(out), tfa.bits(ref)):
            raise AssertionError(f"epilogue {what}: not the "
                                 f"{'plain chain' if f32 else 'f32 chain rounded once'}'s bits")
        max_err = max(max_err, float((out.float() - ref.float()).abs().max()))

    def bit_checks():
        n = 0
        for dtype in (torch.float32, torch.bfloat16):
            for c, s in tfa.SYNTH_1024:
                for film in (True, False):
                    a = inputs(16, c, s, dtype, film=film)
                    check(fused_act.fused_bias_act(**a), a, f"{dtype} C={c} H={s} film={film}")
                    n += 1
                    del a
            g = torch.Generator(dev).manual_seed(5)
            for c, s in tfa.RESBLOCK:
                a = {"y": torch.randn(16, c, s, s, generator=g, device=dev).to(dtype).contiguous(
                         memory_format=torch.channels_last),
                     "bias": 0.1 * torch.randn(c, generator=g, device=dev)}
                out = fused_act.fused_leaky_relu(a["y"], a["bias"])
                if not out.is_contiguous(memory_format=torch.channels_last):
                    raise AssertionError(f"epilogue {dtype} ResBlock C={c} H={s}: not "
                                         "channels-last")
                check(out, a, f"{dtype} channels-last ResBlock map C={c} H={s}")
                n += 1
            a = {"y": torch.randn(16, 512, generator=g, device=dev).to(dtype),
                 "bias": 0.1 * torch.randn(512, generator=g, device=dev)}
            check(fused_act.fused_leaky_relu(a["y"], a["bias"], dim=-1), a,
                  f"{dtype} mapping [16, 512]")
            n += 1
        return n

    for name, (b, c, s) in (("1024^2", (16, 32, 1024)), ("512^2", (16, 64, 512)),
                            ("4^2", (16, 512, 4))):
        shape = (ctypes.c_int * 9)()
        rc = _build.library("fused_act").sr_fused_bias_act_shape(
            b, c, s, s, 1, 1, ctypes.cast(shape, ctypes.c_void_p))
        if rc != 0:
            raise AssertionError(f"sr_fused_bias_act_shape: {rc}")
        v, tx, ty, tiles, chunks, chunk, rows, regs, local = shape
        log(f"epilogue launch shape at {name}, B={b}, C={c}, bf16: V={v}, block {tx} x {ty}, "
            f"{tiles} pixel tiles x {b} samples x {chunks} channel chunks of {chunk}, rows "
            f"{rows}; {regs} registers, {local} B local")
    res = {}
    with torch.no_grad():
        n, counts = run_path("epilogue checks", bit_checks)
        if counts != {"rasterize_multi": 0, "rasterize_single": 0, "fused_bias_act": n,
                      "upfirdn2d": 0}:
            raise AssertionError(f"epilogue checks: launches {counts}, expected {n} of it")
        log(f"check: epilogue at B=16, every (C, H) of the 1024 px synthesis with and without "
            f"FiLM (channels-last map) and [B,1,H,W] noise, the ResBlocks' channels-last maps "
            f"and the mapping's [16, 512], f32 and bf16: f32 bit-equal to the plain chain, bf16 "
            f"bit-equal to the f32 chain rounded once; {n} launches")
        a = inputs(2, 32, 1024, torch.bfloat16)
        worst = tfa.max_gap(fused_act.fused_bias_act(**a), *tfa.oracle(**a))
        if worst > 1.0:
            raise AssertionError(f"epilogue bf16: {worst} roundings off the float64 oracle")
        del a
        log(f"check: epilogue at 1024^2, B=2, C=32, bf16, FiLM and noise: {worst:.3f} of one "
            f"rounding off the float64 oracle at worst")
        for name, (b, c, s) in (("1024^2", (16, 32, 1024)), ("512^2", (16, 64, 512))):
            for last in (True, False):
                a = inputs(b, c, s, torch.bfloat16, film_last=last)
                ms = cuda_ms(torch, lambda: fused_act.fused_bias_act(**a), 20)
                plain_ms = cuda_ms(torch, lambda: fused_act.fused_bias_act_ref(**a), 5)
                nb = nbytes(a)
                bound_ms = 1e3 * nb / HBM_BYTES_PER_S
                log(f"epilogue kernel at {name}, B={b}, C={c}, bf16, FiLM from a "
                    f"{'channels-last' if last else 'contiguous'} map, [B,1,H,W] f32 noise: "
                    f"{ms:.4f} ms (CUDA events, 20 calls), bound {bound_ms:.4f} ms by bytes "
                    f"({nb} bytes at 3.35 TB/s): {100 * bound_ms / ms:.1f}% of it; plain chain "
                    f"{plain_ms:.4f} ms")
                if last:  # the GAR's form
                    key = "" if s == 1024 else f"_{s}"
                    res.update({f"ms{key}": ms, f"plain_ms{key}": plain_ms,
                                f"bound_ms{key}": bound_ms})
                del a

    # one forward a size with the counts at 0, and the synthesis on each path
    g = torch.Generator().manual_seed(9)
    for size, batch in ((1024, 16), (256, 16)):
        gen = GeneratorWithMap(size, 512, 8, dtype=torch.bfloat16, seed=0, device=dev).eval()
        vert = random_apply_pose3D(g, face(face.random_input(batch, g)))
        mesh = (vert, mesh_point_normal(vert, tri), tri)
        z = torch.randn(batch, 512, generator=g).to(dev)
        noise = [n.to(dev) for n in make_noise(size, batch, g)]
        with torch.no_grad():
            gen([z], mesh, noise=noise)
            torch.cuda.synchronize()
            img, counts = run_path(f"epilogue forward {size}",
                                   lambda: gen([z], mesh, noise=noise)[0].float())
            want = {1024: 17 + 18 + 8, 256: 13 + 14 + 8}[size]
            if counts["fused_bias_act"] != want:
                raise AssertionError(f"{size} px forward: launches {counts}, not {want} of the "
                                     "epilogue")
            if counts["upfirdn2d"] != {1024: 16, 256: 12}[size]:
                raise AssertionError(f"{size} px forward: launches {counts}, not 2 of "
                                     "upfirdn2d a level from 8 px")
            latent = gen.get_latent(z)[:, None, :].repeat(1, gen.n_latent, 1)
            maps = gen.normal_pyramid(mesh)
            syn_ms = cuda_ms(torch, lambda: gen.synthesize(latent, maps, noise), 5)
            real = fused_act.takes_kernel
            fused_act.takes_kernel = lambda *a: False
            try:
                before = fused_act.fused_bias_act.launches
                plain = gen([z], mesh, noise=noise)[0].float()
                plain_ms = cuda_ms(torch, lambda: gen.synthesize(latent, maps, noise), 5)
                torch.cuda.synchronize()
                if fused_act.fused_bias_act.launches != before:
                    raise AssertionError(f"{size} px plain path launched the epilogue")
            finally:
                fused_act.takes_kernel = real
        rel = float((img - plain).norm() / plain.norm())
        if not rel < 0.07:
            raise AssertionError(f"{size} px forward: image {rel} relative L2 from the plain "
                                 "path's, over 0.07")
        log(f"epilogue: one no-grad GeneratorWithMap({size}, 512, 8) bf16 forward, B={batch}: "
            f"launches {counts} (the epilogue's: styled convs, ResBlock activations, mapping "
            f"layers); image {rel:.6f} relative L2 from the plain path's; synthesis "
            f"{syn_ms:.3f} ms with the kernel, {plain_ms:.3f} ms on the plain path (CUDA "
            f"events, 5 calls; {smi})")
        del gen, maps, latent, img, plain
    res["max_abs_err"] = max_err
    return res


def upfirdn2d_phase(torch, dev, smi, run_path):
    """Phase 3d: upfirdn2d's kernel (``ops/upfirdn2d.py``, ``csrc/upfirdn2d.cu``)
    at the render cells' calls (``tests/torch_upfirdn2d.py``): the 1024 px
    synthesis's 16 at B=16 in bf16 and the 256 px synthesis's 12 at B=64 in
    f32. Each call against the plain version (f32 within 1e-5; bf16 the
    kernel's f32 sums rounded once, within one rounding of the plain
    version's), one launch; its time alone (its launches replayed from a
    CUDA graph) beside its byte bound (input read once, output written
    once, at 3.35 TB/s), the plain version's time and ATen's depthwise
    ``F.conv2d`` on the stuffed, padded input (``library_ms``, CUDA events);
    the sums over a forward and the forward's launches back to back (one
    graph); the launch shape of each level's blur. Then every form the
    backwards run (``check_backward_forms``). -> the kernel's numbers for
    the kernels line (the 1024 px forward's; ``_256`` the 256 px one's)."""
    import ctypes

    import torch.nn.functional as F
    import torch_upfirdn2d as tu

    from stylerenderer_tpu_torch.ops import _build
    from stylerenderer_tpu_torch.ops.upfirdn2d import make_kernel, upfirdn2d_cuda, upfirdn2d_plain

    lib = _build.library("upfirdn2d")
    codes = {torch.float32: 0, torch.bfloat16: 1}
    res, max_err = {}, 0.0
    g = torch.Generator(dev).manual_seed(20)
    for cell, key in (("gar1024.render.b16", ""), ("gar256.render.b64", "_256")):
        calls, dtype = tu.CELLS[cell]
        dtype = getattr(torch, dtype)
        eb = torch.tensor([], dtype=dtype).element_size()
        args, tot = [], {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}

        def check_and_time():
            nonlocal max_err
            for call in calls:
                (b, c, h, w), up, down, pad = call
                x = torch.randn(b, c, h, w, generator=g, device=dev).to(dtype)
                k = (make_kernel(list(tu.KERNEL)) * (4 if up == 2 else 1)).to(dev)
                a = (x, k, up, down, pad)
                args.append(a)
                out, ref = upfirdn2d_cuda(*a), upfirdn2d_plain(*a)
                if dtype == torch.bfloat16:
                    once = upfirdn2d_cuda(x.float(), k, up, down, pad).to(dtype)
                    if not torch.equal(out.view(torch.int16), once.view(torch.int16)):
                        raise AssertionError(f"upfirdn2d {call}: not its f32 sums rounded once")
                    tol = 2 ** -7 * (1 + ref.float().abs())
                else:
                    tol = torch.full_like(ref, 1e-5)
                err = (out.float() - ref.float()).abs()
                if not bool((err <= tol).all()):
                    raise AssertionError(f"upfirdn2d {call}: {float(err.max())} off the plain "
                                         "version")
                max_err = max(max_err, float(err.max()))
                reps = 1 if x.numel() * eb > 1e8 else 10
                ms = graph_ms(torch, lambda: [upfirdn2d_cuda(*a) for _ in range(reps)], 10) / reps
                plain_ms = cuda_ms(torch, lambda: upfirdn2d_plain(*a), 5)
                xp = x
                if up > 1:
                    xp = F.pad(x.reshape(b, c, h, 1, w, 1), [0, up - 1, 0, 0, 0, up - 1]).reshape(
                        b, c, h * up, w * up)
                xp = F.pad(xp, list(pad))
                wgt = torch.flip(k, (0, 1)).to(dtype)[None, None].expand(c, 1, 4, 4)
                lib_ms = cuda_ms(torch, lambda: F.conv2d(xp, wgt, stride=down, groups=c), 5)
                bound_ms = 1e3 * tu.call_bytes(call, eb) / HBM_BYTES_PER_S
                shape = (ctypes.c_int * 23)()
                _, _, oh, ow = tu.out_shape(call)
                rc = lib.sr_upfirdn2d_shape(b, c, h, w, oh, ow, up, up, down, down, pad[0],
                                            pad[2], 4, 4, codes[dtype], 1,
                                            ctypes.cast(shape, ctypes.c_void_p))
                if rc != 0:
                    raise AssertionError(f"sr_upfirdn2d_shape: {rc}")
                log(f"upfirdn2d {cell} {tuple(x.shape)} up {up} down {down} pad {pad}: "
                    f"{ms:.4f} ms (graph replay), bound {bound_ms:.4f} ms by bytes "
                    f"({tu.call_bytes(call, eb)} bytes): {100 * bound_ms / ms:.1f}% of it; plain "
                    f"{plain_ms:.4f} ms, ATen depthwise F.conv2d {lib_ms:.4f} ms; shape: tile "
                    f"{shape[3] * shape[1]} x {shape[4] * shape[2]} of {shape[5]} planes, "
                    f"{shape[11]} items on {shape[20]} blocks, {shape[19]} B shared, "
                    f"{shape[21]} registers, {shape[22]} B local")
                for name, v in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", lib_ms),
                                ("bound_ms", bound_ms)):
                    tot[name] += v
                del out, ref, xp, wgt

        with torch.no_grad():
            _, counts = run_path(f"upfirdn2d {cell}", check_and_time)
            forward_ms = graph_ms(torch, lambda: [upfirdn2d_cuda(*a) for a in args], 10)
        want = len(calls) * (3 if dtype == torch.bfloat16 else 2)
        if counts["upfirdn2d"] < want:
            raise AssertionError(f"upfirdn2d {cell}: launches {counts}")
        log(f"upfirdn2d {cell}: {len(calls)} calls of a forward, summed: kernel "
            f"{tot['ms']:.4f} ms alone, {forward_ms:.4f} ms back to back (one graph), bound "
            f"{tot['bound_ms']:.4f} ms by bytes: {100 * tot['bound_ms'] / forward_ms:.1f}% of it "
            f"back to back, {100 * tot['bound_ms'] / tot['ms']:.1f}% alone; plain version "
            f"{tot['plain_ms']:.4f} ms, ATen depthwise F.conv2d {tot['library_ms']:.4f} ms "
            f"({smi})")
        res.update({f"{k}{key}": v for k, v in tot.items()})
        res[f"forward_ms{key}"] = forward_ms
        del args

    def check_backward_forms():
        """The forms only backwards and second orders run: every call of the
        inversion and training cells (the adjoints of the down-2 form and
        of Upsample, their negative pads) in f32, and the odd sizes and
        mixed-sign pads of ``tu.EXTRA_CALLS`` in f32, bf16 and f64, against
        the plain version: f32 within 1e-5, f64 1e-12, bf16 the kernel's
        f32 sums rounded once. -> (calls, the largest f32 error)."""
        calls = [(c, torch.float32) for c in dict.fromkeys(
            tu.CELLS["gar256.invert.b32"][0] + tu.CELLS["gar256gan.train.b16"][0])]
        calls += [(c, dt) for c in tu.EXTRA_CALLS
                  for dt in (torch.float32, torch.bfloat16, torch.float64)]
        worst = 0.0
        for call, dtype in calls:
            (b, c, h, w), up, down, pad = call
            x = torch.randn(b, c, h, w, generator=g, device=dev).to(dtype)
            k = (make_kernel(list(tu.KERNEL)) * (4 if up == 2 else 1)).to(dev)
            out, ref = upfirdn2d_cuda(x, k, up, down, pad), upfirdn2d_plain(x, k, up, down, pad)
            if dtype == torch.bfloat16:
                once = upfirdn2d_cuda(x.float(), k, up, down, pad).to(dtype)
                if not torch.equal(out.view(torch.int16), once.view(torch.int16)):
                    raise AssertionError(f"upfirdn2d {call}: not its f32 sums rounded once")
                continue
            err = float((out - ref).abs().max())
            if not err <= (1e-12 if dtype == torch.float64 else 1e-5):
                raise AssertionError(f"upfirdn2d {call} {dtype}: {err} off the plain version")
            if dtype == torch.float32:
                worst = max(worst, err)
            del x, out, ref
        return len(calls), worst

    with torch.no_grad():
        (n_calls, worst), counts = run_path("upfirdn2d backward forms", check_backward_forms)
    if counts["upfirdn2d"] != n_calls + len(tu.EXTRA_CALLS):
        raise AssertionError(f"upfirdn2d backward forms: launches {counts} for {n_calls} calls")
    log(f"upfirdn2d: the inversion's and training's {n_calls - 3 * len(tu.EXTRA_CALLS)} "
        f"distinct calls (forwards, adjoints) in f32 within {worst:.3g} of the plain version; "
        f"{len(tu.EXTRA_CALLS)} odd, cropping calls in f32, bf16 (its f32 sums rounded once), "
        f"f64 within 1e-12; launches {counts['upfirdn2d']}")
    res["max_abs_err"] = max(max_err, worst)
    return res


def binned_phase(torch, smi, cases, run_path):
    """Phase 4j: the binned search (``ops/rasterize_binned.py``, the JAX
    package's XLA scatter search as plain PyTorch, no kernel) on CUDA
    tensors, on each case of ``cases`` (the plain version's winners, which
    earlier phases computed). Where its overflow count is within
    ``big_cap`` it must be bit-equal to the plain version and to K2, and
    it is timed beside K2's wrapper on the same input (CUDA events, median
    of BINNED_ITERS); where it is not (the 9,024-triangle training mesh at
    1024^2 has more than 512 triangles wider than 32 px), the search is
    not exact, as in JAX, and only the count is reported. No kernel is
    launched. Then ``"auto"`` on a CUDA tensor launches K2 once. Fails
    loudly."""
    from stylerenderer_tpu_torch.ops.rasterize import _dispatch_winners
    from stylerenderer_tpu_torch.ops.rasterize_binned import rasterize_winners_binned
    from stylerenderer_tpu_torch.ops.rasterize_single import rasterize_winners_single

    t_phase = time.perf_counter()
    exact = 0
    for name, vert, tri, h, w, ref in cases:
        (win, n_big), counts = run_path(f"binned {name}", lambda: rasterize_winners_binned(
            vert, tri, h, w, return_overflow=True))
        if raster(counts) != {"rasterize_multi": 0, "rasterize_single": 0}:
            raise AssertionError(f"binned {name}: launched {counts}")
        if int(n_big.max()) > BIG_CAP:
            differ = float((win != ref).float().mean())
            log(f"binned search, {name}: {n_big.tolist()} triangles wider than 32 px, over "
                f"big_cap {BIG_CAP}: not exact there (as in JAX), {differ:.5f} of the pixels "
                f"differ from the plain version")
            continue
        compare_wins(win, ref, f"binned {name} against the plain version")
        k2 = rasterize_winners_single(vert, tri, h, w)
        compare_wins(win, k2, f"binned {name} against K2")
        exact += 1
        b_ms = median_ms(torch, lambda: rasterize_winners_binned(vert, tri, h, w), BINNED_ITERS)
        k_ms = median_ms(torch, lambda: rasterize_winners_single(vert, tri, h, w), BINNED_ITERS)
        log(f"binned search, {name}: bit-equal to the plain version and to K2; triangles "
            f"wider than 32 px {n_big.tolist()} of big_cap {BIG_CAP}; {b_ms:.3f} ms against "
            f"K2's wrapper (card binning and kernel) {k_ms:.4f} ms, median of {BINNED_ITERS} "
            f"({b_ms / k_ms:.0f}x; {smi})")
        del win, k2
    if exact < 3:
        raise AssertionError(f"the binned search was exact on {exact} cases, not 3")
    name, vert, tri, h, w, _ = cases[0]
    _, counts = run_path("binned auto cuda", lambda: _dispatch_winners(
        vert, tri, h, w, False, EPS, "auto"))
    if raster(counts) != {"rasterize_multi": 0, "rasterize_single": 1}:
        raise AssertionError(f"'auto' on a CUDA tensor at {h}x{w} launched {counts}")
    log(f"check: 'auto' on a CUDA tensor ({name}) launches K2 once, never the binned search")
    log(f"phase 4j: {time.perf_counter() - t_phase:.1f} s; {smi}")


def scripts_phase(torch, smi, work, run_path):
    """Phase 4k: the six demonstration scripts (``stylerenderer_tpu_torch/
    scripts/``) at cut sizes, each through its ``main`` with the launch
    counts reset around it, writing under ``work``; every number each
    returns must be finite, and every script that renders the GAR launches
    K1 (and K2 where it renders a synth dataset). Fails loudly."""
    from stylerenderer_tpu_torch.scripts import (
        parity_eval, recon_demo, recon_demo256, train_demo, train_demo256, train_demo256_ada,
    )
    from stylerenderer_tpu_torch.scripts._common import all_finite

    t_phase = time.perf_counter()
    root = os.path.join(work, "demos")

    def d(name):
        return os.path.join(root, name)

    mains = {"train_demo": train_demo.main, "train_demo256": train_demo256.main,
             "train_demo256_ada": train_demo256_ada.main, "recon_demo": recon_demo.main,
             "recon_demo256": recon_demo256.main, "parity_eval": parity_eval.main}
    argv = {
        "train_demo": ["--steps", "4", "--batch", "32", "--n_data", "256", "--n_fid", "256",
                       "--ckpt_every", "4", "--log_every", "1", "--out", d("train_demo")],
        "train_demo256": ["--steps", "3", "--batch", "16", "--n_data", "64", "--ckpt_every",
                          "3", "--log_every", "1", "--out", d("train_demo256")],
        "train_demo256_ada": ["--steps", "3", "--batch", "16", "--base", d("train_demo256"),
                              "--ada_every", "1", "--log_every", "1", "--skip_fid",
                              "--out", d("train_demo256_ada")],
        "recon_demo": ["--faces", "4", "--batch", "4", "--iters", "10", "--ckpt",
                       os.path.join(d("train_demo"), "checkpoint"), "--out", d("recon_demo")],
        "recon_demo256": ["--faces", "4", "--batch", "4", "--reg_steps", "20", "--reg_batch",
                          "8", "--iters_short", "10", "--iters_full", "20", "--ckpt",
                          os.path.join(d("train_demo256"), "checkpoint"),
                          "--out", d("recon_demo256")],
        "parity_eval": ["--dry_run", "--with_map", "--out", d("parity_eval")],
    }
    # scripts that render a synth dataset with the GAR's writer (K2 at 64 and 256 px)
    renders_data = ("train_demo", "train_demo256", "parity_eval")
    secs = {}
    for name in SCRIPTS:
        t0 = time.perf_counter()
        summary, counts = run_path(f"script {name}", lambda: mains[name](argv[name]))
        secs[name] = time.perf_counter() - t0
        if not all_finite(summary):
            raise AssertionError(f"script {name}: a number is not finite: {summary}")
        if counts["rasterize_multi"] == 0 or (name in renders_data
                                              and counts["rasterize_single"] == 0):
            raise AssertionError(f"script {name}: launches {counts}")
        if name.startswith("recon"):
            rows = {k: v for k, v in summary.items() if isinstance(v, dict) and "s_per_face" in v}
            rows = rows or {"fit": summary}
            key = "; ".join(
                f"{cfg}: mse {r['pixel_mse']['mean']:.5f}, psnr {r['psnr']['mean']:.2f} dB, lmk "
                f"{r['lmk_err_px']['mean']:.3f} px, vertex rmse {r['vertex_rmse']['mean']:.5f}, "
                f"{r['s_per_face']['mean']:.3f} s/face" for cfg, r in rows.items())
            if "regressor" in summary:
                key += (f"; regressor loss {summary['regressor']['first_loss']:.4f} -> "
                        f"{summary['regressor']['final_loss']:.4f} in "
                        f"{summary['regressor']['seconds']:.1f} s")
        elif name == "parity_eval":
            audits = ("audit_inception", "audit_vgg", "audit_lpips_lin")
            if not all(summary[k]["ok"] for k in audits):
                raise AssertionError(f"parity_eval: an audit failed: {summary}")
            key = (f"audits ok ({', '.join(audits)}), fid {summary['fid']['value']:.3f}, ppl "
                   f"{summary['ppl']['value']:.3f}, lpips pairs "
                   f"{summary['lpips_fixed_pairs']['mean']:.4f}")
        else:
            key = ", ".join(f"{k} {summary[k]}" for k in ("imgs_per_sec", "fid_trend",
                                                          "ada_p_last", "ada_p_max", "r_t_last",
                                                          "resumed_from_step")
                            if k in summary)
        log(f"script {name}: {secs[name]:.1f} s, launches {counts}; {key}")
    each = ", ".join(f"{k} {v:.1f} s" for k, v in secs.items())
    log(f"phase 4k: {time.perf_counter() - t_phase:.1f} s ({each}); {smi}")


@contextlib.contextmanager
def deterministic(torch):
    """PyTorch's deterministic algorithms (``index_add``, cuDNN, cuBLAS)
    inside the block; the previous settings after it."""
    saved = (torch.are_deterministic_algorithms_enabled(), torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark, os.environ.get("CUBLAS_WORKSPACE_CONFIG"))
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(saved[0])
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved[1:3]
        if saved[3] is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG")
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = saved[3]


def checkpoint_diffs(a: str, b: str) -> list:
    """The entries of two ``cli.train`` checkpoint files that are not equal
    bit for bit (tensors by ``torch.equal``, the rest by ``==``)."""
    import torch

    def flat(x, key=""):
        if isinstance(x, dict):
            for k, v in x.items():
                yield from flat(v, f"{key}/{k}")
        elif isinstance(x, (list, tuple)):
            for i, v in enumerate(x):
                yield from flat(v, f"{key}/{i}")
        else:
            yield key, x

    ca, cb = (dict(flat(torch.load(f, map_location="cpu", weights_only=True))) for f in (a, b))
    if ca.keys() != cb.keys():
        return sorted(ca.keys() ^ cb.keys())
    return [k for k in ca if not (torch.equal(ca[k], cb[k]) if isinstance(ca[k], torch.Tensor)
                                  else ca[k] == cb[k])]


def parallel_phase(torch, np, dev, smi, shard, work, run_path, path_launches, check_k1,
                   synth_mesh):
    """Phase 4l: data-parallel training (``parallel/mesh.py``) on the one
    card. (a) ``cli.train.main`` in this process at world 1 under NCCL
    (the launcher's variables set by hand), TRAIN_STEPS steps at full width,
    B=16, on ``shard``, held bit for bit to the same run without a group,
    both with deterministic algorithms: every logged metric and the
    checkpoint; (b) the real launcher, ``torch.distributed.run
    --standalone --nproc_per_node 1``, exits 0 with (a)'s checkpoint up to
    the card's run-to-run spread (it runs PyTorch's defaults); (c) two
    spawned ranks on the card through gloo (NCCL refuses two ranks on one
    device), one step at step 0 with TF32 off at local batch 8, against
    world 1 at 16 in this process, each update landing on rank 0's
    parameters, to 1e-4, each rank's K1 launches reported back, K1 held
    bit for bit to its plain version at the local batch; (d) each kind of
    step's ms at world 1
    with and without the group, in turns, and the collectives' ms in a
    step of each kind. Fails loudly on any check."""
    from torch_parallel import (
        Ranks, free_port, landed_step, make_state, step_inputs, timed_collectives,
    )

    from stylerenderer_tpu_torch.cli.train import main as train_main
    from stylerenderer_tpu_torch.parallel import make_mesh
    from stylerenderer_tpu_torch.train import init_train_state, sample_draws, train_step
    from stylerenderer_tpu_torch.train.step import posed_mesh
    from stylerenderer_tpu_torch.utils.config import TrainConfig

    t_phase = time.perf_counter()
    synth_face, synth_tri = synth_mesh
    argv = [shard, "--iter", str(TRAIN_STEPS), "--batch", str(BATCH), "--d_reg_every", "16",
            "--g_reg_every", "4", "--log_every", "1", "--sample_every", str(TRAIN_STEPS),
            "--ckpt_every", str(TRAIN_STEPS), "--seed", "0"]
    out = {k: os.path.join(work, f"parallel_{k}") for k in ("none", "nccl", "launcher")}
    ckpt = {k: os.path.join(v, "checkpoint", "%06d.pt" % TRAIN_STEPS) for k, v in out.items()}
    launcher_vars = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
    kinds = ["R1 + path" if i % 16 == 0 else "path" if i % 4 == 0 else "plain"
             for i in range(TRAIN_STEPS)]
    want = {"rasterize_multi": sum(3 if k != "plain" else 2 for k in kinds) + 1,
            "rasterize_single": 0}

    # ---- (a) world 1 under NCCL against no group, through the CLI, with
    # deterministic algorithms: by default two runs without a group already
    # differ (index_add's atomics in mesh_point_normal, cuDNN's algorithms)
    seconds = {}
    with deterministic(torch):
        for name, env in (("none", {}), ("nccl", {
                "RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "MASTER_ADDR": "localhost",
                "MASTER_PORT": str(free_port())})):
            os.environ.update(env)
            t0 = time.perf_counter()
            try:
                _, counts = run_path(f"parallel {name}", lambda: train_main(
                    argv + ["--out_dir", out[name]]))
            finally:
                for k in env:
                    os.environ.pop(k)
            seconds[name] = time.perf_counter() - t0
            if raster(counts) != want:
                raise AssertionError(f"parallel {name}: launches {counts}, expected {want}")
    rows = {k: metrics_rows(out[k], TRAIN_STEPS, f"parallel {k}") for k in ("none", "nccl")}
    for a, b in zip(rows["none"], rows["nccl"]):
        diff = [k for k in a if k not in ("step_ms", "imgs_per_sec") and a[k] != b[k]]
        if diff:
            raise AssertionError(f"parallel: world 1 under NCCL differs at step {a['step']}: "
                                 f"{diff}")
    diff = checkpoint_diffs(ckpt["none"], ckpt["nccl"])
    if diff:
        raise AssertionError(f"parallel: world-1 NCCL checkpoint differs: {diff[:8]}")
    log(f"phase 4l (a): cli.train at world 1 under NCCL, {TRAIN_STEPS} steps at full width, "
        f"B={BATCH}, deterministic algorithms: every metric and the checkpoint bit-equal to "
        f"the run without a group; "
        f"launches {want} in each; {seconds['none']:.1f} s without, {seconds['nccl']:.1f} s "
        f"with the group (host clock, set-up and checkpoint included); step ms "
        + ", ".join(f"{a['step_ms']:.1f}/{b['step_ms']:.1f}"
                    for a, b in zip(rows["none"], rows["nccl"])) + " (without/with)")

    # ---- (b) the launcher, in the background while (c) runs
    env = {k: v for k, v in os.environ.items() if k not in launcher_vars}
    launched = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "1",
         "-m", "stylerenderer_tpu_torch.cli.train"] + argv + ["--out_dir", out["launcher"]],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    t_launch = time.perf_counter()

    # ---- (c) two gloo ranks on the card against world 1 at the doubled batch
    spec = dict(device="cuda", backend="gloo", one_card=True, tf32=False, record="params",
                deterministic=True,
                cfg=dict(GAR, batch=BATCH, d_reg_every=16, g_reg_every=4, seed=0),
                face=(48, 96, 80, 29), real=real_batch(torch, np, shard, dev).cpu(),
                draw_seed=11, step=0, run=["step"])
    ranks_dir = tempfile.mkdtemp(dir=work)
    t0 = time.perf_counter()
    ranks = Ranks(2, spec, ranks_dir, timeout=400)
    try:
        cfg, st = make_state(spec, dev)
        real, draws, _ = step_inputs(spec, cfg, st, synth_face, dev)
        vert, norm, _ = posed_mesh(synth_face, synth_tri, draws.d_face, draws.d_pose)
        half = BATCH // 2
        check_k1(vert[half:].contiguous(), norm[half:].contiguous(), half)
        del vert, norm
        results = ranks.wait()
    except BaseException:
        ranks.kill()
        launched.kill()
        launched.wait()
        raise
    ranks_s = time.perf_counter() - t0
    # world 1 at the doubled batch, each update landing on the parameters
    # rank 0's next update saw: Adam's first step (~lr sign(g)) would turn
    # the ranks' other order of summation into parameter differences
    rec = results[0]["step"]
    final = {k: [t.to(dev) for t in rec[k]] for k in ("d", "g")}
    records = [(side, [t.to(dev) for t in params], None) for side, params, _ in rec["records"]]
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        with deterministic(torch):
            m1, _ = landed_step(st, real, draws, cfg, synth_face, synth_tri, {}, records, final)
            m1 = {k: float(v) for k, v in m1.items()}
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    del st, draws, records, final, rec
    for r, res in enumerate(results):
        step = res["step"]
        path_launches[f"parallel gloo rank {r}"] = {
            "rasterize_multi": step["k1_launches"], "rasterize_single": 0,
            "fused_bias_act": step["epilogue_launches"],
            "upfirdn2d": step["upfirdn2d_launches"]}
        if step["k1_launches"] != 3 or step["step"] != 1 or res["device"] != "cuda:0":
            raise AssertionError(f"parallel gloo rank {r}: {step['k1_launches']} K1 launches, "
                                 f"step {step['step']}, {res['device']}")
        errs = {k: abs(step["metrics"][k] - v) / max(abs(v), 1e-30) for k, v in m1.items()}
        log(f"phase 4l (c) rank {r}: relative differences from world 1: "
            + ", ".join(f"{k} {e:.3g}" for k, e in errs.items()))
        bad = {k: e for k, e in errs.items() if e > 1e-4}
        if bad:
            raise AssertionError(f"parallel gloo rank {r}: {bad} over 1e-4 of world 1")
    log(f"phase 4l (c): 2 gloo ranks on the card, one step at step 0 (R1 + path) at local "
        f"batch {half}, TF32 off: every metric within 1e-4 of world 1 at B={BATCH} ("
        + ", ".join(f"{k} {m1[k]:.6g}" for k in ("d", "r1", "g", "path", "path_length"))
        + f"); K1 3 launches on each rank; {ranks_s:.1f} s with the spawn; per rank, its "
        f"first step (warm-up included) "
        + ", ".join(f"{res['step']['step_ms']:.1f} ms with {res['step']['collectives']['ms']:.1f}"
                    f" ms in {res['step']['collectives']['calls']} collectives"
                    for res in results) + " (host clock, each collective timed alone)")

    # ---- (b), continued
    # the launched run takes PyTorch's defaults (nothing asks a launched
    # process for deterministic algorithms; cuDNN's convolutions in TF32):
    # its checkpoint is (a)'s run, every entry but the trained tensors
    # equal, those within the card's run-to-run spread, and its first D
    # loss and scores, taken before any update, within TF32's rounding,
    # 1e-3 (of 1 where smaller: the scores are means of logits near 0)
    try:
        log_b, _ = launched.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        launched.kill()
        launched.wait()
        raise
    launch_s = time.perf_counter() - t_launch
    if launched.returncode != 0:
        raise AssertionError(f"parallel launcher: exit {launched.returncode}\n{log_b[-3000:]}")
    ca, cb = (torch.load(ckpt[k], map_location="cpu", weights_only=True)
              for k in ("none", "launcher"))
    diff = [k for k in checkpoint_diffs(ckpt["none"], ckpt["launcher"])
            if k.split("/")[1] not in ("g", "d", "g_ema", "g_optim", "d_optim", "ada_signs",
                                        "mean_path_length")
            or k.endswith("/step") or "/param_groups/" in k]
    row_b = metrics_rows(out["launcher"], TRAIN_STEPS, "parallel launcher")[0]
    first = {k: (row_b[k], rows["none"][0][k]) for k in ("d", "real_score", "fake_score")
             if abs(row_b[k] - rows["none"][0][k]) > 1e-3 * max(abs(rows["none"][0][k]), 1.0)}
    if diff or first:
        raise AssertionError(f"parallel launcher: checkpoint entries {diff[:8]} or first "
                             f"metrics {first} (launched, (a)) differ from (a)'s")
    spread = max(float((cb[p][k] - t).abs().max()) / max(float(t.abs().max()), 1e-30)
                 for p in ("g", "d") for k, t in ca[p].items())
    if not spread < 1.0:
        raise AssertionError(f"parallel launcher: parameters off by {spread} of their scale")
    log(f"phase 4l (b): torch.distributed.run --standalone --nproc_per_node 1 -m "
        f"stylerenderer_tpu_torch.cli.train exited 0 in {launch_s:.1f} s (beside (c)); its "
        f"checkpoint is (a)'s run: every entry but the trained tensors equal, the first D "
        f"loss and scores within 1e-3 (of 1 where smaller; "
        + ", ".join(f"{k} {row_b[k] - rows['none'][0][k]:.3g}"
                    for k in ("d", "real_score", "fake_score"))
        + f" off), the parameters within {spread:.3g} of each tensor's largest magnitude "
        f"(PyTorch's default algorithms, TF32 convolutions)")

    # ---- (d) each kind of step at world 1, with and without the group
    cfg = TrainConfig(batch=BATCH, d_reg_every=16, g_reg_every=4)
    st = init_train_state(cfg, dev, seed=0)
    real = real_batch(torch, np, shard, dev)
    mesh = make_mesh("cuda", rank=0, world_size=1, init_method=f"tcp://localhost:{free_port()}")
    try:
        for kind, at in STEP_KINDS.items():
            def steps(m, n, at=at):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(n):
                    st.step = at
                    draws = sample_draws(st.generator, cfg, synth_face, BATCH, st.g.n_latent)
                    train_step(st, real, draws, cfg, synth_face, synth_tri, mesh=m)
                torch.cuda.synchronize()
                return (time.perf_counter() - t0) * 1e3 / n

            steps(mesh, 1)
            turns = [steps(m, PAR_REPS) for m in (None, mesh, mesh, None)]
            totals, undo = timed_collectives(dev)
            try:
                steps(mesh, 1)
            finally:
                undo()
            if st.nonfinite_count:
                raise AssertionError(f"parallel {kind}: {st.nonfinite_count} screened steps")
            log(f"phase 4l (d) {kind} step at world 1, B={BATCH}: without the group "
                f"{turns[0]:.1f}, {turns[3]:.1f} ms, under NCCL {turns[1]:.1f}, {turns[2]:.1f} ms "
                f"(host clock, {PAR_REPS} step a turn, in turns); its collectives "
                f"{totals['ms']:.2f} ms in {totals['calls']} calls (each timed alone, the card "
                f"synchronized around it)")
    finally:
        mesh.destroy()
    del st
    log(f"phase 4l: {time.perf_counter() - t_phase:.1f} s; {smi}")



def spatial_phase(torch, np, dev, smi, work, face, tri, path_launches, keys_of_bins):
    """Phase 4m: spatial sharding (``parallel/spatial.py``) on the one card.
    (a) K1 by band on the production mesh at B=16, 7 levels, C=3: every
    band of 2 and of 4 bit-equal to the whole image's launch cut to it;
    band 1 of 4 bit-equal to its plain version, and timed beside its bound
    with its binning held to the plain binning of the band; (b) world 1 in
    this process, TF32 off: ``GeneratorWithMap(256, 512, 8)`` f32 at B=16
    with given noise, its forward timed, and a 1 x 1 mesh under NCCL
    bit-equal to no mesh (the image and ``Discriminator(256)``'s logits of
    it, deterministic algorithms); (c) four gloo ranks on the card (NCCL
    refuses two ranks on one device), laid out 2 x 2 and 1 x 4, the same
    GAR at global B=16 and D on world 1's images, TF32 off, against world 1
    to 1e-4 of each tensor's largest magnitude: the image bands, the
    logits, D's block gradient and a few reduced parameter gradients; the
    vertex and normal gradients to 1e-3, beside world 1's own spread
    between two runs; each rank's K1 launches (once, banded, a
    GAR forward); the banded forward's ms on each rank and its
    collectives' calls and ms. Four ranks share one card, so the times say
    nothing of a speed-up between cards. -> the banded K1's numbers for the
    kernels line."""
    from torch_parallel import Ranks, free_port

    from stylerenderer_tpu_torch.face3d import mesh_point_normal, random_apply_pose3D
    from stylerenderer_tpu_torch.models import Discriminator, GeneratorWithMap, make_noise
    from stylerenderer_tpu_torch.ops.rasterize_multi import (
        band_level_rows, rasterize_winners_multi, rasterize_winners_multi_ref, space_band,
    )
    from stylerenderer_tpu_torch.parallel import make_mesh_2d

    t_phase = time.perf_counter()
    g = torch.Generator().manual_seed(21)
    vert = random_apply_pose3D(g, face(face.random_input(BATCH, g)))
    norm = mesh_point_normal(vert, tri)

    # ---- (a) K1 by band
    full = rasterize_winners_multi(vert, tri, TOP, N_LEVELS, attrs=norm)
    for n in (2, 4):
        for i in range(n):
            t, band = space_band(TOP, N_LEVELS, n, i)
            out = rasterize_winners_multi(vert, tri, TOP, N_LEVELS, attrs=norm, tile=t, band=band)
            cut = []
            for k, (v, w) in enumerate(full):
                y0, y1 = band_level_rows(TOP, t, band, k)
                cut.append((v[:, y0:y1], w[:, y0:y1]))
            compare_multi(out, cut, True, f"K1 band {i} of {n}")
    k1_tile, k1_band = space_band(TOP, N_LEVELS, 4, 1)
    k1_rows = f"top-level rows {k1_band[0] * k1_tile}..{(k1_band[0] + k1_band[1]) * k1_tile}"
    out = rasterize_winners_multi(vert, tri, TOP, N_LEVELS, attrs=norm, tile=k1_tile,
                                  band=k1_band)
    ref, plain_ms = once_ms(torch, lambda: rasterize_winners_multi_ref(
        vert, tri, TOP, N_LEVELS, attrs=norm, tile=k1_tile, band=k1_band))
    band_err = compare_multi(out, ref, True, "K1 band 1 of 4 against its plain version")
    m = k1_measure(torch, np, vert, tri, N_LEVELS, norm, keys_of_bins, tile=k1_tile,
                   band=k1_band)
    del full, out, ref
    log(k1_report(f"phase 4m (a) K1 by band: every band of 2 and of 4 at B={BATCH}, "
                  f"{N_LEVELS} levels, C=3, bit-equal to the whole image's launch cut to it; "
                  f"band 1 of 4 ({k1_rows}, tile {k1_tile})", m)
        + f"; plain version of the band {plain_ms:.1f} ms (once), bit-equal to it")

    # ---- (b) world 1, and a 1 x 1 mesh under NCCL
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        gen = GeneratorWithMap(256, 512, 8, seed=0, device=dev)
        disc = Discriminator(256, seed=3, device=dev)
        z = torch.randn(BATCH, 512, generator=g)
        noise = make_noise(256, 1, g)
        x_w = 0.5 + torch.rand(BATCH, generator=g)
        img_w = 0.5 + torch.rand(BATCH, 3, 256, 256, generator=g)
        args = ([z.to(dev)], (vert, norm, tri))
        noise_d = [n.to(dev) for n in noise]
        with torch.no_grad():
            images = gen(*args, noise=noise_d)[0]
            fwd_ms = cuda_ms(torch, lambda: gen(*args, noise=noise_d), SPATIAL_REPS)
        mesh = make_mesh_2d(1, 1, "cuda", rank=0, world_size=1,
                            init_method=f"tcp://localhost:{free_port()}")
        try:
            with deterministic(torch), torch.no_grad():
                same = (torch.equal(gen(*args, noise=noise_d)[0],
                                    gen(*args, noise=noise_d, device_mesh=mesh)[0])
                        and torch.equal(disc(images), disc(images, mesh)))
        finally:
            mesh.destroy()
        if not same:
            raise AssertionError("spatial: a 1 x 1 mesh under NCCL differs from no mesh")
        log(f"phase 4m (b): GeneratorWithMap(256, 512, 8) f32 (TF32 off) at B={BATCH} with given "
            f"noise, world 1: forward {fwd_ms:.3f} ms (CUDA events, mean of {SPATIAL_REPS}); a "
            f"1 x 1 mesh under NCCL (make_mesh_2d(1, 1)) bit-equal to no mesh, the image and "
            f"Discriminator(256)'s logits, deterministic algorithms")

        # ---- (c) four gloo ranks on the card against world 1
        spec = dict(device="cuda", backend="gloo", one_card=True, tf32=False, run=["spatial"],
                    spatial=dict(d=((256,), dict(seed=3)), g=((256, 512, 8), dict(seed=0)),
                                 x=images.cpu(), x_w=x_w, z=z, vert=vert.cpu(), norm=norm.cpu(),
                                 tri=tri.cpu(), noise=noise, img_w=img_w,
                                 layouts=SPATIAL_LAYOUTS, d_params=SPATIAL_D_PARAMS,
                                 g_params=SPATIAL_G_PARAMS, time=SPATIAL_REPS))
        t0 = time.perf_counter()
        ranks = Ranks(4, spec, tempfile.mkdtemp(dir=work), timeout=400)
        try:
            x = images.detach().clone().requires_grad_(True)
            d_params = [p for n, p in disc.named_parameters() if n in SPATIAL_D_PARAMS]
            logits = disc(x)
            d_ref = torch.autograd.grad((logits[:, 0] * x_w.to(dev)).sum(), [x] + d_params)
            g_params = [p for n, p in gen.named_parameters() if n in SPATIAL_G_PARAMS]
            g_ref = []
            for _ in range(2):  # twice: world 1's own spread of the raster gradients
                vv, nn_ = vert.clone().requires_grad_(True), norm.clone().requires_grad_(True)
                img = gen([z.to(dev)], (vv, nn_, tri), noise=noise_d)[0]
                g_ref.append([t.cpu() for t in torch.autograd.grad(
                    (img * img_w.to(dev)).sum(), [vv, nn_] + g_params)])
            results = ranks.wait()
        finally:
            ranks.kill()
        ranks_s = time.perf_counter() - t0
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    logits, img = logits.detach().cpu(), img.detach().cpu()
    d_ref, (g_ref, g_again) = [t.cpu() for t in d_ref], g_ref
    del gen, disc, images, x, vv, nn_

    def rel(a, b):
        return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)

    # the raster gradients sum per-pixel cotangents that cancel, and the
    # gather's backward adds them with atomics: two world-1 runs on an H100
    # differed by 2.4e-5 of them, and a banded run by 2.4e-4, so they are
    # held to 1e-3 (world 1's own spread is logged beside); the rest to 1e-4
    spread = {"vertex gradient": rel(g_again[0], g_ref[0]),
              "normal gradient": rel(g_again[1], g_ref[1])}
    tol = {k: 1e-3 for k in spread}

    band_launches, worst = 0, {}
    for r, rr in enumerate(results):
        res = rr["spatial"]
        counts = [res[f"{nd}x{ns}"]["k1"] for nd, ns in SPATIAL_LAYOUTS]
        epilogue = [res[f"{nd}x{ns}"]["epilogue_launches"] for nd, ns in SPATIAL_LAYOUTS]
        path_launches[f"spatial rank {r}"] = {
            "rasterize_multi": sum(c[0] for c in counts), "rasterize_single": 0,
            "fused_bias_act": sum(epilogue),
            "upfirdn2d": sum(res[f"{nd}x{ns}"]["upfirdn2d_launches"] for nd, ns in SPATIAL_LAYOUTS)}
        # the mapping's 8 layers a forward run outside the mesh; the banded
        # synthesis keeps the plain chain (warm-up + SPATIAL_REPS forwards)
        want = [(SPATIAL_REPS + 1) * 8] * len(SPATIAL_LAYOUTS)
        if epilogue != want:
            raise AssertionError(f"spatial rank {r}: {epilogue} epilogue launches in the "
                                 f"no-grad banded forwards, expected {want}: the mapping's only")
        band_launches += sum(c[1] for c in counts)
        for (nd, ns), c in zip(SPATIAL_LAYOUTS, counts):
            o = res[f"{nd}x{ns}"]
            if c != (1, 1) or rr["device"] != "cuda:0":
                raise AssertionError(f"spatial {nd}x{ns} rank {r}: K1 launches {c} on "
                                     f"{rr['device']}, expected one banded on cuda:0")
            rows, band, gband = o["rows"], o["band"], o["gband"]
            errs = {"image": rel(o["image"], img[rows][:, :, gband]),
                    "logits": rel(o["logits"], logits[rows]),
                    "D block gradient": rel(o["d_x_grad"], d_ref[0][rows][:, :, band]),
                    "vertex gradient": rel(o["vert_grad"], g_ref[0][rows]),
                    "normal gradient": rel(o["norm_grad"], g_ref[1][rows])}
            errs.update({f"D {n}": rel(a, b / nd)
                         for n, a, b in zip(SPATIAL_D_PARAMS, o["d_grads"], d_ref[1:])})
            errs.update({f"G {n}": rel(a, b / nd)
                         for n, a, b in zip(SPATIAL_G_PARAMS, o["g_grads"], g_ref[2:])})
            for k, e in errs.items():
                worst[k] = max(worst.get(k, 0.0), e)
            bad = {k: e for k, e in errs.items() if not e <= tol.get(k, 1e-4)}
            if bad:
                raise AssertionError(f"spatial {nd}x{ns} rank {r}: {bad} over the tolerance "
                                     f"(1e-4, raster gradients 1e-3) of world 1")
            log(f"phase 4m (c) {nd}x{ns} rank {r} (data {o['data_index']}, space "
                f"{o['space_index']}; rows {rows.start}..{rows.stop}, image rows "
                f"{gband.start}..{gband.stop}): banded forward {o['forward_ms']:.3f} ms (host "
                f"clock, mean of {SPATIAL_REPS}), its collectives {o['collectives']['ms']:.2f} ms "
                f"in {o['collectives']['calls']} calls (each timed alone); K1 {c[0]} launch, "
                f"{c[1]} banded")
    log(f"phase 4m (c): 4 gloo ranks on the one card, 2x2 and 1x4, GeneratorWithMap(256, 512, "
        f"8) f32 at global B={BATCH} and Discriminator(256) on world 1's images, TF32 off: "
        f"every check within 1e-4 of world 1's largest magnitude, the vertex and normal "
        f"gradients within 1e-3 (worst: "
        + ", ".join(f"{k} {e:.3g}" for k, e in worst.items())
        + "; world 1 against itself: "
        + ", ".join(f"{k} {e:.3g}" for k, e in spread.items())
        + f"); world 1's forward {fwd_ms:.3f} ms; {ranks_s:.1f} s with the spawn. Four ranks "
        f"share one card: these times measure no speed-up between cards")
    log(f"phase 4m: {time.perf_counter() - t_phase:.1f} s; {smi}")
    return dict(m, plain_ms=plain_ms, max_abs_err=band_err, launches=band_launches,
                band=f"{k1_rows} of {TOP}, tile {k1_tile}")


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_meshes import (
        KERNEL_CASES, NAN_DEPTH_PIXELS_16, SINGLE_CASES, kernel_case, keys_of_bins,
        single_case,
    )
    from stylerenderer_tpu_torch.cli.generate import main as generate_main
    from stylerenderer_tpu_torch.data import write_synth_dataset
    from stylerenderer_tpu_torch.face3d import (
        mesh_point_normal, random_apply_pose3D, synthetic_face,
    )
    from stylerenderer_tpu_torch.face3d.alignment import render_mean_face
    from stylerenderer_tpu_torch.models import GeneratorWithMap, make_noise
    from stylerenderer_tpu_torch.ops import _build, fused_act
    from stylerenderer_tpu_torch.ops.rasterize import rasterize
    from stylerenderer_tpu_torch.ops.resize import resize_linear
    from stylerenderer_tpu_torch.ops.upfirdn2d import upfirdn2d
    from stylerenderer_tpu_torch.ops.rasterize_multi import (
        rasterize_winners_multi,
        rasterize_winners_multi_ref,
    )
    from stylerenderer_tpu_torch.ops.rasterize_single import (
        build_bins,
        card_tile,
        rasterize_winners_single,
        rasterize_winners_single_ref,
    )

    kernels = {"rasterize_multi": rasterize_winners_multi,
               "rasterize_single": rasterize_winners_single,
               "fused_bias_act": fused_act.fused_bias_act,
               "upfirdn2d": upfirdn2d}
    path_launches = {}

    def run_path(name, fn):
        """Drive one path with every launch count at 0 just before it;
        record and return (its result, the counts just after)."""
        for k in kernels.values():
            k.launches = 0
        out = fn()
        torch.cuda.synchronize()
        counts = {n: k.launches for n, k in kernels.items()}
        path_launches[name] = counts
        return out, counts

    dev = torch.device("cuda")
    t_start = time.perf_counter()
    # the training phase's checkpoint and its shard: phases 4f and 6 read them
    work = tempfile.TemporaryDirectory()

    # ---- phase 1: the card ------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    log(f"device: {kind} x{count}")
    log(f"nvidia-smi: {smi}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")

    # ---- phase 2: build the kernels, in parallel ----------------------------
    t0 = time.perf_counter()
    _build.build_cuda_libraries()
    log(f"build: {len(_build.CUDA_LIBRARIES)} libraries in {time.perf_counter() - t0:.1f} s")
    for name in _build.CUDA_LIBRARIES:
        log(f"build {name}: {_build.build_seconds(name):.1f} s")
        log(_build.build_log(name).strip() or "(library loaded from an earlier build)")

    # ---- phase 3: K1 against its plain version ------------------------------
    max_err = {"rasterize_multi": 0.0, "rasterize_single": 0.0}
    # (name, vertices, triangles, h, w, the plain version's winners): the
    # inputs phase 4j holds the binned search on, gathered where earlier
    # phases run the dense search anyway
    binned_cases = []
    g = torch.Generator().manual_seed(0)
    face, tri = synthetic_face(180, 280, 80, 29, device=dev)
    log(f"mesh: synthetic_face(180, 280, 80, 29): {face.mean.shape[0] // 3} vertices, "
        f"{tri.shape[0]} triangles")
    vert2 = random_apply_pose3D(g, face(face.random_input(2, g)))
    norm2 = mesh_point_normal(vert2, tri)
    out = rasterize_winners_multi(vert2, tri, TOP, N_LEVELS, attrs=norm2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = rasterize_winners_multi_ref(vert2, tri, TOP, N_LEVELS, attrs=norm2)
    torch.cuda.synchronize()
    log(f"plain version, production mesh, B=2: {time.perf_counter() - t0:.1f} s")
    max_err["rasterize_multi"] = max(max_err["rasterize_multi"],
                                     compare_multi(out, ref, True, "production mesh B=2 C=3"))
    win_only = rasterize_winners_multi(vert2, tri, TOP, N_LEVELS)
    compare_multi(win_only, [w for _, w in ref], False, "production mesh B=2 winners-only")
    log(f"check: production mesh B=2, 7 levels {TOP}..{TOP >> (N_LEVELS - 1)} px: winners "
        f"and values bit-equal; winners-only mode bit-equal; covered pixels at {TOP} px: "
        f"{float((ref[0][1] >= 0).float().mean()):.3f}")
    for name in sorted(KERNEL_CASES):
        v, t_, a, top, n_levels, tile, persp = kernel_case(name)
        v, t_, a = (torch.from_numpy(x).to(dev) for x in (v, t_, a))
        for attrs in (a, None):
            o = rasterize_winners_multi(v, t_, top, n_levels, persp, attrs=attrs, tile=tile)
            r = rasterize_winners_multi_ref(v, t_, top, n_levels, persp, attrs=attrs, tile=tile)
            max_err["rasterize_multi"] = max(max_err["rasterize_multi"],
                                             compare_multi(o, r, attrs is not None, name))
        log(f"check: {name} (top {top}, {n_levels} levels, tile {tile}, perspective "
            f"{persp}): both modes bit-equal")
    nan_idx = tuple(torch.tensor(NAN_DEPTH_PIXELS_16, device=dev).T)
    for name in ("nan_depth", "nan_depth_chunks"):
        v, t_, a, top, n_levels, tile, _ = kernel_case(name)
        v, t_, a = (torch.from_numpy(x_).to(dev) for x_ in (v, t_, a))
        (val, win), *_ = rasterize_winners_multi(v, t_, top, n_levels, attrs=a, tile=tile)
        win2 = rasterize_winners_single(v, t_, top, top)
        if not (bool((win[nan_idx] == -1).all()) and bool((val[nan_idx] == 0).all())
                and bool((win2[nan_idx] == -1).all())):
            raise AssertionError(f"{name}: a pixel a NaN depth covers is not background")
    log(f"check: NaN depth (nan_depth, nan_depth_chunks): K1 and K2 give -1 and the "
        f"background value at the {len(NAN_DEPTH_PIXELS_16)} pixels the NaN-depth triangle "
        f"covers, bit-equal to their plain versions")

    # ---- phase 3a: K2 against its plain version -----------------------------
    for name in sorted(SINGLE_CASES):
        v, t_, h, w, tile, persp = single_case(name)
        v, t_ = torch.from_numpy(v).to(dev), torch.from_numpy(t_).to(dev)
        max_err["rasterize_single"] = max(max_err["rasterize_single"], compare_wins(
            rasterize_winners_single(v, t_, h, w, persp, tile=tile),
            rasterize_winners_single_ref(v, t_, h, w, persp), name))
        log(f"check: K2 {name} ({h} x {w}, tile {tile}, perspective {persp}): bit-equal")
    synth_face, synth_tri = synthetic_face(48, 96, 80, 29, device=dev)
    svert16 = random_apply_pose3D(g, synth_face(synth_face.random_input(BATCH, g)))
    ref16, synth_plain_ms = once_ms(
        torch, lambda: rasterize_winners_single_ref(svert16, synth_tri, TOP, TOP))
    k2_synth = {}
    for tile in (8, 16, 32):
        max_err["rasterize_single"] = max(max_err["rasterize_single"], compare_wins(
            rasterize_winners_single(svert16, synth_tri, TOP, TOP, tile=tile), ref16,
            f"K2 synth mesh B={BATCH} tile {tile}"))
        k2_synth[tile] = k2_measure(torch, np, svert16, synth_tri, TOP, TOP, tile, keys_of_bins,
                                    ref16)
    log(f"check: K2 synthetic_face(48, 96, 80, 29) ({synth_tri.shape[0]} triangles), {TOP}^2, "
        f"B={BATCH}, tiles 8, 16, 32: bit-equal, the card's keys and starts "
        f"equal to the plain binning's; plain version {synth_plain_ms:.1f} ms (once); covered "
        f"{float((ref16 >= 0).float().mean()):.3f}")
    dat, _, starts = build_bins(svert16, synth_tri, TOP, TOP, False, EPS, card_tile(TOP, TOP))
    sb_ms, sb_by, nbytes, ops, pairs, n_valid = k2_bound(torch, dat, starts, TOP, TOP)
    del dat, starts
    log(k2_report(f"K2 on the synth mesh, {TOP}^2, B={BATCH}", k2_synth)
        + f"; bound {sb_ms:.4f} ms by {sb_by} ({nbytes} bytes, {ops} f32 ops, {pairs} bbox "
        f"pairs, {n_valid} valid of {svert16.shape[0] * synth_tri.shape[0]} binned triangles)")
    binned_cases.append((f"training mesh {TOP}^2 B={BATCH}", svert16, synth_tri, TOP, TOP,
                         ref16))
    del ref16
    ref2 = rasterize_winners_single_ref(vert2, tri, TOP, TOP)
    for tile in (8, 16):
        max_err["rasterize_single"] = max(max_err["rasterize_single"], compare_wins(
            rasterize_winners_single(vert2, tri, TOP, TOP, tile=tile), ref2,
            f"K2 production mesh B=2 tile {tile}"))
    log(f"check: K2 production mesh {TOP}^2 B=2, tiles 8, 16: bit-equal")

    # ---- phase 3b: K1 at one level against its plain version ----------------
    (v1, w1), = rasterize_winners_multi(vert2, tri, TOP, 1, attrs=norm2)
    (rv1, rw1), = rasterize_winners_multi_ref(vert2, tri, TOP, 1, attrs=norm2)
    max_err["rasterize_multi"] = max(max_err["rasterize_multi"], compare_multi(
        [(v1, w1)], [(rv1, rw1)], True, "K1 one level, production mesh B=2"))
    compare_wins(w1, ref2, "K1 one level against K2's plain version")
    log(f"check: K1 n_levels=1 at {TOP}^2, production mesh B=2: winners and values bit-equal")

    # ---- phase 3c: the styled conv's epilogue kernel ----------------------------
    ep = epilogue_phase(torch, dev, smi, face, tri, run_path)

    # ---- phase 3d: upfirdn2d's kernel ---------------------------------------------
    ufd = upfirdn2d_phase(torch, dev, smi, run_path)

    # ---- phase 4: the "each" path -------------------------------------------
    gen = GeneratorWithMap(256, 512, 8, dtype=torch.bfloat16, seed=0, device=dev).eval()
    batches = []
    for _ in range(FORWARDS + 1):
        vert = random_apply_pose3D(g, face(face.random_input(BATCH, g)))
        batches.append((torch.randn(BATCH, 512, generator=g).to(dev), vert,
                        mesh_point_normal(vert, tri)))
    with torch.no_grad():
        z, vert, norm = batches[0]
        gen([z], (vert, norm, tri))  # warm-up: cuDNN plans, allocator
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        images, counts = run_path("each", lambda: [
            gen([z], (vert, norm, tri))[0] for z, vert, norm in batches[1:]])
        elapsed = time.perf_counter() - t0
    # the epilogue: 13 styled convs, 14 ResBlock activations, 8 mapping
    # layers; upfirdn2d: a blur and an Upsample a level from 8 px
    if counts != {"rasterize_multi": FORWARDS, "rasterize_single": 0,
                  "fused_bias_act": FORWARDS * (13 + 14 + 8), "upfirdn2d": FORWARDS * 12}:
        raise AssertionError(f"each path: launches {counts} in {FORWARDS} forwards")
    for img in images:
        if tuple(img.shape) != (BATCH, 3, 256, 256):
            raise AssertionError(f"image shape {tuple(img.shape)}")
        if not bool(torch.isfinite(img.float()).all()):
            raise AssertionError("non-finite image")
    log(f"each path: GeneratorWithMap(256, 512, 8) bf16, B={BATCH}, {FORWARDS} forwards in "
        f"{elapsed:.4f} s: {BATCH * FORWARDS / elapsed:.1f} renders/s (host clock); launches "
        f"{counts}; image std {float(images[-1].float().std()):.4f}")
    with torch.no_grad():
        z, vert, norm = batches[-1]
        mesh = (vert, norm, tri)
        latent = gen.get_latent(z)[:, None, :].repeat(1, gen.n_latent, 1)
        maps = gen.normal_pyramid(mesh)
        pyr_ms = cuda_ms(torch, lambda: gen.normal_pyramid(mesh), 5)
        syn_ms = cuda_ms(torch, lambda: gen.synthesize(latent, maps), 5)
        fwd_ms = cuda_ms(torch, lambda: gen([z], mesh), 5)
    log(f"each forward split (CUDA events, B={BATCH}): normal pyramid {pyr_ms:.3f} ms, "
        f"synthesis {syn_ms:.3f} ms, whole forward {fwd_ms:.3f} ms")
    profile_forwards(torch, gen, [(z, (vert, norm, tri)) for z, vert, norm in batches[1:]])

    # K1 alone at the each path's shapes, B=16, C=3
    k1 = k1_measure(torch, np, vert, tri, N_LEVELS, norm, keys_of_bins)
    ref16m, k1_plain_ms = once_ms(
        torch, lambda: rasterize_winners_multi_ref(vert, tri, TOP, N_LEVELS, attrs=norm))
    out16 = rasterize_winners_multi(vert, tri, TOP, N_LEVELS, attrs=norm)
    max_err["rasterize_multi"] = max(max_err["rasterize_multi"],
                                     compare_multi(out16, ref16m, True, "each path B=16"))
    log(k1_report(f"K1 rasterize_multi at B={BATCH}, {N_LEVELS} levels, C=3", k1)
        + f"; plain version {k1_plain_ms:.1f} ms (once), bit-equal to it")
    del gen, batches, images, ref16m, out16

    # ---- phase 4a: the synthetic-data path -----------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(work.name, "faces256.srpack")
        write_synth_dataset(os.path.join(tmp, "warm.srpack"), BATCH, size=256, seed=1,
                            batch=BATCH, device=dev)
        t0 = time.perf_counter()
        n, counts = run_path("synth", lambda: write_synth_dataset(
            path, SYNTH_IMAGES, size=256, seed=0, batch=BATCH, device=dev))
        synth_s = time.perf_counter() - t0
        n_batches = -(-SYNTH_IMAGES // BATCH)
        if n != SYNTH_IMAGES or raster(counts) != {"rasterize_multi": 0,
                                                   "rasterize_single": n_batches}:
            raise AssertionError(f"synth path: {n} images, launches {counts}")
        with open(path, "rb") as f:
            head = f.read(28)
        size = os.path.getsize(path)
        if head[:4] != b"SRPK" or size != 28 + 16 * n + n * 256 * 256 * 3:
            raise AssertionError(f"synth shard: header {head!r}, {size} bytes")
        log(f"synth path: write_synth_dataset({SYNTH_IMAGES} images, 256 px, B={BATCH}) in "
            f"{synth_s:.3f} s: {SYNTH_IMAGES / synth_s:.1f} images/s (host clock, shard write "
            f"included); launches {counts}; shard {size} bytes")

        # ---- phase 4a, continued: training on that shard, through cli/train.py
        def check_k1(v, n, b):
            """K1 against its plain version at a training shape; timed."""
            ref, plain_ms = once_ms(
                torch, lambda: rasterize_winners_multi_ref(v, synth_tri, TOP, N_LEVELS, attrs=n))
            max_err["rasterize_multi"] = max(max_err["rasterize_multi"], compare_multi(
                rasterize_winners_multi(v, synth_tri, TOP, N_LEVELS, attrs=n), ref, True,
                f"K1 training mesh B={b}"))
            del ref
            log(k1_report(f"K1 on the training mesh ({synth_tri.shape[0]} triangles), B={b}, "
                          f"{N_LEVELS} levels, C=3, bit-equal to its plain version "
                          f"({plain_ms:.1f} ms once)",
                          k1_measure(torch, np, v, synth_tri, N_LEVELS, n, keys_of_bins)))

        train_step_ms = train_phase(torch, np, dev, path, os.path.join(work.name, "train"),
                                    run_path, synth_face, synth_tri, check_k1)

    # ---- phase 4b: the "downsample" paths -------------------------------------
    def resize_chain(top):
        cur = top
        for s in (128, 64, 32, 16, 8, 4):
            cur = resize_linear(cur, s, s)
        return cur

    ds = {}
    mesh16 = None
    for fused in (True, False):
        gen = GeneratorWithMap(256, 512, 8, dtype=torch.bfloat16, pyramid_mode="downsample",
                               fused_pyramid=fused, seed=0, device=dev).eval()
        inputs = []
        for _ in range(DS_FORWARDS + 1):
            vert = random_apply_pose3D(g, face(face.random_input(BATCH, g)))
            inputs.append((torch.randn(BATCH, 512, generator=g).to(dev),
                           (vert, mesh_point_normal(vert, tri), tri)))
        mesh16 = mesh16 or inputs[-1][1]
        with torch.no_grad():
            gen([inputs[0][0]], inputs[0][1])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            images, counts = run_path(f"downsample_fused={fused}", lambda: [
                gen([z], m)[0] for z, m in inputs[1:]])
            elapsed = time.perf_counter() - t0
            want = ({"rasterize_multi": DS_FORWARDS, "rasterize_single": 0} if fused
                    else {"rasterize_multi": 0, "rasterize_single": DS_FORWARDS})
            if raster(counts) != want:
                raise AssertionError(f"downsample fused={fused}: launches {counts}")
            for img in images:
                if tuple(img.shape) != (BATCH, 3, 256, 256) or not bool(
                        torch.isfinite(img.float()).all()):
                    raise AssertionError(f"downsample fused={fused}: bad image")
            z = inputs[-1][0]
            latent = gen.get_latent(z)[:, None, :].repeat(1, gen.n_latent, 1)
            maps = gen.normal_pyramid(mesh16)
            pyr_ms = cuda_ms(torch, lambda: gen.normal_pyramid(mesh16), 5)
            chain_ms = cuda_ms(torch, lambda: resize_chain(maps[-1]), 5)
            syn_ms = cuda_ms(torch, lambda: gen.synthesize(latent, maps), 5)
            fwd_ms = cuda_ms(torch, lambda: gen([z], mesh16), 5)
        ds[fused] = maps
        log(f"downsample path, fused_pyramid={fused}: B={BATCH}, {DS_FORWARDS} forwards in "
            f"{elapsed:.4f} s: {BATCH * DS_FORWARDS / elapsed:.1f} renders/s (host clock); "
            f"launches {counts}; split (CUDA events): normal pyramid {pyr_ms:.3f} ms (its "
            f"resize chain alone {chain_ms:.3f} ms), synthesis {syn_ms:.3f} ms, whole forward {fwd_ms:.3f} ms")
        del gen, inputs, images
    for k, (a, b) in enumerate(zip(ds[True], ds[False])):
        if a.shape != b.shape or not torch.equal(a, b):
            raise AssertionError(f"downsample: level {k}: fused and unfused pyramids differ")
    log(f"check: downsample normal pyramids, fused and unfused, bit-equal at all "
        f"{len(ds[True])} levels")

    # ---- phase 4c: render_mean_face -------------------------------------------
    hh, ww = MEAN_FACE_HW
    tex = torch.rand(face.mean.shape[0] // 3, 3, generator=torch.Generator().manual_seed(5))
    img, counts = run_path("render_mean_face",
                           lambda: render_mean_face(face, tex, tri, hh, ww))
    if raster(counts) != {"rasterize_multi": 0, "rasterize_single": 1}:
        raise AssertionError(f"render_mean_face: launches {counts}")
    v0 = face(torch.zeros(1, face.sigma.shape[0], device=dev))
    dense = rasterize(v0, tex.to(dev)[None], tri, hh, ww, method="dense")[0].cpu().numpy()
    want = np.clip(dense[:, :, ::-1] * 255.0, 0, 255).astype(np.uint8)
    if img.shape != (hh, ww, 3) or not np.array_equal(img, want):
        raise AssertionError("render_mean_face differs from the dense search's render")
    log(f"render_mean_face {hh} x {ww}: launches {counts}; equal to the dense render; "
        f"face pixels {float((img > 0).any(-1).mean()):.3f}")

    # ---- phase 4d: K2 and K1 at one level at the downsample path's shapes -----
    # both against their plain versions on the production mesh, B=16: the
    # input the unfused (K2) and fused (K1, one level, C=3) paths give them
    vert, norm, _ = mesh16
    tile = card_tile(TOP, TOP)
    ref16p, k2_plain_ms = once_ms(
        torch, lambda: rasterize_winners_single_ref(vert, tri, TOP, TOP))
    max_err["rasterize_single"] = max(max_err["rasterize_single"], compare_wins(
        rasterize_winners_single(vert, tri, TOP, TOP), ref16p,
        f"K2 production mesh B={BATCH} tile {tile}"))
    k2_prod = {t: k2_measure(torch, np, vert, tri, TOP, TOP, t, keys_of_bins, ref16p)
               for t in (8, 16, 32)}
    binned_cases.append((f"production mesh {TOP}^2 B={BATCH}", vert, tri, TOP, TOP, ref16p))
    del ref16p
    ref1, k1_one_plain_ms = once_ms(
        torch, lambda: rasterize_winners_multi_ref(vert, tri, TOP, 1, attrs=norm))
    max_err["rasterize_multi"] = max(max_err["rasterize_multi"], compare_multi(
        rasterize_winners_multi(vert, tri, TOP, 1, attrs=norm), ref1, True,
        f"K1 one level, C=3, production mesh B={BATCH}"))
    del ref1
    log(f"check: K2 (tile {tile}) and K1 at one level with C=3 values, production mesh "
        f"{TOP}^2 B={BATCH}: bit-equal to their plain versions")
    dat, ids, starts = build_bins(vert, tri, TOP, TOP, False, EPS, tile)
    k2b_ms, k2_by, nbytes, ops, pairs, n_valid = k2_bound(torch, dat, starts, TOP, TOP)
    k2 = k2_prod[tile]
    del dat, ids, starts
    log(f"K2 rasterize_single at {TOP}^2, B={BATCH}, production mesh, tile {tile} (the card "
        f"path's): kernel {k2['ms']:.4f} ms, card binning {k2['bins_ms']:.4f} ms (graph "
        f"replay; keys and starts equal to the plain binning's), plain binning "
        f"{k2['plain_bins_ms']:.4f} ms; "
        f"bound {k2b_ms:.4f} ms by {k2_by} ({nbytes} bytes, {ops} f32 ops, {pairs} bbox pairs, "
        f"{n_valid} valid of {vert.shape[0] * tri.shape[0]} binned triangles); plain version "
        f"{k2_plain_ms:.1f} ms (same input, once)")
    log(k2_report(f"K2 on the production mesh, {TOP}^2, B={BATCH}, bit-equal at every tile",
                  k2_prod))
    # 512 px: no plain version (it would take minutes); the tiles agree
    big = 2 * TOP
    k2_big = {t: k2_measure(torch, np, vert, tri, big, big, t, keys_of_bins)
              for t in (8, 16, 32)}
    outs = [rasterize_winners_single(vert, tri, big, big, tile=t) for t in (8, 16, 32)]
    for t, o in zip((16, 32), outs[1:]):
        compare_wins(o, outs[0], f"K2 {big}^2 tile {t} against tile 8")
    del outs
    log(k2_report(f"K2 on the production mesh, {big}^2, B={BATCH}, tiles agree", k2_big))
    k1_one = k1_measure(torch, np, vert, tri, 1, norm, keys_of_bins)
    log(k1_report(f"K1 at one level on the same input (tile {TILE}, C=3, the fused downsample "
                  "path)", k1_one) + f"; plain version {k1_one_plain_ms:.1f} ms (once)")

    # ---- phase 4e: render inverting at full width -----------------------------
    def check_k1_samples(v, n, t, what, k):
        """K1 at 7 levels with C=3 on the batch ``v``, its first ``k``
        samples held against the plain version."""
        out = rasterize_winners_multi(v, t, TOP, N_LEVELS, attrs=n)
        ref, plain_ms = once_ms(torch, lambda: rasterize_winners_multi_ref(
            v[:k], t, TOP, N_LEVELS, attrs=n[:k]))
        max_err["rasterize_multi"] = max(max_err["rasterize_multi"], compare_multi(
            [(a[:k], w[:k]) for a, w in out], ref, True, f"K1 on {what}"))
        log(f"check: K1 on {what}, {N_LEVELS} levels, C=3: samples 0-{k - 1} bit-equal to the "
            f"plain version ({plain_ms:.1f} ms once)")

    targets = inversion_phase(
        torch, np, dev, face, tri, run_path, lambda v: check_k1_samples(
            v, mesh_point_normal(v, tri), tri, f"the B={v.shape[0]} each fit's fitted vertices",
            2))
    photos = targets[0][:2].permute(0, 2, 3, 1).cpu().numpy()

    # ---- phase 4f: evaluation on the training checkpoint ----------------------
    eval_phase(torch, np, dev, smi, os.path.join(work.name, "faces256.srpack"),
               os.path.join(work.name, "train", "checkpoint"), face, tri,
               (synth_face, synth_tri), targets, run_path,
               lambda v, n, what: check_k1_samples(v, n, synth_tri, what, 4))

    # ---- phase 4g: the Regressor and the supervisor heads --------------------
    regressor_heads_phase(torch, np, dev, smi, work.name, (synth_face, synth_tri), (face, tri),
                          targets, run_path, train_step_ms)

    # ---- phase 4h: the real face models and the data pipeline -----------------
    face_models_phase(torch, np, dev, smi, work.name, run_path, max_err, keys_of_bins)

    # ---- phase 4i: the GAR at 1024 px -------------------------------------------
    k1_1024, k2_1024 = highres_phase(
        torch, np, dev, smi, work.name, os.path.join(work.name, "faces256.srpack"), face, tri,
        (synth_face, synth_tri), run_path, max_err, keys_of_bins, binned_cases)

    # ---- phase 4j: the binned search on the card -------------------------------
    binned_phase(torch, smi, binned_cases, run_path)
    del binned_cases

    # ---- phase 4k: the six demonstration scripts at cut sizes ------------------
    scripts_phase(torch, smi, work.name, run_path)

    # ---- phase 4l: data-parallel training over torch.distributed ---------------
    parallel_phase(torch, np, dev, smi, os.path.join(work.name, "faces256.srpack"), work.name,
                   run_path, path_launches, check_k1, (synth_face, synth_tri))

    # ---- phase 4m: spatial sharding over torch.distributed --------------------
    k1_band = spatial_phase(torch, np, dev, smi, work.name, face, tri, path_launches,
                            keys_of_bins)

    # ---- phase 5: a small forward against the CPU ----------------------------
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    small = {d: GeneratorWithMap(32, 64, 2, seed=3, device=d).eval() for d in ("cpu", "cuda")}
    sface, stri = synthetic_face(12, 24, 4, 2, device="cpu")
    gs = torch.Generator().manual_seed(4)
    svert = random_apply_pose3D(gs, sface(sface.random_input(2, gs)))
    snorm = mesh_point_normal(svert, stri)
    sz = torch.randn(2, 64, generator=gs)
    snoise = make_noise(32, 2, gs)
    res = {}
    with torch.no_grad():
        for d, m in small.items():
            img, _, nm = m([sz.to(d)], (svert.to(d), snorm.to(d), stri.to(d)),
                           noise=[n.to(d) for n in snoise], return_normals=True)
            res[d] = (img.cpu(), [x.cpu() for x in nm])
    # the evaluation layer at a small size: the unconditioned Generator
    # (explicit noise), the FID network's pool3 (64 px resized to 299) and
    # LPIPS VGG16 at 64 px, with its gradient through a flat image
    from stylerenderer_tpu_torch.eval import load_lpips, load_patched_inception_v3
    from stylerenderer_tpu_torch.models import Generator

    ge = torch.Generator().manual_seed(6)
    ez = torch.randn(2, 32, generator=ge)
    enoise = make_noise(16, 2, ge)
    ex = torch.rand(2, 3, 64, 64, generator=ge) * 2 - 1
    ey = torch.rand(2, 3, 64, 64, generator=ge) * 2 - 1
    for d in ("cpu", "cuda"):
        with torch.no_grad():
            eg = Generator(16, 32, 2, channel_multiplier=1, seed=3, device=d).eval()
            res[f"generator {d}"] = eg([ez.to(d)], noise=[n.to(d) for n in enoise])[0].cpu()
            res[f"inception {d}"] = load_patched_inception_v3(device=d)(ex.to(d)).cpu()
        lp = load_lpips("vgg", device=d)
        flat = torch.full_like(ex, -0.6, device=d).requires_grad_(True)
        dist = lp(flat, ey.to(d))
        res[f"lpips {d}"] = torch.cat([lp(ex.to(d), ey.to(d)).detach(), dist.detach()]).cpu()
        res[f"lpips grad {d}"] = torch.autograd.grad(dist.sum(), flat)[0].cpu()
    torch.backends.cudnn.allow_tf32 = True
    for a, b in zip(res["cuda"][1], res["cpu"][1]):
        if not bool((a == b).all()):
            raise AssertionError("small forward: normal maps differ between card and CPU")
    img_err = float((res["cuda"][0] - res["cpu"][0]).abs().max())
    torch.testing.assert_close(res["cuda"][0], res["cpu"][0], rtol=1e-4, atol=1e-4)
    log(f"check: GeneratorWithMap(32, 64, 2) f32 (TF32 off) on the card vs the CPU: normal "
        f"maps equal, image max |diff| {img_err:.3e} (tolerance 1e-4)")
    err = {k: float((res[f"{k} cuda"] - res[f"{k} cpu"]).abs().max())
           for k in ("generator", "inception", "lpips", "lpips grad")}
    scale = {k: float(res[f"{k} cpu"].abs().max()) for k in err}
    torch.testing.assert_close(res["generator cuda"], res["generator cpu"], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(res["lpips cuda"], res["lpips cpu"], rtol=1e-4, atol=0)
    if not err["inception"] <= 1e-3 * scale["inception"]:
        raise AssertionError(f"Inception pool3: card vs CPU {err['inception']:.3e} of "
                             f"{scale['inception']:.3e}")
    if not (bool(torch.isfinite(res["lpips grad cuda"]).all())
            and err["lpips grad"] <= 1e-4 * scale["lpips grad"]):
        raise AssertionError(f"LPIPS gradient on a flat image: card vs CPU {err['lpips grad']}")
    log(f"check: (TF32 off, card vs CPU) Generator(16, 32, 2) image max |diff| "
        f"{err['generator']:.3e} (tolerance 1e-4); InceptionV3 pool3, 64 px resized to 299, "
        f"max |diff| {err['inception']:.3e} of max |feature| {scale['inception']:.3e} "
        f"(tolerance 1e-3 of it); LPIPS VGG16 at 64 px max |diff| {err['lpips']:.3e} of "
        f"{scale['lpips']:.3e} (rtol 1e-4), its gradient through a flat image finite, max "
        f"|diff| {err['lpips grad']:.3e} of {scale['lpips grad']:.3e} (tolerance 1e-4 of it)")

    # ---- phase 6: the generation CLI ------------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        paths, counts = run_path("cli", lambda: generate_main([
            "--with_map", "--size", "256", "--sample", "4", "--pics", "1", "--out", tmp,
            "--save_normals"]))
        cli_s = time.perf_counter() - t0
        if raster(counts) != {"rasterize_multi": 1, "rasterize_single": 0}:
            raise AssertionError(f"the CLI's forward launched {counts}")
        size = os.path.getsize(paths[0])
        with open(paths[0], "rb") as f:
            if f.read(8) != b"\x89PNG\r\n\x1a\n":
                raise AssertionError("the CLI wrote no PNG")
    log(f"cli: generate --with_map --size 256 --sample 4 --pics 1: {cli_s:.1f} s, "
        f"PNG {size} bytes")

    # ---- phase 6, continued: both CLIs on the training phase's checkpoint -----
    from stylerenderer_tpu_torch.cli.project import main as project_main
    from stylerenderer_tpu_torch.utils.image import to_uint8, write_png

    ckpt = os.path.join(work.name, "train", "checkpoint")
    with tempfile.TemporaryDirectory() as tmp:
        pngs = []
        for i, img in enumerate(photos):
            pngs.append(os.path.join(tmp, f"photo{i}.png"))
            write_png(pngs[-1], to_uint8(img))
        out_dir = os.path.join(tmp, "recon")
        t0 = time.perf_counter()
        _, counts = run_path("cli project", lambda: project_main(
            pngs + ["--ckpt", ckpt, "--iters", "10", "--segments", "2", "--out", out_dir]))
        cli_s = time.perf_counter() - t0
        if raster(counts) != {"rasterize_multi": 10 + 2, "rasterize_single": 0}:
            raise AssertionError(f"cli project: launches {counts}")
        names = sorted(os.listdir(out_dir))
        if names != ["fit.npz", "mesh_000.obj", "mesh_001.obj", "render.png", "target.png"]:
            raise AssertionError(f"cli project wrote {names}")
        fit = np.load(os.path.join(out_dir, "fit.npz"))
        hist = fit["loss_history"]
        if hist.shape != (10,) or not np.isfinite(hist).all():
            raise AssertionError(f"cli project: loss history {hist}")
        log(f"cli: project --ckpt (the training phase's step {TRAIN_STEPS}) on 2 PNGs, "
            f"--iters 10 --segments 2: {cli_s:.1f} s, launches {counts}, loss {hist[0]:.5f} -> "
            f"{hist[-1]:.5f}, wrote {names}")
        t0 = time.perf_counter()
        paths, counts = run_path("cli generate --ckpt", lambda: generate_main([
            "--with_map", "--size", "256", "--sample", "4", "--pics", "1", "--ckpt", ckpt,
            "--out", os.path.join(tmp, "gen")]))
        if raster(counts) != {"rasterize_multi": 1, "rasterize_single": 0}:
            raise AssertionError(f"cli generate --ckpt: launches {counts}")
        with open(paths[0], "rb") as f:
            if f.read(8) != b"\x89PNG\r\n\x1a\n":
                raise AssertionError("cli generate --ckpt wrote no PNG")
        log(f"cli: generate --with_map --ckpt: {time.perf_counter() - t0:.1f} s, launches "
            f"{counts}")
    work.cleanup()

    # ---- phase 7: the result ------------------------------------------------
    log(f"launches by path: {json.dumps(path_launches)}")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    main_paths = ("each", "synth", "train", "downsample_fused=True", "downsample_fused=False",
                  "render_mean_face") + tuple(
        f"inversion {m}{'' if f else ' unfused'} B={b}" for m, f, b in INV_RUNS) + (
        "eval fid", "eval ppl", f"eval lpips inversion each B={LPIPS_INV_BATCH}",
        "regressor train", f"regressor inversion each B={REG_INV_BATCH}", "train heads",
        "bfm render_mean_face", "FaceWarehouse each", "FLAME each", "pipeline photos",
        "pipeline align", "pipeline align render_ref", "pipeline prepare raw",
        "pipeline prepare jpeg", "pipeline train bfm folder", "pipeline train bfm jpeg shard",
        "pipeline generate bfm", "pipeline project bfm", "pipeline fid bfm", "pipeline ppl bfm",
        "1024 each", "1024 downsample", "1024 downsample unfused", "cli generate 1024",
        "cli generate 1024 truncation", "cli generate 1024 generator", "train bf16", "train ada",
        "binned auto cuda") + tuple(f"script {name}" for name in SCRIPTS) + (
        "parallel none", "parallel nccl", "parallel gloo rank 0", "parallel gloo rank 1") + tuple(
        f"spatial rank {r}" for r in range(4))

    def launches(name):
        return sum(path_launches[p][name] for p in main_paths)

    log(json.dumps({"kernels": [{
        "name": "rasterize_multi",
        "route": "cuda",
        "source": "stylerenderer_tpu_torch/csrc/rasterize_multi.cu",
        "replaces": "stylerenderer_tpu/ops/rasterize_pallas.py:799",
        "launches": launches("rasterize_multi"),
        "max_abs_err": max_err["rasterize_multi"],
        "ms": k1["ms"],
        "plain_ms": k1_plain_ms,
        "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"],
        "library_ms": None,
        "bins_ms": k1["bins_ms"],
        "ms_top1024": k1_1024["ms"],
        "bound_ms_top1024": k1_1024["bound_ms"],
        "plain_ms_top1024_training_mesh_b1": k1_1024["plain_ms"],
    }, {
        "name": "rasterize_multi_band",
        "route": "cuda",
        "source": "stylerenderer_tpu_torch/csrc/rasterize_multi.cu",
        "replaces": "stylerenderer_tpu/ops/rasterize_pallas.py:799",
        "launches": k1_band["launches"],
        "max_abs_err": k1_band["max_abs_err"],
        "ms": k1_band["ms"],
        "plain_ms": k1_band["plain_ms"],
        "bound_ms": k1_band["bound_ms"],
        "bound_by": k1_band["bound_by"],
        "library_ms": None,
        "bins_ms": k1_band["bins_ms"],
        "band": k1_band["band"],
    }, {
        "name": "rasterize_single",
        "route": "cuda",
        "source": "stylerenderer_tpu_torch/csrc/rasterize_single.cu",
        "replaces": "stylerenderer_tpu/ops/rasterize_pallas.py:364",
        "launches": launches("rasterize_single"),
        "max_abs_err": max_err["rasterize_single"],
        "ms": k2["ms"],
        "plain_ms": k2_plain_ms,
        "bound_ms": k2b_ms,
        "bound_by": k2_by,
        "library_ms": None,
        "bins_ms": k2["bins_ms"],
        "plain_bins_ms": k2["plain_bins_ms"],
        "ms_1024": k2_1024["ms"],
        "bound_ms_1024": k2_1024["bound_ms"],
        "plain_ms_1024_image0": k2_1024["plain_ms_image0"],
    }, {
        "name": "fused_bias_act",
        "route": "cuda",
        "source": "stylerenderer_tpu_torch/csrc/fused_act.cu",
        "replaces": "stylerenderer_tpu/ops/fused_act.py (left to XLA)",
        "launches": launches("fused_bias_act"),
        "max_abs_err": ep["max_abs_err"],
        "ms": ep["ms"],
        "plain_ms": ep["plain_ms"],
        "bound_ms": ep["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "ms_512": ep["ms_512"],
        "plain_ms_512": ep["plain_ms_512"],
        "bound_ms_512": ep["bound_ms_512"],
    }, {
        "name": "upfirdn2d",
        "route": "cuda",
        "source": "stylerenderer_tpu_torch/csrc/upfirdn2d.cu",
        "replaces": "stylerenderer_tpu/ops/upfirdn2d.py (left to XLA)",
        "launches": launches("upfirdn2d"),
        "max_abs_err": ufd["max_abs_err"],
        "ms": ufd["ms"],
        "forward_ms": ufd["forward_ms"],
        "plain_ms": ufd["plain_ms"],
        "bound_ms": ufd["bound_ms"],
        "bound_by": "bytes",
        "library_ms": ufd["library_ms"],
        "ms_256": ufd["ms_256"],
        "forward_ms_256": ufd["forward_ms_256"],
        "plain_ms_256": ufd["plain_ms_256"],
        "bound_ms_256": ufd["bound_ms_256"],
        "library_ms_256": ufd["library_ms_256"],
    }]}))
    log(f"nvidia-smi: {smi}")
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

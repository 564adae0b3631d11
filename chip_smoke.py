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
- the generation CLI, and both CLIs (``generate``, ``project``) on the
  training phase's checkpoint (``--ckpt``).

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


def bbox_pairs(torch, dat, n_valid, h, w, n_levels):
    """(pixel, triangle) pairs whose clamped bbox at each level holds the
    pixel, over the valid rows of binned triangles (corner px, py at the
    top level in columns 0-5)."""
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
            y0 = torch.clamp(torch.ceil(qy.amin(-1)), min=0.0)
            y1 = torch.clamp(torch.floor(qy.amax(-1)), max=hl - 1.0)
            n = torch.clamp(x1 - x0 + 1, min=0) * torch.clamp(y1 - y0 + 1, min=0)
            pairs += int(n.double().sum())
    return pairs


def bound(nbytes: int, ops: int):
    """(bound_ms, bound_by): the larger of the byte and operation times."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def k1_bound(torch, dat, starts, top, n_levels, n_attr):
    """Least time for K1's work on these inputs: (bound_ms, bound_by, bytes,
    operations, pairs, valid triangles). Bytes: the rows of the valid
    binned triangles (data and id) read once, the segment starts, and the
    maps written once; invalid triangles are sorted past every tile's
    segments and never read. Operations: the candidate math for every
    (pixel, triangle) pair whose clamped bbox at that level holds the
    pixel, plus one setup per (valid triangle, level)."""
    B, nf, R = dat.shape
    pixels = B * sum((top >> k) ** 2 for k in range(n_levels))
    n_valid = starts[:, -1].long()  # invalid triangles sort past the last key
    nbytes = (int(n_valid.sum()) * (R + 1) * 4 + starts.numel() * 4
              + pixels * 4 * (1 + n_attr))
    pairs = bbox_pairs(torch, dat, n_valid, top, top, n_levels)
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


def k1_measure(torch, np, vert, tri, n_levels, norm, keys_of_bins):
    """K1 at these shapes (top TOP, tile TILE, values of ``norm`` or
    winners only): the card's binning held against the plain binning (keys
    and starts equal), then timed with CUDA events over many launches
    after a warm-up: the plain binning, the card's binning (its launches
    replayed from a CUDA graph, and per call with the host in the loop),
    the kernel; the bound from the plain binning's output; the kernel's
    launch shape (threads, shared memory, registers, spills, resident
    blocks per SM)."""
    import ctypes

    from stylerenderer_tpu_torch.ops import _build
    from stylerenderer_tpu_torch.ops.rasterize_multi import (
        build_bins_multi, launch_bin_multi, launch_rasterize_multi,
    )

    n_attr = 0 if norm is None else norm.shape[-1]
    dat, ids, starts = build_bins_multi(vert, tri, TOP, n_levels, False, EPS, TILE, attrs=norm)
    rows, cstarts, slots, keys = launch_bin_multi(vert, tri, TOP, n_levels, False, EPS, TILE,
                                                  attrs=norm)
    if not torch.equal(cstarts, starts):
        raise AssertionError(f"K1 {n_levels} levels: the card's starts differ from the plain "
                             "binning's")
    want = keys_of_bins(ids.cpu().numpy(), starts.cpu().numpy())
    if not np.array_equal(keys.cpu().numpy(), want):
        raise AssertionError(f"K1 {n_levels} levels: the card's keys differ from the plain "
                             "binning's")
    plain_bins_ms = cuda_ms(torch, lambda: build_bins_multi(vert, tri, TOP, n_levels, False,
                                                            EPS, TILE, attrs=norm), 5)
    def bin_multi():
        return launch_bin_multi(vert, tri, TOP, n_levels, False, EPS, TILE, attrs=norm)
    bins_ms = graph_ms(torch, bin_multi, 50)
    bins_call_ms = cuda_ms(torch, bin_multi, 50)
    ms = cuda_ms(torch, lambda: launch_rasterize_multi(rows, cstarts, slots, TOP, n_levels, TILE,
                                                       n_attr, False, EPS), 50)
    bound_ms, by, nbytes, ops, pairs, n_valid = k1_bound(torch, dat, starts, TOP, n_levels,
                                                         n_attr)
    shape = (ctypes.c_int * 6)()
    rc = _build.library("multi").sr_rasterize_multi_shape(TOP, n_levels, TILE, n_attr, shape)
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


def train_phase(torch, np, dev, shard, out, run_path, face, tri, check_k1):
    """GAR training on ``shard`` through the CLI, then each kind of step
    timed, counted and profiled alone; fails loudly on any check."""
    from stylerenderer_tpu_torch.cli.train import main as train_main
    from stylerenderer_tpu_torch.data import SRPackDataset, to_train_tensor
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
    if counts != want:
        raise AssertionError(f"train path: launches {counts}, expected {want}")
    with open(os.path.join(out, "logs", "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    if [r["step"] for r in rows] != list(range(TRAIN_STEPS)):
        raise AssertionError(f"train path: logged steps {[r['step'] for r in rows]}")
    for r, kind in zip(rows, kinds):
        if not all(np.isfinite(v) for v in r.values()) or r["nonfinite_steps"] != 0:
            raise AssertionError(f"train path: step {r['step']}: {r}")
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

    # each kind of step alone, on the trained state: timed (host clock,
    # each step ends in its finite-flag sync), counted, profiled
    cfg = TrainConfig(batch=BATCH, d_reg_every=16, g_reg_every=4)
    ds = SRPackDataset(shard, 256)
    real = to_train_tensor(ds.read_batch(np.arange(BATCH)), np.random.default_rng(0)).to(dev)
    ds.reader.close()
    step_ms = {}
    for kind, at in STEP_KINDS.items():
        def one(at=at):
            state.step = at
            draws = sample_draws(state.generator, cfg, face, BATCH, state.g.n_latent)
            return train_step(state, real, draws, cfg, face, tri)

        one()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(TRAIN_REPS):
            one()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / TRAIN_REPS
        kind_peak = torch.cuda.max_memory_allocated()
        _, counts = run_path(f"train step, {kind}", one)
        n_k1 = 2 if kind == "plain" else 3
        if counts != {"rasterize_multi": n_k1, "rasterize_single": 0}:
            raise AssertionError(f"train step ({kind}): launches {counts}")
        prof = profile_step(torch, one)
        wall, busy, n_events = prof["wall_ms"], prof["busy_ms"], prof["events"]
        k1_ms = prof["kernel_ms"] + prof["bins_ms"]
        if state.nonfinite_count:
            raise AssertionError(f"train step ({kind}): {state.nonfinite_count} non-finite steps")
        step_ms[kind] = ms
        k1_share = f"{k1_ms / busy:.4f}" if busy else "not measured"
        log(f"train step, {kind}: {ms:.1f} ms (host clock, mean of {TRAIN_REPS}), "
            f"{BATCH * 1e3 / ms:.1f} images/s; peak memory {kind_peak / 2 ** 30:.2f} GiB; "
            f"K1 launches {n_k1}; profiled once: device busy {busy:.1f} ms of {wall:.1f} ms "
            f"host clock (idle share {1 - busy / wall:.3f}), {n_events} device events, K1 and "
            f"its binning {k1_ms:.3f} ms of device time (share {k1_share})")
        for t, n, name in prof["by_op"]:
            log(f"    {t:9.3f} ms  {t / busy:6.1%}  {n:5d} calls  {name}")
    # what the finite screen costs a plain step (the copy it restores from,
    # the max-abs norms and the one host synchronisation): the same steps
    # with it taken out, in turns with it in
    import stylerenderer_tpu_torch.train.step as step_mod

    screen = (step_mod._take_backup, step_mod.all_finite)

    def plain_ms(with_screen):
        if not with_screen:
            step_mod._take_backup, step_mod.all_finite = (lambda st: [],
                                                          lambda values, tensors: True)
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
        if counts != want:
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
    if (out != stats or counts != none or mu.shape != (2048,) or cov.shape != (2048, 2048)
            or not (np.isfinite(mu).all() and np.isfinite(cov).all())):
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
    if counts != {"rasterize_multi": n_batches, "rasterize_single": 0}:
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
    if counts != want or not np.isfinite(ppl):
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
    if counts != want:
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
    if counts != none or any(tuple(i.shape) != (BATCH, 3, 256, 256)
                             or not bool(torch.isfinite(i).all()) for i in images):
        raise AssertionError(f"generator: launches {counts} or bad images")
    del images, gen
    with tempfile.TemporaryDirectory() as tmp:
        paths, counts = run_path("eval cli generate", lambda: generate_main([
            "--size", "256", "--sample", "4", "--pics", "1", "--out", tmp]))
        with open(paths[0], "rb") as f:
            if counts != none or f.read(8) != b"\x89PNG\r\n\x1a\n":
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
    from stylerenderer_tpu_torch.data import SRPackDataset, to_train_tensor
    from stylerenderer_tpu_torch.inversion import ProjectorConfig, make_projector
    from stylerenderer_tpu_torch.models import GeneratorWithMap, Regressor
    from stylerenderer_tpu_torch.supervisors import (
        InceptionResnetV1, PFLDInference, ResNetUNet, make_extra_heads, random_stand_in_,
    )
    from stylerenderer_tpu_torch.train import (
        init_regressor_state, make_regressor_fn, regressor_step, sample_draws,
        sample_regressor_batch, train_step,
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
    if counts != {"rasterize_multi": REG_STEPS, "rasterize_single": 0}:
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
    if counts != {"rasterize_multi": INV_ITERS + 1, "rasterize_single": 0}:
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
    if counts != want:
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
    ds = SRPackDataset(shard, 256)
    real = to_train_tensor(ds.read_batch(np.arange(BATCH)), np.random.default_rng(0)).to(dev)
    ds.reader.close()
    for kind, at in STEP_KINDS.items():
        def one(at=at):
            tstate.step = at
            draws = sample_draws(tstate.generator, tcfg, synth_mesh[0], BATCH,
                                 tstate.g.n_latent, heads)
            return train_step(tstate, real, draws, tcfg, *synth_mesh, heads)

        one()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(TRAIN_REPS):
            m = one()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / TRAIN_REPS
        kind_peak = torch.cuda.max_memory_allocated()
        _, counts = run_path(f"train heads step, {kind}", one)
        n_k1 = 2 if kind == "plain" else 3
        if counts != {"rasterize_multi": n_k1, "rasterize_single": 0} or tstate.nonfinite_count:
            raise AssertionError(f"train heads step ({kind}): launches {counts}, "
                                 f"{tstate.nonfinite_count} non-finite steps")
        log(f"train heads step, {kind}: {ms:.1f} ms (host clock, mean of {TRAIN_REPS}), "
            f"{BATCH * 1e3 / ms:.1f} images/s, against {plain_step_ms[kind]:.1f} ms without "
            f"the heads (phase 4a); peak memory {kind_peak / 2 ** 30:.2f} GiB; K1 launches "
            f"{n_k1}; sfs {float(m['sfs']):.5f}, feature {float(m['feature']):.6f}, lmk "
            f"{float(m['lmk']):.5f}")
    log(f"phase 4g: {time.perf_counter() - t_phase:.1f} s; {smi}")


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
    from stylerenderer_tpu_torch.ops import _build
    from stylerenderer_tpu_torch.ops.rasterize import rasterize
    from stylerenderer_tpu_torch.ops.resize import resize_linear
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
               "rasterize_single": rasterize_winners_single}
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
    if counts != {"rasterize_multi": FORWARDS, "rasterize_single": 0}:
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
        if n != SYNTH_IMAGES or counts != {"rasterize_multi": 0, "rasterize_single": n_batches}:
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
            if counts != want:
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
    if counts != {"rasterize_multi": 0, "rasterize_single": 1}:
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
        if counts != {"rasterize_multi": 1, "rasterize_single": 0}:
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
        if counts != {"rasterize_multi": 10 + 2, "rasterize_single": 0}:
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
        if counts != {"rasterize_multi": 1, "rasterize_single": 0}:
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
        "regressor train", f"regressor inversion each B={REG_INV_BATCH}", "train heads")

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
    }]}))
    log(f"nvidia-smi: {smi}")
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

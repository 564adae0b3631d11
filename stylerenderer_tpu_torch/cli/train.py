"""Training CLI (counterpart of ``stylerenderer_tpu/cli/train.py``):
adversarial training of the GAR with lazy R1 and path-length
regularization, ADA, EMA, checkpoints, the finite guard and periodic
sample grids, on one card (or the CPU with ``--device cpu``) or across
ranks.

    python -m stylerenderer_tpu_torch.cli.train DATA [--bfm BFM.mat --size 256 --batch 16 ...]

``DATA`` is an SRPack shard (raw or JPEG, ``cli.prepare_data``) or a
folder of images, resized as they are read. The mesh condition is the BFM
of ``--bfm`` or, without it, ``synthetic_face(48, 96, 80, 29)`` (9,024
triangles). ``--sfs``, ``--lmk`` and ``--feat`` add the frozen supervisor
heads' terms to the G step (``supervisors/hub.py``; fixed-seed random
stand-ins drawn from ``seed + 1``, as the JAX trainer's).
``--profile_steps N`` traces steps ``start + 1`` to ``start + N`` (the
first step, with its warm-up, is left out, as in the JAX trainer) with
``torch.profiler`` and writes ``profile/trace.json`` (Chrome trace format)
under ``--out_dir``. Each logged row of ``logs/metrics.jsonl`` carries
the step's metrics and ``step_ms``, its host-clock time (the step ends in
one host synchronisation, reading its finite flag).

Across ranks, one process per card:

    python -m torch.distributed.run --nproc_per_node W -m stylerenderer_tpu_torch.cli.train DATA --batch 16 ...

``--batch`` is the global batch, as in the JAX trainer: W must divide it
and the path batch (``batch // path_batch_shrink``), or the run raises.
``--device`` names the device type; rank ``r`` takes ``cuda:LOCAL_RANK``
(NCCL), or the CPU (gloo). The seed is rank 0's; the state is broadcast
from rank 0 after it is made or loaded. Every rank reads only its rows
``[r B/W, (r+1) B/W)`` of each global batch (the same shuffle and flips
on every rank) and draws the whole step's draws from the replicated
generator; the step (``train/step.py``) gathers, reduces and averages so
that its losses, metrics and updates are those of the global batch. Rank
0 alone writes the sample grids, the logs, the profiler trace and the
checkpoints (every rank waits for each checkpoint and can restore from
it). Without a launcher the run is one process with no group.
"""

from __future__ import annotations

import argparse
import os
import time

import torch


def build_argparser():
    p = argparse.ArgumentParser(description="StyleRenderer trainer (PyTorch)")
    p.add_argument("path", type=str, help="SRPack shard or image folder")
    p.add_argument("--iter", type=int, default=800_000)
    p.add_argument("--bfm", type=str, default="", help="BFM .mat (else the synthetic face)")
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--n_sample", type=int, default=64)
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--latent", type=int, default=512)
    p.add_argument("--n_mlp", type=int, default=8)
    p.add_argument("--r1", type=float, default=10.0)
    p.add_argument("--path_regularize", type=float, default=2.0)
    p.add_argument("--path_batch_shrink", type=int, default=2)
    p.add_argument("--d_reg_every", type=int, default=16)
    p.add_argument("--g_reg_every", type=int, default=4)
    p.add_argument("--mixing", type=float, default=0.9)
    p.add_argument("--ckpt", type=str, default="", help="checkpoint directory to resume from")
    p.add_argument("--lr", type=float, default=0.002)
    p.add_argument("--channel_multiplier", type=int, default=2)
    p.add_argument("--wandb", action="store_true")
    p.add_argument("--augment", action="store_true")
    p.add_argument("--augment_p", type=float, default=0.0)
    p.add_argument("--ada_target", type=float, default=0.6)
    p.add_argument("--ada_length", type=int, default=500_000)
    p.add_argument("--ada_every", type=int, default=256)
    p.add_argument("--seed", type=int, default=-1)
    p.add_argument("--out_dir", type=str, default=".")
    p.add_argument("--ckpt_every", type=int, default=10_000)
    p.add_argument("--ckpt_keep", type=int, default=5, help="checkpoints retained")
    p.add_argument("--sample_every", type=int, default=100)
    p.add_argument("--log_every", type=int, default=10)
    p.add_argument("--compute_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--pyramid_mode", type=str, default="each", choices=["each", "downsample"])
    p.add_argument("--sfs", action="store_true",
                   help="shape-from-shading consistency head (weight 0.01)")
    p.add_argument("--lmk", action="store_true",
                   help="landmark consistency head on geometry-paired samples (weight 1e-5)")
    p.add_argument("--feat", action="store_true",
                   help="identity consistency head on shape-paired samples (weight 0.001)")
    p.add_argument("--profile_steps", type=int, default=0,
                   help="write a torch.profiler trace of steps 2..N+1 to OUT_DIR/profile")
    p.add_argument("--device", type=str, default="cuda")
    return p


def main(argv=None):
    args = build_argparser().parse_args(argv)

    from stylerenderer_tpu_torch.parallel import make_mesh

    mesh = make_mesh(args.device)
    try:
        return _train(args, mesh)
    finally:
        mesh.destroy()


def _train(args, mesh):
    from stylerenderer_tpu_torch.data import device_prefetch, open_dataset, prefetch_batches
    from stylerenderer_tpu_torch.face3d import (
        load_face_model, mesh_point_normal, random_apply_pose3D,
    )
    from stylerenderer_tpu_torch.models import make_noise
    from stylerenderer_tpu_torch.parallel import constrain_batch, replicate, replicated
    from stylerenderer_tpu_torch.supervisors import make_extra_heads
    from stylerenderer_tpu_torch.train import init_train_state, run_step
    from stylerenderer_tpu_torch.train.step import path_batch_size
    from stylerenderer_tpu_torch.utils.checkpoint import (
        latest_step, load_checkpoint, save_checkpoint,
    )
    from stylerenderer_tpu_torch.utils.config import TrainConfig
    from stylerenderer_tpu_torch.utils.guards import TrainGuard
    from stylerenderer_tpu_torch.utils.image import save_image_grid
    from stylerenderer_tpu_torch.utils.logging import (
        MetricsLogger, StepTimer, start_profiler_trace, stop_profiler_trace,
    )

    def say(*a, **kw):
        if mesh.is_main:
            print(*a, **kw)

    device = mesh.device
    seed = args.seed if args.seed >= 0 else int(time.time())
    seed = int(replicated(mesh, [torch.tensor([seed])])[0])
    cfg = TrainConfig(
        size=args.size, latent=args.latent, n_mlp=args.n_mlp,
        channel_multiplier=args.channel_multiplier, iter=args.iter,
        batch=args.batch, lr=args.lr, r1=args.r1,
        path_regularize=args.path_regularize,
        path_batch_shrink=args.path_batch_shrink,
        d_reg_every=args.d_reg_every, g_reg_every=args.g_reg_every,
        mixing=args.mixing, augment=args.augment, augment_p=args.augment_p,
        ada_target=args.ada_target, ada_length=args.ada_length,
        ada_every=args.ada_every, n_sample=args.n_sample, seed=seed,
        compute_dtype=args.compute_dtype, pyramid_mode=args.pyramid_mode,
    )
    for what, n in (("batch", cfg.batch), ("path batch", path_batch_size(cfg, cfg.batch))):
        if n % mesh.world:
            raise ValueError(f"{what} {n} not divisible by {mesh.world} ranks")

    dataset = open_dataset(args.path, resolution=cfg.size)
    say(f"dataset: {len(dataset)} images at {cfg.size}px")
    face, tri = load_face_model(args.bfm, device=device)
    state = init_train_state(cfg, device, seed)
    heads = make_extra_heads(cfg.seed + 1, sfs=args.sfs, lmk=args.lmk, feat=args.feat,
                             image_size=cfg.size, device=device)
    start_iter = 0
    ckpt_dir = os.path.join(args.out_dir, "checkpoint")
    if args.ckpt:
        state, _ = load_checkpoint(args.ckpt, state)
        start_iter = state.step
        say(f"resumed from {args.ckpt} at step {start_iter}")
    replicate(mesh, state)

    batches = prefetch_batches(dataset, cfg.batch, seed=seed,
                               pin_memory=device.type == "cuda", rows=mesh.rows(cfg.batch))
    loader = device_prefetch(batches, device)

    # the fixed evaluation set: latents, posed meshes and noise
    gs = torch.Generator().manual_seed(seed)
    sample_z = torch.randn(cfg.n_sample, cfg.latent, generator=gs).to(device)
    sample_v = random_apply_pose3D(gs, face(face.random_input(cfg.n_sample, gs)))
    sample_mesh = (sample_v, mesh_point_normal(sample_v, tri), tri)
    sample_noise = make_noise(cfg.size, cfg.n_sample, torch.Generator().manual_seed(0), device)

    logger = MetricsLogger(os.path.join(args.out_dir, "logs"), args.wandb, rank=mesh.rank)
    timer = StepTimer()
    if mesh.is_main:
        os.makedirs(os.path.join(args.out_dir, "sample"), exist_ok=True)

    def restore_latest():
        if latest_step(ckpt_dir) is None:
            raise RuntimeError("non-finite training metrics and no checkpoint to restore from")
        load_checkpoint(ckpt_dir, state)
        say("guard: restored from latest checkpoint")
        return state

    guard = TrainGuard(restore_fn=restore_latest)
    tracing = False
    try:
        for i in range(start_iter, cfg.iter):
            if args.profile_steps and i == start_iter + 1 and mesh.is_main:
                start_profiler_trace(os.path.join(args.out_dir, "profile"))
                tracing = True
            real = constrain_batch(next(loader), mesh, cfg.batch)
            t0 = time.perf_counter()
            # the step discards a non-finite update itself; the guard only
            # escalates to a checkpoint restore
            metrics, _ = run_step(state, real, cfg, face, tri, heads, mesh)
            step_ms = (time.perf_counter() - t0) * 1e3
            timer.tick()
            if tracing and i == start_iter + args.profile_steps:
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                print(f"profile: {stop_profiler_trace()}")
                tracing = False
            if i % args.log_every == 0:
                m = {k: float(v) for k, v in metrics.items()}
                guard.check(i, state, m, state)
                m["step_ms"] = step_ms
                m["imgs_per_sec"] = timer.images_per_sec(cfg.batch)
                logger.log(i, m)
                if i % (args.log_every * 10) == 0:
                    say(f"step {i}  d {m['d']:.4f}  g {m['g']:.4f}  r1 {m['r1']:.4f}  "
                        f"path {m['path']:.4f}  ada {m['ada_p']:.3f}  {step_ms:.1f} ms  "
                        f"{m['imgs_per_sec']:.1f} img/s", flush=True)
            if (i + 1) % args.sample_every == 0 and mesh.is_main:
                with torch.no_grad():
                    img, _, norms = state.g_ema([sample_z], sample_mesh, return_normals=True,
                                                noise=sample_noise)
                save_image_grid(os.path.join(args.out_dir, "sample", f"{i:06d}.png"),
                                img.float().permute(0, 2, 3, 1).cpu().numpy())
                save_image_grid(os.path.join(args.out_dir, "sample", f"{i:06d}_norm.png"),
                                norms[-1].float().cpu().numpy())
            if (i + 1) % args.ckpt_every == 0 or (i + 1) == cfg.iter:
                save_checkpoint(ckpt_dir, i + 1, state, cfg, max_to_keep=args.ckpt_keep,
                                mesh=mesh)
    finally:
        if tracing:  # the run ended inside the window
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            print(f"profile: {stop_profiler_trace()}")
        loader.close()
        batches.close()
        logger.close()
    return state


if __name__ == "__main__":
    main()

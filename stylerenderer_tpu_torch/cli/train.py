"""Training CLI (counterpart of ``stylerenderer_tpu/cli/train.py``):
adversarial training of the GAR with lazy R1 and path-length
regularization, ADA, EMA, checkpoints, the finite guard and periodic
sample grids, on one card (or the CPU with ``--device cpu``).

    python -m stylerenderer_tpu_torch.cli.train DATA.srpack [--size 256 --batch 16 ...]

The mesh condition is the synthetic face ``synthetic_face(48, 96, 80, 29)``
(9,024 triangles). ``--sfs``, ``--lmk`` and ``--feat`` add the frozen
supervisor heads' terms to the G step (``supervisors/hub.py``; fixed-seed
random stand-ins drawn from ``seed + 1``, as the JAX trainer's). ``--bfm``
(BFM loading), ``--profile_steps`` and image-folder data are not ported
and are refused. Each logged row of ``logs/metrics.jsonl`` carries
the step's metrics and ``step_ms``, its host-clock time (the step ends in
one host synchronisation, reading its finite flag).
"""

from __future__ import annotations

import argparse
import os
import time

import torch

NOT_PORTED = {
    "bfm": "--bfm needs the BFM loader, which the port does not have yet",
    "profile_steps": "--profile_steps is not ported; wrap the run in torch.profiler instead",
}


def build_argparser():
    p = argparse.ArgumentParser(description="StyleRenderer trainer (PyTorch)")
    p.add_argument("path", type=str, help="SRPack shard (raw codec)")
    p.add_argument("--iter", type=int, default=800_000)
    p.add_argument("--bfm", type=str, default="", help="not ported")
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
    p.add_argument("--profile_steps", type=int, default=0, help="not ported")
    p.add_argument("--device", type=str, default="cuda")
    return p


def main(argv=None):
    parser = build_argparser()
    args = parser.parse_args(argv)
    for flag, why in NOT_PORTED.items():
        if getattr(args, flag):
            parser.error(why)
    if os.path.isdir(args.path):
        parser.error("image-folder data is not ported; write a raw SRPack shard "
                     "(stylerenderer_tpu_torch.data.synth, or the JAX package's prepare_data)")

    from stylerenderer_tpu_torch.data import SRPackDataset, device_prefetch, prefetch_batches
    from stylerenderer_tpu_torch.device import resolve_device
    from stylerenderer_tpu_torch.face3d import (
        mesh_point_normal, random_apply_pose3D, synthetic_face,
    )
    from stylerenderer_tpu_torch.models import make_noise
    from stylerenderer_tpu_torch.supervisors import make_extra_heads
    from stylerenderer_tpu_torch.train import init_train_state, sample_draws, train_step
    from stylerenderer_tpu_torch.utils.checkpoint import (
        latest_step, load_checkpoint, save_checkpoint,
    )
    from stylerenderer_tpu_torch.utils.config import TrainConfig
    from stylerenderer_tpu_torch.utils.guards import TrainGuard
    from stylerenderer_tpu_torch.utils.image import save_image_grid
    from stylerenderer_tpu_torch.utils.logging import MetricsLogger, StepTimer

    device = resolve_device(args.device)
    seed = args.seed if args.seed >= 0 else int(time.time())
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

    dataset = SRPackDataset(args.path, resolution=cfg.size)
    print(f"dataset: {len(dataset)} images at {cfg.size}px")
    face, tri = synthetic_face(48, 96, 80, 29, device=device)
    state = init_train_state(cfg, device, seed)
    heads = make_extra_heads(cfg.seed + 1, sfs=args.sfs, lmk=args.lmk, feat=args.feat,
                             image_size=cfg.size, device=device)
    start_iter = 0
    ckpt_dir = os.path.join(args.out_dir, "checkpoint")
    if args.ckpt:
        state, _ = load_checkpoint(args.ckpt, state)
        start_iter = state.step
        print(f"resumed from {args.ckpt} at step {start_iter}")

    batches = prefetch_batches(dataset, cfg.batch, seed=seed,
                               pin_memory=device.type == "cuda")
    loader = device_prefetch(batches, device)

    # the fixed evaluation set: latents, posed meshes and noise
    gs = torch.Generator().manual_seed(seed)
    sample_z = torch.randn(cfg.n_sample, cfg.latent, generator=gs).to(device)
    sample_v = random_apply_pose3D(gs, face(face.random_input(cfg.n_sample, gs)))
    sample_mesh = (sample_v, mesh_point_normal(sample_v, tri), tri)
    sample_noise = make_noise(cfg.size, cfg.n_sample, torch.Generator().manual_seed(0), device)

    logger = MetricsLogger(os.path.join(args.out_dir, "logs"), args.wandb)
    timer = StepTimer()
    os.makedirs(os.path.join(args.out_dir, "sample"), exist_ok=True)

    def restore_latest():
        if latest_step(ckpt_dir) is None:
            raise RuntimeError("non-finite training metrics and no checkpoint to restore from")
        load_checkpoint(ckpt_dir, state)
        print("guard: restored from latest checkpoint")
        return state

    guard = TrainGuard(restore_fn=restore_latest)
    try:
        for i in range(start_iter, cfg.iter):
            real = next(loader)
            t0 = time.perf_counter()
            draws = sample_draws(state.generator, cfg, face, real.shape[0], state.g.n_latent,
                                 heads)
            # the step discards a non-finite update itself; the guard only
            # escalates to a checkpoint restore
            metrics = train_step(state, real, draws, cfg, face, tri, heads)
            step_ms = (time.perf_counter() - t0) * 1e3
            timer.tick()
            if i % args.log_every == 0:
                m = {k: float(v) for k, v in metrics.items()}
                guard.check(i, state, m, state)
                m["step_ms"] = step_ms
                m["imgs_per_sec"] = timer.images_per_sec(cfg.batch)
                logger.log(i, m)
                if i % (args.log_every * 10) == 0:
                    print(f"step {i}  d {m['d']:.4f}  g {m['g']:.4f}  r1 {m['r1']:.4f}  "
                          f"path {m['path']:.4f}  ada {m['ada_p']:.3f}  {step_ms:.1f} ms  "
                          f"{m['imgs_per_sec']:.1f} img/s", flush=True)
            if (i + 1) % args.sample_every == 0:
                with torch.no_grad():
                    img, _, norms = state.g_ema([sample_z], sample_mesh, return_normals=True,
                                                noise=sample_noise)
                save_image_grid(os.path.join(args.out_dir, "sample", f"{i:06d}.png"),
                                img.float().permute(0, 2, 3, 1).cpu().numpy())
                save_image_grid(os.path.join(args.out_dir, "sample", f"{i:06d}_norm.png"),
                                norms[-1].float().cpu().numpy())
            if (i + 1) % args.ckpt_every == 0 or (i + 1) == cfg.iter:
                save_checkpoint(ckpt_dir, i + 1, state, cfg, max_to_keep=args.ckpt_keep)
    finally:
        loader.close()
        batches.close()
        logger.close()
    return state


if __name__ == "__main__":
    main()

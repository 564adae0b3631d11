"""Generation CLI: sample image grids from the generator or the GAR.

python -m stylerenderer_tpu_torch.cli.generate --size 256 --sample 4 \\
    --pics 1 [--with_map [--save_normals]] [--ckpt CKPT_DIR] \\
    [--truncation 0.7] [--out DIR] [--device cuda|cpu]

Renders through the unconditioned ``Generator`` or, with ``--with_map``,
through ``GeneratorWithMap`` conditioned on the synthetic face mesh, posed
at random, with the weights of a checkpoint (``g_ema``, else ``g``, loaded
strictly) or, without ``--ckpt``, random ones. Runs on the card unless
``--device cpu``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def build_argparser():
    p = argparse.ArgumentParser(description="StyleRenderer generator (PyTorch)")
    p.add_argument("--size", type=int, default=1024)
    p.add_argument("--latent", type=int, default=512)
    p.add_argument("--n_mlp", type=int, default=8)
    p.add_argument("--channel_multiplier", type=int, default=2)
    p.add_argument("--sample", type=int, default=1, help="faces per grid")
    p.add_argument("--pics", type=int, default=1, help="number of grids")
    p.add_argument("--truncation", type=float, default=1.0)
    p.add_argument("--truncation_mean", type=int, default=4096)
    p.add_argument("--ckpt", type=str, default="",
                   help="checkpoint directory written by cli.train (newest step)")
    p.add_argument("--with_map", action="store_true",
                   help="render through the GAR (GeneratorWithMap) on a posed mesh, "
                        "not the unconditioned Generator")
    p.add_argument("--out", type=str, default="sample")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--save_normals", action="store_true")
    p.add_argument("--device", type=str, default="cuda")
    return p


@torch.no_grad()
def main(argv=None):
    args = build_argparser().parse_args(argv)
    from stylerenderer_tpu_torch.device import resolve_device
    from stylerenderer_tpu_torch.face3d import (
        mesh_point_normal, random_apply_pose3D, synthetic_face,
    )
    from stylerenderer_tpu_torch.models import Generator, GeneratorWithMap
    from stylerenderer_tpu_torch.utils.image import save_image_grid

    device = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    rng = torch.Generator().manual_seed(args.seed)
    cls = GeneratorWithMap if args.with_map else Generator
    gen = cls(args.size, args.latent, args.n_mlp, channel_multiplier=args.channel_multiplier,
              seed=args.seed, device=device).eval()
    if args.ckpt:
        from stylerenderer_tpu_torch.utils.checkpoint import load_generator_weights

        load_generator_weights(args.ckpt, gen)
    if args.with_map:
        face, tri = synthetic_face(48, 96, 80, 29, device=device)

    trunc_latent = None
    if args.truncation < 1:
        trunc_latent = gen.mean_latent(args.truncation_mean, rng)

    paths = []
    for i in range(args.pics):
        z = torch.randn(args.sample, args.latent, generator=rng).to(device)
        kw = dict(truncation=args.truncation if args.truncation < 1 else None,
                  truncation_latent=trunc_latent, generator=rng)
        if args.with_map:
            vert = random_apply_pose3D(rng, face(face.random_input(args.sample, rng)))
            norm = mesh_point_normal(vert, tri)
            img, _, norms = gen([z], (vert, norm, tri), return_normals=True, **kw)
            if args.save_normals:
                save_image_grid(os.path.join(args.out, f"{i:06d}_norm.png"),
                                norms[-1].float().cpu().numpy())
        else:
            img, _ = gen([z], **kw)
        img = img.float().permute(0, 2, 3, 1).cpu().numpy()
        if not np.isfinite(img).all():
            raise FloatingPointError("non-finite image")
        path = save_image_grid(os.path.join(args.out, f"{i:06d}.png"), img)
        print(path)
        paths.append(path)
    return paths


if __name__ == "__main__":
    main()

"""FID CLI: sample the generator and compare its pool3 statistics with
precomputed real ones (counterpart of ``stylerenderer_tpu/cli/fid.py``).

python -m stylerenderer_tpu_torch.cli.fid --ckpt CKPT_DIR --inception stats.pkl \\
    [--n_sample 50000 --batch 64 --with_map --step N] [--device cuda|cpu]

The weights are a checkpoint's (``g_ema``, else ``g``, loaded strictly);
the real statistics come from ``cli.calc_inception`` (of either package).
With ``--with_map`` each batch is rendered by the GAR on a face mesh (the
BFM of ``--bfm``, else the synthetic face) with a random input and pose.
Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse

import torch

def build_argparser():
    p = argparse.ArgumentParser(description="FID of a generator checkpoint (PyTorch)")
    p.add_argument("--ckpt", type=str, required=True)
    p.add_argument("--inception", type=str, required=True, help="real stats .pkl")
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--latent", type=int, default=512)
    p.add_argument("--n_mlp", type=int, default=8)
    p.add_argument("--channel_multiplier", type=int, default=2)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--n_sample", type=int, default=50_000)
    p.add_argument("--with_map", action="store_true")
    p.add_argument("--bfm", type=str, default="", help="BFM .mat (else the synthetic face)")
    p.add_argument("--inception_weights", type=str, default="")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--step", type=int, default=-1, help="checkpoint step (default: latest)")
    p.add_argument("--device", type=str, default="cuda")
    return p


def make_sampler(gen, mesh_model=None, noise_generator: torch.Generator | None = None):
    """``sample(generator, batch)`` -> images ``[batch, 3, size, size]``:
    ``z``, and for the GAR a random 3DMM input and pose of ``mesh_model``
    (``(face, tri)``), drawn from ``generator``; the noise from
    ``noise_generator``."""
    from stylerenderer_tpu_torch.face3d import mesh_point_normal, random_apply_pose3D

    def sample(generator, batch):
        z = torch.randn(batch, gen.style_dim, generator=generator).to(gen.device)
        if mesh_model is None:
            return gen([z], generator=noise_generator)[0]
        face, tri = mesh_model
        vert = random_apply_pose3D(generator, face(face.random_input(batch, generator)))
        return gen([z], (vert, mesh_point_normal(vert, tri), tri),
                   generator=noise_generator)[0]

    return sample


@torch.no_grad()
def main(argv=None):
    args = build_argparser().parse_args(argv)
    from stylerenderer_tpu_torch.device import resolve_device
    from stylerenderer_tpu_torch.eval import (
        compute_fid, extract_features_from_samples, load_patched_inception_v3, load_stats,
    )
    from stylerenderer_tpu_torch.face3d import load_face_model
    from stylerenderer_tpu_torch.models import Generator, GeneratorWithMap
    from stylerenderer_tpu_torch.utils.checkpoint import load_generator_weights

    device = resolve_device(args.device)
    cls = GeneratorWithMap if args.with_map else Generator
    gen = cls(args.size, args.latent, args.n_mlp, channel_multiplier=args.channel_multiplier,
              seed=args.seed, device=device).eval()
    load_generator_weights(args.ckpt, gen, step=None if args.step < 0 else args.step)
    mesh_model = load_face_model(args.bfm, device=device) if args.with_map else None
    inception = load_patched_inception_v3(args.inception_weights or None, device=device)
    sample = make_sampler(gen, mesh_model,
                          torch.Generator(device=device).manual_seed(args.seed + 1))
    feats = extract_features_from_samples(sample, inception, args.n_sample, args.batch,
                                          torch.Generator().manual_seed(args.seed))
    real_mu, real_cov = load_stats(args.inception)
    fid = compute_fid(feats, real_mu, real_cov)
    print(f"fid: {fid:.4f}")
    return fid


if __name__ == "__main__":
    main()

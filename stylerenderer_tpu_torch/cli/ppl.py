"""PPL CLI: the perceptual path length of a generator (counterpart of
``stylerenderer_tpu/cli/ppl.py``).

python -m stylerenderer_tpu_torch.cli.ppl --ckpt CKPT_DIR [--space w|z \\
    --sampling end|full --eps 1e-4 --crop --n_sample 5000 --batch 64 \\
    --with_map] [--device cuda|cpu]

The weights are a checkpoint's (``g_ema``, else ``g``, loaded strictly).
Every synthesis call uses one set of noise maps (the JAX CLI gives every
call the same noise key). With ``--with_map`` one posed synthetic-face
mesh batch (the BFM of ``--bfm``, else the synthetic face), drawn once,
conditions every call. LPIPS is VGG16, with a torchvision state dict from
``--vgg_weights`` or a random backbone. Runs on the card unless
``--device cpu``.
"""

from __future__ import annotations

import argparse

import torch

def build_argparser():
    p = argparse.ArgumentParser(description="perceptual path length (PyTorch)")
    p.add_argument("--ckpt", type=str, required=True)
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--latent", type=int, default=512)
    p.add_argument("--n_mlp", type=int, default=8)
    p.add_argument("--channel_multiplier", type=int, default=2)
    p.add_argument("--space", choices=["z", "w"], default="w")
    p.add_argument("--sampling", choices=["end", "full"], default="end")
    p.add_argument("--eps", type=float, default=1e-4)
    p.add_argument("--crop", action="store_true")
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--n_sample", type=int, default=5_000)
    p.add_argument("--with_map", action="store_true")
    p.add_argument("--bfm", type=str, default="", help="BFM .mat (else the synthetic face)")
    p.add_argument("--vgg_weights", type=str, default="",
                   help="torchvision vgg16 state dict for true LPIPS")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda")
    return p


def make_sampler(gen, lpips, batch: int, mesh_model=None, *, space: str = "w",
                 sampling: str = "end", eps: float = 1e-4, crop: bool = False):
    """The CLI's ``sample(generator, batch) -> [batch]`` distances: every
    synthesis call takes one set of noise maps (seed 0) and, for the GAR, one
    batch of ``mesh_model`` (``(face, tri)``) with a random input and pose
    (seed 1), both drawn here for ``batch`` samples."""
    from stylerenderer_tpu_torch.eval import make_ppl_sampler
    from stylerenderer_tpu_torch.face3d import mesh_point_normal, random_apply_pose3D
    from stylerenderer_tpu_torch.models import make_noise

    mesh = None
    if mesh_model is not None:
        face, tri = mesh_model
        g = torch.Generator().manual_seed(1)
        vert = random_apply_pose3D(g, face(face.random_input(batch, g)))
        mesh = (vert, mesh_point_normal(vert, tri), tri)
    noise = make_noise(gen.size, batch, torch.Generator().manual_seed(0), gen.device)

    def synth(latents, input_is_latent):
        kw = dict(input_is_latent=input_is_latent, noise=noise)
        return (gen([latents], **kw) if mesh is None else gen([latents], mesh, **kw))[0]

    return make_ppl_sampler(gen.get_latent, synth, lpips, gen.style_dim, space=space,
                            sampling=sampling, eps=eps, crop=crop, device=gen.device)


@torch.no_grad()
def main(argv=None):
    args = build_argparser().parse_args(argv)
    from stylerenderer_tpu_torch.device import resolve_device
    from stylerenderer_tpu_torch.eval import compute_ppl, load_lpips
    from stylerenderer_tpu_torch.face3d import load_face_model
    from stylerenderer_tpu_torch.models import Generator, GeneratorWithMap
    from stylerenderer_tpu_torch.utils.checkpoint import load_generator_weights

    device = resolve_device(args.device)
    cls = GeneratorWithMap if args.with_map else Generator
    gen = cls(args.size, args.latent, args.n_mlp, channel_multiplier=args.channel_multiplier,
              seed=args.seed, device=device).eval()
    load_generator_weights(args.ckpt, gen)
    mesh_model = load_face_model(args.bfm, device=device) if args.with_map else None
    lpips = load_lpips("vgg", backbone_weights=args.vgg_weights or None, device=device)
    sampler = make_sampler(gen, lpips, args.batch, mesh_model, space=args.space,
                           sampling=args.sampling, eps=args.eps, crop=args.crop)
    ppl = compute_ppl(sampler, torch.Generator().manual_seed(args.seed), args.n_sample,
                      args.batch)
    print(f"ppl: {ppl:.4f}")
    return ppl


if __name__ == "__main__":
    main()

"""Synthetic shaded-face dataset (counterpart of
``stylerenderer_tpu/data/synth.py``): a learnable stand-in for FFHQ-style
photos when no real data ships with the repository.

Each sample: a random 3DMM face and a random rigid pose, its vertex normals
rasterized per pixel, then Lambertian shading with a random directional
light, a random skin-like albedo and ambient light, on a solid background.
The distribution is renderable by the GAR itself, so adversarial training
has a true optimum.

The random draws (``make_synth_batch``, a ``torch.Generator`` on the CPU)
are split from the arithmetic (``shade_faces``), so the shading can be
held against the JAX package on the same draws.

    python -m stylerenderer_tpu_torch.data.synth OUT --size 256 --n 64 [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch

ALBEDO_LO = (0.55, 0.35, 0.25)
ALBEDO_HI = (0.95, 0.75, 0.65)
BG_LO, BG_HI = 0.05, 0.35


def shade_faces(vert, tri, light, albedo, bg, size: int):
    """Shaded faces ``[B, size, size, 3]`` in [0, 1].

    ``vert`` ``[B, nv, 3]`` posed vertices, ``tri`` ``[nf, 3]``, ``light``
    ``[B, 3]`` the raw normal draws of the light direction, ``albedo`` and
    ``bg`` ``[B, 1, 1, 3]``. At ``nf*size^2 > 2^24`` the rasterizer takes
    the single-level kernel on a CUDA tensor."""
    from stylerenderer_tpu_torch.face3d import mesh_point_normal
    from stylerenderer_tpu_torch.ops.rasterize import rasterize

    norm = mesh_point_normal(vert, tri)
    nmap = rasterize(vert, norm, tri, size, size)  # [B, H, W, 3]
    mask = (torch.sum(nmap * nmap, -1, keepdim=True) > 1e-6).float()
    n = nmap / torch.clamp(torch.linalg.norm(nmap, dim=-1, keepdim=True), min=1e-6)

    light = light / torch.linalg.norm(light, dim=-1, keepdim=True)
    # bias lights toward the camera (+z) so faces are lit
    light = torch.cat([light[:, :2], light[:, 2:].abs() + 0.5], -1)
    light = light / torch.linalg.norm(light, dim=-1, keepdim=True)
    diffuse = torch.clamp(torch.einsum("bhwc,bc->bhw", n, light), min=0.0)[..., None]
    img = albedo * (0.25 + 0.75 * diffuse)
    return torch.clamp(mask * img + (1 - mask) * bg, 0.0, 1.0)


@torch.no_grad()
def make_synth_batch(generator: torch.Generator, face, tri, size: int, batch: int,
                     device):
    """Draw ``batch`` faces, poses, lights, albedos and backgrounds with
    ``generator`` (on the CPU), then shade them on ``device``:
    ``[B, size, size, 3]`` in [0, 1]."""
    from stylerenderer_tpu_torch.face3d import random_apply_pose3D

    vert = random_apply_pose3D(generator, face(face.random_input(batch, generator)))
    light = torch.randn(batch, 3, generator=generator)
    lo, hi = torch.tensor(ALBEDO_LO), torch.tensor(ALBEDO_HI)
    albedo = lo + (hi - lo) * torch.rand(batch, 1, 1, 3, generator=generator)
    bg = BG_LO + (BG_HI - BG_LO) * torch.rand(batch, 1, 1, 3, generator=generator)
    return shade_faces(vert.to(device), tri.to(device), light.to(device),
                       albedo.to(device), bg.to(device), size)


def write_synth_dataset(path: str, n: int, size: int = 64, seed: int = 0,
                        batch: int = 64, face=None, tri=None, device="cuda") -> int:
    """Render ``n`` shaded faces on ``device`` and write them as a raw SRPack
    shard; returns the number written."""
    from stylerenderer_tpu_torch.data.srpack import SRPackWriter
    from stylerenderer_tpu_torch.device import resolve_device
    from stylerenderer_tpu_torch.face3d import synthetic_face

    device = resolve_device(device)
    if face is None:
        face, tri = synthetic_face(48, 96, 80, 29, device=device)
    generator = torch.Generator().manual_seed(seed)
    writer = SRPackWriter(path, [size], codec="raw")
    done = 0
    while done < n:
        imgs = make_synth_batch(generator, face, tri, size, batch, device).cpu().numpy()
        take = min(batch, n - done)
        for i in range(take):
            writer.add([np.asarray(imgs[i] * 255.0, np.uint8)])
        done += take
    return writer.finalize()


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="render a synthetic face SRPack")
    p.add_argument("out", type=str)
    p.add_argument("--n", type=int, default=10_000)
    p.add_argument("--size", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)
    n = write_synth_dataset(args.out, args.n, args.size, args.seed, device=args.device)
    print(f"wrote {n} {args.size}px shaded faces -> {args.out}")


if __name__ == "__main__":
    main()

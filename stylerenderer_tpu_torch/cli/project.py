"""Face-reconstruction CLI: invert the renderer against photos
(counterpart of ``stylerenderer_tpu/cli/project.py``).

python -m stylerenderer_tpu_torch.cli.project PHOTO.png [PHOTO2.png ...] \\
    [--ckpt CKPT_DIR] [--iters 300 --size 256 --segments 1 --out recon/] \\
    [--device cuda|cpu]

Loads aligned photos, fits (w+, 3DMM parameters, pose) on the card (the
CPU with ``--device cpu``) and writes ``render.png``, ``target.png``,
``mesh_{i:03d}.obj`` per photo and ``fit.npz``. The weights are a
``cli.train`` checkpoint's (``g_ema``, else ``g``) or, without ``--ckpt``,
random ones; the mesh is ``synthetic_face(48, 96, 80, 29)``. ``--w_lpips >
0`` adds the LPIPS (VGG16) term, with a torchvision VGG16 state dict from
``--vgg_weights`` or a random backbone. ``--bfm`` is not ported and is
refused.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

NOT_PORTED = {
    "bfm": "--bfm needs the BFM loader, which the port does not have yet",
}


def build_argparser():
    p = argparse.ArgumentParser(description="render inverting (reconstruction), PyTorch")
    p.add_argument("photos", nargs="+", help="aligned face photos")
    p.add_argument("--ckpt", type=str, default="",
                   help="checkpoint directory written by cli.train (newest step)")
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--latent", type=int, default=512)
    p.add_argument("--n_mlp", type=int, default=8)
    p.add_argument("--channel_multiplier", type=int, default=2)
    p.add_argument("--bfm", type=str, default="", help="not ported")
    p.add_argument("--iters", type=int, default=300)
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--w_lpips", type=float, default=0.0,
                   help="LPIPS weight (needs --vgg_weights for true LPIPS)")
    p.add_argument("--vgg_weights", type=str, default="",
                   help="torchvision vgg16 state dict for the LPIPS backbone")
    p.add_argument("--out", type=str, default="recon")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--segments", type=int, default=1,
                   help="split the fit into this many calls (same trajectory)")
    p.add_argument("--device", type=str, default="cuda")
    return p


def main(argv=None):
    parser = build_argparser()
    args = parser.parse_args(argv)
    for flag, why in NOT_PORTED.items():
        if getattr(args, flag):
            parser.error(why)
    from PIL import Image

    from stylerenderer_tpu_torch.device import resolve_device
    from stylerenderer_tpu_torch.face3d import save_obj, synthetic_face
    from stylerenderer_tpu_torch.inversion import ProjectorConfig, make_projector_jit
    from stylerenderer_tpu_torch.models import GeneratorWithMap
    from stylerenderer_tpu_torch.utils.image import save_image_grid

    device = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    gen = GeneratorWithMap(args.size, args.latent, args.n_mlp,
                           channel_multiplier=args.channel_multiplier, seed=args.seed,
                           device=device)
    face, tri = synthetic_face(48, 96, 80, 29, device=device)
    if args.ckpt:
        from stylerenderer_tpu_torch.utils.checkpoint import load_generator_weights

        load_generator_weights(args.ckpt, gen)

    lpips = None
    if args.w_lpips > 0:
        from stylerenderer_tpu_torch.eval import load_lpips

        lpips = load_lpips("vgg", backbone_weights=args.vgg_weights or None, device=device)

    cfg = ProjectorConfig(iters=args.iters, lr=args.lr, w_lpips=args.w_lpips)
    project = make_projector_jit(gen, face, tri, cfg, lpips=lpips)

    imgs = []
    for path in args.photos:
        img = Image.open(path).convert("RGB").resize((args.size, args.size))
        imgs.append(np.asarray(img, np.float32) / 127.5 - 1.0)
    target_hwc = np.stack(imgs)
    target = torch.from_numpy(target_hwc).permute(0, 3, 1, 2).contiguous().to(device)

    out = project(None, torch.Generator().manual_seed(args.seed), target,
                  segments=args.segments)
    hist = out["loss_history"].cpu().numpy()
    print(f"loss: {hist[0]:.4f} -> {hist[-1]:.4f} over {args.iters} iters")
    save_image_grid(os.path.join(args.out, "render.png"),
                    out["render"].permute(0, 2, 3, 1).cpu().numpy())
    save_image_grid(os.path.join(args.out, "target.png"), target_hwc)
    vert = out["vertices"].cpu().numpy()
    for i in range(len(imgs)):
        save_obj(os.path.join(args.out, f"mesh_{i:03d}.obj"), vert[i], tri.cpu().numpy())
    np.savez(
        os.path.join(args.out, "fit.npz"),
        w_plus=out["w_plus"].cpu().numpy(),
        face_params=out["face_params"].cpu().numpy(),
        rvec=out["rvec"].cpu().numpy(),
        tvec=out["tvec"].cpu().numpy(),
        log_scale=out["log_scale"].cpu().numpy(),
        loss_history=hist,
    )
    print(f"wrote render/target/meshes/fit.npz -> {args.out}")
    return out


if __name__ == "__main__":
    main()

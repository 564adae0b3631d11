"""Production-resolution Render Inverting demonstration (counterpart of the
JAX package's ``scripts/recon_demo256.py``): the paper's method,
Regressor-initialized inversion, on ``train_demo256``'s checkpoint.

1. load ``g_ema`` from the port's ``train_demo256`` checkpoint (no JAX
   checkpoint exists to load);
2. train the Regressor on the generator's own renders
   (``train/regressor.py``: z -> w -> render -> w back);
3. invert targets with known w+, 3DMM parameters and pose under four
   configs, {mean-latent, Regressor} init x {short, full} iterations, with
   pixel, LPIPS (VGG16: the fixed-seed backbone, as no weights are in the
   repository), landmark and prior terms, in float32.

Inversion needs a linear morphable model (its prior sigma): the synthetic
face here, as in the JAX demo.

    python -m stylerenderer_tpu_torch.scripts.recon_demo256 [--faces 32] [--batch 8] \
        [--reg_steps 1500]

Artifacts under ``--out`` (default ``torch_demos/recon_demo256``):
``metrics.json`` (per config), ``regressor_loss.json``, the configs'
``grid_<config>_{0,1}.png`` and ``batch_0_<config>.npz``.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from stylerenderer_tpu_torch.scripts._common import default_out, lmk_vertex_ids
from stylerenderer_tpu_torch.scripts.recon_demo import (
    METRICS, invert_batches, load_demo_generator, summarize,
)


def build_argparser():
    p = argparse.ArgumentParser(description="Regressor-initialized inversion at 256 px")
    p.add_argument("--faces", type=int, default=32)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--reg_steps", type=int, default=1500)
    p.add_argument("--reg_batch", type=int, default=8)
    p.add_argument("--iters_short", type=int, default=100)
    p.add_argument("--iters_full", type=int, default=300)
    p.add_argument("--seed", type=int, default=13)
    p.add_argument("--ckpt", type=str, default="", help="default: train_demo256's checkpoint")
    p.add_argument("--bfm", type=str, default="", help="the BFM .mat the checkpoint was "
                   "trained on (else the synthetic face)")
    p.add_argument("--out", type=str, default="")
    p.add_argument("--device", type=str, default="cuda")
    return p


def main(argv=None) -> dict:
    args = build_argparser().parse_args(argv)
    from stylerenderer_tpu_torch.device import resolve_device
    from stylerenderer_tpu_torch.eval import load_lpips
    from stylerenderer_tpu_torch.inversion import ProjectorConfig, make_projector
    from stylerenderer_tpu_torch.models import Regressor
    from stylerenderer_tpu_torch.train.regressor import make_regressor_fn, make_regressor_trainer

    device = resolve_device(args.device)
    out = os.path.abspath(args.out or default_out("recon_demo256"))
    os.makedirs(out, exist_ok=True)
    ckpt = args.ckpt or os.path.join(default_out("train_demo256"), "checkpoint")
    gen, face, tri, cfg = load_demo_generator(ckpt, device, args.bfm)

    # ---- stage 1: the Regressor, trained on the checkpoint's renders ----
    reg = Regressor(cfg.size, cfg.latent, cfg.n_mlp, channel_multiplier=cfg.channel_multiplier,
                    seed=args.seed, device=device)
    init_fn, step_fn = make_regressor_trainer(reg, gen, face, tri, batch=args.reg_batch,
                                              lr=1e-4)
    rstate = init_fn(args.seed)
    losses = []
    t0 = time.perf_counter()
    for i in range(args.reg_steps):
        m = step_fn(rstate)
        if i % 50 == 0 or i == args.reg_steps - 1:
            losses.append([i, float(m["regressor_loss"])])
    reg_s = time.perf_counter() - t0
    print(f"regressor: {args.reg_steps} steps in {reg_s:.1f} s, loss {losses[0][1]:.4f} -> "
          f"{losses[-1][1]:.4f}", flush=True)
    with open(os.path.join(out, "regressor_loss.json"), "w") as f:
        json.dump({"steps_losses": losses, "seconds": reg_s}, f)

    # the Regressor gives a pixel-normed direction: scale it to the mean
    # radius of mapped latents so Adam starts at the right magnitude
    with torch.no_grad():
        z = torch.randn(256, gen.style_dim, generator=torch.Generator().manual_seed(17))
        w_norm = float(torch.sqrt(torch.mean(gen.get_latent(z.to(device)) ** 2)))
    regressor_fn = make_regressor_fn(reg, w_norm)

    # ---- stage 2: the four configs on the same targets ----
    lpips = load_lpips("vgg", device=device)
    lmk_idx = lmk_vertex_ids(face.mean.shape[-1] // 3, device)
    configs = {}
    for iters in (args.iters_short, args.iters_full):
        pcfg = ProjectorConfig(iters=iters, w_lpips=0.8, w_lmk=1e-3)
        configs[f"mean_init_{iters}"] = make_projector(gen, face, tri, pcfg, lpips_fn=lpips,
                                                       lmk_vidx=lmk_idx)
        configs[f"regressor_init_{iters}"] = make_projector(
            gen, face, tri, pcfg, lpips_fn=lpips, lmk_vidx=lmk_idx, regressor_fn=regressor_fn)
    results = invert_batches(configs, gen, face, tri, args.faces, args.batch, args.seed + 1,
                             out)

    summary = {name: summarize(r) for name, r in results.items()}
    for name, r in results.items():  # the first batch carries the warm-up
        tail = r["s_per_face"][1:] or r["s_per_face"]
        summary[name]["s_per_face_steady"] = {"mean": sum(tail) / len(tail)}
    summary["faces"] = args.faces
    summary["config"] = (f"pixel+LPIPS+landmark+prior over (w+, 3DMM, pose), {gen.size}px, "
                         f"batch {args.batch}")
    summary["regressor"] = {"steps": args.reg_steps, "first_loss": losses[0][1],
                            "final_loss": losses[-1][1], "seconds": reg_s,
                            "w_norm_scale": w_norm}
    summary["ckpt"] = ckpt
    with open(os.path.join(out, "metrics.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps({name: {k: summary[name][k]["mean"] for k in METRICS + ("s_per_face",)}
                      for name in configs}), flush=True)
    print(f"artifacts -> {out}")
    return summary


if __name__ == "__main__":
    main()

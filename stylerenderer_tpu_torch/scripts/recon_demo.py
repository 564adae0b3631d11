"""Batch face-reconstruction demonstration (counterpart of the JAX
package's ``scripts/recon_demo.py``): invert the GAR trained by
``train_demo`` against targets it rendered itself with known ground truth
(w+, 3DMM parameters, pose), so that besides the image-space quality (pixel
MSE, PSNR, landmark error) the geometry's recovery (vertex RMSE against the
ground-truth posed mesh) is measured too. Per batch: sample the ground
truth, render the target, fit (pixel + landmark + prior over w+, 3DMM
parameters and pose, ``inversion/project.py``, in float32), then the
metrics and a grid of targets over reconstructions.

    python -m stylerenderer_tpu_torch.scripts.recon_demo [--faces 96] [--iters 300] [--batch 16]

``--ckpt`` defaults to ``torch_demos/train_demo/checkpoint`` (the widths
come from the checkpoint). Artifacts under ``--out`` (default
``torch_demos/recon_demo``): ``metrics.json`` (per-face values and their
mean, median, p10 and p90), ``grid_{0,1}.png`` and ``batch_0.npz`` (the
first batch's targets, renders, fitted and ground-truth vertices).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from stylerenderer_tpu_torch.scripts._common import (
    default_out, face_metrics, lmk_vertex_ids, make_targets, project_lmk, save_pairs_grid, stats,
)

METRICS = ("pixel_mse", "psnr", "lmk_err_px", "vertex_rmse")


def build_argparser():
    p = argparse.ArgumentParser(description="invert the 64 px GAR against known targets")
    p.add_argument("--faces", type=int, default=96)
    p.add_argument("--iters", type=int, default=300)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--seed", type=int, default=11)
    p.add_argument("--ckpt", type=str, default="", help="default: train_demo's checkpoint")
    p.add_argument("--bfm", type=str, default="", help="the BFM .mat the checkpoint was "
                   "trained on (else the synthetic face)")
    p.add_argument("--out", type=str, default="")
    p.add_argument("--device", type=str, default="cuda")
    return p


def load_demo_generator(ckpt_dir: str, device, bfm: str = ""):
    """The checkpoint's ``g_ema`` in a float32 ``GeneratorWithMap`` of its
    widths, the face model it was trained on (``bfm``, else the synthetic
    face) on ``device``, and the checkpoint's ``TrainConfig``."""
    from stylerenderer_tpu_torch.face3d import load_face_model
    from stylerenderer_tpu_torch.models import GeneratorWithMap
    from stylerenderer_tpu_torch.utils.checkpoint import load_generator_weights, load_params_only

    _, cfg = load_params_only(ckpt_dir)
    gen = GeneratorWithMap(cfg.size, cfg.latent, cfg.n_mlp,
                           channel_multiplier=cfg.channel_multiplier, device=device)
    load_generator_weights(ckpt_dir, gen)
    face, tri = load_face_model(bfm, device=device)
    return gen.eval(), face, tri, cfg


def invert_batches(name_to_project, gen, face, tri, faces: int, batch: int, seed: int,
                   out: str) -> dict:
    """Fit ``faces`` targets, ``batch`` at a time, under each named projector;
    returns per-name lists of per-face metrics and seconds a face. Writes
    ``grid_{name}_{b}.png`` for the first two batches and the first batch's
    tensors to ``batch_0_{name}.npz`` (name left out when there is one)."""
    size = gen.size
    lmk_idx = lmk_vertex_ids(face.mean.shape[-1] // 3, gen.device)
    g = torch.Generator().manual_seed(seed)
    results = {n: {k: [] for k in METRICS + ("s_per_face",)} for n in name_to_project}
    tag = (lambda n: "") if len(name_to_project) == 1 else (lambda n: f"_{n}")
    n_batches = -(-faces // batch)
    for bi in range(n_batches):
        t = make_targets(gen, face, tri, batch, g)
        target_lmk = project_lmk(t["vertices"], lmk_idx, size)
        fit_seed = int(torch.randint(0, 2**31 - 1, (1,), generator=g))
        for name, project in name_to_project.items():
            if gen.device.type == "cuda":
                torch.cuda.synchronize(gen.device)
            t0 = time.perf_counter()
            fit = project(torch.Generator().manual_seed(fit_seed), t["target"], target_lmk)
            hist = fit["loss_history"].cpu().numpy()
            dt = time.perf_counter() - t0
            if not np.isfinite(hist).all():
                raise FloatingPointError(f"non-finite loss: {name}, batch {bi}")
            m = face_metrics(fit["render"], t["target"], fit["vertices"], t["vertices"],
                             lmk_idx, size)
            r = results[name]
            for k in METRICS:
                r[k] += m[k].tolist()
            r["s_per_face"].append(dt / batch)
            print(f"batch {bi + 1}/{n_batches} {name}: {dt / batch:.3f} s/face, "
                  f"mse {m['pixel_mse'].mean():.4f}, psnr {m['psnr'].mean():.1f} dB, "
                  f"lmk {m['lmk_err_px'].mean():.2f} px, "
                  f"vrmse {m['vertex_rmse'].mean():.4f}", flush=True)
            if bi < 2:
                save_pairs_grid(os.path.join(out, f"grid{tag(name)}_{bi}.png"), t["target"],
                                fit["render"])
            if bi == 0:
                np.savez(os.path.join(out, f"batch_0{tag(name)}.npz"),
                         target=t["target"].cpu().numpy(),
                         render=fit["render"].float().cpu().numpy(),
                         vertices=fit["vertices"].cpu().numpy(),
                         vertices_gt=t["vertices"].cpu().numpy(),
                         lmk_vidx=lmk_idx.cpu().numpy(), loss_history=hist)
    return results


def summarize(r: dict) -> dict:
    out = {k: stats(v) for k, v in r.items()}
    out["per_face"] = {k: r[k] for k in METRICS}
    return out


def main(argv=None) -> dict:
    args = build_argparser().parse_args(argv)
    from stylerenderer_tpu_torch.device import resolve_device
    from stylerenderer_tpu_torch.inversion import ProjectorConfig, make_projector

    device = resolve_device(args.device)
    out = os.path.abspath(args.out or default_out("recon_demo"))
    os.makedirs(out, exist_ok=True)
    ckpt = args.ckpt or os.path.join(default_out("train_demo"), "checkpoint")
    gen, face, tri, _ = load_demo_generator(ckpt, device, args.bfm)
    lmk_idx = lmk_vertex_ids(face.mean.shape[-1] // 3, device)
    project = make_projector(gen, face, tri,
                             ProjectorConfig(iters=args.iters, w_lpips=0.0, w_lmk=1e-3),
                             lmk_vidx=lmk_idx)
    r = invert_batches({"fit": project}, gen, face, tri, args.faces, args.batch, args.seed,
                       out)["fit"]
    summary = summarize(r)
    summary.update(faces=len(r["pixel_mse"]), iters=args.iters, ckpt=ckpt,
                   config=f"pixel+landmark+prior over (w+, 3DMM, pose), {gen.size}px")
    with open(os.path.join(out, "metrics.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps({k: summary[k]["mean"] for k in METRICS + ("s_per_face",)}), flush=True)
    print(f"artifacts -> {out}")
    return summary


if __name__ == "__main__":
    main()

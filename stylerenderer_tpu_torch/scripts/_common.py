"""Shared pieces of the demonstration scripts: output directories, the
training log and its curves, the synth dataset, the FID trend over kept
checkpoints, summary statistics, and the reconstruction targets with known
ground truth and their metrics."""

from __future__ import annotations

import json
import math
import os

import numpy as np
import torch

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def default_out(name: str) -> str:
    """``torch_demos/<name>`` in the checkout (listed in ``.gitignore``)."""
    return os.path.join(REPO_ROOT, "torch_demos", name)


def add_width_args(p, size: int):
    """The model's size and widths and the face model, passed on to
    ``cli.train``."""
    p.add_argument("--size", type=int, default=size)
    p.add_argument("--latent", type=int, default=512)
    p.add_argument("--n_mlp", type=int, default=8)
    p.add_argument("--channel_multiplier", type=int, default=2)
    p.add_argument("--bfm", type=str, default="", help="BFM .mat (else the synthetic face)")
    p.add_argument("--device", type=str, default="cuda")


def width_argv(args) -> list[str]:
    return ["--size", str(args.size), "--latent", str(args.latent), "--n_mlp", str(args.n_mlp),
            "--channel_multiplier", str(args.channel_multiplier), "--device", args.device,
            *(["--bfm", args.bfm] if args.bfm else [])]


def ensure_dataset(path: str, n: int, size: int, device, bfm: str = "") -> str:
    """The synth writer's shard of ``n`` faces at ``size`` px on the face
    model (``--bfm`` or the synthetic face), rendered once."""
    if not os.path.exists(path):
        from stylerenderer_tpu_torch.data import write_synth_dataset
        from stylerenderer_tpu_torch.face3d import load_face_model

        print(f"rendering {n} synthetic shaded faces -> {path}", flush=True)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        face, tri = load_face_model(bfm, device=device)
        write_synth_dataset(path, n, size=size, batch=min(64, n), face=face, tri=tri,
                            device=device)
    return path


def read_log(out: str) -> list[dict]:
    """The rows of ``out/logs/metrics.jsonl`` (``cli.train``'s log), by step."""
    rows = []
    path = os.path.join(out, "logs", "metrics.jsonl")
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                try:
                    rows.append(json.loads(line))
                except json.JSONDecodeError:
                    pass
    return sorted(rows, key=lambda r: r.get("step", 0))


def write_curves(out: str, rows: list[dict], fid_trend: list | None = None) -> dict:
    """``out/curves.json``: the adversarial losses, step times and sustained
    images/s by logged step, and the FID trend (the JAX scripts draw
    ``curves.png`` with matplotlib, which the port does not need)."""
    keys = ("d", "g", "r1", "path", "ada_p", "r_t", "step_ms", "imgs_per_sec")
    curves = {"step": [r["step"] for r in rows]}
    curves.update({k: [r.get(k) for r in rows] for k in keys})
    curves["fid_trend"] = fid_trend
    with open(os.path.join(out, "curves.json"), "w") as f:
        json.dump(curves, f, indent=1)
    return curves


def sustained_imgs_per_sec(rows: list[dict]):
    """The last logged images/s (``StepTimer``'s window over the latest
    steps), or None before any."""
    ips = [r["imgs_per_sec"] for r in rows if r.get("imgs_per_sec")]
    return ips[-1] if ips else None


def fid_trend(out: str, data: str, n_sample: int, device: str, bfm: str = "",
              batch: int = 64) -> list:
    """Random-backbone FID (a fixed-seed Inception: no published weights are
    in the repository, so the trend is the signal) between ``data`` and each
    checkpoint kept under ``out/checkpoint``, through ``cli.calc_inception``
    and ``cli.fid`` (rendering the face model of ``bfm``, else the synthetic
    face); written to ``out/fid_trend.json``."""
    from stylerenderer_tpu_torch.cli import calc_inception, fid as cli_fid
    from stylerenderer_tpu_torch.utils.checkpoint import all_steps, load_params_only

    ckpt_dir = os.path.join(out, "checkpoint")
    _, cfg = load_params_only(ckpt_dir)
    stats = os.path.join(out, "real_stats.pkl")
    if not os.path.exists(stats):  # over the first n_sample images (full batches)
        calc_inception.main([data, "--size", str(cfg.size), "--out", stats, "--n_sample",
                             str(n_sample), "--batch", str(min(batch, n_sample)),
                             "--device", device])
    trend = []
    for s in all_steps(ckpt_dir):
        value = cli_fid.main([
            "--ckpt", ckpt_dir, "--step", str(s), "--inception", stats, "--with_map",
            "--size", str(cfg.size), "--latent", str(cfg.latent), "--n_mlp", str(cfg.n_mlp),
            "--channel_multiplier", str(cfg.channel_multiplier), "--n_sample", str(n_sample),
            "--batch", str(min(batch, n_sample)), "--device", device,
            *(["--bfm", bfm] if bfm else [])])
        trend.append({"step": int(s), "fid": float(value)})
        print(f"step {s}: fid {value:.3f}", flush=True)
    with open(os.path.join(out, "fid_trend.json"), "w") as f:
        json.dump(trend, f, indent=1)
    return trend


def stats(a) -> dict:
    a = np.asarray(a, np.float64)
    return {"mean": float(a.mean()), "median": float(np.median(a)),
            "p10": float(np.percentile(a, 10)), "p90": float(np.percentile(a, 90))}


def all_finite(tree) -> bool:
    """Every number in a nest of dicts and lists is finite (None is skipped)."""
    if isinstance(tree, dict):
        return all(all_finite(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return all(all_finite(v) for v in tree)
    if isinstance(tree, (int, float)) and not isinstance(tree, bool):
        return math.isfinite(tree)
    return True


# ---- reconstruction with known ground truth ----------------------------------------

N_LMK = 68


def lmk_vertex_ids(nv: int, device) -> torch.Tensor:
    """68 mesh vertices spread evenly over the index range (the JAX demos')."""
    return torch.linspace(0, nv - 1, N_LMK, device=device).long()


def project_lmk(vert, lmk_idx, size: int):
    """The landmark vertices through the renderer's NDC -> pixel map:
    ``[B, 68, 2]``."""
    lv = vert[:, lmk_idx, :]
    return torch.stack([(1 + lv[..., 0]) * size / 2 - 0.5,
                        (1 - lv[..., 1]) * size / 2 - 0.5], -1)


@torch.no_grad()
def make_targets(gen, face, tri, batch: int, generator: torch.Generator) -> dict:
    """Targets rendered by ``gen`` with known ground truth: ``z``, a 3DMM
    sample ``x`` and a pose (``rvec`` N(0, 0.15), ``tvec`` N(0, 0.05),
    ``log_scale`` N(0, 0.05)), all drawn from ``generator`` (on the CPU);
    zero noise. Returns the target ``[B, 3, H, W]`` clipped to [-1, 1], the
    posed vertices and the draws."""
    from stylerenderer_tpu_torch.face3d import mesh_point_normal
    from stylerenderer_tpu_torch.inversion.project import _apply_pose

    dev = gen.device
    z = torch.randn(batch, gen.style_dim, generator=generator).to(dev)
    x = face.random_input(batch, generator)
    rvec = (torch.randn(batch, 3, generator=generator) * 0.15).to(dev)
    tvec = (torch.randn(batch, 3, generator=generator) * 0.05).to(dev)
    log_scale = (torch.randn(batch, 1, generator=generator) * 0.05).to(dev)
    vert = _apply_pose(face(x), rvec, tvec, log_scale)
    noise = [torch.zeros(1, 1, 1, 1, device=dev)] * gen.num_layers
    img = gen([z], (vert, mesh_point_normal(vert, tri), tri), noise=noise)[0]
    return {"target": torch.clamp(img.float(), -1, 1), "vertices": vert, "z": z, "x": x,
            "rvec": rvec, "tvec": tvec, "log_scale": log_scale}


def face_metrics(render, target, vert, vert_gt, lmk_idx, size: int) -> dict:
    """Per face: pixel MSE and PSNR (images in [-1, 1], so a peak-to-peak of
    2), the mean landmark distance in pixels and the vertex RMSE against the
    ground truth; numpy arrays ``[B]``."""
    render, target = render.float(), target.float()
    mse = ((render - target) ** 2).mean(dim=(1, 2, 3)).cpu().numpy().astype(np.float64)
    psnr = 10 * np.log10(4.0 / np.maximum(mse, 1e-12))
    lmk = torch.linalg.norm(project_lmk(vert, lmk_idx, size)
                            - project_lmk(vert_gt, lmk_idx, size), dim=-1).mean(-1)
    vrmse = torch.sqrt(((vert - vert_gt) ** 2).mean(dim=(1, 2)))
    return {"pixel_mse": mse, "psnr": psnr,
            "lmk_err_px": lmk.cpu().numpy().astype(np.float64),
            "vertex_rmse": vrmse.cpu().numpy().astype(np.float64)}


def save_pairs_grid(path: str, target, render, cols: int = 8) -> str:
    """Targets over their reconstructions, ``cols`` faces a row pair."""
    from stylerenderer_tpu_torch.utils.image import save_image_grid

    t = target.float().permute(0, 2, 3, 1).cpu().numpy()
    r = render.float().permute(0, 2, 3, 1).cpu().numpy()
    cols = min(cols, len(t))
    pad = (-len(t)) % cols
    blank = np.ones((pad,) + t.shape[1:], np.float32)
    t, r = np.concatenate([t, blank]), np.concatenate([r, blank])
    rows = [part[i:i + cols] for i in range(0, len(t), cols) for part in (t, r)]
    return save_image_grid(path, np.concatenate(rows), nrow=cols)

"""ADA at production resolution (counterpart of the JAX package's
``scripts/train_demo256_ada.py``): 256 px, B=16 training steps with the
ADA controller, resumed from ``train_demo256``'s checkpoint where one
exists, else from step 0 (the reference trains with ADA on from the
start). ``--ada_length`` defaults to 30k images (the trainer's is 500k),
so that the controller's response shows within a 2k-step run: it changes
the controller's gain, not its mechanism. Also the FID trends of both
256 px runs (random-backbone Inception).

    python -m stylerenderer_tpu_torch.scripts.train_demo256_ada [--steps 2000]

Artifacts under ``--out`` (default ``torch_demos/train_demo256_ada``):
``logs/``, ``sample/``, ``checkpoint/``, ``curves.json``,
``ada_summary.json`` (``p`` and ``r_t`` at every logged step and their
summary) and ``fid_trend.json``; and ``fid_trend.json`` and
``curves.json`` of the base run under ``--base`` when its checkpoints are
there.
"""

from __future__ import annotations

import argparse
import json
import os
import time

from stylerenderer_tpu_torch.scripts._common import (
    add_width_args, default_out, ensure_dataset, fid_trend, read_log, sustained_imgs_per_sec,
    width_argv, write_curves,
)


def build_argparser():
    p = argparse.ArgumentParser(description="ADA at 256 px, resumed from train_demo256")
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--ada_length", type=int, default=30_000)
    p.add_argument("--ada_every", type=int, default=256)
    p.add_argument("--n_data", type=int, default=2000)
    p.add_argument("--n_fid", type=int, default=2000)
    p.add_argument("--log_every", type=int, default=25)
    p.add_argument("--seed", type=int, default=23)
    p.add_argument("--skip_fid", action="store_true")
    p.add_argument("--base", type=str, default="", help="train_demo256's --out")
    p.add_argument("--out", type=str, default="")
    add_width_args(p, size=256)
    return p


def main(argv=None) -> dict:
    args = build_argparser().parse_args(argv)
    from stylerenderer_tpu_torch.cli.train import main as train_main
    from stylerenderer_tpu_torch.device import resolve_device
    from stylerenderer_tpu_torch.utils.checkpoint import latest_step

    resolve_device(args.device)
    base = os.path.abspath(args.base or default_out("train_demo256"))
    out = os.path.abspath(args.out or default_out("train_demo256_ada"))
    os.makedirs(out, exist_ok=True)
    data = ensure_dataset(os.path.join(base, f"faces{args.size}.srpack"), args.n_data,
                          args.size, args.device, args.bfm)
    base_ckpt = os.path.join(base, "checkpoint")
    start = latest_step(base_ckpt) or 0
    t0 = time.perf_counter()
    train_main([data, "--batch", str(args.batch), "--iter", str(start + args.steps),
                "--seed", str(args.seed), "--compute_dtype", "bfloat16",
                *(["--ckpt", base_ckpt] if start else []),
                "--augment", "--ada_length", str(args.ada_length), "--ada_every",
                str(args.ada_every), "--ckpt_every", str(args.steps), "--ckpt_keep", "2",
                "--sample_every", str(max(args.steps // 4, 1)), "--log_every",
                str(args.log_every), "--n_sample", "8", "--out_dir", out]
               + width_argv(args))
    train_s = time.perf_counter() - t0

    rows = read_log(out)
    ada = [(r["step"], r["ada_p"], r["r_t"]) for r in rows if "ada_p" in r]
    summary = {
        "steps": len(ada), "resumed_from_step": start,
        "ada_p": [a[1] for a in ada], "r_t": [a[2] for a in ada],
        "logged_steps": [a[0] for a in ada],
        "ada_p_first": ada[0][1] if ada else None,
        "ada_p_last": ada[-1][1] if ada else None,
        "ada_p_max": max(a[1] for a in ada) if ada else None,
        "r_t_last": ada[-1][2] if ada else None,
        "ada_length": args.ada_length, "ada_every": args.ada_every,
        "note": ("resumed from train_demo256" if start else "ADA from step 0")
                + "; the short ada_length raises the controller's gain",
    }
    with open(os.path.join(out, "ada_summary.json"), "w") as f:
        json.dump(summary, f, indent=1)

    trends = {}
    if not args.skip_fid:
        if start:  # the base run's trend, while its checkpoints are on disk
            trends["base"] = fid_trend(base, data, args.n_fid, args.device, args.bfm)
            write_curves(base, read_log(base), trends["base"])
        trends["ada"] = fid_trend(out, data, args.n_fid, args.device, args.bfm)
    write_curves(out, rows, trends.get("ada"))
    result = {"train_seconds": train_s, "imgs_per_sec": sustained_imgs_per_sec(rows),
              "ada_p_last": summary["ada_p_last"], "ada_p_max": summary["ada_p_max"],
              "r_t_last": summary["r_t_last"], "resumed_from_step": start,
              "fid_trend": trends, "out": out}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()

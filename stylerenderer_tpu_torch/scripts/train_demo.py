"""End-to-end training demonstration (counterpart of the JAX package's
``scripts/train_demo.py``): render a synthetic shaded-face dataset, train
the GAR at 64 px in bf16 with ``cli.train`` (checkpoints and sample grids),
then a random-backbone FID trend over the kept checkpoints through
``cli.fid``.

    python -m stylerenderer_tpu_torch.scripts.train_demo [--steps 50000] [--out DIR]

Artifacts under ``--out`` (default ``torch_demos/train_demo``):
``faces64.srpack``, ``logs/metrics.jsonl``, ``sample/``, ``checkpoint/``,
``real_stats.pkl``, ``fid_trend.json`` and ``curves.json`` (losses, step
times and images/s by step, and the FID trend).
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
    p = argparse.ArgumentParser(description="train the GAR at 64 px, then its FID trend")
    p.add_argument("--steps", type=int, default=50_000)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--n_data", type=int, default=10_000)
    p.add_argument("--n_fid", type=int, default=5000)
    p.add_argument("--ckpt_every", type=int, default=0, help="default: steps // 8")
    p.add_argument("--log_every", type=int, default=25)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--skip_fid", action="store_true")
    p.add_argument("--out", type=str, default="")
    add_width_args(p, size=64)
    return p


def main(argv=None) -> dict:
    args = build_argparser().parse_args(argv)
    from stylerenderer_tpu_torch.cli.train import main as train_main
    from stylerenderer_tpu_torch.device import resolve_device

    resolve_device(args.device)
    out = os.path.abspath(args.out or default_out("train_demo"))
    os.makedirs(out, exist_ok=True)
    data = ensure_dataset(os.path.join(out, f"faces{args.size}.srpack"), args.n_data,
                          args.size, args.device, args.bfm)
    t0 = time.perf_counter()
    every = str(args.ckpt_every or max(args.steps // 8, 1))
    train_main([data, "--batch", str(args.batch), "--iter", str(args.steps), "--seed",
                str(args.seed), "--compute_dtype", "bfloat16", "--ckpt_every", every,
                "--ckpt_keep", "10", "--sample_every", every, "--log_every",
                str(args.log_every), "--n_sample", "16", "--out_dir", out]
               + width_argv(args))
    train_s = time.perf_counter() - t0
    trend = None if args.skip_fid else fid_trend(out, data, args.n_fid, args.device, args.bfm)
    rows = read_log(out)
    write_curves(out, rows, trend)
    summary = {"steps": args.steps, "train_seconds": train_s,
               "imgs_per_sec": sustained_imgs_per_sec(rows),
               "last": {k: rows[-1][k] for k in ("d", "g")} if rows else None,
               "fid_trend": trend, "out": out}
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()

"""Production-resolution training demonstration (counterpart of the JAX
package's ``scripts/train_demo256.py``): the full train step (the
rasterizer in G's graph, lazy R1 and path length, EMA, the finite screen)
at 256 px, B=16, in bf16 on 2,000 synthetic shaded faces, with the
sustained images/s in its log.

    python -m stylerenderer_tpu_torch.scripts.train_demo256 [--steps 3000] [--batch 16]

Artifacts under ``--out`` (default ``torch_demos/train_demo256``):
``faces256.srpack``, ``logs/``, ``sample/``, ``checkpoint/`` (which
``train_demo256_ada`` resumes and ``recon_demo256`` inverts) and
``curves.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import time

from stylerenderer_tpu_torch.scripts._common import (
    add_width_args, default_out, ensure_dataset, read_log, sustained_imgs_per_sec, width_argv,
    write_curves,
)


def build_argparser():
    p = argparse.ArgumentParser(description="train the GAR at 256 px, B=16")
    p.add_argument("--steps", type=int, default=3000)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--n_data", type=int, default=2000)
    p.add_argument("--ckpt_every", type=int, default=0, help="default: steps // 3")
    p.add_argument("--log_every", type=int, default=25)
    p.add_argument("--seed", type=int, default=17)
    p.add_argument("--out", type=str, default="")
    add_width_args(p, size=256)
    return p


def main(argv=None) -> dict:
    args = build_argparser().parse_args(argv)
    from stylerenderer_tpu_torch.cli.train import main as train_main
    from stylerenderer_tpu_torch.device import resolve_device

    resolve_device(args.device)
    out = os.path.abspath(args.out or default_out("train_demo256"))
    os.makedirs(out, exist_ok=True)
    data = ensure_dataset(os.path.join(out, f"faces{args.size}.srpack"), args.n_data,
                          args.size, args.device, args.bfm)
    t0 = time.perf_counter()
    train_main([data, "--batch", str(args.batch), "--iter", str(args.steps), "--seed",
                str(args.seed), "--compute_dtype", "bfloat16", "--ckpt_every",
                str(args.ckpt_every or max(args.steps // 3, 1)), "--ckpt_keep", "3",
                "--sample_every", str(max(args.steps // 6, 1)), "--log_every",
                str(args.log_every), "--n_sample", "8", "--out_dir", out]
               + width_argv(args))
    train_s = time.perf_counter() - t0
    rows = read_log(out)
    write_curves(out, rows)
    summary = {"steps": args.steps, "batch": args.batch, "train_seconds": train_s,
               "imgs_per_sec": sustained_imgs_per_sec(rows),
               "step_ms": [r["step_ms"] for r in rows if "step_ms" in r],
               "last": {k: rows[-1][k] for k in ("d", "g")} if rows else None, "out": out}
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()

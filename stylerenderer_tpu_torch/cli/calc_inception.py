"""Inception statistics of real data for FID (counterpart of
``stylerenderer_tpu/cli/calc_inception.py``).

python -m stylerenderer_tpu_torch.cli.calc_inception DATA \\
    [--size 256 --batch 64 --n_sample 50000 --out inception_stats.pkl] \\
    [--inception_weights FID_INCEPTION.pth] [--device cuda|cpu]

Reads an SRPack shard or a folder of images (resized as they are read)
and writes the pool3 mean and covariance in the JAX package's pickle, so
either package's ``cli.fid`` reads them. Runs on the card unless
``--device cpu``.
"""

from __future__ import annotations

import argparse
import os

import torch


def build_argparser():
    p = argparse.ArgumentParser(description="inception stats for FID (PyTorch)")
    p.add_argument("path", type=str, help="SRPack shard or image folder")
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--n_sample", type=int, default=50_000)
    p.add_argument("--out", type=str, default="")
    p.add_argument("--inception_weights", type=str, default="",
                   help="torch FID-inception state dict (optional)")
    p.add_argument("--device", type=str, default="cuda")
    return p


def main(argv=None):
    args = build_argparser().parse_args(argv)
    from stylerenderer_tpu_torch.data import SRPackDataset, open_dataset, prefetch_batches
    from stylerenderer_tpu_torch.device import resolve_device
    from stylerenderer_tpu_torch.eval import (
        extract_features_from_dataset, feature_stats, load_patched_inception_v3, save_stats,
    )

    device = resolve_device(args.device)
    ds = open_dataset(args.path, resolution=args.size)
    try:
        n = min(args.n_sample, len(ds))
        inception = load_patched_inception_v3(args.inception_weights or None, device=device)
        it = prefetch_batches(ds, args.batch, train=False, drop_last=True)
        try:
            feats = extract_features_from_dataset((b.to(device) for b in it), inception, n)
        finally:
            it.close()
    finally:
        if isinstance(ds, SRPackDataset):
            ds.reader.close()
    mu, cov = feature_stats(feats)
    out = args.out or f"inception_{os.path.basename(args.path)}.pkl"
    save_stats(out, mu, cov, meta={"size": args.size, "n": len(feats),
                                   "pretrained": bool(args.inception_weights)})
    print(f"wrote stats for {len(feats)} images -> {out}")
    return out


if __name__ == "__main__":
    main()

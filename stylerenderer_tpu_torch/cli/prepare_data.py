"""Data preparation CLI (counterpart of
``stylerenderer_tpu/cli/prepare_data.py``): an image folder -> a
multi-resolution SRPack shard that ``cli.train`` reads.

python -m stylerenderer_tpu_torch.cli.prepare_data PATH --out data.srpack \\
    [--size 128,256,512,1024 --n_worker 8 --codec raw|jpeg --resample lanczos --limit N]

Host work only (PIL and a pool of worker processes); the shard's bytes
equal the JAX package's.
"""

from __future__ import annotations

import argparse


def build_argparser():
    p = argparse.ArgumentParser(description="images -> multi-resolution SRPack (PyTorch port)")
    p.add_argument("path", type=str, help="input image folder")
    p.add_argument("--out", type=str, required=True, help="output .srpack path")
    p.add_argument("--size", type=str, default="128,256,512,1024")
    p.add_argument("--n_worker", type=int, default=8)
    p.add_argument("--codec", type=str, default="raw", choices=["raw", "jpeg"])
    p.add_argument("--resample", type=str, default="lanczos",
                   choices=["lanczos", "bilinear", "bicubic", "box", "nearest"])
    p.add_argument("--limit", type=int, default=0)
    return p


def main(argv=None):
    args = build_argparser().parse_args(argv)
    from stylerenderer_tpu_torch.data.prepare import prepare

    sizes = [int(s) for s in args.size.split(",")]
    n = prepare(args.path, args.out, sizes, args.n_worker, args.codec, args.resample,
                args.limit or None)
    print(f"wrote {n} items x sizes {sizes} -> {args.out}")
    return n


if __name__ == "__main__":
    main()

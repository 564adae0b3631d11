"""The metric-parity runbook with the published weights (counterpart of the
JAX package's ``scripts/parity_eval.py``). The published FID Inception
(``pt_inception-2015-12-05``), torchvision's VGG16 and the LPIPS v0.1
linear heads are not in the repository and are never downloaded: this
script takes their paths.

    python -m stylerenderer_tpu_torch.scripts.parity_eval \\
        --inception pt_inception-2015-12-05.pth --vgg vgg16.pth --lpips_lin vgg.pth \\
        --ckpt torch_demos/train_demo256/checkpoint --data faces256.srpack \\
        --size 256 --with_map

1. An audit of each file: the port's networks carry the published names,
   so no conversion is needed; every key of the file must be consumed with
   its shape (apart from the heads the metric does not use: the Inception's
   ``fc`` and ``AuxLogits``, VGG's ``classifier``), every parameter of the
   network must be in the file, and the networks loaded by
   ``eval/inception.py::load_patched_inception_v3`` and
   ``eval/lpips.py::load_lpips`` must hold the file's tensors.
2. The reference protocols, run by the port: FID (real statistics over
   ``--data``, ``--n_fid`` generator samples, pool3), LPIPS (the mean over
   the dataset's pairs (2i, 2i+1)) and PPL (``--n_ppl`` samples, eps 1e-4,
   W-space end sampling, the center crop at 256 px and up, the 1-99
   percentile filter).

``--dry_run`` writes seeded stand-in state dicts of the published layouts
(and, without ``--data``, a synth shard) under ``--out`` and runs the
whole runbook at toy scale. The report goes to ``--out``/parity_eval.json
(default ``torch_demos/parity_eval``).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from stylerenderer_tpu_torch.scripts._common import default_out

# what the published files hold beyond the metric's networks
INCEPTION_UNUSED = ("fc.", "AuxLogits.")
VGG_UNUSED = ("classifier.",)
LPIPS_CHANNELS = (64, 128, 256, 512, 512)


def build_argparser():
    p = argparse.ArgumentParser(description="FID/PPL/LPIPS with the published weights")
    p.add_argument("--inception", type=str, default="",
                   help="pt_inception-2015-12-05 state dict (.pth)")
    p.add_argument("--vgg", type=str, default="", help="torchvision vgg16 state dict (.pth)")
    p.add_argument("--lpips_lin", type=str, default="",
                   help="LPIPS v0.1 linear heads (default: weights/lpips/v0.1/vgg.pth)")
    p.add_argument("--ckpt", type=str, default="",
                   help="cli.train checkpoint directory (empty: a seeded generator)")
    p.add_argument("--data", type=str, default="", help="SRPack shard or image folder")
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--latent", type=int, default=512)
    p.add_argument("--n_mlp", type=int, default=8)
    p.add_argument("--channel_multiplier", type=int, default=2)
    p.add_argument("--with_map", action="store_true")
    p.add_argument("--bfm", type=str, default="")
    p.add_argument("--n_fid", type=int, default=50_000)
    p.add_argument("--n_ppl", type=int, default=5_000)
    p.add_argument("--n_lpips_pairs", type=int, default=64)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", type=str, default="")
    p.add_argument("--dry_run", action="store_true",
                   help="seeded stand-ins of the published files and a toy scale")
    p.add_argument("--device", type=str, default="cuda")
    return p


def _load_state_dict(path: str) -> dict:
    sd = torch.load(path, map_location="cpu")
    return sd.state_dict() if hasattr(sd, "state_dict") else sd


def audit(path: str, own: dict, unused: tuple[str, ...], loaded: dict) -> dict:
    """Key and shape audit of the file at ``path`` against the network's
    state dict ``own`` (``num_batches_tracked`` buffers aside), and the
    largest difference between the file's tensors and ``loaded``, the
    network as its loader built it."""
    sd = _load_state_dict(path)
    own = {k: v for k, v in own.items() if not k.endswith("num_batches_tracked")}
    consumed = [k for k in sd if k in own and tuple(sd[k].shape) == tuple(own[k].shape)]
    mismatch = [k for k in sd if k in own and k not in consumed]
    unconsumed = [k for k in sd if k not in own]
    missing = [k for k in own if k not in sd]
    max_diff = max((float((sd[k].float() - loaded[k].float().cpu()).abs().max())
                    for k in consumed), default=0.0)
    ok = (not mismatch and not missing and max_diff == 0.0
          and all(k.startswith(unused) for k in unconsumed))
    return {"keys_in_file": len(sd), "consumed": len(consumed), "shape_mismatch": mismatch,
            "missing": missing, "unconsumed": unconsumed, "max_abs_diff": max_diff,
            "ok": bool(ok)}


def write_standins(root: str, seed: int = 0) -> dict:
    """Seeded state dicts in the published layouts: the FID Inception (its
    BN statistics off identity, and the 1008-way ``fc``), torchvision's VGG16
    ``features`` trunk, and the LPIPS heads ``lin{i}.model.1.weight``."""
    from stylerenderer_tpu_torch.eval.inception import InceptionV3
    from stylerenderer_tpu_torch.eval.lpips import CONV_INDICES

    os.makedirs(root, exist_ok=True)
    g = torch.Generator().manual_seed(seed)
    inc = {}
    for k, v in InceptionV3().state_dict().items():
        if k.endswith("num_batches_tracked"):
            continue
        if k.endswith("running_var") or (k.endswith(".weight") and ".bn." in k):
            inc[k] = 0.75 + 0.5 * torch.rand(v.shape, generator=g)
        elif v.ndim == 4:
            inc[k] = torch.randn(v.shape, generator=g) * (2.0 / v[0].numel()) ** 0.5
        else:
            inc[k] = torch.randn(v.shape, generator=g) * 0.1
    inc["fc.weight"] = torch.randn(1008, 2048, generator=g) * 0.01
    inc["fc.bias"] = torch.zeros(1008)
    vgg, cin = {}, 3
    for tid, c in zip(CONV_INDICES["vgg"], (64, 64, 128, 128, 256, 256, 256, 512, 512, 512,
                                            512, 512, 512)):
        scale = (2.0 / (9 * cin)) ** 0.5
        vgg[f"features.{tid}.weight"] = torch.randn(c, cin, 3, 3, generator=g) * scale
        vgg[f"features.{tid}.bias"] = torch.randn(c, generator=g) * 0.01
        cin = c
    lin = {f"lin{i}.model.1.weight": torch.rand(1, c, 1, 1, generator=g)
           for i, c in enumerate(LPIPS_CHANNELS)}
    paths = {}
    for name, sd in (("inception", inc), ("vgg", vgg), ("lpips_lin", lin)):
        paths[name] = os.path.join(root, f"{name}_standin.pth")
        torch.save(sd, paths[name])
    return paths


def _dataset_pairs(ds, n_pairs: int, device):
    n = min(2 * n_pairs, len(ds) - len(ds) % 2)
    imgs = np.stack([np.asarray(ds[i]) for i in range(n)]).astype(np.float32) / 127.5 - 1.0
    t = torch.from_numpy(imgs).permute(0, 3, 1, 2).contiguous().to(device)
    return t[0::2], t[1::2]


@torch.no_grad()
def main(argv=None) -> dict:
    args = build_argparser().parse_args(argv)
    from stylerenderer_tpu_torch.cli.fid import make_sampler as make_fid_sampler
    from stylerenderer_tpu_torch.cli.ppl import make_sampler as make_ppl_sampler
    from stylerenderer_tpu_torch.data import SRPackDataset, open_dataset, prefetch_batches
    from stylerenderer_tpu_torch.device import resolve_device
    from stylerenderer_tpu_torch.eval import (
        compute_fid, compute_ppl, extract_features_from_dataset, extract_features_from_samples,
        feature_stats, load_lpips, load_patched_inception_v3,
    )
    from stylerenderer_tpu_torch.eval.inception import InceptionV3
    from stylerenderer_tpu_torch.eval.lpips import HEADS_DIR, LPIPS
    from stylerenderer_tpu_torch.face3d import load_face_model
    from stylerenderer_tpu_torch.models import Generator, GeneratorWithMap

    device = resolve_device(args.device)
    out = os.path.abspath(args.out or default_out("parity_eval"))
    os.makedirs(out, exist_ok=True)
    report: dict = {"protocol": {
        "fid": "real mu/cov over --data + N generator samples, FID-InceptionV3 pool3",
        "ppl": "N samples, eps=1e-4, W end, LPIPS net-lin vgg, crop at >= 256 px, "
               "1-99 pct filter",
        "lpips": "mean over the dataset's pairs (2i, 2i+1)",
    }}
    if args.dry_run:
        paths = write_standins(os.path.join(out, "standins"), args.seed)
        args.inception, args.vgg, args.lpips_lin = (paths["inception"], paths["vgg"],
                                                    paths["lpips_lin"])
        if not args.data:
            from stylerenderer_tpu_torch.data import write_synth_dataset

            args.data = os.path.join(out, "standins", "synth.srpack")
            face, tri = load_face_model(args.bfm, device=device)
            write_synth_dataset(args.data, 48, size=args.size, batch=16, face=face, tri=tri,
                                device=device)
        args.n_fid = min(args.n_fid, 32)
        args.n_ppl = min(args.n_ppl, 16)
        args.n_lpips_pairs = min(args.n_lpips_pairs, 8)
        args.batch = min(args.batch, 8)
        report["dry_run"] = True
    if not args.lpips_lin:
        cand = os.path.join(HEADS_DIR, "vgg.pth")
        args.lpips_lin = cand if os.path.exists(cand) else ""

    # ---- stage 1: the audits, and the networks as their loaders build them ----
    t0 = time.perf_counter()
    inception = load_patched_inception_v3(args.inception or None, device=device)
    lpips = load_lpips("vgg", backbone_weights=args.vgg or None,
                       linear_weights=args.lpips_lin or None, device=device)
    if args.inception:
        report["audit_inception"] = audit(args.inception, InceptionV3().state_dict(),
                                          INCEPTION_UNUSED, inception.state_dict())
    if args.vgg:
        own = {k: v for k, v in LPIPS("vgg").state_dict().items() if k.startswith("features.")}
        report["audit_vgg"] = audit(args.vgg, own, VGG_UNUSED, lpips.state_dict())
    if args.lpips_lin:
        own = {k: v for k, v in LPIPS("vgg").state_dict().items() if k.startswith("lin")}
        report["audit_lpips_lin"] = audit(args.lpips_lin, own, (), lpips.state_dict())
    report["audit_seconds"] = time.perf_counter() - t0
    for k in ("audit_inception", "audit_vgg", "audit_lpips_lin"):
        if k in report:
            print(f"{k}: {report[k]}", flush=True)

    # ---- stage 2: the generator under test ----
    widths = dict(channel_multiplier=args.channel_multiplier, device=device)
    cls = GeneratorWithMap if args.with_map else Generator
    if args.ckpt:
        from stylerenderer_tpu_torch.utils.checkpoint import (
            load_generator_weights, load_params_only,
        )

        _, cfg = load_params_only(args.ckpt)
        gen = cls(cfg.size, cfg.latent, cfg.n_mlp, channel_multiplier=cfg.channel_multiplier,
                  device=device)
        load_generator_weights(args.ckpt, gen)
        args.size = cfg.size
    else:
        gen = cls(args.size, args.latent, args.n_mlp, seed=7, **widths)
        report["generator"] = "seeded (no --ckpt)"
    gen.eval()
    mesh_model = load_face_model(args.bfm, device=device) if args.with_map else None

    # ---- stages 3 and 4: FID, and LPIPS over fixed dataset pairs ----
    if args.data:
        ds = open_dataset(args.data, resolution=args.size)
        try:
            t0 = time.perf_counter()
            n_real = min(args.n_fid, len(ds))
            it = prefetch_batches(ds, min(args.batch, n_real), train=False, drop_last=True)
            try:
                real = extract_features_from_dataset((b.to(device) for b in it), inception,
                                                     n_real)
            finally:
                it.close()
            real_mu, real_cov = feature_stats(real)
            sample = make_fid_sampler(gen, mesh_model,
                                      torch.Generator(device=device).manual_seed(args.seed + 1))
            fake = extract_features_from_samples(sample, inception, args.n_fid, args.batch,
                                                 torch.Generator().manual_seed(args.seed))
            report["fid"] = {"value": float(compute_fid(fake, real_mu, real_cov)),
                             "n_real": int(len(real)), "n_fake": int(args.n_fid),
                             "pretrained_inception": bool(args.inception),
                             "seconds": time.perf_counter() - t0}
            print(f"fid: {report['fid']}", flush=True)
            d = lpips(*_dataset_pairs(ds, args.n_lpips_pairs, device))
            report["lpips_fixed_pairs"] = {"mean": float(d.mean()), "n_pairs": int(len(d))}
            print(f"lpips fixed pairs: {report['lpips_fixed_pairs']}", flush=True)
        finally:
            if isinstance(ds, SRPackDataset):
                ds.reader.close()

    # ---- stage 5: PPL ----
    t0 = time.perf_counter()
    sampler = make_ppl_sampler(gen, lpips, args.batch, mesh_model, space="w", sampling="end",
                               eps=1e-4, crop=args.size >= 256)
    report["ppl"] = {"value": float(compute_ppl(sampler, torch.Generator().manual_seed(args.seed),
                                                args.n_ppl, args.batch)),
                     "n_sample": int(args.n_ppl), "pretrained_vgg": bool(args.vgg),
                     "published_linear_heads": bool(args.lpips_lin),
                     "seconds": time.perf_counter() - t0}
    print(f"ppl: {report['ppl']}", flush=True)

    path = os.path.join(out, "parity_eval.json")
    with open(path, "w") as f:
        json.dump(report, f, indent=1)
    print(f"wrote {path}")
    return report


if __name__ == "__main__":
    main()

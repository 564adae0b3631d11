"""Face alignment CLI (counterpart of ``stylerenderer_tpu/cli/align.py``).

python -m stylerenderer_tpu_torch.cli.align PHOTOS/ --out ALIGNED/ \\
    [--lmk_dir LMKS/ | --lmk_manifest M.txt | --dlib PREDICTOR.dat | --exec BIN] \\
    [--size 256 --bfm BFM.mat [--lmk_vidx i,j,... | --render_ref]] [--device cuda|cpu]

Warps every photo so that its landmarks land on the canonical reference:
the face model's landmark vertices (``--lmk_vidx``; without them 68
vertices spread over the mesh) projected at ``--size``, or, with
``--render_ref``, the detector run on the BFM's textured mean face
rendered at that size (the detector must take images: ``--dlib`` or
``--exec``). The face model is the BFM of ``--bfm``, else the synthetic
face. The render and the warps run on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse


def build_argparser():
    p = argparse.ArgumentParser(description="align faces to the canonical pose (PyTorch)")
    p.add_argument("path", type=str, help="input photo folder")
    p.add_argument("--out", type=str, required=True)
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--bfm", type=str, default="", help="BFM .mat (else the synthetic face)")
    p.add_argument("--lmk_dir", type=str, default="",
                   help="precomputed landmark .txt files (one per image)")
    p.add_argument("--lmk_manifest", type=str, default="",
                   help="single manifest txt: 'name.png x0 y0 x1 y1 ...' lines")
    p.add_argument("--dlib", type=str, default="", help="dlib 68-point shape predictor path")
    p.add_argument("--exec", dest="exec_path", type=str, default="",
                   help="external landmark-detector binary")
    p.add_argument("--lmk_vidx", type=str, default="",
                   help="comma-separated landmark vertex ids of the face model")
    p.add_argument("--render_ref", action="store_true",
                   help="build the canonical reference by rasterizing the textured mean face "
                        "and detecting landmarks on the render (needs --bfm with a 'tex' "
                        "field, and --dlib or --exec)")
    p.add_argument("--device", type=str, default="cuda")
    return p


def main(argv=None):
    parser = build_argparser()
    args = parser.parse_args(argv)
    if args.render_ref and (args.lmk_dir or args.lmk_manifest):
        parser.error("--render_ref runs the detector on the mean-face render; landmark "
                     "files (--lmk_dir, --lmk_manifest) cannot: use --dlib or --exec")

    import numpy as np

    from stylerenderer_tpu_torch.device import resolve_device
    from stylerenderer_tpu_torch.face3d import load_bfm_texture, load_face_model
    from stylerenderer_tpu_torch.face3d.alignment import (
        LandmarksDetectorDlib, LandmarksDetectorExec, LandmarksManifestReader,
        LandmarksReader, align_dataset,
    )

    if args.lmk_dir:
        detector = LandmarksReader(args.lmk_dir)
    elif args.lmk_manifest:
        detector = LandmarksManifestReader(args.lmk_manifest)
    elif args.dlib:
        detector = LandmarksDetectorDlib(args.dlib)
    elif args.exec_path:
        detector = LandmarksDetectorExec(args.exec_path)
    else:
        parser.error("need --lmk_dir / --lmk_manifest / --dlib / --exec for landmarks")

    face, tri = load_face_model(args.bfm, device=resolve_device(args.device))
    tex = load_bfm_texture(args.bfm) if (args.render_ref and args.bfm) else None
    if args.render_ref and tex is None:
        parser.error("--render_ref needs a --bfm .mat with a 'tex' field")
    if args.lmk_vidx:
        lmk_vidx = np.asarray([int(i) for i in args.lmk_vidx.split(",")])
    elif tex is None:
        # spread over the mesh (real use: the face model's landmark ids, or --render_ref)
        lmk_vidx = np.linspace(0, face.mean.shape[0] // 3 - 1, 68).astype(np.int64)
    else:
        lmk_vidx = None
    n = align_dataset(args.path, args.out, detector, face, tri, lmk_vidx, args.size, tex=tex)
    print(f"aligned {n} photos -> {args.out}")
    return n


if __name__ == "__main__":
    main()

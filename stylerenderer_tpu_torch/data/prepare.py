"""Dataset preparation (counterpart of ``stylerenderer_tpu/data/prepare.py``):
an image folder -> a multi-resolution SRPack shard.

Every image is resized with PIL (``LANCZOS`` by default) to each size,
in a pool of worker processes, and stored raw (decode-free reading) or as
a JPEG at quality 100. The shard's bytes equal the JAX package's for the
same folder and arguments.
"""

from __future__ import annotations

import io
import multiprocessing
from functools import partial
from typing import Sequence

import numpy as np

from stylerenderer_tpu_torch.data.dataset import list_images
from stylerenderer_tpu_torch.data.srpack import SRPackWriter

_RESAMPLE = {"lanczos": "LANCZOS", "bilinear": "BILINEAR", "bicubic": "BICUBIC",
             "box": "BOX", "nearest": "NEAREST"}


def _load_and_resize(path: str, sizes: Sequence[int], codec: str, resample: str,
                     quality: int = 100):
    """One image at every size: uint8 ``[s, s, 3]`` arrays (``raw``) or JPEG
    bytes (``jpeg``)."""
    from PIL import Image

    rs = getattr(Image, _RESAMPLE.get(resample, "LANCZOS"))
    with Image.open(path) as im:
        img = im.convert("RGB")
    out = []
    for s in sizes:
        r = img.resize((s, s), rs)
        if codec == "raw":
            out.append(np.asarray(r, np.uint8))
        else:
            buf = io.BytesIO()
            r.save(buf, format="jpeg", quality=quality)
            out.append(buf.getvalue())
    return out


def prepare(in_dir: str, out_path: str, sizes: Sequence[int] = (128, 256, 512, 1024),
            n_workers: int = 8, codec: str = "raw", resample: str = "lanczos",
            limit: int | None = None) -> int:
    """Write the images under ``in_dir`` (the first ``limit``, sorted) to the
    SRPack ``out_path`` at every size; returns the item count."""
    files = list_images(in_dir)
    if limit:
        files = files[:limit]
    if not files:
        raise ValueError(f"no images under {in_dir}")
    writer = SRPackWriter(out_path, sizes, codec)
    fn = partial(_load_and_resize, sizes=sizes, codec=codec, resample=resample)
    if n_workers > 1:
        with multiprocessing.get_context("spawn").Pool(n_workers) as pool:
            for rec in pool.imap(fn, files, chunksize=8):
                writer.add(rec)
    else:
        for f in files:
            writer.add(fn(f))
    return writer.finalize()

"""SRPack writer (the port's own copy of the writer in
``stylerenderer_tpu/data/srpack.py``; the same bytes on disk).

A shard holds every image at every requested resolution behind a flat
(offset, length) index:

- header: ``b"SRPK"``, then little-endian u32 version (1), u32 codec,
  u32 number of sizes, u64 number of items;
- the sizes, u32 each;
- the index, one (u64 offset, u64 length) per record, size-major;
- the records, in the same order.

Codecs: ``raw`` (uint8 HWC pixels, decode-free) and ``jpeg`` (encoded
bytes as given). The native reader comes with the training slice.
"""

from __future__ import annotations

import struct
from typing import Sequence

import numpy as np

_MAGIC = b"SRPK"
CODEC_RAW = 0
CODEC_JPEG = 1


class SRPackWriter:
    """Two-pass writer: stage records, then emit header+index+blob."""

    def __init__(self, path: str, sizes: Sequence[int], codec: str = "raw"):
        self.path = path
        self.sizes = [int(s) for s in sizes]
        self.codec = CODEC_RAW if codec == "raw" else CODEC_JPEG
        self._records: list[list[bytes]] = [[] for _ in self.sizes]

    def add(self, per_size_images):
        """per_size_images: list parallel to ``sizes``; each entry either a
        uint8 HWC array (raw) or encoded bytes (jpeg)."""
        if len(per_size_images) != len(self.sizes):
            raise ValueError(f"{len(per_size_images)} images for {len(self.sizes)} sizes")
        for i, img in enumerate(per_size_images):
            if self.codec == CODEC_RAW:
                arr = np.ascontiguousarray(img, np.uint8)
                s = self.sizes[i]
                if arr.shape != (s, s, 3):
                    raise ValueError(f"image {arr.shape}, expected {(s, s, 3)}")
                self._records[i].append(arr.tobytes())
            else:
                self._records[i].append(bytes(img))

    def finalize(self) -> int:
        """Write the shard; returns the number of items."""
        n_items = len(self._records[0])
        if any(len(r) != n_items for r in self._records):
            raise ValueError("every size needs the same number of images")
        header = _MAGIC + struct.pack("<IIIQ", 1, self.codec, len(self.sizes), n_items)
        sizes_blob = struct.pack(f"<{len(self.sizes)}I", *self.sizes)
        index = []
        offset = 0
        for recs in self._records:
            for r in recs:
                index.append((offset, len(r)))
                offset += len(r)
        index_blob = b"".join(struct.pack("<QQ", o, n) for o, n in index)
        with open(self.path, "wb") as f:
            f.write(header)
            f.write(sizes_blob)
            f.write(index_blob)
            for recs in self._records:
                for r in recs:
                    f.write(r)
        return n_items

"""SRPack writer and reader (the port's own copy of
``stylerenderer_tpu/data/srpack.py``; the same bytes on disk).

A shard holds every image at every requested resolution behind a flat
(offset, length) index:

- header: ``b"SRPK"``, then little-endian u32 version (1), u32 codec,
  u32 number of sizes, u64 number of items;
- the sizes, u32 each;
- the index, one (u64 offset, u64 length) per record, size-major;
- the records, in the same order.

Codecs: ``raw`` (uint8 HWC pixels, decode-free) and ``jpeg`` (encoded
bytes as given, decoded with PIL on read). The reader mmaps the shard in
native code (``csrc/srpack.cpp``, built with g++ at first use, loaded
with ``ctypes``) and gathers raw batches with a pool of threads.
"""

from __future__ import annotations

import ctypes
import io
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


class SRPackReader:
    """mmap'd reader over the native library; ``close()`` (or a ``with``
    block) unmaps the shard."""

    def __init__(self, path: str):
        from stylerenderer_tpu_torch.ops._build import library

        self._lib = library("srpack")
        self._h = self._lib.srpack_open(path.encode())
        if not self._h:
            raise IOError(f"cannot open SRPack file {path!r}")
        self.path = path
        self.n_items = int(self._lib.srpack_n_items(self._h))
        self.codec = int(self._lib.srpack_codec(self._h))
        sizes = (ctypes.c_uint32 * int(self._lib.srpack_n_sizes(self._h)))()
        self._lib.srpack_sizes(self._h, sizes)
        self.sizes = [int(s) for s in sizes]

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def size_index(self, resolution: int) -> int:
        if resolution not in self.sizes:
            raise KeyError(f"resolution {resolution} not in pack (have {self.sizes})")
        return self.sizes.index(resolution)

    def _check_item(self, item: int) -> None:
        if not 0 <= item < self.n_items:
            raise IndexError(f"item {item} out of range for {self.n_items} items")

    def read_record(self, resolution: int, item: int) -> bytes:
        """One record's bytes, whatever the codec."""
        si = self.size_index(resolution)
        self._check_item(item)
        n = int(self._lib.srpack_record_length(self._h, si, item))
        buf = (ctypes.c_uint8 * n)()
        got = int(self._lib.srpack_read_record(self._h, si, item, buf, n))
        return bytes(buf)[:got]

    def read_batch_raw(self, resolution: int, items) -> np.ndarray:
        """Batched zero-decode read (raw codec): -> uint8 ``[N, s, s, 3]``."""
        if self.codec != CODEC_RAW:
            raise ValueError(f"{self.path}: JPEG shard; read it with decode()")
        si = self.size_index(resolution)
        items = np.ascontiguousarray(items, np.int64)
        stride = resolution * resolution * 3
        out = np.empty((len(items), resolution, resolution, 3), np.uint8)
        rc = self._lib.srpack_read_batch(self._h, si, items.ctypes.data, len(items),
                                         out.ctypes.data, stride)
        if rc != 0:
            raise IndexError(f"srpack_read_batch failed (rc={rc}): items out of range "
                             f"for {self.n_items} items")
        return out

    def decode(self, resolution: int, item: int) -> np.ndarray:
        """-> uint8 ``[s, s, 3]``, whatever the codec."""
        self._check_item(item)
        if self.codec == CODEC_RAW:
            return self.read_batch_raw(resolution, np.asarray([item]))[0]
        from PIL import Image

        with Image.open(io.BytesIO(self.read_record(resolution, item))) as im:
            return np.asarray(im.convert("RGB"))

    def close(self) -> None:
        if self._h:
            self._lib.srpack_close(self._h)
            self._h = None

    def __del__(self):
        if getattr(self, "_h", None):
            self.close()

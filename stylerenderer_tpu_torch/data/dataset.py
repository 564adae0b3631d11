"""Training data (counterpart of ``stylerenderer_tpu/data/dataset.py``):
an SRPack dataset, an image-folder dataset, a background-thread batch
pipeline and a device prefetch.

- ``SRPackDataset``: the images of one resolution of an SRPack shard
  (raw: read natively in batches; JPEG: decoded with PIL item by item);
- ``ImageFolderDataset``: a folder of images, found recursively by
  extension and resized with PIL's ``LANCZOS`` as they are read;
- ``prefetch_batches``: batches read natively and turned into training
  tensors (random horizontal flip, [-1, 1], NCHW float32) in a background
  thread, seeded, optionally in pinned memory;
- ``device_prefetch``: keeps ``depth`` batches in flight to the device with
  ``non_blocking`` copies, so the copy overlaps the step.
"""

from __future__ import annotations

import collections
import os
import queue
import threading
from typing import Iterator, Sequence

import numpy as np
import torch

from stylerenderer_tpu_torch.data.srpack import CODEC_RAW, SRPackReader

IMG_EXTENSIONS = (".png", ".jpg", ".jpeg", ".bmp", ".webp", ".ppm", ".tif", ".tiff")


def list_images(root: str, extensions: Sequence[str] = IMG_EXTENSIONS) -> list[str]:
    """Every file under ``root`` (recursively) with an image extension, sorted."""
    return sorted(os.path.join(dirpath, n) for dirpath, _, names in os.walk(root)
                  for n in names if os.path.splitext(n)[1].lower() in extensions)


def to_train_tensor(batch_u8: np.ndarray, rng: np.random.Generator | None = None,
                    hflip: bool = True, flips: np.ndarray | None = None) -> torch.Tensor:
    """uint8 ``[B, H, W, 3]`` -> float32 ``[B, 3, H, W]`` in [-1, 1], each
    sample flipped horizontally with probability 1/2 (drawn from ``rng``,
    or given as the boolean ``flips``)."""
    x = batch_u8.astype(np.float32) / 127.5 - 1.0
    if hflip and flips is None and rng is not None:
        flips = rng.random(len(x)) < 0.5
    if hflip and flips is not None:
        x[flips] = x[flips, :, ::-1]
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


class SRPackDataset:
    """The images at ``resolution`` of an SRPack shard."""

    def __init__(self, path: str, resolution: int = 256):
        self.reader = SRPackReader(path)
        if resolution not in self.reader.sizes:
            raise ValueError(f"resolution {resolution} missing from {path} "
                             f"(available: {self.reader.sizes})")
        self.resolution = resolution

    def __len__(self) -> int:
        return self.reader.n_items

    def __getitem__(self, idx: int) -> np.ndarray:
        return self.reader.decode(self.resolution, idx)

    def read_batch(self, indices) -> np.ndarray:
        if self.reader.codec == CODEC_RAW:
            return self.reader.read_batch_raw(self.resolution, indices)
        return np.stack([self.reader.decode(self.resolution, int(i)) for i in indices])


class ImageFolderDataset:
    """The images under ``root`` (recursively, by extension, sorted), each
    resized to ``resolution`` (0 keeps its size) with PIL's ``LANCZOS``
    as it is read."""

    def __init__(self, root: str, resolution: int = 256,
                 extensions: Sequence[str] = IMG_EXTENSIONS):
        self.root = root
        self.resolution = resolution
        self.files = list_images(root, extensions)

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, idx: int) -> np.ndarray:
        from PIL import Image

        with Image.open(self.files[idx]) as im:
            img = im.convert("RGB")
        if self.resolution:
            img = img.resize((self.resolution, self.resolution), Image.LANCZOS)
        return np.asarray(img)

    def read_batch(self, indices) -> np.ndarray:
        return np.stack([self[int(i)] for i in indices])


def open_dataset(path: str, resolution: int = 256):
    """``ImageFolderDataset`` for a directory, else ``SRPackDataset``."""
    if os.path.isdir(path):
        return ImageFolderDataset(path, resolution=resolution)
    return SRPackDataset(path, resolution=resolution)


def prefetch_batches(dataset, batch_size: int, *, seed: int = 0, train: bool = True,
                     depth: int = 3, drop_last: bool = True, pin_memory: bool = False,
                     rows: slice | None = None) -> Iterator[torch.Tensor]:
    """Endless (``train``: shuffled epochs, random flips) or single-epoch
    iterator of float32 ``[B, 3, H, W]`` batches in [-1, 1], assembled in a
    background thread; ``pin_memory`` puts them in page-locked memory for
    ``non_blocking`` copies. An error in the thread is raised here.

    ``rows`` (a rank's ``Mesh.rows(batch_size)``): only those rows of each
    batch are read and yielded. Every rank runs the same seeded shuffle and
    flip draws, so its rows are those of the one-process batch."""
    n = len(dataset)
    if n < (batch_size if drop_last else 1):
        raise ValueError(f"{n} images cannot fill a batch of {batch_size}")
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()
    end = object()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.5)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        rng = np.random.default_rng(seed)
        try:
            while not stop.is_set():
                order = rng.permutation(n) if train else np.arange(n)
                for i in range(0, n - (batch_size - 1 if drop_last else 0), batch_size):
                    idx = order[i:i + batch_size]
                    flips = rng.random(len(idx)) < 0.5 if train else None
                    if rows is not None:
                        idx, flips = idx[rows], None if flips is None else flips[rows]
                    batch = to_train_tensor(dataset.read_batch(idx), hflip=train, flips=flips)
                    if not put(batch.pin_memory() if pin_memory else batch):
                        return
                if not train:
                    put(end)
                    return
        except Exception as e:  # noqa: BLE001 - handed to the consumer, which raises it
            put(e)

    thread = threading.Thread(target=worker, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is end:
                return
            if isinstance(item, Exception):
                raise item
            yield item
    finally:
        stop.set()
        thread.join(timeout=5.0)


def device_prefetch(iterator, device, depth: int = 2) -> Iterator[torch.Tensor]:
    """Copy the batches of ``iterator`` to ``device`` ``depth`` ahead of the
    consumer, without blocking the host (``non_blocking``; from pinned
    memory the copy overlaps the device's work)."""
    buf: collections.deque = collections.deque()
    for batch in iterator:
        buf.append(batch.to(device, non_blocking=True))
        if len(buf) >= depth:
            yield buf.popleft()
    while buf:
        yield buf.popleft()

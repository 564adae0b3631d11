"""Data: the SRPack shard writer and reader, the training datasets and
their prefetching, dataset preparation from an image folder, and the
synthetic shaded-face dataset."""

from stylerenderer_tpu_torch.data.dataset import (
    IMG_EXTENSIONS,
    ImageFolderDataset,
    SRPackDataset,
    device_prefetch,
    list_images,
    open_dataset,
    prefetch_batches,
    to_train_tensor,
)
from stylerenderer_tpu_torch.data.prepare import prepare
from stylerenderer_tpu_torch.data.srpack import SRPackReader, SRPackWriter
from stylerenderer_tpu_torch.data.synth import (
    make_synth_batch,
    shade_faces,
    write_synth_dataset,
)

__all__ = [
    "IMG_EXTENSIONS", "ImageFolderDataset", "SRPackDataset", "SRPackReader", "SRPackWriter",
    "device_prefetch", "list_images", "make_synth_batch", "open_dataset", "prefetch_batches",
    "prepare",
    "shade_faces", "to_train_tensor", "write_synth_dataset",
]

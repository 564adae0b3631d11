"""Data: the SRPack shard writer and reader, the training datasets and
their prefetching, and the synthetic shaded-face dataset."""

from stylerenderer_tpu_torch.data.dataset import (
    SRPackDataset,
    device_prefetch,
    prefetch_batches,
    to_train_tensor,
)
from stylerenderer_tpu_torch.data.srpack import SRPackReader, SRPackWriter
from stylerenderer_tpu_torch.data.synth import (
    make_synth_batch,
    shade_faces,
    write_synth_dataset,
)

__all__ = [
    "SRPackDataset", "SRPackReader", "SRPackWriter", "device_prefetch", "make_synth_batch",
    "prefetch_batches", "shade_faces", "to_train_tensor", "write_synth_dataset",
]

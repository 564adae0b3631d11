"""Data: the SRPack shard writer and the synthetic shaded-face dataset."""

from stylerenderer_tpu_torch.data.srpack import SRPackWriter
from stylerenderer_tpu_torch.data.synth import (
    make_synth_batch,
    shade_faces,
    write_synth_dataset,
)

__all__ = ["SRPackWriter", "make_synth_batch", "shade_faces", "write_synth_dataset"]

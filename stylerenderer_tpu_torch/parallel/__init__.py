"""Data parallelism over ``torch.distributed`` (counterpart of
``stylerenderer_tpu/parallel/``)."""

from stylerenderer_tpu_torch.parallel.mesh import (
    Mesh,
    batch_sharding,
    constrain_batch,
    make_mesh,
    replicate,
    replicated,
    shard_batch,
)

__all__ = [
    "Mesh",
    "batch_sharding",
    "constrain_batch",
    "make_mesh",
    "replicate",
    "replicated",
    "shard_batch",
]

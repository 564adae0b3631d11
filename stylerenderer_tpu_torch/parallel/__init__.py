"""Data parallelism and spatial sharding over ``torch.distributed``
(counterpart of ``stylerenderer_tpu/parallel/``)."""

from stylerenderer_tpu_torch.parallel.mesh import (
    Mesh,
    batch_sharding,
    constrain_batch,
    image_sharding,
    make_mesh,
    make_mesh_2d,
    replicate,
    replicated,
    shard_batch,
    shard_image,
    split_mesh,
)

__all__ = [
    "Mesh",
    "batch_sharding",
    "constrain_batch",
    "image_sharding",
    "make_mesh",
    "make_mesh_2d",
    "replicate",
    "replicated",
    "shard_batch",
    "shard_image",
    "split_mesh",
]

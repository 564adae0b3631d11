"""The GAR generator and the discriminator."""

from stylerenderer_tpu_torch.models.discriminator import Discriminator
from stylerenderer_tpu_torch.models.generator import (
    GeneratorWithMap,
    MappingNetwork,
    StyledMapConv,
    ToRGB,
    channel_table,
    make_noise,
    stored_noise,
)

__all__ = [
    "Discriminator", "GeneratorWithMap", "MappingNetwork", "StyledMapConv", "ToRGB",
    "channel_table", "make_noise", "stored_noise",
]

"""The StyleGAN2 generator, the GAR generator and the discriminator."""

from stylerenderer_tpu_torch.models.discriminator import Discriminator
from stylerenderer_tpu_torch.models.generator import (
    Generator,
    GeneratorWithMap,
    MappingNetwork,
    StyledConv,
    StyledMapConv,
    ToRGB,
    channel_table,
    make_noise,
    stored_noise,
)

__all__ = [
    "Discriminator", "Generator", "GeneratorWithMap", "MappingNetwork", "StyledConv",
    "StyledMapConv", "ToRGB",
    "channel_table", "make_noise", "stored_noise",
]

"""The StyleGAN2 generator, the GAR generator, the discriminator and the Regressor."""

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
from stylerenderer_tpu_torch.models.regressor import Regressor

__all__ = [
    "Discriminator", "Generator", "GeneratorWithMap", "MappingNetwork", "Regressor", "StyledConv",
    "StyledMapConv", "ToRGB",
    "channel_table", "make_noise", "stored_noise",
]

"""Render inverting: fit the GAR's latents, the 3DMM and the pose to photos."""

from stylerenderer_tpu_torch.inversion.project import (
    ProjectorConfig, make_projector, make_projector_jit,
)

__all__ = ["ProjectorConfig", "make_projector", "make_projector_jit"]

"""Self-supervised training of the Regressor, Render Inverting's stage 1
(counterpart of ``stylerenderer_tpu/train/regressor.py``): the GAR renders
its own samples and the Regressor learns to read the latent back,

    z ~ N(0, 1);  w = mapping(z);  img = GAR(w, posed 3DMM sample)
    loss = mean((R(img) - w / sqrt(mean(w^2) + 1e-8))^2)

(the Regressor pixel-norms its output, so it is held to w's direction).

Split as ``train/step.py`` splits its draws from its step:
``sample_regressor_batch`` renders a batch under ``no_grad`` from an
explicit ``torch.Generator`` (z, the 3DMM sample, its pose, the noise),
and ``regressor_step`` takes one Adam step (optax's defaults: ``lr``
1e-4, betas (0.9, 0.999), eps 1e-8) on a given ``(img, w)``.
``make_regressor_fn`` turns the trained net into the projector's init hook
(``inversion/project.py::make_projector(regressor_fn=)``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from stylerenderer_tpu_torch.face3d.geometry import mesh_point_normal, random_apply_pose3D
from stylerenderer_tpu_torch.models.generator import make_noise


@dataclass
class RegressorState:
    regressor: torch.nn.Module
    optim: torch.optim.Adam
    generator: torch.Generator  # the sampler's draws, on the models' device
    step: int = 0


@torch.no_grad()
def sample_regressor_batch(gen, face, tri, batch: int, generator: torch.Generator):
    """``(img [B, 3, size, size], w [B, style_dim])``: ``w`` the mapped
    latent of a fresh z, ``img`` the GAR's render of it (tiled to every
    layer) on a posed random 3DMM sample with fresh noise."""
    dev = gen.device
    z = torch.randn(batch, gen.style_dim, generator=generator, device=generator.device)
    w = gen.get_latent(z.to(dev))
    vert = random_apply_pose3D(generator, face(face.random_input(batch, generator)))
    norm = mesh_point_normal(vert, tri)
    pyramid = gen.normal_pyramid((vert, norm, tri))
    latent = w[:, None, :].repeat(1, gen.n_latent, 1)
    img = gen.synthesize(latent, pyramid, make_noise(gen.size, batch, generator, dev))
    return img, w


def init_regressor_state(regressor, lr: float = 1e-4, seed: int = 0) -> RegressorState:
    """Adam over ``regressor``'s parameters and the sampler's generator on
    its device, seeded with ``seed``."""
    optim = torch.optim.Adam(regressor.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    return RegressorState(regressor.train(), optim,
                          torch.Generator(regressor.device).manual_seed(seed))


def regressor_loss(regressor, img, w):
    """``mean((R(img) - w / sqrt(mean(w^2, -1) + 1e-8))^2)``."""
    w_dir = w / torch.sqrt(torch.mean(w * w, -1, keepdim=True) + 1e-8)
    return torch.mean((regressor(img) - w_dir) ** 2)


def regressor_step(state: RegressorState, img, w) -> dict:
    """One Adam step of ``state.regressor`` on ``(img, w)``; returns
    ``{"regressor_loss": 0-d tensor on the device}``."""
    loss = regressor_loss(state.regressor, img, w)
    state.optim.zero_grad(set_to_none=True)
    loss.backward()
    state.optim.step()
    state.step += 1
    return {"regressor_loss": loss.detach()}


def make_regressor_trainer(regressor, gen, face, tri, *, batch: int, lr: float = 1e-4):
    """The JAX package's call shape: -> ``(init_fn(seed) -> RegressorState,
    step_fn(state) -> metrics)``; ``step_fn`` samples a batch from the
    state's generator, then takes ``regressor_step``. ``gen`` is put in
    eval mode with its parameters frozen."""
    gen.eval().requires_grad_(False)

    def init_fn(seed: int = 0) -> RegressorState:
        return init_regressor_state(regressor, lr, seed)

    def step_fn(state: RegressorState) -> dict:
        img, w = sample_regressor_batch(gen, face, tri, batch, state.generator)
        return regressor_step(state, img, w)

    return init_fn, step_fn


def make_regressor_fn(regressor, mean_w_norm: float = 1.0) -> Callable:
    """The projector's init hook: ``img [B, 3, H, W] -> w [B, D]``, the
    Regressor's output (in eval mode, no gradient) times ``mean_w_norm``;
    the Regressor's own mode is restored after the call."""

    @torch.no_grad()
    def fn(img):
        training = regressor.training
        try:
            return regressor.eval()(img) * mean_w_norm
        finally:
            regressor.train(training)

    return fn

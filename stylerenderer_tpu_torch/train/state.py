"""Training state (counterpart of ``stylerenderer_tpu/train/state.py``): G,
D and the G-EMA, both optimizers, the ADA controller, the path-length
running mean, the step and the step's random generator, in one object
that ``train/step.py`` updates in place and ``utils/checkpoint.py`` saves."""

from __future__ import annotations

import copy
from dataclasses import dataclass, field

import torch

from stylerenderer_tpu_torch.device import resolve_device
from stylerenderer_tpu_torch.models import Discriminator, GeneratorWithMap
from stylerenderer_tpu_torch.utils.config import TrainConfig


@dataclass
class TrainState:
    g: GeneratorWithMap
    d: Discriminator
    g_ema: GeneratorWithMap
    g_optim: torch.optim.Adam
    d_optim: torch.optim.Adam
    generator: torch.Generator  # the step's draws, on the models' device
    mean_path_length: torch.Tensor  # 0-d f32, on the device
    ada_p: torch.Tensor  # 0-d f32
    ada_signs: torch.Tensor  # 0-d f32: accumulated sign(real_pred)
    ada_count: torch.Tensor  # 0-d f32
    step: int = 0  # finite steps taken
    nonfinite_count: int = 0  # steps whose update the finite screen discarded
    # copies of the parameters and optimizer moments taken before each step,
    # for the finite screen to restore from (allocated at the first step)
    backup: list | None = field(default=None, repr=False)

    @property
    def device(self) -> torch.device:
        return self.g.device


def make_optimizers(cfg: TrainConfig, g: torch.nn.Module, d: torch.nn.Module):
    """Adam with the lazy-regularization ratios: ``lr * ratio``,
    ``betas=(0, 0.99 ** ratio)``, ``eps=1e-8`` added after the
    bias-corrected square root, as optax's ``adam`` does. The moments are
    created at once (zeros, step 0), as ``optax``'s ``init`` does, so a
    state can be saved or screened before its first step."""
    def adam(params, ratio):
        opt = torch.optim.Adam(params, lr=cfg.lr * ratio, betas=(0.0, 0.99 ** ratio),
                               eps=1e-8)
        for group in opt.param_groups:
            for p in group["params"]:
                opt.state[p] = {"step": torch.tensor(0.0),
                                "exp_avg": torch.zeros_like(p),
                                "exp_avg_sq": torch.zeros_like(p)}
        return opt

    return adam(g.parameters(), cfg.g_reg_ratio), adam(d.parameters(), cfg.d_reg_ratio)


def make_models(cfg: TrainConfig, device="cuda", seed: int | None = None):
    """G (``GeneratorWithMap``) and D at ``cfg``'s widths, drawn from
    ``seed`` (default ``cfg.seed``) and ``seed + 1``."""
    seed = cfg.seed if seed is None else seed
    dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
    g = GeneratorWithMap(cfg.size, cfg.latent, cfg.n_mlp,
                         channel_multiplier=cfg.channel_multiplier, dtype=dtype,
                         pyramid_mode=cfg.pyramid_mode, seed=seed, device=device)
    d = Discriminator(cfg.size, cfg.channel_multiplier, dtype=dtype, seed=seed + 1,
                      device=device)
    return g, d


def init_train_state(cfg: TrainConfig, device="cuda", seed: int | None = None) -> TrainState:
    """A fresh state on ``device``: the models from ``make_models``, the EMA
    a copy of G, zero optimizer moments and path mean, the ADA probability
    ``cfg.augment_p`` (0 when adaptive), and the step's generator seeded
    with ``seed`` (default ``cfg.seed``)."""
    device = resolve_device(device)
    seed = cfg.seed if seed is None else seed
    g, d = make_models(cfg, device, seed)
    g_ema = copy.deepcopy(g).eval().requires_grad_(False)
    g_optim, d_optim = make_optimizers(cfg, g, d)

    def scalar(x=0.0):
        return torch.tensor(float(x), device=device)

    return TrainState(g=g, d=d, g_ema=g_ema, g_optim=g_optim, d_optim=d_optim,
                      generator=torch.Generator(device).manual_seed(seed),
                      mean_path_length=scalar(),
                      ada_p=scalar(cfg.augment_p if cfg.augment_p > 0 else 0.0),
                      ada_signs=scalar(), ada_count=scalar())

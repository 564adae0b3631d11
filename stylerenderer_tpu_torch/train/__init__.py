"""Adversarial training of the GAR: losses, state and the train step."""

from stylerenderer_tpu_torch.train.losses import (
    d_logistic_loss,
    g_nonsaturating_loss,
    path_lengths_multi,
    path_regularize,
    r1_penalty,
)
from stylerenderer_tpu_torch.train.state import (
    TrainState,
    init_train_state,
    make_models,
    make_optimizers,
)
from stylerenderer_tpu_torch.train.step import StepDraws, sample_draws, train_step

__all__ = [
    "StepDraws", "TrainState", "d_logistic_loss", "g_nonsaturating_loss",
    "init_train_state", "make_models", "make_optimizers", "path_lengths_multi",
    "path_regularize", "r1_penalty", "sample_draws", "train_step",
]

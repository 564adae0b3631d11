"""Adversarial training of the GAR (losses, state, the train step with its
optional supervisor heads) and the Regressor's self-supervised training."""

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
from stylerenderer_tpu_torch.train.regressor import (
    RegressorState,
    init_regressor_state,
    make_regressor_fn,
    make_regressor_trainer,
    regressor_step,
    sample_regressor_batch,
)
from stylerenderer_tpu_torch.train.step import StepDraws, run_step, sample_draws, train_step

__all__ = [
    "RegressorState", "StepDraws", "TrainState", "d_logistic_loss", "g_nonsaturating_loss",
    "init_regressor_state", "init_train_state", "make_models", "make_optimizers",
    "make_regressor_fn", "make_regressor_trainer", "path_lengths_multi", "path_regularize",
    "r1_penalty", "regressor_step", "run_step", "sample_draws", "sample_regressor_batch",
    "train_step",
]

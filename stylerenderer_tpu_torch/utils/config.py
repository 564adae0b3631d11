"""The training configuration (the port's own copy of
``stylerenderer_tpu/utils/config.py``): one frozen dataclass with the
reference trainer's defaults, saved into every checkpoint."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any


@dataclass(frozen=True)
class TrainConfig:
    # model
    size: int = 256
    latent: int = 512
    n_mlp: int = 8
    channel_multiplier: int = 2
    # optimization
    iter: int = 800_000
    batch: int = 16
    lr: float = 2e-3
    r1: float = 10.0
    path_regularize: float = 2.0
    path_batch_shrink: int = 2
    d_reg_every: int = 16
    g_reg_every: int = 4
    mixing: float = 0.9
    # ADA
    augment: bool = False
    augment_p: float = 0.0
    ada_target: float = 0.6
    ada_length: int = 500_000
    ada_every: int = 256
    # EMA: 0.5 ** (32 / (10 * 1000))
    ema_halflife_kimg: float = 10.0
    # data / logging
    n_sample: int = 64
    seed: int = 0
    # numerics
    compute_dtype: str = "float32"
    pyramid_mode: str = "each"

    @property
    def ema_decay(self) -> float:
        return 0.5 ** (32 / (self.ema_halflife_kimg * 1000))

    @property
    def g_reg_ratio(self) -> float:
        return self.g_reg_every / (self.g_reg_every + 1)

    @property
    def d_reg_ratio(self) -> float:
        return self.d_reg_every / (self.d_reg_every + 1)

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "TrainConfig":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})

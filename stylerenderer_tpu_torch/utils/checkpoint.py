"""Checkpoint and resume with ``torch.save`` (counterpart of
``stylerenderer_tpu/utils/checkpoint.py``, which uses orbax).

One file per saved step, ``<dir>/<step:06d>.pt``, holding a dict with the
reference trainer's top-level keys (``g``, ``d``, ``g_ema``, ``g_optim``,
``d_optim``, ``args`` (the ``TrainConfig`` as a dict) and ``ada_aug_p``)
plus ``step``, ``mean_path_length``, ``ada_signs``, ``ada_count``,
``nonfinite_count`` and ``rng`` (the step generator's state), so a resumed
run takes the very next step the saved one would have. Files are written
under a temporary name and renamed; the newest ``max_to_keep`` stay.

Across ranks (``parallel/mesh.py``) the state is replicated: rank 0
writes, every rank waits at a barrier after the write, and every rank
loads the same file into its own copy (``load_checkpoint`` maps it to the
state's device).
"""

from __future__ import annotations

import os
import re
import tempfile

import torch

from stylerenderer_tpu_torch.utils.config import TrainConfig

_NAME = re.compile(r"^(\d+)\.pt$")


def all_steps(ckpt_dir: str) -> list[int]:
    """The saved steps under ``ckpt_dir``, oldest first (none if it is
    missing)."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(ckpt_dir)) if m)


def _path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"{step:06d}.pt")


def save_checkpoint(ckpt_dir: str, step: int, state, cfg: TrainConfig,
                    max_to_keep: int = 5, mesh=None) -> str:
    """Save ``state`` as step ``step``; delete all but the newest
    ``max_to_keep`` checkpoints. Returns the file written. With ``mesh``,
    rank 0 writes and every rank returns after the file is in place."""
    if max_to_keep < 1:
        raise ValueError(f"max_to_keep must be >= 1, got {max_to_keep}")
    if mesh is not None:
        path = _path(ckpt_dir, step)
        if mesh.is_main:
            path = save_checkpoint(ckpt_dir, step, state, cfg, max_to_keep)
        mesh.barrier()
        return path
    os.makedirs(ckpt_dir, exist_ok=True)
    payload = {
        "g": state.g.state_dict(),
        "d": state.d.state_dict(),
        "g_ema": state.g_ema.state_dict(),
        "g_optim": state.g_optim.state_dict(),
        "d_optim": state.d_optim.state_dict(),
        "args": cfg.to_dict(),
        "ada_aug_p": float(state.ada_p),
        "ada_signs": float(state.ada_signs),
        "ada_count": float(state.ada_count),
        "mean_path_length": float(state.mean_path_length),
        "step": int(state.step),
        "nonfinite_count": int(state.nonfinite_count),
        "rng": state.generator.get_state(),
    }
    path = _path(ckpt_dir, step)
    fd, tmp = tempfile.mkstemp(suffix=".tmp", dir=ckpt_dir)
    try:
        with os.fdopen(fd, "wb") as f:
            torch.save(payload, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    for old in all_steps(ckpt_dir)[:-max_to_keep]:
        os.unlink(_path(ckpt_dir, old))
    return path


def latest_step(ckpt_dir: str) -> int | None:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def _read(ckpt_dir: str, step: int | None) -> dict:
    if step is None:
        step = latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    return torch.load(_path(ckpt_dir, step), map_location="cpu", weights_only=True)


def load_checkpoint(ckpt_dir: str, state, step: int | None = None):
    """Load step ``step`` (default the newest) into ``state`` (built with
    ``init_train_state`` at the same widths) in place -> (state,
    TrainConfig)."""
    ck = _read(ckpt_dir, step)
    for name in ("g", "d", "g_ema"):
        getattr(state, name).load_state_dict(ck[name], strict=True)
    state.g_optim.load_state_dict(ck["g_optim"])
    state.d_optim.load_state_dict(ck["d_optim"])
    dev = state.device
    state.ada_p = torch.tensor(ck["ada_aug_p"], device=dev)
    state.ada_signs = torch.tensor(ck["ada_signs"], device=dev)
    state.ada_count = torch.tensor(ck["ada_count"], device=dev)
    state.mean_path_length = torch.tensor(ck["mean_path_length"], device=dev)
    state.step = int(ck["step"])
    state.nonfinite_count = int(ck["nonfinite_count"])
    state.generator.set_state(ck["rng"])
    return state, TrainConfig.from_dict(ck["args"])


def load_params_only(ckpt_dir: str, step: int | None = None):
    """The raw checkpoint dict (state dicts on the CPU; pull ``g_ema`` or
    ``g`` out for generation) and its TrainConfig."""
    ck = _read(ckpt_dir, step)
    return ck, TrainConfig.from_dict(ck["args"])


def load_generator_weights(ckpt_dir: str, gen, step: int | None = None):
    """Load a checkpoint's ``g_ema`` (else its ``g``) into ``gen`` with
    ``strict=True``, for generation and inversion; a checkpoint with
    neither raises ``KeyError``. Returns ``gen``."""
    ck, _ = load_params_only(ckpt_dir, step)
    sd = ck.get("g_ema", ck.get("g"))
    if sd is None:
        raise KeyError(f"checkpoint under {ckpt_dir} has neither g_ema nor g")
    gen.load_state_dict(sd, strict=True)
    return gen

"""Failure detection and recovery (the port's own copy of
``stylerenderer_tpu/utils/guards.py``).

- ``metrics_finite``: host-side NaN/Inf screen of a step's metrics;
- ``state_finite``: every floating tensor of a training state (models,
  optimizer moments, scalars), one host synchronisation;
- ``TrainGuard``: counts consecutive non-finite steps, calls a restore
  function after a threshold, and raises when recovery keeps failing.
"""

from __future__ import annotations

import math
from typing import Callable

import torch


def metrics_finite(metrics: dict) -> bool:
    return all(math.isfinite(float(v)) for v in metrics.values())


def _floating(obj):
    if isinstance(obj, torch.Tensor):
        return [obj] if obj.is_floating_point() else []
    if isinstance(obj, torch.nn.Module):
        return [t for t in obj.state_dict().values() if t.is_floating_point()]
    if isinstance(obj, torch.optim.Optimizer):
        return [t for st in obj.state.values() for t in st.values()
                if isinstance(t, torch.Tensor) and t.is_floating_point()]
    if isinstance(obj, dict):
        return [t for v in obj.values() for t in _floating(v)]
    if isinstance(obj, (list, tuple)):
        return [t for v in obj for t in _floating(v)]
    if hasattr(obj, "__dataclass_fields__"):
        return [t for name in obj.__dataclass_fields__ for t in _floating(getattr(obj, name))]
    return []


def state_finite(state) -> bool:
    """Whether every element of every floating tensor in ``state`` (a
    tensor, module, optimizer, dict, list or dataclass such as
    ``TrainState``, searched recursively) is finite."""
    tensors = [t.detach() for t in _floating(state)]
    if not tensors:
        return True
    by_device: dict = {}
    for t in tensors:
        by_device.setdefault(t.device, []).append(t)
    flags = [torch.isfinite(torch.stack([n.float() for n in torch._foreach_norm(ts, float("inf"))]))
             .all().cpu() for ts in by_device.values()]
    return bool(torch.stack(flags).all())


class TrainGuard:
    """Detects non-finite training steps and drives recovery.

    guard = TrainGuard(restore_fn, max_bad_steps=3, max_restores=5)
    state = guard.check(step_idx, state, metrics, prev_state)
    """

    def __init__(self, restore_fn: Callable | None = None,
                 max_bad_steps: int = 3, max_restores: int = 5):
        self.restore_fn = restore_fn
        self.max_bad_steps = max_bad_steps
        self.max_restores = max_restores
        self.bad_streak = 0
        self.restores = 0
        self.bad_total = 0

    def check(self, step: int, state, metrics: dict, prev_state):
        """Returns the state to continue from (``prev_state`` if this step
        must be discarded). Raises RuntimeError when recovery is exhausted."""
        if metrics_finite(metrics):
            self.bad_streak = 0
            return state
        self.bad_streak += 1
        self.bad_total += 1
        if self.bad_streak < self.max_bad_steps:
            return prev_state
        self.restores += 1
        self.bad_streak = 0
        if self.restores > self.max_restores:
            raise RuntimeError(
                f"training diverged at step {step}: {self.bad_total} non-finite "
                f"steps, {self.restores - 1} checkpoint restores exhausted")
        if self.restore_fn is None:
            raise RuntimeError(
                f"training produced non-finite metrics at step {step} and no "
                "restore_fn is configured")
        return self.restore_fn()

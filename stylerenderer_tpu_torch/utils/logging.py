"""Metrics logging and step timing (counterpart of
``stylerenderer_tpu/utils/logging.py``).

``MetricsLogger`` appends one JSON row per call to ``metrics.jsonl``
through a raw ``O_APPEND`` descriptor, one ``os.write`` per row (no
buffered file object whose tail a crash could lose), and mirrors the rows
to tensorboardX when it is installed and to wandb when asked.
Across ranks only rank 0 writes (``rank``: other ranks' loggers
write nothing). ``StepTimer`` tracks the rolling step time and images
per second, of the global batch that its caller names.
``trace_ctx`` names a span in a profiler trace, and only while a
profiler runs; ``SPANS`` lists every span the package emits, with its
layer. ``start_profiler_trace`` and ``stop_profiler_trace`` bracket one
``torch.profiler`` trace of the process (CPU, and the card's kernels when
there is one) and write it as a Chrome trace, as
``jax.profiler.start_trace``/``stop_trace`` do.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any

import torch

# the trace between start_profiler_trace and stop_profiler_trace: one per
# process, as jax.profiler's
_TRACE: dict[str, Any] = {}


class MetricsLogger:
    def __init__(self, log_dir: str, use_wandb: bool = False,
                 project: str = "stylerenderer-tpu", rank: int = 0):
        self._fd = None
        if rank != 0:
            return
        os.makedirs(log_dir, exist_ok=True)
        self._fd = os.open(os.path.join(log_dir, "metrics.jsonl"),
                           os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
        self._tb = None
        try:
            import tensorboardX
        except ImportError:
            pass
        else:
            self._tb = tensorboardX.SummaryWriter(logdir=log_dir)
        self._wandb = None
        if use_wandb:
            try:
                import wandb
            except ImportError as e:
                os.close(self._fd)
                raise RuntimeError("--wandb was asked for but wandb is not installed") from e
            wandb.init(project=project)
            self._wandb = wandb

    def log(self, step: int, data: dict[str, Any]) -> None:
        if self._fd is None:
            return
        clean = {}
        for k, v in data.items():
            try:
                clean[k] = float(v)
            except (TypeError, ValueError):
                continue
        view = memoryview((json.dumps({"step": int(step), **clean}) + "\n").encode())
        # os.write may write short (a signal, a full disk): loop so a row is
        # never silently cut; errors such as ENOSPC raise
        while view:
            view = view[os.write(self._fd, view):]
        if self._tb is not None:
            for k, v in clean.items():
                self._tb.add_scalar(k, v, step)
        if self._wandb is not None:
            self._wandb.log(clean, step=step)

    def close(self) -> None:
        if self._fd is None:
            return
        os.close(self._fd)
        self._fd = None
        if self._tb is not None:
            self._tb.close()


class StepTimer:
    """Rolling step time and throughput over the last ``window`` ticks."""

    def __init__(self, window: int = 50):
        self.window = window
        self._times: list[float] = []
        self._last = None

    def tick(self) -> float | None:
        now = time.perf_counter()
        dt = None
        if self._last is not None:
            dt = now - self._last
            self._times.append(dt)
            if len(self._times) > self.window:
                self._times.pop(0)
        self._last = now
        return dt

    @property
    def mean_step_time(self) -> float:
        return sum(self._times) / len(self._times) if self._times else 0.0

    def images_per_sec(self, batch: int) -> float:
        """``batch`` (the global batch, across ranks) over the mean step
        time."""
        t = self.mean_step_time
        return batch / t if t > 0 else 0.0


# the resolutions of the synthesis, 4 to 1024 px, each with its span
SYNTHESIS_SPANS = {2 ** i: f"synthesis.r{2 ** i}" for i in range(2, 11)}

# every span the package emits -> its layer (PERF.md's list of layers)
SPANS = {
    "geometry.morph": "entry",
    "geometry.pose": "entry",
    "geometry.normals": "entry",
    "gar.mapping": "mapping network",
    "gar.pyramid": "normal pyramid",
    "gar.synthesis": "synthesis",
    **{name: "synthesis" for name in SYNTHESIS_SPANS.values()},
    "project.forward": "whole forward or step",
    "project.backward": "pyramid backward, synthesis backward",
    "train.step": "training",
    "train.backup": "training",
    "train.d": "training",
    "train.ada": "training",
    "train.r1": "training",
    "train.g": "training",
    "train.path": "training",
    "train.finish": "training",
}

_OFF = contextlib.nullcontext()


def trace_ctx(name: str, args: str | None = None):
    """A span named ``name`` (one of ``SPANS``) in a profiler trace, a
    ``torch.profiler.record_function`` range on the profiler's timeline,
    beside the card's kernels; spans nest. ``args`` carries a per-call
    identity, such as a step number. With no profiler running it is one
    shared null context: a span costs a check of the profiler's state and
    nothing more (a ``record_function`` costs ~15 us even then)."""
    if not torch._C._autograd._profiler_enabled():
        return _OFF
    return torch.profiler.record_function(name, args)


def start_profiler_trace(log_dir: str) -> None:
    """Start tracing the host's ops and, on a machine with a card, its
    kernels; ``stop_profiler_trace`` writes the trace under ``log_dir``."""
    if _TRACE:
        raise RuntimeError("a profiler trace is already running")
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    _TRACE.update(prof=prof, log_dir=log_dir)


def stop_profiler_trace() -> str:
    """Stop the running trace and write it as ``trace.json`` (Chrome trace
    format) under its ``log_dir`` -> the file's path. The caller
    synchronizes the card first, so the traced kernels have ended."""
    if not _TRACE:
        raise RuntimeError("no profiler trace is running")
    prof, log_dir = _TRACE.pop("prof"), _TRACE.pop("log_dir")
    prof.stop()
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    return path

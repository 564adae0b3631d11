"""Pieces the loops share: loading the benchmark's weights into the
program's GAR, the precision flags, the profiler ranges around the GAR's
layers, and the sample of answers checked after the window."""

from __future__ import annotations

import contextlib
import random

import torch

# the program's compute type for the precision a configuration states
DTYPES = {"bfloat16": torch.bfloat16, "tf32": torch.float32, "float32": torch.float32}
LAYER_RANGES = ("normal_pyramid", "synthesize")


def load_weights(gen, P: dict) -> None:
    """Copy the benchmark's weights ``P`` into ``gen``'s parameters, which
    must be exactly the names of ``P``."""
    params = dict(gen.named_parameters())
    if set(params) != set(P):
        missing, extra = sorted(set(P) - set(params)), sorted(set(params) - set(P))
        raise KeyError(f"the program's parameters differ from the reference's: "
                       f"not in the program {missing[:5]}, not in the reference {extra[:5]}")
    with torch.no_grad():
        for k, t in P.items():
            if params[k].shape != t.shape:
                raise ValueError(f"{k}: program {tuple(params[k].shape)}, "
                                 f"reference {tuple(t.shape)}")
            params[k].copy_(t)


def wrap_layers(gen) -> None:
    """Wrap the instance's ``normal_pyramid`` and ``synthesize`` in
    ``gar_bench.<name>`` ranges for the profiler (the forward and the
    projector call both through the instance)."""
    from torch.autograd.profiler import record_function

    for name in LAYER_RANGES:
        fn = getattr(gen, name)

        def wrapped(*a, _fn=fn, _name=name, **k):
            with record_function(f"gar_bench.{_name}"):
                return _fn(*a, **k)
        setattr(gen, name, wrapped)


def sync(device) -> None:
    """Wait for the card (nothing to wait for on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def program_flags() -> None:
    """PyTorch's default precision flags, which the configurations state:
    convolutions may take TF32 (cuDNN), matrix products may not."""
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False


@contextlib.contextmanager
def exact_float32():
    """TF32 off for convolutions and matrix products (the reference)."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


class Reservoir:
    """A uniform sample of ``k`` of the window's answers, drawn from the
    seed without knowing how many the window will give (Vitter's
    algorithm R)."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.n, self.items = k, random.Random(f"{seed}/sample"), 0, []

    def offer(self, make):
        """Offer the next answer; ``make()`` builds what is kept of it and is
        called only when it is taken."""
        if self.n < self.k:
            self.items.append(make())
        else:
            j = self.rng.randrange(self.n + 1)
            if j < self.k:
                self.items[j] = make()
        self.n += 1

    def pick(self, n: int) -> int:
        """An index below ``n`` drawn from the sample's stream."""
        return self.rng.randrange(n)

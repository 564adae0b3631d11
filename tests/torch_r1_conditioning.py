"""How well-conditioned the R1 update of the port's card step test is.

    python tests/torch_r1_conditioning.py [--device cuda|cpu] [--runs 4]

At the size of the card step tests in ``tests/test_torch_gpu.py``
(16 px, B=4, channel multiplier 1), this takes the D parameters after the
step's first (D) update, from the CPU's step and from ``--runs`` steps on
``--device``, and computes the R1 update's gradients at each of those
parameter states four ways: float32 on the CPU, float32 on the device,
float64 on both. It prints, per state, the largest error of one against
another over the D tensors, relative to each tensor's largest magnitude
(and which tensor), and whether the device's D update repeats from run to
run. A state where float32 is off float64 by more than the test's 1e-3 is
one where two float32 orders of summation cannot be held to 1e-3.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import stylerenderer_tpu_torch.train.step as step_mod  # noqa: E402
from stylerenderer_tpu_torch.face3d import synthetic_face  # noqa: E402
from stylerenderer_tpu_torch.train import (  # noqa: E402
    init_train_state, losses, sample_draws, train_step,
)
from stylerenderer_tpu_torch.utils.config import TrainConfig  # noqa: E402

CFG = TrainConfig(size=16, latent=32, n_mlp=2, channel_multiplier=1, batch=4,
                  d_reg_every=2, g_reg_every=2)


def _to(obj, device):
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, list):
        return [_to(x, device) for x in obj]
    if dataclasses.is_dataclass(obj):
        return type(obj)(**{f.name: _to(getattr(obj, f.name), device)
                            for f in dataclasses.fields(obj)})
    return obj


def d_after_first_update(device, state0, draws, real):
    """The D parameters (on the CPU) after the step's first update on
    ``device``, from the test's initial weights."""
    st = init_train_state(CFG, device, seed=1)
    for name in ("g", "d", "g_ema"):
        getattr(st, name).load_state_dict(getattr(state0, name).state_dict())
    face, tri = synthetic_face(12, 24, 4, 2, device=device)
    seen = []
    adam = step_mod._adam_step

    def record(opt, params, grads):
        adam(opt, params, grads)
        if not seen:
            seen.append([p.detach().cpu().clone() for p in params])

    step_mod._adam_step = record
    try:
        train_step(st, real.to(device), _to(draws, device), CFG, face, tri)
    finally:
        step_mod._adam_step = adam
    return seen[0]


def r1_grads(state0, params, real, device, dtype):
    """The R1 update's gradients of D at ``params``, computed in ``dtype``
    on ``device`` (every layer's compute type set to ``dtype``)."""
    d = copy.deepcopy(state0.d)
    for m in d.modules():
        if isinstance(getattr(m, "dtype", None), torch.dtype):
            m.dtype = dtype
    d = d.to(device).to(dtype)
    with torch.no_grad():
        for p, q in zip(d.parameters(), params):
            p.copy_(q.to(dtype))
    ps = list(d.parameters())
    r1 = losses.r1_penalty(d, real.to(device).to(dtype))
    gs = torch.autograd.grad(CFG.r1 / 2.0 * r1 * CFG.d_reg_every, ps, allow_unused=True,
                             materialize_grads=True)
    return [g.detach().cpu().double() for g in gs]


def worst(a, b):
    rel = [float((x - y).abs().max()) / max(float(y.abs().max()), 1e-30) for x, y in zip(a, b)]
    return f"{max(rel):.3e} (tensor {int(np.argmax(rel))})"


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--runs", type=int, default=4)
    args = p.parse_args(argv)
    dev = torch.device(args.device)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    state0 = init_train_state(CFG, "cpu", seed=1)
    face, _ = synthetic_face(12, 24, 4, 2, device="cpu")
    draws = sample_draws(torch.Generator().manual_seed(2), CFG, face, 4, state0.g.n_latent)
    real = torch.rand(4, 3, 16, 16, generator=torch.Generator().manual_seed(3)) * 2 - 1
    names = [n for n, _ in state0.d.named_parameters()]
    print("D tensors:", ", ".join(f"{i} {n}" for i, n in enumerate(names)))
    states = [("the CPU's D update", d_after_first_update("cpu", state0, draws, real))]
    states += [(f"{dev.type} D update, run {k}", d_after_first_update(dev, state0, draws, real))
               for k in range(args.runs)]
    for name, params in states:
        f64 = r1_grads(state0, params, real, "cpu", torch.float64)
        c32 = r1_grads(state0, params, real, "cpu", torch.float32)
        d32 = r1_grads(state0, params, real, dev, torch.float32)
        d64 = r1_grads(state0, params, real, dev, torch.float64)
        same = all(torch.equal(a, b) for a, b in zip(params, states[1][1]))
        print(f"{name} (equal to run 0's: {same}): {dev.type} f32 vs CPU f32 {worst(d32, c32)}; "
              f"CPU f32 vs f64 {worst(c32, f64)}; {dev.type} f32 vs f64 {worst(d32, f64)}; "
              f"{dev.type} f64 vs CPU f64 {worst(d64, f64)}", flush=True)


if __name__ == "__main__":
    main()

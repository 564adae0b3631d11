"""``train/step.py::run_step``, the training iteration that ``cli.train`` and
the benchmark's training cell both call: from one seed it leaves the state
bit for bit where ``cli.train``'s former inline body (``sample_draws`` from
the state's generator, then ``train_step``) leaves it, and hands back the
draws that body drew; the step's spans (``train.step``, ``train.backup``
and the sections ``train.d``, ``train.r1``, ``train.g``, ``train.path``)
are opened under a profiler, inside ``train.step``, and not without one."""

import dataclasses

import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch_threads import _one_thread  # noqa: F401

from stylerenderer_tpu_torch.face3d import synthetic_face
from stylerenderer_tpu_torch.train import init_train_state, run_step, sample_draws, train_step
from stylerenderer_tpu_torch.utils.config import TrainConfig
from stylerenderer_tpu_torch.utils.logging import SPANS

SIZE, B = 16, 4
# R1 and the path term on steps 0 and 2, step 1 plain
CFG = TrainConfig(size=SIZE, latent=32, n_mlp=2, channel_multiplier=1, batch=B,
                  d_reg_every=2, g_reg_every=2)
STEP_SPANS = {"train.step", "train.backup", "train.d", "train.r1", "train.g", "train.path"}


@pytest.fixture(scope="module")
def inputs():
    face, tri = synthetic_face(8, 16, shape_dim=4, expression_dim=2, device="cpu")
    real = torch.tanh(torch.randn(B, 3, SIZE, SIZE, generator=torch.Generator().manual_seed(1)))
    return face, tri, real


def _tensors(st):
    out = [*st.g.parameters(), *st.d.parameters(), *st.g_ema.parameters(),
           st.mean_path_length]
    for opt in (st.g_optim, st.d_optim):
        for group in opt.param_groups:
            for p in group["params"]:
                out += [opt.state[p][k] for k in ("exp_avg", "exp_avg_sq", "step")]
    return out


def _flat(draws):
    """Every tensor of a ``StepDraws``, in field order."""
    out = []
    for f in dataclasses.fields(draws):
        v = getattr(draws, f.name)
        if dataclasses.is_dataclass(v):
            out += _flat(v)
        elif isinstance(v, list):
            out += v
        elif v is not None:
            out.append(v)
    return out


def test_run_step_is_the_cli_body(inputs):
    face, tri, real = inputs
    a, b = init_train_state(CFG, "cpu", seed=3), init_train_state(CFG, "cpu", seed=3)
    for _ in range(3):
        metrics, draws = run_step(a, real, CFG, face, tri)
        inline = sample_draws(b.generator, CFG, face, CFG.batch, b.g.n_latent, {})
        expected = train_step(b, real, inline, CFG, face, tri, {})
        assert all(torch.equal(x, y) for x, y in zip(_flat(draws), _flat(inline)))
        assert metrics.keys() == expected.keys()
        assert all(torch.equal(torch.as_tensor(metrics[k]), torch.as_tensor(expected[k]))
                   for k in metrics)
    assert a.step == b.step == 3 and a.nonfinite_count == b.nonfinite_count == 0
    assert float(metrics["r1"]) > 0 and float(metrics["path"]) > 0  # step 2 regularized
    assert all(torch.equal(x, y) for x, y in zip(_tensors(a), _tensors(b)))


def test_step_spans_only_under_a_profiler(inputs, monkeypatch):
    face, tri, real = inputs
    st = init_train_state(CFG, "cpu", seed=3)
    made, record = [], torch.profiler.record_function

    def spy(name, args=None):
        made.append(name)
        return record(name, args)
    monkeypatch.setattr(torch.profiler, "record_function", spy)
    run_step(st, real, CFG, face, tri)
    assert made == []
    st.step = 2  # R1 and the path term again, now traced
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run_step(st, real, CFG, face, tri)
    spans = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
             if e.is_user_annotation and e.name.startswith("train.")]
    names = [n for n, _, _ in spans]
    assert STEP_SPANS <= set(names) <= set(SPANS)
    assert names.count("train.step") == names.count("train.backup") == 1
    _, s0, s1 = next(s for s in spans if s[0] == "train.step")
    assert all(s0 <= a and b <= s1 for _, a, b in spans)

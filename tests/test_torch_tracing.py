"""The port's spans (``utils/logging.py::trace_ctx``, ``SPANS``): none is
made while no profiler runs; under a CPU ``torch.profiler`` a tiny GAR
forward, the geometry and a 2-step fit emit their spans, nested as the
layers are, each name listed in ``SPANS``; the outputs are bit-equal with
and without a profiler running. (``cli.train``'s ``train.*`` spans:
``test_torch_supervisors.py::test_cli_train_takes_profile_bfm_and_folder``.)"""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch_threads import _one_thread  # noqa: F401

from stylerenderer_tpu_torch.face3d import mesh_point_normal, synthetic_face
from stylerenderer_tpu_torch.face3d.geometry import apply_pose3D
from stylerenderer_tpu_torch.inversion import ProjectorConfig, make_projector
from stylerenderer_tpu_torch.models import GeneratorWithMap
from stylerenderer_tpu_torch.utils.logging import SPANS, SYNTHESIS_SPANS, trace_ctx

SIZE, LATENT, N_MLP, B = 16, 32, 2, 2
RES = [4, 8, 16]


@pytest.fixture(scope="module")
def tiny():
    gen = GeneratorWithMap(SIZE, LATENT, N_MLP, channel_multiplier=1, device="cpu", seed=3)
    face, tri = synthetic_face(8, 16, shape_dim=4, expression_dim=2, device="cpu")
    g = torch.Generator().manual_seed(7)
    draws = dict(x=face.random_input(B, g), pose=0.1 * torch.randn(B, 7, generator=g),
                 z=torch.randn(B, LATENT, generator=g),
                 noise=[torch.randn(B, 1, r, r, generator=g) for r in (4, 8, 8, 16, 16)])
    return dict(gen=gen, face=face, tri=tri, **draws)


def _render(t):
    vert = apply_pose3D(t["face"](t["x"]), t["pose"])
    norm = mesh_point_normal(vert, t["tri"])
    with torch.no_grad():
        img, _, maps = t["gen"]([t["z"]], (vert, norm, t["tri"]), return_normals=True,
                                noise=t["noise"])
    return img, maps


def _fit(t):
    # a fresh projector and generator state each call: the fit freezes them
    project = make_projector(t["gen"], t["face"], t["tri"],
                             ProjectorConfig(w_lpips=0.0, w_lmk=0.0, w_reg_w=0.1))
    g = torch.Generator().manual_seed(1)
    target = torch.tanh(torch.randn(B, 3, SIZE, SIZE, generator=g))
    return project(2, target, n_steps=2)


def _traced(fn):
    """``fn()`` under a CPU profiler -> (its result, its user ranges but
    torch's own ``Optimizer.*`` ones: ``[(name, start, end)]``)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
             if e.is_user_annotation and not e.name.startswith("Optimizer.")]
    return out, spans


def _names(spans):
    return [n for n, _, _ in spans]


def test_no_profiler_no_record_function(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function made with no profiler running")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch._C._autograd._profiler_enabled()
    a, b = trace_ctx("gar.synthesis"), trace_ctx("train.step", args="3")
    assert a is b
    with a:
        pass


def test_every_span_name_is_fixed_and_listed():
    assert set(SYNTHESIS_SPANS.values()) <= set(SPANS)
    assert all(isinstance(n, str) and not any(c.isspace() for c in n) for n in SPANS)
    assert set(SPANS.values()) >= {"entry", "synthesis", "normal pyramid", "training"}


def test_forward_and_geometry_spans(tiny):
    _, spans = _traced(lambda: _render(tiny))
    names = _names(spans)
    assert set(names) <= set(SPANS)
    for n in ["geometry.morph", "geometry.pose", "geometry.normals", "gar.mapping",
              "gar.pyramid", "gar.synthesis"] + [SYNTHESIS_SPANS[r] for r in RES]:
        assert names.count(n) == 1, n
    (_, s0, s1), = [s for s in spans if s[0] == "gar.synthesis"]
    for name, a, b in spans:
        if name.startswith("synthesis.r"):
            assert s0 <= a <= b <= s1, name
    # the layers follow one another: geometry, mapping, pyramid, synthesis
    start = {n: a for n, a, _ in spans}
    assert (start["geometry.morph"] < start["geometry.pose"] < start["geometry.normals"]
            < start["gar.mapping"] < start["gar.pyramid"] < start["gar.synthesis"])


def test_projector_spans(tiny):
    _, spans = _traced(lambda: _fit(tiny))
    names = _names(spans)
    assert set(names) <= set(SPANS)
    assert names.count("project.forward") == 2 and names.count("project.backward") == 2
    # two steps and the final render, each posing and rendering once
    assert names.count("geometry.pose") == 3 and names.count("gar.synthesis") == 3
    fwd = [(a, b) for n, a, b in spans if n == "project.forward"]
    inside = [a for n, a, _ in spans if n == "gar.pyramid"
              and any(f0 <= a <= f1 for f0, f1 in fwd)]
    assert len(inside) == 2


def test_outputs_bit_equal_with_and_without_a_profiler(tiny):
    img0, maps0 = _render(tiny)
    (img1, maps1), _ = _traced(lambda: _render(tiny))
    assert torch.equal(img0, img1)
    assert all(torch.equal(a, b) for a, b in zip(maps0, maps1))
    fit0 = _fit(tiny)
    fit1, _ = _traced(lambda: _fit(tiny))
    for k in ("w_plus", "face_params", "rvec", "tvec", "log_scale", "render",
              "loss_history"):
        assert torch.equal(fit0[k], fit1[k]), k

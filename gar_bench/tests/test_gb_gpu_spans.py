"""On the card (``python -m pytest gar_bench/tests -m gpu``; it skips without
one): the program's own spans lie on the device trace's clock and cover the
same device work as the benchmark's own per-layer ranges."""

import pytest
import torch

from gar_bench import spec


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
def test_program_spans_share_the_device_clock():
    """A traced 256 px forward at B=2: each kernel launched inside the
    program's ``gar.synthesis`` or ``gar.pyramid`` span starts at or after
    the span's start (one clock), and the device time inside each equals
    that inside the benchmark's own ``gar_bench.synthesize`` and
    ``gar_bench.normal_pyramid`` ranges to 1%."""
    _card()
    from stylerenderer_tpu_torch.face3d import LinearMorphableModel
    from stylerenderer_tpu_torch.face3d.geometry import apply_pose3D, mesh_point_normal
    from stylerenderer_tpu_torch.models import GeneratorWithMap

    from gar_bench import inputs, trace
    from gar_bench.common import DTYPES, load_weights, program_flags, wrap_layers

    cfg, m, dev, seed = spec.config("gar256"), spec.config("gar256")["mesh"], "cuda", 2**33 + 5
    program_flags()
    face, tri = inputs.face_model(m, seed, dev)
    gen = GeneratorWithMap(
        cfg["size"], cfg["style_dim"], cfg["n_mlp"], n_stylemap=cfg["n_stylemap"],
        channel_multiplier=cfg["channel_multiplier"], lr_mlp=cfg["lr_mlp"],
        dtype=DTYPES[cfg["precision"]["synthesis"]], pyramid_mode=cfg["pyramid_mode"],
        fused_pyramid=cfg["fused_pyramid"], device=dev).eval()
    load_weights(gen, inputs.weights(cfg, seed, dev))
    wrap_layers(gen)
    model = LinearMorphableModel(face["basis"], face["mean"], face["sigma"], m["shape_dim"],
                                 m["expression_dim"])
    d = inputs.render_draws(seed, 0, 2, cfg, spec.traffic("render.b16"), face, dev)

    def forward():
        with torch.no_grad():
            vert = apply_pose3D(model(d["x"]), d["pose"])
            return gen([d["z"]], (vert, mesh_point_normal(vert, tri), tri), noise=d["noise"])[0]
    forward()
    torch.cuda.synchronize()
    _, tr = trace.run_traced(torch, forward)
    spans = tr.ranges(lambda n: n in ("gar.synthesis", "gar.pyramid"))
    inside = 0
    for start, _, name, _, corr in tr.device:
        ts, tid = tr.launch.get(corr, (None, None))
        for s, e, span in spans.get(tid, []):
            if ts is not None and s <= ts < e:
                assert start >= s, (name, span, start, s)
                inside += 1
    assert inside > 0
    for ours, theirs in (("gar.synthesis", "gar_bench.synthesize"),
                         ("gar.pyramid", "gar_bench.normal_pyramid")):
        a = tr.device_s_in(lambda n: n == ours)
        b = tr.device_s_in(lambda n: n == theirs)
        assert b > 0 and abs(a - b) <= 0.01 * b, (ours, a, theirs, b)

"""The inputs come from the seed alone: the same seed gives the same draws,
weights, face model and targets; another seed or batch gives others; seeds
beyond 32 bits work."""

import pytest
import torch

from gar_bench import inputs
from gar_bench.common import Reservoir
from gar_bench.tests.tiny import shrink
from gar_bench import spec

SEEDS = (0, 7, 2**31 + 12345, 2**40 + 3)


def _draws(seed, index):
    cfg = shrink(spec.config("gar1024"))
    face, _ = inputs.face_model(cfg["mesh"], seed, "cpu")
    return inputs.render_draws(seed, index, 2, cfg, spec.traffic("render.b16"), face, "cpu")


def _same(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return torch.equal(a, b)


@pytest.mark.parametrize("seed", SEEDS)
def test_draws_repeat_from_the_seed(seed):
    assert _same(_draws(seed, 3), _draws(seed, 3))
    assert not torch.equal(_draws(seed, 3)["z"], _draws(seed, 4)["z"])
    assert not torch.equal(_draws(seed, 3)["z"], _draws(seed + 1, 3)["z"])


@pytest.mark.parametrize("seed", SEEDS[1:3])
def test_weights_face_and_targets_repeat_from_the_seed(seed):
    cfg = shrink(spec.config("gar256"))
    assert _same(inputs.weights(cfg, seed, "cpu"), inputs.weights(cfg, seed, "cpu"))
    assert not _same(inputs.weights(cfg, seed, "cpu"), inputs.weights(cfg, seed + 1, "cpu"))
    assert _same(inputs.face_model(cfg["mesh"], seed, "cpu"),
                 inputs.face_model(cfg["mesh"], seed, "cpu"))
    assert torch.equal(inputs.targets(seed, 2, 16, 8, "cpu"), inputs.targets(seed, 2, 16, 8, "cpu"))
    assert torch.equal(inputs.mean_latent_draws(seed, 8, 4), inputs.mean_latent_draws(seed, 8, 4))


def test_every_seed_draws_the_same_sizes():
    a, b = _draws(1, 0), _draws(2**40, 0)
    assert [t.shape for t in a["noise"]] == [t.shape for t in b["noise"]]
    assert a["z"].shape == b["z"].shape and a["pose"].shape == b["pose"].shape


def test_face_mesh_is_the_published_size():
    m = spec.config("gar1024")["mesh"]
    pts, tri = inputs.sphere_face(m["nu"], m["nv"], m["radius"])
    assert tri.shape == (m["triangles"], 3) and pts.shape == (m["nu"] * m["nv"], 3)


def test_sample_repeats_from_the_seed():
    def picks(seed, n):
        r = Reservoir(4, seed)
        for i in range(n):
            j = r.pick(16)
            r.offer(lambda: (i, j))
        return r.items
    assert picks(9, 100) == picks(9, 100)
    assert picks(9, 100) != picks(10, 100)
    assert len(picks(9, 3)) == 3

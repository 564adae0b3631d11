"""The port's data path and the modules around the single-level
rasterizer, against the JAX package:

- ``ops/resize.py`` against ``jax.image.resize(..., "linear")``;
- ``data/synth.py::shade_faces`` against the JAX ``make_synth_batch`` on
  the same draws, rebuilt here from the same key splits;
- ``data/srpack.py::SRPackWriter``: the same bytes as the JAX writer;
- ``write_synth_dataset`` and its CLI on the CPU;
- ``face3d/alignment.py::render_mean_face`` against the JAX one.

Inputs are made with numpy or JAX keys from seeds and handed to both
packages as numpy arrays.
"""

import struct

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from stylerenderer_tpu.data.srpack import SRPackReader, SRPackWriter as JSRPackWriter
from stylerenderer_tpu.data.synth import make_synth_batch as j_make_synth_batch
from stylerenderer_tpu.face3d import random_apply_pose3D as j_random_apply_pose3D
from stylerenderer_tpu.face3d import synthetic_face as j_synthetic_face
from stylerenderer_tpu.face3d.alignment import render_mean_face as j_render_mean_face

from stylerenderer_tpu_torch.data import SRPackWriter, shade_faces, write_synth_dataset
from stylerenderer_tpu_torch.data.synth import main as synth_main
from stylerenderer_tpu_torch.face3d import synthetic_face
from stylerenderer_tpu_torch.face3d.alignment import render_mean_face
from stylerenderer_tpu_torch.ops.rasterize_single import rasterize_winners_single
from stylerenderer_tpu_torch.ops.resize import resize_linear
from torch_threads import _one_thread  # noqa: F401


def test_resize_pyramid_matches_jax():
    """The downsample pyramid's chain 256 -> 128 -> ... -> 4."""
    x = np.random.RandomState(0).randn(2, 256, 256, 3).astype(np.float32)
    cur_j, cur_p = jnp.asarray(x), torch.from_numpy(x)
    for s in (128, 64, 32, 16, 8, 4):
        cur_j = jax.image.resize(cur_j, (2, s, s, 3), "linear")
        cur_p = resize_linear(cur_p, s, s)
        assert cur_p.shape == (2, s, s, 3)
        np.testing.assert_allclose(cur_p.numpy(), np.asarray(cur_j), rtol=0, atol=1e-6,
                                   err_msg=f"{s} px")


@pytest.mark.parametrize("shape_in,shape_out", [
    ((7, 9), (3, 4)), ((5, 5), (2, 3)), ((13, 6), (6, 6)), ((4, 6), (9, 7)), ((6, 5), (6, 2)),
])
def test_resize_odd_sizes_match_jax(shape_in, shape_out):
    """Odd sizes, shrinking and growing, one axis at a time: the edge
    renormalization and the antialias widening."""
    x = np.random.RandomState(1).randn(2, *shape_in, 2).astype(np.float32)
    ref = jax.image.resize(jnp.asarray(x), (2, *shape_out, 2), "linear")
    out = resize_linear(torch.from_numpy(x), *shape_out)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-6)


def _jax_draws(key, face, batch):
    """The draws of JAX ``make_synth_batch`` (``synth.py:25-27,33,40-45``)."""
    kf, kp, kl, ka, kb = jax.random.split(key, 5)
    vert = j_random_apply_pose3D(kp, face(face.random_input(kf, batch)))
    light = jax.random.normal(kl, (batch, 3))
    albedo = jax.random.uniform(ka, (batch, 1, 1, 3), minval=jnp.asarray([0.55, 0.35, 0.25]),
                                maxval=jnp.asarray([0.95, 0.75, 0.65]))
    bg = jax.random.uniform(kb, (batch, 1, 1, 3), minval=0.05, maxval=0.35)
    return [np.array(a) for a in (vert, light, albedo, bg)]


@pytest.mark.parametrize("seed", [0, 1])
def test_shade_faces_matches_jax(seed):
    face, tri = j_synthetic_face(12, 24, 4, 2)
    key = jax.random.PRNGKey(seed)
    size, batch = 32, 3
    ref = np.asarray(j_make_synth_batch(key, face, tri, size, batch))
    vert, light, albedo, bg = (torch.from_numpy(a) for a in _jax_draws(key, face, batch))
    out = shade_faces(vert, torch.from_numpy(np.array(tri)).long(), light, albedo, bg, size)
    assert out.shape == (batch, size, size, 3)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)
    # faces and background both present, shading in range
    assert 0.05 < float((out != bg).all(-1).float().mean()) < 0.95
    assert 0.0 <= float(out.min()) and float(out.max()) <= 1.0


@pytest.mark.parametrize("codec", ["raw", "jpeg"])
def test_srpack_writer_bytes_equal_jax(tmp_path, codec):
    rng = np.random.RandomState(2)
    sizes = [8, 4]
    if codec == "raw":
        items = [[rng.randint(0, 256, (s, s, 3)).astype(np.uint8) for s in sizes]
                 for _ in range(3)]
    else:
        items = [[rng.bytes(int(rng.randint(5, 40))) for _ in sizes] for _ in range(3)]
    paths = []
    for cls, name in ((SRPackWriter, "port.srpack"), (JSRPackWriter, "jax.srpack")):
        writer = cls(str(tmp_path / name), sizes, codec=codec)
        for it in items:
            writer.add(it)
        assert writer.finalize() == 3
        paths.append(tmp_path / name)
    assert paths[0].read_bytes() == paths[1].read_bytes()


def test_write_synth_dataset_cpu(tmp_path):
    """The dataset writer on the CPU: the shard's header and length, the
    images read back by the JAX package's reader, no kernel launched."""
    path = str(tmp_path / "faces.srpack")
    before = rasterize_winners_single.launches
    face, tri = synthetic_face(12, 24, 4, 2, device="cpu")
    n = write_synth_dataset(path, 5, size=16, seed=3, batch=2, face=face, tri=tri,
                            device="cpu")
    assert n == 5 and rasterize_winners_single.launches == before
    with open(path, "rb") as f:
        head = f.read(24)
    assert head[:4] == b"SRPK"
    assert struct.unpack("<IIIQ", head[4:]) == (1, 0, 1, 5)
    assert (tmp_path / "faces.srpack").stat().st_size == 24 + 4 + 5 * 16 + 5 * 16 * 16 * 3
    reader = SRPackReader(path)
    imgs = reader.read_batch_raw(16, np.arange(5))
    reader.close()
    assert imgs.shape == (5, 16, 16, 3) and len({im.tobytes() for im in imgs}) == 5


def test_synth_cli_cpu(tmp_path, capsys):
    out = tmp_path / "cli.srpack"
    synth_main([str(out), "--n", "2", "--size", "8", "--device", "cpu"])
    assert "wrote 2 8px shaded faces" in capsys.readouterr().out
    assert out.stat().st_size == 24 + 4 + 2 * 16 + 2 * 8 * 8 * 3


def test_render_mean_face_matches_jax():
    """A non-square render (40 high, 24 wide) of the textured mean face."""
    jface, tri = j_synthetic_face(12, 24, 4, 2)
    face, ptri = synthetic_face(12, 24, 4, 2, device="cpu")
    tex = np.random.RandomState(4).rand(face.mean.shape[0] // 3, 3).astype(np.float32)
    ref = j_render_mean_face(jface, tex, np.asarray(tri), 40, 24)
    out = render_mean_face(face, tex, ptri, 40, 24)
    assert out.shape == ref.shape == (40, 24, 3) and out.dtype == np.uint8
    assert np.abs(out.astype(int) - ref.astype(int)).max() <= 1
    assert (out > 0).any(axis=-1).mean() > 0.2

"""The port's data preparation against the JAX package: ``prepare`` and
``cli.prepare_data`` write the same shard bytes (raw and JPEG codecs),
the image-folder dataset and the JPEG shard decode to the same images,
and ``cli.train`` takes a step on a JPEG shard on the CPU."""

import importlib
import os

import numpy as np
import pytest
from PIL import Image

from stylerenderer_tpu.data import dataset as jds

from stylerenderer_tpu_torch.cli import prepare_data
from stylerenderer_tpu_torch.data import (
    ImageFolderDataset, SRPackDataset, SRPackReader, list_images, open_dataset, prepare,
)
from torch_threads import _one_thread  # noqa: F401

# the module (the JAX package's ``data`` exports a function of its name)
jprep = importlib.import_module("stylerenderer_tpu.data.prepare")


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """Photos of several sizes, formats and modes in nested folders, and
    files that are not images."""
    root = tmp_path_factory.mktemp("photos")
    (root / "sub").mkdir()
    rng = np.random.RandomState(0)
    specs = [("a.png", (37, 41), "RGB"), ("b.jpg", (64, 48), "RGB"), ("sub/c.png", (20, 20), "L"),
             ("sub/d.PNG", (50, 30), "RGBA"), ("e.bmp", (33, 29), "RGB")]
    for name, (w, h), mode in specs:
        chans = {"RGB": 3, "L": 1, "RGBA": 4}[mode]
        arr = rng.randint(0, 256, (h, w, chans)).astype(np.uint8)
        Image.fromarray(arr[..., 0] if chans == 1 else arr, mode).save(root / name)
    (root / "notes.txt").write_text("not an image")
    (root / "sub" / "x.npy").write_bytes(b"\x93NUMPY")
    return str(root)


def test_list_images_matches_jax(folder):
    files = list_images(folder)
    assert files == jprep.list_images(folder)
    assert [os.path.relpath(f, folder) for f in files] == [
        "a.png", "b.jpg", "e.bmp", "sub/c.png", "sub/d.PNG"]


@pytest.mark.parametrize("codec,workers", [("raw", 1), ("jpeg", 1), ("raw", 2)])
def test_prepare_writes_the_same_bytes_as_jax(folder, tmp_path, codec, workers):
    """Byte-equal shards for the raw and the JPEG codec (PIL's LANCZOS,
    JPEG quality 100), from one process or a pool of workers."""
    port, jax_ = str(tmp_path / "port.srpack"), str(tmp_path / "jax.srpack")
    assert prepare(folder, port, (8, 16), workers, codec) == 5
    assert jprep.prepare(folder, jax_, (8, 16), 1, codec) == 5
    with open(port, "rb") as f, open(jax_, "rb") as g:
        assert f.read() == g.read()


def test_prepare_options_match_jax(folder, tmp_path):
    """Another filter and a limit; an empty folder raises."""
    port, jax_ = str(tmp_path / "port.srpack"), str(tmp_path / "jax.srpack")
    assert prepare(folder, port, (12,), 1, "raw", "bicubic", limit=3) == 3
    jprep.prepare(folder, jax_, (12,), 1, "raw", "bicubic", limit=3)
    with open(port, "rb") as f, open(jax_, "rb") as g:
        assert f.read() == g.read()
    (tmp_path / "empty").mkdir()
    with pytest.raises(ValueError, match="no images"):
        prepare(str(tmp_path / "empty"), port)


@pytest.mark.parametrize("resolution", [16, 0])
def test_image_folder_dataset_matches_jax(folder, resolution):
    ds, jd = ImageFolderDataset(folder, resolution), jds.ImageFolderDataset(folder, resolution)
    assert ds.files == jd.files and len(ds) == 5
    for i in range(len(ds)):
        np.testing.assert_array_equal(ds[i], jd[i])
    if resolution:
        batch = ds.read_batch(np.asarray([4, 0, 2]))
        assert batch.shape == (3, 16, 16, 3) and batch.dtype == np.uint8
        np.testing.assert_array_equal(batch, jd.read_batch(np.asarray([4, 0, 2])))


def test_jpeg_shard_decodes_as_jax(folder, tmp_path):
    """A JPEG shard's items, one by one and in batches, equal the JAX
    reader's decode; ``open_dataset`` takes folders and shards."""
    path = str(tmp_path / "j.srpack")
    prepare(folder, path, (16, 24), 1, "jpeg")
    ds, jd = SRPackDataset(path, 24), jds.SRPackDataset(path, 24)
    order = np.asarray([3, 1, 4, 0])
    got = ds.read_batch(order)
    assert got.shape == (4, 24, 24, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, jd.read_batch(order))
    with SRPackReader(path) as r:
        for i in range(5):
            np.testing.assert_array_equal(r.decode(16, i), jd.reader.decode(16, i))
    assert isinstance(open_dataset(path, 16), SRPackDataset)
    assert isinstance(open_dataset(folder, 16), ImageFolderDataset)


def test_cli_prepare_data_matches_prepare(folder, tmp_path, capsys):
    out = str(tmp_path / "cli.srpack")
    assert prepare_data.main([folder, "--out", out, "--size", "8,16", "--n_worker", "1",
                              "--codec", "jpeg"]) == 5
    prepare(folder, str(tmp_path / "ref.srpack"), (8, 16), 1, "jpeg")
    with open(out, "rb") as f, open(tmp_path / "ref.srpack", "rb") as g:
        assert f.read() == g.read()
    assert "wrote 5 items x sizes [8, 16]" in capsys.readouterr().out


def test_cli_train_takes_a_jpeg_shard(folder, tmp_path):
    """``cli.train`` on the JPEG shard that ``prepare`` wrote: a step at a
    tiny size on the CPU, its checkpoint and metrics written."""
    from stylerenderer_tpu_torch.cli.train import main

    shard = str(tmp_path / "j.srpack")
    prepare(folder, shard, (16,), 1, "jpeg")
    out = tmp_path / "run"
    state = main([shard, "--iter", "1", "--batch", "2", "--log_every", "1", "--seed", "0",
                  "--out_dir", str(out), "--size", "16", "--latent", "32", "--n_mlp", "2",
                  "--channel_multiplier", "1", "--device", "cpu"])
    assert state.step == 1
    assert (out / "checkpoint" / "000001.pt").exists()
    assert (out / "logs" / "metrics.jsonl").exists()

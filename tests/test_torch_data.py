"""The port's training data and checkpoints: the native SRPack reader
against shards written by the JAX writer and by the port's writer (byte
for byte), ``to_train_tensor`` and ``prefetch_batches`` against the JAX
package's (the same seed gives the same batches), the device prefetch, and
a checkpoint round trip (save, rotate, ``latest_step``, load into a fresh
state, take an identical next step)."""

import numpy as np
import pytest
import torch

from stylerenderer_tpu.data.dataset import (
    prefetch_batches as j_prefetch_batches,
    to_train_tensor as j_to_train_tensor,
)
from stylerenderer_tpu.data.srpack import SRPackReader as JSRPackReader
from stylerenderer_tpu.data.srpack import SRPackWriter as JSRPackWriter

from stylerenderer_tpu_torch.data import (
    SRPackDataset,
    SRPackReader,
    SRPackWriter,
    device_prefetch,
    prefetch_batches,
    to_train_tensor,
)
from stylerenderer_tpu_torch.face3d import synthetic_face
from stylerenderer_tpu_torch.train import init_train_state, sample_draws, train_step
from stylerenderer_tpu_torch.utils.checkpoint import (
    latest_step,
    load_checkpoint,
    load_params_only,
    save_checkpoint,
)
from stylerenderer_tpu_torch.utils.config import TrainConfig
from torch_threads import _one_thread  # noqa: F401

SIZES = (8, 16)


def _images(n, seed=0):
    rng = np.random.RandomState(seed)
    return [[rng.randint(0, 256, (s, s, 3), dtype=np.uint8) for s in SIZES] for _ in range(n)]


def _write(cls, path, images, codec="raw"):
    w = cls(str(path), SIZES, codec=codec)
    for per_size in images:
        w.add(per_size)
    w.finalize()
    return str(path)


@pytest.mark.parametrize("writer", [SRPackWriter, JSRPackWriter], ids=["port", "jax"])
def test_reader_reads_every_record(tmp_path, writer):
    """Every record of a two-size raw shard, one at a time and in shuffled
    batches, is the image written; the JAX reader agrees."""
    images = _images(7)
    path = _write(writer, tmp_path / "a.srpack", images)
    with SRPackReader(path) as r:
        assert (r.n_items, r.codec, r.sizes) == (7, 0, list(SIZES))
        order = np.array([6, 0, 3, 3, 1])
        for k, s in enumerate(SIZES):
            for i in range(7):
                assert r.read_record(s, i) == images[i][k].tobytes()
                np.testing.assert_array_equal(r.decode(s, i), images[i][k])
            batch = r.read_batch_raw(s, order)
            np.testing.assert_array_equal(batch, np.stack([images[i][k] for i in order]))
            np.testing.assert_array_equal(batch, JSRPackReader(path).read_batch_raw(s, order))


def test_reader_refuses_bad_input(tmp_path):
    """Out-of-range items and sizes, a file that is not a shard, the raw
    batch read of a JPEG shard, and a JPEG record that does not decode
    (its bytes still read as they are) raise."""
    path = _write(SRPackWriter, tmp_path / "a.srpack", _images(3))
    r = SRPackReader(path)
    with pytest.raises(IndexError):
        r.read_batch_raw(8, [0, 3])
    with pytest.raises(IndexError):
        r.read_record(8, -1)
    with pytest.raises(KeyError):
        r.read_batch_raw(32, [0])
    r.close()
    r.close()
    bad = tmp_path / "bad.srpack"
    bad.write_bytes(b"NOPE" + bytes(60))
    with pytest.raises(IOError):
        SRPackReader(str(bad))
    jpeg = tmp_path / "j.srpack"
    w = SRPackWriter(str(jpeg), [8], codec="jpeg")
    w.add([b"\xff\xd8not-really-a-jpeg"])
    w.finalize()
    with SRPackReader(str(jpeg)) as rj:
        assert rj.read_record(8, 0) == b"\xff\xd8not-really-a-jpeg"
        with pytest.raises(ValueError, match="JPEG"):
            rj.read_batch_raw(8, [0])
        with pytest.raises(OSError):
            rj.decode(8, 0)
    with pytest.raises(OSError):
        SRPackDataset(str(jpeg), 8).read_batch([0])
    with pytest.raises(ValueError, match="missing"):
        SRPackDataset(path, 32)


def test_to_train_tensor_matches_jax():
    batch = np.random.RandomState(1).randint(0, 256, (6, 5, 4, 3), dtype=np.uint8)
    got = to_train_tensor(batch, np.random.default_rng(3))
    want = j_to_train_tensor(batch, np.random.default_rng(3))
    assert got.dtype == torch.float32 and got.shape == (6, 3, 5, 4) and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), np.transpose(want, (0, 3, 1, 2)))
    assert float(got.min()) >= -1.0 and float(got.max()) <= 1.0
    np.testing.assert_array_equal(to_train_tensor(batch, None).numpy(),
                                  np.transpose(batch / np.float32(127.5) - 1, (0, 3, 1, 2)))


def test_prefetch_batches_match_jax(tmp_path):
    """Shuffled epochs with flips from one seed: the same batches as the
    JAX pipeline's, across an epoch boundary; one evaluation epoch in
    order; the device prefetch hands them on unchanged."""
    images = _images(10, seed=2)
    path = _write(SRPackWriter, tmp_path / "a.srpack", images)
    ds = SRPackDataset(path, 16)

    class JDataset:  # the JAX pipeline over the same shard
        def __len__(self):
            return 10

        def read_batch(self, idx):
            return JSRPackReader(path).read_batch_raw(16, idx)

    port = prefetch_batches(ds, 4, seed=7)
    jax_it = j_prefetch_batches(JDataset(), 4, seed=7)
    for _ in range(5):  # two batches per epoch (drop_last)
        np.testing.assert_array_equal(next(port).numpy(),
                                      np.transpose(next(jax_it), (0, 3, 1, 2)))
    port.close()
    jax_it.close()
    evals = list(device_prefetch(prefetch_batches(ds, 4, train=False, drop_last=False), "cpu"))
    assert [len(b) for b in evals] == [4, 4, 2]
    want = np.stack([im[1] for im in images]).astype(np.float32) / 127.5 - 1
    np.testing.assert_array_equal(torch.cat(evals).numpy(), np.transpose(want, (0, 3, 1, 2)))


def test_prefetch_raises_the_reader_error(tmp_path):
    class Broken:
        def __len__(self):
            return 8

        def read_batch(self, idx):
            raise OSError("disk gone")

    with pytest.raises(OSError, match="disk gone"):
        next(prefetch_batches(Broken(), 4))
    with pytest.raises(ValueError, match="cannot fill"):
        next(prefetch_batches(Broken(), 16))


def test_checkpoint_round_trip(tmp_path):
    """Save after one step, rotate, find the newest, load into a fresh state
    and take the next step: bit-equal metrics and parameters to the run
    that never stopped."""
    cfg = TrainConfig(size=8, latent=16, n_mlp=1, channel_multiplier=1, batch=2,
                      d_reg_every=2, g_reg_every=2, augment=True, ada_every=2)
    face, tri = synthetic_face(6, 12, 4, 2, device="cpu")
    real = torch.rand(2, 3, 8, 8, generator=torch.Generator().manual_seed(0)) * 2 - 1
    st = init_train_state(cfg, "cpu", seed=3)

    def step(s):
        return train_step(s, real, sample_draws(s.generator, cfg, face, 2, s.g.n_latent), cfg,
                          face, tri)

    step(st)
    ckpt = str(tmp_path / "ckpt")
    for k in (1, 2):
        save_checkpoint(ckpt, k, st, cfg, max_to_keep=1)
    assert [p.name for p in (tmp_path / "ckpt").iterdir()] == ["000002.pt"]
    assert latest_step(ckpt) == 2 and latest_step(str(tmp_path / "none")) is None
    resumed, cfg2 = load_checkpoint(ckpt, init_train_state(cfg, "cpu", seed=9))
    assert cfg2 == cfg and resumed.step == st.step == 1
    assert float(resumed.ada_count) == float(st.ada_count)
    raw, _ = load_params_only(ckpt)
    assert {"g", "d", "g_ema", "g_optim", "d_optim", "args", "ada_aug_p"} <= set(raw)
    m_a, m_b = step(st), step(resumed)
    assert {k: float(v) for k, v in m_a.items()} == {k: float(v) for k, v in m_b.items()}
    for a, b in zip(list(st.g.parameters()) + list(st.d.parameters())
                    + list(st.g_ema.parameters()),
                    list(resumed.g.parameters()) + list(resumed.d.parameters())
                    + list(resumed.g_ema.parameters())):
        assert torch.equal(a, b)
    with pytest.raises(FileNotFoundError):
        load_params_only(str(tmp_path / "none"))

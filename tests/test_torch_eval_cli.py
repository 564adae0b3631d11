"""The port's evaluation CLIs on the CPU: ``cli.calc_inception`` on the
synth writer's shard and on a folder of its images (the stats pickle read
by the JAX package), ``cli.fid --with_map`` and ``cli.ppl`` (the GAR and
the unconditioned Generator) on a port checkpoint, and ``fid``/``ppl``
with ``--bfm``. Split from ``test_torch_eval.py`` so that two test
processes share the evaluation layer's cost: each ``cli.fid`` here takes a
2048-dimensional scipy ``sqrtm``.
"""

import pickle

import numpy as np
import pytest
import torch

from stylerenderer_tpu.eval import fid as j_fid

from stylerenderer_tpu_torch.eval import fid
from stylerenderer_tpu_torch.models import Generator
from torch_threads import _one_thread  # noqa: F401


# ---- the CLIs on the CPU ------------------------------------------------------------

TINY = ["--size", "16", "--latent", "32", "--n_mlp", "2", "--channel_multiplier", "1",
        "--device", "cpu"]


@pytest.fixture(scope="module")
def tiny_ckpt(tmp_path_factory):
    """A ``cli.train`` checkpoint at size 16, and a 6-image shard of the
    port's synthetic-face writer."""
    from stylerenderer_tpu_torch.data import write_synth_dataset
    from stylerenderer_tpu_torch.train import init_train_state
    from stylerenderer_tpu_torch.utils.checkpoint import save_checkpoint
    from stylerenderer_tpu_torch.utils.config import TrainConfig

    root = tmp_path_factory.mktemp("eval_cli")
    cfg = TrainConfig(size=16, latent=32, n_mlp=2, channel_multiplier=1, batch=2)
    save_checkpoint(str(root / "ckpt"), 1, init_train_state(cfg, "cpu", seed=3), cfg)
    shard = str(root / "faces16.srpack")
    assert write_synth_dataset(shard, 6, size=16, batch=6, device="cpu") == 6
    return root, str(root / "ckpt"), shard


def test_cli_calc_inception_fid_ppl(tiny_ckpt, capsys):
    """``cli.calc_inception`` on the port writer's shard writes the stats
    pickle (JAX's ``load_stats`` reads it); ``cli.fid --with_map`` and
    ``cli.ppl`` (GAR and unconditioned) on a port checkpoint print finite
    numbers."""
    from stylerenderer_tpu_torch.cli import calc_inception, fid as cli_fid, ppl as cli_ppl

    root, ckpt, shard = tiny_ckpt
    stats = str(root / "stats.pkl")
    assert calc_inception.main([shard, "--size", "16", "--batch", "3", "--device", "cpu",
                                "--out", stats]) == stats
    mu, cov = j_fid.load_stats(stats)
    assert mu.shape == (2048,) and cov.shape == (2048, 2048) and np.isfinite(cov).all()
    with open(stats, "rb") as f:
        assert pickle.load(f)["meta"] == {"size": 16, "n": 6, "pretrained": False}
    value = cli_fid.main(["--ckpt", ckpt, "--inception", stats, "--with_map", "--n_sample",
                          "5", "--batch", "2"] + TINY)
    assert np.isfinite(value) and value > 0
    for extra in (["--with_map"], ["--space", "z", "--sampling", "full", "--crop"]):
        argv = ["--ckpt", ckpt, "--n_sample", "3", "--batch", "2"] + TINY + extra
        if "--with_map" not in extra:  # an unconditioned generator's checkpoint
            argv[1] = str(_generator_ckpt(root))
            argv[argv.index("--size") + 1] = "32"
        assert np.isfinite(cli_ppl.main(argv))
    out = capsys.readouterr().out
    assert "fid: " in out and out.count("ppl: ") == 2


def _generator_ckpt(root):
    """A checkpoint directory holding an unconditioned ``Generator(32, 32,
    2)``'s ``g_ema`` (``crop`` needs 32 px for VGG's five taps)."""
    path = root / "gen_ckpt"
    if not path.exists():
        path.mkdir()
        from stylerenderer_tpu_torch.utils.config import TrainConfig

        g = Generator(32, 32, 2, channel_multiplier=1, device="cpu", seed=2)
        torch.save({"g_ema": g.state_dict(),
                    "args": TrainConfig(size=32, latent=32, n_mlp=2,
                                        channel_multiplier=1).to_dict()},
                   path / "000001.pt")
    return path


@pytest.mark.parametrize("cli,argv", [
    ("calc_inception", ["DIR"]),
    ("fid", ["--ckpt", "x", "--inception", "y", "--bfm", "b.mat"]),
    ("ppl", ["--ckpt", "x", "--bfm", "b.mat"]),
])
def test_eval_clis_take_folder_and_bfm(tiny_ckpt, tmp_path, capsys, cli, argv):
    """What these CLIs refused before the face models and the image folders
    were ported, they take now: ``calc_inception`` on a folder of the
    shard's images writes the shard's statistics, and ``fid`` and ``ppl``
    with ``--with_map --bfm`` render a BFM file's mesh and print finite
    numbers."""
    import importlib

    import scipy.io
    from torch_face_models import bfm_dict

    from stylerenderer_tpu_torch.data import SRPackReader
    from stylerenderer_tpu_torch.utils.image import write_png

    mod = importlib.import_module(f"stylerenderer_tpu_torch.cli.{cli}")
    root, ckpt, shard = tiny_ckpt
    if cli == "calc_inception":
        folder = tmp_path / "faces"
        folder.mkdir()
        with SRPackReader(shard) as r:
            for i in range(r.n_items):
                write_png(str(folder / f"{i}.png"), r.decode(16, i))
        stats = {}
        for name, src in (("folder", str(folder)), ("shard", shard)):
            out = str(tmp_path / f"{name}.pkl")
            mod.main([src if a == "DIR" else a for a in argv]
                     + ["--size", "16", "--batch", "3", "--device", "cpu", "--out", out])
            stats[name] = j_fid.load_stats(out)
        for a, b in zip(stats["folder"], stats["shard"]):
            np.testing.assert_array_equal(a, b)
        return
    bfm = str(tmp_path / "bfm.mat")
    scipy.io.savemat(bfm, bfm_dict(12, 24, 4, 2))
    real = str(tmp_path / "real.pkl")
    fid.save_stats(real, np.zeros(2048), np.eye(2048))
    argv = [{"x": ckpt, "y": real, "b.mat": bfm}.get(a, a) for a in argv]
    value = mod.main(argv + ["--with_map", "--n_sample", "3", "--batch", "2"] + TINY)
    assert np.isfinite(value)
    assert "not ported" not in capsys.readouterr().err

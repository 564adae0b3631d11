"""The port's demonstration scripts (``stylerenderer_tpu_torch/scripts/``) on
the CPU at a toy size: 16 px, narrow widths, a small BFM file (``--bfm``,
the sphere layout of ``tests/torch_face_models.py``, 1,104 triangles, in
place of the synthetic face's 9,024), two training steps, two faces, one
or two fit iterations, four FID samples.

The scripts chain as on the card: ``train_demo`` and ``train_demo256`` each
train one toy checkpoint (module-scoped, so each run is paid once);
``recon_demo`` inverts the first, ``train_demo256_ada`` resumes the second
and ``recon_demo256`` trains its Regressor on it. Each test checks the
script's artifacts and that their numbers are finite; the reconstruction
tests also check that the metrics are computed on the right tensors.
``parity_eval --dry_run`` runs with the network refused.
"""

import json
import os
import socket

import numpy as np
import pytest
import torch

from stylerenderer_tpu_torch.scripts import (
    parity_eval, recon_demo, recon_demo256, train_demo, train_demo256, train_demo256_ada,
)
from stylerenderer_tpu_torch.scripts._common import all_finite, face_metrics
from torch_threads import _one_thread  # noqa: F401

TOY = ["--size", "16", "--latent", "32", "--n_mlp", "2", "--channel_multiplier", "1",
       "--device", "cpu"]


@pytest.fixture(scope="module")
def bfm(tmp_path_factory):
    import scipy.io
    from torch_face_models import bfm_dict

    path = str(tmp_path_factory.mktemp("bfm") / "bfm.mat")
    scipy.io.savemat(path, bfm_dict(24, 24, 4, 2))
    return path


def _json(path):
    with open(path) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def demo64(tmp_path_factory, bfm):
    """``train_demo``: 2 steps at B=2 on 8 synth faces, one checkpoint, its
    FID on 4 samples."""
    out = str(tmp_path_factory.mktemp("train_demo"))
    summary = train_demo.main(["--steps", "2", "--batch", "2", "--n_data", "8", "--n_fid", "4",
                               "--ckpt_every", "2", "--log_every", "1", "--out", out,
                               "--bfm", bfm] + TOY)
    return out, summary


@pytest.fixture(scope="module")
def demo256(tmp_path_factory, bfm):
    """``train_demo256`` at the toy size: 2 steps, one checkpoint."""
    out = str(tmp_path_factory.mktemp("train_demo256"))
    summary = train_demo256.main(["--steps", "2", "--batch", "2", "--n_data", "8",
                                  "--ckpt_every", "2", "--log_every", "1", "--out", out,
                                  "--bfm", bfm] + TOY)
    return out, summary


def test_train_demo(demo64):
    out, summary = demo64
    for name in ("faces16.srpack", "real_stats.pkl", "checkpoint/000002.pt", "sample/000001.png",
                 "sample/000001_norm.png", "logs/metrics.jsonl"):
        assert os.path.exists(os.path.join(out, name)), name
    trend = _json(os.path.join(out, "fid_trend.json"))
    assert [t["step"] for t in trend] == [2] and np.isfinite(trend[0]["fid"])
    curves = _json(os.path.join(out, "curves.json"))
    assert curves["step"] == [0, 1] and curves["fid_trend"] == trend
    assert all_finite(curves) and all(v is not None for v in curves["d"] + curves["g"])
    assert summary["fid_trend"] == trend and np.isfinite(summary["imgs_per_sec"])


def test_train_demo256(demo256):
    out, summary = demo256
    assert os.path.exists(os.path.join(out, "checkpoint", "000002.pt"))
    curves = _json(os.path.join(out, "curves.json"))
    assert curves["step"] == [0, 1] and curves["fid_trend"] is None and all_finite(curves)
    assert len(summary["step_ms"]) == 2 and np.isfinite(summary["imgs_per_sec"])


def test_train_demo256_ada_resumes(demo256, bfm, tmp_path):
    """ADA resumed from ``train_demo256``'s checkpoint at step 2 for 2 more
    steps, the controller at every step; the FID trends are the same code as
    ``train_demo``'s and are skipped here (each is a 2048-d ``sqrtm``)."""
    base, _ = demo256
    out = str(tmp_path / "ada")
    summary = train_demo256_ada.main(["--steps", "2", "--batch", "2", "--base", base,
                                      "--ada_every", "1", "--ada_length", "100", "--log_every",
                                      "1", "--skip_fid", "--out", out, "--bfm", bfm] + TOY)
    assert summary["resumed_from_step"] == 2
    assert os.path.exists(os.path.join(out, "checkpoint", "000004.pt"))
    ada = _json(os.path.join(out, "ada_summary.json"))
    assert ada["logged_steps"] == [2, 3] and len(ada["ada_p"]) == len(ada["r_t"]) == 2
    assert all_finite(ada) and all(0.0 <= p <= 1.0 for p in ada["ada_p"])
    assert all_finite(_json(os.path.join(out, "curves.json")))


def _check_recon(out, summary, tag=""):
    """The saved first batch reproduces the reported per-face metrics, and
    the metric function gives 0 on a target against itself."""
    b = np.load(os.path.join(out, f"batch_0{tag}.npz"))
    t = {k: torch.from_numpy(b[k]) for k in ("target", "render", "vertices", "vertices_gt",
                                              "lmk_vidx")}
    size = t["target"].shape[-1]
    m = face_metrics(t["render"], t["target"], t["vertices"], t["vertices_gt"], t["lmk_vidx"],
                     size)
    n = len(m["pixel_mse"])
    for k, v in m.items():
        np.testing.assert_allclose(summary["per_face"][k][:n], v, rtol=1e-6)
    same = face_metrics(t["target"], t["target"], t["vertices_gt"], t["vertices_gt"],
                        t["lmk_vidx"], size)
    assert (same["pixel_mse"] == 0).all() and (same["vertex_rmse"] == 0).all()
    assert (same["lmk_err_px"] == 0).all() and np.isfinite(same["psnr"]).all()
    assert (m["pixel_mse"] > 0).all() and (m["vertex_rmse"] > 0).all()


def test_recon_demo(demo64, bfm, tmp_path):
    ckpt = os.path.join(demo64[0], "checkpoint")
    out = str(tmp_path / "recon")
    summary = recon_demo.main(["--faces", "2", "--iters", "2", "--batch", "2", "--ckpt", ckpt,
                               "--out", out, "--bfm", bfm, "--device", "cpu"])
    metrics = _json(os.path.join(out, "metrics.json"))
    assert metrics["faces"] == 2 and all_finite(metrics)
    assert os.path.exists(os.path.join(out, "grid_0.png"))
    _check_recon(out, metrics)
    assert summary["pixel_mse"]["mean"] == metrics["pixel_mse"]["mean"]


def test_recon_demo256(demo256, bfm, tmp_path):
    ckpt = os.path.join(demo256[0], "checkpoint")
    out = str(tmp_path / "recon256")
    recon_demo256.main(["--faces", "2", "--batch", "2", "--reg_steps", "2", "--reg_batch", "2",
                        "--iters_short", "1", "--iters_full", "2", "--ckpt", ckpt,
                        "--out", out, "--bfm", bfm, "--device", "cpu"])
    metrics = _json(os.path.join(out, "metrics.json"))
    configs = ("mean_init_1", "regressor_init_1", "mean_init_2", "regressor_init_2")
    assert set(configs) <= set(metrics) and all_finite(metrics)
    for name in configs:
        assert os.path.exists(os.path.join(out, f"grid_{name}_0.png"))
        _check_recon(out, metrics[name], f"_{name}")
    losses = _json(os.path.join(out, "regressor_loss.json"))["steps_losses"]
    assert [s for s, _ in losses] == [0, 1] and all_finite(losses)


def test_parity_eval_dry_run(bfm, tmp_path, monkeypatch):
    """Seeded stand-ins of the published files pass the audit (every key
    consumed with its shape, the Inception's ``fc`` left as unused), and
    FID, PPL and LPIPS come out finite; no connection is attempted."""
    def refuse(*args, **kwargs):
        raise AssertionError("parity_eval tried to open a connection")

    monkeypatch.setattr(socket.socket, "connect", refuse)
    out = str(tmp_path / "parity")
    report = parity_eval.main(["--dry_run", "--n_fid", "4", "--n_ppl", "4", "--n_lpips_pairs",
                               "2", "--batch", "2", "--with_map", "--bfm", bfm, "--out", out] + TOY)
    for k in ("audit_inception", "audit_vgg", "audit_lpips_lin"):
        assert report[k]["ok"], report[k]
        assert report[k]["consumed"] > 0 and not report[k]["missing"]
    assert report["audit_inception"]["unconsumed"] == ["fc.weight", "fc.bias"]
    assert report["audit_lpips_lin"]["consumed"] == 5
    for k in ("fid", "ppl"):
        assert np.isfinite(report[k]["value"])
    assert np.isfinite(report["lpips_fixed_pairs"]["mean"]) and all_finite(report)
    assert _json(os.path.join(out, "parity_eval.json"))["dry_run"] is True

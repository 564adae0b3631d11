"""The port's face alignment against the JAX package (and OpenCV, whose
``warpAffine`` and ``resize`` the JAX package calls): the pose solvers,
the landmark readers and detectors, the warp, the canonical references,
segmentation and recognition, ``align_dataset`` and ``cli.align``.

The warp is held to 1 grey level of ``cv2.warpAffine`` (measured: OpenCV
5 interpolates in float and rounds to bytes; the port's bilinear
``grid_sample`` sums in another order, so a value at a half level may
round the other way) and exactly on integer translations."""

import os
import stat
import sys

import cv2
import numpy as np
import pytest
import jax
import torch

from torch_face_models import bfm_dict

from stylerenderer_tpu.cli import align as j_cli_align
from stylerenderer_tpu.face3d import alignment as jal
from stylerenderer_tpu.face3d import io as jio
from stylerenderer_tpu.supervisors.convert import convert_facenet

from stylerenderer_tpu_torch.cli import align as cli_align
from stylerenderer_tpu_torch.face3d import alignment as al
from stylerenderer_tpu_torch.face3d import load_bfm
from stylerenderer_tpu_torch.supervisors.convert import random_stand_in_
from stylerenderer_tpu_torch.supervisors.landmark import PFLDInference
from stylerenderer_tpu_torch.supervisors.recognition import InceptionResnetV1
from stylerenderer_tpu_torch.utils.image import write_png
from torch_threads import _one_thread  # noqa: F401

WARP_TOL = 1  # grey levels


def _image(seed, h, w, smooth=False):
    rng = np.random.RandomState(seed)
    if smooth:
        y, x = np.mgrid[:h, :w]
        img = 127 + 100 * np.sin(x[..., None] / 5.0 + y[..., None] / 7.0 + np.arange(3))
        return np.clip(img + rng.randn(h, w, 3) * 10, 0, 255).astype(np.uint8)
    return rng.randint(0, 256, (h, w, 3)).astype(np.uint8)


def _similarity(rng, scale=(0.7, 1.4), shift=8.0):
    th, s = rng.uniform(-0.6, 0.6), rng.uniform(*scale)
    return np.asarray([[s * np.cos(th), -s * np.sin(th), rng.uniform(-shift, shift)],
                       [s * np.sin(th), s * np.cos(th), rng.uniform(-shift, shift)]])


# ---- pose solvers ---------------------------------------------------------------


@pytest.mark.parametrize("max_iter", [0, 50])
def test_pose_solvers_match_jax(max_iter):
    """``solve_ortho`` (closed form and ``leastsq``), ``solve_affine``,
    ``euler_mat_inv`` and the Rodrigues pair: the same numpy code, to
    1e-10."""
    rng = np.random.RandomState(max_iter)
    p3 = rng.randn(68, 3)
    R = jal._rodrigues_np(rng.randn(3) * 0.4)
    p2 = 1.7 * (p3 @ R)[:, :2] + [3.0, -2.0] + rng.randn(68, 2) * 0.01
    s, Rp, t = al.solve_ortho(p3, p2, max_iter=max_iter)
    js, jR, jt = jal.solve_ortho(p3, p2, max_iter=max_iter)
    np.testing.assert_allclose([s], [js], rtol=0, atol=1e-10)
    np.testing.assert_allclose(Rp, jR, rtol=0, atol=1e-10)
    np.testing.assert_allclose(t, jt, rtol=0, atol=1e-10)
    np.testing.assert_allclose(Rp, R, atol=1e-2)
    src = rng.randn(68, 2) * 30
    dst = src @ _similarity(rng)[:, :2].T + 5
    np.testing.assert_allclose(al.solve_affine(src, dst), jal.solve_affine(src, dst),
                               rtol=0, atol=1e-10)
    for order in ("yxz", "xyz"):
        np.testing.assert_allclose(al.euler_mat_inv(R, order), jal.euler_mat_inv(R, order),
                                   rtol=0, atol=1e-10)
    r = rng.randn(3)
    np.testing.assert_allclose(al._rodrigues_np(r), jal._rodrigues_np(r), rtol=0, atol=1e-10)
    np.testing.assert_allclose(al._rodrigues_inv_np(R), jal._rodrigues_inv_np(R), rtol=0,
                               atol=1e-10)
    np.testing.assert_array_equal(al._rodrigues_np(np.zeros(3)), np.eye(3))


# ---- readers and detectors -----------------------------------------------------------


def test_landmark_readers_match_jax(tmp_path):
    """Per-image ``.txt`` files and a manifest: equal arrays; the port's
    manifest reader also answers by path."""
    rng = np.random.RandomState(0)
    names = ["b.png", "a.jpg", "sub_c.bmp"]
    lmks = {n: rng.uniform(0, 200, (68, 2)).astype(np.float32) for n in names}
    (tmp_path / "lmk").mkdir()
    lines = []
    for n, pts in lmks.items():
        with open(tmp_path / "lmk" / (os.path.splitext(n)[0] + ".txt"), "w") as f:
            f.write("\n".join(f"{x} {y}" for x, y in pts) + "\n")
        lines.append(n + " " + " ".join(f"{v}" for v in pts.reshape(-1)))
    manifest = str(tmp_path / "m.txt")
    with open(manifest, "w") as f:
        f.write("\n\n".join(lines) + "\n")
    reader, jreader = al.LandmarksReader(str(tmp_path / "lmk")), jal.LandmarksReader(
        str(tmp_path / "lmk"))
    mreader, jmreader = al.LandmarksManifestReader(manifest), jal.LandmarksManifestReader(
        manifest)
    assert mreader.names == jmreader.names
    np.testing.assert_array_equal(mreader.data, jmreader.data)
    for n, pts in lmks.items():
        path = f"/photos/{n}"
        np.testing.assert_array_equal(reader.detect_path(path), jreader.detect_path(path))
        np.testing.assert_array_equal(mreader.detect(n), jmreader.detect(n))
        np.testing.assert_array_equal(mreader.detect_path(path), pts)
    assert mreader.detect("missing.png") is None and jmreader.detect("missing.png") is None


_FAKE_DETECTOR = """#!{python}
import os, sys
import numpy as np
from PIL import Image
out, arg = sys.argv[1], sys.argv[2]
files = sorted(os.path.join(arg, n) for n in os.listdir(arg)) if os.path.isdir(arg) else [arg]
with open(out, "w") as f:
    for p in files:
        a = np.asarray(Image.open(p).convert("RGB"), np.float64)
        # landmarks that name the file's pixels: the channel means and a corner
        vals = list(a.mean((0, 1))) + [a[0, 0, 0], a[-1, -1, 2], float(a.shape[1])]
        f.write(os.path.basename(p) + " " + " ".join(str(v) for v in vals) + "\\n")
"""


def test_exec_detector_matches_jax(tmp_path):
    """An external binary on an image array (written as a PNG: the port's
    writer against ``cv2.imwrite``, same pixels and channel order), a path
    and a list of paths."""
    exe = tmp_path / "bin" / "detect"
    exe.parent.mkdir()
    exe.write_text(_FAKE_DETECTOR.format(python=sys.executable))
    exe.chmod(exe.stat().st_mode | stat.S_IEXEC)
    img = _image(1, 20, 30)
    (tmp_path / "photos").mkdir()
    paths = []
    for i in range(2):
        paths.append(str(tmp_path / "photos" / f"p{i}.png"))
        cv2.imwrite(paths[-1], _image(2 + i, 16, 12))
    det, jdet = al.LandmarksDetectorExec(str(exe)), jal.LandmarksDetectorExec(str(exe))
    for arg in (img, paths[0], paths):
        got, want = det.detect(arg), jdet.detect(arg)
        np.testing.assert_array_equal(got, want)
    assert det.detect(img).shape == (3, 2)
    assert not os.listdir(det.workdir)  # the temporary PNG and manifest are removed


def test_dlib_detector_needs_dlib():
    """dlib is imported when the detector is made: without it (it is
    installed neither here nor with the port), ``ImportError``; with it, a
    missing predictor file raises."""
    with pytest.raises((ImportError, RuntimeError)):
        al.LandmarksDetectorDlib("missing_predictor.dat")


def _pfld():
    return random_stand_in_(PFLDInference(), torch.Generator().manual_seed(0)).eval()


def test_resize_matches_cv2():
    """The detectors' bilinear resize against ``cv2.resize``'s
    ``INTER_LINEAR`` (which the JAX package's detectors call): within 1
    grey level (OpenCV sums in fixed point)."""
    for h, w, size in ((90, 120, 112), (200, 170, 160), (40, 40, 112)):
        img = _image(h, h, w, smooth=True)
        want = cv2.resize(img, (size, size))
        x = torch.from_numpy(img).permute(2, 0, 1)[None].float()
        got = al._resize_u8(x, size, size)[0].permute(1, 2, 0).numpy()
        assert np.abs(got - want.astype(np.float32)).max() <= 1


def test_torch_landmark_detector_matches_jax():
    """``LandmarksDetectorTorch`` over the port's PFLD: the JAX adapter on
    the same net and image gives the same landmarks (an image at the net's
    size is not resized by either)."""
    net = _pfld()
    img = _image(3, 112, 112)
    got = al.LandmarksDetectorTorch(net).detect(img)
    want = jal.LandmarksDetectorTorch(net).detect(img)
    assert got.shape == (68, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # another size: the same net on the port's resize
    img = _image(4, 90, 150, smooth=True)
    x = al._resize_u8(torch.from_numpy(img).permute(2, 0, 1)[None].float(), 112, 112) / 255
    with torch.no_grad():
        ref = net(x).reshape(-1, 2).numpy() * [150, 90]
    np.testing.assert_allclose(al.LandmarksDetectorTorch(net).detect(img), ref, rtol=0,
                               atol=1e-4)


# ---- the warp --------------------------------------------------------------------


@pytest.mark.parametrize("border", ["constant", "reflect"])
@pytest.mark.parametrize("src_hw,dst_hw", [((40, 50), (45, 60)), ((64, 48), (64, 64)),
                                           ((33, 70), (20, 30))])
def test_warp_affine_matches_cv2(border, src_hw, dst_hw):
    """Random similarities (and a shear) on non-square sources, for both
    borders: within ``WARP_TOL`` grey levels of ``cv2.warpAffine``; integer
    translations exactly."""
    rng = np.random.RandomState(src_hw[0] + dst_hw[1])
    img = _image(src_hw[0], *src_hw)
    mode = cv2.BORDER_REFLECT if border == "reflect" else cv2.BORDER_CONSTANT
    Ms = [_similarity(rng) for _ in range(3)] + [np.asarray([[1.1, 0.3, -2.0], [-0.2, 0.9, 4.5]])]
    x = torch.from_numpy(img).permute(2, 0, 1)[None].float().repeat(len(Ms), 1, 1, 1)
    out = al.warp_affine(x, np.stack(Ms), dst_hw, border)
    got = torch.clamp(torch.round(out), 0, 255).permute(0, 2, 3, 1).numpy()
    for M, g in zip(Ms, got):
        want = cv2.warpAffine(img, M, dst_hw[::-1], flags=cv2.INTER_LINEAR, borderMode=mode)
        assert np.abs(g - want.astype(np.float32)).max() <= WARP_TOL
    for shift in ((3, -2), (-7, 11), (0, 0)):
        M = np.asarray([[1.0, 0.0, shift[0]], [0.0, 1.0, shift[1]]])
        want = cv2.warpAffine(img, M, dst_hw[::-1], flags=cv2.INTER_LINEAR, borderMode=mode)
        got = al.warp_affine(x[:1], M[None], dst_hw, border)[0].permute(1, 2, 0)
        np.testing.assert_array_equal(torch.round(got).numpy(), want.astype(np.float32))


def test_align_faces_match_jax():
    """``align_face`` (zeros outside) and ``align_face_ortho`` (mirrored
    border, the pose's roll) against the JAX package's cv2 warps."""
    rng = np.random.RandomState(7)
    img = _image(7, 80, 64, smooth=True)
    lmk = rng.uniform(10, 60, (68, 2))
    ref = lmk @ _similarity(rng)[:, :2].T + 4
    got = al.align_face(img, lmk, ref, 48, device="cpu")
    want = jal.align_face(img, lmk, ref, 48)
    assert got.dtype == np.uint8 and got.shape == want.shape == (48, 48, 3)
    assert np.abs(got.astype(int) - want).max() <= WARP_TOL
    p3 = rng.randn(68, 3)
    R = jal._rodrigues_np([0.1, 0.2, 0.5])
    p2 = 20 * (p3 @ R)[:, :2] + 30
    got = al.align_face_ortho(img, p2, p3, 56, max_iter=20, device="cpu")
    want = jal.align_face_ortho(img, p2, p3, 56, max_iter=20)
    assert np.abs(got.astype(int) - want).max() <= WARP_TOL


def test_warp_refuses_bad_input():
    x = torch.zeros(1, 3, 8, 8)
    with pytest.raises(ValueError, match="border"):
        al.warp_affine(x, np.eye(2, 3)[None], 8, "wrap")
    with pytest.raises(ValueError, match="at least 2"):
        al.warp_affine(torch.zeros(1, 3, 1, 8), np.eye(2, 3)[None], 8)


# ---- canonical references, segmentation, recognition -------------------------------------


def test_canonical_references_match_jax():
    """The projected landmark vertices to 1e-4 px; the render-and-detect
    reference with the same detector on both renders, equal."""
    data = bfm_dict(12, 24, 4, 2)
    jm, jtri = jio.load_bfm(data)
    pm, ptri = load_bfm(data, device="cpu")
    vidx = np.linspace(0, 12 * 24 - 1, 68).astype(np.int64)
    np.testing.assert_allclose(al.build_canonical_reference(pm, ptri, vidx, 64),
                               jal.build_canonical_reference(jm, jtri, vidx, 64),
                               rtol=0, atol=1e-4)

    class Centroid:
        def detect(self, img):
            ys, xs = np.nonzero(img.any(-1))
            return np.asarray([[xs.mean(), ys.mean()], [xs.min(), ys.max()]], np.float32)

    tex = data["tex"].T
    got = al.build_canonical_reference_render(pm, tex, ptri, Centroid(), 64)
    want = jal.build_canonical_reference_render(jm, tex, jtri, Centroid(), 64)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)

    class Blind:
        def detect(self, img):
            return None

    with pytest.raises(RuntimeError, match="no face"):
        al.build_canonical_reference_render(pm, tex, ptri, Blind(), 64)


def test_grabcut_segmentation_matches_jax():
    img = _image(9, 60, 70, smooth=True)
    lmk = np.random.RandomState(9).uniform(15, 50, (68, 2))
    seg = al.SkinSegmentationGrabcut(iters=2, erode=5, dilate=9)
    jseg = jal.SkinSegmentationGrabcut(iters=2, erode=5, dilate=9)
    cv2.setRNGSeed(0)  # grabCut's GMM initialization draws from OpenCV's generator
    got = seg.segment(img, lmk)
    cv2.setRNGSeed(0)
    np.testing.assert_array_equal(got, jseg.segment(img, lmk))
    assert got.dtype == np.uint8 and 0 < got.sum() < got.size


def test_torch_segmentation_matches_jax():
    """A torch module behind both adapters: the same mask (the crop to
    multiples of 32, BGR to RGB, normalization, threshold and padding)."""
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Conv2d(3, 2, 3, padding=1), torch.nn.Tanh())
    img = _image(10, 70, 100, smooth=True)
    got = al.SkinSegmentationTorch(model, 0.5).segment(img)
    want = jal.SkinSegmentationTorch(model, 0.5).segment(img)
    assert got.shape == (70, 100) and got.dtype == bool
    np.testing.assert_array_equal(got, want)
    assert got[:64, :96].any() and not got[64:].any() and not got[:, 96:].any()


def test_recognition_feature_matches_jax():
    """``RecognitionFeature`` with the JAX package's parameters (through the
    JAX converter of the port's state dict) on the same crop: embeddings to
    1e-4 of the largest. The default centre crop is the port's resize
    (``test_resize_matches_cv2``)."""
    net = random_stand_in_(InceptionResnetV1(), torch.Generator().manual_seed(1)).eval()
    sd = net.state_dict()
    crop = _image(11, 75, 75, smooth=True)
    feat = al.RecognitionFeature(sd, detect_crop=lambda img: crop, device="cpu")
    jfeat = jal.RecognitionFeature({"params": convert_facenet(sd)}, detect_crop=lambda img: crop)
    apply = jax.jit(jfeat.net.apply)
    jfeat.net = type("JitNet", (), {"apply": staticmethod(apply)})()
    img = _image(12, 90, 100)
    got, want = feat.detect(img), np.asarray(jfeat.detect(img))
    assert got.shape == (512,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())
    default = al.RecognitionFeature(sd, device="cpu").detect(_image(13, 90, 100))
    assert default.shape == (512,) and np.isfinite(default).all()
    assert al.RecognitionFeature(sd, detect_crop=lambda img: None, device="cpu").detect(img) is None


# ---- align_dataset and cli.align -------------------------------------------------------


def _photos(tmp_path, n=3, size=(72, 60)):
    """PNG photos with landmark files and a manifest; one file that does
    not decode."""
    rng = np.random.RandomState(5)
    (tmp_path / "in").mkdir()
    (tmp_path / "lmk").mkdir()
    lines = []
    for i in range(n):
        name = f"face{i}.png"
        cv2.imwrite(str(tmp_path / "in" / name), _image(20 + i, *size, smooth=True))
        pts = rng.uniform(8, 52, (68, 2))
        np.savetxt(tmp_path / "lmk" / f"face{i}.txt", pts, fmt="%.4f")
        lines.append(name + " " + " ".join(f"{v:.4f}" for v in pts.reshape(-1)))
    (tmp_path / "in" / "broken.png").write_bytes(b"\x89PNG not an image")
    np.savetxt(tmp_path / "lmk" / "broken.txt", rng.uniform(8, 52, (68, 2)))
    with open(tmp_path / "m.txt", "w") as f:
        f.write("\n".join(lines) + "\n")
    return tmp_path


@pytest.mark.parametrize("detector", ["lmk_dir", "lmk_manifest"])
def test_cli_align_matches_jax(tmp_path, detector):
    """``cli.align`` on a folder of PNGs with a BFM file and landmark
    vertices: the JAX CLI's file names (the broken photo skipped), images
    within ``WARP_TOL``. The JAX CLI runs with ``--lmk_dir``: its
    ``align_dataset`` hands the manifest reader the image array, which it
    cannot take."""
    root = _photos(tmp_path)
    bfm = str(root / "bfm.mat")
    import scipy.io

    scipy.io.savemat(bfm, bfm_dict(12, 24, 4, 2))
    common = ["--size", "48", "--bfm", bfm, "--lmk_vidx",
              ",".join(str(i) for i in np.linspace(0, 287, 68).astype(int))]
    src = ["--lmk_dir", str(root / "lmk")] if detector == "lmk_dir" else [
        "--lmk_manifest", str(root / "m.txt")]
    n = cli_align.main([str(root / "in"), "--out", str(root / "port")] + src + common
                       + ["--device", "cpu"])
    j_cli_align.main([str(root / "in"), "--out", str(root / "jax"), "--lmk_dir",
                      str(root / "lmk")] + common)
    names = sorted(os.listdir(root / "port"))
    assert n == 3 and names == sorted(os.listdir(root / "jax")) == [
        "face0.png", "face1.png", "face2.png"]
    for name in names:
        got = al.read_bgr(str(root / "port" / name))
        want = cv2.imread(str(root / "jax" / name))
        assert got.shape == want.shape == (48, 48, 3)
        assert np.abs(got.astype(int) - want).max() <= WARP_TOL


def test_cli_align_refuses_render_ref_with_landmark_files(tmp_path, capsys):
    for src in (["--lmk_dir", "L"], ["--lmk_manifest", "m.txt"]):
        with pytest.raises(SystemExit):
            cli_align.main(["in", "--out", "out", "--render_ref", "--bfm", "b.mat", "--device",
                            "cpu"] + src)
        assert "--render_ref runs the detector" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        cli_align.main(["in", "--out", "out", "--device", "cpu"])
    assert "need --lmk_dir" in capsys.readouterr().err


def test_align_dataset_renders_the_reference(tmp_path):
    """``tex`` given: the reference is the detector's answer on the mean
    face's render (a detector that takes images); JPEG photos are written
    at quality 95 and read back."""
    root = tmp_path
    (root / "in").mkdir()
    img = _image(30, 64, 64, smooth=True)
    cv2.imwrite(str(root / "in" / "a.jpg"), img)
    data = bfm_dict(12, 24, 4, 2)
    pm, ptri = load_bfm(data, device="cpu")
    jm, jtri = jio.load_bfm(data)
    lmk = np.random.RandomState(1).uniform(10, 50, (5, 2)).astype(np.float32)

    class Fixed:
        def __init__(self):
            self.seen = []

        def detect(self, im):
            self.seen.append(im.shape)
            return lmk if im.shape[:2] == (64, 64) else lmk * 0.9 + 3

    det, jdet = Fixed(), Fixed()
    assert al.align_dataset(str(root / "in"), str(root / "out"), det, pm, ptri, size=40,
                            tex=data["tex"].T) == 1
    assert jal.align_dataset(str(root / "in"), str(root / "jout"), jdet, jm, jtri, size=40,
                             tex=data["tex"].T) == 1
    assert det.seen == jdet.seen == [(40, 40, 3), (64, 64, 3)]
    got, want = al.read_bgr(str(root / "out" / "a.jpg")), cv2.imread(str(root / "jout" / "a.jpg"))
    assert got.shape == want.shape == (40, 40, 3)
    # both JPEGs at quality 95 of images within WARP_TOL: their decodes stay close
    assert np.abs(got.astype(int) - want).mean() < 2.0


def test_read_bgr_matches_cv2(tmp_path):
    img = _image(40, 30, 20)
    cv2.imwrite(str(tmp_path / "a.png"), img)
    write_png(str(tmp_path / "b.png"), img[:, :, ::-1])
    for name in ("a.png", "b.png"):
        np.testing.assert_array_equal(al.read_bgr(str(tmp_path / name)), img)
    (tmp_path / "c.png").write_bytes(b"nope")
    assert al.read_bgr(str(tmp_path / "c.png")) is None

"""Face alignment and preprocessing (counterpart of
``stylerenderer_tpu/face3d/alignment.py``).

- landmark detectors behind ``detect(img) -> [L, 2]`` (and, for readers of
  landmark files, ``detect_path(path)``): per-image ``.txt`` files, a
  manifest, an external binary, dlib (imported lazily; not installed with
  the port) and PFLD-style nets on the net's device;
- pose solvers, a host copy in numpy and scipy: ``solve_ortho``
  (scaled-orthographic pose from 3D to 2D landmarks, with an optional
  ``leastsq`` refinement), ``solve_affine`` (2D similarity) and
  ``euler_mat_inv``;
- skin segmentation (``cv2.grabCut``, imported lazily; a torch module) and
  the face-embedding wrapper ``RecognitionFeature``;
- the alignment pipeline: the canonical reference (the mean face's
  landmark vertices projected, or a detector run on its render), the
  similarity warp on the device (``warp_affine``, cv2's ``warpAffine``
  semantics in torch) and ``align_dataset``.

Images are uint8 BGR ``[H, W, 3]`` arrays, the layout of ``cv2.imread``
that the JAX package uses; files are read and written with PIL.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from stylerenderer_tpu_torch.device import resolve_device

# --------------------------------------------------------------------------
# landmark detectors
# --------------------------------------------------------------------------


class LandmarksReader:
    """Reads precomputed landmarks from sidecar ``.txt`` files in
    ``lmk_dir``, named after each image: one ``x y`` pair per line."""

    def __init__(self, lmk_dir: str, suffix: str = ".txt"):
        self.lmk_dir = lmk_dir
        self.suffix = suffix

    def detect_path(self, image_path: str) -> np.ndarray:
        base = os.path.splitext(os.path.basename(image_path))[0]
        pts = []
        with open(os.path.join(self.lmk_dir, base + self.suffix)) as f:
            for line in f:
                parts = line.split()
                if len(parts) >= 2:
                    pts.append([float(parts[0]), float(parts[1])])
        return np.asarray(pts, np.float32)


class LandmarksManifestReader:
    """Reads one manifest, each non-empty line ``name.png x0 y0 x1 y1 ...``,
    and answers ``detect(img_name)`` with the landmarks of the first name
    (in sorted order) that ends ``img_name``, else None."""

    def __init__(self, file_name: str):
        names, data = [], []
        with open(file_name) as f:
            for line in f:
                toks = line.split()
                if not toks:
                    continue
                name = [t for t in toks
                        if len(t) > 4 and t[-4:].lower() in (".png", ".jpg", ".bmp")]
                nums = []
                for t in toks:
                    try:
                        nums.append(float(t))
                    except ValueError:
                        pass
                if name and nums:
                    names.append(name[0])
                    data.append(nums)
        order = np.argsort(names)
        self.names = [names[i] for i in order]
        self.data = np.asarray(data, np.float32)[order] if data else np.zeros((0, 0))

    def detect(self, img_name: str) -> np.ndarray | None:
        for i, name in enumerate(self.names):
            if img_name.endswith(name):
                return self.data[i].reshape(-1, 2)
        return None

    def detect_path(self, image_path: str) -> np.ndarray | None:
        """The landmarks of the image file ``image_path``, matched by its
        name (``align_dataset`` asks by path; the JAX package's passes the
        image array to ``detect``, which takes a name)."""
        return self.detect(image_path)


class LandmarksDetectorExec:
    """An external detector binary: runs ``exec <out.txt> <image-or-dir>``
    in the binary's directory, then reads the manifest it wrote. Takes an
    image array (written as a PNG), an image path or a list of paths."""

    def __init__(self, exec_path: str, workdir: str | None = None):
        self.exec_path = os.path.abspath(exec_path)
        self.workdir = workdir or os.path.join(os.path.dirname(self.exec_path), ".lmk_tmp")

    def detect(self, img):
        import subprocess
        import tempfile

        from stylerenderer_tpu_torch.utils.image import write_png

        os.makedirs(self.workdir, exist_ok=True)
        tmp_img = None
        if isinstance(img, str):
            names, argv = [os.path.basename(img)], os.path.abspath(img)
        elif hasattr(img, "__len__") and len(img) > 0 and isinstance(img[0], str):
            names = [os.path.basename(p) for p in img]
            argv = os.path.abspath(os.path.dirname(img[0]))
        else:
            fd, tmp_img = tempfile.mkstemp(suffix=".png", dir=self.workdir)
            os.close(fd)
            write_png(tmp_img, np.asarray(img)[:, :, ::-1])  # BGR -> RGB file
            names, argv = [os.path.basename(tmp_img)], tmp_img
        out_txt = os.path.join(self.workdir, "lmk.txt")
        try:
            subprocess.run([self.exec_path, out_txt, argv], cwd=os.path.dirname(self.exec_path),
                           check=True, capture_output=True)
            reader = LandmarksManifestReader(out_txt)
            lmks = [reader.detect(n) for n in names]
        finally:
            if tmp_img and os.path.exists(tmp_img):
                os.remove(tmp_img)
            if os.path.exists(out_txt):
                os.remove(out_txt)
        return lmks[0] if len(lmks) == 1 else np.asarray(lmks)


class LandmarksDetectorDlib:
    """dlib's 68-point detector; raises ``ImportError`` without dlib."""

    def __init__(self, predictor_path: str):
        import dlib

        self.detector = dlib.get_frontal_face_detector()
        self.predictor = dlib.shape_predictor(predictor_path)

    def detect(self, img: np.ndarray) -> np.ndarray | None:
        rects = self.detector(img, 1)
        if not rects:
            return None
        shape = self.predictor(img, rects[0])
        return np.asarray([[shape.part(i).x, shape.part(i).y] for i in range(shape.num_parts)],
                          np.float32)


def _resize_u8(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Bilinear resize of ``[1, C, H, W]`` byte values with half-pixel
    centres and no antialiasing (``cv2.resize``'s ``INTER_LINEAR``),
    rounded to bytes as cv2 returns them."""
    x = F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False, antialias=False)
    return torch.clamp(torch.round(x), 0, 255)


class LandmarksDetectorTorch:
    """A PFLD-style landmark net (``supervisors/landmark.py::PFLDInference``):
    ``net(img [1, 3, S, S] in [0, 1]) -> [1, 2L]`` coordinates in [0, 1] of
    the image, which is resized to ``S`` on the net's device."""

    def __init__(self, net, input_size: int = 112):
        self.net = net
        self.input_size = input_size

    def detect(self, img: np.ndarray) -> np.ndarray:
        h, w = img.shape[:2]
        dev = next(self.net.parameters()).device
        x = torch.as_tensor(np.ascontiguousarray(img), device=dev).permute(2, 0, 1)[None]
        x = _resize_u8(x.float(), self.input_size, self.input_size) / 255.0
        with torch.no_grad():
            out = self.net(x)
        if isinstance(out, (tuple, list)):
            out = out[-1]
        lmk = out.reshape(-1, 2).float().cpu().numpy()
        return lmk * np.asarray([w, h], np.float32)


# --------------------------------------------------------------------------
# pose solvers (host numpy and scipy)
# --------------------------------------------------------------------------


def _rodrigues_np(rvec: np.ndarray) -> np.ndarray:
    """Axis-angle -> rotation matrix (``cv2.Rodrigues``, forward)."""
    r = np.asarray(rvec, np.float64).reshape(3)
    th = np.linalg.norm(r)
    if th < 1e-12:
        return np.eye(3)
    k = r / th
    K = np.asarray([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)


def _rodrigues_inv_np(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> axis-angle (``cv2.Rodrigues``, inverse)."""
    from scipy.spatial.transform import Rotation

    return Rotation.from_matrix(np.asarray(R, np.float64)).as_rotvec()


def solve_ortho(pts3d: np.ndarray, pts2d: np.ndarray, max_iter: int = 0, eps: float = 1e-9):
    """Scaled-orthographic pose from 3D <-> 2D correspondences: ``s``, ``R``,
    ``t`` minimizing ``|| s (P3 @ R)[:, :2] + t - P2 ||``, in closed form
    (least squares, then the nearest rotation by SVD); ``max_iter > 0``
    refines it with ``scipy.optimize.leastsq`` over (axis-angle, scale,
    translation). Returns (scale, R ``[3, 3]``, t ``[2]``)."""
    p3 = np.asarray(pts3d, np.float64)
    p2 = np.asarray(pts2d, np.float64)
    c3, c2 = p3.mean(0), p2.mean(0)
    q3, q2 = p3 - c3, p2 - c2
    M, *_ = np.linalg.lstsq(q3, q2, rcond=None)  # q2 ~ q3 @ M, M [3, 2]
    u, s, vt = np.linalg.svd(M, full_matrices=False)
    scale = s.mean()
    r12 = u @ vt  # [3, 2], orthonormal columns
    r3 = np.cross(r12[:, 0], r12[:, 1])
    R = np.stack([r12[:, 0], r12[:, 1], r3], axis=1)
    if np.linalg.det(R) < 0:
        R[:, 2] *= -1
    t = c2 - scale * (c3 @ R)[:2]

    if max_iter > 0:
        from scipy.optimize import leastsq

        def fun(x):
            proj = x[3] * (p3 @ _rodrigues_np(x[:3]))[:, :2] + x[4:6]
            return (proj - p2).reshape(-1)

        x0 = np.concatenate([_rodrigues_inv_np(R), [scale], t])
        x, _ = leastsq(fun, x0, ftol=eps, maxfev=int(max_iter))
        scale, R, t = float(x[3]), _rodrigues_np(x[:3]), x[4:6]
    return float(scale), R, t


def solve_affine(src2d: np.ndarray, dst2d: np.ndarray) -> np.ndarray:
    """2D similarity (rotation, scale, translation) by Procrustes, mapping
    ``src2d`` onto ``dst2d``: the ``[2, 3]`` matrix ``warp_affine`` takes."""
    src = np.asarray(src2d, np.float64)
    dst = np.asarray(dst2d, np.float64)
    cs, cd = src.mean(0), dst.mean(0)
    qs, qd = src - cs, dst - cd
    a = (qs * qd).sum() / (qs * qs).sum()
    b = (qs[:, 0] * qd[:, 1] - qs[:, 1] * qd[:, 0]).sum() / (qs * qs).sum()
    M = np.asarray([[a, -b], [b, a]])
    t = cd - cs @ M.T
    return np.concatenate([M, t[:, None]], axis=1)


def euler_mat_inv(R: np.ndarray, order: str = "yxz") -> np.ndarray:
    """Rotation matrix -> Euler angles in ``order``, the inverse of
    ``transforms.euler_mat``."""
    from scipy.spatial.transform import Rotation

    return Rotation.from_matrix(np.asarray(R)).as_euler(order)


# --------------------------------------------------------------------------
# skin segmentation and recognition
# --------------------------------------------------------------------------


class SkinSegmentationGrabcut:
    """The landmarks' convex hull as a trimap, refined by ``cv2.grabCut``;
    raises ``ImportError`` without OpenCV."""

    def __init__(self, iters: int = 3, erode: int = 10, dilate: int = 20):
        self.iters = iters
        self.erode = erode
        self.dilate = dilate

    def segment(self, img: np.ndarray, lmk: np.ndarray) -> np.ndarray:
        import cv2

        h, w = img.shape[:2]
        hull = cv2.convexHull(np.asarray(lmk, np.int32))
        fill = np.zeros((h, w), np.uint8)
        cv2.fillConvexPoly(fill, hull, 1)
        sure_fg = cv2.erode(fill, np.ones((self.erode, self.erode), np.uint8))
        maybe = cv2.dilate(fill, np.ones((self.dilate, self.dilate), np.uint8))
        mask = np.full((h, w), cv2.GC_BGD, np.uint8)
        mask[maybe > 0] = cv2.GC_PR_FGD
        mask[sure_fg > 0] = cv2.GC_FGD
        bgd = np.zeros((1, 65), np.float64)
        fgd = np.zeros((1, 65), np.float64)
        cv2.grabCut(img, mask, None, bgd, fgd, self.iters, cv2.GC_INIT_WITH_MASK)
        return ((mask == cv2.GC_FGD) | (mask == cv2.GC_PR_FGD)).astype(np.uint8)


class SkinSegmentationTorch:
    """Neural skin segmentation behind a torch module, on the module's
    device: ImageNet-normalized RGB, cropped to multiples of 32, the first
    output channel's sigmoid thresholded and zero-padded back to the
    input's size. ``model`` returns a tensor or a dict with ``'out'``; the
    default is torchvision's FCN-ResNet101 with one class (imported only
    then; its weights must be supplied)."""

    def __init__(self, model=None, threshold: float = 0.5):
        if model is None:
            from torchvision.models.segmentation import fcn_resnet101

            model = fcn_resnet101(weights=None, num_classes=1)
        self.model = model.eval()
        self.mean = np.asarray([0.485, 0.456, 0.406], np.float32)
        self.std = np.asarray([0.229, 0.224, 0.225], np.float32)
        self.th = min(max(threshold, 0.0), 1.0)

    def segment(self, img: np.ndarray, *args) -> np.ndarray:
        h, w = img.shape[:2]
        x = img.astype(np.float32)
        if x.max() > 2.0:
            x = x / 255.0
        x = x[: (h // 32) * 32, : (w // 32) * 32]
        if x.ndim == 2 or x.shape[-1] == 1:
            x = np.tile(x.reshape(x.shape[0], x.shape[1], 1), [1, 1, 3])
        else:
            x = x[:, :, ::-1]  # BGR -> RGB
        x = (x - self.mean) / self.std
        dev = next(self.model.parameters()).device
        x = torch.from_numpy(np.transpose(x, (2, 0, 1)).copy())[None].to(dev)
        with torch.no_grad():
            out = self.model(x)
            if isinstance(out, dict):
                out = out["out"]
            mask = torch.sigmoid(out)[0, 0].cpu().numpy()
        if h > mask.shape[0] or w > mask.shape[1]:
            mask = np.pad(mask, ((0, h - mask.shape[0]), (0, w - mask.shape[1])), "constant")
        return mask > self.th


class RecognitionFeature:
    """Face embedding by ``supervisors/recognition.py::InceptionResnetV1``
    on ``device``. ``params``: a facenet state dict or path (the JAX
    package's parameters through ``utils/weights.py::
    facenet_state_dict_from_jax``); without them a random stand-in drawn
    from ``seed``. ``detect_crop(img) -> [160, 160, 3]`` crops the face;
    the default is the centre square, resized to 160 (``cv2.resize``'s
    bilinear)."""

    def __init__(self, params=None, detect_crop=None, seed: int = 0, device="cuda"):
        from stylerenderer_tpu_torch.supervisors.convert import load_facenet, random_stand_in_
        from stylerenderer_tpu_torch.supervisors.recognition import InceptionResnetV1

        self.device = resolve_device(device)
        self.net = InceptionResnetV1()
        if params is None:
            random_stand_in_(self.net, torch.Generator().manual_seed(seed))
        else:
            load_facenet(self.net, params)
        self.net = self.net.eval().to(self.device)
        self.detect_crop = detect_crop

    def detect(self, img: np.ndarray) -> np.ndarray | None:
        if self.detect_crop is not None:
            crop = self.detect_crop(img)
            if crop is None:
                return None
            x = torch.as_tensor(np.asarray(crop, np.float32), device=self.device)
        else:
            h, w = img.shape[:2]
            s = min(h, w)
            y0, x0 = (h - s) // 2, (w - s) // 2
            sq = torch.as_tensor(np.ascontiguousarray(img[y0:y0 + s, x0:x0 + s]),
                                 device=self.device).permute(2, 0, 1)[None].float()
            x = _resize_u8(sq, 160, 160)[0].permute(1, 2, 0)
        if float(x.max()) > 2.0:
            x = x / 127.5 - 1.0  # bytes -> [-1, 1]
        with torch.no_grad():
            emb = self.net(x.permute(2, 0, 1)[None])
        return emb[0].cpu().numpy()


# --------------------------------------------------------------------------
# the alignment pipeline
# --------------------------------------------------------------------------


def render_mean_face(face_model, tex, tri, height: int, width: int) -> np.ndarray:
    """Rasterize the mean 3DMM face with its per-vertex texture ``tex``
    ``[nv, C]`` at ``height x width``, on the face model's device. Returns
    a uint8 BGR image (the cv2 convention); a texture in [0, 1] is scaled
    to bytes. At production size (``nf*height*width > 2^24``, both sides
    multiples of 8) the rasterizer takes the single-level kernel on a CUDA
    model."""
    from stylerenderer_tpu_torch.ops.rasterize import rasterize

    dev = face_model.device
    v = face_model(torch.zeros(1, face_model.sigma.shape[0], device=dev))
    t = torch.as_tensor(tex, dtype=torch.float32, device=dev)[None]
    img = rasterize(v, t, torch.as_tensor(tri, device=dev), height, width)[0].cpu().numpy()
    if img.max() <= 2.0:  # texture in [0, 1] -> bytes
        img = img * 255.0
    return np.clip(img[:, :, ::-1], 0, 255).astype(np.uint8)  # RGB -> BGR


def build_canonical_reference_render(face_model, tex, tri, detector,
                                     size: int = 256) -> np.ndarray:
    """The canonical landmarks ``[L, 2]`` in pixels: ``detector`` run on the
    mean face rendered with its texture at ``size x size``."""
    render = render_mean_face(face_model, tex, tri, size, size)
    lmk = detector.detect(render)
    if lmk is None or len(lmk) == 0:
        raise RuntimeError("detector found no face on the mean-face render")
    return np.asarray(lmk, np.float32)


def build_canonical_reference(face_model, tri, lmk_vidx, size: int = 256) -> np.ndarray:
    """The canonical landmarks ``[L, 2]`` in pixels: the mean face's
    landmark vertices ``lmk_vidx`` through the renderer's NDC -> pixel
    mapping at ``size x size``."""
    with torch.no_grad():
        v = face_model(torch.zeros(1, face_model.sigma.shape[0], device=face_model.device))
    lv = v[0].cpu().numpy()[np.asarray(lmk_vidx)]
    px = (1 + lv[:, 0]) * size / 2 - 0.5
    py = (1 - lv[:, 1]) * size / 2 - 0.5
    return np.stack([px, py], -1).astype(np.float32)


def _fold_reflect(c: torch.Tensor, n: int) -> torch.Tensor:
    """Fold coordinates into ``[-0.5, n - 0.5]`` by mirroring about the
    outer pixel edges: with edge clamping, bilinear taps then read
    ``fedcba|abcdefgh|hgfedcb`` (cv2's ``BORDER_REFLECT``;
    ``grid_sample``'s reflection mirrors about the edge pixels' centres,
    cv2's ``BORDER_REFLECT_101``)."""
    c = torch.remainder(c + 0.5, 2 * n)
    return torch.where(c >= n, 2 * n - c, c) - 0.5


def warp_affine(img: torch.Tensor, M, size, border: str = "constant") -> torch.Tensor:
    """Warp ``img`` ``[B, C, H, W]`` (float) by the affine maps ``M``
    ``[B, 2, 3]``, which take source pixels to destination pixels, into
    ``size`` (an int or ``(height, width)``), with bilinear interpolation:
    ``cv2.warpAffine(..., flags=INTER_LINEAR)``. Pixel centres are at
    integer coordinates; ``M`` is inverted in f64 on the host. ``border``:
    ``"constant"`` (zeros, ``BORDER_CONSTANT``) or ``"reflect"``
    (``BORDER_REFLECT``). Returns float ``[B, C, h, w]``, unrounded."""
    if border not in ("constant", "reflect"):
        raise ValueError(f"border {border!r}: 'constant' or 'reflect'")
    B, _, H, W = img.shape
    if H < 2 or W < 2:
        raise ValueError(f"source {H} x {W}: both sides must be at least 2")
    h, w = (size, size) if isinstance(size, int) else size
    M = np.asarray(M, np.float64).reshape(B, 2, 3)
    full = np.concatenate([M, np.broadcast_to([[[0.0, 0.0, 1.0]]], (B, 1, 3))], 1)
    inv = torch.as_tensor(np.linalg.inv(full)[:, :2], device=img.device)  # dst -> src
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float64, device=img.device),
                            torch.arange(w, dtype=torch.float64, device=img.device),
                            indexing="ij")
    dst = torch.stack([xs, ys, torch.ones_like(xs)], -1)  # [h, w, 3]
    src = torch.einsum("hwk,bjk->bhwj", dst, inv)  # [B, h, w, 2] as (x, y)
    sx, sy = src[..., 0], src[..., 1]
    if border == "reflect":
        sx, sy = _fold_reflect(sx, W), _fold_reflect(sy, H)
    grid = torch.stack([2 * sx / (W - 1) - 1, 2 * sy / (H - 1) - 1], -1).to(img.dtype)
    return F.grid_sample(img, grid, mode="bilinear", align_corners=True,
                         padding_mode="zeros" if border == "constant" else "border")


def _warp_u8(img: np.ndarray, M: np.ndarray, size: int, border: str, device) -> np.ndarray:
    """``warp_affine`` of one uint8 ``[H, W, C]`` image on ``device``,
    rounded to bytes."""
    x = torch.as_tensor(np.ascontiguousarray(img), device=resolve_device(device))
    out = warp_affine(x.permute(2, 0, 1)[None].float(), M[None], size, border)
    return torch.clamp(torch.round(out), 0, 255)[0].permute(1, 2, 0).to(torch.uint8).cpu().numpy()


def align_face(img: np.ndarray, lmk: np.ndarray, ref_lmk: np.ndarray, size: int = 256,
               device="cuda") -> np.ndarray:
    """Similarity-warp ``img`` (uint8 ``[H, W, C]``) on ``device`` so that
    its landmarks ``lmk`` land on the canonical ``ref_lmk``; ``size x
    size``, zeros outside."""
    return _warp_u8(img, solve_affine(lmk, ref_lmk), size, "constant", device)


def align_face_ortho(img: np.ndarray, lmk: np.ndarray, base_lmk3d: np.ndarray,
                     size: int = 256, max_iter: int = 0, device="cuda") -> np.ndarray:
    """The 3D-landmark alignment: solve the scaled-orthographic pose from
    the canonical 3D landmarks to the detected ``lmk``, keep its in-plane
    rotation (roll), scale and translation as a 2D similarity and warp the
    photo back to the canonical frame by its inverse, mirrored at the
    border (``BORDER_REFLECT``)."""
    scale, R, t = solve_ortho(np.asarray(base_lmk3d), np.asarray(lmk), max_iter=max_iter)
    rot = euler_mat_inv(R, "yxz")  # (yaw, pitch, roll)
    # R acts on row vectors; the warp's matrix on column vectors
    c, s = scale * np.cos(rot[2]), scale * np.sin(rot[2])
    T = np.asarray([[c, s, t[0]], [-s, c, t[1]], [0.0, 0.0, 1.0]])
    return _warp_u8(img, np.linalg.inv(T)[:2, :], size, "reflect", device)


def read_bgr(path: str) -> np.ndarray | None:
    """An image file as the uint8 BGR ``[H, W, 3]`` array ``cv2.imread``
    gives (EXIF orientation applied, alpha dropped), via PIL; None when it
    does not decode."""
    from PIL import Image, ImageOps

    try:
        with Image.open(path) as im:
            rgb = np.asarray(ImageOps.exif_transpose(im).convert("RGB"))
    except OSError:
        return None
    return np.ascontiguousarray(rgb[:, :, ::-1])


def write_bgr(path: str, img: np.ndarray) -> None:
    """Write a uint8 BGR image by the file's extension, via PIL; a JPEG at
    quality 95 (``cv2.imwrite``'s default)."""
    from PIL import Image

    im = Image.fromarray(np.ascontiguousarray(img[:, :, ::-1]))
    if os.path.splitext(path)[1].lower() in (".jpg", ".jpeg"):
        im.save(path, quality=95)
    else:
        im.save(path)


def align_dataset(in_dir: str, out_dir: str, detector, face_model, tri, lmk_vidx=None,
                  size: int = 256, tex=None) -> int:
    """Align every photo under ``in_dir`` into ``out_dir`` (same file
    names): landmarks from ``detector`` (by path where it reads files),
    the similarity to the canonical reference, the warp on the face
    model's device. The reference is detected on the textured mean face's
    render when ``tex`` is given, else projected from ``lmk_vidx``.
    Photos that do not decode, or where no landmarks are found, are
    skipped. Returns the number written."""
    from stylerenderer_tpu_torch.data.dataset import list_images

    os.makedirs(out_dir, exist_ok=True)
    if tex is not None:
        ref = build_canonical_reference_render(face_model, tex, tri, detector, size)
    elif lmk_vidx is not None:
        ref = build_canonical_reference(face_model, tri, lmk_vidx, size)
    else:
        raise ValueError("need tex (render-and-detect) or lmk_vidx")
    n = 0
    for path in list_images(in_dir):
        img = read_bgr(path)
        if img is None:
            continue
        lmk = (detector.detect_path(path) if hasattr(detector, "detect_path")
               else detector.detect(img))
        if lmk is None:
            continue
        out = align_face(img, lmk, ref, size, device=face_model.device)
        write_bgr(os.path.join(out_dir, os.path.basename(path)), out)
        n += 1
    return n

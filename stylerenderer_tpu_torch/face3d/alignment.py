"""Face alignment (counterpart of ``stylerenderer_tpu/face3d/alignment.py``;
so far only the render of the mean face that the canonical reference is
detected on)."""

from __future__ import annotations

import numpy as np
import torch


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

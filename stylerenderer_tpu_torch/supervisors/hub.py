"""The training heads: frozen supervisor nets behind the image layout of
the GAR (counterpart of ``stylerenderer_tpu/supervisors/hub.py``).

Each head takes the generator's images ``[B, 3, H, W]`` in [-1, 1] and
runs its net at the net's own size, resized with the JAX package's linear
resize (``ops/resize.py::resize_linear``, antialiased when shrinking):

- ``sfs``: ``ResNetUNet`` at the next multiple of 32 (at least 32), its
  unit normals resized back and returned as ``[B, H, W, 3]``, the layout
  of the generator's normal maps;
- ``lmk``: ``PFLDInference`` at 112 px on ``(x + 1) / 2`` -> ``[B, 136]``;
- ``feat``: ``InceptionResnetV1`` at 160 px -> ``[B, 512]``.

The nets are frozen (``eval()``, no parameter gradients); the gradient
flows through them to the image.
"""

from __future__ import annotations

import torch

from stylerenderer_tpu_torch.device import resolve_device
from stylerenderer_tpu_torch.ops.resize import resize_linear
from stylerenderer_tpu_torch.supervisors.convert import (
    load_face_normals,
    load_facenet,
    load_pfld,
    random_stand_in_,
)
from stylerenderer_tpu_torch.supervisors.face_normals import ResNetUNet
from stylerenderer_tpu_torch.supervisors.landmark import PFLDInference
from stylerenderer_tpu_torch.supervisors.recognition import InceptionResnetV1

LMK_SIZE, FEAT_SIZE = 112, 160


def _resize(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """``[B, C, H, W]`` -> ``[B, h, w, C]`` (``resize_linear``'s layout)."""
    return resize_linear(x.permute(0, 2, 3, 1), h, w)


def _frozen(net, params, load, generator, device):
    """``net`` with ``params`` (a path or a state dict) or, without them, a
    random stand-in drawn from ``generator``; frozen, on ``device``."""
    if params is None:
        random_stand_in_(net, generator)
    else:
        load(net, params)
    return net.eval().requires_grad_(False).to(device)


def make_extra_heads(seed: int = 0, *, sfs: bool = False, lmk: bool = False,
                     feat: bool = False, image_size: int = 256, sfs_params=None,
                     lmk_params=None, feat_params=None, device="cuda") -> dict:
    """``{'sfs': fn, 'lmk': fn, 'feat': fn}`` for the heads asked for, on
    ``device`` (``"cuda"`` unless asked otherwise). ``*_params`` are a
    published ``.pth``/``.pth.tar`` path or state dict; without them each
    net is a random stand-in drawn from its own seed, which ``seed`` fixes
    whichever heads are asked for."""
    device = resolve_device(device)
    seeds = torch.randint(2 ** 62, (3,), generator=torch.Generator().manual_seed(seed))
    gens = [torch.Generator().manual_seed(int(s)) for s in seeds]
    heads = {}
    if sfs:
        net = _frozen(ResNetUNet(), sfs_params, load_face_normals, gens[0], device)
        run = max(32, -(-image_size // 32) * 32)

        def sfs_fn(img, net=net, run=run):
            h, w = img.shape[2], img.shape[3]
            x = img if (h, w) == (run, run) else _resize(img, run, run).permute(0, 3, 1, 2)
            n = net(x)[0].permute(0, 2, 3, 1)
            return n if (h, w) == (run, run) else resize_linear(n, h, w)

        heads["sfs"] = sfs_fn
    if lmk:
        net = _frozen(PFLDInference(), lmk_params, load_pfld, gens[1], device)

        def lmk_fn(img, net=net):
            return net((_resize(img, LMK_SIZE, LMK_SIZE).permute(0, 3, 1, 2) + 1) / 2)

        heads["lmk"] = lmk_fn
    if feat:
        net = _frozen(InceptionResnetV1(), feat_params, load_facenet, gens[2], device)

        def feat_fn(img, net=net):
            return net(_resize(img, FEAT_SIZE, FEAT_SIZE).permute(0, 3, 1, 2))

        heads["feat"] = feat_fn
    return heads

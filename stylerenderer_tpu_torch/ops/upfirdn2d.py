"""upfirdn2d: upsample, FIR filter, downsample (counterpart of
``stylerenderer_tpu/ops/upfirdn2d.py``).

1. zero-stuff the input by ``up`` (sample at phase 0 of each ``up`` block),
2. pad by ``(pad0, pad1)`` per spatial dim; negative pads crop,
3. convolve (true convolution: cross-correlate with the flipped kernel),
4. decimate by ``down``.

Output size per dim: ``(in*up + pad0 + pad1 - kernel) // down + 1``.
Layout: NCHW. The JAX package does this in one XLA convolution. Here the
device decides: on a card (float32, bfloat16 or float64) it is one
hand-written CUDA kernel, ``csrc/upfirdn2d.cu`` (``upfirdn2d_cuda``,
counted in ``upfirdn2d.launches``): one read of the input and one write of
the output, ``up=2`` polyphase with no stuffed copy, ``down=2`` computing
only the kept outputs, sums in float (double for float64) rounded once. On
the CPU it is the plain version, ``upfirdn2d_plain``: a reshape for the
zero-stuffing, ``F.pad`` (which crops on negative pads) and one depthwise
``F.conv2d`` whose stride decimates.

The op is linear in ``x``, and its gradient is again an ``upfirdn2d``
(``up`` and ``down`` swapped, the kernel flipped, the pads from the
shapes), written as an ``autograd.Function`` whose backward calls itself.
So gradients of any order are forward ``upfirdn2d`` calls, the kernel on a
card: ATen's double backward of a grouped convolution runs one
convolution per channel (4.2 s for 16 x 128 x 256 x 256 on an H100), which
the path-length and R1 penalties would hit in every Blur and Upsample.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def make_kernel(k, device=None) -> torch.Tensor:
    """Normalized 2-D FIR kernel from a 1-D (outer product) or 2-D tap list."""
    k = torch.as_tensor(k, dtype=torch.float32, device=device)
    if k.ndim == 1:
        k = k[None, :] * k[:, None]
    return k / torch.sum(k)


def _as_pair(v) -> tuple[int, int]:
    if isinstance(v, (tuple, list)):
        if len(v) == 1:
            return int(v[0]), int(v[0])
        return int(v[0]), int(v[1])
    return int(v), int(v)


def _pads(pad):
    """-> (pad_x0, pad_x1, pad_y0, pad_y1) from a 2- or 4-tuple."""
    if len(pad) == 2:
        return int(pad[0]), int(pad[1]), int(pad[0]), int(pad[1])
    return tuple(int(p) for p in pad)


def upfirdn2d(x: torch.Tensor, kernel: torch.Tensor, up=1, down=1,
              pad=(0, 0)) -> torch.Tensor:
    """Upsample-FIR-downsample ``x`` ``[B, C, H, W]`` with ``kernel`` ``[kh, kw]``
    (a constant: no gradient flows to it).

    ``up``/``down`` are ints or ``(x, y)`` pairs; ``pad`` is ``(pad0, pad1)``
    for both dims or ``(pad_x0, pad_x1, pad_y0, pad_y1)``.
    """
    up, down, pad = _as_pair(up), _as_pair(down), _pads(pad)
    b, c, h, w = x.shape
    kh, kw = kernel.shape
    out_h, out_w = _out_size(h, w, kh, kw, up, down, pad)
    if out_h <= 0 or out_w <= 0:
        raise ValueError(
            f"upfirdn2d produces empty output: in={h}x{w} up={up[1]}x{up[0]} "
            f"pad=({pad[2]},{pad[3]},{pad[0]},{pad[1]}) k={kh}x{kw} "
            f"down={down[1]}x{down[0]}")
    return _UpFirDn2d.apply(x, kernel.detach(), up, down, pad)


def _out_size(h, w, kh, kw, up, down, pad):
    return ((h * up[1] + pad[2] + pad[3] - kh) // down[1] + 1,
            (w * up[0] + pad[0] + pad[1] - kw) // down[0] + 1)


class _UpFirDn2d(torch.autograd.Function):
    """``upfirdn2d`` whose backward is the adjoint ``upfirdn2d``: zero-stuff
    the output gradient by ``down``, pad by ``k - 1 - pad0`` before and what
    restores the input length after, convolve with the flipped kernel,
    decimate by ``up``. The backward calls this Function again, so every
    order of differentiation stays a forward ``upfirdn2d``: the kernel on a
    card tensor, the plain version on a CPU one."""

    @staticmethod
    def forward(ctx, x, kernel, up, down, pad):
        ctx.save_for_backward(kernel)
        ctx.args = (x.shape[2], x.shape[3], up, down, pad)
        if x.is_cuda:
            return upfirdn2d_cuda(x, kernel, up, down, pad)
        return upfirdn2d_plain(x, kernel, up, down, pad)

    @staticmethod
    def backward(ctx, gy):
        (kernel,) = ctx.saved_tensors
        h, w, up, down, pad = ctx.args
        kh, kw = kernel.shape
        out_h, out_w = gy.shape[2], gy.shape[3]
        gpad = (kw - pad[0] - 1, w * up[0] - out_w * down[0] + pad[0] - up[0] + 1,
                kh - pad[2] - 1, h * up[1] - out_h * down[1] + pad[2] - up[1] + 1)
        gx = _UpFirDn2d.apply(gy, torch.flip(kernel, (0, 1)), down, up, gpad)
        return gx, None, None, None, None


upfirdn2d.launches = 0
KERNEL_DTYPES = (torch.float32, torch.bfloat16, torch.float64)
_DTYPE_CODES = {dtype: i for i, dtype in enumerate(KERNEL_DTYPES)}


def upfirdn2d_plain(x, kernel, up=1, down=1, pad=(0, 0)):
    """The plain version: the zero-stuffed, padded input through one
    depthwise ``F.conv2d`` (what a CPU tensor takes)."""
    up, down, pad = _as_pair(up), _as_pair(down), _pads(pad)
    (up_x, up_y), (down_x, down_y) = up, down
    pad_x0, pad_x1, pad_y0, pad_y1 = pad
    b, c, h, w = x.shape
    kh, kw = kernel.shape
    out_h, out_w = _out_size(h, w, kh, kw, up, down, pad)
    if up_x > 1 or up_y > 1:
        x = x.reshape(b, c, h, 1, w, 1)
        x = F.pad(x, [0, up_x - 1, 0, 0, 0, up_y - 1])
        x = x.reshape(b, c, h * up_y, w * up_x)
    x = F.pad(x, [pad_x0, pad_x1, pad_y0, pad_y1])
    weight = torch.flip(kernel, (0, 1)).to(x.dtype)[None, None]
    out = F.conv2d(x, weight.expand(c, 1, kh, kw), stride=(down_y, down_x),
                   groups=c)
    assert out.shape == (b, c, out_h, out_w), (out.shape, (b, c, out_h, out_w))
    return out


def _kernel_args(x, kernel, up, down, pad):
    """Check the inputs for the kernel or its host build -> (out, taps, the
    C function's arguments). ``x`` ``[B, C, H, W]`` float32, bfloat16 or
    float64, any strides; the taps ``kernel`` in float32 (float64 for a
    float64 ``x``) on ``x``'s device; ``out`` contiguous. Raises on what the
    kernel does not take."""
    if x.dtype not in KERNEL_DTYPES:
        raise ValueError(f"the kernel takes float32, bfloat16 or float64, got {x.dtype}")
    if x.ndim != 4 or kernel.ndim != 2 or max(kernel.shape) > 8:
        raise ValueError(f"the kernel takes an NCHW x and a kernel of at most 8 x 8 taps, got "
                         f"{tuple(x.shape)} and {tuple(kernel.shape)}")
    (up_x, up_y), (down_x, down_y) = _as_pair(up), _as_pair(down)
    pad = _pads(pad)
    b, c, h, w = x.shape
    kh, kw = kernel.shape
    out_h, out_w = _out_size(h, w, kh, kw, (up_x, up_y), (down_x, down_y), pad)
    taps = kernel.to(x.device, torch.float64 if x.dtype == torch.float64 else torch.float32
                     ).contiguous()
    out = torch.empty(b, c, out_h, out_w, dtype=x.dtype, device=x.device)
    return out, taps, (x.data_ptr(), out.data_ptr(), taps.data_ptr(), b, c, h, w, *x.stride(),
                       out_h, out_w, up_x, up_y, down_x, down_y, pad[0], pad[2], kh, kw,
                       _DTYPE_CODES[x.dtype])


def upfirdn2d_cuda(x, kernel, up=1, down=1, pad=(0, 0)):
    """``upfirdn2d``'s kernel on the current stream, counted in
    ``upfirdn2d.launches``. Raises on a dtype or a tensor it does not take,
    and when the launch is refused."""
    from stylerenderer_tpu_torch.ops._build import library

    out, taps, args = _kernel_args(x, kernel, up, down, pad)
    if x.device.type != "cuda":
        raise ValueError(f"the kernel takes CUDA tensors, got {x.device}")
    if out.numel() == 0:
        return out
    lib = library("upfirdn2d")
    rc = lib.sr_upfirdn2d(*args, torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("upfirdn2d launch failed: " + lib.sr_error_string(rc).decode())
    upfirdn2d.launches += 1
    return out


def upfirdn2d_host(x, kernel, up=1, down=1, pad=(0, 0)):
    """The kernel's math, tiling and schedule compiled for the host (g++),
    on CPU tensors: ``upfirdn2d``'s result as the card computes it."""
    from stylerenderer_tpu_torch.ops._build import library

    out, taps, args = _kernel_args(x, kernel, up, down, pad)
    if x.device.type != "cpu":
        raise ValueError(f"the host build takes CPU tensors, got {x.device}")
    if out.numel() and library("upfirdn2d_host").sr_upfirdn2d_host(*args) != 0:
        raise ValueError("upfirdn2d_host: arguments the kernel does not take")
    return out


def upfirdn2d_ref(x, kernel, up=1, down=1, pad=(0, 0)) -> np.ndarray:
    """Slow numpy float64 oracle of the same semantics (NCHW), written from
    the definition and independent of ``upfirdn2d``."""
    up_x, up_y = _as_pair(up)
    down_x, down_y = _as_pair(down)
    pad_x0, pad_x1, pad_y0, pad_y1 = _pads(pad)
    x = np.asarray(x, np.float64)
    kernel = np.asarray(kernel, np.float64)
    b, c, h, w = x.shape
    kh, kw = kernel.shape
    stuffed = np.zeros((b, c, h * up_y, w * up_x), np.float64)
    stuffed[:, :, ::up_y, ::up_x] = x
    padded = np.pad(stuffed, ((0, 0), (0, 0),
                              (max(pad_y0, 0), max(pad_y1, 0)),
                              (max(pad_x0, 0), max(pad_x1, 0))))
    padded = padded[:, :,
                    max(-pad_y0, 0):padded.shape[2] - max(-pad_y1, 0),
                    max(-pad_x0, 0):padded.shape[3] - max(-pad_x1, 0)]
    out_h = (h * up_y + pad_y0 + pad_y1 - kh) // down_y + 1
    out_w = (w * up_x + pad_x0 + pad_x1 - kw) // down_x + 1
    out = np.zeros((b, c, out_h, out_w), np.float64)
    kf = kernel[::-1, ::-1]
    for oy in range(out_h):
        for ox in range(out_w):
            iy, ix = oy * down_y, ox * down_x
            patch = padded[:, :, iy:iy + kh, ix:ix + kw]
            out[:, :, oy, ox] = np.einsum("bchw,hw->bc", patch, kf)
    return out


def upfirdn2d_band(x, kernel, mesh, up=1, down=1, pad=(0, 0)) -> torch.Tensor:
    """``upfirdn2d`` of a map whose rows are split over ``mesh``'s
    ``'space'`` axis: ``x`` is this rank's band, the result its band of the
    whole map's output rows (``parallel/spatial.py::band_ops``: a halo of
    the rows the band's outputs read, the y pads replaced by the plan's).
    Raises unless the whole map's output rows split into equal bands."""
    from stylerenderer_tpu_torch.parallel.spatial import band_ops

    (_, up_y), (_, down_y), (px0, px1, py0, py1) = _as_pair(up), _as_pair(down), _pads(pad)
    kh = kernel.shape[0]
    h_out = (x.shape[2] * mesh.n_space * up_y + py0 + py1 - kh) // down_y + 1
    x, ((q0, q1),) = band_ops(x, [(up_y, down_y, kh, py0)], h_out, mesh)
    return upfirdn2d(x, kernel, up, down, (px0, px1, q0, q1))


def upsample2d(x, kernel, factor: int = 2):
    """FIR upsample by ``factor`` (StyleGAN2 ``Upsample`` pad arithmetic)."""
    kernel = kernel * (factor ** 2)
    p = kernel.shape[0] - factor
    return upfirdn2d(x, kernel, up=factor, down=1,
                     pad=((p + 1) // 2 + factor - 1, p // 2))


def downsample2d(x, kernel, factor: int = 2):
    """FIR downsample by ``factor`` (StyleGAN2 ``Downsample`` pad arithmetic)."""
    p = kernel.shape[0] - factor
    return upfirdn2d(x, kernel, up=1, down=factor, pad=((p + 1) // 2, p // 2))


def blur(x, kernel, pad, upsample_factor: int = 1):
    """FIR blur with an explicit pad (StyleGAN2 ``Blur``)."""
    if upsample_factor > 1:
        kernel = kernel * (upsample_factor ** 2)
    return upfirdn2d(x, kernel, pad=pad)

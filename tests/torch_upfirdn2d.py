"""The ``upfirdn2d`` calls of the benchmark's four cells, shared by the CPU
tests, the card tests and ``chip_smoke.py`` (torch and the port only, no
JAX).

A call is ``(x shape [B, C, H, W], up, down, pad)`` with ``pad`` the
4-tuple ``(pad_x0, pad_x1, pad_y0, pad_y1)``; the kernel is always
``make_kernel([1, 3, 3, 1])`` (times 4 where it upsamples)."""

from stylerenderer_tpu_torch.models.generator import channel_table
from stylerenderer_tpu_torch.ops.upfirdn2d import _out_size

KERNEL = (1, 3, 3, 1)


def synthesis_calls(size: int, batch: int) -> list:
    """A no-grad synthesis forward's calls, in order: at each level ``s``
    from 8 px, the upsampling styled conv's blur on the transposed conv's
    ``s + 1`` map, then ToRGB's ``Upsample`` of the 3-channel skip."""
    ch = channel_table(2)
    calls = []
    s = 8
    while s <= size:
        calls.append(((batch, ch[s], s + 1, s + 1), 1, 1, (1, 1, 1, 1)))
        calls.append(((batch, 3, s // 2, s // 2), 2, 1, (2, 1, 2, 1)))
        s *= 2
    return calls


def discriminator_calls(size: int, batch: int) -> list:
    """Config F's residual D at ``size`` (``Discriminator(size, 2)``): each
    ResBlock's downsampling conv blurs with pads (2, 2), its 1x1 skip with
    (1, 1)."""
    ch = channel_table(2)
    calls = []
    s = size
    while s > 4:
        calls.append(((batch, ch[s], s, s), 1, 1, (2, 2, 2, 2)))
        calls.append(((batch, ch[s], s, s), 1, 1, (1, 1, 1, 1)))
        s //= 2
    return calls


def out_shape(call) -> tuple:
    (b, c, h, w), up, down, pad = call
    return (b, c) + _out_size(h, w, 4, 4, (up, up), (down, down), pad)


def adjoint(call):
    """The call ``_UpFirDn2d.backward`` makes for ``call``'s gradient."""
    (b, c, h, w), up, down, pad = call
    _, _, out_h, out_w = out_shape(call)
    gpad = (4 - pad[0] - 1, w * up - out_w * down + pad[0] - up + 1,
            4 - pad[2] - 1, h * up - out_h * down + pad[2] - up + 1)
    return (b, c, out_h, out_w), down, up, gpad


def with_adjoints(calls) -> list:
    return calls + [adjoint(c) for c in calls]


# per cell: its calls (forward, and the adjoints its backwards take; a
# second order takes the forward forms again) and its compute type
CELLS = {
    "gar1024.render.b16": (synthesis_calls(1024, 16), "bfloat16"),
    "gar256.render.b64": (synthesis_calls(256, 64), "float32"),
    "gar256.invert.b32": (with_adjoints(synthesis_calls(256, 32)), "float32"),
    "gar256gan.train.b16": (with_adjoints(synthesis_calls(256, 16) + synthesis_calls(256, 8)
                                          + discriminator_calls(256, 16)), "float32"),
}


# calls with negative pads and odd sizes beside the cells' (an adjoint of a
# cropping forward, a mixed-sign pad, a downsample of an odd map)
EXTRA_CALLS = [((4, 64, 33, 33), 1, 1, (-1, -1, -1, -1)), ((4, 64, 31, 33), 2, 1, (2, -1, 1, 0)),
               ((4, 64, 33, 31), 1, 2, (1, -1, 0, 1)), ((4, 3, 65, 63), 2, 1, (1, 2, 1, 2))]


def call_bytes(call, elem_bytes: int) -> int:
    """The bytes one call must move: its input read once, its output
    written once."""
    (b, c, h, w), *_ = call
    _, _, oh, ow = out_shape(call)
    return (b * c * h * w + b * c * oh * ow) * elem_bytes


SHAPE_NAMES = ("kind", "rx", "ry", "tx", "ty", "tp", "sx", "sy", "tiles_x", "tiles_y", "groups",
               "items", "in_w", "in_h", "pitch", "raw_pitch", "lanes", "bulk", "vec", "smem")


def launch_shape(fn, call, dtype_code=1, unit_w=1, kh=4, kw=4) -> dict:
    """``call``'s launch shape from ``fn``, the card's ``sr_upfirdn2d_shape``
    or the host build's ``sr_upfirdn2d_shape_host`` -> {name: value} of
    ``SHAPE_NAMES``."""
    import ctypes

    (b, c, h, w), up, down, pad = call
    oh, ow = _out_size(h, w, kh, kw, (up, up), (down, down), pad)
    out = (ctypes.c_int * 23)()
    assert fn(b, c, h, w, oh, ow, up, up, down, down, pad[0], pad[2], kh, kw, dtype_code, unit_w,
              ctypes.cast(out, ctypes.c_void_p)) == 0
    return dict(zip(SHAPE_NAMES, out))

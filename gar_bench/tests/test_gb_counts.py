"""The yardstick's counts: the forward's operations against a counter of
every matrix product and convolution, and against a hand count; the
pyramid's bbox pairs against a brute-force count on a tiny mesh."""

import torch
from torch.utils.flop_counter import FlopCounterMode

from gar_bench import flops, inputs, pyramid_work
from gar_bench.reference import gar
from gar_bench.tests.tiny import shrink
from gar_bench import spec


def _tiny():
    return shrink(spec.config("gar256"))


def _reference_forward(cfg, P, B=1):
    z = torch.randn(B, cfg["style_dim"])
    maps = [torch.rand(B, s, s, 3) for s in gar.levels(cfg["size"])]
    noise = [torch.randn(B, 1, r, r) for r in gar.noise_shapes(cfg["size"])]
    w = gar.mapping(P, z, cfg)
    latent = w[:, None].expand(B, gar.n_latent(cfg["size"]), w.shape[1])
    return gar.synthesis(P, latent, maps, noise, cfg)


def test_forward_flops_equal_a_counter_of_the_reference():
    cfg = _tiny()
    P = inputs.weights(cfg, 3, "cpu")
    with FlopCounterMode(display=False) as fc:
        _reference_forward(cfg, P)
    assert fc.get_total_flops() == flops.forward_flops(cfg)


def test_forward_flops_equal_a_counter_of_the_port():
    """The port's FIR upsampling convolves the zero-stuffed map: 16 taps an
    output pixel where 4 are work; every other product and convolution is
    counted alike."""
    from stylerenderer_tpu_torch.models import GeneratorWithMap

    from gar_bench.common import load_weights

    cfg = _tiny()
    gen = GeneratorWithMap(cfg["size"], cfg["style_dim"], cfg["n_mlp"],
                           channel_multiplier=cfg["channel_multiplier"], device="cpu").eval()
    load_weights(gen, inputs.weights(cfg, 3, "cpu"))
    maps = [torch.rand(1, s, s, 3) for s in gar.levels(cfg["size"])]
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        latent = gen.style(torch.randn(1, cfg["style_dim"]))[:, None].expand(
            1, gen.n_latent, cfg["style_dim"])
        gen.synthesize(latent, maps)
    stuffed = sum(2 * 12 * 3 * r * r for r in gar.levels(cfg["size"])[1:])
    assert fc.get_total_flops() == flops.forward_flops(cfg) + stuffed


def _hand_convs(size):
    """The 3x3 convs by hand from config-f's channel table (multiplier 2):
    4 px 512->512; per level an upsampling conv at the input resolution and
    a conv at the output one."""
    ch = {4: 512, 8: 512, 16: 512, 32: 512, 64: 512, 128: 256, 256: 128, 512: 64, 1024: 32}
    n, cin, r = 2 * 16 * 512 * 512 * 9, 512, 8
    while r <= size:
        n += 2 * (r // 2) ** 2 * cin * ch[r] * 9 + 2 * r * r * ch[r] * ch[r] * 9
        cin, r = ch[r], 2 * r
    return n


# the 3x3 convs' operations by resolution, worked out by hand: 4 px; then per
# level the upsampling conv (at the input resolution) + the conv
HAND_256 = (75_497_472 + (75_497_472 + 301_989_888) + (301_989_888 + 1_207_959_552)
            + (1_207_959_552 + 4_831_838_208) + (4_831_838_208 + 19_327_352_832)
            + (9_663_676_416 + 19_327_352_832) + (9_663_676_416 + 19_327_352_832))
HAND_1024 = HAND_256 + 2 * (9_663_676_416 + 19_327_352_832)


def test_forward_flops_against_a_hand_count():
    for name, convs in (("gar256", HAND_256), ("gar1024", HAND_1024)):
        cfg = spec.config(name)
        assert _hand_convs(cfg["size"]) == convs
        total = flops.forward_flops(cfg)
        # the rest (mapping, styles, ToRGB, blurs, ResBlocks) is small
        assert convs < total < 1.03 * convs


def test_bbox_pairs_against_brute_force():
    g = torch.Generator().manual_seed(5)
    verts = torch.rand(2, 30, 3, generator=g) * 1.6 - 0.8
    tri = torch.randint(0, 30, (40, 3), generator=g)
    tri[0] = torch.tensor([0, 0, 1])  # degenerate
    tri[1] = torch.tensor([0, 1, 31])  # out of range
    sizes = [4, 8, 16]
    want = 0
    for b in range(2):
        for s in sizes:
            for t in tri.tolist():
                if max(t) >= 30:
                    continue
                p = verts[b, t]
                px = [(1 + float(x)) * s / 2 - 0.5 for x in p[:, 0]]
                py = [(1 - float(y)) * s / 2 - 0.5 for y in p[:, 1]]
                det = ((px[1] * py[2] - py[1] * px[2]) + (py[0] * px[2] - px[0] * py[2])
                       + (px[0] * py[1] - py[0] * px[1]))
                if det > 1e-6:
                    continue
                for y in range(s):
                    for x in range(s):
                        if min(px) <= x <= max(px) and min(py) <= y <= max(py):
                            want += 1
    assert pyramid_work.bbox_pairs(verts, tri, sizes) == want


def test_pyramid_work_bytes_and_bound():
    verts = torch.zeros(3, 10, 3)
    tri = torch.zeros(7, 3, dtype=torch.long)
    w = pyramid_work.work(verts, tri, [4, 8])
    assert w["bytes"] == 3 * 10 * 3 * 4 * 2 + 7 * 3 * 4 + 3 * (16 + 64) * 16
    assert w["bound_s"] == max(w["bytes"] / 3.35e12, w["ops"] / 67e12)

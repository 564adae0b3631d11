"""The training cell's pieces on the CPU, at the tiny size of ``tiny.py`` and
on weights drawn from a seed: the port's ``Discriminator``, ``r1_penalty``
and ``path_lengths_multi`` (over W+ and every normal level) and their
parameter gradients against ``reference/disc.py`` and
``reference/train.py``; each model's last update in ``run_step``'s steps 0
(R1 and the path term) and 1 (the two losses), as Adam got it, against the
reference's at the same parameters; and the control's faults failing the
cell's limits.

Every tolerance is float32 rounding alone: both sides compute in float32 on
the CPU, in nearly the same order of operations, so each leaf's relative L2
gap stays near 1e-6 (program against reference: 1.3e-6 at most on the
discriminator, R1, the path length and the updates on the CPU at this
size); 1e-4 leaves a hundred times that, and is still a hundred times under
the smallest gap that a fault leaves (the control one precision below reads
0.05 and more)."""

import pytest
import torch

from gar_bench import compare, control, inputs, spec
from gar_bench.common import load_weights
from gar_bench.compare import judge
from gar_bench.reference import disc, gar
from gar_bench.reference import train as ref_train
from gar_bench.tests import tiny
from gar_bench.tests.test_gb_imports import CHECK, _run

CPU = torch.device("cpu")
CELL = "gar256gan.train.b16"
TOL = 1e-4
SEED = 2**32 + 19


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.layout(tmp_path_factory.mktemp("tiny"))


@pytest.fixture(scope="module")
def client(root):
    """The tiny cell's loop after set-up (steps 0-4 through ``run_step``)."""
    wl = spec.workload(spec.benchmark(root), tiny.name(CELL))
    loop = spec.loop("train", root).Loop(spec.config(wl["config"], root),
                                         spec.traffic(wl["traffic"], root), SEED, CPU)
    loop.setup()
    return loop


def _rel(a, b) -> float:
    a, b = a.detach(), b.detach()
    return compare.rel_l2(a, b) if float(b.norm()) > 0 else float(a.norm())


def _grads(loss, leaves: dict) -> dict:
    """The gradient of every leaf that ``loss`` reaches."""
    gs = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    return {k: g for k, g in zip(leaves, gs) if g is not None}


def _program_d(client):
    from stylerenderer_tpu_torch.models import Discriminator

    cfg, dc = client.cfg, client.cfg["discriminator"]
    d = Discriminator(cfg["size"], dc["channel_multiplier"], tuple(cfg["blur_kernel"]),
                      dc["stddev_group"], dc["stddev_feat"], device="cpu")
    load_weights(d, client.PD)
    return d


def test_discriminator_matches_the_reference(client):
    d = _program_d(client)
    x = torch.cat(client.reals)
    with torch.no_grad():
        assert _rel(d(x), disc.forward(client.PD, x, client.cfg)) <= TOL


def test_r1_penalty_and_its_gradients_match_the_reference(client):
    from stylerenderer_tpu_torch.train import r1_penalty

    d, real = _program_d(client), client.reals[0]
    params = dict(d.named_parameters())
    prog = r1_penalty(d, real)
    gp = dict(zip(params, torch.autograd.grad(prog, list(params.values()),
                                              allow_unused=True, materialize_grads=True)))
    leaves = {k: v.clone().requires_grad_(True) for k, v in client.PD.items()}
    ref = ref_train.r1_penalty(lambda x: disc.forward(leaves, x, client.cfg), real)
    gr = _grads(ref, leaves)
    assert _rel(prog, ref) <= TOL
    for k in compare.counted_leaves(gr):
        assert _rel(gp[k], gr[k]) <= TOL, k


def test_path_lengths_over_the_normal_levels_match_the_reference(client):
    from stylerenderer_tpu_torch.models import GeneratorWithMap
    from stylerenderer_tpu_torch.train import path_lengths_multi

    cfg, d = client.cfg, client.draws[0]
    g = GeneratorWithMap(cfg["size"], cfg["style_dim"], cfg["n_mlp"],
                         channel_multiplier=cfg["channel_multiplier"], lr_mlp=cfg["lr_mlp"],
                         device="cpu")
    load_weights(g, client.P)
    params = dict(g.named_parameters())
    pb = client.traffic["batch"] // client.traffic["path_batch_shrink"]
    maps = [m[:pb] for m in ref_train.pyramid(client.face, client.tri, d["g_face"],
                                              d["g_pose"], cfg, ref_train.Precision())]
    w = [g.get_latent(z) for z in (d["p_z1"], torch.where(d["p_mix"], d["p_z2"], d["p_z1"]))]
    layer = torch.arange(g.n_latent)[None, :, None]
    lat = torch.where(layer < d["p_inject"], w[0][:, None], w[1][:, None])
    prog = path_lengths_multi(lambda lt, *ms: g.synthesize(lt, list(ms), noise=d["p_noise"]),
                              d["p_probe"], (lat, *maps))
    gp = dict(zip(params, torch.autograd.grad(prog.sum(), list(params.values()),
                                              allow_unused=True, materialize_grads=True)))
    leaves = {k: v.clone().requires_grad_(True) for k, v in client.P.items()}
    lat_r = ref_train.latents(leaves, d, "p", cfg, ref_train.Precision())
    ref = ref_train.path_lengths(
        lambda lt, ms: gar.synthesis(leaves, lt, ms, d["p_noise"], cfg), lat_r,
        [m.clone().requires_grad_(True) for m in maps], d["p_probe"])
    gr = _grads(ref.sum(), leaves)
    w_only = ref_train.path_lengths(
        lambda lt, ms: gar.synthesis(leaves, lt, ms, d["p_noise"], cfg), lat_r,
        [m.clone().requires_grad_(True) for m in maps], d["p_probe"], with_maps=False)
    assert _rel(prog, ref) <= TOL
    assert _rel(w_only, ref) > 100 * TOL  # the normal levels count
    for k in compare.counted_leaves(gr):
        assert _rel(gp[k], gr[k]) <= TOL, k


def test_the_updates_of_steps_0_and_1_match_the_reference(client):
    """Each model's last update in ``run_step``'s steps 0 (R1, the path term)
    and 1 (the two losses), its gradient as Adam got it, against the
    reference's at the values of G, D and the path mean it was taken at."""
    updates = client.first["updates"]
    assert [sorted(u) for u in updates] == [["d", "g"], ["d", "g"]]
    for prog_u, ref_u in zip(updates, client.gradients_at(updates)):
        for part in ("g", "d"):
            for k in compare.counted_leaves(ref_u[part]):
                assert _rel(prog_u[part]["grad"][k], ref_u[part][k]) <= TOL, (part, k)
    ref = client.reference()
    assert client.first["mean_path_length"][0] == pytest.approx(ref["mean_path_length"][0],
                                                                rel=TOL)
    assert client.discarded == 0


def test_an_ema_left_unchanged_or_a_path_mean_not_carried_is_not_correct(client, root):
    """The check holds the EMA and the running path mean: an EMA that never
    moved, or a mean restarted from 0 before step 4's update, fails the
    cell's limits where the sound run passes them."""
    limits = spec.limits(tiny.name(CELL), root)
    ref = client.reference(keep=())
    at = client.gradients_at(client.first["updates"])

    def numbers(prog):
        out = spec.loop("train", root).train_numbers(prog, ref, at, {"g": client.P,
                                                                      "d": client.PD})[0]
        return out, judge(dict(out, discarded_steps=0), limits)[0]

    assert numbers(client.first)[1]
    got, ok = numbers(dict(client.first, params=dict(client.first["params"], ema=client.P)))
    assert got["ema_change_gap"] == pytest.approx(1.0) and not ok
    means = list(client.first["mean_path_length"])
    means[4] -= 0.99 * means[3]  # step 4's update from 0, not from the running mean
    got, ok = numbers(dict(client.first, mean_path_length=means))
    assert got["path_mean_gap"] > limits["path_mean_gap"] and not ok


@pytest.mark.parametrize("fault", ["no_r1", "w_only"])
def test_the_faults_fail_the_cells_limits(root, fault):
    wl = spec.workload(spec.benchmark(root), tiny.name(CELL))
    numbers = control.readings(wl, 5, fault, 0, base=root, device=CPU)
    assert not judge(numbers, spec.limits(wl["name"], root))[0], numbers


def test_the_discriminators_weights_follow_the_seed(client):
    again = disc.weights(client.cfg, torch.randn(
        disc.n_params(client.cfg), generator=inputs.stream(SEED, "weights", 1, CPU)))
    assert all(torch.equal(again[k], v) for k, v in client.PD.items())


def test_the_training_reference_loads_nothing_of_the_port():
    code = ("import gar_bench.reference.disc, gar_bench.reference.train\n"
            "import gar_bench.train_flops, gar_bench.span_launches\n")
    line = _run(code + CHECK % (("jax", "jaxlib", "flax", "stylerenderer_tpu",
                                 "stylerenderer_tpu_torch"),))
    assert line == "LOADED ", line


def test_span_time_counts_what_another_thread_launched():
    """A kernel that the autograd engine's thread (tid 2) launches while the
    window's thread (tid 1) is inside ``train.r1`` counts for the span; one
    launched after the span does not; the thread-matching reader sees none."""
    from gar_bench.span_launches import device_ms_a_range
    from gar_bench.trace import WINDOW, Trace

    def x(name, cat, ts, dur, tid=None, corr=None):
        e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}
        if tid is not None:
            e["tid"] = tid
        if corr is not None:
            e["args"] = {"correlation": corr}
        return e
    tr = Trace([x(WINDOW, "user_annotation", 0, 1000, 1),
                x("train.r1", "user_annotation", 100, 100, 1),
                x("cudaLaunchKernel", "cuda_runtime", 150, 1, 2, 7),
                x("cudaLaunchKernel", "cuda_runtime", 250, 1, 2, 8),
                x("k", "kernel", 160, 30, corr=7), x("k", "kernel", 260, 40, corr=8)])
    assert device_ms_a_range(tr, "train.r1") == pytest.approx(0.030)
    assert device_ms_a_range(tr, "train.path") is None
    assert tr.device_s_in(lambda n: n == "train.r1") == 0.0


def test_idle_time_a_path_step():
    """``idle_path_ms``: the device's idle time inside the window thread's
    ``train.path`` ranges, over their number."""
    from types import SimpleNamespace

    from gar_bench.trace import WINDOW, Trace

    tr = Trace([{"ph": "X", "name": WINDOW, "cat": "user_annotation", "ts": 0, "dur": 1000,
                 "tid": 1},
                {"ph": "X", "name": "train.path", "cat": "user_annotation", "ts": 100,
                 "dur": 100, "tid": 1},
                {"ph": "X", "name": "train.path", "cat": "user_annotation", "ts": 500,
                 "dur": 100, "tid": 1},
                {"ph": "X", "name": "k", "cat": "kernel", "ts": 160, "dur": 30},
                {"ph": "X", "name": "k", "cat": "kernel", "ts": 700, "dur": 30}])
    reader = spec.metric("idle_path_ms.train")
    assert reader.read(SimpleNamespace(trace=tr, units=16)) == pytest.approx((70 + 100) / 2e3)

"""The port's data parallelism on the CPU (``parallel/mesh.py``, the train
step, D's minibatch-stddev channel and ``cli.train`` across ranks), at
the tiny size of ``torch_train_ref.py``: global batch 4 on 2 gloo ranks
of 2 rows each, against the port at world 1 on the global batch and
against the JAX reference pieces with their batch inputs sharded over a
2-device mesh (``stylerenderer_tpu.parallel``).

The ranks are spawned once for the module (``torch_parallel.Ranks``)
and run every scenario; each test checks one. The whole step runs at
step 0 (R1 and the path term both fire) with ADA's controller on
(``ada_every=2``, so it fires) and the deterministic stand-in heads
(``sfs``, ``feat``, ``lmk``), whose pairs cross the ranks. Its four Adam
updates are recorded; the references are evaluated at the parameters each
update saw on the ranks, because Adam's first step (~``lr * sign(g)``)
turns rounding into parameter differences. Tolerances: against world 1,
1e-5 of each tensor's largest magnitude; against JAX, 1e-4, the
tolerance of ``test_torch_train.py``."""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from stylerenderer_tpu.parallel import make_mesh as j_make_mesh
from stylerenderer_tpu.parallel import replicate as j_replicate
from stylerenderer_tpu.parallel import shard_batch as j_shard_batch

from stylerenderer_tpu_torch.face3d.augment import aug_draws
from stylerenderer_tpu_torch.parallel import Mesh, batch_sharding, make_mesh
from stylerenderer_tpu_torch.train import r1_penalty
from stylerenderer_tpu_torch.train.step import _grads
from torch_parallel import SCENARIOS, Ranks, landed_step, stand_in_heads
from torch_threads import _one_thread  # noqa: F401
from torch_train_ref import (  # noqa: F401 - tiny is a fixture
    B,
    CFG,
    SIZE,
    _assert_tree_close,
    _draws,
    _jax_d,
    _jax_g,
    _named,
    _nchw,
    _real,
    _state,
    tiny,
)

W = 2
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FACE = (6, 12, 4, 2)
STEP_CFG = dict(CFG, augment=True, ada_every=2, ada_target=0.25)


@pytest.fixture(scope="module")
def spec(tiny):
    """The scenarios' inputs: the fixture's weights, seeded reals and
    draws (with ADA's), the stand-in heads, step 0. D's signs on these
    reals average 0.5, above ``ada_target``, so ``p`` moves up."""
    _, st = _state(tiny, augment=True, ada_every=2, ada_target=0.25)
    draws, jd = _draws(tiny, 4)
    gen = torch.Generator().manual_seed(9)
    draws = dataclasses.replace(draws, **{k: aug_draws(gen, B)
                                          for k in ("d_aug_real", "d_aug_fake", "g_aug")})
    return dict(device="cpu", cfg=STEP_CFG, face=FACE, g=st.g.state_dict(),
                d=st.d.state_dict(), real=_nchw(_real(6)), draws=draws, heads=True, step=0,
                run=["helpers", "stddev", "step", "screen"], jd=jd)


@pytest.fixture(scope="module")
def launched(spec, tmp_path_factory):
    """The 2 ranks, started; the first test compiles JAX while they run."""
    ranks = Ranks(W, {k: v for k, v in spec.items() if k != "jd"},
                  str(tmp_path_factory.mktemp("ranks")))
    yield ranks
    ranks.wait()


@pytest.fixture(scope="module")
def ranks(launched):
    return launched.wait()


def _rel(got, want, rel, what):
    err, scale = float((got - want).abs().max()), float(want.abs().max())
    assert err <= rel * max(scale, 1e-30), f"{what}: max err {err:.3e}, scale {scale:.3e}"


# ------------------------------------------------- the whole step against JAX

def test_step_matches_jax_sharded(tiny, spec, launched):
    """The same step's losses, path mean and four updates' gradients against
    the JAX reference pieces evaluated at the ranks' parameters, with the
    batch inputs placed by JAX ``shard_batch`` and the parameters by
    ``replicate`` over ``make_mesh(jax.devices()[:2])``; to 1e-4."""
    jd = spec["jd"]
    _, st = _state(tiny)
    mesh = j_make_mesh(jax.devices()[:2])

    def jax_d(tensors):
        return j_replicate(mesh, _jax_d(_named(st.d, tensors)))

    def jax_g(tensors):
        return j_replicate(mesh, _jax_g(_named(st.g, tensors)))

    def sh(x):
        return j_shard_batch(mesh, jnp.asarray(x))

    def styles(s):
        return [sh(z) for z in s[0]], s[1]

    real = sh(np.transpose(spec["real"].numpy(), (0, 2, 3, 1)))

    def close(port, want, what):
        np.testing.assert_allclose(port, float(want), rtol=1e-4, atol=1e-7, err_msg=what)

    # the inputs: posed meshes and D's fakes, as the step makes them
    dvert, dnorm = tiny["posed"](*map(jnp.asarray, jd["d_mesh"]))
    fake = sh(tiny["fake"](tiny["gp"], *jd["d_styles"], dvert, dnorm, jd["d_noise"]))
    gvert, gnorm = tiny["posed"](*map(jnp.asarray, jd["g_mesh"]))
    res, pb = B // 2, B // 2
    gvert, gnorm = (t.at[1::2].set(t[:res * 2:2]) for t in (gvert, gnorm))

    def pieces(d0, d1, d2, g0, g1):
        with mesh:
            return (tiny["d_step"](d0, real, fake), tiny["r1"](d1, real),
                    tiny["g_step_heads"](g0, d2, *styles(jd["g_styles"]), sh(gvert), sh(gnorm),
                                         [sh(n) for n in jd["g_noise"]]),
                    tiny["path"](g1, *styles(jd["p_styles"]), sh(gvert[:pb]), sh(gnorm[:pb]),
                                 [sh(n) for n in jd["p_noise"]], jd["key"], jnp.float32(0.0)))

    # compiled for the mesh while the ranks run, then at the ranks' parameters
    jax.block_until_ready(pieces(*[j_replicate(mesh, tiny[k]) for k in ("dp",) * 3 + ("gp",) * 2]))
    r0 = launched.wait()[0]["step"]
    recs, m = r0["records"], r0["metrics"]
    ((d_loss, d_grads), ((_, r1), r1_grads), ((g_loss, aux), g_grads),
     ((_, (pen, new_mean, pl)), p_grads)) = pieces(
        jax_d(recs[0][1]), jax_d(recs[1][1]), jax_d(r0["d"]), jax_g(recs[2][1]),
        jax_g(recs[3][1]))
    assert len(d_loss.sharding.device_set) == 2
    close(m["d"], d_loss, "d")
    close(m["r1"], r1, "r1")
    close(m["g"], g_loss, "g")
    for k in ("sfs", "feature", "lmk"):
        close(m[k], aux[k], k)
    close(m["path"], pen, "path")
    close(m["path_length"], jnp.mean(pl), "path_length")
    close(r0["mean_path_length"], new_mean, "mean_path_length")
    for rec, want in zip(recs, (d_grads, r1_grads, g_grads, p_grads)):
        port = (_jax_d(_named(st.d, rec[2])) if rec[0] == "d" else
                _jax_g(_named(st.g, rec[2])))
        _assert_tree_close(port, jax.device_get(want), 1e-4)


# ------------------------------------------------------------------ the helpers

@pytest.mark.parametrize("world", [1, 2])
def test_mesh_helpers(spec, ranks, world):
    """``batch_sharding``, ``shard_batch``, ``constrain_batch`` and
    ``replicate`` at world 1 (no group: identities) and 2 (contiguous
    blocks; rank 0's parameters, Adam moments, generator, path mean and
    step counters on every rank); ``gather_rows`` with its adjoint and its
    gradient of a gradient: for y = sum(w * gather(x)^2) on every rank,
    dy/dx_r = 2 W w_r x_r and d|dy/dx|^2/dx_r = 8 W^2 w_r^2 x_r."""
    outs = [SCENARIOS["helpers"](Mesh(), spec, torch.device("cpu"))] if world == 1 else ranks
    outs = [o["helpers"] if world == 2 else o for o in outs]
    x = torch.arange(12.0).reshape(6, 2)
    for r, o in enumerate(outs):
        n = 6 // world
        assert o["rows"] == slice(r * n, (r + 1) * n)
        assert torch.equal(o["shard"]["x"], x[r * n:(r + 1) * n])
        assert torch.equal(o["shard"]["pair"][1], x[r * n:(r + 1) * n, 0])
        assert isinstance(o["shard"]["pair"], tuple)
        assert o["constrain_ok"] and o["constrain_checks"]
        rep = o["replicated"]
        assert rep["step"] == 0 and rep["nonfinite_count"] == 0
        assert rep["mean_path_length"] == 0.0 and float(rep["d_exp_avg"][0].abs().max()) == 0
        for a, b in zip(rep["g"], outs[0]["replicated"]["g"]):
            assert torch.equal(a, b)
        assert torch.equal(rep["rng"], outs[0]["replicated"]["rng"])
        g = o["gather"]
        xr = torch.arange(2.0, dtype=torch.float64) + 3 * r + 1
        w = (torch.arange(2.0 * world, dtype=torch.float64) + 1)[r * 2:(r + 1) * 2]
        full = torch.cat([torch.arange(2.0, dtype=torch.float64) + 3 * q + 1
                          for q in range(world)])
        assert g["y"] == pytest.approx(float(((torch.arange(2.0 * world) + 1) * full ** 2).sum()))
        torch.testing.assert_close(g["gx"], 2 * world * w * xr, rtol=1e-12, atol=0)
        torch.testing.assert_close(g["ggx"], 8 * world ** 2 * w ** 2 * xr, rtol=1e-12, atol=0)
    with pytest.raises(ValueError, match="not divisible"):
        batch_sharding(Mesh(rank=1, world=2), 5)


def test_make_mesh_without_a_launcher(monkeypatch):
    """No launcher variables: world 1, no group, the device asked for; some
    but not all of them: an error naming the missing ones."""
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    mesh = make_mesh("cpu")
    assert (mesh.rank, mesh.world, mesh.group, mesh.device) == (0, 1, None, torch.device("cpu"))
    assert mesh.gather_rows(x := torch.ones(2)) is x
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(RuntimeError, match="WORLD_SIZE, LOCAL_RANK missing"):
        make_mesh("cpu")
    with pytest.raises(ValueError, match="both rank and world_size"):
        make_mesh("cpu", rank=0)


@pytest.mark.parametrize("world,what", [(3, "batch 4 not divisible by 3 ranks"),
                                        (4, "path batch 2 not divisible by 4 ranks")])
def test_cli_train_refuses_a_world_that_does_not_divide(tmp_path, world, what):
    """As the JAX trainer, ``cli.train`` raises before it reads data when
    the world does not divide the global batch or the path batch."""
    from stylerenderer_tpu_torch.cli.train import _train, build_argparser

    args = build_argparser().parse_args([str(tmp_path / "none"), "--out_dir",
                                         str(tmp_path)] + TOY)
    with pytest.raises(ValueError, match=what):
        _train(args, Mesh(world=world))


# -------------------------------------------------------------- D's stddev channel

def test_stddev_groups_across_ranks(tiny, spec, ranks):
    """Local batch 2 with ``stddev_group=4``: every group's other two members
    are on the other rank. D's logits on each rank's rows, R1 and R1's
    averaged gradients equal D's at world 1 on the global batch (1e-5), and
    the logits JAX's D."""
    _, st = _state(tiny)
    real = spec["real"]
    assert st.d.stddev_group == 4 and real.shape[0] // W == 2
    with torch.no_grad():
        logits = st.d(real)
    r1 = r1_penalty(st.d, real)
    grads = _grads(r1, list(st.d.parameters()))
    got = torch.cat([o["stddev"]["logits"] for o in ranks])
    _rel(got, logits, 1e-5, "logits")
    _rel(got, torch.from_numpy(np.asarray(tiny["disc"](
        tiny["dp"], jnp.asarray(np.transpose(real.numpy(), (0, 2, 3, 1)))))), 1e-5, "jax logits")
    for o in ranks:
        assert o["stddev"]["r1"] == pytest.approx(float(r1), rel=1e-5)
        for a, b, (name, _) in zip(o["stddev"]["grads"], grads, st.d.named_parameters()):
            _rel(a, b, 1e-5, f"R1 grad {name}")
    # a rank's own rows alone make other groups, off by far more than the
    # tolerance: the gather is needed
    with torch.no_grad():
        alone = st.d(real[:2])
    assert float((alone - logits[:2]).abs().max()) > 10 * 1e-5 * float(logits.abs().max())


# ---------------------------------------------------------------- the whole step

def _world1_at(tiny, spec, records, final):
    """The port at world 1 on the global batch, each update made to land on
    the parameters the ranks' next update saw (``final`` after the last)
    -> (metrics, state, each update's gradients)."""
    cfg, st = _state(tiny, augment=True, ada_every=2, ada_target=0.25)
    m, grads = landed_step(st, spec["real"], spec["draws"], cfg, tiny["face"], tiny["tri"],
                           stand_in_heads(), records, final)
    return m, st, grads


def test_step_matches_world_1(tiny, spec, ranks):
    """Two ranks at local batch 2 against world 1 at 4: every metric (the
    heads' terms included), ``ada_p``, the path mean and the four updates'
    averaged gradients to 1e-5; both ranks hold the same records and
    parameters, bit for bit; each update is Adam's first step on the
    averaged gradients."""
    r0, r1 = (o["step"] for o in ranks)
    for a, b in zip(r0["records"], r1["records"]):
        assert a[0] == b[0]
        for x, y in zip(a[1] + a[2], b[1] + b[2]):
            assert torch.equal(x, y)
    for x, y in zip(r0["g"] + r0["d"] + r0["ema"], r1["g"] + r1["d"] + r1["ema"]):
        assert torch.equal(x, y)
    recs = r0["records"]
    assert [r[0] for r in recs] == ["d", "d", "g", "g"]
    assert r0["step"] == 1 and r0["metrics"]["nonfinite_steps"] == 0
    assert {"sfs", "feature", "lmk", "r1", "path", "r_t"} <= set(r0["metrics"])

    m, st, grads = _world1_at(tiny, spec, recs, r0)
    assert set(m) == set(r0["metrics"])
    for k, v in m.items():
        assert r0["metrics"][k] == pytest.approx(float(v), rel=1e-5, abs=1e-30), k
    assert float(m["r1"]) != 0 and float(m["path"]) != 0 and float(m["lmk"]) != 0
    assert r0["ada_p"] == pytest.approx(float(st.ada_p), rel=1e-5) and r0["ada_p"] > 0
    assert r0["mean_path_length"] == pytest.approx(float(st.mean_path_length), rel=1e-5)
    names = {"d": [n for n, _ in st.d.named_parameters()],
             "g": [n for n, _ in st.g.named_parameters()]}
    for k, (rec, want) in enumerate(zip(recs, grads)):
        for name, a, b in zip(names[rec[0]], rec[2], want):
            _rel(a, b, 1e-5, f"update {k} ({rec[0]}) {name}")
    # Adam's first steps from zero moments carry D0 to D1 and G0 to G1
    for (_, p0, g), p1, lr in ((recs[0], recs[1][1], st.d_optim.defaults["lr"]),
                               (recs[2], recs[3][1], st.g_optim.defaults["lr"])):
        for a, gr, b in zip(p0, g, p1):
            gr = gr.double()
            want = a.double() - lr * gr / (gr.abs() + 1e-8)
            torch.testing.assert_close(b.double(), want, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------- the finite screen

def test_finite_screen_on_every_rank(ranks):
    """NaN reals on rank 1 only: both ranks take the same decision, keep
    every parameter bit for bit, stay at their step and count one screened
    step."""
    for o in ranks:
        s = o["screen"]
        assert s["kept"] and s["step"] == 1 and s["nonfinite_count"] == 1
        assert s["nonfinite_steps"] == 1 and not np.isfinite(s["d"])


# ----------------------------------------------------------------------- the CLI

TOY = ["--size", "8", "--latent", "16", "--n_mlp", "1", "--channel_multiplier", "1",
       "--batch", "4", "--iter", "2", "--d_reg_every", "2", "--g_reg_every", "2",
       "--n_sample", "2", "--log_every", "1", "--sample_every", "2", "--ckpt_every", "2",
       "--lr", "0", "--seed", "3", "--device", "cpu"]


def test_cli_train_two_ranks(tmp_path):
    """``cli.train`` under ``torch.distributed.run --nproc_per_node 2`` with
    ``--device cpu``, 2 steps at a toy size on a folder of 8 images (the
    first with R1 and the path term): rank 0 alone writes the one
    checkpoint, the log rows and the sample grid, and they equal the
    world-1 CLI's at the same global batch and seed to 1e-5 (metrics
    relative; Adam's first moment and the root of its second, which hold
    the steps' averaged gradients, of each tensor's largest magnitude). ``--lr 0`` keeps the parameters
    where they started (equal bit for bit): Adam's normalization would
    turn the rounding of near-zero gradient elements, which differs
    between a sum over 4 rows and two sums over 2, into parameter
    differences of up to 2 lr."""
    from stylerenderer_tpu_torch.utils.image import write_png

    folder = tmp_path / "faces"
    folder.mkdir()
    rng = np.random.RandomState(0)
    for i in range(8):
        write_png(str(folder / f"{i}.png"), rng.randint(0, 256, (SIZE, SIZE, 3), np.uint8))
    env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
    two, one = tmp_path / "two", tmp_path / "one"
    # the world-1 run beside the launched ranks, in a process of its own
    procs = [subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
         str(W), "-m", "stylerenderer_tpu_torch.cli.train", str(folder), "--out_dir",
         str(two)] + TOY, cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)]
    procs.append(subprocess.Popen(
        [sys.executable, "-m", "stylerenderer_tpu_torch.cli.train", str(folder), "--out_dir",
         str(one)] + TOY, cwd=ROOT, env=dict(env, OMP_NUM_THREADS="1"), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True))
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-4000:]
    assert sorted(os.listdir(two / "checkpoint")) == ["000002.pt"]
    assert (two / "sample" / "000001.png").exists()
    rows = [[json.loads(line) for line in open(d / "logs" / "metrics.jsonl")] for d in (two, one)]
    assert len(rows[0]) == len(rows[1]) == 2  # one writer
    assert rows[0][0]["r1"] != 0 and rows[0][0]["path"] != 0
    for got, want in zip(*rows):
        for k in set(want) - {"step_ms", "imgs_per_sec"}:
            assert got[k] == pytest.approx(want[k], rel=1e-5, abs=1e-12), k
    got, want = (torch.load(d / "checkpoint" / "000002.pt", weights_only=True)
                 for d in (two, one))
    for k in ("step", "nonfinite_count", "args", "ada_aug_p"):
        assert got[k] == want[k], k
    assert torch.equal(got["rng"], want["rng"])
    assert got["mean_path_length"] == pytest.approx(want["mean_path_length"], rel=1e-5)
    for part in ("g", "d", "g_ema"):
        for name, t in want[part].items():
            assert torch.equal(got[part][name], t), f"{part}.{name}"
    for part in ("g_optim", "d_optim"):
        for i, st in want[part]["state"].items():
            mine = got[part]["state"][i]
            assert mine["step"] == st["step"] == 3  # R1 and the path term add one
            _rel(mine["exp_avg"], st["exp_avg"], 1e-5, f"{part}[{i}].exp_avg")
            # the second moment is quadratic in the gradients: its root is
            # held to their tolerance
            _rel(mine["exp_avg_sq"].sqrt(), st["exp_avg_sq"].sqrt(), 1e-5,
                 f"{part}[{i}].exp_avg_sq")

"""The port's training slice against the JAX package at a tiny size
(``size=8``, ``latent=16``, ``n_mlp=1``, ``channel_multiplier=1``, B=4,
``synthetic_face(6, 12, 4, 2)``, as ``tests/test_train.py::tiny_cfg``):
the losses against their closed forms, the Discriminator and the
minibatch-stddev channel, R1 and the multi-tensor path length with their
parameter gradients, one whole train step at given draws, the Adam + EMA
update against optax, the regularizer schedule, the ADA controller, the
finite screen and the guard.

One set of weights drives both packages (``utils/weights.py``); inputs
come from numpy seeds. The JAX reference pieces are jitted once per
module. Tolerances: forwards 1e-5; losses and gradients 1e-4 of each
tensor's largest magnitude; the optimizer and EMA updates 1e-6."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch

from stylerenderer_tpu.nn.layers import Downsample as JDownsample
from stylerenderer_tpu.nn.layers import minibatch_stddev as j_minibatch_stddev
from stylerenderer_tpu.utils.torch_import import import_discriminator

import stylerenderer_tpu_torch.train.step as step_mod
from stylerenderer_tpu_torch.nn.layers import Downsample, minibatch_stddev
from stylerenderer_tpu_torch.train import (
    d_logistic_loss,
    g_nonsaturating_loss,
    make_optimizers,
    path_lengths_multi,
    path_regularize,
    r1_penalty,
    sample_draws,
    train_step,
)
from stylerenderer_tpu_torch.train.step import _adam_step, ada_update, ema_update
from stylerenderer_tpu_torch.utils.config import TrainConfig
from stylerenderer_tpu_torch.utils.guards import TrainGuard, metrics_finite, state_finite
from torch_threads import _one_thread  # noqa: F401
from torch_train_ref import (  # noqa: F401 - tiny is a fixture
    B,
    B2,
    CFG,
    SIZE,
    _assert_tree_close,
    _chw_to_hwc,
    _close,
    _draws,
    _jax_d,
    _jax_g,
    _named,
    _nchw,
    _nhwc,
    _real,
    _state,
    tiny,
)

# ---------------------------------------------------------------- losses

def test_losses_closed_form():
    rp = torch.tensor([1.0, -2.0])
    fp = torch.tensor([0.5, -1.0])

    def sp(x):
        return np.log1p(np.exp(-np.abs(x))) + np.maximum(x, 0)

    np.testing.assert_allclose(float(d_logistic_loss(rp, fp)),
                               (sp(-1.0) + sp(2.0)) / 2 + (sp(0.5) + sp(-1.0)) / 2, rtol=1e-5)
    np.testing.assert_allclose(float(g_nonsaturating_loss(fp)), (sp(-0.5) + sp(1.0)) / 2,
                               rtol=1e-5)
    # mean' = 1 + .5 * (3 - 1) = 2; penalty = mean((pl - 2)^2) = (0 + 4) / 2
    pl = torch.tensor([2.0, 4.0], requires_grad=True)
    pen, mean = path_regularize(pl, torch.tensor(1.0), decay=0.5)
    np.testing.assert_allclose(float(mean), 2.0, rtol=1e-6)
    np.testing.assert_allclose(float(pen.detach()), 2.0, rtol=1e-6)
    assert not mean.requires_grad and pen.requires_grad


def test_r1_penalty_quadratic_disc():
    """For D(x) = a sum(x^2): grad = 2a x, penalty = 4a^2 E[|x|^2], and its
    derivative in a is 8a E[|x|^2]."""
    a = torch.tensor(1.5, requires_grad=True)
    x = torch.randn(4, 1, 3, 3, generator=torch.Generator().manual_seed(0))
    pen = r1_penalty(lambda img: a * img.pow(2).reshape(4, -1).sum(-1), x)
    sq = float(x.pow(2).reshape(4, -1).sum(-1).mean())
    np.testing.assert_allclose(float(pen.detach()), 4 * 1.5 ** 2 * sq, rtol=1e-5)
    (ga,) = torch.autograd.grad(pen, a)
    np.testing.assert_allclose(float(ga), 8 * 1.5 * sq, rtol=1e-5)


def test_path_lengths_closed_form():
    """A linear synthesis ``img = a x1 + b x2`` (per sample): the gradients
    are ``a * probe'`` and ``b * probe'``; with lambdas (1, 2) the path
    length is ``|a| |probe'| + 2 |b| |probe'|``; an input that does not reach
    the output contributes the 1e-12 floor."""
    g = torch.Generator().manual_seed(1)
    x1, x2, x3 = (torch.randn(2, 3, 4, 4, generator=g) for _ in range(3))
    probe = torch.randn(2, 3, 4, 4, generator=g)
    pl = path_lengths_multi(lambda u, v, w: 0.5 * u - 2.0 * v, probe, (x1, x2, x3), (1.0, 2.0, 1.0))
    pn = (probe / 4.0).reshape(2, -1).norm(dim=1)
    np.testing.assert_allclose(pl.detach().numpy(), (0.5 * pn + 2 * 2.0 * pn + 1e-12).numpy(),
                               rtol=1e-6)


# --------------------------------------------------- layers and the network

@pytest.mark.parametrize("b,f", [(8, 1), (8, 2), (2, 1)])
def test_minibatch_stddev_matches_jax(b, f):
    x = np.random.RandomState(b + f).randn(b, 5, 3, 6).astype(np.float32)
    want = j_minibatch_stddev(jnp.asarray(x), 4, f)
    got = minibatch_stddev(_nchw(x), 4, f)
    np.testing.assert_allclose(_nhwc(got.numpy()), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_downsample_matches_jax():
    x = np.random.RandomState(0).randn(2, 8, 8, 3).astype(np.float32)
    jd = JDownsample()
    want = jd.apply(jd.init(jax.random.PRNGKey(0), x), x)
    got = Downsample()(_nchw(x))
    np.testing.assert_allclose(_nhwc(got.numpy()), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_discriminator_matches_jax(tiny):
    _, st = _state(tiny)
    real = _real(1)
    want = tiny["disc"](tiny["dp"], jnp.asarray(real))
    with torch.no_grad():
        got = st.d(_nchw(real))
    assert got.shape == (B, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_discriminator_state_dict_round_trip(tiny):
    """JAX params -> the port's state dict -> load(strict) -> state dict ->
    ``import_discriminator`` gives back every array; ``final_linear.0``'s
    rows come back in the port's (C, H, W) order."""
    _, st = _state(tiny)
    sd = {k: v.numpy() for k, v in st.d.state_dict().items()}
    back = import_discriminator(sd, SIZE)
    back["final_linear0"]["weight"] = _chw_to_hwc(back["final_linear0"]["weight"])
    _assert_tree_close(back, tiny["dp"], 0.0)
    assert {"convs.1.conv2.0.kernel", "convs.1.skip.1.weight", "final_linear.1.bias"} <= set(sd)


# ---------------------------------------------------------- regularizers

def test_r1_penalty_matches_jax(tiny):
    """R1 on the reals and its gradient in D's parameters."""
    cfg, st = _state(tiny)
    real = _real(2)
    (_, r1_j), grads_j = tiny["r1"](tiny["dp"], jnp.asarray(real))
    params = list(st.d.parameters())
    r1 = r1_penalty(st.d, _nchw(real))
    grads = step_mod._grads(cfg.r1 / 2.0 * r1 * cfg.d_reg_every, params)
    _close(r1, r1_j, 1e-4)
    _assert_tree_close(_jax_d(_named(st.d, grads)), grads_j, 1e-4)


def test_path_lengths_matches_jax(tiny):
    """``path_lengths_multi`` over W and the detached pyramid, then
    ``path_regularize``, and the gradient of the weighted penalty in G's
    parameters: same latents, pyramid, noise and probe."""
    cfg, st = _state(tiny)
    draws, jd = _draws(tiny, 3)
    pb = B // 2
    x, z = (a[:pb] for a in jd["g_mesh"])
    vert, norm = tiny["posed"](jnp.asarray(x), jnp.asarray(z))
    mpl = 0.5
    (_, (pen_j, mean_j, pl_j)), grads_j = tiny["path"](
        tiny["gp"], *jd["p_styles"], vert, norm, jd["p_noise"], jd["key"], jnp.float32(mpl))
    g = st.g
    tri = tiny["tri"]
    with torch.no_grad():
        pyramid = g.normal_pyramid((torch.from_numpy(np.array(vert)),
                                    torch.from_numpy(np.array(norm)), tri))
    w = [g.get_latent(s) for s in draws.p_styles.styles()]
    latent = step_mod._mix_styles(w, g.n_latent, draws.p_styles.inject, None, None)
    pl = path_lengths_multi(lambda lat, *maps: g.synthesize(lat, list(maps), noise=draws.p_noise),
                            draws.p_probe, (latent, *pyramid))
    pen, mean = path_regularize(pl, torch.tensor(mpl))
    grads = step_mod._grads(cfg.path_regularize * cfg.g_reg_every * pen, list(g.parameters()))
    np.testing.assert_allclose(pl.detach().numpy(), np.asarray(pl_j), rtol=1e-4)
    _close(pen, pen_j, 1e-4)
    _close(mean, mean_j, 1e-5)
    _assert_tree_close(_jax_g(_named(g, grads)), grads_j, 1e-4)


# ------------------------------------------------------------- the step

def test_train_step_matches_jax(tiny, monkeypatch):
    """One whole step at given draws (step 0: R1 and path both fire). Its
    four updates are recorded: each one's parameters and gradients. The JAX
    reference, composed from ``stylerenderer_tpu.train.losses``,
    ``Discriminator.apply``, ``GeneratorWithMap.apply`` (explicit noise and
    inject index) and ``_mix_styles``, is evaluated at the parameters each
    update saw: D loss, R1, G loss, path length and path mean, and every
    update's gradients, agree. Each update is Adam's first step on its
    gradients, ``p - lr g / (|g| + eps)`` (1e-6)."""
    cfg, st = _state(tiny)
    draws, jd = _draws(tiny, 4)
    real = _real(5)
    records = []

    def record(opt, params, grads):
        records.append((opt, [p.detach().clone() for p in params],
                        [g.detach().clone() for g in grads]))
        _adam_step(opt, params, grads)

    monkeypatch.setattr(step_mod, "_adam_step", record)
    m = train_step(st, _nchw(real), draws, cfg, tiny["face"], tiny["tri"])
    assert [r[0] for r in records] == [st.d_optim, st.d_optim, st.g_optim, st.g_optim]
    assert st.step == 1 and m["nonfinite_steps"] == 0

    d0, d1 = (_jax_d(_named(st.d, r[1])) for r in records[:2])
    d2 = _jax_d(_named(st.d))  # D after R1: the G step's
    g0, g1 = (_jax_g(_named(st.g, r[1])) for r in records[2:])
    _assert_tree_close(d0, tiny["dp"], 0.0)
    _assert_tree_close(g0, tiny["gp"], 0.0)

    dvert, dnorm = tiny["posed"](*map(jnp.asarray, jd["d_mesh"]))
    fake = tiny["fake"](tiny["gp"], *jd["d_styles"], dvert, dnorm, jd["d_noise"])
    d_loss, d_grads = tiny["d_step"](d0, jnp.asarray(real), fake)
    _close(m["d"], d_loss, 1e-4)
    _assert_tree_close(_jax_d(_named(st.d, records[0][2])), d_grads, 1e-4)

    (_, r1), r1_grads = tiny["r1"](d1, jnp.asarray(real))
    _close(m["r1"], r1, 1e-4)
    _assert_tree_close(_jax_d(_named(st.d, records[1][2])), r1_grads, 1e-4)

    gvert, gnorm = tiny["posed"](*map(jnp.asarray, jd["g_mesh"]))
    g_loss, g_grads = tiny["g_step"](g0, d2, *jd["g_styles"], gvert, gnorm, jd["g_noise"])
    _close(m["g"], g_loss, 1e-4)
    _assert_tree_close(_jax_g(_named(st.g, records[2][2])), g_grads, 1e-4)

    pb = B // 2
    (_, (pen, new_mean, pl)), p_grads = tiny["path"](
        g1, *jd["p_styles"], gvert[:pb], gnorm[:pb], jd["p_noise"], jd["key"], jnp.float32(0.0))
    _close(m["path"], pen, 1e-4)
    _close(m["path_length"], jnp.mean(pl), 1e-4)
    _close(m["mean_path_length"], new_mean, 1e-4)
    _close(st.mean_path_length, new_mean, 1e-4)
    _assert_tree_close(_jax_g(_named(st.g, records[3][2])), p_grads, 1e-4)

    # the updates between: Adam's first step from zero moments,
    # p - lr * g / (|g| + eps), carries D0 to D1 and G0 to G1
    for before, grads, after, mod, ratio in (
            (records[0][1], records[0][2], records[1][1], st.d, cfg.d_reg_ratio),
            (records[2][1], records[2][2], records[3][1], st.g, cfg.g_reg_ratio)):
        for p0, g, p1 in zip(before, grads, after):
            g = g.double().numpy()
            want = p0.double().numpy() - cfg.lr * ratio * g / (np.abs(g) + 1e-8)
            np.testing.assert_allclose(p1.numpy(), want, rtol=1e-6, atol=1e-6)


def test_adam_and_ema_match_optax():
    """Two Adam updates of ``make_optimizers``' optimizer on given gradients
    against optax's ``adam`` (same lr, betas, eps), then the EMA against
    ``tree_map(e * d + p * (1 - d))``; to 1e-6."""
    cfg = TrainConfig(**CFG)
    rng = np.random.RandomState(0)
    shapes = [(5, 3), (7,), (2, 3, 3, 1)]
    p0 = [rng.randn(*s).astype(np.float32) for s in shapes]
    grads = [[rng.randn(*s).astype(np.float32) * 10 ** k for k, s in enumerate(shapes)]
             for _ in range(2)]
    grads[1][1][2] = 0.0
    params = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in p0]
    mod = torch.nn.Module()
    for i, p in enumerate(params):
        mod.register_parameter(f"p{i}", p)
    g_optim, _ = make_optimizers(cfg, mod, torch.nn.Linear(1, 1))
    tx = optax.adam(cfg.lr * cfg.g_reg_ratio, b1=0.0, b2=0.99 ** cfg.g_reg_ratio, eps=1e-8)
    jp, opt_state = [jnp.asarray(p) for p in p0], tx.init([jnp.asarray(p) for p in p0])
    for gs in grads:
        _adam_step(g_optim, params, [torch.from_numpy(g) for g in gs])
        upd, opt_state = tx.update([jnp.asarray(g) for g in gs], opt_state, jp)
        jp = optax.apply_updates(jp, upd)
        for a, b in zip(params, jp):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=0, atol=1e-6)
    ema = [torch.from_numpy(p.copy()) for p in p0]
    ema_update(ema, params, cfg.ema_decay)
    want = jax.tree_util.tree_map(lambda e, p: e * cfg.ema_decay + p * (1.0 - cfg.ema_decay),
                                  [jnp.asarray(p) for p in p0], jp)
    for a, b in zip(ema, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6)
    assert g_optim.defaults["betas"] == (0.0, 0.99 ** cfg.g_reg_ratio)
    assert g_optim.defaults["eps"] == 1e-8


def test_schedule_and_ema(tiny):
    """Steps 0, 1, 2 with ``d_reg_every = g_reg_every = 2``: R1 and the path
    length fire at steps 0 and 2, not 1; parameters move; after step 0 the
    EMA is ``d * old + (1 - d) * new``; the path batch is half the batch."""
    cfg, st = _state(tiny, batch=B2)
    real = torch.from_numpy(_real(6, B2)).permute(0, 3, 1, 2).contiguous()
    ema0 = [p.detach().clone() for p in st.g_ema.parameters()]
    g0 = [p.detach().clone() for p in st.g.parameters()]
    ms = []
    for i in range(3):
        draws = sample_draws(st.generator, cfg, tiny["face"], B2, st.g.n_latent)
        assert draws.p_probe.shape == (B2 // 2, 3, SIZE, SIZE)
        ms.append({k: float(v) for k, v in train_step(st, real, draws, cfg, tiny["face"],
                                                       tiny["tri"]).items()})
        if i == 0:
            d = cfg.ema_decay
            for e, old, new in zip(st.g_ema.parameters(), ema0, st.g.parameters()):
                np.testing.assert_allclose(e.detach().numpy(),
                                           (old * d + new.detach() * (1 - d)).numpy(),
                                           rtol=1e-5, atol=1e-6)
    assert st.step == 3 and all(metrics_finite(m) for m in ms)
    assert ms[0]["r1"] != 0 and ms[1]["r1"] == 0 and ms[2]["r1"] != 0
    assert ms[0]["path_length"] != 0 and ms[1]["path_length"] == 0 and ms[2]["path_length"] != 0
    assert ms[1]["mean_path_length"] == ms[0]["mean_path_length"] != ms[2]["mean_path_length"]
    assert max(float((a - b).abs().max()) for a, b in zip(st.g.parameters(), g0)) > 0


def test_ada_controller(tiny):
    """The closed form of the controller, and a step with the adaptive
    augmentation on: 2 reals against ``ada_every=2`` fire the update and
    reset the statistics."""
    cfg = TrainConfig(**dict(CFG, augment=True, ada_every=8))
    step = 0.6 / 500_000
    # signs 3 + 2, count 4 + 4 = 8 > 7: fires, r_t = 5/8 > 0.6 moves p up
    p, s, c = ada_update(cfg, torch.tensor(0.5), torch.tensor(3.0), torch.tensor(4.0),
                         torch.tensor([1.0, 2.0, -1.0, 0.5]))
    np.testing.assert_allclose(float(p), 0.5 + step * 8, rtol=1e-6)
    assert float(s) == 0.0 and float(c) == 0.0
    # count 4: accumulates only
    p, s, c = ada_update(cfg, torch.tensor(1e-6), torch.tensor(0.0), torch.tensor(0.0),
                         torch.tensor([-1.0, -2.0, -1.0, 0.5]))
    assert float(p) == np.float32(1e-6) and float(s) == -2.0 and float(c) == 4.0
    # fires with r_t = -1/2: p moves down and is clipped at 0
    p, _, _ = ada_update(cfg, torch.tensor(1e-6), torch.tensor(-2.0), torch.tensor(4.0),
                         torch.tensor([-1.0, -2.0, -1.0, 0.5]))
    assert float(p) == 0.0

    cfg, st = _state(tiny, batch=B2, augment=True, ada_every=2)
    real = torch.from_numpy(_real(7, B2)).permute(0, 3, 1, 2).contiguous()
    with torch.no_grad():  # p = 0: the D step sees the reals unaugmented
        r_t = float(torch.sign(st.d(real)).mean())
    draws = sample_draws(st.generator, cfg, tiny["face"], B2, st.g.n_latent)
    assert draws.d_aug_real is not None and draws.g_aug.keep.shape == (B2,)
    m = train_step(st, real, draws, cfg, tiny["face"], tiny["tri"])
    assert float(st.ada_count) == 0.0 and float(st.ada_signs) == 0.0
    want = max(0.0, (1.0 if r_t > 0.6 else -1.0) * step * B2)
    np.testing.assert_allclose(float(st.ada_p), want, rtol=1e-6)
    np.testing.assert_allclose(float(m["ada_p"]), want, rtol=1e-6)


def test_finite_screen_keeps_the_state(tiny):
    """A NaN real batch never reaches G, D, the EMA or the optimizers: the
    step reports it, keeps every tensor bit for bit, does not advance, and
    the next good step proceeds."""
    cfg, st = _state(tiny, batch=B2)
    face, tri = tiny["face"], tiny["tri"]
    snap = {n: [t.detach().clone() for t in ts] for n, ts in (
        ("g", st.g.parameters()), ("d", st.d.parameters()), ("ema", st.g_ema.parameters()),
        ("opt", [v for o in (st.g_optim, st.d_optim) for s in o.state.values()
                 for v in s.values()]))}
    mpl = st.mean_path_length.clone()
    bad = torch.full((B2, 3, SIZE, SIZE), float("nan"))
    m = train_step(st, bad, sample_draws(st.generator, cfg, face, B2, st.g.n_latent), cfg,
                   face, tri)
    assert not np.isfinite(float(m["d"]))
    assert st.nonfinite_count == 1 and st.step == 0 and m["nonfinite_steps"] == 1
    now = {"g": list(st.g.parameters()), "d": list(st.d.parameters()),
           "ema": list(st.g_ema.parameters()),
           "opt": [v for o in (st.g_optim, st.d_optim) for s in o.state.values()
                   for v in s.values()]}
    for name in snap:
        assert len(snap[name]) == len(now[name])
        for a, b in zip(snap[name], now[name]):
            assert torch.equal(a, b.detach()), name
    assert torch.equal(mpl, st.mean_path_length)
    good = torch.from_numpy(_real(8, B2)).permute(0, 3, 1, 2)
    m = train_step(st, good, sample_draws(st.generator, cfg, face, B2, st.g.n_latent), cfg,
                   face, tri)
    assert st.step == 1 and st.nonfinite_count == 1 and np.isfinite(float(m["d"]))
    assert state_finite(st)


def test_guards():
    assert metrics_finite({"a": 1.0, "b": torch.tensor(2.0)})
    assert not metrics_finite({"a": float("nan")})
    assert not metrics_finite({"a": 1.0, "b": float("inf")})
    assert state_finite({"w": torch.ones(3), "step": torch.tensor(1)})
    assert not state_finite({"w": torch.tensor([1.0, float("nan")])})
    assert not state_finite([torch.ones(2), {"x": torch.tensor([float("-inf")])}])

    restored = []

    def restore():
        restored.append(True)
        return "ckpt_state"

    g = TrainGuard(restore_fn=restore, max_bad_steps=2, max_restores=1)
    assert g.check(0, "new", {"l": float("nan")}, "prev") == "prev" and not restored
    assert g.check(1, "new", {"l": float("nan")}, "prev") == "ckpt_state" and len(restored) == 1
    assert g.check(2, "new", {"l": 1.0}, "prev") == "new"
    g.check(3, "new", {"l": float("nan")}, "prev")
    with pytest.raises(RuntimeError, match="restores exhausted"):
        g.check(4, "new", {"l": float("nan")}, "prev")
    with pytest.raises(RuntimeError, match="no restore_fn"):
        TrainGuard(max_bad_steps=1).check(0, "new", {"l": float("nan")}, "prev")

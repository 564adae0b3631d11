"""The port's supervisor nets and training heads against the JAX package:
``ResNetUNet`` (face_normals), ``PFLDInference`` and ``InceptionResnetV1``
(facenet) with their published names, ``make_extra_heads``, the heads'
pairing rules, the G step with all three heads, and ``cli.train --sfs
--lmk --feat``.

Each port net is drawn at random (batch norm off identity), and its
``state_dict()`` goes through the JAX package's own converter
(``convert_face_normals``, ``convert_pfld``, ``convert_facenet``), which
reads the published layouts by name and raises on a missing key: both
forwards agree (to 1e-4 of the largest output), so the port's names are
the published ones, and ``utils/weights.py``'s inverse gives back every
array the converter read, bit for bit. The JAX networks are applied
jitted. The G step is the JAX step's G loss (``train/step.py:232-266``)
composed from its pieces at the parameters the port's step saw, with the
port's draws carried across (size 16, B=4): G's loss and the three terms
to 1e-5 relative, G's gradients to 1e-4 of each tensor's largest
magnitude."""

import json

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from stylerenderer_tpu.face3d import mesh_point_normal as j_mesh_point_normal
from stylerenderer_tpu.face3d import synthetic_face as j_synthetic_face
from stylerenderer_tpu.face3d.transforms import euler_mat as j_euler_mat
from stylerenderer_tpu.supervisors import InceptionResnetV1 as JInceptionResnetV1
from stylerenderer_tpu.supervisors import PFLDInference as JPFLDInference
from stylerenderer_tpu.supervisors import ResNetUNet as JResNetUNet
from stylerenderer_tpu.supervisors import convert_face_normals, convert_facenet, convert_pfld
from stylerenderer_tpu.supervisors import make_extra_heads as j_make_extra_heads
from stylerenderer_tpu.train import losses as jl
from stylerenderer_tpu.train import make_models as j_make_models
from stylerenderer_tpu.train.step import _smooth_l1 as j_smooth_l1
from stylerenderer_tpu.utils.config import TrainConfig as JTrainConfig
from stylerenderer_tpu.utils.torch_import import import_discriminator, import_generator

import stylerenderer_tpu_torch.train.step as step_mod
from stylerenderer_tpu_torch.face3d import synthetic_face
from stylerenderer_tpu_torch.face3d.geometry import POSE3D_P
from stylerenderer_tpu_torch.supervisors import (
    InceptionResnetV1, PFLDInference, ResNetUNet, load_face_normals, load_facenet, load_pfld,
    make_extra_heads, random_stand_in_,
)
from stylerenderer_tpu_torch.train import init_train_state, sample_draws, train_step
from stylerenderer_tpu_torch.train.step import StepDraws, StyleDraws, pair_geometry, posed_mesh
from stylerenderer_tpu_torch.utils.config import TrainConfig
from stylerenderer_tpu_torch.utils.weights import (
    discriminator_state_dict_from_jax,
    face_normals_state_dict_from_jax,
    facenet_state_dict_from_jax,
    pfld_state_dict_from_jax,
    state_dict_from_jax,
)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs files in parallel processes,
    where torch's thread pools would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(np.asarray(x), (0, 3, 1, 2))))


def _nhwc(x):
    return np.transpose(np.asarray(x), (0, 2, 3, 1))


def _assert_rel(port, ref, rel, what=""):
    """max |port - ref| <= rel * max |ref|."""
    a, b = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    err, scale = np.abs(a - b).max(), np.abs(b).max()
    assert err <= rel * max(scale, 1e-30), f"{what}: max err {err:.3e}, scale {scale:.3e}"


def _random_net(cls, seed):
    """A port net with flax's default init and batch norm off identity."""
    net = random_stand_in_(cls(), torch.Generator().manual_seed(seed)).eval()
    g = torch.Generator().manual_seed(seed + 100)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                c = m.num_features
                m.running_mean.copy_(torch.randn(c, generator=g) * 0.1)
                m.running_var.copy_(torch.rand(c, generator=g) * 0.6 + 0.7)
                m.weight.copy_(torch.rand(c, generator=g) * 0.5 + 0.75)
                m.bias.copy_(torch.randn(c, generator=g) * 0.1)
    return net


class _Reads(dict):
    """A state dict that records the keys read from it."""

    def __init__(self, *args):
        super().__init__(*args)
        self.read = set()

    def __getitem__(self, key):
        self.read.add(key)
        return super().__getitem__(key)


# name: (port class, JAX class, JAX converter, inverse, port loader, input
# shape NHWC, input range)
NETS = {
    "face_normals": (ResNetUNet, JResNetUNet, convert_face_normals,
                     face_normals_state_dict_from_jax, load_face_normals, (1, 32, 32, 3), (-1, 1)),
    "pfld": (PFLDInference, JPFLDInference, convert_pfld, pfld_state_dict_from_jax, load_pfld,
             (2, 112, 112, 3), (0, 1)),
    # 75 px: the smallest input the unpadded convs and pools admit
    "facenet": (InceptionResnetV1, JInceptionResnetV1, convert_facenet,
                facenet_state_dict_from_jax, load_facenet, (1, 75, 75, 3), (-1, 1)),
}


@pytest.fixture(scope="module")
def nets():
    """Per net: the port net, its state dict and the JAX converter's params."""
    out = {}
    for i, (name, (cls, _, convert, *_)) in enumerate(NETS.items()):
        net = _random_net(cls, i)
        sd = _Reads({k: v.clone() for k, v in net.state_dict().items()})
        out[name] = dict(net=net, sd=sd, params=convert(sd))
    return out


@pytest.mark.parametrize("name", sorted(NETS))
def test_net_matches_jax_through_its_converter(nets, name):
    """The JAX converter reads the port's state dict as a published file:
    both forwards agree to 1e-4 of the largest output (``ResNetUNet``: the
    unit normals and the raw prediction)."""
    _, jcls, _, _, _, shape, (lo, hi) = NETS[name]
    n = nets[name]
    x = np.random.RandomState(1).uniform(lo, hi, shape).astype(np.float32)
    want = jax.jit(lambda p, v: jcls().apply({"params": p}, v))(n["params"], jnp.asarray(x))
    with torch.no_grad():
        got = n["net"](_nchw(x))
    if name == "face_normals":
        for a, b, what in zip(got, want, ("normals", "raw")):
            assert a.shape == (1, 3, 32, 32)
            _assert_rel(_nhwc(a), b, 1e-4, what)
    else:
        assert got.shape == (shape[0], 136 if name == "pfld" else 512)
        assert np.isfinite(got.numpy()).all() and float(got.std()) > 0
        _assert_rel(got.numpy(), want, 1e-4, name)


@pytest.mark.parametrize("name", sorted(NETS))
def test_state_dict_from_jax_inverts_the_converter(nets, name):
    """``*_state_dict_from_jax(convert_*(sd))`` equals ``sd`` bit for bit
    on every key the converter read (it drops ``num_batches_tracked``),
    writes no other key than the net's own, and loads strictly."""
    _, _, _, inverse, *_ = NETS[name]
    n = nets[name]
    back = inverse(jax.tree_util.tree_map(np.asarray, n["params"]))
    own = n["net"].state_dict()
    assert set(back) == set(own)
    read = n["sd"].read
    assert read == {k for k in own if not k.endswith("num_batches_tracked")}
    for k in read:
        assert torch.equal(back[k], dict.__getitem__(n["sd"], k)), k
    type(n["net"])().load_state_dict(back, strict=True)


@pytest.mark.parametrize("name", sorted(NETS))
def test_published_layouts_load_by_name(nets, name, tmp_path):
    """The published files' shapes: face_normals' trunk as ``base_model.*``
    (alone, and beside the bare names), PFLD's ``state_dict`` subkey with a
    ``module.`` prefix in a ``.pth.tar`` file, facenet with its
    ``logits.*``; extra keys are dropped, a missing key raises naming it."""
    cls, _, _, _, load, *_ = NETS[name]
    sd = dict(nets[name]["sd"])
    extra = {"junk.weight": torch.zeros(2)}
    if name == "face_normals":
        trunk = ("conv1.", "bn1.", "layer1.", "layer2.", "layer3.", "layer4.")
        only = {("base_model." + k if k.startswith(trunk) else k): v for k, v in sd.items()}
        variants = [only, {**sd, **{"base_model." + k: v for k, v in sd.items()}, **extra}]
    elif name == "pfld":
        path = str(tmp_path / "pfld_model_best.pth.tar")
        torch.save({"epoch": 3, "state_dict": {"module." + k: v for k, v in sd.items()}}, path)
        variants = [path, {**sd, **extra}]
    else:
        variants = [{**sd, "logits.weight": torch.zeros(8, 512), "logits.bias": torch.zeros(8)}]
    for v in variants:
        net = load(cls(), v)
        for k, t in net.state_dict().items():
            if not k.endswith("num_batches_tracked"):
                assert torch.equal(t, sd[k]), k
    missing = sorted(k for k in sd if k.endswith("running_var"))[0]
    with pytest.raises(KeyError, match=missing.replace(".", r"\.")):
        load(cls(), {k: v for k, v in sd.items() if k != missing})


def test_make_extra_heads_shapes():
    """At ``image_size=16`` (``sfs`` runs at 32 and resizes back): normals
    ``[B, 16, 16, 3]``, 136 landmarks, a unit 512-d embedding; the nets are
    frozen and the gradient reaches the image; each net's stand-in is fixed
    by the seed whichever heads are asked for."""
    heads = make_extra_heads(3, sfs=True, lmk=True, feat=True, image_size=16, device="cpu")
    img = (torch.rand(2, 3, 16, 16, generator=torch.Generator().manual_seed(0)) * 2 - 1)
    img.requires_grad_(True)
    out = {k: f(img) for k, f in heads.items()}
    assert out["sfs"].shape == (2, 16, 16, 3)
    assert out["lmk"].shape == (2, 136)
    assert out["feat"].shape == (2, 512)
    np.testing.assert_allclose(out["feat"].detach().norm(dim=-1).numpy(), 1.0, rtol=1e-5)
    for f in heads.values():
        assert all(not p.requires_grad for p in f.__defaults__[0].parameters())
        assert not f.__defaults__[0].training
    (gimg,) = torch.autograd.grad(sum(o.square().sum() for o in out.values()), img)
    assert torch.isfinite(gimg).all() and float(gimg.abs().max()) > 0
    alone = make_extra_heads(3, lmk=True, image_size=16, device="cpu")
    assert set(alone) == {"lmk"} and torch.equal(alone["lmk"](img), out["lmk"])


# ---- the heads in the train step ------------------------------------------------------

SIZE, LATENT, B = 16, 16, 4
CFG = dict(size=SIZE, latent=LATENT, n_mlp=1, channel_multiplier=1, batch=B, d_reg_every=2,
           g_reg_every=2, path_batch_shrink=2, mixing=0.9)
NOISE_RES = [4, 8, 8, 16, 16]


def test_paired_geometry_semantics():
    """The reference's pairing rules (``train.py:294-309``), as the JAX
    package's ``test_paired_geometry_semantics``: with ``lmk``, interleaved
    pairs share the whole posed geometry and render the same normal
    pyramids, with their own styles; with ``feat``, the halves share the
    styles and the shape part of the 3DMM sample but not the expression;
    without heads the draws are the plain trainer's."""
    cfg = TrainConfig(**dict(CFG, batch=6))
    face, tri = synthetic_face(6, 12, 4, 2, device="cpu")
    st = init_train_state(cfg, "cpu")
    batch, half, res = 6, 3, 3

    def draws(heads):
        return sample_draws(torch.Generator().manual_seed(10), cfg, face, batch,
                            st.g.n_latent, heads)

    d = draws(("lmk",))
    vert, norm, _ = posed_mesh(face, tri, d.g_face, d.g_pose)
    vert, norm = pair_geometry(vert), pair_geometry(norm)
    assert torch.equal(vert[1::2], vert[:res * 2:2]) and torch.equal(norm[1::2], norm[:res * 2:2])
    assert not torch.equal(vert[0], vert[2])
    assert not torch.equal(d.g_styles.z1[0], d.g_styles.z1[1])
    with torch.no_grad():
        for m in st.g.normal_pyramid((vert, norm, tri)):
            assert torch.equal(m[1::2], m[:res * 2:2])

    d = draws(("feat",))
    for z in (d.g_styles.z1, d.g_styles.z2):
        assert z.shape == (batch, LATENT) and torch.equal(z[half:], z[:res])
    dim0 = face.dim[0]
    assert torch.equal(d.g_face[half:, :dim0], d.g_face[:res, :dim0])
    assert not torch.equal(d.g_face[half:, dim0:], d.g_face[:res, dim0:])
    vert, _, _ = posed_mesh(face, tri, d.g_face, d.g_pose)
    assert not torch.equal(vert[half:], vert[:res])

    plain, none = draws(()), sample_draws(torch.Generator().manual_seed(10), cfg, face, batch,
                                          st.g.n_latent)
    for a, b in ((plain.g_styles.z1, none.g_styles.z1), (plain.g_face, none.g_face),
                 (plain.p_probe, none.p_probe)):
        assert torch.equal(a, b)


def _perturb(params, seed):
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32)
        + 0.2 * np.asarray(rng.randn(*np.shape(x)), np.float32), params)


def _chw_to_hwc(w):
    c = w.shape[0] // 16
    return np.transpose(w.reshape(c, 4, 4, -1), (1, 2, 0, 3)).reshape(16 * c, -1)


def _named(module, tensors=None):
    names = [n for n, _ in module.named_parameters()]
    tensors = [p for _, p in module.named_parameters()] if tensors is None else tensors
    return {n: t.detach().numpy() for n, t in zip(names, tensors)}


def _jax_g(named):
    return import_generator(named, SIZE, 1, with_map=True)


def _jax_d(named):
    tree = import_discriminator(named, SIZE)
    tree["final_linear0"]["weight"] = _chw_to_hwc(tree["final_linear0"]["weight"])
    return tree


def _step_draws(seed, face):
    """Seeded numpy draws with the ``feat`` pairing -> (port ``StepDraws``,
    the G step's draws for JAX)."""
    rng = np.random.RandomState(seed)
    half, res, pb = (B + 1) // 2, B // 2, B // 2
    sigma = face.sigma.numpy()

    def styles(b):
        z1, z2 = (rng.randn(b, LATENT).astype(np.float32) for _ in range(2))
        return z1, z2, bool(rng.rand() < 0.9), int(rng.randint(1, 2 * 4 - 2))

    def noise(b):
        return [rng.randn(b, 1, r, r).astype(np.float32) for r in NOISE_RES]

    def mesh():
        return ((rng.randn(B, 6) * sigma).astype(np.float32),
                (rng.randn(B, 7) * np.asarray(POSE3D_P)).astype(np.float32))

    ds, (dx, dz), dn = styles(B), mesh(), noise(B)
    z1, z2, mix, inject = styles(half)
    gs = (np.concatenate([z1, z1[:res]]), np.concatenate([z2, z2[:res]]), mix, inject)
    (gx, gz), gn = mesh(), noise(B)
    gx[half:, :4] = gx[:res, :4]
    ps, pn = styles(pb), noise(pb)
    probe = rng.randn(pb, 3, SIZE, SIZE).astype(np.float32)

    def sd(s):
        return StyleDraws(*(torch.from_numpy(a) for a in s[:2]), torch.tensor(s[2]),
                          torch.tensor(s[3]))

    t = torch.from_numpy
    draws = StepDraws(sd(ds), t(dx), t(dz), [t(n) for n in dn], sd(gs), t(gx), t(gz),
                      [t(n) for n in gn], sd(ps), [t(n) for n in pn], t(probe))
    jg = dict(styles=[jnp.asarray(gs[0]), jnp.asarray(gs[1] if gs[2] else gs[0])],
              inject=gs[3], mesh=(gx, gz),
              noise=[jnp.asarray(np.transpose(n, (0, 2, 3, 1))) for n in gn])
    return draws, jg


def test_g_step_with_heads_matches_jax(nets, monkeypatch):
    """One step (no R1, no path) with ``sfs``, ``lmk`` and ``feat`` carrying
    the same weights in both packages: G's loss and the three terms to
    1e-5 relative, G's gradients to 1e-4, against the JAX step's G loss at
    the parameters the port's G update saw (D after its own update), with
    the ``lmk`` geometry pairing applied after posing."""
    cfg = TrainConfig(**CFG)
    jcfg = JTrainConfig(**CFG)
    jgen, jdisc = j_make_models(jcfg)
    jface, jtri = j_synthetic_face(6, 12, shape_dim=4, expression_dim=2)
    face, tri = synthetic_face(6, 12, 4, 2, device="cpu")
    st = init_train_state(cfg, "cpu")
    gp, dp = _perturb(_jax_g(_named(st.g)), 4), _perturb(_jax_d(_named(st.d)), 5)
    st.g.load_state_dict(state_dict_from_jax(gp), strict=True)
    st.d.load_state_dict(discriminator_state_dict_from_jax(dp, SIZE), strict=True)
    st.step = 1  # d_reg_every = g_reg_every = 2: neither regularizer
    sds = {k: dict(nets[n]["sd"]) for k, n in (("sfs", "face_normals"), ("lmk", "pfld"),
                                               ("feat", "facenet"))}
    kw = dict(sfs=True, lmk=True, feat=True, image_size=SIZE, sfs_params=sds["sfs"],
              lmk_params=sds["lmk"], feat_params=sds["feat"])
    heads = make_extra_heads(0, device="cpu", **kw)
    jheads = j_make_extra_heads(jax.random.PRNGKey(0), **kw)

    draws, jg = _step_draws(6, face)
    real = np.random.RandomState(7).uniform(-1, 1, (B, 3, SIZE, SIZE)).astype(np.float32)
    records, adam = [], step_mod._adam_step

    def record(opt, params, grads):
        records.append((opt, [p.detach().clone() for p in params],
                        [g.detach().clone() for g in grads]))
        adam(opt, params, grads)

    monkeypatch.setattr(step_mod, "_adam_step", record)
    m = train_step(st, torch.from_numpy(real), draws, cfg, face, tri, heads)
    assert [r[0] for r in records] == [st.d_optim, st.g_optim] and st.step == 2
    assert {"sfs", "feature", "lmk"} <= set(m)

    half, res = (B + 1) // 2, B // 2
    v = jface(jnp.asarray(jg["mesh"][0]))
    z = jnp.asarray(jg["mesh"][1])
    R = jnp.exp(z[:, -1])[:, None, None] * j_euler_mat(z[:, :3], "yxz")
    v = jnp.einsum("bnk,bkj->bnj", v, R) + z[:, None, 3:6]
    n = j_mesh_point_normal(v, jtri)
    v, n = v.at[1::2].set(v[:res * 2:2]), n.at[1::2].set(n[:res * 2:2])

    @jax.jit
    def g_step(g, d, styles, inject, vert, norm, noise):
        def f(p):
            fimg, _, norms = jgen.apply({"params": p}, styles, (vert, norm, jtri),
                                        inject_index=inject, noise=noise, return_normals=True)
            loss = jl.g_nonsaturating_loss(jdisc.apply({"params": d}, fimg))
            nm = norms[-1]
            mask = (jnp.sum(nm * nm, -1, keepdims=True) > 1e-3).astype(nm.dtype)
            sfs = j_smooth_l1(mask * jheads["sfs"](fimg), mask * nm)
            feat = jheads["feat"](fimg)
            fl = jnp.mean((feat[:res] - feat[half:]) ** 2)
            lmk = jheads["lmk"](fimg)
            ll = j_smooth_l1(lmk[:res * 2:2], lmk[1::2])
            loss = loss + 0.01 * sfs + 0.001 * fl + 1e-5 * ll
            return loss, {"sfs": sfs, "feature": fl, "lmk": ll}
        return jax.value_and_grad(f, has_aux=True)(g)

    g0 = _jax_g(_named(st.g, records[1][1]))
    d1 = _jax_d(_named(st.d))
    (loss, aux), grads = g_step(g0, d1, jg["styles"], jg["inject"], v, n, jg["noise"])
    for key, want in (("g", loss), ("sfs", aux["sfs"]), ("feature", aux["feature"]),
                      ("lmk", aux["lmk"])):
        assert float(want) != 0
        np.testing.assert_allclose(float(m[key]), float(want), rtol=1e-5, err_msg=key)
    got = _jax_g(_named(st.g, records[1][2]))
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_want = dict(jax.tree_util.tree_leaves_with_path(grads))
    for path, a in flat_got:
        _assert_rel(a, flat_want[path], 1e-4, jax.tree_util.keystr(path))


# ---- the CLI --------------------------------------------------------------------------

TINY = ["--size", "16", "--latent", "32", "--n_mlp", "2", "--channel_multiplier", "1",
        "--device", "cpu"]


@pytest.fixture(scope="module")
def shard(tmp_path_factory):
    from stylerenderer_tpu_torch.data import write_synth_dataset

    path = str(tmp_path_factory.mktemp("heads_cli") / "faces16.srpack")
    assert write_synth_dataset(path, 4, size=16, batch=4, device="cpu") == 4
    return path


def test_cli_train_with_heads(shard, tmp_path, capsys):
    """``cli.train --sfs --lmk --feat`` takes a step on the CPU and logs
    ``sfs``, ``feature`` and ``lmk``, finite, beside the plain terms."""
    from stylerenderer_tpu_torch.cli.train import main

    out = tmp_path / "run"
    state = main([shard, "--sfs", "--lmk", "--feat", "--iter", "1", "--batch", "2",
                  "--log_every", "1", "--seed", "0", "--out_dir", str(out)] + TINY)
    assert state.step == 1
    with open(out / "logs" / "metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    assert len(rows) == 1 and {"sfs", "feature", "lmk", "g", "d"} <= set(rows[0])
    assert all(np.isfinite(rows[0][k]) for k in ("sfs", "feature", "lmk", "g"))
    assert (out / "checkpoint" / "000001.pt").exists()


@pytest.mark.parametrize("argv,why", [
    (["--bfm", "b.mat"], "--bfm needs the BFM loader"),
    (["--profile_steps", "2"], "--profile_steps is not ported"),
    (["FOLDER"], "image-folder data is not ported"),
])
def test_cli_train_still_refuses(shard, tmp_path, capsys, argv, why):
    from stylerenderer_tpu_torch.cli.train import main

    if argv == ["FOLDER"]:
        argv = [str(tmp_path)]
    else:
        argv = [shard] + argv
    with pytest.raises(SystemExit):
        main(argv + TINY)
    assert why in capsys.readouterr().err

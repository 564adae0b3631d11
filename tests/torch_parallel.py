"""The port's train step, and its sharded D and GAR, across ranks in
spawned processes, one rank each (gloo on the CPU, or gloo or NCCL on
cards), for ``tests/test_torch_parallel.py``,
``tests/test_torch_spatial.py`` and ``chip_smoke.py``. Imports torch and
the port only, so a rank starts without JAX.

``Ranks(world, spec, out_dir)`` spawns ``world`` processes that each run
``rank_main``: make the mesh (``parallel/mesh.py::make_mesh`` with an
explicit rank over ``tcp://localhost``), run the scenarios that
``spec["run"]`` names and save what each rank saw to
``out_dir/rank{r}.pt``; ``wait()`` returns those dicts in rank order.

``spec`` (a dict; tensors on the CPU):

- ``device``, ``backend`` (``None``: the mesh's default), ``tf32``,
  ``deterministic`` (PyTorch's deterministic algorithms), ``one_card``
  (every rank on ``cuda:0``), ``record`` (``"step"``'s records and
  parameters: ``True``, the default; ``"params"``: without gradients, on
  rank 0 only);
- ``cfg``: ``TrainConfig`` fields; ``face``: ``synthetic_face`` args;
- ``g``, ``d``: state dicts to load (else the models of ``cfg.seed``);
- ``real``: the global real batch; ``draws``: the global ``StepDraws``,
  or ``draw_seed``: draw them with ``sample_draws`` on the device;
- ``heads``: use ``stand_in_heads``; ``step``: the state's step;
- ``run``: scenario names, in order: ``"helpers"``, ``"stddev"``,
  ``"step"``, ``"screen"``, ``"spatial"`` (see the functions below;
  ``"spatial"`` reads ``spatial``).
"""

from __future__ import annotations

import os
import socket
import time

import torch
import torch.distributed as dist


def stand_in_heads():
    """Deterministic stand-ins with the heads' signatures (NCHW in; ``sfs``
    gives ``[B, H, W, 3]``), the port's copies of JAX
    ``tests/test_train.py``'s."""
    return {
        "sfs": lambda img: torch.tanh(img).permute(0, 2, 3, 1),
        "feat": lambda img: img.mean(dim=(2, 3)),
        "lmk": lambda img: img.abs().mean(1).reshape(img.shape[0], -1)[:, :16],
    }


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class Ranks:
    """``world`` spawned processes running ``rank_main`` on ``spec``;
    ``wait`` collects them."""

    def __init__(self, world: int, spec: dict, out_dir: str, timeout: float = 300.0):
        ctx = torch.multiprocessing.get_context("spawn")
        port = free_port()
        self.out_dir, self.deadline = out_dir, time.monotonic() + timeout
        self.procs = [ctx.Process(target=rank_main, args=(r, world, port, spec, out_dir))
                      for r in range(world)]
        for p in self.procs:
            p.start()
        self._results = None

    def wait(self) -> list:
        """Wait for every rank (killing the rest when one fails or the time
        runs out) -> each rank's saved dict, in rank order."""
        if self._results is not None:
            return self._results
        procs = self.procs
        try:
            while any(p.is_alive() for p in procs):
                if (time.monotonic() > self.deadline
                        or any(p.exitcode not in (None, 0) for p in procs)):
                    break
                time.sleep(0.05)
        finally:
            self.kill()
        codes = [p.exitcode for p in procs]
        if codes != [0] * len(procs):
            raise RuntimeError(f"ranks exited with {codes}")
        self._results = [torch.load(os.path.join(self.out_dir, f"rank{r}.pt"), weights_only=False)
                         for r in range(len(procs))]
        return self._results

    def kill(self) -> None:
        """End the ranks that still run."""
        for p in self.procs:
            if p.is_alive():
                p.kill()
            p.join(timeout=10)


def timed_collectives(device: torch.device):
    """Time every ``all_reduce``, ``all_gather`` and ``broadcast`` of
    ``torch.distributed`` on the host clock, the device synchronized before
    and after each -> (totals ``{"ms", "calls"}``, a function that undoes
    the wrapping)."""
    totals = {"ms": 0.0, "calls": 0}
    originals = {n: getattr(dist, n) for n in ("all_reduce", "all_gather", "broadcast")}

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def wrap(fn):
        def timed(*args, **kwargs):
            sync()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            sync()
            totals["ms"] += (time.perf_counter() - t0) * 1e3
            totals["calls"] += 1
            return out
        return timed

    for n, fn in originals.items():
        setattr(dist, n, wrap(fn))

    def undo():
        for n, fn in originals.items():
            setattr(dist, n, fn)

    return totals, undo


def _to(x, device):
    """Tensors of a draws tree moved to ``device``."""
    import dataclasses

    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, list):
        return [_to(v, device) for v in x]
    if dataclasses.is_dataclass(x):
        return type(x)(**{f.name: _to(getattr(x, f.name), device)
                          for f in dataclasses.fields(x)})
    return x


def _cpu(tensors):
    return [t.detach().to("cpu", copy=True) for t in tensors]


def make_state(spec: dict, device):
    from stylerenderer_tpu_torch.train import init_train_state
    from stylerenderer_tpu_torch.utils.config import TrainConfig

    cfg = TrainConfig(**spec["cfg"])
    st = init_train_state(cfg, device)
    if "g" in spec:
        st.g.load_state_dict(spec["g"], strict=True)
        st.g_ema.load_state_dict(spec["g"], strict=True)
        st.d.load_state_dict(spec["d"], strict=True)
    st.step = spec.get("step", 0)
    return cfg, st


def step_inputs(spec: dict, cfg, st, face, device):
    """(global real, global draws, heads) of ``spec`` on ``device``."""
    from stylerenderer_tpu_torch.train import sample_draws

    heads = stand_in_heads() if spec.get("heads") else {}
    real = spec["real"].to(device)
    if "draws" in spec:
        draws = _to(spec["draws"], device)
    else:
        gen = torch.Generator(device).manual_seed(spec["draw_seed"])
        draws = sample_draws(gen, cfg, face, real.shape[0], st.g.n_latent, heads)
    return real, draws, heads


def recorded_step(st, real, draws, cfg, face, tri, heads, mesh, grads=True):
    """``train_step`` with each Adam update's optimizer (``"d"``/``"g"``),
    parameters before it and (with ``grads``) gradients recorded ->
    (metrics, records)."""
    import stylerenderer_tpu_torch.train.step as step_mod

    records, adam, keep_grads = [], step_mod._adam_step, grads

    def record(opt, params, grads):
        grads = list(grads)
        records.append(("d" if opt is st.d_optim else "g", _cpu(params),
                        _cpu(grads) if keep_grads else None))
        adam(opt, params, grads)

    step_mod._adam_step = record
    try:
        m = step_mod.train_step(st, real, draws, cfg, face, tri, heads, mesh)
    finally:
        step_mod._adam_step = adam
    return m, records


def landed_step(st, real, draws, cfg, face, tri, heads, records, final):
    """``train_step`` at world 1 with each update made to land on the
    parameters that another run's next update saw (``records``, as
    ``recorded_step`` gives them) and on ``final`` (``{"d": [...], "g":
    [...]}``) after the last, so that each update is evaluated at that
    run's parameters -> (metrics, each update's gradients)."""
    import stylerenderer_tpu_torch.train.step as step_mod

    before = {"d": [], "g": []}
    for side, params, _ in records:
        before[side].append(params)
    targets = {id(opt): before[side][1:] + [final[side]]
               for opt, side in ((st.d_optim, "d"), (st.g_optim, "g"))}
    grads, adam = [], step_mod._adam_step

    def land(opt, params, gs):
        grads.append([g.detach().clone() for g in gs])
        with torch.no_grad():
            for p, t in zip(params, targets[id(opt)].pop(0)):
                p.copy_(t)

    step_mod._adam_step = land
    try:
        m = step_mod.train_step(st, real, draws, cfg, face, tri, heads)
    finally:
        step_mod._adam_step = adam
    return m, grads


def _helpers(mesh, spec, device):
    """``batch_sharding``, ``shard_batch``, ``constrain_batch``, ``replicate``
    (of a state whose non-zero ranks were changed) and ``gather_rows``
    with its adjoint and its gradient of a gradient."""
    from stylerenderer_tpu_torch.parallel import (
        batch_sharding, constrain_batch, replicate, shard_batch,
    )

    out = {"rows": batch_sharding(mesh, 6)}
    x = torch.arange(12.0).reshape(6, 2)
    out["shard"] = shard_batch(mesh, {"x": x, "pair": (x, x[:, 0])})
    out["constrain_ok"] = constrain_batch(out["shard"]["x"], mesh, 6) is out["shard"]["x"]
    try:  # the whole batch is a rank's rows only at world 1
        constrain_batch(x, mesh, 6)
        out["constrain_checks"] = mesh.world == 1
    except ValueError:
        out["constrain_checks"] = mesh.world > 1
    cfg, st = make_state(spec, device)
    if mesh.rank:
        with torch.no_grad():
            for p in st.g.parameters():
                p.add_(mesh.rank)
        st.d_optim.state[next(iter(st.d.parameters()))]["exp_avg"].fill_(mesh.rank)
        st.generator.manual_seed(1000 + mesh.rank)
        st.mean_path_length.fill_(mesh.rank)
        st.step, st.nonfinite_count = 7 + mesh.rank, mesh.rank
    replicate(mesh, st)
    out["replicated"] = {
        "g": _cpu(st.g.parameters()), "d_exp_avg": _cpu(
            [st.d_optim.state[next(iter(st.d.parameters()))]["exp_avg"]]),
        "rng": torch.rand(3, generator=st.generator, device=st.generator.device).cpu(),
        "mean_path_length": float(st.mean_path_length), "step": st.step,
        "nonfinite_count": st.nonfinite_count}
    # gather_rows: y = sum(w * gather(x)^2) over every rank's copy; its
    # gradient in x, and the gradient of sum(gx^2) in x (second order)
    x = torch.arange(2.0, dtype=torch.float64).add(3 * mesh.rank + 1).requires_grad_(True)
    w = torch.arange(2.0 * mesh.world, dtype=torch.float64) + 1
    y = (w * mesh.gather_rows(x) ** 2).sum()
    (gx,) = torch.autograd.grad(y, x, create_graph=True)
    (ggx,) = torch.autograd.grad((gx ** 2).sum(), x)
    out["gather"] = {"y": float(y.detach()), "gx": gx.detach(), "ggx": ggx}
    return out


def _stddev(mesh, spec, device):
    """D's logits on the rank's rows, its R1 penalty and R1's averaged
    gradients in D's parameters (the stddev groups across ranks)."""
    from stylerenderer_tpu_torch.train import r1_penalty
    from stylerenderer_tpu_torch.train.step import _grads

    _, st = make_state(spec, device)
    real = spec["real"].to(device)[mesh.rows(spec["real"].shape[0])]

    def disc(img):
        return st.d(img, mesh=mesh)

    with torch.no_grad():
        logits = disc(real)
    r1 = r1_penalty(disc, real, mesh.gather_rows)
    grads = mesh.average_gradients(_grads(r1, list(st.d.parameters())))
    return {"logits": logits.cpu(), "r1": float(r1), "grads": _cpu(grads)}


def _step(mesh, spec, device):
    """One whole step on the rank's rows: metrics, K1's, the epilogue
    kernel's and upfirdn2d's launches, the step's host time and its collectives' (each timed alone); with
    ``spec["record"]``, each update's records and the parameters after it
    (``"params"``: without the gradients, on rank 0 only)."""
    from stylerenderer_tpu_torch.face3d import synthetic_face
    from stylerenderer_tpu_torch.ops.fused_act import fused_bias_act
    from stylerenderer_tpu_torch.ops.rasterize_multi import rasterize_winners_multi
    from stylerenderer_tpu_torch.ops.upfirdn2d import upfirdn2d
    from stylerenderer_tpu_torch.train import train_step

    cfg, st = make_state(spec, device)
    face, tri = synthetic_face(*spec["face"], device=device)
    real, draws, heads = step_inputs(spec, cfg, st, face, device)
    real = real[mesh.rows(real.shape[0])]
    mode = spec.get("record", True)
    record = mode is True or (mode == "params" and mesh.rank == 0)
    rasterize_winners_multi.launches = fused_bias_act.launches = upfirdn2d.launches = 0
    totals, undo = timed_collectives(device)
    t0 = time.perf_counter()
    try:
        if record:
            m, records = recorded_step(st, real, draws, cfg, face, tri, heads, mesh,
                                       grads=mode is True)
        else:
            m = train_step(st, real, draws, cfg, face, tri, heads, mesh)
    finally:
        undo()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    out = {"metrics": {k: float(v) for k, v in m.items()}, "ada_p": float(st.ada_p),
           "mean_path_length": float(st.mean_path_length), "step": st.step,
           "k1_launches": rasterize_winners_multi.launches,
           "epilogue_launches": fused_bias_act.launches,
           "upfirdn2d_launches": upfirdn2d.launches,
           "step_ms": (time.perf_counter() - t0) * 1e3, "collectives": dict(totals)}
    if record:
        out.update(records=records, g=_cpu(st.g.parameters()), d=_cpu(st.d.parameters()),
                   ema=_cpu(st.g_ema.parameters()))
    return out


def _screen(mesh, spec, device):
    """A plain step (state step 1: no regularizer) whose reals are NaN on
    the last rank only: every rank keeps its state and counts one screened
    step."""
    from stylerenderer_tpu_torch.face3d import synthetic_face
    from stylerenderer_tpu_torch.train.step import train_step

    cfg, st = make_state(spec, device)
    st.step = 1
    face, tri = synthetic_face(*spec["face"], device=device)
    real, draws, heads = step_inputs(spec, cfg, st, face, device)
    real = real[mesh.rows(real.shape[0])].clone()
    if mesh.rank == mesh.world - 1:
        real.fill_(float("nan"))
    before = _cpu(list(st.g.parameters()) + list(st.d.parameters()))
    m = train_step(st, real, draws, cfg, face, tri, heads, mesh)
    after = _cpu(list(st.g.parameters()) + list(st.d.parameters()))
    return {"kept": all(torch.equal(a, b) for a, b in zip(before, after)),
            "step": st.step, "nonfinite_count": st.nonfinite_count,
            "nonfinite_steps": m["nonfinite_steps"], "d": float(m["d"])}


def _spatial(mesh, spec, device):
    """``spec["spatial"]``'s D and GAR on each of its ``layouts``
    (``(n_data, n_space)``, each laid over this world by ``split_mesh``):
    per layout, the rank's place and groups, its ``image_sharding``, D's
    logits of its block ``shard_image(x)``, and for the loss
    ``sum(logits * x_w[rows])`` the gradient in the block and the
    parameters' gradients reduced by ``average_gradients``; the GAR's
    image band for the rank's rows of ``z``, ``vert``, ``norm`` (and the
    given whole noise maps), and for ``sum(image * img_w[rows, :, gband])``
    (``gband`` its band of the image's rows)
    the gradients in ``vert`` and ``norm`` and the reduced parameter
    gradients (``"d_params"``, ``"g_params"``: of those parameters only,
    by name); K1's launches and
    banded launches in the GAR's forward. With ``"time": n``, also the
    banded GAR forward's ms (mean of ``n``, no gradient), the epilogue
    kernel's launches in those forwards and its collectives' calls and ms
    in one more forward (each timed alone).

    ``spec["spatial"]``: ``d`` and ``g``, each ``(args, kwargs)`` of the
    class (``seed`` among them) and optionally ``d_state``/``g_state``;
    ``x`` ``[B, 3, H, W]``, ``x_w`` ``[B]``; ``z``, ``vert``, ``norm``,
    ``tri``, ``noise`` (a list), ``img_w`` ``[B, 3, S, S]``; ``layouts``."""
    import torch.distributed as dist

    from stylerenderer_tpu_torch.models import Discriminator, GeneratorWithMap
    from stylerenderer_tpu_torch.ops.rasterize_multi import rasterize_winners_multi
    from stylerenderer_tpu_torch.parallel import image_sharding, shard_image, split_mesh
    from stylerenderer_tpu_torch.parallel.spatial import band_rows

    sp = spec["spatial"]
    d = Discriminator(*sp["d"][0], **sp["d"][1], device=device)
    g = GeneratorWithMap(*sp["g"][0], **sp["g"][1], device=device)
    for net, key in ((d, "d_state"), (g, "g_state")):
        if key in sp:
            net.load_state_dict(sp[key], strict=True)
    x, x_w, img_w = (sp[k].to(device) for k in ("x", "x_w", "img_w"))
    z, vert, norm, tri = (sp[k].to(device) for k in ("z", "vert", "norm", "tri"))
    noise = [n.to(device) for n in sp["noise"]]
    d_params, g_params = ([p for n, p in net.named_parameters()
                           if sp.get(key) is None or n in sp[key]]
                          for net, key in ((d, "d_params"), (g, "g_params")))
    out = {}
    for nd, ns in sp["layouts"]:
        m = split_mesh(mesh, nd, ns)
        rows, band = image_sharding(m, x.shape[0], x.shape[2])
        res = {"data_index": m.data_index, "space_index": m.space_index, "n_data": m.n_data,
               "is_main": m.is_main,
               "n_space": m.n_space, "rows": rows, "band": band,
               "data_ranks": dist.get_process_group_ranks(m.data_group),
               "space_ranks": (dist.get_process_group_ranks(m.space_group)
                               if m.space_group is not None else None)}
        xb = shard_image(m, x).clone().requires_grad_(True)
        logits = d(xb, m)
        grads = torch.autograd.grad((logits[:, 0] * x_w[rows]).sum(), [xb] + d_params)
        res.update(logits=logits.detach().cpu(), d_x_grad=grads[0].cpu(),
                   d_grads=_cpu(m.average_gradients(grads[1:])))
        vr = vert[rows].clone().requires_grad_(True)
        nr = norm[rows].clone().requires_grad_(True)
        rasterize_winners_multi.launches = rasterize_winners_multi.band_launches = 0
        img = g([z[rows]], (vr, nr, tri), noise=noise, device_mesh=m)[0]
        res["k1"] = (rasterize_winners_multi.launches, rasterize_winners_multi.band_launches)
        gband = band_rows(m, img_w.shape[2])
        gs = torch.autograd.grad((img * img_w[rows][:, :, gband]).sum(), [vr, nr] + g_params)
        res.update(gband=gband, image=img.detach().cpu(), vert_grad=gs[0].cpu(), norm_grad=gs[1].cpu(),
                   g_grads=_cpu(m.average_gradients(gs[2:])))
        res["halo"] = _halo_check(m, device)
        res["layers"] = _layers_check(m, device)
        if sp.get("time"):
            res.update(_time_forward(g, [z[rows]], (vert[rows], norm[rows], tri), noise, m,
                                     sp["time"], device))
        out[f"{nd}x{ns}"] = res
    return out


def _halo_check(mesh, device):
    """``halo`` of one row a rank (a map of ``n_space`` rows) with 2 rows
    above and 3 below, reaching 2 and 3 ranks away -> (the padded band,
    the band's gradient of ``sum(padded * w)`` with ``w`` =
    ``arange(36).reshape(1, 2, 6, 3) + 100 * space_index``)."""
    from stylerenderer_tpu_torch.parallel.spatial import band_rows, halo

    h = mesh.n_space
    full = torch.arange(2.0 * h * 3, device=device).reshape(1, 2, h, 3) + 1
    band = full[:, :, band_rows(mesh, h)].clone().requires_grad_(True)
    padded = halo(band, 2, 3, mesh)
    w = torch.arange(36.0, device=device).reshape(1, 2, 6, 3) + 100 * mesh.space_index
    (gb,) = torch.autograd.grad((padded * w).sum(), band)
    return padded.detach().cpu(), gb.cpu()


def _layers_check(mesh, device):
    """Each banded layer on this rank's band of a seeded ``[2, 4, 16, 8]``
    map against the same layer on the whole map, cut to the band -> per
    layer (the output's and the band's gradient's largest error over the
    largest magnitude), the gradient of ``sum(out * w)`` for a seeded
    ``w``. Covers the forms D and the GAR do not reach: ``Downsample``, a
    lone ``Blur`` and the downsampling ``ModulatedConv2d``, beside the
    others."""
    from stylerenderer_tpu_torch.nn.layers import (
        Blur, ConvLayer, Downsample, EqualConv2d, ModulatedConv2d, Upsample,
    )
    from stylerenderer_tpu_torch.parallel.spatial import band_rows, sharded

    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 4, 16, 8, generator=gen).to(device)
    style = torch.randn(2, 8, generator=gen).to(device)
    torch.manual_seed(0)  # the layers' own draws, alike on every rank
    layers = {
        "EqualConv2d 3x3": (EqualConv2d(4, 3, 3, padding=1), False),
        "Blur": (Blur(pad=(2, 1)), False),
        "Upsample": (Upsample(), False),
        "Downsample": (Downsample(), False),
        "ConvLayer downsample": (ConvLayer(4, 3, 3, downsample=True), False),
        "ModulatedConv2d": (ModulatedConv2d(4, 3, 3, 8), True),
        "ModulatedConv2d upsample": (ModulatedConv2d(4, 3, 3, 8, upsample=True), True),
        "ModulatedConv2d downsample": (ModulatedConv2d(4, 3, 3, 8, downsample=True), True),
    }

    def rel(a, b):
        return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)

    out = {}
    for name, (layer, styled) in layers.items():
        layer = layer.to(device)
        args = (style,) if styled else ()
        whole = x.clone().requires_grad_(True)
        y = layer(whole, *args)
        w = torch.randn(y.shape, generator=gen).to(device)
        (gw,) = torch.autograd.grad((y * w).sum(), whole)
        rows, out_rows = band_rows(mesh, x.shape[2]), band_rows(mesh, y.shape[2])
        band = x[:, :, rows].clone().requires_grad_(True)
        with sharded(mesh):
            yb = layer(band, *args)
        (gb,) = torch.autograd.grad((yb * w[:, :, out_rows]).sum(), band)
        out[name] = (rel(yb.detach(), y.detach()[:, :, out_rows]), rel(gb, gw[:, :, rows]))
    return out


def _time_forward(g, styles, face, noise, mesh, n, device):
    """The GAR forward on ``mesh`` without gradient: its mean ms over ``n``
    after one warm-up (host clock, the device synchronized around) and the
    epilogue kernel's and upfirdn2d's launches in them, then one more with
    every collective timed alone."""
    from stylerenderer_tpu_torch.ops.fused_act import fused_bias_act
    from stylerenderer_tpu_torch.ops.upfirdn2d import upfirdn2d

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    with torch.no_grad():
        fused_bias_act.launches = upfirdn2d.launches = 0
        g(styles, face, noise=noise, device_mesh=mesh)
        mesh.barrier()
        sync()
        t0 = time.perf_counter()
        for _ in range(n):
            g(styles, face, noise=noise, device_mesh=mesh)
        sync()
        ms = (time.perf_counter() - t0) * 1e3 / n
        launches, ups = fused_bias_act.launches, upfirdn2d.launches
        mesh.barrier()
        totals, undo = timed_collectives(device)
        try:
            g(styles, face, noise=noise, device_mesh=mesh)
        finally:
            undo()
    return {"forward_ms": ms, "epilogue_launches": launches, "upfirdn2d_launches": ups,
            "collectives": dict(totals)}


SCENARIOS = {"helpers": _helpers, "stddev": _stddev, "step": _step, "screen": _screen,
             "spatial": _spatial}


def rank_main(rank: int, world: int, port: int, spec: dict, out_dir: str) -> None:
    """One rank: the mesh, ``spec["run"]``'s scenarios, ``rank{r}.pt``."""
    from stylerenderer_tpu_torch.parallel import make_mesh

    torch.set_num_threads(1)
    tf32 = spec.get("tf32", True)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    if spec.get("deterministic"):
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
        torch.use_deterministic_algorithms(True)
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    # with ``one_card`` every rank shares the card of local rank 0
    mesh = make_mesh(spec["device"], rank=rank, world_size=world,
                     local_rank=0 if spec.get("one_card") else rank,
                     backend=spec.get("backend"), init_method=f"tcp://localhost:{port}")
    try:
        out = {name: SCENARIOS[name](mesh, spec, mesh.device) for name in spec["run"]}
        out["device"] = str(mesh.device)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        mesh.destroy()

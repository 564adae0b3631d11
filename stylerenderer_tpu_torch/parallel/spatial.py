"""Spatial sharding over the mesh's ``'space'`` axis: the space collectives,
the halo exchange and the row plans of the banded layers. In the JAX
package, GSPMD inserts all of this when a feature map is sharded
``P('data', 'space')`` (``stylerenderer_tpu/parallel/mesh.py::
image_sharding``); the port has no GSPMD, so it writes them.

Layout. On a 2-D mesh (``parallel/mesh.py::make_mesh_2d``) a rank holds
``[B / n_data, C, H / n_space, W]`` of every feature map: its band, the
rows ``band_rows(mesh, H)``. A spatial op (a conv, a blur, a resample)
whose output row reads input rows around it takes the rows it lacks from
the neighbouring ranks (``halo``; zeros past the image's top and bottom
edges, where the whole image's op pads with zeros), runs with its H
padding replaced by the plan's (``band_ops``: negative pads crop), and
gives exactly its band of the whole image's output rows. A halo may reach
past one neighbour (a 1-row band under a 2-row pad): each rank then
contributes its whole band, so the exchange is one ``all_gather`` either
way. Only ``all_gather`` and ``all_reduce`` are used, which gloo and NCCL
both take on CUDA tensors.

How layers find the mesh. The models' entry points take it explicitly
(``Discriminator.forward(x, mesh)``, ``GeneratorWithMap.forward(...,
device_mesh=)``) and run their layers inside ``sharded(mesh)``, where
``active()`` returns it; layers outside any ``sharded`` run unbanded, as
before. A context (JAX's ``with mesh:``) rather than an argument of every
layer, because ``ConvLayer`` is an ``nn.Sequential`` (its state-dict
names are the reference's) whose ``forward`` takes one argument, and a
block's layers would otherwise all thread it. Autograd's backward needs no
context: every collective keeps its mesh. A recompute under
``torch.utils.checkpoint`` runs in the backward, outside the context, so
the generator enters it again there (``models/generator.py::_styled``).

The adjoint convention. A value replicated over ``'space'`` carries the
WHOLE cotangent on every space rank. Hence:

- ``gather_space`` (the band's rows of every rank, along H) has as
  adjoint the rank's own slice (``_SliceSpace``), not a sum;
- ``sum_space`` (an all-reduce of partial values, such as the stddev's
  sum over a band) has the identity as adjoint;
- a replicated value used in band compute gets only its band's share of
  the cotangent. Where a collective's output re-enters band compute (the
  stddev channel), or where a model input leaves (the GAR's latents and
  mesh vertices), ``enter_band`` sums those shares over ``'space'``: its
  forward is the identity and its adjoint ``sum_space``'s forward. A
  replicated parameter used in band compute keeps its partial gradient,
  which ``Mesh.average_gradients`` sums over ``'space'`` (and averages
  over ``'data'``);
- a parameter used in replicated compute downstream of a gather (D's
  ``final_linear``) would get the whole gradient on every space rank, and
  ``average_gradients``' sum would make it ``n_space`` times too large:
  ``replicated_linear`` and ``split_grad`` hand it ``1 / n_space`` of its
  first-order gradient instead (through ``replicated_linear`` the
  gradient in the input stays whole, so a gradient of a gradient that
  flows into the weight, R1's, is the band's share as everywhere else).

Each collective is an ``autograd.Function`` whose backward is its
adjoint's Function, so gradients of any order pass through them.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch
import torch.distributed as dist
import torch.nn.functional as F

_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("space_mesh", default=None)


def band_rows(mesh, h: int) -> slice:
    """This rank's rows of an ``h``-row map over ``'space'``; raises unless
    ``n_space`` divides ``h``."""
    n = mesh.n_space
    if h % n:
        raise ValueError(f"{h} rows do not split into {n} bands over 'space'")
    b = h // n
    return slice(mesh.space_index * b, (mesh.space_index + 1) * b)


@contextlib.contextmanager
def sharded(mesh):
    """Run the layers inside with feature maps banded over ``mesh``'s
    ``'space'`` axis (nothing changes for ``None`` or ``n_space == 1``)."""
    token = _ACTIVE.set(mesh if mesh is not None and mesh.n_space > 1 else None)
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def active():
    """The mesh of the innermost ``sharded`` with ``n_space > 1``, else
    ``None``."""
    return _ACTIVE.get()


# ---- the row plans of the banded layers ---------------------------------------

def _needed(op, lo: int, hi: int) -> tuple[int, int]:
    """Input rows ``[ilo, ihi)`` that output rows ``[lo, hi)`` of the 1-D op
    ``(up, down, k, pad0)`` read (upfirdn's semantics along H: zero-stuff
    by ``up``, pad ``pad0`` before, correlate with a ``k`` tap kernel,
    keep every ``down``-th row)."""
    up, down, k, p0 = op
    return -((p0 - lo * down) // up), ((hi - 1) * down + k - 1 - p0) // up + 1


def pad_rows(x: torch.Tensor, q0: int, q1: int) -> torch.Tensor:
    """``x`` with ``q0`` zero rows before and ``q1`` after along H; a
    negative count crops."""
    h = x.shape[2]
    x = x[:, :, max(-q0, 0):h - max(-q1, 0)]
    if q0 > 0 or q1 > 0:
        x = F.pad(x, [0, 0, max(q0, 0), max(q1, 0)])
    return x


def band_ops(x: torch.Tensor, ops, h_out: int, mesh):
    """Plan and exchange for a chain of ops along H on this rank's band
    ``x`` ``[B, C, h, W]`` of an ``h * n_space``-row map, whose last op
    gives ``h_out`` rows in all -> (``x`` with its halo, the H pads
    ``(q0, q1)`` of each op). Run op ``j`` on the previous op's output with
    its H pads replaced by ``pads[j]`` (its W padding unchanged) and the
    last gives this rank's rows ``band_rows(mesh, h_out)`` of the whole
    map's result.

    ``ops``: ``(up, down, k, pad0)`` per op, in order (``pad0``: the whole
    map's H padding before). A transposed conv of stride ``s`` and ``k``
    taps is ``(s, 1, k, k - 1)``."""
    h = x.shape[2]
    out = band_rows(mesh, h_out)
    ranges = [(out.start, out.stop)]
    for op in reversed(ops):
        ranges.append(_needed(op, *ranges[-1]))
    ranges.reverse()
    i0 = mesh.space_index * h
    above, below = max(i0 - ranges[0][0], 0), max(ranges[0][1] - i0 - h, 0)
    ranges[0] = (i0 - above, i0 + h + below)
    pads = []
    for (up, down, k, p0), (ilo, ihi), (olo, ohi) in zip(ops, ranges, ranges[1:]):
        q0 = ilo * up - olo * down + p0
        pads.append((q0, (ohi - olo - 1) * down + k - (ihi - ilo) * up - q0))
    return halo(x, above, below, mesh), pads


# ---- the collectives --------------------------------------------------------------

def _gather_parts(x: torch.Tensor, mesh) -> list:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.n_space)]
    dist.all_gather(parts, x, group=mesh.space_group)
    return parts


def _halo_rows(n: int, h: int, above: int, below: int, q: int) -> list:
    """The whole map's rows of rank ``q``'s halo: ``above`` rows before its
    band, then ``below`` after (rows outside ``[0, n h)`` are past the
    edges)."""
    return list(range(q * h - above, q * h)) + list(range((q + 1) * h, (q + 1) * h + below))


def _halo(x, above, below, mesh):
    """Forward of ``halo``: one all-gather of every rank's edge rows (its
    first ``min(below, h)`` rows, which the ranks above read, then its last
    ``min(above, h)``, which the ranks below read)."""
    b, c, h, w = x.shape
    na, nb = min(above, h), min(below, h)
    parts = _gather_parts(torch.cat([x[:, :, :nb], x[:, :, h - na:]], 2), mesh)
    e = na + nb
    flat = torch.cat(parts + [x.new_zeros(b, c, 1, w)], 2)  # the zero row past the edges
    idx = []
    for g in _halo_rows(mesh.n_space, h, above, below, mesh.space_index):
        if not 0 <= g < mesh.n_space * h:
            idx.append(mesh.n_space * e)
            continue
        q, r = divmod(g, h)
        idx.append(q * e + (r if r < nb else nb + r - (h - na)))
    rows = flat.index_select(2, torch.tensor(idx, device=x.device))
    return torch.cat([rows[:, :, :above], x, rows[:, :, above:]], 2)


def _halo_adjoint(g, above, below, mesh):
    """Forward of ``_HaloAdjoint``: each rank's halo rows' cotangents go to
    the ranks that own those rows (one all-gather) and are added to their
    own rows, rank by rank in order."""
    h = g.shape[2] - above - below
    own = g[:, :, above:above + h].clone()
    parts = _gather_parts(torch.cat([g[:, :, :above], g[:, :, above + h:]], 2), mesh)
    lo = mesh.space_index * h
    for q, part in enumerate(parts):
        pairs = [(i, r - lo) for i, r in enumerate(_halo_rows(mesh.n_space, h, above, below, q))
                 if lo <= r < lo + h]
        if pairs:
            src, dst = (torch.tensor(v, device=g.device) for v in zip(*pairs))
            own.index_add_(2, dst, part.index_select(2, src))
    return own


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, above, below, mesh):
        ctx.args = (above, below, mesh)
        return _halo(x, above, below, mesh)

    @staticmethod
    def backward(ctx, g):
        return _HaloAdjoint.apply(g, *ctx.args), None, None, None


class _HaloAdjoint(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g, above, below, mesh):
        ctx.args = (above, below, mesh)
        return _halo_adjoint(g, above, below, mesh)

    @staticmethod
    def backward(ctx, gg):
        return _Halo.apply(gg, *ctx.args), None, None, None


def halo(x: torch.Tensor, above: int, below: int, mesh) -> torch.Tensor:
    """The band ``x`` ``[B, C, h, W]`` with ``above`` rows of the ranks
    before it on top and ``below`` rows of the ranks after it underneath
    (zeros past the image's edges) -> ``[B, C, above + h + below, W]``,
    differentiable: the adjoint sends each halo row's cotangent back to
    the rank that owns the row and adds it there."""
    if above == 0 and below == 0:
        return x
    return _Halo.apply(x, above, below, mesh)


class _GatherSpace(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return torch.cat(_gather_parts(x, mesh), 2)

    @staticmethod
    def backward(ctx, g):
        return _SliceSpace.apply(g, ctx.mesh), None


class _SliceSpace(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x[:, :, band_rows(mesh, x.shape[2])].clone()

    @staticmethod
    def backward(ctx, g):
        return _GatherSpace.apply(g, ctx.mesh), None


def gather_space(x: torch.Tensor, mesh) -> torch.Tensor:
    """Every space rank's band of ``x`` ``[B, C, h, W]`` along H, in rank
    order -> the whole map, replicated over ``'space'``; the adjoint is
    the rank's own rows of the (whole) cotangent."""
    return _GatherSpace.apply(x, mesh)


class _SumSpace(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        total = x.contiguous().clone()
        dist.all_reduce(total, group=mesh.space_group)
        return total

    @staticmethod
    def backward(ctx, g):
        return _EnterBand.apply(g, ctx.mesh), None


class _EnterBand(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _SumSpace.apply(g, ctx.mesh), None


def sum_space(x: torch.Tensor, mesh) -> torch.Tensor:
    """The sum over ``'space'`` of the ranks' partial ``x``, replicated;
    the adjoint is the identity (the replicated sum's cotangent is whole
    on every rank)."""
    return _SumSpace.apply(x, mesh)


def enter_band(x: torch.Tensor, mesh) -> torch.Tensor:
    """A replicated ``x`` about to be used in band compute: the identity,
    whose adjoint sums the ranks' partial cotangents over ``'space'``, so
    that ``x``'s cotangent is whole again on every rank."""
    return _EnterBand.apply(x, mesh)


class _SplitGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, n):
        ctx.n = n
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * (1.0 / ctx.n), None


def split_grad(p: torch.Tensor, mesh) -> torch.Tensor:
    """A parameter used in replicated compute: the identity, whose gradient
    is ``1 / n_space`` of the whole one, so that ``average_gradients``' sum
    over ``'space'`` gives the whole."""
    return _SplitGrad.apply(p, mesh.n_space)


class _ReplicatedLinear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, n):
        ctx.save_for_backward(x, w)
        ctx.n = n
        return F.linear(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gw = (g.t() @ x) * (1.0 / ctx.n) if ctx.needs_input_grad[1] else None
        return g @ w, gw, None


def replicated_linear(x: torch.Tensor, w: torch.Tensor, mesh) -> torch.Tensor:
    """``F.linear(x, w)`` (no bias) on a replicated ``x``: the gradient in
    ``x`` is whole, the first-order gradient in ``w`` is ``1 / n_space`` of
    the whole (see the module's adjoint convention)."""
    return _ReplicatedLinear.apply(x, w, mesh.n_space)

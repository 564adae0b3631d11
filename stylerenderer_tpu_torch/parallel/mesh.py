"""Process groups, batch sharding and the train step's collectives over
``torch.distributed`` (counterpart of ``stylerenderer_tpu/parallel/mesh.py``).

The JAX package builds a ``Mesh('data')`` over its devices, shards the
batch along it, replicates the parameters and jits the step: GSPMD then
inserts every reduction, and the step has the semantics of the global
batch. The port runs one process per card (``torch.distributed.run``).
A ``Mesh`` is the process group with the rank's place in it; the global
batch is split in contiguous blocks of rows, rank ``r`` holding
``[r B/W, (r+1) B/W)`` (JAX's ``P('data')``); replicated state is
broadcast from rank 0; and the train step calls the collectives that
GSPMD would have inserted:

- ``Mesh.average_gradients``: one flat buffer per dtype and update, one
  ``all_reduce``, divided by the world size;
- ``Mesh.all_reduce_``: detached statistics and the finite flag;
- ``Mesh.gather_rows``: the rows of every rank, in rank order, with
  gradient. Its backward sums the cotangents of every rank and keeps the
  rank's rows; the two are ``autograd.Function``s that are each other's
  adjoint, so a gradient of a gradient (R1 through D's stddev channel)
  goes through them too, on gloo and NCCL alike.

G and D are not wrapped in ``DistributedDataParallel``: DDP averages
gradients in the hooks of ``.backward()``, and the step takes each
gradient with ``torch.autograd.grad``, where DDP would reduce nothing and
every rank would train alone.

Without a launcher, ``make_mesh`` gives world 1 with no group: every
collective is then the identity and the step is the one-process step.

``make_mesh_2d(n_data, n_space)`` lays the world out as JAX's
``make_mesh_2d`` does, ``reshape(n_data, n_space)`` over the axes
``('data', 'space')``: global rank ``r`` has data index ``r // n_space``
and space index ``r % n_space``, with a process group over each row
(``space_group``, the ranks of one data index) and each column
(``data_group``). The batch is split over ``'data'`` as above (``rows``,
``gather_rows`` and ``batch_sharding`` use the data group), and the
feature maps' rows over ``'space'`` (``image_sharding``;
``parallel/spatial.py`` holds the space collectives, the halo exchanges
and the adjoint convention). A 1-D mesh is ``n_space == 1``.
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

from stylerenderer_tpu_torch.device import resolve_device
from stylerenderer_tpu_torch.parallel.spatial import band_rows

_LAUNCHER_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK")


@dataclasses.dataclass
class Mesh:
    """A rank's place in the data-parallel group: ``group`` is ``None`` for
    one process without a launcher; ``device`` is ``cuda:LOCAL_RANK`` or
    the CPU."""

    rank: int = 0
    world: int = 1
    local_rank: int = 0
    device: torch.device = dataclasses.field(default_factory=lambda: torch.device("cpu"))
    group: object | None = None
    backend: str | None = None
    n_space: int = 1
    # the ranks of this rank's column (one space index) and row (one data
    # index); on a 1-D mesh the data group is ``group`` and there is none
    data_group: object | None = None
    space_group: object | None = None

    @property
    def is_main(self) -> bool:
        """Rank 0: the rank that writes logs, sample grids and checkpoints."""
        return self.rank == 0

    @property
    def n_data(self) -> int:
        return self.world // self.n_space

    @property
    def data_index(self) -> int:
        return self.rank // self.n_space

    @property
    def space_index(self) -> int:
        return self.rank % self.n_space

    def rows(self, batch: int) -> slice:
        """The rows of a global batch of ``batch`` that this rank holds."""
        return batch_sharding(self, batch)

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Every data rank's ``x`` concatenated along dim 0 in rank order,
        differentiable (the identity without a group)."""
        if self.data_group is None:
            return x
        return _GatherRows.apply(x, self)

    def all_reduce_(self, t: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
        """``t`` reduced over the ranks in place (outside autograd)."""
        if self.group is not None:
            dist.all_reduce(t, op=op, group=self.group)
        return t

    def average_gradients(self, grads) -> list:
        """The mean over the data ranks of each gradient: per dtype one flat
        buffer and one ``all_reduce`` over the world, divided by ``n_data``,
        then views of it. On a 2-D mesh that is a sum over ``'space'`` (a
        rank's gradient is its band's share) and a mean over ``'data'``."""
        grads = list(grads)
        if self.group is None:
            return grads
        by_dtype: dict = {}
        for i, g in enumerate(grads):
            by_dtype.setdefault(g.dtype, []).append(i)
        for idx in by_dtype.values():
            flat = torch.cat([grads[i].reshape(-1) for i in idx])
            dist.all_reduce(flat, group=self.group)
            flat.div_(self.n_data)
            for i, piece in zip(idx, flat.split([grads[i].numel() for i in idx])):
                grads[i] = piece.view_as(grads[i])
        return grads

    def broadcast_(self, tensors) -> list:
        """Rank 0's values of ``tensors`` on every rank, in place: one
        broadcast per (device, dtype), staged through the card for host
        tensors under NCCL."""
        tensors = list(tensors)
        if self.group is None or not tensors:
            return tensors
        by_kind: dict = {}
        for t in tensors:
            by_kind.setdefault((t.device, t.dtype), []).append(t)
        with torch.no_grad():
            for (device, _), ts in by_kind.items():
                flat = torch.cat([t.reshape(-1) for t in ts])
                if self.backend == "nccl" and device.type != "cuda":
                    flat = flat.to(self.device)
                dist.broadcast(flat, 0, group=self.group)
                for t, piece in zip(ts, flat.split([t.numel() for t in ts])):
                    t.copy_(piece.view_as(t))
        return tensors

    def barrier(self) -> None:
        if self.group is not None:
            dist.barrier(group=self.group)

    def destroy(self) -> None:
        """Destroy the process group that ``make_mesh`` created."""
        if self.group is not None:
            dist.destroy_process_group(self.group)
            self.group = None


def _all_gather(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.n_data)]
    dist.all_gather(parts, x, group=mesh.data_group)
    return torch.cat(parts)


def _sum_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    total = x.contiguous().clone()
    dist.all_reduce(total, group=mesh.data_group)
    n = x.shape[0] // mesh.n_data
    return total[mesh.data_index * n:(mesh.data_index + 1) * n].clone()


class _GatherRows(torch.autograd.Function):
    """All-gather along dim 0; adjoint: ``_SumRows``."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _all_gather(x, mesh)

    @staticmethod
    def backward(ctx, grad):
        return _SumRows.apply(grad, ctx.mesh), None


class _SumRows(torch.autograd.Function):
    """All-reduce (sum) of a global tensor, then the rank's rows; adjoint:
    ``_GatherRows``."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _sum_rows(x, mesh)

    @staticmethod
    def backward(ctx, grad):
        return _GatherRows.apply(grad, ctx.mesh), None


def make_mesh(device="cuda", *, rank: int | None = None, world_size: int | None = None,
              local_rank: int | None = None, backend: str | None = None,
              init_method: str = "env://") -> Mesh:
    """The data-parallel group of this process.

    ``rank`` and ``world_size`` (and ``local_rank``, default ``rank``) are
    given, or read from ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` as
    ``torch.distributed.run`` sets them (with ``MASTER_ADDR`` and
    ``MASTER_PORT`` for ``init_method="env://"``). With none of them set
    the mesh is world 1 with no group; with some but not all set it
    raises. ``device`` names the device type (``"cuda"`` unless asked
    otherwise); a rank's device is ``cuda:LOCAL_RANK``. The backend is
    NCCL on the card and gloo on the CPU unless ``backend`` is given.
    Nothing falls back to another device or backend."""
    dev_type = resolve_device(torch.device(device).type).type
    if rank is None and world_size is None:
        found = {k: os.environ.get(k) for k in _LAUNCHER_VARS}
        if not any(found.values()):
            return Mesh(device=resolve_device(device))
        missing = [k for k, v in found.items() if not v]
        if missing:
            raise RuntimeError(f"launcher environment half set: {', '.join(missing)} missing "
                               f"beside {', '.join(k for k in found if k not in missing)}")
        rank, world_size, local_rank = (int(found[k]) for k in _LAUNCHER_VARS)
    elif rank is None or world_size is None:
        raise ValueError("give both rank and world_size, or neither")
    local_rank = rank if local_rank is None else local_rank
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} outside a world of {world_size}")
    if dist.is_initialized():
        raise RuntimeError("a default process group is already initialized")
    if dev_type == "cuda":
        dev = torch.device("cuda", local_rank)
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
    backend = backend or ("nccl" if dev_type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size)
    return Mesh(rank=rank, world=world_size, local_rank=local_rank, device=dev,
                group=dist.group.WORLD, backend=backend, data_group=dist.group.WORLD)


def make_mesh_2d(n_data: int, n_space: int, device="cuda", *, rank: int | None = None,
                 world_size: int | None = None, local_rank: int | None = None,
                 backend: str | None = None, init_method: str = "env://") -> Mesh:
    """The ``n_data x n_space`` mesh of this process over the axes
    ``('data', 'space')`` (JAX's ``make_mesh_2d``): ``make_mesh``'s group,
    arguments and launcher variables, laid out by ``split_mesh``. Raises
    unless the world has ``n_data * n_space`` ranks (before any group is
    made, when ``world_size`` is given). With ``n_space == 1`` it is
    ``make_mesh``'s mesh."""
    if n_data < 1 or n_space < 1:
        raise ValueError(f"a {n_data} x {n_space} mesh")
    if world_size is not None and world_size != n_data * n_space:
        raise ValueError(f"a {n_data} x {n_space} mesh needs {n_data * n_space} ranks, "
                         f"not {world_size}")
    mesh = make_mesh(device, rank=rank, world_size=world_size, local_rank=local_rank,
                     backend=backend, init_method=init_method)
    try:
        return split_mesh(mesh, n_data, n_space)
    except ValueError:
        mesh.destroy()
        raise


def split_mesh(mesh: Mesh, n_data: int, n_space: int) -> Mesh:
    """``mesh``'s world laid out as ``n_data x n_space`` -> a new ``Mesh``
    over the same world group with a data group for each space index and
    a space group for each data index (every rank makes every group, in
    one order, as ``dist.new_group`` asks). ``n_space == 1`` gives the 1-D
    mesh: ``mesh`` itself. Raises unless ``n_data * n_space`` is the
    world."""
    if n_data * n_space != mesh.world:
        raise ValueError(f"a {n_data} x {n_space} mesh needs {n_data * n_space} ranks, "
                         f"not {mesh.world}")
    if n_space == 1:
        return mesh
    data_group = space_group = None
    for d in range(n_data):
        g = dist.new_group([d * n_space + s for s in range(n_space)])
        if d == mesh.rank // n_space:
            space_group = g
    for s in range(n_space):
        g = dist.new_group([d * n_space + s for d in range(n_data)])
        if s == mesh.rank % n_space:
            data_group = g
    return dataclasses.replace(mesh, n_space=n_space, data_group=data_group,
                               space_group=space_group)


def batch_sharding(mesh: Mesh, batch: int) -> slice:
    """Data rank ``d``'s rows ``[d B/D, (d+1) B/D)`` of a global batch of
    ``batch`` over ``D = n_data`` data ranks (JAX's ``P('data')``); raises
    unless D divides it."""
    if batch % mesh.n_data:
        raise ValueError(f"batch {batch} not divisible by {mesh.n_data} ranks")
    n = batch // mesh.n_data
    return slice(mesh.data_index * n, (mesh.data_index + 1) * n)


def image_sharding(mesh: Mesh, batch: int, height: int) -> tuple[slice, slice]:
    """This rank's ``(rows, band)`` of a global ``[batch, C, height, W]``
    image batch: its rows of the batch over ``'data'`` and its rows of the
    image over ``'space'`` (JAX's ``P('data', 'space')`` on NHWC's dims 0
    and 1, here NCHW's 0 and 2)."""
    return batch_sharding(mesh, batch), band_rows(mesh, height)


def shard_image(mesh: Mesh, images: torch.Tensor) -> torch.Tensor:
    """This rank's block ``[B/n_data, C, H/n_space, W]`` of a global
    ``[B, C, H, W]`` batch."""
    rows, band = image_sharding(mesh, images.shape[0], images.shape[2])
    return images[rows, :, band]


def replicated(mesh: Mesh, tensors) -> list:
    """``tensors`` made equal on every rank: rank 0's values, in place."""
    return mesh.broadcast_(tensors)


def shard_batch(mesh: Mesh, batch):
    """The rank's rows of a global batch: a tensor or a list, tuple or dict
    of them, each sliced along dim 0."""
    if isinstance(batch, torch.Tensor):
        return batch[mesh.rows(batch.shape[0])]
    if isinstance(batch, dict):
        return {k: shard_batch(mesh, v) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(shard_batch(mesh, v) for v in batch)
    raise TypeError(f"cannot shard a {type(batch).__name__}")


def _replicate_tensors(obj, seen: set) -> list:
    """The tensors of ``obj`` that ``replicate`` broadcasts."""
    if id(obj) in seen:
        return []
    seen.add(id(obj))
    if isinstance(obj, torch.Tensor):
        return [obj.data]
    if isinstance(obj, torch.nn.Module):
        return [t.data for t in list(obj.parameters()) + list(obj.buffers())]
    if isinstance(obj, torch.optim.Optimizer):
        return [t for st in obj.state.values() for t in st.values()
                if isinstance(t, torch.Tensor)]
    if isinstance(obj, dict):
        return [t for v in obj.values() for t in _replicate_tensors(v, seen)]
    if isinstance(obj, (list, tuple)):
        return [t for v in obj for t in _replicate_tensors(v, seen)]
    return []


def replicate(mesh: Mesh, tree):
    """Rank 0's copy of ``tree`` on every rank, in place -> ``tree``. A
    ``TrainState`` (any dataclass), module, optimizer, tensor, or list,
    tuple or dict of them: parameters, buffers, optimizer state, 0-d
    statistics, ``torch.Generator`` states and the dataclass's int fields
    (the step counters)."""
    if mesh.group is None:
        return tree
    fields = ([getattr(tree, f.name) for f in dataclasses.fields(tree)]
              if dataclasses.is_dataclass(tree) else [tree])
    mesh.broadcast_(_replicate_tensors(fields, set()))
    for gen in (f for f in fields if isinstance(f, torch.Generator)):
        state = mesh.broadcast_([gen.get_state()])[0]
        gen.set_state(state)
    if dataclasses.is_dataclass(tree):
        ints = [f.name for f in dataclasses.fields(tree)
                if type(getattr(tree, f.name)) is int]
        values = torch.tensor([getattr(tree, n) for n in ints], dtype=torch.int64)
        for n, v in zip(ints, mesh.broadcast_([values])[0].tolist()):
            setattr(tree, n, v)
    return tree


def constrain_batch(x: torch.Tensor, mesh: Mesh | None = None,
                    batch: int | None = None) -> torch.Tensor:
    """``x``, checked to hold this rank's rows of a global batch of
    ``batch``. The identity: in the JAX package this is a sharding
    constraint inside the jitted step, telling GSPMD to keep a batch-major
    intermediate split over ``'data'``. Here every rank's tensors already
    hold only its rows (each process computes on its own block), so there
    is nothing to place; only the leading dimension can be wrong."""
    if mesh is not None and batch is not None:
        rows = mesh.rows(batch)
        if x.shape[0] != rows.stop - rows.start:
            raise ValueError(f"leading dim {x.shape[0]}: rank {mesh.rank} holds "
                             f"{rows.stop - rows.start} of {batch} rows")
    return x

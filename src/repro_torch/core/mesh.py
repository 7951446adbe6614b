"""Device-mesh plumbing for the mesh tier: one process per rank under
``torch.distributed``.

The reference runs one SPMD program over a JAX ``Mesh`` (``shard_map``).
The port runs the same program in every rank's process: a "mesh" is a
``torch.distributed.device_mesh.DeviceMesh`` with named dimensions (for
example ``("pod", "data")``), every rank calls the same entry point with
its own shard, and the collectives go through each named dimension's
process group.

* :func:`init_mesh` / :func:`pick_backend` — start a rank and build its
  mesh; the caller names the backend (``nccl`` where each rank owns a
  card, ``gloo`` for CPU ranks or ranks that share one card) and no code
  switches backend on failure;
* :func:`make_embed_mesh` / :func:`resolve_mesh` — the 1-D embed mesh
  ``SnsConfig.embed_mesh`` names (``None`` | the world size | a ready
  ``DeviceMesh``);
* :func:`linear_index` — a rank's row-major index over named dimensions,
  the r-th contiguous row block of a sharded global array (the
  reference's ``P(axes)`` layout);
* :func:`axis_size` / :func:`row_block` — row-block sizing;
* :func:`all_reduce` / :func:`all_gather` — the collectives, over one
  dimension or, innermost first, over several;
* :func:`all_gather_dim` / :func:`reduce_scatter_dim` — the LM mesh
  tier's pair along a tensor dimension (FSDP's weight gather and its
  gradient's reduce-scatter), and :func:`block` — a rank's block of a
  dimension;
* :class:`count_collectives` — while open, a record of every call of
  the four collectives above (its kind, axis, result bytes, and whether
  its group spans more than one host), for the dry run's counts.

Staging: a gloo group takes host tensors, so every collective over a
gloo group copies a card tensor to the host, runs there and copies the
result back; an nccl group takes the card tensors as they are.  The rule
follows the group's backend and is the same on every path.  Booleans
travel as uint8.
"""
from __future__ import annotations

import datetime
from typing import List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

# the 1-D mesh dimension the sharded embed stage runs over
EMBED_AXIS = "embed"

Axes = Union[str, Sequence[str]]


def pick_backend(device, ranks_per_card: int = 1) -> str:
    """The backend for ranks whose tensors live on ``device``: ``nccl``
    when each rank owns a card, ``gloo`` for CPU ranks or ranks that share
    one card (NCCL refuses two ranks on one GPU)."""
    dev = torch.device(device)
    return "nccl" if dev.type == "cuda" and ranks_per_card == 1 else "gloo"


def init_mesh(rank: int, world_size: int, init_method: str,
              shape: Sequence[int], names: Sequence[str], *, backend: str,
              timeout_s: float = 300.0):
    """Join the default process group as ``rank`` of ``world_size``
    (``init_method`` e.g. ``file:///tmp/dir/rendezvous``) with the named
    ``backend`` and build a ``DeviceMesh`` of ``shape`` over all ranks,
    row-major, with dimension ``names``.  An nccl rank sets its card
    (``torch.cuda.set_device``) before calling this.  Collectives that
    wait longer than ``timeout_s`` raise."""
    from torch.distributed.device_mesh import DeviceMesh
    if int(torch.tensor(shape).prod()) != world_size:
        raise ValueError(f"mesh shape {tuple(shape)} does not hold "
                         f"{world_size} ranks")
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s))
    return DeviceMesh("cuda" if backend == "nccl" else "cpu",
                      torch.arange(world_size).reshape(tuple(shape)),
                      mesh_dim_names=tuple(names))


def make_embed_mesh(n_ranks: Optional[int] = None, axis: str = EMBED_AXIS):
    """A 1-D mesh over every rank of the default group, the topology the
    row-block-sharded embed stage runs on.  Every rank runs the program,
    so ``n_ranks`` (default: the world size) must be the world size."""
    from torch.distributed.device_mesh import DeviceMesh
    if not dist.is_initialized():
        raise ValueError("an embed mesh needs torch.distributed initialized "
                         "(see mesh.init_mesh)")
    world = dist.get_world_size()
    n = world if n_ranks is None else int(n_ranks)
    if n != world:
        raise ValueError(f"embed mesh wants {n} ranks; the default group "
                         f"has {world}")
    dev_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(dev_type, torch.arange(n), mesh_dim_names=(axis,))


def resolve_mesh(spec, axis: str = EMBED_AXIS):
    """Normalize ``SnsConfig.embed_mesh``: ``None`` stays single-device,
    an int builds a 1-D mesh over that many ranks (the world size), a
    ``DeviceMesh`` passes through as is (its first dimension is the embed
    dimension)."""
    from torch.distributed.device_mesh import DeviceMesh
    if spec is None:
        return None
    if isinstance(spec, DeviceMesh):
        return spec
    if isinstance(spec, int) and not isinstance(spec, bool):
        return make_embed_mesh(spec, axis=axis)
    raise TypeError(f"embed_mesh must be None, a rank count, or a "
                    f"DeviceMesh; got {spec!r}")


def as_axes(axes: Axes) -> Tuple[str, ...]:
    """One dimension name or several -> a tuple of names."""
    return (axes,) if isinstance(axes, str) else tuple(axes)


def check_axes(mesh, axes: Axes) -> Tuple[str, ...]:
    """``axes`` as a tuple after checking that ``mesh`` is a
    ``DeviceMesh`` holding every one of them."""
    from torch.distributed.device_mesh import DeviceMesh
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a torch.distributed DeviceMesh "
                        f"(see mesh.init_mesh); got {mesh!r}")
    axes = as_axes(axes)
    for a in axes:
        _dim(mesh, a)
    return axes


def _dim(mesh, axis: str) -> int:
    names = mesh.mesh_dim_names or ()
    if axis not in names:
        raise ValueError(f"mesh has no dimension {axis!r}; it has {names}")
    return names.index(axis)


def mesh_axis(mesh) -> str:
    """The first dimension's name: the axis a 1-D embed mesh shards over."""
    return mesh.mesh_dim_names[0]


def axis_size(mesh, axes: Axes) -> int:
    """Total rank count along one dimension or a sequence of them."""
    n = 1
    for a in as_axes(axes):
        n *= mesh.shape[_dim(mesh, a)]
    return n


def linear_index(mesh, axes: Axes) -> int:
    """This rank's row-major index over ``axes``: its row block of a
    global array sharded over them (the reference's ``mesh.linear_index``
    under ``P(axes)``)."""
    idx = 0
    for a in as_axes(axes):
        idx = idx * mesh.shape[_dim(mesh, a)] + mesh.get_local_rank(a)
    return idx


def row_block(n: int, n_shards: int) -> Tuple[int, int]:
    """(rows_per_shard, n_padded) for ``n`` rows over ``n_shards``
    ranks, ``n_padded = rows_per_shard · n_shards ≥ n``: shard s owns
    global rows [s·rows_per_shard, (s+1)·rows_per_shard), the tail rows
    are padding."""
    rows_per = -(-n // n_shards)
    return rows_per, rows_per * n_shards


# the tensor collectives' names moved in torch 2.13; either takes the
# same arguments
_GATHER_INTO = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_SCATTER_FROM = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor

_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
               "min": dist.ReduceOp.MIN}


# the open count_collectives contexts (empty: the wrappers record nothing)
_COUNTERS: List["count_collectives"] = []
# cards a host: a collective's group crosses hosts when its global ranks
# do not all lie in one block of this many
HOST_RANKS = 8


class count_collectives:
    """Context manager: every call of :func:`all_reduce`,
    :func:`all_gather`, :func:`all_gather_dim` and
    :func:`reduce_scatter_dim` while it is open, one entry a collective
    (a wrapper over several axes makes one a dimension): ``calls`` holds
    ``[kind, axis, bytes, crosses_host]`` with the reference's dry-run
    conventions (``repro.launch.dryrun.collective_bytes_from_hlo``): the
    kind as XLA names it ("all-reduce", "all-gather", "reduce-scatter")
    and the bytes of the collective's result (the gathered tensor, the
    reduced one, the scattered part).  A group crosses a host when its
    global ranks do not all lie in one block of :data:`HOST_RANKS`.
    Closed, it costs the wrappers one test of an empty list."""

    def __init__(self):
        self.calls: List[list] = []

    def __enter__(self):
        _COUNTERS.append(self)
        return self

    def __exit__(self, *exc):
        _COUNTERS.remove(self)
        return False

    def summary(self) -> dict:
        """Bytes by kind, in all and across hosts, and the call count."""
        per_kind: dict = {}
        for kind, _, nbytes, _ in self.calls:
            per_kind[kind] = per_kind.get(kind, 0) + nbytes
        return {"per_kind": per_kind, "total": sum(per_kind.values()),
                "cross_host": sum(c[2] for c in self.calls if c[3]),
                "num_ops": len(self.calls)}


def _note(kind: str, axis: str, group, result: torch.Tensor) -> None:
    ranks = dist.get_process_group_ranks(group)
    crosses = min(ranks) // HOST_RANKS != max(ranks) // HOST_RANKS
    for c in _COUNTERS:
        c.calls.append([kind, axis, result.numel() * result.element_size(),
                        crosses])


def _wire(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` as the group's backend takes it: on the host for gloo, as
    is for nccl; booleans as uint8.  Always a fresh contiguous tensor."""
    if t.dtype == torch.bool:
        t = t.to(torch.uint8)
    if dist.get_backend(group) == "gloo":
        return t.to("cpu", copy=True).contiguous()
    return t.clone(memory_format=torch.contiguous_format)


def all_reduce(t: torch.Tensor, mesh, axes: Axes, op: str = "sum"
               ) -> torch.Tensor:
    """``op`` ("sum" | "max" | "min") of ``t`` over the ranks of
    ``axes``, one dimension at a time in the order given (innermost
    first, as the reference's hierarchical ``psum``).  Returns a new
    tensor on ``t``'s device; ``t`` is not modified."""
    out = t
    for a in as_axes(axes):
        group = mesh.get_group(a)
        w = _wire(out, group)
        dist.all_reduce(w, op=_REDUCE_OPS[op], group=group)
        if _COUNTERS:
            _note("all-reduce", a, group, w)
        out = w.to(t.device, dtype=t.dtype)
    return out if out is not t else t.clone()


def all_gather(t: torch.Tensor, mesh, axes: Axes) -> torch.Tensor:
    """Every rank's ``t`` along ``axes``, concatenated along dim 0 in
    rank order (the reference's tiled ``all_gather``), one dimension at a
    time in the order given.  Returns a new tensor on ``t``'s device."""
    out = t
    for a in as_axes(axes):
        group = mesh.get_group(a)
        w = _wire(out, group)
        parts: List[torch.Tensor] = [torch.empty_like(w) for _ in
                                     range(dist.get_world_size(group))]
        dist.all_gather(parts, w, group=group)
        out = torch.cat(parts).to(t.device, dtype=t.dtype)
        if _COUNTERS:
            _note("all-gather", a, group, out)
    return out if out is not t else t.clone()


def block(t: torch.Tensor, mesh, axes: Axes, dim: int) -> torch.Tensor:
    """This rank's block of ``t`` along ``dim`` over ``axes`` (the
    :func:`linear_index` over them, row-major): a view."""
    n = axis_size(mesh, axes)
    if t.shape[dim] % n:
        raise ValueError(f"dimension {dim} of {tuple(t.shape)} does not "
                         f"split over {n} ranks")
    step = t.shape[dim] // n
    return t.narrow(dim, linear_index(mesh, axes) * step, step)


def all_gather_dim(t: torch.Tensor, mesh, axes: Axes, dim: int
                   ) -> torch.Tensor:
    """Every rank's ``t`` along ``axes`` concatenated along ``dim`` in
    the row-major rank order of :func:`linear_index` (the inverse of
    :func:`block`).  Several axes are gathered innermost (last) first.
    Returns a new tensor on ``t``'s device."""
    out = t
    for a in reversed(as_axes(axes)):
        group = mesh.get_group(a)
        n = dist.get_world_size(group)
        w = _wire(out.movedim(dim, 0), group)
        full = torch.empty((n * w.shape[0],) + tuple(w.shape[1:]),
                           dtype=w.dtype, device=w.device)
        _GATHER_INTO(full, w, group=group)
        if _COUNTERS:
            _note("all-gather", a, group, full)
        out = full.to(t.device, dtype=t.dtype).movedim(0, dim)
    return out.contiguous() if out is not t else t.clone()


def reduce_scatter_dim(t: torch.Tensor, mesh, axes: Axes, dim: int
                       ) -> torch.Tensor:
    """The sum of ``t`` over the ranks of ``axes``, of which this rank
    keeps its :func:`block` along ``dim`` (the adjoint of
    :func:`all_gather_dim`).  Several axes are scattered outermost
    (first) first.  Returns a new tensor on ``t``'s device."""
    out = t
    for a in as_axes(axes):
        group = mesh.get_group(a)
        n = dist.get_world_size(group)
        w = _wire(out.movedim(dim, 0), group)
        if w.shape[0] % n:
            raise ValueError(f"dimension {dim} of {tuple(t.shape)} does "
                             f"not split over {n} ranks")
        part = torch.empty((w.shape[0] // n,) + tuple(w.shape[1:]),
                           dtype=w.dtype, device=w.device)
        _SCATTER_FROM(part, w, group=group)
        if _COUNTERS:
            _note("reduce-scatter", a, group, part)
        out = part.to(t.device, dtype=t.dtype).movedim(0, dim)
    return out.contiguous() if out is not t else t.clone()

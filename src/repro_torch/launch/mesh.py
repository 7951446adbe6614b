"""Meshes of the LM stack (the port of ``repro.launch.mesh``).

Axis semantics, as in the reference:
  "pod"   — across pods / data centres; only sketch merges and gradient
            reductions cross it.
  "data"  — data parallel and the FSDP shard axis inside a pod.
  "model" — the tensor / expert parallel axis.

A mesh is a ``torch.distributed`` ``DeviceMesh`` with these dimension
names (``core.mesh``): every rank runs the same program in its own
process.  :func:`make_host_mesh` joins the default group when the caller
has not; :func:`spawn_ranks` is the launchers' ``--mesh`` /
``--host-devices``: it starts one process a rank and hands each its
device and mesh.
"""
from __future__ import annotations

import math
import os
import tempfile
from typing import Callable, Optional, Sequence, Tuple

import torch.distributed as dist

from repro_torch.core import mesh as mesh_mod

PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}
# a launcher's --mesh names its dimensions by the last len(shape) of these
AXES = ("pod", "data", "model")


def make_host_mesh(shape: Tuple[int, ...], axes: Sequence[str], *,
                   rank: Optional[int] = None,
                   init_method: Optional[str] = None,
                   backend: str = "gloo"):
    """A mesh of ``shape`` named ``axes`` over every rank of the default
    group, row-major.  When ``torch.distributed`` is not initialised yet,
    this rank joins it first (``rank`` and ``init_method`` then name the
    rendezvous, ``backend`` the group's backend: gloo for CPU ranks or
    ranks sharing a card, nccl for one card a rank)."""
    from torch.distributed.device_mesh import DeviceMesh
    import torch
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         f"length")
    if not dist.is_initialized():
        if rank is None or init_method is None:
            raise ValueError("torch.distributed is not initialised: name "
                             "this rank and the rendezvous")
        return mesh_mod.init_mesh(rank, math.prod(shape), init_method,
                                  shape, axes, backend=backend)
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"mesh shape {shape} does not hold the {world} "
                         f"ranks of the default group")
    dev_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(dev_type, torch.arange(world).reshape(shape),
                      mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, **init):
    """The reference's production layout: (16, 16) ("data", "model"), or
    (2, 16, 16) ("pod", "data", "model") with ``multi_pod``.  The world
    size must be 256 or 512 ranks; the layout is never shrunk to fit.
    ``init`` goes to :func:`make_host_mesh`."""
    shape, axes = PRODUCTION_SHAPES[bool(multi_pod)]
    need = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else None
    if have is not None and have != need:
        raise ValueError(f"the production mesh {shape} needs {need} ranks; "
                         f"the default group has {have}")
    return make_host_mesh(shape, axes, **init)


def axis_names(mesh) -> Tuple[str, ...]:
    return tuple(mesh.mesh_dim_names or ())


def dp_axes(mesh) -> Tuple[str, ...]:
    """Data-parallel axes of a mesh = every axis that is not 'model'."""
    return tuple(a for a in axis_names(mesh) if a != "model")


def dp_size(mesh) -> int:
    return mesh_mod.axis_size(mesh, dp_axes(mesh))


def tp_size(mesh) -> int:
    return mesh_mod.axis_size(mesh, "model") \
        if "model" in axis_names(mesh) else 1


def parse_mesh(spec: str) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """A launcher's ``--mesh`` comma shape and its dimension names,
    ``AXES[-len(shape):]`` as in the reference."""
    shape = tuple(int(x) for x in spec.split(","))
    if not 1 <= len(shape) <= len(AXES):
        raise ValueError(f"--mesh {spec}: 1 to {len(AXES)} dimensions")
    return shape, AXES[-len(shape):]


def spawn_ranks(fn: Callable, spec: str, host_devices: int, device,
                args: tuple = ()) -> None:
    """Run ``fn(rank, device, mesh, *args)`` in one spawned process a rank
    of the mesh ``spec`` (``--mesh``).  With ``host_devices`` the ranks
    are that many CPU processes on gloo (it must be the mesh's size, and
    ``device`` the CPU); otherwise each rank owns one card on nccl, and a
    mesh larger than the visible cards raises.  The ranks meet through a
    file in a fresh temporary directory; ``fn`` must be picklable (a
    module-level function)."""
    import torch
    import torch.multiprocessing as mp
    shape, names = parse_mesh(spec)
    world = math.prod(shape)
    dev = torch.device(device)
    if host_devices:
        if dev.type != "cpu":
            raise ValueError("--host-devices runs CPU ranks: pass --device "
                             "cpu")
        if host_devices != world:
            raise ValueError(f"--mesh {spec} has {world} ranks, "
                             f"--host-devices {host_devices}")
    else:
        if dev.type != "cuda":
            raise ValueError("a mesh off the card needs --host-devices N")
        if torch.cuda.device_count() < world:
            raise ValueError(f"--mesh {spec} needs {world} cards (one a "
                             f"rank); {torch.cuda.device_count()} are "
                             f"visible")
    rdv = tempfile.mkdtemp(prefix="repro_torch_mesh_")
    mp.spawn(_rank_entry, args=(fn, shape, names, host_devices,
                                f"file://{rdv}/rendezvous", args),
             nprocs=world)


def _rank_entry(rank: int, fn: Callable, shape, names, host_devices: int,
                init: str, args: tuple) -> None:
    """One spawned rank of :func:`spawn_ranks`: its device and backend,
    the mesh, then ``fn``; the group is torn down however ``fn`` ends."""
    import torch
    if host_devices:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // host_devices))
        dev, backend = torch.device("cpu"), "gloo"
    else:
        torch.cuda.set_device(rank)
        dev, backend = torch.device("cuda", rank), "nccl"
    mesh = make_host_mesh(shape, names, rank=rank, init_method=init,
                          backend=backend)
    try:
        fn(rank, dev, mesh, *args)
    finally:
        dist.destroy_process_group()

"""Device meshes, process-group start-up and the collectives the sharded
forms use (counterpart of revo_tpu/parallel/mesh.py).

The JAX package runs one controller over a named ``jax.sharding.Mesh`` and
lets ``shard_map`` place the shards and ``psum`` meet them.  Here a
``Mesh`` is a grid of slots, each a ``torch.device``; a sharded form runs
each slot's share of the work on that slot's device, one slot after the
other, and the helpers below stand in for ``shard_map``'s plumbing:

- ``shard`` splits dim 0 into one piece per slot on that slot's device;
- ``replicate`` puts one copy on every slot's device;
- ``psum`` sums the slots' partials (in slot order, no atomics);
- ``gather`` concatenates the slots' results in slot order.

Axes, as in JAX: "seq" runs sequences or segments; "pt", "pair", "edge" and
"cand" split a reduction.  A device may fill several slots: two slots on
one card drive the sharded code there, and ``[torch.device("cpu")] * 8``
is the counterpart of the tests' eight virtual CPU devices.  Slots on one
device share its current stream (and with it the kernels' scratch), which
is safe because launches on one stream run in order: never run slots from
threads.

Across processes (``maybe_distributed_init``, one process per card, the
PyTorch idiom and the way a host-bound program scales over cards) a mesh
built by ``make_mesh`` spans every rank's slots, each rank owning a
contiguous block; each process then runs only its own slots, ``psum`` ends
in one ``all_reduce`` and ``gather`` in one ``all_gather``, so every rank
returns the whole result.  Gloo is a CPU transport: under it a CUDA
tensor is copied to the host for the collective and back, explicitly.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist


class Mesh:
    """Slots (``torch.device``s) in an array shaped by the named axes.

    ``shape`` maps each axis name to its size, so ``mesh.shape[axis]``
    reads as it does in JAX.  ``owners`` holds each slot's rank under a
    process group (``group``); without one every slot is this process's."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str], group=None,
                 owners: Optional[np.ndarray] = None):
        axis_names = tuple(axis_names)
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-d device array for axes {axis_names}")
        self.devices = devices
        self.axis_names = axis_names
        self.group = group
        self.owners = np.zeros(devices.shape, np.int64) if owners is None else owners

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    def __repr__(self) -> str:
        where = "" if self.group is None else f", {dist.get_world_size(self.group)} processes"
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.flat]}{where})"


def cuda_devices() -> list:
    """Every CUDA device of this process; raises where there is none (no
    entry point falls back to the CPU unless its caller names it)."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; name the devices (e.g. "
                           "[torch.device('cpu')] * n) to run on the CPU")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def maybe_distributed_init(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    local_rank: Optional[int] = None,
    backend: Optional[str] = None,
) -> bool:
    """Start the default ``torch.distributed`` process group.

    Arguments default from the environment ``torchrun`` sets: the address
    ``tcp://MASTER_ADDR:MASTER_PORT``, ``WORLD_SIZE``, ``RANK`` and
    ``LOCAL_RANK``.  With CUDA present this process takes card
    ``LOCAL_RANK`` and the backend defaults to NCCL, else to gloo (NCCL
    refuses two ranks on one card; give ``backend="gloo"`` there).
    Without a complete environment it does nothing.  Returns True only when
    it started a group of more than one process."""
    env = os.environ
    if init_method is None and env.get("MASTER_ADDR") and env.get("MASTER_PORT"):
        init_method = f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    world_size = int(env.get("WORLD_SIZE", 0) or 0) if world_size is None else world_size
    rank = int(env.get("RANK", -1) or -1) if rank is None else rank
    if not init_method or world_size < 1 or not 0 <= rank < world_size:
        return False
    if dist.is_initialized():
        raise RuntimeError("a torch.distributed process group is already running")
    if torch.cuda.is_available():
        local_rank = int(env.get("LOCAL_RANK", 0) or 0) if local_rank is None else local_rank
        torch.cuda.set_device(local_rank)
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank)
    return world_size > 1


def _this_device() -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass the devices of this "
                           "process's slots to make_mesh")
    return torch.device("cuda", torch.cuda.current_device())


def make_mesh(
    axis_names: Sequence[str] = ("seq",),
    axis_sizes: Optional[Tuple[int, ...]] = None,
    devices=None,
) -> Mesh:
    """Named mesh over ``devices`` (default: every CUDA device; raises
    without one).

    With one axis every slot lands on it; with several, ``axis_sizes``
    must multiply to the slot count (one size may be -1, to be inferred).
    A device may repeat.  Under a process group the mesh spans every
    rank: ``devices`` then lists this process's slots (default: its card),
    every rank must give as many, and rank r owns the r-th block."""
    if dist.is_initialized():
        local = [torch.device(d) for d in devices] if devices is not None else [_this_device()]
        everyone = [None] * dist.get_world_size()
        dist.all_gather_object(everyone, [str(d) for d in local])
        if any(len(theirs) != len(local) for theirs in everyone):
            raise ValueError(f"ranks give different slot counts: {everyone}")
        flat = [torch.device(d) for theirs in everyone for d in theirs]
        owners = np.repeat(np.arange(len(everyone)), len(local))
        group = dist.group.WORLD
    else:
        flat = [torch.device(d) for d in devices] if devices is not None else cuda_devices()
        owners, group = np.zeros(len(flat), np.int64), None
    n = len(flat)
    if n == 0:
        raise ValueError("a mesh needs at least one device")
    if axis_sizes is None:
        if len(axis_names) != 1:
            raise ValueError("axis_sizes required for multi-axis meshes")
        shape: Tuple[int, ...] = (n,)
    else:
        sizes = list(axis_sizes)
        if sizes.count(-1) == 1:
            known = int(np.prod([s for s in sizes if s != -1]))
            sizes[sizes.index(-1)] = n // known
        if int(np.prod(sizes)) != n:
            raise ValueError(f"mesh {tuple(sizes)} does not cover {n} devices")
        shape = tuple(sizes)
    grid = np.empty(n, dtype=object)
    grid[:] = flat
    return Mesh(grid.reshape(shape), axis_names, group, owners.reshape(shape))


def _axis_slots(mesh: Mesh, axis: str):
    """(this process's slot devices along ``axis``, the axis size).  The
    other axes only replicate a function sharded over ``axis``, so it runs
    at index 0 of each; under a process group the axis must span every
    slot."""
    if not isinstance(mesh, Mesh):
        raise TypeError(f"want a revo_tpu_torch.parallel.mesh.Mesh (make_mesh), got {type(mesh)}")
    k = mesh.axis_names.index(axis)
    index = [0] * len(mesh.axis_names)
    index[k] = slice(None)
    devices, owners = mesh.devices[tuple(index)], mesh.owners[tuple(index)]
    if mesh.group is None:
        return list(devices), len(devices)
    if len(devices) != mesh.size:
        raise ValueError(f"under a process group a sharded axis must span the mesh: {mesh}")
    me = dist.get_rank(mesh.group)
    return [d for d, r in zip(devices, owners) if r == me], len(devices)


def local_slots(mesh: Mesh, axis: str) -> list:
    """The devices of the slots along ``axis`` that this process runs."""
    return _axis_slots(mesh, axis)[0]


def to_device(tree, device):
    """A tensor, or a nest of (named) tuples and lists of tensors, on
    ``device``; other leaves as they are.  A tensor already there is not
    copied."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, (tuple, list)):
        moved = [to_device(x, device) for x in tree]
        if hasattr(tree, "_fields"):
            return type(tree)(*moved)
        return type(tree)(moved)
    return tree


def _slice(tree, lo: int, hi: int):
    if isinstance(tree, (torch.Tensor, list)):
        return tree[lo:hi]
    moved = [_slice(x, lo, hi) for x in tree]
    return type(tree)(*moved) if hasattr(tree, "_fields") else type(tree)(moved)


def _leading(tree) -> int:
    if isinstance(tree, (torch.Tensor, list)):
        return len(tree)
    sizes = {_leading(x) for x in tree}
    if len(sizes) != 1:
        raise ValueError(f"leaves of different lengths: {sorted(sizes)}")
    return sizes.pop()


def shard(x, mesh: Mesh, axis: str) -> list:
    """Dim 0 of ``x`` (a tensor, a (named) tuple of tensors or a list) in
    equal pieces, one per slot along ``axis``; returns the pieces of this
    process's slots, each on its slot's device.  Pieces are slices (uint16
    tensors on the card have no index gather).  Raises when dim 0 does not
    divide by the axis size, as ``shard_map`` does."""
    slots, n = _axis_slots(mesh, axis)
    total = _leading(x)
    if total % n:
        raise ValueError(f"dim 0 of size {total} does not divide over the {n} slots of "
                         f"axis {axis!r}")
    k = total // n
    first = 0 if mesh.group is None else dist.get_rank(mesh.group) * len(slots)
    return [to_device(_slice(x, (first + i) * k, (first + i + 1) * k), d)
            for i, d in enumerate(slots)]


def replicate(x, mesh: Mesh, axis: str) -> list:
    """One copy of ``x`` on each of this process's slots along ``axis``
    (no copy where ``x`` is already on the slot's device)."""
    return [to_device(x, d) for d in local_slots(mesh, axis)]


def _host_staged(tensor: torch.Tensor, group, collective):
    """Run ``collective`` on ``tensor``, through a host copy under gloo."""
    if dist.get_backend(group) == "gloo" and tensor.device.type != "cpu":
        host = tensor.cpu()
        out = collective(host)
        return out.to(tensor.device)
    return collective(tensor)


def psum(parts: Sequence[torch.Tensor], mesh: Mesh, axis: str) -> torch.Tensor:
    """Sum of this process's slot partials (aligned with ``local_slots``),
    added in slot order on the first slot's device into a fresh tensor (a
    kernel's outputs may be views of one buffer); under a process group
    then one ``all_reduce``, so every rank holds the total.  Integer
    partials stay integer."""
    parts = list(parts)
    home = parts[0].device
    total = parts[0].to(home, copy=True)
    for p in parts[1:]:
        total = total + p.to(home)
    if mesh.group is None:
        return total

    def all_reduce(t):
        dist.all_reduce(t, group=mesh.group)
        return t

    return _host_staged(total.contiguous(), mesh.group, all_reduce)


def gather(parts: Sequence, mesh: Mesh, axis: str):
    """This process's slot results concatenated along dim 0 in slot order,
    on the first slot's device, then under a process group the ranks'
    blocks in rank order (one ``all_gather``), so every rank returns the
    whole result.  Lists of Python objects concatenate as lists."""
    parts = list(parts)
    if isinstance(parts[0], list):
        mine = [v for p in parts for v in p]
        if mesh.group is None:
            return mine
        everyone = [None] * dist.get_world_size(mesh.group)
        dist.all_gather_object(everyone, mine, group=mesh.group)
        return [v for theirs in everyone for v in theirs]
    home = parts[0].device
    mine = torch.cat([p.to(home) for p in parts]).contiguous()
    if mesh.group is None:
        return mine

    def all_gather(t):
        blocks = [torch.empty_like(t) for _ in range(dist.get_world_size(mesh.group))]
        dist.all_gather(blocks, t, group=mesh.group)
        return torch.cat(blocks)

    return _host_staged(mine, mesh.group, all_gather)

"""The (data, model) mesh over torch.distributed ranks (counterpart of
``qkv_ecc_tpu/parallel/mesh.py``).

One process per rank: rank r sits at data index r // model and model index
r % model, so the model axis is the innermost, as JAX lays its devices. The
mesh holds this rank's subgroups: its model group (the ranks of its data
index, over which the tensor-parallel sums run) and its data group (the
ranks of its model index). The backend is the caller's: NCCL for ranks each
on its own card, gloo for CPU ranks and for several ranks sharing one card
(NCCL puts no two ranks of a communicator on one device).

A group of one rank is left out (None): its collectives are the identity
and cost nothing. The collectives are all_reduce (sum and max) and a gather,
which is all_gather except where gloo holds CUDA tensors (gloo's CUDA
collectives are broadcast and all_reduce): there it is an all_reduce of a
zero buffer holding each rank's part at its place (adding zeros is exact).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from ..device import resolve_device


@dataclasses.dataclass
class Mesh:
    """This rank's view of a (data, model) mesh. ``model_group`` and
    ``data_group`` are None where the group would hold this rank alone (an
    axis of 1, and every axis of single_device_mesh): every collective over
    None is the identity."""

    data: int
    model: int
    rank: int
    device: torch.device
    model_group: Optional[object] = None
    data_group: Optional[object] = None

    @property
    def shape(self) -> dict:
        return {"data": self.data, "model": self.model}

    @property
    def size(self) -> int:
        return self.data * self.model

    @property
    def active(self) -> bool:
        """Whether this rank is one of the mesh's (ranks past data x model
        are left out, as JAX's create_mesh leaves devices out)."""
        return self.rank < self.size

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model


def rank_device(device=None, rank: int = 0) -> torch.device:
    """The device of a rank: ``None`` means card ``rank % cards`` (raising
    when there is none); anything else is taken as given (``"cpu"``, or
    ``"cuda:0"`` for ranks sharing one card)."""
    if device is None:
        resolve_device(None)
        return torch.device("cuda", rank % torch.cuda.device_count())
    return torch.device(device)


def create_mesh(data: int | None = None, model: int | None = None, devices=None, *,
                device=None) -> Mesh:
    """Build a (data, model) mesh over the initialised default process group.

    Defaults as JAX's: model = all ranks, data = 1; with one given, the
    other is the world size divided by it. data x model may be less than the
    world size (the ranks after it are not in the mesh, ``active`` False)
    and raises ValueError when it is more. ``devices`` is JAX's argument,
    the number of ranks to lay out (default: all). Every rank of the world
    must call this, in the same order, since it creates the subgroups.
    ``device``: see rank_device."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    n = world if devices is None else (devices if isinstance(devices, int) else len(devices))
    if data is None and model is None:
        data, model = 1, n
    elif data is None:
        data = n // model
    elif model is None:
        model = n // data
    if data * model > n or n > world:
        raise ValueError(f"mesh {data}x{model} needs more than {n} ranks")
    mesh = Mesh(data, model, rank, rank_device(device, rank))
    if mesh.device.type == "cuda":
        torch.cuda.set_device(mesh.device)  # NCCL's collectives run on the current card
    if not dist.is_initialized():
        return mesh
    for d in range(data):  # every rank enters every new_group
        g = dist.new_group([d * model + m for m in range(model)])
        if mesh.active and d == mesh.data_index and model > 1:
            mesh.model_group = g
    for m in range(model):
        g = dist.new_group([d * model + m for d in range(data)])
        if mesh.active and m == mesh.model_index and data > 1:
            mesh.data_group = g
    return mesh


def single_device_mesh(device=None) -> Mesh:
    """A 1x1 mesh on ``device`` (None: the card) without a process group."""
    return Mesh(1, 1, 0, resolve_device(device))


def initialize_distributed(coordinator_address=None, num_processes=None, process_id=None, *,
                           backend: str):
    """Join the default process group over TCP at ``coordinator_address``
    ("host:port", rank 0 listening there), with the given backend ("nccl"
    or "gloo": no automatic choice). Without an address it reads torch's
    environment variables (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK).
    Returns (world size, rank)."""
    if coordinator_address is None:
        dist.init_process_group(backend)
    else:
        dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id)
    return dist.get_world_size(), dist.get_rank()


def replicated(mesh: Mesh):
    """JAX's replicated sharding: no dimension sharded (a spec of None)."""
    return None


# -- collectives ------------------------------------------------------------


def all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """x reduced over ``group`` (sum or max), in place; the identity
    without a group."""
    if group is not None:
        dist.all_reduce(x, op=dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX,
                        group=group)
    return x


def all_gather_cat(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    """The group's tensors concatenated along ``dim`` in rank order (JAX's
    all_gather(tiled=True)); x without a group. All of the same shape."""
    if group is None:
        return x
    n, i = dist.get_world_size(group), dist.get_rank(group)
    if x.is_cuda and dist.get_backend(group) == "gloo":
        # gloo gathers no CUDA tensor: a sum of zero buffers, each holding
        # one rank's part at its place
        dim = dim % x.dim()
        shape = list(x.shape)
        shape[dim] *= n
        out = torch.zeros(shape, dtype=x.dtype, device=x.device)
        out.narrow(dim, i * x.shape[dim], x.shape[dim]).copy_(x)
        return all_reduce(out, group)
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)

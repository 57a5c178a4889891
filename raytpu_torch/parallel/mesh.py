"""The pixel mesh on torch.distributed (the counterpart of
raytpu.parallel.mesh).

raytpu runs one process over a JAX device mesh; PyTorch runs one process a
rank.  The scene is replicated on every rank and the pixels are split:
rendering needs no collective but the gather of the frame, and training
takes one all-reduce of the scene gradient (raytpu_torch.grad).

On a mesh of more than one rank the pixels are interleaved unless the
caller asks for blocks: a block is a strip of the frame, and strips differ
widely in how many rays survive each bounce (over 4 ranks at 1920x1080 3x3,
the busiest block holds 1.686x the mean rank's live rays, the interleaved
sets 1.001x), so in blocks every rank waits in the gradient's all-reduce
for the busiest one.  A world of one takes the whole frame either way.

  * `make_mesh`              — this rank's place in the group: a `Mesh`.
  * `initialize_distributed` — join a process group (a no-op without a
                               coordinator).
  * `interleaved`            — whether a mesh takes the interleaved sets.
  * `pixel_set`              — this rank's pixels, interleaved or a block.
  * `all_reduce_sum`, `all_gather_rows`, `gather_image` — the collectives.
  * `describe_devices`       — the devices this process sees.

A Mesh is a small frozen class, not a torch DeviceMesh:
init_device_mesh initialises a process group of its own where none exists,
and a world of one needs none.

Collectives under "gloo" run on host copies: gloo's all_gather does not
take CUDA tensors, and two ranks sharing one card cannot use "nccl" (it
refuses a duplicate GPU).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from raytpu_torch.config import RenderConfig
# local_device is re-exported: raytpu_torch.parallel names it.
from raytpu_torch.device import local_device, resolve_device  # noqa: F401
from raytpu_torch.utils.profiling import count, span

PIXEL_AXIS = "px"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh over the pixels (axis PIXEL_AXIS): rank `rank` of `size`
    in `group`, whose torch.distributed backend is `backend`, rendering on
    `device`.  `group` and `backend` None is a world of one, with no
    process group."""
    rank: int
    size: int
    device: torch.device
    group: object = None
    backend: str | None = None


def make_mesh(device=None) -> Mesh:
    """The mesh over the world of the initialised process group, or a world
    of one when none is initialised.  `device` is where this rank renders
    (default: local_device(), which raises without a card)."""
    device = resolve_device(device)
    if not dist.is_initialized():
        return Mesh(0, 1, device)
    group = dist.group.WORLD
    return Mesh(dist.get_rank(group), dist.get_world_size(group), device, group,
                dist.get_backend(group))


def initialize_distributed(coordinator: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None,
                           backend: str | None = None) -> None:
    """Join the process group of `num_processes` ranks as rank `process_id`.
    `coordinator` is "host:port" (tcp://), or an init URL as
    torch.distributed takes it ("file://...", or "env://" under torchrun,
    which sets the rank and size itself); None is a no-op, as in raytpu.
    `backend` defaults to "nccl" where a card is present and "gloo" where
    not; two ranks sharing one card must name "gloo"."""
    if coordinator is None:
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(backend, init_method=url,
                            world_size=-1 if num_processes is None else num_processes,
                            rank=-1 if process_id is None else process_id)


def interleaved(mesh: Mesh, interleave: bool | None = None) -> bool:
    """Whether `mesh` takes the interleaved pixel sets: `interleave` where
    the caller gives it, else (None) whenever the mesh has more than one
    rank."""
    return mesh.size > 1 if interleave is None else bool(interleave)


def pixel_set(mesh: Mesh, cfg: RenderConfig, interleave: bool | None = None):
    """This rank's pixels as (offset, count, stride): the frame's pixels
    {offset + j*stride : j < count}, the tail clamped to P-1 by the
    renderers.  count = ceil(P / size); rank s takes the interleaved set
    (s, count, size), or with `interleave` False the block (s*count, count,
    1).  `interleave` None (the default) interleaves: a hot strip of the
    frame is spread over every rank, where a block would leave one rank
    with most of it (1.686x the mean rank's live rays over 4 ranks at
    1920x1080 3x3).  On a world of one both are (0, P, 1).  Each
    interleaved set over more than one rank counts `mesh.interleaved`."""
    per = -(-cfg.num_pixels // mesh.size)
    if interleaved(mesh, interleave):
        if mesh.size > 1:
            count("mesh.interleaved")
        return mesh.rank, per, mesh.size
    return mesh.rank * per, per, 1


def _comm_copy(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """A copy of `t` where mesh's backend takes it: the host under gloo."""
    device = "cpu" if mesh.backend == "gloo" else t.device
    return t.detach().to(device, copy=True).contiguous()


def all_reduce_sum(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """The sum of `t` over the ranks, on every rank and on t's device."""
    if mesh.group is None:
        return t
    with span("mesh.all_reduce"):
        buf = _comm_copy(mesh, t)
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=mesh.group)
        return buf.to(t.device)


def all_gather_rows(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """Every rank's `t` (one shape on every rank), concatenated along the
    first axis in rank order, on every rank and on t's device."""
    if mesh.group is None:
        return t
    with span("mesh.all_gather"):
        buf = _comm_copy(mesh, t)
        parts = [torch.empty_like(buf) for _ in range(mesh.size)]
        dist.all_gather(parts, buf, group=mesh.group)
        return torch.cat(parts).to(t.device)


def gather_image(mesh: Mesh, rows: torch.Tensor) -> np.ndarray:
    """Every rank's rows, in rank order, as one numpy array on every rank
    (the readback of raytpu's process_allgather)."""
    return all_gather_rows(mesh, rows).cpu().numpy()


def describe_devices() -> str:
    """The CPU, each card by name, and this process's rank when a process
    group is initialised."""
    lines = ["cpu"]
    for i in range(torch.cuda.device_count()):
        lines.append(f"cuda:{i} {torch.cuda.get_device_name(i)}")
    if dist.is_initialized():
        lines.append(f"rank {dist.get_rank()}/{dist.get_world_size()}, "
                     f"backend={dist.get_backend()}")
    return "\n".join(lines)

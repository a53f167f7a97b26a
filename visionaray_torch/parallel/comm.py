"""The port's mesh and its transport over torch.distributed.

JAX's 1-D device ``Mesh`` becomes a process group: one rank per device,
the group's ranks in order along the one axis.  ``Mesh`` carries the
group, its size and this rank's place; a mesh of one rank never
communicates (a single process needs no process group at all).

Transport (what ``shard_map`` and ``ppermute`` do for the JAX package):

- ``all_gather``: every rank's block, concatenated along axis 0; this
  rank's block keeps its autograd graph, the others arrive as constants.
- ``all_reduce_``: an in-place sum over the ranks (the ``psum`` that
  ``shard_map`` inserts for the gradients of replicated leaves).
- ``hop``: ``ppermute`` over ``[(i, i + 1 mod D)]``, one ring step, with
  its transpose as the backward: the forward sends the payload to rank
  + 1 and receives from rank - 1; the backward sends the payload's
  gradient to rank - 1 and receives from rank + 1.  Send and receive of a
  step are posted together (``dist.batch_isend_irecv``), so no rank waits
  on a send that its neighbour has not yet matched.  ``backward()`` is
  therefore collective: every rank runs the same hops and calls it.

Host staging, only for a gloo group: gloo's collectives and point-to-point
calls take host tensors, so a CUDA tensor is copied to the host, sent,
and the received one copied back to its card (``STATS`` counts the bytes
and the seconds).  This lets two ranks share one GPU (NCCL refuses two
ranks on one device); the rendering and the kernels stay on the card.  An
NCCL group passes CUDA tensors as they are and never stages, and its
errors propagate.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any

import torch
import torch.distributed as dist

TILE_AXIS = "tiles"

# transport counters of this process: ring hops and their payload bytes,
# gathers and reductions, and the host staging of a gloo group (bytes
# copied each way, seconds spent in the copies after the card was idle)
STATS = {"hops": 0, "hop_bytes": 0, "gathers": 0, "gather_bytes": 0,
         "reduces": 0, "staged_bytes": 0, "staging_s": 0.0}


def reset_stats():
    for k in STATS:
        STATS[k] = 0.0 if k == "staging_s" else 0


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh of ranks: ``group`` (None: the default group, or no
    process group at all for a mesh of one), ``ranks`` the global ranks of
    its members in axis order, ``rank`` this process's place among them."""

    group: Any = None
    ranks: tuple = (0,)
    rank: int = 0
    axis_names: tuple = (TILE_AXIS,)

    @property
    def size(self) -> int:
        return len(self.ranks)

    @property
    def backend(self):
        return None if self.size == 1 else dist.get_backend(self.group)


def world_mesh() -> Mesh:
    """The mesh of every rank of the default group (of one process when no
    group is initialized)."""
    if not dist.is_initialized():
        return Mesh()
    n = dist.get_world_size()
    return Mesh(group=None, ranks=tuple(range(n)), rank=dist.get_rank())


def _staged(t: torch.Tensor, mesh: Mesh) -> bool:
    return t.is_cuda and mesh.backend == "gloo"


def _to_host(t: torch.Tensor) -> torch.Tensor:
    torch.cuda.synchronize(t.device)
    t0 = time.perf_counter()
    host = t.cpu()
    STATS["staging_s"] += time.perf_counter() - t0
    STATS["staged_bytes"] += host.numel() * host.element_size()
    return host


def _to_device(host: torch.Tensor, device) -> torch.Tensor:
    t0 = time.perf_counter()
    out = host.to(device)
    torch.cuda.synchronize(device)
    STATS["staging_s"] += time.perf_counter() - t0
    STATS["staged_bytes"] += host.numel() * host.element_size()
    return out


def _wire(t: torch.Tensor):
    """(tensor to send, dtype to restore): bool travels as uint8."""
    if t.dtype == torch.bool:
        return t.to(torch.uint8), torch.bool
    return t, t.dtype


def all_gather(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's ``t`` (equal shapes), concatenated along axis 0 in
    rank order; this rank's block is ``t`` itself, with its graph."""
    if mesh.size == 1:
        return t
    src, dtype = _wire(t.detach().contiguous())
    stage = _staged(src, mesh)
    if stage:
        src = _to_host(src)
    parts = [torch.empty_like(src) for _ in range(mesh.size)]
    dist.all_gather(parts, src, group=mesh.group)
    STATS["gathers"] += 1
    STATS["gather_bytes"] += src.numel() * src.element_size() * mesh.size
    if stage:
        parts = [_to_device(p, t.device) for p in parts]
    parts = [p.to(dtype) for p in parts]
    parts[mesh.rank] = t
    return torch.cat(parts)


def all_reduce_(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Sum ``t`` over the ranks, in place; returns ``t``."""
    if mesh.size == 1:
        return t
    if _staged(t, mesh):
        host = _to_host(t.contiguous())
        dist.all_reduce(host, group=mesh.group)
        t.copy_(_to_device(host, t.device))
    else:
        dist.all_reduce(t, group=mesh.group)
    STATS["reduces"] += 1
    return t


def _exchange(t: torch.Tensor, mesh: Mesh, forward: bool) -> torch.Tensor:
    """Send ``t`` one step around the ring (to rank + 1 when ``forward``,
    else to rank - 1) and receive the same shape from the other side."""
    nxt = mesh.ranks[(mesh.rank + 1) % mesh.size]
    prv = mesh.ranks[(mesh.rank - 1) % mesh.size]
    dst, src = (nxt, prv) if forward else (prv, nxt)
    send = t.contiguous()
    stage = _staged(send, mesh)
    if stage:
        send = _to_host(send)
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, dst, group=mesh.group),
           dist.P2POp(dist.irecv, recv, src, group=mesh.group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    STATS["hops"] += 1
    STATS["hop_bytes"] += send.numel() * send.element_size()
    return _to_device(recv, t.device) if stage else recv


class _Hop(torch.autograd.Function):
    """One ring step with ppermute's transpose as its backward."""

    @staticmethod
    def forward(ctx, payload, mesh):
        ctx.mesh = mesh
        return _exchange(payload, mesh, forward=True)

    @staticmethod
    def backward(ctx, grad):
        return _exchange(grad, ctx.mesh, forward=False), None


def hop(payload: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``payload`` from rank - 1 after this rank's went to rank + 1 (the
    identity on a mesh of one).  Differentiable: its backward runs the
    step the other way, on every rank."""
    if mesh.size == 1:
        return payload
    if torch.is_grad_enabled() and payload.requires_grad:
        return _Hop.apply(payload, mesh)
    return _exchange(payload, mesh, forward=True)

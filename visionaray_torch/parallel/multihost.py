"""Launching over several processes (port of parallel/multihost.py).

The JAX package's story is ``jax.distributed``: every host runs the same
program and ``shard_map`` spans all chips.  Here every rank runs the same
program and the process group takes the place of the global device list:
one rank per device, so the device count is the world size, and a
process's slice of the flat pixel array is its rank's.

Determinism: the counter-based RNG is keyed by absolute pixel id, so a
frame is the same for any number of ranks.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time
from datetime import timedelta
from typing import Optional

import torch
import torch.distributed as dist

from visionaray_torch.device import resolve_device
from visionaray_torch.parallel.comm import Mesh, all_gather, world_mesh


# a rank waits this long for the others in a collective before it fails
_TIMEOUT = timedelta(seconds=600)


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None, device="cuda") -> bool:
    """Initialize the default process group (idempotent); returns True
    when the world size is above 1 after the call.

    ``coordinator_address`` ("host:port"), ``num_processes`` and
    ``process_id`` default to the environment's MASTER_ADDR and
    MASTER_PORT, WORLD_SIZE and RANK.  With none of them set this is one
    process: no group is made and the call returns False.  ``backend``
    defaults to NCCL on a CUDA ``device`` and gloo on the CPU; a CUDA rank
    takes the card ``process_id`` modulo the card count.
    """
    if dist.is_initialized():
        return dist.get_world_size() > 1
    addr = coordinator_address
    if addr is None and "MASTER_ADDR" in os.environ:
        addr = (f"{os.environ['MASTER_ADDR']}:"
                f"{os.environ.get('MASTER_PORT', '29500')}")
    if addr is None and num_processes is None \
            and "WORLD_SIZE" not in os.environ:
        return False
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
    if process_id is None:   # not `or`: process_id=0 is a valid argument
        process_id = int(os.environ.get("RANK", "0"))
    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    if addr is None:
        addr = "localhost:29500"
    if "://" not in addr:
        addr = "tcp://" + addr
    dist.init_process_group(backend, init_method=addr,
                            world_size=num_processes, rank=process_id,
                            timeout=_TIMEOUT)
    return dist.get_world_size() > 1


def shutdown() -> None:
    """End this rank's part in the default process group, if there is one:
    wait at a barrier for every rank to finish, then destroy the group, so
    that no rank leaves the interpreter while the backend's threads still
    run (a gloo rank that exits with its group alive can die in
    std::terminate after its work is done).  Call it in a ``finally``:
    while an exception propagates the barrier is skipped, as the other
    ranks may never reach it, and the group is only destroyed."""
    if not dist.is_initialized():
        return
    if sys.exc_info()[0] is None:
        dist.barrier()
    dist.destroy_process_group()


def global_mesh() -> Mesh:
    """1-D mesh over every rank of the default group."""
    return world_mesh()


def make_global_pixel_array(x_local, mesh: Mesh):
    """The global array of the ranks' local shards: each rank passes its
    slice of the flat pixel array (n_global // world size, ...) and gets
    the whole, in rank order (JAX assembles a sharded global jax.Array;
    torch has none, so the shards are gathered)."""
    return all_gather(torch.as_tensor(x_local), mesh)


def _world(world_size, rank):
    if world_size is None:
        world_size = dist.get_world_size() if dist.is_initialized() else 1
    if rank is None:
        rank = dist.get_rank() if dist.is_initialized() else 0
    return world_size, rank


def padded_global_size(n_global: int, world_size: Optional[int] = None
                       ) -> int:
    """n_global rounded up so every device (rank) holds an equal shard."""
    nd, _ = _world(world_size, None)
    return -(-n_global // nd) * nd


def local_slice(n_global: int, world_size: Optional[int] = None,
                rank: Optional[int] = None) -> slice:
    """This process's contiguous range of the padded flat index space,
    always padded_global_size(n) // world size long; the last rank's may
    reach past n_global, padding the caller masks."""
    pc, pid = _world(world_size, rank)
    per = padded_global_size(n_global, pc) // pc
    return slice(pid * per, (pid + 1) * per)


def local_backend(world: int, device="cuda") -> str:
    """The backend for ``world`` ranks on this host: NCCL when the device
    is CUDA and every rank has a card of its own, else gloo (NCCL refuses
    two ranks on one card; a gloo group's transport stages CUDA tensors
    through host buffers, parallel/comm.py)."""
    dev = resolve_device(device)
    return ("nccl" if dev.type == "cuda"
            and world <= torch.cuda.device_count() else "gloo")


def spawn_local(world: int, argv=None, timeout: Optional[float] = None,
                env=None, outputs=None) -> list:
    """Run a script as ``world`` ranks on this host: each rank a process
    of ``argv`` (this process's command line by default) under ``env``
    (this process's environment by default) with RANK, WORLD_SIZE,
    MASTER_ADDR and MASTER_PORT set, so that ``initialize()`` joins them;
    rank r's stdout and stderr go to the file ``outputs[r]`` when given.
    Waits for all.  A rank that exits non-zero, or ``timeout`` seconds
    passing, ends the others at once (a rank left alone would wait in a
    collective).  Returns each rank's exit code, negative for a rank
    ended here."""
    argv = list(sys.argv if argv is None else argv)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = str(s.getsockname()[1])
    base = dict(os.environ if env is None else env)
    procs = [subprocess.Popen(
        [sys.executable] + argv,
        env=dict(base, RANK=str(r), WORLD_SIZE=str(world),
                 MASTER_ADDR="localhost", MASTER_PORT=port),
        stdout=None if outputs is None else outputs[r],
        stderr=None if outputs is None else subprocess.STDOUT)
        for r in range(world)]
    t_end = None if timeout is None else time.monotonic() + timeout
    while any(p.poll() is None for p in procs):
        if any(p.poll() not in (None, 0) for p in procs) or (
                t_end is not None and time.monotonic() > t_end):
            break
        time.sleep(0.2)
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.wait()
    return [p.returncode for p in procs]

"""Rank processes of a cell on several cards: one process a card, joined
by ``torch.distributed`` at ``tcp://localhost:<free port>``."""

from __future__ import annotations

import os
import socket
import subprocess
import time


def spawn(world: int, argv: list, out_dir: str, timeout: float) -> list:
    """Run ``argv`` as ``world`` ranks (RANK, WORLD_SIZE, MASTER_ADDR,
    MASTER_PORT in the environment), each rank's output to
    ``out_dir/rank<r>.log``; wait for all.  A rank that fails, or the time
    limit, ends the others at once.  Returns the exit codes (negative for
    a rank ended here)."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = str(s.getsockname()[1])
    logs = [open(os.path.join(out_dir, f"rank{r}.log"), "w")
            for r in range(world)]
    try:
        procs = [subprocess.Popen(
            argv, stdout=logs[r], stderr=subprocess.STDOUT,
            env=dict(os.environ, RANK=str(r), WORLD_SIZE=str(world),
                     MASTER_ADDR="localhost", MASTER_PORT=port))
            for r in range(world)]
        t_end = time.monotonic() + timeout
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) or \
                    time.monotonic() > t_end:
                break
            time.sleep(0.1)
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        return [p.returncode for p in procs]
    finally:
        for f in logs:
            f.close()


def log_tail(out_dir: str, rank: int, n: int = 3000) -> str:
    with open(os.path.join(out_dir, f"rank{rank}.log")) as f:
        return f.read()[-n:]

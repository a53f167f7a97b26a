"""What several per-layer readers take from a traced run's context."""

from __future__ import annotations

from harness.trace import seconds_of

WALK_KERNELS = ("lbvh_kernel",)      # traverse_lbvh.cu's kernel, by name


def iterations(ctx) -> int:
    return ctx["shapes"]["traced_iterations"]


def walk_s(ctx) -> float:
    """Device seconds of the walk kernels per traced iteration (rank 0)."""
    return seconds_of(ctx["traces"][0], WALK_KERNELS) / iterations(ctx)

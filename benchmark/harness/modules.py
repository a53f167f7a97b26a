"""The modules a run may not hold once its window has closed: JAX and the
JAX package.  Top-level names are compared whole, so ``visionaray_torch``,
whose name begins with the JAX package's, is not among them."""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "visionaray_tpu")


def forbidden_modules() -> list:
    """Top-level names of this process's loaded modules that are
    forbidden, sorted."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))

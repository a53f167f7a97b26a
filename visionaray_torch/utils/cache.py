"""Where the port's compiled kernels live (port of utils/cache.py).

The JAX package points XLA's persistent compilation cache at a directory
so a render program compiles once per (program, shape) across processes.
The port runs no XLA: what it compiles is its kernel libraries, the nvcc
build of ``ops/cuda/*.cu`` (``ops/traverse.py``) and the g++ build of
``native/sah_builder.cpp`` (``ops/sah.py``), each kept under a hash of its
sources, so a second process loads them without building.  This names
that directory; by default ``build/visionaray_torch/`` in the checkout
(git-ignored).
"""

from __future__ import annotations

from pathlib import Path

import visionaray_torch.ops.sah as sah
import visionaray_torch.ops.traverse as trav

DEFAULT = Path(__file__).resolve().parents[2] / "build" / "visionaray_torch"


def enable_compilation_cache(path: str | None = None) -> str:
    """Build and load the kernel libraries under ``path`` (default
    ``build/visionaray_torch/``) from now on; returns the directory.  A
    library already loaded in this process stays loaded."""
    root = Path(path) if path else DEFAULT
    trav._BUILD_ROOT = root
    sah._BUILD_ROOT = root / "sah"
    return str(root)

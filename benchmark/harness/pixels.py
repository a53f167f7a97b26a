"""The order in which a mix hands pixels to the renderer.

- ``swizzle64``: bench.py's 64 x 64 pixel blocks, row-major blocks and
  row-major pixels inside each (a copy of ``chip_smoke.py::
  swizzled_pixels``);
- ``rows``: row-major pixels.
"""

from __future__ import annotations

import numpy as np


def order(kind: str, width: int, height: int):
    """(x, y) int32 numpy arrays of the W x H pixels in ``kind`` order."""
    if kind == "rows":
        yy, xx = np.meshgrid(np.arange(height), np.arange(width),
                             indexing="ij")
        return (xx.reshape(-1).astype(np.int32),
                yy.reshape(-1).astype(np.int32))
    if kind != "swizzle64":
        raise ValueError(f"pixel order {kind!r}: swizzle64 or rows")
    B = 64
    Wp, Hp = -(-width // B) * B, -(-height // B) * B
    yy, xx = np.meshgrid(np.arange(Hp), np.arange(Wp), indexing="ij")
    inb = (xx < width) & (yy < height)
    blk = (yy // B) * (Wp // B) + (xx // B)
    flat = np.argsort(np.where(inb, blk, 1 << 30).reshape(-1),
                      kind="stable")[: width * height]
    return (xx.reshape(-1)[flat].astype(np.int32),
            yy.reshape(-1)[flat].astype(np.int32))


def padded(x, y, tile: int):
    """Lanes padded up to a whole number of ``tile`` with pixel (0, 0), as
    the training step pads its last tile."""
    n = x.shape[0]
    pad = -(-n // tile) * tile - n
    z = np.zeros(pad, np.int32)
    return np.concatenate([x, z]), np.concatenate([y, z])


def sample(n: int, k: int, seed: int):
    """``k`` distinct lane indices of ``n``, drawn from ``seed``."""
    rng = np.random.default_rng([int(seed) & (2**63 - 1), 0x5EED])
    return np.sort(rng.choice(n, size=min(k, n), replace=False))

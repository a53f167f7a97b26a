"""Device selection shared by every entry point of the port."""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device="cuda") -> torch.device:
    """The torch.device for ``device``; raises if CUDA is asked for and
    absent.  There is no silent fallback to the CPU: callers that want the
    CPU (the parity tests) say so."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "visionaray_torch: a CUDA device was requested but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain PyTorch path on the CPU")
    return dev


def take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``jnp.take(x, idx, axis=0)`` for in-range indices of any shape.

    Unlike jnp.take, an out-of-range index raises instead of filling.
    """
    flat = torch.index_select(x, 0, idx.reshape(-1).long())
    return flat.reshape(tuple(idx.shape) + tuple(x.shape[1:]))


def to_numpy(x) -> np.ndarray:
    """A numpy array of ``x``: a tensor is copied to the host (detached),
    anything else goes through ``np.asarray``."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)

"""Counter-based per-ray RNG (port of ops/sampling.py), bit-exact.

The reference hashes (seed, absolute pixel id, frame) with the PCG-RXS-M-XS
output function over uint32 lanes.  torch on the CPU cannot add or shift
uint32 tensors, so every uint32 value here lives in an int64 tensor in
[0, 2^32) and each wrapping step is masked with ``& 0xFFFFFFFF``.  A
product that wraps int64 keeps its low 32 bits, so the mask is still exact.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_MUL = 747796405
_INC = 2891336453
_MIX = 277803737
_UNIT = 2.3283064e-10   # 2^-32 as float32


def as_u32(x, device=None) -> torch.Tensor:
    """A uint32 value (python int or integer tensor) as an int64 tensor."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & _MASK
    return torch.as_tensor(int(x) & _MASK, dtype=torch.int64, device=device)


def _pcg_out(x):
    word = (((x >> ((x >> 28) + 4)) ^ x) * _MIX) & _MASK
    return (word >> 22) ^ word


def pcg_hash(x):
    """One PCG-RXS-M-XS round over uint32 lanes held in int64."""
    x = (as_u32(x) * _MUL + _INC) & _MASK
    return _pcg_out(x)


def _to_unit_float(bits):
    """uint32 -> f32 in [0, 1]: the f32 rounding of the reference, so bits
    within 128 of 2^32 round to exactly 1.0 (kept, not fixed)."""
    return bits.to(torch.float32) * torch.tensor(
        _UNIT, dtype=torch.float32, device=bits.device)


@dataclass
class Sampler:
    """Stateless-seeded, stateful-advancing uniform sampler; ``state`` is
    an int64 tensor of uint32 values."""

    state: Any

    @staticmethod
    def seed(seed: int, pixel_id, frame=0) -> "Sampler":
        pid = as_u32(pixel_id)
        f = as_u32(frame, device=pid.device)
        s = pcg_hash(pid ^ pcg_hash((as_u32(seed, pid.device)
                                     + f * 0x9E3779B9) & _MASK))
        return Sampler(state=pcg_hash(s))

    def next(self):
        new_state = (self.state * _MUL + _INC) & _MASK
        return _to_unit_float(_pcg_out(new_state)), Sampler(state=new_state)

    def next_n(self, n: int):
        us = []
        s = self
        for _ in range(n):
            u, s = s.next()
            us.append(u)
        return us, s


def radical_inverse(n, base: int = 2, iters: int = 32):
    """Van der Corput radical inverse of uint32 ``n`` (held in int64, as
    the PCG code holds them), f32 digit weights as in the reference."""
    n = as_u32(n)
    result = torch.zeros(n.shape, dtype=torch.float32, device=n.device)
    inv_base = np.float32(1.0 / base)
    inv_bi = inv_base
    for _ in range(iters):
        digit = (n % base).to(torch.float32)
        result = result + digit * float(inv_bi)
        n = n // base
        inv_bi = inv_bi * inv_base
    return result

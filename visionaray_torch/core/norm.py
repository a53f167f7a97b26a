"""Normalized fixed-point texel types (port of core/norm.py, a numpy copy;
reference math/snorm.h, unorm.h).

unorm<Bits>: float in [0, 1] <-> unsigned int in [0, 2^Bits - 1]
snorm<Bits>: float in [-1, 1] <-> signed int, converted per OpenGL 4.4
             section 2.3.4.1 (math/detail/{snorm,unorm}.inl): encode
             truncates f * (2^Bits - 1) (resp. 2^(Bits-1) - 1), decode
             divides by the same scale, snorm decode clamps at -1 (the
             two's-complement minimum maps to -1).

Host-side texel conversion utilities (texture upload / pixel IO), so they
run in numpy with the reference's double-precision scale — 32-bit round
trips stay exact, which float32 math could not deliver.  The quantized
arrays feed textures as plain integer dtypes.
"""

from __future__ import annotations

import numpy as np

_UINT = {8: np.uint8, 16: np.uint16, 32: np.uint32}
_INT = {8: np.int8, 16: np.int16, 32: np.int32}


def _umax(bits: int) -> float:
    return float((1 << bits) - 1)


def _smax(bits: int) -> float:
    return float((1 << (bits - 1)) - 1)


def float_to_unorm(f, bits: int = 8, dtype=None):
    """Quantize [0,1] float -> Bits-wide unsigned (unorm.inl:20-24):
    saturate, scale by double(2^Bits - 1), truncate.  ``dtype`` overrides
    the storage type for widths without a same-size integer (DEPTH24
    stores 24 bits in uint32; io/pixel_format.py)."""
    f = np.clip(np.asarray(f), 0.0, 1.0)
    return np.trunc(f.astype(np.float64) * _umax(bits)).astype(
        dtype or _UINT[bits])


def unorm_to_float(u, bits: int = 8):
    """Dequantize (unorm.inl:27-32)."""
    u = np.asarray(u)
    return (u.astype(np.float64) / _umax(bits)).astype(np.float32)


def float_to_snorm(f, bits: int = 8, dtype=None):
    """Quantize [-1,1] float (snorm.inl:20-26): clamp, scale by
    double(2^(Bits-1) - 1), truncate toward zero."""
    f = np.clip(np.asarray(f), -1.0, 1.0)
    return np.trunc(f.astype(np.float64) * _smax(bits)).astype(
        dtype or _INT[bits])


def snorm_to_float(s, bits: int = 8):
    """Dequantize with the -1 clamp (snorm.inl:28-34)."""
    s = np.asarray(s)
    return np.maximum(s.astype(np.float64) / _smax(bits),
                      -1.0).astype(np.float32)

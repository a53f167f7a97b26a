"""Pixel formats and format-converting store/blend (port of
io/pixel_format.py: the host functions a numpy copy, the device functions
in PyTorch).

The reference enumerates pixel formats (pixel_format.h:17-60, runtime info
in src/visionaray/pixel_format.cpp) and routes every framebuffer write
through format-templated `pixel_access::store/blend` conversions
(detail/pixel_access.h:40+, 2.2 kLoC of template instantiations).  Here a
format is a small descriptor and conversion is one vectorized function —
the internal framebuffer is always linear (…, C) float32 and conversion
happens at the edges (store into a typed target, blend for progressive
accumulation).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np

import torch

from visionaray_torch.core.norm import (
    float_to_snorm, float_to_unorm, snorm_to_float, unorm_to_float,
)
from visionaray_torch.device import resolve_device

@dataclasses.dataclass(frozen=True)
class PixelFormatInfo:
    """Runtime format info (pixel_format.cpp's table analogue)."""

    name: str
    components: int
    dtype: type            # numpy storage dtype
    kind: str              # "unorm" | "snorm" | "float" | "uint" | "int"
    bits_per_component: int
    # storage-order -> RGBA-order gather indices (BGR8: (2,1,0))
    swizzle: tuple = None
    # per-component bit widths packed little-endian into ONE dtype word
    # (RGB10_A2: (10,10,10,2)); packed formats have no trailing comp dim
    packed_bits: tuple = None

    @property
    def size_bytes(self) -> int:
        if self.packed_bits is not None:
            return sum(self.packed_bits) // 8
        return self.components * self.bits_per_component // 8


def _fmt(name, components, dtype, kind, bits, **kw):
    return PixelFormatInfo(name, components, dtype, kind, bits, **kw)


PIXEL_FORMATS: Dict[str, PixelFormatInfo] = {
    f.name: f for f in [
        # color (pixel_format.h:21-48)
        _fmt("R8", 1, np.uint8, "unorm", 8),
        _fmt("RG8", 2, np.uint8, "unorm", 8),
        _fmt("RGB8", 3, np.uint8, "unorm", 8),
        _fmt("RGBA8", 4, np.uint8, "unorm", 8),
        _fmt("R16F", 1, np.float16, "float", 16),
        _fmt("RG16F", 2, np.float16, "float", 16),
        _fmt("RGB16F", 3, np.float16, "float", 16),
        _fmt("RGBA16F", 4, np.float16, "float", 16),
        _fmt("R32F", 1, np.float32, "float", 32),
        _fmt("RG32F", 2, np.float32, "float", 32),
        _fmt("RGB32F", 3, np.float32, "float", 32),
        _fmt("RGBA32F", 4, np.float32, "float", 32),
        _fmt("R16I", 1, np.int16, "int", 16),
        _fmt("RG16I", 2, np.int16, "int", 16),
        _fmt("RGB16I", 3, np.int16, "int", 16),
        _fmt("RGBA16I", 4, np.int16, "int", 16),
        _fmt("R32I", 1, np.int32, "int", 32),
        _fmt("RG32I", 2, np.int32, "int", 32),
        _fmt("RGB32I", 3, np.int32, "int", 32),
        _fmt("RGBA32I", 4, np.int32, "int", 32),
        _fmt("R16UI", 1, np.uint16, "uint", 16),
        _fmt("RG16UI", 2, np.uint16, "uint", 16),
        _fmt("RGB16UI", 3, np.uint16, "uint", 16),
        _fmt("RGBA16UI", 4, np.uint16, "uint", 16),
        _fmt("R32UI", 1, np.uint32, "uint", 32),
        _fmt("RG32UI", 2, np.uint32, "uint", 32),
        _fmt("RGB32UI", 3, np.uint32, "uint", 32),
        _fmt("RGBA32UI", 4, np.uint32, "uint", 32),
        # component-swizzled (pixel_format.h:50-51)
        _fmt("BGR8", 3, np.uint8, "unorm", 8, swizzle=(2, 1, 0)),
        _fmt("BGRA8", 4, np.uint8, "unorm", 8, swizzle=(2, 1, 0, 3)),
        # bit-packed (pixel_format.h:53-55)
        _fmt("RGB10_A2", 4, np.uint32, "unorm", 32,
             packed_bits=(10, 10, 10, 2)),
        _fmt("R11F_G11F_B10F", 3, np.uint32, "float", 32,
             packed_bits=(11, 11, 10)),
        # snorm extensions kept from earlier rounds
        _fmt("RGB8S", 3, np.int8, "snorm", 8),
        _fmt("RGBA8S", 4, np.int8, "snorm", 8),
        # depth / stencil (pixel_format.h:57-64)
        _fmt("DEPTH16", 1, np.uint16, "unorm", 16),
        _fmt("DEPTH24", 1, np.uint32, "unorm", 24),
        _fmt("DEPTH32", 1, np.uint32, "unorm", 32),
        _fmt("DEPTH32F", 1, np.float32, "float", 32),
        _fmt("DEPTH24_STENCIL8", 1, np.uint32, "uint", 32),
        _fmt("DEPTH32F_STENCIL8", 1, np.uint64, "uint", 64),
        # luminance (pixel_format.h:66-68)
        _fmt("LUMINANCE8", 1, np.uint8, "unorm", 8),
        _fmt("LUMINANCE16", 1, np.uint16, "unorm", 16),
        _fmt("LUMINANCE32F", 1, np.float32, "float", 32),
    ]
}


# --- 11/10-bit small floats via the float16 bit layout -----------------
# An e5m6 (11F) / e5m5 (10F) value is exactly a float16 (e5m10) with the
# mantissa truncated and no sign bit, so encode = clamp to the type's max
# finite value, round through float16, drop low mantissa bits; decode =
# shift back up and reinterpret as float16.  Matches the GL packed format.

_SMALLF_MAX = {11: 65024.0, 10: 64512.0}


def _smallf_encode(f, bits):
    f = np.clip(np.asarray(f, np.float32), 0.0, _SMALLF_MAX[bits])
    h = f.astype(np.float16).view(np.uint16).astype(np.uint32)
    return (h >> (15 - bits)) & ((1 << bits) - 1)


def _smallf_decode(u, bits):
    h = ((np.asarray(u, np.uint32) & ((1 << bits) - 1))
         << (15 - bits)).astype(np.uint16)
    return h.view(np.float16).astype(np.float32)


def _pack_host(f, info: PixelFormatInfo):
    """(…, C) floats -> (…) packed word (RGB10_A2 / R11F_G11F_B10F)."""
    out = np.zeros(f.shape[:-1], np.uint64)
    shift = 0
    for c, bits in enumerate(info.packed_bits):
        comp = f[..., c].astype(np.float64)
        if info.kind == "unorm":
            q = np.trunc(np.clip(comp, 0.0, 1.0)
                         * float((1 << bits) - 1)).astype(np.uint64)
        else:
            q = _smallf_encode(comp, bits).astype(np.uint64)
        out |= q << shift
        shift += bits
    return out.astype(info.dtype)


def _unpack_host(arr, info: PixelFormatInfo):
    """(…) packed word -> (…, C) floats."""
    arr = np.asarray(arr).astype(np.uint64)
    comps = []
    shift = 0
    for bits in info.packed_bits:
        q = (arr >> shift) & ((1 << bits) - 1)
        if info.kind == "unorm":
            comps.append((q.astype(np.float64)
                          / float((1 << bits) - 1)).astype(np.float32))
        else:
            comps.append(_smallf_decode(q, bits))
        shift += bits
    return np.stack(comps, axis=-1)


def _to_float(arr, info: PixelFormatInfo):
    if info.packed_bits is not None:
        return _unpack_host(arr, info)
    bits = info.bits_per_component
    if info.kind == "unorm":
        f = unorm_to_float(arr, bits)
    elif info.kind == "snorm":
        f = snorm_to_float(arr, bits)
    else:  # uint / int / float: value-preserving cast
        f = np.asarray(arr).astype(np.float32)
    if info.swizzle is not None:
        f = f[..., list(info.swizzle)]
    return f


def _from_float(arr, info: PixelFormatInfo):
    if info.packed_bits is not None:
        return _pack_host(arr, info)
    if info.swizzle is not None:  # RGBA order -> storage order
        arr = np.asarray(arr)[..., list(np.argsort(info.swizzle))]
    bits = info.bits_per_component
    if info.kind == "unorm":
        return float_to_unorm(arr, bits, dtype=info.dtype)
    if info.kind == "snorm":
        return float_to_snorm(arr, bits, dtype=info.dtype)
    if info.kind == "uint":
        return np.clip(np.rint(np.asarray(arr, np.float64)), 0,
                       float((1 << bits) - 1)).astype(info.dtype)
    if info.kind == "int":
        return np.clip(np.rint(np.asarray(arr, np.float64)),
                       float(-(1 << (bits - 1))),
                       float((1 << (bits - 1)) - 1)).astype(info.dtype)
    return np.asarray(arr).astype(info.dtype)


def _fit_components(f, src_c: int, dst_c: int):
    """Component adaptation like the reference's per-pair conversions:
    drop extras; missing color components get 0, missing alpha gets 1."""
    if src_c == dst_c:
        return f
    if dst_c < src_c:
        return f[..., :dst_c]
    pad = [f]
    if dst_c >= 4 > src_c:
        if src_c < 3:
            pad.append(np.zeros(f.shape[:-1] + (3 - src_c,), np.float32))
        pad.append(np.ones(f.shape[:-1] + (1,), np.float32))
    else:
        pad.append(np.zeros(f.shape[:-1] + (dst_c - src_c,), np.float32))
    out = np.concatenate(pad, axis=-1)
    return out[..., :dst_c]


def convert(arr, src: str, dst: str):
    """Convert an (…, C_src) array between formats (pixel_access.h store
    conversions, collapsed into one generic path)."""
    si, di = PIXEL_FORMATS[src], PIXEL_FORMATS[dst]
    arr = np.asarray(arr)
    if si.packed_bits is None and (
            arr.ndim == 0
            or (si.components > 1 and arr.shape[-1] != si.components)):
        raise ValueError(f"expected trailing dim {si.components} for {src}")
    f = _to_float(arr, si)
    if si.components == 1 and f.ndim and f.shape[-1] != 1:
        f = f[..., None]
    f = _fit_components(f, si.components, di.components)
    out = _from_float(f, di)
    if di.packed_bits is not None:
        return out
    return out[..., 0] if di.components == 1 else out


def store(target: np.ndarray, img, src: str, dst: str):
    """pixel_access::store — convert and overwrite the target buffer."""
    target[...] = convert(img, src, dst)
    return target


def blend(target: np.ndarray, img, src: str, dst: str, sfactor: float,
          dfactor: float):
    """pixel_access::blend — target = src*sfactor + target*dfactor in
    linear float, then re-quantized (detail/pixel_access.h blend path;
    jittered_blend uses sfactor=1/frame, dfactor=1-1/frame)."""
    di = PIXEL_FORMATS[dst]
    cur = _to_float(np.asarray(target), di)
    si = PIXEL_FORMATS[src]
    new = _fit_components(_to_float(np.asarray(img), si),
                          si.components, di.components)
    if di.components == 1 and cur.ndim == new.ndim - 1:
        cur = cur[..., None]
    mixed = new * sfactor + cur * dfactor
    out = _from_float(mixed, di)
    target[...] = out[..., 0] if di.components == 1 and \
        target.ndim < out.ndim else out
    return target


# ---------------------------------------------------------------------------
# Device-side store/blend (the other half of the reference's pixel_access
# matrix, detail/pixel_access.h:40+): the render loop accumulates straight
# into a quantized device buffer, as the reference's GL render targets do,
# where jittered_blend writes through pixel_access::blend into unorm8
# colour planes every frame.
#
# Quantization uses float32 scales on the device, as the JAX package's
# does: exact for <= 16-bit components; 32-bit unorm/snorm round trips
# need the f64 host path above.  Bit fields are built in int64 (PyTorch
# cannot shift uint32 on the CPU) and stored in the format's dtype.

_TORCH_DTYPES = {np.uint8: torch.uint8, np.uint16: torch.uint16,
                 np.uint32: torch.uint32, np.uint64: torch.uint64,
                 np.int8: torch.int8, np.int16: torch.int16,
                 np.int32: torch.int32, np.float16: torch.float16,
                 np.float32: torch.float32}


def torch_dtype(info: PixelFormatInfo) -> torch.dtype:
    """The storage dtype of a format on the device."""
    return _TORCH_DTYPES[info.dtype]


def _umax_bits(info):
    return float((1 << info.bits_per_component) - 1)


def _smax_bits(info):
    return float((1 << (info.bits_per_component - 1)) - 1)


def _to_int(q, lo: float, hi: float, dtype):
    """Integral float ``q`` saturated to [lo, hi], stored as ``dtype``."""
    return torch.clamp(q.to(torch.float64), lo, hi).to(torch.int64).to(dtype)


def _smallf_encode_device(f, bits):
    f = torch.clamp(f.to(torch.float32), 0.0, _SMALLF_MAX[bits])
    h = f.to(torch.float16).view(torch.int16).to(torch.int64) & 0xFFFF
    return (h >> (15 - bits)) & ((1 << bits) - 1)


def _smallf_decode_device(u, bits):
    h = (u.to(torch.int64) & ((1 << bits) - 1)) << (15 - bits)
    h = torch.where(h >= 1 << 15, h - (1 << 16), h)
    return h.to(torch.int16).view(torch.float16).to(torch.float32)


def _pack_device(f, info: PixelFormatInfo):
    out = torch.zeros(f.shape[:-1], dtype=torch.int64, device=f.device)
    shift = 0
    for c, bits in enumerate(info.packed_bits):
        comp = f[..., c]
        if info.kind == "unorm":
            q = torch.trunc(torch.clamp(comp, 0.0, 1.0)
                            * np.float32((1 << bits) - 1)).to(torch.int64)
        else:
            q = _smallf_encode_device(comp, bits)
        out = out | (q << shift)
        shift += bits
    return out.to(torch.uint32)


def _unpack_device(arr, info: PixelFormatInfo):
    arr = arr.to(torch.int64) & 0xFFFFFFFF
    comps = []
    shift = 0
    for bits in info.packed_bits:
        q = (arr >> shift) & ((1 << bits) - 1)
        if info.kind == "unorm":
            comps.append(q.to(torch.float32) / np.float32((1 << bits) - 1))
        else:
            comps.append(_smallf_decode_device(q, bits))
        shift += bits
    return torch.stack(comps, dim=-1)


def _to_float_device(arr, info: PixelFormatInfo):
    if info.packed_bits is not None:
        return _unpack_device(arr, info)
    if info.kind == "unorm":
        f = arr.to(torch.float32) / np.float32(_umax_bits(info))
    elif info.kind == "snorm":
        f = torch.clamp(arr.to(torch.float32) / np.float32(_smax_bits(info)),
                        min=-1.0)
    else:
        f = arr.to(torch.float32)
    if info.swizzle is not None:
        f = f[..., list(info.swizzle)]
    return f


def _from_float_device(f, info: PixelFormatInfo):
    if info.packed_bits is not None:
        return _pack_device(f, info)
    if info.swizzle is not None:
        f = f[..., list(np.argsort(info.swizzle))]
    dtype = torch_dtype(info)
    b = info.bits_per_component
    if info.kind == "unorm":
        q = torch.clamp(f, 0.0, 1.0) * np.float32(_umax_bits(info))
        return _to_int(torch.trunc(q), 0.0, _umax_bits(info), dtype)
    if info.kind == "snorm":
        q = torch.clamp(f, -1.0, 1.0) * np.float32(_smax_bits(info))
        return _to_int(torch.trunc(q), -_smax_bits(info) - 1.0,
                       _smax_bits(info), dtype)
    if info.kind == "uint":
        return _to_int(torch.clamp(torch.round(f), 0.0,
                                   float(np.float32((1 << b) - 1))),
                       0.0, float((1 << min(b, 63)) - 1), dtype)
    if info.kind == "int":
        return _to_int(torch.clamp(torch.round(f), -float(1 << (b - 1)),
                                   float(np.float32((1 << (b - 1)) - 1))),
                       -float(1 << (b - 1)), float((1 << (b - 1)) - 1),
                       dtype)
    return f.to(dtype)


def _fit_components_device(f, src_c: int, dst_c: int):
    if src_c == dst_c:
        return f
    if dst_c < src_c:
        return f[..., :dst_c]
    pad = [f]
    if dst_c >= 4 > src_c:
        if src_c < 3:
            pad.append(torch.zeros(f.shape[:-1] + (3 - src_c,),
                                   dtype=torch.float32, device=f.device))
        pad.append(torch.ones(f.shape[:-1] + (1,), dtype=torch.float32,
                              device=f.device))
    else:
        pad.append(torch.zeros(f.shape[:-1] + (dst_c - src_c,),
                               dtype=torch.float32, device=f.device))
    return torch.cat(pad, dim=-1)[..., :dst_c]


def convert_device(arr, src: str, dst: str):
    """convert() on the tensor's device, differentiable up to the
    quantization.  <= 16-bit formats match the host path bit for bit away
    from truncation boundaries (an f32 scale and an f64 one can differ by
    1 LSB where f * (2^bits - 1) lands within one ulp of an integer)."""
    si, di = PIXEL_FORMATS[src], PIXEL_FORMATS[dst]
    f = _to_float_device(arr, si)
    if si.components == 1 and (f.ndim == 0 or f.shape[-1] != 1):
        f = f[..., None]
    f = _fit_components_device(f, si.components, di.components)
    out = _from_float_device(f, di)
    if di.packed_bits is not None:
        return out
    return out[..., 0] if di.components == 1 else out


def store_device(target, img, src: str = "RGBA32F"):
    """Device-side pixel_access::store into a TypedRenderTarget."""
    return dataclasses.replace(
        target, color=convert_device(img, src, target.format))


def blend_device(target, img, sfactor, dfactor, src: str = "RGBA32F"):
    """Device-side pixel_access::blend: dequantize the current buffer, mix
    in linear float, requantize (jittered_blend: sfactor = 1/frame)."""
    di = PIXEL_FORMATS[target.format]
    si = PIXEL_FORMATS[src]
    cur = _to_float_device(target.color, di)
    new = _fit_components_device(_to_float_device(img, si),
                                 si.components, di.components)
    mixed = new * sfactor + cur * dfactor
    return dataclasses.replace(target, color=_from_float_device(mixed, di))


@dataclasses.dataclass
class TypedRenderTarget:
    """Device render target with a quantized colour plane (H, W, C) of the
    format's storage dtype, and a float depth plane (H, W)."""

    color: Any
    depth: Any
    format: str = "RGBA8"
    width: int = 0
    height: int = 0

    def as_float(self):
        return _to_float_device(self.color, PIXEL_FORMATS[self.format])


def make_typed_render_target(width: int, height: int, format: str = "RGBA8",
                             device="cuda") -> TypedRenderTarget:
    """Quantized device framebuffer (cpu_buffer_rt<PF_RGBA8, ...>
    analogue), zeroed: (H, W, C) of the format's dtype, (H, W) words for a
    packed format; write it with store_device / blend_device, or pass it
    as ``render(..., rt=...)``."""
    dev = resolve_device(device)
    info = PIXEL_FORMATS[format]
    # a packed format keeps one word a pixel (the JAX package's gives it
    # C words, which its own blend_device cannot unpack)
    shape = (height, width) + (() if info.packed_bits else
                               (info.components,))
    return TypedRenderTarget(
        color=torch.zeros(shape, dtype=torch_dtype(info), device=dev),
        depth=torch.zeros((height, width), dtype=torch.float32, device=dev),
        format=format, width=width, height=height)

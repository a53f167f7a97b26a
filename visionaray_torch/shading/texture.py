"""Textures: 1D/2D/3D sampling with address modes and filters (port of
shading/texture.py; reference include/visionaray/texture/).

- address modes: WRAP, MIRROR, CLAMP, BORDER (BORDER taps outside
  [0, size) read ``border_value``);
- filters: NEAREST, LINEAR (bi/trilinear), BSPLINE (4-tap uniform cubic
  B-spline), BSPLINE_INTERPOL (the B-spline over coefficients prefiltered
  at upload, so it interpolates the texels), CARDINAL_SPLINE (Catmull-Rom).

The textures of a scene are packed into one atlas (M, H, W, 3) with a
leading material index, so a batch of rays gathers from different textures
in one call.  Every sample is differentiable with respect to the texels,
and LINEAR and the cubic filters with respect to the coordinates.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import IntEnum
from typing import Any

import numpy as np
import torch

from visionaray_torch.device import resolve_device


class AddressMode(IntEnum):
    WRAP = 0
    MIRROR = 1
    CLAMP = 2
    BORDER = 3


class Filter(IntEnum):
    NEAREST = 0
    LINEAR = 1
    BSPLINE = 2
    # the B-spline over prefiltered coefficients (reference forward.h:18-34
    # BSplineInterpol, detail/prefilter.h; prefilter_bspline below)
    BSPLINE_INTERPOL = 3
    # Catmull-Rom (reference detail/filter/common.h:188-229)
    CARDINAL_SPLINE = 4


_POLE = float(np.sqrt(3.0) - 2.0)       # cubic B-spline IIR pole
_LAMBDA = 6.0                            # gain (1-z)(1-1/z) for that pole


def _cubic_weights(t, kind: int):
    """The 4 tap weights at fractional position t in [0, 1).

    BSPLINE, BSPLINE_INTERPOL: Mitchell-Netravali B=1, C=0, the uniform
    cubic B-spline (detail/filter/common.h:145-186); CARDINAL_SPLINE:
    Catmull-Rom (B=0, C=0.5, :188-229), interpolating without a prefilter.
    """
    t2 = t * t
    t3 = t2 * t
    if kind == Filter.CARDINAL_SPLINE:
        return (-0.5 * t3 + t2 - 0.5 * t,
                1.5 * t3 - 2.5 * t2 + 1.0,
                -1.5 * t3 + 2.0 * t2 + 0.5 * t,
                0.5 * t3 - 0.5 * t2)
    s = 1 - t
    return (s * s * s / 6.0,
            (3 * t3 - 6 * t2 + 4) / 6.0,
            (-3 * t3 + 3 * t2 + 3 * t + 1) / 6.0,
            t3 / 6.0)


def _prefilter_axis(c, axis: int):
    """Causal and anticausal IIR pass along ``axis`` (Unser's B-spline
    transform; the reference's Ruijters prefilter, texture/detail/
    prefilter.h): causal start from a 12-term horizon sum
    c+(0) = sum_k pole^k c(k), anticausal start pole/(pole-1) * last."""
    c = torch.movedim(c, axis, 0)
    n = c.shape[0]
    hor = min(12, n)
    zk = torch.as_tensor((_POLE ** np.arange(hor)).astype(np.float32),
                         device=c.device)
    y = _LAMBDA * torch.tensordot(zk, c[:hor], dims=([0], [0]))
    fwd = [y]
    for k in range(1, n):
        y = _LAMBDA * c[k] + _POLE * y
        fwd.append(y)
    y = (_POLE / (_POLE - 1.0)) * fwd[-1]
    out = [y]
    for k in range(n - 2, -1, -1):
        y = _POLE * (y - fwd[k])
        out.append(y)
    return torch.movedim(torch.stack(out[::-1]), 0, axis)


def prefilter_bspline(texels, ndim: int | None = None):
    """B-spline coefficients of ``texels`` for BSPLINE_INTERPOL, along the
    first ``ndim`` axes (default: all but a trailing channel axis of at
    most 4).  Run once at upload, as the reference's
    convert_to_bspline_coeffs is (prefilter.h:96-204)."""
    if ndim is None:
        ndim = texels.ndim - 1 if texels.shape[-1] <= 4 else texels.ndim
    out = texels.to(torch.float32)
    for ax in range(ndim):
        out = _prefilter_axis(out, ax)
    return out


def _resolve_coord(x, size, mode: int):
    """Integer texel coordinate -> (index in [0, size), in-bounds mask)."""
    ones = torch.ones(x.shape, dtype=torch.bool, device=x.device)
    if mode == AddressMode.WRAP:
        return torch.remainder(x, size), ones
    if mode == AddressMode.MIRROR:
        period = 2 * size
        m = torch.remainder(x, period)
        return torch.where(m < size, m, period - 1 - m), ones
    if mode == AddressMode.CLAMP:
        return torch.clamp(x, 0, size - 1), ones
    inb = (x >= 0) & (x < size)      # BORDER
    return torch.clamp(x, 0, size - 1), inb


def _ifloor(x):
    return torch.floor(x).to(torch.int32)


def _taps2d(fetch, x, y, filter: int):
    """LINEAR or cubic 2D taps around unnormalized (x, y)."""
    x0, y0 = _ifloor(x), _ifloor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    if filter == Filter.LINEAR:
        return ((1 - fx) * (1 - fy) * fetch(x0, y0)
                + fx * (1 - fy) * fetch(x0 + 1, y0)
                + (1 - fx) * fy * fetch(x0, y0 + 1)
                + fx * fy * fetch(x0 + 1, y0 + 1))
    wx = _cubic_weights(fx, filter)
    wy = _cubic_weights(fy, filter)
    out = 0.0
    for j in range(4):
        row = 0.0
        for i in range(4):
            row = row + wx[i] * fetch(x0 - 1 + i, y0 - 1 + j)
        out = out + wy[j] * row
    return out


def tex2d(texels, u, v, filter: int = Filter.LINEAR,
          address_mode: int = AddressMode.WRAP, border_value=0.0):
    """Sample an (H, W, C) texture at normalized (u, v), v = 0 on row 0
    (tex2D)."""
    H, W = texels.shape[0], texels.shape[1]
    x = u * W - 0.5
    y = v * H - 0.5

    def fetch(xi, yi):
        xi2, bx = _resolve_coord(xi, W, address_mode)
        yi2, by = _resolve_coord(yi, H, address_mode)
        val = texels[yi2.long(), xi2.long()]
        return torch.where((bx & by)[..., None], val, border_value)

    if filter == Filter.NEAREST:
        return fetch(_ifloor(x + 0.5), _ifloor(y + 0.5))
    return _taps2d(fetch, x, y, filter)


def tex1d(texels, u, filter: int = Filter.LINEAR,
          address_mode: int = AddressMode.CLAMP, border_value=0.0):
    """Sample an (N, C) 1D texture (transfer functions)."""
    N = texels.shape[0]
    x = u * N - 0.5

    def fetch(xi):
        xi2, b = _resolve_coord(xi, N, address_mode)
        return torch.where(b[..., None], texels[xi2.long()], border_value)

    if filter == Filter.NEAREST:
        return fetch(_ifloor(x + 0.5))
    x0 = _ifloor(x)
    fx = (x - x0)[..., None]
    if filter == Filter.LINEAR:
        return (1 - fx) * fetch(x0) + fx * fetch(x0 + 1)
    w = _cubic_weights(fx, filter)
    out = 0.0
    for i in range(4):
        out = out + w[i] * fetch(x0 - 1 + i)
    return out


def tex3d(texels, u, v, w, filter: int = Filter.LINEAR,
          address_mode: int = AddressMode.CLAMP, border_value=0.0):
    """Sample a (D, H, W) or (D, H, W, C) volume (tex3D)."""
    squeeze = texels.ndim == 3
    if squeeze:
        texels = texels[..., None]
    D, H, W = texels.shape[:3]
    x = u * W - 0.5
    y = v * H - 0.5
    z = w * D - 0.5

    def fetch(xi, yi, zi):
        xi2, bx = _resolve_coord(xi, W, address_mode)
        yi2, by = _resolve_coord(yi, H, address_mode)
        zi2, bz = _resolve_coord(zi, D, address_mode)
        val = texels[zi2.long(), yi2.long(), xi2.long()]
        return torch.where((bx & by & bz)[..., None], val, border_value)

    if filter == Filter.NEAREST:
        out = fetch(_ifloor(x + 0.5), _ifloor(y + 0.5), _ifloor(z + 0.5))
    elif filter == Filter.LINEAR:
        x0, y0, z0 = _ifloor(x), _ifloor(y), _ifloor(z)
        fx = (x - x0)[..., None]
        fy = (y - y0)[..., None]
        fz = (z - z0)[..., None]
        out = 0.0
        for dz in (0, 1):
            wz = fz if dz else (1 - fz)
            for dy in (0, 1):
                wy = fy if dy else (1 - fy)
                for dx in (0, 1):
                    wx = fx if dx else (1 - fx)
                    out = out + wx * wy * wz * fetch(x0 + dx, y0 + dy,
                                                     z0 + dz)
    else:
        x0, y0, z0 = _ifloor(x), _ifloor(y), _ifloor(z)
        wx = _cubic_weights((x - x0)[..., None], filter)
        wy = _cubic_weights((y - y0)[..., None], filter)
        wz = _cubic_weights((z - z0)[..., None], filter)
        out = 0.0
        for k in range(4):
            plane = 0.0
            for j in range(4):
                row = 0.0
                for i in range(4):
                    row = row + wx[i] * fetch(x0 - 1 + i, y0 - 1 + j,
                                              z0 - 1 + k)
                plane = plane + wy[j] * row
            out = out + wz[k] * plane
    return out[..., 0] if squeeze else out


@dataclass
class TextureAtlas:
    """Per-material 2D textures packed into one (M, H, W, 3) tensor;
    ``enabled`` (M,) masks the materials without one (they sample white,
    as get_surface does without textures).  ``filter`` and
    ``address_mode`` are plain ints, shared by every texture."""

    texels: Any    # (M, H, W, 3) f32
    enabled: Any   # (M,) bool
    filter: int = int(Filter.LINEAR)
    address_mode: int = int(AddressMode.WRAP)

    @staticmethod
    def pack(images, num_materials: int, resolution: int = 256,
             filter: int = Filter.LINEAR,
             address_mode: int = AddressMode.WRAP,
             device="cuda") -> "TextureAtlas":
        """``images``: {material index: (H, W, 3+) float array}; each is
        nearest-resized on the host to ``resolution`` square.  Under
        BSPLINE_INTERPOL the atlas is prefiltered here, once, as the
        reference's texture::reset() does."""
        dev = resolve_device(device)
        tex = np.ones((num_materials, resolution, resolution, 3), np.float32)
        enabled = np.zeros((num_materials,), bool)
        for gid, img in images.items():
            img = np.asarray(img, np.float32)
            if img.shape[:2] != (resolution, resolution):
                ys = (np.arange(resolution) * img.shape[0]
                      // resolution).astype(int)
                xs = (np.arange(resolution) * img.shape[1]
                      // resolution).astype(int)
                img = img[ys][:, xs]
            tex[gid] = img[..., :3]
            enabled[gid] = True
        texels = torch.as_tensor(tex, device=dev)
        if int(filter) == int(Filter.BSPLINE_INTERPOL):
            # every texture along its rows and columns (axes 1 and 2)
            texels = _prefilter_axis(_prefilter_axis(texels, 1), 2)
        return TextureAtlas(texels=texels,
                            enabled=torch.as_tensor(enabled, device=dev),
                            filter=int(filter),
                            address_mode=int(address_mode))


def sample_scene_texture(atlas: TextureAtlas, geom_id, uv):
    """Each ray's texel color from its material's texture at ``uv``
    (..., 2); white where the material has none."""
    M, H, W, _ = atlas.texels.shape
    gid = torch.clamp(geom_id, 0, M - 1).long()
    x = uv[..., 0] * W - 0.5
    y = uv[..., 1] * H - 0.5

    def fetch(xi, yi):
        xi2, bx = _resolve_coord(xi, W, atlas.address_mode)
        yi2, by = _resolve_coord(yi, H, atlas.address_mode)
        # BORDER taps outside [0, size) read 0, as tex2d's do
        return torch.where((bx & by)[..., None],
                           atlas.texels[gid, yi2.long(), xi2.long()], 0.0)

    if atlas.filter == Filter.NEAREST:
        val = fetch(_ifloor(x + 0.5), _ifloor(y + 0.5))
    else:
        val = _taps2d(fetch, x, y, atlas.filter)
    return torch.where(atlas.enabled[gid][..., None], val,
                       torch.ones_like(val))

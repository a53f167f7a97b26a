"""Spectral power distributions and color conversion (port of
shading/spectrum.py).

A spectrum is a tensor whose trailing axis is the sample axis: (..., 3) is
RGB, the default everywhere; (..., N) is an N-sample SPD over
``lambdas(N)``, and ``to_rgb`` folds it back for display.  Every function
is elementwise PyTorch and differentiable.

  cie_x/y/z            multi-lobe gaussian fits of the CIE 1931 observer
                       (reference detail/color_conversion.h:28-57)
  xyz_to_rgb           sRGB/D65 matrix (color_conversion.h:92-104)
  spd_to_rgb/luminance integration against the fits (:110-151)
  from_rgb             3-bin box lift b/g/r -> thirds of [400, 700] nm
                       (detail/spectrum.inl:331-361)
  blackbody            Planck's law per micron (detail/spd/blackbody.h)
  d65 / cornell_*      measured tables (spd_data.py)
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from visionaray_torch.device import resolve_device
from visionaray_torch.shading import spd_data
from visionaray_torch.shading.lights import light_groups

NUM_SAMPLES = 300        # spectral mode sample count (spectrum.h:34)
LAMBDA_MIN = 400.0
LAMBDA_MAX = 700.0


def lambdas(n: int = NUM_SAMPLES, device="cuda"):
    """Sample wavelengths (nm), endpoints included, in jnp.linspace's f32
    arithmetic: start * (1 - s) + stop * s with s = i / (n - 1)."""
    dev = resolve_device(device)
    if n == 1:
        return torch.full((1,), LAMBDA_MIN, dtype=torch.float32, device=dev)
    s = torch.arange(n - 1, dtype=torch.float32, device=dev) / float(n - 1)
    out = LAMBDA_MIN * (1 - s) + LAMBDA_MAX * s
    return torch.cat([out, torch.full((1,), LAMBDA_MAX, dtype=torch.float32,
                                      device=dev)])


def _f32(x):
    """f32 tensor of ``x``, on its device (a tensor) or on the CPU."""
    return torch.as_tensor(x, dtype=torch.float32)


# --- CIE 1931 standard observer (multi-lobe gaussian fits) ---------------

def _lobe(lam, mu, lo, hi):
    t = (lam - mu) * torch.where(lam < mu, lo, hi)
    return torch.exp(-0.5 * t * t)


def cie_x(lam):
    lam = _f32(lam)
    return (0.362 * _lobe(lam, 442.0, 0.0624, 0.0374)
            + 1.056 * _lobe(lam, 599.8, 0.0264, 0.0323)
            - 0.065 * _lobe(lam, 501.1, 0.0490, 0.0382))


def cie_y(lam):
    lam = _f32(lam)
    return (0.821 * _lobe(lam, 568.8, 0.0213, 0.0247)
            + 0.286 * _lobe(lam, 530.9, 0.0613, 0.0322))


def cie_z(lam):
    lam = _f32(lam)
    return (1.217 * _lobe(lam, 437.0, 0.0845, 0.0278)
            + 0.681 * _lobe(lam, 459.0, 0.0385, 0.0725))


# --- XYZ <-> RGB (sRGB primaries, D65 white) ------------------------------

_XYZ_TO_RGB = np.array([
    [3.2404542, -1.5371385, -0.4985314],
    [-0.9692660, 1.8760108, 0.0415560],
    [0.0556434, -0.2040259, 1.0572252],
], np.float32)


def xyz_to_rgb(xyz):
    m = torch.as_tensor(_XYZ_TO_RGB, device=xyz.device)
    return xyz @ m.T


def spd_to_rgb(samples, lam=None):
    """Integrate a sampled SPD (..., N) against the CIE fits -> (..., 3),
    normalized by sum(cie_y) (color_conversion.h:131)."""
    if lam is None:
        lam = lambdas(samples.shape[-1], samples.device)
    x = torch.sum(samples * cie_x(lam), dim=-1)
    y = torch.sum(samples * cie_y(lam), dim=-1)
    z = torch.sum(samples * cie_z(lam), dim=-1)
    n = torch.sum(cie_y(lam))
    return xyz_to_rgb(torch.stack([x, y, z], dim=-1) / n)


def spd_to_luminance(samples, lam=None):
    """Y integral (cd/m^2), unnormalized (color_conversion.h:145-151)."""
    if lam is None:
        lam = lambdas(samples.shape[-1], samples.device)
    return torch.sum(samples * cie_y(lam), dim=-1)


def to_rgb(samples):
    """RGB passes through; any other sample count is integrated."""
    if samples.shape[-1] == 3:
        return samples
    return spd_to_rgb(samples)


def to_luminance(samples):
    """Luminance: RGB through the reference's Rec.601 luma
    (spectrum.inl:391-397), an SPD through the Y integral."""
    if samples.shape[-1] == 3:
        w = torch.tensor([0.3, 0.59, 0.11], dtype=torch.float32,
                         device=samples.device)
        return torch.sum(samples * w, dim=-1)
    return spd_to_luminance(samples)


def from_rgb(rgb, n: int = NUM_SAMPLES):
    """Lift RGB (..., 3) to a box spectrum (..., n): sample i falls in bin
    (3 i) // n, and bins 0, 1, 2 take b, g, r."""
    if n == 3:
        return rgb
    bin_ = (torch.arange(n, device=rgb.device) * 3) // n
    src = 2 - bin_          # bin 0 -> blue (2), 1 -> green, 2 -> red (0)
    return torch.index_select(rgb, -1, src)


# --- SPDs ------------------------------------------------------------------

def lift_scene(scene, n: int = NUM_SAMPLES):
    """The scene in spectral mode: every material color and every light's
    ``cl`` lifted from RGB to an n-sample SPD (the reference's
    VSNRAY_SPECTRUM_RGB toggle, spectrum.h:17).  Geometry, trees and
    textures stay; the path tracer reads the channel count from
    ``materials.cd`` and folds the result back through ``to_rgb``."""
    def lift(lights):
        if lights is None or lights.num_lights == 0:
            return lights
        return dataclasses.replace(lights, cl=from_rgb(lights.cl, n))

    groups = [lift(g) for g in light_groups(scene.lights)]
    lights = (type(scene.lights)(groups)
              if isinstance(scene.lights, (tuple, list))
              else (groups[0] if groups else scene.lights))
    return dataclasses.replace(scene, materials=scene.materials.to_spectral(n),
                               lights=lights)


def blackbody(temperature, lam):
    """Planck spectral radiance (W/m^2/sr/micron), lambda in nm
    (detail/spd/blackbody.h:26-37)."""
    k = 1.3806488e-23
    h = 6.62606957e-34
    c = 2.99792458e8
    lam_um = _f32(lam) * 1e-3
    l2 = lam_um * lam_um
    l5 = lam_um * (l2 * l2)     # jnp's integer power: x * x^4
    return ((2.0e24 * h * c * c) / l5
            / (torch.exp((1e6 * h * c) / (lam_um * k * temperature)) - 1.0))


def _interp(x, fp):
    """jnp.interp(x, arange(len(fp)), fp): fp[0] below the table, fp[-1]
    above it, linear in between."""
    fp = torch.as_tensor(fp, dtype=torch.float32, device=x.device)
    xp = torch.arange(fp.shape[0], dtype=torch.float32, device=x.device)
    i = torch.clamp(torch.searchsorted(xp, x.contiguous(), right=True), 1,
                    fp.shape[0] - 1)
    f = fp[i - 1] + (x - xp[i - 1]) / (xp[i] - xp[i - 1]) * (fp[i] - fp[i - 1])
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def d65(lam):
    """CIE D65, normalized P(560) = 1; 0 outside [300, 830) (detail/spd/
    d65.h)."""
    lam = _f32(lam)
    x = (lam - spd_data.D65_LAMBDA_MIN) / spd_data.D65_LAMBDA_STEP
    v = _interp(x, spd_data.D65_TABLE)
    return torch.where((lam < 300.0) | (lam >= 830.0), 0.0, v)


def _cornell(table, step, lam):
    lam = _f32(lam)
    x = (lam - spd_data.CORNELL_LAMBDA_MIN) / step
    v = _interp(x, table)
    return torch.where((lam < spd_data.CORNELL_LAMBDA_MIN)
                       | (lam >= spd_data.CORNELL_LAMBDA_MAX), 0.0, v)


def cornell_white(lam):
    return _cornell(spd_data.CORNELL_WHITE, 4.0, lam)


def cornell_green(lam):
    return _cornell(spd_data.CORNELL_GREEN, 4.0, lam)


def cornell_red(lam):
    return _cornell(spd_data.CORNELL_RED, 4.0, lam)


def cornell_light(lam):
    return _cornell(spd_data.CORNELL_LIGHT, 100.0, lam)

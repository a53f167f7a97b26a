"""BRDFs: lambertian, blinn, specular reflection + fresnel (port of
shading/brdf.py).  Batched over rays; sampling takes explicit uniforms."""

from __future__ import annotations

import math

import torch

from visionaray_torch.core.vecmath import (
    dot, normalize, orthonormal_basis, reflect, saturate,
)

INV_PI = 1.0 / math.pi
TWO_PI = 2.0 * math.pi


def cosine_sample_hemisphere(u1, u2):
    """r = sqrt(u1); theta = 2*pi*u2; z = sqrt(1 - u1)."""
    r = torch.sqrt(u1)
    theta = TWO_PI * u2
    x = r * torch.cos(theta)
    y = r * torch.sin(theta)
    z = torch.sqrt(torch.clamp_min(1.0 - u1, 0.0))
    return torch.stack([x, y, z], dim=-1)


def uniform_sample_hemisphere(u1, u2):
    """r = sqrt(1 - u1^2), phi = 2 pi u2, z = u1 (reference
    sampling.h)."""
    r = torch.sqrt(torch.clamp_min(1.0 - u1 * u1, 0.0))
    phi = TWO_PI * u2
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), u1], dim=-1)


def fresnel_reflectance_conductor(eta, k, cosi):
    """Conductor Fresnel; eta/k (..., 3), cosi (...)."""
    cosi = cosi[..., None]
    e2k2 = eta * eta + k * k
    rs2 = (e2k2 - 2.0 * eta * cosi + cosi * cosi) / \
          (e2k2 + 2.0 * eta * cosi + cosi * cosi)
    rp2 = (e2k2 * cosi * cosi - 2.0 * eta * cosi + 1.0) / \
          (e2k2 * cosi * cosi + 2.0 * eta * cosi + 1.0)
    return (rs2 + rp2) / 2.0


def fresnel_reflectance_dielectric(eta, cosi, cost):
    """Dielectric Fresnel: the mean of the parallel and perpendicular
    reflectances."""
    rparl = (eta * cosi - cost) / (eta * cosi + cost)
    rperp = (cosi - eta * cost) / (cosi + eta * cost)
    return (rparl * rparl + rperp * rperp) / 2.0


def lambertian_f(cd, kd):
    """f = cd * kd / pi."""
    return cd * (kd * INV_PI)[..., None]


def lambertian_sample_f(cd, kd, n, wo, u1, u2):
    """Cosine-hemisphere sample about n; returns (f, wi, pdf)."""
    u, v = orthonormal_basis(n)
    sp = cosine_sample_hemisphere(u1, u2)
    wi = normalize(sp[..., 0:1] * u + sp[..., 1:2] * v + sp[..., 2:3] * n)
    pdf = dot(n, wi) * INV_PI
    return lambertian_f(cd, kd), wi, pdf


def phong_f(cs, ks, exp, n, wo, wi):
    """Phong: cs * ks (exp + 2) / (2 pi) * max(0, reflect(wo, n) . wi)^exp
    (reference brdf.h)."""
    r = reflect(wo, n)
    rdotl = torch.clamp_min(dot(r, wi), 0.0)
    scale = ks * ((exp + 2.0) / TWO_PI) * torch.pow(rdotl, exp)
    return cs * scale[..., None]


def blinn_f(cs, ks, exp, n, wo, wi):
    h = normalize(wo + wi)
    hdotn = torch.clamp_min(dot(h, n), 0.0)
    spec = cs * ks[..., None]
    schlick = spec + (1.0 - spec) * \
        torch.pow(1.0 - saturate(dot(wi, h)), 5.0)[..., None]
    nfactor = (exp + 2.0) / (8.0 * math.pi)
    return schlick * (nfactor * torch.pow(hdotn, exp))[..., None]


def blinn_sample_f(cs, ks, exp, n, wo, u1, u2):
    """Power-cosine half-vector sampling; returns (f, wi, pdf).

    A half vector within rounding of perpendicular to ``wo`` reflects it
    onto exactly ``-wo``, as ``wo . h == 0`` does: the reference gives
    such a sample pdf 0 only where ``wo . h`` is exactly 0, and a tiny
    nonzero ``wo . h`` leaves it a finite pdf and ``blinn_f``'s
    ``normalize(wo + wi)`` a NaN colour, which ``next_ray`` multiplies
    into dst (visionaray_tpu/shading/brdf.py:94, :114-119 do the same).
    Here every sample with ``wo + wi == 0`` gets pdf 0 and colour 0
    (``blinn_f`` taken at ``wo`` in its place, so that no NaN enters the
    graph); every other sample is unchanged, bit for bit."""
    costheta = torch.pow(u1, 1.0 / (exp + 1.0))
    sintheta = torch.sqrt(torch.clamp_min(1.0 - costheta * costheta, 0.0))
    phi = u2 * TWO_PI
    u, v = orthonormal_basis(n)
    h = normalize(
        (sintheta * torch.cos(phi))[..., None] * u
        + (sintheta * torch.sin(phi))[..., None] * v
        + costheta[..., None] * n
    )
    wi = reflect(wo, h)
    vdoth = dot(wo, h)
    pdf = ((exp + 1.0) * torch.pow(costheta, exp)) / \
          (2.0 * math.pi * 4.0 * torch.where(vdoth != 0.0, vdoth, 1.0))
    ok = torch.any(wo + wi != 0.0, dim=-1)
    pdf = torch.where(ok, pdf, 0.0)
    f = blinn_f(cs, ks, exp, n, wo, torch.where(ok[..., None], wi, wo))
    return torch.where(ok[..., None], f, 0.0), wi, pdf


def specular_reflection_sample_f(cr, kr, ior, absorption, n, wo):
    """Perfect mirror; returns (f, wi, pdf=1)."""
    wi = reflect(wo, n)
    pdf = torch.ones(wo.shape[:-1], dtype=wo.dtype, device=wo.device)
    fr = fresnel_reflectance_conductor(ior, absorption, torch.abs(dot(n, wo)))
    ndotwi = torch.abs(dot(n, wi))
    safe = torch.where(ndotwi != 0.0, ndotwi, 1.0)
    f = fr * cr * kr[..., None] / safe[..., None]
    return f, wi, pdf

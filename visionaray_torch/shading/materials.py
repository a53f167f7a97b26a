"""Material system: SoA table + masked type dispatch (port of
shading/materials.py).  Every branch is computed and selected by ``mtype``,
the select/mask idiom of the reference's SIMD path."""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from enum import IntEnum
from typing import Any

import torch

from visionaray_torch.core.vecmath import dot, reflect
from visionaray_torch.device import resolve_device, take
from visionaray_torch.shading import brdf


class MaterialType(IntEnum):
    EMISSIVE = 0
    MATTE = 1
    MIRROR = 2
    PLASTIC = 3


_VEC_FIELDS = ("ca", "cd", "cs", "cr", "ior", "absorption", "ce")


@dataclass
class Materials:
    """SoA material table; every field has leading dim M (or the ray batch
    once gathered by ``take``)."""

    mtype: Any         # (M,) i32
    ca: Any            # (M, 3) ambient color
    ka: Any            # (M,)
    cd: Any            # (M, 3) diffuse color
    kd: Any            # (M,)
    cs: Any            # (M, 3) specular color
    ks: Any            # (M,)
    specular_exp: Any  # (M,)
    cr: Any            # (M, 3) mirror color
    kr: Any            # (M,)
    ior: Any           # (M, 3) conductor eta
    absorption: Any    # (M, 3) conductor k
    ce: Any            # (M, 3) emissive color
    ls: Any            # (M,)

    # ------------------------------------------------------------------ build
    @staticmethod
    def zeros(M: int, device="cuda") -> "Materials":
        dev = resolve_device(device)

        def v3():
            return torch.zeros((M, 3), dtype=torch.float32, device=dev)

        def v1():
            return torch.zeros((M,), dtype=torch.float32, device=dev)

        return Materials(
            mtype=torch.full((M,), int(MaterialType.MATTE), dtype=torch.int32,
                             device=dev),
            ca=v3(), ka=v1(), cd=v3(), kd=v1(), cs=v3(), ks=v1(),
            specular_exp=torch.ones((M,), dtype=torch.float32, device=dev),
            cr=v3(), kr=v1(), ior=v3(), absorption=v3(), ce=v3(), ls=v1())

    @staticmethod
    def _make(mtype, device, **fields) -> "Materials":
        dev = resolve_device(device)
        arrs = {k: torch.as_tensor(v, dtype=torch.float32, device=dev)
                for k, v in fields.items()}
        M = 1
        for k, a in arrs.items():
            if k in _VEC_FIELDS:
                n = a.reshape(-1, 3).shape[0] if a.ndim >= 2 else 1
            else:
                n = a.reshape(-1).shape[0]
            M = max(M, n)
        out = {"mtype": torch.full((M,), int(mtype), dtype=torch.int32,
                                   device=dev)}
        for k, a in arrs.items():
            if k in _VEC_FIELDS:
                a = a.reshape(-1, 3) if a.ndim <= 1 else a
                out[k] = a.expand(M, 3).contiguous()
            else:
                out[k] = a.reshape(-1).expand(M).contiguous()
        return dataclasses.replace(Materials.zeros(M, dev), **out)

    @staticmethod
    def default(device="cuda") -> "Materials":
        return Materials.matte(cd=(0.8, 0.8, 0.8), device=device)

    @staticmethod
    def matte(cd=(0.8, 0.8, 0.8), kd=1.0, ca=(0.2, 0.2, 0.2), ka=1.0,
              device="cuda"):
        return Materials._make(MaterialType.MATTE, device, cd=cd, kd=kd,
                               ca=ca, ka=ka)

    @staticmethod
    def emissive(ce=(1.0, 1.0, 1.0), ls=1.0, device="cuda"):
        return Materials._make(MaterialType.EMISSIVE, device, ce=ce, ls=ls)

    @staticmethod
    def mirror(cr=(1.0, 1.0, 1.0), kr=1.0, ior=(1.34, 0.96, 0.62),
               absorption=(7.5, 6.4, 5.4), device="cuda"):
        return Materials._make(MaterialType.MIRROR, device, cr=cr, kr=kr,
                               ior=ior, absorption=absorption)

    @staticmethod
    def plastic(cd=(0.8, 0.8, 0.8), kd=1.0, cs=(0.2, 0.2, 0.2), ks=1.0,
                specular_exp=32.0, ca=(0.2, 0.2, 0.2), ka=1.0,
                device="cuda"):
        return Materials._make(MaterialType.PLASTIC, device, cd=cd, kd=kd,
                               cs=cs, ks=ks, specular_exp=specular_exp,
                               ca=ca, ka=ka)

    @staticmethod
    def concatenate(mats) -> "Materials":
        return Materials(**{
            f.name: torch.cat([getattr(m, f.name) for m in mats], dim=0)
            for f in dataclasses.fields(Materials)})

    @property
    def num_materials(self):
        return self.mtype.shape[0]

    def take(self, idx) -> "Materials":
        """Gather per-ray material rows by index."""
        return Materials(**{f.name: take(getattr(self, f.name), idx)
                            for f in dataclasses.fields(self)})

    # --------------------------------------------------------------- interface
    def ambient(self):
        """Per-type ambient term: ca * ka for matte and plastic, 0 for the
        other types."""
        amb = self.ca * self.ka[..., None]
        is_amb = (self.mtype == MaterialType.MATTE) | \
                 (self.mtype == MaterialType.PLASTIC)
        return torch.where(is_amb[..., None], amb, torch.zeros_like(amb))

    def shade(self, n, view_dir, light_dir, light_intensity):
        """Direct-lighting shade per material type (matte, plastic: pi*f*I*
        max(0, n.l); mirror: 0; emissive: ce*ls)."""
        ndotl = torch.clamp_min(dot(n, light_dir), 0.0)[..., None]
        diffuse = brdf.lambertian_f(self.cd, self.kd)
        spec = brdf.blinn_f(self.cs, self.ks, self.specular_exp,
                            n, view_dir, light_dir)
        matte_c = math.pi * diffuse * light_intensity * ndotl
        plastic_c = math.pi * (diffuse + spec) * light_intensity * ndotl
        emissive_c = self.ce * self.ls[..., None]
        zero = torch.zeros_like(matte_c)
        t = self.mtype[..., None]
        return torch.where(
            t == MaterialType.PLASTIC, plastic_c,
            torch.where(t == MaterialType.MATTE, matte_c,
                        torch.where(t == MaterialType.EMISSIVE, emissive_c,
                                    zero)))

    def sample(self, n, view_dir, u_lobe, u1, u2):
        """BRDF importance sample per type; returns (color, wi, pdf)."""
        f_d, wi_d, pdf_d = brdf.lambertian_sample_f(
            self.cd, self.kd, n, view_dir, u1, u2)
        f_s, wi_s, pdf_s = brdf.blinn_sample_f(
            self.cs, self.ks, self.specular_exp, n, view_dir, u1, u2)
        f_m, wi_m, pdf_m = brdf.specular_reflection_sample_f(
            self.cr, self.kr, self.ior, self.absorption, n, view_dir)

        # plastic lobe probabilities
        prob_diff = torch.mean(self.cd, dim=-1) * self.kd
        prob_spec = torch.mean(self.cs, dim=-1) * self.ks
        all_zero = (prob_diff == 0.0) & (prob_spec == 0.0)
        prob_diff = torch.where(all_zero, 0.5, prob_diff)
        prob_spec = torch.where(all_zero, 0.5, prob_spec)
        prob_diff = prob_diff / (prob_diff + prob_spec)
        take_diff = u_lobe < prob_diff
        f_p = torch.where(take_diff[..., None], f_d, f_s)
        wi_p = torch.where(take_diff[..., None], wi_d, wi_s)
        pdf_p = torch.where(take_diff, pdf_d, pdf_s)

        emissive_f = self.ce * self.ls[..., None]

        t = self.mtype
        t3 = t[..., None]
        f = torch.where(
            t3 == MaterialType.PLASTIC, f_p,
            torch.where(t3 == MaterialType.MATTE, f_d,
                        torch.where(t3 == MaterialType.MIRROR, f_m,
                                    emissive_f)))
        wi = torch.where(
            t3 == MaterialType.PLASTIC, wi_p,
            torch.where(t3 == MaterialType.MATTE, wi_d, wi_m))
        pdf = torch.where(
            t == MaterialType.PLASTIC, pdf_p,
            torch.where(t == MaterialType.MATTE, pdf_d,
                        torch.where(t == MaterialType.MIRROR, pdf_m,
                                    torch.ones_like(pdf_d))))
        return f, wi, pdf

    def specular_bounce(self, view_dir, normal):
        """Whitted-bounce reflectivity per type: matte kr = 0, mirror
        kr = mat.kr, every other type (plastic, emissive) 0.1.  Returns
        (reflected_dir, kr)."""
        refl = reflect(view_dir, normal)
        kr = torch.where(
            self.mtype == MaterialType.MATTE, 0.0,
            torch.where(self.mtype == MaterialType.MIRROR, self.kr, 0.1))
        return refl, kr

    def is_emissive(self):
        return self.mtype == MaterialType.EMISSIVE

    def is_specular(self):
        """Delta-BSDF types (mirror): NEE cannot see light through them."""
        return self.mtype == MaterialType.MIRROR

    def to_spectral(self, n: int = 300) -> "Materials":
        """Every color field lifted from RGB to an n-sample SPD (the
        reference built without VSNRAY_SPECTRUM_RGB, spectrum.h:17): the
        shading algebra is channel-count agnostic, so lifting the fields
        is the whole switch."""
        from visionaray_torch.shading.spectrum import from_rgb
        return dataclasses.replace(
            self, **{f: from_rgb(getattr(self, f), n) for f in _VEC_FIELDS})

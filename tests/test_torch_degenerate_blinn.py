"""A Blinn half-vector sample within rounding of perpendicular to the view
direction (ROADMAP A1): shading/brdf.py::blinn_sample_f against the
formula it had before its guard and against the JAX package's.

Where ``wo . h`` is tiny but not 0, ``reflect(wo, h)`` rounds to exactly
``-wo``: the reference gives the sample a finite (huge) pdf and
``blinn_f``'s ``normalize(wo + wi)`` a NaN colour, which ``next_ray``
multiplies into dst.  On the card this made a training step's loss NaN
at about 3e-4 of the train mix's frames.  The inputs here are of that
kind, built on the CPU: a half vector drawn as the sampler draws it, and
``wo`` made perpendicular to it, so that the reflection collapses for
some of them in each package's own rounding.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from visionaray_tpu.core import vecmath as jvec
from visionaray_tpu.shading import brdf as jbrdf
from visionaray_torch.core.vecmath import (
    dot, normalize, orthonormal_basis, reflect,
)
from visionaray_torch.shading import brdf

torch.set_num_threads(1)
N = 20000


def _draws(seed):
    rng = np.random.default_rng(seed)
    n = rng.normal(size=(N, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    u1 = rng.random(N).astype(np.float32)
    u2 = rng.random(N).astype(np.float32)
    exp = rng.choice(np.array([8.0, 16.0, 32.0], np.float32), N)
    cs = np.full((N, 3), 0.2, np.float32)
    ks = np.ones(N, np.float32)
    return rng, cs, ks, exp, n, u1, u2


def _perpendicular(rng, h):
    """A unit ``wo`` perpendicular to each row of ``h`` (float32)."""
    q = rng.normal(size=h.shape).astype(np.float32)
    w = q - (q * h).sum(1, keepdims=True) * h
    return (w / np.linalg.norm(w, axis=1, keepdims=True)).astype(np.float32)


def _half_torch(exp, n, u1, u2):
    """blinn_sample_f's half vector, as the port computes it."""
    ct = torch.pow(u1, 1.0 / (exp + 1.0))
    st = torch.sqrt(torch.clamp_min(1.0 - ct * ct, 0.0))
    phi = u2 * brdf.TWO_PI
    u, v = orthonormal_basis(n)
    return normalize((st * torch.cos(phi))[..., None] * u
                     + (st * torch.sin(phi))[..., None] * v
                     + ct[..., None] * n)


def _unguarded(cs, ks, exp, n, wo, u1, u2):
    """blinn_sample_f as the port had it before the guard (the
    reference's formula)."""
    h = _half_torch(exp, n, u1, u2)
    wi = reflect(wo, h)
    vdoth = dot(wo, h)
    pdf = ((exp + 1.0) * torch.pow(torch.pow(u1, 1.0 / (exp + 1.0)), exp)) \
        / (2.0 * np.pi * 4.0 * torch.where(vdoth != 0.0, vdoth, 1.0))
    pdf = torch.where(vdoth != 0.0, pdf, 0.0)
    return brdf.blinn_f(cs, ks, exp, n, wo, wi), wi, pdf


def _degenerate(f, pdf):
    return ~torch.isfinite(f).all(-1) & (pdf > 0.0)


def test_collapsed_sample_gets_pdf_and_colour_zero():
    """Inputs whose reflection collapses onto -wo: the unguarded formula
    gives a NaN colour with a positive pdf there; the guarded one gives
    colour 0 and pdf 0, the same direction, and is finite everywhere."""
    rng, *args = _draws(1)
    cs, ks, exp, n, u1, u2 = (torch.as_tensor(a) for a in args)
    wo = torch.as_tensor(_perpendicular(rng, _half_torch(exp, n, u1,
                                                         u2).numpy()))
    f0, wi0, pdf0 = _unguarded(cs, ks, exp, n, wo, u1, u2)
    bad = _degenerate(f0, pdf0)
    assert int(bad.sum()) >= 10, int(bad.sum())
    assert bool((wo + wi0 == 0.0).all(-1)[bad].all())
    f, wi, pdf = brdf.blinn_sample_f(cs, ks, exp, n, wo, u1, u2)
    assert bool(torch.isfinite(f).all() & torch.isfinite(pdf).all())
    assert bool((f[bad] == 0.0).all()) and bool((pdf[bad] == 0.0).all())
    assert torch.equal(wi, wi0)
    ok = ~(wo + wi0 == 0.0).all(-1)
    assert torch.equal(f[ok], f0[ok]) and torch.equal(pdf[ok], pdf0[ok])


def test_guard_keeps_ordinary_samples_bit_equal():
    """On ordinary draws, and on ``wo . h == 0`` exactly (pdf 0 in both),
    the guarded sample equals the unguarded one bit for bit, but for the
    colour of a collapsed sample (NaN before, 0 now)."""
    rng, *args = _draws(2)
    cs, ks, exp, n, u1, u2 = (torch.as_tensor(a) for a in args)
    wo = torch.as_tensor(rng.normal(size=(N, 3)).astype(np.float32))
    wo = torch.where((dot(wo, n) < 0.0)[..., None], -wo, wo)
    wo = normalize(wo)
    # a few exactly perpendicular: the half vector is n itself at u1 = 1
    u1[:4] = 1.0
    n[:4] = torch.tensor([0.0, 0.0, 1.0])
    wo[:4] = torch.tensor([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0],
                           [0.6, 0.8, 0.0], [-1.0, 0.0, 0.0]])
    f0, wi0, pdf0 = _unguarded(cs, ks, exp, n, wo, u1, u2)
    f, wi, pdf = brdf.blinn_sample_f(cs, ks, exp, n, wo, u1, u2)
    collapsed = (wo + wi0 == 0.0).all(-1)
    assert bool(collapsed[:4].all()) and bool((pdf0[:4] == 0.0).all())
    assert torch.equal(wi, wi0) and torch.equal(pdf, pdf0)
    assert torch.equal(f[~collapsed], f0[~collapsed])
    assert bool((f[collapsed] == 0.0).all())
    assert bool(torch.isfinite(f).all())


def test_reference_gives_the_nan_too():
    """The JAX package's blinn_sample_f on inputs built the same way in
    its own rounding: a NaN colour with a positive pdf at some of them,
    as the port had before the guard (the reference is wrong there: ROADMAP
    Queue A, "where the reference is wrong")."""
    rng, cs, ks, exp, n, u1, u2 = _draws(3)
    ct = jnp.power(u1, 1.0 / (exp + 1.0))
    st = jnp.sqrt(jnp.maximum(0.0, 1.0 - ct * ct))
    phi = u2 * jbrdf.TWO_PI
    u, v = jvec.orthonormal_basis(jnp.asarray(n))
    h = np.asarray(jvec.normalize((st * jnp.cos(phi))[..., None] * u
                                  + (st * jnp.sin(phi))[..., None] * v
                                  + ct[..., None] * n))
    wo = _perpendicular(rng, h)
    f, wi, pdf = (np.asarray(a) for a in jbrdf.blinn_sample_f(
        *(jnp.asarray(a) for a in (cs, ks, exp, n, wo, u1, u2))))
    bad = ~np.isfinite(f).all(-1) & (pdf > 0.0)
    assert int(bad.sum()) >= 10, int(bad.sum())
    assert bool(((wo + wi) == 0.0).all(-1)[bad].all())
    # the port, on the same inputs: finite everywhere, and pdf 0 wherever
    # its own reflection collapses
    tf, twi, tpdf = brdf.blinn_sample_f(
        *(torch.as_tensor(a) for a in (cs, ks, exp, n, wo, u1, u2)))
    assert bool(torch.isfinite(tf).all())
    gone = (torch.as_tensor(wo) + twi == 0.0).all(-1)
    assert bool((tpdf[gone] == 0.0).all())


@pytest.mark.parametrize("nee", (True, False), ids=("nee", "no_nee"))
def test_collapsed_lane_leaves_the_bounce_finite(nee):
    """One bounce of the torch body's pieces (shading/bounce.py) at a
    plastic lane whose Blinn sample collapses: dst becomes 0 (the lane's
    pdf is 0) and every carry stays finite, where the unguarded formula
    made dst NaN."""
    from visionaray_torch.shading import bounce as shade
    from visionaray_torch.shading.materials import Materials

    rng, *args = _draws(1)
    cs, ks, exp, n, u1, u2 = (torch.as_tensor(a) for a in args)
    wo = torch.as_tensor(_perpendicular(rng, _half_torch(exp, n, u1,
                                                         u2).numpy()))
    f0, _, pdf0 = _unguarded(cs, ks, exp, n, wo, u1, u2)
    k = int(torch.nonzero(_degenerate(f0, pdf0))[0, 0])
    mats = Materials.plastic(cd=(0.3, 0.6, 0.5), cs=(0.2, 0.2, 0.2),
                             specular_exp=float(exp[k]), device="cpu")
    rows = mats.take(torch.zeros(1, dtype=torch.int64))
    # the plastic lobe's diffuse probability is below any draw: u_lobe 1
    f, wi, pdf = rows.sample(n[k:k + 1], wo[k:k + 1], torch.ones(1),
                             u1[k:k + 1], u2[k:k + 1])
    assert bool(torch.isfinite(f).all()) and float(pdf[0]) == 0.0
    h = shade.Shade(n=n[k:k + 1], view_dir=wo[k:k + 1], src=f, refl_dir=wi,
                    pdf=pdf, pos=torch.zeros(1, 3),
                    active=torch.ones(1, dtype=torch.bool),
                    emissive=torch.zeros(1, dtype=torch.bool),
                    specular=torch.zeros(1, dtype=torch.bool),
                    zero_pdf=pdf <= 0.0,
                    take_d=torch.ones(1, dtype=torch.bool) if nee else None,
                    mats=rows)
    dst, acc = torch.full((1, 3), 0.5), torch.full((1, 3), 0.25)
    direct = torch.full((1, 3), 0.125) if nee else None
    ray, active, dst2, acc2, _ = shade.next_ray(
        h, direct, dst, acc, torch.zeros(1, dtype=torch.bool), eps=1e-3,
        nee=nee, first=False)
    assert torch.equal(dst2, torch.zeros(1, 3))
    assert bool(torch.isfinite(acc2).all()) and not bool(active[0])
    assert bool(torch.isfinite(ray.ori).all() & torch.isfinite(ray.dir).all())
    stale = h._replace(src=f0[k:k + 1], pdf=pdf0[k:k + 1],
                       zero_pdf=pdf0[k:k + 1] <= 0.0)
    _, _, dst0, _, _ = shade.next_ray(
        stale, direct, dst, acc, torch.zeros(1, dtype=torch.bool),
        eps=1e-3, nee=nee, first=False)
    assert bool(torch.isnan(dst0).all())

"""visionaray_torch core, sampling, intersection and shading vs the JAX
package on the CPU (inputs from numpy seeds)."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visionaray_tpu.core.camera import Pinhole as JPinhole
from visionaray_tpu.core.types import Ray as JRay
from visionaray_tpu.ops import intersect as jint
from visionaray_tpu.ops import lbvh as jlbvh
from visionaray_tpu.ops import sampling as jsamp
from visionaray_tpu.ops.trace import any_hit as j_any_hit
from visionaray_tpu.ops.trace import closest_hit as j_closest_hit
from visionaray_tpu.scenes import tri_sphere_plane as j_tri_sphere_plane
from visionaray_tpu.shading import lights as jlights
from visionaray_tpu.shading.materials import Materials as JMaterials
from visionaray_tpu.shading.surface import get_surface as j_get_surface

from visionaray_torch import convert
from visionaray_torch.core.camera import Pinhole
from visionaray_torch.core.types import Ray
from visionaray_torch.ops import intersect as tint
from visionaray_torch.ops import lbvh as tlbvh
from visionaray_torch.ops import sampling as tsamp
from visionaray_torch.ops.trace import any_hit, closest_hit
from visionaray_torch.shading import lights as tlights
from visionaray_torch.shading.materials import Materials
from visionaray_torch.shading.surface import get_surface

torch.set_num_threads(1)
CPU = "cpu"
REPO = Path(__file__).resolve().parents[1]


def t(a, dtype=None):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def arrays(obj):
    """A JAX dataclass's leaves as numpy arrays (static fields as is)."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        out[f.name] = v if (v is None or isinstance(v, (bool, int, str))) \
            else np.asarray(v)
    return out


# ---------------------------------------------------------------- sampling

def test_pcg_hash_bit_exact():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    x[:4] = [0, 1, 2**31, 2**32 - 1]
    ref = np.asarray(jsamp.pcg_hash(jnp.asarray(x)))
    got = tsamp.pcg_hash(t(x.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, ref.astype(np.int64))


@pytest.mark.parametrize("seed,frame", [(0, 1), (7, 123456), (2**31, 3)])
def test_sampler_stream_bit_exact(seed, frame):
    rng = np.random.default_rng(seed % 1000)
    pid = rng.integers(0, 2**32, 2048, dtype=np.uint64).astype(np.uint32)
    js = jsamp.Sampler.seed(seed, jnp.asarray(pid), jnp.uint32(frame))
    ts = tsamp.Sampler.seed(seed, t(pid.astype(np.int64)), frame)
    np.testing.assert_array_equal(ts.state.numpy(),
                                  np.asarray(js.state).astype(np.int64))
    jus, js = js.next_n(6)
    tus, ts = ts.next_n(6)
    for ju, tu in zip(jus, tus):
        np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(ts.state.numpy(),
                                  np.asarray(js.state).astype(np.int64))


def test_unit_float_rounds_top_bits_to_one():
    bits = np.array([0, 1, 2**31, 2**32 - 129, 2**32 - 128, 2**32 - 1],
                    np.uint32)
    ref = np.asarray(jsamp._to_unit_float(jnp.asarray(bits)))
    got = tsamp._to_unit_float(t(bits.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, ref)
    assert got[-1] == 1.0


# ---------------------------------------------------------------- camera

def test_primary_rays_match():
    kw = dict(eye=(2.5, 2.2, 6.0), center=(18.0, 4.0, 6.0),
              up=(0.0, 1.0, 0.0), fovy=np.deg2rad(55.0), aspect=16 / 9)
    jc = JPinhole.create(**kw)
    tc = Pinhole.create(**kw, device=CPU)
    rng = np.random.default_rng(1)
    x = rng.integers(0, 1920, 1000).astype(np.int32)
    y = rng.integers(0, 1080, 1000).astype(np.int32)
    jit = (rng.random((1000, 2)) - 0.5).astype(np.float32)
    jr = jc.primary_rays(jnp.asarray(x), jnp.asarray(y), 1920, 1080,
                         jnp.asarray(jit))
    tr = tc.primary_rays(t(x), t(y), 1920, 1080, t(jit))
    np.testing.assert_allclose(tr.dir.numpy(), np.asarray(jr.dir),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(tr.ori.numpy(), np.asarray(jr.ori))
    for a, b in zip(tc.basis(), jc.basis()):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)


def test_pinhole_converted_matches_created():
    jc = JPinhole.create(eye=(0, 1, 9), center=(0, 0, 0), fovy=0.7,
                         aspect=1.5)
    tc = convert.pinhole_from_arrays(arrays(jc), device=CPU)
    assert tc.fovy.dtype == torch.float32
    np.testing.assert_array_equal(tc.eye.numpy(), np.asarray(jc.eye))


# ---------------------------------------------------------------- morton

def test_morton_exact():
    rng = np.random.default_rng(2)
    p = rng.random((5000, 3)).astype(np.float32)
    p[:3] = [[0, 0, 0], [1, 1, 1], [0.999999, 0.5, 1e-9]]
    ref = np.asarray(jlbvh.morton3d(jnp.asarray(p))).astype(np.int64)
    np.testing.assert_array_equal(tlbvh.morton3d(t(p)).numpy(), ref)


# ---------------------------------------------------------------- intersect

@pytest.fixture(scope="module")
def rays():
    rng = np.random.default_rng(3)
    o = rng.uniform(-2, 2, (256, 3)).astype(np.float32)
    d = rng.normal(size=(256, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def test_intersect_triangle_matches(rays):
    o, d = rays
    rng = np.random.default_rng(4)
    v1 = rng.uniform(-1, 1, (64, 3)).astype(np.float32)
    e1 = rng.uniform(-1, 1, (64, 3)).astype(np.float32)
    e2 = rng.uniform(-1, 1, (64, 3)).astype(np.float32)
    ref = jint.intersect_triangle(jnp.asarray(o)[:, None],
                                  jnp.asarray(d)[:, None], jnp.asarray(v1),
                                  jnp.asarray(e1), jnp.asarray(e2))
    got = tint.intersect_triangle(t(o)[:, None], t(d)[:, None], t(v1),
                                  t(e1), t(e2))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))
    assert got[3].sum() > 50
    for a, b in zip(got[:3], ref[:3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)


def test_intersect_sphere_plane_match(rays):
    o, d = rays
    c = np.array([[0.3, -0.2, 0.5], [1.5, 1.0, -1.0]], np.float32)
    r = np.array([0.8, 0.4], np.float32)
    js = jint.intersect_sphere(jnp.asarray(o)[:, None],
                               jnp.asarray(d)[:, None], jnp.asarray(c),
                               jnp.asarray(r))
    ts = tint.intersect_sphere(t(o)[:, None], t(d)[:, None], t(c), t(r))
    np.testing.assert_array_equal(ts[1].numpy(), np.asarray(js[1]))
    np.testing.assert_allclose(ts[0].numpy(), np.asarray(js[0]), rtol=1e-5,
                               atol=1e-5)
    n = np.array([[0, 1, 0], [0.6, 0, 0.8]], np.float32)
    off = np.array([0.1, -0.5], np.float32)
    jp = jint.intersect_plane(jnp.asarray(o)[:, None],
                              jnp.asarray(d)[:, None], jnp.asarray(n),
                              jnp.asarray(off))
    tp = tint.intersect_plane(t(o)[:, None], t(d)[:, None], t(n), t(off))
    np.testing.assert_array_equal(tp[1].numpy(), np.asarray(jp[1]))
    np.testing.assert_allclose(tp[0].numpy(), np.asarray(jp[0]), rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------- shading

def _materials_pair():
    j = JMaterials.concatenate([
        JMaterials.plastic(cd=(0.55, 0.45, 0.35), cs=(0.1, 0.1, 0.1),
                           specular_exp=16.0),
        JMaterials.matte(cd=(0.7, 0.65, 0.55)),
        JMaterials.mirror(cr=(0.9, 0.9, 0.8)),
        JMaterials.emissive(ce=(1.0, 0.85, 0.6), ls=8.0),
        JMaterials.plastic(cd=(0, 0, 0), cs=(0, 0, 0), ks=0.0, kd=0.0),
    ])
    tm = Materials.concatenate([
        Materials.plastic(cd=(0.55, 0.45, 0.35), cs=(0.1, 0.1, 0.1),
                          specular_exp=16.0, device=CPU),
        Materials.matte(cd=(0.7, 0.65, 0.55), device=CPU),
        Materials.mirror(cr=(0.9, 0.9, 0.8), device=CPU),
        Materials.emissive(ce=(1.0, 0.85, 0.6), ls=8.0, device=CPU),
        Materials.plastic(cd=(0, 0, 0), cs=(0, 0, 0), ks=0.0, kd=0.0,
                          device=CPU),
    ])
    return j, tm


def test_material_tables_equal():
    j, tm = _materials_pair()
    conv = convert.materials_from_arrays(arrays(j), device=CPU)
    for f in dataclasses.fields(tm):
        ref = np.asarray(getattr(j, f.name))
        np.testing.assert_array_equal(getattr(tm, f.name).numpy(), ref)
        np.testing.assert_array_equal(getattr(conv, f.name).numpy(), ref)


def test_shade_and_sample_match():
    j, tm = _materials_pair()
    rng = np.random.default_rng(5)
    n_rays = 500
    idx = rng.integers(0, 5, n_rays).astype(np.int32)
    nrm = rng.normal(size=(n_rays, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    vd = rng.normal(size=(n_rays, 3)).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    vd = np.where((vd * nrm).sum(-1, keepdims=True) < 0, -vd, vd)
    ld = rng.normal(size=(n_rays, 3)).astype(np.float32)
    ld /= np.linalg.norm(ld, axis=-1, keepdims=True)
    inten = rng.random((n_rays, 3)).astype(np.float32)
    u = rng.random((3, n_rays)).astype(np.float32)
    jm = j.take(jnp.asarray(idx))
    tmm = tm.take(t(idx))
    np.testing.assert_allclose(
        tmm.shade(t(nrm), t(vd), t(ld), t(inten)).numpy(),
        np.asarray(jm.shade(jnp.asarray(nrm), jnp.asarray(vd),
                            jnp.asarray(ld), jnp.asarray(inten))),
        rtol=2e-5, atol=1e-6)
    got = tmm.sample(t(nrm), t(vd), t(u[0]), t(u[1]), t(u[2]))
    ref = jm.sample(jnp.asarray(nrm), jnp.asarray(vd), jnp.asarray(u[0]),
                    jnp.asarray(u[1]), jnp.asarray(u[2]))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4,
                                   atol=2e-5)
    np.testing.assert_array_equal(tmm.is_emissive().numpy(),
                                  np.asarray(jm.is_emissive()))
    np.testing.assert_array_equal(tmm.is_specular().numpy(),
                                  np.asarray(jm.is_specular()))


def test_lights_match():
    rng = np.random.default_rng(6)
    pos = rng.uniform(-3, 3, (300, 3)).astype(np.float32)
    u1, u2 = rng.random((2, 300)).astype(np.float32)
    ja = jlights.AreaLights.rect((0, 5, 0), (1, 0, 0), (0, 0, 1), kl=4.0)
    ta = tlights.AreaLights.rect((0, 5, 0), (1, 0, 0), (0, 0, 1), kl=4.0,
                                 device=CPU)
    js = jlights.SpotLights.create((0, 4, 0), (0, -1, 0), cutoff_deg=40.0,
                                   exponent=3.0, attenuation=(1, 0.1, 0.01))
    ts = tlights.SpotLights.create((0, 4, 0), (0, -1, 0), cutoff_deg=40.0,
                                   exponent=3.0, attenuation=(1, 0.1, 0.01),
                                   device=CPU)
    jp = jlights.PointLights.create([[1, 2, 3]], attenuation=(1, 0.2, 0.05))
    tp = tlights.PointLights.create([[1, 2, 3]], attenuation=(1, 0.2, 0.05),
                                    device=CPU)
    for li in range(2):
        np.testing.assert_allclose(
            ta.sample(li, t(u1), t(u2)).numpy(),
            np.asarray(ja.sample(li, jnp.asarray(u1), jnp.asarray(u2))),
            rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(ta.normal(li).numpy(),
                                   np.asarray(ja.normal(li)), rtol=1e-6)
        np.testing.assert_allclose(float(ta.area(li)), float(ja.area(li)),
                                   rtol=1e-6)
    for jl, tl in ((js, ts), (jp, tp), (ja, ta)):
        np.testing.assert_allclose(
            tl.intensity(0, t(pos)).numpy(),
            np.asarray(jl.intensity(0, jnp.asarray(pos))),
            rtol=1e-5, atol=1e-7)
    conv = convert.lights_from_arrays("SpotLights", arrays(js), device=CPU)
    np.testing.assert_array_equal(conv.cos_cutoff.numpy(),
                                  ts.cos_cutoff.numpy())
    assert tlights.light_groups((ta, tp)) == (ta, tp)
    assert tlights.light_groups(None) == ()


# ------------------------------------------------ brute-force trace + surface

def test_brute_trace_and_surface_match():
    """Triangles, spheres and planes without a BVH: closest_hit, any_hit
    and get_surface over tri_sphere_plane, carried over by convert.py."""
    jscene, jcam = j_tri_sphere_plane()
    scene = convert.scene_from_arrays(
        mesh=arrays(jscene.mesh), spheres=arrays(jscene.spheres),
        planes=arrays(jscene.planes), materials=arrays(jscene.materials),
        lights=("PointLights", arrays(jscene.lights)), device=CPU)
    rng = np.random.default_rng(7)
    o = np.tile(np.asarray(jcam.eye)[None], (400, 1)).astype(np.float32)
    d = rng.normal(size=(400, 3)).astype(np.float32) * [1, 0.6, 1]
    d[:, 2] = -np.abs(d[:, 2]) - 1.0
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    jray = JRay(jnp.asarray(o), jnp.asarray(d))
    ray = Ray(t(o), t(d))
    jh = j_closest_hit(jray, jscene)
    th = closest_hit(ray, scene)
    np.testing.assert_array_equal(th.hit.numpy(), np.asarray(jh.hit))
    assert len(set(th.prim_id[th.hit].tolist())) == 3, "all groups hit"
    np.testing.assert_array_equal(th.prim_id.numpy(), np.asarray(jh.prim_id))
    np.testing.assert_array_equal(th.geom_id.numpy(), np.asarray(jh.geom_id))
    np.testing.assert_allclose(th.t.numpy(), np.asarray(jh.t), rtol=1e-5)
    js = j_get_surface(jh, jray, jscene)
    ts = get_surface(th, ray, scene)
    np.testing.assert_allclose(ts.geometric_normal.numpy(),
                               np.asarray(js.geometric_normal), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(ts.shading_normal.numpy(),
                               np.asarray(js.shading_normal), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_array_equal(ts.materials.mtype.numpy(),
                                  np.asarray(js.materials.mtype))
    mt = np.where(np.asarray(jh.hit), np.asarray(jh.t) * 0.5, 1e30)
    mt = mt.astype(np.float32)
    ja = j_any_hit(jray, jscene, jnp.asarray(mt))
    ta = any_hit(ray, scene, t(mt))
    np.testing.assert_array_equal(ta.hit.numpy(), np.asarray(ja.hit))


# ---------------------------------------------------------------- package

def test_entry_points_raise_without_gpu(monkeypatch):
    from visionaray_torch.scenes.sponza_like import sponza_like_scene
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        sponza_like_scene(target_tris=4000)
    with pytest.raises(RuntimeError, match="CUDA"):
        Materials.matte()


def test_package_imports_no_jax():
    code = ("import sys, pkgutil, importlib\n"
            "before = set(sys.modules)\n"
            "import visionaray_torch\n"
            "for m in pkgutil.walk_packages(visionaray_torch.__path__, "
            "'visionaray_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = [m for m in set(sys.modules) - before if m == 'jax' or "
            "m.startswith(('jax.', 'visionaray_tpu'))]\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_package_source_names_no_reference_package():
    src = list((REPO / "visionaray_torch").rglob("*.py"))
    src += list((REPO / "visionaray_torch").rglob("*.cu"))
    src.append(REPO / "chip_smoke.py")
    assert len(src) > 15
    for p in src:
        text = p.read_text()
        for line in text.splitlines():
            s = line.strip()
            if s.startswith(("import ", "from ")):
                assert "visionaray_tpu" not in s and "jax" not in s.split(), \
                    f"{p}: {line}"
        assert "import jax" not in text and "from jax" not in text, p
        assert "from visionaray_tpu" not in text, p
        assert "import visionaray_tpu" not in text, p

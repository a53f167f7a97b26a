"""The bounce's two hand kernels (ops/cuda/bounce_shade.cu) against their
plain PyTorch versions (ops/bounce_shade.py), on the card.

Per bounce, the kernels and the plain versions take the same inputs:
every output is compared, the carry, the sampler state, the first hit,
the shadow and next rays and the buffer between the kernels.  Then a
256x256 NEE frame of the sponza-like scene through the fused path against
the torch body (kernels/pathtracing.py::_torch_body).

Marked ``cuda``: each test skips itself when torch.cuda.is_available() is
False (decided inside the fixture, never at import).  On a GPU machine:

    python -m pytest tests/test_torch_cuda_bounce.py -q

The kernels are built with -fmad=false and follow the card's rounding of
each torch operation, so every output must be equal, bit for bit.
"""

import dataclasses

import pytest
import torch

from visionaray_torch.core.types import FLT_MAX
from visionaray_torch.kernels import pathtracing as pt
from visionaray_torch.kernels.params import KernelParams
from visionaray_torch.ops import bounce_shade as bs
from visionaray_torch.ops import traversal as tt
from visionaray_torch.ops import traverse as trav
from visionaray_torch.ops.sampling import Sampler
from visionaray_torch.ops.trace import TraceConfig
from visionaray_torch.scenes.sponza_like import sponza_like_scene
from visionaray_torch.sched.render import _pixel_grid
from visionaray_torch.shading.lights import PointLights
from visionaray_torch.shading.materials import Materials

pytestmark = pytest.mark.cuda

W = H = 96
BOUNCES = 5


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the bounce kernels have no CPU or "
                    "interpret mode (the CPU runs their plain versions)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def sponza(cuda):
    return sponza_like_scene(target_tris=4000, device=cuda)


def _mixed(scene, corner: bool):
    """Every material type on the sponza-like mesh, two point lights with
    attenuation; ``corner``: perturbed per-corner shading normals."""
    dev = scene.device
    mats = Materials.concatenate([
        Materials.emissive(ce=(4.0, 3.0, 2.0), ls=2.0, device=dev),
        Materials.matte(cd=(0.7, 0.2, 0.3), device=dev),
        Materials.mirror(device=dev),
        Materials.plastic(cd=(0.3, 0.6, 0.5), cs=(0.4, 0.4, 0.4),
                          specular_exp=12.0, device=dev),
        Materials.plastic(cd=(0.0, 0.0, 0.0), cs=(0.0, 0.0, 0.0),
                          device=dev)])
    F = scene.mesh.num_prims
    mesh = dataclasses.replace(
        scene.mesh, geom_ids=torch.arange(F, dtype=torch.int32,
                                          device=dev) % 5)
    if corner:
        g = torch.Generator(device="cpu").manual_seed(0)
        jit = 0.2 * torch.randn((F, 3, 3), generator=g).to(dev)
        cn = torch.nn.functional.normalize(
            scene.mesh.normals[:, None, :] + jit, dim=-1)
        mesh = dataclasses.replace(mesh, corner_normals=cn.contiguous(),
                                   face_normals_binding=False)
    lights = PointLights.create(
        position=[[12.0, 9.0, 6.0], [3.0, 5.0, 2.0]],
        cl=[[1.0, 1.0, 1.0], [0.5, 0.7, 0.2]], kl=[1.0, 2.0],
        attenuation=[[1.0, 0.0, 0.0], [1.0, 0.1, 0.01]], device=dev)
    return dataclasses.replace(scene, mesh=mesh, materials=mats,
                               lights=lights)


CASES = {
    "sponza_nee": dict(nee=True),
    "sponza": dict(nee=False),
    "sponza_forward_shadows": dict(nee=True, reversed=False),
    "mixed_nee": dict(nee=True, mixed=True),
    "mixed": dict(nee=False, mixed=True),
    "corner_nee": dict(nee=True, mixed=True, corner=True),
    "no_lights_nee": dict(nee=True, mixed=True, lights=False),
}


def _differ(a, b):
    """(lanes that differ, largest difference) of two outputs; NaN equals
    NaN, -0 equals 0; int32-bit rows compare as integers."""
    if a is None or b is None:
        assert a is None and b is None
        return 0, 0.0
    if a.dtype != torch.float32:
        ne = a != b
        return int(ne.reshape(ne.shape[0], -1).any(-1).sum()), 0.0
    ne = (a != b) & ~(torch.isnan(a) & torch.isnan(b))
    lanes = ne if ne.dim() == 1 else ne.any(-1)
    big = float((a - b).abs()[ne].max()) if bool(ne.any()) else 0.0
    return int(lanes.sum()), big


@pytest.mark.parametrize("case", list(CASES))
def test_kernels_equal_plain_per_bounce(cuda, sponza, case):
    opt = CASES[case]
    scene, cam = sponza
    if opt.get("mixed"):
        scene = _mixed(scene, opt.get("corner", False))
    if opt.get("lights") is False:
        scene = dataclasses.replace(scene, lights=None)
    nee = opt["nee"]
    params = KernelParams.create(
        scene, num_bounces=BOUNCES, epsilon=1e-3,
        ambient_color=(1.0, 1.0, 1.0, 1.0),
        trace=TraceConfig(shadow_reversed=opt.get("reversed", True)))
    x, y = _pixel_grid(W, H, cuda)
    report = []
    with torch.inference_mode():
        ray = cam.primary_rays(x, y, W, H, None)
        sh = bs.Shading.of(params, nee)
        o, d = ray.ori.contiguous(), ray.dir.contiguous()
        n = o.shape[0]
        state = Sampler.seed(11, (y * W + x).to(torch.int64), 3).state
        tables = tt.prim_tables("triangle", scene.mesh)
        active = torch.ones(n, dtype=torch.bool, device=cuda)
        dst = torch.ones((n, 3), device=cuda)
        acc = torch.zeros((n, 3), device=cuda)
        prev = torch.zeros(n, dtype=torch.bool, device=cuda)
        mt = torch.full((n,), FLT_MAX, device=cuda)
        for b in range(BOUNCES):
            _, ref = tt.bvh_traverse(o, d, mt, scene.bvh, "triangle", tables,
                                     "closest")
            before = trav.ENTRY_LAUNCHES[bs.ENTRY_HIT]
            hk = bs.shade_hit(sh, o, d, ref, state, active, dst, acc, b)
            assert trav.ENTRY_LAUNCHES[bs.ENTRY_HIT] == before + 1
            hp = bs.shade_hit_plain(sh, o, d, ref, state, active, dst, acc,
                                    b)
            outs = [(f, getattr(hk, f), getattr(hp, f)) for f in (
                "state", "carry", "first_hit", "first_t", "shadow_o",
                "shadow_d", "shadow_t", "fire")]
            outs += [(f"mid[{r}]", hk.mid[r], hp.mid[r])
                     for r in range(bs.MID)]
            sref = None
            if hk.fire is not None:
                _, sref = tt.bvh_traverse(hk.shadow_o, hk.shadow_d,
                                          hk.shadow_t, scene.bvh, "triangle",
                                          tables, "any")
            if nee:
                acc = hk.carry
            else:
                dst = hk.carry
            before = trav.ENTRY_LAUNCHES[bs.ENTRY_CLOSE]
            ck = bs.shade_close(sh, d, hk, sref, dst, acc, prev, b)
            assert trav.ENTRY_LAUNCHES[bs.ENTRY_CLOSE] == before + 1
            cp = bs.shade_close_plain(sh, d, hk, sref, dst, acc, prev, b)
            outs += [(f"next.{f}", getattr(ck, f), getattr(cp, f)) for f in (
                "o", "d", "max_t", "dst", "acc", "active", "prev_delta")]
            for name, a, p in outs:
                lanes, big = _differ(a, p)
                if lanes:
                    report.append(f"bounce {b} {name}: {lanes} of {n} lanes "
                                  f"differ, largest by {big:.3g}")
            state = hk.state
            o, d, mt = ck.o, ck.d, ck.max_t
            dst, acc, active, prev = ck.dst, ck.acc, ck.active, ck.prev_delta
        assert bool(active.any()) or not nee
    assert not report, "\n".join(report)


def test_frame_equals_torch_body(cuda, sponza):
    """A 256x256 NEE frame through the fused path (10 kernel launches)
    against the torch body: the share of pixels off by more than 1e-3 in
    a channel is at most 1e-4; hit and depth equal."""
    scene, cam = sponza
    w = h = 256
    params = KernelParams.create(scene, num_bounces=BOUNCES, epsilon=1e-3,
                                 ambient_color=(1.0, 1.0, 1.0, 1.0))
    x, y = _pixel_grid(w, h, cuda)
    with torch.inference_mode():
        ray = cam.primary_rays(x, y, w, h, None)
        samp = Sampler.seed(5, (y * w + x).to(torch.int64), 2)
        assert pt._fused_ok(params)
        trav.reset_launch_counts()
        fused = pt.pathtracing_kernel(params, ray, samp, nee=True)
        assert trav.ENTRY_LAUNCHES[bs.ENTRY_HIT] == BOUNCES
        assert trav.ENTRY_LAUNCHES[bs.ENTRY_CLOSE] == BOUNCES
        assert trav.LAUNCHES["lbvh_closest"] == BOUNCES
        assert trav.LAUNCHES["lbvh_any"] == BOUNCES
        body = pt._torch_body(params, ray, samp, nee=True)
    off = ((fused.color - body.color).abs() > 1e-3).any(-1)
    assert float(off.float().mean()) <= 1e-4, int(off.sum())
    assert torch.equal(fused.hit, body.hit)
    assert torch.equal(fused.depth, body.depth)

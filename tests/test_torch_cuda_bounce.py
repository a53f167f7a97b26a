"""The bounce's two hand kernels (ops/cuda/bounce_shade.cu) against their
plain PyTorch versions (ops/bounce_shade.py), on the card.

Per bounce, the kernels and the plain versions take the same inputs:
every output is compared, the carry, the sampler state, the first hit,
the shadow and next rays and the buffer between the kernels.  Then a
256x256 NEE frame of the sponza-like scene through the fused path against
the torch body (kernels/pathtracing.py::_torch_body).  Last, per bounce
under autograd, the pair's adjoint kernel against its plain version, the
torch body's recompute, on the same inputs and output gradients.

Marked ``cuda``: each test skips itself when torch.cuda.is_available() is
False (decided inside the fixture, never at import).  On a GPU machine:

    python -m pytest tests/test_torch_cuda_bounce.py -q

The kernels are built with -fmad=false and follow the card's rounding of
each torch operation, so every output must be equal, bit for bit.  The
adjoint is not: it takes each lane's chain rule in float32 in its own
order, and sums the lanes' shares by atomics (ADJOINT_TOL).
"""

import dataclasses

import pytest
import torch

import visionaray_torch.core.scene as scene_module
import visionaray_torch.ops.trace as trace_module
import visionaray_torch.shading.materials as materials_module
from visionaray_torch.core.types import FLT_MAX
from visionaray_torch.device import take
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


def _case(sponza, case, leaves=()):
    """The case's scene, camera and parameters; ``leaves``: the scene
    tensors ("vertices", "cd") made leaves that require grad."""
    opt = CASES[case]
    scene, cam = sponza
    if opt.get("mixed"):
        scene = _mixed(scene, opt.get("corner", False))
    if opt.get("lights") is False:
        scene = dataclasses.replace(scene, lights=None)
    if "vertices" in leaves:
        scene = dataclasses.replace(scene, mesh=dataclasses.replace(
            scene.mesh,
            vertices=scene.mesh.vertices.detach().clone().requires_grad_()))
    if "cd" in leaves:
        scene = dataclasses.replace(scene, materials=dataclasses.replace(
            scene.materials,
            cd=scene.materials.cd.detach().clone().requires_grad_()))
    params = KernelParams.create(
        scene, num_bounces=BOUNCES, epsilon=1e-3,
        ambient_color=(1.0, 1.0, 1.0, 1.0),
        trace=TraceConfig(shadow_reversed=opt.get("reversed", True)))
    return scene, cam, params, opt["nee"]


@pytest.mark.parametrize("case", list(CASES))
def test_kernels_equal_plain_per_bounce(cuda, sponza, case):
    scene, cam, params, nee = _case(sponza, case)
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


# The adjoint against the recompute, relative L2 of each gradient, from
# random gradients of the bounce's outputs.  Both are float32 and take
# each lane's chain rule in their own order; the vertices' gradient is a
# sum of the lanes' Moeller-Trumbore shares, which random signs and the
# near cancellation of a triangle's v1, e1 and e2 shares make the most
# sensitive to rounding: on the CPU (48x48, the kernel built with g++)
# each of the two sits 1.2e-6 to 2.7e-5 from the same bounce recomputed
# in f64, and 1.3e-6 to 3.3e-6 from the other; on the card the two were
# up to 1.1e-5 apart.  So the vertices' gap may reach the float32 noise
# of that sum, 5e-5, and every other gradient's 1e-5 (at most 5.7e-7
# seen: the ray's, dst's and acc's are each lane's own, the albedo's is
# summed in f64 on both sides).
ADJOINT_TOL = {"vertices": 5e-5}
ADJOINT_TOL_REST = 1e-5


def f64_sums(x, idx):
    """``device.take`` whose backward sums in f64 into a float32 tensor
    that requires grad (the forward bit-equal): the torch body's gathers
    of the vertices, the triangles' corners and the albedo summed over
    the lanes exactly, as the adjoint sums the albedo."""
    if x.requires_grad and x.dtype == torch.float32:
        return take(x.double(), idx).float()
    return take(x, idx)


@pytest.mark.parametrize("case", list(CASES))
def test_adjoint_equals_recompute_per_bounce(cuda, sponza, case,
                                             monkeypatch):
    """Per bounce of a 96x96 frame, ``_FusedBounce`` with the vertices and
    the albedo as leaves and the ray, dst and acc requiring grad: its
    backward launches the adjoint kernel once and no recompute, and the
    gradients of all six, from random gradients of the bounce's outputs,
    are finite and within ADJOINT_TOL of the backward through the torch
    body's recompute (``_adjoint_ok`` off) on the same inputs, its
    gathers summed in f64 (``f64_sums``)."""
    scene, cam, params, nee = _case(sponza, case, ("vertices", "cd"))
    leaves = [t for _, t in pt._grad_leaves(params)]
    wrt_leaves = [scene.mesh.vertices, scene.materials.cd]
    x, y = _pixel_grid(W, H, cuda)
    with torch.no_grad():
        ray = cam.primary_rays(x, y, W, H, None)
        fr = pt._Frame(params=params, sh=bs.Shading.of(params, nee),
                       tables=tt.prim_tables("triangle", scene.mesh),
                       nee=nee,
                       paths=tuple(p for p, _ in pt._grad_leaves(params)))
    n = x.shape[0]
    c = pt._Carry(
        o=ray.ori.contiguous(), d=ray.dir.contiguous(),
        max_t=torch.full((n,), FLT_MAX, device=cuda),
        state=Sampler.seed(11, (y * W + x).to(torch.int64), 3).state,
        active=torch.ones(n, dtype=torch.bool, device=cuda),
        dst=torch.ones((n, 3), device=cuda),
        acc=torch.zeros((n, 3), device=cuda),
        prev_delta=torch.zeros(n, dtype=torch.bool, device=cuda))
    gen = torch.Generator().manual_seed(7)
    report = []
    for b in range(BOUNCES):
        grads = {}
        for path in ("adjoint", "recompute"):
            xs = {f: getattr(c, f).detach().clone().requires_grad_(
                f in pt._DIFF_IN) for f in pt._IN}
            with torch.enable_grad():
                out = pt._Carry(*pt._FusedBounce.apply(
                    fr, b, *[xs[f] for f in pt._IN], *leaves))
            ys = [(f, getattr(out, f)) for f in pt._DIFF_IN + (
                "first_t",) if getattr(out, f) is not None
                and getattr(out, f).requires_grad]
            if path == "adjoint":
                gs = {f: torch.randn(y.shape, generator=gen).to(cuda)
                      for f, y in ys}
            wrt = [xs[f] for f in pt._DIFF_IN] + wrt_leaves
            with monkeypatch.context() as m:
                if path == "recompute":
                    m.setattr(pt, "_adjoint_ok", lambda fr, dev: False)
                    for mod in (materials_module, scene_module,
                                trace_module):
                        m.setattr(mod, "take", f64_sums)
                before = trav.ENTRY_LAUNCHES[bs.ENTRY_BWD]
                grads[path] = torch.autograd.grad(
                    [y for _, y in ys], wrt, [gs[f] for f, _ in ys],
                    allow_unused=True)
                launched = trav.ENTRY_LAUNCHES[bs.ENTRY_BWD] - before
            assert launched == (path == "adjoint"), (path, launched)
        names = list(pt._DIFF_IN) + ["vertices", "cd"]
        for name, a, r in zip(names, grads["adjoint"],
                              grads["recompute"]):
            if r is None:
                r = torch.zeros_like(a)
            if not bool(torch.isfinite(a).all()):
                report.append(f"bounce {b} {name}: not finite")
                continue
            den = float(r.norm())
            gap = float((a - r).norm()) / (den if den > 0 else 1.0)
            if gap > ADJOINT_TOL.get(name, ADJOINT_TOL_REST):
                report.append(f"bounce {b} {name}: {gap:.3g} of "
                              f"|{den:.4g}|")
        with torch.no_grad():
            c = pt._Carry(*pt._fused_bounce(fr, b, c)[:8])
    assert not report, "\n".join(report)

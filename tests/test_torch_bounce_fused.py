"""The fused bounce on the CPU: kernels/pathtracing.py::_fused_body, whose
hand kernels run their plain versions (ops/bounce_shade.py) on CPU
tensors, against the torch body (``_torch_body``, pathtrace_loop), bit
for bit; and every input that keeps the torch body.

The Cornell box (36 triangles) on a flat tree, 8x8 pixels, with every
material type (emissive, matte, mirror, plastic), one or two point
lights, NEE on and off.  ``tests/test_torch_cuda_bounce.py`` holds the
kernels themselves to the plain versions on the card.
"""

import dataclasses

import numpy as np
import pytest
import torch

from visionaray_torch.core.scene import Spheres
from visionaray_torch.kernels import pathtracing as pt
from visionaray_torch.kernels.params import KernelParams
from visionaray_torch.ops import bounce_shade as bs
from visionaray_torch.ops import sah
from visionaray_torch.ops.cluster_bvh import build_cluster_bvh
from visionaray_torch.ops.lbvh import build_lbvh
from visionaray_torch.ops.sampling import Sampler
from visionaray_torch.ops.trace import TraceConfig
from visionaray_torch.scenes.basic import cornell_box
from visionaray_torch.sched.render import _pixel_grid
from visionaray_torch.shading.lights import AreaLights, PointLights
from visionaray_torch.shading.materials import Materials
from visionaray_torch.shading.spectrum import lift_scene
from visionaray_torch.shading.texture import TextureAtlas

torch.set_num_threads(1)
CPU = "cpu"
W = H = 8
BOUNCES = 4
S = 5.55   # the box's size


def _lights(count: int):
    if count == 0:
        return PointLights.none(device=CPU)
    pos = [[0.5 * S, 0.9 * S, 0.5 * S], [0.2 * S, 0.5 * S, 0.3 * S]]
    return PointLights.create(
        position=pos[:count], cl=[[1.0, 0.9, 0.8], [0.4, 0.6, 0.9]][:count],
        kl=[6.0, 3.0][:count],
        attenuation=[[1.0, 0.0, 0.0], [1.0, 0.2, 0.05]][:count], device=CPU)


def _box(tree="lbvh", lights=1, mixed=True, corner=False):
    """The Cornell box on a flat tree; ``mixed``: its two boxes a mirror
    and a plastic, the green wall plastic (beside the matte walls and the
    emissive patch); ``corner``: jittered per-corner normals."""
    scene, cam = cornell_box(device=CPU)
    mesh = scene.mesh
    if mixed:
        gids = mesh.geom_ids.clone()
        gids[12:24] = 4          # the short box: mirror
        gids[24:36] = 5          # the tall box: plastic
        mats = Materials.concatenate([
            Materials.matte(cd=(0.73, 0.73, 0.73), device=CPU),
            Materials.matte(cd=(0.65, 0.05, 0.05), device=CPU),
            Materials.plastic(cd=(0.12, 0.45, 0.15), cs=(0.3, 0.3, 0.3),
                              specular_exp=20.0, device=CPU),
            Materials.emissive(ce=(1.0, 0.85, 0.6), ls=8.0, device=CPU),
            Materials.mirror(device=CPU),
            Materials.plastic(cd=(0.5, 0.5, 0.6), cs=(0.2, 0.2, 0.2),
                              specular_exp=8.0, device=CPU)])
        mesh = dataclasses.replace(mesh, geom_ids=gids)
        scene = dataclasses.replace(scene, materials=mats)
    if corner:
        rng = np.random.default_rng(3)
        jit = torch.as_tensor(rng.normal(0.0, 0.2, (mesh.num_prims, 3, 3)),
                              dtype=torch.float32)
        cn = torch.nn.functional.normalize(mesh.normals[:, None, :] + jit,
                                           dim=-1)
        mesh = dataclasses.replace(mesh, corner_normals=cn,
                                   face_normals_binding=False)
    lights = (_lights(1), _lights(2)) \
        if lights == "groups" else _lights(lights)
    build = {"lbvh": build_lbvh, "sah": sah.build_sah,
             "sbvh": sah.build_sbvh}[tree]
    scene = dataclasses.replace(scene, mesh=mesh, lights=lights,
                                bvh=build(mesh))
    return scene, cam


def _frame(params, cam, nee, fn=pt.pathtracing_kernel):
    x, y = _pixel_grid(W, H, CPU)
    jitter = torch.as_tensor(np.random.default_rng(1).uniform(
        -0.45, 0.45, (W * H, 2)), dtype=torch.float32)
    ray = cam.primary_rays(x, y, W, H, jitter)
    samp = Sampler.seed(9, (y * W + x).to(torch.int64), 2)
    return fn(params, ray, samp, nee=nee)


def _params(scene, **kw):
    return KernelParams.create(scene, num_bounces=BOUNCES, epsilon=1e-3,
                               ambient_color=(0.3, 0.3, 0.3, 1.0), **kw)


FUSED = {
    "matte_1light_nee": dict(mixed=False, nee=True),
    "matte_1light": dict(mixed=False, nee=False),
    "mixed_1light_nee": dict(nee=True),
    "mixed_1light": dict(nee=False),
    "mixed_2lights_nee": dict(lights=2, nee=True),
    "mixed_2lights": dict(lights=2, nee=False),
    "mixed_2groups_nee": dict(lights="groups", nee=True),
    "mixed_no_lights_nee": dict(lights=0, nee=True),
    "mixed_corner_nee": dict(corner=True, nee=True),
    "mixed_forward_shadows_nee": dict(nee=True, reversed=False),
    "sah_nee": dict(tree="sah", nee=True),
    "sbvh_nee": dict(tree="sbvh", nee=True),
}


@pytest.mark.parametrize("case", list(FUSED))
def test_fused_frame_equals_torch_body(case):
    """Colour, hit and depth of the fused path, bit-equal to the torch
    body's; the path ran its two kernels once a bounce each."""
    opt = dict(FUSED[case])
    nee = opt.pop("nee")
    reversed_ = opt.pop("reversed", True)
    scene, cam = _box(**opt)
    params = _params(scene, trace=TraceConfig(shadow_reversed=reversed_))
    with torch.inference_mode():
        before = dict(bs.PLAIN_CALLS)
        fused = _frame(params, cam, nee)
        calls = {k: bs.PLAIN_CALLS[k] - before[k] for k in before}
        body = _frame(params, cam, nee, fn=pt._torch_body)
    assert calls == {bs.ENTRY_HIT: BOUNCES, bs.ENTRY_CLOSE: BOUNCES}
    assert bool(fused.hit.any())
    for f in ("color", "hit", "depth"):
        assert torch.equal(getattr(fused, f), getattr(body, f)), f


def _textured(scene):
    tex = TextureAtlas.pack({0: np.full((4, 4, 3), 0.5, np.float32)},
                            scene.materials.num_materials, resolution=4,
                            device=CPU)
    return dataclasses.replace(scene, textures=tex)


def _sphere(scene):
    return dataclasses.replace(scene, spheres=Spheres.create(
        [[2.0, 1.0, 2.0]], [0.8], geom_ids=[1], device=CPU))


def _treelets(scene):
    return dataclasses.replace(scene, bvh=build_cluster_bvh(
        scene.mesh, cluster_size=8, treelet_size=2))


def _area(scene):
    return dataclasses.replace(scene, lights=AreaLights.rect(
        (2.0, 5.5, 2.0), (1.0, 0.0, 0.0), (0.0, 0.0, 1.0), kl=4.0,
        device=CPU))


def _no_filter(pid, t, u, v, hit):
    return hit


KEPT = {
    "grad": (_treelets, {}),
    "textures": (_textured, {}),
    "sphere": (_sphere, {}),
    "treelets": (_treelets, {}),
    "spectral": (lambda s: lift_scene(s, 8), {}),
    "hit_filter": (lambda s: s, dict(hit_filter=_no_filter)),
    "area_lights": (_area, {}),
    "no_tree": (lambda s: dataclasses.replace(s, bvh=None), {}),
}


@pytest.mark.parametrize("case", list(KEPT))
def test_excluded_inputs_take_the_torch_body(case):
    """Textures, a sphere, a treelet ClusterBVH (with autograd off, and on
    in case ``grad``), spectral colour (nc != 3), a hit filter, area
    lights, no tree: the torch body runs, and no kernel (nor its plain
    version) is called.  Autograd alone keeps the fused path
    (tests/test_torch_step_fused.py)."""
    make, kw = KEPT[case]
    scene, cam = _box()
    params = _params(make(scene), **kw)
    grad = case == "grad"
    with torch.set_grad_enabled(grad):
        assert not pt._fused_ok(params)
        before = dict(bs.PLAIN_CALLS)
        out = _frame(params, cam, True)
        assert bs.PLAIN_CALLS == before
        body = _frame(params, cam, True, fn=pt._torch_body)
    assert torch.equal(out.color, body.color)


def test_material_ids_beyond_the_table_are_refused():
    """The kernel reads a material row by a face's id unchecked, so the
    fused path refuses a mesh whose ids leave the table (the torch body's
    gather raises too)."""
    scene, _ = _box()
    gids = scene.mesh.geom_ids.clone()
    gids[5] = scene.materials.num_materials
    bad = dataclasses.replace(scene, mesh=dataclasses.replace(
        scene.mesh, geom_ids=gids))
    with pytest.raises(ValueError, match="material ids"):
        bs.Shading.of(_params(bad), True)
    bs.Shading.of(_params(scene), True)


@pytest.mark.parametrize("change", ("none", "written", "replaced"))
def test_material_table_kept_while_unchanged(change):
    """The frame's material table is made once and kept with the
    materials (ops/traversal.py::kept) until a field is written in place
    or replaced; then it is made anew, with the new values."""
    scene, _ = _box()
    first = bs.Shading.of(_params(scene), True).mat
    if change == "written":
        scene.materials.cd.mul_(0.5)
    elif change == "replaced":
        scene = dataclasses.replace(scene, materials=dataclasses.replace(
            scene.materials, cd=scene.materials.cd * 0.5))
    again = bs.Shading.of(_params(scene), True).mat
    assert (again is first) == (change == "none")
    assert torch.equal(again, bs.material_table(scene.materials))

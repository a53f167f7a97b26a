"""The training step through the fused bounce: kernels/pathtracing.py's
``_FusedBounce``, whose forward is the two hand kernels around the walks
(their plain versions on CPU tensors) and whose backward recomputes the
torch body, against the torch body (``_torch_body``, pathtrace_loop's
checkpointed bounces) on the same inputs.

The Cornell box (36 triangles, every material type, jittered per-corner
normals so that the vertices reach the colour without NEE too) on its
LBVH, 8x8 pixels.  The loss is equal; the gradients agree to 1e-6
relative L2 (autograd sums the bounces' shares into a leaf in another
order).  Each bounce's walks are recorded as the torch body records them;
the inputs the fused path refuses keep the torch body under autograd too.
The ``cuda`` case holds the same on the card at 256x256.
"""

import dataclasses

import pytest
import torch

import visionaray_torch.core.scene as scene_module
import visionaray_torch.ops.trace as trace_module
from visionaray_torch.kernels import pathtracing as pt
from visionaray_torch.kernels.params import KernelParams
from visionaray_torch.ops import bounce_shade as bs
from visionaray_torch.ops import traverse as trav
from visionaray_torch.ops.sampling import Sampler
from visionaray_torch.sched import render, step
from visionaray_torch.scenes.sponza_like import sponza_like_scene
from visionaray_torch.sched.render import _pixel_grid
from visionaray_torch.shading import materials as materials_module
from visionaray_torch.shading.spectrum import lift_scene
from visionaray_torch.utils import metrics

from test_torch_bounce_fused import (
    _area, _box, _frame, _textured, _treelets,
)
from test_torch_cuda_bounce import f64_sums

torch.set_num_threads(1)
CPU = "cpu"
W = H = 8
PATHS = {"fused": pt._fused_body, "torch": pt._torch_body}


def _rel(a, b):
    return float((a - b).norm() / b.norm())


def _params(scene, bounces):
    return KernelParams.create(scene, num_bounces=bounces, epsilon=1e-3,
                               ambient_color=(0.3, 0.3, 0.3, 1.0))


def _step(params, cam, nee, path, monkeypatch, w=W, h=H, dev=CPU):
    """``loss_and_grads`` with the path tracer set to ``path`` (a key of
    PATHS; None: ``pathtracing_kernel``, which picks)."""
    x, y = _pixel_grid(w, h, dev)
    with monkeypatch.context() as m:
        if path is not None:
            m.setitem(render.KERNELS, "pathtracing", PATHS[path])
        return step.loss_and_grads(
            params.scene.mesh.vertices, params.scene.materials.cd, 3,
            params, cam, x, y, nee=nee, width=w, height=h, tile=w * h)


@pytest.mark.parametrize("bounces", (2, 5))
@pytest.mark.parametrize("nee", (True, False), ids=("nee", "no_nee"))
def test_step_equals_torch_body(nee, bounces, monkeypatch):
    """Loss equal, vertex and albedo gradients within 1e-6 relative L2;
    the fused path ran the hit and close kernels once a bounce, in the
    forward alone."""
    scene, cam = _box(corner=True)
    params = _params(scene, bounces)
    assert pt._fused_ok(params)
    before = dict(bs.PLAIN_CALLS)
    loss, (gv, gc) = _step(params, cam, nee, "fused", monkeypatch)
    calls = {k: bs.PLAIN_CALLS[k] - before[k] for k in before}
    body, (bv, bc) = _step(params, cam, nee, "torch", monkeypatch)
    assert calls == {bs.ENTRY_HIT: bounces, bs.ENTRY_CLOSE: bounces}
    assert torch.equal(loss, body)
    assert float(bv.norm()) > 0 and float(bc.norm()) > 0
    assert _rel(gv, bv) <= 1e-6 and _rel(gc, bc) <= 1e-6


class _Tapes(trav.TraceTape):
    """A TraceTape that keeps every tape made."""

    made = []

    def __init__(self):
        super().__init__()
        self.made.append(self)


@pytest.mark.parametrize("nee", (True, False), ids=("nee", "no_nee"))
def test_tapes_equal_torch_body(nee, monkeypatch):
    """Under autograd each fused bounce records its walks' (best_t,
    best_ref) on a tape of its own, entry for entry what the torch body's
    checkpoint records: the closest walk, then (NEE) the shadow walk."""
    scene, cam = _box(lights=2, corner=True)
    params = _params(scene, 5)
    monkeypatch.setattr(trav, "TraceTape", _Tapes)
    tapes = {}
    for name, fn in PATHS.items():
        _Tapes.made = []
        with torch.enable_grad():
            _frame(params, cam, nee, fn=fn)
        # the recorded tapes: on the CPU the plain hit kernel replays its
        # walk's refs through a one-entry tape of its own (pos 1)
        tapes[name] = [t for t in _Tapes.made if t.pos == 0]
    assert len(tapes["fused"]) == len(tapes["torch"]) == 5
    for a, b in zip(tapes["fused"], tapes["torch"]):
        assert len(a.outs) == len(b.outs) == (2 if nee else 1)
        for x, y in zip(a.outs, b.outs):
            assert len(x) == len(y) == 2
            for p, q in zip(x, y):
                assert p.dtype == q.dtype and p.shape == q.shape
                assert torch.equal(p, q)


@pytest.mark.parametrize("tensor", ("light_cl", "material_ks"))
def test_third_scene_tensor_gets_its_gradient(tensor):
    """A scene tensor beyond the step's two (a point light's ``cl``, the
    materials' ``ks``) is an input of every fused bounce: its gradient
    matches the torch body's, as do the vertices' and albedo's."""
    scene, cam = _box(lights=2)
    v = scene.mesh.vertices.detach().clone().requires_grad_()
    cd = scene.materials.cd.detach().clone().requires_grad_()
    mats = dataclasses.replace(scene.materials, cd=cd)
    lights = scene.lights
    if tensor == "light_cl":
        third = lights.cl.detach().clone().requires_grad_()
        lights = dataclasses.replace(lights, cl=third)
    else:
        third = mats.ks.detach().clone().requires_grad_()
        mats = dataclasses.replace(mats, ks=third)
    scene = dataclasses.replace(
        scene, mesh=dataclasses.replace(scene.mesh, vertices=v),
        materials=mats, lights=lights)
    params = _params(scene, 4)
    got = {}
    for name, fn in PATHS.items():
        with torch.enable_grad():
            rec = _frame(params, cam, True, fn=fn)
            loss = rec.color[..., :3].sum()
            got[name] = (loss, torch.autograd.grad(loss, (v, cd, third)))
    assert torch.equal(got["fused"][0], got["torch"][0])
    for a, b in zip(got["fused"][1], got["torch"][1]):
        assert float(b.norm()) > 0
        assert _rel(a, b) <= 1e-6


GRADS = {
    "none": (False, ()),
    "vertices": (False, ("mesh", "vertices")),
    "albedo": (False, ("materials", "cd")),
    "normals": (False, ("mesh", "normals")),
    "exponent": (False, ("materials", "specular_exp")),
    "epsilon": (False, ("epsilon",)),
    "corner": (True, ()),
    "corner_vertices": (True, ("mesh", "vertices")),
    "corner_normals": (True, ("mesh", "corner_normals")),
}


@pytest.mark.parametrize("case", list(GRADS))
def test_ray_grads_follow_the_torch_body(case):
    """``_ray_grads`` says, for every pair of ray flags, which of the next
    origin, the next direction and the first t the torch body's bounce
    makes require grad, exactly: the fused bounce marks the rest
    constant, so that its backward differentiates no more than the
    checkpoint's."""
    corner, path = GRADS[case]
    scene, cam = _box(corner=corner)
    params = _params(scene, 1)
    if path:
        obj = params if path == ("epsilon",) else params.scene
        for name in path[:-1]:
            obj = getattr(obj, name)
        setattr(obj, path[-1],
                getattr(obj, path[-1]).detach().clone().requires_grad_())
    x, y = _pixel_grid(W, H, CPU)
    base = cam.primary_rays(x, y, W, H, None)
    n = x.shape[0]
    body = pt._bounce_body(
        lights=params.scene.lights,
        amb3=torch.as_tensor(params.ambient_color[:3]), eps=params.epsilon,
        nee=True, reversed_shadow=True)
    for o_rg in (False, True):
        for d_rg in (False, True):
            ray = dataclasses.replace(
                base, ori=base.ori.clone().requires_grad_(o_rg),
                dir=base.dir.clone().requires_grad_(d_rg))
            with torch.enable_grad():
                out = body(pt.scene_tracer(params, binned=False), 0, ray,
                           Sampler.seed(1, torch.arange(n), 1),
                           torch.ones(n, dtype=torch.bool),
                           torch.ones(n, 3).requires_grad_(),
                           torch.zeros(n, 3).requires_grad_(), None, None,
                           torch.zeros(n, dtype=torch.bool))
            got = (out[0].ori.requires_grad, out[0].dir.requires_grad,
                   out[6].requires_grad)
            assert pt._ray_grads(params, o_rg, d_rg) == got, (o_rg, d_rg)


def test_an_unmarked_gradient_is_refused(monkeypatch):
    """Should ``_ray_grads`` leave out an output the torch body
    differentiates, the backward raises rather than drop its gradient."""
    scene, cam = _box(corner=True)
    params = _params(scene, 2)
    monkeypatch.setattr(pt, "_ray_grads", lambda *a: (False, False, False))
    with pytest.raises(RuntimeError, match="_ray_grads"):
        _step(params, cam, True, "fused", monkeypatch)


@pytest.mark.parametrize("marks", ("exact", "over"))
def test_recompute_differentiates_no_more_than_the_torch_body(marks,
                                                              monkeypatch):
    """Each fused bounce's recompute differentiates the ray's origin and
    direction exactly where the torch body's checkpointed bounce does:
    face normals held constant leave every direction out of the graph,
    and the origins past bounce 0 in it (the vertices).  An over-marked
    output (``_ray_grads`` saying all three differentiable) would build
    the BRDF lobes' graphs in every backward that the torch body never
    builds: it shows here as directions that require grad."""
    scene, cam = _box()
    params = _params(scene, 4)
    if marks == "over":
        monkeypatch.setattr(pt, "_ray_grads", lambda *a: (True, True, True))
    make, seen = pt._bounce_body, []

    def recording(**kw):
        body = make(**kw)

        def run(tr, bounce, ray, *rest):
            seen.append((bounce, ray.ori.requires_grad,
                         ray.dir.requires_grad))
            return body(tr, bounce, ray, *rest)
        return run

    monkeypatch.setattr(pt, "_bounce_body", recording)
    flags = {}
    for name in ("torch", "fused"):
        seen.clear()
        _step(params, cam, True, name, monkeypatch)
        # the torch body's checkpoint runs each bounce twice, forward and
        # recompute, alike; the fused path only recomputes, last first
        flags[name] = dict((b, f) for b, *f in reversed(seen))
    assert flags["torch"] == {0: [False, False], 1: [True, False],
                              2: [True, False], 3: [True, False]}
    assert (flags["fused"] == flags["torch"]) == (marks == "exact")


KEPT = {
    "treelets": _treelets,
    "textures": _textured,
    "area_lights": _area,
    "spectral": lambda s: lift_scene(s, 8),
}


@pytest.mark.parametrize("case", list(KEPT))
def test_excluded_step_takes_the_torch_body(case):
    """A treelet ClusterBVH, textures, an area light, spectral colour:
    the step runs the torch body, whatever autograd: no hit kernel (nor
    its plain version) runs, and the loss and gradients are finite."""
    scene, cam = _box()
    params = _params(KEPT[case](scene), 3)
    assert not pt._fused_ok(params)
    before = (dict(bs.PLAIN_CALLS), dict(trav.ENTRY_LAUNCHES))
    x, y = _pixel_grid(W, H, CPU)
    loss, (gv, gc) = step.loss_and_grads(
        params.scene.mesh.vertices, params.scene.materials.cd, 3, params,
        cam, x, y, nee=True, width=W, height=H, tile=W * H)
    assert (dict(bs.PLAIN_CALLS), dict(trav.ENTRY_LAUNCHES)) == before
    assert bool(torch.isfinite(loss))
    assert bool(torch.isfinite(gv).all() & torch.isfinite(gc).all())


LEAVES = {
    "vertices_and_albedo": ((("mesh", "vertices"), ("materials", "cd")),
                            True),
    "vertices": ((("mesh", "vertices"),), True),
    "albedo": ((("materials", "cd"),), True),
    "ray_and_carry_only": ((), True),
    "light_cl": ((("mesh", "vertices"), ("lights", "cl")), False),
    "material_ks": ((("materials", "cd"), ("materials", "ks")), False),
    "specular_exp": ((("materials", "specular_exp"),), False),
    "normals": ((("mesh", "normals"),), False),
    "corner_normals": ((("mesh", "corner_normals"),), False),
    "epsilon": ((("epsilon",),), False),
}


def _with_grads(params, paths):
    """``params`` with a copy of each tensor at ``paths`` (from the
    scene, or ``("epsilon",)``) made a leaf that requires grad."""
    for path in paths:
        if path == ("epsilon",):
            params = dataclasses.replace(params, epsilon=torch.tensor(
                float(params.epsilon), requires_grad=True))
            continue
        obj = getattr(params.scene, path[0])
        leaf = getattr(obj, path[1]).detach().clone().requires_grad_()
        params = dataclasses.replace(params, scene=dataclasses.replace(
            params.scene, **{path[0]: dataclasses.replace(
                obj, **{path[1]: leaf})}))
    return params


@pytest.mark.parametrize("case", list(LEAVES))
def test_backward_dispatch_by_leaves(case):
    """``_FusedBounce``'s backward takes the adjoint kernel where the lanes
    are on the card and every parameter tensor that requires grad is the
    vertices or the albedo (the ray and the carry it differentiates
    always); a light's, another material field's, the normals' or a
    tensor epsilon's gradient keeps the torch body's recompute, as does
    any CPU tensor."""
    paths, kernel = LEAVES[case]
    scene, _ = _box(lights=2, corner=case == "corner_normals")
    params = _with_grads(_params(scene, 2), paths)
    found = tuple(p for p, _ in pt._grad_leaves(params))
    assert sorted(found) == sorted(
        p if p == ("epsilon",) else ("scene",) + p for p in paths)
    fr = pt._Frame(params=params, sh=None, tables=(), nee=True, paths=found)
    assert pt._adjoint_ok(fr, torch.device("cuda")) == kernel
    assert pt._adjoint_ok(fr, "cuda:0") == kernel
    assert not pt._adjoint_ok(fr, torch.device("cpu"))


@pytest.mark.parametrize("leaves", ("vertices_and_albedo", "albedo"))
def test_adjoint_backward_wiring(leaves, monkeypatch):
    """With the adjoint taken (``_adjoint_ok`` forced, the kernel's
    wrapper replaced by a recorder that answers the recompute's
    gradients), the step asks ``shade_backward`` once a bounce, last
    bounce first, for exactly the gradients autograd needs (the leaves
    that require grad; past bounce 0 dst, acc and, with the vertices,
    the ray's origin), hands it the tape's refs (the shadow walk's with
    NEE), and returns what it answers: the step's gradients equal the
    recompute's."""
    scene, cam = _box(corner=False)
    params = _params(scene, 3)
    calls = []
    recompute = pt._FusedBounce.backward

    def recorder(sh, o, d, ref, state, active, dst, acc, prev_delta,
                 shadow_ref, g_o, g_d, g_dst, g_acc, g_first_t, bounce,
                 want):
        calls.append((bounce, set(want), shadow_ref is not None,
                      ref.dtype, ref.shape == (o.shape[0],)))
        return bs.Grads(*answers.pop())

    # the recompute's answers, bounce by bounce, recorded first
    answers = []

    def keep(ctx, *grads):
        out = recompute(ctx, *grads)
        fields = {f: out[pt._ARG[f]] for f in pt._DIFF_IN}
        leaf = {ctx.fr.paths[i]: out[pt._LEAF0 + i]
                for i in range(len(ctx.fr.paths))}
        answers.insert(0, (
            *(fields[f] for f in pt._DIFF_IN),
            leaf.get(("scene", "mesh", "vertices")),
            leaf.get(("scene", "materials", "cd"))))
        return out

    x, y = _pixel_grid(W, H, CPU)
    verts, cd = params.scene.mesh.vertices, params.scene.materials.cd
    if leaves == "albedo":
        def step_grads():
            with torch.enable_grad():
                c = cd.detach().requires_grad_()
                loss = step.frame_loss(verts, c, 3, params, cam, x, y,
                                       True, width=W, height=H, tile=W * H)
                return loss.detach(), torch.autograd.grad(loss, (c,))
    else:
        def step_grads():
            return step.loss_and_grads(verts, cd, 3, params, cam, x, y,
                                       nee=True, width=W, height=H,
                                       tile=W * H)
    with monkeypatch.context() as m:
        m.setattr(pt._FusedBounce, "backward", staticmethod(keep))
        want_loss, want = step_grads()
    with monkeypatch.context() as m:
        m.setattr(pt, "_adjoint_ok", lambda fr, dev: True)
        m.setattr(bs, "shade_backward", recorder)
        loss, got = step_grads()
    assert torch.equal(loss, want_loss) and not answers
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    leaf = {"vertices", "cd"} if leaves == "vertices_and_albedo" else {"cd"}
    assert [c[0] for c in calls] == [2, 1, 0]
    ray = {"o"} if leaves == "vertices_and_albedo" else set()
    assert [c[1] for c in calls] == [{"dst", "acc"} | ray | leaf] * 2 + [
        leaf], [c[1] for c in calls]
    assert all(c[2] and c[3] == torch.int32 and c[4] for c in calls)


def test_recompute_spans_carry_recompute(monkeypatch):
    """Traced, the step on an LBVH with point lights takes the fused path
    (``pathtracing_kernel`` picks it under autograd): its forward opens
    each bounce's spans once, untagged, inside ``step.forward``; the
    backward recomputes the torch body's bounces last to first, their
    spans tagged ``recompute=True`` inside ``step.backward``, counting
    nothing."""
    scene, cam = _box(corner=True)
    params = _params(scene, 5)
    phases = ["bounce.closest", "bounce.shade", "bounce.nee", "bounce.shade"]
    metrics.enable(True)
    metrics.reset()
    try:
        before = bs.PLAIN_CALLS[bs.ENTRY_HIT]
        _step(params, cam, True, None, monkeypatch)
        snap = metrics.snapshot()
    finally:
        metrics.enable(False)
        metrics.reset()
    assert bs.PLAIN_CALLS[bs.ENTRY_HIT] - before == 5
    spans = snap["spans"]
    names = [s["name"] for s in spans]
    fwd, bwd = (spans[names.index(n)]["host_ns"]
                for n in ("step.forward", "step.backward"))
    bounces = [s for s in spans if s["name"].startswith("bounce.")]
    forward = [s for s in bounces if "recompute" not in s["tags"]]
    again = [s for s in bounces if s["tags"].get("recompute")]
    assert [(s["name"], s["tags"]) for s in forward] == \
        [(p, {"bounce": b}) for b in range(5) for p in phases]
    assert [(s["name"], s["tags"]["bounce"]) for s in again] == \
        [(p, b) for b in reversed(range(5)) for p in phases]
    assert all(fwd[0] <= s["host_ns"][0] <= s["host_ns"][1] <= fwd[1]
               for s in forward)
    assert all(bwd[0] <= s["host_ns"][0] <= s["host_ns"][1] <= bwd[1]
               for s in again)
    assert snap["counters"]["bounce.lanes"] == [W * H] * 5


# The adjoint's gradients against the torch body's at the step, relative
# L2: each lane's chain rule in float32 in another order than autograd's.
# The vertices carry most of it, their Moeller-Trumbore shares nearly
# cancelling: two float32 evaluations of the same step differ by 2.4e-6
# there on the CPU (24x24 on sponza_like_scene(4000), the kernel built
# with g++), while the albedo, summed in f64 by the kernel, differs from
# the torch body's gathers summed in f64 (``f64_sums``) by 0 there.
ADJOINT_TOL = 1e-5


@pytest.mark.cuda
def test_step_on_the_card(monkeypatch):
    """On the card, 256x256, 5-bounce NEE on the sponza-like scene: the
    fused step's loss bit-equal to the torch body's; five hit-kernel
    launches a step, and five launches of the adjoint kernel in its
    backward, whose gradients are within ADJOINT_TOL of the torch body's
    (its gathers there summed in f64, ``f64_sums``);
    and with the adjoint off (its plain version, the torch body's
    recompute, as on the CPU) the gradients within 1e-6 relative L2 of
    the torch body's.  Deterministic algorithms, so that the gathers'
    backward sums each material's lanes in one order on the torch paths
    (with atomics the torch body's albedo gradient differs from itself by
    ~8e-6)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the bounce kernels have no CPU or "
                    "interpret mode (the CPU runs their plain versions)")
    dev = torch.device("cuda")
    scene, cam = sponza_like_scene(target_tris=4000, device=dev)
    params = KernelParams.create(scene, num_bounces=5, epsilon=1e-3,
                                 ambient_color=(1.0, 1.0, 1.0, 1.0))
    assert pt._fused_ok(params)
    kw = dict(w=256, h=256, dev=dev)
    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        trav.reset_launch_counts()
        loss, (gv, gc) = _step(params, cam, True, "fused", monkeypatch,
                               **kw)
        torch.cuda.synchronize()
        assert trav.ENTRY_LAUNCHES[bs.ENTRY_HIT] == 5
        assert trav.ENTRY_LAUNCHES[bs.ENTRY_CLOSE] == 5
        assert trav.ENTRY_LAUNCHES[bs.ENTRY_BWD] == 5
        with monkeypatch.context() as m:
            m.setattr(pt, "_adjoint_ok", lambda fr, d: False)
            plain, (pv, pc) = _step(params, cam, True, "fused", m, **kw)
        assert trav.ENTRY_LAUNCHES[bs.ENTRY_BWD] == 5
        body, (bv, bc) = _step(params, cam, True, "torch", monkeypatch,
                               **kw)
        with monkeypatch.context() as m:
            for mod in (materials_module, scene_module, trace_module):
                m.setattr(mod, "take", f64_sums)
            body64, (bv64, bc64) = _step(params, cam, True, "torch", m,
                                         **kw)
    finally:
        torch.use_deterministic_algorithms(was[0], warn_only=was[1])
    assert trav.ENTRY_LAUNCHES[bs.ENTRY_HIT] == 10
    assert torch.equal(loss, body), (float(loss), float(body))
    assert torch.equal(plain, body) and torch.equal(body64, body)
    assert _rel(pv, bv) <= 1e-6, _rel(pv, bv)
    assert _rel(pc, bc) <= 1e-6, _rel(pc, bc)
    assert bool(torch.isfinite(gv).all() & torch.isfinite(gc).all())
    assert _rel(gv, bv64) <= ADJOINT_TOL, _rel(gv, bv64)
    assert _rel(gc, bc64) <= ADJOINT_TOL, _rel(gc, bc64)

"""The LBVH tier's CUDA kernel (ops/cuda/traverse_lbvh.cu) vs its plain
PyTorch version, on the card, in every form: triangles closest, any and
multi-hit (k = 1, 4, 16) on 1:1 leaves (LBVH, SAH), closest and any on
generalized SBVH leaves, spheres closest and any; axis-aligned rays whose
origins lie on box planes (the NaN slab case), dead lanes, a single-leaf
tree, the counters and the launch counts.  Also: the LBVH built on the
card equals the CPU build, table for table.

Marked ``cuda``: each test skips itself when torch.cuda.is_available() is
False (decided inside the fixture, never at import).  On a GPU machine:

    python -m pytest tests/test_torch_cuda_lbvh.py -q

The kernel is built with -fmad=false and follows the plain version's
walk and operation order, so refs and t must be equal, bit for bit.
"""

import numpy as np
import pytest
import torch

from visionaray_torch.core.scene import Spheres, TriangleMesh
from visionaray_torch.ops import lbvh, sah
from visionaray_torch.ops import traversal as tt
from visionaray_torch.ops import traverse as trav
from visionaray_torch.scenes.sponza_like import sponza_like_scene

pytestmark = pytest.mark.cuda

FLT_MAX = 3.4028234663852886e38


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the LBVH traversal kernel has no CPU "
                    "or interpret mode (chip_smoke.py runs it on the H100)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def scene(cuda):
    s, _ = sponza_like_scene(target_tris=4000, device=cuda)
    rng = np.random.default_rng(0)
    n = 6000
    o = rng.uniform([0.5, 0.5, 0.5], [23.5, 9.5, 11.5], (n, 3))
    d = rng.normal(size=(n, 3))
    mt = rng.uniform(-1.0, 30.0, n)
    mt[::5] = FLT_MAX
    f32 = dict(dtype=torch.float32, device=cuda)
    return (s, torch.as_tensor(o, **f32), torch.as_tensor(d, **f32),
            torch.as_tensor(mt, **f32))


def _same(bvh, prim, geom, o, d, mt, mode, k=1):
    tabs = tt.prim_tables(prim, geom)
    kt, kr = tt.bvh_traverse(o, d, mt, bvh, prim, tabs, mode, k)
    pt, pr = tt.traverse_bvh_plain(o, d, mt, bvh, prim, tabs, mode, k)
    torch.cuda.synchronize()
    assert torch.equal(kr, pr)
    assert torch.equal(torch.nan_to_num(kt, nan=-7.0),
                       torch.nan_to_num(pt, nan=-7.0))
    return kr


def test_build_on_card_equals_cpu_build(scene):
    s = scene[0]
    cpu_mesh = TriangleMesh(**{k: (v.cpu() if torch.is_tensor(v) else v)
                               for k, v in vars(s.mesh).items()})
    ref = lbvh.build_lbvh(cpu_mesh)
    for name in ("node_lo", "node_hi", "left", "right", "parent",
                 "prim_ids"):
        assert torch.equal(getattr(s.bvh, name).cpu(), getattr(ref, name))
    assert s.bvh.depth == ref.depth


@pytest.mark.parametrize("mode,k", [("closest", 1), ("any", 1),
                                    ("multi", 1), ("multi", 4),
                                    ("multi", 16)])
def test_lbvh_forms(scene, mode, k):
    s, o, d, mt = scene
    trav.reset_launch_counts()
    refs = _same(s.bvh, "triangle", s.mesh, o, d, mt, mode, k)
    assert int((refs >= 0).sum()) > 1000
    assert trav.LAUNCHES[f"lbvh_{mode}"] == 1
    assert trav.ENTRY_LAUNCHES["vsnray_traverse_lbvh"] == 1
    assert trav.VARIANT_LAUNCHES == {f"lbvh_{mode}/leaves_1to1": 1}


@pytest.mark.parametrize("mode", ["closest", "any"])
def test_sah_and_sbvh_forms(scene, mode):
    s, o, d, mt = scene
    for bvh in (sah.build_sah(s.mesh), sah.build_sbvh(s.mesh)):
        trav.reset_launch_counts()
        _same(bvh, "triangle", s.mesh, o, d, mt, mode)
        form = "generalized" if bvh.leaf_first is not None else "1to1"
        assert trav.VARIANT_LAUNCHES == {f"lbvh_{mode}/leaves_{form}": 1}


@pytest.mark.parametrize("mode", ["closest", "any"])
def test_sphere_forms(cuda, scene, mode):
    _, o, d, mt = scene
    rng = np.random.default_rng(1)
    S = 3000
    center = rng.uniform([0.0, 0.0, 0.0], [24.0, 10.0, 12.0], (S, 3))
    radius = np.exp(rng.uniform(np.log(0.01), np.log(0.5), S))
    radius[::100] = 1e-9
    sp = Spheres.create(center, radius, device=cuda)
    bvh = tt.build_sphere_bvh(sp)
    trav.reset_launch_counts()
    refs = _same(bvh, "sphere", sp, o, d, mt, mode)
    assert int((refs >= 0).sum()) > 100
    assert trav.LAUNCHES[f"sphere_{mode}"] == 1


@pytest.mark.parametrize("mode", ["closest", "any", "multi"])
def test_nan_slab_rays(scene, mode):
    """Axis-aligned rays whose origins lie on node box planes: a zero
    direction component times an infinite reciprocal is NaN there."""
    s, _, _, _ = scene
    lo = s.bvh.node_lo[:2000]
    hi = s.bvh.node_hi[:2000]
    o = torch.cat([lo, hi, lo]).contiguous()
    d = torch.zeros_like(o)
    n = lo.shape[0]
    d[:n, 0] = 1.0
    d[n:2 * n, 1] = -1.0
    d[2 * n:, 2] = 1.0
    mt = torch.full((o.shape[0],), FLT_MAX, dtype=torch.float32,
                    device=o.device)
    _same(s.bvh, "triangle", s.mesh, o, d, mt, mode, 4)


def test_single_leaf_and_dead_lanes(cuda, scene):
    _, o, d, mt = scene
    verts = torch.tensor([[5.0, 2.0, 3.0], [6.0, 2.0, 3.0], [5.0, 3.0, 3.0]])
    mesh = TriangleMesh.create(verts, [[0, 1, 2]], device=cuda)
    bvh = lbvh.build_lbvh(mesh)
    assert bvh.num_nodes == 1
    toward = torch.tensor([5.2, 2.2, 3.0], device=cuda) - o
    for mode in ("closest", "any", "multi"):
        refs = _same(bvh, "triangle", mesh, o, toward.contiguous(), mt, mode)
        assert bool((refs[mt <= 0] < 0).all())
        assert int((refs >= 0).sum()) > 100


def test_counters(scene):
    s, o, d, mt = scene
    tabs = tt.prim_tables("triangle", s.mesh)
    cnt = torch.zeros((o.shape[0], 2), dtype=torch.int32, device=o.device)
    kt, kr = tt.bvh_traverse(o, d, mt, s.bvh, "triangle", tabs, "closest",
                             counters=cnt)
    t2, r2 = tt.bvh_traverse(o, d, mt, s.bvh, "triangle", tabs, "closest")
    assert torch.equal(kr, r2) and torch.equal(kt, t2)
    dead = mt <= 0
    assert int(cnt[dead].abs().sum()) == 0
    assert bool((cnt[~dead, 0] >= 2).all())
    assert bool((cnt[kr >= 0, 1] >= 1).all())

"""The LBVH walk's per-lane test counts (ops/traversal.py) and the
``walk.<mode>.*`` counters they feed:

- on the CPU, ``traverse_bvh_plain``'s counts equal a per-ray Python walk
  of the same tree (2 box tests a visited internal node, one primitive
  test a primitive tested in a visited leaf, nothing for a dead lane),
  for closest and any-hit rays, on an LBVH and an SBVH of tens of
  triangles, on a single 1:1 leaf and on a single generalized leaf;
- with the program's tracing on and counting tests, ``bvh_traverse``
  counts ``walk.<mode>.rays``, ``.box`` and ``.prim``: the lanes that
  tested anything and the sums of the per-lane counts; off, or on without
  ``tests`` (a stretch whose spans are timed), it asks the walk for no
  counts and counts nothing;
- on the card (``cuda``), the kernel's counts equal the plain walk's,
  lane for lane, on the LBVH scene of tests/test_torch_cuda_lbvh.py and
  on an SBVH of it (the kernel's generalized-leaf form).
"""

import numpy as np
import pytest
import torch

from visionaray_torch.core.scene import TriangleMesh
from visionaray_torch.ops import lbvh, sah
from visionaray_torch.ops import traversal as tt
from visionaray_torch.ops.intersect import intersect_aabb, intersect_triangle
from visionaray_torch.scenes.sponza_like import sponza_like_scene
from visionaray_torch.utils import metrics

torch.set_num_threads(1)
FLT_MAX = 3.4028234663852886e38
MODES = ("closest", "any")


@pytest.fixture(autouse=True)
def tracing_off():
    metrics.enable(False)
    metrics.reset()
    yield
    metrics.enable(False)
    metrics.reset()


def _soup(n_tris=40, seed=0):
    """A mesh of ``n_tris`` small random triangles in a 10-unit box."""
    rng = np.random.default_rng(seed)
    centre = rng.uniform(0.0, 10.0, (n_tris, 1, 3))
    verts = (centre + rng.uniform(-1.0, 1.0, (n_tris, 3, 3))).reshape(-1, 3)
    faces = np.arange(3 * n_tris).reshape(-1, 3)
    return TriangleMesh.create(verts, faces, device="cpu")


def _rays(n=64, seed=1):
    """Rays from inside the box, half of them aimed at a triangle's first
    corner of the soup; every fourth lane dead (max_t <= 0), a few with a
    short max_t."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(1.0, 9.0, (n, 3))
    d = rng.normal(size=(n, 3))
    corners = _soup().vertices.numpy()[0::3]
    aim = corners[rng.integers(0, corners.shape[0], n // 2)]
    d[::2] = aim + rng.uniform(-0.3, 0.3, aim.shape) - o[::2]
    mt = np.full(n, FLT_MAX)
    mt[::4] = rng.uniform(-1.0, 0.0, mt[::4].shape)
    mt[1::7] = 2.0
    f32 = dict(dtype=torch.float32)
    return (torch.as_tensor(o, **f32), torch.as_tensor(d, **f32),
            torch.as_tensor(mt, **f32))


def _single_leaf(mesh, generalized: bool):
    """A tree that is one leaf: over triangle 0 (1:1), or a generalized
    leaf over references to triangles 2, 0, 1."""
    if not generalized:
        one = TriangleMesh.create(mesh.vertices[:3], [[0, 1, 2]],
                                  device="cpu")
        bvh = lbvh.build_lbvh(one)
        assert bvh.num_nodes == 1
        return one, bvh
    lo, hi = lbvh.triangle_aabbs(*mesh.corners())
    i32 = dict(dtype=torch.int32)
    return mesh, lbvh.BVH(
        node_lo=lo[:3].amin(0, keepdim=True),
        node_hi=hi[:3].amax(0, keepdim=True),
        left=torch.zeros(0, **i32), right=torch.zeros(0, **i32),
        parent=torch.full((1,), -1, **i32),
        prim_ids=torch.tensor([2, 0, 1], **i32),
        leaf_first=torch.zeros(1, **i32),
        leaf_count=torch.full((1,), 3, **i32), max_leaf_size=4)


def _walk_one(o, d, mt, bvh, tables, mode):
    """(box tests, primitive tests, ref) of one ray, walked node by node
    in Python: the kernel's visit order and counting rule."""
    if not float(mt) > 0.0:
        return 0, 0, -1
    base = bvh.num_leaves - 1
    left, right = bvh.left.tolist(), bvh.right.tolist()
    pids = bvh.prim_ids.tolist()
    inv = 1.0 / d
    v1, e1, e2 = tables
    box = prim = 0
    best_t, best = float(mt), -1
    stack, node = [], 0
    while True:
        if node >= base:
            slot = node - base
            if bvh.leaf_first is None:
                refs = [slot]
            else:
                first = int(bvh.leaf_first[slot])
                cnt = min(int(bvh.leaf_count[slot]), bvh.max_leaf_size)
                refs = [min(first + j, bvh.num_prims - 1)
                        for j in range(max(cnt, 0))]
            for ref in refs:
                p = pids[ref]
                t, _, _, hit = intersect_triangle(o, d, v1[p], e1[p], e2[p])
                prim += 1
                if bool(hit) and 0.0 <= float(t) < best_t:
                    best_t, best = float(t), ref
            if (mode == "any" and best >= 0) or not stack:
                break
            node = stack.pop()
            continue
        lc, rc = left[node], right[node]
        tn1, tf1, h1 = intersect_aabb(o, inv, bvh.node_lo[lc],
                                      bvh.node_hi[lc])
        tn2, tf2, h2 = intersect_aabb(o, inv, bvh.node_lo[rc],
                                      bvh.node_hi[rc])
        box += 2
        b1 = bool(h1) and float(tn1) < best_t and float(tf1) >= 0.0
        b2 = bool(h2) and float(tn2) < best_t and float(tf2) >= 0.0
        if b1 and b2:
            near_left = float(tn1) < float(tn2)
            stack.append(rc if near_left else lc)
            node = lc if near_left else rc
        elif b1 or b2:
            node = lc if b1 else rc
        elif stack:
            node = stack.pop()
        else:
            break
    return box, prim, best


def _trees():
    mesh = _soup()
    yield "lbvh", mesh, lbvh.build_lbvh(mesh)
    yield "sbvh", mesh, sah.build_sbvh(mesh)
    yield ("single_leaf", *_single_leaf(mesh, False))
    yield ("generalized_leaf", *_single_leaf(mesh, True))


TREES = {name: (mesh, bvh) for name, mesh, bvh in _trees()}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("tree", sorted(TREES))
def test_plain_counts_equal_a_per_ray_walk(tree, mode):
    mesh, bvh = TREES[tree]
    o, d, mt = _rays()
    if tree.endswith("leaf"):   # aim at the leaf's triangles: some hit
        d = (mesh.vertices[:3].mean(0) - o).contiguous()
    tabs = tt.prim_tables("triangle", mesh)
    cnt = torch.full((o.shape[0], 2), -5, dtype=torch.int32)
    _, ref = tt.traverse_bvh_plain(o, d, mt, bvh, "triangle", tabs, mode,
                                   counters=cnt)
    want = [_walk_one(o[i], d[i], mt[i], bvh, tabs, mode)
            for i in range(o.shape[0])]
    assert cnt.tolist() == [[b, p] for b, p, _ in want]
    assert ref.tolist() == [r for _, _, r in want]
    dead = mt <= 0
    assert int(cnt[dead].abs().sum()) == 0
    assert bool((cnt[~dead].sum(dim=1) > 0).all())
    assert int((ref >= 0).sum()) > 0
    if bvh.num_nodes == 1:
        assert int(cnt[:, 0].abs().sum()) == 0


@pytest.mark.parametrize("tree", sorted(TREES))
def test_tracing_counts_the_walks(tree):
    mesh, bvh = TREES[tree]
    o, d, mt = _rays()
    tabs = tt.prim_tables("triangle", mesh)
    per_lane = {}
    for mode in MODES:
        cnt = torch.zeros((o.shape[0], 2), dtype=torch.int32)
        tt.traverse_bvh_plain(o, d, mt, bvh, "triangle", tabs, mode,
                              counters=cnt)
        per_lane[mode] = cnt
    metrics.enable(True, tests=True)
    for mode in MODES:
        tt.bvh_traverse(o, d, mt, bvh, "triangle", tabs, mode)
    got = metrics.snapshot()["counters"]
    want = {}
    for mode, cnt in per_lane.items():
        want[f"walk.{mode}.rays"] = int((cnt.sum(dim=1) > 0).sum())
        want[f"walk.{mode}.box"] = int(cnt[:, 0].sum())
        want[f"walk.{mode}.prim"] = int(cnt[:, 1].sum())
    assert got == want
    assert want["walk.closest.rays"] == int((mt > 0).sum())
    # a caller's own counters are filled, and not counted again
    metrics.reset()
    mine = torch.zeros((o.shape[0], 2), dtype=torch.int32)
    tt.bvh_traverse(o, d, mt, bvh, "triangle", tabs, "closest",
                    counters=mine)
    assert torch.equal(mine, per_lane["closest"])
    assert metrics.snapshot()["counters"] == {}
    # nor inside a checkpoint's recompute
    with metrics.recomputing():
        tt.bvh_traverse(o, d, mt, bvh, "triangle", tabs, "closest")
    assert metrics.snapshot()["counters"] == {}


def _no_counts(monkeypatch):
    """The walks of every mode get no counters and nothing is counted."""
    mesh, bvh = TREES["lbvh"]
    o, d, mt = _rays()
    tabs = tt.prim_tables("triangle", mesh)
    seen = []
    plain = tt.traverse_bvh_plain

    def spy(*a, **k):
        seen.append(a[8] if len(a) > 8 else k.get("counters"))
        return plain(*a, **k)

    monkeypatch.setattr(tt, "traverse_bvh_plain", spy)
    for mode in MODES:
        tt.bvh_traverse(o, d, mt, bvh, "triangle", tabs, mode)
    assert seen == [None, None]
    assert metrics.snapshot()["counters"] == {}


def test_tracing_off_asks_for_no_counts(monkeypatch):
    _no_counts(monkeypatch)


def test_spans_alone_ask_for_no_counts(monkeypatch):
    """Tracing on without ``tests``, as in a stretch whose spans are
    timed: the walk gets no counters, so it runs its non-counting form."""
    metrics.enable(True)
    assert metrics.enabled() and not metrics.counting_tests()
    _no_counts(monkeypatch)


@pytest.mark.cuda
@pytest.mark.parametrize("mode, tree", [
    ("closest", "lbvh"), ("any", "lbvh"), ("multi", "lbvh"),
    ("closest", "sbvh"), ("any", "sbvh")])
def test_kernel_counts_equal_plain_counts(mode, tree):
    """The counting form of traverse_lbvh.cu against the plain walk, lane
    for lane, on the 4,000-triangle courtyard's LBVH and its SBVH (the
    generalized-leaf form; the kernel's multi-hit takes 1:1 leaves alone)
    with random rays, a fifth of them unbounded and some dead."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the LBVH traversal kernel has no CPU "
                    "or interpret mode")
    dev = torch.device("cuda")
    s, _ = sponza_like_scene(target_tris=4000, device=dev)
    bvh = s.bvh if tree == "lbvh" else sah.build_sbvh(s.mesh)
    rng = np.random.default_rng(0)
    n = 6000
    o = rng.uniform([0.5, 0.5, 0.5], [23.5, 9.5, 11.5], (n, 3))
    d = rng.normal(size=(n, 3))
    mt = rng.uniform(-1.0, 30.0, n)
    mt[::5] = FLT_MAX
    f32 = dict(dtype=torch.float32, device=dev)
    o, d, mt = (torch.as_tensor(x, **f32) for x in (o, d, mt))
    tabs = tt.prim_tables("triangle", s.mesh)
    k = 4 if mode == "multi" else 1
    kc = torch.zeros((n, 2), dtype=torch.int32, device=dev)
    pc = torch.zeros((n, 2), dtype=torch.int32, device=dev)
    _, kr = tt.bvh_traverse(o, d, mt, bvh, "triangle", tabs, mode, k,
                            counters=kc)
    _, pr = tt.traverse_bvh_plain(o, d, mt, bvh, "triangle", tabs, mode, k,
                                  counters=pc)
    torch.cuda.synchronize()
    assert torch.equal(kr, pr)
    assert torch.equal(kc, pc), int((kc != pc).any(dim=1).sum())
    assert int(kc[mt <= 0].abs().sum()) == 0
    assert bool((kc[mt > 0, 0] >= 2).all())

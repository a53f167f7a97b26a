"""The CUDA traversal kernel vs its plain PyTorch version, on the card.

Marked ``cuda``: each test skips itself when torch.cuda.is_available() is
False (the decision is taken inside the fixture, never at import).  On a
GPU machine:

    python -m pytest tests/test_torch_cuda_traverse.py -q

The kernel is built with -fmad=false, so on the same triangle it computes
the plain version's t, u, v bit for bit.  The tests require equal hit
flags, misses that keep t = max_t, and for closest-hit equal t, u, v where
the prims agree; a prim may differ only on a tie at equal t.  Any-hit
reports the first hit each side finds, so only its flag is compared.  The
same holds for every 1f form (fanout 4/8, the half-cluster skip): they
change the visiting order and the culling, not the result.
"""

import numpy as np
import pytest
import torch

from visionaray_torch.core.scene import TriangleMesh
from visionaray_torch.core.types import Ray
from visionaray_torch.ops import traverse as trav
from visionaray_torch.ops.cluster_bvh import build_cluster_bvh
from visionaray_torch.scenes.sponza_like import sponza_like_scene

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the traversal kernel has no CPU or "
                    "interpret mode (chip_smoke.py runs it on the H100)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def scene(cuda):
    with torch.inference_mode():
        s, cam = sponza_like_scene(target_tris=20000, build_bvh=False,
                                   device=cuda)
        s.bvh = build_cluster_bvh(s.mesh, cluster_size=16, treelet_size=16)
        rng = np.random.default_rng(0)
        n = 20000
        o = torch.as_tensor(rng.uniform([0.5, 0.5, 0.5], [23.5, 9.5, 11.5],
                                        (n, 3)), dtype=torch.float32,
                            device=cuda)
        d = torch.as_tensor(rng.normal(size=(n, 3)), dtype=torch.float32,
                            device=cuda)
        d = d / d.norm(dim=-1, keepdim=True)
    return s, Ray(o, d)


def _check(got, ref, rays, any_hit):
    live = rays[:, 6] >= 0
    gh, rh = got[1] >= 0, ref[1] >= 0
    assert torch.equal(gh, rh)
    assert torch.equal(got[0][~gh], rays[:, 6][~gh])
    assert int(live.sum()) > 0 and int(gh.sum()) > 0
    if any_hit:   # the first hit found: traversal order picks which
        return
    both = gh & rh
    same = both & (got[1] == ref[1])
    assert torch.equal(got[0][same], ref[0][same])
    # a prim may differ only on a tie (same t, other triangle)
    assert torch.equal(got[0][both & ~same], ref[0][both & ~same])
    assert torch.equal(got[2][same], ref[2][same])
    assert torch.equal(got[3][same], ref[3][same])


@pytest.mark.parametrize("any_hit", [False, True])
def test_coherent_modes_match_plain(scene, any_hit):
    s, ray = scene
    bvh = s.bvh
    n = ray.ori.shape[0]
    mt = torch.full((n,), 1e30, device=ray.ori.device)
    mt[::7] = -1.0
    npad = trav._round_up(n, 8192)
    rays = trav._pack_rays(ray.ori, ray.dir, mt, n, npad, pad_maxt=-1.0)
    before = trav.LAUNCHES["any" if any_hit else "closest"]
    entry = trav.ENTRY_LAUNCHES["vsnray_traverse_coherent"]
    got = trav.cluster_traverse(rays, bvh.nodes, bvh.tris, bvh.num_clusters,
                                bvh.cluster_size, tile_lanes=4096,
                                any_hit=any_hit)
    assert trav.LAUNCHES["any" if any_hit else "closest"] == before + 1
    assert trav.ENTRY_LAUNCHES["vsnray_traverse_coherent"] == entry + 1
    roots, splits = trav._default_tiles(npad, 4096, rays.device)
    ref = trav.traverse_plain(rays, bvh.nodes, bvh.tris, bvh.num_clusters,
                              bvh.cluster_size, 4096, any_hit, roots, splits)
    _check(got, ref, rays, any_hit)


@pytest.mark.parametrize("any_hit", [False, True])
def test_binned_rounds_match_plain(scene, any_hit, monkeypatch):
    s, ray = scene
    bvh = s.bvh
    calls = []
    real = trav.cluster_traverse

    def check(rays, nodes, tris, C, K, tile_lanes, any_hit=False,
              tile_roots=None, tile_splits=None, counters=None, **tree):
        got = real(rays, nodes, tris, C, K, tile_lanes, any_hit, tile_roots,
                   tile_splits, **tree)
        ref = trav.traverse_plain(rays, nodes, tris, C, K, tile_lanes,
                                  any_hit, tile_roots, tile_splits)
        _check(got, ref, rays, any_hit)
        calls.append(int((tile_splits < tile_lanes).sum()))
        return got

    monkeypatch.setattr(trav, "cluster_traverse", check)
    mt = torch.full((ray.ori.shape[0],), 1e30, device=ray.ori.device)
    with torch.inference_mode():
        trav._binned_trace(ray, bvh, mt, 3, any_hit=any_hit)
    assert len(calls) >= 1 and sum(calls) >= 1


# row 1f: (fanout, half_skip) forms of the kernel on the K=16 kd build
VARIANTS = [(4, False), (8, False), (2, True), (4, True), (8, True)]


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("fanout,half_skip", VARIANTS)
def test_1f_coherent_match_plain(scene, any_hit, fanout, half_skip):
    """Wide descent and the half-cluster skip change the visiting order
    and the culling, not the result.  These coherent forms run on
    traverse_binned.cu (every tile from root 0)."""
    s, ray = scene
    bvh = s.bvh
    assert bvh.heap and bvh.half_boxes
    n = ray.ori.shape[0]
    mt = torch.full((n,), 1e30, device=ray.ori.device)
    mt[::7] = -1.0
    npad = trav._round_up(n, 8192)
    rays = trav._pack_rays(ray.ori, ray.dir, mt, n, npad, pad_maxt=-1.0)
    mode = "any" if any_hit else "closest"
    key = trav.variant_key(mode, fanout, half_skip)
    before = trav.VARIANT_LAUNCHES.get(key, 0)
    entry = trav.ENTRY_LAUNCHES["vsnray_traverse_binned"]
    counters = torch.zeros((npad, 2), dtype=torch.int32, device=rays.device)
    got = trav.cluster_traverse(rays, bvh.nodes, bvh.tris, bvh.num_clusters,
                                bvh.cluster_size, tile_lanes=4096,
                                any_hit=any_hit, counters=counters,
                                fanout=fanout, half_skip=half_skip)
    assert trav.VARIANT_LAUNCHES[key] == before + 1
    assert trav.ENTRY_LAUNCHES["vsnray_traverse_binned"] == entry + 1
    roots, splits = trav._default_tiles(npad, 4096, rays.device)
    ref = trav.traverse_plain(rays, bvh.nodes, bvh.tris, bvh.num_clusters,
                              bvh.cluster_size, 4096, any_hit, roots, splits)
    _check(got, ref, rays, any_hit)
    base = torch.zeros_like(counters)
    trav.cluster_traverse(rays, bvh.nodes, bvh.tris, bvh.num_clusters,
                          bvh.cluster_size, tile_lanes=4096, any_hit=any_hit,
                          counters=base)
    if half_skip and not any_hit:
        # a skipped half's triangles are not tested
        assert int(counters[:, 1].sum()) < int(base[:, 1].sum())


@pytest.mark.parametrize("fanout,half_skip", VARIANTS)
def test_1f_binned_rounds_match_plain(scene, fanout, half_skip,
                                      monkeypatch):
    """The two-pass tiles of real binned rounds (closest-hit and any-hit)
    under each 1f form."""
    s, ray = scene
    bvh = s.bvh
    calls = []
    real = trav.cluster_traverse

    def check(rays, nodes, tris, C, K, tile_lanes, any_hit=False,
              tile_roots=None, tile_splits=None, counters=None, **tree):
        assert (tree["fanout"], tree["half_skip"]) == (fanout, half_skip)
        got = real(rays, nodes, tris, C, K, tile_lanes, any_hit, tile_roots,
                   tile_splits, **tree)
        ref = trav.traverse_plain(rays, nodes, tris, C, K, tile_lanes,
                                  any_hit, tile_roots, tile_splits)
        _check(got, ref, rays, any_hit)
        calls.append(int((tile_splits < tile_lanes).sum()))
        return got

    monkeypatch.setattr(trav, "cluster_traverse", check)
    mt = torch.full((ray.ori.shape[0],), 1e30, device=ray.ori.device)
    with torch.inference_mode():
        for any_hit in (False, True):
            trav._binned_trace(ray, bvh, mt, 3, any_hit, fanout, half_skip)
    assert len(calls) >= 2 and sum(calls) >= 1


def _c1_case(device):
    """A mesh of 24 triangles in one cluster (C == 1) and 20000 rays aimed
    at random points of its box."""
    rng = np.random.default_rng(3)
    verts = rng.uniform(-1, 1, (72, 3)).astype(np.float32)
    faces = np.arange(72, dtype=np.int32).reshape(24, 3)
    mesh = TriangleMesh.create(verts, faces, device=device)
    o = rng.uniform(-3, 3, (20000, 3))
    d = rng.uniform(-1, 1, (20000, 3)) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return (build_cluster_bvh(mesh, cluster_size=32),
            Ray(torch.as_tensor(o, dtype=torch.float32, device=device),
                torch.as_tensor(d, dtype=torch.float32, device=device)))


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("kind", ["radix", "c1"])
def test_radix_modes_match_plain(scene, cuda, kind, any_hit):
    """Row 1e: the radix tree (children from the kids columns) and the
    single-cluster tree, from node 0."""
    if kind == "radix":
        s, ray = scene
        with torch.inference_mode():
            bvh = build_cluster_bvh(s.mesh, cluster_size=16)
        assert bvh.num_clusters > 1 and not bvh.heap
    else:
        with torch.inference_mode():
            bvh, ray = _c1_case(cuda)
        assert bvh.num_clusters == 1 and bvh.depth == 0
    n = ray.ori.shape[0]
    mt = torch.full((n,), 1e30, device=cuda)
    mt[::7] = -1.0
    npad = trav._round_up(n, 8192)
    rays = trav._pack_rays(ray.ori, ray.dir, mt, n, npad, pad_maxt=-1.0)
    mode = trav.launch_mode(False, bvh.num_clusters, False, any_hit)
    assert mode == ("c1_" if kind == "c1" else "radix_") + (
        "any" if any_hit else "closest")
    before = trav.LAUNCHES[mode]
    got = trav.cluster_traverse(rays, bvh.nodes, bvh.tris, bvh.num_clusters,
                                bvh.cluster_size, tile_lanes=4096,
                                any_hit=any_hit, heap=False,
                                depth=bvh.depth)
    assert trav.LAUNCHES[mode] == before + 1
    roots, splits = trav._default_tiles(npad, 4096, rays.device)
    ref = trav.traverse_plain(rays, bvh.nodes, bvh.tris, bvh.num_clusters,
                              bvh.cluster_size, 4096, any_hit, roots, splits,
                              heap=False)
    _check(got, ref, rays, any_hit)


def test_wrapper_rejects_bad_inputs(scene):
    s, ray = scene
    bvh = s.bvh
    rays = torch.zeros((4096, 8), device=ray.ori.device)
    with pytest.raises(ValueError, match="tris"):
        trav.cluster_traverse(rays, bvh.nodes, bvh.tris[:-1],
                              bvh.num_clusters, bvh.cluster_size, 4096)
    with pytest.raises(ValueError, match="nodes is on cpu"):
        trav.cluster_traverse(rays, bvh.nodes.cpu(), bvh.tris,
                              bvh.num_clusters, bvh.cluster_size, 4096)


# the two-pass kernel (traverse_binned.cu): every (fanout, half_skip) form
# at each compile-time K and at K=40 (its run-time-K form, the automatic
# cluster size of a ~430k-triangle mesh); the half skip needs half boxes
# (K >= 16)
BINNED_KS = (*trav.BINNED_K, 40)
BINNED_CASES = [(K, f, h) for K in BINNED_KS for f in trav.FANOUTS
                for h in (False, True) if K >= 16 or not h]


@pytest.fixture(scope="module")
def k_bvhs(scene):
    """The scene's mesh built at each K of BINNED_KS (T=16)."""
    s, _ = scene
    with torch.inference_mode():
        return {K: build_cluster_bvh(s.mesh, cluster_size=K, treelet_size=16)
                for K in BINNED_KS}


def _good_records(bvh):
    """(records (C, K, 16), valid (C, K): records of non-zero area -- a
    cluster's padding records have none -- and the clusters holding one)."""
    rec = bvh.tri_records()
    valid = torch.linalg.cross(rec[..., 3:6], rec[..., 6:9]).norm(dim=-1) \
        > 1e-6
    return rec, valid, torch.nonzero(valid.any(1)).reshape(-1)


def _aimed(bvh, clusters, rng, seed, origins=None):
    """Rays from random points of the scene box (or ``origins``) to a point
    inside a random valid triangle of each of ``clusters``."""
    dev = clusters.device
    rec, valid, _ = _good_records(bvh)
    lo, hi = bvh.nodes[0, 0:3], bvh.nodes[0, 3:6]
    gen = torch.Generator(device=dev).manual_seed(seed)
    k = torch.multinomial(valid[clusters].float(), 1,
                          generator=gen).reshape(-1)
    r = rec[clusters, k]
    w = torch.as_tensor(rng.uniform(0.1, 0.4, (clusters.shape[0], 2)),
                        dtype=torch.float32, device=dev)
    target = r[:, 0:3] + w[:, 0:1] * r[:, 3:6] + w[:, 1:2] * r[:, 6:9]
    o = lo + (hi - lo) * torch.as_tensor(
        rng.uniform(0.05, 0.95, (clusters.shape[0], 3)),
        dtype=torch.float32, device=dev)
    if origins is not None:
        o = origins(target, r)
    d = target - o
    return o, d / d.norm(dim=-1, keepdim=True)


def _edge_tiles(bvh, ray, seed=0):
    """Four 2048-lane two-pass tiles: (0) the scene's rays, split at lane 48
    so that warp 1 straddles pass A (a treelet root) and pass B (its
    parent); (1) all lanes dead; (2) every lane aimed at a triangle of one
    cluster, pass A starting at that cluster's leaf and pass B at its
    treelet's root; (3) lane j aimed at a triangle of the (37 j)-th
    non-empty cluster (mod their count) from the root, so that the lanes of
    a warp sit in different clusters.
    A third of the live lanes of tiles 0 and 3 have max_t cut short."""
    dev = ray.ori.device
    tl = trav.BINNED_ROWS * 128
    rng = np.random.default_rng(seed)
    C = bvh.num_clusters
    _, _, good = _good_records(bvh)

    def aimed(clusters):
        return _aimed(bvh, clusters, rng, seed)

    c_one = int(good[rng.integers(0, good.numel())])
    o0, d0 = ray.ori[:tl], ray.dir[:tl]
    o2, d2 = aimed(torch.full((tl,), c_one, device=dev))
    o3, d3 = aimed(good[torch.arange(tl, device=dev) * 37 % good.numel()])
    o = torch.cat([o0, o0, o2, o3])
    d = torch.cat([d0, d0, d2, d3])
    mt = torch.full((4 * tl,), 1e30, device=dev)
    cut = torch.as_tensor(rng.random(4 * tl) < 1 / 3, device=dev)
    mt = torch.where(cut, torch.as_tensor(rng.uniform(0.5, 4.0, 4 * tl),
                                          dtype=torch.float32, device=dev),
                     mt)
    mt[tl:2 * tl] = -1.0
    mt[2 * tl:3 * tl] = 1e30
    rays = trav._pack_rays(o, d, mt, 4 * tl, 4 * tl, pad_maxt=-1.0)
    troots = bvh.treelet_roots.tolist()
    s_one = c_one // bvh.treelet_size
    ta = troots[1]
    roots = torch.tensor([[ta, 0, C - 1 + c_one, 0],
                          [(ta - 1) // 2, 0, troots[s_one], 0]],
                         dtype=torch.int32, device=dev)
    splits = torch.tensor([48, tl, tl // 2, tl], dtype=torch.int32,
                          device=dev)
    return rays, roots, splits


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("K,fanout,half_skip", BINNED_CASES)
def test_binned_form_edge_tiles(scene, k_bvhs, K, fanout, half_skip,
                                any_hit):
    """traverse_binned.cu against the plain version on a straddling warp,
    an all-dead tile, a tile on one cluster and a tile on many."""
    _, ray = scene
    bvh = k_bvhs[K]
    rays, roots, splits = _edge_tiles(bvh, ray)
    tl = trav.BINNED_ROWS * 128
    mode = "binned_any" if any_hit else "binned_closest"
    key = trav.variant_key(mode, fanout, half_skip)
    before = trav.VARIANT_LAUNCHES.get(key, 0)
    got = trav.cluster_traverse(rays, bvh.nodes, bvh.tris, bvh.num_clusters,
                                K, tile_lanes=tl, any_hit=any_hit,
                                tile_roots=roots, tile_splits=splits,
                                fanout=fanout, half_skip=half_skip)
    assert trav.VARIANT_LAUNCHES[key] == before + 1
    ref = trav.traverse_plain(rays, bvh.nodes, bvh.tris, bvh.num_clusters,
                              K, tl, any_hit, roots, splits)
    _check(got, ref, rays, any_hit)
    hit = (got[1] >= 0).reshape(4, tl)
    assert not hit[1].any() and hit[2].all() and int(hit[3].sum()) > 100
    # tile 2's pass A starts at its cluster's leaf and sees only its prims
    c_one = int(roots[0, 2]) - (bvh.num_clusters - 1)
    own = set(bvh.tri_records()[c_one, :, 9].tolist())
    assert set(got[1].reshape(4, tl)[2, :tl // 2].tolist()) <= own


@pytest.mark.parametrize("K,fanout,half_skip", BINNED_CASES)
def test_binned_form_rounds(scene, k_bvhs, K, fanout, half_skip,
                            monkeypatch):
    """Real binned rounds, closest-hit and any-hit, at each K and form,
    with the kernel's counters: every live lane tests something."""
    _, ray = scene
    bvh = k_bvhs[K]
    calls = []
    real = trav.cluster_traverse

    def check(rays, nodes, tris, C, Kc, tile_lanes, any_hit=False,
              tile_roots=None, tile_splits=None, counters=None, **tree):
        npad = rays.shape[0]
        cnt = torch.zeros((npad, 2), dtype=torch.int32, device=rays.device)
        got = real(rays, nodes, tris, C, Kc, tile_lanes, any_hit, tile_roots,
                   tile_splits, cnt, **tree)
        ref = trav.traverse_plain(rays, nodes, tris, C, Kc, tile_lanes,
                                  any_hit, tile_roots, tile_splits)
        _check(got, ref, rays, any_hit)
        live = rays[:, 6] >= 0
        assert bool((cnt[live].sum(1) > 0).all())
        assert not bool(cnt[~live].any())
        calls.append(any_hit)
        return got

    monkeypatch.setattr(trav, "cluster_traverse", check)
    mt = torch.full((ray.ori.shape[0],), 1e30, device=ray.ori.device)
    with torch.inference_mode():
        for any_hit in (False, True):
            trav._binned_trace(ray, bvh, mt, 3, any_hit, fanout, half_skip)
    assert False in calls and True in calls


def test_binned_form_refusals(scene, k_bvhs):
    """The two-pass kernel takes no half skip at K=8, and no K that is not
    a multiple of 8."""
    _, ray = scene
    bvh = k_bvhs[8]
    rays, roots, splits = _edge_tiles(bvh, ray)
    tl = trav.BINNED_ROWS * 128
    with pytest.raises(ValueError, match="half boxes"):
        trav.cluster_traverse(rays, bvh.nodes, bvh.tris, bvh.num_clusters,
                              8, tl, tile_roots=roots, tile_splits=splits,
                              half_skip=True)
    with pytest.raises(ValueError, match="multiple of 8"):
        trav.cluster_traverse(rays, bvh.nodes, bvh.tris, bvh.num_clusters,
                              12, tl, tile_roots=roots, tile_splits=splits)


# traverse_coherent.cu: coherent lanes (every lane from the root of a heap
# tree) at each compile-time K, on lane layouts that drive the warp-packet
# walk, its leaf steps and the one-lane walk of incoherent warps
COHERENT_TILES = 5
SPREAD_COS = 0.985   # traverse_coherent.cu kSpreadCos


def _packet_warps(rays):
    """Per warp of 32 lanes, whether traverse_coherent.cu walks it as a
    packet: at most a quarter of its live lanes point further than
    acos(SPREAD_COS) from its first live lane."""
    w = rays.reshape(-1, 32, 8)
    live = w[..., 6] >= 0
    d = w[..., 3:6]
    ref = d.gather(1, live.to(torch.int8).argmax(1)[:, None, None]
                   .expand(-1, 1, 3))
    cos = (d * ref).sum(-1) / (d.norm(dim=-1) * ref.norm(dim=-1))
    apart = live & (cos < SPREAD_COS)
    return 4 * apart.sum(1) <= live.sum(1)


def _coherent_lanes(bvh, ray, seed=0):
    """Five 4096-lane tiles, every lane from the root: (0) a pinhole fan
    from one point over 0.1 rad, a 64 x 64 grid row by row, so that a warp
    is a strip of 32 adjacent pixels within 3 degrees (a packet); (1) tile
    0's lanes, warps dead in turn: every lane, the first half, every other
    lane, none; (2) every lane aimed at a triangle of one cluster from just
    in front of it (its warps all hit that cluster); (3) lane j aimed at a
    triangle of the (37 j)-th non-empty cluster from a random point, so
    that the lanes of a warp head to different clusters (walked lane by
    lane); (4) the scene's random rays.  A third of the live lanes of tiles
    0, 3 and 4 have max_t cut short."""
    dev = ray.ori.device
    tl = trav.TILE_ROWS * 128
    rng = np.random.default_rng(seed)
    _, _, good = _good_records(bvh)
    lo, hi = bvh.nodes[0, 0:3], bvh.nodes[0, 3:6]
    eye = lo + (hi - lo) * torch.tensor([0.05, 0.4, 0.3], device=dev)
    fwd = torch.tensor([1.0, -0.2, 0.3], device=dev)
    fwd = fwd / fwd.norm()
    right = torch.linalg.cross(fwd, torch.tensor([0.0, 1.0, 0.0],
                                                 device=dev))
    right = right / right.norm()
    up = torch.linalg.cross(right, fwd)
    u = (torch.arange(64, device=dev, dtype=torch.float32) + 0.5) / 64 - 0.5
    gy, gx = torch.meshgrid(u, u, indexing="ij")
    d0 = fwd + 0.1 * (gx.reshape(-1, 1) * right + gy.reshape(-1, 1) * up)
    d0 = d0 / d0.norm(dim=-1, keepdim=True)
    o0 = eye.expand(tl, 3)

    def in_front(target, r):   # just off the triangle along its normal
        n = torch.linalg.cross(r[:, 3:6], r[:, 6:9])
        return target + 1e-3 * (hi - lo).norm() * n / n.norm(dim=-1,
                                                              keepdim=True)

    c_one = int(good[rng.integers(0, good.numel())])
    o2, d2 = _aimed(bvh, torch.full((tl,), c_one, device=dev), rng, seed,
                    in_front)
    o3, d3 = _aimed(bvh, good[torch.arange(tl, device=dev) * 37
                              % good.numel()], rng, seed)
    o = torch.cat([o0, o0, o2, o3, ray.ori[:tl]])
    d = torch.cat([d0, d0, d2, d3, ray.dir[:tl]])
    n = COHERENT_TILES * tl
    mt = torch.full((n,), 1e30, device=dev)
    cut = torch.as_tensor(rng.random(n) < 1 / 3, device=dev)
    mt = torch.where(cut, torch.as_tensor(rng.uniform(0.5, 4.0, n),
                                          dtype=torch.float32, device=dev),
                     mt)
    mt[tl:3 * tl] = 1e30
    lane = torch.arange(tl, device=dev)
    kind = (lane // 32) % 4       # the dead lanes of tile 1's warps
    dead = (kind == 0) | ((kind == 1) & (lane % 32 < 16)) | \
        ((kind == 2) & (lane % 2 == 1))
    mt[tl:2 * tl] = torch.where(dead, -1.0, 1e30)
    return trav._pack_rays(o, d, mt, n, n, pad_maxt=-1.0), c_one


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("K", trav.BINNED_K)
def test_coherent_form_lanes(scene, k_bvhs, K, any_hit):
    """traverse_coherent.cu against the plain version on coherent and
    incoherent warps, a warp on one cluster, half-dead and all-dead
    warps."""
    _, ray = scene
    bvh = k_bvhs[K]
    rays, c_one = _coherent_lanes(bvh, ray)
    tl = trav.TILE_ROWS * 128
    entry = trav.ENTRY_LAUNCHES["vsnray_traverse_coherent"]
    got = trav.cluster_traverse(rays, bvh.nodes, bvh.tris, bvh.num_clusters,
                                K, tile_lanes=tl, any_hit=any_hit)
    assert trav.ENTRY_LAUNCHES["vsnray_traverse_coherent"] == entry + 1
    roots, splits = trav._default_tiles(rays.shape[0], tl, rays.device)
    ref = trav.traverse_plain(rays, bvh.nodes, bvh.tris, bvh.num_clusters,
                              K, tl, any_hit, roots, splits)
    _check(got, ref, rays, any_hit)
    hit = (got[1] >= 0).reshape(COHERENT_TILES, tl)
    live = (rays[:, 6] >= 0).reshape(COHERENT_TILES, tl)
    warps = live[1].reshape(-1, 32)
    assert not warps[0::4].any() and bool(warps[3::4].all())
    assert int(warps[1::4].sum(1).min()) == 16
    assert hit[0].any() and hit[1].any() and hit[2].all()
    assert int(hit[3].sum()) > 100
    packet = _packet_warps(rays).reshape(COHERENT_TILES, -1)
    assert bool(packet[0].all()) and not bool(packet[3].any())
    if not any_hit:
        # tile 2's lanes start just in front of their cluster
        own = set(bvh.tri_records()[c_one, :, 9].tolist())
        mine = got[1].reshape(COHERENT_TILES, tl)[2].tolist()
        assert sum(p in own for p in mine) >= 0.9 * tl


@pytest.mark.parametrize("K", trav.BINNED_K)
def test_coherent_two_pass_front_end(scene, k_bvhs, K, monkeypatch):
    """cluster_closest_hit(two_pass=True): lanes capped at
    TWO_PASS_CAP_FRAC of the scene diagonal, then the capped misses at
    full range among dead lanes, both launches through
    traverse_coherent.cu, each against the plain version."""
    s, ray = scene
    bvh = k_bvhs[K]
    caps = []
    real = trav.cluster_traverse

    def check(rays, nodes, tris, C, Kc, tile_lanes, any_hit=False,
              tile_roots=None, tile_splits=None, counters=None, **tree):
        entry = trav.ENTRY_LAUNCHES["vsnray_traverse_coherent"]
        got = real(rays, nodes, tris, C, Kc, tile_lanes, any_hit, tile_roots,
                   tile_splits, **tree)
        assert trav.ENTRY_LAUNCHES["vsnray_traverse_coherent"] == entry + 1
        roots, splits = trav._default_tiles(rays.shape[0], tile_lanes,
                                            rays.device)
        ref = trav.traverse_plain(rays, nodes, tris, C, Kc, tile_lanes,
                                  any_hit, roots, splits)
        _check(got, ref, rays, any_hit)
        caps.append(rays[:, 6].clone())
        return got

    monkeypatch.setattr(trav, "cluster_traverse", check)
    with torch.inference_mode():
        rec = trav.cluster_closest_hit(ray, bvh, s.mesh, two_pass=True)
    assert len(caps) == 2
    diag = float((bvh.nodes[0, 3:6] - bvh.nodes[0, 0:3]).norm())
    first = caps[0][caps[0] >= 0]
    assert float(first.max()) <= trav.TWO_PASS_CAP_FRAC * diag * (1 + 1e-6)
    assert bool((caps[1] < 0).any()) and bool((caps[1] > 1e29).any())
    assert int(rec.hit.sum()) > 0


@pytest.mark.parametrize("any_hit", [False, True])
def test_coherent_k40_goes_to_binned(scene, k_bvhs, any_hit):
    """Coherent lanes at K=40 (no compile-time form in
    traverse_coherent.cu) run traverse_binned.cu's run-time-K form."""
    _, ray = scene
    bvh = k_bvhs[40]
    rays, _ = _coherent_lanes(bvh, ray)
    tl = trav.TILE_ROWS * 128
    entry = trav.ENTRY_LAUNCHES["vsnray_traverse_binned"]
    got = trav.cluster_traverse(rays, bvh.nodes, bvh.tris, bvh.num_clusters,
                                40, tile_lanes=tl, any_hit=any_hit)
    assert trav.ENTRY_LAUNCHES["vsnray_traverse_binned"] == entry + 1
    roots, splits = trav._default_tiles(rays.shape[0], tl, rays.device)
    ref = trav.traverse_plain(rays, bvh.nodes, bvh.tris, bvh.num_clusters,
                              40, tl, any_hit, roots, splits)
    _check(got, ref, rays, any_hit)


# row 1e: radix trees (children from the kids columns) and C == 1, from the
# root, on traverse_binned.cu's lane_walk: K in BINNED_K unrolled, any other
# multiple of 8 in the run-time-K form
RADIX_KS = (*trav.BINNED_K, 40, "c1")


@pytest.fixture(scope="module")
def radix_bvhs(scene):
    """The scene's mesh as one radix tree at each K of BINNED_KS."""
    s, _ = scene
    with torch.inference_mode():
        return {K: build_cluster_bvh(s.mesh, cluster_size=K)
                for K in BINNED_KS}


def _shadow_fan(bvh, cam_rays):
    """Shadow rays of one point light: from a point near the top of the
    scene box to where ``cam_rays`` (a pinhole fan) hit, max_t just short
    of the surface, lanes whose camera ray missed dead -- a warp is a fan
    from one point to 32 adjacent surface points."""
    n = cam_rays.shape[0]
    roots, splits = trav._default_tiles(n, n, cam_rays.device)
    t, p, _, _ = trav.traverse_plain(cam_rays, bvh.nodes, bvh.tris,
                                     bvh.num_clusters, bvh.cluster_size, n,
                                     False, roots, splits, heap=bvh.heap)
    hit = p >= 0
    target = cam_rays[:, 0:3] + t[:, None] * cam_rays[:, 3:6]
    lo, hi = bvh.nodes[0, 0:3], bvh.nodes[0, 3:6]
    light = lo + (hi - lo) * torch.tensor([0.45, 0.9, 0.55],
                                          device=lo.device)
    d = target - light
    dist = d.norm(dim=-1)
    mt = torch.where(hit, dist * (1 - 1e-4), -1.0)
    return trav._pack_rays(light.expand(n, 3), d / dist[:, None], mt, n, n,
                           pad_maxt=-1.0)


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("K", RADIX_KS)
def test_radix_walks_match_plain(scene, radix_bvhs, cuda, K, any_hit):
    """Radix trees against the plain version on _coherent_lanes' tiles
    (camera-like fan, dead lanes, one cluster, lanes apart, random rays)
    and a shadow fan from one point: coherent warps, warps whose lanes
    point apart, and fans from one point."""
    if K == "c1":
        with torch.inference_mode():
            bvh, ray = _c1_case(cuda)
        assert bvh.num_clusters == 1
    else:
        _, ray = scene
        bvh = radix_bvhs[K]
        assert not bvh.heap and bvh.depth > 0
    tl = trav.TILE_ROWS * 128
    lanes, _ = _coherent_lanes(bvh, ray)
    rays = torch.cat([lanes, _shadow_fan(bvh, lanes[:tl])])
    C, Kc = bvh.num_clusters, bvh.cluster_size
    entry, mode, _ = trav.launch_form(False, C, False, any_hit, 2, False, Kc)
    assert entry == "vsnray_traverse_binned"
    before = (trav.ENTRY_LAUNCHES[entry], trav.LAUNCHES[mode])
    got = trav.cluster_traverse(rays, bvh.nodes, bvh.tris, C, Kc,
                                tile_lanes=tl, any_hit=any_hit, heap=False,
                                depth=bvh.depth)
    assert (trav.ENTRY_LAUNCHES[entry], trav.LAUNCHES[mode]) == (
        before[0] + 1, before[1] + 1)
    roots, splits = trav._default_tiles(rays.shape[0], tl, rays.device)
    ref = trav.traverse_plain(rays, bvh.nodes, bvh.tris, C, Kc, tl, any_hit,
                              roots, splits, heap=False)
    _check(got, ref, rays, any_hit)
    tiles = COHERENT_TILES + 1
    packet = _packet_warps(rays).reshape(tiles, -1)
    assert bool(packet[0].all()) and bool(packet[-1].any())
    assert not bool(packet[3].any())
    live = (rays[:, 6] >= 0).reshape(tiles, tl)
    hit = (got[1] >= 0).reshape(tiles, tl)
    assert hit[0].any() and hit[2].all() and int(live[-1].sum()) > 100

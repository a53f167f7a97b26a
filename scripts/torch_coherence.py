"""Coherence of the traversal kernels' launches from the root, read from a
plain walk (no counter in any timed kernel).

    python3 scripts/torch_coherence.py [--warps N]    # on the GPU
    python3 scripts/torch_coherence.py --small        # on the CPU

Captures the launches from the root of chip_smoke.py's 1080p frame on the
heap tree -- mode 1 (bounce 0's camera rays) and mode 1d (bounce 0's NEE
shadow rays) -- the mode-1d launches of the same frame under
TraceConfig(shadow_binned=False) (bounce 0's shadows, then bounces 1-4's,
which are incoherent), the radix frame's launches (every bounce's
closest-hit and NEE shadow rays on the radix tree of the same scene,
build_cluster_bvh(treelet_size=0)) and the simple frame's one launch on
that tree (render with defaults only, chip_smoke.py phase 7c), on N
sampled warps of each launch (every warp that holds a live lane, evenly
spaced; default 512).  ``--small`` does the same on the CPU on
chip_smoke.py's small configuration (sponza_like 4000, K=8, T=16, and its
radix tree at K=8) at 64x64, on every warp.

``walk_plain`` walks each sampled lane through the tree as the one-lane
walk does (near child first by its own slab entry, popped nodes behind the
best hit skipped; children 2n+1 / 2n+2 on a heap, the kids columns on a
radix tree) and returns the clusters each lane visits.  Per launch
the script prints, over live lanes and warps of 32 consecutive lanes:
clusters visited per lane, distinct clusters per warp, and lanes per
distinct cluster (visits / distinct (warp, cluster) pairs: the lanes a
warp-wide leaf step would serve), beside the walk's disagreement with
``traverse_plain`` (closest-hit t, any-hit hit flag; must be 0).
"""

import argparse
import dataclasses
import json
import math
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
import visionaray_torch.ops.traverse as trav  # noqa: E402
from visionaray_torch.kernels.params import KernelParams  # noqa: E402
from visionaray_torch.ops.cluster_bvh import build_cluster_bvh  # noqa: E402
from visionaray_torch.ops.trace import TraceConfig  # noqa: E402
from visionaray_torch.sched.render import (  # noqa: E402
    _pixel_grid, render, render_pixels,
)
from visionaray_torch.scenes.sponza_like import sponza_like_scene  # noqa: E402

SLAB_PAD = 1e-6      # traverse_common.cuh kSlabPad


def _box_entry(box, o, inv, bt):
    """traverse_common.cuh box_entry of boxes (L, 8) [lo hi ...] for lanes
    o, inv (L, 3) with best t bt (L,): entry distance or +inf."""
    lo, hi = box[:, 0:3], box[:, 3:6]
    t1 = (lo - o) * inv
    t2 = (hi - o) * inv
    tn = torch.minimum(t1, t2).amax(-1)
    tf = torch.maximum(t1, t2).amin(-1)
    tn = tn - tn.abs() * SLAB_PAD
    tf = tf + tf.abs() * SLAB_PAD
    ok = (lo[:, 0] <= hi[:, 0]) & (tf >= tn) & (tf >= 0.0) & (tn < bt)
    return torch.where(ok, tn, math.inf)


def walk_plain(rays, nodes, tris, num_clusters, cluster_size, any_hit,
               heap=True, depth=None):
    """The one-lane walk of every lane from the root of a heap tree (or,
    with ``heap`` False, of a radix tree of ``depth`` levels), as plain
    PyTorch over all lanes at once.  Returns (t, prim, visits): (npad,)
    each, and visits (V, 2) int64 rows (lane, cluster) in the order the
    lanes' leaf steps happen."""
    npad = rays.shape[0]
    dev = rays.device
    C, K = num_clusters, cluster_size
    o, d, mt = rays[:, 0:3], rays[:, 3:6], rays[:, 6]
    inv = torch.clamp(1.0 / d, -trav._INV_CLAMP, trav._INV_CLAMP)
    recs = tris.reshape(C, K, 16)
    kids = nodes[:, 6:8].to(torch.int64)
    bt = mt.clone()
    bp = torch.full((npad,), -1.0, device=dev)
    leaf_base = C - 1
    if heap:
        depth = int(math.log2(C))
    node = torch.zeros(npad, dtype=torch.int64, device=dev)
    sp = torch.zeros(npad, dtype=torch.int64, device=dev)
    stack_n = torch.zeros((npad, depth + 1), dtype=torch.int64, device=dev)
    stack_t = torch.full((npad, depth + 1), math.inf, device=dev)
    active = mt >= 0.0
    visits = []
    while True:
        act = torch.nonzero(active).reshape(-1)
        if act.numel() == 0:
            break
        n = node[act]
        at_leaf = n >= leaf_base
        pending = []
        # inner lanes: both children, near first, the other pushed
        ii, ni = act[~at_leaf], n[~at_leaf]
        if ii.numel():
            if heap:
                left, right = 2 * ni + 1, 2 * ni + 2
            else:
                left, right = kids[ni, 0], kids[ni, 1]
            tl = _box_entry(nodes[left], o[ii], inv[ii], bt[ii])
            tr = _box_entry(nodes[right], o[ii], inv[ii], bt[ii])
            hl, hr = tl < math.inf, tr < math.inf
            left_first = hl & (tl <= tr)
            both = hl & hr
            lanes = ii[both]
            stack_n[lanes, sp[lanes]] = torch.where(left_first, right,
                                                    left)[both]
            stack_t[lanes, sp[lanes]] = torch.where(left_first, tr, tl)[both]
            sp[lanes] += 1
            node[ii] = torch.where(left_first, left,
                                   torch.where(hr, right, ni))
            pending.append(ii[~(hl | hr)])
        # leaf lanes: the cluster's K records in order
        li, c = act[at_leaf], n[at_leaf] - leaf_base
        if li.numel():
            visits.append(torch.stack([li, c], dim=1))
            t, _, _, ok = trav._mt(o[li], d[li], recs[c])
            valid = ok & (t >= 0.0) & (t < bt[li][:, None])
            if any_hit:
                first = torch.argmax(valid.to(torch.uint8), dim=1)
                found = valid.any(dim=1)
            else:
                tv = torch.where(valid, t, math.inf)
                first = torch.argmin(tv, dim=1)
                found = tv.gather(1, first[:, None])[:, 0] < math.inf
            hit_l = li[found]
            bt[hit_l] = t[found, first[found]]
            bp[hit_l] = recs[c[found], first[found], 9]
            if any_hit:
                active[hit_l] = False
                pending.append(li[~found])
            else:
                pending.append(li)
        # pop: the nearest stacked node in front of the best hit
        pend = torch.cat(pending)
        while pend.numel():
            empty = sp[pend] == 0
            active[pend[empty]] = False
            pend = pend[~empty]
            sp[pend] -= 1
            take = stack_t[pend, sp[pend]] < bt[pend]
            got = pend[take]
            node[got] = stack_n[got, sp[got]]
            pend = pend[~take]
    visits = torch.cat(visits) if visits else torch.zeros(
        (0, 2), dtype=torch.int64, device=dev)
    return bt, bp, visits


def coherence(rays, bvh, any_hit, warps):
    """Per-launch coherence figures on ``warps`` sampled warps (all when
    None) of one coherent launch."""
    dev = rays.device
    n_warps = rays.shape[0] // 32
    live_w = torch.nonzero((rays[:, 6] >= 0).reshape(n_warps, 32)
                           .any(1)).reshape(-1)
    if warps is not None and live_w.numel() > warps:
        live_w = live_w[torch.linspace(0, live_w.numel() - 1, warps,
                                       device=dev).long()]
    lanes = (live_w[:, None] * 32 + torch.arange(32, device=dev)).reshape(-1)
    sub = rays[lanes].contiguous()
    C, K = bvh.num_clusters, bvh.cluster_size
    t, p, visits = walk_plain(sub, bvh.nodes, bvh.tris, C, K, any_hit,
                              heap=bvh.heap, depth=bvh.depth)
    roots, splits = trav._default_tiles(sub.shape[0], sub.shape[0], dev)
    pt, pp, _, _ = trav.traverse_plain(sub, bvh.nodes, bvh.tris, C, K,
                                       sub.shape[0], any_hit, roots, splits,
                                       heap=bvh.heap)
    live = sub[:, 6] >= 0
    if any_hit:
        disagree = int((live & ((p >= 0) != (pp >= 0))).sum())
    else:
        disagree = int((live & (t != pt)).sum())
    per_lane = torch.bincount(visits[:, 0], minlength=sub.shape[0])[live]
    pairs = torch.unique((visits[:, 0] // 32) * C + visits[:, 1])
    per_warp = torch.bincount(pairs // C, minlength=live_w.numel())

    def q(x):
        x = x.double()
        return dict(mean=float(x.mean()), p50=float(x.quantile(0.5)),
                    p90=float(x.quantile(0.9)), max=float(x.max()))

    return dict(warps=int(live_w.numel()), live_lanes=int(live.sum()),
                clusters_per_lane=q(per_lane),
                distinct_clusters_per_warp=q(per_warp),
                lanes_per_distinct_cluster=visits.shape[0]
                / max(pairs.numel(), 1),
                walk_vs_plain_disagree=disagree)


def captured(frame, keys):
    """The launches of ``frame()`` of the modes ``keys``, in order."""
    rec = cs.LaunchRecorder(trav.cluster_traverse)
    with cs.recorded(rec):
        frame()
    return {k: rec.launches.get(k, []) for k in keys}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--small", action="store_true",
                    help="chip_smoke.py's small configuration on the CPU")
    ap.add_argument("--warps", type=int, default=512,
                    help="warps sampled per launch (GPU run)")
    args = ap.parse_args()
    if args.small:
        dev = torch.device("cpu")
        params, cam = cs.small_config(dev)
        W = H = 64
        x, y = _pixel_grid(W, H, dev)
        warps = None
    else:
        if not torch.cuda.is_available():
            print("torch_coherence: needs a CUDA GPU (or --small)",
                  file=sys.stderr)
            return 2
        dev = torch.device("cuda")
        scene, cam = sponza_like_scene(target_tris=cs.TARGET_TRIS,
                                       build_bvh=False, device=dev)
        scene.bvh = build_cluster_bvh(scene.mesh, cluster_size=cs.K,
                                      treelet_size=cs.T)
        params = KernelParams.create(
            scene, num_bounces=cs.BOUNCES, epsilon=1e-3,
            bg_color=(0.2, 0.3, 0.5, 1.0), ambient_color=(1.0, 1.0, 1.0, 1.0))
        W, H = cs.WIDTH, cs.HEIGHT
        x, y = cs.swizzled_pixels(dev)
        warps = args.warps
    scene = params.scene
    radix = dataclasses.replace(scene, bvh=build_cluster_bvh(
        scene.mesh, cluster_size=scene.bvh.cluster_size, treelet_size=0))

    def frame(cfg, s=scene):
        p = dataclasses.replace(params, scene=s, trace=cfg)
        return lambda: render_pixels(p, cam, x, y, W, H, "pathtracing", 1,
                                     "jittered_blend", 1, nee=True)

    out = {}
    with torch.no_grad():
        runs = [("default", frame(TraceConfig()), ("closest", "any"), scene),
                ("shadow_binned=False",
                 frame(TraceConfig(shadow_binned=False)), ("any",), scene),
                ("radix frame", frame(TraceConfig(), radix),
                 ("radix_closest", "radix_any"), radix),
                ("simple frame", lambda: render(radix, cam, W, H),
                 ("radix_closest",), radix)]
        for label, run, keys, s in runs:
            for key, launches in captured(run, keys).items():
                for idx, ln in enumerate(launches):
                    name = f"{label} {key} launch {idx}"
                    out[name] = coherence(ln["rays"], s.bvh, ln["any_hit"],
                                          warps)
                    print(f"{name}: {json.dumps(out[name])}", flush=True)
    if not args.small:
        print(f"card: {cs.nvidia_smi_line()}")
    return 0 if all(v["walk_vs_plain_disagree"] == 0
                    for v in out.values()) else 1


if __name__ == "__main__":
    sys.exit(main())

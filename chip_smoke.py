#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port (visionaray_torch) on one GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when it fails:

1. Device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions, and the nvcc build of ops/cuda/traverse_binned.cu and
   traverse_coherent.cu, one nvcc each, started together (seconds; ptxas'
   registers, shared memory, stack and spills of the main path's forms).
2. Kernel vs plain version, per traversal mode, on every launch captured
   from the real 1080p frame (sponza-class scene, 259,656 triangles, K=32,
   T=128): coherent closest-hit and any-hit (traverse_coherent.cu), binned
   two-pass closest-hit and any-hit (traverse_binned.cu).  The first, a
   middle and the last launch of each mode are compared on >= 8192 lanes
   each (binned modes: tiles that straddle two treelet segments, the tile
   where live lanes end, then tiles with live lanes); every launch is
   timed, and its counters size its bound; the per-frame sums are reported
   beside the first launch.
3. The slice: ClusterBVH built on the card, then the 1920x1080, 1 spp,
   5-bounce NEE frame in bench.py's 64-px block swizzle; one warm frame,
   then timed frames.  Launch counts (per mode, per kernel form and per C
   entry point) are reset just before the first timed frame and read just
   after it: modes 1 and 1d must have run traverse_coherent.cu.
4. Whole-path check: a small config (sponza_like 4000 triangles, K=8, T=16,
   64x64, 3 bounces, NEE) rendered through the kernel and through the
   plain version, both on the card, compared image to image.
5. The training step (sched/step.py, bench.py's value_and_grad over the
   vertices and the albedo) at full width: the 1080p frame of phase 3 in
   bench.py's one 2^21-lane tile.  One warm step, one step whose forward
   and backward launches are counted apart (the backward must launch no
   traversal) and whose peak memory is read, then timed steps.  The loss
   and both gradients must be finite and the gradients non-zero.
6. Gradient check: phase 4's configuration at 32x32, loss_and_grads
   through the kernel and through the plain version on the card, held to
   the CPU test's tolerance.
7. The radix-tree form (row 1e): build_cluster_bvh(treelet_size=0) of the
   260k scene on the card (auto K=32, C=8,115), tables equal to the CPU
   build; (a) the 1080p frame on it (every bounce from the root of the
   radix tree, on traverse_binned.cu), timed as phase 3, its launches
   per entry point printed; its two modes held against the plain version
   on captured launches as in phase 2.  (b) A mesh of 24 triangles
   (C == 1) rendered at 64x64, and its two modes held the same way.
   (c) The simple frame: render(scene on the radix tree, cam, 1920, 1080)
   with defaults only (the simple kernel, uniform sampler), timed as phase
   3 (simple_frame_s): exactly one radix_closest launch, its image finite
   and more than half of its pixels hit, the launch held against the plain
   version; then the same frame on the radix tree at K=40, whose launch
   runs the kernel's run-time-K form.
8. Row 1f on phase 3's scene and tree (K=32, so the kd build carries half
   boxes): the 1080p frame under TraceConfig(fanout=4), (fanout=8),
   (half_skip=True) and (fanout=4, half_skip=True), timed as phase 3, each
   frame's launches counted per kernel form, its image held to phase 3's
   with phase 4's image tolerance, and its modes 1, 1b, 1c and 1d held
   against the plain version on captured launches as in phase 2 (relaunched
   with the captured form; the coherent 1f forms run traverse_binned.cu).
   Then the full-width training step under (fanout=4, half_skip=True),
   checked and timed as phase 5.
9. The main path's other switches: the 1080p frame with shadow_binned=False
   (NEE shadows of bounces 1.. through coherent any-hit: incoherent lanes
   on traverse_coherent.cu) and with shadow_reversed=False, shadow_m=6,
   dir_bits=3; each finite, not constant, with every expected mode
   launched, and its coherent modes held against the plain version on
   captured launches as in phase 2.
10. The Whitted frame on phase 7a's radix tree: render(scene, cam, 1920,
    1080, algo="whitted") with defaults only (4 bounces, one point light),
    timed as phase 3 (whitted_frame_s): 5 radix_closest and 4 radix_any
    launches, the image finite and mostly hit, both modes held against the
    plain version on captured launches as in phase 2.
11. The AO frame, the same for algo="ao" (ao_frame_s), each frame blended
    into the last one's RenderTarget (the counted frame: frame_num=2): 1
    radix_closest and 8 radix_any launches.
12. The boundary step on the radix tree: build_edge_adjacency of the mesh
    (timed, once), then the vertex gradient of the mean RGB of
    render(..., algo="simple", boundary=adj), timed as phase 5
    (boundary_step_s) with its peak memory and increment, the edge and
    silhouette counts: 3 radix_closest launches (primary, f-, f+) held
    against the plain version; the gradient finite and unlike the step's
    with boundary=None; the boundary image exactly 0.  At 32x32 on phase
    6's configuration the gradient through the kernel is held to the plain
    version's with phase 6's limits.
13. The simple frame through a hit filter rejecting every prim whose id is
    0 mod 7 (filtered_frame_s; its launches are its re-traces, at most
    16), its launches against the plain version; on the primary rays no
    accepted prim is one the filter rejects, and where the unfiltered
    winner is accepted the prim is the same and t bit-equal.  Then
    multi_hit(primary rays, k=16) (multi_hit_s, 16 launches): t sorted
    along k, slot 0 the closest hit, every slot's hit and prim against the
    plain version on COMPARE_LANES lanes, the launches against the plain
    version.

Output: one line per check, then a JSON line with per-kernel numbers, the
card's name and power limit, and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

    python3 chip_smoke.py --profile [--profile-table=PATH]

adds a torch.profiler breakdown of one more frame, radix frame, training
step, Whitted frame, AO frame and boundary step: device time by kernel
group and the device idle share, and with PATH the full operator tables
(the step's in PATH.step).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

import visionaray_torch.ops.traverse as trav
from visionaray_torch.core.camera import Pinhole
from visionaray_torch.core.scene import Scene, TriangleMesh
from visionaray_torch.core.types import Ray
from visionaray_torch.diff.boundary import (
    boundary_image, build_edge_adjacency, silhouette_mask,
)
from visionaray_torch.kernels.params import KernelParams
from visionaray_torch.ops.cluster_bvh import build_cluster_bvh
from visionaray_torch.ops.trace import TraceConfig, closest_hit, multi_hit
from visionaray_torch.sched import step
from visionaray_torch.sched.render import _pixel_grid, render, render_pixels
from visionaray_torch.scenes.sponza_like import sponza_like_scene
from visionaray_torch.shading.lights import PointLights

WIDTH, HEIGHT, SPP, BOUNCES = 1920, 1080, 1, 5
TARGET_TRIS, K, T = 260_000, 32, 128
TIMED_FRAMES = 3
COMPARE_LANES = 8192
# kernel vs plain, per mode: lanes whose hit flag differs, plus closest-hit
# lanes whose prims differ at different t (a tie at equal t is allowed),
# may be at most this share of the compared live lanes; where both pick
# the same prim, t must agree to this relative error
MISMATCH_SHARE = 1e-4
T_RTOL = 1e-6
# whole-path check: the slice test's tolerance
IMG_MEAN_ABS, IMG_PIX_TOL, IMG_PIX_SHARE = 1e-4, 1e-3, 0.02
# gradient check: tests/test_torch_grad.py's tolerance
LOSS_RTOL, GRAD_REL_L2, GRAD_COS = 1e-5, 1e-3, 0.999
TIMED_STEPS = 3
# H100 SXM peaks (NVIDIA data sheet): memory rate and f32 non-tensor rate
PEAK_BYTES_S, PEAK_F32_S = 3.35e12, 67e12
FLOP_TRI, FLOP_BOX = 40, 20      # ops of one triangle / one box test
REPLACES = "visionaray_tpu/ops/pallas/traverse.py:557"
# the source of each C entry point of ops/traverse.py::launch_form
SOURCES = {"vsnray_traverse_binned":
               "visionaray_torch/ops/cuda/traverse_binned.cu",
           "vsnray_traverse_coherent":
               "visionaray_torch/ops/cuda/traverse_coherent.cu"}
COHERENT = ("closest", "any")   # the modes launched from the root
MODES = [  # (mode key, kernel name, table row) of the treelet frame
    ("closest", "traverse_closest", "1"),
    ("binned_closest", "traverse_binned_closest", "1b"),
    ("binned_any", "traverse_binned_any", "1c"),
    ("any", "traverse_any", "1d"),
]
RADIX_MODES = [("radix_closest", "traverse_radix_closest", "1e"),
               ("radix_any", "traverse_radix_any", "1e")]
C1_MODES = [("c1_closest", "traverse_c1_closest", "1e (C == 1)"),
            ("c1_any", "traverse_c1_any", "1e (C == 1)")]
# row 1f: the kernel's wide descent and half-cluster skip on the main path
OPTIONS_1F = {"fanout4": TraceConfig(fanout=4),
              "fanout8": TraceConfig(fanout=8),
              "half_skip": TraceConfig(half_skip=True),
              "fanout4_half_skip": TraceConfig(fanout=4, half_skip=True)}
STEP_1F = "fanout4_half_skip"
# phase 9: the shadow and sort-key switches, with the modes each launches
# (the coherent ones among them are held against the plain version)
SWITCHES = {
    "shadow_coherent": (TraceConfig(shadow_binned=False),
                        ("closest", "any", "binned_closest")),
    "shadow_from_surface_m6_dir_bits3": (
        TraceConfig(shadow_reversed=False, shadow_m=6, dir_bits=3),
        ("closest", "any", "binned_closest", "binned_any")),
}

# phases 10-11: the kernels' launches a frame, by mode
ALGO_LAUNCHES = {"whitted": {"radix_closest": 5, "radix_any": 4},
                 "ao": {"radix_closest": 1, "radix_any": 8}}
MULTI_HIT_K = 16


def reject_mod7(pid, t, u, v, hit):
    """Phase 13's hit filter: rejects every prim whose id is 0 mod 7."""
    return hit & (pid % 7 != 0)


def log(*a):
    print(*a, flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps):
    """Mean milliseconds of fn() over reps, after one warm call."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


class LaunchRecorder:
    """Stands in for traverse.cluster_traverse during the warm frame and
    keeps a copy of the inputs of every launch, by mode, in launch order."""

    def __init__(self, fn):
        self.fn = fn
        self.launches = {}

    @property
    def first(self):
        return {mode: lns[0] for mode, lns in self.launches.items()}

    def __call__(self, rays, nodes, tris, num_clusters, cluster_size,
                 tile_lanes, any_hit=False, tile_roots=None,
                 tile_splits=None, counters=None, heap=True, depth=None,
                 fanout=2, half_skip=False):
        mode = trav.launch_mode(heap, num_clusters, tile_roots is not None,
                                any_hit)
        self.launches.setdefault(mode, []).append(dict(
            rays=rays.clone(), tile_lanes=tile_lanes, any_hit=any_hit,
            roots=None if tile_roots is None else tile_roots.clone(),
            splits=None if tile_splits is None else tile_splits.clone(),
            fanout=fanout, half_skip=half_skip))
        return self.fn(rays, nodes, tris, num_clusters, cluster_size,
                       tile_lanes, any_hit, tile_roots, tile_splits,
                       counters, heap=heap, depth=depth, fanout=fanout,
                       half_skip=half_skip)


@contextlib.contextmanager
def recorded(rec):
    """cluster_traverse replaced by the LaunchRecorder ``rec``."""
    trav.cluster_traverse = rec
    try:
        yield rec
    finally:
        trav.cluster_traverse = rec.fn


def plain_on_card(rays, nodes, tris, num_clusters, cluster_size,
                  tile_lanes, any_hit=False, tile_roots=None,
                  tile_splits=None, counters=None, heap=True, depth=None,
                  fanout=2, half_skip=False):
    """cluster_traverse's contract through the plain version, on the card
    (the kernel form, ``fanout`` and ``half_skip``, does not change it)."""
    if tile_roots is None:
        tile_roots, tile_splits = trav._default_tiles(
            rays.shape[0], tile_lanes, rays.device)
    return trav.traverse_plain(rays, nodes, tris, num_clusters,
                               cluster_size, tile_lanes, any_hit,
                               tile_roots, tile_splits, heap=heap)


@contextlib.contextmanager
def plain_traversal():
    """Every traversal through the plain version while inside."""
    kernel_fn = trav.cluster_traverse
    trav.cluster_traverse = plain_on_card
    try:
        yield
    finally:
        trav.cluster_traverse = kernel_fn


def full_tiles(launch):
    rays = launch["rays"]
    tl = launch["tile_lanes"]
    if launch["roots"] is None:
        roots, splits = trav._default_tiles(rays.shape[0], tl, rays.device)
    else:
        roots, splits = launch["roots"], launch["splits"]
    return rays, roots, splits, tl


def compare_tiles(rays, roots, splits, tl):
    """Tile indices for the kernel-vs-plain comparison: straddling
    (two-pass) tiles, the tile where live lanes end and dead lanes begin,
    then tiles with live lanes from the middle of those on, at least
    COMPARE_LANES lanes in all."""
    n_tiles = rays.shape[0] // tl
    live = (rays[:, 6] >= 0).reshape(n_tiles, tl)
    picked = []
    straddle = torch.nonzero(splits < tl).reshape(-1).tolist()
    picked += straddle[:: max(1, len(straddle) // 4)][:4]
    mixed = torch.nonzero(live.any(1) & ~live.all(1)).reshape(-1).tolist()
    picked += mixed[-1:]
    live_tiles = torch.nonzero(live.any(1)).reshape(-1).tolist()
    half = len(live_tiles) // 2
    for t in live_tiles[half:] + live_tiles[:half] + list(range(n_tiles)):
        if len(set(picked)) * tl >= COMPARE_LANES:
            break
        picked.append(t)
    return sorted(set(picked)), len(straddle), len(mixed)


def sub_launch(rays, roots, splits, tl, tiles):
    idx = torch.tensor(tiles, device=rays.device)
    sub_rays = rays.reshape(-1, tl, 8)[idx].reshape(-1, 8).contiguous()
    return (sub_rays, roots[:, idx].contiguous(),
            splits[idx].contiguous())


def ptxas_report(log):
    """Per kernel form in nvcc's ptxas output: registers, shared memory,
    stack frame and spill bytes, keyed by a readable form name."""
    forms, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = form_name(m.group(1))
            forms[name] = dict(regs=0, smem=0, stack=0, spill=0)
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            forms[name].update(stack=int(m.group(1)),
                               spill=int(m.group(2)) + int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            forms[name]["regs"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            forms[name]["smem"] = int(sm.group(1)) if sm else 0
    return forms


def form_name(mangled):
    """``binned any=0 count=0 fanout=2 half=0 K=32 heap=1`` or ``coherent
    any=0 count=0 K=32`` from a kernel's mangled name (K=0: the run-time-K
    form; heap=0: a radix tree)."""
    m = re.search(r"binned_kernelILb(\d)ELb(\d)ELi(\d)ELb(\d)ELi(\d+)E"
                  r"Lb(\d)E", mangled)
    if m:
        return ("binned any={} count={} fanout={} half={} K={} heap={}"
                .format(*m.groups()))
    m = re.search(r"coherent_kernelILb(\d)ELb(\d)ELi(\d+)E", mangled)
    if m:
        return "coherent any={} count={} K={}".format(*m.groups())
    return mangled


def ptxas_lines(log, main_path=False):
    """One line per kernel form; ``main_path``: only the non-counting forms
    that the main path's frame and its 1f options (K=32, heap) and the
    radix frames (K=32, and K=40 in the run-time-K form) run."""
    out = []
    for name, f in ptxas_report(log).items():
        if main_path and ("count=1" in name or (
                "K=32" not in name and not name.endswith("K=0 heap=0"))):
            continue
        out.append(f"{name}: {f['regs']} registers, {f['smem']} B smem, "
                   f"{f['stack']} B stack, {f['spill']} B spills")
    return out


def check_mode(key, name, row, launches, bvh, count):
    """Kernel vs plain version on the captured launches of one mode,
    relaunched in the form (fanout, half_skip) they were captured with:
    the first, a middle and the last launch compared on a subset of tiles;
    every launch timed, its counters sizing its bound."""
    first = launches[0]
    any_hit = first["any_hit"]
    binned = first["roots"] is not None
    C, Kc = bvh.num_clusters, bvh.cluster_size
    fanout, half_skip = first["fanout"], first["half_skip"]

    entry = trav.launch_form(bvh.heap, C, binned, any_hit, fanout,
                             half_skip, Kc)[0]

    def kernel(r, ro, sp, tl, counters=None):
        return trav.cluster_traverse(
            r, bvh.nodes, bvh.tris, C, Kc, tile_lanes=tl, any_hit=any_hit,
            tile_roots=ro if binned else None,
            tile_splits=sp if binned else None, counters=counters,
            heap=bvh.heap, depth=bvh.depth, fanout=fanout,
            half_skip=half_skip)

    def plain(r, ro, sp, tl):
        return trav.traverse_plain(r, bvh.nodes, bvh.tris, C, Kc, tl,
                                   any_hit, ro, sp, heap=bvh.heap)

    # correctness on a subset of tiles of the first, a middle and the last
    # launch
    compared = sorted({0, len(launches) // 2, len(launches) - 1})
    hit_mm = prim_mm = n_live = n_lanes = n_straddle = n_mixed = 0
    max_rel = max_abs = 0.0
    for idx in compared:
        rays, roots, splits, tl = full_tiles(launches[idx])
        tiles, straddle, mixed = compare_tiles(rays, roots, splits, tl)
        sr, sro, ssp = sub_launch(rays, roots, splits, tl, tiles)
        kt, kp, ku, kv = kernel(sr, sro, ssp, tl)
        pt, pp, pu, pv = plain(sr, sro, ssp, tl)
        torch.cuda.synchronize()
        live = sr[:, 6] >= 0
        kh, ph = kp >= 0, pp >= 0
        hit_mm += int((live & (kh != ph)).sum())
        n_live += int(live.sum())
        n_lanes += sr.shape[0]
        n_straddle += straddle
        n_mixed += mixed
        if any_hit:
            max_abs = max(max_abs, float((kh != ph).float().max()))
        else:
            both = live & kh & ph
            same = both & (kp == pp)
            prim_mm += int((both & (kp != pp) & (kt != pt)).sum())
            dt = (kt - pt).abs()[same]
            rel = dt / pt.abs()[same].clamp_min(1e-30)
            uv = torch.maximum((ku - pu).abs(), (kv - pv).abs())[same]
            if dt.numel():
                max_abs = max(max_abs, float(dt.max()), float(uv.max()))
                max_rel = max(max_rel, float(rel.max()))
        if idx == 0:
            plain_ms = cuda_ms(lambda: plain(sr, sro, ssp, tl), 1)
            kernel_cmp_ms = cuda_ms(lambda: kernel(sr, sro, ssp, tl), 5)

    # every launch: time, counters, bound
    launch_ms, bounds, live_lanes, tests = [], [], [], [0, 0]
    for idx, ln in enumerate(launches):
        rays, roots, splits, tl = full_tiles(ln)
        npad = rays.shape[0]
        launch_ms.append(cuda_ms(lambda: kernel(rays, roots, splits, tl), 5))
        counters = torch.zeros((npad, 2), dtype=torch.int32,
                               device=rays.device)
        kernel(rays, roots, splits, tl, counters)
        tot = counters.sum(0, dtype=torch.int64).tolist()
        tests[0] += tot[0]
        tests[1] += tot[1]
        bytes_moved = (npad * 8 * 4 + bvh.nodes.numel() * 4
                       + bvh.tris.numel() * 4 + roots.numel() * 4
                       + splits.numel() * 4 + 4 * npad * 4)
        ops = FLOP_TRI * tot[1] + FLOP_BOX * tot[0]
        bounds.append((bytes_moved / PEAK_BYTES_S * 1e3,
                       ops / PEAK_F32_S * 1e3))
        live_lanes.append(int((rays[:, 6] >= 0).sum()))
    t_bytes, t_ops = bounds[0]
    bound_frame = sum(max(b) for b in bounds)
    ms_frame = sum(launch_ms)
    ok = (hit_mm + prim_mm <= MISMATCH_SHARE * max(n_live, 1)
          and max_rel <= T_RTOL)
    src = SOURCES[entry]
    log(f"kernel {row} {name} (fanout={fanout} half_skip={half_skip}) "
        f"[{src.rsplit('/', 1)[1]}]: compared launches {compared} "
        f"lanes={n_lanes} live={n_live} straddling_tiles_in_launches="
        f"{n_straddle} live_dead_tiles_in_launches={n_mixed} "
        f"hit_mismatch={hit_mm} prim_mismatch_unique={prim_mm} "
        f"max_rel_t={max_rel:.3e} kernel_ms_compare={kernel_cmp_ms:.4f} "
        f"plain_ms={plain_ms:.3f} | first launch lanes="
        f"{first['rays'].shape[0]} live={live_lanes[0]} ms={launch_ms[0]:.4f}"
        f" bound_ms={max(t_bytes, t_ops):.4f} "
        f"({'bytes' if t_bytes >= t_ops else 'operations'}) | "
        f"{len(launches)} launches: ms_sum={ms_frame:.4f} "
        f"bound_ms_sum={bound_frame:.4f} box_tests={tests[0]} "
        f"tri_tests={tests[1]} {'OK' if ok else 'FAIL'}")
    if len(launches) > 1:
        log(f"  launch ms {[round(t, 4) for t in launch_ms]} live lanes "
            f"{live_lanes}")
    return ok, {
        "name": name, "route": "cuda", "source": src, "entry": entry,
        "replaces": REPLACES, "mode": row, "mode_key": key,
        "launches": count.get(key, 0),
        "max_abs_err": max_abs, "ms": launch_ms[0], "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None, "lanes": first["rays"].shape[0],
        "ms_frame": ms_frame, "bound_ms_frame": bound_frame,
        "launch_ms": launch_ms, "launch_live_lanes": live_lanes,
        "compared_launches": compared, "compare_lanes": n_lanes,
        "kernel_ms_compare": kernel_cmp_ms, "hit_mismatch": hit_mm,
        "prim_mismatch_unique": prim_mm, "max_rel_t": max_rel,
        "box_tests": tests[0], "tri_tests": tests[1],
        "variant": trav.variant_key(key, fanout, half_skip),
    }


def swizzled_pixels(device):
    """bench.py's 64x64 pixel-block order."""
    B = 64
    Wp, Hp = -(-WIDTH // B) * B, -(-HEIGHT // B) * B
    yy, xx = np.meshgrid(np.arange(Hp), np.arange(Wp), indexing="ij")
    inb = (xx < WIDTH) & (yy < HEIGHT)
    order = (yy // B) * (Wp // B) + (xx // B)
    flat = np.argsort(np.where(inb, order, 1 << 30).reshape(-1),
                      kind="stable")[: WIDTH * HEIGHT]
    x = torch.as_tensor(xx.reshape(-1)[flat], dtype=torch.int32,
                        device=device)
    y = torch.as_tensor(yy.reshape(-1)[flat], dtype=torch.int32,
                        device=device)
    return x, y


def small_config(device):
    """sponza_like 4000 (4,804 triangles), K=8, T=16, 3 bounces."""
    scene, cam = sponza_like_scene(target_tris=4000, device=device)
    scene.bvh = build_cluster_bvh(scene.mesh, cluster_size=8,
                                  treelet_size=16)
    params = KernelParams.create(scene, num_bounces=3, epsilon=1e-3,
                                 bg_color=(0.2, 0.3, 0.5, 1.0),
                                 ambient_color=(1.0, 1.0, 1.0, 1.0))
    return params, cam


def whole_path_check(device):
    """Small config through the kernel and through the plain version."""
    params, cam = small_config(device)
    x, y = _pixel_grid(64, 64, device)

    def frame():
        return render_pixels(params, cam, x, y, 64, 64, "pathtracing", 1,
                             "jittered_blend", 1, nee=True)[0]

    img_k = frame()
    with plain_traversal():
        img_p = frame()
    diff = (img_k - img_p).abs()
    mean_abs = float(diff.mean())
    share = float((diff.amax(-1) > IMG_PIX_TOL).float().mean())
    ok = bool(torch.isfinite(img_k).all()) and mean_abs <= IMG_MEAN_ABS \
        and share <= IMG_PIX_SHARE
    log(f"whole path 64x64 kernel vs plain: mean_abs={mean_abs:.3e} "
        f"pixels_over_{IMG_PIX_TOL:g}={share:.4f} "
        f"image_mean={float(img_k.mean()):.6f} {'OK' if ok else 'FAIL'}")
    return ok


def grad_stats(got, ref):
    """(relative L2 error, cosine) of two gradients."""
    got, ref = got.double(), ref.double()
    rel = float((got - ref).norm() / ref.norm())
    cos = float((got * ref).sum() / (got.norm() * ref.norm()))
    return rel, cos


def training_step_phase(params, cam, x, y, label="training step"):
    """Phase 5 (and phase 8's step): bench.py's training step at full
    width under ``params``."""
    verts = params.scene.mesh.vertices
    cd = params.scene.materials.cd
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step.loss_and_grads(verts, cd, 1, params, cam, x, y, nee=True)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0

    # the counted step: forward and backward apart, peak memory (also as
    # the increment over what earlier phases left allocated)
    base_mem = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with torch.enable_grad():
        v = verts.detach().requires_grad_()
        c = cd.detach().requires_grad_()
        trav.reset_launch_counts()
        t0 = time.perf_counter()
        loss = step.frame_loss(v, c, 2, params, cam, x, y, nee=True)
        torch.cuda.synchronize()
        fwd_s = time.perf_counter() - t0
        fwd = dict(trav.LAUNCHES)
        fwd_variants = dict(trav.VARIANT_LAUNCHES)
        fwd_entries = dict(trav.ENTRY_LAUNCHES)
        trav.reset_launch_counts()
        t0 = time.perf_counter()
        g_v, g_c = torch.autograd.grad(loss, (v, c))
        torch.cuda.synchronize()
        bwd_s = time.perf_counter() - t0
        bwd = dict(trav.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()

    times = []
    for i in range(TIMED_STEPS):
        t0 = time.perf_counter()
        loss_t, (gv_t, gc_t) = step.loss_and_grads(verts, cd, 3 + i, params,
                                                   cam, x, y, nee=True)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    step_s = sum(times) / len(times)
    rays = WIDTH * HEIGHT * SPP * BOUNCES * 2
    finite = all(bool(torch.isfinite(t).all())
                 for t in (loss, g_v, g_c, loss_t, gv_t, gc_t))
    nonzero = float(g_v.abs().sum()) > 0 and float(g_c.abs().sum()) > 0
    bwd_launches = sum(bwd.values())
    ok = (finite and nonzero and bwd_launches == 0
          and all(fwd[k] > 0 for k, _, _ in MODES))
    lanes = -(-x.shape[0] // step.TILE) * step.TILE
    log(f"{label} 1920x1080 spp=1 bounces=5 nee ({lanes} lanes, "
        f"{lanes - x.shape[0]} padding): step_s={step_s:.4f} (steps "
        f"{', '.join(f'{t:.4f}' for t in times)}) "
        f"mrays_per_s={rays / step_s / 1e6:.3f} warm_s={warm_s:.3f} "
        f"counted step forward_s={fwd_s:.4f} backward_s={bwd_s:.4f} "
        f"peak_mem_bytes={peak} step_mem_bytes={peak - base_mem} "
        f"loss={float(loss.detach()):.7f} "
        f"|g_verts|={float(g_v.norm()):.6e} |g_cd|={float(g_c.norm()):.6e} "
        f"finite={finite} nonzero={nonzero}")
    log(f"  forward launches={fwd} by kernel form={fwd_variants} by entry "
        f"point={fwd_entries} backward launches={bwd} "
        f"{'OK' if ok else 'FAIL'}")
    return ok, dict(step_s=step_s, mrays_per_s=rays / step_s / 1e6,
                    step_times=times, forward_s=fwd_s, backward_s=bwd_s,
                    peak_mem_bytes=peak, step_mem_bytes=peak - base_mem,
                    loss=float(loss.detach()),
                    forward_launches=fwd, forward_variants=fwd_variants,
                    forward_entries=fwd_entries,
                    backward_launches=bwd_launches)


def grad_check(device):
    """Phase 6: loss_and_grads through the kernel and through the plain
    version at 32x32 on phase 4's configuration."""
    params, cam = small_config(device)
    x, y = _pixel_grid(32, 32, device)
    verts = params.scene.mesh.vertices
    cd = params.scene.materials.cd

    def run():
        return step.loss_and_grads(verts, cd, 1, params, cam, x, y, nee=True,
                                   width=32, height=32, tile=32 * 32)

    loss_k, grads_k = run()
    with plain_traversal():
        loss_p, grads_p = run()
    loss_rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    stats = [grad_stats(a, b) for a, b in zip(grads_k, grads_p)]
    ok = (loss_rel <= LOSS_RTOL and all(
        rel <= GRAD_REL_L2 and cos >= GRAD_COS for rel, cos in stats)
        and all(bool(torch.isfinite(g).all()) for g in grads_k))
    log(f"gradient check 32x32 kernel vs plain: loss_rel={loss_rel:.3e} "
        f"g_verts rel_l2={stats[0][0]:.3e} cos={stats[0][1]:.9f} "
        f"g_cd rel_l2={stats[1][0]:.3e} cos={stats[1][1]:.9f} "
        f"{'OK' if ok else 'FAIL'}")
    return ok


def timed_frames(frame):
    """Warm frame with the first launch of each mode recorded, a counted
    frame (counts reset just before), then more timed frames."""
    rec = LaunchRecorder(trav.cluster_traverse)
    with recorded(rec):
        t0 = time.perf_counter()
        frame(1)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
    trav.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    color, depth = frame(2)
    torch.cuda.synchronize()
    times = [time.perf_counter() - t0]
    launches = dict(trav.LAUNCHES)
    rec.variants = dict(trav.VARIANT_LAUNCHES)
    rec.entries = dict(trav.ENTRY_LAUNCHES)
    for i in range(TIMED_FRAMES - 1):
        t0 = time.perf_counter()
        frame(3 + i)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return rec, launches, warm_s, times, color, depth


def radix_phase(scene, cam, cpu_mesh, dev):
    """Phase 7a set-up: the radix tree of the 260k scene, checked against
    the CPU build, and its 1080p frame."""
    t0 = time.perf_counter()
    rbvh = build_cluster_bvh(scene.mesh, treelet_size=0)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    cpu_bvh = build_cluster_bvh(cpu_mesh, treelet_size=0)
    same = (all(torch.equal(getattr(rbvh, k).cpu(), getattr(cpu_bvh, k))
                for k in ("nodes", "tris"))
            and rbvh.depth == cpu_bvh.depth)
    shape_ok = (rbvh.cluster_size, rbvh.num_clusters,
                rbvh.nodes.shape[0], rbvh.heap) == (32, 8115, 16229, False)
    log(f"radix tree: bvh_build_s={build_s:.3f} C={rbvh.num_clusters} "
        f"K={rbvh.cluster_size} nodes={rbvh.nodes.shape[0]} "
        f"depth={rbvh.depth} tables_equal_to_cpu_build={same}")
    params = KernelParams.create(
        dataclasses.replace(scene, bvh=rbvh), num_bounces=BOUNCES,
        epsilon=1e-3, bg_color=(0.2, 0.3, 0.5, 1.0),
        ambient_color=(1.0, 1.0, 1.0, 1.0))
    x, y = swizzled_pixels(dev)

    def frame(num):
        return render_pixels(params, cam, x, y, WIDTH, HEIGHT,
                             "pathtracing", SPP, "jittered_blend", num,
                             nee=True)

    return rbvh, frame, same and shape_ok, build_s


def simple_phase(scene, cam, label, check_modes):
    """Phase 7c: render(scene, cam, 1920, 1080) with defaults only (the
    simple kernel) on a radix tree, timed as phase 3: exactly one
    radix_closest launch, its image finite and mostly hit, the launch held
    against the plain version."""
    def frame(num):
        rt = render(scene, cam, WIDTH, HEIGHT)
        return rt.color.reshape(-1, 4), rt.depth.reshape(-1)

    rec, launches, warm_s, times, color, depth = timed_frames(frame)
    frame_s = sum(times) / len(times)
    finite = bool(torch.isfinite(color).all())
    hit = float((depth > 0).float().mean())
    K = scene.bvh.cluster_size
    ok = (finite and hit > 0.5 and launches["radix_closest"] == 1
          and sum(launches.values()) == 1
          and rec.entries["vsnray_traverse_binned"] == 1)
    log(f"simple frame{label} 1920x1080 render() defaults on the radix tree "
        f"(K={K} C={scene.bvh.num_clusters}): simple_frame_s={frame_s:.4f} "
        f"(frames {', '.join(f'{t:.4f}' for t in times)}) "
        f"warm_s={warm_s:.3f} launches={launches} entry_launches="
        f"{rec.entries} hit_fraction={hit:.4f} image_mean="
        f"{float(color[:, :3].mean()):.6f} finite={finite} "
        f"{'OK' if ok else 'FAIL'}")
    ok &= check_modes([("radix_closest", f"traverse_radix_closest_simple"
                        f"{label}", "1e")], rec, scene.bvh, launches)
    return ok, frame_s


def c1_scene(device):
    """24 triangles in one cluster (K=32 gives C == 1), lit by a point
    light, seen by a camera in front: phase 7b."""
    rng = np.random.default_rng(3)
    verts = rng.uniform(-1, 1, (72, 3)).astype(np.float32)
    faces = np.arange(72, dtype=np.int32).reshape(24, 3)
    mesh = TriangleMesh.create(verts, faces, device=device)
    scene = Scene.create(
        mesh=mesh, lights=PointLights.create((2.0, 3.0, 4.0),
                                             device=device),
        bvh=build_cluster_bvh(mesh, cluster_size=32), device=device)
    cam = Pinhole.create((0.0, 0.5, 4.0), (0.0, 0.0, 0.0), device=device)
    return scene, cam


def image_diff(img, ref):
    """(mean abs difference, share of pixels off by more than IMG_PIX_TOL)
    of two (N, 4) images."""
    diff = (img - ref).abs()
    return (float(diff.mean()),
            float((diff.amax(-1) > IMG_PIX_TOL).float().mean()))


def option_phase(option, cfg, params, cam, x, y, ref_color, check_modes):
    """Phase 8, one 1f option: the 1080p frame under ``cfg``, timed as
    phase 3, its launches by kernel form, its image against the default
    frame's, and its modes against the plain version."""
    p1 = dataclasses.replace(params, trace=cfg)

    def frame(num):
        return render_pixels(p1, cam, x, y, WIDTH, HEIGHT, "pathtracing",
                             SPP, "jittered_blend", num, nee=True)

    rec, launches, warm_s, times, color, depth = timed_frames(frame)
    frame_s = sum(times) / len(times)
    forms = {trav.variant_key(k, cfg.fanout, cfg.half_skip)
             for k, _, _ in MODES}
    mean_abs, share = image_diff(color, ref_color)
    finite = bool(torch.isfinite(color).all())
    std = float(color[:, :3].std())
    hit = float((depth > 0).float().mean())
    ok = (finite and std > 0 and hit > 0.5 and set(rec.variants) == forms
          and mean_abs <= IMG_MEAN_ABS and share <= IMG_PIX_SHARE)
    log(f"1f {option} frame 1920x1080 spp=1 bounces=5 nee: "
        f"frame_s={frame_s:.4f} (frames "
        f"{', '.join(f'{t:.4f}' for t in times)}) warm_s={warm_s:.3f} "
        f"launches={rec.variants} hit_fraction={hit:.4f} "
        f"image_std={std:.6f} vs default frame: mean_abs={mean_abs:.3e} "
        f"pixels_over_{IMG_PIX_TOL:g}={share:.4f} finite={finite} "
        f"{'OK' if ok else 'FAIL'}")
    per_mode = {k: rec.variants.get(
        trav.variant_key(k, cfg.fanout, cfg.half_skip), 0)
        for k, _, _ in MODES}
    modes = [(k, f"{name}_{option}", "1f") for k, name, _ in MODES]
    ok &= check_modes(modes, rec, params.scene.bvh, per_mode)
    return ok, dict(frame_s=frame_s, frame_times=times, warm_s=warm_s,
                    launches=rec.variants, image_mean_abs_vs_default=mean_abs,
                    image_share_over_tol_vs_default=share)


def switch_phase(name, cfg, expect, params, cam, x, y, ref_color,
                 check_modes):
    """Phase 9, one switch setting: a counted 1080p frame, its coherent
    modes against the plain version on its captured launches."""
    p1 = dataclasses.replace(params, trace=cfg)
    rec = LaunchRecorder(trav.cluster_traverse)
    trav.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with recorded(rec):
        color, depth = render_pixels(p1, cam, x, y, WIDTH, HEIGHT,
                                     "pathtracing", SPP, "jittered_blend", 2,
                                     nee=True)
    torch.cuda.synchronize()
    frame_s = time.perf_counter() - t0
    launches = dict(trav.LAUNCHES)
    entries = dict(trav.ENTRY_LAUNCHES)
    mean_abs, share = image_diff(color, ref_color)
    finite = bool(torch.isfinite(color).all())
    std = float(color[:, :3].std())
    ok = (finite and std > 0 and all(launches[k] > 0 for k in expect)
          and sum(launches.values()) == sum(launches[k] for k in expect))
    log(f"switches {name} ({cfg}): frame 1920x1080 frame_s={frame_s:.4f} "
        f"(one frame, kernel warm) launches={launches} "
        f"entry_launches={entries} "
        f"image_std={std:.6f} vs default frame: mean_abs={mean_abs:.3e} "
        f"pixels_over_{IMG_PIX_TOL:g}={share:.4f} finite={finite} "
        f"{'OK' if ok else 'FAIL'}")
    modes = [(k, f"{n}_{name}", row) for k, n, row in MODES
             if k in COHERENT and k in expect]
    ok &= check_modes(modes, rec, params.scene.bvh, launches)
    return ok, dict(frame_s=frame_s, launches=launches,
                    entry_launches=entries,
                    image_mean_abs_vs_default=mean_abs,
                    image_share_over_tol_vs_default=share)


def algo_phase(rscene, cam, algo, check_modes):
    """Phases 10-11: render(scene on the radix tree, cam, 1920, 1080,
    algo=algo) with defaults only, timed as phase 3; AO frames blend into
    the previous frame's RenderTarget."""
    state = {}

    def frame(num):
        rt = render(rscene, cam, WIDTH, HEIGHT, algo=algo, frame_num=num,
                    rt=state.get("rt") if algo == "ao" else None)
        state["rt"] = rt
        return rt.color.reshape(-1, 4), rt.depth.reshape(-1)

    rec, launches, warm_s, times, color, depth = timed_frames(frame)
    frame_s = sum(times) / len(times)
    expect = ALGO_LAUNCHES[algo]
    finite = bool(torch.isfinite(color).all())
    std = float(color[:, :3].std())
    hit = float((depth > 0).float().mean())
    ok = (finite and std > 0 and hit > 0.5
          and all(launches[k] == n for k, n in expect.items())
          and sum(launches.values()) == sum(expect.values()))
    log(f"{algo} frame 1920x1080 render() defaults on the radix tree: "
        f"{algo}_frame_s={frame_s:.4f} (frames "
        f"{', '.join(f'{t:.4f}' for t in times)}) warm_s={warm_s:.3f} "
        f"launches={launches} (expected {expect}) entry_launches="
        f"{rec.entries} hit_fraction={hit:.4f} image_mean="
        f"{float(color[:, :3].mean()):.6f} image_std={std:.6f} "
        f"finite={finite} {'OK' if ok else 'FAIL'}")
    ok &= check_modes([(k, f"traverse_{k}_{algo}", "1e") for k in expect],
                      rec, rscene.bvh, launches)
    return ok, dict(frame_s=frame_s, frame_times=times, warm_s=warm_s,
                    launches=launches)


def _boundary_grad(scene, cam, width, height, adj):
    """(loss, vertex gradient) of the mean RGB of render(..., "simple",
    boundary=adj); ``adj=None``: no boundary term."""
    v = scene.mesh.vertices.detach().requires_grad_()
    s2 = dataclasses.replace(
        scene, mesh=dataclasses.replace(scene.mesh, vertices=v))
    with torch.enable_grad():
        rt = render(s2, cam, width, height, algo="simple", boundary=adj)
        loss = rt.color[..., :3].mean()
        (g,) = torch.autograd.grad(loss, v)
    return loss.detach(), g


def boundary_phase(rscene, cam, check_modes, dev):
    """Phase 12: the boundary step at full width on the radix tree, and
    its gradient check at 32x32 on phase 6's configuration."""
    mesh = rscene.mesh
    t0 = time.perf_counter()
    adj = build_edge_adjacency(mesh.faces.cpu().numpy(),
                               mesh.vertices.cpu().numpy(), device=dev)
    torch.cuda.synchronize()
    adj_s = time.perf_counter() - t0
    E = adj.edges.shape[0]
    with torch.no_grad():
        n_sil = int(silhouette_mask(mesh.vertices, mesh.faces, adj, cam.eye,
                                    geom_ids=mesh.geom_ids).sum())

    rec = LaunchRecorder(trav.cluster_traverse)
    with recorded(rec):
        t0 = time.perf_counter()
        _boundary_grad(rscene, cam, WIDTH, HEIGHT, adj)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
    base_mem = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    trav.reset_launch_counts()
    t0 = time.perf_counter()
    loss, g = _boundary_grad(rscene, cam, WIDTH, HEIGHT, adj)
    torch.cuda.synchronize()
    counted_s = time.perf_counter() - t0
    launches = dict(trav.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    times = []
    for _ in range(TIMED_STEPS):
        t0 = time.perf_counter()
        _boundary_grad(rscene, cam, WIDTH, HEIGHT, adj)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    step_s = sum(times) / len(times)

    loss_nb, g_nb = _boundary_grad(rscene, cam, WIDTH, HEIGHT, None)
    v = mesh.vertices.detach().requires_grad_()
    with torch.enable_grad():
        bimg = boundary_image(
            KernelParams.create(dataclasses.replace(
                rscene, mesh=dataclasses.replace(mesh, vertices=v))),
            cam, WIDTH, HEIGHT, adj)
    zero = float(bimg.detach().abs().max()) == 0.0
    finite = bool(torch.isfinite(g).all())
    differs = not torch.equal(g, g_nb)
    ok = (finite and differs and zero and float(loss) == float(loss_nb)
          and launches.get("radix_closest", 0) == 3
          and sum(launches.values()) == 3)
    log(f"boundary step 1920x1080 render(simple, boundary=adj) on the radix "
        f"tree: boundary_step_s={step_s:.4f} (steps "
        f"{', '.join(f'{t:.4f}' for t in times)}) counted_s={counted_s:.4f} "
        f"warm_s={warm_s:.3f} adjacency_s={adj_s:.3f} edges={E} "
        f"silhouette_edges={n_sil} peak_mem_bytes={peak} "
        f"step_mem_bytes={peak - base_mem} launches={launches} "
        f"loss={float(loss):.7f} |g|={float(g.norm()):.6e} "
        f"|g without boundary|={float(g_nb.norm()):.6e} "
        f"|g - g without|={float((g - g_nb).norm()):.6e} finite={finite} "
        f"differs={differs} boundary_image_zero={zero} "
        f"{'OK' if ok else 'FAIL'}")
    ok &= check_modes([("radix_closest", "traverse_radix_closest_boundary",
                        "1e")], rec, rscene.bvh, launches)

    # kernel vs plain gradients at 32x32, phase 6's configuration
    params, scam = small_config(dev)
    sadj = build_edge_adjacency(params.scene.mesh.faces.cpu().numpy(),
                                params.scene.mesh.vertices.cpu().numpy(),
                                device=dev)
    _, gk = _boundary_grad(params.scene, scam, 32, 32, sadj)
    with plain_traversal():
        _, gp = _boundary_grad(params.scene, scam, 32, 32, sadj)
    rel, cos = grad_stats(gk, gp)
    good = (rel <= GRAD_REL_L2 and cos >= GRAD_COS
            and bool(torch.isfinite(gk).all()) and float(gp.norm()) > 0)
    log(f"boundary gradient check 32x32 kernel vs plain: g_verts "
        f"rel_l2={rel:.3e} cos={cos:.9f} |g|={float(gp.norm()):.6e} "
        f"{'OK' if good else 'FAIL'}")
    return ok and good, dict(
        boundary_step_s=step_s, step_times=times, counted_s=counted_s,
        adjacency_s=adj_s, edges=E, silhouette_edges=n_sil,
        peak_mem_bytes=peak, step_mem_bytes=peak - base_mem,
        launches=launches, grad_check_rel_l2=rel, grad_check_cos=cos)


def filter_phase(rscene, cam, check_modes, dev):
    """Phase 13: the filtered simple frame and multi_hit on the primary
    rays of the radix tree."""
    def frame(num):
        rt = render(rscene, cam, WIDTH, HEIGHT, hit_filter=reject_mod7)
        return rt.color.reshape(-1, 4), rt.depth.reshape(-1)

    rec, launches, warm_s, times, color, depth = timed_frames(frame)
    filtered_s = sum(times) / len(times)
    n = launches.get("radix_closest", 0)
    finite = bool(torch.isfinite(color).all())
    hit_frac = float((depth > 0).float().mean())
    ok = (finite and hit_frac > 0.5 and 1 <= n <= 16
          and sum(launches.values()) == n)

    x, y = _pixel_grid(WIDTH, HEIGHT, dev)
    ray = cam.primary_rays(x, y, WIDTH, HEIGHT)
    ref = closest_hit(ray, rscene)
    got = closest_hit(ray, rscene, hit_filter=reject_mod7)
    kept_rejected = int((got.hit & (got.prim_id % 7 == 0)).sum())
    acc = ref.hit & (ref.prim_id % 7 != 0)
    fell = ref.hit & ~acc
    same = (bool(got.hit[acc].all())
            and torch.equal(got.prim_id[acc], ref.prim_id[acc])
            and torch.equal(got.t[acc], ref.t[acc]))
    behind = bool((got.t[fell] > ref.t[fell]).all())
    ok &= kept_rejected == 0 and same and behind
    log(f"filtered frame 1920x1080 render(hit_filter=prim % 7 != 0) on the "
        f"radix tree: filtered_frame_s={filtered_s:.4f} (frames "
        f"{', '.join(f'{t:.4f}' for t in times)}) warm_s={warm_s:.3f} "
        f"launches (1 + re-traces)={launches} hit_fraction={hit_frac:.4f} "
        f"| primary rays: unfiltered winners rejected={int(fell.sum())} "
        f"accepted={int(acc.sum())} accepted prims the filter rejects="
        f"{kept_rejected} accepted winners same prim and t bit-equal={same} "
        f"fell-through hits behind the rejected={behind} "
        f"{'OK' if ok else 'FAIL'}")
    ok &= check_modes([("radix_closest", "traverse_radix_closest_filtered",
                        "1e")], rec, rscene.bvh, launches)

    # multi_hit on the primary rays
    mrec = LaunchRecorder(trav.cluster_traverse)
    with recorded(mrec):
        multi_hit(ray, rscene, k=MULTI_HIT_K)
        torch.cuda.synchronize()
    trav.reset_launch_counts()
    mtimes = []
    for i in range(TIMED_FRAMES):
        t0 = time.perf_counter()
        mh = multi_hit(ray, rscene, k=MULTI_HIT_K)
        torch.cuda.synchronize()
        mtimes.append(time.perf_counter() - t0)
        if i == 0:
            mlaunches = dict(trav.LAUNCHES)
    mh_s = sum(mtimes) / len(mtimes)
    sorted_k = bool((mh.t[:, 1:] >= mh.t[:, :-1]).all())
    h0 = mh.hit[:, 0]
    slot0 = (torch.equal(h0, ref.hit)
             and torch.equal(mh.prim_id[h0, 0], ref.prim_id[h0]))
    rel0 = float(((mh.t[h0, 0] - ref.t[h0]).abs()
                  / ref.t[h0].abs().clamp_min(1e-30)).max())
    depth_hist = torch.bincount(mh.hit.sum(1), minlength=MULTI_HIT_K + 1)
    # every slot against the plain version on a subset of lanes
    mid = x.shape[0] // 2
    sub = Ray(ori=ray.ori[mid:mid + COMPARE_LANES],
              dir=ray.dir[mid:mid + COMPARE_LANES])
    km = multi_hit(sub, rscene, k=MULTI_HIT_K)
    with plain_traversal():
        pm = multi_hit(sub, rscene, k=MULTI_HIT_K)
    torch.cuda.synchronize()
    hit_mm = int((km.hit != pm.hit).sum())
    both = km.hit & pm.hit
    prim_mm = int((both & (km.prim_id != pm.prim_id) & (km.t != pm.t)).sum())
    live = int(pm.hit.sum())
    good = (sorted_k and slot0 and rel0 <= T_RTOL
            and mlaunches.get("radix_closest", 0) == MULTI_HIT_K
            and sum(mlaunches.values()) == MULTI_HIT_K
            and hit_mm + prim_mm <= MISMATCH_SHARE * max(live, 1) + 1
            and live > COMPARE_LANES)
    log(f"multi_hit 1920x1080 primary rays k={MULTI_HIT_K} on the radix "
        f"tree: multi_hit_s={mh_s:.4f} (calls "
        f"{', '.join(f'{t:.4f}' for t in mtimes)}) launches={mlaunches} "
        f"t sorted along k={sorted_k} slot 0 = closest hit={slot0} "
        f"max_rel_t_slot0={rel0:.3e} lanes by hits found="
        f"{depth_hist.tolist()} | {COMPARE_LANES} lanes vs plain: "
        f"hits={live} hit_mismatch={hit_mm} prim_mismatch_unique={prim_mm} "
        f"{'OK' if good else 'FAIL'}")
    good &= check_modes([("radix_closest",
                          "traverse_radix_closest_multi_hit", "1e")],
                        mrec, rscene.bvh, mlaunches)
    return ok and good, dict(
        filtered_frame_s=filtered_s, filtered_frame_times=times,
        filtered_launches=launches, multi_hit_s=mh_s,
        multi_hit_times=mtimes, multi_hit_launches=mlaunches)


def profile_run(run, label, table_path=None):
    """``--profile``: torch.profiler over one ``run()`` (a frame or a
    training step); prints the device busy share and the top kernels by
    device time.  ``--profile-table=PATH`` also writes the profiler's full
    operator table to PATH."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    ka = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    # device-side events only (kernels, copies): an operator's row repeats
    # the time of the kernels it launched
    dev_rows = sorted((e for e in ka
                       if e.device_type == torch.autograd.DeviceType.CUDA),
                      key=dev_us, reverse=True)
    groups = {"traverse_kernel": ("binned_kernel", "coherent_kernel"),
              "sort": ("Sort", "sort", "Radix", "radix"),
              "gather_scatter": ("gather", "index", "scatter", "Index"),
              "reduce": ("reduce_kernel",),
              "cat_copy": ("Cat", "copy", "Memcpy", "Memset")}
    sums = dict.fromkeys(list(groups) + ["elementwise_other"], 0.0)
    for e in dev_rows:
        g = next((k for k, keys in groups.items()
                  if any(s in e.key for s in keys)), "elementwise_other")
        sums[g] += dev_us(e) / 1e6
    busy_s = sum(sums.values())
    log(f"profile: {label} wall_s={wall_s:.4f} device_busy_s={busy_s:.4f} "
        f"idle_share={1 - busy_s / wall_s:.4f} kernels_launched="
        f"{sum(e.count for e in dev_rows)} | "
        + " ".join(f"{k}={v:.4f}" for k, v in sums.items()))
    for e in dev_rows[:12]:
        log(f"  {dev_us(e) / 1e3:9.3f} ms  n={e.count:6d}  {e.key[:90]}")
    if table_path:
        sort_key = ("self_device_time_total"
                    if hasattr(dev_rows[0], "self_device_time_total")
                    else "self_cuda_time_total")
        with open(table_path, "w") as f:
            f.write(ka.table(sort_by=sort_key, row_limit=80))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "runs on a GPU only", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    log(f"device: {smi} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | python {sys.version.split()[0]}")

    # ---- phase 1: build the kernel
    trav._library()
    info = trav.BUILD_INFO
    log(f"kernel build: {info['seconds']:.2f} s -> {info['path']}")
    for line in ptxas_lines(info["log"], main_path=True):
        log("  ptxas: " + line)
    spills = [n for n, f in ptxas_report(info["log"]).items() if f["spill"]]
    log(f"  forms with spills ({len(spills)} of "
        f"{len(ptxas_report(info['log']))}): {spills}")

    all_ok = True
    entries = []

    def check_modes(modes, rec, bvh, launches):
        ok = True
        for key, name, row in modes:
            if key not in rec.first:
                log(f"FAIL: mode {key} was never launched by its frame")
                ok = False
                continue
            good, entry = check_mode(key, name, row, rec.launches[key], bvh,
                                     launches)
            ok &= good
            entries.append(entry)
        return ok

    with torch.no_grad():
        # ---- phase 3 set-up: scene and BVH on the card
        t0 = time.perf_counter()
        scene, cam = sponza_like_scene(target_tris=TARGET_TRIS, device=dev)
        torch.cuda.synchronize()
        scene_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        scene.bvh = build_cluster_bvh(scene.mesh, cluster_size=K,
                                      treelet_size=T)
        torch.cuda.synchronize()
        bvh_build_s = time.perf_counter() - t0
        bvh = scene.bvh
        # the same build on the CPU (the tests hold the CPU build equal to
        # the JAX package's at small sizes)
        cpu_mesh = dataclasses.replace(scene.mesh,
                                       vertices=scene.mesh.vertices.cpu(),
                                       faces=scene.mesh.faces.cpu())
        cpu_bvh = build_cluster_bvh(cpu_mesh, cluster_size=K,
                                    treelet_size=T)
        same = all(torch.equal(getattr(bvh, k).cpu(), getattr(cpu_bvh, k))
                   for k in ("nodes", "tris", "treelet_lo", "treelet_hi",
                             "treelet_roots"))
        log(f"scene: tris={scene.num_triangles} scene_s={scene_s:.3f} "
            f"bvh_build_s={bvh_build_s:.3f} C={bvh.num_clusters} "
            f"K={bvh.cluster_size} S={bvh.num_treelets} "
            f"T={bvh.treelet_size} tables_equal_to_cpu_build={same}")
        all_ok &= same
        params = KernelParams.create(
            scene, num_bounces=BOUNCES, epsilon=1e-3,
            bg_color=(0.2, 0.3, 0.5, 1.0), ambient_color=(1.0, 1.0, 1.0, 1.0))
        x, y = swizzled_pixels(dev)

        def frame(num):
            return render_pixels(params, cam, x, y, WIDTH, HEIGHT,
                                 "pathtracing", SPP, "jittered_blend", num,
                                 nee=True)

        # ---- phase 3: the forward frame, counts reset just before
        rec, launches, warm_s, times, color, depth = timed_frames(frame)
        log(f"warm frame: {warm_s:.3f} s, modes seen: {sorted(rec.first)}")
        frame_s = sum(times) / len(times)
        rays = WIDTH * HEIGHT * SPP * BOUNCES * 2
        hit_frac = float((depth > 0).float().mean())
        img_mean = float(color[:, :3].mean())
        finite = bool(torch.isfinite(color).all())
        img_std = float(color[:, :3].std())
        log(f"frame 1920x1080 spp=1 bounces=5 nee: frame_s={frame_s:.4f} "
            f"(frames {', '.join(f'{t:.4f}' for t in times)}) "
            f"mrays_per_s={rays / frame_s / 1e6:.3f} launches={launches} "
            f"entry_launches={rec.entries} "
            f"hit_fraction={hit_frac:.4f} image_mean={img_mean:.6f} "
            f"image_std={img_std:.6f} finite={finite}")
        coherent_n = sum(launches[k] for k in COHERENT)
        path_ok = (finite and img_std > 0 and hit_frac > 0.5
                   and all(launches[k] > 0 for k, _, _ in MODES)
                   and rec.entries["vsnray_traverse_coherent"] == coherent_n)
        if not path_ok:
            log("FAIL: the frame is not finite, is constant, hits too "
                "little, a path mode never launched, or a coherent mode "
                "did not run traverse_coherent.cu")
        all_ok &= path_ok

        # ---- phase 2: kernel vs plain, per mode, on captured launches
        all_ok &= check_modes(MODES, rec, bvh, launches)
        rec_entries = rec.entries
        del rec

        # ---- phase 4: whole-path check
        all_ok &= whole_path_check(dev)

    # ---- phase 5: the training step at full width
    step_ok, step_info = training_step_phase(params, cam, x, y)
    all_ok &= step_ok
    for e in entries:
        e["launches_training_step"] = step_info["forward_launches"].get(
            e["mode_key"], 0)

    # ---- phase 6: kernel vs plain gradients at 32x32
    all_ok &= grad_check(dev)

    with torch.no_grad():
        # ---- phase 7a: the radix tree of the 260k scene
        rbvh, rframe, tables_ok, rbuild_s = radix_phase(scene, cam,
                                                        cpu_mesh, dev)
        all_ok &= tables_ok
        rrec, rlaunches, rwarm_s, rtimes, rcolor, rdepth = \
            timed_frames(rframe)
        rframe_s = sum(rtimes) / len(rtimes)
        rfinite = bool(torch.isfinite(rcolor).all())
        rstd = float(rcolor[:, :3].std())
        rhit = float((rdepth > 0).float().mean())
        radix_ok = (rfinite and rstd > 0 and rhit > 0.5
                    and all(rlaunches[k] > 0 for k, _, _ in RADIX_MODES)
                    and sum(rlaunches.values()) == sum(
                        rlaunches[k] for k, _, _ in RADIX_MODES)
                    and rrec.entries["vsnray_traverse_binned"] == sum(
                        rlaunches.values()))
        log(f"radix frame 1920x1080 spp=1 bounces=5 nee: "
            f"frame_s={rframe_s:.4f} (frames "
            f"{', '.join(f'{t:.4f}' for t in rtimes)}) warm_s={rwarm_s:.3f} "
            f"mrays_per_s={rays / rframe_s / 1e6:.3f} launches={rlaunches} "
            f"entry_launches={rrec.entries} "
            f"hit_fraction={rhit:.4f} image_mean="
            f"{float(rcolor[:, :3].mean()):.6f} image_std={rstd:.6f} "
            f"finite={rfinite} {'OK' if radix_ok else 'FAIL'}")
        all_ok &= radix_ok
        all_ok &= check_modes(RADIX_MODES, rrec, rbvh, rlaunches)
        rentries = rrec.entries
        del rrec

        # ---- phase 7b: a single-cluster tree (C == 1)
        c1, c1_cam = c1_scene(dev)
        c1_params = KernelParams.create(
            c1, num_bounces=2, epsilon=1e-3, bg_color=(0.2, 0.3, 0.5, 1.0),
            ambient_color=(1.0, 1.0, 1.0, 1.0))
        cx, cy = _pixel_grid(64, 64, dev)

        def c1_frame(num):
            return render_pixels(c1_params, c1_cam, cx, cy, 64, 64,
                                 "pathtracing", 1, "jittered_blend", num,
                                 nee=True)

        crec, claunches, _, _, ccolor, cdepth = timed_frames(c1_frame)
        c1_ok = (c1.bvh.num_clusters == 1 and bool(
            torch.isfinite(ccolor).all()) and float(ccolor.std()) > 0
            and all(claunches[k] > 0 for k, _, _ in C1_MODES))
        log(f"C == 1 frame 64x64 bounces=2 nee: tris={c1.num_triangles} "
            f"C={c1.bvh.num_clusters} launches={claunches} hit_fraction="
            f"{float((cdepth > 0).float().mean()):.4f} "
            f"{'OK' if c1_ok else 'FAIL'}")
        all_ok &= c1_ok
        all_ok &= check_modes(C1_MODES, crec, c1.bvh, claunches)
        del crec

        # ---- phase 7c: the simple frame on the radix tree, render's
        # defaults only; then on the radix tree at K=40
        simple = {}
        for label, sbvh in (("", rbvh), ("_k40", None)):
            if sbvh is None:
                sbvh = build_cluster_bvh(scene.mesh, cluster_size=40,
                                         treelet_size=0)
            ok, simple[f"simple_frame{label}_s"] = simple_phase(
                dataclasses.replace(scene, bvh=sbvh), cam, label,
                check_modes)
            all_ok &= ok

    with torch.no_grad():
        # ---- phase 8: row 1f, the four options on the main path's frame
        frames_1f = {}
        for option, cfg in OPTIONS_1F.items():
            first = len(entries)
            good, frames_1f[option] = option_phase(
                option, cfg, params, cam, x, y, color, check_modes)
            for e in entries[first:]:
                e["option"] = option
            all_ok &= good

    # ---- phase 8: the training step under one 1f option
    cfg = OPTIONS_1F[STEP_1F]
    step_ok, step_1f = training_step_phase(
        dataclasses.replace(params, trace=cfg), cam, x, y,
        label=f"1f {STEP_1F} training step")
    forms = {trav.variant_key(k, cfg.fanout, cfg.half_skip)
             for k, _, _ in MODES}
    step_ok &= set(step_1f["forward_variants"]) == forms
    all_ok &= step_ok
    for e in entries:
        if e.get("option") == STEP_1F:
            e["launches_training_step"] = step_1f["forward_variants"].get(
                e["variant"], 0)
        elif e.get("option"):
            e["launches_training_step"] = 0

    with torch.no_grad():
        # ---- phase 9: the shadow and sort-key switches
        switch_frames = {}
        for name, (cfg, expect) in SWITCHES.items():
            first = len(entries)
            good, switch_frames[name] = switch_phase(
                name, cfg, expect, params, cam, x, y, color, check_modes)
            for e in entries[first:]:
                e["switch"] = name
                e["launches_training_step"] = 0
            all_ok &= good

    # ---- phases 10-13: render's other paths on phase 7a's radix tree
    rscene = dataclasses.replace(scene, bvh=rbvh)
    slice7 = {}
    first = len(entries)
    with torch.no_grad():
        for algo in ("whitted", "ao"):
            good, slice7[f"{algo}_frame"] = algo_phase(rscene, cam, algo,
                                                       check_modes)
            all_ok &= good
    good, slice7["boundary_step"] = boundary_phase(rscene, cam, check_modes,
                                                   dev)
    all_ok &= good
    with torch.no_grad():
        good, slice7["filter_multi_hit"] = filter_phase(rscene, cam,
                                                        check_modes, dev)
    all_ok &= good
    for e in entries[first:]:
        e["launches_training_step"] = 0

    if "--profile" in sys.argv[1:]:
        table = [a.split("=", 1)[1] for a in sys.argv[1:]
                 if a.startswith("--profile-table=")]
        with torch.no_grad():
            profile_run(lambda: frame(TIMED_FRAMES + 2), "frame",
                        table[0] if table else None)
            profile_run(lambda: rframe(TIMED_FRAMES + 2), "radix frame")
        profile_run(lambda: step.loss_and_grads(
            params.scene.mesh.vertices, params.scene.materials.cd,
            TIMED_STEPS + 3, params, cam, x, y, nee=True), "training step",
            table[0] + ".step" if table else None)
        with torch.no_grad():
            for algo in ("whitted", "ao"):
                profile_run(lambda: render(rscene, cam, WIDTH, HEIGHT,
                                           algo=algo), f"{algo} frame")
        adj = build_edge_adjacency(rscene.mesh.faces.cpu().numpy(),
                                   rscene.mesh.vertices.cpu().numpy(),
                                   device=dev)
        profile_run(lambda: _boundary_grad(rscene, cam, WIDTH, HEIGHT, adj),
                    "boundary step")

    log(json.dumps({"kernels": entries, "frame_s": frame_s,
                    "entry_launches": rec_entries,
                    "bvh_build_s": bvh_build_s,
                    "mrays_per_s": rays / frame_s / 1e6,
                    "training_step": step_info,
                    "radix_frame_s": rframe_s,
                    "radix_entry_launches": rentries, **simple,
                    "radix_bvh_build_s": rbuild_s,
                    "frames_1f": frames_1f, "training_step_1f": step_1f,
                    "switch_frames": switch_frames, **slice7,
                    "build_s": info["seconds"]}))
    log(f"card: {smi}")
    if not all_ok:
        log("chip_smoke: FAILED")
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

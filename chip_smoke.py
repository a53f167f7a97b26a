#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port (visionaray_torch) on one GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when it fails:

1. Device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions, and the nvcc build of ops/cuda/traverse.cu (seconds, ptxas
   report).
2. Kernel vs plain version, per traversal mode, on launches captured from
   the real 1080p frame (sponza-class scene, 259,656 triangles, K=32,
   T=128): coherent closest-hit, binned two-pass closest-hit, binned
   two-pass any-hit, coherent any-hit.  Each is compared on >= 8192 lanes
   (binned modes: tiles that straddle two treelet segments and tiles with
   dead lanes) and timed at the full launch; the kernel's counters size
   the bound.
3. The slice: ClusterBVH built on the card, then the 1920x1080, 1 spp,
   5-bounce NEE frame in bench.py's 64-px block swizzle; one warm frame,
   then timed frames.  Launch counts are reset just before the first
   timed frame and read just after it.
4. Whole-path check: a small config (sponza_like 4000 triangles, K=8, T=16,
   64x64, 3 bounces, NEE) rendered through the kernel and through the
   plain version, both on the card, compared image to image.

Output: one line per check, then a JSON line with per-kernel numbers, the
card's name and power limit, and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

    python3 chip_smoke.py --profile [--profile-table=PATH]

adds a torch.profiler breakdown of one more frame: device time by kernel
group and the device idle share, and with PATH the full operator table.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

import visionaray_torch.ops.traverse as trav
from visionaray_torch.kernels.params import KernelParams
from visionaray_torch.ops.cluster_bvh import build_cluster_bvh
from visionaray_torch.sched.render import _pixel_grid, render_pixels
from visionaray_torch.scenes.sponza_like import sponza_like_scene

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
# H100 SXM peaks (NVIDIA data sheet): memory rate and f32 non-tensor rate
PEAK_BYTES_S, PEAK_F32_S = 3.35e12, 67e12
FLOP_TRI, FLOP_BOX = 40, 20      # ops of one triangle / one box test
REPLACES = "visionaray_tpu/ops/pallas/traverse.py:557"
SOURCE = "visionaray_torch/ops/cuda/traverse.cu"
MODES = [  # (mode key, kernel name, table row)
    ("closest", "traverse_closest", "1"),
    ("binned_closest", "traverse_binned_closest", "1b"),
    ("binned_any", "traverse_binned_any", "1c"),
    ("any", "traverse_any", "1d"),
]


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
    keeps a copy of the inputs of the first launch of each mode."""

    def __init__(self, fn):
        self.fn = fn
        self.first = {}

    def __call__(self, rays, nodes, tris, num_clusters, cluster_size,
                 tile_lanes, any_hit=False, tile_roots=None,
                 tile_splits=None, counters=None):
        mode = ("binned_" if tile_roots is not None else "") + \
            ("any" if any_hit else "closest")
        if mode not in self.first:
            self.first[mode] = dict(
                rays=rays.clone(), tile_lanes=tile_lanes, any_hit=any_hit,
                roots=None if tile_roots is None else tile_roots.clone(),
                splits=None if tile_splits is None else tile_splits.clone())
        return self.fn(rays, nodes, tris, num_clusters, cluster_size,
                       tile_lanes, any_hit, tile_roots, tile_splits,
                       counters)


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
    and the middle of the launch, at least COMPARE_LANES lanes in all."""
    n_tiles = rays.shape[0] // tl
    live = (rays[:, 6] >= 0).reshape(n_tiles, tl)
    picked = []
    straddle = torch.nonzero(splits < tl).reshape(-1).tolist()
    picked += straddle[:: max(1, len(straddle) // 4)][:4]
    mixed = torch.nonzero(live.any(1) & ~live.all(1)).reshape(-1).tolist()
    picked += mixed[-1:]
    mid = n_tiles // 2
    while len(set(picked)) * tl < COMPARE_LANES:
        picked.append(mid)
        mid += 1
    return sorted(set(picked)), len(straddle), len(mixed)


def sub_launch(rays, roots, splits, tl, tiles):
    idx = torch.tensor(tiles, device=rays.device)
    sub_rays = rays.reshape(-1, tl, 8)[idx].reshape(-1, 8).contiguous()
    return (sub_rays, roots[:, idx].contiguous(),
            splits[idx].contiguous())


def check_mode(key, name, row, launch, bvh, launches):
    rays, roots, splits, tl = full_tiles(launch)
    any_hit = launch["any_hit"]
    binned = launch["roots"] is not None
    C, Kc = bvh.num_clusters, bvh.cluster_size

    def kernel(r, ro, sp, counters=None):
        return trav.cluster_traverse(
            r, bvh.nodes, bvh.tris, C, Kc, tile_lanes=tl, any_hit=any_hit,
            tile_roots=ro if binned else None,
            tile_splits=sp if binned else None, counters=counters)

    def plain(r, ro, sp):
        return trav.traverse_plain(r, bvh.nodes, bvh.tris, C, Kc, tl,
                                   any_hit, ro, sp)

    # correctness on a subset of tiles
    tiles, n_straddle, n_mixed = compare_tiles(rays, roots, splits, tl)
    sr, sro, ssp = sub_launch(rays, roots, splits, tl, tiles)
    kt, kp, ku, kv = kernel(sr, sro, ssp)
    pt, pp, pu, pv = plain(sr, sro, ssp)
    torch.cuda.synchronize()
    live = sr[:, 6] >= 0
    kh, ph = kp >= 0, pp >= 0
    hit_mm = int((live & (kh != ph)).sum())
    n_live = int(live.sum())
    if any_hit:
        prim_mm = 0
        max_rel = 0.0
        max_abs = float((kh != ph).float().max())
    else:
        both = live & kh & ph
        same = both & (kp == pp)
        prim_mm = int((both & (kp != pp) & (kt != pt)).sum())
        dt = (kt - pt).abs()[same]
        max_abs = float(dt.max()) if dt.numel() else 0.0
        rel = dt / pt.abs()[same].clamp_min(1e-30)
        max_rel = float(rel.max()) if rel.numel() else 0.0
        uv = torch.maximum((ku - pu).abs(), (kv - pv).abs())[same]
        max_abs = max(max_abs, float(uv.max()) if uv.numel() else 0.0)
    plain_ms = cuda_ms(lambda: plain(sr, sro, ssp), 1)
    kernel_cmp_ms = cuda_ms(lambda: kernel(sr, sro, ssp), 5)

    # full launch: time and counters
    ms = cuda_ms(lambda: kernel(rays, roots, splits), 5)
    counters = torch.zeros((rays.shape[0], 2), dtype=torch.int32,
                           device=rays.device)
    kernel(rays, roots, splits, counters)
    tot = counters.sum(0, dtype=torch.int64).tolist()
    npad = rays.shape[0]
    bytes_moved = (npad * 8 * 4 + bvh.nodes.numel() * 4
                   + bvh.tris.numel() * 4 + roots.numel() * 4
                   + splits.numel() * 4 + 4 * npad * 4)
    ops = FLOP_TRI * tot[1] + FLOP_BOX * tot[0]
    t_bytes = bytes_moved / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_F32_S * 1e3
    ok = (hit_mm + prim_mm <= MISMATCH_SHARE * max(n_live, 1)
          and max_rel <= T_RTOL)
    log(f"kernel {row} {name}: compare_lanes={sr.shape[0]} live={n_live} "
        f"tiles={len(tiles)} straddling_tiles_in_launch={n_straddle} "
        f"live_dead_tiles_in_launch={n_mixed} hit_mismatch={hit_mm} "
        f"prim_mismatch_unique={prim_mm} max_rel_t={max_rel:.3e} "
        f"kernel_ms_compare={kernel_cmp_ms:.4f} plain_ms={plain_ms:.3f} | "
        f"full launch lanes={npad} live={int((rays[:, 6] >= 0).sum())} "
        f"ms={ms:.4f} box_tests={tot[0]} tri_tests={tot[1]} "
        f"bound_ms={max(t_bytes, t_ops):.4f} "
        f"({'bytes' if t_bytes >= t_ops else 'operations'}) "
        f"{'OK' if ok else 'FAIL'}")
    entry = {
        "name": name, "route": "cuda", "source": SOURCE,
        "replaces": REPLACES, "mode": row, "launches": launches.get(key, 0),
        "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None, "lanes": npad, "compare_lanes": sr.shape[0],
        "kernel_ms_compare": kernel_cmp_ms, "hit_mismatch": hit_mm,
        "prim_mismatch_unique": prim_mm, "max_rel_t": max_rel,
        "box_tests": tot[0], "tri_tests": tot[1],
    }
    return ok, entry


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


def whole_path_check(device):
    """Small config through the kernel and through the plain version."""
    scene, cam = sponza_like_scene(target_tris=4000, device=device)
    scene.bvh = build_cluster_bvh(scene.mesh, cluster_size=8,
                                  treelet_size=16)
    params = KernelParams.create(scene, num_bounces=3, epsilon=1e-3,
                                 bg_color=(0.2, 0.3, 0.5, 1.0),
                                 ambient_color=(1.0, 1.0, 1.0, 1.0))
    x, y = _pixel_grid(64, 64, device)

    def frame():
        return render_pixels(params, cam, x, y, 64, 64, "pathtracing", 1,
                             "jittered_blend", 1, nee=True)[0]

    img_k = frame()
    kernel_fn = trav.cluster_traverse

    def plain_on_card(rays, nodes, tris, num_clusters, cluster_size,
                      tile_lanes, any_hit=False, tile_roots=None,
                      tile_splits=None, counters=None):
        if tile_roots is None:
            tile_roots, tile_splits = trav._default_tiles(
                rays.shape[0], tile_lanes, rays.device)
        return trav.traverse_plain(rays, nodes, tris, num_clusters,
                                   cluster_size, tile_lanes, any_hit,
                                   tile_roots, tile_splits)

    trav.cluster_traverse = plain_on_card
    try:
        img_p = frame()
    finally:
        trav.cluster_traverse = kernel_fn
    diff = (img_k - img_p).abs()
    mean_abs = float(diff.mean())
    share = float((diff.amax(-1) > IMG_PIX_TOL).float().mean())
    ok = bool(torch.isfinite(img_k).all()) and mean_abs <= IMG_MEAN_ABS \
        and share <= IMG_PIX_SHARE
    log(f"whole path 64x64 kernel vs plain: mean_abs={mean_abs:.3e} "
        f"pixels_over_{IMG_PIX_TOL:g}={share:.4f} "
        f"image_mean={float(img_k.mean()):.6f} {'OK' if ok else 'FAIL'}")
    return ok


def profile_frame(run, table_path=None):
    """``--profile``: torch.profiler over one frame; prints the device busy
    share and the top kernels by device time.  ``--profile-table=PATH``
    also writes the profiler's full operator table to PATH."""
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
    groups = {"traverse_kernel": ("traverse_kernel",),
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
    log(f"profile: frame wall_s={wall_s:.4f} device_busy_s={busy_s:.4f} "
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
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            log("  nvcc: " + line.strip())

    all_ok = True
    with torch.inference_mode():
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
        params = KernelParams.create(
            scene, num_bounces=BOUNCES, epsilon=1e-3,
            bg_color=(0.2, 0.3, 0.5, 1.0), ambient_color=(1.0, 1.0, 1.0, 1.0))
        x, y = swizzled_pixels(dev)

        def frame(num):
            return render_pixels(params, cam, x, y, WIDTH, HEIGHT,
                                 "pathtracing", SPP, "jittered_blend", num,
                                 nee=True)

        # warm frame, recording the first launch of every mode
        rec = LaunchRecorder(trav.cluster_traverse)
        trav.cluster_traverse = rec
        try:
            t0 = time.perf_counter()
            frame(1)
            torch.cuda.synchronize()
            warm_s = time.perf_counter() - t0
        finally:
            trav.cluster_traverse = rec.fn
        log(f"warm frame: {warm_s:.3f} s, modes seen: {sorted(rec.first)}")

        # ---- phase 3: the main path, counts reset just before
        trav.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        color, depth = frame(2)
        torch.cuda.synchronize()
        times = [time.perf_counter() - t0]
        launches = dict(trav.LAUNCHES)
        for i in range(TIMED_FRAMES - 1):
            t0 = time.perf_counter()
            frame(3 + i)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        frame_s = sum(times) / len(times)
        rays = WIDTH * HEIGHT * SPP * BOUNCES * 2
        hit_frac = float((depth > 0).float().mean())
        img_mean = float(color[:, :3].mean())
        finite = bool(torch.isfinite(color).all())
        img_std = float(color[:, :3].std())
        log(f"frame 1920x1080 spp=1 bounces=5 nee: frame_s={frame_s:.4f} "
            f"(frames {', '.join(f'{t:.4f}' for t in times)}) "
            f"mrays_per_s={rays / frame_s / 1e6:.3f} launches={launches} "
            f"hit_fraction={hit_frac:.4f} image_mean={img_mean:.6f} "
            f"image_std={img_std:.6f} finite={finite}")
        path_ok = (finite and img_std > 0 and hit_frac > 0.5
                   and all(launches[k] > 0 for k, _, _ in MODES))
        if not path_ok:
            log("FAIL: the frame is not finite, is constant, hits too "
                "little, or a path mode never launched")
        all_ok &= path_ok

        # ---- phase 2: kernel vs plain, per mode, on captured launches
        entries = []
        for key, name, row in MODES:
            if key not in rec.first:
                log(f"FAIL: mode {key} was never launched by the frame")
                all_ok = False
                continue
            ok, entry = check_mode(key, name, row, rec.first[key], bvh,
                                   launches)
            all_ok &= ok
            entries.append(entry)
        del rec

        # ---- phase 4: whole-path check
        all_ok &= whole_path_check(dev)

        if "--profile" in sys.argv[1:]:
            table = [a.split("=", 1)[1] for a in sys.argv[1:]
                     if a.startswith("--profile-table=")]
            profile_frame(lambda: frame(TIMED_FRAMES + 2),
                          table[0] if table else None)

    log(json.dumps({"kernels": entries, "frame_s": frame_s,
                    "bvh_build_s": bvh_build_s,
                    "mrays_per_s": rays / frame_s / 1e6,
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

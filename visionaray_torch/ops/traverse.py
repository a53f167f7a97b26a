"""ClusterBVH traversal: the hand-written CUDA kernel, its plain PyTorch
version, and the glue around them (port of ops/pallas/traverse.py).

Every ClusterBVH traversal goes through ``cluster_traverse`` (the LBVH
tier's flat trees go through ops/traversal.py's ``bvh_traverse``, whose
``traverse_lbvh.cu`` is built into the same library and counted in the
same ``LAUNCHES`` / ``ENTRY_LAUNCHES``, as is the volume renderer's march,
kernels/volume.py's ``volume_march`` over ``volume_march.cu`` and its
backward over ``volume_march_bwd.cu``, and the path tracer's bounce,
ops/bounce_shade.py over ``bounce_shade.cu``, counted in
``ENTRY_LAUNCHES`` alone):

- on CUDA tensors it launches a kernel of ``ops/cuda/`` and adds one to
  ``LAUNCHES[mode]`` and to ``ENTRY_LAUNCHES[entry point]``:
  ``traverse_coherent.cu`` for coherent tiles on a heap tree (binary
  descent, no half skip, K in BINNED_K), ``traverse_binned.cu`` for the
  two-pass tiles of the binned path, radix trees and every other
  heap-tree form; both built with nvcc at first use into one library
  under ``build/visionaray_torch/<source hash>/``, loaded with ctypes
  (``launch_form`` picks the entry point);
- on CPU tensors it runs ``traverse_plain``, a brute-force Moeller-Trumbore
  of each lane against every cluster under its start node.  It does not
  depend on traversal order, so it is an independent oracle for the kernel.

The kernel works on lanes laid out as ``_pack_rays`` makes them: one
``(npad, 8)`` f32 row per lane ``[ox oy oz dx dy dz max_t pad]``, tile
``i // tile_lanes`` for lane i; lanes with max_t < 0 are dead.  Tile
metadata (start nodes ``tile_roots`` (2, n_tiles), pass split
``tile_splits`` (n_tiles,)) comes from the same glue as the TPU path, so
TILE_ROWS, INTERLEAVE, BINNED_ROWS, BIN_M and _ENTRY_CHUNK keep their JAX
values.

Two tree forms: the kd heap (children of n at 2n+1 / 2n+2, the treelet
build) and the radix tree (children read from nodes[n, 6:8]; C == 1 is a
single leaf), traversed from node 0 only.  On a heap the kernels can also
descend 4 or 8 wide (``fanout``) and, where the kd build wrote half-cluster
boxes, skip the half of a cluster whose box the ray misses (``half_skip``):
PERF.md row 1f.  Neither changes the contract, so ``traverse_plain`` is
the oracle for every option.

Gradients: the traversal runs without autograd and only decides *which*
primitive each lane hits.  ``_HitTuv`` passes the kernel's (t, u, v)
through and, in backward, re-derives them with Moeller-Trumbore at that
fixed primitive (JAX _hit_tuv).  Under a ``TraceTape`` the front ends
record their traversal outputs, and a replay hands them back in call order
instead of tracing again: that is how a checkpointed bounce recomputes its
body in backward without a kernel launch.

The front ends take the JAX package's VSNRAY_FANOUT, VSNRAY_HALFSKIP and
VSNRAY_DIRBITS switches as arguments (``ops/trace.py::TraceConfig`` carries
them from ``KernelParams``); the port reads no environment variables.  As
in JAX (_fanout_for, _half_skip_for), each tree gets what it can take: a
radix tree runs binary descent, a tree without half boxes no skip.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

from visionaray_torch.core.types import FLT_MAX, HitRecord, Ray
from visionaray_torch.device import take
from visionaray_torch.ops.intersect import intersect_triangle
from visionaray_torch.ops.lbvh import morton3d

TILE_ROWS = 32       # coherent path: tile = TILE_ROWS * 128 lanes
INTERLEAVE = 2       # tiles per TPU grid step; fixes the padding granule
STACK_DEPTH = 64     # the kernels' stack entries; see stack_need
FANOUTS = (2, 4, 8)  # descent widths of the kernel (JAX _SORT_NET keys)
# the cluster sizes whose record loop the kernels unroll at compile time;
# traverse_binned.cu takes any other multiple of 8 through one run-time-K
# form, traverse_coherent.cu only these
BINNED_K = (8, 16, 32)
_INV_CLAMP = 1e18    # 1/d is clamped to +-1e18
BIN_M = 6            # treelet slots per ray on the binned closest path
BINNED_ROWS = 16     # binned path: tile = BINNED_ROWS * 128 lanes
_ENTRY_CHUNK = 1 << 15   # rays per treelet-entry chunk (bounds N x S)
TWO_PASS_CAP_FRAC = 0.08  # cluster_closest_hit(two_pass=True) ray cap

# Kernel launches per mode; each CUDA launch of cluster_traverse adds one.
#   closest         coherent closest-hit from the root (bounce 0)
#   any             coherent any-hit from the root (bounce-0 NEE shadows)
#   binned_closest  two-pass tiles, closest-hit (bounces 1..)
#   binned_any      two-pass tiles, any-hit (NEE shadows of bounces 1..)
#   radix_closest   radix tree from the root, closest-hit
#   radix_any       radix tree from the root, any-hit
#   c1_closest      single-cluster tree (C == 1), closest-hit
#   c1_any          single-cluster tree (C == 1), any-hit
# and the LBVH tier's walk (ops/traversal.py::bvh_traverse), on a flat BVH:
#   lbvh_closest    triangles, closest-hit (LBVH, SAH or SBVH leaves)
#   lbvh_any        triangles, any-hit
#   lbvh_multi      triangles, the k nearest hits
#   sphere_closest  spheres, closest-hit
#   sphere_any      spheres, any-hit
# and the volume renderer (kernels/volume.py::volume_march):
#   volume_march      one ray march over every volume of the scene
#   volume_march_bwd  its backward: texel and transfer gradients
#   volume_bricks     the march's brick table, once per texels and transfer
LAUNCHES = {"closest": 0, "any": 0, "binned_closest": 0, "binned_any": 0,
            "radix_closest": 0, "radix_any": 0, "c1_closest": 0,
            "c1_any": 0, "lbvh_closest": 0, "lbvh_any": 0, "lbvh_multi": 0,
            "sphere_closest": 0, "sphere_any": 0, "volume_march": 0,
            "volume_march_bwd": 0, "volume_bricks": 0}
# Kernel launches per (mode, fanout, half_skip), keyed by variant_key, per
# (LBVH mode, leaf form), keyed by traversal.leaf_variant_key, and per
# transfer form of the volume march (kernels/volume.py::transfer_form):
# which form of the kernel each launch ran.
VARIANT_LAUNCHES: dict = {}
# Kernel launches per C entry point: which kernel each mode ran.
ENTRY_LAUNCHES = {"vsnray_traverse_binned": 0,
                  "vsnray_traverse_coherent": 0,
                  "vsnray_traverse_lbvh": 0,
                  "vsnray_volume_march": 0,
                  "vsnray_volume_march_bwd": 0,
                  "vsnray_volume_bricks": 0,
                  "vsnray_bounce_shade_hit": 0,
                  "vsnray_bounce_shade_close": 0,
                  "vsnray_bounce_shade_bwd": 0}

_CUDA_DIR = Path(__file__).resolve().parent / "cuda"
SOURCES = (_CUDA_DIR / "traverse_binned.cu",
           _CUDA_DIR / "traverse_coherent.cu",
           _CUDA_DIR / "traverse_lbvh.cu",
           _CUDA_DIR / "volume_march.cu",
           _CUDA_DIR / "volume_march_bwd.cu",
           _CUDA_DIR / "bounce_shade.cu")
_BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / \
    "visionaray_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-fmad=false", "-Xptxas", "-v",
              "-Xcompiler", "-fPIC"]
# filled by the first build or load: seconds, library path, nvcc's output
BUILD_INFO: dict = {}
_LIB = None


def reset_launch_counts():
    for counts in (LAUNCHES, ENTRY_LAUNCHES):
        for k in counts:
            counts[k] = 0
    VARIANT_LAUNCHES.clear()


def variant_key(mode: str, fanout: int, half_skip: bool) -> str:
    """The VARIANT_LAUNCHES key of one launch, e.g.
    ``binned_closest/fanout4/half_skip``."""
    return f"{mode}/fanout{fanout}" + ("/half_skip" if half_skip else "")


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and Path(cand, "bin", "nvcc").exists():
            return str(Path(cand, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the traversal kernels are "
                           "built from ops/cuda/*.cu at first use")
    return found


def build_library(sources, out_dir: Path, flags=NVCC_FLAGS) -> Path:
    """Compile ``sources`` with nvcc, one process per source, all started
    together, and link them into ``out_dir/libvsnray_traverse.so``; nvcc's
    output (ptxas' registers, shared memory and spills) goes to
    ``out_dir/nvcc.log``."""
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    jobs = []
    for src in sources:
        obj = out_dir / f"{Path(src).stem}.{os.getpid()}.o"
        jobs.append((src, obj, subprocess.Popen(
            [nvcc, *flags, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for src, obj, proc in jobs:
        out = proc.communicate()[0]
        log.append(f"== {Path(src).name}\n{out}")
        if proc.returncode != 0:
            failed.append(f"{src}:\n{out}")
    (out_dir / "nvcc.log").write_text("".join(log))
    if failed:
        raise RuntimeError("nvcc failed on " + "\n".join(failed))
    tmp = out_dir / f"libvsnray_traverse.{os.getpid()}.tmp.so"
    link = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                           *[str(obj) for _, obj, _ in jobs]],
                          capture_output=True, text=True)
    for _, obj, _ in jobs:
        obj.unlink()
    if link.returncode != 0:
        raise RuntimeError(f"nvcc failed to link:\n{link.stderr}")
    lib_path = out_dir / "libvsnray_traverse.so"
    os.replace(tmp, lib_path)
    return lib_path


def bind_library(lib_path) -> ctypes.CDLL:
    """Load a built library and declare the arguments of the entry points
    it holds (a library built from an older source set, as
    scripts/torch_kernel_ab.py builds, may lack the newer ones)."""
    lib = ctypes.CDLL(str(lib_path))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # pointers (rays, nodes, tris[, roots, splits], 4 outputs, counters),
    # ints, the stream
    for entry, argtypes in (
            ("vsnray_traverse_binned", [p] * 10 + [i] * 9 + [p]),
            ("vsnray_traverse_coherent", [p] * 8 + [i] * 4 + [p]),
            # rays, max_t, packed nodes and primitives, 2 outputs,
            # counters; 8 ints; the stream
            ("vsnray_traverse_lbvh", [p] * 8 + [i] * 8 + [p]),
            # rays, boxes, padded texels, transfer, brick bits, bg, 3
            # outputs, dst, steps, empty steps, warps; n, V, D, H, W, T,
            # shift, nbx, nby, nbz, shared; step_scale; the stream
            ("vsnray_volume_march", [p] * 15 + [i] * 11 + [f, p]),
            # padded texels, prefix counts, table, bits; V, D, H, W, T,
            # shift, nbx, nby, nbz; the stream
            ("vsnray_volume_bricks", [p] * 4 + [i] * 9 + [p]),
            # rays, boxes, texels, transfer, bg, dst, dL/dcolor, 5
            # gradients (texels, transfer, ori, dir, boxes), the counts;
            # n, V, D, H, W, T; step_scale; the stream
            ("vsnray_volume_march_bwd", [p] * 15 + [i] * 6 + [f, p]),
            # the path tracer's bounce (ops/bounce_shade.py): 16 inputs
            # (rays, refs, state, carry, scene tables, ambient, epsilon)
            # and 9 outputs; n, triangles, lights, nee, reversed; the
            # stream
            ("vsnray_bounce_shade_hit", [p] * 25 + [i] * 5 + [p]),
            # directions, the buffer, shadow refs, carry, materials,
            # epsilon, 7 outputs; n, lights, nee, first; the stream
            ("vsnray_bounce_shade_close", [p] * 15 + [i] * 4 + [p]),
            # the pair's adjoint: 19 inputs (rays, refs, state, carry,
            # shadow refs, scene tables with the faces), the gradients of
            # 5 outputs, 6 gradients out; n, triangles, lights,
            # materials, nee, first; the stream
            ("vsnray_bounce_shade_bwd", [p] * 30 + [i] * 6 + [p])):
        fn = getattr(lib, entry, None)
        if fn is None:
            continue
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def _library():
    """Build (once per source hash) and load the kernels' shared library."""
    global _LIB
    if _LIB is not None:
        return _LIB
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(_CUDA_DIR.glob("*.cu*")):
        digest.update(path.name.encode() + path.read_bytes())
    out_dir = _BUILD_ROOT / digest.hexdigest()[:16]
    lib_path = out_dir / "libvsnray_traverse.so"
    t0 = time.perf_counter()
    if not lib_path.exists():
        build_library(SOURCES, out_dir)
    log = out_dir / "nvcc.log"
    BUILD_INFO.update(seconds=time.perf_counter() - t0, path=str(lib_path),
                      log=log.read_text() if log.exists() else "")
    _LIB = bind_library(lib_path)
    return _LIB


def _round_up(x, m):
    return -(-x // m) * m


def _default_tiles(npad, tile_lanes, device):
    n_tiles = npad // tile_lanes
    roots = torch.zeros((2, n_tiles), dtype=torch.int32, device=device)
    splits = torch.full((n_tiles,), tile_lanes, dtype=torch.int32,
                        device=device)
    return roots, splits


def stack_need(depth: int, fanout: int) -> int:
    """Worst-case stack entries of a walk over a tree of ``depth`` levels:
    each descent pushes at most fanout - 1 nodes and goes log2(fanout)
    levels down (a heap keeps its leaves on one level)."""
    return (fanout - 1) * -(-depth // (fanout.bit_length() - 1))


def _check_inputs(rays, nodes, tris, num_clusters, cluster_size, tile_lanes,
                  tile_roots, tile_splits, heap, depth, fanout, half_skip):
    npad = rays.shape[0]
    C, K = num_clusters, cluster_size
    n_tiles = npad // tile_lanes
    want = [
        (rays, (npad, 8), torch.float32),
        (nodes, (2 * C - 1, 8), torch.float32),
        (tris, (C, K // 8, 128), torch.float32),
        (tile_roots, (2, n_tiles), torch.int32),
        (tile_splits, (n_tiles,), torch.int32),
    ]
    for name, (x, shape, dtype) in zip(
            ("rays", "nodes", "tris", "tile_roots", "tile_splits"), want):
        if tuple(x.shape) != shape or x.dtype != dtype:
            raise ValueError(f"cluster_traverse: {name} must be {dtype} "
                             f"{shape}, got {x.dtype} {tuple(x.shape)}")
        if x.device != rays.device:
            raise ValueError(f"cluster_traverse: {name} is on {x.device}, "
                             f"rays on {rays.device}")
        if not x.is_contiguous():
            raise ValueError(f"cluster_traverse: {name} must be contiguous")
    if npad == 0 or npad % tile_lanes:
        raise ValueError(f"cluster_traverse: {npad} lanes is not a positive "
                         f"multiple of tile_lanes={tile_lanes}")
    if K % 8:
        raise ValueError("cluster_traverse: K must be a multiple of 8")
    if fanout not in FANOUTS:
        raise ValueError(f"cluster_traverse: fanout must be one of "
                         f"{FANOUTS}, got {fanout}")
    if fanout > 2 and not heap:
        raise ValueError("cluster_traverse: fanout > 2 needs a heap-built "
                         "tree (the kd build); a radix tree descends 2 wide")
    # the kd build writes the half-cluster boxes into records 0 and 1
    # exactly when K >= 16 (cluster_bvh.py half_boxes); elsewhere columns
    # 10..15 hold zeros, and a skip over them would cull real triangles
    if half_skip and not (heap and K >= 16):
        raise ValueError("cluster_traverse: half_skip needs a tree that "
                         "carries half boxes (a kd build with K >= 16)")
    if heap:
        if C & (C - 1) or C < 2:
            raise ValueError("cluster_traverse: a heap-built ClusterBVH has "
                             "C a power of two >= 2")
        depth = int(math.log2(C))
    elif depth is None:
        raise ValueError("cluster_traverse: a radix tree needs its depth "
                         "(ClusterBVH.depth)")
    # the JAX kernel clips its stack index at STACK_DEPTH - 1 and would
    # silently lose nodes; the port refuses such a tree instead
    if stack_need(depth, fanout) > STACK_DEPTH:
        raise ValueError(
            f"cluster_traverse: a tree of depth {depth} at fanout {fanout} "
            f"needs {stack_need(depth, fanout)} entries, more than the "
            f"{STACK_DEPTH}-entry traversal stack")


def launch_mode(heap: bool, num_clusters: int, two_pass: bool,
                any_hit: bool) -> str:
    """The LAUNCHES key of one launch."""
    kind = "any" if any_hit else "closest"
    if not heap:
        return ("c1_" if num_clusters == 1 else "radix_") + kind
    return ("binned_" if two_pass else "") + kind


def launch_form(heap: bool, num_clusters: int, two_pass: bool,
                any_hit: bool, fanout: int, half_skip: bool,
                cluster_size: int):
    """(C entry point, LAUNCHES key, VARIANT_LAUNCHES key) of one launch:
    coherent tiles on a heap tree at binary descent, without the half skip
    and with K in BINNED_K go to traverse_coherent.cu; every other launch
    (two-pass tiles, radix trees and C == 1, and the other coherent heap
    forms, whose tiles all start at node 0) to traverse_binned.cu."""
    mode = launch_mode(heap, num_clusters, two_pass, any_hit)
    if (heap and not two_pass and fanout == 2 and not half_skip
            and cluster_size in BINNED_K):
        entry = "vsnray_traverse_coherent"
    else:
        entry = "vsnray_traverse_binned"
    return entry, mode, variant_key(mode, fanout, half_skip)


def cluster_traverse(rays, nodes, tris, num_clusters: int, cluster_size: int,
                     tile_lanes: int, any_hit: bool = False,
                     tile_roots=None, tile_splits=None, counters=None,
                     heap: bool = True, depth=None, fanout: int = 2,
                     half_skip: bool = False):
    """Closest-hit (or any-hit) of packed lanes under per-lane start nodes.

    ``rays`` (npad, 8) f32 from ``_pack_rays``; ``tile_roots`` (2, n_tiles)
    and ``tile_splits`` (n_tiles,) i32, or None for the coherent layout
    (every lane starts at the root).  Returns (t, prim, u, v), each
    (npad,) f32; prim is the prim id as an f32 value, -1 on a miss, and
    misses and dead lanes keep t = max_t.  ``counters``: optional (npad, 2)
    i32 tensor the kernel fills with per-lane box and triangle tests.
    ``heap``: children of n at 2n+1 / 2n+2; otherwise a radix tree whose
    children are nodes[n, 6:8], of ``depth`` levels, traversed from node 0
    (it has no tile roots).  ``fanout`` 4 or 8: wider descent, heap trees
    only; ``half_skip``: the half-cluster skip, on kd builds with K >= 16
    (row 1f).  Neither changes the result.

    CUDA tensors launch the kernel; CPU tensors run ``traverse_plain``.
    """
    npad = rays.shape[0]
    two_pass = tile_roots is not None
    if two_pass and not heap:
        raise ValueError("cluster_traverse: a radix tree is traversed from "
                         "node 0 and takes no tile roots")
    if not two_pass:
        tile_roots, tile_splits = _default_tiles(npad, tile_lanes,
                                                 rays.device)
    _check_inputs(rays, nodes, tris, num_clusters, cluster_size, tile_lanes,
                  tile_roots, tile_splits, heap, depth, fanout, half_skip)
    if rays.device.type == "cpu":
        return traverse_plain(rays, nodes, tris, num_clusters, cluster_size,
                              tile_lanes, any_hit, tile_roots, tile_splits,
                              heap=heap)
    if rays.device.type != "cuda":
        raise ValueError(f"cluster_traverse: no kernel for {rays.device}")
    for x in (rays, nodes, tris):
        if x.data_ptr() % 16:
            raise ValueError("cluster_traverse: rays, nodes and tris must "
                             "be 16-byte aligned")
    if counters is not None and (tuple(counters.shape) != (npad, 2)
                                 or counters.dtype != torch.int32
                                 or counters.device != rays.device
                                 or not counters.is_contiguous()):
        raise ValueError("cluster_traverse: counters must be contiguous "
                         "int32 (npad, 2) on the rays' device")
    entry, mode, key = launch_form(heap, num_clusters, two_pass, any_hit,
                                   fanout, half_skip, cluster_size)
    lib = _library()
    outs = [torch.empty((npad,), dtype=torch.float32, device=rays.device)
            for _ in range(4)]
    outs_cnt = [*[o.data_ptr() for o in outs],
                None if counters is None else counters.data_ptr()]
    if entry == "vsnray_traverse_coherent":
        # every lane starts at the root: no tile metadata
        args = [rays.data_ptr(), nodes.data_ptr(), tris.data_ptr(),
                *outs_cnt, npad, num_clusters, cluster_size, int(any_hit)]
    else:
        args = [rays.data_ptr(), nodes.data_ptr(), tris.data_ptr(),
                tile_roots.data_ptr(), tile_splits.data_ptr(), *outs_cnt,
                npad, npad // tile_lanes, tile_lanes, num_clusters,
                cluster_size, int(any_hit), fanout, int(half_skip),
                int(heap)]
    with torch.cuda.device(rays.device):
        stream = torch.cuda.current_stream(rays.device).cuda_stream
        err = getattr(lib, entry)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: cudaError {err}")
    LAUNCHES[mode] += 1
    ENTRY_LAUNCHES[entry] += 1
    VARIANT_LAUNCHES[key] = VARIANT_LAUNCHES.get(key, 0) + 1
    return tuple(outs)


def _mt(o, d, rec):
    """Moeller-Trumbore of lanes o, d (L, 3) against records ``rec``, (M,
    16) shared by every lane or (L, M, 16) per lane, in the kernel's
    operation order (traverse.py:258-274); returns (t, b1, b2, ok) each
    (L, M)."""
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    v1x, v1y, v1z = rec[..., 0], rec[..., 1], rec[..., 2]
    e1x, e1y, e1z = rec[..., 3], rec[..., 4], rec[..., 5]
    e2x, e2y, e2z = rec[..., 6], rec[..., 7], rec[..., 8]
    s1x = dy * e2z - dz * e2y
    s1y = dz * e2x - dx * e2z
    s1z = dx * e2y - dy * e2x
    div = s1x * e1x + s1y * e1y + s1z * e1z
    ok = div != 0.0
    inv_div = 1.0 / torch.where(ok, div, 1.0)
    ddx = ox - v1x
    ddy = oy - v1y
    ddz = oz - v1z
    b1 = (ddx * s1x + ddy * s1y + ddz * s1z) * inv_div
    ok = ok & (b1 >= 0.0) & (b1 <= 1.0)
    s2x = ddy * e1z - ddz * e1y
    s2y = ddz * e1x - ddx * e1z
    s2z = ddx * e1y - ddy * e1x
    b2 = (dx * s2x + dy * s2y + dz * s2z) * inv_div
    ok = ok & (b2 >= 0.0) & (b1 + b2 <= 1.0)
    t = (e2x * s2x + e2y * s2y + e2z * s2z) * inv_div
    return t, b1, b2, ok


def traverse_plain(rays, nodes, tris, num_clusters: int, cluster_size: int,
                   tile_lanes: int, any_hit: bool, tile_roots, tile_splits,
                   heap: bool = True):
    """The kernel's contract in plain PyTorch, brute force.

    Each live lane is tested against every triangle of every cluster under
    its start node -- on a heap the subtree of node n at depth dn covers the
    contiguous clusters [((n+1) << (D-dn)) - 1 - (C-1), + 2^(D-dn)), with
    D = log2(C); on a radix tree the start must be the root, node 0, which
    covers all C clusters -- in cluster order, folding with the strict
    t < best_t (closest-hit: the first of equal nearest; any-hit: the first
    hit with t < max_t).  ``nodes`` is not read: no box culls anything.
    """
    npad = rays.shape[0]
    dev = rays.device
    C, K = num_clusters, cluster_size
    D = int(math.log2(C)) if heap else 0
    lane = torch.arange(npad, device=dev)
    tile = lane // tile_lanes
    in_a = (lane - tile * tile_lanes) < take(tile_splits, tile)
    start = torch.where(in_a, take(tile_roots[0], tile),
                        take(tile_roots[1], tile))
    mt = rays[:, 6]
    bt = mt.clone()
    bp = torch.full((npad,), -1.0, dtype=torch.float32, device=dev)
    bu = torch.zeros((npad,), dtype=torch.float32, device=dev)
    bv = torch.zeros((npad,), dtype=torch.float32, device=dev)
    recs = tris.reshape(C, K, 16)
    live = mt >= 0.0
    budget = (1 << 24) if dev.type == "cuda" else (1 << 20)
    for n in torch.unique(start[live]).tolist():
        idx = torch.nonzero(live & (start == n)).reshape(-1)
        if heap:
            dn = (n + 1).bit_length() - 1
            span = 1 << (D - dn)
            c0 = ((n + 1) << (D - dn)) - 1 - (C - 1)
        elif n == 0:
            span, c0 = C, 0
        else:
            raise ValueError(f"traverse_plain: a radix tree is traversed "
                             f"from node 0, not {n}")
        o = rays[idx, 0:3]
        d = rays[idx, 3:6]
        g_t, g_p = bt[idx], bp[idx]
        g_u, g_v = bu[idx], bv[idx]
        g_mt = mt[idx]
        step = max(1, budget // (idx.numel() * K))
        for j0 in range(c0, c0 + span, step):
            rec = recs[j0:min(j0 + step, c0 + span)].reshape(-1, 16)
            t, b1, b2, ok = _mt(o, d, rec)
            if any_hit:
                valid = ok & (t >= 0.0) & (t < g_mt[:, None]) \
                    & (g_t >= g_mt)[:, None]
                first = torch.argmax(valid.to(torch.uint8), dim=1)
                upd = valid.any(dim=1)
                g_t = torch.where(upd, t.gather(1, first[:, None])[:, 0], g_t)
                g_p = torch.where(upd, rec[first, 9], g_p)
            else:
                tv = torch.where(ok & (t >= 0.0), t, math.inf)
                best = torch.argmin(tv, dim=1)
                tb = tv.gather(1, best[:, None])[:, 0]
                upd = tb < g_t
                g_t = torch.where(upd, tb, g_t)
                g_p = torch.where(upd, rec[best, 9], g_p)
                g_u = torch.where(upd, b1.gather(1, best[:, None])[:, 0], g_u)
                g_v = torch.where(upd, b2.gather(1, best[:, None])[:, 0], g_v)
        bt[idx], bp[idx], bu[idx], bv[idx] = g_t, g_p, g_u, g_v
    return bt, bp, bu, bv


def _pack_rays(o, d, mt, n, npad, pad_maxt):
    """Lanes as (npad, 8) rows [ox oy oz dx dy dz max_t 0]; padding lanes
    are [0 0 0 1 1 1 pad_maxt 0]."""
    rows = torch.cat([o, d, mt[:, None], torch.zeros_like(mt)[:, None]],
                     dim=1)
    if npad > n:
        pad_row = torch.tensor([0, 0, 0, 1, 1, 1, pad_maxt, 0],
                               dtype=torch.float32, device=o.device)
        rows = torch.cat([rows, pad_row.expand(npad - n, 8)], dim=0)
    return rows.contiguous()


def _octant(d):
    return ((d[:, 0] < 0).to(torch.int64)
            + ((d[:, 1] < 0).to(torch.int64) << 1)
            + ((d[:, 2] < 0).to(torch.int64) << 2))


def _inverse_perm(perm):
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.shape[0], dtype=perm.dtype,
                             device=perm.device)
    return inv


def _coherence_perm(o, d, root_lo, root_hi):
    """Sort key: direction octant (3b) | origin morton (29b), stable, so a
    caller's pixel-block order survives within an octant.  Returns (perm,
    inv_perm)."""
    ext = torch.clamp_min(root_hi - root_lo, 1e-9)
    q = torch.clamp((o - root_lo) / ext, 0.0, 1.0)
    key = (_octant(d) << 29) | (morton3d(q) >> 1)
    perm = torch.argsort(key, stable=True)
    return perm, _inverse_perm(perm)


class TraceTape:
    """The traversal outputs of the front ends, in call order."""

    def __init__(self):
        self.outs = []
        self.pos = 0


_TAPE = threading.local()   # .tape, .replay: set by recording / replaying


class recording:
    """Context: every front-end traversal appends its output to ``tape``."""

    def __init__(self, tape: TraceTape):
        self.tape = tape

    def __enter__(self):
        self.saved = (getattr(_TAPE, "tape", None),
                      getattr(_TAPE, "replay", False))
        _TAPE.tape, _TAPE.replay = self.tape, False

    def __exit__(self, *exc):
        _TAPE.tape, _TAPE.replay = self.saved


class replaying(recording):
    """Context: the front ends return ``tape``'s outputs in order and launch
    nothing."""

    def __enter__(self):
        super().__enter__()
        self.tape.pos = 0
        _TAPE.replay = True


def _traced(fn):
    """The traversal ``fn()`` (kernel and glue) without autograd, recorded
    or replayed as the current tape says."""
    tape = getattr(_TAPE, "tape", None)
    if tape is not None and _TAPE.replay:
        out = tape.outs[tape.pos]
        tape.pos += 1
        return out
    with torch.no_grad():
        out = fn()
    if tape is not None:
        tape.outs.append(out)
    return out


def _fanout_for(cbvh, fanout: int) -> int:
    """The descent width a tree takes (JAX _fanout_for): ``fanout`` on a
    heap build, 2 on a radix tree."""
    return fanout if cbvh.heap else 2


def _half_skip_for(cbvh, half_skip: bool) -> bool:
    """The half-cluster skip where the tree carries half boxes (JAX
    _half_skip_for)."""
    return bool(half_skip and cbvh.half_boxes)


def _tree_kw(cbvh, fanout: int, half_skip: bool) -> dict:
    """cluster_traverse's tree arguments for ``cbvh``."""
    return dict(heap=cbvh.heap, depth=cbvh.depth,
                fanout=_fanout_for(cbvh, fanout),
                half_skip=_half_skip_for(cbvh, half_skip))


def _traverse_sorted(o, d, mt, n, cbvh, fanout: int, half_skip: bool):
    """Kernel over pre-sorted rays in coherent tiles; returns (n, 4)
    [t prim u v]."""
    chunk = TILE_ROWS * 128 * INTERLEAVE
    npad = _round_up(max(n, chunk), chunk)
    rays = _pack_rays(o, d, mt, n, npad, pad_maxt=-1.0)
    t, prim, u, v = cluster_traverse(
        rays, cbvh.nodes, cbvh.tris, cbvh.num_clusters, cbvh.cluster_size,
        tile_lanes=TILE_ROWS * 128, any_hit=False,
        **_tree_kw(cbvh, fanout, half_skip))
    return torch.stack([t[:n], prim[:n], u[:n], v[:n]], dim=1)


def _flat_rays(ray: Ray, max_t):
    o = ray.ori.reshape(-1, 3).to(torch.float32)
    d = ray.dir.reshape(-1, 3).to(torch.float32)
    mt = torch.as_tensor(max_t, dtype=torch.float32, device=o.device)
    mt = mt.expand(ray.batch_shape).reshape(-1)
    return o, d, mt


class _HitTuv(torch.autograd.Function):
    """(t, u, v) at the winning primitive (JAX traverse.py:602-642).

    Forward returns the kernel's values, no gather.  Backward re-derives
    them with Moeller-Trumbore at the fixed prim ``pid`` from the ray and
    the 16-column corner table ``tbl`` = [v1 e1 e2 0*7], and returns the
    gradients of ``ori``, ``dir`` and ``tbl``.
    """

    @staticmethod
    def forward(ctx, ori, dir, tbl, pid, kt, ku, kv):
        ctx.save_for_backward(ori, dir, tbl, pid)
        return kt.clone(), ku.clone(), kv.clone()

    @staticmethod
    def backward(ctx, gt, gu, gv):
        ori, dir, tbl, pid = ctx.saved_tensors
        want = ctx.needs_input_grad[:3]
        with torch.enable_grad():
            args = [x.detach().requires_grad_(w)
                    for x, w in zip((ori, dir, tbl), want)]
            rows = take(args[2], pid)
            t, u, v, _ = intersect_triangle(args[0], args[1], rows[..., 0:3],
                                            rows[..., 3:6], rows[..., 6:9])
            wrt = [a for a, w in zip(args, want) if w]
            got = iter(torch.autograd.grad((t, u, v), wrt, (gt, gu, gv),
                                           allow_unused=True))
        grads = [next(got) if w else None for w in want]
        grads = [torch.zeros_like(a) if w and g is None else g
                 for a, g, w in zip(args, grads, want)]
        return (*grads, None, None, None, None)


def _hit_tuv(ray: Ray, mesh, pid, kt, ku, kv):
    """``_HitTuv`` when a gradient can reach the ray or the vertices, else
    the kernel's values as they are."""
    if not torch.is_grad_enabled():
        return kt, ku, kv
    # a TriangleMesh's corners derive from its vertices; a soup
    # (parallel/ring.py) holds them
    if hasattr(mesh, "vertices"):
        mesh_grad = mesh.vertices.requires_grad
    else:
        mesh_grad = any(c.requires_grad for c in mesh.corners())
    if not (ray.ori.requires_grad or ray.dir.requires_grad or mesh_grad):
        return kt, ku, kv
    v1, e1, e2 = mesh.corners()
    tbl = torch.cat([v1, e1, e2, torch.zeros(v1.shape[:-1] + (7,),
                                             dtype=v1.dtype,
                                             device=v1.device)], dim=-1)
    return _HitTuv.apply(ray.ori, ray.dir, tbl, pid, kt, ku, kv)


def _closest_record(outs, ray: Ray, mesh) -> HitRecord:
    """HitRecord from traversal outputs (n, 4), differentiable by
    recompute through ``_hit_tuv``."""
    bs = ray.batch_shape
    prim = outs[:, 1].reshape(bs)
    hit = prim >= 0.0
    pid = torch.where(hit, prim.to(torch.int32), 0)
    t, u, v = _hit_tuv(ray, mesh, pid, outs[:, 0].reshape(bs),
                       outs[:, 2].reshape(bs), outs[:, 3].reshape(bs))
    return HitRecord(
        hit=hit,
        t=torch.where(hit, t, FLT_MAX),
        prim_id=pid,
        geom_id=take(mesh.geom_ids, pid),
        u=torch.where(hit, u, 0.0),
        v=torch.where(hit, v, 0.0),
    )


def _any_record(outs, ray: Ray, mesh) -> HitRecord:
    bs = ray.batch_shape
    prim = outs[:, 1].reshape(bs)
    t = outs[:, 0].reshape(bs)
    hit = prim >= 0.0
    pid = torch.where(hit, prim.to(torch.int32), 0)
    return HitRecord(hit=hit, t=torch.where(hit, t, FLT_MAX), prim_id=pid,
                     geom_id=take(mesh.geom_ids, pid),
                     u=torch.zeros_like(t), v=torch.zeros_like(t))


def cluster_closest_hit(ray: Ray, cbvh, mesh, max_t=FLT_MAX,
                        sort_rays: bool = True, two_pass: bool = False,
                        fanout: int = 2,
                        half_skip: bool = False) -> HitRecord:
    """Closest hit over the whole tree, coherent tiles.

    ``two_pass``: trace first with rays capped at TWO_PASS_CAP_FRAC of the
    scene diagonal, then re-trace only the capped misses at full range.
    ``fanout``, ``half_skip``: the kernel options (row 1f), taken where the
    tree allows them.
    """
    outs = _traced(lambda: _coherent_closest(ray, cbvh, max_t, sort_rays,
                                             two_pass, fanout, half_skip))
    return _closest_record(outs, ray, mesh)


def _coherent_closest(ray: Ray, cbvh, max_t, sort_rays: bool,
                      two_pass: bool, fanout: int, half_skip: bool):
    o, d, mt = _flat_rays(ray, max_t)
    n = o.shape[0]
    chunk = TILE_ROWS * 128 * INTERLEAVE
    root_lo = cbvh.nodes[0, 0:3]
    root_hi = cbvh.nodes[0, 3:6]
    inv = None
    if sort_rays and n > chunk:
        perm, inv = _coherence_perm(o, d, root_lo, root_hi)
        o, d, mt = o[perm], d[perm], mt[perm]

    if two_pass:
        diag = torch.linalg.norm(root_hi - root_lo)
        cap = TWO_PASS_CAP_FRAC * diag
        outs1 = _traverse_sorted(o, d, torch.minimum(mt, cap), n, cbvh,
                                 fanout, half_skip)
        missed = (outs1[:, 1] < 0.0) & (mt > cap)
        perm2 = torch.argsort((~missed).to(torch.int32), stable=True)
        inv2 = _inverse_perm(perm2)
        mt2 = torch.where(missed, mt, -1.0)
        outs2 = _traverse_sorted(o[perm2], d[perm2], mt2[perm2], n, cbvh,
                                 fanout, half_skip)
        outs = torch.where(missed[:, None], outs2[inv2], outs1)
    else:
        outs = _traverse_sorted(o, d, mt, n, cbvh, fanout, half_skip)
    if inv is not None:
        outs = outs[inv]
    return outs


def cluster_any_hit(ray: Ray, cbvh, mesh, max_t, sort_rays: bool = True,
                    fanout: int = 2, half_skip: bool = False) -> HitRecord:
    """Occlusion query over the whole tree, coherent tiles."""
    return _any_record(_traced(lambda: _coherent_any(
        ray, cbvh, max_t, sort_rays, fanout, half_skip)), ray, mesh)


def _coherent_any(ray: Ray, cbvh, max_t, sort_rays: bool, fanout: int,
                  half_skip: bool):
    o, d, mt = _flat_rays(ray, max_t)
    n = o.shape[0]
    chunk = TILE_ROWS * 128 * INTERLEAVE
    npad = _round_up(max(n, chunk), chunk)
    inv = None
    if sort_rays and n > chunk:
        perm, inv = _coherence_perm(o, d, cbvh.nodes[0, 0:3],
                                    cbvh.nodes[0, 3:6])
        o, d, mt = o[perm], d[perm], mt[perm]
    rays = _pack_rays(o, d, mt, n, npad, pad_maxt=-1.0)
    t, prim, _, _ = cluster_traverse(
        rays, cbvh.nodes, cbvh.tris, cbvh.num_clusters, cbvh.cluster_size,
        tile_lanes=TILE_ROWS * 128, any_hit=True,
        **_tree_kw(cbvh, fanout, half_skip))
    outs = torch.stack([t[:n], prim[:n]], dim=1)
    if inv is not None:
        outs = outs[inv]
    return outs


# ---------------------------------------------------------------------------
# Treelet-binned traversal, the incoherent-ray path: (ray, treelet) pairs
# are processed in rounds in entry order, each round sorted treelet-major so
# a kernel tile holds rays entering one treelet (or two, as two passes).


def _treelet_entries(o, d, mt, tlo, thi, m: int):
    """Entry distances of each ray into its m nearest treelets.

    Returns (ent (N, m) ascending, inf = empty slot; slot (N, m) int64 with
    -1 = "whole tree": a ray overlapping more than m treelets gets its last
    slot replaced by a whole-tree pass from the m-th nearest entry).
    Chunked by _ENTRY_CHUNK rays; the result per ray does not depend on the
    chunking.
    """
    S = tlo.shape[0]
    s_iota = torch.arange(S, device=o.device)[None, :]
    ents, slots = [], []
    for c0 in range(0, o.shape[0], _ENTRY_CHUNK):
        oc = o[c0:c0 + _ENTRY_CHUNK]
        dc = d[c0:c0 + _ENTRY_CHUNK]
        mc = mt[c0:c0 + _ENTRY_CHUNK]
        inv = torch.clamp(1.0 / dc, -_INV_CLAMP, _INV_CLAMP)
        t1 = (tlo[None, :, :] - oc[:, None, :]) * inv[:, None, :]
        t2 = (thi[None, :, :] - oc[:, None, :]) * inv[:, None, :]
        tn = torch.amax(torch.minimum(t1, t2), dim=-1)
        tf = torch.amin(torch.maximum(t1, t2), dim=-1)
        hit = (tf >= tn) & (tf >= 0.0) & (tn < mc[:, None])
        work = torch.where(hit, torch.clamp_min(tn, 0.0), math.inf)
        e_c, s_c = [], []
        for _ in range(m):
            idx_r = torch.argmin(work, dim=-1)
            e_c.append(torch.amin(work, dim=-1))
            s_c.append(idx_r)
            work = torch.where(s_iota == idx_r[:, None], math.inf, work)
        slot = torch.stack(s_c, dim=-1)
        ovf = hit.sum(dim=-1) > m
        slot[:, m - 1] = torch.where(ovf, -1, slot[:, m - 1])
        ents.append(torch.stack(e_c, dim=-1))
        slots.append(slot)
    return torch.cat(ents), torch.cat(slots)


def _two_pass_tile_meta(skey_s, troots, S: int, n_tiles: int, chunk: int,
                        lca_steps: int, npad: int):
    """Per-tile (split, rootA, rootB) from the sorted segment keys.

    ``skey_s`` (npad,) sorted: treelet index in [0, S), S for whole-tree
    slots, S+1 for dead/padding lanes.  split: end of the tile's first
    segment, in [1, chunk].  rootA: that segment's treelet root, or 0.
    rootB: the root of the single remaining treelet, the heap LCA of the
    spanned treelets, or 0 when a whole-tree slot lands in pass B; dead
    lanes never widen it.  Each result is (n_tiles,) int32.
    """
    dev = skey_s.device
    skey_s = skey_s.to(torch.int64)
    troots = troots.to(torch.int64)
    tile_iota = torch.arange(n_tiles, dtype=torch.int64, device=dev)
    segstart = torch.searchsorted(
        skey_s, torch.arange(S + 3, dtype=torch.int64, device=dev),
        right=False)
    tile0 = skey_s.reshape(n_tiles, chunk)[:, 0]
    n_live_tot = segstart[S + 1]
    idx_ll = torch.clamp(torch.minimum((tile_iota + 1) * chunk, n_live_tot)
                         - 1, 0, npad - 1)
    tile_ll = skey_s[idx_ll]
    split = torch.clamp(segstart[torch.clamp_max(tile0 + 1, S + 2)]
                        - tile_iota * chunk, 1, chunk)
    rootA = torch.where(tile0 < S, troots[torch.clamp(tile0, 0, S - 1)], 0)
    second = tile0 + 1
    wt = (second >= S) | (tile_ll >= S)
    x = (S - 1) + torch.clamp(second, 0, S - 1)
    y = (S - 1) + torch.clamp(tile_ll, 0, S - 1)
    for _ in range(lca_steps):
        ne = x != y
        x, y = (torch.where(ne, (x - 1) >> 1, x),
                torch.where(ne, (y - 1) >> 1, y))
    rootB = torch.where(wt, 0, x)
    return (split.to(torch.int32), rootA.to(torch.int32),
            rootB.to(torch.int32))


def _binned_trace(ray: Ray, cbvh, max_t, m: int, any_hit: bool,
                  fanout: int = 2, half_skip: bool = False,
                  dir_bits: int = 0):
    """Binned traversal loop; returns per-ray (n, 4) [t prim u v] with t the global
    distance (treelet entry + local t).

    Round r traces the lanes whose r-th nearest treelet entry is still in
    front of their best hit.  A round with no live lane is skipped; that
    test is one host sync per round.  ``dir_bits`` > 0 replaces the lowest
    morton bits of the sort key by as many in-octant direction bits (JAX
    VSNRAY_DIRBITS, traverse.py:1020-1031).
    """
    if not 0 <= dir_bits <= 19:
        raise ValueError(f"dir_bits must be in [0, 19], got {dir_bits}")
    m = min(m, cbvh.num_treelets)
    o, d, mt = _flat_rays(ray, max_t)
    n = o.shape[0]
    dev = o.device
    root_lo = cbvh.nodes[0, 0:3]
    root_hi = cbvh.nodes[0, 3:6]
    ext = torch.clamp_min(root_hi - root_lo, 1e-9)
    ent, slot = _treelet_entries(o, d, mt, cbvh.treelet_lo, cbvh.treelet_hi,
                                 m)

    S = cbvh.num_treelets
    troots = cbvh.treelet_roots
    chunk = BINNED_ROWS * 128
    npad = _round_up(max(n, chunk * INTERLEAVE), chunk * INTERLEAVE)
    n_tiles = npad // chunk
    lca_steps = max(1, int(math.ceil(math.log2(max(S, 2)))) + 1)
    octant = _octant(d)
    mbits = 19 - dir_bits
    # in-octant direction bits: the top dir_bits of |d|'s morton code
    dk = morton3d(torch.abs(d)) >> (30 - dir_bits) if dir_bits else None

    bt = torch.full((n,), FLT_MAX, dtype=torch.float32, device=dev)
    bp = torch.full((n,), -1.0, dtype=torch.float32, device=dev)
    bu = torch.zeros((n,), dtype=torch.float32, device=dev)
    bv = torch.zeros((n,), dtype=torch.float32, device=dev)
    for r in range(m):
        ent_r = ent[:, r]
        slot_r = slot[:, r]
        cap = torch.minimum(mt, bt)
        live = torch.isfinite(ent_r) & (ent_r < cap)
        if any_hit:
            live = live & (bp < 0.0)
        if not bool(live.any()):
            continue
        ent_c = torch.where(live, ent_r, 0.0)
        mtp = torch.where(live, cap - ent_c, -1.0)

        # treelet-major (dead last), then octant, then entry-point morton
        op = o + d * ent_c[:, None]
        q = torch.clamp((op - root_lo) / ext, 0.0, 1.0)
        mor = morton3d(q) >> (30 - mbits)
        if dk is not None:
            mor = (mor << dir_bits) | dk     # 19 bits in all
        skey = torch.where(live, torch.where(slot_r < 0, S, slot_r), S + 1)
        key = (skey << 22) | (octant << 19) | mor
        if npad > n:
            key = torch.cat([key, torch.full((npad - n,), (S + 1) << 22,
                                             dtype=key.dtype, device=dev)])
        key_s, perm = torch.sort(key, stable=True)
        skey_s = key_s >> 22

        tbl8 = torch.stack([o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1],
                            d[:, 2], ent_c, mtp], dim=1)
        if npad > n:
            pad_row = torch.tensor([0, 0, 0, 1, 1, 1, 0, -1],
                                   dtype=torch.float32, device=dev)
            tbl8 = torch.cat([tbl8, pad_row.expand(npad - n, 8)], dim=0)
        g8 = tbl8[perm]
        op_k = g8[:, 0:3] + g8[:, 3:6] * g8[:, 6:7]

        split, rootA, rootB = _two_pass_tile_meta(
            skey_s, troots, S, n_tiles, chunk, lca_steps, npad)
        rays = _pack_rays(op_k, g8[:, 3:6], g8[:, 7], npad, npad,
                          pad_maxt=-1.0)
        t_t, prim_t, u_t, v_t = cluster_traverse(
            rays, cbvh.nodes, cbvh.tris, cbvh.num_clusters,
            cbvh.cluster_size, tile_lanes=chunk, any_hit=any_hit,
            tile_roots=torch.stack([rootA, rootB]).contiguous(),
            tile_splits=split.contiguous(),
            **_tree_kw(cbvh, fanout, half_skip))

        # un-sort: lane i of the sorted layout is pair perm[i]
        def unsort(x):
            out = torch.empty_like(x)
            out[perm] = x
            return out[:n]

        t_o, p_o = unsort(t_t), unsort(prim_t)
        hit_r = live & (p_o >= 0.0)
        tg = ent_c + t_o
        upd = hit_r & (tg < bt)
        bt = torch.where(upd, tg, bt)
        bp = torch.where(upd, p_o, bp)
        if not any_hit:
            bu = torch.where(upd, unsort(u_t), bu)
            bv = torch.where(upd, unsort(v_t), bv)
    return torch.stack([bt, bp, bu, bv], dim=1)


def binned_closest_hit(ray: Ray, cbvh, mesh, max_t=FLT_MAX, m: int = BIN_M,
                       fanout: int = 2, half_skip: bool = False,
                       dir_bits: int = 0) -> HitRecord:
    """Closest hit via treelet binning."""
    if cbvh.treelet_size <= 0:
        raise ValueError("binned traversal needs a treelet-built ClusterBVH")
    outs = _traced(lambda: _binned_trace(ray, cbvh, max_t, m, False, fanout,
                                         half_skip, dir_bits))
    return _closest_record(outs, ray, mesh)


def binned_any_hit(ray: Ray, cbvh, mesh, max_t, m: int = BIN_M,
                   fanout: int = 2, half_skip: bool = False,
                   dir_bits: int = 0) -> HitRecord:
    """Occlusion query via treelet binning (any pair hit occludes)."""
    if cbvh.treelet_size <= 0:
        raise ValueError("binned traversal needs a treelet-built ClusterBVH")
    outs = _traced(lambda: _binned_trace(ray, cbvh, max_t, m, True, fanout,
                                         half_skip, dir_bits))
    return _any_record(outs, ray, mesh)

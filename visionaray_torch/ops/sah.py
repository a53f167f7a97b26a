"""Host-side binned-SAH and SBVH builders (port of ops/sah.py): ctypes over
the repo's ``native/sah_builder.cpp``, emitting the flat ``BVH`` of
ops/lbvh.py, so the LBVH tier's traversal walks any of the three builds.

The C++ source is shared with the JAX package and read as it is; its
library is compiled with g++ at first use into
``build/visionaray_torch/sah/<source hash>/`` (never into ``native/``,
where the JAX loader keeps its own), written to a temporary file and moved
into place, so concurrent test workers cannot clobber each other.  A
failed build raises; nothing falls back to the LBVH.  ``build`` dispatches
like the reference's build<BVH>() entry: "lbvh", "sah" or "sbvh".
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np
import torch

from visionaray_torch.ops.lbvh import BVH, build_lbvh, triangle_aabbs

_REPO = Path(__file__).resolve().parents[2]
SOURCE = _REPO / "native" / "sah_builder.cpp"
GXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]
_BUILD_ROOT = _REPO / "build" / "visionaray_torch" / "sah"
_LIB = None


def library_path() -> Path:
    """Where the library of the current source and flags lives."""
    digest = hashlib.sha256(" ".join(GXX_FLAGS).encode()
                            + SOURCE.read_bytes()).hexdigest()[:16]
    return _BUILD_ROOT / digest / "libsah_builder.so"


def _load():
    global _LIB
    if _LIB is not None:
        return _LIB
    so = library_path()
    if not so.exists():
        so.parent.mkdir(parents=True, exist_ok=True)
        tmp = so.parent / f"libsah_builder.{os.getpid()}.tmp.so"
        out = subprocess.run(["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                             capture_output=True, text=True)
        if out.returncode != 0:
            raise RuntimeError(f"g++ failed on {SOURCE}:\n{out.stderr}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int32)
    lib.vsnray_tpu_build_sah.restype = ctypes.c_int
    lib.vsnray_tpu_build_sah.argtypes = [fp, fp, ctypes.c_int, fp, fp, ip,
                                         ip, ip, ip]
    lib.vsnray_tpu_build_sbvh.restype = ctypes.c_int
    lib.vsnray_tpu_build_sbvh.argtypes = [
        fp, fp, fp, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, fp, fp, ip, ip, ip, ip, ip, ip, ip]
    _LIB = lib
    return lib


def available() -> bool:
    """True when the native library builds (or is built) and loads."""
    try:
        _load()
        return True
    except (OSError, RuntimeError):
        return False


def _host(x):
    return np.ascontiguousarray(
        x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
        else np.asarray(x), dtype=np.float32)


def _ptr(a, kind):
    return a.ctypes.data_as(ctypes.POINTER(kind))


def _to(device, **arrays):
    return {k: None if v is None else torch.as_tensor(v, device=device)
            for k, v in arrays.items()}


def build_sah_from_aabbs(prim_lo, prim_hi, device=None) -> BVH:
    """Binned-SAH BVH with 1:1 leaves over primitive AABBs, built on the
    host; the tables go to ``device`` (default: the AABBs' device)."""
    lib = _load()
    if device is None:
        device = prim_lo.device if isinstance(prim_lo, torch.Tensor) \
            else "cpu"
    lo, hi = _host(prim_lo), _host(prim_hi)
    n = lo.shape[0]
    node_lo = np.empty((2 * n - 1, 3), np.float32)
    node_hi = np.empty((2 * n - 1, 3), np.float32)
    left = np.empty((max(n - 1, 1),), np.int32)
    right = np.empty((max(n - 1, 1),), np.int32)
    parent = np.empty((2 * n - 1,), np.int32)
    prim_ids = np.empty((n,), np.int32)
    fp, ip = ctypes.c_float, ctypes.c_int32
    rc = lib.vsnray_tpu_build_sah(
        _ptr(lo, fp), _ptr(hi, fp), n, _ptr(node_lo, fp), _ptr(node_hi, fp),
        _ptr(left, ip), _ptr(right, ip), _ptr(parent, ip),
        _ptr(prim_ids, ip))
    if rc != 0:
        raise RuntimeError(f"SAH builder failed: {rc}")
    return BVH(**_to(device, node_lo=node_lo, node_hi=node_hi,
                     left=left[: n - 1], right=right[: n - 1], parent=parent,
                     prim_ids=prim_ids))


def build_sah(mesh) -> BVH:
    """SAH BVH over a TriangleMesh (built on the host, tables on the mesh's
    device)."""
    v1, e1, e2 = mesh.corners()
    lo, hi = triangle_aabbs(v1, e1, e2)
    return build_sah_from_aabbs(lo, hi)


def build_sbvh(mesh, alpha: float = 1e-5, max_leaf_size: int = 4) -> BVH:
    """Full-quality SBVH: binned SAH + spatial splits + multi-prim leaves
    (reference binned_sah_builder with use_spatial_splits, gate alpha *
    SA(root), max_leaf_size 4).  Triangles straddling a chosen spatial
    plane are referenced from both children, so ``prim_ids`` may repeat
    ids.  Returns a generalized-leaf BVH on the mesh's device."""
    lib = _load()
    v1, e1, e2 = (_host(a) for a in mesh.corners())
    n = v1.shape[0]
    fp, ip = ctypes.c_float, ctypes.c_int32
    cap_leaves, cap_refs = max(2 * n, 8), max(2 * n, 8)
    for _ in range(3):
        node_lo = np.empty((2 * cap_leaves - 1, 3), np.float32)
        node_hi = np.empty((2 * cap_leaves - 1, 3), np.float32)
        left = np.empty((max(cap_leaves - 1, 1),), np.int32)
        right = np.empty((max(cap_leaves - 1, 1),), np.int32)
        parent = np.empty((2 * cap_leaves - 1,), np.int32)
        leaf_first = np.empty((cap_leaves,), np.int32)
        leaf_count = np.empty((cap_leaves,), np.int32)
        prim_refs = np.empty((cap_refs,), np.int32)
        counts = np.zeros((2,), np.int32)
        rc = lib.vsnray_tpu_build_sbvh(
            _ptr(v1, fp), _ptr(e1, fp), _ptr(e2, fp), n,
            ctypes.c_float(alpha), max_leaf_size, cap_leaves, cap_refs,
            _ptr(node_lo, fp), _ptr(node_hi, fp), _ptr(left, ip),
            _ptr(right, ip), _ptr(parent, ip), _ptr(leaf_first, ip),
            _ptr(leaf_count, ip), _ptr(prim_refs, ip), _ptr(counts, ip))
        if rc == 0:
            break
        if rc != 1:
            raise RuntimeError(f"SBVH builder failed: {rc}")
        cap_leaves = int(counts[0]) + 8
        cap_refs = int(counts[1]) + 8
    else:
        raise RuntimeError("SBVH capacity retry loop did not converge")
    L, R = int(counts[0]), int(counts[1])
    return BVH(**_to(mesh.vertices.device,
                     node_lo=node_lo[: 2 * L - 1],
                     node_hi=node_hi[: 2 * L - 1],
                     left=left[: max(L - 1, 0)], right=right[: max(L - 1, 0)],
                     parent=parent[: 2 * L - 1], prim_ids=prim_refs[:R],
                     leaf_first=leaf_first[:L], leaf_count=leaf_count[:L]),
               max_leaf_size=int(max_leaf_size))


def build(mesh, builder: str = "lbvh") -> BVH:
    """Builder dispatch: "lbvh" (on the mesh's device), "sah" or "sbvh"
    (host, native)."""
    if builder == "sah":
        return build_sah(mesh)
    if builder == "sbvh":
        return build_sbvh(mesh)
    if builder == "lbvh":
        return build_lbvh(mesh)
    raise ValueError(f"build: builder must be 'lbvh', 'sah' or 'sbvh', got "
                     f"{builder!r}")

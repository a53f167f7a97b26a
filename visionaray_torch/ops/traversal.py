"""BVH traversal, the LBVH tier (port of ops/traversal.py): a per-ray
stack walk over the flat ``BVH`` of ops/lbvh.py (LBVH, native SAH, SBVH
and sphere LBVHs), its hand-written CUDA kernel and its plain PyTorch
version.

The search runs through ``bvh_traverse``:

- on CUDA tensors it launches ``vsnray_traverse_lbvh``
  (``ops/cuda/traverse_lbvh.cu``, built into the traversal library of
  ops/traverse.py) and adds one to ``LAUNCHES[mode]``,
  ``ENTRY_LAUNCHES["vsnray_traverse_lbvh"]`` and
  ``VARIANT_LAUNCHES["<mode>/leaves_<form>"]``;
- on CPU tensors it runs ``traverse_bvh_plain``, the lockstep masked form
  of the JAX package's vmapped ``_traverse_one`` / ``_traverse_one_multi``.

Both walk one node per step, as JAX does: at an internal node both
children get the slab test ``hit & tnear < best_t & tfar >= 0``; when both
pass, the near one (the left iff ``tn_left < tn_right``) is taken and the
far one pushed; the stack pops LIFO.  Leaves test their primitive (1:1) or
their ``leaf_count`` references (generalized leaves) with the strict
``0 <= t < best_t``.  Any-hit stops after the first leaf that holds an
accepted hit; multi-hit inserts into a t-sorted k-array (JAX's stable
``pos = sum(t >= ts)``) and culls against its last entry.  ``1/d`` is not
clamped and min/max propagate NaN, as in JAX's jnp tier: a zero direction
component on a box plane gives a NaN entry, and the box is missed.

Contract, per lane: ``(best_t, best_ref)``, best_t = max_t and best_ref =
-1 on a miss; best_ref indexes ``prim_ids``.  Multi-hit: ``(ts, refs)``
each (n, k), unused slots max_t / -1.  Lanes with max_t <= 0 can accept no
hit and retire at once.

Gradients: the search runs without autograd (through
``ops/traverse.py::_traced``, so a checkpointed bounce replays it and
launches nothing in backward); t, u, v are then recomputed differentiably
at the winning primitive, as JAX does.
"""

from __future__ import annotations

import weakref

import torch

import visionaray_torch.ops.traverse as trav
from visionaray_torch.core.types import FLT_MAX, HitRecord, Ray
from visionaray_torch.device import take
from visionaray_torch.ops.intersect import (
    intersect_aabb, intersect_sphere, intersect_triangle,
)
from visionaray_torch.ops.lbvh import BVH, build_lbvh_from_aabbs
from visionaray_torch.ops.trace import _closest_filtered, _recompute_hits

STACK_DEPTH = 64      # JAX STACK_DEPTH: entries of the per-lane stack
MODES = ("closest", "any", "multi")
PRIMS = ("triangle", "sphere")
ENTRY = "vsnray_traverse_lbvh"
_CHECK_EVERY = 16     # plain version: lockstep steps between compactions


def launch_key(prim: str, mode: str) -> str:
    """The LAUNCHES key of one launch: ``lbvh_<mode>`` over triangles,
    ``sphere_<mode>`` over spheres."""
    return ("lbvh_" if prim == "triangle" else "sphere_") + mode


def leaf_variant_key(key: str, generalized: bool) -> str:
    """The VARIANT_LAUNCHES key naming the leaf form of one launch."""
    return f"{key}/leaves_{'generalized' if generalized else '1to1'}"


# id(object) -> (weak reference, cache): what this module keeps for a BVH
# (its kernel pack) or a geometry (its primitive tables) while it lives
_CACHES: dict = {}


def _cache_of(obj) -> dict:
    """The cache dict kept for ``obj``, dropped when ``obj`` dies."""
    oid = id(obj)
    entry = _CACHES.get(oid)
    if entry is not None and entry[0]() is obj:
        return entry[1]
    cache = {}
    _CACHES[oid] = (weakref.ref(obj, lambda _, oid=oid: _CACHES.pop(oid,
                                                                    None)),
                    cache)
    return cache


def _version(t):
    """A tensor's in-place write count; None for no tensor and for an
    inference tensor, which keeps none (render's inference_mode makes
    them; one can be written in place only inside that mode, and the port
    writes none of its tables there)."""
    return None if t is None or t.is_inference() else t._version


def _key(tensors):
    return tuple((t, _version(t)) for t in tensors)


def _held(key, tensors) -> bool:
    """Whether ``key`` (from _key) still names ``tensors`` as they are: the
    same objects, none written in place since."""
    return len(key) == len(tensors) and all(
        k is t and v == _version(t) for (k, v), t in zip(key, tensors))


def prim_tables(prim: str, geom):
    """The kernel's primitive tables of a TriangleMesh (v1, e1, e2) or a
    Spheres group (center, radius), detached and contiguous f32 (a
    triangle group is anything with ``corners()``).  Kept with ``geom``
    while its tensor fields are the same tensors, unwritten, so that every
    query of a frame hands the kernel the same tables and ``kernel_pack``
    reuses their pack."""
    src = tuple(v for v in vars(geom).values() if isinstance(v, torch.Tensor))
    cache = _cache_of(geom)
    if cache.get("prim") == prim and _held(cache["key"], src):
        return cache["tables"]
    arrs = geom.corners() if prim == "triangle" else (geom.center,
                                                       geom.radius)
    tables = tuple(a.detach().to(torch.float32).contiguous() for a in arrs)
    cache.update(prim=prim, key=_key(src), tables=tables)
    return tables


def leaf_bits(bvh: BVH) -> int:
    """The bits a generalized leaf's code gives its count: enough for
    ``max_leaf_size``; 0 on 1:1 leaves, whose code is the leaf slot."""
    if bvh.leaf_first is None:
        return 0
    return max(int(bvh.max_leaf_size), 0).bit_length()


def pack_nodes(bvh: BVH):
    """The kernel's node records: (L - 1, 16) f32, internal node i as
    four float4s, (lo.x, hi.x, lo.y, hi.y) of its left child, the same of
    its right child, (lo.z, hi.z) of the left then of the right, and the
    two children's codes (int32 bits) and two zero words.  A child's code
    is its node index when it is internal, else ``~leaf``: on 1:1 leaves
    ``leaf`` is the leaf slot (its reference), on generalized leaves
    ``(leaf_first << leaf_bits) | min(leaf_count, max_leaf_size)``.
    Returns (records, root code)."""
    L = bvh.num_leaves
    base = L - 1
    dev = bvh.node_lo.device
    bits = leaf_bits(bvh)
    if bvh.leaf_first is not None:
        first = bvh.leaf_first.to(torch.int64)
        count = torch.clamp(bvh.leaf_count.to(torch.int64), 0,
                            max(int(bvh.max_leaf_size), 0))
        if L and int(first.max()) >= 1 << (31 - bits):
            raise ValueError(f"pack_nodes: leaf_first up to "
                             f"{int(first.max())} does not fit a leaf code "
                             f"beside {bits} count bits")
        leaf_code = ~((first << bits) | count)
    else:
        leaf_code = ~torch.arange(L, dtype=torch.int64, device=dev)
    root = 0 if base > 0 else int(leaf_code[0])
    if base == 0:
        return torch.zeros((0, 16), dtype=torch.float32, device=dev), root
    lc = bvh.left.to(torch.int64)
    rc = bvh.right.to(torch.int64)

    def code(c):
        return torch.where(c < base, c,
                           leaf_code[torch.clamp_min(c - base, 0)])

    lo, hi = bvh.node_lo, bvh.node_hi
    boxes = torch.stack([lo[lc, 0], hi[lc, 0], lo[lc, 1], hi[lc, 1],
                         lo[rc, 0], hi[rc, 0], lo[rc, 1], hi[rc, 1],
                         lo[lc, 2], hi[lc, 2], lo[rc, 2], hi[rc, 2]], dim=1)
    zero = torch.zeros_like(lc)
    codes = torch.stack([code(lc), code(rc), zero, zero], dim=1)
    codes = codes.to(torch.int32).view(torch.float32)
    return torch.cat([boxes.to(torch.float32), codes], dim=1).contiguous(), \
        root


def pack_prims(bvh: BVH, prim: str, tables):
    """The kernel's primitive records in reference order (record r is
    primitive ``prim_ids[r]``): triangles (R, 3, 4) f32, rows v1, e1, e2
    with a zero w; spheres (R, 4) f32, (centre, radius)."""
    pid = bvh.prim_ids.to(torch.int64)
    if prim == "triangle":
        rows = torch.stack([x[pid] for x in tables], dim=1)
        return torch.cat([rows, torch.zeros_like(rows[..., :1])],
                         dim=2).contiguous()
    center, radius = tables
    return torch.cat([center[pid], radius[pid, None]], dim=1).contiguous()


def kernel_pack(bvh: BVH, prim: str, tables):
    """The packed nodes (with their root code) and primitives of ``bvh``
    and ``tables`` for the kernel, built on their device at first use and
    kept on the BVH: a later query reuses them while the BVH's tables (and
    for the primitives, ``tables``) are the same tensors, unwritten (their
    ``_version``).  A rebuilt or refitted tree (new tensors, or tensors
    written in place) gets a new pack."""
    cache = _cache_of(bvh)
    node_src = (bvh.node_lo, bvh.node_hi, bvh.left, bvh.right,
                bvh.leaf_first, bvh.leaf_count)
    if not _held(cache.get("node_key", ()), node_src):
        cache.clear()
        cache["nodes"], cache["root"] = pack_nodes(bvh)
        cache["node_key"] = _key(node_src)
    prim_src = (bvh.prim_ids, *tables)
    if cache.get("prim") != prim or not _held(cache.get("prim_key", ()),
                                              prim_src):
        cache["prims"] = pack_prims(bvh, prim, tables)
        cache["prim"], cache["prim_key"] = prim, _key(prim_src)
    return cache["nodes"], cache["root"], cache["prims"]


def _check(o, d, max_t, bvh: BVH, prim: str, tables, mode: str, k: int):
    if prim not in PRIMS or mode not in MODES:
        raise ValueError(f"bvh_traverse: prim must be one of {PRIMS} and "
                         f"mode one of {MODES}, got {prim!r}, {mode!r}")
    n = o.shape[0]
    dev = o.device
    gen = bvh.leaf_first is not None
    if mode == "multi":
        if prim != "triangle" or gen:
            raise ValueError("bvh_traverse: multi-hit takes triangles on a "
                             "1:1-leaf BVH (lbvh/sah); SBVH spatial splits "
                             "would record duplicated references")
        if k < 1:
            raise ValueError(f"bvh_traverse: k must be >= 1, got {k}")
    want = [("ori", o, (n, 3), torch.float32),
            ("dir", d, (n, 3), torch.float32),
            ("max_t", max_t, (n,), torch.float32),
            ("node_lo", bvh.node_lo, (bvh.num_nodes, 3), torch.float32),
            ("node_hi", bvh.node_hi, (bvh.num_nodes, 3), torch.float32),
            ("left", bvh.left, (bvh.num_leaves - 1,), torch.int32),
            ("right", bvh.right, (bvh.num_leaves - 1,), torch.int32),
            ("prim_ids", bvh.prim_ids, (bvh.num_prims,), torch.int32)]
    if gen:
        want += [("leaf_first", bvh.leaf_first, (bvh.num_leaves,),
                  torch.int32),
                 ("leaf_count", bvh.leaf_count, (bvh.num_leaves,),
                  torch.int32)]
    if prim == "triangle":
        nt = tables[0].shape[0]
        want += [(nm, x, (nt, 3), torch.float32)
                 for nm, x in zip(("v1", "e1", "e2"), tables)]
    else:
        ns = tables[0].shape[0]
        want += [("center", tables[0], (ns, 3), torch.float32),
                 ("radius", tables[1], (ns,), torch.float32)]
    for name, x, shape, dtype in want:
        if tuple(x.shape) != shape or x.dtype != dtype:
            raise ValueError(f"bvh_traverse: {name} must be {dtype} {shape}, "
                             f"got {x.dtype} {tuple(x.shape)}")
        if x.device != dev:
            raise ValueError(f"bvh_traverse: {name} is on {x.device}, rays "
                             f"on {dev}")
        if not x.is_contiguous():
            raise ValueError(f"bvh_traverse: {name} must be contiguous")
    # JAX clips its stack index at STACK_DEPTH - 1 and would silently lose
    # nodes; a walk holds at most one entry per level, so refuse deeper
    # trees (a Karras tree has depth <= 63; a SAH/SBVH tree has no bound)
    if bvh.depth > STACK_DEPTH:
        raise ValueError(f"bvh_traverse: a tree of depth {bvh.depth} needs "
                         f"more than the {STACK_DEPTH}-entry traversal stack")


def bvh_traverse(o, d, max_t, bvh: BVH, prim: str, tables, mode: str,
                 k: int = 1, counters=None):
    """The search of one batch of lanes: ``o``, ``d`` (n, 3), ``max_t``
    (n,) f32; ``tables`` from ``prim_tables``.  Returns (best_t (n,) f32,
    best_ref (n,) i32), or for ``mode="multi"`` (ts, refs) each (n, k).
    ``counters``: optional (n, 2) i32 tensor the kernel fills with per-lane
    box tests and primitive tests.  CUDA tensors launch the kernel; CPU
    tensors run ``traverse_bvh_plain``."""
    _check(o, d, max_t, bvh, prim, tables, mode, k)
    if o.device.type == "cpu":
        return traverse_bvh_plain(o, d, max_t, bvh, prim, tables, mode, k)
    if o.device.type != "cuda":
        raise ValueError(f"bvh_traverse: no kernel for {o.device}")
    if counters is not None and (tuple(counters.shape) != (o.shape[0], 2)
                                 or counters.dtype != torch.int32
                                 or counters.device != o.device
                                 or not counters.is_contiguous()):
        raise ValueError("bvh_traverse: counters must be contiguous int32 "
                         "(n, 2) on the rays' device")
    with torch.cuda.device(o.device):
        stream = torch.cuda.current_stream(o.device).cuda_stream
        out_t, out_ref = launch(trav._library(), o, d, max_t, bvh, prim,
                                tables, mode, k, counters, stream)
    if o.shape[0] == 0:
        return out_t, out_ref
    gen = bvh.leaf_first is not None
    key = launch_key(prim, mode)
    trav.LAUNCHES[key] += 1
    trav.ENTRY_LAUNCHES[ENTRY] += 1
    vkey = leaf_variant_key(key, gen)
    trav.VARIANT_LAUNCHES[vkey] = trav.VARIANT_LAUNCHES.get(vkey, 0) + 1
    return out_t, out_ref


def launch(lib, o, d, max_t, bvh: BVH, prim: str, tables, mode: str, k: int,
           counters, stream):
    """Allocate the outputs and call ``lib.vsnray_traverse_lbvh`` on the
    inputs ``bvh_traverse`` has checked, with ``kernel_pack``'s records;
    raises on a launch error."""
    n = o.shape[0]
    shape = (n, k) if mode == "multi" else (n,)
    out_t = torch.empty(shape, dtype=torch.float32, device=o.device)
    out_ref = torch.empty(shape, dtype=torch.int32, device=o.device)
    if n == 0:
        return out_t, out_ref
    nodes, root, prims = kernel_pack(bvh, prim, tables)
    args = [o.data_ptr(), d.data_ptr(), max_t.data_ptr(),
            nodes.data_ptr() if nodes.numel() else None, prims.data_ptr(),
            out_t.data_ptr(), out_ref.data_ptr(),
            None if counters is None else counters.data_ptr(), n,
            bvh.num_prims, leaf_bits(bvh), root, int(k), PRIMS.index(prim),
            MODES.index(mode), int(bvh.leaf_first is not None)]
    err = lib.vsnray_traverse_lbvh(*args, stream)
    if err != 0:
        raise RuntimeError(f"{ENTRY} launch failed: cudaError {err}")
    return out_t, out_ref


def _prim_test(prim, tables, o, d, pid):
    """(t, hit) of lanes o, d against primitives ``pid``."""
    if prim == "triangle":
        v1, e1, e2 = tables
        t, _, _, hit = intersect_triangle(o, d, take(v1, pid), take(e1, pid),
                                          take(e2, pid))
        return t, hit
    center, radius = tables
    return intersect_sphere(o, d, take(center, pid), take(radius, pid))


def traverse_bvh_plain(o, d, max_t, bvh: BVH, prim: str, tables, mode: str,
                       k: int = 1):
    """The kernel's contract in plain PyTorch: JAX's per-ray walk run in
    lockstep over the live lanes with per-lane masks (a lane that is done
    keeps its state), one node per step.  Every _CHECK_EVERY steps the
    lanes that are done are written out and dropped (one host sync)."""
    _check(o, d, max_t, bvh, prim, tables, mode, k)
    n = o.shape[0]
    dev = o.device
    multi = mode == "multi"
    gen = bvh.leaf_first is not None
    leaf_base = bvh.num_leaves - 1
    n_refs = bvh.num_prims
    prim_ids = bvh.prim_ids.to(torch.int64)
    left = bvh.left.to(torch.int64)
    right = bvh.right.to(torch.int64)
    if gen:
        leaf_first = bvh.leaf_first.to(torch.int64)
        leaf_count = bvh.leaf_count.to(torch.int64)
    shape = (n, k) if multi else (n,)
    out_t = (max_t[:, None] if multi else max_t).expand(shape).clone()
    out_ref = torch.full(shape, -1, dtype=torch.int64, device=dev)

    lanes = torch.nonzero(max_t > 0.0).reshape(-1)
    o, d = o[lanes], d[lanes]
    inv = 1.0 / d
    A = lanes.numel()
    node = torch.full((A,), 0 if leaf_base > 0 else leaf_base,
                      dtype=torch.int64, device=dev)
    sp = torch.zeros((A,), dtype=torch.int64, device=dev)
    stack = torch.zeros((A, STACK_DEPTH), dtype=torch.int64, device=dev)
    bt = (max_t[lanes][:, None].expand(A, k) if multi
          else max_t[lanes]).clone()
    br = torch.full(bt.shape, -1, dtype=torch.int64, device=dev)
    done = torch.zeros((A,), dtype=torch.bool, device=dev)
    idx_k = torch.arange(k, device=dev)

    def leaf_refs(slot):
        if not gen:
            yield slot, None
            return
        first = take(leaf_first, slot)
        cnt = torch.clamp_max(take(leaf_count, slot), bvh.max_leaf_size)
        for j in range(bvh.max_leaf_size):
            yield torch.clamp_max(first + j, n_refs - 1), j < cnt

    def step(node, sp, stack, bt, br, done):
        live = ~done
        is_leaf = node >= leaf_base
        slot = torch.clamp_min(node - leaf_base, 0)
        for ref, valid in leaf_refs(slot):
            t, hit = _prim_test(prim, tables, o, d, take(prim_ids, ref))
            ok = live & is_leaf & hit & (t >= 0.0)
            if valid is not None:
                ok = ok & valid
            if multi:
                ok = ok & (t < bt[:, k - 1])
                pos = (t[:, None] >= bt).sum(dim=1)
                take_it = (ok & (pos < k))[:, None]
                t_sh = torch.cat([bt[:, :1], bt[:, :-1]], dim=1)
                r_sh = torch.cat([br[:, :1], br[:, :-1]], dim=1)
                before = idx_k[None, :] < pos[:, None]
                at = idx_k[None, :] == pos[:, None]
                bt = torch.where(take_it, torch.where(
                    before, bt, torch.where(at, t[:, None], t_sh)), bt)
                br = torch.where(take_it, torch.where(
                    before, br, torch.where(at, ref[:, None], r_sh)), br)
            else:
                ok = ok & (t < bt)
                bt = torch.where(ok, t, bt)
                br = torch.where(ok, ref, br)
        if mode == "any":
            found = live & (br >= 0)
        else:
            found = torch.zeros_like(done)
        if leaf_base > 0:
            ni = torch.clamp_max(node, leaf_base - 1)
            lc, rc = take(left, ni), take(right, ni)
            tn1, tf1, h1 = intersect_aabb(o, inv, take(bvh.node_lo, lc),
                                          take(bvh.node_hi, lc))
            tn2, tf2, h2 = intersect_aabb(o, inv, take(bvh.node_lo, rc),
                                          take(bvh.node_hi, rc))
            bound = bt[:, k - 1] if multi else bt
            b1 = ~is_leaf & h1 & (tn1 < bound) & (tf1 >= 0.0)
            b2 = ~is_leaf & h2 & (tn2 < bound) & (tf2 >= 0.0)
            both = b1 & b2
            near_l = tn1 < tn2
            near = torch.where(near_l, lc, rc)
            far = torch.where(near_l, rc, lc)
            pos = torch.clamp_max(sp, STACK_DEPTH - 1)[:, None]
            cur = stack.gather(1, pos)[:, 0]
            stack = stack.scatter(1, pos, torch.where(live & both, far,
                                                      cur)[:, None])
            sp1 = torch.where(both, torch.clamp_max(sp + 1, STACK_DEPTH), sp)
            nxt = torch.where(both, near, torch.where(
                b1, lc, torch.where(b2, rc, -1)))
        else:
            sp1 = sp
            nxt = torch.full_like(node, -1)
        need_pop = is_leaf | (nxt < 0)
        can_pop = sp1 > 0
        popped = stack.gather(1, torch.clamp_min(sp1 - 1, 0)[:, None])[:, 0]
        new_node = torch.where(need_pop, torch.where(can_pop, popped, 0), nxt)
        new_sp = torch.where(need_pop & can_pop, sp1 - 1, sp1)
        node = torch.where(live, new_node, node)
        sp = torch.where(live, new_sp, sp)
        done = done | (live & need_pop & ~can_pop) | found
        return node, sp, stack, bt, br, done

    while A > 0:
        for _ in range(_CHECK_EVERY):
            node, sp, stack, bt, br, done = step(node, sp, stack, bt, br,
                                                 done)
        fin = torch.nonzero(done).reshape(-1)
        if fin.numel():
            out_t.index_copy_(0, lanes[fin], bt[fin])
            out_ref.index_copy_(0, lanes[fin], br[fin])
            keep = torch.nonzero(~done).reshape(-1)
            lanes, o, d, inv = lanes[keep], o[keep], d[keep], inv[keep]
            node, sp, stack = node[keep], sp[keep], stack[keep]
            bt, br, done = bt[keep], br[keep], done[keep]
            A = lanes.numel()
    return out_t, out_ref.to(torch.int32)


# ---------------------------------------------------------------------------
# Front ends (JAX bvh_closest_hit, bvh_any_hit, bvh_multi_hit, the sphere
# BVH): the detached search, then the record.


def _flat(ray: Ray, max_t):
    o = ray.ori.detach().reshape(-1, 3).to(torch.float32).contiguous()
    d = ray.dir.detach().reshape(-1, 3).to(torch.float32).contiguous()
    mt = torch.as_tensor(max_t, dtype=torch.float32, device=o.device)
    mt = mt.detach().expand(ray.batch_shape).reshape(-1).contiguous()
    return o, d, mt


def _search(ray: Ray, bvh: BVH, prim: str, geom, max_t, mode: str,
            k: int = 1):
    """The traced search: (best_t, best_ref) or (ts, refs), each with the
    ray's batch shape (and a trailing k)."""
    def run():
        o, d, mt = _flat(ray, max_t)
        t, ref = bvh_traverse(o, d, mt, bvh, prim, prim_tables(prim, geom),
                              mode, k)
        tail = (k,) if mode == "multi" else ()
        bs = ray.batch_shape + tail
        return t.reshape(bs), ref.reshape(bs)

    return trav._traced(run)


def bvh_closest_hit(ray: Ray, bvh: BVH, mesh, max_t=FLT_MAX,
                    hit_filter=None) -> HitRecord:
    """Closest triangle hit through the BVH, differentiable by recompute.
    ``max_t`` seeds the search's best t (lanes with max_t <= 0 retire at
    once).  ``hit_filter``: the closest surviving hit, by re-tracing past
    each rejected winner (ops/trace.py ``_filtered_search``)."""
    if hit_filter is not None:
        return _closest_filtered(
            ray, lambda r, mt: bvh_closest_hit(r, bvh, mesh, mt), mesh,
            hit_filter, max_t)
    _, ref = _search(ray, bvh, "triangle", mesh, max_t, "closest")
    hit = ref >= 0
    pid = take(bvh.prim_ids, torch.clamp_min(ref, 0))
    t, u, v, pid, gid = _recompute_hits(ray.ori, ray.dir, mesh, hit, pid)
    return HitRecord(hit=hit, t=t, prim_id=pid, geom_id=gid, u=u, v=v)


def bvh_any_hit(ray: Ray, bvh: BVH, mesh, max_t) -> HitRecord:
    """Occlusion query with early exit: the first leaf in traversal order
    holding a hit in [0, max_t) answers it (t from the search, u = v = 0)."""
    best_t, ref = _search(ray, bvh, "triangle", mesh, max_t, "any")
    hit = ref >= 0
    pid = torch.where(hit, take(bvh.prim_ids, torch.clamp_min(ref, 0)), 0)
    return HitRecord(hit=hit, t=torch.where(hit, best_t, FLT_MAX),
                     prim_id=pid, geom_id=take(mesh.geom_ids, pid),
                     u=torch.zeros_like(best_t), v=torch.zeros_like(best_t))


def bvh_multi_hit(ray: Ray, bvh: BVH, mesh, k: int,
                  max_t=FLT_MAX) -> HitRecord:
    """The k nearest triangle hits through the BVH, sorted by t; fields
    carry a trailing k axis, unused slots hit=False, t=FLT_MAX.
    Differentiable by recompute at each recorded primitive."""
    _, refs = _search(ray, bvh, "triangle", mesh, max_t, "multi", k)
    hit = refs >= 0
    pid = take(bvh.prim_ids, torch.clamp_min(refs, 0))
    t, u, v, pid, gid = _recompute_hits(ray.ori[..., None, :],
                                       ray.dir[..., None, :], mesh, hit, pid)
    return HitRecord(hit=hit, t=t, prim_id=pid, geom_id=gid, u=u, v=v)


def build_sphere_bvh(spheres) -> BVH:
    """LBVH over a Spheres group (lo/hi = center -/+ radius)."""
    r = spheres.radius[:, None]
    return build_lbvh_from_aabbs(spheres.center - r, spheres.center + r)


def sphere_bvh_closest_hit(ray: Ray, bvh: BVH, spheres, max_t=FLT_MAX,
                           prim_offset: int = 0) -> HitRecord:
    """Closest sphere hit through the BVH, differentiable by recompute;
    ``prim_offset``: the global prim id of the group's first sphere."""
    _, ref = _search(ray, bvh, "sphere", spheres, max_t, "closest")
    hit = ref >= 0
    pid = torch.where(hit, take(bvh.prim_ids, torch.clamp_min(ref, 0)), 0)
    t, _ = intersect_sphere(ray.ori, ray.dir, take(spheres.center, pid),
                            take(spheres.radius, pid))
    t = torch.where(hit, t, FLT_MAX)
    return HitRecord(hit=hit, t=t,
                     prim_id=torch.where(hit, pid + prim_offset, 0).to(
                         torch.int32),
                     geom_id=take(spheres.geom_ids, pid),
                     u=torch.zeros_like(t), v=torch.zeros_like(t))


def sphere_bvh_any_hit(ray: Ray, bvh: BVH, spheres, max_t,
                       prim_offset: int = 0) -> HitRecord:
    """Sphere occlusion query through the BVH with early exit."""
    best_t, ref = _search(ray, bvh, "sphere", spheres, max_t, "any")
    hit = ref >= 0
    pid = torch.where(hit, take(bvh.prim_ids, torch.clamp_min(ref, 0)), 0)
    return HitRecord(hit=hit, t=torch.where(hit, best_t, FLT_MAX),
                     prim_id=torch.where(hit, pid + prim_offset, 0).to(
                         torch.int32),
                     geom_id=take(spheres.geom_ids, pid),
                     u=torch.zeros_like(best_t), v=torch.zeros_like(best_t))

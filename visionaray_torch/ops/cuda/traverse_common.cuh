// Device helpers shared by the two traversal kernels: traverse_binned.cu
// (the two-pass tiles of the treelet-binned path, radix trees, and every
// heap-tree form the coherent kernel does not take) and
// traverse_coherent.cu (coherent tiles on a heap tree).  The stack size,
// the slab test, the sorting networks, the triangle test and the one-lane
// while-while walk live here.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kStackDepth = 64;      // traverse.py STACK_DEPTH
constexpr float kInvClamp = 1e18f;   // traverse.py _INV_CLAMP
// Relative widening of each slab interval.  The slab test and the triangle
// test round differently; a triangle lying in a box face (the axis-aligned
// floors and walls of the sponza-class scene bound their boxes exactly)
// must not be culled by a last-ulp difference.  Widening only adds work.
constexpr float kSlabPad = 1e-6f;

struct RayData {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
};

__device__ __forceinline__ float clamp_inv(float d) {
  return fminf(fmaxf(1.0f / d, -kInvClamp), kInvClamp);
}

// Entry distance of the ray into the box [lo, hi], or +inf when the box is
// empty (padding: lo.x > hi.x), missed, behind the ray or beyond best_t.
__device__ __forceinline__ float box_entry(float lox, float loy, float loz,
                                           float hix, float hiy, float hiz,
                                           const RayData& r, float best_t) {
  if (lox > hix) return INFINITY;
  const float tx1 = (lox - r.ox) * r.ix, tx2 = (hix - r.ox) * r.ix;
  const float ty1 = (loy - r.oy) * r.iy, ty2 = (hiy - r.oy) * r.iy;
  const float tz1 = (loz - r.oz) * r.iz, tz2 = (hiz - r.oz) * r.iz;
  float tn = fmaxf(fmaxf(fminf(tx1, tx2), fminf(ty1, ty2)), fminf(tz1, tz2));
  float tf = fminf(fminf(fmaxf(tx1, tx2), fmaxf(ty1, ty2)), fmaxf(tz1, tz2));
  tn -= fabsf(tn) * kSlabPad;
  tf += fabsf(tf) * kSlabPad;
  return (tf >= tn && tf >= 0.0f && tn < best_t) ? tn : INFINITY;
}

// box_entry of node n's box (one float4 + one float2 load).
__device__ __forceinline__ float slab_entry(const float* __restrict__ nodes,
                                            int n, const RayData& r,
                                            float best_t) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(nodes + 8 * n));
  const float2 b = __ldg(reinterpret_cast<const float2*>(nodes + 8 * n + 4));
  // a = lo.x lo.y lo.z hi.x, b = hi.y hi.z
  return box_entry(a.x, a.y, a.z, a.w, b.x, b.y, r, best_t);
}

// One comparator of a sorting network: ascending by key, a strict > so
// equal keys keep their order (traverse.py:421-426).
__device__ __forceinline__ void cswap(float& ka, int& ia, float& kb,
                                      int& ib) {
  if (ka > kb) {
    const float tk = ka; ka = kb; kb = tk;
    const int ti = ia; ia = ib; ib = ti;
  }
}

// _SORT_NET[4] and _SORT_NET[8] (traverse.py:76-82), unrolled so that the
// keys and indices stay in registers.
template <int kN>
__device__ __forceinline__ void sort_net(float (&key)[kN], int (&idx)[kN]);

template <>
__device__ __forceinline__ void sort_net<4>(float (&key)[4], int (&idx)[4]) {
  cswap(key[0], idx[0], key[1], idx[1]);
  cswap(key[2], idx[2], key[3], idx[3]);
  cswap(key[0], idx[0], key[2], idx[2]);
  cswap(key[1], idx[1], key[3], idx[3]);
  cswap(key[1], idx[1], key[2], idx[2]);
}

template <>
__device__ __forceinline__ void sort_net<8>(float (&key)[8], int (&idx)[8]) {
  cswap(key[0], idx[0], key[1], idx[1]);
  cswap(key[2], idx[2], key[3], idx[3]);
  cswap(key[4], idx[4], key[5], idx[5]);
  cswap(key[6], idx[6], key[7], idx[7]);
  cswap(key[0], idx[0], key[2], idx[2]);
  cswap(key[1], idx[1], key[3], idx[3]);
  cswap(key[4], idx[4], key[6], idx[6]);
  cswap(key[5], idx[5], key[7], idx[7]);
  cswap(key[1], idx[1], key[2], idx[2]);
  cswap(key[5], idx[5], key[6], idx[6]);
  cswap(key[0], idx[0], key[4], idx[4]);
  cswap(key[1], idx[1], key[5], idx[5]);
  cswap(key[2], idx[2], key[6], idx[6]);
  cswap(key[3], idx[3], key[7], idx[7]);
  cswap(key[2], idx[2], key[4], idx[4]);
  cswap(key[3], idx[3], key[5], idx[5]);
  cswap(key[1], idx[1], key[2], idx[2]);
  cswap(key[3], idx[3], key[4], idx[4]);
  cswap(key[5], idx[5], key[6], idx[6]);
}

// Moeller-Trumbore of the ray against one triangle record, given as its
// first three float4 (v1x v1y v1z e1x | e1y e1z e2x e2y | e2z pid pad pad),
// folded into (bt, bp, bu, bv) with the strict t < bt: the records that
// traverse_coherent.cu stages in shared memory.  Returns true when it hit;
// an any-hit lane then stops and leaves u, v alone.  intersect_records
// below is the same arithmetic on records in global memory, written out:
// calling this function from it changed the two-pass kernel's SASS and
// cost 1b 2% (PERF.md §6).
template <bool kAnyHit>
__device__ __forceinline__ bool test_record(const float4& a, const float4& b,
                                            const float4& c, const RayData& r,
                                            float& bt, float& bp, float& bu,
                                            float& bv) {
  const float v1x = a.x, v1y = a.y, v1z = a.z;
  const float e1x = a.w, e1y = b.x, e1z = b.y;
  const float e2x = b.z, e2y = b.w, e2z = c.x;
  // operation order of traverse.py:258-274
  const float s1x = r.dy * e2z - r.dz * e2y;
  const float s1y = r.dz * e2x - r.dx * e2z;
  const float s1z = r.dx * e2y - r.dy * e2x;
  const float div = s1x * e1x + s1y * e1y + s1z * e1z;
  bool ok = div != 0.0f;
  const float inv_div = 1.0f / (ok ? div : 1.0f);
  const float ddx = r.ox - v1x;
  const float ddy = r.oy - v1y;
  const float ddz = r.oz - v1z;
  const float b1 = (ddx * s1x + ddy * s1y + ddz * s1z) * inv_div;
  ok = ok && (b1 >= 0.0f) && (b1 <= 1.0f);
  const float s2x = ddy * e1z - ddz * e1y;
  const float s2y = ddz * e1x - ddx * e1z;
  const float s2z = ddx * e1y - ddy * e1x;
  const float b2 = (r.dx * s2x + r.dy * s2y + r.dz * s2z) * inv_div;
  ok = ok && (b2 >= 0.0f) && (b1 + b2 <= 1.0f);
  const float t = (e2x * s2x + e2y * s2y + e2z * s2z) * inv_div;
  if (ok && t >= 0.0f && t < bt) {
    bt = t;
    bp = c.y;
    if (!kAnyHit) {
      bu = b1;
      bv = b2;
    }
    return true;
  }
  return false;
}

// Records [k0, k1) of one cluster against the ray, in order, folded into
// (bt, bp, bu, bv) with the strict t < bt.  Returns true when an any-hit
// lane found its hit (and stops there).  A one-loop kernel with the same
// code written inline, calling this function with a run-time cluster size
// instead, compiled to up to 32 more instructions and ran 12-15% slower in
// every binary-descent mode on an H100 (same registers).
template <bool kAnyHit, bool kCount>
__device__ __forceinline__ bool intersect_records(
    const float4* __restrict__ rec, int k0, int k1, const RayData& r,
    float& bt, float& bp, float& bu, float& bv, int& n_tri) {
  for (int k = k0; k < k1; ++k) {
    const float4 a = __ldg(rec + 4 * k);      // v1x v1y v1z e1x
    const float4 b = __ldg(rec + 4 * k + 1);  // e1y e1z e2x e2y
    const float4 c = __ldg(rec + 4 * k + 2);  // e2z pid pad pad
    if (kCount) ++n_tri;
    const float v1x = a.x, v1y = a.y, v1z = a.z;
    const float e1x = a.w, e1y = b.x, e1z = b.y;
    const float e2x = b.z, e2y = b.w, e2z = c.x;
    // operation order of traverse.py:258-274
    const float s1x = r.dy * e2z - r.dz * e2y;
    const float s1y = r.dz * e2x - r.dx * e2z;
    const float s1z = r.dx * e2y - r.dy * e2x;
    const float div = s1x * e1x + s1y * e1y + s1z * e1z;
    bool ok = div != 0.0f;
    const float inv_div = 1.0f / (ok ? div : 1.0f);
    const float ddx = r.ox - v1x;
    const float ddy = r.oy - v1y;
    const float ddz = r.oz - v1z;
    const float b1 = (ddx * s1x + ddy * s1y + ddz * s1z) * inv_div;
    ok = ok && (b1 >= 0.0f) && (b1 <= 1.0f);
    const float s2x = ddy * e1z - ddz * e1y;
    const float s2y = ddz * e1x - ddx * e1z;
    const float s2z = ddx * e1y - ddy * e1x;
    const float b2 = (r.dx * s2x + r.dy * s2y + r.dz * s2z) * inv_div;
    ok = ok && (b2 >= 0.0f) && (b1 + b2 <= 1.0f);
    const float t = (e2x * s2x + e2y * s2y + e2z * s2z) * inv_div;
    if (ok && t >= 0.0f && t < bt) {
      bt = t;
      bp = c.y;
      if (kAnyHit) return true;
      bu = b1;
      bv = b2;
    }
  }
  return false;
}

// Records [k0, k1) of one cluster against the ray: one record at a time,
// unrolled, when kK is a compile-time cluster size; one loop when kK is 0
// (run-time K).
template <bool kAnyHit, bool kCount, int kK>
__device__ __forceinline__ bool test_records(const float4* __restrict__ rec,
                                             int k0, int k1, const RayData& r,
                                             float& bt, float& bp, float& bu,
                                             float& bv, int& n_tri) {
  if constexpr (kK == 0) {
    return intersect_records<kAnyHit, kCount>(rec, k0, k1, r, bt, bp, bu, bv,
                                              n_tri);
  } else {
#pragma unroll
    for (int k = k0; k < k1; ++k)
      if (intersect_records<kAnyHit, kCount>(rec, k, k + 1, r, bt, bp, bu, bv,
                                             n_tri))
        return true;
    return false;
  }
}

// The K records of one cluster against the ray, in order k = 0..K-1; with
// the half skip each half's box (floats 10..15 of record h) is tested first
// and gates its K/2 records.  Returns true when an any-hit lane found its
// hit.
template <bool kAnyHit, bool kCount, bool kHalfSkip, int kK>
__device__ __forceinline__ bool test_cluster(const float4* __restrict__ rec,
                                             int K, const RayData& r,
                                             float& bt, float& bp, float& bu,
                                             float& bv, int& n_box,
                                             int& n_tri) {
  if constexpr (kHalfSkip) {
    const int half = K / 2;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 c = __ldg(rec + 4 * h + 2);  // e2z pid lo.x lo.y
      const float4 d = __ldg(rec + 4 * h + 3);  // lo.z hi.x hi.y hi.z
      if (kCount) ++n_box;
      if (box_entry(c.z, c.w, d.x, d.y, d.z, d.w, r, bt) < bt &&
          test_records<kAnyHit, kCount, kK>(rec, h * half, (h + 1) * half, r,
                                            bt, bp, bu, bv, n_tri))
        return true;
    }
    return false;
  } else {
    return test_records<kAnyHit, kCount, kK>(rec, 0, K, r, bt, bp, bu, bv,
                                             n_tri);
  }
}

// The while-while walk of one lane (Aila & Laine, HPG 2009), from
// ``node``, which the lane has entered, with ``sp`` entries on its stack:
// the lane descends inner nodes, near child first by its own slab entry,
// until it holds a leaf or its walk is over, and only then tests the
// cluster, so the lanes of a warp test their clusters together and
// reconverge after.  Popped nodes whose entry is behind the best hit are
// skipped.  kHeap: the children of n are 2n+1 / 2n+2; otherwise (a radix
// tree, binary descent) they are read from n's kids columns nodes[n, 6:8]
// (float values, exact below 2^24).  kFanout 4 or 8 (heap trees): the node is
// expanded into its descendants two (three) levels down
// (traverse.py:393-441), a child that is already a leaf kept with -1 in its
// empty sibling slot, the candidates ordered by the reference's sorting
// network and pushed far to near.  kK: the cluster size at compile time
// (records unrolled), or 0 for the run-time ``K``.
template <bool kAnyHit, bool kCount, int kFanout, bool kHalfSkip, int kK,
          bool kHeap = true>
__device__ __forceinline__ void lane_walk(
    const float* __restrict__ nodes, const float4* __restrict__ tris,
    int leaf_base, int K, const RayData& r, int node,
    int (&stack_node)[kStackDepth], float (&stack_t)[kStackDepth], int sp,
    float& bt, float& bp, float& bu, float& bv, int& n_box, int& n_tri) {
  static_assert(kFanout == 2 || kFanout == 4 || kFanout == 8,
                "fanout is 2, 4 or 8");
  static_assert(kK == 0 || kK == 8 || kK == 16 || kK == 32,
                "K is 8, 16, 32 or 0 (run time)");
  static_assert(!kHalfSkip || kK == 0 || kK >= 16, "half boxes need K >= 16");
  static_assert(kHeap || (kFanout == 2 && !kHalfSkip),
                "a radix tree descends 2 wide, without the half skip");
  auto pop = [&]() -> bool {
    while (sp > 0) {
      --sp;
      if (stack_t[sp] < bt) {
        node = stack_node[sp];
        return true;
      }
    }
    return false;
  };
  while (true) {
    // inner phase: descend until this lane holds a leaf or is done
    bool walking = true;
    while (node < leaf_base) {
      bool descended = false;
      if constexpr (kFanout == 2) {
        int left = 2 * node + 1, right = 2 * node + 2;
        if constexpr (!kHeap) {
          const float2 kids =
              __ldg(reinterpret_cast<const float2*>(nodes + 8 * node + 6));
          left = static_cast<int>(kids.x);
          right = static_cast<int>(kids.y);
        }
        const float tl = slab_entry(nodes, left, r, bt);
        const float tr = slab_entry(nodes, right, r, bt);
        if (kCount) n_box += 2;
        const bool hl = tl < INFINITY, hr = tr < INFINITY;
        if (hl && hr) {
          const bool left_first = tl <= tr;
          stack_node[sp] = left_first ? right : left;
          stack_t[sp] = left_first ? tr : tl;
          ++sp;
          node = left_first ? left : right;
        } else if (hl || hr) {
          node = hl ? left : right;
        }
        descended = hl || hr;
      } else {
        constexpr int kLevels = kFanout == 8 ? 3 : 2;
        int idx[kFanout];
        idx[0] = 2 * node + 1;
        idx[1] = 2 * node + 2;
#pragma unroll
        for (int lv = 1; lv < kLevels; ++lv) {
#pragma unroll
          for (int j = (1 << lv) - 1; j >= 0; --j) {
            const int c = idx[j];
            const bool keep = c >= leaf_base || c < 0;
            idx[2 * j] = keep ? c : 2 * c + 1;
            idx[2 * j + 1] = keep ? -1 : 2 * c + 2;
          }
        }
        float key[kFanout];
#pragma unroll
        for (int j = 0; j < kFanout; ++j) {
          key[j] = idx[j] >= 0 ? slab_entry(nodes, idx[j], r, bt) : INFINITY;
          if (kCount) n_box += idx[j] >= 0;
        }
        sort_net<kFanout>(key, idx);
        if (key[0] < INFINITY) {
          // the hit candidates behind the nearest, pushed far to near
#pragma unroll
          for (int j = kFanout - 1; j >= 1; --j) {
            if (key[j] < INFINITY) {
              stack_node[sp] = idx[j];
              stack_t[sp] = key[j];
              ++sp;
            }
          }
          node = idx[0];
          descended = true;
        }
      }
      if (!descended) walking = pop();
      if (!walking) break;
    }
    if (!walking) break;
    // leaf phase: the warp's lanes that hold a leaf test it together
    const bool found = test_cluster<kAnyHit, kCount, kHalfSkip, kK>(
        tris + static_cast<size_t>(node - leaf_base) * K * 4, K, r, bt, bp,
        bu, bv, n_box, n_tri);
    const bool more = !(kAnyHit && found) && pop();
    if (!more) break;
  }
}

}  // namespace

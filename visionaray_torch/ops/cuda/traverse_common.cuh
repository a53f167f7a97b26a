// Device helpers shared by the two traversal kernels: traverse.cu (coherent
// tiles, radix trees) and traverse_binned.cu (the two-pass tiles of the
// treelet-binned path).  The stack size, the slab test, the sorting
// networks and the triangle test live here.

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

// Moeller-Trumbore of the ray against records [k0, k1) of one cluster,
// folded into (bt, bp, bu, bv) with the strict t < bt, for the two halves
// of the half-cluster skip in traverse.cu and for one record at a time in
// traverse_binned.cu.  Returns true when an any-hit lane found its hit (and
// stops there).  traverse.cu's whole-cluster loop is the same code written
// inline: called through this function with a run-time cluster size it
// compiled to up to 32 more instructions and ran 12-15% slower in every
// binary-descent mode on an H100 (same registers).
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

}  // namespace

// The volume march shared by volume_march.cu (forward) and
// volume_march_bwd.cu (backward): the slab test of a box, the boxes in a
// ray's depth order, and each step's trilinear and transfer fetches, in
// the plain version's (kernels/volume.py::march_plain) arithmetic and
// order.  Both kernels walk a ray through march(), so under -fmad=false
// the backward re-marches every step of the forward bit for bit.  The
// forward instantiates march<true> with its Skip tables: the same steps,
// fetched from a padded texel copy, with the steps in provably empty
// bricks skipped (below); the backward takes march<false>, the code of
// the first design.

#pragma once

#include <math.h>

#include "nan_minmax.cuh"

namespace vol {

constexpr int kMaxSteps = 512;   // kernels/volume.py MAX_STEPS

// The volumes: (V, 3) boxes, (V, D, H, W) texels, (V, T, 4) transfer.
struct Grid {
  const float* lo;
  const float* hi;
  const float* texels;
  const float* transfer;
  int V, D, H, W, T;
  float step_scale;
};

struct Lane {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
};

__device__ __forceinline__ Lane load_lane(const float* ori, const float* dir,
                                          int i) {
  Lane r;
  r.ox = ori[3 * i];
  r.oy = ori[3 * i + 1];
  r.oz = ori[3 * i + 2];
  r.dx = dir[3 * i];
  r.dy = dir[3 * i + 1];
  r.dz = dir[3 * i + 2];
  r.ix = 1.0f / r.dx;
  r.iy = 1.0f / r.dy;
  r.iz = 1.0f / r.dz;
  return r;
}

// ops/intersect.py intersect_aabb of box v, then tn = max(tn, 0):
// hit = tf >= tn.
__device__ __forceinline__ bool box(const Grid& g, int v, const Lane& r,
                                    float& tn, float& tf) {
  const float* lo = g.lo + 3 * v;
  const float* hi = g.hi + 3 * v;
  const float t1x = (__ldg(lo + 0) - r.ox) * r.ix;
  const float t1y = (__ldg(lo + 1) - r.oy) * r.iy;
  const float t1z = (__ldg(lo + 2) - r.oz) * r.iz;
  const float t2x = (__ldg(hi + 0) - r.ox) * r.ix;
  const float t2y = (__ldg(hi + 1) - r.oy) * r.iy;
  const float t2z = (__ldg(hi + 2) - r.oz) * r.iz;
  tn = nan_max(nan_max(nan_min(t1x, t2x), nan_min(t1y, t2y)),
               nan_min(t1z, t2z));
  tf = nan_min(nan_min(nan_max(t1x, t2x), nan_max(t1y, t2y)),
               nan_max(t1z, t2z));
  tn = nan_max(tn, 0.0f);
  return tf >= tn;
}

__device__ __forceinline__ int clampi(int x, int hi) {
  return min(max(x, 0), hi);
}

// One step of the march: where it samples and what it reads.
struct Sample {
  int vol;             // the box
  float fx, fy, fz;    // trilinear fractions
  int x0, y0, z0;      // trilinear base texel (unclamped)
  float ft;            // transfer fraction
  int t0, t1;          // transfer entries (clamped)
  float c0[4], c1[4];  // the transfer entries read
  float c[4];          // the classified colour
  float z;             // the opacity before the clip: c.a * dt * D
  float al;            // the opacity after it
  float u, v, w;       // where it samples, in the box's unit cube
  float t;             // the ray parameter of the step: tn + dt * i
  int i;               // the step's index in its box
};

// The forward's tables (kernels/volume.py::volume_pack), built once per
// (texels, transfer) pair:
// - padded: (V, D+2, H+2, W+2), the texels with a replicated one-texel
//   border, so the 8 trilinear corners of base cell (x0, y0, z0), each
//   axis clamped once into [-1, W-1], sit at fixed offsets from one
//   pointer.  Where _tex3d_multi clamps x0 < -1 or x0 > W-1 per corner,
//   it reads one edge texel twice with the two weights; the clamped base
//   reads the same texel (the border is its copy) with the same weights,
//   in the same order: the sum is the same, bit for bit.
// - transfer: (V, T) RGBA as float4, in shared memory or global memory
//   (tr_at reads one entry from whichever the kernel holds).
// - bits: one bit per brick of B^3 cells, B = 1 << shift, brick
//   (v, bz, by, bx) at bit ((v nbz + bz) nby + by) nbx + bx, set where the
//   brick is empty: every value a step whose base cell lies in it can
//   classify has alpha <= 0 and finite RGB.  Such a step's opacity is
//   exactly 0 (c.a <= 0, dt finite and >= 0), so dst + om (c.rgb 0, 0) is
//   dst, bit for bit: the step is skipped.  brick_table states the
//   table's rounding bound; the step checks here what the table assumes:
//   its base cell is finite and within 2^30 (fractions in [0, 1]), and
//   its box's dt is finite and >= 0.
struct Skip {
  const float* padded;
  const float4* transfer;
  const unsigned* bits;
  int shift;
  int nbx, nby, nbz;
};

// The flat index of texel (xi, yi, zi) of volume vol, and its trilinear
// weight; _tex3d_multi's corner order (dz, dy, dx).
__device__ __forceinline__ int corner(const Grid& g, const Sample& s,
                                      int k, float& w) {
  const int dz = k >> 2, dy = (k >> 1) & 1, dx = k & 1;
  const float wz = dz ? s.fz : 1.0f - s.fz;
  const float wy = dy ? s.fy : 1.0f - s.fy;
  const float wx = dx ? s.fx : 1.0f - s.fx;
  w = wz * wy * wx;
  const int zi = clampi(s.z0 + dz, g.D - 1);
  const int yi = clampi(s.y0 + dy, g.H - 1);
  const int xi = clampi(s.x0 + dx, g.W - 1);
  return ((s.vol * g.D + zi) * g.H + yi) * g.W + xi;
}

// _tex3d_multi (trilinear, CLAMP) at normalized (u, v, w), then
// _tex1d_multi (linear, CLAMP) of the transfer and the clipped opacity.
__device__ __forceinline__ void sample(const Grid& g, int vol, float u,
                                       float v, float w, float dt, float fD,
                                       Sample& s) {
  s.vol = vol;
  s.u = u;
  s.v = v;
  s.w = w;
  const float x = u * static_cast<float>(g.W) - 0.5f;
  const float y = v * static_cast<float>(g.H) - 0.5f;
  const float z = w * static_cast<float>(g.D) - 0.5f;
  s.x0 = static_cast<int>(floorf(x));
  s.y0 = static_cast<int>(floorf(y));
  s.z0 = static_cast<int>(floorf(z));
  s.fx = x - static_cast<float>(s.x0);
  s.fy = y - static_cast<float>(s.y0);
  s.fz = z - static_cast<float>(s.z0);
  float sv = 0.0f;
  for (int k = 0; k < 8; ++k) {
    float wk;
    const int idx = corner(g, s, k, wk);
    sv = sv + wk * __ldg(g.texels + idx);
  }
  const float xt = sv * static_cast<float>(g.T) - 0.5f;
  const int t0 = static_cast<int>(floorf(xt));
  s.ft = xt - static_cast<float>(t0);
  s.t0 = clampi(t0, g.T - 1);
  s.t1 = clampi(t0 + 1, g.T - 1);
  const float* tr = g.transfer + 4 * g.T * vol;
  for (int ch = 0; ch < 4; ++ch) {
    s.c0[ch] = __ldg(tr + 4 * s.t0 + ch);
    s.c1[ch] = __ldg(tr + 4 * s.t1 + ch);
    s.c[ch] = (1.0f - s.ft) * s.c0[ch] + s.ft * s.c1[ch];
  }
  s.z = s.c[3] * dt * fD;
  s.al = nan_min(nan_max(s.z, 0.0f), 1.0f);
}

// One step of the forward's march<true> at unit-cube position (u, v, w)
// of the box whose padded texels start at vp, with its transfer entries
// at e0 (vol T) and its bricks at bb (vol nbz): dst composited unless the
// step's brick is empty (skip_box: the box's dt allows the skip).  Returns
// whether it skipped.  The arithmetic is sample()'s, in its order.
template <class TrAt>
__device__ __forceinline__ bool fast_step(const Grid& g, const Skip& k,
                                          const float* vp, int e0, int bb,
                                          bool skip_box, float u, float v,
                                          float w, float dt, float fD,
                                          float* dst, TrAt&& tr_at) {
  const float x = u * static_cast<float>(g.W) - 0.5f;
  const float y = v * static_cast<float>(g.H) - 0.5f;
  const float z = w * static_cast<float>(g.D) - 0.5f;
  const int x0 = static_cast<int>(floorf(x));
  const int y0 = static_cast<int>(floorf(y));
  const int z0 = static_cast<int>(floorf(z));
  constexpr float kFinite = 1073741824.0f;   // 2^30
  if (skip_box && fabsf(x) < kFinite && fabsf(y) < kFinite &&
      fabsf(z) < kFinite) {
    const int bx = clampi(x0, g.W - 1) >> k.shift;
    const int by = clampi(y0, g.H - 1) >> k.shift;
    const int bz = clampi(z0, g.D - 1) >> k.shift;
    const int b = ((bb + bz) * k.nby + by) * k.nbx + bx;
    if ((__ldg(k.bits + (b >> 5)) >> (b & 31)) & 1u) return true;
  }
  const float fx = x - static_cast<float>(x0);
  const float fy = y - static_cast<float>(y0);
  const float fz = z - static_cast<float>(z0);
  const float gx = 1.0f - fx, gy = 1.0f - fy, gz = 1.0f - fz;
  const int Wp = g.W + 2;
  const int Sp = (g.H + 2) * Wp;
  const float* p = vp + (min(max(z0, -1), g.D - 1) + 1) * Sp +
                   (min(max(y0, -1), g.H - 1) + 1) * Wp +
                   (min(max(x0, -1), g.W - 1) + 1);
  // _tex3d_multi's corner order (dz, dy, dx), weights (wz * wy) * wx
  float sv = 0.0f;
  sv = sv + gz * gy * gx * __ldg(p);
  sv = sv + gz * gy * fx * __ldg(p + 1);
  sv = sv + gz * fy * gx * __ldg(p + Wp);
  sv = sv + gz * fy * fx * __ldg(p + Wp + 1);
  sv = sv + fz * gy * gx * __ldg(p + Sp);
  sv = sv + fz * gy * fx * __ldg(p + Sp + 1);
  sv = sv + fz * fy * gx * __ldg(p + Sp + Wp);
  sv = sv + fz * fy * fx * __ldg(p + Sp + Wp + 1);
  const float xt = sv * static_cast<float>(g.T) - 0.5f;
  const int t0 = static_cast<int>(floorf(xt));
  const float ft = xt - static_cast<float>(t0);
  const float gt = 1.0f - ft;
  const float4 c0 = tr_at(e0 + clampi(t0, g.T - 1));
  const float4 c1 = tr_at(e0 + clampi(t0 + 1, g.T - 1));
  const float cr = gt * c0.x + ft * c1.x;
  const float cg = gt * c0.y + ft * c1.y;
  const float cb = gt * c0.z + ft * c1.z;
  const float ca = gt * c0.w + ft * c1.w;
  const float al = nan_min(nan_max(ca * dt * fD, 0.0f), 1.0f);
  const float om = 1.0f - dst[3];
  dst[0] = dst[0] + om * (cr * al);
  dst[1] = dst[1] + om * (cg * al);
  dst[2] = dst[2] + om * (cb * al);
  dst[3] = dst[3] + om * al;
  return false;
}

struct NoSkip {};

// March lane r front to back through every box in its depth order (JAX's
// stable argsort of (hit ? tn : inf): a selection over the key (tn,
// index), O(V^2) slab tests, no local array, no cap on V; the first key of
// inf ends the ray), compositing into dst (r, g, b, a).  Each box: dt =
// step_scale * min(extent / (D, H, W)) (JAX pairs extent x with D), then
// for i < 512: t = tn + dt * i, p = o + d * t, uvw = (p - lo) / extent,
// dst += (1 - dst.a) * (c.rgb * a, a).  JAX masks a step with !(t < tf)
// or dst.a >= 0.999; the march breaks at the first such step instead (t
// grows with i and dst.a never falls, so every later step would be
// masked too).
// - march<false> (the backward): after each step, step(sample, dt, om) is
//   called with om = 1 - dst.a before the step and dst already updated;
//   the sample carries the step's t, index and unit-cube position, which
//   the backward's ray and box gradients read.
// - march<true> (the forward, with its Skip tables k and its transfer
//   reader tr_at): fast_step() takes each step, and step(empty) is called
//   after it, empty where its brick was skipped.  The steps visited are
//   march<false>'s, and so is dst, bit for bit.
template <bool kSkip = false, class Step, class Tables = NoSkip,
          class TrAt = NoSkip>
__device__ __forceinline__ void march(const Grid& g, const Lane& r,
                                      float* dst, Step&& step,
                                      const Tables& k = Tables(),
                                      TrAt&& tr_at = TrAt()) {
  const float fD = static_cast<float>(g.D);
  float prev_key = -INFINITY;
  int prev = -1;
  for (int rank = 0; rank < g.V; ++rank) {
    // the next box in (key, index) order after (prev_key, prev)
    int best = -1;
    float best_key = INFINITY, tn = 0.0f, tf = 0.0f;
    for (int v = 0; v < g.V; ++v) {
      float vn, vf;
      const float key = box(g, v, r, vn, vf) ? vn : INFINITY;
      const bool after = key > prev_key || (key == prev_key && v > prev);
      if (after && (best < 0 || key < best_key)) {
        best = v;
        best_key = key;
        tn = vn;
        tf = vf;
      }
    }
    if (best < 0 || best_key == INFINITY) break;
    prev_key = best_key;
    prev = best;

    const float* lo = g.lo + 3 * best;
    const float* hi = g.hi + 3 * best;
    const float lx = __ldg(lo), ly = __ldg(lo + 1), lz = __ldg(lo + 2);
    const float ex = __ldg(hi) - lx;
    const float ey = __ldg(hi + 1) - ly;
    const float ez = __ldg(hi + 2) - lz;
    const float dt = g.step_scale *
        nan_min(nan_min(ex / fD, ey / static_cast<float>(g.H)),
                ez / static_cast<float>(g.W));
    if constexpr (kSkip) {
      const float* vp = k.padded + static_cast<long long>(best) *
          (g.D + 2) * (g.H + 2) * (g.W + 2);
      const int e0 = best * g.T;
      const int bb = best * k.nbz;
      // an empty step's z = c.a dt D is <= 0 for finite dt >= 0 (NaN fails)
      const bool skip_box = dt >= 0.0f && dt <= 3.402823466e38f;
      for (int i = 0; i < kMaxSteps; ++i) {
        const float t = tn + dt * static_cast<float>(i);
        if (!(t < tf) || !(dst[3] < 0.999f)) break;
        const float px = r.ox + r.dx * t;
        const float py = r.oy + r.dy * t;
        const float pz = r.oz + r.dz * t;
        step(fast_step(g, k, vp, e0, bb, skip_box, (px - lx) / ex,
                       (py - ly) / ey, (pz - lz) / ez, dt, fD, dst, tr_at));
      }
    } else {
      for (int i = 0; i < kMaxSteps; ++i) {
        const float t = tn + dt * static_cast<float>(i);
        if (!(t < tf) || !(dst[3] < 0.999f)) break;
        const float px = r.ox + r.dx * t;
        const float py = r.oy + r.dy * t;
        const float pz = r.oz + r.dz * t;
        Sample s;
        sample(g, best, (px - lx) / ex, (py - ly) / ey, (pz - lz) / ez, dt,
               fD, s);
        s.t = t;
        s.i = i;
        const float om = 1.0f - dst[3];
        dst[0] = dst[0] + om * (s.c[0] * s.al);
        dst[1] = dst[1] + om * (s.c[1] * s.al);
        dst[2] = dst[2] + om * (s.c[2] * s.al);
        dst[3] = dst[3] + om * s.al;
        step(s, dt, om);
      }
    }
  }
}

}  // namespace vol

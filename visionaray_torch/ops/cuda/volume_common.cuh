// The volume march shared by volume_march.cu (forward) and
// volume_march_bwd.cu (backward): the slab test of a box, the boxes in a
// ray's depth order, and each step's trilinear and transfer fetches, in
// the plain version's (kernels/volume.py::march_plain) arithmetic and
// order.  Both kernels walk a ray through march(), so under -fmad=false
// the backward re-marches every step of the forward bit for bit.

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

// March lane r front to back through every box in its depth order (JAX's
// stable argsort of (hit ? tn : inf): a selection over the key (tn,
// index), O(V^2) slab tests, no local array, no cap on V; the first key of
// inf ends the ray), compositing into dst (r, g, b, a).  Each box: dt =
// step_scale * min(extent / (D, H, W)) (JAX pairs extent x with D), then
// for i < 512: t = tn + dt * i, p = o + d * t, uvw = (p - lo) / extent,
// dst += (1 - dst.a) * (c.rgb * a, a).  JAX masks a step with !(t < tf)
// or dst.a >= 0.999; the march breaks at the first such step instead (t
// grows with i and dst.a never falls, so every later step would be
// masked too).  After each step, step(sample, dt, om) is called with om =
// 1 - dst.a before the step and dst already updated; the sample carries
// the step's t, index and unit-cube position, which the backward's ray
// and box gradients read (the forward's step ignores them).
template <class Step>
__device__ __forceinline__ void march(const Grid& g, const Lane& r,
                                      float* dst, Step&& step) {
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

}  // namespace vol

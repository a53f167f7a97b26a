// The volume renderer's ray march, one thread per ray: the card form of
// kernels/volume.py (the port's plain version, march_plain).
//
// Replaces: the JAX package's jnp volume kernel,
// visionaray_tpu/kernels/volume.py volume_kernel (:115-182) with its
// gathers _tex3d_multi (:67) and _tex1d_multi (:100).  That kernel has no
// pl.pallas_call: XLA fuses its lax.scan over the V volumes around a
// lax.fori_loop of MAX_STEPS = 512 masked steps into one device loop.
// Eager PyTorch would make ~50 elementwise launches per step, tens of
// thousands a frame, so on the card the march is this kernel.
//
// What it computes, per ray, with JAX's arithmetic in JAX's order (so
// under -fmad=false every value is the plain version's, bit for bit):
// - entry and exit of every box: inv = 1/d unclamped, the slab test with
//   NaN-propagating min/max (nan_minmax.cuh), tn = max(tn, 0) (NaN stays
//   NaN), hit = tf >= tn; depth = the least tn of the boxes hit, else 0;
// - the boxes in JAX's stable argsort order of (hit ? tn : inf): a
//   selection over the key (tn, index), O(V^2) slab tests a ray, with no
//   local array and no cap on V; the first key of inf ends the ray (a box
//   missed, or entered at t = inf, adds nothing);
// - per box: dt = step_scale * min(extent / (D, H, W)) (JAX pairs extent
//   x with D, kept as it is), then for i < 512: t = tn + dt * i,
//   p = o + d * t, uvw = (p - lo) / extent, a trilinear fetch of the
//   scalar (index clamp, flat index ((v*D + z)*H + y)*W + x), a linear
//   fetch of the RGBA transfer (index clamp), opacity a = clamp(c.a * dt *
//   D, 0, 1) (JAX's D3[0], kept), dst += (1 - dst.a) * (c.rgb * a, a);
// - color = dst + (1 - dst.a) * bg.
// JAX masks a step with !(t < tf) or dst.a >= 0.999; this kernel breaks
// at the first such step instead.  t grows with i and dst.a never falls,
// so every later step would be masked too: the image is the same.
//
// Design: one thread per ray, 128 threads a block; texels and transfer
// are read with __ldg point loads and f32 weights (texture objects'
// hardware filtering has 9-bit weights, ~1e-3 off).  Bound: a step is
// ~100 f32 operations (chip_smoke.py FLOP_STEP) and 8 + 2 dependent
// loads; 256^3 texels (64 MiB) do not fit the 50 MB L2, so the loads'
// latency and the misses of rays whose steps land in different bricks are
// what this first design expects to hold it.  The counting form writes
// each ray's steps taken, over all its boxes, to size the operations
// bound.

#include <cuda_runtime.h>
#include <math.h>

#include "nan_minmax.cuh"

namespace {

constexpr int kBlock = 128;
constexpr int kMaxSteps = 512;   // kernels/volume.py MAX_STEPS

struct VolArgs {
  const float* ori;
  const float* dir;
  const float* lo;
  const float* hi;
  const float* texels;
  const float* transfer;
  const float* bg;
  float* color;
  unsigned char* hit;
  float* depth;
  int* steps;
  int n, V, D, H, W, T;
  float step_scale;
};

struct Lane {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
};

// ops/intersect.py intersect_aabb of box v, then tn = max(tn, 0):
// hit = tf >= tn.
__device__ __forceinline__ bool box(const VolArgs& a, int v, const Lane& r,
                                    float& tn, float& tf) {
  const float* lo = a.lo + 3 * v;
  const float* hi = a.hi + 3 * v;
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

// _tex3d_multi: trilinear, CLAMP, at normalized (u, v, w) of volume vol.
__device__ __forceinline__ float tex3d(const VolArgs& a, int vol, float u,
                                       float v, float w) {
  const float x = u * static_cast<float>(a.W) - 0.5f;
  const float y = v * static_cast<float>(a.H) - 0.5f;
  const float z = w * static_cast<float>(a.D) - 0.5f;
  const int x0 = static_cast<int>(floorf(x));
  const int y0 = static_cast<int>(floorf(y));
  const int z0 = static_cast<int>(floorf(z));
  const float fx = x - static_cast<float>(x0);
  const float fy = y - static_cast<float>(y0);
  const float fz = z - static_cast<float>(z0);
  float out = 0.0f;
  for (int dz = 0; dz < 2; ++dz) {
    const float wz = dz ? fz : 1.0f - fz;
    const int zi = clampi(z0 + dz, a.D - 1);
    for (int dy = 0; dy < 2; ++dy) {
      const float wy = dy ? fy : 1.0f - fy;
      const int yi = clampi(y0 + dy, a.H - 1);
      const int row = ((vol * a.D + zi) * a.H + yi) * a.W;
      for (int dx = 0; dx < 2; ++dx) {
        const float wx = dx ? fx : 1.0f - fx;
        const int xi = clampi(x0 + dx, a.W - 1);
        out = out + wz * wy * wx * __ldg(a.texels + row + xi);
      }
    }
  }
  return out;
}

template <bool kCount>
__global__ void __launch_bounds__(kBlock) volume_kernel(VolArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  Lane r;
  r.ox = a.ori[3 * i];
  r.oy = a.ori[3 * i + 1];
  r.oz = a.ori[3 * i + 2];
  r.dx = a.dir[3 * i];
  r.dy = a.dir[3 * i + 1];
  r.dz = a.dir[3 * i + 2];
  r.ix = 1.0f / r.dx;
  r.iy = 1.0f / r.dy;
  r.iz = 1.0f / r.dz;

  bool any = false;
  float depth = INFINITY;
  for (int v = 0; v < a.V; ++v) {
    float tn, tf;
    if (box(a, v, r, tn, tf)) {
      any = true;
      depth = fminf(depth, tn);   // tn of a box hit is not NaN
    }
  }

  float dr = 0.0f, dg = 0.0f, db = 0.0f, da = 0.0f;
  int n_steps = 0;
  const float fD = static_cast<float>(a.D);
  float prev_key = -INFINITY;
  int prev = -1;
  for (int rank = 0; rank < a.V; ++rank) {
    // the next box in (key, index) order after (prev_key, prev)
    int best = -1;
    float best_key = INFINITY, tn = 0.0f, tf = 0.0f;
    for (int v = 0; v < a.V; ++v) {
      float vn, vf;
      const float key = box(a, v, r, vn, vf) ? vn : INFINITY;
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

    const float* lo = a.lo + 3 * best;
    const float* hi = a.hi + 3 * best;
    const float lx = __ldg(lo), ly = __ldg(lo + 1), lz = __ldg(lo + 2);
    const float ex = __ldg(hi) - lx;
    const float ey = __ldg(hi + 1) - ly;
    const float ez = __ldg(hi + 2) - lz;
    const float dt = a.step_scale *
        nan_min(nan_min(ex / fD, ey / static_cast<float>(a.H)),
                ez / static_cast<float>(a.W));
    const float* tr = a.transfer + 4 * a.T * best;
    for (int s = 0; s < kMaxSteps; ++s) {
      const float t = tn + dt * static_cast<float>(s);
      if (!(t < tf) || !(da < 0.999f)) break;
      if (kCount) ++n_steps;
      const float px = r.ox + r.dx * t;
      const float py = r.oy + r.dy * t;
      const float pz = r.oz + r.dz * t;
      const float sv = tex3d(a, best, (px - lx) / ex, (py - ly) / ey,
                             (pz - lz) / ez);
      // _tex1d_multi: linear, CLAMP
      const float xt = sv * static_cast<float>(a.T) - 0.5f;
      const int t0 = static_cast<int>(floorf(xt));
      const float ft = xt - static_cast<float>(t0);
      const float* c0 = tr + 4 * clampi(t0, a.T - 1);
      const float* c1 = tr + 4 * clampi(t0 + 1, a.T - 1);
      const float cr = (1.0f - ft) * __ldg(c0) + ft * __ldg(c1);
      const float cg = (1.0f - ft) * __ldg(c0 + 1) + ft * __ldg(c1 + 1);
      const float cb = (1.0f - ft) * __ldg(c0 + 2) + ft * __ldg(c1 + 2);
      const float ca = (1.0f - ft) * __ldg(c0 + 3) + ft * __ldg(c1 + 3);
      const float al = nan_min(nan_max(ca * dt * fD, 0.0f), 1.0f);
      const float om = 1.0f - da;
      dr = dr + om * (cr * al);
      dg = dg + om * (cg * al);
      db = db + om * (cb * al);
      da = da + om * al;
    }
  }

  const float om = 1.0f - da;
  a.color[4 * i] = dr + om * __ldg(a.bg);
  a.color[4 * i + 1] = dg + om * __ldg(a.bg + 1);
  a.color[4 * i + 2] = db + om * __ldg(a.bg + 2);
  a.color[4 * i + 3] = da + om * __ldg(a.bg + 3);
  a.hit[i] = any ? 1 : 0;
  a.depth[i] = any ? depth : 0.0f;
  if (kCount) a.steps[i] = n_steps;
}

}  // namespace

// ori, dir (n, 3); lo, hi (V, 3); texels (V, D, H, W); transfer (V, T, 4);
// bg (4,); color (n, 4), hit (n,) bytes, depth (n,); steps (n,) int or
// null (the counting form).  All f32 but hit and steps.
extern "C" int vsnray_volume_march(
    const void* ori, const void* dir, const void* lo, const void* hi,
    const void* texels, const void* transfer, const void* bg, void* color,
    void* hit, void* depth, void* steps, int n, int V, int D, int H, int W,
    int T, float step_scale, void* stream) {
  VolArgs a;
  a.ori = static_cast<const float*>(ori);
  a.dir = static_cast<const float*>(dir);
  a.lo = static_cast<const float*>(lo);
  a.hi = static_cast<const float*>(hi);
  a.texels = static_cast<const float*>(texels);
  a.transfer = static_cast<const float*>(transfer);
  a.bg = static_cast<const float*>(bg);
  a.color = static_cast<float*>(color);
  a.hit = static_cast<unsigned char*>(hit);
  a.depth = static_cast<float*>(depth);
  a.steps = static_cast<int*>(steps);
  a.n = n;
  a.V = V;
  a.D = D;
  a.H = H;
  a.W = W;
  a.T = T;
  a.step_scale = step_scale;
  if (n <= 0 || V < 1 || D < 1 || H < 1 || W < 1 || T < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((n + kBlock - 1) / kBlock);
  if (a.steps != nullptr) {
    volume_kernel<true><<<grid, kBlock, 0, s>>>(a);
  } else {
    volume_kernel<false><<<grid, kBlock, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

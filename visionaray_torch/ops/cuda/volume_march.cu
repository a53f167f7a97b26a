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
// The march itself (slab test, depth order, fetches, steps) is
// volume_common.cuh's, shared with the backward, volume_march_bwd.cu.  The
// form that saves the composite writes dst (n, 4), each ray's colour
// before the background: the backward needs it, and it cannot be
// recovered from the colour where bg.a = 1.
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

#include "volume_common.cuh"

namespace {

constexpr int kBlock = 128;

struct VolArgs {
  vol::Grid g;
  const float* ori;
  const float* dir;
  const float* bg;
  float* color;
  unsigned char* hit;
  float* depth;
  float* dst;
  int* steps;
  int n;
};

template <bool kCount>
__global__ void __launch_bounds__(kBlock) volume_kernel(VolArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  const vol::Lane r = vol::load_lane(a.ori, a.dir, i);

  bool any = false;
  float depth = INFINITY;
  for (int v = 0; v < a.g.V; ++v) {
    float tn, tf;
    if (vol::box(a.g, v, r, tn, tf)) {
      any = true;
      depth = fminf(depth, tn);   // tn of a box hit is not NaN
    }
  }

  float dst[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  int n_steps = 0;
  vol::march(a.g, r, dst, [&](const vol::Sample&, float, float) {
    if (kCount) ++n_steps;
  });

  const float om = 1.0f - dst[3];
  for (int ch = 0; ch < 4; ++ch) {
    a.color[4 * i + ch] = dst[ch] + om * __ldg(a.bg + ch);
  }
  if (a.dst != nullptr) {
    for (int ch = 0; ch < 4; ++ch) a.dst[4 * i + ch] = dst[ch];
  }
  a.hit[i] = any ? 1 : 0;
  a.depth[i] = any ? depth : 0.0f;
  if (kCount) a.steps[i] = n_steps;
}

}  // namespace

// ori, dir (n, 3); lo, hi (V, 3); texels (V, D, H, W); transfer (V, T, 4);
// bg (4,); color (n, 4), hit (n,) bytes, depth (n,); dst (n, 4) or null
// (the composite before the background, for the backward); steps (n,) int
// or null (the counting form).  All f32 but hit and steps.
extern "C" int vsnray_volume_march(
    const void* ori, const void* dir, const void* lo, const void* hi,
    const void* texels, const void* transfer, const void* bg, void* color,
    void* hit, void* depth, void* dst, void* steps, int n, int V, int D,
    int H, int W, int T, float step_scale, void* stream) {
  VolArgs a;
  a.g.lo = static_cast<const float*>(lo);
  a.g.hi = static_cast<const float*>(hi);
  a.g.texels = static_cast<const float*>(texels);
  a.g.transfer = static_cast<const float*>(transfer);
  a.g.V = V;
  a.g.D = D;
  a.g.H = H;
  a.g.W = W;
  a.g.T = T;
  a.g.step_scale = step_scale;
  a.ori = static_cast<const float*>(ori);
  a.dir = static_cast<const float*>(dir);
  a.bg = static_cast<const float*>(bg);
  a.color = static_cast<float*>(color);
  a.hit = static_cast<unsigned char*>(hit);
  a.depth = static_cast<float*>(depth);
  a.dst = static_cast<float*>(dst);
  a.steps = static_cast<int*>(steps);
  a.n = n;
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

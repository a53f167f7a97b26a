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
// Design (the first design, redesigned): one thread per ray, 128
// threads a block.  The first design spent ~300 instructions a step
// (1.6 ms for 172,730,813 steps at 256^3 on the H100), most of them on
// steps that add nothing: 85% of volume_scene(256)'s 1080p steps sample a
// cell whose 4^3 brick (kernels/volume.py BRICK; 81% at 8^3) maps only to
// transfer entries of alpha 0.  So:
// - a step first finds its brick (its base cell, each axis clamped into
//   the grid, shifted down by log2 B) and tests the brick's bit
//   (volume_common.cuh Skip, kernels/volume.py::volume_pack); in an empty
//   brick it skips the texel loads, the trilinear sum, the transfer fetch
//   and the composite, which would leave dst as it is, bit for bit;
// - any other step reads its 8 corners from a padded copy of the texels
//   at fixed offsets from one base pointer (one clamp per axis, not 24)
//   and its two transfer entries as float4s, from shared memory when the
//   block's copy of every table fits TR_SMEM_MAX (kernels/volume.py),
//   else from global memory (the form counted in VARIANT_LAUNCHES);
// - texels are read with __ldg point loads and f32 weights (texture
//   objects' hardware filtering has 9-bit weights, ~1e-3 off);
// - the brick table is built on the card by vsnray_volume_bricks (below),
//   one thread a brick, in place of ~60 small PyTorch operations.
// The steps visited, and their order, are the first design's: the
// counting form counts every one (steps), and the empty ones (empty), and
// the warp-iterations of the march and those whose every lane skipped
// (warps[0], warps[1]: 64-bit sums over the launch).  Bound: a step is
// ~100 f32 operations (chip_smoke.py FLOP_STEP) counted over every step,
// skipped or not, so that the bound compares across designs.

#include <cuda_runtime.h>
#include <math.h>

#include "volume_common.cuh"

namespace {

constexpr int kBlock = 128;
constexpr int kSmemMax = 48 * 1024;   // kernels/volume.py TR_SMEM_MAX

struct VolArgs {
  vol::Grid g;
  vol::Skip k;
  const float* ori;
  const float* dir;
  const float* bg;
  float* color;
  unsigned char* hit;
  float* depth;
  float* dst;
  int* steps;
  int* empty;
  unsigned long long* warps;
  int n;
};

template <bool kCount, bool kShared>
__global__ void __launch_bounds__(kBlock) volume_kernel(VolArgs a) {
  extern __shared__ float4 s_tr[];
  if (kShared) {
    for (int j = threadIdx.x; j < a.g.V * a.g.T; j += kBlock) {
      s_tr[j] = __ldg(a.k.transfer + j);
    }
    __syncthreads();
  }
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
  int n_steps = 0, n_empty = 0;
  unsigned long long n_warp = 0, n_warp_empty = 0;
  const auto step = [&](bool empty) {
    if (kCount) {
      ++n_steps;
      n_empty += empty ? 1 : 0;
      if (a.warps != nullptr) {
        const unsigned live = __activemask();
        const unsigned skipped = __ballot_sync(live, empty);
        if ((threadIdx.x & 31u) == static_cast<unsigned>(__ffs(live) - 1)) {
          ++n_warp;
          n_warp_empty += skipped == live ? 1 : 0;
        }
      }
    }
  };
  if (kShared) {
    vol::march<true>(a.g, r, dst, step, a.k,
                     [&](int e) { return s_tr[e]; });
  } else {
    vol::march<true>(a.g, r, dst, step, a.k,
                     [&](int e) { return __ldg(a.k.transfer + e); });
  }

  const float om = 1.0f - dst[3];
  for (int ch = 0; ch < 4; ++ch) {
    a.color[4 * i + ch] = dst[ch] + om * __ldg(a.bg + ch);
  }
  if (a.dst != nullptr) {
    for (int ch = 0; ch < 4; ++ch) a.dst[4 * i + ch] = dst[ch];
  }
  a.hit[i] = any ? 1 : 0;
  a.depth[i] = any ? depth : 0.0f;
  if (kCount) {
    a.steps[i] = n_steps;
    if (a.empty != nullptr) a.empty[i] = n_empty;
    if (a.warps != nullptr && n_warp > 0) {
      atomicAdd(a.warps, n_warp);
      atomicAdd(a.warps + 1, n_warp_empty);
    }
  }
}

template <bool kCount>
void launch(const VolArgs& a, bool shared, cudaStream_t s) {
  const dim3 grid((a.n + kBlock - 1) / kBlock);
  if (shared) {
    const size_t smem = sizeof(float4) * a.g.V * a.g.T;
    volume_kernel<kCount, true><<<grid, kBlock, smem, s>>>(a);
  } else {
    volume_kernel<kCount, false><<<grid, kBlock, 0, s>>>(a);
  }
}

// The brick table of kernels/volume.py::brick_table, one thread per
// brick, in its arithmetic: the min and max (NaN-propagating) of the
// brick's window, texels [B b, B b + B] of each axis clamped to the grid
// (read from the padded copy, whose high border is the clamp), then in
// f64 e = 2^-16 (max(|lo|, |hi|) T + 1), a = lo T - 0.5 - e, b = hi T -
// 0.5 + e, fits = a > -2^30 and b < 2^30, the entries [floor(a), floor(b)
// + 1] clamped to [0, T - 1], and the count of entries that are not
// empty in that range from the prefix counts (V, T + 1).  Writes the
// table (one byte a brick) and sets the brick's bit in the zeroed words.
struct BrickArgs {
  const float* padded;
  const long long* prefix;
  unsigned char* table;
  unsigned* bits;
  int V, D, H, W, T, shift, nbx, nby, nbz;
};

__global__ void __launch_bounds__(kBlock) bricks_kernel(BrickArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.V * a.nbz * a.nby * a.nbx) return;
  const int bx = i % a.nbx;
  const int by = (i / a.nbx) % a.nby;
  const int bz = (i / a.nbx / a.nby) % a.nbz;
  const int v = i / a.nbx / a.nby / a.nbz;
  const int B = 1 << a.shift;
  const int Wp = a.W + 2, Hp = a.H + 2;
  const float* vp = a.padded + static_cast<long long>(v) * (a.D + 2) * Hp * Wp;
  float lo = INFINITY, hi = -INFINITY;
  for (int z = B * bz; z <= min(B * bz + B, a.D); ++z) {
    for (int y = B * by; y <= min(B * by + B, a.H); ++y) {
      const float* row = vp + ((z + 1) * Hp + y + 1) * Wp + 1;
      for (int x = B * bx; x <= min(B * bx + B, a.W); ++x) {
        const float s = __ldg(row + x);
        lo = nan_min(lo, s);
        hi = nan_max(hi, s);
      }
    }
  }
  const double T = static_cast<double>(a.T);
  const double dlo = lo, dhi = hi;
  const double e = 0x1p-16 * (fmax(fabs(dlo), fabs(dhi)) * T + 1.0);
  const double fa = dlo * T - 0.5 - e;
  const double fb = dhi * T - 0.5 + e;
  const bool fits = fa > -1073741824.0 && fb < 1073741824.0;
  const double tmax = T - 1.0;
  const int i0 = static_cast<int>(fmin(fmax(floor(fits ? fa : 0.0), 0.0),
                                       tmax));
  const int i1 = static_cast<int>(fmin(fmax(floor(fits ? fb : 0.0) + 1.0,
                                            0.0), tmax));
  const long long* pre = a.prefix + static_cast<long long>(v) * (a.T + 1);
  const bool empty = fits && pre[i1 + 1] - pre[i0] == 0;
  a.table[i] = empty ? 1 : 0;
  if (empty) atomicOr(a.bits + (i >> 5), 1u << (i & 31));
}

}  // namespace

// padded (V, D+2, H+2, W+2) f32 (kernels/volume.py::pad_texels); prefix
// (V, T + 1) int64, the count of non-empty transfer entries below each
// index; table (V, nbz, nby, nbx) bytes, written; bits, the table's words,
// zeroed by the caller; bricks of 2^shift cells.
extern "C" int vsnray_volume_bricks(const void* padded, const void* prefix,
                                    void* table, void* bits, int V, int D,
                                    int H, int W, int T, int shift, int nbx,
                                    int nby, int nbz, void* stream) {
  BrickArgs a;
  a.padded = static_cast<const float*>(padded);
  a.prefix = static_cast<const long long*>(prefix);
  a.table = static_cast<unsigned char*>(table);
  a.bits = static_cast<unsigned*>(bits);
  a.V = V;
  a.D = D;
  a.H = H;
  a.W = W;
  a.T = T;
  a.shift = shift;
  a.nbx = nbx;
  a.nby = nby;
  a.nbz = nbz;
  if (V < 1 || D < 1 || H < 1 || W < 1 || T < 1 || shift < 0 ||
      shift > 30 || nbx != ((W - 1) >> shift) + 1 ||
      nby != ((H - 1) >> shift) + 1 || nbz != ((D - 1) >> shift) + 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n = V * nbz * nby * nbx;
  const dim3 grid((n + kBlock - 1) / kBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bricks_kernel<<<grid, kBlock, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// ori, dir (n, 3); lo, hi (V, 3); padded (V, D+2, H+2, W+2) texels with a
// replicated border; transfer (V, T, 4), 16-byte aligned; bits, the brick
// table (kernels/volume.py::volume_pack: bricks of 2^shift cells, nbz x
// nby x nbx a volume); bg (4,); color (n, 4), hit (n,) bytes, depth (n,);
// dst (n, 4) or null (the composite before the background, for the
// backward); steps (n,) int or null (the counting form), and with it
// empty (n,) int or null (the steps skipped) and warps (2,) uint64 or
// null (warp-iterations, and those every lane skipped, added to);
// shared: 1 reads the transfer tables from shared memory (V * T * 16
// bytes, at most kSmemMax), 0 from global memory.  All f32 but hit,
// steps, empty, bits and warps.
extern "C" int vsnray_volume_march(
    const void* ori, const void* dir, const void* lo, const void* hi,
    const void* padded, const void* transfer, const void* bits,
    const void* bg, void* color, void* hit, void* depth, void* dst,
    void* steps, void* empty, void* warps, int n, int V, int D, int H,
    int W, int T, int shift, int nbx, int nby, int nbz, int shared,
    float step_scale, void* stream) {
  VolArgs a;
  a.g.lo = static_cast<const float*>(lo);
  a.g.hi = static_cast<const float*>(hi);
  a.g.texels = nullptr;
  a.g.transfer = static_cast<const float*>(transfer);
  a.g.V = V;
  a.g.D = D;
  a.g.H = H;
  a.g.W = W;
  a.g.T = T;
  a.g.step_scale = step_scale;
  a.k.padded = static_cast<const float*>(padded);
  a.k.transfer = static_cast<const float4*>(transfer);
  a.k.bits = static_cast<const unsigned*>(bits);
  a.k.shift = shift;
  a.k.nbx = nbx;
  a.k.nby = nby;
  a.k.nbz = nbz;
  a.ori = static_cast<const float*>(ori);
  a.dir = static_cast<const float*>(dir);
  a.bg = static_cast<const float*>(bg);
  a.color = static_cast<float*>(color);
  a.hit = static_cast<unsigned char*>(hit);
  a.depth = static_cast<float*>(depth);
  a.dst = static_cast<float*>(dst);
  a.steps = static_cast<int*>(steps);
  a.empty = static_cast<int*>(empty);
  a.warps = static_cast<unsigned long long*>(warps);
  a.n = n;
  if (n <= 0 || V < 1 || D < 1 || H < 1 || W < 1 || T < 1 || shift < 0 ||
      shift > 30 || nbx != ((W - 1) >> shift) + 1 ||
      nby != ((H - 1) >> shift) + 1 || nbz != ((D - 1) >> shift) + 1 ||
      (reinterpret_cast<unsigned long long>(transfer) & 15u) != 0 ||
      (shared && static_cast<long long>(V) * T * 16 > kSmemMax)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.steps != nullptr) {
    launch<true>(a, shared != 0, s);
  } else {
    launch<false>(a, shared != 0, s);
  }
  return static_cast<int>(cudaGetLastError());
}

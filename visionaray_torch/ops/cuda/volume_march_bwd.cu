// The volume march's backward pass, one thread per ray: the gradients of
// kernels/volume.py::march_plain's colour with respect to the texels
// (V, D, H, W), the transfer tables (V, T, 4), the rays' origins and
// directions (n, 3) and the boxes' corners lo, hi (V, 3), as jax.grad of
// the JAX package's volume kernel gives them.
//
// Replaces: the reverse pass XLA derives from the JAX package's jnp volume
// kernel, visionaray_tpu/kernels/volume.py volume_kernel (:115-182), with
// _tex3d_multi (:67) and _tex1d_multi (:100).  There is no pl.pallas_call
// to port: the forward is volume_march.cu, this is its adjoint.
//
// Each ray is marched again with volume_common.cuh's march(), the
// forward's code, so under -fmad=false it takes the forward's steps, stops
// at the same step and carries the same prefix composite dst_k.  With the
// saved final composite F = dst_N (the forward's dst output), the colour's
// gradient G and g = G less (G . bg) on alpha (color = F + (1 - F.a) bg),
// step k with contribution (c.rgb a, a) and T_k = 1 - dst_k.a gets
//   dL/dc.rgb = T_k a G.rgb
//   dL/da     = T_k (G.rgb . c.rgb + g.a) - g . (F - dst_{k+1}) / (1 - a)
// the second term being g's alpha part carried back through the suffix
// F - dst_{k+1} = T_{k+1} S_{k+1} of the later steps: 0 exactly where no
// later step is live, and bounded elsewhere, since a live step has
// dst.a < 0.999, so 1 - a >= T_{k+1} > 0.001.  Its cancellation costs
// about ulp(F) / T_{k+1}: 5e-7 (relative L2) of dL/da over the longest
// rays of volume_scene(256) against the plain version's autograd.  Then,
// as JAX differentiates the step:
// - the clip a = min(max(z, 0), 1) of z = c.a dt D passes dL/da where
//   0 < z < 1, half of it where z is exactly 0 or 1 (jnp.maximum and
//   jnp.minimum split a tie evenly), nothing outside;
// - the transfer taps get (1 - ft) and ft of dL/dc, and the scalar
//   dL/ds = T (dL/dc . (c1 - c0)) (floor passes no gradient);
// - the 8 trilinear texels get their weight times dL/ds.
// The rays and the boxes: a step samples at uvw = (p - lo) / extent with
// p = o + d t, t = tn + dt i, so dL/ds also moves the sample, through the
// spatial derivative of the trilinear fetch (dL/du = dL/ds * ds/dfx * W,
// and so on: the fractions have slope 1, floor none), to p, lo and extent
// and, through t, to the box's entry tn and step dt.  dt enters the
// opacity too: z = c.a dt D.  A thread sums these per box in registers
// and, when its ray leaves the box, carries them back as the plain
// version's autograd does:
// - tn = max(max_j min(t1_j, t2_j), 0) with t1 = (lo - o) / d and t2 =
//   (hi - o) / d: the outer max passes half on a tie at 0, the max over
//   the axes splits evenly among tied axes (torch.amax, jnp.max), each
//   min passes to the smaller slab (half each on a tie); the reciprocal
//   1 / d gives -1 / d^2;
// - dt = step_scale * min_j(extent_j / (D, H, W)_j), split evenly among
//   tied axes (torch.amin; a cubic box on a cubic grid ties all three);
// - extent = hi - lo.
// The live mask and the step count carry no gradient.  The ray's
// gradients are its thread's own; the boxes' are summed in f64 in shared
// memory, like the transfer's, and flushed once a block.  The depth's
// gradient (the least tn of the boxes hit) and the background's, sum
// (1 - F.a) G, are reductions over the rays left to PyTorch.
//
// Design: a grid-stride loop over the rays, 128 threads a block, at most
// kMaxBlocks blocks.  Texel gradients go to global memory by f32
// atomicAdd (8 a step with a nonzero dL/ds: neighbouring rays touch
// neighbouring texels, so contention is low, and a texel sums few terms).
// The transfer tables are small (1 KiB for one 64-entry table) and every
// step of every ray lands on them: an entry sums millions of terms (the
// gated entry 0 of alpha takes one from every empty step), and f32 sums
// put the transfer gradient of 2,048 rays through volume_scene(256) 3.5e-5
// (relative L2) off the plain version's, f64 sums 1.1e-6.  So the sums
// stay f64, in three levels:
// - a thread sums consecutive steps that land on the same two taps (the
//   box and the clamped t0, t1) in f64 registers, across its rays too,
//   and flushes them when the taps change and at its end.  Empty space
//   samples 0, always taps (0, 0): a thread's whole stretch of empty steps
//   is one flush, where the first design issued up to 8 shared f64
//   atomics a step, every lane of a warp on the same address (on sm_90 a
//   shared f64 atomicAdd is a compare-and-swap loop, PERF.md);
// - at a flush, the lanes that flush together are grouped by their taps
//   (__match_any_sync), each group's sums are added up by shuffles in
//   log2(group size) rounds, and one leader lane adds them to the block's
//   table;
// - a block accumulates the table in double in dynamic shared memory,
//   V * T * 4 entries (above 48 KiB the block opts in to more; a table
//   larger than the card allows a block, 29,056 entries on the H100, is
//   refused), and adds it to a double output once, at its end.
// A null gtexels or gtransfer skips that gradient's atomics (optimizing
// only the transfer function takes no texel atomics); a non-null counts
// gets the number of shared transfer adds issued.  The ray and box terms
// are a second instantiation (kPos), launched only when one of their
// gradients is asked for: in one form they took the texel and transfer
// gradients from 96 to 168 registers and 11.3 to 16.6 ms at 256^3
// (NVIDIA H100 80GB HBM3, 700 W).  Atomic adds are not associative: the
// gradients are not bit-reproducible from run to run.

#include <cuda_runtime.h>
#include <math.h>

#include "volume_common.cuh"

namespace {

constexpr int kBlock = 128;
constexpr int kMinBlocks = 3;
constexpr int kMaxBlocks = 2048;

struct BwdArgs {
  vol::Grid g;
  const float* ori;
  const float* dir;
  const float* bg;
  const float* dst;      // (n, 4) the forward's composite before bg
  const float* gcolor;   // (n, 4) dL/dcolor
  float* gtexels;        // (V, D, H, W), accumulated into, or null
  double* gtransfer;     // (V, T, 4), accumulated into, or null
  float* gori;           // (n, 3) dL/do, written, or null
  float* gdir;           // (n, 3) dL/dd, written, or null
  double* gbox;          // (V, 6) dL/d(lo, hi), accumulated into, or null
  unsigned long long* counts;   // [0] += shared transfer adds, or null
  int n;
};

// A thread's transfer sums since its last flush: the steps that sampled
// taps t0, t1 of box vol (key), (1 - ft) dL/dc to entry e0 and ft dL/dc to
// entry e1, each channel in f64.
struct TrAcc {
  int key;          // ((vol T + t0) << 1) | (t1 - t0); -1: nothing held
  int e0, e1;       // 4 (vol T + t0), 4 (vol T + t1): table offsets
  double s[8];      // e0's four channels, then e1's
};

// Sum x over the lanes of `peers` (this lane's group among the lanes of
// `mask`) into the group's lowest lane: each round a lane adds the
// partial sum of its next-higher live peer, and the peers at odd
// positions drop out (Westphal's segmented reduction; every lane of
// `mask` runs the same rounds).
__device__ __forceinline__ void reduce_peers(unsigned mask, unsigned peers,
                                             double (&x)[8]) {
  const unsigned lane = threadIdx.x & 31u;
  unsigned rel = __popc(peers & ((1u << lane) - 1u));
  unsigned up = peers & ~((2u << lane) - 1u);
  while (__any_sync(mask, up != 0u)) {
    const int next = __ffs(up);
    const int src = next != 0 ? next - 1 : static_cast<int>(lane);
    for (int j = 0; j < 8; ++j) {
      const double t = __shfl_sync(mask, x[j], src);
      if (next != 0) x[j] = x[j] + t;
    }
    up &= ~__ballot_sync(mask, (rel & 1u) != 0u);
    rel >>= 1;
  }
}

// Add the sums of the lanes flushing together, grouped by taps, to the
// block's table, one leader lane a group; then acc holds nothing.
__device__ __forceinline__ void flush_transfer(double* s_tr, TrAcc& acc,
                                               unsigned long long* counts) {
  const unsigned mask = __activemask();
  const unsigned peers = __match_any_sync(mask, acc.key);
  reduce_peers(mask, peers, acc.s);
  const unsigned lane = threadIdx.x & 31u;
  if (acc.key >= 0 && lane == static_cast<unsigned>(__ffs(peers) - 1)) {
    int adds = 0;
    for (int ch = 0; ch < 4; ++ch) {
      double s0 = acc.s[ch];
      const double s1 = acc.s[4 + ch];
      if (acc.e1 == acc.e0) {
        s0 = s0 + s1;
      } else if (s1 != 0.0) {
        atomicAdd(s_tr + acc.e1 + ch, s1);
        ++adds;
      }
      if (s0 != 0.0) {
        atomicAdd(s_tr + acc.e0 + ch, s0);
        ++adds;
      }
    }
    if (counts != nullptr && adds > 0) {
      atomicAdd(counts, static_cast<unsigned long long>(adds));
    }
  }
  acc.key = -1;
  for (int j = 0; j < 8; ++j) acc.s[j] = 0.0;
}

// One box's share of a ray's gradient, summed over its live steps.
struct BoxAcc {
  int vol;          // the box, -1 before the first step
  float gtn;        // dL/dtn
  float gdt;        // dL/ddt
  float glo[3];     // dL/dlo through uvw = (p - lo) / extent
  float gext[3];    // dL/dextent through the same
};

// Carry acc back through dt = step_scale * min(extent / (D, H, W)),
// extent = hi - lo and the slab entry tn to the ray (go, gd) and the box
// (s_box[6 v .. 6 v + 5] = lo, hi), with the plain version's tie rules.
__device__ __forceinline__ void flush_box(const vol::Grid& g,
                                          const vol::Lane& r,
                                          const BoxAcc& acc, float* go,
                                          float* gd, double* s_box) {
  const float* lo = g.lo + 3 * acc.vol;
  const float* hi = g.hi + 3 * acc.vol;
  const float l[3] = {__ldg(lo), __ldg(lo + 1), __ldg(lo + 2)};
  const float h[3] = {__ldg(hi), __ldg(hi + 1), __ldg(hi + 2)};
  const float o[3] = {r.ox, r.oy, r.oz};
  const float d[3] = {r.dx, r.dy, r.dz};
  const float inv[3] = {r.ix, r.iy, r.iz};
  const float D3[3] = {static_cast<float>(g.D), static_cast<float>(g.H),
                       static_cast<float>(g.W)};
  float glo[3], ghi[3];
  // dt: torch.amin splits its gradient evenly among tied axes
  float q[3];
  for (int j = 0; j < 3; ++j) q[j] = (h[j] - l[j]) / D3[j];
  const float qm = nan_min(nan_min(q[0], q[1]), q[2]);
  const int nq = (q[0] == qm) + (q[1] == qm) + (q[2] == qm);
  const float gq = nq > 0 ? acc.gdt * g.step_scale / static_cast<float>(nq)
                          : 0.0f;
  for (int j = 0; j < 3; ++j) {
    const float ge = acc.gext[j] + (q[j] == qm ? gq / D3[j] : 0.0f);
    glo[j] = acc.glo[j] - ge;
    ghi[j] = ge;
  }
  // tn = max(max_j min(t1_j, t2_j), 0)
  float t1[3], t2[3], m[3];
  for (int j = 0; j < 3; ++j) {
    t1[j] = (l[j] - o[j]) * inv[j];
    t2[j] = (h[j] - o[j]) * inv[j];
    m[j] = nan_min(t1[j], t2[j]);
  }
  const float tnr = nan_max(nan_max(m[0], m[1]), m[2]);
  const float gtnr = tnr > 0.0f ? acc.gtn
                     : tnr == 0.0f ? 0.5f * acc.gtn : 0.0f;
  const int nm = (m[0] == tnr) + (m[1] == tnr) + (m[2] == tnr);
  if (gtnr != 0.0f && nm > 0) {
    const float gm = gtnr / static_cast<float>(nm);
    for (int j = 0; j < 3; ++j) {
      if (!(m[j] == tnr)) continue;
      const float g1 = t1[j] < t2[j] ? gm : t1[j] > t2[j] ? 0.0f : 0.5f * gm;
      const float g2 = t2[j] < t1[j] ? gm : t2[j] > t1[j] ? 0.0f : 0.5f * gm;
      glo[j] = glo[j] + g1 * inv[j];
      ghi[j] = ghi[j] + g2 * inv[j];
      go[j] = go[j] - (g1 + g2) * inv[j];
      const float ginv = g1 * (l[j] - o[j]) + g2 * (h[j] - o[j]);
      gd[j] = gd[j] - ginv / (d[j] * d[j]);
    }
  }
  if (s_box == nullptr) return;
  double* b = s_box + 6 * acc.vol;
  for (int j = 0; j < 3; ++j) {
    if (glo[j] != 0.0f) atomicAdd(b + j, static_cast<double>(glo[j]));
    if (ghi[j] != 0.0f) atomicAdd(b + 3 + j, static_cast<double>(ghi[j]));
  }
}

// kPos: the ray and box gradients are wanted (any of gori, gdir, gbox);
// the form without them keeps the texel and transfer form's registers.
// At least kMinBlocks blocks an SM: the kPos form would take 185
// registers and 2 blocks; capped at 168 with 92 B of spills it runs 3,
// 21% faster at 256^3 (scripts/torch_kernel_ab_lbvh_volume.py, PERF.md);
// the other form stays under the cap.
template <bool kPos>
__global__ void __launch_bounds__(kBlock, kMinBlocks)
    volume_bwd_kernel(BwdArgs a) {
  // V * T * 4 where gtransfer is wanted, then V * 6 where gbox is
  extern __shared__ double s_tr[];
  const bool want_tr = a.gtransfer != nullptr;
  constexpr bool want_pos = kPos;
  const int n_tr = want_tr ? a.g.V * a.g.T * 4 : 0;
  const int n_box = a.gbox != nullptr ? a.g.V * 6 : 0;
  double* s_box = a.gbox != nullptr ? s_tr + n_tr : nullptr;
  for (int j = threadIdx.x; j < n_tr + n_box; j += blockDim.x) s_tr[j] = 0.0;
  __syncthreads();
  const float fD = static_cast<float>(a.g.D);
  const float fH = static_cast<float>(a.g.H);
  const float fW = static_cast<float>(a.g.W);
  const float fT = static_cast<float>(a.g.T);
  const float bg0 = __ldg(a.bg), bg1 = __ldg(a.bg + 1);
  const float bg2 = __ldg(a.bg + 2), bg3 = __ldg(a.bg + 3);
  TrAcc tacc;
  tacc.key = -1;
  tacc.e0 = tacc.e1 = 0;
  for (int j = 0; j < 8; ++j) tacc.s[j] = 0.0;

  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < a.n;
       i += gridDim.x * blockDim.x) {
    const float G0 = a.gcolor[4 * i], G1 = a.gcolor[4 * i + 1];
    const float G2 = a.gcolor[4 * i + 2], G3 = a.gcolor[4 * i + 3];
    if (G0 == 0.0f && G1 == 0.0f && G2 == 0.0f && G3 == 0.0f) continue;
    const float F0 = a.dst[4 * i], F1 = a.dst[4 * i + 1];
    const float F2 = a.dst[4 * i + 2], F3 = a.dst[4 * i + 3];
    const float ga = G3 - (G0 * bg0 + G1 * bg1 + G2 * bg2 + G3 * bg3);
    const vol::Lane r = vol::load_lane(a.ori, a.dir, i);
    float dst[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float go[3] = {0.0f, 0.0f, 0.0f}, gd[3] = {0.0f, 0.0f, 0.0f};
    BoxAcc acc;
    acc.vol = -1;
    float bl[3] = {0.0f, 0.0f, 0.0f}, be[3] = {1.0f, 1.0f, 1.0f};
    vol::march(a.g, r, dst, [&](const vol::Sample& s, float dt, float om) {
      // dst is dst_{k+1}, om is T_k
      const float rest = G0 * (F0 - dst[0]) + G1 * (F1 - dst[1]) +
                         G2 * (F2 - dst[2]) + ga * (F3 - dst[3]);
      const float keep = 1.0f - s.al;
      float dal = om * (G0 * s.c[0] + G1 * s.c[1] + G2 * s.c[2] + ga);
      if (rest != 0.0f && keep > 0.0f) dal = dal - rest / keep;
      const float oa = om * s.al;
      const float dz = (s.z > 0.0f && s.z < 1.0f) ? 1.0f
                       : (s.z == 0.0f || s.z == 1.0f) ? 0.5f : 0.0f;
      const float gz = dal * dz;
      float dc[4];
      dc[0] = oa * G0;
      dc[1] = oa * G1;
      dc[2] = oa * G2;
      dc[3] = gz * dt * fD;
      if (want_pos) {
        if (s.vol != acc.vol) {
          if (acc.vol >= 0) flush_box(a.g, r, acc, go, gd, s_box);
          acc.vol = s.vol;
          acc.gtn = 0.0f;
          acc.gdt = 0.0f;
          for (int j = 0; j < 3; ++j) {
            acc.glo[j] = 0.0f;
            acc.gext[j] = 0.0f;
            bl[j] = __ldg(a.g.lo + 3 * s.vol + j);
            be[j] = __ldg(a.g.hi + 3 * s.vol + j) - bl[j];
          }
        }
        // z = c.a dt D
        acc.gdt = acc.gdt + gz * s.c[3] * fD;
      }
      if (want_tr) {
        const int e = a.g.T * s.vol;
        const int key = ((e + s.t0) << 1) | (s.t1 - s.t0);
        if (key != tacc.key) {
          if (tacc.key >= 0) flush_transfer(s_tr, tacc, a.counts);
          tacc.key = key;
          tacc.e0 = 4 * (e + s.t0);
          tacc.e1 = 4 * (e + s.t1);
        }
      }
      float dft = 0.0f;
      for (int ch = 0; ch < 4; ++ch) {
        if (dc[ch] == 0.0f) continue;
        if (want_tr) {
          tacc.s[ch] = tacc.s[ch] +
                       static_cast<double>((1.0f - s.ft) * dc[ch]);
          tacc.s[4 + ch] = tacc.s[4 + ch] +
                           static_cast<double>(s.ft * dc[ch]);
        }
        dft = dft + dc[ch] * (s.c1[ch] - s.c0[ch]);
      }
      const float ds = dft * fT;
      if ((a.gtexels == nullptr && !want_pos) || ds == 0.0f) return;
      // ds/d(fx, fy, fz): the trilinear weights' slopes times the texels
      float sx = 0.0f, sy = 0.0f, sz = 0.0f;
      for (int k = 0; k < 8; ++k) {
        float w;
        const int idx = vol::corner(a.g, s, k, w);
        if (a.gtexels != nullptr) atomicAdd(a.gtexels + idx, w * ds);
        if (!want_pos) continue;
        const float tv = __ldg(a.g.texels + idx);
        const int kz = k >> 2, ky = (k >> 1) & 1, kx = k & 1;
        const float wz = kz ? s.fz : 1.0f - s.fz;
        const float wy = ky ? s.fy : 1.0f - s.fy;
        const float wx = kx ? s.fx : 1.0f - s.fx;
        sx = sx + (kx ? 1.0f : -1.0f) * (wz * wy) * tv;
        sy = sy + (ky ? 1.0f : -1.0f) * (wz * wx) * tv;
        sz = sz + (kz ? 1.0f : -1.0f) * (wy * wx) * tv;
      }
      if (!want_pos) return;
      // uvw = (p - lo) / extent with x = u W - 0.5 (u pairs with W)
      const float gu = ds * sx * fW;
      const float gv = ds * sy * fH;
      const float gw = ds * sz * fD;
      const float gp[3] = {gu / be[0], gv / be[1], gw / be[2]};
      const float uvw[3] = {s.u, s.v, s.w};
      for (int j = 0; j < 3; ++j) {
        acc.glo[j] = acc.glo[j] - gp[j];
        acc.gext[j] = acc.gext[j] - gp[j] * uvw[j];
        go[j] = go[j] + gp[j];
        gd[j] = gd[j] + gp[j] * s.t;
      }
      // p = o + d t, t = tn + dt i
      const float gt = gp[0] * r.dx + gp[1] * r.dy + gp[2] * r.dz;
      acc.gtn = acc.gtn + gt;
      acc.gdt = acc.gdt + gt * static_cast<float>(s.i);
    });
    if (!want_pos) continue;
    if (acc.vol >= 0) flush_box(a.g, r, acc, go, gd, s_box);
    for (int j = 0; j < 3; ++j) {
      if (a.gori != nullptr) a.gori[3 * i + j] = go[j];
      if (a.gdir != nullptr) a.gdir[3 * i + j] = gd[j];
    }
  }

  if (want_tr) flush_transfer(s_tr, tacc, a.counts);
  __syncthreads();
  for (int j = threadIdx.x; j < n_tr; j += blockDim.x) {
    if (s_tr[j] != 0.0) atomicAdd(a.gtransfer + j, s_tr[j]);
  }
  for (int j = threadIdx.x; j < n_box; j += blockDim.x) {
    if (s_box[j] != 0.0) atomicAdd(a.gbox + j, s_box[j]);
  }
}

}  // namespace

// ori, dir (n, 3); lo, hi (V, 3); texels (V, D, H, W); transfer (V, T, 4);
// bg (4,); dst (n, 4), the forward's composite before the background;
// gcolor (n, 4), dL/dcolor; gtexels (V, D, H, W), gtransfer (V, T, 4)
// and gbox (V, 6: lo, hi) are added to (pass zeros), gori and gdir (n, 3)
// written for every ray (pass zeros: a ray with dL/dcolor = 0 is
// skipped); each is null where that gradient is not wanted.  All f32 but
// gtransfer and gbox, f64.  counts (1,) u64, added to, or null: the
// shared-memory adds the transfer gradient issued.  cudaErrorInvalidValue
// where the V * T * 4 and V * 6 doubles exceed the shared memory a block
// may opt in to.
extern "C" int vsnray_volume_march_bwd(
    const void* ori, const void* dir, const void* lo, const void* hi,
    const void* texels, const void* transfer, const void* bg,
    const void* dst, const void* gcolor, void* gtexels, void* gtransfer,
    void* gori, void* gdir, void* gbox, void* counts,
    int n, int V, int D, int H, int W, int T, float step_scale,
    void* stream) {
  BwdArgs a;
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
  a.dst = static_cast<const float*>(dst);
  a.gcolor = static_cast<const float*>(gcolor);
  a.gtexels = static_cast<float*>(gtexels);
  a.gtransfer = static_cast<double*>(gtransfer);
  a.gori = static_cast<float*>(gori);
  a.gdir = static_cast<float*>(gdir);
  a.gbox = static_cast<double*>(gbox);
  a.counts = static_cast<unsigned long long*>(counts);
  a.n = n;
  if (n <= 0 || V < 1 || D < 1 || H < 1 || W < 1 || T < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool pos = gori != nullptr || gdir != nullptr || gbox != nullptr;
  int blocks = (n + kBlock - 1) / kBlock;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const dim3 grid(blocks);
  const size_t smem = sizeof(double) *
      ((gtransfer == nullptr ? 0 : 4 * static_cast<size_t>(V) * T) +
       (gbox == nullptr ? 0 : 6 * static_cast<size_t>(V)));
  if (smem > 48 * 1024) {
    int dev = 0, optin = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) {
      e = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    }
    if (e != cudaSuccess) return static_cast<int>(e);
    if (smem > static_cast<size_t>(optin)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    e = pos ? cudaFuncSetAttribute(
                  volume_bwd_kernel<true>,
                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                  static_cast<int>(smem))
            : cudaFuncSetAttribute(
                  volume_bwd_kernel<false>,
                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                  static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (pos) {
    volume_bwd_kernel<true><<<grid, kBlock, smem, s>>>(a);
  } else {
    volume_bwd_kernel<false><<<grid, kBlock, smem, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

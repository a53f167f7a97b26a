// The volume march's backward pass, one thread per ray: the gradients of
// kernels/volume.py::march_plain's colour with respect to the texels
// (V, D, H, W) and the transfer tables (V, T, 4), as jax.grad of the JAX
// package's volume kernel gives them.
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
// The background's gradient, sum (1 - F.a) G, is a reduction over the
// rays, left to PyTorch.
//
// Design: a grid-stride loop over the rays, 128 threads a block, at most
// kMaxBlocks blocks.  Texel gradients go to global memory by f32
// atomicAdd (8 a step with a nonzero dL/ds: neighbouring rays touch
// neighbouring texels, so contention is low, and a texel sums few terms).
// The transfer tables are small (1 KiB for one 64-entry table) and every
// step of every ray lands on them: an entry sums millions of terms (the
// gated entry 0 of alpha takes one from every empty step), and f32 sums
// put the transfer gradient of 2,048 rays through volume_scene(256) 3.5e-5
// (relative L2) off the plain version's, f64 sums 1.1e-6.  So a block
// accumulates them in double in dynamic shared memory, V * T * 4 entries
// (above 48 KiB the block opts in to more; a table larger than the card
// allows a block, 29,056 entries on the H100, is refused), and adds them
// to a double output once, at its end.  A null gtexels or gtransfer skips
// that gradient's atomics (optimizing only the transfer function takes no
// texel atomics).  Atomic adds are not associative: the gradients are not
// bit-reproducible from run to run.

#include <cuda_runtime.h>
#include <math.h>

#include "volume_common.cuh"

namespace {

constexpr int kBlock = 128;
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
  int n;
};

__global__ void __launch_bounds__(kBlock) volume_bwd_kernel(BwdArgs a) {
  extern __shared__ double s_tr[];  // V * T * 4 where gtransfer is wanted
  const bool want_tr = a.gtransfer != nullptr;
  const int n_tr = want_tr ? a.g.V * a.g.T * 4 : 0;
  for (int j = threadIdx.x; j < n_tr; j += blockDim.x) s_tr[j] = 0.0;
  __syncthreads();
  const float fD = static_cast<float>(a.g.D);
  const float fT = static_cast<float>(a.g.T);
  const float bg0 = __ldg(a.bg), bg1 = __ldg(a.bg + 1);
  const float bg2 = __ldg(a.bg + 2), bg3 = __ldg(a.bg + 3);

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
      float dc[4];
      dc[0] = oa * G0;
      dc[1] = oa * G1;
      dc[2] = oa * G2;
      dc[3] = dal * dz * dt * fD;
      double* tr = s_tr + 4 * a.g.T * s.vol;
      float dft = 0.0f;
      for (int ch = 0; ch < 4; ++ch) {
        if (dc[ch] == 0.0f) continue;
        if (want_tr) {
          atomicAdd(tr + 4 * s.t0 + ch,
                    static_cast<double>((1.0f - s.ft) * dc[ch]));
          atomicAdd(tr + 4 * s.t1 + ch, static_cast<double>(s.ft * dc[ch]));
        }
        dft = dft + dc[ch] * (s.c1[ch] - s.c0[ch]);
      }
      const float ds = dft * fT;
      if (a.gtexels == nullptr || ds == 0.0f) return;
      for (int k = 0; k < 8; ++k) {
        float w;
        const int idx = vol::corner(a.g, s, k, w);
        atomicAdd(a.gtexels + idx, w * ds);
      }
    });
  }

  __syncthreads();
  for (int j = threadIdx.x; j < n_tr; j += blockDim.x) {
    if (s_tr[j] != 0.0) atomicAdd(a.gtransfer + j, s_tr[j]);
  }
}

}  // namespace

// ori, dir (n, 3); lo, hi (V, 3); texels (V, D, H, W); transfer (V, T, 4);
// bg (4,); dst (n, 4), the forward's composite before the background;
// gcolor (n, 4), dL/dcolor; gtexels (V, D, H, W) and gtransfer (V, T, 4)
// are added to (pass zeros), or null where that gradient is not wanted.
// All f32 but gtransfer, f64.  cudaErrorInvalidValue where V * T * 4
// doubles exceed the shared memory a block may opt in to.
extern "C" int vsnray_volume_march_bwd(
    const void* ori, const void* dir, const void* lo, const void* hi,
    const void* texels, const void* transfer, const void* bg,
    const void* dst, const void* gcolor, void* gtexels, void* gtransfer,
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
  a.n = n;
  if (n <= 0 || V < 1 || D < 1 || H < 1 || W < 1 || T < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int blocks = (n + kBlock - 1) / kBlock;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const dim3 grid(blocks);
  const size_t smem =
      gtransfer == nullptr ? 0 : sizeof(double) * 4 * static_cast<size_t>(V) * T;
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
    e = cudaFuncSetAttribute(volume_bwd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  volume_bwd_kernel<<<grid, kBlock, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

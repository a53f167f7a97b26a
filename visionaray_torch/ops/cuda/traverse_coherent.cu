// Coherent-ray ClusterBVH traversal for NVIDIA Hopper (sm_90a): PERF.md
// rows 1 and 1d, closest-hit and any-hit of lanes that all start at the
// root of a heap-built tree (children of n at 2n+1 / 2n+2), binary
// descent, cluster size K = 8, 16 or 32 (compile time).
//
// Replaces the coherent modes of the Pallas TPU kernel visionaray_tpu/ops/
// pallas/traverse.py::_traverse_kernel (launched by _cluster_traverse,
// traverse.py:514-586) for cluster_closest_hit (:722) and cluster_any_hit
// (:1152).  The other coherent heap forms (4/8-wide descent, the
// half-cluster skip, another K) and radix trees go to traverse_binned.cu
// (the packet walk below ran 7-27% slower than the one-lane walk on the
// radix tree's bounce-0 launches, PERF.md §6).
//
// Contract (the plain PyTorch version in traverse.py states it): for every
// live lane (max_t >= 0) the nearest triangle of the tree with
// 0 <= t < max_t, Moeller-Trumbore in the reference's operation order with
// the strict t < best_t fold, each cluster's records tested in order
// k = 0..K-1; any-hit lanes stop at their first hit and leave u = v = 0;
// misses and dead lanes keep t = max_t, prim = -1.  Culling is
// conservative (a node is skipped only when its entry is behind the lane's
// best hit), so closest-hit t does not depend on the visiting order; prim,
// u and v may differ from another walk's only where two triangles tie at
// that t, and an any-hit lane may report another of its hits.
//
// What bounds it on this card: memory latency and divergence, not bytes or
// flops (PERF.md §6: the parent kernel ran at 6-7% of its operations
// bound).  The lanes are coherent: bounce 0's camera rays in 64-px block
// order, sorted by octant and origin morton code (a warp is a strip of 32
// adjacent pixels), and bounce 0's NEE shadow rays traced from one light (a
// warp is a fan from one point to 32 adjacent surface points).  Most lanes
// of a warp want the same nodes and the same clusters, yet one thread per
// ray walks, orders and loads each of them for itself.
//
// What the design does about that: a warp-packet walk for coherent warps,
// the one-lane walk for the others.
// - Packet walk.  The warp holds one node (warp-uniform).  Every lane that
//   entered it slab-tests both children against its own best t; ballots
//   give the lanes that enter each child, and the child nearer for the
//   majority of the lanes comes first.  The other child is pushed by every
//   lane, each with its own entry distance (infinity where it missed), so
//   the stack pointer stays uniform and each lane's stack stays its own.
//   A popped node is taken by the lanes whose entry is in front of their
//   best hit, and skipped with one ballot when no lane wants it.
// - Leaf step.  The warp copies the cluster's K records (their first 48
//   bytes) once into its own shared-memory buffer, 16 bytes a lane, then
//   each lane that entered the leaf tests all K records from there, fully
//   unrolled; every lane reads one broadcast address per load.  Any-hit
//   lanes drop out at their first hit; the warp stops when no live lane is
//   left.
// - Incoherent warps.  A warp whose lanes point apart (more than a quarter
//   of its live lanes further than 9.9 degrees from its first live lane)
//   shares few clusters: the packet would visit the union of its lanes'
//   paths.  Each of its lanes runs the while-while walk of
//   traverse_binned.cu (lane_walk in traverse_common.cuh) from the root
//   instead.  This guards the incoherent callers of the coherent entry:
//   bounce 1-4 shadows under TraceConfig(shadow_binned=False), camera rays
//   of a low-resolution frame.
// Measured and dropped (PERF.md §6): leaving the packet when fewer
// than a share of the live lanes want the node (8 or 16 of 32), when the
// leaf steps serve few lanes on average, or after a count of sparse leaf
// steps (each either slowed the coherent modes or left too late);
// cp.async staging; prefetching the stack-top cluster; 64 threads a block.
//
// Launch: 128 threads a block, 4 * 3K float4 of static shared memory
// (6 KB at K = 32), 64-entry stacks in local memory.
//
// Build: as traverse_binned.cu (nvcc -gencode arch=compute_90a,code=sm_90a
// -O3 -std=c++17 -fmad=false -Xcompiler -fPIC -c), linked with it into one
// shared library; -fmad=false keeps the triangle test bit-equal to the
// plain version's.

#include "traverse_common.cuh"

namespace {

constexpr int kBlock = 128;
constexpr int kWarps = kBlock / 32;
constexpr unsigned kFull = 0xffffffffu;
// A warp is walked lane by lane when more than a quarter of its live lanes
// point further than acos(kSpreadCos) = 9.9 degrees from its first live
// lane (PERF.md §6: the threshold and the alternatives measured).
constexpr float kSpreadCos = 0.985f;

// The first three float4 of each of the cluster's kK records (v1 e1 e2
// pid) to buf[3k .. 3k+2], float4 j of the buffer by lane j mod 32: the
// loads of a warp cover the cluster's 2 KB (K = 32) together, the stores
// fill consecutive 16-byte words.
template <int kK>
__device__ __forceinline__ void stage_cluster(float4* buf,
                                              const float4* __restrict__ rec,
                                              int lane) {
#pragma unroll
  for (int q = 0; q < (3 * kK + 31) / 32; ++q) {
    const int j = lane + 32 * q;
    if (3 * kK % 32 == 0 || j < 3 * kK) {
      const int k = j / 3;
      buf[j] = __ldg(rec + 4 * k + (j - 3 * k));
    }
  }
}

// The kK staged records against the ray, in order; true when an any-hit
// lane found its hit.
template <bool kAnyHit, bool kCount, int kK>
__device__ __forceinline__ bool test_staged(const float4* buf,
                                            const RayData& r, float& bt,
                                            float& bp, float& bu, float& bv,
                                            int& n_tri) {
#pragma unroll
  for (int k = 0; k < kK; ++k) {
    if (kCount) ++n_tri;
    if (test_record<kAnyHit>(buf[3 * k], buf[3 * k + 1], buf[3 * k + 2], r,
                             bt, bp, bu, bv) &&
        kAnyHit)
      return true;
  }
  return false;
}

template <bool kAnyHit, bool kCount, int kK>
__global__ void __launch_bounds__(kBlock)
coherent_kernel(const float4* __restrict__ rays,    // (npad, 8) as 2 float4
                const float* __restrict__ nodes,    // (2C-1, 8)
                const float4* __restrict__ tris,    // (C, K, 16) as 4 float4
                float* __restrict__ out_t, float* __restrict__ out_prim,
                float* __restrict__ out_u, float* __restrict__ out_v,
                int* __restrict__ counters,         // (npad, 2) or null
                int npad, int num_clusters) {
  static_assert(kK == 8 || kK == 16 || kK == 32, "K is 8, 16 or 32");
  __shared__ float4 staged[kWarps][3 * kK];
  const int i = blockIdx.x * kBlock + threadIdx.x;
  const int lane = threadIdx.x & 31;
  // lanes past npad take part in the warp's ballots as dead lanes
  float4 r0 = make_float4(0.0f, 0.0f, 0.0f, 1.0f);
  float4 r1 = make_float4(1.0f, 1.0f, -1.0f, 0.0f);
  if (i < npad) {
    r0 = rays[2 * i];      // ox oy oz dx
    r1 = rays[2 * i + 1];  // dy dz max_t pad
  }
  const float max_t = r1.z;
  const bool live = max_t >= 0.0f;
  float bt = max_t, bp = -1.0f, bu = 0.0f, bv = 0.0f;
  int n_box = 0, n_tri = 0;

  const unsigned live_mask = __ballot_sync(kFull, live);
  if (live_mask) {
    RayData r;
    r.ox = r0.x; r.oy = r0.y; r.oz = r0.z;
    r.dx = r0.w; r.dy = r1.x; r.dz = r1.y;
    r.ix = clamp_inv(r.dx); r.iy = clamp_inv(r.dy); r.iz = clamp_inv(r.dz);
    // the angle of each live lane to the warp's first live lane
    const int ref = __ffs(live_mask) - 1;
    const float qx = __shfl_sync(kFull, r.dx, ref);
    const float qy = __shfl_sync(kFull, r.dy, ref);
    const float qz = __shfl_sync(kFull, r.dz, ref);
    const float dot = r.dx * qx + r.dy * qy + r.dz * qz;
    const float norms = sqrtf((r.dx * r.dx + r.dy * r.dy + r.dz * r.dz) *
                              (qx * qx + qy * qy + qz * qz));
    const bool apart = live && dot < kSpreadCos * norms;
    const bool solo =
        4 * __popc(__ballot_sync(kFull, apart)) > __popc(live_mask);
    const int leaf_base = num_clusters - 1;
    int stack_node[kStackDepth];
    float stack_t[kStackDepth];
    if (solo) {
      // incoherent: every live lane walks alone from the root
      if (live)
        lane_walk<kAnyHit, kCount, 2, false, kK>(
            nodes, tris, leaf_base, kK, r, 0, stack_node, stack_t, 0, bt, bp,
            bu, bv, n_box, n_tri);
    } else {
      float4* buf = staged[threadIdx.x >> 5];
      int sp = 0;           // warp-uniform, as is node
      int node = 0;
      bool want = live;     // this lane entered ``node``
      bool done = false;    // any-hit: this lane found its hit
      while (true) {
        if (node < leaf_base) {
          const int left = 2 * node + 1, right = 2 * node + 2;
          float tl = INFINITY, tr = INFINITY;
          if (want) {
            tl = slab_entry(nodes, left, r, bt);
            tr = slab_entry(nodes, right, r, bt);
            if (kCount) n_box += 2;
          }
          const bool hl = tl < INFINITY, hr = tr < INFINITY;
          const unsigned bl = __ballot_sync(kFull, hl);
          const unsigned br = __ballot_sync(kFull, hr);
          if (bl | br) {
            bool left_first = br == 0;
            if (bl && br) {
              // the child nearer for the majority first; every lane pushes
              // the other with its own entry (infinity where it missed)
              const int n_left = __popc(__ballot_sync(kFull, hl && tl <= tr));
              const int n_right = __popc(__ballot_sync(kFull, hr && tr < tl));
              left_first = n_left >= n_right;
              stack_node[sp] = left_first ? right : left;
              stack_t[sp] = left_first ? tr : tl;
              ++sp;
            }
            node = left_first ? left : right;
            want = left_first ? hl : hr;
            continue;
          }
        } else {
          // leaf step: the cluster's records staged once for the warp
          __syncwarp();   // every lane done reading the previous cluster
          stage_cluster<kK>(
              buf, tris + static_cast<size_t>(node - leaf_base) * kK * 4, lane);
          __syncwarp();
          if (want && test_staged<kAnyHit, kCount, kK>(buf, r, bt, bp, bu, bv,
                                                       n_tri))
            done = true;
          if (kAnyHit && !__ballot_sync(kFull, live && !done)) break;
        }
        // pop the nearest stacked node that some lane still wants
        bool found = false;
        while (sp > 0) {
          --sp;
          want = !done && stack_t[sp] < bt;
          if (__ballot_sync(kFull, want)) {
            node = stack_node[sp];
            found = true;
            break;
          }
        }
        if (!found) break;
      }
    }
  }
  if (i < npad) {
    out_t[i] = bt;
    out_prim[i] = bp;
    out_u[i] = bu;
    out_v[i] = bv;
    if (kCount) {
      counters[2 * i] = n_box;
      counters[2 * i + 1] = n_tri;
    }
  }
}

struct CoherentArgs {
  dim3 grid, block;
  cudaStream_t stream;
  const float4* rays;
  const float* nodes;
  const float4* tris;
  float *out_t, *out_prim, *out_u, *out_v;
  int* counters;
  int npad, num_clusters;
};

template <bool kAnyHit, bool kCount, int kK>
void launch(const CoherentArgs& a) {
  coherent_kernel<kAnyHit, kCount, kK><<<a.grid, a.block, 0, a.stream>>>(
      a.rays, a.nodes, a.tris, a.out_t, a.out_prim, a.out_u, a.out_v,
      a.counters, a.npad, a.num_clusters);
}

template <bool kAnyHit, bool kCount>
bool launch_k(const CoherentArgs& a, int cluster_size) {
  switch (cluster_size) {
    case 8: launch<kAnyHit, kCount, 8>(a); return true;
    case 16: launch<kAnyHit, kCount, 16>(a); return true;
    case 32: launch<kAnyHit, kCount, 32>(a); return true;
    default: return false;
  }
}

}  // namespace

// Plain C entry point for ctypes: coherent lanes from the root of a heap
// tree, binary descent, no half skip.  Launches on ``stream`` and returns
// cudaGetLastError() of the launch (0 = success), or cudaErrorInvalidValue
// without launching for a cluster size other than 8, 16, 32.
extern "C" int vsnray_traverse_coherent(
    const void* rays, const void* nodes, const void* tris, void* out_t,
    void* out_prim, void* out_u, void* out_v, void* counters, int npad,
    int num_clusters, int cluster_size, int any_hit, void* stream) {
  CoherentArgs a;
  a.block = dim3(kBlock);
  a.grid = dim3((npad + kBlock - 1) / kBlock);
  a.stream = static_cast<cudaStream_t>(stream);
  a.rays = static_cast<const float4*>(rays);
  a.nodes = static_cast<const float*>(nodes);
  a.tris = static_cast<const float4*>(tris);
  a.out_t = static_cast<float*>(out_t);
  a.out_prim = static_cast<float*>(out_prim);
  a.out_u = static_cast<float*>(out_u);
  a.out_v = static_cast<float*>(out_v);
  a.counters = static_cast<int*>(counters);
  a.npad = npad;
  a.num_clusters = num_clusters;
  bool ok;
  if (any_hit) {
    ok = a.counters ? launch_k<true, true>(a, cluster_size)
                    : launch_k<true, false>(a, cluster_size);
  } else {
    ok = a.counters ? launch_k<false, true>(a, cluster_size)
                    : launch_k<false, false>(a, cluster_size);
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

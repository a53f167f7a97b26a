// Two-pass-tile ClusterBVH traversal for NVIDIA Hopper (sm_90a): the
// treelet-binned path's kernel (PERF.md rows 1b, 1c and their 1f forms),
// and the coherent launches on a heap tree that traverse_coherent.cu does
// not take (4/8-wide descent, the half-cluster skip, a cluster size outside
// 8, 16, 32), which arrive with both roots 0 and split = tile_lanes.
//
// Replaces the two-pass tiles of the Pallas TPU kernel visionaray_tpu/ops/
// pallas/traverse.py::_traverse_kernel (:105-126 pass selection, :453-496
// the per-pass walks), launched by _cluster_traverse (:514-586) for
// _binned_trace's rounds (:938, :1106, :1134).  Lanes [0, split) of a tile
// start at rootA and the rest at rootB; on a heap tree only (children of n
// at 2n+1 / 2n+2), binary or 4/8-wide descent, with or without the
// half-cluster skip.
//
// Contract: traverse.cu's (the plain PyTorch version in traverse.py states
// it): for every live lane (max_t >= 0) the nearest triangle under its
// start node with 0 <= t < max_t, Moeller-Trumbore in the reference's
// operation order with the strict t < best_t fold, records tested in order
// k = 0..K-1; any-hit lanes stop at their first hit and leave u = v = 0;
// misses and dead lanes keep t = max_t, prim = -1.
//
// What bounds it on this card: memory latency and divergence, not bytes or
// flops (its ops bound is 2.6-3.0% of the parent's time, PERF.md §6).  A
// lane starts at a treelet root and walks a short path of dependent node
// loads to 2-4 clusters of K records; in traverse.cu's one-loop walk each
// iteration handles one inner node or one whole cluster, so the lanes of a
// warp at a leaf and those at an inner node take turns, and a K-step
// cluster loop (run-time K, not unrolled) stalls the descending lanes.
//
// What the design does about that:
// - While-while (Aila & Laine, HPG 2009): a lane descends inner nodes until
//   it holds a leaf or its walk is over, and only then tests the cluster, so
//   the lanes of a warp test their clusters together and reconverge after.
// - For K = 8, 16 or 32 (the kd build's sizes and the main path's) K is a
//   compile-time value and the record loop is fully unrolled, so the loads
//   of many records go out before their tests.  Any other multiple of 8
//   (pick_cluster_size gives 40, 48, ... on large meshes) runs one more
//   form whose record loop runs to the run-time K.
// The walk (lane_walk) and the record tests live in traverse_common.cuh:
// the lanes of traverse_coherent.cu's incoherent warps run the same walk.
// The stack is kStackDepth entries.
// Each lane visits the nodes and records in the order the one-loop walk
// did, so the two return the same bits.  Measured and dropped (PERF.md
// §6): staging each distinct cluster of a warp's leaf step in shared
// memory (a leaf step holds 2-4 lanes per cluster, and the groups' tests
// serialise), the stack in shared memory, partial unrolling; a stack of
// stack_need(16, fanout) entries ran no faster.
//
// Launch: 128 threads a block, no shared memory.  ptxas (CUDA 12.8,
// sm_90a), the main path's forms (K = 32, fanout 2, no half skip): 48
// registers closest-hit, 39 any-hit, a 512 B stack frame, no spills; the
// any-hit forms at fanout 8, or fanout 4 with the half skip, spill 12-20 B,
// as do the run-time-K any-hit forms with the half skip.
//
// Build: as traverse.cu (nvcc -gencode arch=compute_90a,code=sm_90a -O3
// -std=c++17 -fmad=false -Xcompiler -fPIC -c), linked with it into one
// shared library.

#include "traverse_common.cuh"

namespace {

constexpr int kBlock = 128;

template <bool kAnyHit, bool kCount, int kFanout, bool kHalfSkip, int kK>
__global__ void __launch_bounds__(kBlock)
binned_kernel(const float4* __restrict__ rays,    // (npad, 8) as 2 float4
              const float* __restrict__ nodes,    // (2C-1, 8)
              const float4* __restrict__ tris,    // (C, K, 16) as 4 float4
              const int* __restrict__ roots,      // (2, n_tiles)
              const int* __restrict__ splits,     // (n_tiles,)
              float* __restrict__ out_t, float* __restrict__ out_prim,
              float* __restrict__ out_u, float* __restrict__ out_v,
              int* __restrict__ counters,         // (npad, 2) or null
              int npad, int n_tiles, int tile_lanes, int num_clusters,
              int cluster_size) {
  const int K = kK > 0 ? kK : cluster_size;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= npad) return;
  const float4 r1 = rays[2 * i + 1];  // dy dz max_t pad
  const float max_t = r1.z;
  float bt = max_t, bp = -1.0f, bu = 0.0f, bv = 0.0f;
  int n_box = 0, n_tri = 0;

  if (max_t >= 0.0f) {
    const float4 r0 = rays[2 * i];  // ox oy oz dx
    const int tile = i / tile_lanes;
    const int lane = i - tile * tile_lanes;
    const int node = lane < splits[tile] ? roots[tile] : roots[n_tiles + tile];
    RayData r;
    r.ox = r0.x; r.oy = r0.y; r.oz = r0.z;
    r.dx = r0.w; r.dy = r1.x; r.dz = r1.y;
    r.ix = clamp_inv(r.dx); r.iy = clamp_inv(r.dy); r.iz = clamp_inv(r.dz);
    int stack_node[kStackDepth];
    float stack_t[kStackDepth];
    lane_walk<kAnyHit, kCount, kFanout, kHalfSkip, kK>(
        nodes, tris, num_clusters - 1, K, r, node, stack_node, stack_t, 0, bt,
        bp, bu, bv, n_box, n_tri);
  }
  out_t[i] = bt;
  out_prim[i] = bp;
  out_u[i] = bu;
  out_v[i] = bv;
  if (kCount) {
    counters[2 * i] = n_box;
    counters[2 * i + 1] = n_tri;
  }
}

struct BinnedArgs {
  dim3 grid, block;
  cudaStream_t stream;
  const float4* rays;
  const float* nodes;
  const float4* tris;
  const int* roots;
  const int* splits;
  float *out_t, *out_prim, *out_u, *out_v;
  int* counters;
  int npad, n_tiles, tile_lanes, num_clusters, cluster_size;
};

template <bool kAnyHit, bool kCount, int kFanout, bool kHalfSkip, int kK>
bool launch(const BinnedArgs& a) {
  binned_kernel<kAnyHit, kCount, kFanout, kHalfSkip, kK>
      <<<a.grid, a.block, 0, a.stream>>>(
          a.rays, a.nodes, a.tris, a.roots, a.splits, a.out_t, a.out_prim,
          a.out_u, a.out_v, a.counters, a.npad, a.n_tiles, a.tile_lanes,
          a.num_clusters, a.cluster_size);
  return true;
}

// The instantiation for (fanout, half_skip) at cluster size kK (0: run
// time); false for a combination the kernel does not take (the half skip
// needs K >= 16).
template <bool kAnyHit, bool kCount, int kK>
bool launch_form(const BinnedArgs& a, int fanout, int half_skip) {
  if (half_skip) {
    if constexpr (kK == 0 || kK >= 16) {
      if (a.cluster_size < 16) return false;
      switch (fanout) {
        case 2: return launch<kAnyHit, kCount, 2, true, kK>(a);
        case 4: return launch<kAnyHit, kCount, 4, true, kK>(a);
        case 8: return launch<kAnyHit, kCount, 8, true, kK>(a);
        default: return false;
      }
    }
    return false;
  }
  switch (fanout) {
    case 2: return launch<kAnyHit, kCount, 2, false, kK>(a);
    case 4: return launch<kAnyHit, kCount, 4, false, kK>(a);
    case 8: return launch<kAnyHit, kCount, 8, false, kK>(a);
    default: return false;
  }
}

template <bool kAnyHit, bool kCount>
bool launch_k(const BinnedArgs& a, int fanout, int half_skip) {
  switch (a.cluster_size) {
    case 8: return launch_form<kAnyHit, kCount, 8>(a, fanout, half_skip);
    case 16: return launch_form<kAnyHit, kCount, 16>(a, fanout, half_skip);
    case 32: return launch_form<kAnyHit, kCount, 32>(a, fanout, half_skip);
    default:
      if (a.cluster_size <= 0 || a.cluster_size % 8) return false;
      return launch_form<kAnyHit, kCount, 0>(a, fanout, half_skip);
  }
}

}  // namespace

// Plain C entry point for ctypes, for two-pass tiles on a heap tree.
// Launches on ``stream`` and returns cudaGetLastError() of the launch (0 =
// success), or cudaErrorInvalidValue without launching for a cluster size
// (a positive multiple of 8), fanout or half skip the kernel does not take.
extern "C" int vsnray_traverse_binned(
    const void* rays, const void* nodes, const void* tris, const void* roots,
    const void* splits, void* out_t, void* out_prim, void* out_u,
    void* out_v, void* counters, int npad, int n_tiles,
    int tile_lanes, int num_clusters, int cluster_size, int any_hit,
    int fanout, int half_skip, void* stream) {
  BinnedArgs a;
  a.block = dim3(kBlock);
  a.grid = dim3((npad + kBlock - 1) / kBlock);
  a.stream = static_cast<cudaStream_t>(stream);
  a.rays = static_cast<const float4*>(rays);
  a.nodes = static_cast<const float*>(nodes);
  a.tris = static_cast<const float4*>(tris);
  a.roots = static_cast<const int*>(roots);
  a.splits = static_cast<const int*>(splits);
  a.out_t = static_cast<float*>(out_t);
  a.out_prim = static_cast<float*>(out_prim);
  a.out_u = static_cast<float*>(out_u);
  a.out_v = static_cast<float*>(out_v);
  a.counters = static_cast<int*>(counters);
  a.npad = npad;
  a.n_tiles = n_tiles;
  a.tile_lanes = tile_lanes;
  a.num_clusters = num_clusters;
  a.cluster_size = cluster_size;
  bool ok;
  if (any_hit) {
    ok = a.counters ? launch_k<true, true>(a, fanout, half_skip)
                    : launch_k<true, false>(a, fanout, half_skip);
  } else {
    ok = a.counters ? launch_k<false, true>(a, fanout, half_skip)
                    : launch_k<false, false>(a, fanout, half_skip);
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// Two-pass-tile and radix-tree ClusterBVH traversal for NVIDIA Hopper
// (sm_90a): the treelet-binned path's kernel (PERF.md rows 1b, 1c and
// their 1f forms), every launch on a radix tree or a single-cluster tree
// (row 1e), and the coherent launches on a heap tree that
// traverse_coherent.cu does not take (4/8-wide descent, the half-cluster
// skip, a cluster size outside 8, 16, 32); the launches from the root
// arrive with both roots 0 and split = tile_lanes.
//
// Replaces the Pallas TPU kernel visionaray_tpu/ops/pallas/traverse.py::
// _traverse_kernel, launched by _cluster_traverse (:514-586): its two-pass
// tiles (:105-126 pass selection, :453-496 the per-pass walks) for
// _binned_trace's rounds (:938, :1106, :1134), and its heap=False path
// (children from the kids columns, :159-174; C == 1, :300-315).  Lanes
// [0, split) of a tile start at rootA and the rest at rootB.  On a heap
// tree (children of n at 2n+1 / 2n+2): binary or 4/8-wide descent, with or
// without the half-cluster skip; on a radix tree (children from nodes[n,
// 6:8]): binary descent from node 0.  A tree of one cluster has its leaf
// at node 0, so every live lane tests cluster 0 with no box test, as the
// TPU kernel's C == 1 path does.
//
// Contract (the plain PyTorch version in traverse.py states it): for every
// live lane (max_t >= 0) the nearest triangle under its start node with
// 0 <= t < max_t, Moeller-Trumbore in the reference's operation order with
// the strict t < best_t fold, records tested in order k = 0..K-1; any-hit
// lanes stop at their first hit and leave u = v = 0; misses and dead lanes
// keep t = max_t, prim = -1.
//
// What bounds it on this card: memory latency and divergence, not bytes or
// flops (its ops bound is 2-7% of its time, PERF.md §6).  A lane walks a
// path of dependent node loads to clusters of K records (2-4 from a
// treelet root, ~10 from the root of the 260k-triangle radix tree, 19
// levels deep); in a one-loop walk each iteration handles one inner node
// or one whole cluster, so the lanes of a warp at a leaf and those at an
// inner node take turns, and a K-step cluster loop (run-time K, not
// unrolled) stalls the descending lanes.
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
// The walk (lane_walk, kHeap picking the children) and the record tests
// live in traverse_common.cuh: the lanes of traverse_coherent.cu's
// incoherent warps run the same walk.  The stack is kStackDepth entries.
// Each lane visits the nodes and records in the order the one-loop walk
// did, so the two return the same bits.  Measured and dropped (PERF.md
// §6): staging each distinct cluster of a warp's leaf step in shared
// memory (a leaf step holds 2-4 lanes per cluster, and the groups' tests
// serialise), the stack in shared memory, partial unrolling; a stack of
// stack_need(16, fanout) entries ran no faster.  On radix trees: the
// warp-packet walk of traverse_coherent.cu for coherent warps (7-27%
// slower on the bounce-0 launches), and loading each child's whole row to
// carry its kids in registers (no faster).
//
// Launch: 128 threads a block, no shared memory.  ptxas (CUDA 12.8,
// sm_90a), the main path's forms (K = 32, fanout 2, no half skip): 48
// registers closest-hit, 39 any-hit, a 512 B stack frame, no spills; the
// any-hit forms at fanout 8, or fanout 4 with the half skip, spill 12-20 B,
// as do the run-time-K any-hit forms with the half skip; the radix forms
// at K = 32 as the heap's (48 and 39 registers, no spills).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17
// -fmad=false -Xcompiler -fPIC -c, beside traverse_coherent.cu, linked
// with it into one shared library.  -fmad=false keeps every product and
// sum separately rounded, as the plain PyTorch version's elementwise ops
// are, so the two agree to the bit on the same triangle.

#include "traverse_common.cuh"

namespace {

constexpr int kBlock = 128;

template <bool kAnyHit, bool kCount, int kFanout, bool kHalfSkip, int kK,
          bool kHeap>
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
    lane_walk<kAnyHit, kCount, kFanout, kHalfSkip, kK, kHeap>(
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

template <bool kAnyHit, bool kCount, int kFanout, bool kHalfSkip, int kK,
          bool kHeap = true>
bool launch(const BinnedArgs& a) {
  binned_kernel<kAnyHit, kCount, kFanout, kHalfSkip, kK, kHeap>
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
bool launch_k(const BinnedArgs& a, int fanout, int half_skip, int heap) {
  if (!heap) {
    // a radix tree: binary descent, no half skip
    if (fanout != 2 || half_skip) return false;
    switch (a.cluster_size) {
      case 8: return launch<kAnyHit, kCount, 2, false, 8, false>(a);
      case 16: return launch<kAnyHit, kCount, 2, false, 16, false>(a);
      case 32: return launch<kAnyHit, kCount, 2, false, 32, false>(a);
      default:
        if (a.cluster_size <= 0 || a.cluster_size % 8) return false;
        return launch<kAnyHit, kCount, 2, false, 0, false>(a);
    }
  }
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

// Plain C entry point for ctypes: two-pass tiles, and lanes from the root,
// on a heap tree (``heap`` = 1) or a radix tree (0).  Launches on
// ``stream`` and returns cudaGetLastError() of the launch (0 = success), or
// cudaErrorInvalidValue without launching for a cluster size (a positive
// multiple of 8), fanout or half skip the kernel does not take.
extern "C" int vsnray_traverse_binned(
    const void* rays, const void* nodes, const void* tris, const void* roots,
    const void* splits, void* out_t, void* out_prim, void* out_u,
    void* out_v, void* counters, int npad, int n_tiles,
    int tile_lanes, int num_clusters, int cluster_size, int any_hit,
    int fanout, int half_skip, int heap, void* stream) {
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
    ok = a.counters ? launch_k<true, true>(a, fanout, half_skip, heap)
                    : launch_k<true, false>(a, fanout, half_skip, heap);
  } else {
    ok = a.counters ? launch_k<false, true>(a, fanout, half_skip, heap)
                    : launch_k<false, false>(a, fanout, half_skip, heap);
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

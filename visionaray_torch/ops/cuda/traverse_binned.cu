// Two-pass-tile ClusterBVH traversal for NVIDIA Hopper (sm_90a): the
// treelet-binned path's kernel (PERF.md rows 1b, 1c and their 1f forms).
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
// The stack is traverse.cu's, kStackDepth entries.
// Each lane visits the nodes and records in the order traverse.cu does, so
// the two kernels return the same bits.  Measured and dropped (PERF.md
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

// Records [k0, k1) of one cluster against the ray: one record at a time,
// unrolled, when kK is a compile-time cluster size; one loop when kK is 0
// (run-time K).
template <bool kAnyHit, bool kCount, int kK>
__device__ __forceinline__ bool test_records(const float4* __restrict__ rec,
                                             int k0, int k1, const RayData& r,
                                             float& bt, float& bp, float& bu,
                                             float& bv, int& n_tri) {
  if constexpr (kK == 0) {
    return intersect_records<kAnyHit, kCount>(rec, k0, k1, r, bt, bp, bu, bv,
                                              n_tri);
  } else {
#pragma unroll
    for (int k = k0; k < k1; ++k)
      if (intersect_records<kAnyHit, kCount>(rec, k, k + 1, r, bt, bp, bu, bv,
                                             n_tri))
        return true;
    return false;
  }
}

// The K records of one cluster against the ray, in order k = 0..K-1; with
// the half skip each half's box (floats 10..15 of record h) is tested first
// and gates its K/2 records.  Returns true when an any-hit lane found its
// hit.
template <bool kAnyHit, bool kCount, bool kHalfSkip, int kK>
__device__ __forceinline__ bool test_cluster(const float4* __restrict__ rec,
                                             int K, const RayData& r,
                                             float& bt, float& bp, float& bu,
                                             float& bv, int& n_box,
                                             int& n_tri) {
  if constexpr (kHalfSkip) {
    const int half = K / 2;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 c = __ldg(rec + 4 * h + 2);  // e2z pid lo.x lo.y
      const float4 d = __ldg(rec + 4 * h + 3);  // lo.z hi.x hi.y hi.z
      if (kCount) ++n_box;
      if (box_entry(c.z, c.w, d.x, d.y, d.z, d.w, r, bt) < bt &&
          test_records<kAnyHit, kCount, kK>(rec, h * half, (h + 1) * half, r,
                                            bt, bp, bu, bv, n_tri))
        return true;
    }
    return false;
  } else {
    return test_records<kAnyHit, kCount, kK>(rec, 0, K, r, bt, bp, bu, bv,
                                             n_tri);
  }
}

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
  static_assert(kFanout == 2 || kFanout == 4 || kFanout == 8,
                "fanout is 2, 4 or 8");
  static_assert(kK == 0 || kK == 8 || kK == 16 || kK == 32,
                "K is 8, 16, 32 or 0 (run time)");
  static_assert(!kHalfSkip || kK == 0 || kK >= 16, "half boxes need K >= 16");
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
    int node = lane < splits[tile] ? roots[tile] : roots[n_tiles + tile];
    RayData r;
    r.ox = r0.x; r.oy = r0.y; r.oz = r0.z;
    r.dx = r0.w; r.dy = r1.x; r.dz = r1.y;
    r.ix = clamp_inv(r.dx); r.iy = clamp_inv(r.dy); r.iz = clamp_inv(r.dz);
    const int leaf_base = num_clusters - 1;
    int stack_node[kStackDepth];
    float stack_t[kStackDepth];
    int sp = 0;

    // the nearest stacked node whose entry is still in front of the best hit
    auto pop = [&]() -> bool {
      while (sp > 0) {
        --sp;
        if (stack_t[sp] < bt) {
          node = stack_node[sp];
          return true;
        }
      }
      return false;
    };

    while (true) {
      // inner phase: descend until this lane holds a leaf or is done
      bool walking = true;
      while (node < leaf_base) {
        bool descended = false;
        if constexpr (kFanout == 2) {
          const int left = 2 * node + 1, right = 2 * node + 2;
          const float tl = slab_entry(nodes, left, r, bt);
          const float tr = slab_entry(nodes, right, r, bt);
          if (kCount) n_box += 2;
          const bool hl = tl < INFINITY, hr = tr < INFINITY;
          if (hl && hr) {
            const bool left_first = tl <= tr;
            stack_node[sp] = left_first ? right : left;
            stack_t[sp] = left_first ? tr : tl;
            ++sp;
            node = left_first ? left : right;
          } else if (hl || hr) {
            node = hl ? left : right;
          }
          descended = hl || hr;
        } else {
          // the frontier kFanout/2 levels down (traverse.py:400-412): a
          // candidate that is a leaf stays, its empty sibling slot gets -1
          constexpr int kLevels = kFanout == 8 ? 3 : 2;
          int idx[kFanout];
          idx[0] = 2 * node + 1;
          idx[1] = 2 * node + 2;
#pragma unroll
          for (int lv = 1; lv < kLevels; ++lv) {
#pragma unroll
            for (int j = (1 << lv) - 1; j >= 0; --j) {
              const int c = idx[j];
              const bool keep = c >= leaf_base || c < 0;
              idx[2 * j] = keep ? c : 2 * c + 1;
              idx[2 * j + 1] = keep ? -1 : 2 * c + 2;
            }
          }
          float key[kFanout];
#pragma unroll
          for (int j = 0; j < kFanout; ++j) {
            key[j] = idx[j] >= 0 ? slab_entry(nodes, idx[j], r, bt)
                                 : INFINITY;
            if (kCount) n_box += idx[j] >= 0;
          }
          sort_net<kFanout>(key, idx);
          if (key[0] < INFINITY) {
            // the hit candidates behind the nearest, pushed far to near
#pragma unroll
            for (int j = kFanout - 1; j >= 1; --j) {
              if (key[j] < INFINITY) {
                stack_node[sp] = idx[j];
                stack_t[sp] = key[j];
                ++sp;
              }
            }
            node = idx[0];
            descended = true;
          }
        }
        if (!descended) walking = pop();
        if (!walking) break;
      }
      if (!walking) break;
      // leaf phase: the warp's lanes that hold a leaf test it together
      const bool found = test_cluster<kAnyHit, kCount, kHalfSkip, kK>(
          tris + static_cast<size_t>(node - leaf_base) * K * 4, K, r, bt, bp,
          bu, bv, n_box, n_tri);
      const bool more = !(kAnyHit && found) && pop();
      if (!more) break;
    }
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

// ClusterBVH traversal for NVIDIA Hopper (sm_90a), one thread per ray.
//
// Replaces the Pallas TPU kernel visionaray_tpu/ops/pallas/traverse.py::
// _traverse_kernel (launched by _cluster_traverse, traverse.py:514-586) in
// its coherent modes: closest-hit and any-hit from the root; on heap-built
// trees (children of n at 2n+1 / 2n+2) and on radix trees (children read
// from the kids columns nodes[n, 6:8], traverse.py:159-174); on heap trees
// also with 4- or 8-wide descent (traverse.py:393-441) and with the
// half-cluster skip (traverse.py:354-373).  The treelet-binned two-pass
// tiles go to traverse_binned.cu.  This kernel still reads per-tile start
// nodes (lanes [0, split) of a tile at rootA, the rest at rootB), so
// scripts/torch_kernel_ab.py can run it on the two-pass tiles beside the
// new form.
//
// Contract (the plain PyTorch version in traverse.py states it directly):
// for every lane with max_t >= 0, the nearest triangle under the lane's
// start node with 0 <= t < max_t (Moeller-Trumbore in the reference's
// operation order, strict t < best_t fold), returned as (t, prim id as an
// f32 value, u, v).  Any-hit lanes stop at the first such triangle and do
// not write u, v.  Misses and dead lanes (max_t < 0) keep t = max_t,
// prim = -1, u = v = 0.  A tree of one cluster (C == 1) has its leaf at
// node 0, so every live lane intersects cluster 0 with no box test, as the
// TPU kernel's C == 1 path does (traverse.py:300-315).  The descent width
// and the half-cluster skip change only the visiting order and the
// culling, never the contract.  The caller checks that the tree's
// worst-case stack fits.
//
// What bounds it on this card: neither the 3.35 TB/s of device memory nor
// the 67 TFLOP/s of f32 arithmetic.  The inputs that must move are small
// (32 B a ray, 64 B a triangle, the whole 260k-triangle scene is 17 MB and
// sits in the 50 MB L2); the work is dependent pointer chasing: each step
// of a ray loads a node or a cluster whose address depends on the previous
// step, and the 32 rays of a warp diverge in where they go.  So the time is
// set by memory latency and by divergence, not by bytes or flops.
//
// What the design does about that: the TPU kernel's per-tile consensus
// (SMEM scalar node walk, interval-hull frusta, 128-lane rows, tile
// interleave) is dropped.  Each thread walks its own ray with a stack in
// local memory, near child first by its slab entry distance, and skips
// popped nodes whose entry is already behind its best hit.  The callers
// sort rays (camera rays by direction octant and origin morton code,
// bounce rays by treelet, octant and entry-point morton code), so the
// threads of a warp mostly visit the same nodes and their loads coalesce
// in L1/L2.  Node boxes load as one float4 + one float2, triangle records
// as three float4 (the first 12 of 16 floats).
//
// Wide descent (kFanout 4 or 8, heap trees only): a node is expanded into
// its descendants two (three) levels down, a child that is already a leaf
// kept as it is with -1 in its empty sibling slot; the candidates are
// slab-tested against the ray's best t, ordered by entry distance with the
// reference's sorting network (_SORT_NET, traverse.py:76) in registers,
// and the walk continues at the nearest while the others are pushed
// far-to-near with their entry distances, so the pop loop still culls them
// against the best hit.  It trades fewer, longer loop iterations for box
// tests of grandchildren that binary descent might have culled at their
// parent.  The half-cluster skip (kHalfSkip): at a leaf the two boxes of
// the cluster's K/2 halves (floats 10..15 of records 0 and 1, written by
// the kd build) are slab-tested first, and a half's triangles are tested
// only if the ray enters its box before its best hit.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17
// -fmad=false -Xcompiler -fPIC -c, beside traverse_binned.cu, linked into
// one shared library.  -fmad=false keeps every product and sum separately
// rounded, as the plain PyTorch version's elementwise ops are, so the two
// agree to the bit on the same triangle.

#include "traverse_common.cuh"

namespace {

// Children of internal node n: arithmetic on a heap, the kids columns
// (float values, exact below 2^24) on a radix tree.
template <bool kHeap>
__device__ __forceinline__ void children(const float* __restrict__ nodes,
                                         int n, int& left, int& right) {
  if (kHeap) {
    left = 2 * n + 1;
    right = 2 * n + 2;
  } else {
    const float2 k = __ldg(reinterpret_cast<const float2*>(nodes + 8 * n + 6));
    left = static_cast<int>(k.x);
    right = static_cast<int>(k.y);
  }
}

template <bool kAnyHit, bool kCount, bool kHeap, int kFanout, bool kHalfSkip>
__global__ void __launch_bounds__(128)
traverse_kernel(const float4* __restrict__ rays,    // (npad, 8) as 2 float4
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
  static_assert(kFanout == 2 || kHeap, "wide descent needs a heap tree");
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= npad) return;
  const float4 r0 = rays[2 * i];      // ox oy oz dx
  const float4 r1 = rays[2 * i + 1];  // dy dz max_t pad
  const float max_t = r1.z;
  float bt = max_t, bp = -1.0f, bu = 0.0f, bv = 0.0f;
  int n_box = 0, n_tri = 0;

  if (max_t >= 0.0f) {
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
    bool done = false;

    while (true) {
      if (node >= leaf_base) {
        const float4* rec =
            tris + static_cast<size_t>(node - leaf_base) * cluster_size * 4;
        if constexpr (kHalfSkip) {
          // half h's box: floats 10..15 of record h = lo.xyz hi.xyz
          const int half = cluster_size / 2;
          for (int h = 0; h < 2 && !done; ++h) {
            const float4 c = __ldg(rec + 4 * h + 2);  // e2z pid lo.x lo.y
            const float4 d = __ldg(rec + 4 * h + 3);  // lo.z hi.x hi.y hi.z
            if (kCount) ++n_box;
            if (box_entry(c.z, c.w, d.x, d.y, d.z, d.w, r, bt) < bt)
              done = intersect_records<kAnyHit, kCount>(
                  rec, h * half, (h + 1) * half, r, bt, bp, bu, bv, n_tri);
          }
        } else {
          // the same loop as intersect_records, inline (see there)
          for (int k = 0; k < cluster_size; ++k) {
            const float4 a = __ldg(rec + 4 * k);      // v1x v1y v1z e1x
            const float4 b = __ldg(rec + 4 * k + 1);  // e1y e1z e2x e2y
            const float4 c = __ldg(rec + 4 * k + 2);  // e2z pid pad pad
            if (kCount) ++n_tri;
            const float v1x = a.x, v1y = a.y, v1z = a.z;
            const float e1x = a.w, e1y = b.x, e1z = b.y;
            const float e2x = b.z, e2y = b.w, e2z = c.x;
            // operation order of traverse.py:258-274
            const float s1x = r.dy * e2z - r.dz * e2y;
            const float s1y = r.dz * e2x - r.dx * e2z;
            const float s1z = r.dx * e2y - r.dy * e2x;
            const float div = s1x * e1x + s1y * e1y + s1z * e1z;
            bool ok = div != 0.0f;
            const float inv_div = 1.0f / (ok ? div : 1.0f);
            const float ddx = r.ox - v1x;
            const float ddy = r.oy - v1y;
            const float ddz = r.oz - v1z;
            const float b1 = (ddx * s1x + ddy * s1y + ddz * s1z) * inv_div;
            ok = ok && (b1 >= 0.0f) && (b1 <= 1.0f);
            const float s2x = ddy * e1z - ddz * e1y;
            const float s2y = ddz * e1x - ddx * e1z;
            const float s2z = ddx * e1y - ddy * e1x;
            const float b2 = (r.dx * s2x + r.dy * s2y + r.dz * s2z) * inv_div;
            ok = ok && (b2 >= 0.0f) && (b1 + b2 <= 1.0f);
            const float t = (e2x * s2x + e2y * s2y + e2z * s2z) * inv_div;
            if (ok && t >= 0.0f && t < bt) {
              bt = t;
              bp = c.y;
              if (kAnyHit) {
                done = true;
                break;
              }
              bu = b1;
              bv = b2;
            }
          }
        }
        if (kAnyHit && done) break;
      } else if constexpr (kFanout == 2) {
        int left, right;
        children<kHeap>(nodes, node, left, right);
        const float tl = slab_entry(nodes, left, r, bt);
        const float tr = slab_entry(nodes, right, r, bt);
        if (kCount) n_box += 2;
        const bool hl = tl < INFINITY, hr = tr < INFINITY;
        if (hl || hr) {
          if (hl && hr) {
            const bool left_first = tl <= tr;
            stack_node[sp] = left_first ? right : left;
            stack_t[sp] = left_first ? tr : tl;
            ++sp;
            node = left_first ? left : right;
          } else {
            node = hl ? left : right;
          }
          continue;
        }
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
          key[j] = idx[j] >= 0 ? slab_entry(nodes, idx[j], r, bt) : INFINITY;
          if (kCount) n_box += idx[j] >= 0;
        }
        sort_net<kFanout>(key, idx);
        if (key[0] < INFINITY) {
          // push the hit candidates behind the nearest, far to near, so
          // the nearest of them is on top
#pragma unroll
          for (int j = kFanout - 1; j >= 1; --j) {
            if (key[j] < INFINITY) {
              stack_node[sp] = idx[j];
              stack_t[sp] = key[j];
              ++sp;
            }
          }
          node = idx[0];
          continue;
        }
      }
      // pop the next node whose entry is still in front of the best hit
      bool found = false;
      while (sp > 0) {
        --sp;
        if (stack_t[sp] < bt) {
          node = stack_node[sp];
          found = true;
          break;
        }
      }
      if (!found) break;
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

struct LaunchArgs {
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

template <bool kAnyHit, bool kCount, bool kHeap, int kFanout, bool kHalfSkip>
void launch(const LaunchArgs& a) {
  traverse_kernel<kAnyHit, kCount, kHeap, kFanout, kHalfSkip>
      <<<a.grid, a.block, 0, a.stream>>>(
          a.rays, a.nodes, a.tris, a.roots, a.splits, a.out_t, a.out_prim,
          a.out_u, a.out_v, a.counters, a.npad, a.n_tiles, a.tile_lanes,
          a.num_clusters, a.cluster_size);
}

// The instantiation for (heap, fanout, half_skip); false for a
// combination the kernel does not take (wide descent or the half skip on a
// radix tree, a fanout other than 2, 4, 8).
template <bool kAnyHit, bool kCount>
bool launch_tree(const LaunchArgs& a, int heap, int fanout, int half_skip) {
  if (!heap) {
    if (fanout != 2 || half_skip) return false;
    launch<kAnyHit, kCount, false, 2, false>(a);
    return true;
  }
  switch (fanout * 2 + (half_skip ? 1 : 0)) {
    case 4: launch<kAnyHit, kCount, true, 2, false>(a); return true;
    case 5: launch<kAnyHit, kCount, true, 2, true>(a); return true;
    case 8: launch<kAnyHit, kCount, true, 4, false>(a); return true;
    case 9: launch<kAnyHit, kCount, true, 4, true>(a); return true;
    case 16: launch<kAnyHit, kCount, true, 8, false>(a); return true;
    case 17: launch<kAnyHit, kCount, true, 8, true>(a); return true;
    default: return false;
  }
}

}  // namespace

// Plain C entry point for ctypes.  Launches on ``stream`` and returns
// cudaGetLastError() of the launch (0 = success), or cudaErrorInvalidValue
// without launching for an option the kernel does not take.
extern "C" int vsnray_traverse(const void* rays, const void* nodes,
                               const void* tris, const void* roots,
                               const void* splits, void* out_t,
                               void* out_prim, void* out_u, void* out_v,
                               void* counters, int npad, int n_tiles,
                               int tile_lanes, int num_clusters,
                               int cluster_size, int any_hit, int heap,
                               int fanout, int half_skip, void* stream) {
  LaunchArgs a;
  a.block = dim3(128);
  a.grid = dim3((npad + 127) / 128);
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
    ok = a.counters ? launch_tree<true, true>(a, heap, fanout, half_skip)
                    : launch_tree<true, false>(a, heap, fanout, half_skip);
  } else {
    ok = a.counters ? launch_tree<false, true>(a, heap, fanout, half_skip)
                    : launch_tree<false, false>(a, heap, fanout, half_skip);
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

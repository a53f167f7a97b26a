// Radix-tree ClusterBVH traversal for NVIDIA Hopper (sm_90a), one thread
// per ray: PERF.md row 1e.
//
// Replaces the Pallas TPU kernel visionaray_tpu/ops/pallas/traverse.py::
// _traverse_kernel (launched by _cluster_traverse, traverse.py:514-586) on
// trees that are not heap-built: closest-hit and any-hit from the root of a
// radix tree, children read from the kids columns nodes[n, 6:8]
// (traverse.py:159-174), and the single-cluster tree (C == 1).  Heap trees
// go to traverse_coherent.cu (coherent tiles: binary descent, K = 8, 16,
// 32) and traverse_binned.cu (two-pass tiles, and every other coherent
// form).  The kernel still reads per-tile start nodes (lanes [0, split) of
// a tile at rootA, the rest at rootB); the wrapper passes node 0 for all.
//
// Contract (the plain PyTorch version in traverse.py states it directly):
// for every lane with max_t >= 0, the nearest triangle under the lane's
// start node with 0 <= t < max_t (Moeller-Trumbore in the reference's
// operation order, strict t < best_t fold), returned as (t, prim id as an
// f32 value, u, v).  Any-hit lanes stop at the first such triangle and do
// not write u, v.  Misses and dead lanes (max_t < 0) keep t = max_t,
// prim = -1, u = v = 0.  A tree of one cluster (C == 1) has its leaf at
// node 0, so every live lane intersects cluster 0 with no box test, as the
// TPU kernel's C == 1 path does (traverse.py:300-315).  The caller checks
// that the tree's worst-case stack fits.
//
// What bounds it on this card: neither the 3.35 TB/s of device memory nor
// the 67 TFLOP/s of f32 arithmetic.  The inputs that must move are small
// (32 B a ray, 64 B a triangle, the whole 260k-triangle scene is 17 MB and
// sits in the 50 MB L2); the work is dependent pointer chasing: each step
// of a ray loads a node or a cluster whose address depends on the previous
// step, and the 32 rays of a warp diverge in where they go.  So the time is
// set by memory latency and by divergence, not by bytes or flops.
//
// What the design does about that: each thread walks its own ray with a
// stack in local memory, near child first by its slab entry distance, and
// skips popped nodes whose entry is already behind its best hit.  One loop
// iteration handles one inner node or one whole cluster (run-time K).
// Node boxes load as one float4 + one float2, triangle records as three
// float4 (the first 12 of 16 floats).  The heap forms this loop once
// served were redesigned in traverse_binned.cu and traverse_coherent.cu;
// the radix forms keep the SASS they had.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17
// -fmad=false -Xcompiler -fPIC -c, beside traverse_binned.cu and
// traverse_coherent.cu, linked into one shared library.  -fmad=false keeps
// every product and sum separately rounded, as the plain PyTorch version's
// elementwise ops are, so the two agree to the bit on the same triangle.

#include "traverse_common.cuh"

namespace {

template <bool kAnyHit, bool kCount>
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
        if (kAnyHit && done) break;
      } else {
        // children from the kids columns (float values, exact below 2^24)
        const float2 kids =
            __ldg(reinterpret_cast<const float2*>(nodes + 8 * node + 6));
        const int left = static_cast<int>(kids.x);
        const int right = static_cast<int>(kids.y);
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

template <bool kAnyHit, bool kCount>
void launch(const LaunchArgs& a) {
  traverse_kernel<kAnyHit, kCount><<<a.grid, a.block, 0, a.stream>>>(
      a.rays, a.nodes, a.tris, a.roots, a.splits, a.out_t, a.out_prim,
      a.out_u, a.out_v, a.counters, a.npad, a.n_tiles, a.tile_lanes,
      a.num_clusters, a.cluster_size);
}

}  // namespace

// Plain C entry point for ctypes, for radix trees (and C == 1).  Launches on
// ``stream`` and returns cudaGetLastError() of the launch (0 = success).
extern "C" int vsnray_traverse(const void* rays, const void* nodes,
                               const void* tris, const void* roots,
                               const void* splits, void* out_t,
                               void* out_prim, void* out_u, void* out_v,
                               void* counters, int npad, int n_tiles,
                               int tile_lanes, int num_clusters,
                               int cluster_size, int any_hit, void* stream) {
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
  if (any_hit) {
    if (a.counters) launch<true, true>(a); else launch<true, false>(a);
  } else {
    if (a.counters) launch<false, true>(a); else launch<false, false>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

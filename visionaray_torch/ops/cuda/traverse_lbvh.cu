// The LBVH tier's per-ray stack walk over a flat BVH (ops/lbvh.py BVH:
// LBVH, native SAH and SBVH builds, sphere LBVHs), one thread per ray.
//
// Replaces: the JAX package's jnp traversal tier,
// visionaray_tpu/ops/traversal.py _traverse_one (:33-151, vmapped by
// _traverse_batch_isect :154-186) and _traverse_one_multi (:226-306).
// That tier has no pl.pallas_call: XLA compiles its vmapped while_loop
// into one device loop.  Eager PyTorch would drive that loop from the
// host, one iteration per node visit, so on the card the walk is this
// kernel.
//
// What it computes, per lane, exactly as the JAX walk and its plain
// version ops/traversal.py::traverse_bvh_plain do: from node 0, one node
// per step; at an internal node both children get the slab test, and a
// child is entered when hit && tnear < best_t && tfar >= 0; with both
// entered, the near child (the left iff tn_left < tn_right) is taken and
// the far one pushed; otherwise the one that passed, else a pop.  A leaf
// tests its primitive (1:1 leaves) or its leaf_count references
// (generalized SBVH leaves) with the strict 0 <= t < best_t; any-hit
// stops after the first leaf holding an accepted hit; multi-hit inserts
// into the lane's t-sorted k-array (JAX's stable pos = sum(t >= ts)) and
// culls against its last entry.  1/d is not clamped and the slab test's
// min/max propagate NaN (jnp.minimum/maximum do; fminf/fmaxf do not): a
// zero direction component on a box plane gives 0 * inf = NaN, and the box
// is missed.  Operation orders are those of ops/intersect.py, so with
// -fmad=false t is bit-equal to the plain version's.
//
// Bound: the least time for a launch's work is set by its box tests'
// operations (~20 a box; for the any-hit and multi-hit forms by the bytes
// of the tables), but a walk is a chain of dependent gathers, and each
// step issues far more instructions than the 20 operations counted: the
// first design, which read JAX's SoA tables scalar by scalar, ran at 5-7%
// of the bound on the 1080p frames, and its time followed the
// instructions a step issues more than the sectors it reads.  This design
// (Aila & Laine, "Understanding the Efficiency of Ray Traversal on GPUs",
// HPG 2009, fitted to the walk's fixed visit order) cuts both:
// - packed nodes (ops/traversal.py::pack_nodes, built once per BVH on the
//   card): internal node i is one 64-byte record of 4 float4s, both
//   children's boxes and both children's codes, read with vector __ldg,
//   so a step is one dependent hop of two sectors (the first design made
//   two hops, left/right then 12 scalar box loads over 4-6 sectors).  A
//   child's code is its node index if it is internal and ~leaf if it is a
//   leaf, where leaf points straight at the leaf's first primitive record
//   (1:1 leaves: the leaf slot, a reference index) or packs
//   (first << leaf_bits) | count (generalized leaves), so a leaf costs no
//   hop through leaf_first / leaf_count;
// - packed primitives (pack_prims): the records in reference order, a
//   triangle 3 float4s (v1, e1, e2), a sphere one (centre, radius), so a
//   leaf test reads one contiguous record, no prim_ids hop;
// - the slab test's NaN-propagating min / max as one instruction each
//   (nan_minmax.cuh: PTX min.NaN / max.NaN) where the first design spent
//   a NaN test, a min and a select on each of its 24 a step: this halved
//   the launch (PERF.md);
// - one node or one leaf a loop iteration, as the first design.  Aila and
//   Laine's while-while loop (descend until every lane of the warp holds
//   a leaf, then test leaves) measured slower here: a 1:1 leaf is one
//   primitive, so lanes waited on the warp's longest descent for a short
//   leaf phase; so did a persistent grid whose lanes fetch a new ray as
//   they finish.  Speculative traversal is not used: it would change the
//   visit order and the counts the bound is taken from;
// - the stack in local memory (L1-resident), lanes with max_t <= 0
//   retiring before their first load.
//
// Forms (template parameters): the primitive (triangle: Moeller-Trumbore;
// sphere: the stable quadratic, the smaller root even if negative, then
// t >= 0), the mode (closest, any, multi), the leaf convention (1:1 or
// generalized) and per-lane counters (box and primitive tests).

#include <cuda_runtime.h>
#include <math.h>

#include "nan_minmax.cuh"

namespace {

constexpr int kStackDepth = 64;   // traversal.py STACK_DEPTH
constexpr int kBlock = 128;

enum Prim { kTriangle = 0, kSphere = 1 };
enum Mode { kClosest = 0, kAny = 1, kMulti = 2 };

struct LbvhArgs {
  const float* ori;
  const float* dir;
  const float* max_t;
  const float4* nodes;   // (L - 1, 4): see pack_nodes
  const float4* prims;   // triangles (R, 3): v1, e1, e2; spheres (R,)
  float* out_t;
  int* out_ref;
  int* counters;
  int n, num_refs, leaf_bits, root, k;
};

struct Lane {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
};

// JAX intersect_aabb of one box: tnear, tfar; hit = tfar >= tnear.
__device__ __forceinline__ bool slab(float lox, float hix, float loy,
                                     float hiy, float loz, float hiz,
                                     const Lane& r, float& tnear,
                                     float& tfar) {
  const float t1x = (lox - r.ox) * r.ix;
  const float t1y = (loy - r.oy) * r.iy;
  const float t1z = (loz - r.oz) * r.iz;
  const float t2x = (hix - r.ox) * r.ix;
  const float t2y = (hiy - r.oy) * r.iy;
  const float t2z = (hiz - r.oz) * r.iz;
  tnear = nan_max(nan_max(nan_min(t1x, t2x), nan_min(t1y, t2y)),
                  nan_min(t1z, t2z));
  tfar = nan_min(nan_min(nan_max(t1x, t2x), nan_max(t1y, t2y)),
                 nan_max(t1z, t2z));
  return tfar >= tnear;
}

// ops/intersect.py intersect_triangle, in its operation order.
__device__ __forceinline__ bool triangle(const LbvhArgs& a, int ref,
                                         const Lane& r, float& t) {
  const float4 v1 = __ldg(a.prims + 3 * ref);
  const float4 e1 = __ldg(a.prims + 3 * ref + 1);
  const float4 e2 = __ldg(a.prims + 3 * ref + 2);
  const float s1x = r.dy * e2.z - r.dz * e2.y;
  const float s1y = r.dz * e2.x - r.dx * e2.z;
  const float s1z = r.dx * e2.y - r.dy * e2.x;
  const float div = s1x * e1.x + s1y * e1.y + s1z * e1.z;
  bool ok = div != 0.0f;
  const float inv_div = ok ? 1.0f / div : 0.0f;
  const float ddx = r.ox - v1.x;
  const float ddy = r.oy - v1.y;
  const float ddz = r.oz - v1.z;
  const float b1 = (ddx * s1x + ddy * s1y + ddz * s1z) * inv_div;
  ok = ok && (b1 >= 0.0f) && (b1 <= 1.0f);
  const float s2x = ddy * e1.z - ddz * e1.y;
  const float s2y = ddz * e1.x - ddx * e1.z;
  const float s2z = ddx * e1.y - ddy * e1.x;
  const float b2 = (r.dx * s2x + r.dy * s2y + r.dz * s2z) * inv_div;
  ok = ok && (b2 >= 0.0f) && (b1 + b2 <= 1.0f);
  t = (e2.x * s2x + e2.y * s2y + e2.z * s2z) * inv_div;
  return ok;
}

// ops/intersect.py intersect_sphere, in its operation order.
__device__ __forceinline__ bool sphere(const LbvhArgs& a, int ref,
                                       const Lane& r, float& t) {
  const float4 c = __ldg(a.prims + ref);
  const float rad = c.w;
  const float ox = r.ox - c.x, oy = r.oy - c.y;
  const float oz = r.oz - c.z;
  const float A = r.dx * r.dx + r.dy * r.dy + r.dz * r.dz;
  const float B = 2.0f * (r.dx * ox + r.dy * oy + r.dz * oz);
  const float C = (ox * ox + oy * oy + oz * oz) - rad * rad;
  const float disc = B * B - 4.0f * A * C;
  const bool valid = disc >= 0.0f;
  const float root = sqrtf(valid ? disc : 0.0f);
  const float q = B < 0.0f ? -0.5f * (B - root) : -0.5f * (B + root);
  const float safe_q = q != 0.0f ? q : 1.0f;
  const float safe_a = A != 0.0f ? A : 1.0f;
  t = valid ? nan_min(q / safe_a, C / safe_q) : -1.0f;
  return valid;
}

template <int kPrim>
__device__ __forceinline__ bool prim_test(const LbvhArgs& a, int ref,
                                          const Lane& r, float& t) {
  return kPrim == kTriangle ? triangle(a, ref, r, t) : sphere(a, ref, r, t);
}

template <int kPrim, int kMode, bool kGen, bool kCount>
__global__ void __launch_bounds__(kBlock) lbvh_kernel(LbvhArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  const float mt = a.max_t[i];
  float bt = mt;
  int br = -1;
  float* ts = a.out_t + (kMode == kMulti ? i * a.k : i);
  int* ls = a.out_ref + (kMode == kMulti ? i * a.k : i);
  if (kMode == kMulti) {
    for (int j = 0; j < a.k; ++j) {
      ts[j] = mt;
      ls[j] = -1;
    }
  }
  int n_box = 0, n_prim = 0;
  // no hit satisfies 0 <= t < max_t <= 0 (nor a NaN max_t): retire
  if (mt > 0.0f) {
    Lane r;
    r.ox = a.ori[3 * i];
    r.oy = a.ori[3 * i + 1];
    r.oz = a.ori[3 * i + 2];
    r.dx = a.dir[3 * i];
    r.dy = a.dir[3 * i + 1];
    r.dz = a.dir[3 * i + 2];
    r.ix = 1.0f / r.dx;
    r.iy = 1.0f / r.dy;
    r.iz = 1.0f / r.dz;
    const unsigned count_mask = (1u << a.leaf_bits) - 1u;
    int stack[kStackDepth];
    int sp = 0;
    int node = a.root;   // >= 0 internal, else ~leaf
    float worst = mt;    // multi: the k-array's last entry
    while (true) {
      if (node < 0) {
        const unsigned code = ~static_cast<unsigned>(node);
        int first = static_cast<int>(code), cnt = 1;
        if (kGen) {
          first = static_cast<int>(code >> a.leaf_bits);
          cnt = static_cast<int>(code & count_mask);
        }
        for (int j = 0; j < cnt; ++j) {
          const int ref = min(first + j, a.num_refs - 1);
          float t;
          const bool hit = prim_test<kPrim>(a, ref, r, t);
          if (kCount) ++n_prim;
          if (kMode == kMulti) {
            if (hit && t >= 0.0f && t < worst) {
              int pos = 0;
              for (int s = 0; s < a.k; ++s) pos += (t >= ts[s]) ? 1 : 0;
              for (int s = a.k - 1; s > pos; --s) {
                ts[s] = ts[s - 1];
                ls[s] = ls[s - 1];
              }
              ts[pos] = t;
              ls[pos] = ref;
              worst = ts[a.k - 1];
            }
          } else if (hit && t >= 0.0f && t < bt) {
            bt = t;
            br = ref;
          }
        }
        if ((kMode == kAny && br >= 0) || sp == 0) break;
        node = stack[--sp];
        continue;
      }
      const float4* rec = a.nodes + 4 * node;
      const float4 n0 = __ldg(rec);       // left lo.x hi.x lo.y hi.y
      const float4 n1 = __ldg(rec + 1);   // right lo.x hi.x lo.y hi.y
      const float4 n2 = __ldg(rec + 2);   // left lo.z hi.z, right's
      const int4 n3 = __ldg(reinterpret_cast<const int4*>(rec + 3));
      float tn1, tf1, tn2, tf2;
      const bool h1 = slab(n0.x, n0.y, n0.z, n0.w, n2.x, n2.y, r, tn1, tf1);
      const bool h2 = slab(n1.x, n1.y, n1.z, n1.w, n2.z, n2.w, r, tn2, tf2);
      if (kCount) n_box += 2;
      const float bound = kMode == kMulti ? worst : bt;
      const bool b1 = h1 && tn1 < bound && tf1 >= 0.0f;
      const bool b2 = h2 && tn2 < bound && tf2 >= 0.0f;
      if (b1 && b2) {
        const bool near_left = tn1 < tn2;
        // the wrapper refuses trees deeper than the stack; JAX's clip
        stack[min(sp, kStackDepth - 1)] = near_left ? n3.y : n3.x;
        sp = min(sp + 1, kStackDepth);
        node = near_left ? n3.x : n3.y;
      } else if (b1) {
        node = n3.x;
      } else if (b2) {
        node = n3.y;
      } else {
        if (sp == 0) break;
        node = stack[--sp];
      }
    }
  }
  if (kMode != kMulti) {
    a.out_t[i] = bt;
    a.out_ref[i] = br;
  }
  if (kCount) {
    a.counters[2 * i] = n_box;
    a.counters[2 * i + 1] = n_prim;
  }
}

template <int kPrim, int kMode, bool kGen>
cudaError_t launch_count(const LbvhArgs& a, bool count, cudaStream_t s) {
  const dim3 grid((a.n + kBlock - 1) / kBlock);
  if (count) {
    lbvh_kernel<kPrim, kMode, kGen, true><<<grid, kBlock, 0, s>>>(a);
  } else {
    lbvh_kernel<kPrim, kMode, kGen, false><<<grid, kBlock, 0, s>>>(a);
  }
  return cudaGetLastError();
}

template <int kPrim, int kMode>
cudaError_t launch_gen(const LbvhArgs& a, bool gen, bool count,
                       cudaStream_t s) {
  return gen ? launch_count<kPrim, kMode, true>(a, count, s)
             : launch_count<kPrim, kMode, false>(a, count, s);
}

}  // namespace

// nodes: (L - 1) 64-byte records, 16-byte aligned (null for a single
// leaf); prims: the primitive records in reference order; root: the root's
// code (0, or ~leaf of the single leaf); leaf_bits: the count's bits in a
// generalized leaf's code.  prim: 0 triangle, 1 sphere; mode: 0 closest,
// 1 any, 2 multi (triangles on 1:1 leaves only).
extern "C" int vsnray_traverse_lbvh(
    const void* ori, const void* dir, const void* max_t, const void* nodes,
    const void* prims, void* out_t, void* out_ref, void* counters, int n,
    int num_refs, int leaf_bits, int root, int k, int prim, int mode,
    int generalized, void* stream) {
  LbvhArgs a;
  a.ori = static_cast<const float*>(ori);
  a.dir = static_cast<const float*>(dir);
  a.max_t = static_cast<const float*>(max_t);
  a.nodes = static_cast<const float4*>(nodes);
  a.prims = static_cast<const float4*>(prims);
  a.out_t = static_cast<float*>(out_t);
  a.out_ref = static_cast<int*>(out_ref);
  a.counters = static_cast<int*>(counters);
  a.n = n;
  a.num_refs = num_refs;
  a.leaf_bits = leaf_bits;
  a.root = root;
  a.k = k;
  const bool gen = generalized != 0;
  const bool count = a.counters != nullptr;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || k < 1 || num_refs < 1 || !a.prims ||
      (root >= 0 && !a.nodes) || leaf_bits < 0 || leaf_bits > 30 ||
      (!gen && leaf_bits != 0) ||
      (mode == kMulti && (prim != kTriangle || gen))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err;
  if (prim == kTriangle) {
    if (mode == kClosest) {
      err = launch_gen<kTriangle, kClosest>(a, gen, count, s);
    } else if (mode == kAny) {
      err = launch_gen<kTriangle, kAny>(a, gen, count, s);
    } else {
      err = launch_count<kTriangle, kMulti, false>(a, count, s);
    }
  } else if (prim == kSphere) {
    if (mode == kClosest) {
      err = launch_gen<kSphere, kClosest>(a, gen, count, s);
    } else if (mode == kAny) {
      err = launch_gen<kSphere, kAny>(a, gen, count, s);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

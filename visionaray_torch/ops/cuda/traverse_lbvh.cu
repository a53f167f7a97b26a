// The LBVH tier's per-ray stack walk over a flat BVH (ops/lbvh.py BVH:
// LBVH, native SAH and SBVH builds, sphere LBVHs), one thread per ray.
//
// Replaces: the JAX package's jnp traversal tier,
// visionaray_tpu/ops/traversal.py _traverse_one (:33-151, vmapped by
// _traverse_batch_isect :154-186) and _traverse_one_multi (:226-306).
// That tier has no pl.pallas_call: XLA compiles its vmapped while_loop
// into one device loop.  Eager PyTorch would drive that loop from the
// host, one iteration per node visit, so on the card the walk is this
// kernel (the reference's own CUDA design, one thread per pixel with a
// stack in local memory).
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
// of the tables), but a walk is a chain of dependent gathers of 12-byte
// node boxes and 4-byte child links, each its own 32-byte sector, and
// their latency is what this design expects to hold it (PERF.md: 6.7% of
// the operations bound on 1080p primary rays; incoherent rays cost 2-3.5x
// more per box test).  This first design does nothing about it beyond one
// thread per ray, the stack in local memory (L1-resident), read-only loads
// through __ldg, and lanes with max_t <= 0 retiring before their first
// load: it reads JAX's tables as they are (SoA node_lo, node_hi, left,
// right, prim_ids; the mesh's v1, e1, e2 or the spheres' center, radius).
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
  const float* node_lo;
  const float* node_hi;
  const int* left;
  const int* right;
  const int* prim_ids;
  const int* leaf_first;
  const int* leaf_count;
  const float* p0;   // v1 or center
  const float* p1;   // e1 or radius
  const float* p2;   // e2
  float* out_t;
  int* out_ref;
  int* counters;
  int n, num_nodes, num_refs, max_leaf_size, k;
};

struct Lane {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
};

// JAX intersect_aabb of node n's box: tnear, tfar; hit = tfar >= tnear.
__device__ __forceinline__ bool slab(const LbvhArgs& a, int n, const Lane& r,
                                     float& tnear, float& tfar) {
  const float* lo = a.node_lo + 3 * n;
  const float* hi = a.node_hi + 3 * n;
  const float t1x = (__ldg(lo + 0) - r.ox) * r.ix;
  const float t1y = (__ldg(lo + 1) - r.oy) * r.iy;
  const float t1z = (__ldg(lo + 2) - r.oz) * r.iz;
  const float t2x = (__ldg(hi + 0) - r.ox) * r.ix;
  const float t2y = (__ldg(hi + 1) - r.oy) * r.iy;
  const float t2z = (__ldg(hi + 2) - r.oz) * r.iz;
  tnear = nan_max(nan_max(nan_min(t1x, t2x), nan_min(t1y, t2y)),
                  nan_min(t1z, t2z));
  tfar = nan_min(nan_min(nan_max(t1x, t2x), nan_max(t1y, t2y)),
                 nan_max(t1z, t2z));
  return tfar >= tnear;
}

// ops/intersect.py intersect_triangle, in its operation order.
__device__ __forceinline__ bool triangle(const LbvhArgs& a, int pid,
                                         const Lane& r, float& t) {
  const float* v1 = a.p0 + 3 * pid;
  const float* e1 = a.p1 + 3 * pid;
  const float* e2 = a.p2 + 3 * pid;
  const float v1x = __ldg(v1), v1y = __ldg(v1 + 1), v1z = __ldg(v1 + 2);
  const float e1x = __ldg(e1), e1y = __ldg(e1 + 1), e1z = __ldg(e1 + 2);
  const float e2x = __ldg(e2), e2y = __ldg(e2 + 1), e2z = __ldg(e2 + 2);
  const float s1x = r.dy * e2z - r.dz * e2y;
  const float s1y = r.dz * e2x - r.dx * e2z;
  const float s1z = r.dx * e2y - r.dy * e2x;
  const float div = s1x * e1x + s1y * e1y + s1z * e1z;
  bool ok = div != 0.0f;
  const float inv_div = ok ? 1.0f / div : 0.0f;
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
  t = (e2x * s2x + e2y * s2y + e2z * s2z) * inv_div;
  return ok;
}

// ops/intersect.py intersect_sphere, in its operation order.
__device__ __forceinline__ bool sphere(const LbvhArgs& a, int pid,
                                       const Lane& r, float& t) {
  const float* c = a.p0 + 3 * pid;
  const float rad = __ldg(a.p1 + pid);
  const float ox = r.ox - __ldg(c), oy = r.oy - __ldg(c + 1);
  const float oz = r.oz - __ldg(c + 2);
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
__device__ __forceinline__ bool prim_test(const LbvhArgs& a, int pid,
                                          const Lane& r, float& t) {
  return kPrim == kTriangle ? triangle(a, pid, r, t) : sphere(a, pid, r, t);
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
    const int leaf_base = (a.num_nodes + 1) / 2 - 1;
    int stack[kStackDepth];
    int sp = 0;
    int node = leaf_base > 0 ? 0 : leaf_base;
    float worst = mt;   // multi: the k-array's last entry
    while (true) {
      if (node >= leaf_base) {
        const int slot = node - leaf_base;
        int first = slot, cnt = 1;
        if (kGen) {
          first = __ldg(a.leaf_first + slot);
          cnt = min(__ldg(a.leaf_count + slot), a.max_leaf_size);
        }
        for (int j = 0; j < cnt; ++j) {
          const int ref = min(first + j, a.num_refs - 1);
          float t;
          const bool hit = prim_test<kPrim>(a, __ldg(a.prim_ids + ref), r, t);
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
        if (kMode == kAny && br >= 0) break;
        if (sp == 0) break;
        node = stack[--sp];
        continue;
      }
      const int lc = __ldg(a.left + node);
      const int rc = __ldg(a.right + node);
      float tn1, tf1, tn2, tf2;
      const bool h1 = slab(a, lc, r, tn1, tf1);
      const bool h2 = slab(a, rc, r, tn2, tf2);
      if (kCount) n_box += 2;
      const float bound = kMode == kMulti ? worst : bt;
      const bool b1 = h1 && tn1 < bound && tf1 >= 0.0f;
      const bool b2 = h2 && tn2 < bound && tf2 >= 0.0f;
      if (b1 && b2) {
        const bool near_left = tn1 < tn2;
        // the wrapper refuses trees deeper than the stack; JAX's clip
        stack[min(sp, kStackDepth - 1)] = near_left ? rc : lc;
        sp = min(sp + 1, kStackDepth);
        node = near_left ? lc : rc;
      } else if (b1) {
        node = lc;
      } else if (b2) {
        node = rc;
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

// prim: 0 triangle, 1 sphere; mode: 0 closest, 1 any, 2 multi (triangles
// on 1:1 leaves only); generalized: leaves read leaf_first / leaf_count.
extern "C" int vsnray_traverse_lbvh(
    const void* ori, const void* dir, const void* max_t, const void* node_lo,
    const void* node_hi, const void* left, const void* right,
    const void* prim_ids, const void* leaf_first, const void* leaf_count,
    const void* p0, const void* p1, const void* p2, void* out_t,
    void* out_ref, void* counters, int n, int num_nodes, int num_refs,
    int max_leaf_size, int k, int prim, int mode, int generalized,
    void* stream) {
  LbvhArgs a;
  a.ori = static_cast<const float*>(ori);
  a.dir = static_cast<const float*>(dir);
  a.max_t = static_cast<const float*>(max_t);
  a.node_lo = static_cast<const float*>(node_lo);
  a.node_hi = static_cast<const float*>(node_hi);
  a.left = static_cast<const int*>(left);
  a.right = static_cast<const int*>(right);
  a.prim_ids = static_cast<const int*>(prim_ids);
  a.leaf_first = static_cast<const int*>(leaf_first);
  a.leaf_count = static_cast<const int*>(leaf_count);
  a.p0 = static_cast<const float*>(p0);
  a.p1 = static_cast<const float*>(p1);
  a.p2 = static_cast<const float*>(p2);
  a.out_t = static_cast<float*>(out_t);
  a.out_ref = static_cast<int*>(out_ref);
  a.counters = static_cast<int*>(counters);
  a.n = n;
  a.num_nodes = num_nodes;
  a.num_refs = num_refs;
  a.max_leaf_size = max_leaf_size;
  a.k = k;
  const bool gen = generalized != 0;
  const bool count = a.counters != nullptr;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || k < 1 || (gen && (!a.leaf_first || !a.leaf_count)) ||
      (prim == kTriangle && !a.p2) ||
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

// The shading of one bounce of the path tracer, around its two LBVH walks:
// vsnray_bounce_shade_hit between the closest walk and the shadow walk,
// vsnray_bounce_shade_close after the shadow walk.  One thread per lane.
//
// Replaces: no TPU kernel.  The JAX package's bounce body
// (visionaray_tpu/kernels/pathtracing.py, the jnp code between its
// traversals) is elementwise glue that XLA fuses into a few device loops;
// eager PyTorch runs it as ~680 separate kernels a bounce
// (kernels/pathtracing.py::pathtrace_loop.bounce_body), each a full pass
// over every lane, and the host spends ~19 us launching each.  These two
// kernels are that glue, for the inference path tracer on a triangle
// scene with an LBVH-tier tree, point lights and RGB colour
// (kernels/pathtracing.py::_fused_ok).
//
// What they compute, per lane, in the torch body's order of operations:
// - hit: the winning triangle of the closest walk's best_ref (its packed
//   record, ops/traversal.py::pack_prims), t, u, v recomputed there
//   (ops/trace.py::_recompute_hits) and masked as closest_hit masks them;
//   get_surface's face or interpolated corner normal; the ambient term of
//   the lanes that exit; the first hit; faceforward; the sampler's 3 or 6
//   PCG draws (uint32, the state kept as the int64 tensor holds it);
//   Materials.sample's lobe for the lane's material type; with NEE,
//   _nee_direct's light pick, direction and intensity, its fire mask and
//   the shadow ray, written flat as ops/traversal.py::bvh_traverse takes
//   it.  The values the close kernel needs go to a (kMid, n) SoA buffer.
// - close: visibility from the shadow walk's best_ref (visible = fire and
//   ref < 0), shade(), the acc / dst updates, the BRDF weight, active,
//   prev_delta and the next closest ray, flat, with max_t = active ?
//   FLT_MAX : -1.
// Material-only factors (lambertian_f, cs * ks, 1 - spec, 1 / (exp + 1),
// the plastic lobe probability, the conductor's eta^2 + k^2 ...) come
// from a per-material table that ops/bounce_shade.py::material_table
// computes with the torch body's own operations, so they are the values
// the body computes per lane.
//
// Numbers: built with -fmad=false and no fast math, with the functions
// PyTorch's CUDA kernels call (sqrtf, rsqrtf, powf, sinf, cosf, IEEE
// division), each torch operation one rounding here.  Where PyTorch's
// CUDA kernels round otherwise than the expression reads, this file
// follows the kernels: a tensor divided by a Python number is a multiply
// by its float reciprocal (folded into the table), and torch.sum over a
// last axis of 3 adds (x0 + x2) + x1 (its reduction splits the row over
// two threads); an axis of 3 in the middle is added in order.  So each
// output is bit-equal to the plain version (ops/bounce_shade.py) on the
// card.
//
// Bound: memory.  A bounce moves ~444 bytes a lane through the pair: over
// every lane, the ray, carry and sampler state in and out, the shadow and
// next rays and the buffer between the two; over the lanes whose closest
// walk hit, the triangle record, prim id, normal and material id gathered
// by primitive (68 B); the shadow ref where the lane fired.  In the 1080p
// frame (nearly every lane hits) that is 0.92 GB a bounce, 0.275 ms at
// 3.35 TB/s.  Design: one pass a kernel, every lane array read and written
// once, coalesced (SoA, or rows of 3 floats); the material and light
// tables are read through the read-only cache; the gathers by primitive
// are the only scattered reads.  On the H100 the pair takes 0.30-0.35 ms
// a bounce, 79-90% of that bound (PERF.md section 6).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;
constexpr float kFltMax = 3.4028234663852886e38f;
// Python's constants as torch hands them to a kernel: rounded to float
constexpr float kPi = 3.141592653589793f;
constexpr float kTwoPi = 6.283185307179586f;      // brdf.TWO_PI
constexpr float kInvPi = 0.3183098861837907f;     // brdf.INV_PI
constexpr float kEightPi = 25.132741228718345f;   // 2.0 * math.pi * 4.0

enum MatType { kEmissive = 0, kMatte = 1, kMirror = 2, kPlastic = 3 };

// Material table columns (ops/bounce_shade.py::MAT_COLS)
enum MatCol {
  kType = 0,      // mtype, int32 bits
  kFd = 1,        // lambertian_f(cd, kd), 3
  kPiFd = 4,      // math.pi * lambertian_f, 3
  kSpec = 7,      // cs * ks, 3
  kOmSpec = 10,   // 1 - cs * ks, 3
  kExp = 13,      // specular_exp
  kExp1 = 14,     // exp + 1
  kInvExp1 = 15,  // 1 / (exp + 1)
  kNfactor = 16,  // (exp + 2) / (8 pi)
  kProbDiff = 17, // the plastic lobe's diffuse probability
  kE2k2 = 18,     // ior^2 + absorption^2, 3
  kTwoEta = 21,   // 2 ior, 3
  kCr = 24,       // cr, 3
  kKr = 27,       // kr
  kEmis = 28,     // ce * ls, 3
  kMatCols = 31
};

// Light table columns (point lights): position 3, cl 3, kl, attenuation 3
constexpr int kLightCols = 10;

// The (kMid, n) buffer between the two kernels
enum Mid {
  kMidN = 0,      // faceforwarded shading normal, 3
  kMidWl = 3,     // direction to the light, 3
  kMidI = 6,      // the light's intensity, 3
  kMidF = 9,      // the sample's colour, 3
  kMidWi = 12,    // the sample's direction, 3
  kMidPdf = 15,
  kMidPos = 16,   // the hit point, 3
  kMidFlags = 19, // int32 bits, Flag
  kMidGeom = 20,  // material row, int32 bits
  kMid = 21
};

enum Flag {
  kFHit = 1, kFActive = 2, kFFire = 4, kFTakeD = 8, kFEmissive = 16,
  kFSpecular = 32, kFZeroPdf = 64
};

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 v3(float x, float y, float z) {
  V3 r;
  r.x = x;
  r.y = y;
  r.z = z;
  return r;
}
__device__ __forceinline__ V3 add(V3 a, V3 b) {
  return v3(a.x + b.x, a.y + b.y, a.z + b.z);
}
__device__ __forceinline__ V3 sub(V3 a, V3 b) {
  return v3(a.x - b.x, a.y - b.y, a.z - b.z);
}
__device__ __forceinline__ V3 mul(V3 a, V3 b) {
  return v3(a.x * b.x, a.y * b.y, a.z * b.z);
}
__device__ __forceinline__ V3 scale(V3 a, float s) {
  return v3(a.x * s, a.y * s, a.z * s);
}
__device__ __forceinline__ V3 neg(V3 a) { return v3(-a.x, -a.y, -a.z); }
__device__ __forceinline__ V3 sel(bool c, V3 a, V3 b) { return c ? a : b; }

// vecmath.dot, written out left to right
__device__ __forceinline__ float dot(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
// torch.sum(a * b, dim=-1) on the card: the row of 3 split over two
// threads, (p0 + p2) + p1
__device__ __forceinline__ float tsum3(V3 a, V3 b) {
  return (a.x * b.x + a.z * b.z) + a.y * b.y;
}
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return v3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
            a.x * b.y - a.y * b.x);
}
// vecmath.normalize: v * rsqrt(dot(v, v))
__device__ __forceinline__ V3 normalize(V3 v) {
  return scale(v, rsqrtf(dot(v, v)));
}
// vecmath.reflect(i, n): 2 dot(n, i) n - i
__device__ __forceinline__ V3 reflect(V3 i, V3 n) {
  const float k = 2.0f * dot(n, i);
  return sub(scale(n, k), i);
}
// torch.clamp_min / torch.clamp on the card: NaN passes through
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float saturate(float v) {
  return isnan(v) ? v : fminf(fmaxf(v, 0.0f), 1.0f);
}

__device__ __forceinline__ V3 load3(const float* p, int i) {
  return v3(p[3 * i], p[3 * i + 1], p[3 * i + 2]);
}
__device__ __forceinline__ void store3(float* p, int i, V3 v) {
  p[3 * i] = v.x;
  p[3 * i + 1] = v.y;
  p[3 * i + 2] = v.z;
}
__device__ __forceinline__ V3 ldg3(const float* p) {
  return v3(__ldg(p), __ldg(p + 1), __ldg(p + 2));
}
__device__ __forceinline__ V3 mid3(const float* mid, int row, int n, int i) {
  return v3(mid[row * n + i], mid[(row + 1) * n + i],
            mid[(row + 2) * n + i]);
}
__device__ __forceinline__ void put3(float* mid, int row, int n, int i,
                                     V3 v) {
  mid[row * n + i] = v.x;
  mid[(row + 1) * n + i] = v.y;
  mid[(row + 2) * n + i] = v.z;
}

// ops/sampling.py: one PCG-RXS-M-XS step and its float in [0, 1]
__device__ __forceinline__ float next_uniform(uint32_t& s) {
  s = s * 747796405u + 2891336453u;
  const uint32_t word = ((s >> ((s >> 28) + 4u)) ^ s) * 277803737u;
  const uint32_t bits = (word >> 22) ^ word;
  return __uint2float_rn(bits) * 2.3283064365386963e-10f;   // 2^-32
}

// brdf.blinn_f(cs, ks, exp, n, wo, wi)
__device__ __forceinline__ V3 blinn_f(const float* m, V3 n, V3 wo, V3 wi) {
  const V3 h = normalize(add(wo, wi));
  const float hdotn = clamp_min(dot(h, n), 0.0f);
  const float p5 = powf(1.0f - saturate(dot(wi, h)), 5.0f);
  const V3 spec = ldg3(m + kSpec);
  const V3 om = ldg3(m + kOmSpec);
  const V3 schlick = add(spec, scale(om, p5));
  const float k = __ldg(m + kNfactor) * powf(hdotn, __ldg(m + kExp));
  return scale(schlick, k);
}

struct HitArgs {
  const float* ori;
  const float* dir;
  const int* ref;
  const long long* state;
  const unsigned char* active;
  const float* dst;
  const float* acc;
  const float4* prims;       // (R, 3) float4: v1, e1, e2 in reference order
  const int* prim_ids;       // (R,)
  const float* normals;      // (F, 3)
  const float* corner;       // (F, 3, 3) or null (face binding)
  const int* geom_ids;       // (F,)
  const float* mat;          // (M, kMatCols)
  const float* lights;       // (L, kLightCols)
  const float* amb;          // (3,)
  const float* eps;          // ()
  long long* state_out;
  float* carry_out;          // acc with NEE, else dst
  unsigned char* first_hit;  // bounce 0 only, else null
  float* first_t;
  float* shadow_o;           // NEE with lights only, else null
  float* shadow_d;
  float* shadow_t;
  unsigned char* fire;
  float* mid;
  int n, num_tris, num_lights, nee, reversed;
};

__global__ void __launch_bounds__(kBlock) shade_hit(HitArgs a) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= a.n) return;
  const int n = a.n;
  const V3 o = load3(a.ori, i);
  const V3 d = load3(a.dir, i);
  const int ref = a.ref[i];
  const bool active = a.active[i] != 0;
  const float max_t = active ? kFltMax : -1.0f;

  // the closest hit at the walk's winner (ops/trace.py::_recompute_hits,
  // then closest_hit's merge and max_t mask)
  const bool hit0 = ref >= 0;
  int pid = 0;
  float t = kFltMax, u = 0.0f, v = 0.0f;
  if (hit0) {
    pid = __ldg(a.prim_ids + ref);
    const float4 r1 = __ldg(a.prims + 3 * ref);
    const float4 r2 = __ldg(a.prims + 3 * ref + 1);
    const float4 r3 = __ldg(a.prims + 3 * ref + 2);
    const V3 v1 = v3(r1.x, r1.y, r1.z);
    const V3 e1 = v3(r2.x, r2.y, r2.z);
    const V3 e2 = v3(r3.x, r3.y, r3.z);
    // ops/intersect.py::intersect_triangle
    const V3 s1 = cross(d, e2);
    const float div = dot(s1, e1);
    bool hit = div != 0.0f;
    const float inv_div = hit ? 1.0f / div : 0.0f;
    const V3 dd = sub(o, v1);
    const float b1 = dot(dd, s1) * inv_div;
    hit = hit && b1 >= 0.0f && b1 <= 1.0f;
    const V3 s2 = cross(dd, e1);
    const float b2 = dot(d, s2) * inv_div;
    hit = hit && b2 >= 0.0f && b1 + b2 <= 1.0f;
    const float tt = dot(e2, s2) * inv_div;
    t = hit ? tt : -1.0f;
    u = hit ? b1 : 0.0f;
    v = hit ? b2 : 0.0f;
  }
  const int gid = __ldg(a.geom_ids + pid);
  const bool closer = hit0 && t >= 0.0f && t < kFltMax;
  const int prim = closer ? pid : 0;
  const int geom = closer ? gid : 0;
  const bool hit = closer && t < max_t;
  t = hit ? t : kFltMax;
  u = hit ? u : 0.0f;
  v = hit ? v : 0.0f;

  // shading/surface.py::get_surface
  const int tri = min(max(prim, 0), a.num_tris - 1);
  const V3 gn = ldg3(a.normals + 3 * tri);
  V3 sn = gn;
  if (a.corner != nullptr) {
    const float w0 = (1.0f - u) - v;
    const float* c = a.corner + 9 * tri;
    const V3 c0 = scale(ldg3(c), w0);
    const V3 c1 = scale(ldg3(c + 3), u);
    const V3 c2 = scale(ldg3(c + 6), v);
    sn = normalize(add(add(c0, c1), c2));
  }
  const float* m = a.mat + kMatCols * geom;
  const int mtype = __float_as_int(__ldg(m + kType));

  // the hit's bookkeeping
  const bool exited = active && !hit;
  const V3 dst = load3(a.dst, i);
  if (a.nee) {
    const V3 acc = load3(a.acc, i);
    store3(a.carry_out, i,
           sel(exited, add(acc, mul(dst, ldg3(a.amb))), acc));
  } else {
    store3(a.carry_out, i, sel(exited, mul(dst, ldg3(a.amb)), dst));
  }
  const bool active2 = active && hit;
  if (a.first_hit != nullptr) {
    a.first_hit[i] = hit;
    a.first_t[i] = t;
  }
  const V3 wo = neg(d);
  const V3 nn = dot(gn, wo) < 0.0f ? neg(sn) : sn;

  uint32_t s = static_cast<uint32_t>(a.state[i]);
  const float u_lobe = next_uniform(s);
  const float u1 = next_uniform(s);
  const float u2 = next_uniform(s);
  float ul = 0.0f;
  if (a.nee) {
    ul = next_uniform(s);
    next_uniform(s);   // ua, ub: area lights' only
    next_uniform(s);
  }
  a.state_out[i] = static_cast<long long>(s);

  // Materials.sample: the lobe of the lane's type
  V3 f, wi;
  float pdf;
  if (mtype == kMatte || mtype == kPlastic) {
    // vecmath.orthonormal_basis(n)
    const bool xbig = fabsf(nn.x) > fabsf(nn.y);
    const V3 vb = normalize(xbig ? v3(-nn.z, 0.0f, nn.x)
                                 : v3(0.0f, nn.z, -nn.y));
    const V3 ub = cross(vb, nn);
    const bool diffuse = mtype == kMatte || u_lobe < __ldg(m + kProbDiff);
    if (diffuse) {
      // lambertian_sample_f
      const float r = sqrtf(u1);
      const float theta = u2 * kTwoPi;
      const float x = r * cosf(theta);
      const float y = r * sinf(theta);
      const float z = sqrtf(clamp_min(1.0f - u1, 0.0f));
      wi = normalize(add(add(scale(ub, x), scale(vb, y)), scale(nn, z)));
      pdf = dot(nn, wi) * kInvPi;
      f = ldg3(m + kFd);
    } else {
      // blinn_sample_f
      const float ct = powf(u1, __ldg(m + kInvExp1));
      const float st = sqrtf(clamp_min(1.0f - ct * ct, 0.0f));
      const float phi = u2 * kTwoPi;
      const V3 h = normalize(add(add(scale(ub, st * cosf(phi)),
                                     scale(vb, st * sinf(phi))),
                                 scale(nn, ct)));
      wi = reflect(wo, h);
      const float vdoth = dot(wo, h);
      const float p = (__ldg(m + kExp1) * powf(ct, __ldg(m + kExp))) /
                      (kEightPi * (vdoth != 0.0f ? vdoth : 1.0f));
      pdf = vdoth != 0.0f ? p : 0.0f;
      f = blinn_f(m, nn, wo, wi);
    }
  } else {
    wi = reflect(wo, nn);
    pdf = 1.0f;
    if (mtype == kMirror) {
      // specular_reflection_sample_f with the conductor's Fresnel term
      const float cosi = fabsf(dot(nn, wo));
      const V3 e2k2 = ldg3(m + kE2k2);
      const V3 te = ldg3(m + kTwoEta);
      const float cc = cosi * cosi;
      const V3 tec = scale(te, cosi);
      const V3 ec = scale(scale(e2k2, cosi), cosi);
      const V3 rs2 = v3((e2k2.x - tec.x + cc) / (e2k2.x + tec.x + cc),
                        (e2k2.y - tec.y + cc) / (e2k2.y + tec.y + cc),
                        (e2k2.z - tec.z + cc) / (e2k2.z + tec.z + cc));
      const V3 rp2 = v3((ec.x - tec.x + 1.0f) / (ec.x + tec.x + 1.0f),
                        (ec.y - tec.y + 1.0f) / (ec.y + tec.y + 1.0f),
                        (ec.z - tec.z + 1.0f) / (ec.z + tec.z + 1.0f));
      const V3 fr = scale(add(rs2, rp2), 0.5f);
      const float ndotwi = fabsf(dot(nn, wi));
      const float safe = ndotwi != 0.0f ? ndotwi : 1.0f;
      const V3 fc = scale(mul(fr, ldg3(m + kCr)), __ldg(m + kKr));
      f = v3(fc.x / safe, fc.y / safe, fc.z / safe);
    } else {
      f = ldg3(m + kEmis);   // emissive, and any other type
    }
  }
  const bool zero_pdf = pdf <= 0.0f;
  const bool emissive = mtype == kEmissive;
  const bool specular = mtype == kMirror;
  const float th = hit ? t : 1.0f;
  const V3 pos = add(o, scale(d, th));

  // _nee_direct up to the shadow walk: uniform light pick
  bool take_d = false, fire = false;
  V3 wl = v3(0.0f, 0.0f, 0.0f), li = v3(0.0f, 0.0f, 0.0f);
  if (a.nee) {
    take_d = active2 && !emissive && !specular;
    if (a.num_lights > 0) {
      const int total = a.num_lights;
      const int pick = min(static_cast<int>(ul * static_cast<float>(total)),
                           total - 1);
      const float* l = a.lights + kLightCols * pick;
      const V3 p = ldg3(l);
      const V3 to = sub(p, pos);
      const float dist = sqrtf(dot(to, to));
      const float dc = clamp_min(dist, 1e-12f);
      wl = v3(to.x / dc, to.y / dc, to.z / dc);
      fire = tsum3(nn, wl) > 0.0f && take_d;
      // PointLights.intensity: cl * kl / (c + l d + q d^2)
      const V3 att = ldg3(l + 7);
      const float denom = (att.x + att.y * dist) + (att.z * dist) * dist;
      li = scale(ldg3(l + 3), __ldg(l + 6) / denom);
      const float eps = __ldg(a.eps);
      a.shadow_t[i] = fire ? dist - 2.0f * eps : -1.0f;
      if (a.reversed) {
        store3(a.shadow_o, i, sub(p, scale(wl, eps)));
        store3(a.shadow_d, i, neg(wl));
      } else {
        store3(a.shadow_o, i, add(pos, scale(wl, eps)));
        store3(a.shadow_d, i, wl);
      }
      a.fire[i] = fire;
    }
  }
  put3(a.mid, kMidN, n, i, nn);
  put3(a.mid, kMidWl, n, i, wl);
  put3(a.mid, kMidI, n, i, li);
  put3(a.mid, kMidF, n, i, f);
  put3(a.mid, kMidWi, n, i, wi);
  a.mid[kMidPdf * n + i] = pdf;
  put3(a.mid, kMidPos, n, i, pos);
  const int flags = (hit ? kFHit : 0) | (active2 ? kFActive : 0) |
                    (fire ? kFFire : 0) | (take_d ? kFTakeD : 0) |
                    (emissive ? kFEmissive : 0) |
                    (specular ? kFSpecular : 0) | (zero_pdf ? kFZeroPdf : 0);
  a.mid[kMidFlags * n + i] = __int_as_float(flags);
  a.mid[kMidGeom * n + i] = __int_as_float(geom);
}

struct CloseArgs {
  const float* dir;
  const float* mid;
  const int* shadow_ref;      // null without a shadow walk
  const float* dst;
  const float* acc;
  const unsigned char* prev_delta;
  const float* mat;
  const float* eps;
  float* next_o;
  float* next_d;
  float* next_t;
  float* dst_out;
  float* acc_out;
  unsigned char* active_out;
  unsigned char* prev_delta_out;
  int n, num_lights, nee, first;
};

__global__ void __launch_bounds__(kBlock) shade_close(CloseArgs a) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= a.n) return;
  const int n = a.n;
  const V3 nn = mid3(a.mid, kMidN, n, i);
  const V3 f = mid3(a.mid, kMidF, n, i);
  const V3 wi = mid3(a.mid, kMidWi, n, i);
  const float pdf = a.mid[kMidPdf * n + i];
  const int flags = __float_as_int(a.mid[kMidFlags * n + i]);
  const int geom = __float_as_int(a.mid[kMidGeom * n + i]);
  const bool active = flags & kFActive;
  const bool emissive = flags & kFEmissive;
  const bool zero_pdf = flags & kFZeroPdf;
  const float* m = a.mat + kMatCols * geom;
  V3 dst = load3(a.dst, i);
  V3 acc = load3(a.acc, i);

  if (a.nee) {
    V3 direct = v3(0.0f, 0.0f, 0.0f);
    if (a.num_lights > 0) {
      // Materials.shade(n, view_dir, light_dir, I), then the estimator's
      // g * visible * total (g = 1 for a point light)
      const V3 wl = mid3(a.mid, kMidWl, n, i);
      const V3 li = mid3(a.mid, kMidI, n, i);
      const V3 wo = neg(load3(a.dir, i));
      const int mtype = __float_as_int(__ldg(m + kType));
      const float ndotl = clamp_min(dot(nn, wl), 0.0f);
      V3 c = v3(0.0f, 0.0f, 0.0f);
      if (mtype == kPlastic) {
        const V3 fd = ldg3(m + kFd);
        const V3 sp = blinn_f(m, nn, wo, wl);
        c = scale(mul(scale(add(fd, sp), kPi), li), ndotl);
      } else if (mtype == kMatte) {
        c = scale(mul(ldg3(m + kPiFd), li), ndotl);
      } else if (mtype == kEmissive) {
        c = ldg3(m + kEmis);
      }
      const bool visible = (flags & kFFire) && a.shadow_ref[i] < 0;
      const float w = (1.0f * (visible ? 1.0f : 0.0f)) *
                      static_cast<float>(a.num_lights);
      direct = scale(c, w);
    }
    if (flags & kFTakeD) acc = add(acc, mul(dst, direct));
    const bool take_e = active && emissive &&
                        (a.first || a.prev_delta[i] != 0);
    if (take_e) acc = add(acc, mul(dst, f));
  }
  const float safe_pdf = zero_pdf ? 1.0f : pdf;
  const float ndotwi = tsum3(nn, wi);
  const float weight = emissive ? 1.0f : ndotwi / safe_pdf;
  const V3 src = scale(f, weight);
  const bool upd = active && !zero_pdf && !(a.nee && emissive);
  if (upd) dst = mul(dst, src);
  if (zero_pdf && active) dst = v3(0.0f, 0.0f, 0.0f);
  const bool active3 = active && !emissive && !zero_pdf;
  const V3 pos = mid3(a.mid, kMidPos, n, i);
  store3(a.next_o, i, add(pos, scale(wi, __ldg(a.eps))));
  store3(a.next_d, i, wi);
  a.next_t[i] = active3 ? kFltMax : -1.0f;
  store3(a.dst_out, i, dst);
  store3(a.acc_out, i, acc);
  a.active_out[i] = active3;
  a.prev_delta_out[i] = active3 && (flags & kFSpecular);
}

inline int blocks(int n) { return (n + kBlock - 1) / kBlock; }

}  // namespace

extern "C" int vsnray_bounce_shade_hit(
    const void* ori, const void* dir, const void* ref, const void* state,
    const void* active, const void* dst, const void* acc, const void* prims,
    const void* prim_ids, const void* normals, const void* corner,
    const void* geom_ids, const void* mat, const void* lights,
    const void* amb, const void* eps, void* state_out, void* carry_out,
    void* first_hit, void* first_t, void* shadow_o, void* shadow_d,
    void* shadow_t, void* fire, void* mid, int n, int num_tris,
    int num_lights, int nee, int reversed, void* stream) {
  HitArgs a;
  a.ori = static_cast<const float*>(ori);
  a.dir = static_cast<const float*>(dir);
  a.ref = static_cast<const int*>(ref);
  a.state = static_cast<const long long*>(state);
  a.active = static_cast<const unsigned char*>(active);
  a.dst = static_cast<const float*>(dst);
  a.acc = static_cast<const float*>(acc);
  a.prims = static_cast<const float4*>(prims);
  a.prim_ids = static_cast<const int*>(prim_ids);
  a.normals = static_cast<const float*>(normals);
  a.corner = static_cast<const float*>(corner);
  a.geom_ids = static_cast<const int*>(geom_ids);
  a.mat = static_cast<const float*>(mat);
  a.lights = static_cast<const float*>(lights);
  a.amb = static_cast<const float*>(amb);
  a.eps = static_cast<const float*>(eps);
  a.state_out = static_cast<long long*>(state_out);
  a.carry_out = static_cast<float*>(carry_out);
  a.first_hit = static_cast<unsigned char*>(first_hit);
  a.first_t = static_cast<float*>(first_t);
  a.shadow_o = static_cast<float*>(shadow_o);
  a.shadow_d = static_cast<float*>(shadow_d);
  a.shadow_t = static_cast<float*>(shadow_t);
  a.fire = static_cast<unsigned char*>(fire);
  a.mid = static_cast<float*>(mid);
  a.n = n;
  a.num_tris = num_tris;
  a.num_lights = num_lights;
  a.nee = nee;
  a.reversed = reversed;
  const bool shadows = nee && num_lights > 0;
  if (n <= 0 || num_tris < 1 || num_lights < 0 ||
      (shadows && (!a.lights || !a.shadow_o || !a.shadow_d ||
                   !a.shadow_t || !a.fire)) ||
      ((a.first_hit == nullptr) != (a.first_t == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  shade_hit<<<blocks(n), kBlock, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int vsnray_bounce_shade_close(
    const void* dir, const void* mid, const void* shadow_ref,
    const void* dst, const void* acc, const void* prev_delta,
    const void* mat, const void* eps, void* next_o, void* next_d,
    void* next_t, void* dst_out, void* acc_out, void* active_out,
    void* prev_delta_out, int n, int num_lights, int nee, int first,
    void* stream) {
  CloseArgs a;
  a.dir = static_cast<const float*>(dir);
  a.mid = static_cast<const float*>(mid);
  a.shadow_ref = static_cast<const int*>(shadow_ref);
  a.dst = static_cast<const float*>(dst);
  a.acc = static_cast<const float*>(acc);
  a.prev_delta = static_cast<const unsigned char*>(prev_delta);
  a.mat = static_cast<const float*>(mat);
  a.eps = static_cast<const float*>(eps);
  a.next_o = static_cast<float*>(next_o);
  a.next_d = static_cast<float*>(next_d);
  a.next_t = static_cast<float*>(next_t);
  a.dst_out = static_cast<float*>(dst_out);
  a.acc_out = static_cast<float*>(acc_out);
  a.active_out = static_cast<unsigned char*>(active_out);
  a.prev_delta_out = static_cast<unsigned char*>(prev_delta_out);
  a.n = n;
  a.num_lights = num_lights;
  a.nee = nee;
  a.first = first;
  if (n <= 0 || num_lights < 0 ||
      (nee && num_lights > 0 && !a.shadow_ref)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  shade_close<<<blocks(n), kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      a);
  return static_cast<int>(cudaGetLastError());
}

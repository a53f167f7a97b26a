// The shading of one bounce of the path tracer, around its two LBVH walks:
// vsnray_bounce_shade_hit between the closest walk and the shadow walk,
// vsnray_bounce_shade_close after the shadow walk, and their adjoint,
// vsnray_bounce_shade_bwd.  One thread per lane.
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
//   light_sample's light pick, direction and intensity, its fire mask and
//   the shadow ray, written flat as ops/traversal.py::bvh_traverse takes
//   it (shading/bounce.py).  The values the close kernel needs go to a
//   (kMid, n) SoA buffer.
// - close: visibility from the shadow walk's best_ref (visible = fire and
//   ref < 0), direct_light's shade(), next_ray's acc / dst updates, the
//   BRDF weight, active, prev_delta and the next closest ray, flat, with
//   max_t = active ? FLT_MAX : -1.
// - bwd: the gradient of the pair under autograd
//   (kernels/pathtracing.py::_FusedBounce.backward), from the gradients of
//   the next ray's origin and direction, dst, acc and the first t: those
//   of the bounce's ray origin and direction, dst and acc, the vertices
//   (through the hit's t, u, v, scattered to the triangle's three) and
//   the albedo cd (through lambertian_f).  Each lane runs the
//   hit kernel's code again (hit_lane: the same operations, so the same
//   values, and no buffer kept between forward and backward) and the
//   close kernel's arithmetic from the shadow walk's ref the tape keeps,
//   then the reverse of each operation autograd would take through the
//   torch body: the selected lobe alone, where-masks passing their
//   branch's gradient, clamp_min and clamp passing it where the value
//   lies in range, abs its sign, pow 0 at an exponent of 0.  The lobes
//   move with n only through corner normals and with the view direction
//   only when the ray's direction is differentiated; otherwise their
//   backward is skipped, as autograd builds no graph for them.  Both
//   leaves' gradients are summed in f64: a vertex's shares nearly cancel
//   (a triangle's v1 takes -(dd + e1 + e2)'s), and in f32 atomics the
//   1080p step's vertex gradient came out ~1e-4 off its f64 sum, and
//   slower (PERF.md section 6).  A warp's lanes on one triangle (most of
//   a warp of camera rays) are summed by shuffles (__match_any_sync
//   groups) and one leader adds the 9 sums; the albedo's few rows take
//   every lane's share: a warp's lanes of one row by shuffles, then a
//   block's table in shared memory, then one atomic per row a block.
//   The plain version is the torch body's recompute under autograd.
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
// a bounce, 79-90% of that bound (PERF.md section 6).  The adjoint reads
// the forward's inputs, the refs and the gradients of the outputs (~160
// bytes a lane), writes the inputs' gradients (48) and scatters 36 bytes
// a hit lane to the vertices' gradient, again one pass with the triangle
// record gathered by primitive.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;
// the adjoint's per-block albedo table in shared memory, at most
constexpr int kMaxSmemCd = 48 * 1024;
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
  kKdInvPi = 31,  // kd / pi: lambertian_f's factor of cd
  kMatCols = 32
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

// specular_reflection_sample_f's colour, with the conductor's Fresnel term
__device__ __forceinline__ V3 mirror_f(const float* m, V3 nn, V3 wo, V3 wi) {
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
  return v3(fc.x / safe, fc.y / safe, fc.z / safe);
}

// Sum x over the lanes of `peers` (one group of __match_any_sync) into the
// group's lowest lane, in log2(group size) rounds of shuffles (Westphal's
// segmented reduction; every lane of `mask` runs the same rounds)
template <int N>
__device__ __forceinline__ void reduce_peers(unsigned mask, unsigned peers,
                                             double (&x)[N]) {
  const unsigned lane = threadIdx.x & 31u;
  unsigned rel = __popc(peers & ((1u << lane) - 1u));
  unsigned up = peers & ~((2u << lane) - 1u);
  while (__any_sync(mask, up != 0u)) {
    const int next = __ffs(up);
    const int src = next != 0 ? next - 1 : static_cast<int>(lane);
    for (int j = 0; j < N; ++j) {
      const double t = __shfl_sync(mask, x[j], src);
      if (next != 0) x[j] = x[j] + t;
    }
    up &= ~__ballot_sync(mask, (rel & 1u) != 0u);
    rel >>= 1;
  }
}

// What the two kernels and the adjoint read of the scene
struct SceneArgs {
  const float4* prims;       // (R, 3) float4: v1, e1, e2 in reference order
  const int* prim_ids;       // (R,)
  const float* normals;      // (F, 3)
  const float* corner;       // (F, 3, 3) or null (face binding)
  const int* geom_ids;       // (F,)
  const float* mat;          // (M, kMatCols)
  const float* lights;       // (L, kLightCols)
  const float* amb;          // (3,)
  const float* eps;          // ()
  int num_tris, num_lights, nee, reversed;
};

// ops/intersect.py::intersect_triangle at one triangle, with the
// intermediates its adjoint reads
struct Tri {
  V3 s1, dd, s2;
  float div, inv, b1, b2, t;
  bool hit;
};

__device__ __forceinline__ Tri intersect(V3 o, V3 d, V3 v1, V3 e1, V3 e2) {
  Tri r;
  r.s1 = cross(d, e2);
  r.div = dot(r.s1, e1);
  bool hit = r.div != 0.0f;
  r.inv = hit ? 1.0f / r.div : 0.0f;
  r.dd = sub(o, v1);
  r.b1 = dot(r.dd, r.s1) * r.inv;
  hit = hit && r.b1 >= 0.0f && r.b1 <= 1.0f;
  r.s2 = cross(r.dd, e1);
  r.b2 = dot(d, r.s2) * r.inv;
  hit = hit && r.b2 >= 0.0f && r.b1 + r.b2 <= 1.0f;
  r.t = dot(e2, r.s2) * r.inv;
  r.hit = hit;
  return r;
}

// The hit kernel's work on one lane, and what its adjoint reads again
struct Lane {
  bool hit, active2, exited, flip, diffuse, ok, zero_pdf, emissive;
  bool specular, take_d, fire;
  int tri, geom, mtype;
  float t, u, v, th, pdf, vdoth, dist, dc, denom;
  Tri x;
  V3 v1, e1, e2;
  V3 gn, sn, S, wo, nn;
  uint32_t state;
  float u_lobe, u1, u2, ul;
  V3 Vb, vb, ub;   // the sampling frame: vb = normalize(Vb), ub
  V3 sp;           // lambert: (x, y, z); blinn: (st cos phi, st sin phi, ct)
  V3 W;            // the lobe's direction (lambert) or half vector (blinn),
                   // before normalize
  V3 h, f, wi, pos;
  V3 P, to, wl, li;
  const float* m;
  const float* l;
};

// the closest hit, get_surface, at_hit's draws and Materials.sample, the
// hit point, and light_sample up to the shadow walk (ops/bounce_shade.py)
__device__ __forceinline__ Lane hit_lane(const SceneArgs& s, V3 o, V3 d,
                                         int ref, bool active,
                                         uint32_t state) {
  Lane L;
  const float max_t = active ? kFltMax : -1.0f;

  // the closest hit at the walk's winner (ops/trace.py::_recompute_hits,
  // then closest_hit's merge and max_t mask)
  const bool hit0 = ref >= 0;
  int pid = 0;
  float t = kFltMax, u = 0.0f, v = 0.0f;
  L.v1 = L.e1 = L.e2 = v3(0.0f, 0.0f, 0.0f);
  if (hit0) {
    pid = __ldg(s.prim_ids + ref);
    const float4 r1 = __ldg(s.prims + 3 * ref);
    const float4 r2 = __ldg(s.prims + 3 * ref + 1);
    const float4 r3 = __ldg(s.prims + 3 * ref + 2);
    L.v1 = v3(r1.x, r1.y, r1.z);
    L.e1 = v3(r2.x, r2.y, r2.z);
    L.e2 = v3(r3.x, r3.y, r3.z);
    L.x = intersect(o, d, L.v1, L.e1, L.e2);
    t = L.x.hit ? L.x.t : -1.0f;
    u = L.x.hit ? L.x.b1 : 0.0f;
    v = L.x.hit ? L.x.b2 : 0.0f;
  }
  const int gid = __ldg(s.geom_ids + pid);
  const bool closer = hit0 && t >= 0.0f && t < kFltMax;
  const int prim = closer ? pid : 0;
  L.geom = closer ? gid : 0;
  L.hit = closer && t < max_t;
  L.t = L.hit ? t : kFltMax;
  L.u = L.hit ? u : 0.0f;
  L.v = L.hit ? v : 0.0f;

  // shading/surface.py::get_surface
  L.tri = min(max(prim, 0), s.num_tris - 1);
  L.gn = ldg3(s.normals + 3 * L.tri);
  L.sn = L.gn;
  L.S = L.gn;
  if (s.corner != nullptr) {
    const float w0 = (1.0f - L.u) - L.v;
    const float* c = s.corner + 9 * L.tri;
    const V3 c0 = scale(ldg3(c), w0);
    const V3 c1 = scale(ldg3(c + 3), L.u);
    const V3 c2 = scale(ldg3(c + 6), L.v);
    L.S = add(add(c0, c1), c2);
    L.sn = normalize(L.S);
  }
  L.m = s.mat + kMatCols * L.geom;
  L.mtype = __float_as_int(__ldg(L.m + kType));

  // shading/bounce.py::at_hit
  L.exited = active && !L.hit;
  L.active2 = active && L.hit;
  L.wo = neg(d);
  L.flip = dot(L.gn, L.wo) < 0.0f;
  L.nn = L.flip ? neg(L.sn) : L.sn;
  const V3 nn = L.nn, wo = L.wo;
  const float* m = L.m;

  uint32_t st = state;
  L.u_lobe = next_uniform(st);
  L.u1 = next_uniform(st);
  L.u2 = next_uniform(st);
  L.ul = 0.0f;
  if (s.nee) {
    L.ul = next_uniform(st);
    next_uniform(st);   // ua, ub: area lights' only
    next_uniform(st);
  }
  L.state = st;

  // Materials.sample: the lobe of the lane's type
  const float u1 = L.u1, u2 = L.u2;
  L.diffuse = false;
  L.ok = true;
  L.vdoth = 0.0f;
  L.Vb = L.vb = L.ub = L.sp = L.W = L.h = v3(0.0f, 0.0f, 0.0f);
  if (L.mtype == kMatte || L.mtype == kPlastic) {
    // vecmath.orthonormal_basis(n)
    const bool xbig = fabsf(nn.x) > fabsf(nn.y);
    L.Vb = xbig ? v3(-nn.z, 0.0f, nn.x) : v3(0.0f, nn.z, -nn.y);
    L.vb = normalize(L.Vb);
    L.ub = cross(L.vb, nn);
    L.diffuse = L.mtype == kMatte || L.u_lobe < __ldg(m + kProbDiff);
    if (L.diffuse) {
      // lambertian_sample_f
      const float r = sqrtf(u1);
      const float theta = u2 * kTwoPi;
      L.sp = v3(r * cosf(theta), r * sinf(theta),
                sqrtf(clamp_min(1.0f - u1, 0.0f)));
      L.W = add(add(scale(L.ub, L.sp.x), scale(L.vb, L.sp.y)),
                scale(nn, L.sp.z));
      L.wi = normalize(L.W);
      L.pdf = dot(nn, L.wi) * kInvPi;
      L.f = ldg3(m + kFd);
    } else {
      // blinn_sample_f
      const float ct = powf(u1, __ldg(m + kInvExp1));
      const float st = sqrtf(clamp_min(1.0f - ct * ct, 0.0f));
      const float phi = u2 * kTwoPi;
      L.sp = v3(st * cosf(phi), st * sinf(phi), ct);
      L.W = add(add(scale(L.ub, L.sp.x), scale(L.vb, L.sp.y)),
                scale(nn, L.sp.z));
      L.h = normalize(L.W);
      L.wi = reflect(wo, L.h);
      L.vdoth = dot(wo, L.h);
      const float p = (__ldg(m + kExp1) * powf(ct, __ldg(m + kExp))) /
                      (kEightPi * (L.vdoth != 0.0f ? L.vdoth : 1.0f));
      // a half vector within rounding of perpendicular to wo reflects it
      // onto exactly -wo: pdf 0 and colour 0, as shading/brdf.py's
      // blinn_sample_f guards it
      const V3 back = add(wo, L.wi);
      L.ok = back.x != 0.0f || back.y != 0.0f || back.z != 0.0f;
      L.pdf = L.ok ? p : 0.0f;
      L.f = L.ok ? blinn_f(m, nn, wo, L.wi) : v3(0.0f, 0.0f, 0.0f);
    }
  } else {
    L.wi = reflect(wo, nn);
    L.pdf = 1.0f;
    if (L.mtype == kMirror) {
      L.f = mirror_f(m, nn, wo, L.wi);
    } else {
      L.f = ldg3(m + kEmis);   // emissive, and any other type
    }
  }
  L.zero_pdf = L.pdf <= 0.0f;
  L.emissive = L.mtype == kEmissive;
  L.specular = L.mtype == kMirror;
  L.th = L.hit ? L.t : 1.0f;
  L.pos = add(o, scale(d, L.th));

  // light_sample up to the shadow walk: a uniform light pick
  L.take_d = false;
  L.fire = false;
  L.dist = L.dc = L.denom = 0.0f;
  L.P = L.to = L.wl = L.li = v3(0.0f, 0.0f, 0.0f);
  L.l = nullptr;
  if (s.nee) {
    L.take_d = L.active2 && !L.emissive && !L.specular;
    if (s.num_lights > 0) {
      const int total = s.num_lights;
      const int pick = min(static_cast<int>(L.ul * static_cast<float>(total)),
                           total - 1);
      L.l = s.lights + kLightCols * pick;
      L.P = ldg3(L.l);
      L.to = sub(L.P, L.pos);
      L.dist = sqrtf(dot(L.to, L.to));
      L.dc = clamp_min(L.dist, 1e-12f);
      L.wl = v3(L.to.x / L.dc, L.to.y / L.dc, L.to.z / L.dc);
      L.fire = tsum3(nn, L.wl) > 0.0f && L.take_d;
      // PointLights.intensity: cl * kl / (c + l d + q d^2)
      const V3 att = ldg3(L.l + 7);
      L.denom = (att.x + att.y * L.dist) + (att.z * L.dist) * L.dist;
      L.li = scale(ldg3(L.l + 3), __ldg(L.l + 6) / L.denom);
    }
  }
  return L;
}

// Materials.shade(n, view_dir, light_dir, I) for the lane's type
__device__ __forceinline__ V3 shade_c(const float* m, int mtype, V3 nn,
                                      V3 wo, V3 wl, V3 li) {
  const float ndotl = clamp_min(dot(nn, wl), 0.0f);
  if (mtype == kPlastic) {
    const V3 fd = ldg3(m + kFd);
    const V3 sp = blinn_f(m, nn, wo, wl);
    return scale(mul(scale(add(fd, sp), kPi), li), ndotl);
  }
  if (mtype == kMatte) return scale(mul(ldg3(m + kPiFd), li), ndotl);
  if (mtype == kEmissive) return ldg3(m + kEmis);
  return v3(0.0f, 0.0f, 0.0f);
}

struct HitArgs {
  SceneArgs s;
  const float* ori;
  const float* dir;
  const int* ref;
  const long long* state;
  const unsigned char* active;
  const float* dst;
  const float* acc;
  long long* state_out;
  float* carry_out;          // acc with NEE, else dst
  unsigned char* first_hit;  // bounce 0 only, else null
  float* first_t;
  float* shadow_o;           // NEE with lights only, else null
  float* shadow_d;
  float* shadow_t;
  unsigned char* fire;
  float* mid;
  int n;
};

__global__ void __launch_bounds__(kBlock) shade_hit(HitArgs a) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= a.n) return;
  const int n = a.n;
  const SceneArgs& s = a.s;
  const V3 o = load3(a.ori, i);
  const V3 d = load3(a.dir, i);
  const bool active = a.active[i] != 0;
  const Lane L = hit_lane(s, o, d, a.ref[i], active,
                          static_cast<uint32_t>(a.state[i]));

  // the hit's bookkeeping
  const V3 dst = load3(a.dst, i);
  if (s.nee) {
    const V3 acc = load3(a.acc, i);
    store3(a.carry_out, i,
           sel(L.exited, add(acc, mul(dst, ldg3(s.amb))), acc));
  } else {
    store3(a.carry_out, i, sel(L.exited, mul(dst, ldg3(s.amb)), dst));
  }
  if (a.first_hit != nullptr) {
    a.first_hit[i] = L.hit;
    a.first_t[i] = L.t;
  }
  a.state_out[i] = static_cast<long long>(L.state);
  if (s.nee && s.num_lights > 0) {
    const float eps = __ldg(s.eps);
    a.shadow_t[i] = L.fire ? L.dist - 2.0f * eps : -1.0f;
    if (s.reversed) {
      store3(a.shadow_o, i, sub(L.P, scale(L.wl, eps)));
      store3(a.shadow_d, i, neg(L.wl));
    } else {
      store3(a.shadow_o, i, add(L.pos, scale(L.wl, eps)));
      store3(a.shadow_d, i, L.wl);
    }
    a.fire[i] = L.fire;
  }
  put3(a.mid, kMidN, n, i, L.nn);
  put3(a.mid, kMidWl, n, i, L.wl);
  put3(a.mid, kMidI, n, i, L.li);
  put3(a.mid, kMidF, n, i, L.f);
  put3(a.mid, kMidWi, n, i, L.wi);
  a.mid[kMidPdf * n + i] = L.pdf;
  put3(a.mid, kMidPos, n, i, L.pos);
  const int flags = (L.hit ? kFHit : 0) | (L.active2 ? kFActive : 0) |
                    (L.fire ? kFFire : 0) | (L.take_d ? kFTakeD : 0) |
                    (L.emissive ? kFEmissive : 0) |
                    (L.specular ? kFSpecular : 0) |
                    (L.zero_pdf ? kFZeroPdf : 0);
  a.mid[kMidFlags * n + i] = __int_as_float(flags);
  a.mid[kMidGeom * n + i] = __int_as_float(L.geom);
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
      // direct_light: Materials.shade(n, view_dir, light_dir, I), then
      // the estimator's g * visible * total (g = 1 for a point light)
      const V3 c = shade_c(m, __float_as_int(__ldg(m + kType)), nn,
                           neg(load3(a.dir, i)), mid3(a.mid, kMidWl, n, i),
                           mid3(a.mid, kMidI, n, i));
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
  // next_ray
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

// ---------------------------------------------------------------------------
// The adjoint of the pair: vsnray_bounce_shade_bwd.

__device__ __forceinline__ void acc3(V3& a, V3 b) { a = add(a, b); }

// y = normalize(v): dL/dv = (g - y (g . y)) rsqrt(v . v)
__device__ __forceinline__ V3 normalize_bwd(V3 v, V3 y, V3 g) {
  return scale(sub(g, scale(y, dot(g, y))), rsqrtf(dot(v, v)));
}

// w = reflect(i, n) = 2 (n . i) n - i
__device__ __forceinline__ void reflect_bwd(V3 i, V3 n, V3 gw, V3& gi,
                                            V3& gn) {
  const float k = 2.0f * dot(n, i);
  const float gk = 2.0f * dot(gw, n);
  acc3(gi, sub(scale(n, gk), gw));
  acc3(gn, add(scale(gw, k), scale(i, gk)));
}

// torch.clamp_min(x, lo) and torch.clamp(x, 0, 1) pass the gradient where
// lo <= x (<= 1)
__device__ __forceinline__ float pass_min(float x, float lo, float g) {
  return x >= lo ? g : 0.0f;
}

// brdf.blinn_f(cs, ks, exp, n, wo, wi) backward: gn, gwo, gwi added to
__device__ __forceinline__ void blinn_f_bwd(const float* m, V3 n, V3 wo,
                                            V3 wi, V3 g, V3& gn, V3& gwo,
                                            V3& gwi) {
  const V3 H = add(wo, wi);
  const V3 h = normalize(H);
  const float hn = dot(h, n);
  const float hdotn = clamp_min(hn, 0.0f);
  const float wh = dot(wi, h);
  const float om_sat = 1.0f - saturate(wh);
  const float p5 = powf(om_sat, 5.0f);
  const V3 spec = ldg3(m + kSpec);
  const V3 om = ldg3(m + kOmSpec);
  const V3 schlick = add(spec, scale(om, p5));
  const float e = __ldg(m + kExp);
  const float nf = __ldg(m + kNfactor);
  const float k = nf * powf(hdotn, e);
  // out = schlick * k
  const float gk = dot(g, schlick);
  const float gp5 = dot(scale(g, k), om);
  // pow(hdotn, e): e hdotn^(e - 1)
  const float ghdotn = e == 0.0f ? 0.0f
                                 : gk * nf * e * powf(hdotn, e - 1.0f);
  const float ghn = pass_min(hn, 0.0f, ghdotn);
  // pow(1 - sat, 5), sat = clamp(wh, 0, 1)
  const float gsat = -gp5 * 5.0f * powf(om_sat, 4.0f);
  const float gwh = (wh >= 0.0f && wh <= 1.0f) ? gsat : 0.0f;
  V3 gh = add(scale(n, ghn), scale(wi, gwh));
  acc3(gn, scale(h, ghn));
  acc3(gwi, scale(h, gwh));
  const V3 gH = normalize_bwd(H, h, gh);
  acc3(gwo, gH);
  acc3(gwi, gH);
}

// the sampling frame's backward: vb = normalize(Vb(n)), ub = cross(vb, n)
__device__ __forceinline__ void frame_bwd(const Lane& L, V3 gub, V3 gvb,
                                          V3& gn) {
  // ub = cross(vb, n): gvb += n x gub, gn += gub x vb
  acc3(gvb, cross(L.nn, gub));
  acc3(gn, cross(gub, L.vb));
  const V3 gV = normalize_bwd(L.Vb, L.vb, gvb);
  if (fabsf(L.nn.x) > fabsf(L.nn.y)) {
    gn = add(gn, v3(gV.z, 0.0f, -gV.x));     // Vb = (-n.z, 0, n.x)
  } else {
    gn = add(gn, v3(0.0f, -gV.z, gV.y));     // Vb = (0, n.z, -n.y)
  }
}

struct BwdArgs {
  SceneArgs s;
  const float* ori;
  const float* dir;
  const int* ref;
  const long long* state;
  const unsigned char* active;
  const float* dst;
  const float* acc;
  const unsigned char* prev_delta;
  const int* shadow_ref;      // null without a shadow walk
  const int* faces;           // (F, 3), with g_verts
  // the gradients of the bounce's outputs, each null where none reaches it
  const float* g_o;
  const float* g_d;
  const float* g_dst;
  const float* g_acc;
  const float* g_first_t;
  // the gradients wanted, each null where not
  float* gi_o;
  float* gi_d;
  float* gi_dst;
  float* gi_acc;
  double* g_verts;            // (V, 3), added to
  double* g_cd;               // (M, 3), added to
  int n, num_mats, first, smem_cd;
};

__global__ void __launch_bounds__(kBlock) shade_bwd(BwdArgs a) {
  extern __shared__ double s_cd[];
  const int i = blockIdx.x * kBlock + threadIdx.x;
  const SceneArgs& s = a.s;
  const int cd_len = 3 * a.num_mats;
  if (a.smem_cd) {
    for (int k = threadIdx.x; k < cd_len; k += kBlock) s_cd[k] = 0.0;
    __syncthreads();
  }
  int key = -1;              // the material row this lane adds to
  double gcd[3] = {0.0, 0.0, 0.0};
  int vkey = -1;             // the triangle whose vertices this lane moves
  int vf[3] = {0, 0, 0};
  double gv[9] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  if (i < a.n) {
    const V3 o = load3(a.ori, i);
    const V3 d = load3(a.dir, i);
    const bool active = a.active[i] != 0;
    const Lane L = hit_lane(s, o, d, a.ref[i], active,
                            static_cast<uint32_t>(a.state[i]));
    const float* m = L.m;
    const bool corner = s.corner != nullptr;
    // the hit's t, u, v move the vertices, the ray and, with corner
    // normals, n; the view direction moves with the ray's direction
    const bool want_n = corner && L.hit;
    const bool want_wo = a.gi_d != nullptr;
    const V3 zero = v3(0.0f, 0.0f, 0.0f);
    const V3 go = a.g_o != nullptr ? load3(a.g_o, i) : zero;
    const V3 gd_out = a.g_d != nullptr ? load3(a.g_d, i) : zero;
    const V3 gdst3 = a.g_dst != nullptr ? load3(a.g_dst, i) : zero;
    const V3 gacc3 = a.g_acc != nullptr ? load3(a.g_acc, i) : zero;
    const V3 dst = load3(a.dst, i);
    const V3 amb = ldg3(s.amb);
    // the carry after at_hit: dst_in is what next_ray multiplies
    const V3 dst_in = (!s.nee && L.exited) ? mul(dst, amb) : dst;

    V3 G_n = zero, G_wo = zero, G_pos = zero, G_wi = zero, G_f = zero;
    V3 G_cd = zero, G_dstin = zero;
    float G_pdf = 0.0f;

    // next_ray: o' = pos + wi eps, d' = wi
    const float eps = __ldg(s.eps);
    acc3(G_pos, go);
    acc3(G_wi, add(scale(go, eps), gd_out));
    const float safe_pdf = L.zero_pdf ? 1.0f : L.pdf;
    const float ndotwi = tsum3(L.nn, L.wi);
    const float weight = L.emissive ? 1.0f : ndotwi / safe_pdf;
    const V3 src = scale(L.f, weight);
    const bool upd = L.active2 && !L.zero_pdf && !(s.nee && L.emissive);
    const V3 gdst2 = (L.zero_pdf && L.active2) ? zero : gdst3;
    if (upd) {
      acc3(G_dstin, mul(gdst2, src));
      const V3 gsrc = mul(gdst2, dst_in);
      acc3(G_f, scale(gsrc, weight));
      if (!L.emissive) {
        const float gw = dot(gsrc, L.f);
        const float gndotwi = gw / safe_pdf;
        if (!L.zero_pdf) G_pdf += -gw * ndotwi / (safe_pdf * safe_pdf);
        if (want_n) acc3(G_n, scale(L.wi, gndotwi));
        acc3(G_wi, scale(L.nn, gndotwi));
      }
    } else {
      acc3(G_dstin, gdst2);
    }

    V3 G_acc = gacc3;
    if (s.nee) {
      // emission on the camera ray and after a delta bounce
      const bool take_e = L.active2 && L.emissive &&
                          (a.first || a.prev_delta[i] != 0);
      if (take_e) {
        acc3(G_dstin, mul(gacc3, L.f));
        acc3(G_f, mul(gacc3, dst_in));
      }
      // direct_light, where the lane fired and the walk found nothing
      const bool visible = L.fire && a.shadow_ref != nullptr &&
                           a.shadow_ref[i] < 0;
      if (L.take_d && s.num_lights > 0) {
        const V3 c = shade_c(m, L.mtype, L.nn, L.wo, L.wl, L.li);
        const float w = (1.0f * (visible ? 1.0f : 0.0f)) *
                        static_cast<float>(s.num_lights);
        acc3(G_dstin, mul(gacc3, scale(c, w)));
        if (visible) {
          const V3 gc = scale(mul(gacc3, dst_in), w);
          const float ndotl_raw = dot(L.nn, L.wl);
          const float ndotl = clamp_min(ndotl_raw, 0.0f);
          V3 g_wl = zero, g_li = zero;
          float g_ndotl = 0.0f;
          if (L.mtype == kPlastic || L.mtype == kMatte) {
            // c = ((A pi) li) ndotl, A = fd + blinn (plastic) or
            // c = (pi fd) li ndotl (matte)
            const V3 A = L.mtype == kPlastic
                             ? scale(add(ldg3(m + kFd),
                                         blinn_f(m, L.nn, L.wo, L.wl)),
                                     kPi)
                             : ldg3(m + kPiFd);
            const V3 B = mul(A, L.li);
            g_ndotl = dot(gc, B);
            const V3 gB = scale(gc, ndotl);
            g_li = mul(gB, A);
            const V3 gsum = scale(mul(gB, L.li), kPi);
            acc3(G_cd, gsum);
            if (L.mtype == kPlastic) {
              blinn_f_bwd(m, L.nn, L.wo, L.wl, gsum, G_n, G_wo, g_wl);
            }
          }
          const float gdot = pass_min(ndotl_raw, 0.0f, g_ndotl);
          acc3(G_n, scale(L.wl, gdot));
          acc3(g_wl, scale(L.nn, gdot));
          // li = cl (kl / denom), denom = (a0 + a1 dist) + (a2 dist) dist
          const V3 att = ldg3(L.l + 7);
          const float scl = __ldg(L.l + 6) / L.denom;
          const float gscl = dot(g_li, ldg3(L.l + 3));
          const float gden = -gscl * scl / L.denom;
          float g_dist = gden * (att.y + 2.0f * att.z * L.dist);
          // wl = to / clamp_min(dist, 1e-12)
          V3 g_to = scale(g_wl, 1.0f / L.dc);
          g_dist += pass_min(L.dist, 1e-12f,
                             -dot(g_wl, L.to) / (L.dc * L.dc));
          // dist = |to|, to = P - pos
          if (L.dist > 0.0f) acc3(g_to, scale(L.to, g_dist / L.dist));
          G_pos = sub(G_pos, g_to);
        }
      }
      // at_hit: acc1 = exited ? acc + dst amb : acc
    }

    // Materials.sample's backward for the lane's lobe
    const bool lobe_moves = want_n || want_wo;
    if (L.mtype == kMatte || L.mtype == kPlastic) {
      if (L.diffuse) {
        acc3(G_cd, G_f);
        if (want_n) {
          // pdf = (n . wi) / pi, wi = normalize(W),
          // W = ub x + vb y + n z
          const float gp = G_pdf * kInvPi;
          acc3(G_n, scale(L.wi, gp));
          acc3(G_wi, scale(L.nn, gp));
          const V3 gW = normalize_bwd(L.W, L.wi, G_wi);
          acc3(G_n, scale(gW, L.sp.z));
          frame_bwd(L, scale(gW, L.sp.x), scale(gW, L.sp.y), G_n);
        }
      } else if (lobe_moves) {
        // f = blinn_f(n, wo, wi), wi = reflect(wo, h), pdf = C / (8 pi
        // (wo . h)), h = normalize(ub a + vb b + n ct)
        V3 gh = zero;
        if (L.ok) {
          blinn_f_bwd(m, L.nn, L.wo, L.wi, G_f, G_n, G_wo, G_wi);
          const float gv = -G_pdf * L.pdf / L.vdoth;
          acc3(G_wo, scale(L.h, gv));
          acc3(gh, scale(L.wo, gv));
        }
        reflect_bwd(L.wo, L.h, G_wi, G_wo, gh);
        if (want_n) {
          const V3 gW = normalize_bwd(L.W, L.h, gh);
          acc3(G_n, scale(gW, L.sp.z));
          frame_bwd(L, scale(gW, L.sp.x), scale(gW, L.sp.y), G_n);
        }
      }
    } else if (lobe_moves) {
      if (L.mtype == kMirror) {
        // f = ((fr cr) kr) / safe, safe = |n . wi| (1 where 0),
        // fr = (rs2 + rp2) / 2 of cosi = |n . wo|
        const float dnw = dot(L.nn, L.wi);
        const float safe = fabsf(dnw) != 0.0f ? fabsf(dnw) : 1.0f;
        const V3 cr = scale(ldg3(m + kCr), __ldg(m + kKr));
        const float gsafe = -dot(G_f, L.f) / safe;
        if (fabsf(dnw) != 0.0f) {
          const float g = dnw > 0.0f ? gsafe : (dnw < 0.0f ? -gsafe : 0.0f);
          acc3(G_n, scale(L.wi, g));
          acc3(G_wi, scale(L.nn, g));
        }
        const V3 gfr = scale(mul(G_f, cr), 1.0f / safe);
        const float dno = dot(L.nn, L.wo);
        const float c = fabsf(dno);
        const V3 A = ldg3(m + kE2k2);
        const V3 B = ldg3(m + kTwoEta);
        const float Av[3] = {A.x, A.y, A.z}, Bv[3] = {B.x, B.y, B.z};
        const float gv[3] = {gfr.x, gfr.y, gfr.z};
        float gcos = 0.0f;
        for (int ch = 0; ch < 3; ++ch) {
          const float a = Av[ch], b = Bv[ch];
          const float N = (a - b * c) + c * c, D = (a + b * c) + c * c;
          const float Np = (a * c * c - b * c) + 1.0f;
          const float Dp = (a * c * c + b * c) + 1.0f;
          const float drs = ((2.0f * c - b) * D - N * (b + 2.0f * c)) /
                            (D * D);
          const float drp = ((2.0f * a * c - b) * Dp -
                             Np * (2.0f * a * c + b)) / (Dp * Dp);
          gcos += 0.5f * gv[ch] * (drs + drp);
        }
        const float g = dno > 0.0f ? gcos : (dno < 0.0f ? -gcos : 0.0f);
        acc3(G_n, scale(L.wo, g));
        acc3(G_wo, scale(L.nn, g));
      }
      reflect_bwd(L.wo, L.nn, G_wi, G_wo, G_n);
    }

    // at_hit's carry
    V3 G_dst;
    if (s.nee) {
      G_dst = G_dstin;
      if (L.exited) acc3(G_dst, mul(G_acc, amb));
    } else {
      G_dst = L.exited ? mul(G_dstin, amb) : G_dstin;
    }

    // the hit point, the first t and the surface, back to t, u, v
    V3 G_o = G_pos, G_d = scale(G_pos, L.th);
    float G_t = 0.0f, G_u = 0.0f, G_v = 0.0f;
    if (L.hit) {
      G_t = dot(G_pos, d);
      if (a.first && a.g_first_t != nullptr) G_t += a.g_first_t[i];
      if (want_n) {
        // faceforward, then sn = normalize(S), S = c0 w0 + c1 u + c2 v
        const V3 gsn = L.flip ? neg(G_n) : G_n;
        const V3 gS = normalize_bwd(L.S, L.sn, gsn);
        const float* cn = s.corner + 9 * L.tri;
        const float gw0 = dot(gS, ldg3(cn));
        G_u = dot(gS, ldg3(cn + 3)) - gw0;
        G_v = dot(gS, ldg3(cn + 6)) - gw0;
      }
    }
    G_d = sub(G_d, G_wo);    // wo = -d

    // intersect_triangle's backward at the hit triangle
    if (L.hit && (G_t != 0.0f || G_u != 0.0f || G_v != 0.0f)) {
      const Tri& x = L.x;
      const float T = dot(L.e2, x.s2), B1 = dot(x.dd, x.s1),
                  B2 = dot(d, x.s2);
      const float g_inv = (G_t * T + G_u * B1) + G_v * B2;
      const float g_div = -g_inv * x.inv * x.inv;
      const float gT = G_t * x.inv, gB1 = G_u * x.inv, gB2 = G_v * x.inv;
      V3 g_e2 = scale(x.s2, gT), g_s2 = scale(L.e2, gT);
      acc3(G_d, scale(x.s2, gB2));
      acc3(g_s2, scale(d, gB2));
      V3 g_dd = scale(x.s1, gB1), g_s1 = scale(x.dd, gB1);
      // s2 = dd x e1
      acc3(g_dd, cross(L.e1, g_s2));
      V3 g_e1 = cross(g_s2, x.dd);
      // div = s1 . e1
      acc3(g_s1, scale(L.e1, g_div));
      acc3(g_e1, scale(x.s1, g_div));
      // s1 = d x e2
      acc3(G_d, cross(L.e2, g_s1));
      acc3(g_e2, cross(g_s1, d));
      // dd = o - v1
      acc3(G_o, g_dd);
      if (a.g_verts != nullptr) {
        // v1 = V[f0], e1 = V[f1] - V[f0], e2 = V[f2] - V[f0]
        const V3 g0 = sub(sub(neg(g_dd), g_e1), g_e2);
        vkey = L.tri;
        for (int k = 0; k < 3; ++k) vf[k] = __ldg(a.faces + 3 * L.tri + k);
        const V3 gk[3] = {g0, g_e1, g_e2};
        for (int k = 0; k < 3; ++k) {
          gv[3 * k] = gk[k].x;
          gv[3 * k + 1] = gk[k].y;
          gv[3 * k + 2] = gk[k].z;
        }
      }
    }

    if (a.gi_o != nullptr) store3(a.gi_o, i, G_o);
    if (a.gi_d != nullptr) store3(a.gi_d, i, G_d);
    if (a.gi_dst != nullptr) store3(a.gi_dst, i, G_dst);
    if (a.gi_acc != nullptr) store3(a.gi_acc, i, G_acc);
    // cd moves f_d = cd (kd / pi): the lane's share of its material's row
    if (a.g_cd != nullptr && (G_cd.x != 0.0f || G_cd.y != 0.0f ||
                              G_cd.z != 0.0f)) {
      const float k = __ldg(m + kKdInvPi);
      key = L.geom;
      gcd[0] = static_cast<double>(G_cd.x * k);
      gcd[1] = static_cast<double>(G_cd.y * k);
      gcd[2] = static_cast<double>(G_cd.z * k);
    }
  }
  const unsigned lane = threadIdx.x & 31u;
  // the vertices: lanes of a warp on one triangle (neighbouring camera
  // rays mostly are) summed by shuffles in f64, one leader adding them
  if (a.g_verts != nullptr) {
    const unsigned vmask = __activemask();
    const unsigned vpeers = __match_any_sync(vmask, vkey);
    reduce_peers(vmask, vpeers, gv);
    if (vkey >= 0 && lane == static_cast<unsigned>(__ffs(vpeers) - 1)) {
      for (int k = 0; k < 9; ++k) {
        if (gv[k] != 0.0) atomicAdd(a.g_verts + 3 * vf[k / 3] + k % 3, gv[k]);
      }
    }
  }
  if (a.g_cd == nullptr) return;
  // the albedo rows: lanes of a warp on one row summed by shuffles, one
  // leader a row adding to the block's f64 table, the table added to the
  // output once a block
  const unsigned mask = __activemask();
  const unsigned peers = __match_any_sync(mask, key);
  reduce_peers(mask, peers, gcd);
  const bool leader = key >= 0 &&
                      lane == static_cast<unsigned>(__ffs(peers) - 1);
  if (a.smem_cd) {
    if (leader) {
      for (int ch = 0; ch < 3; ++ch) atomicAdd(s_cd + 3 * key + ch, gcd[ch]);
    }
    __syncthreads();
    for (int k = threadIdx.x; k < cd_len; k += kBlock) {
      if (s_cd[k] != 0.0) atomicAdd(a.g_cd + k, s_cd[k]);
    }
  } else if (leader) {
    for (int ch = 0; ch < 3; ++ch) atomicAdd(a.g_cd + 3 * key + ch, gcd[ch]);
  }
}

inline int blocks(int n) { return (n + kBlock - 1) / kBlock; }

SceneArgs scene_args(const void* prims, const void* prim_ids,
                     const void* normals, const void* corner,
                     const void* geom_ids, const void* mat,
                     const void* lights, const void* amb, const void* eps,
                     int num_tris, int num_lights, int nee, int reversed) {
  SceneArgs s;
  s.prims = static_cast<const float4*>(prims);
  s.prim_ids = static_cast<const int*>(prim_ids);
  s.normals = static_cast<const float*>(normals);
  s.corner = static_cast<const float*>(corner);
  s.geom_ids = static_cast<const int*>(geom_ids);
  s.mat = static_cast<const float*>(mat);
  s.lights = static_cast<const float*>(lights);
  s.amb = static_cast<const float*>(amb);
  s.eps = static_cast<const float*>(eps);
  s.num_tris = num_tris;
  s.num_lights = num_lights;
  s.nee = nee;
  s.reversed = reversed;
  return s;
}

bool scene_ok(const SceneArgs& s) {
  return s.num_tris >= 1 && s.num_lights >= 0 &&
         !(s.nee && s.num_lights > 0 && !s.lights);
}

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
  a.s = scene_args(prims, prim_ids, normals, corner, geom_ids, mat, lights,
                   amb, eps, num_tris, num_lights, nee, reversed);
  a.ori = static_cast<const float*>(ori);
  a.dir = static_cast<const float*>(dir);
  a.ref = static_cast<const int*>(ref);
  a.state = static_cast<const long long*>(state);
  a.active = static_cast<const unsigned char*>(active);
  a.dst = static_cast<const float*>(dst);
  a.acc = static_cast<const float*>(acc);
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
  const bool shadows = nee && num_lights > 0;
  if (n <= 0 || !scene_ok(a.s) ||
      (shadows && (!a.shadow_o || !a.shadow_d || !a.shadow_t || !a.fire)) ||
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

extern "C" int vsnray_bounce_shade_bwd(
    const void* ori, const void* dir, const void* ref, const void* state,
    const void* active, const void* dst, const void* acc,
    const void* prev_delta, const void* shadow_ref, const void* prims,
    const void* prim_ids, const void* normals, const void* corner,
    const void* geom_ids, const void* faces, const void* mat,
    const void* lights, const void* amb, const void* eps, const void* g_o,
    const void* g_d, const void* g_dst, const void* g_acc,
    const void* g_first_t, void* gi_o, void* gi_d, void* gi_dst,
    void* gi_acc, void* g_verts, void* g_cd, int n, int num_tris,
    int num_lights, int num_mats, int nee, int first, void* stream) {
  BwdArgs a;
  a.s = scene_args(prims, prim_ids, normals, corner, geom_ids, mat, lights,
                   amb, eps, num_tris, num_lights, nee, 0);
  a.ori = static_cast<const float*>(ori);
  a.dir = static_cast<const float*>(dir);
  a.ref = static_cast<const int*>(ref);
  a.state = static_cast<const long long*>(state);
  a.active = static_cast<const unsigned char*>(active);
  a.dst = static_cast<const float*>(dst);
  a.acc = static_cast<const float*>(acc);
  a.prev_delta = static_cast<const unsigned char*>(prev_delta);
  a.shadow_ref = static_cast<const int*>(shadow_ref);
  a.faces = static_cast<const int*>(faces);
  a.g_o = static_cast<const float*>(g_o);
  a.g_d = static_cast<const float*>(g_d);
  a.g_dst = static_cast<const float*>(g_dst);
  a.g_acc = static_cast<const float*>(g_acc);
  a.g_first_t = static_cast<const float*>(g_first_t);
  a.gi_o = static_cast<float*>(gi_o);
  a.gi_d = static_cast<float*>(gi_d);
  a.gi_dst = static_cast<float*>(gi_dst);
  a.gi_acc = static_cast<float*>(gi_acc);
  a.g_verts = static_cast<double*>(g_verts);
  a.g_cd = static_cast<double*>(g_cd);
  a.n = n;
  a.num_mats = num_mats;
  a.first = first;
  const int smem = 3 * num_mats * static_cast<int>(sizeof(double));
  a.smem_cd = a.g_cd != nullptr && smem <= kMaxSmemCd;
  if (n <= 0 || num_mats < 1 || !scene_ok(a.s) ||
      (nee && num_lights > 0 && !a.shadow_ref) ||
      (a.g_verts != nullptr && !a.faces)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  shade_bwd<<<blocks(n), kBlock, a.smem_cd ? smem : 0,
              static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

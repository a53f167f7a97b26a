// jnp.minimum / jnp.maximum on the card: NaN if either operand is NaN.
// CUDA's fminf / fmaxf return the other operand instead, so a slab test
// built on them would enter a box that the JAX package's jnp tier misses
// (a zero direction component with the origin on a box plane gives
// 0 * inf = NaN).  On the card one instruction each: PTX min.NaN /
// max.NaN (sm_80 and later), which return NaN where either operand is
// NaN and else what min / max (fminf / fmaxf) return; the host build of a
// CPU rehearsal takes the test.  Shared by traverse_lbvh.cu and the volume
// kernels (volume_common.cuh).

#pragma once

#include <math.h>

static __device__ __forceinline__ float nan_min(float a, float b) {
#if defined(__CUDA_ARCH__)
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
#else
  return (isnan(a) || isnan(b)) ? NAN : fminf(a, b);
#endif
}
static __device__ __forceinline__ float nan_max(float a, float b) {
#if defined(__CUDA_ARCH__)
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
#else
  return (isnan(a) || isnan(b)) ? NAN : fmaxf(a, b);
#endif
}

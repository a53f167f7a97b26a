// jnp.minimum / jnp.maximum on the card: NaN if either operand is NaN.
// CUDA's fminf / fmaxf return the other operand instead, so a slab test
// built on them would enter a box that the JAX package's jnp tier misses
// (a zero direction component with the origin on a box plane gives
// 0 * inf = NaN).  Shared by traverse_lbvh.cu and volume_march.cu.

#pragma once

#include <math.h>

static __device__ __forceinline__ float nan_min(float a, float b) {
  return (isnan(a) || isnan(b)) ? NAN : fminf(a, b);
}
static __device__ __forceinline__ float nan_max(float a, float b) {
  return (isnan(a) || isnan(b)) ? NAN : fmaxf(a, b);
}

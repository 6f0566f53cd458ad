// Device helpers shared by the quantizer kernels (qdq_ragged.cu,
// qdq_tiled.cu): NaN-propagating min/max/clip, a block-wide reduction of
// (min, max, sum) in a fixed order, and the affine round trip of
// `_affine_roundtrip` (fedtorch_tpu/ops/pallas/quant_kernel.py:43-54):
//
//   scale = (mx - mn) / (qmax - qmin);  scale == 0 -> 0.001
//   zp    = trunc(clip(qmin - (mn - mean) / scale, qmin, qmax))
//   q     = clip(rint(zp + (x - mean) / scale), qmin, qmax)
//   out   = scale * (q - zp) + mean
//
// Numerics follow the formula literally: IEEE division (no fast math, no
// reciprocal), rintf (round half to even, as jnp.round), truncf, and a
// build with --fmad=false so the last line is not contracted into an FMA.
// min, max and clip propagate NaN as jnp.min / jnp.max / jnp.clip do
// (fminf and fmaxf would drop it).
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace qdq {

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a < b || isnan(a)) ? a : b;
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || isnan(a)) ? a : b;
}

// jnp.clip(v, lo, hi) == minimum(maximum(v, lo), hi): NaN in, NaN out.
__device__ __forceinline__ float clip(float v, float lo, float hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ void accumulate(float v, float& mn, float& mx,
                                           float& sum) {
  mn = nan_min(mn, v);
  mx = nan_max(mx, v);
  sum += v;
}

// Reduces each thread's (mn, mx, sum) over the block: warp shuffles, then
// across the warps in shared memory. The order is fixed, so a rerun gives
// the same bits. Every thread returns with the block's result.
template <int kThreads>
__device__ __forceinline__ void block_reduce(float& mn, float& mx,
                                             float& sum) {
  constexpr int kWarps = kThreads / 32;
  for (int off = 16; off > 0; off >>= 1) {
    mn = nan_min(mn, __shfl_xor_sync(0xffffffffu, mn, off));
    mx = nan_max(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  }
  __shared__ float s_mn[kWarps], s_mx[kWarps], s_sum[kWarps];
  __shared__ float s_out[3];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    s_mn[warp] = mn;
    s_mx[warp] = mx;
    s_sum[warp] = sum;
  }
  __syncthreads();
  if (warp == 0) {
    mn = lane < kWarps ? s_mn[lane] : INFINITY;
    mx = lane < kWarps ? s_mx[lane] : -INFINITY;
    sum = lane < kWarps ? s_sum[lane] : 0.0f;
    for (int off = kWarps / 2; off > 0; off >>= 1) {
      mn = nan_min(mn, __shfl_xor_sync(0xffffffffu, mn, off));
      mx = nan_max(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    }
    if (lane == 0) {
      s_out[0] = mn;
      s_out[1] = mx;
      s_out[2] = sum;
    }
  }
  __syncthreads();
  mn = s_out[0];
  mx = s_out[1];
  sum = s_out[2];
}

struct Affine {
  float scale, zp, mean, qmin, qmax;
};

__device__ __forceinline__ Affine make_affine(float mn, float mx, float mean,
                                              int num_bits) {
  Affine a;
  a.qmin = -static_cast<float>(1 << (num_bits - 1));
  a.qmax = static_cast<float>((1 << (num_bits - 1)) - 1);
  a.scale = (mx - mn) / (a.qmax - a.qmin);
  if (a.scale == 0.0f) a.scale = 0.001f;
  a.zp = truncf(clip(a.qmin - (mn - mean) / a.scale, a.qmin, a.qmax));
  a.mean = mean;
  return a;
}

__device__ __forceinline__ float roundtrip(float x, const Affine& a) {
  const float q = clip(rintf(a.zp + (x - a.mean) / a.scale), a.qmin, a.qmax);
  return a.scale * (q - a.zp) + a.mean;
}

}  // namespace qdq

// Per-row adaptive affine quantize -> dequantize, hand-written for Hopper
// (sm_90a).
//
// Replaces the TPU Pallas kernel `_qdq_batch_kernel`
// (fedtorch_tpu/ops/pallas/quant_kernel.py:76), which the JAX package
// launches through `_pallas_qdq_batch_padded` (`pallas_call` at :179) from
// `fused_quantize_dequantize_batch` and `fused_quantize_dequantize_tree`:
// the uplink and downlink wire format of quantized FedAvg. Row r of the
// [rows, n] input gets its own min, max and mean over its n elements, then
// the round trip of `_affine_roundtrip` (quant_kernel.py:43-54):
//
//   scale = (mx - mn) / (qmax - qmin);  scale == 0 -> 0.001
//   zp    = trunc(clip(qmin - (mn - mean) / scale, qmin, qmax))
//   q     = clip(rint(zp + (x - mean) / scale), qmin, qmax)
//   out   = scale * (q - zp) + mean
//
// What bounds it: bytes. Each element is read once for the statistics and
// once more (from L2) for the round trip, and written once; about 2 flops
// per byte moved. A quantized ResNet-20 round moves 2 x 10 x 272,474 x 4 B
// = 21.8 MB through the uplink, ~6.5 us at 3.35 TB/s, so at these sizes the
// 26 launches of a round (13 leaf sizes, uplink and downlink), not the
// bytes, set its time.
//
// Design, simple and right first: one block of 256 threads per row. Pass 1
// is a coalesced strided loop keeping a per-thread min, max and float32
// sum, reduced by warp shuffles and then across the 8 warps in shared
// memory. Pass 2 re-reads the row (it is in L2: the largest row is 147 KB)
// and writes the round trip. The TPU kernel's 128-lane / 8-sublane
// padding, its VMEM ceiling and its fallbacks are gone: the kernel takes
// the unpadded contiguous [rows, n] tensor and masks nothing.
//
// Numerics follow the formula literally: IEEE division (no fast math, no
// reciprocal), rintf (round half to even, as jnp.round), truncf, and a
// build with --fmad=false so the last line is not contracted into an FMA.
// min, max and clip propagate NaN as jnp.min / jnp.max / jnp.clip do
// (fminf and fmaxf would drop it). Sums run in another order than on the
// CPU or the TPU, so the mean may differ in its last bit; on inputs whose
// sums are exact the output is bitwise the reference's.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

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

__global__ void __launch_bounds__(kThreads)
qdq_batch_kernel(const float* __restrict__ x, float* __restrict__ out,
                 int64_t n, float qmin, float qmax) {
  const int64_t row = blockIdx.x;
  const float* xr = x + row * n;
  float* outr = out + row * n;

  // pass 1: per-thread statistics over a strided, coalesced sweep
  float mn = INFINITY, mx = -INFINITY, sum = 0.0f;
  for (int64_t i = threadIdx.x; i < n; i += kThreads) {
    const float v = xr[i];
    mn = nan_min(mn, v);
    mx = nan_max(mx, v);
    sum += v;
  }
  for (int off = 16; off > 0; off >>= 1) {
    mn = nan_min(mn, __shfl_xor_sync(0xffffffffu, mn, off));
    mx = nan_max(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  }
  __shared__ float s_mn[kWarps], s_mx[kWarps], s_sum[kWarps];
  __shared__ float s_stats[3];
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
      s_stats[0] = mn;
      s_stats[1] = mx;
      s_stats[2] = sum / static_cast<float>(n);
    }
  }
  __syncthreads();
  mn = s_stats[0];
  mx = s_stats[1];
  const float mean = s_stats[2];

  float scale = (mx - mn) / (qmax - qmin);
  if (scale == 0.0f) scale = 0.001f;
  const float zp = truncf(clip(qmin - (mn - mean) / scale, qmin, qmax));

  // pass 2: the affine round trip (the row is re-read from L2)
  for (int64_t i = threadIdx.x; i < n; i += kThreads) {
    const float q = clip(rintf(zp + (xr[i] - mean) / scale), qmin, qmax);
    outr[i] = scale * (q - zp) + mean;
  }
}

}  // namespace

// x, out: contiguous float32 [rows, n] on the current device; rows >= 1,
// n >= 1, num_bits 8 or 16 (the Python wrapper checks all of it). Launches
// on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int qdq_batch_f32(const float* x, float* out, int64_t rows,
                             int64_t n, int num_bits, void* stream) {
  const float qmin = -static_cast<float>(1 << (num_bits - 1));
  const float qmax = static_cast<float>((1 << (num_bits - 1)) - 1);
  qdq_batch_kernel<<<static_cast<unsigned int>(rows), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(x, out, n, qmin,
                                                          qmax);
  return static_cast<int>(cudaGetLastError());
}

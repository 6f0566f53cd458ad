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
// Numerics (qdq_common.cuh): IEEE division, rintf, truncf, --fmad=false
// and NaN-propagating min, max and clip. Sums run in another order than
// on the CPU or the TPU, so the mean may differ in its last bit; on
// inputs whose sums are exact the output is bitwise the reference's.

#include "qdq_common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
qdq_batch_kernel(const float* __restrict__ x, float* __restrict__ out,
                 int64_t n, int num_bits) {
  const int64_t row = blockIdx.x;
  const float* xr = x + row * n;
  float* outr = out + row * n;

  // pass 1: per-thread statistics over a strided, coalesced sweep
  float mn = INFINITY, mx = -INFINITY, sum = 0.0f;
  for (int64_t i = threadIdx.x; i < n; i += kThreads) {
    qdq::accumulate(xr[i], mn, mx, sum);
  }
  qdq::block_reduce<kThreads>(mn, mx, sum);
  const qdq::Affine a =
      qdq::make_affine(mn, mx, sum / static_cast<float>(n), num_bits);

  // pass 2: the affine round trip (the row is re-read from L2)
  for (int64_t i = threadIdx.x; i < n; i += kThreads) {
    outr[i] = qdq::roundtrip(xr[i], a);
  }
}

}  // namespace

// x, out: contiguous float32 [rows, n] on the current device; rows >= 1,
// n >= 1, num_bits 8 or 16 (the Python wrapper checks all of it). Launches
// on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int qdq_batch_f32(const float* x, float* out, int64_t rows,
                             int64_t n, int num_bits, void* stream) {
  qdq_batch_kernel<<<static_cast<unsigned int>(rows), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(x, out, n,
                                                          num_bits);
  return static_cast<int>(cudaGetLastError());
}

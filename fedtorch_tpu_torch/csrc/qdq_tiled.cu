// Multi-block two-pass adaptive affine quantize -> dequantize for long
// rows, hand-written for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernels `_tiled_stats_kernel` and
// `_tiled_apply_kernel` (fedtorch_tpu/ops/pallas/quant_kernel.py:83 and
// :111), which the JAX package launches through `_pallas_qdq_tiled`
// (`pallas_call` at :130 and :142) for a tensor of more than 512k
// elements. Here each row of a contiguous [rows, n] float32 tensor gets
// its own min, max and mean over its n elements, then the round trip of
// `_affine_roundtrip` (qdq_common.cuh). One launch of each kernel serves a
// whole bucket of leaves of one size: WideResNet-28-10's uplink stacks
// 7 leaves x 10 clients of 3,686,400 elements as [70, 3,686,400].
//
// Redesigned for the GPU, not translated. The TPU kernel walks its grid
// in order on one core and carries [min, max, sum] in SMEM from one
// step to the next. CUDA blocks run in parallel and in no order, so:
//
// * qdq_tiled_stats_f32: grid (nchunks, rows). Block (c, r) reduces
//   elements [c*chunk, min((c+1)*chunk, n)) of row r to a partial
//   [min, max, sum], written to the float32 workspace [rows, nchunks, 3].
//   No float atomics: every sum has a fixed order, so a rerun gives the
//   same bits.
// * qdq_tiled_apply_f32: the same grid. Block (c, r) first folds row r's
//   nchunks partials (min and max NaN-propagating, the sum by a fixed
//   tree), takes mean = sum / n with IEEE division, then writes its
//   chunk's round trip. Every block of a row folds the same partials in
//   the same order, so all of them see the same statistics. Folding in
//   every block costs one read of <= ~1,000 x 12 bytes from L2 per block
//   of 2 x 32 KB of device memory traffic; a third launch that folds once
//   would save that read but add a launch and a dependency to each
//   bucket, so the fold stays in the apply kernel.
//
// What bounds it: bytes. The stats pass reads every element once, the
// apply pass reads it once more and writes it once; about 12 float32
// operations per element against 12 bytes moved. A quantized WideResNet-
// 28-10 round sends 375,091,200 elements through the pair: 0.448 ms for
// stats and 0.896 ms for apply at 3.35 TB/s. No row fits in the 50 MB L2,
// so both passes stream from device memory. chunk = 8192 (the wrapper's
// choice) gives 450 blocks per 3,686,400-element row and 31,500 blocks
// for the largest bucket, many per SM; each thread moves 8 float4.
//
// Loads and stores are coalesced and 16 bytes wide where the chunk's
// address is 16-byte aligned (every row of a WideResNet bucket is: its
// sizes are multiples of 4), scalar otherwise. Offsets are 64-bit: row
// times n may exceed 2^31 for a wider model. Numerics as in
// qdq_common.cuh; on inputs whose sums are exact the output is bitwise
// equal to the plain version's (ops/cuda/quant_kernel.py,
// qdq_tiled_ref).

#include "qdq_common.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

__global__ void __launch_bounds__(kThreads)
tiled_stats_kernel(const float* __restrict__ x, float* __restrict__ partials,
                   int64_t n, int64_t chunk) {
  const int64_t c = blockIdx.x, row = blockIdx.y, nchunks = gridDim.x;
  const int64_t start = c * chunk;
  const int64_t len = n - start < chunk ? n - start : chunk;
  const float* p = x + row * n + start;

  float mn = INFINITY, mx = -INFINITY, sum = 0.0f;
  int64_t done = 0;
  if (aligned16(p)) {
    const float4* p4 = reinterpret_cast<const float4*>(p);
    const int64_t nv = len / 4;
#pragma unroll 4
    for (int64_t i = threadIdx.x; i < nv; i += kThreads) {
      const float4 v = p4[i];
      qdq::accumulate(v.x, mn, mx, sum);
      qdq::accumulate(v.y, mn, mx, sum);
      qdq::accumulate(v.z, mn, mx, sum);
      qdq::accumulate(v.w, mn, mx, sum);
    }
    done = nv * 4;
  }
  for (int64_t i = done + threadIdx.x; i < len; i += kThreads) {
    qdq::accumulate(p[i], mn, mx, sum);
  }
  qdq::block_reduce<kThreads>(mn, mx, sum);
  if (threadIdx.x == 0) {
    float* o = partials + (row * nchunks + c) * 3;
    o[0] = mn;
    o[1] = mx;
    o[2] = sum;
  }
}

__global__ void __launch_bounds__(kThreads)
tiled_apply_kernel(const float* __restrict__ x,
                   const float* __restrict__ partials,
                   float* __restrict__ out, int64_t n, int64_t chunk,
                   int num_bits) {
  const int64_t c = blockIdx.x, row = blockIdx.y, nchunks = gridDim.x;

  // fold the row's partials in a fixed order
  const float* pr = partials + row * nchunks * 3;
  float mn = INFINITY, mx = -INFINITY, sum = 0.0f;
  for (int64_t j = threadIdx.x; j < nchunks; j += kThreads) {
    mn = qdq::nan_min(mn, pr[3 * j]);
    mx = qdq::nan_max(mx, pr[3 * j + 1]);
    sum += pr[3 * j + 2];
  }
  qdq::block_reduce<kThreads>(mn, mx, sum);
  const qdq::Affine a =
      qdq::make_affine(mn, mx, sum / static_cast<float>(n), num_bits);

  const int64_t start = c * chunk;
  const int64_t len = n - start < chunk ? n - start : chunk;
  const float* p = x + row * n + start;
  float* o = out + row * n + start;
  int64_t done = 0;
  if (aligned16(p) && aligned16(o)) {
    const float4* p4 = reinterpret_cast<const float4*>(p);
    float4* o4 = reinterpret_cast<float4*>(o);
    const int64_t nv = len / 4;
#pragma unroll 4
    for (int64_t i = threadIdx.x; i < nv; i += kThreads) {
      const float4 v = p4[i];
      o4[i] = make_float4(qdq::roundtrip(v.x, a), qdq::roundtrip(v.y, a),
                          qdq::roundtrip(v.z, a), qdq::roundtrip(v.w, a));
    }
    done = nv * 4;
  }
  for (int64_t i = done + threadIdx.x; i < len; i += kThreads) {
    o[i] = qdq::roundtrip(p[i], a);
  }
}

}  // namespace

// x: contiguous float32 [rows, n]; partials: float32 [rows, nchunks, 3]
// with nchunks = ceil(n / chunk); 1 <= rows <= 65535, n >= 1, chunk >= 1,
// nchunks <= 2^31 - 1 (the Python wrapper checks all of it). Launches on
// `stream` and returns cudaGetLastError() (0 on success).
extern "C" int qdq_tiled_stats_f32(const float* x, float* partials,
                                   int64_t rows, int64_t n, int64_t chunk,
                                   void* stream) {
  const dim3 grid(static_cast<unsigned int>((n + chunk - 1) / chunk),
                  static_cast<unsigned int>(rows));
  tiled_stats_kernel<<<grid, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(x, partials, n,
                                                            chunk);
  return static_cast<int>(cudaGetLastError());
}

// x, out: contiguous float32 [rows, n]; partials as written by
// qdq_tiled_stats_f32 with the same chunk; num_bits 8 or 16.
extern "C" int qdq_tiled_apply_f32(const float* x, const float* partials,
                                   float* out, int64_t rows, int64_t n,
                                   int64_t chunk, int num_bits,
                                   void* stream) {
  const dim3 grid(static_cast<unsigned int>((n + chunk - 1) / chunk),
                  static_cast<unsigned int>(rows));
  tiled_apply_kernel<<<grid, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      x, partials, out, n, chunk, num_bits);
  return static_cast<int>(cudaGetLastError());
}

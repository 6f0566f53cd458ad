// Ragged multi-block two-pass adaptive affine quantize -> dequantize over
// many leaves at once, hand-written for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel `_qdq_batch_kernel`
// (fedtorch_tpu/ops/pallas/quant_kernel.py:76), which the JAX package
// launches through `_pallas_qdq_batch_padded` (`pallas_call` at :179) once
// per bucket of equal-sized leaves from `fused_quantize_dequantize_tree`,
// and, as its one-row case, `_qdq_kernel` (:72, through
// `_pallas_qdq_padded`, `pallas_call` at :162) from the single-tensor
// `fused_quantize_dequantize`. Each row of each leaf (a contiguous float32
// [rows, n] tensor: one (tensor, client) row on the uplink, one tensor on
// the downlink) gets its own min, max and mean over its n elements, then
// the round trip of `_affine_roundtrip` (qdq_common.cuh).
//
// Redesigned for the GPU, not translated. The TPU kernel holds a whole
// padded row in VMEM and takes one grid step per row, one launch per
// leaf size. Here one launch of each kernel covers every leaf of a tree
// call, read in place (no stack into a bucket first):
//
// * A segment is one row of one leaf. It is cut into chunks of `chunk`
//   elements (the wrapper's _CHUNK, 8192, as in qdq_tiled.cu), the last
//   one ragged; a row shorter than a chunk is one chunk. The grid has one
//   block of 256 threads per chunk of every row of every leaf: ~4,800
//   blocks on the transformer's uplink, ~920 on ResNet-20's.
// * The leaf table (per leaf: input and output pointer, n, the leaf's
//   first chunk in the grid) is a kernel parameter passed by value
//   (__grid_constant__, read from the parameter bank): no table in device
//   memory, no copy from the host per call, and a launch that a CUDA graph
//   can capture. kMaxLeaves leaves x 32 bytes stay under the 32,764-byte
//   parameter limit of CUDA 12.1 on Volta and later (DenseNet-BC-100's
//   299 leaves: one launch of each kernel a tree call, where the classic
//   4 KB limit's 96 leaves took four). A tree of more than kMaxLeaves
//   leaves takes more launches (the wrapper splits it). Block b finds its
//   leaf by a binary search over the table's first chunks (9 compares at
//   299 leaves), then its row and its chunk within the row.
// * qdq_ragged_stats_f32 reduces its chunk to a partial [min, max, sum],
//   written to the float32 workspace [total_chunks, 3]. No float atomics:
//   every sum has a fixed order, so a rerun gives the same bits.
// * qdq_ragged_apply_f32 runs on the same grid. Each block folds its own
//   row's partials in a fixed order (min and max NaN-propagating, the sum
//   by a fixed tree, as qdq_tiled.cu does), takes mean = sum / n with IEEE
//   division, and writes its chunk's round trip. Every block of a row
//   folds the same partials in the same order, so all of them see the
//   same statistics.
//
// Why two passes: a row's statistics need every element of the row before
// any output of it, and the blocks of a long row run in parallel in no
// order; sharing statistics between them takes a second launch or a
// grid-wide barrier. The two-launch form keeps each pass a plain stream.
//
// What bounds it: bytes. The function must read each element once and
// write it once, 8 bytes per element (ResNet-20's uplink and downlink
// together: 2 x 11 x 272,474 x 4 B = 24 MB, 7.2 us at 3.35 TB/s). The two
// passes read each element twice, 12 bytes per element, when a call's
// payload does not stay in the 50 MB L2 between them (the transformer's
// uplink is 149 MB); a payload that fits (every downlink, ResNet-20's
// uplink) re-reads from L2. About 12 float32 operations per element, so
// the operations never bound it.
//
// Short rows keep a block each. ResNet-20's uplink has 430 rows of 16-64
// elements (the norm layers' scales and biases), each one block of 256
// threads, mostly idle. On an H100 80GB HBM3 at 700 W (chip_smoke.py)
// they cost 0.0098 ms of the 0.0243 ms uplink call hot in L2: the blocks
// cost, not their 69 KB. That is about 3e-6 of a ResNet-20 round; one
// warp per short row in shared blocks would add a second kind of block to
// both kernels to save at most that.
//
// Loads and stores are 16 bytes wide from the first 16-byte boundary of a
// chunk, with scalar head and tail elements: leaves of 10 or 86 elements
// per row put later rows off alignment. The apply pass takes the vector
// form where input and output share their offset within 16 bytes, scalar
// otherwise. Offsets are 64-bit. Numerics as in qdq_common.cuh (IEEE
// division, rintf, truncf, --fmad=false, NaN-propagating min, max and
// clip); on inputs whose sums are exact the output is bitwise the plain
// version's (ops/cuda/quant_kernel.py, qdq_ragged_ref).

#include "qdq_common.cuh"

#if CUDART_VERSION < 12010
#error "the leaf table needs CUDA 12.1's 32 KB kernel parameters"
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLeaves = 1000;  // the wrapper's _TABLE_LEAVES

struct Leaf {
  const float* x;
  float* out;
  int64_t n;           // elements per row
  int64_t chunk_base;  // the leaf's first chunk in this launch's grid
};

struct LeafTable {
  Leaf leaf[kMaxLeaves];
  int count;
};

static_assert(sizeof(Leaf) == 32, "one table record is 32 bytes");
static_assert(sizeof(LeafTable) + 64 <= 32764,
              "the table and the other parameters fit in 32,764 B");

// Where block b's chunk lies: its leaf, the chunk's first element and
// length within the leaf, and the grid index and count of its row's chunks.
struct Segment {
  int leaf;
  int64_t start, len, n, first, nchunks;
};

__device__ __forceinline__ Segment locate(const LeafTable& t, int64_t b,
                                          int64_t chunk) {
  int lo = 0, hi = t.count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.leaf[mid].chunk_base <= b) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  const Leaf& l = t.leaf[lo];
  Segment s;
  s.leaf = lo;
  s.n = l.n;
  s.nchunks = (l.n + chunk - 1) / chunk;
  const int64_t local = b - l.chunk_base;
  const int64_t row = local / s.nchunks, c = local - row * s.nchunks;
  s.first = l.chunk_base + row * s.nchunks;
  s.start = row * l.n + c * chunk;
  s.len = l.n - c * chunk < chunk ? l.n - c * chunk : chunk;
  return s;
}

// Elements of [p, p + len) before the first 16-byte boundary (p is 4-byte
// aligned, as every float32 tensor is).
__device__ __forceinline__ int64_t head_elems(const float* p, int64_t len) {
  const int64_t h = ((16u - (reinterpret_cast<uintptr_t>(p) & 15u)) & 15u) / 4;
  return h < len ? h : len;
}

__global__ void __launch_bounds__(kThreads)
qdq_ragged_stats_kernel(const __grid_constant__ LeafTable t,
                        float* __restrict__ partials, int64_t chunk) {
  const int64_t b = blockIdx.x;
  const Segment s = locate(t, b, chunk);
  const float* p = t.leaf[s.leaf].x + s.start;

  float mn = INFINITY, mx = -INFINITY, sum = 0.0f;
  const int64_t head = head_elems(p, s.len);
  if (threadIdx.x < head) qdq::accumulate(p[threadIdx.x], mn, mx, sum);
  const float4* p4 = reinterpret_cast<const float4*>(p + head);
  const int64_t nv = (s.len - head) / 4;
#pragma unroll 4
  for (int64_t i = threadIdx.x; i < nv; i += kThreads) {
    const float4 v = p4[i];
    qdq::accumulate(v.x, mn, mx, sum);
    qdq::accumulate(v.y, mn, mx, sum);
    qdq::accumulate(v.z, mn, mx, sum);
    qdq::accumulate(v.w, mn, mx, sum);
  }
  for (int64_t i = head + 4 * nv + threadIdx.x; i < s.len; i += kThreads) {
    qdq::accumulate(p[i], mn, mx, sum);
  }
  qdq::block_reduce<kThreads>(mn, mx, sum);
  if (threadIdx.x == 0) {
    partials[3 * b] = mn;
    partials[3 * b + 1] = mx;
    partials[3 * b + 2] = sum;
  }
}

__global__ void __launch_bounds__(kThreads)
qdq_ragged_apply_kernel(const __grid_constant__ LeafTable t,
                        const float* __restrict__ partials, int64_t chunk,
                        int num_bits) {
  const Segment s = locate(t, blockIdx.x, chunk);

  // fold the row's partials in a fixed order
  const float* pr = partials + 3 * s.first;
  float mn = INFINITY, mx = -INFINITY, sum = 0.0f;
  for (int64_t j = threadIdx.x; j < s.nchunks; j += kThreads) {
    mn = qdq::nan_min(mn, pr[3 * j]);
    mx = qdq::nan_max(mx, pr[3 * j + 1]);
    sum += pr[3 * j + 2];
  }
  qdq::block_reduce<kThreads>(mn, mx, sum);
  const qdq::Affine a =
      qdq::make_affine(mn, mx, sum / static_cast<float>(s.n), num_bits);

  const float* p = t.leaf[s.leaf].x + s.start;
  float* o = t.leaf[s.leaf].out + s.start;
  int64_t head = 0, nv = 0;
  if (((reinterpret_cast<uintptr_t>(p) ^ reinterpret_cast<uintptr_t>(o))
       & 15u) == 0) {
    head = head_elems(p, s.len);
    nv = (s.len - head) / 4;
  }
  if (threadIdx.x < head) o[threadIdx.x] = qdq::roundtrip(p[threadIdx.x], a);
  const float4* p4 = reinterpret_cast<const float4*>(p + head);
  float4* o4 = reinterpret_cast<float4*>(o + head);
#pragma unroll 4
  for (int64_t i = threadIdx.x; i < nv; i += kThreads) {
    const float4 v = p4[i];
    o4[i] = make_float4(qdq::roundtrip(v.x, a), qdq::roundtrip(v.y, a),
                        qdq::roundtrip(v.z, a), qdq::roundtrip(v.w, a));
  }
  for (int64_t i = head + 4 * nv + threadIdx.x; i < s.len; i += kThreads) {
    o[i] = qdq::roundtrip(p[i], a);
  }
}

// The table from the host records, 4 int64 per leaf: input pointer,
// output pointer, n, first chunk.
int fill(const int64_t* rec, int count, LeafTable& t) {
  if (count < 1 || count > kMaxLeaves) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int i = 0; i < count; ++i, rec += 4) {
    t.leaf[i].x = reinterpret_cast<const float*>(rec[0]);
    t.leaf[i].out = reinterpret_cast<float*>(rec[1]);
    t.leaf[i].n = rec[2];
    t.leaf[i].chunk_base = rec[3];
  }
  t.count = count;
  return 0;
}

}  // namespace

// table: `count` host records as fill() reads them, 1 <= count <= 1000, the
// first chunks ascending from 0 with each leaf's rows x ceil(n / chunk)
// chunks; x: contiguous float32 [rows, n] on the current device; partials:
// float32 [nblocks, 3] with nblocks the table's total chunks,
// 1 <= nblocks <= 2^31 - 1 (the Python wrapper checks all of it).
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int qdq_ragged_stats_f32(const int64_t* table, int count,
                                    float* partials, int64_t nblocks,
                                    int64_t chunk, void* stream) {
  LeafTable t{};
  const int err = fill(table, count, t);
  if (err != 0) return err;
  qdq_ragged_stats_kernel<<<static_cast<unsigned int>(nblocks), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(t, partials,
                                                                 chunk);
  return static_cast<int>(cudaGetLastError());
}

// The same table and grid; partials as qdq_ragged_stats_f32 wrote them
// with the same chunk; each out a contiguous float32 [rows, n]; num_bits
// 8 or 16.
extern "C" int qdq_ragged_apply_f32(const int64_t* table, int count,
                                    const float* partials, int64_t nblocks,
                                    int64_t chunk, int num_bits,
                                    void* stream) {
  LeafTable t{};
  const int err = fill(table, count, t);
  if (err != 0) return err;
  qdq_ragged_apply_kernel<<<static_cast<unsigned int>(nblocks), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      t, partials, chunk, num_bits);
  return static_cast<int>(cudaGetLastError());
}

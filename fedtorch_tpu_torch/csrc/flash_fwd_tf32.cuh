// Exact attention forward with the online softmax on Hopper's tensor cores
// in TF32 (sm_90a): float32 at any head dim, and every bfloat16 input the
// wgmma kernel (`flash_fwd_sm90.cu`) does not take.
//
// Replaces the TPU Pallas kernel `_fwd_kernel`
// (fedtorch_tpu/ops/pallas/flash_attention.py:82), which the JAX package
// launches through `_fwd_pallas` (`pallas_call` at :168), for the inputs
// that `ops/cuda/flash_attention.py::_route` sends to "tf32": float32 (the
// library's default dtype), bfloat16 at head dims other than 64, 128, 192
// and 256 (and 512), and views that are misaligned or strided past what TMA
// takes. It
// computes what that kernel and its oracle `_fwd_xla` compute: for each
// (batch, head) and query row i, over the keys j it sees (j <= i when
// causal),
//
//   s_j = (q_i . k_j) * scale          in float32
//   o_i = sum_j exp(s_j - lse_i) v_j,  lse_i = log sum_j exp(s_j)
//
// with o in the inputs' dtype and lse in float32 [B, H, T].
//
// What bounds it: operations. At (B 8, T 2048, H 4, D 64, causal) the
// useful work is 4 B H D T(T+1)/2 = 17.2 GFLOP: 0.2566 ms on the CUDA
// cores' 67 TFLOP/s of float32, which is where the kernel it replaces ran.
// One TF32 product keeps 10 mantissa bits and would break the float32 bar
// (2e-5; tests/test_torch_flash_tf32.py shows it), so float32 products
// run as 3xTF32, the split of CUTLASS's OpMultiplyAddFastF32:
// x_hi = tf32(x), x_lo = x - x_hi (read as TF32 by the tensor cores), and
// a b = a_hi b_hi + a_hi b_lo + a_lo b_hi summed in float32 (a_lo b_lo,
// ~2^-22 of a b, is dropped).
// Three TF32 products of 17.2 GFLOP take 0.1042 ms at the card's 495
// TFLOP/s; the bytes (67.4 MB in float32) take 0.0201 ms. bfloat16 values
// are exact in TF32, so bf16 q K^T is one product and P V two (p still
// split).
//
// Design:
// - One CTA of 8 warps per (batch*head, 128 query rows); each warp owns
//   16 rows and runs `mma.sync.m16n8k8` TF32 with float32 accumulators,
//   and each K/V tile in shared memory feeds all 8. The heaviest causal
//   query tiles are launched first (grid y runs from the last tile down).
//   Registers are capped at 128 a thread (2 CTAs an SM) below D 128; from
//   D 128 on one CTA an SM takes what it needs (up to 255 a thread: a
//   warp's O at D 256 is 16 rows x 256 columns, 128 float32 a thread).
// - Q is read once into shared memory as float32 (bf16 widened exactly),
//   columns >= D and rows >= T zero. K and V tiles of 32 keys (16 past D
//   128) come in by
//   `cp.async` into a two-stage ring, tile i + 1's copy in flight while
//   tile i is computed: 16-byte copies where every pointer, stride and row
//   allows, 4-byte copies otherwise (any float32 view; bf16 with 4-byte
//   pointers and even strides), element loads for the rest (misaligned
//   bf16). The CTA's threads take a tile's pieces in turn, with constant
//   loop bounds over the padded width. Rows past T are zero-filled by the
//   copy itself, columns >= D were zeroed once, so any D <= 256 (padded to
//   16, 32, 64, 128, 192 or 256) and any T >= 1 work.
// - Shared memory past D 128: Q as float32 at padded width 256 takes 128
//   rows x 264 x 4 = 135,168 B; two stages of 32-key float32 K and V tiles
//   would take 2 x 32 x (264 + 260) x 4 = 134,144 B more, 269,312 in all,
//   past the 232,448 B a block may take. So the tiles past D 128 hold 16
//   keys: 2 x 16 x (264 + 260) x 4 = 67,072 B, 202,240 in all (bf16:
//   135,168 + 2 x 16 x (264 + 264) x 2 = 168,960; D 192 in float32:
//   102,400 + 2 x 16 x (200 + 196) x 4 = 153,088). The query tile, the
//   grid and the warps stay; S shrinks to 8 accumulators a thread, which
//   the 128 of O need.
// - Past D 256 a cluster of n = ceil(D / 256) CTAs (up to kMaxCluster =
//   8, the portable cluster size: D <= 2048), launched with
//   cudaLaunchKernelEx, takes each (batch*head, 128 query rows): CTA r
//   holds columns 256 r .. 256 r + 255 of Q, K, V and O and is the D-256
//   layout on them (`flash_fwd_tf32_kernel<T, 256, true>`). Each tile,
//   every warp computes its partial S over the CTA's columns, the hi and
//   the cross products apart, into its threads' slots; after a cluster
//   barrier each CTA reads every rank's slots through distributed shared
//   memory and sums them in rank order 0..n-1, then adds the cross
//   products (the rule below) and runs the softmax, so m and l agree
//   bitwise across the cluster; each CTA takes P V on its own columns,
//   and rank 0 writes the lse. So S is computed once per (query rows, key
//   tile), and Q is read from device memory once a CTA. The CTAs of a
//   cluster share their query rows, so all step through the same tiles
//   and cross the same cluster barriers, causal or not. Shared memory:
//   the D-256 layout and the slots, 256 threads x 16 float32 (s and sx)
//   = 16,384 B: 218,624 B in float32 (bf16, s only: 168,960 + 8,192 =
//   177,152). Two sets of slots would take 235,008 B in float32, past
//   the 232,448, so there is one: a CTA waits on the barrier's next
//   arrival (every CTA has read the slots), after the next tile's S,
//   before it stores again.
// - Past 2048 the chunked kernel (`flash_fwd_tf32_chunked_kernel`): one
//   CTA per (batch*head, 256 of O's columns, 128 query rows), S summed
//   over D in 64-column chunks of Q and K staged for every key tile, so
//   each column block computes all of S and re-reads Q from L2 a tile
//   (116,224 B of shared memory in float32).
// - S = Q K^T with d paired as (2t, 2t + 1) in both operands, so each
//   fragment is one 64-bit (float32) or 32-bit (bf16) shared load. P V
//   takes P straight from the S accumulators: the keys of a k8 step are
//   permuted so that the accumulator's columns (2t, 2t + 1) are the A
//   operand's (t, t + 4), and V's rows are read in the same order. Row
//   strides are padded so both fragment loads are free of bank conflicts.
// - Q, K, V and p are split into hi and lo where they are loaded; from D
//   = 128 on the Q fragments of a warp's 16 rows would not fit in registers as
//   hi and lo, so Q stays in shared memory as float32 and is split per
//   k8 step, once for all the tile's keys.
// - Causal: tiles wholly past the query tile's last row are not loaded,
//   tiles wholly past a warp's last row are not computed by that warp
//   (`_fwd_kernel`'s loop bound, :128-131); only tiles that cross the
//   diagonal or T are masked. l is summed in float32 from p before its
//   split.
// - As built, float32 at (8, 2048, 4, 64) runs at ~4.9x the 3xTF32 bound
//   (PERF.md); what holds it there is not measured (PERF.md §7).
//
// Non-finite rules, those of `flash_fwd_sm90.cu` (and of `_fwd_xla`):
// - the running max keeps NaN; m_safe = m where finite, else 0;
// - p = exp(s - m_safe) where s is finite, else 0;
// - corr = exp(m_old - m_safe) where the old max is finite, 0 where it is
//   -inf (nothing summed yet), 1 where it is +inf or NaN;
// - l_safe = max(l, 1e-30) keeping NaN; lse = m_fin + log(l_safe).
// A non-finite float32 input splits into hi = x and lo = NaN (inf - inf),
// so a cross product it enters is NaN, while hi_a hi_b is +-inf or NaN
// where a b is (hi_b = 0 only where b = 0). So q K^T sums the cross
// products apart and adds them only where the hi products' sum is finite,
// which it is exactly where every input of the score is: a score is +-inf
// or NaN where float32's is, and a -inf score (p = 0, the max unmoved)
// stays -inf. In P V only the hi product sees a non-finite v: both cross
// products take 0 in its place (p_lo can be 0, 0 inf = NaN, or negative,
// -inf beside the hi product's +inf). So o is +-inf where p > 0 meets an
// infinite v, and NaN where the plain version computes 0 inf: p = 0 in a
// tile the warp computes (the hi product is 0 inf), and every key past
// the tiles it computes (causal), which the plain version's dense product
// still multiplies by p = 0. A pre-pass writes the last key of each
// (batch*head, column) whose v is not finite, and of each (batch*head):
// a causal column whose last such key lies past the warp's tiles is NaN,
// and a (batch, head) with none takes P V without the masks. Past D 256
// the rule for q K^T holds on the cluster's summed partials, and each CTA
// of a cluster (each column block of the chunked kernel) applies the
// rules for v to its own columns of V and O (the table is indexed by the
// column in D).
//
// Rounding: compiled without --fmad=false (build.py), as the other
// attention kernel. expf, logf and the division by l_safe are the
// IEEE-accurate ones (no fast math).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "sm90_ptx.cuh"

namespace flash_tf32 {

struct Strides {
  int64_t b, t, h;  // element strides of a [B, T, H, D] view (d's is 1)
};

// The launchers, each compiled in a source of its own so that the build
// (one nvcc a source, all at once) compiles the instances side by side:
// head dims up to 256 in float32 (flash_fwd_tf32_f32.cu) and in bfloat16
// (flash_fwd_tf32_bf16.cu), the clusters past 256 in both
// (flash_fwd_tf32_cluster.cu), the chunked kernel past kMaxCluster x 256
// in both (flash_fwd_tf32_chunked.cu). The entry, flash_fwd_tf32.cu, picks
// one.
using Launcher = int(const void* q, const void* k, const void* v, void* o,
                     float* lse, int* last, int64_t B, int64_t T_len,
                     int64_t H, int64_t D, Strides sq, Strides sk,
                     Strides sv, float scale, int causal, int mode,
                     cudaStream_t stream);
Launcher narrow_f32, narrow_bf16, cluster_f32, cluster_bf16, chunked_f32,
    chunked_bf16;
// A cluster launch's plan at head dim D (256 < D <= kMaxCluster x 256):
// out = {CTAs a cluster, dynamic shared memory of a CTA in bytes,
// cudaOccupancyMaxActiveClusters}; returns a CUDA error (0 on success)
int cluster_info_f32(int64_t D, int* out);
int cluster_info_bf16(int64_t D, int* out);

// The largest cluster that every Hopper part schedules (the portable
// size): the cluster kernel takes head dims up to kMaxCluster x 256
constexpr int kMaxCluster = 8;

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kBQ = 16 * kWarps;  // query rows per CTA

// Shared memory of one CTA at padded head dim DP: Q as float32, then two
// stages of a K and a V tile of kBK keys in the input type. Row strides
// (elements) keep the fragment loads conflict-free: Q and K are read as
// (2t, 2t + 1) pairs of rows g (stride = 8 words mod 32), V as single
// values of rows 2t and 2t + 1 (stride = 4 words mod 32 in float32, 8
// halves in bf16). Past DP 128 the tiles hold 16 keys (the header's
// arithmetic).
template <typename T, int DP>
struct Layout {
  static constexpr int kBK = DP > 128 ? 16 : 32;  // keys per K/V tile
  static constexpr int kSN = kBK / 2;             // S accumulators a thread
  static constexpr int kQS = DP + 8;
  static constexpr int kKS = DP + 8;
  static constexpr int kVS = sizeof(T) == 4 ? DP + 4 : DP + 8;
  static constexpr int kQBytes = kBQ * kQS * 4;
  static constexpr int kKBytes = kBK * kKS * static_cast<int>(sizeof(T));
  static constexpr int kVBytes = kBK * kVS * static_cast<int>(sizeof(T));
  static constexpr int kStage = kKBytes + kVBytes;
  static constexpr int kBytes = kQBytes + 2 * kStage;
  static_assert(kBytes <= 232448, "the shared memory a block may take");
};

// The cluster kernel's CTA (past D 256, the header's arithmetic): the
// layout at DP 256, then the exchange of S's partials, each thread's
// kVecs float4 slots (its s and, in float32, its cross products sx)
template <typename T>
struct Cluster {
  using L = Layout<T, 256>;
  static constexpr int kVecs = (sizeof(T) == 4 ? 2 : 1) * L::kSN / 4;
  static constexpr int kXBytes = kVecs * kThreads * 16;
  static constexpr int kBytes = L::kBytes + kXBytes;
  static_assert(L::kBytes % 16 == 0, "the slots' float4 alignment");
  static_assert(kBytes <= 232448, "the shared memory a block may take");
};

// Shared memory of one CTA of the chunked kernel (past kMaxCluster x 256;
// the header's arithmetic): two stages of a kDC-column chunk of Q (kBQ
// rows) and of the K tile, then two stages of the V tile's kDV columns of
// the CTA's block. The chunks' row stride kCS keeps the (2t, 2t + 1)
// fragment loads conflict-free, as kQS and kKS do; V is read as at D 256.
template <typename T>
struct Chunked {
  static constexpr int kDV = 256;  // O columns of a CTA
  static constexpr int kDC = 64;   // columns of a chunk of S's sum over D
  static constexpr int kBK = Layout<T, kDV>::kBK;  // 16 keys a tile
  static constexpr int kSN = kBK / 2;
  static constexpr int kCS = kDC + 8;
  static constexpr int kVS = Layout<T, kDV>::kVS;
  static constexpr int kQBytes = kBQ * kCS * static_cast<int>(sizeof(T));
  static constexpr int kKBytes = kBK * kCS * static_cast<int>(sizeof(T));
  static constexpr int kChunk = kQBytes + kKBytes;
  static constexpr int kVBytes = kBK * kVS * static_cast<int>(sizeof(T));
  static constexpr int kBytes = 2 * kChunk + 2 * kVBytes;
  static_assert(kBytes <= 232448, "the shared memory a block may take");
};

__device__ __forceinline__ bool is_finite(float x) {
  return fabsf(x) < INFINITY;  // false for NaN and +-inf
}

__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// c ? a : b without a branch (a ?: around expf became a branch per score
// in the wgmma kernel)
__device__ __forceinline__ float select(bool c, float a, float b) {
  float d;
  asm("{\n .reg .pred p;\n setp.ne.u32 p, %1, 0;\n"
      " selp.f32 %0, %2, %3, p;\n}"
      : "=f"(d)
      : "r"(static_cast<uint32_t>(c)), "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo (OpMultiplyAddFastF32's split): hi = tf32(x) rounded to
// nearest; lo = x - hi is left in float32, and the tensor cores read its
// top 19 bits (TF32 truncated): that moves a b by ~2^-22 of it and saves
// a conversion per operand
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d[16 x 8] += A[16 x 8] B[8 x 8], TF32 in, float32 accumulators. Lane
// (g, t) holds a = {A[g][t], A[g + 8][t], A[g][t + 4], A[g + 8][t + 4]},
// b = {B[t][g], B[t + 4][g]}, d = {D[g][2t], D[g][2t + 1], D[g + 8][2t],
// D[g + 8][2t + 1]}.
__device__ __forceinline__ void mma(float* d, const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// `bytes` from global to shared memory, or zeros where `ok` is false
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool ok) {
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(ok ? 16 : 0)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(ok ? 4 : 0)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// kBK rows r0.. of one [T, D] slice (row stride `st`, d stride 1) into a
// tile of row stride kS, as 16-byte, 4-byte or single-element pieces
// (mode 2, 1, 0). The CTA's threads take the tile's pieces in turn over
// the padded width DP, so the loop bounds are constants and every lane
// has work; pieces at columns >= D are skipped, rows past T become zeros.
template <typename T, int DP, int kS>
__device__ __forceinline__ void load_rows(T* dst, const T* src, int64_t st,
                                          int r0, int T_len, int D,
                                          int mode) {
  constexpr int kBK = Layout<T, DP>::kBK;
  auto piece = [&](auto bytes) {
    constexpr int E = decltype(bytes)::value / sizeof(T);  // elements
    constexpr int kC = DP / E;                              // a row's
#pragma unroll 4
    for (int idx = threadIdx.x; idx < kBK * kC; idx += kThreads) {
      const int r = idx / kC, c = (idx % kC) * E;
      if (c >= D) continue;
      const bool ok = r0 + r < T_len;
      const T* from = src + static_cast<int64_t>(ok ? r0 + r : 0) * st + c;
      if constexpr (E * sizeof(T) == 16 || E * sizeof(T) == 4) {
        cp_async<E * sizeof(T)>(dst + r * kS + c, from, ok);
      } else {
        dst[r * kS + c] = ok ? *from : from_float<T>(0.f);
      }
    }
  };
  if (mode == 2) {
    piece(std::integral_constant<int, 16>());
  } else if (mode == 1) {
    piece(std::integral_constant<int, 4>());
  } else {
    piece(std::integral_constant<int, sizeof(T)>());
  }
}

// R rows r0.. and W columns c0.. of one [T, D] slice into a tile of row
// stride kS, pieces as in load_rows; rows past T and columns >= D become
// zeros (the chunked kernel's chunks and column blocks reuse their
// buffers).
// load_rows stays for the narrow kernel: through this loader its float32
// D-256 instance ran 1.8% slower on an NVIDIA H100 80GB HBM3 at 700 W
// (PERF.md section 6).
template <typename T, int R, int W, int kS>
__device__ __forceinline__ void load_block(T* dst, const T* src, int64_t st,
                                           int r0, int c0, int T_len, int D,
                                           int mode) {
  auto piece = [&](auto bytes) {
    constexpr int E = decltype(bytes)::value / sizeof(T);  // elements
    constexpr int kC = W / E;                               // a row's
#pragma unroll 4
    for (int idx = threadIdx.x; idx < R * kC; idx += kThreads) {
      const int r = idx / kC, c = (idx % kC) * E;
      const bool ok = r0 + r < T_len && c0 + c < D;
      const T* from =
          ok ? src + static_cast<int64_t>(r0 + r) * st + c0 + c : src;
      if constexpr (E * sizeof(T) == 16 || E * sizeof(T) == 4) {
        cp_async<E * sizeof(T)>(dst + r * kS + c, from, ok);
      } else {
        dst[r * kS + c] = ok ? *from : from_float<T>(0.f);
      }
    }
  };
  if (mode == 2) {
    piece(std::integral_constant<int, 16>());
  } else if (mode == 1) {
    piece(std::integral_constant<int, 4>());
  } else {
    piece(std::integral_constant<int, sizeof(T)>());
  }
}

// The online-softmax update of one tile, in place: s holds a thread's raw
// products of rows row0 and row0 + 8 (s[4 j + 2 r + e] is row row0 + 8 r,
// key k0 + 8 j + 2 t + e) and leaves with their p; m and l move, and
// corr[r] is the factor the accumulators of row r take.
template <int kBK>
__device__ __forceinline__ void softmax(float (&s)[kBK / 2], float (&m)[2],
                                       float (&l)[2], float (&corr)[2],
                                       int k0, int row0, int w_first,
                                       int T_len, float scale, int causal) {
  const int t = threadIdx.x % 4;
  const bool edge = (causal && k0 + kBK - 1 > w_first) || k0 + kBK > T_len;
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = i / 2, idx = 4 * j + i;
      float x = s[idx] * scale;
      if (edge) {
        const int key = k0 + 8 * j + 2 * t + i % 2;
        if (key >= T_len || (causal && key > row0 + 8 * r)) x = -INFINITY;
      }
      s[idx] = x;
      mx[r] = max_nan(mx[r], x);
    }
  }
#pragma unroll
  for (int off = 1; off < 4; off *= 2) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = max_nan(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], off));
    }
  }
  float m_safe[2], ps[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_new = max_nan(m[r], mx[r]);
    m_safe[r] = is_finite(m_new) ? m_new : 0.f;
    corr[r] = is_finite(m[r]) ? expf(m[r] - m_safe[r])
                              : (m[r] == -INFINITY ? 0.f : 1.f);
    m[r] = m_new;
  }
#pragma unroll
  for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = i / 2, idx = 4 * j + i;
      const float p = select(is_finite(s[idx]), expf(s[idx] - m_safe[r]),
                             0.f);
      s[idx] = p;
      ps[r] += p;
    }
  }
#pragma unroll
  for (int off = 1; off < 4; off *= 2) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      ps[r] += __shfl_xor_sync(0xffffffffu, ps[r], off);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + ps[r];
}

// S += Q K^T over kSteps k8 steps for a warp's 16 rows, each over the
// tile's kBK / 8 key groups: the hi products into s, in float32 the cross
// products into sx. Q (q_row: the warp's row g, column 2t; row stride kQS)
// is float32 in shared memory (the narrow kernel), or a chunk in the input
// type (the chunked kernel), whose bf16 pair (d, d + 1) is one 32-bit
// load, widened exactly; bf16 K is exact in TF32.
template <typename T, typename TQ, int kBK, int kSteps, int kQS, int kKS>
__device__ __forceinline__ void qk_steps(float (&s)[kBK / 2],
                                         float (&sx)[kBK / 2],
                                         const TQ* q_row, const T* ks) {
  constexpr bool kF32 = sizeof(T) == 4;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) {
    uint32_t ah[4], al[4];
    if constexpr (sizeof(TQ) == 4) {
      const float2 x0 = *reinterpret_cast<const float2*>(q_row + 8 * kk);
      const float2 x1 =
          *reinterpret_cast<const float2*>(q_row + 8 * kQS + 8 * kk);
      if constexpr (kF32) {
        split(x0.x, ah[0], al[0]);
        split(x1.x, ah[1], al[1]);
        split(x0.y, ah[2], al[2]);
        split(x1.y, ah[3], al[3]);
      } else {  // bf16 widened: exact in TF32
        ah[0] = __float_as_uint(x0.x);
        ah[1] = __float_as_uint(x1.x);
        ah[2] = __float_as_uint(x0.y);
        ah[3] = __float_as_uint(x1.y);
      }
    } else {
      const uint32_t u0 = *reinterpret_cast<const uint32_t*>(q_row + 8 * kk);
      const uint32_t u1 =
          *reinterpret_cast<const uint32_t*>(q_row + 8 * kQS + 8 * kk);
      ah[0] = u0 << 16;
      ah[1] = u1 << 16;
      ah[2] = u0 & 0xffff0000u;
      ah[3] = u1 & 0xffff0000u;
    }
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      const T* kp = ks + (8 * j + g) * kKS + 8 * kk + 2 * t;
      if constexpr (kF32) {
        const float2 y = *reinterpret_cast<const float2*>(kp);
        uint32_t bh0, bl0, bh1, bl1;
        split(y.x, bh0, bl0);
        split(y.y, bh1, bl1);
        mma(sx + 4 * j, al, bh0, bh1);
        mma(sx + 4 * j, ah, bl0, bl1);
        mma(s + 4 * j, ah, bh0, bh1);
      } else {
        // the pair (d, d + 1): d in the low half; a bf16's bits are the
        // high half of its float32
        const uint32_t u = *reinterpret_cast<const uint32_t*>(kp);
        mma(s + 4 * j, ah, u << 16, u & 0xffff0000u);
      }
    }
  }
}

// In float32, the cross products added to S where the hi products' sum is
// finite (the header's non-finite rules)
template <typename T, int kSN>
__device__ __forceinline__ void add_cross(float (&s)[kSN],
                                          const float (&sx)[kSN]) {
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < kSN; ++i) {
      s[i] = select(is_finite(s[i]), s[i] + sx[i], s[i]);
    }
  }
}

// S = Q K^T of one tile for a warp's 16 rows in the narrow and cluster
// kernels, before add_cross: DP / 8 k8 steps over the resident float32 Q
template <typename T, int DP>
__device__ __forceinline__ void qk(float (&s)[Layout<T, DP>::kSN],
                                   float (&sx)[Layout<T, DP>::kSN],
                                   const float* q_row, const T* ks) {
  using L = Layout<T, DP>;
#pragma unroll
  for (int i = 0; i < L::kSN; ++i) s[i] = sx[i] = 0.f;
  qk_steps<T, float, L::kBK, DP / 8, L::kQS, L::kKS>(s, sx, q_row, ks);
}

// S of a tile summed over the cluster (the header's design): the thread's
// partials over its CTA's columns go to its slots; once every CTA's are
// there (the cluster barrier), each CTA reads every rank's slots through
// distributed shared memory and sums them in rank order 0..n-1, so all
// hold the same S, and so the same m and l, bitwise. The barrier's next
// arrival marks this CTA's reads done: each CTA waits on it before it
// stores the next tile's partials (and before it exits), so no slot is
// overwritten while a peer reads it. Every thread takes every barrier,
// its warp scoring the tile (`mine`) or not.
template <typename T, int kSN>
__device__ __forceinline__ void cluster_sum(float (&s)[kSN],
                                            float (&sx)[kSN], float4* xs,
                                            int i, int n, bool mine) {
  constexpr int kV = kSN / 4;  // a thread's float4 slots of s (and of sx)
  constexpr bool kF32 = sizeof(T) == 4;
  float4* slot = xs + threadIdx.x;
  if (i > 0) sm90::cluster_wait();
  if (mine) {
#pragma unroll
    for (int j = 0; j < kV; ++j) {
      slot[j * kThreads] =
          make_float4(s[4 * j], s[4 * j + 1], s[4 * j + 2], s[4 * j + 3]);
      if constexpr (kF32) {
        slot[(kV + j) * kThreads] = make_float4(sx[4 * j], sx[4 * j + 1],
                                                sx[4 * j + 2], sx[4 * j + 3]);
      }
    }
  }
  sm90::cluster_arrive();
  sm90::cluster_wait();
  if (mine) {
    const uint32_t own = sm90::smem_addr(slot);
    auto take = [&](int r, bool add) {
      const uint32_t at = sm90::mapa(own, static_cast<uint32_t>(r));
#pragma unroll
      for (int j = 0; j < kV; ++j) {
        const float4 x = sm90::ld_cluster_f4(at + j * kThreads * 16);
        const float xv[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[4 * j + e] = add ? s[4 * j + e] + xv[e] : xv[e];
        }
        if constexpr (kF32) {
          const float4 y =
              sm90::ld_cluster_f4(at + (kV + j) * kThreads * 16);
          const float yv[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            sx[4 * j + e] = add ? sx[4 * j + e] + yv[e] : yv[e];
          }
        }
      }
    };
    take(0, false);
    for (int r = 1; r < n; ++r) take(r, true);
  }
  sm90::cluster_arrive();
}

__device__ __forceinline__ uint32_t widen(__nv_bfloat16 x) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(x)) << 16;
}

// all ones where the float32 bits are finite, else 0: a v element's mask
// for the cross products
__device__ __forceinline__ uint32_t finite_mask(uint32_t bits) {
  return (bits & 0x7f800000u) == 0x7f800000u ? 0u : 0xffffffffu;
}

// O = corr O + P V for a warp's 16 rows. The k8 step j takes the keys 8 j
// + 2t (A column t: the accumulator column 2t) and 8 j + 2t + 1 (column
// t + 4: the accumulator column 2t + 1); V's rows are read in that order.
template <typename T, int DP, bool kMask>
__device__ __forceinline__ void pv(float (&acc)[DP / 2],
                                   const float (&s)[Layout<T, DP>::kSN],
                                   const float (&corr)[2], const T* vs) {
  using L = Layout<T, DP>;
  constexpr int kBK = L::kBK;
  constexpr bool kF32 = sizeof(T) == 4;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      acc[4 * n + 2 * r] *= corr[r];
      acc[4 * n + 2 * r + 1] *= corr[r];
    }
  }
#pragma unroll
  for (int j = 0; j < kBK / 8; ++j) {
    uint32_t ph[4], pl[4];
    split(s[4 * j], ph[0], pl[0]);
    split(s[4 * j + 2], ph[1], pl[1]);
    split(s[4 * j + 1], ph[2], pl[2]);
    split(s[4 * j + 3], ph[3], pl[3]);
    const T* vp = vs + (8 * j + 2 * t) * L::kVS + g;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      // kMask: a non-finite v enters the hi product only (the header's
      // rules); without it every v of the (batch, head) is finite
      if constexpr (kF32) {
        const float v0 = to_float(vp[8 * n]);
        const float v1 = to_float(vp[L::kVS + 8 * n]);
        uint32_t bh0, bl0, bh1, bl1;
        split(v0, bh0, bl0);
        split(v1, bh1, bl1);
        if constexpr (kMask) {
          const uint32_t f0 = finite_mask(__float_as_uint(v0));
          const uint32_t f1 = finite_mask(__float_as_uint(v1));
          mma(acc + 4 * n, pl, bh0 & f0, bh1 & f1);
          mma(acc + 4 * n, ph, bl0 & f0, bl1 & f1);
        } else {
          mma(acc + 4 * n, pl, bh0, bh1);
          mma(acc + 4 * n, ph, bl0, bl1);
        }
        mma(acc + 4 * n, ph, bh0, bh1);
      } else {
        const uint32_t b0 = widen(vp[8 * n]), b1 = widen(vp[L::kVS + 8 * n]);
        if constexpr (kMask) {
          mma(acc + 4 * n, pl, b0 & finite_mask(b0), b1 & finite_mask(b1));
        } else {
          mma(acc + 4 * n, pl, b0, b1);
        }
        mma(acc + 4 * n, ph, b0, b1);
      }
    }
  }
}

// kCluster: past D 256, one CTA of a cluster of n = ceil(D / 256) (the
// header's design), with DP 256 and the exchange after Layout's bytes
template <typename T, int DP, bool kCluster = false>
__global__ void __launch_bounds__(kThreads, DP >= 128 ? 1 : 2)
flash_fwd_tf32_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ o,
                      float* __restrict__ lse,
                      const int* __restrict__ last, Strides sq, Strides sk,
                      Strides sv, int H, int T_len, int D, float scale,
                      int causal, int mode) {
  using L = Layout<T, DP>;
  constexpr int kBK = L::kBK;
  extern __shared__ __align__(16) uint8_t smem[];
  float* qs = reinterpret_cast<float*>(smem);
  T* ks[2];
  T* vs[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    ks[i] = reinterpret_cast<T*>(smem + L::kQBytes + i * L::kStage);
    vs[i] = reinterpret_cast<T*>(smem + L::kQBytes + i * L::kStage +
                                 L::kKBytes);
  }

  // the cluster's CTA `rank` of n holds columns c0.. c0 + Dc - 1 of Q, K,
  // V and O (the whole head dim without a cluster)
  const int n = kCluster ? static_cast<int>(sm90::cluster_size()) : 1;
  const int rank = kCluster ? static_cast<int>(sm90::cluster_rank()) : 0;
  const int bh = blockIdx.x / n;
  const int c0 = rank * DP;
  const int Dc = min(D - c0, DP);
  const int b = bh / H, h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // longest tiles first
  // causal: no key past the tile's last row (the same count in every CTA
  // of a cluster: they share the query rows)
  const int k_end = causal ? min(q0 + kBQ, T_len) : T_len;
  const int n_tiles = (k_end + kBK - 1) / kBK;
  const T* qb = q + b * sq.b + h * sq.h + c0;
  const T* kb = k + b * sk.b + h * sk.h + c0;
  const T* vb = v + b * sv.b + h * sv.h + c0;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;

  auto load_tile = [&](int i) {
    load_rows<T, DP, L::kKS>(ks[i & 1], kb, sk.t, i * kBK, T_len, Dc, mode);
    load_rows<T, DP, L::kVS>(vs[i & 1], vb, sv.t, i * kBK, T_len, Dc, mode);
    cp_async_commit();
  };
  load_tile(0);

  // Q as float32, zero past the CTA's columns and T; K and V columns past
  // them zero in both stages (the copies never write them)
  for (int r = warp; r < kBQ; r += kWarps) {
    const bool ok = q0 + r < T_len;
    const T* row = qb + static_cast<int64_t>(ok ? q0 + r : 0) * sq.t;
    for (int c = lane; c < DP; c += 32) {
      qs[r * L::kQS + c] = ok && c < Dc ? to_float(row[c]) : 0.f;
    }
  }
  for (int r = warp; r < 2 * kBK; r += kWarps) {
    for (int c = Dc + lane; c < DP; c += 32) {
      ks[r / kBK][(r % kBK) * L::kKS + c] = from_float<T>(0.f);
      vs[r / kBK][(r % kBK) * L::kVS + c] = from_float<T>(0.f);
    }
  }

  // this warp's rows w_first + g and w_first + g + 8; tiles past its last
  // row (causal) or rows wholly past T are not computed
  const int w_first = q0 + 16 * warp;
  const int row0 = w_first + g;
  const int w_end = w_first >= T_len ? 0
                    : causal         ? min(w_first + 16, T_len)
                                     : T_len;
  const float* q_row = qs + (16 * warp + g) * L::kQS + 2 * t;

  // the pre-pass's verdict on this (batch, head): a non-finite v
  // anywhere (the flags follow the B*H*D table)
  const bool dirty =
      last[static_cast<int64_t>(gridDim.x / n) * D + bh] >= 0;

  float acc[DP / 2], s[L::kSN], sx[L::kSN];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, corr[2];

  for (int i = 0; i < n_tiles; ++i) {
    if (i + 1 < n_tiles) {
      load_tile(i + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile i (and Q, the zeroed columns) visible
    const int k0 = i * kBK;
    const bool mine = k0 < w_end;  // this warp scores tile i
    if (mine) qk<T, DP>(s, sx, q_row, ks[i & 1]);
    if constexpr (kCluster) {
      cluster_sum<T>(s, sx, reinterpret_cast<float4*>(smem + L::kBytes), i,
                     n, mine);
    }
    if (mine) {
      add_cross<T>(s, sx);
      softmax<kBK>(s, m, l, corr, k0, row0, w_first, T_len, scale, causal);
      if (dirty) {
        pv<T, DP, true>(acc, s, corr, vs[i & 1]);
      } else {
        pv<T, DP, false>(acc, s, corr, vs[i & 1]);
      }
    }
    __syncthreads();  // every warp is done with the stage tile i + 2 takes
  }
  // no CTA leaves while a peer may still read its slots
  if constexpr (kCluster) sm90::cluster_wait();

  // causal: the keys from kc on lie past every row of the warp and were
  // not computed; a non-finite v among them makes the column NaN
  const int kc = (w_end + kBK - 1) / kBK * kBK;
  const int* last_bh = causal && dirty && kc < T_len
                           ? last + static_cast<int64_t>(bh) * D + c0
                           : nullptr;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= T_len) continue;
    const float l_safe = l[r] != l[r] ? l[r] : fmaxf(l[r], 1e-30f);
    T* orow =
        o + ((static_cast<int64_t>(b) * T_len + row) * H + h) * D + c0;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + 2 * t + e;
        if (c >= Dc) continue;
        float x = acc[4 * j + 2 * r + e] / l_safe;
        if (last_bh != nullptr && last_bh[c] >= kc) x = NAN;
        orow[c] = from_float<T>(x);
      }
    }
    if (t == 0 && rank == 0) {  // one writer a row
      lse[static_cast<int64_t>(bh) * T_len + row] =
          (is_finite(m[r]) ? m[r] : 0.f) + logf(l_safe);
    }
  }
}

// Past kMaxCluster x 256: one CTA per (batch*head, column block of kDV,
// 128 query rows); the header's design. Warps, rows, causal skips,
// softmax, P V and the non-finite rules are the narrow kernel's; S is
// summed over D in kDC-column chunks, one (key tile, chunk) step at a
// time.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_tf32_chunked_kernel(const T* __restrict__ q,
                              const T* __restrict__ k,
                              const T* __restrict__ v, T* __restrict__ o,
                              float* __restrict__ lse,
                              const int* __restrict__ last, Strides sq,
                              Strides sk, Strides sv, int H, int T_len,
                              int D, float scale, int causal, int mode) {
  using W = Chunked<T>;
  constexpr int kBK = W::kBK;
  extern __shared__ __align__(16) uint8_t smem[];
  T* vs[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    vs[i] = reinterpret_cast<T*>(smem + 2 * W::kChunk + i * W::kVBytes);
  }

  const int n_cb = (D + W::kDV - 1) / W::kDV;  // column blocks
  const int bh = blockIdx.x / n_cb, cb = blockIdx.x % n_cb;
  const int c_v = cb * W::kDV;  // this CTA's first column of V and O
  const int b = bh / H, h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // longest tiles first
  const int k_end = causal ? min(q0 + kBQ, T_len) : T_len;
  const int n_tiles = (k_end + kBK - 1) / kBK;
  const int n_chunks = (D + W::kDC - 1) / W::kDC;
  const int n_steps = n_tiles * n_chunks;
  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;

  // step n: chunk n % n_chunks of Q and of key tile n / n_chunks, and with
  // a tile's first chunk the tile's V columns c_v..
  auto load_step = [&](int n) {
    const int i = n / n_chunks, c0 = (n % n_chunks) * W::kDC;
    T* qs = reinterpret_cast<T*>(smem + (n & 1) * W::kChunk);
    load_block<T, kBQ, W::kDC, W::kCS>(qs, qb, sq.t, q0, c0, T_len, D,
                                        mode);
    load_block<T, kBK, W::kDC, W::kCS>(
        reinterpret_cast<T*>(smem + (n & 1) * W::kChunk + W::kQBytes), kb,
        sk.t, i * kBK, c0, T_len, D, mode);
    if (c0 == 0) {
      load_block<T, kBK, W::kDV, W::kVS>(vs[i & 1], vb, sv.t, i * kBK, c_v,
                                          T_len, D, mode);
    }
    cp_async_commit();
  };
  load_step(0);

  const int w_first = q0 + 16 * warp;
  const int row0 = w_first + g;
  const int w_end = w_first >= T_len ? 0
                    : causal         ? min(w_first + 16, T_len)
                                     : T_len;
  const int q_off = (16 * warp + g) * W::kCS + 2 * t;
  const bool dirty =
      last[static_cast<int64_t>(gridDim.x / n_cb) * D + bh] >= 0;

  float acc[W::kDV / 2], s[W::kSN], sx[W::kSN];
#pragma unroll
  for (int i = 0; i < W::kDV / 2; ++i) acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, corr[2];

  for (int n = 0; n < n_steps; ++n) {
    if (n + 1 < n_steps) {
      load_step(n + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // step n's chunks (and, from its first, V) visible
    const int i = n / n_chunks, c = n % n_chunks;
    const int k0 = i * kBK;
    if (k0 < w_end) {
      if (c == 0) {
#pragma unroll
        for (int j = 0; j < W::kSN; ++j) s[j] = sx[j] = 0.f;
      }
      const T* qs = reinterpret_cast<const T*>(smem + (n & 1) * W::kChunk);
      qk_steps<T, T, kBK, W::kDC / 8, W::kCS, W::kCS>(
          s, sx, qs + q_off,
          reinterpret_cast<const T*>(smem + (n & 1) * W::kChunk +
                                     W::kQBytes));
      if (c == n_chunks - 1) {
        add_cross<T>(s, sx);
        softmax<kBK>(s, m, l, corr, k0, row0, w_first, T_len, scale, causal);
        if (dirty) {
          pv<T, W::kDV, true>(acc, s, corr, vs[i & 1]);
        } else {
          pv<T, W::kDV, false>(acc, s, corr, vs[i & 1]);
        }
      }
    }
    __syncthreads();  // every warp is done with the stages step n + 2 takes
  }

  const int kc = (w_end + kBK - 1) / kBK * kBK;
  const int* last_bh = causal && dirty && kc < T_len
                           ? last + static_cast<int64_t>(bh) * D
                           : nullptr;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= T_len) continue;
    const float l_safe = l[r] != l[r] ? l[r] : fmaxf(l[r], 1e-30f);
    T* orow = o + ((static_cast<int64_t>(b) * T_len + row) * H + h) * D;
#pragma unroll
    for (int n = 0; n < W::kDV / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = c_v + 8 * n + 2 * t + e;
        if (c >= D) continue;
        float x = acc[4 * n + 2 * r + e] / l_safe;
        if (last_bh != nullptr && last_bh[c] >= kc) x = NAN;
        orow[c] = from_float<T>(x);
      }
    }
    if (t == 0 && cb == 0) {
      lse[static_cast<int64_t>(bh) * T_len + row] =
          (is_finite(m[r]) ? m[r] : 0.f) + logf(l_safe);
    }
  }
}

// The pre-pass: last[bh * D + c] = the last key whose v[b, key, h, c] is
// not finite, and last[B * H * D + bh] = the last such key of any column
// (both -1 where there is none; the caller sets -1). One block per
// (batch*head, kLastRows keys); its 128 threads take the columns in turn
// (two each past D 128, four at D 512); non-finite values are rare, so the
// atomics are too.
constexpr int kLastRows = 64;
constexpr int kLastThreads = 128;

template <typename T>
__global__ void __launch_bounds__(kLastThreads)
v_last_nonfinite_kernel(const T* __restrict__ v, Strides sv, int H,
                        int T_len, int D, int* __restrict__ last) {
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int r0 = blockIdx.y * kLastRows;
  const int r1 = min(r0 + kLastRows, T_len);
  for (int c = threadIdx.x; c < D; c += kLastThreads) {
    const T* col = v + b * sv.b + h * sv.h + c;
    int found = -1;
    for (int r = r0; r < r1; ++r) {
      if (!is_finite(to_float(col[static_cast<int64_t>(r) * sv.t]))) {
        found = r;
      }
    }
    if (found >= 0) {
      atomicMax(last + static_cast<int64_t>(bh) * D + c, found);
      atomicMax(last + static_cast<int64_t>(gridDim.x) * D + bh, found);
    }
  }
}

// the memset of `last` and the pre-pass, before either kernel
template <typename T>
int prepass(const void* v, int* last, int64_t B, int64_t T_len, int64_t H,
            int64_t D, Strides sv, cudaStream_t stream) {
  cudaError_t e = cudaMemsetAsync(
      last, 0xff, static_cast<size_t>(B * H * (D + 1)) * sizeof(int),
      stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 pre(static_cast<unsigned int>(B * H),
                 static_cast<unsigned int>((T_len + kLastRows - 1) /
                                           kLastRows));
  v_last_nonfinite_kernel<T><<<pre, kLastThreads, 0, stream>>>(
      static_cast<const T*>(v), sv, static_cast<int>(H),
      static_cast<int>(T_len), static_cast<int>(D), last);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DP>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int* last, int64_t B, int64_t T_len, int64_t H, int64_t D,
           Strides sq, Strides sk, Strides sv, float scale, int causal,
           int mode, cudaStream_t stream) {
  constexpr int bytes = Layout<T, DP>::kBytes;
  const int pre = prepass<T>(v, last, B, T_len, H, D, sv, stream);
  if (pre != 0) return pre;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tf32_kernel<T, DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned int>(B * H),
                  static_cast<unsigned int>((T_len + kBQ - 1) / kBQ));
  flash_fwd_tf32_kernel<T, DP><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, last, sq, sk, sv,
      static_cast<int>(H), static_cast<int>(T_len), static_cast<int>(D),
      scale, causal, mode);
  return static_cast<int>(cudaGetLastError());
}

// past kMaxCluster x 256: the column blocks of each (batch*head) side by
// side on x
template <typename T>
int launch_chunked(const void* q, const void* k, const void* v, void* o,
                   float* lse, int* last, int64_t B, int64_t T_len,
                   int64_t H, int64_t D, Strides sq, Strides sk, Strides sv,
                   float scale, int causal, int mode, cudaStream_t stream) {
  constexpr int bytes = Chunked<T>::kBytes;
  const int pre = prepass<T>(v, last, B, T_len, H, D, sv, stream);
  if (pre != 0) return pre;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tf32_chunked_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n_cb = (D + Chunked<T>::kDV - 1) / Chunked<T>::kDV;
  const dim3 grid(static_cast<unsigned int>(B * H * n_cb),
                  static_cast<unsigned int>((T_len + kBQ - 1) / kBQ));
  flash_fwd_tf32_chunked_kernel<T><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, last, sq, sk, sv,
      static_cast<int>(H), static_cast<int>(T_len), static_cast<int>(D),
      scale, causal, mode);
  return static_cast<int>(cudaGetLastError());
}

// The cluster launch past D 256 (up to kMaxCluster x 256): the cluster's
// n CTAs of each (batch*head, 128 query rows) side by side on x; `cfg`
// points at `attr`. A cluster that cannot be placed (shared memory,
// occupancy) makes the launch fail, and the error is returned.
template <typename T>
cudaError_t cluster_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr,
                           int64_t BH, int64_t T_len, int64_t D,
                           cudaStream_t stream) {
  const unsigned int n = static_cast<unsigned int>((D + 255) / 256);
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(static_cast<unsigned int>(BH) * n,
                     static_cast<unsigned int>((T_len + kBQ - 1) / kBQ));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = Cluster<T>::kBytes;
  cfg.stream = stream;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = n;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaFuncSetAttribute(flash_fwd_tf32_kernel<T, 256, true>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              Cluster<T>::kBytes);
}

template <typename T>
int launch_cluster(const void* q, const void* k, const void* v, void* o,
                   float* lse, int* last, int64_t B, int64_t T_len,
                   int64_t H, int64_t D, Strides sq, Strides sk, Strides sv,
                   float scale, int causal, int mode, cudaStream_t stream) {
  const int pre = prepass<T>(v, last, B, T_len, H, D, sv, stream);
  if (pre != 0) return pre;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = cluster_config<T>(cfg, attr, B * H, T_len, D, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaLaunchKernelEx(
      &cfg, flash_fwd_tf32_kernel<T, 256, true>, static_cast<const T*>(q),
      static_cast<const T*>(k), static_cast<const T*>(v), static_cast<T*>(o),
      lse, static_cast<const int*>(last), sq, sk, sv, static_cast<int>(H),
      static_cast<int>(T_len), static_cast<int>(D), scale, causal, mode);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int cluster_info(int64_t D, int* out) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = cluster_config<T>(cfg, attr, 1, 1, D, nullptr);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = static_cast<int>(attr.val.clusterDim.x);
  out[1] = Cluster<T>::kBytes;
  return static_cast<int>(cudaOccupancyMaxActiveClusters(
      out + 2, flash_fwd_tf32_kernel<T, 256, true>, &cfg));
}

// head dims 1..256: the instance of D's padded width
template <typename T>
int dispatch_narrow(const void* q, const void* k, const void* v, void* o,
                    float* lse, int* last, int64_t B, int64_t T_len,
                    int64_t H, int64_t D, Strides sq, Strides sk, Strides sv,
                    float scale, int causal, int mode, cudaStream_t st) {
  if (D <= 16) {
    return launch<T, 16>(q, k, v, o, lse, last, B, T_len, H, D, sq, sk, sv,
                         scale, causal, mode, st);
  }
  if (D <= 32) {
    return launch<T, 32>(q, k, v, o, lse, last, B, T_len, H, D, sq, sk, sv,
                         scale, causal, mode, st);
  }
  if (D <= 64) {
    return launch<T, 64>(q, k, v, o, lse, last, B, T_len, H, D, sq, sk, sv,
                         scale, causal, mode, st);
  }
  if (D <= 128) {
    return launch<T, 128>(q, k, v, o, lse, last, B, T_len, H, D, sq, sk, sv,
                          scale, causal, mode, st);
  }
  if (D <= 192) {
    return launch<T, 192>(q, k, v, o, lse, last, B, T_len, H, D, sq, sk, sv,
                          scale, causal, mode, st);
  }
  return launch<T, 256>(q, k, v, o, lse, last, B, T_len, H, D, sq, sk, sv,
                        scale, causal, mode, st);
}

}  // namespace
}  // namespace flash_tf32

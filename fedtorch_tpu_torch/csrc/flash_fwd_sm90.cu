// Exact attention forward with the online softmax on Hopper's tensor cores
// (sm_90a): bfloat16 q, k, v with head dim 64, 128, 192, 256 or 512.
//
// Replaces the TPU Pallas kernel `_fwd_kernel`
// (fedtorch_tpu/ops/pallas/flash_attention.py:82), for the inputs that
// `ops/cuda/flash_attention.py::_route` sends here; `flash_fwd_tf32.cuh`
// takes the rest (float32, other head dims, misaligned views). It computes
// what that kernel and its oracle `_fwd_xla` compute: for each (batch,
// head) and query row i, over the keys j it sees (j <= i when causal),
//
//   s_j = (q_i . k_j) * scale          in float32
//   o_i = sum_j exp(s_j - lse_i) v_j,  lse_i = log sum_j exp(s_j)
//
// with o in bfloat16 and lse in float32 [B, H, T].
//
// What bounds it: operations. At the transformer path's shape (B 8, T
// 2048, H 4, D 64, causal) the useful work is 4 B H D T(T+1)/2 = 17.2
// GFLOP: 0.01738 ms at the card's 989 TFLOP/s of dense bf16 tensor-core
// work, against 0.0101 ms for the 33.8 MB that must move. P V is issued
// twice (p split in two bf16 halves, below), so the tensor cores do 1.5x
// the useful work, 25.8 GFLOP: 0.0261 ms at peak. At D = 128 (the heads
// of a d_model-512 transformer) the products double, 34.4 GFLOP useful:
// 0.03476 ms, while the softmax's work per score stays the same. At D =
// 256 (the heads of a d_model-1024 transformer, and Gemma 7B's) it is
// 68.7 GFLOP: 0.0695 ms at peak, against 0.040 ms for the bytes; at D =
// 512 (a d_model-2048 transformer's) 137.5 GFLOP: 0.1390 ms, against
// 0.080 ms for the 268 MB.
//
// Design:
// - One CTA of 288 threads per (batch*head, 128 query rows): two consumer
//   warpgroups of 64 rows each and one producer warp (a producer
//   warpgroup, 384 threads, past D 128; at D 512 a cluster of two such
//   CTAs; below). The heaviest causal
//   query tiles are launched first (grid y runs from the last tile down).
// - The producer's lane 0 loads the CTA's Q tile once and streams the K
//   and V tiles (64 keys each) by TMA into a 4-stage shared-memory ring
//   with full and empty mbarriers. The tensor maps are 4-D (d, h, t, b)
//   over the views' byte strides, so the strided thirds of one qkv
//   projection are read in place; TMA zero-fills rows past T, and the
//   kernel scores keys >= T as -inf and never stores rows >= T. A tile
//   is kept as D / 64 column blocks ("atoms") of 128-byte rows, one TMA
//   box each: a 128-byte row is one row of the 128-byte swizzle, which
//   `wgmma` reads without bank conflicts. At D = 128, Q takes 32 KB and a
//   K or V tile 16 KB, so Q and the ring take 160 KB of the 227 KB, and
//   the two sanitized V tiles of the non-finite rules (below) 32 KB more.
// - Past D 128 the K and V tiles hold 32 keys (`Cfg::kBK`). With 64, D
//   256 would need Q 64 KB + a 4-stage ring of 32 KB K and V tiles (256
//   KB) + two sanitized tiles (64 KB): 385 KB. With 32 the ring takes 128
//   KB and the sanitized tiles 32 KB: 64 + 128 + 32 + 1 (alignment) = 225
//   KB, 230,400 B of the 232,448 a block may take (D 192: 169 KB). The
//   halved tile also halves S and P in registers: at D 256 a consumer
//   thread holds O of m64n256 (128 float32), S of m64n32 (16) and the two
//   P halves (16). ptxas gives every thread of a 288-thread CTA 168
//   registers (it counts whole warpgroups: 65,536 / 384); there the D-256
//   instance spilled 1,772 bytes and ptxas serialized its `wgmma`s (1.93
//   ms a launch at (8, 2048, 4, 256), PERF.md). So past D 128 the
//   producer is a whole warpgroup that keeps 24 registers a thread
//   (`setmaxnreg`) and the consumers take 240: no spill.
//   S is `wgmma m64n32k16`; P V one `m64n128k16` per pair of V's atoms
//   (and an `m64n64k16` for D 192's third), each on its own 64 columns
//   of the accumulators, the descriptor stepping two atoms at a time.
// - At D 512 a warpgroup cannot hold O for 64 rows (256 float32 a
//   thread), so a cluster of two CTAs (`Cfg::kCluster`, launched with
//   cudaLaunchKernelEx) splits the head dim: CTA r holds columns 256 r ..
//   256 r + 255 of Q, K, V and O (`Cfg::kDC`), its TMA boxes offset by
//   256 r, and is the D-256 layout on them: 128 query rows, two consumer
//   warpgroups of 64, a producer warpgroup, 32-key tiles. A warpgroup's S
//   over its CTA's columns is a partial (16 k-steps of `m64n32k16`); it
//   pushes the partial (64 x 32 float32, 8 KB) by `st.async` into the
//   warpgroup of the same rows in the other CTA, takes that one's from
//   its own shared memory, and both sum the two in rank order, so their
//   m and l agree bitwise; rank 0 writes the lse. The handshake is per
//   warpgroup pair (`exchange`): the two warpgroups of a CTA score
//   different numbers of causal tiles, so a CTA- or cluster-wide barrier
//   per tile would deadlock. S is computed once per (query rows, key
//   tile): the tensor cores issue 1.5x the useful work, as at D 256, and
//   K and V are read once per 128 query rows. Shared
//   memory: Q 64 KB; a 3-stage ring (`Cfg::kStages`) of 32-key K and V
//   tiles, 96 KB; the two sanitized V tiles, 32 KB; two 8 KB buffers of
//   the peer's partials for each warpgroup, 32 KB; 1 KB of alignment:
//   225 KB, 230,400 B, as at D 256 (a 4-stage ring beside the buffers
//   would take 257 KB). Registers as at D 256 (setmaxnreg 24/240: O 128,
//   S 16, P 16). The partials' trip between the SMs stays on each tile's
//   path, about a quarter of the launch (PERF.md); running S two tiles
//   ahead of P V to hide it needs a second S array, which spilled.
// - S = Q K^T: kDC / 16 `wgmma m64n64k16` from shared memory into float32
//   accumulators, the descriptors stepping 32 bytes along an atom's rows
//   and then to the next atom; then the scale; the causal mask only on
//   tiles that cross the diagonal (or T), and tiles wholly past the
//   diagonal skipped (`_fwd_kernel`'s loop bound, :128-131). A row's max
//   and sum are reduced over the 4 lanes that share it in the
//   accumulator layout.
// - P V keeps float32 precision: p = p_hi + p_lo with p_hi = bf16(p) and
//   p_lo = bf16(p - p_hi) leaves p within ~2^-17 of its float32 value,
//   where one bf16 rounding (2^-9) would break the bar the tests hold (the
//   float32 bar plus one bf16 spacing of o). Both halves go through
//   `wgmma m64nDk16` with A from registers (the S accumulator fragment
//   re-packed as the A operand) and V from shared memory through the
//   transpose bit; from D = 128 on the descriptor's leading byte offset
//   steps from one of V's atoms to the next. l is summed in float32 from p
//   before the split.
// - Inside a warpgroup, tile i's P V and tile i + 1's S are issued
//   together, and tile i + 1's softmax runs while P V is on the tensor
//   cores; each loop iteration ends with no wgmma in flight, so ptxas
//   keeps the products asynchronous. The two warpgroups interleave too.
// - As built at D = 64, the softmax's float32 instructions (scale, mask,
//   max, expf, sum, the split of p) bound it, not the tensor cores: it
//   runs at ~6.6x the bound (PERF.md). 288 threads a CTA leave one CTA (8
//   consumer warps) per SM; at D = 128 the O accumulators double to 64
//   float32 a thread, within the 168 registers ptxas gives a thread.
//
// Non-finite rules, those of `flash_fwd_tf32.cuh` (and of `_fwd_xla`):
// - the running max keeps NaN; m_safe = m where finite, else 0;
// - p = exp(s - m_safe) where s is finite, else 0;
// - corr = exp(m_old - m_safe) where the old max is finite, 0 where it is
//   -inf (nothing summed yet), 1 where it is +inf or NaN (the sums are
//   already in the basis m_safe = 0);
// - l_safe = max(l, 1e-30) keeping NaN; lse = m_fin + log(l_safe).
// - In P V only the p_hi product sees a non-finite v: the p_lo product
//   reads a copy of the V tile with every non-finite element 0 (p_lo can
//   be 0, 0 inf = NaN, or of the other sign, -inf beside p_hi's +inf).
//   So o is +-inf where p > 0 meets an infinite v, and NaN where the
//   plain version computes 0 inf: p = 0 in a tile the warpgroup scores
//   (the p_hi product is 0 inf), and every key past the tiles it scores
//   (causal), which the plain version's dense product still multiplies
//   by p = 0. A pre-pass (`v_last_nonfinite_kernel`) writes the last key
//   of each (batch*head, column) whose v is not finite, one writer per
//   column and no memset: a (batch, head) with none (the kernel reads
//   all its columns first) runs as if the rule were not there (at D 64 in
//   its own instantiation of the loop: `Dirty`), and one with some copies
//   each V tile into its warpgroup's own 1024-aligned buffer (the same
//   swizzled bytes, non-finite bf16 zeroed) before P V, and marks NaN
//   each causal column whose last such key lies past the warpgroup's
//   tiles. The two copies take 16 KB (D 64), 32 KB (D 128 and 256: 32-key
//   tiles; D 512: the CTA's 256 columns) or 24 KB (D 192) of shared
//   memory beside the ring. The tiles a warpgroup scores, and so the keys
//   past them, follow the instance's kBK and query tile.
//
// Rounding: compiled without --fmad=false (build.py): attention has no
// rounding contract beyond its tolerance, and splitting the multiply-adds
// would lengthen an operations-bound kernel. expf, logf and the division
// by l_safe are the IEEE-accurate ones (no fast math).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "sm90_ptx.cuh"

namespace {

constexpr int kConsumers = 256;             // two warpgroups
constexpr int kAtomCols = 64;               // bf16 columns of one atom
constexpr int kRowBytes = kAtomCols * 2;    // one 128-byte swizzle row

template <int kD>
struct Cfg {
  static_assert(kD % kAtomCols == 0, "head dim: whole 64-column atoms");
  // past D 256 a cluster of two CTAs splits the head dim (the header's
  // budget): CTAs a cluster, the columns of Q, K, V and O a CTA holds, and
  // the K/V ring's depth
  static constexpr int kCluster = kD > 256 ? 2 : 1;
  static_assert(kD <= 256 * kCluster, "a CTA holds at most 256 columns");
  static constexpr int kDC = kD / kCluster;
  static constexpr int kStages = kCluster > 1 ? 3 : 4;
  static constexpr int kBQ = 128;   // query rows per CTA
  static constexpr int kDV = kDC;   // columns of O (and of V) a warpgroup owns
  // keys per K/V tile: 64 up to D 128, 32 past it (the header's budget)
  static constexpr int kBK = kD > 128 ? 32 : 64;
  static constexpr int kSN = kBK / 2;  // S accumulators a thread
  static constexpr int kPN = kBK / 4;  // bf16 pairs of P a thread
  // the producer: one warp up to D 128; past it a whole warpgroup, whose
  // registers `setmaxnreg` hands to the consumers (the header's budget)
  static constexpr bool kRegSplit = kD > 128;
  static constexpr int kThreads = kConsumers + (kRegSplit ? 128 : 32);
  static constexpr int kProducerRegs = 24, kConsumerRegs = 240;
  static_assert(!kRegSplit || 128 * kProducerRegs + kConsumers *
                kConsumerRegs <= 65536, "the register file");
  static constexpr int kAtoms = kDC / kAtomCols;           // a CTA's
  static constexpr int kQAtomBytes = kBQ * kRowBytes;      // 16 KB
  static constexpr int kKVAtomBytes = kBK * kRowBytes;     // 8 or 4 KB
  static constexpr int kQBytes = kAtoms * kQAtomBytes;
  static constexpr int kKVBytes = kAtoms * kKVAtomBytes;  // a K or V tile
  // a consumer warpgroup's partial S of a tile (64 rows x kBK float32) as
  // the peer CTA pushes it, into one of two buffers
  static constexpr int kXBytes = kCluster > 1 ? 64 * kBK * 4 : 0;
  // Q, the K and V ring, one sanitized V tile per consumer warpgroup, its
  // two buffers of partials from the peer, and the alignment
  static constexpr int kSmemBytes = kQBytes + 2 * kStages * kKVBytes +
                                    2 * kKVBytes + 4 * kXBytes + 1024;
  // what a block may take, less the static barriers
  static_assert(kSmemBytes <= 232448 - 128, "shared memory");
};

__device__ __forceinline__ bool is_finite(float x) {
  return fabsf(x) < INFINITY;  // false for NaN and +-inf
}

// two floats as a bf16 pair, `lo` in the low half (the lower k index)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// c ? a : b without a branch. Written as ?: around expf, ptxas made one
// divergent branch per score, and the kernel took 1.7x as long (PERF.md)
__device__ __forceinline__ float select(bool c, float a, float b) {
  float d;
  asm("{\n .reg .pred p;\n setp.ne.u32 p, %1, 0;\n"
      " selp.f32 %0, %2, %3, p;\n}"
      : "=f"(d)
      : "r"(static_cast<uint32_t>(c)), "f"(a), "f"(b));
  return d;
}

// a bf16 pair with each non-finite half zeroed
__device__ __forceinline__ uint32_t finite_pair(uint32_t w) {
  const uint32_t lo = (w & 0x7f80u) == 0x7f80u ? 0x0000ffffu : 0u;
  const uint32_t hi = (w & 0x7f800000u) == 0x7f800000u ? 0xffff0000u : 0u;
  return w & ~(lo | hi);
}

// The warpgroup's atoms of the V tile at `src` into `dst` with every
// non-finite element 0: the p_lo product's operand. Both are 1024-byte
// aligned, so a byte-for-byte copy keeps the 128-byte swizzle. The
// warpgroup's 128 threads copy it, fence it to the async proxy and meet at
// named barrier `bar` before any of them issues the wgmma that reads it.
template <int kD>
__device__ __forceinline__ void sanitize_v(uint32_t dst, uint32_t src,
                                           uint32_t bar) {
  constexpr int kChunks = Cfg<kD>::kKVBytes / (16 * 128);
  const uint32_t t = threadIdx.x % 128;
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const uint32_t off = (i * 128 + t) * 16;
    uint4 x = sm90::lds128(src + off);
    x.x = finite_pair(x.x);
    x.y = finite_pair(x.y);
    x.z = finite_pair(x.z);
    x.w = finite_pair(x.w);
    sm90::sts128(dst + off, x);
  }
  sm90::fence_proxy_async();
  sm90::bar_sync(bar, 128);
  __syncwarp();
}

// one k16 step of S = Q K^T over a tile of 64 or 32 keys
__device__ __forceinline__ void wgmma_qk(float (&s)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  sm90::wgmma_ss(s, da, db, scale_d);
}
__device__ __forceinline__ void wgmma_qk(float (&s)[16], uint64_t da,
                                         uint64_t db, int scale_d) {
  sm90::wgmma_m64n32k16_ss(s, da, db, scale_d);
}

// S = Q K^T of one key tile into `s` (uncommitted) over the CTA's
// columns: kDC / 16 k16 steps, each 32 bytes along the swizzled 128-byte
// rows of one atom of Q and K
template <int kD>
__device__ __forceinline__ void issue_qk(float (&s)[Cfg<kD>::kSN],
                                         uint32_t q_wg, uint32_t k_tile) {
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < Cfg<kD>::kDC / 16; ++kk) {
    const int atom = kk / 4, step = kk % 4;
    wgmma_qk(s,
             sm90::desc_sw128(q_wg + atom * Cfg<kD>::kQAtomBytes) + 2 * step,
             sm90::desc_sw128(k_tile + atom * Cfg<kD>::kKVAtomBytes) +
                 2 * step,
             kk);
  }
}

// The online-softmax update of one tile of kBK keys, in place: s holds a
// thread's raw products of rows row0 and row0 + 8 (d[4 j + 2 r + e] is
// row row0 + 8 r, key k0 + 8 j + 2 t4 + e) and leaves with their p; m and
// l move, and corr[r] is the factor the accumulators of row r take. The
// two rows go through each step together, so their shuffles and exps
// overlap.
template <int kBK>
__device__ __forceinline__ void softmax(float (&s)[kBK / 2], float (&m)[2],
                                       float (&l)[2], float (&corr)[2],
                                       int k0, int row0, int wg_first, int T,
                                       float scale, int causal) {
  const int t4 = threadIdx.x % 4;
  // only tiles that cross the diagonal or T need the mask
  const bool edge = (causal && k0 + kBK - 1 > wg_first) || k0 + kBK > T;
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = i / 2, idx = 4 * j + i;
      float x = s[idx] * scale;
      if (edge) {
        const int key = k0 + 8 * j + 2 * t4 + i % 2;
        if (key >= T || (causal && key > row0 + 8 * r)) x = -INFINITY;
      }
      s[idx] = x;
      mx[r] = sm90::max_nan(mx[r], x);
    }
  }
  // the 4 lanes of a row
#pragma unroll
  for (int off = 1; off < 4; off *= 2) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = sm90::max_nan(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], off));
    }
  }
  float m_safe[2], ps[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_new = sm90::max_nan(m[r], mx[r]);
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

// p (in s) as the A fragments of P V, split into bf16 halves: the
// fragment of k16 step kk is the pairs (s[8 kk + 2 a], +1), a < 4
template <int kSN>
__device__ __forceinline__ void split_p(const float (&s)[kSN],
                                        uint32_t (&p_hi)[kSN / 2],
                                        uint32_t (&p_lo)[kSN / 2]) {
#pragma unroll
  for (int a = 0; a < kSN / 2; ++a) {
    const float x0 = s[2 * a], x1 = s[2 * a + 1];
    const uint32_t hi = pack_bf16(x0, x1);
    // a bf16 widens to float32 exactly: its bits in the high half
    p_hi[a] = hi;
    p_lo[a] = pack_bf16(x0 - __uint_as_float(hi << 16),
                        x1 - __uint_as_float(hi & 0xffff0000u));
  }
}

// one k16 step of P V over the warpgroup's kDV columns: 16 V rows (2048
// bytes into each atom). The accumulator's columns 128 c.. are entries
// 64 c.. of `acc`, so a kDV of 192 or 256 (D 256 and 512) issues a
// 128-column product per pair of atoms (and a 64-column one for a last
// odd atom), the descriptor stepping two atoms along
template <int kD>
__device__ __forceinline__ void wgmma_pv(float (&acc)[Cfg<kD>::kDV / 2],
                                         const uint32_t* a, uint64_t desc) {
  constexpr int kDV = Cfg<kD>::kDV;
  if constexpr (kDV == 64) {
    sm90::wgmma_m64n64k16_rs_tb(acc, a, desc);
  } else {
#pragma unroll
    for (int c = 0; c < kDV / 128; ++c) {
      sm90::wgmma_m64n128k16_rs_tb(
          *reinterpret_cast<float(*)[64]>(acc + 64 * c), a,
          desc + ((2 * c * Cfg<kD>::kKVAtomBytes) >> 4));
    }
    if constexpr (kDV % 128 != 0) {
      sm90::wgmma_m64n64k16_rs_tb(
          *reinterpret_cast<float(*)[32]>(acc + kDV / 2 - 32), a,
          desc + (((kDV / 64 - 1) * Cfg<kD>::kKVAtomBytes) >> 4));
    }
  }
}

// O = corr O + P_hi V + P_lo V_lo for one key tile (uncommitted): kBK /
// 16 k16 steps per half; V's atoms (D >= 128) are the descriptor's
// leading byte offset apart. v_tile is the warpgroup's first atom of the
// tile; V_lo is V, or its sanitized copy (the header's non-finite rules)
template <int kD>
__device__ __forceinline__ void issue_pv(float (&acc)[Cfg<kD>::kDV / 2],
                                         uint32_t (&p_hi)[Cfg<kD>::kPN],
                                         uint32_t (&p_lo)[Cfg<kD>::kPN],
                                         const float (&corr)[2],
                                         uint32_t v_tile, uint32_t v_lo) {
  constexpr int kBK = Cfg<kD>::kBK;
#pragma unroll
  for (int j = 0; j < Cfg<kD>::kDV / 8; ++j) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      acc[4 * j + 2 * r] *= corr[r];
      acc[4 * j + 2 * r + 1] *= corr[r];
    }
  }
  const uint32_t lbo =
      Cfg<kD>::kDC > kAtomCols ? Cfg<kD>::kKVAtomBytes : 1024;
  const uint64_t desc_v = sm90::desc_sw128(v_tile, lbo);
  const uint64_t desc_lo = sm90::desc_sw128(v_lo, lbo);
  sm90::fence_regs(acc);
  sm90::fence_regs(p_hi);
  sm90::fence_regs(p_lo);
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    wgmma_pv<kD>(acc, p_hi + 4 * kk, desc_v + 128 * kk);
  }
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    wgmma_pv<kD>(acc, p_lo + 4 * kk, desc_lo + 128 * kk);
  }
}

// one tile of the CTA's columns c0.. and `rows` rows from (h, row, b)
// into `dst`, an atom at a time
template <int kD>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int atom_bytes, int c0,
                                         int h, int row, int b) {
#pragma unroll
  for (int a = 0; a < Cfg<kD>::kAtoms; ++a) {
    sm90::tma_load_4d(dst + a * atom_bytes, map, bar, c0 + a * kAtomCols, h,
                      row, b);
  }
}

// The cluster's exchange of S (the header's design): a consumer
// warpgroup's peer is the warpgroup of the same rows in the other CTA.
// Each pushes its partial of tile i (its 64 rows over its CTA's columns)
// into the peer's buffer i % 2 by `st.async`, whose bytes complete that
// buffer's `full` barrier in the peer (armed there for those bytes); then
// waits on its own `full` of the buffer for the peer's partial, sums the
// two in rank order, re-arms the buffer for tile i + 2, and hands it back
// with one arrival on the peer's `empty` of the buffer. A push into a
// buffer waits on this warpgroup's own `empty` of it (the peer took tile
// i - 2 from it). Every barrier takes one arrival a phase.
struct Exchange {
  uint32_t x_in, x_peer;           // buffer 0 here and in the peer
  uint32_t full, empty;            // barriers of buffer 0 here
  uint32_t full_peer, empty_peer;  // and in the peer
  uint32_t rank, bar;              // this CTA's rank; a named barrier
};

template <int kD>
__device__ __forceinline__ void exchange(float (&s)[Cfg<kD>::kSN], int i,
                                         int n_wg, const Exchange& x) {
  constexpr int kSN = Cfg<kD>::kSN;
  constexpr uint32_t kBytes = Cfg<kD>::kXBytes;
  const uint32_t t = threadIdx.x % 128;
  const uint32_t b = i & 1, off = b * kBytes;
  if (i >= 2) sm90::mbar_wait_cluster(x.empty + 8 * b, ((i >> 1) - 1) & 1);
#pragma unroll
  for (int j = 0; j < kSN / 4; ++j) {
    sm90::st_async_f4(x.x_peer + off + (j * 128 + t) * 16,
                      make_float4(s[4 * j], s[4 * j + 1], s[4 * j + 2],
                                  s[4 * j + 3]),
                      x.full_peer + 8 * b);
  }
  sm90::mbar_wait_cluster(x.full + 8 * b, (i >> 1) & 1);
#pragma unroll
  for (int j = 0; j < kSN / 4; ++j) {
    const float4 p = sm90::lds128f(x.x_in + off + (j * 128 + t) * 16);
    const float pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {  // rank 0's partial first
      s[4 * j + e] =
          x.rank == 0 ? s[4 * j + e] + pv[e] : pv[e] + s[4 * j + e];
    }
  }
  // every thread of the warpgroup has read the buffer
  sm90::bar_sync(x.bar, 128);
  if (t == 0) {
    if (i + 2 < n_wg) sm90::mbar_expect_tx(x.full + 8 * b, kBytes);
    sm90::mbar_arrive_remote(x.empty_peer + 8 * b);
  }
}

// How a consumer knows whether its (batch, head) has a non-finite v:
// kFinite and kNonfinite fix it at compile time (an instantiation of the
// loop for each, chosen once a CTA), kRuntime tests the flag in every
// tile. On an H100 at (8, 2048, 4, D) bf16 causal, D 64 took 0.1126-0.1150
// ms a launch with the two instantiations and 0.1249-0.1275 with the
// flag tested in the loop (0.1162-0.1167 before the non-finite rules); at
// D 128 the two instantiations spilled (560 bytes loaded) and took
// 0.1653-0.1658 ms against 0.1612-0.1621 (PERF.md)
enum Dirty { kFinite, kNonfinite, kRuntime };

// The consumer warpgroups' tiles and store
template <int kD, Dirty kDirty>
__device__ __forceinline__ void consume(
    uint32_t q_wg, uint32_t k_s, uint32_t v_s, uint32_t v_clean,
    uint32_t q_full, uint32_t full, uint32_t empty, int n_wg, int n_tiles,
    int row0, int wg_first, int wg, int t4, int T, int H, int h, int b,
    int bh, __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
    const int* __restrict__ last, float scale, int causal,
    bool dirty_flag, const Exchange& x) {
  using C = Cfg<kD>;
  constexpr int kBK = C::kBK, kSN = C::kSN, kDV = C::kDV;
  constexpr int kStages = C::kStages;
  const bool dirty = kDirty == kRuntime ? dirty_flag : kDirty == kNonfinite;
  // the CTA's first column of O: 0, or 256 in the second CTA of a cluster
  const int col0 = static_cast<int>(x.rank) * C::kDC;
  // s: the scores, then p, of the tile in hand; p_hi/p_lo: its P split
  float acc[kDV / 2], s[kSN];
  uint32_t p_hi[C::kPN], p_lo[C::kPN];
#pragma unroll
  for (int i = 0; i < kDV / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kSN; ++i) s[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, corr[2];
  if constexpr (C::kCluster > 1) {
    if (threadIdx.x % 128 == 0) {  // the buffers' bytes of tiles 0 and 1
      sm90::mbar_expect_tx(x.full, C::kXBytes);
      if (n_wg > 1) sm90::mbar_expect_tx(x.full + 8, C::kXBytes);
    }
  }

  sm90::mbar_wait(q_full, 0);
  sm90::mbar_wait(full, 0);
  __syncwarp();  // converged again for the .aligned wgmma
  issue_qk<kD>(s, q_wg, k_s);
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  sm90::fence_regs(s);
  if constexpr (C::kCluster > 1) exchange<kD>(s, 0, n_wg, x);
  softmax<kBK>(s, m, l, corr, 0, row0, wg_first, T, scale, causal);
  split_p(s, p_hi, p_lo);

  // Tile i's P V runs under tile i + 1's softmax, and tile i + 1's S
  // beside tile i's P V. Every iteration ends with nothing in flight, so
  // each wait retires a known group (else ptxas serializes the wgmmas).
  for (int i = 0; i + 1 < n_wg; ++i) {
    const int nst = (i + 1) % kStages;
    const uint32_t v_tile = v_s + (i % kStages) * C::kKVBytes;
    if (dirty) sanitize_v<kD>(v_clean, v_tile, 1 + wg);
    sm90::mbar_wait(full + 8 * nst, ((i + 1) / kStages) & 1);
    __syncwarp();
    sm90::fence_regs(s);
    issue_qk<kD>(s, q_wg, k_s + nst * C::kKVBytes);
    sm90::wgmma_commit();
    issue_pv<kD>(acc, p_hi, p_lo, corr, v_tile, dirty ? v_clean : v_tile);
    sm90::wgmma_commit();

    sm90::wgmma_wait<1>();  // S of tile i + 1
    sm90::fence_regs(s);
    if constexpr (C::kCluster > 1) exchange<kD>(s, i + 1, n_wg, x);
    softmax<kBK>(s, m, l, corr, (i + 1) * kBK, row0, wg_first, T, scale,
                 causal);

    sm90::wgmma_wait<0>();  // P V of tile i: its stage and P are free
    sm90::fence_regs(acc);
    sm90::fence_regs(p_hi);
    sm90::fence_regs(p_lo);
    sm90::mbar_arrive(empty + 8 * (i % kStages));
    split_p(s, p_hi, p_lo);
  }
  const uint32_t v_tile = v_s + ((n_wg - 1) % kStages) * C::kKVBytes;
  if (dirty) sanitize_v<kD>(v_clean, v_tile, 1 + wg);
  __syncwarp();
  issue_pv<kD>(acc, p_hi, p_lo, corr, v_tile, dirty ? v_clean : v_tile);
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  sm90::fence_regs(acc);
  sm90::fence_regs(p_hi);
  sm90::fence_regs(p_lo);
  sm90::mbar_arrive(empty + 8 * ((n_wg - 1) % kStages));
  // tiles past this warpgroup's diagonal: released once they have landed
  for (int i = n_wg; i < n_tiles; ++i) {
    sm90::mbar_wait(full + 8 * (i % kStages), (i / kStages) & 1);
    sm90::mbar_arrive(empty + 8 * (i % kStages));
  }
  // the peer has taken the last pushes: nothing more comes into this
  // CTA's shared memory from it, so the CTA may exit
  if constexpr (C::kCluster > 1) {
    for (int i = max(n_wg - 2, 0); i < n_wg; ++i) {
      sm90::mbar_wait_cluster(x.empty + 8 * (i & 1), (i >> 1) & 1);
    }
  }

  // causal: the keys from kc on lie past every row of the warpgroup and
  // were not scored; a non-finite v among them makes the column NaN
  const int kc = n_wg * kBK;
  const int* last_bh =
      dirty && causal && kc < T ? last + static_cast<int64_t>(bh) * kD
                                : nullptr;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= T) continue;
    const float l_safe = l[r] != l[r] ? l[r] : fmaxf(l[r], 1e-30f);
    __nv_bfloat16* orow = o + ((static_cast<int64_t>(b) * T + row) * H + h)
                                  * kD;
#pragma unroll
    for (int j = 0; j < kDV / 8; ++j) {
      const int c = col0 + 8 * j + 2 * t4;
      float x0 = acc[4 * j + 2 * r] / l_safe;
      float x1 = acc[4 * j + 2 * r + 1] / l_safe;
      if (last_bh != nullptr) {
        if (last_bh[c] >= kc) x0 = NAN;
        if (last_bh[c + 1] >= kc) x1 = NAN;
      }
      *reinterpret_cast<uint32_t*>(orow + c) = pack_bf16(x0, x1);
    }
    if (t4 == 0 && x.rank == 0) {  // one writer a row
      lse[static_cast<int64_t>(bh) * T + row] =
          (is_finite(m[r]) ? m[r] : 0.f) + logf(l_safe);
    }
  }
}

template <int kD>
__global__ void __launch_bounds__(Cfg<kD>::kThreads, 1)
flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                    const int* __restrict__ last, int H, int T, float scale,
                    int causal) {
  using C = Cfg<kD>;
  constexpr int kBK = C::kBK, kBQ = C::kBQ, kStages = C::kStages;
  __shared__ __align__(8) uint64_t q_full;
  __shared__ __align__(8) uint64_t full[kStages];
  __shared__ __align__(8) uint64_t empty[kStages];
  // the cluster's exchange: a pair of barriers for each buffer of each
  // consumer warpgroup
  __shared__ __align__(8) uint64_t x_full[4];
  __shared__ __align__(8) uint64_t x_empty[4];
  extern __shared__ uint8_t smem_raw[];

  // 1024-byte aligned tiles: the 128-byte swizzle repeats every 8 rows
  const uint32_t base = (sm90::smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t k_s = base + C::kQBytes;
  const uint32_t v_s = k_s + kStages * C::kKVBytes;
  // after the ring and the two sanitized V tiles: the peer's partials,
  // two buffers a consumer warpgroup
  const uint32_t x_s = v_s + (kStages + 2) * C::kKVBytes;

  // the CTA's rank in its cluster holds columns rank * kDC.. of Q, K, V
  // and O; the cluster's CTAs share the (batch*head, query rows)
  const uint32_t rank = C::kCluster > 1 ? sm90::cluster_rank() : 0;
  const int bh = blockIdx.x / C::kCluster;
  const int c0 = static_cast<int>(rank) * C::kDC;
  const int b = bh / H, h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // longest tiles first
  // causal: no key past the tile's last row
  const int k_end = causal ? min(q0 + kBQ, T) : T;
  const int n_tiles = (k_end + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    sm90::mbar_init(sm90::smem_addr(&q_full), 1);
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(sm90::smem_addr(&full[s]), 1);
      sm90::mbar_init(sm90::smem_addr(&empty[s]), kConsumers);
    }
    if constexpr (C::kCluster > 1) {
      for (int w = 0; w < 4; ++w) {
        sm90::mbar_init(sm90::smem_addr(&x_full[w]), 1);
        sm90::mbar_init(sm90::smem_addr(&x_empty[w]), 1);
      }
    }
    sm90::fence_barrier_init();
  }
  if constexpr (C::kCluster > 1) {
    // every CTA of the cluster runs, its barriers initialised, before any
    // reaches into another's shared memory
    sm90::cluster_arrive();
    sm90::cluster_wait();
  } else {
    __syncthreads();
  }

  if (threadIdx.x >= kConsumers) {
    // producer: one lane issues every load
    if constexpr (C::kRegSplit) sm90::setmaxnreg_dec<C::kProducerRegs>();
    if (threadIdx.x != kConsumers) return;
    sm90::mbar_expect_tx(sm90::smem_addr(&q_full), C::kQBytes);
    tma_tile<kD>(q_s, &qmap, sm90::smem_addr(&q_full), C::kQAtomBytes, c0,
                 h, q0, b);
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kStages;
      // the consumers' release of tile i - kStages (passes at once for
      // the first kStages tiles)
      sm90::mbar_wait(sm90::smem_addr(&empty[s]), ((i / kStages) & 1) ^ 1);
      const uint32_t bar = sm90::smem_addr(&full[s]);
      sm90::mbar_expect_tx(bar, 2 * C::kKVBytes);
      tma_tile<kD>(k_s + s * C::kKVBytes, &kmap, bar, C::kKVAtomBytes, c0,
                   h, i * kBK, b);
      tma_tile<kD>(v_s + s * C::kKVBytes, &vmap, bar, C::kKVAtomBytes, c0,
                   h, i * kBK, b);
    }
    return;
  }

  if constexpr (C::kRegSplit) sm90::setmaxnreg_inc<C::kConsumerRegs>();
  // consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63 (of the
  // CTA's columns, in a cluster); in the accumulator layout lane (g, t4)
  // of warp w holds rows 16 w + g and 16 w + g + 8, columns 8 j + 2 t4 +
  // {0, 1}: d[4 j + 2 r + e] is row 16 w + g + 8 r, column 8 j + 2 t4 + e
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int wg_first = q0 + 64 * wg;
  const int wg_last = wg_first + 63;
  const int row0 = wg_first + 16 * warp + g;

  // tiles this warpgroup scores: causal, none wholly past its last row
  // (`_fwd_kernel`'s loop bound, :128-131); the same for its peer, whose
  // rows these are
  const int n_wg = causal ? min(n_tiles, wg_last / kBK + 1) : n_tiles;
  // this warpgroup's 64 rows of each Q atom, and its sanitized V tile
  const uint32_t q_wg = q_s + wg * 64 * kRowBytes;
  const uint32_t v_clean = v_s + (kStages + wg) * C::kKVBytes;
  Exchange x{};
  x.rank = rank;
  if constexpr (C::kCluster > 1) {
    const uint32_t peer = rank ^ 1u;
    x.x_in = x_s + 2 * wg * C::kXBytes;
    x.x_peer = sm90::mapa(x.x_in, peer);
    x.full = sm90::smem_addr(&x_full[2 * wg]);
    x.empty = sm90::smem_addr(&x_empty[2 * wg]);
    x.full_peer = sm90::mapa(x.full, peer);
    x.empty_peer = sm90::mapa(x.empty, peer);
    x.bar = 3 + wg;  // 1 + wg is sanitize_v's
  }
  // the pre-pass's verdict on this (batch, head): a non-finite v in any
  // column (the same in every thread of the CTA)
  int last_any = -1;
  for (int c = lane; c < kD; c += 32) {
    last_any = max(last_any, last[static_cast<int64_t>(bh) * kD + c]);
  }
  const bool dirty = __any_sync(0xffffffffu, last_any >= 0);

  const uint32_t qf = sm90::smem_addr(&q_full);
  const uint32_t fl = sm90::smem_addr(&full[0]);
  const uint32_t em = sm90::smem_addr(&empty[0]);
  if constexpr (kD == 64) {
    if (dirty) {
      consume<kD, kNonfinite>(q_wg, k_s, v_s, v_clean, qf, fl, em, n_wg,
                              n_tiles, row0, wg_first, wg, t4, T, H, h, b, bh,
                              o, lse, last, scale, causal, dirty, x);
    } else {
      consume<kD, kFinite>(q_wg, k_s, v_s, v_clean, qf, fl, em, n_wg,
                           n_tiles, row0, wg_first, wg, t4, T, H, h, b, bh, o,
                           lse, last, scale, causal, dirty, x);
    }
  } else {
    consume<kD, kRuntime>(q_wg, k_s, v_s, v_clean, qf, fl, em, n_wg, n_tiles,
                          row0, wg_first, wg, t4, T, H, h, b, bh, o, lse, last,
                          scale, causal, dirty, x);
  }
}

// The pre-pass: last[bh * D + c] = the last key whose v[b, key, h, c] is
// not finite, -1 where there is none. One CTA per (batch*head, 16
// columns): each thread reads 32 bytes of every 256th row, the CTA takes
// the max, and one thread writes each column, so nothing is reset first.
constexpr int kPreCols = 16;
constexpr int kPreThreads = 256;

__global__ void __launch_bounds__(kPreThreads)
v_last_nonfinite_kernel(const __nv_bfloat16* __restrict__ v, int64_t svb,
                        int64_t svt, int64_t svh, int H, int T, int D,
                        int* __restrict__ last) {
  __shared__ int part[kPreThreads / 32][kPreCols];
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int c0 = blockIdx.y * kPreCols;
  const __nv_bfloat16* col = v + b * svb + h * svh + c0;
  int found[kPreCols];
#pragma unroll
  for (int c = 0; c < kPreCols; ++c) found[c] = -1;
#pragma unroll 4
  for (int r = threadIdx.x; r < T; r += kPreThreads) {
    const uint4* p =
        reinterpret_cast<const uint4*>(col + static_cast<int64_t>(r) * svt);
    uint4 x[kPreCols / 8];
#pragma unroll
    for (int i = 0; i < kPreCols / 8; ++i) x[i] = __ldg(p + i);
#pragma unroll
    for (int i = 0; i < kPreCols / 8; ++i) {
      const uint32_t w[4] = {x[i].x, x[i].y, x[i].z, x[i].w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {  // column c0 + 8 i + 2 e in the low half
        const int c = 8 * i + 2 * e;
        if ((w[e] & 0x7f80u) == 0x7f80u) found[c] = r;
        if ((w[e] & 0x7f800000u) == 0x7f800000u) found[c + 1] = r;
      }
    }
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int c = 0; c < kPreCols; ++c) {
    const int m = __reduce_max_sync(0xffffffffu, found[c]);
    if (lane == 0) part[warp][c] = m;
  }
  __syncthreads();
  if (threadIdx.x < kPreCols) {
    int m = -1;
#pragma unroll
    for (int w = 0; w < kPreThreads / 32; ++w) {
      m = max(m, part[w][threadIdx.x]);
    }
    last[static_cast<int64_t>(bh) * D + c0 + threadIdx.x] = m;
  }
}

int launch_last(const void* v, int* last, int64_t B, int64_t T_len,
                int64_t H, int64_t D, int64_t svb, int64_t svt, int64_t svh,
                cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned int>(B * H),
                  static_cast<unsigned int>(D / kPreCols));
  v_last_nonfinite_kernel<<<grid, kPreThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(v), svb, svt, svh,
      static_cast<int>(H), static_cast<int>(T_len), static_cast<int>(D),
      last);
  return static_cast<int>(cudaGetLastError());
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled looked up through the runtime, so the library
// links without -lcuda
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &res) == cudaSuccess &&
        res == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// a 4-D (d, h, t, b) bf16 map over a [B, T, H, D] view with the given
// element strides, boxes of one 64-column atom of `rows` rows of one
// (b, h)
bool make_map(EncodeTiled enc, CUtensorMap* map, const void* ptr, int64_t B,
              int64_t T, int64_t H, int64_t D, int64_t sb, int64_t st,
              int64_t sh, uint32_t rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(T),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(st) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {kAtomCols, 1, rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
             const_cast<void*>(ptr), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The launch at head dim kD: the (batch*head, 128 query rows) CTAs, past D
// 256 in clusters of kCluster side by side on x (`cfg` then points at
// `attr`; a cluster that cannot be placed makes the launch fail, and the
// error is returned)
template <int kD>
cudaError_t config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr,
                   int64_t BH, int64_t T_len, cudaStream_t stream) {
  using C = Cfg<kD>;
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(static_cast<unsigned int>(BH * C::kCluster),
                     static_cast<unsigned int>((T_len + C::kBQ - 1) / C::kBQ));
  cfg.blockDim = dim3(C::kThreads);
  cfg.dynamicSmemBytes = C::kSmemBytes;
  cfg.stream = stream;
  if constexpr (C::kCluster > 1) {
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = C::kCluster;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
  }
  return cudaFuncSetAttribute(flash_fwd_tc_kernel<kD>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              C::kSmemBytes);
}

// the maps (K and V in tiles of the instance's kBK keys), the pre-pass
// and the kernel at head dim kD
template <int kD>
int launch(EncodeTiled enc, const void* q, const void* k, const void* v,
           void* o, float* lse, int* last, int64_t B, int64_t T_len,
           int64_t H, int64_t sqb, int64_t sqt, int64_t sqh, int64_t skb,
           int64_t skt, int64_t skh, int64_t svb, int64_t svt, int64_t svh,
           float scale, int causal, cudaStream_t stream) {
  CUtensorMap qm, km, vm;
  if (!make_map(enc, &qm, q, B, T_len, H, kD, sqb, sqt, sqh,
                Cfg<kD>::kBQ) ||
      !make_map(enc, &km, k, B, T_len, H, kD, skb, skt, skh, Cfg<kD>::kBK) ||
      !make_map(enc, &vm, v, B, T_len, H, kD, svb, svt, svh, Cfg<kD>::kBK)) {
    return -3;
  }
  const int pre = launch_last(v, last, B, T_len, H, kD, svb, svt, svh,
                              stream);
  if (pre != 0) return pre;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = config<kD>(cfg, attr, B * H, T_len, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  if constexpr (Cfg<kD>::kCluster > 1) {
    err = cudaLaunchKernelEx(&cfg, flash_fwd_tc_kernel<kD>, qm, km, vm,
                             static_cast<__nv_bfloat16*>(o), lse,
                             static_cast<const int*>(last),
                             static_cast<int>(H), static_cast<int>(T_len),
                             scale, causal);
    if (err != cudaSuccess) return static_cast<int>(err);
  } else {
    flash_fwd_tc_kernel<kD>
        <<<cfg.gridDim, cfg.blockDim, cfg.dynamicSmemBytes, stream>>>(
        qm, km, vm, static_cast<__nv_bfloat16*>(o), lse, last,
        static_cast<int>(H), static_cast<int>(T_len), scale, causal);
  }
  return static_cast<int>(cudaGetLastError());
}

// the instances' head dims
bool tc_head_dim(int64_t D) {
  return D == 64 || D == 128 || D == 192 || D == 256 || D == 512;
}

}  // namespace

// q, k, v: bfloat16 [B, T, H, D] views (D = 64, 128, 192, 256 or 512) on the
// current device with the given element strides for b, t and h and a d
// stride of 1; base pointers 16-byte aligned and strides multiples of 8 (the Python
// wrapper checks both). o: contiguous bf16 [B, T, H, D]; lse: contiguous
// float32 [B, H, T]; last: B * H * D int32 of scratch for the pre-pass.
// 1 <= T <= 65535 x 128 (the query tiles).
// Launches the pre-pass and the kernel on `stream`; returns
// cudaGetLastError() (0 on success), -1 for another head dim, -2 if
// cuTensorMapEncodeTiled is missing, -3 if it refuses a map.
extern "C" int flash_fwd_tc(const void* q, const void* k, const void* v,
                            void* o, float* lse, void* last, int64_t B,
                            int64_t T_len, int64_t H, int64_t D, int64_t sqb,
                            int64_t sqt, int64_t sqh, int64_t skb,
                            int64_t skt, int64_t skh, int64_t svb,
                            int64_t svt, int64_t svh, float scale,
                            int causal, void* stream) {
  if (!tc_head_dim(D)) return -1;
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return -2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* lst = static_cast<int*>(last);
  auto go = [&](auto d) {
    return launch<decltype(d)::value>(enc, q, k, v, o, lse, lst, B, T_len, H,
                                      sqb, sqt, sqh, skb, skt, skh, svb, svt,
                                      svh, scale, causal, st);
  };
  switch (D) {
    case 64:
      return go(std::integral_constant<int, 64>());
    case 128:
      return go(std::integral_constant<int, 128>());
    case 192:
      return go(std::integral_constant<int, 192>());
    case 256:
      return go(std::integral_constant<int, 256>());
    default:
      return go(std::integral_constant<int, 512>());
  }
}

// The cluster launch at head dim D (512): out = {CTAs a cluster, dynamic
// shared memory of a CTA in bytes, cudaOccupancyMaxActiveClusters}.
// Returns a CUDA error (0 on success), or -1 for a head dim without one.
extern "C" int flash_tc_cluster_info(int64_t D, int* out) {
  if (D != 512) return -1;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = config<512>(cfg, attr, 1, 1, nullptr);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = Cfg<512>::kCluster;
  out[1] = Cfg<512>::kSmemBytes;
  return static_cast<int>(cudaOccupancyMaxActiveClusters(
      out + 2, flash_fwd_tc_kernel<512>, &cfg));
}

// The pre-pass alone, as flash_fwd_tc launches it (for timing it apart):
// v and its strides as there, last: B * H * D int32.
extern "C" int flash_tc_last_nonfinite(const void* v, void* last, int64_t B,
                                       int64_t T_len, int64_t H, int64_t D,
                                       int64_t svb, int64_t svt, int64_t svh,
                                       void* stream) {
  if (!tc_head_dim(D)) return -1;
  return launch_last(v, static_cast<int*>(last), B, T_len, H, D, svb, svt,
                     svh, static_cast<cudaStream_t>(stream));
}

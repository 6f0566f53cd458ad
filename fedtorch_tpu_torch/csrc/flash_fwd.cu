// Exact attention forward with the online softmax, hand-written for Hopper
// (sm_90a).
//
// Replaces the TPU Pallas kernel `_fwd_kernel`
// (fedtorch_tpu/ops/pallas/flash_attention.py:82), which the JAX package
// launches through `_fwd_pallas` (`pallas_call` at :168) from
// `flash_attention` and `flash_attention_with_lse`: the transformer's
// attention='flash' path. For each (batch, head) and query row i, over the
// keys j it sees (j <= i when causal):
//
//   s_j = (q_i . k_j) * scale          in float32
//   o_i = sum_j exp(s_j - lse_i) v_j,  lse_i = log sum_j exp(s_j)
//
// through the running max m, running sum l and a float32 accumulator, so
// no [T, T] score matrix reaches device memory: q, k and v are read, o
// (input dtype) and lse (float32) written.
//
// What bounds it: operations. At the transformer path's shape (B 8, T 2048,
// H 4, D 64, bfloat16, causal) a launch does 4 B H D T(T+1)/2 = 17.2 GFLOP
// and moves 33.8 MB: 0.0174 ms at the card's 989 TFLOP/s of bf16 tensor-core
// work against 0.0101 ms for the bytes. This first kernel runs its float32
// products on the CUDA cores (67 TFLOP/s), so it stays at least 989 / 67 =
// 14.8x above that bound; `wgmma` on bfloat16 tiles with TMA loads is later
// work.
//
// Design, simple and right first:
// - One block of 128 threads per (batch*head, tile of query rows). A row
//   belongs to R adjacent lanes (R = 1 for D <= 32, D / 32 above), each
//   holding 16 or 32 of its q values and of its float32 accumulator in
//   registers; a dot product is summed over the R lanes by xor shuffles, so
//   every lane of a row holds the same bits of s, m and l.
// - K and V tiles are staged through shared memory as float32, read by all
//   rows of a warp at once (broadcast, no bank conflicts: the R lanes of a
//   row read adjacent 16-byte chunks).
// - Causal: tiles wholly past the query tile's last row are not visited
//   (the loop bound of `_fwd_kernel`, :128-131); inside, keys past the row
//   score -inf. Keys past T are never read, so any T >= 1 works.
// - Heaviest causal query tiles are scheduled first.
// - q, k and v are read through their [B, T, H, D] strides (the d stride
//   is 1), so the strided chunks of one qkv projection need no copy; 4
//   elements are loaded at once where every pointer and stride allows it.
//
// Non-finite rules, those of `_fwd_kernel` (:115-142) with the max and the
// finiteness tests written out, since fmaxf drops a NaN that jnp.maximum
// keeps:
// - the running max keeps NaN; m_safe = m where finite, else 0;
// - p = exp(s - m_safe) where s is finite, else 0 (NaN scores included);
// - l_safe = max(l, 1e-30) keeping NaN; lse = m_fin + log(l_safe), m_fin =
//   m where finite, else 0;
// - corr, the rescale of the running sums when m moves: exp(m_old - m_safe)
//   where the old max is finite, 0 where it is -inf (nothing summed yet).
//   Where the old max is +inf or NaN the sums are already in the basis
//   m_safe = 0, which a non-finite max keeps, so corr is 1. `_fwd_kernel`
//   takes 0 there too, which drops every k-block before the one holding a
//   non-finite score and so departs from its own oracle `_fwd_xla`; this
//   kernel gives the oracle's result for any tiling.
//
// Rounding: this source is compiled on its own, WITHOUT --fmad=false
// (build.py). The quantizer needs that flag to keep its rounding as
// written; attention has no such contract (its bar against the plain
// version is a tolerance, 2e-5 in float32), and splitting each of its
// multiply-adds into a multiply and an add would double the instructions
// of an operations-bound kernel. expf, logf and the divisions are the
// IEEE-accurate ones (no fast math).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // 4 warps
constexpr int kGroup = 16;     // keys per online-softmax update

template <int D>
struct Tile {
  static constexpr int R = D >= 64 ? D / 32 : 1;  // lanes per query row
  static constexpr int C4 = D / (4 * R);          // float4 chunks per lane
  static constexpr int BQ = kThreads / R;         // query rows per block
  static constexpr int BK = D == 128 ? 32 : 64;   // keys per smem tile
};

struct Strides {
  int64_t b, t, h;  // element strides of a [B, T, H, D] view (d's is 1)
};

__device__ __forceinline__ bool is_finite(float x) {
  return fabsf(x) < INFINITY;  // false for NaN and +-inf
}

// jnp.maximum: NaN if either operand is NaN
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ float4 load4(const float* p, bool vec) {
  if (vec) return __ldg(reinterpret_cast<const float4*>(p));
  return make_float4(p[0], p[1], p[2], p[3]);
}

// bfloat16 -> float32 is exact: the 16 bits become the high half
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p, bool vec) {
  if (vec) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    return make_float4(__uint_as_float(u.x << 16),
                       __uint_as_float(u.x & 0xffff0000u),
                       __uint_as_float(u.y << 16),
                       __uint_as_float(u.y & 0xffff0000u));
  }
  return make_float4(__bfloat162float(p[0]), __bfloat162float(p[1]),
                     __bfloat162float(p[2]), __bfloat162float(p[3]));
}

// o is the wrapper's contiguous [B, T, H, D] output: 4 elements at a
// multiple of 4 are always aligned
__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

__device__ __forceinline__ uint32_t bf16_bits(float x) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(x)));
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  uint2 u;
  u.x = bf16_bits(x.x) | (bf16_bits(x.y) << 16);
  u.y = bf16_bits(x.z) | (bf16_bits(x.w) << 16);
  *reinterpret_cast<uint2*>(p) = u;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, Strides sq, Strides sk, Strides sv,
                 int H, int T_len, float scale, bool causal, bool vec) {
  using Tl = Tile<D>;
  constexpr int R = Tl::R, C4 = Tl::C4, BQ = Tl::BQ, BK = Tl::BK;
  constexpr int DV = D / 4;  // float4 per key row
  __shared__ float4 ks[BK * DV];
  __shared__ float4 vs[BK * DV];

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // longest tiles first
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int r = threadIdx.x % R;
  const int i = q0 + threadIdx.x / R;  // this lane's query row
  const bool row_ok = i < T_len;       // rows past T compute, never write

  // lane r owns the chunks c*R + r of its row, c < C4
  const T* qrow = q + b * sq.b + h * sq.h +
                  static_cast<int64_t>(row_ok ? i : T_len - 1) * sq.t;
  float4 qr[C4], acc[C4];
#pragma unroll
  for (int c = 0; c < C4; ++c) {
    qr[c] = load4(qrow + 4 * (c * R + r), vec);
    acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m = -INFINITY, l = 0.f;

  const T* kbase = k + b * sk.b + h * sk.h;
  const T* vbase = v + b * sv.b + h * sv.h;
  // causal: no key past the tile's last row
  const int k_end = causal ? min(q0 + BQ, T_len) : T_len;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    const int nk = min(BK, k_end - k0);
    __syncthreads();  // every row is done with the previous tile
    for (int idx = threadIdx.x; idx < BK * DV; idx += kThreads) {
      const int kk = idx / DV, d = 4 * (idx % DV);
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (kk < nk) {  // the tail stays zero: p * v must not read garbage
        const int64_t t = k0 + kk;
        kv = load4(kbase + t * sk.t + d, vec);
        vv = load4(vbase + t * sv.t + d, vec);
      }
      ks[idx] = kv;
      vs[idx] = vv;
    }
    __syncthreads();

    for (int g = 0; g < nk; g += kGroup) {
      float s[kGroup];
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        const float4* kr = ks + (g + j) * DV;
        float dot = 0.f;
#pragma unroll
        for (int c = 0; c < C4; ++c) {
          const float4 kv = kr[c * R + r];
          dot += qr[c].x * kv.x + qr[c].y * kv.y + qr[c].z * kv.z +
                 qr[c].w * kv.w;
        }
#pragma unroll
        for (int off = 1; off < R; off <<= 1) {
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        }
        const int t = k0 + g + j;
        s[j] = (g + j < nk && (!causal || t <= i)) ? dot * scale
                                                   : -INFINITY;
      }
      float m_blk = s[0];
#pragma unroll
      for (int j = 1; j < kGroup; ++j) m_blk = nan_max(m_blk, s[j]);
      const float m_new = nan_max(m, m_blk);
      const float m_safe = is_finite(m_new) ? m_new : 0.f;
      const float corr = is_finite(m) ? expf(m - m_safe)
                                      : (m == -INFINITY ? 0.f : 1.f);
#pragma unroll
      for (int c = 0; c < C4; ++c) {
        acc[c].x *= corr;
        acc[c].y *= corr;
        acc[c].z *= corr;
        acc[c].w *= corr;
      }
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        const float p = is_finite(s[j]) ? expf(s[j] - m_safe) : 0.f;
        psum += p;
        const float4* vr = vs + (g + j) * DV;
#pragma unroll
        for (int c = 0; c < C4; ++c) {
          const float4 vv = vr[c * R + r];
          acc[c].x += p * vv.x;
          acc[c].y += p * vv.y;
          acc[c].z += p * vv.z;
          acc[c].w += p * vv.w;
        }
      }
      l = l * corr + psum;
      m = m_new;
    }
  }

  if (!row_ok) return;
  const float l_safe = l != l ? l : fmaxf(l, 1e-30f);
  T* orow = o + ((static_cast<int64_t>(b) * T_len + i) * H + h) * D;
#pragma unroll
  for (int c = 0; c < C4; ++c) {
    store4(orow + 4 * (c * R + r),
           make_float4(acc[c].x / l_safe, acc[c].y / l_safe,
                       acc[c].z / l_safe, acc[c].w / l_safe));
  }
  if (r == 0) {
    lse[static_cast<int64_t>(bh) * T_len + i] =
        (is_finite(m) ? m : 0.f) + logf(l_safe);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int64_t B, int64_t T_len, int64_t H, Strides sq, Strides sk,
           Strides sv, float scale, int causal, int vec,
           cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned int>((T_len + Tile<D>::BQ - 1) /
                                            Tile<D>::BQ),
                  static_cast<unsigned int>(B * H));
  flash_fwd_kernel<T, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, sq, sk, sv,
      static_cast<int>(H), static_cast<int>(T_len), scale, causal != 0,
      vec != 0);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int64_t D, const void* q, const void* k, const void* v,
             void* o, float* lse, int64_t B, int64_t T_len, int64_t H,
             Strides sq, Strides sk, Strides sv, float scale, int causal,
             int vec, cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, o, lse, B, T_len, H, sq, sk, sv, scale,
                           causal, vec, stream);
    case 32:
      return launch<T, 32>(q, k, v, o, lse, B, T_len, H, sq, sk, sv, scale,
                           causal, vec, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, lse, B, T_len, H, sq, sk, sv, scale,
                           causal, vec, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, lse, B, T_len, H, sq, sk, sv, scale,
                            causal, vec, stream);
    default:
      return -1;
  }
}

}  // namespace

// q, k, v: [B, T, H, D] views on the current device with the given element
// strides for b, t and h and a d stride of 1, float32 (bf16 = 0) or
// bfloat16 (bf16 = 1); o: contiguous [B, T, H, D] of the same dtype; lse:
// contiguous float32 [B, H, T]. T >= 1, B * H <= 65535, D in {16, 32, 64,
// 128}; vec = 1 only if every pointer and stride allows 4-element loads (the
// Python wrapper checks all of it). Launches on `stream` and returns
// cudaGetLastError() (0 on success), or -1 for an unsupported D.
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         void* o, float* lse, int64_t B, int64_t T_len,
                         int64_t H, int64_t D, int64_t sqb, int64_t sqt,
                         int64_t sqh, int64_t skb, int64_t skt, int64_t skh,
                         int64_t svb, int64_t svt, int64_t svh, float scale,
                         int causal, int bf16, int vec, void* stream) {
  const Strides sq{sqb, sqt, sqh}, sk{skb, skt, skh}, sv{svb, svt, svh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return dispatch<__nv_bfloat16>(D, q, k, v, o, lse, B, T_len, H, sq, sk,
                                   sv, scale, causal, vec, st);
  }
  return dispatch<float>(D, q, k, v, o, lse, B, T_len, H, sq, sk, sv, scale,
                         causal, vec, st);
}

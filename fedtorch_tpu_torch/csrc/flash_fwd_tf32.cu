// The entry of the TF32 flash forward. The kernels, what they replace,
// what bounds them and their design are in flash_fwd_tf32.cuh; their
// instances compile in flash_fwd_tf32_f32.cu, flash_fwd_tf32_bf16.cu,
// flash_fwd_tf32_cluster.cu and flash_fwd_tf32_chunked.cu.

#include "flash_fwd_tf32.cuh"

// q, k, v: [B, T, H, D] views on the current device with the given element
// strides for b, t and h and a d stride of 1, float32 (bf16 = 0) or
// bfloat16 (bf16 = 1); o: contiguous [B, T, H, D] of the same dtype; lse:
// contiguous float32 [B, H, T]; last: B * H * (D + 1) int32 of scratch
// for the pre-pass. D >= 1, 1 <= T <= 65535 * 128.
// mode: 2 if every pointer, b/t/h stride and D elements are 16-byte
// multiples, 1 if they are 4-byte multiples, else 0 (the Python wrapper
// checks all of it). Head dims up to 256 take the narrow kernel, up to
// kMaxCluster x 256 a cluster of ceil(D / 256) CTAs, past it the chunked
// kernel. Launches on `stream` and returns the first CUDA error (0 on
// success; a cluster launch that cannot be placed fails here), or -1 for
// D < 1.
extern "C" int flash_fwd_tf32(const void* q, const void* k, const void* v,
                              void* o, float* lse, void* last, int64_t B,
                              int64_t T_len, int64_t H, int64_t D,
                              int64_t sqb, int64_t sqt,
                              int64_t sqh, int64_t skb, int64_t skt,
                              int64_t skh, int64_t svb, int64_t svt,
                              int64_t svh, float scale, int causal, int bf16,
                              int mode, void* stream) {
  using namespace flash_tf32;
  if (D < 1) return -1;
  const Strides sq{sqb, sqt, sqh}, sk{skb, skt, skh}, sv{svb, svt, svh};
  Launcher* go = D > 256 * kMaxCluster ? (bf16 ? chunked_bf16 : chunked_f32)
                 : D > 256             ? (bf16 ? cluster_bf16 : cluster_f32)
                                       : (bf16 ? narrow_bf16 : narrow_f32);
  return go(q, k, v, o, lse, static_cast<int*>(last), B, T_len, H, D, sq, sk,
            sv, scale, causal, mode, static_cast<cudaStream_t>(stream));
}

// The cluster launch at head dim D (256 < D <= kMaxCluster x 256) in
// float32 (bf16 = 0) or bfloat16: out = {CTAs a cluster, dynamic shared
// memory of a CTA in bytes, cudaOccupancyMaxActiveClusters}. Returns a
// CUDA error (0 on success), or -1 for a D that takes no cluster.
extern "C" int flash_tf32_cluster_info(int64_t D, int bf16, int* out) {
  using namespace flash_tf32;
  if (D <= 256 || D > 256 * kMaxCluster) return -1;
  return bf16 ? cluster_info_bf16(D, out) : cluster_info_f32(D, out);
}

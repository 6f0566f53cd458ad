// The cluster instances past head dim 256 (up to kMaxCluster x 256) of the
// TF32 flash forward (flash_fwd_tf32.cuh), in a source of its own so that
// the build compiles it beside the others.

#include "flash_fwd_tf32.cuh"

namespace flash_tf32 {

int cluster_f32(const void* q, const void* k, const void* v, void* o,
                float* lse, int* last, int64_t B, int64_t T_len, int64_t H,
                int64_t D, Strides sq, Strides sk, Strides sv, float scale,
                int causal, int mode, cudaStream_t st) {
  return launch_cluster<float>(q, k, v, o, lse, last, B, T_len, H, D, sq, sk,
                               sv, scale, causal, mode, st);
}

int cluster_bf16(const void* q, const void* k, const void* v, void* o,
                 float* lse, int* last, int64_t B, int64_t T_len, int64_t H,
                 int64_t D, Strides sq, Strides sk, Strides sv, float scale,
                 int causal, int mode, cudaStream_t st) {
  return launch_cluster<__nv_bfloat16>(q, k, v, o, lse, last, B, T_len, H, D,
                                       sq, sk, sv, scale, causal, mode, st);
}

int cluster_info_f32(int64_t D, int* out) {
  return cluster_info<float>(D, out);
}

int cluster_info_bf16(int64_t D, int* out) {
  return cluster_info<__nv_bfloat16>(D, out);
}

}  // namespace flash_tf32

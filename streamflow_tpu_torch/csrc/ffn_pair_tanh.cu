// K2's tanh-gelu instances (the kernels of ffn_pair.cuh with G = kTanh), a
// translation unit of their own so that nvcc builds the variants in
// parallel; the launchers that dispatch to them are in ffn_pair.cu.

#include "ffn_pair.cuh"

int sf::ffn_pair_launch_tanh(const FfnArgs& a, int dtype, cudaStream_t s) {
  return pair_launch<kTanh>(a, dtype, s);
}
int sf::ffn_gemm_launch_tanh(const void* a, const void* w,
                             const FfnGemmArgs& g, int dtype,
                             cudaStream_t s) {
  return gemm_launch<kTanh>(a, w, g, dtype, s);
}
int sf::ffn_prologue_launch_tanh(const void* x, const void* y,
                                 const void* db, void* out, int n, int c,
                                 int dtype, cudaStream_t s) {
  return prologue_launch<kTanh>(x, y, db, out, n, c, dtype, s);
}

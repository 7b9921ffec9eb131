// K2's launchers (kernels and design: ffn_pair.cuh). The erf instances
// build here; poly and tanh in ffn_pair_poly.cu and ffn_pair_tanh.cu.

#include "ffn_pair.cuh"

int sf::ffn_pair_launch_erf(const FfnArgs& a, int dtype, cudaStream_t s) {
  return pair_launch<kErf>(a, dtype, s);
}
int sf::ffn_gemm_launch_erf(const void* a, const void* w,
                            const FfnGemmArgs& g, int dtype, cudaStream_t s) {
  return gemm_launch<kErf>(a, w, g, dtype, s);
}
int sf::ffn_prologue_launch_erf(const void* x, const void* y, const void* db,
                                void* out, int n, int c, int dtype,
                                cudaStream_t s) {
  return prologue_launch<kErf>(x, y, db, out, n, c, dtype, s);
}


// The launchers take the gelu variant last before the stream (0 erf, 1
// poly, 2 tanh: common.cuh's Gelu); sf_ffn_pair keeps its erf-only
// signature beside sf_ffn_pair_v for tools that launch another checkout's
// K2 with this tree's argument types (tools/kernel_bench.py --other).

// C (n x N) = A (n x K) . W (N x K)^T + bias with the epilogue (act: gelu;
// res, kw/kb: the pair's residual and k1), bf16 (K a multiple of 8, N
// even) or f32
extern "C" int sf_ffn_gemm(const void* a, const void* w, const void* bias,
                           const void* res, const void* kw, const void* kb,
                           void* out, int n, int N, int K, int act, int dtype,
                           int gelu, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n == 0 || N == 0) return 0;
  const GemmArgs g{bias, res, kw, kb, out, n, N, K, act};
  switch (gelu) {
    case kErf: return ffn_gemm_launch_erf(a, w, g, dtype, s);
    case kPoly: return ffn_gemm_launch_poly(a, w, g, dtype, s);
    case kTanh: return ffn_gemm_launch_tanh(a, w, g, dtype, s);
  }
  return (int)cudaErrorInvalidValue;
}

// x' = gelu(x + y_dw + b_dw), rounded to the io type
extern "C" int sf_ffn_prologue(const void* x, const void* y, const void* db,
                               void* out, int n, int c, int dtype, int gelu,
                               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (gelu) {
    case kErf: return ffn_prologue_launch_erf(x, y, db, out, n, c, dtype, s);
    case kPoly: return ffn_prologue_launch_poly(x, y, db, out, n, c, dtype, s);
    case kTanh: return ffn_prologue_launch_tanh(x, y, db, out, n, c, dtype, s);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int sf_ffn_pair_v(const void* x, const void* yres, const void* db,
                             const void* ln_g, const void* ln_b,
                             const void* wp, const void* bp, const void* w1,
                             const void* b1, const void* w2, const void* b2,
                             const void* kw, const void* kb, void* out, int n,
                             int c, int ch, int co, int residual, int add_res,
                             int dtype, int gelu, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n == 0) return 0;
  if ((c | ch) & 1) return (int)cudaErrorInvalidValue;  // k pairs
  const Args a{x, yres, db, ln_g, ln_b, wp, bp, w1, b1, w2, b2, kw, kb, out,
               n, c, ch, co, residual, add_res};
  switch (gelu) {
    case kErf: return ffn_pair_launch_erf(a, dtype, s);
    case kPoly: return ffn_pair_launch_poly(a, dtype, s);
    case kTanh: return ffn_pair_launch_tanh(a, dtype, s);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int sf_ffn_pair(const void* x, const void* yres, const void* db,
                           const void* ln_g, const void* ln_b, const void* wp,
                           const void* bp, const void* w1, const void* b1,
                           const void* w2, const void* b2, const void* kw,
                           const void* kb, void* out, int n, int c, int ch,
                           int co, int residual, int add_res, int dtype,
                           void* stream) {
  return sf_ffn_pair_v(x, yres, db, ln_g, ln_b, wp, bp, w1, b1, w2, b2, kw,
                       kb, out, n, c, ch, co, residual, add_res, dtype, kErf,
                       stream);
}

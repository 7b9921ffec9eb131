// K2: fused FFN pair with optional edge stages, one row tile per block.
//
// Replaces the Pallas kernel streamflow_tpu/ops/pallas/_ffn_kernel.py
// (_ffn_pair_fwd -> pl.pallas_call) in its five forms:
//   ffn_pair_k1       y = k1(gelu(x + gelu(x W1 + b1) W2 + b2))
//   dwres_pw_ffn_pair x = gelu(x + y_dw + b_dw); x = gelu(x + x Wp + bp);
//                     y = gelu(x W1 + b1) W2 + b2
//   ln_ffn_pair       y = x + gelu(LN(x) W1 + b1) W2 + b2
//   ffn_pair          y = [gelu(x +)] gelu(x W1 + b1) W2 + b2
//   pw_ffn_pair       x = gelu(x + x Wp + bp); y = [gelu(x +)] pair(x)
// with k1(y) = gelu(y + y*kw + kb). Rounding to the io type happens exactly
// where ffn_pair_xla rounds (after each prologue stage and after the hidden
// gelu); all products accumulate in f32.
//
// Bound on the H100: the two (or three) GEMMs. The bf16 kernel runs them on
// the tensor cores (mma.sync m16n8k16, f32 accumulation; A fragments from
// shared memory by ldmatrix, B fragments straight from the L2-resident
// weights), so it is bound by re-reading the weights once per row tile
// and by the elementwise epilogues. The f32 kernel (used by f32 models
// only) runs the GEMMs on the CUDA cores. What the design does about HBM:
// the hidden activation (1.5x or 4x wide) and every prologue intermediate
// stay in shared memory; device memory sees one read of x (and y_dw) and
// one write of y.
//
// Layout: x (n, c) row-major; weights in nn.Linear layout (out, in), so a
// tensor-core B fragment's two k-neighbours are one 32-bit load.

#include "common.cuh"

using namespace sf;

namespace {

constexpr int NT = 256;  // threads per block (8 warps)
constexpr int NW = NT / 32;

struct Args {
  const void *x, *yres, *db, *ln_g, *ln_b, *wp, *bp, *w1, *b1, *w2, *b2,
      *kw, *kb;
  void* out;
  int n, c, ch, co, residual, add_res;
};

// ---------------------------------------------------------------- f32 path
constexpr int BM = 16;    // rows per block
constexpr int TNN = 128;  // threads along the output columns
constexpr int RM = 8;     // rows per thread (2 thread rows x 8 = BM)
constexpr int RN = 4;     // columns per thread per pass

__host__ __device__ inline int up4(int v) { return (v + 3) & ~3; }

// acc[i][j] = sum_k A[tm*RM + i][k] * W[n0 + tn + j*TNN][k]
__device__ __forceinline__ void mm_pass(const float* __restrict__ A, int lda,
                                        int K, const float* __restrict__ W,
                                        int N, int n0, int tm, int tn,
                                        float (&acc)[RM][RN]) {
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;
  const float* a0 = A + tm * RM * lda;
  const float* wrow[RN];
  bool ok[RN];
#pragma unroll
  for (int j = 0; j < RN; ++j) {
    int col = n0 + tn + j * TNN;
    ok[j] = col < N;
    wrow[j] = W + (size_t)(ok[j] ? col : 0) * K;
  }
  for (int k = 0; k < K; k += 4) {
    float w[4][RN];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int j = 0; j < RN; ++j)
        w[kk][j] = (ok[j] && k + kk < K) ? wrow[j][k + kk] : 0.f;
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      // lda is a multiple of 4 and the pad columns hold zeros
      float4 a = *reinterpret_cast<const float4*>(a0 + i * lda + k);
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        acc[i][j] = fmaf(a.x, w[0][j], acc[i][j]);
        acc[i][j] = fmaf(a.y, w[1][j], acc[i][j]);
        acc[i][j] = fmaf(a.z, w[2][j], acc[i][j]);
        acc[i][j] = fmaf(a.w, w[3][j], acc[i][j]);
      }
    }
  }
}

__global__ void __launch_bounds__(NT) ffn_pair_f32_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  const float *x = (const float*)a.x, *yres = (const float*)a.yres;
  const float *db = (const float*)a.db, *wp = (const float*)a.wp;
  const int n = a.n, c = a.c, ch = a.ch, co = a.co;
  const int ldc = up4(c), ldh = up4(ch);
  float* xa = smem;            // BM x ldc : x after the prologue stages
  float* xb = xa + BM * ldc;   // BM x ldc : pw-stage output
  float* hs = xb + BM * ldc;   // BM x ldh : hidden activation
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * BM;
  const int tm = tid / TNN, tn = tid % TNN;

  for (int e = tid; e < BM * ldc; e += NT) {
    int m = e / ldc, col = e % ldc, row = row0 + m;
    float v = 0.f;
    if (col < c && row < n) {
      v = x[(size_t)row * c + col];
      if (yres != nullptr)
        v = gelu(v + yres[(size_t)row * c + col] + db[col]);
    }
    xa[e] = v;
    xb[e] = 0.f;
  }
  for (int e = tid; e < BM * ldh; e += NT) hs[e] = 0.f;
  __syncthreads();

  if (a.ln_g != nullptr) {
    const float *g = (const float*)a.ln_g, *be = (const float*)a.ln_b;
    const int warp = tid / 32, lane = tid % 32;
    for (int m = warp; m < BM; m += NW) {
      float s = 0.f, ss = 0.f;
      for (int col = lane; col < c; col += 32) {
        float v = xa[m * ldc + col];
        s += v;
        ss += v * v;
      }
      s = warp_sum(s);
      ss = warp_sum(ss);
      float mean = s / c;
      float rstd = rsqrtf(ss / c - mean * mean + 1e-5f);
      for (int col = lane; col < c; col += 32)
        xa[m * ldc + col] = (xa[m * ldc + col] - mean) * rstd * g[col] +
                            be[col];
    }
    __syncthreads();
  }

  float acc[RM][RN];
  const float* xs = xa;
  if (wp != nullptr) {
    const float* bp = (const float*)a.bp;
    for (int n0 = 0; n0 < c; n0 += TNN * RN) {
      mm_pass(xa, ldc, c, wp, c, n0, tm, tn, acc);
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) {
          int m = tm * RM + i, col = n0 + tn + j * TNN;
          if (col < c)
            xb[m * ldc + col] = gelu(xa[m * ldc + col] + acc[i][j] + bp[col]);
        }
    }
    __syncthreads();
    xs = xb;
  }

  const float* b1 = (const float*)a.b1;
  for (int n0 = 0; n0 < ch; n0 += TNN * RN) {
    mm_pass(xs, ldc, c, (const float*)a.w1, ch, n0, tm, tn, acc);
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        int m = tm * RM + i, col = n0 + tn + j * TNN;
        if (col < ch) hs[m * ldh + col] = gelu(acc[i][j] + b1[col]);
      }
  }
  __syncthreads();

  const float *b2 = (const float*)a.b2, *kw = (const float*)a.kw,
              *kb = (const float*)a.kb;
  float* out = (float*)a.out;
  for (int n0 = 0; n0 < co; n0 += TNN * RN) {
    mm_pass(hs, ldh, ch, (const float*)a.w2, co, n0, tm, tn, acc);
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        int m = tm * RM + i, col = n0 + tn + j * TNN, row = row0 + m;
        if (col >= co || row >= n) continue;
        float y = acc[i][j] + b2[col];
        if (a.residual) y = gelu(xs[m * ldc + col] + y);
        if (kw != nullptr) y = gelu(y + y * kw[col] + kb[col]);
        if (a.add_res) y += x[(size_t)row * c + col];
        out[(size_t)row * co + col] = y;
      }
  }
}

// --------------------------------------------------------------- bf16 path
typedef __nv_bfloat16 bf16;

__host__ __device__ inline int up16(int v) { return (v + 15) & ~15; }
// shared-memory row stride (elements) of a bf16 tile with K columns: a
// multiple of 8 (16-byte ldmatrix rows) offset by 8 so that the 8 rows of
// one ldmatrix phase fall in distinct banks
__host__ __device__ inline int ld16(int k) { return up16(k) + 8; }

__device__ __forceinline__ uint32_t ld_pair(const bf16* w, bool ok) {
  return ok ? __ldg(reinterpret_cast<const unsigned int*>(w)) : 0u;
}

// B fragments of NJ n8 tiles at k (two 32-bit loads per tile, zero past
// N or K)
template <int NJ>
__device__ __forceinline__ void load_b(uint32_t (&b)[NJ][2],
                                       const bf16* const (&wrow)[NJ],
                                       const bool (&nok)[NJ], int k, int K) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    b[j][0] = ld_pair(wrow[j] + k, nok[j] && k < K);
    b[j][1] = ld_pair(wrow[j] + k + 8, nok[j] && k + 8 < K);
  }
}

// C[BM x N] = A[BM x K] (shared, stride lda) . W^T, W (N x K) in global
// memory; every warp takes (8 NJ)-column chunks and hands each finished
// value to epi(row, col, value). The next k step's B fragments are loaded
// before the current step's products, hiding part of the L2 latency. K is
// even (pairs of k load as one word).
template <int MT, int NJ, class Epi>
__device__ __forceinline__ void tc_gemm_nj(const bf16* A, int lda, int K,
                                           const bf16* __restrict__ W, int N,
                                           Epi& epi) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  for (int nc = warp * 8 * NJ; nc < N; nc += NW * 8 * NJ) {
    float acc[MT][NJ][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    const bf16* wrow[NJ];
    bool nok[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      int col = nc + j * 8 + g;
      nok[j] = col < N;
      wrow[j] = W + (size_t)(nok[j] ? col : 0) * K;
    }
    uint32_t bn[NJ][2];
    load_b<NJ>(bn, wrow, nok, 2 * t, K);
    for (int k0 = 0; k0 < K; k0 += 16) {
      uint32_t bc[NJ][2];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        bc[j][0] = bn[j][0];
        bc[j][1] = bn[j][1];
      }
      load_b<NJ>(bn, wrow, nok, k0 + 16 + 2 * t, K);
      uint32_t af[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        ldmatrix_x4(af[i], A + (i * 16 + (lane & 15)) * lda + k0 +
                               (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int i = 0; i < MT; ++i)
          mma_bf16(acc[i][j], af[i], bc[j][0], bc[j][1]);
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          int row = i * 16 + g + (e >> 1) * 8;
          int col = nc + j * 8 + 2 * t + (e & 1);
          if (col < N) epi(row, col, acc[i][j][e]);
        }
  }
}

// 32-column chunks for wide outputs, 16-column ones for narrow outputs so
// that all 8 warps get work
template <int MT, class Epi>
__device__ __forceinline__ void tc_gemm(const bf16* A, int lda, int K,
                                        const bf16* __restrict__ W, int N,
                                        Epi& epi) {
  if (N >= 8 * NW * 4)
    tc_gemm_nj<MT, 4>(A, lda, K, W, N, epi);
  else
    tc_gemm_nj<MT, 2>(A, lda, K, W, N, epi);
}

struct EpiPw {  // x' = gelu(x + x Wp + bp)
  const bf16 *xa, *bp;
  bf16* xb;
  int ld;
  __device__ void operator()(int r, int col, float v) const {
    xb[r * ld + col] = __float2bfloat16_rn(
        gelu(__bfloat162float(xa[r * ld + col]) + v + __bfloat162float(bp[col])));
  }
};

struct EpiHidden {  // h = gelu(x W1 + b1)
  const bf16* b1;
  bf16* hs;
  int ld;
  __device__ void operator()(int r, int col, float v) const {
    hs[r * ld + col] = __float2bfloat16_rn(gelu(v + __bfloat162float(b1[col])));
  }
};

struct EpiOut {  // y = h W2 + b2, then residual / k1 / add_res
  const bf16 *xs, *b2, *kw, *kb, *x;
  bf16* out;
  int ld, row0, n, c, co, residual, add_res;
  __device__ void operator()(int r, int col, float v) const {
    int row = row0 + r;
    if (row >= n) return;
    float y = v + __bfloat162float(b2[col]);
    if (residual) y = gelu(__bfloat162float(xs[r * ld + col]) + y);
    if (kw != nullptr)
      y = gelu(y + y * __bfloat162float(kw[col]) + __bfloat162float(kb[col]));
    if (add_res) y += __bfloat162float(x[(size_t)row * c + col]);
    out[(size_t)row * co + col] = __float2bfloat16_rn(y);
  }
};

template <int MT>
__global__ void __launch_bounds__(NT) ffn_pair_bf16_kernel(Args a) {
  constexpr int R = 16 * MT;  // rows per block
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const bf16 *x = (const bf16*)a.x, *yres = (const bf16*)a.yres;
  const bf16* db = (const bf16*)a.db;
  const int n = a.n, c = a.c, ch = a.ch;
  const int ldc = ld16(c), ldh = ld16(ch);
  const bool pw = a.wp != nullptr;
  // x tile R x ldc and hidden R x ldh; with the pw stage its output xb
  // (R x ldc) follows, and the hidden tile reuses x's space (x is dead once
  // the pw stage has run), so 64-row tiles fit at C = 640 as well
  bf16* xa = (bf16*)smem_raw;
  bf16* hs = pw ? xa : xa + R * ldc;
  bf16* xb = xa + R * (pw ? max(ldc, ldh) : ldc);
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * R;

  // x tile (+ dw-residual prologue); pad columns and rows are zero
  for (int e = tid; e < R * ldc; e += NT) {
    int m = e / ldc, col = e % ldc, row = row0 + m;
    float v = 0.f;
    if (col < c && row < n) {
      v = __bfloat162float(x[(size_t)row * c + col]);
      if (yres != nullptr)
        v = gelu(v + __bfloat162float(yres[(size_t)row * c + col]) +
                 __bfloat162float(db[col]));
    }
    xa[e] = __float2bfloat16_rn(v);
    if (pw) xb[e] = __float2bfloat16_rn(0.f);
  }
  if (!pw)
    for (int e = tid; e < R * ldh; e += NT) hs[e] = __float2bfloat16_rn(0.f);
  __syncthreads();

  if (a.ln_g != nullptr) {  // LayerNorm: f32 stats, E[x^2] - mean^2
    const bf16 *g = (const bf16*)a.ln_g, *be = (const bf16*)a.ln_b;
    const int warp = tid / 32, lane = tid % 32;
    for (int m = warp; m < R; m += NW) {
      float s = 0.f, ss = 0.f;
      for (int col = lane; col < c; col += 32) {
        float v = __bfloat162float(xa[m * ldc + col]);
        s += v;
        ss += v * v;
      }
      s = warp_sum(s);
      ss = warp_sum(ss);
      float mean = s / c;
      float rstd = rsqrtf(ss / c - mean * mean + 1e-5f);
      for (int col = lane; col < c; col += 32) {
        float v = __bfloat162float(xa[m * ldc + col]);
        xa[m * ldc + col] = __float2bfloat16_rn(
            (v - mean) * rstd * __bfloat162float(g[col]) +
            __bfloat162float(be[col]));
      }
    }
    __syncthreads();
  }

  const bf16* xs = xa;
  if (pw) {
    EpiPw epi{xa, (const bf16*)a.bp, xb, ldc};
    tc_gemm<MT>(xa, ldc, c, (const bf16*)a.wp, c, epi);
    __syncthreads();
    xs = xb;
    // the hidden GEMM's epilogue writes columns < ch; the ones GEMM2 reads
    // beyond them must be zero
    const int pad = up16(ch) - ch;
    for (int e = tid; e < R * pad; e += NT)
      hs[(e / pad) * ldh + ch + e % pad] = __float2bfloat16_rn(0.f);
  }
  {
    EpiHidden epi{(const bf16*)a.b1, hs, ldh};
    tc_gemm<MT>(xs, ldc, c, (const bf16*)a.w1, ch, epi);
  }
  __syncthreads();
  EpiOut epi{xs, (const bf16*)a.b2, (const bf16*)a.kw, (const bf16*)a.kb, x,
             (bf16*)a.out, ldc, row0, n, c, a.co, a.residual, a.add_res};
  tc_gemm<MT>(hs, ldh, ch, (const bf16*)a.w2, a.co, epi);
}

size_t bf16_smem(int mt, const Args& a) {
  int r = 16 * mt;
  int lc = ld16(a.c), lh = ld16(a.ch);
  return sizeof(bf16) * (size_t)r *
         (a.wp ? lc + (lc > lh ? lc : lh) : lc + lh);
}

template <int MT>
int launch_bf16(const Args& a, cudaStream_t s) {
  size_t smem = bf16_smem(MT, a);
  cudaError_t e = cudaFuncSetAttribute(
      ffn_pair_bf16_kernel<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  int grid = (a.n + 16 * MT - 1) / (16 * MT);
  ffn_pair_bf16_kernel<MT><<<grid, NT, smem, s>>>(a);
  return (int)cudaGetLastError();
}

int launch_f32(const Args& a, cudaStream_t s) {
  size_t smem = sizeof(float) * BM * (2 * up4(a.c) + up4(a.ch));
  cudaError_t e = cudaFuncSetAttribute(
      ffn_pair_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  int grid = (a.n + BM - 1) / BM;
  ffn_pair_f32_kernel<<<grid, NT, smem, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int sf_ffn_pair(const void* x, const void* yres, const void* db,
                           const void* ln_g, const void* ln_b, const void* wp,
                           const void* bp, const void* w1, const void* b1,
                           const void* w2, const void* b2, const void* kw,
                           const void* kb, void* out, int n, int c, int ch,
                           int co, int residual, int add_res, int dtype,
                           void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n == 0) return 0;
  if ((c | ch) & 1) return (int)cudaErrorInvalidValue;  // k pairs
  Args a{x, yres, db, ln_g, ln_b, wp, bp, w1, b1, w2, b2, kw, kb, out,
         n, c, ch, co, residual, add_res};
  if (dtype != sf::kBF16) return launch_f32(a, s);
  // 64-row tiles where they fit the 227 KB of shared memory, else 32
  if (bf16_smem(4, a) <= 232448) return launch_bf16<4>(a, s);
  return launch_bf16<2>(a, s);
}

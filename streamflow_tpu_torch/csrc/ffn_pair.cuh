// K2: fused FFN pair with optional edge stages, on row tiles of 64: its
// kernels, templates on the gelu variant (launchers: ffn_pair.cu).
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
// gelu); all products accumulate in f32. Every gelu of a launch is the
// variant its `gelu` argument names (JAX's static `gelu`: erf or poly; tanh
// for the gelu probe), a template argument of each kernel (common.cuh's
// gelu_v): the erf instances are the kernels as they were.
//
// Bound on the H100: the two (or three) GEMMs on the tensor cores (every
// main-path call is far above the card's 295 FLOP per byte of device
// memory), and in practice the weights' bytes from L2: every row tile
// reads all of them, 16 KB for each 64 x 128 x 64 product per consumer.
// bf16 design (Hopper): persistent blocks (one per SM) walk row tiles of
// 64 rows. A producer warpgroup's first thread streams every weight as TMA
// boxes (128 rows x 64 k, 128-byte swizzle) through a ring of up to 8
// stages, in the order the consumers use them, across all the tiles a
// block walks, so the next tile's weights load while this tile's epilogue
// runs; it hands its registers to the two consumer warpgroups (setmaxnreg
// 40 / 232: ptxas sizes a block of three warpgroups at 168). The two
// consumers share the tile and split the work by columns: each computes 64
// of every 128 pw-stage and hidden columns (wgmma from shared memory, the
// A tile against its half of the box) and 64 NBW of the pass's output
// columns (NBW <= 5, 160 f32 registers a thread: gru's 640 outputs in one
// pass). For each hidden chunk of 128 columns a consumer computes its half
// of h = gelu(x W1 + b1), rounds it to bf16 into its panel of the chunk's
// buffer (two buffers, so the next chunk's product overlaps this one's
// y += h W2), meets the other at a named barrier, and accumulates y += h
// W2 with wgmma over both panels: the hidden activation stays in shared
// memory, and only the f32 order of the sum over chunks differs from
// ffn_pair_xla. The x tile arrives by TMA (64-row boxes, zero past n and
// c) where no prologue rewrites it and its rows are whole 16-byte units;
// otherwise the consumers copy it in by cp.async (y_dw into the pw tile,
// free until the pw stage), then apply the prologue stages in place in f32
// and round. The pw stage's output goes into a tile beside x. The
// epilogue stages each 64-column block in shared memory and stores whole
// rows with 16-byte stores (8 or 4 bytes where co is not a multiple of
// 8). Shared memory (Plan): the x tile, 8 KB per 64 columns (80 KB at C =
// 640), the pw output beside it, 48 KB of hidden buffers and staging
// (inside x's space once the pw stage has run, where it fits), then the
// ring: 4 stages for gru's pw form, 6 for its first pair, 7-8 elsewhere.
// A consumer per 64 rows of a 128-row tile would hold 64 x 256 f32 of y
// and the hidden chunk, past what ptxas allots without spilling into the
// ~25 KB of L1 that shared memory leaves or serialising wgmmas (C7512).
// TMA needs rows of
// whole 16-byte units: the wrapper pads a weight whose input width is not
// a multiple of 8 (only convc1's 324 and 486) with zero columns, and the
// tensor maps read rows up8(in) long. Ragged row counts and widths read as
// zeros (TMA's out-of-bounds fill; the register loads zero past n and c)
// and are masked in the stores. The f32 kernel (used by f32 models only)
// runs the GEMMs on the CUDA cores, 16 rows per block.
//
// Wide path (ffn_pair_gemm_kernel, ffn_pair_gemm_f32_kernel,
// ffn_pair_prologue_kernel; the wrapper picks it where the fused plan
// cannot hold the widths: the UMT decoder's gru, 1920 -> 2880 -> 1920 /
// 384 with a 1920-wide pw stage, and joint flow head, 1152 -> 1728 ->
// 1152 / 6). There a 64-row x tile (240 KB at 1920 columns, twice that
// with the pw stage's output) no longer fits shared memory, nor y's f32
// accumulators a warpgroup's registers. The pair runs as its stages in
// separate launches, each intermediate rounded to the io type exactly
// where ffn_pair_xla rounds it and kept in device memory between them
// (the TPU kernel keeps the hidden activation in VMEM; at 5376 rows it is
// 31 MB of bf16, inside the 50 MB L2): [x = gelu(x + y_dw + b_dw), an
// elementwise launch], [x = gelu(x + x Wp + bp)], h = gelu(x W1 + b1),
// y = h W2 + b2 with the pair's epilogue ([gelu(x +)], [k1]). Each
// product is one launch of ffn_pair_gemm_kernel: C = A W^T + bias and an
// elementwise epilogue, a block per 128 x 128 output tile, the A and W
// boxes (128 rows x 64 k, 128-byte swizzle) streamed by TMA from a
// producer warp through a ring of four 32 KB stages, two consumer
// warpgroups of 64 rows each on m64n128k16 wgmma, the epilogue from the
// accumulators straight to device memory. Bound: the products (about 160
// GFLOP a gru call at 5376 rows; the intermediates add ~0.15 GB of
// traffic). f32: the same stages, the products on the CUDA cores (64 x 64
// tiles, 4 x 4 a thread).
//
// Layout: x (n, c) row-major; weights in nn.Linear layout (out, in), rows
// K-major as wgmma's B operand wants them.

#pragma once

#include "common.cuh"

namespace sf {

// a launch's arguments (the pair's), and the wide path's product's
struct FfnArgs {
  const void *x, *yres, *db, *ln_g, *ln_b, *wp, *bp, *w1, *b1, *w2, *b2,
      *kw, *kb;
  void* out;
  int n, c, ch, co, residual, add_res;
  int x_tma;  // bf16: x read by TMA (set by the launcher)
};

struct FfnGemmArgs {
  const void *bias, *res, *kw, *kb;  // res, kw/kb: or null
  void* out;
  int n, N, K, act;
};

// each gelu variant's launches, a translation unit each so that nvcc
// builds the variants in parallel: erf in ffn_pair.cu, poly in
// ffn_pair_poly.cu, tanh in ffn_pair_tanh.cu (dtype: common.cuh's DType)
int ffn_pair_launch_erf(const FfnArgs& a, int dtype, cudaStream_t s);
int ffn_gemm_launch_erf(const void* a, const void* w, const FfnGemmArgs& g,
                        int dtype, cudaStream_t s);
int ffn_prologue_launch_erf(const void* x, const void* y, const void* db,
                            void* out, int n, int c, int dtype,
                            cudaStream_t s);
int ffn_pair_launch_poly(const FfnArgs& a, int dtype, cudaStream_t s);
int ffn_gemm_launch_poly(const void* a, const void* w, const FfnGemmArgs& g,
                        int dtype, cudaStream_t s);
int ffn_prologue_launch_poly(const void* x, const void* y, const void* db,
                            void* out, int n, int c, int dtype,
                            cudaStream_t s);
int ffn_pair_launch_tanh(const FfnArgs& a, int dtype, cudaStream_t s);
int ffn_gemm_launch_tanh(const void* a, const void* w, const FfnGemmArgs& g,
                        int dtype, cudaStream_t s);
int ffn_prologue_launch_tanh(const void* x, const void* y, const void* db,
                            void* out, int n, int c, int dtype,
                            cudaStream_t s);

}  // namespace sf

using namespace sf;

// the kernels and their launches, templates on the gelu variant G; each
// translation unit instantiates its own
namespace {

constexpr int NT = 256;  // threads per block (8 warps)
constexpr int NW = NT / 32;

using Args = sf::FfnArgs;

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

template <int G>
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
        v = gelu_v<G>(v + yres[(size_t)row * c + col] + db[col]);
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
            xb[m * ldc + col] =
                gelu_v<G>(xa[m * ldc + col] + acc[i][j] + bp[col]);
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
        if (col < ch) hs[m * ldh + col] = gelu_v<G>(acc[i][j] + b1[col]);
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
        if (a.residual) y = gelu_v<G>(xs[m * ldc + col] + y);
        if (kw != nullptr) y = gelu_v<G>(y + y * kw[col] + kb[col]);
        if (a.add_res) y += x[(size_t)row * c + col];
        out[(size_t)row * co + col] = y;
      }
  }
}

// --------------------------------------------------------------- bf16 path
typedef __nv_bfloat16 bf16;

constexpr int STAGE = 16384;   // a weight box: 128 rows x 64 k
constexpr int PANEL = 8192;    // 64 rows x 64 columns of a row tile
constexpr int HC = 128;        // hidden columns per chunk, 64 per consumer
constexpr int MAXB = 5;        // output blocks per consumer and pass, at most
constexpr int SMEM_MAX = 232448;

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// 64-column output blocks each consumer accumulates in one pass over the
// hidden chunks (its 64 x 64 NBW f32 in registers); a pass covers 2 NBW
// blocks, split between the two consumers; wider outputs take passes of
// equal width, each recomputing h (none on the main path: 640 is 2 x 5)
__host__ __device__ inline int wg_blocks(int co) {
  const int blocks = cdiv(co, 64), passes = cdiv(blocks, 2 * MAXB);
  return cdiv(cdiv(blocks, passes), 2);
}

// Shared memory of the bf16 kernel, byte offsets from the 1024-aligned
// base: the x tile (XP panels of 64 columns, zero past n and c), with the
// pw stage its output beside it; two hidden-chunk buffers of two panels
// and one staging panel per consumer (inside x's space once the pw stage
// has run, where it is large enough); the ring of weight stages; the
// mbarriers (two per stage, one for the x tile).
struct Plan {
  int xp, x_off, xb_off, h_off, stg_off, st_off, bar_off, ns, bytes;
};

Plan make_plan(int c, bool pw) {
  Plan p;
  p.xp = cdiv(c, 64);
  const int xbytes = p.xp * PANEL, aux = 6 * PANEL;
  p.x_off = 0;
  int off = xbytes;
  p.xb_off = off;
  if (pw) off += xbytes;
  if (pw && xbytes >= aux) {
    p.h_off = 0;
  } else {
    p.h_off = off;
    off += aux;
  }
  p.stg_off = p.h_off + 4 * PANEL;
  p.st_off = off;
  const int room = SMEM_MAX - 1024 - 256 - off;
  p.ns = room < 0 ? 0 : (room / STAGE < 8 ? room / STAGE : 8);
  p.bar_off = off + p.ns * STAGE;
  p.bytes = p.bar_off + 16 * p.ns + 16 + 1024;
  return p;
}

// byte offset of element (r, k) in a K-major tile of 64-row, 64-column
// panels, 128-byte swizzle (the layout TMA writes and wgmma reads)
__device__ __forceinline__ int swz(int r, int k) {
  return (k >> 6) * PANEL + r * 128 + ((((k >> 3) & 7) ^ (r & 7)) << 4) +
         ((k & 7) << 1);
}

__device__ __forceinline__ uint64_t desc128(const void* p) {
  return wgmma_desc(p, 16, 1024, 1);
}

// V consecutive bf16 (V = 8, 4 or 2) as V/2 words, to and from shared
// memory (within one 16-byte unit of the swizzled tile)
template <int V>
__device__ __forceinline__ void ld_words(uint32_t (&w)[V / 2],
                                         const uint8_t* p) {
  if constexpr (V == 8) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
  } else if constexpr (V == 4) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w[0] = v.x, w[1] = v.y;
  } else {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  }
}
template <int V>
__device__ __forceinline__ void st_words(uint8_t* p,
                                         const uint32_t (&w)[V / 2]) {
  if constexpr (V == 8)
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  else if constexpr (V == 4)
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  else
    *reinterpret_cast<uint32_t*>(p) = w[0];
}
__device__ __forceinline__ float2 unpack_bf16(uint32_t w) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&w));
}

// The x tile's 64 rows from r0 where TMA cannot take them (a prologue
// stage, or rows not of whole 16-byte units): V-element cp.async granules
// by the consumers' 256 threads, zero past n and c; yres, where given, into
// the pw tile ys (free until the pw stage) at the same offsets.
template <int V>
__device__ void copy_x(uint8_t* xs, uint8_t* ys, const Args& a, int r0,
                       int kpad, int t) {
  const bf16 *x = (const bf16*)a.x, *yres = (const bf16*)a.yres;
  const int c = a.c, gpr = kpad / V;
  for (int e = t; e < 64 * gpr; e += 256) {
    const int r = e / gpr, k = (e - r * gpr) * V, o = swz(r, k);
    if (r0 + r < a.n && k < c) {
      cp_async<2 * V>(xs + o, x + (size_t)(r0 + r) * c + k);
      if (yres != nullptr)
        cp_async<2 * V>(ys + o, yres + (size_t)(r0 + r) * c + k);
    } else {
      const uint32_t z[V / 2] = {};
      st_words<V>(xs + o, z);
    }
  }
}

// The prologue stages in place on the copied tile: gelu(x + yres + db) or
// LayerNorm (f32 stats, E[x^2] - mean^2), each rounded to bf16. Consumer
// warp w8 (0..7) takes rows w8, w8 + 8, ...; a lane V columns at a time.
template <int G, int V>
__device__ void prologue_x(uint8_t* xs, const uint8_t* ys, const Args& a,
                           int r0, int w8, int lane) {
  const bf16 *db = (const bf16*)a.db, *lg = (const bf16*)a.ln_g,
             *lb = (const bf16*)a.ln_b;
  const int c = a.c;
  for (int rr = w8; rr < 64; rr += 8) {
    if (r0 + rr >= a.n) continue;
    float s = 0.f, ss = 0.f;
    for (int k = lane * V; k < c; k += 32 * V) {
      uint32_t w[V / 2], y[V / 2];
      ld_words<V>(w, xs + swz(rr, k));
      if (a.yres != nullptr) ld_words<V>(y, ys + swz(rr, k));
#pragma unroll
      for (int e = 0; e < V / 2; ++e) {
        float2 f = unpack_bf16(w[e]);
        if (a.yres != nullptr) {
          const float2 yv = unpack_bf16(y[e]);
          w[e] = pack_bf16(gelu_v<G>(f.x + yv.x + to_f(db[k + 2 * e])),
                           gelu_v<G>(f.y + yv.y + to_f(db[k + 2 * e + 1])));
          f = unpack_bf16(w[e]);
        }
        s += f.x + f.y;
        ss += f.x * f.x + f.y * f.y;
      }
      if (a.yres != nullptr) st_words<V>(xs + swz(rr, k), w);
    }
    if (lg == nullptr) continue;
    s = warp_sum(s);
    ss = warp_sum(ss);
    const float mean = s / c;
    const float rstd = rsqrtf(ss / c - mean * mean + 1e-5f);
    for (int k = lane * V; k < c; k += 32 * V) {
      uint32_t w[V / 2];
      ld_words<V>(w, xs + swz(rr, k));
#pragma unroll
      for (int e = 0; e < V / 2; ++e) {
        const float2 f = unpack_bf16(w[e]);
        const int i = k + 2 * e;
        w[e] = pack_bf16((f.x - mean) * rstd * to_f(lg[i]) + to_f(lb[i]),
                         (f.y - mean) * rstd * to_f(lg[i + 1]) +
                             to_f(lb[i + 1]));
      }
      st_words<V>(xs + swz(rr, k), w);
    }
  }
}

// rows [0, 64) x columns [0, ncols) of a staging panel to out at rows
// r0.., columns c0.. (row stride co), V columns per store, by the
// warpgroup's 128 threads
template <int V>
__device__ void store_block(bf16* out, const uint8_t* sg, int r0, int n,
                            int co, int c0, int ncols, int tid) {
  const int vpr = ncols / V;
  for (int e = tid; e < 64 * vpr; e += 128) {
    const int r = e / vpr, k = (e % vpr) * V;
    if (r0 + r < n) {
      uint32_t w[V / 2];
#pragma unroll
      for (int i = 0; i < V / 2; ++i)
        w[i] = *reinterpret_cast<const uint32_t*>(sg + swz(r, k + 2 * i));
      st_words<V>(reinterpret_cast<uint8_t*>(out + (size_t)(r0 + r) * co +
                                             c0 + k),
                  w);
    }
  }
}

__device__ __forceinline__ float ld_bf(const bf16* p, int i, bool ok) {
  return ok ? __bfloat162float(p[i]) : 0.f;
}

// NBW: 64-column output blocks per consumer and pass. Two consumer
// warpgroups share each 64-row tile: each computes half of every 128-wide
// chunk (the pw stage's and the hidden activation's) and half of the
// output blocks; a third warpgroup produces (its first thread streams the
// weights) and hands its registers to them.
template <int G, int NBW>
__global__ void __launch_bounds__(384, 1)
    ffn_pair_tc_kernel(const __grid_constant__ CUtensorMap tw1,
                       const __grid_constant__ CUtensorMap tw2,
                       const __grid_constant__ CUtensorMap twp,
                       const __grid_constant__ CUtensorMap tx, const Args a,
                       const Plan pl) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* xs = sm + pl.x_off;
  uint8_t* xbs = sm + pl.xb_off;
  uint8_t* hs = sm + pl.h_off;
  uint8_t* st = sm + pl.st_off;
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + pl.bar_off);
  uint64_t* empty = full + pl.ns;
  uint64_t* xbar = empty + pl.ns;
  const bool pw = a.wp != nullptr;
  const int c = a.c, ch = a.ch, co = a.co, ns = pl.ns;
  const int ntiles = cdiv(a.n, 64);
  const int kpc = pl.xp;               // 64-wide k panels of x
  const int nqc = cdiv(c, 128);        // pw output chunks
  const int nchunk = cdiv(ch, HC);
  const int npass = cdiv(co, 128 * NBW);

  if (threadIdx.x == 0) {
    for (int s = 0; s < ns; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);
    }
    mbar_init(xbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  // the warpgroup index, known warp-uniform to the compiler (ptxas C7520)
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 2) {
    regs_dealloc<40>();
    // producer: one thread streams every weight box, in the consumers'
    // order, through the ring, for all the tiles the block walks
    if (threadIdx.x == 256) {
      int it = 0;
      auto load = [&](const CUtensorMap* m, int k0, int n0) {
        const int s = it % ns;
        mbar_wait(&empty[s], ((it / ns) & 1) ^ 1);
        mbar_expect_tx(&full[s], STAGE);
        tma_load_2d(st + s * STAGE, m, &full[s], k0, n0);
        ++it;
      };
      for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
        if (pw)
          for (int q = 0; q < nqc; ++q)
            for (int kp = 0; kp < kpc; ++kp) load(&twp, 64 * kp, 128 * q);
        for (int ps = 0; ps < npass; ++ps) {
          const int col0 = ps * 128 * NBW;
          const int nbox = cdiv(min(128 * NBW, co - col0), 128);
          for (int j = 0; j < nchunk; ++j) {
            for (int kp = 0; kp < kpc; ++kp) load(&tw1, 64 * kp, HC * j);
            for (int kk = 0; kk < 2; ++kk)
              if (HC * j + 64 * kk < ch)
                for (int i = 0; i < nbox; ++i)
                  load(&tw2, HC * j + 64 * kk, col0 + 128 * i);
          }
        }
      }
    }
    return;
  }
  regs_alloc<232>();

  const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int tid = threadIdx.x % 128;
  int it = 0, held = -1;  // ring position; stage whose wgmmas may be in flight
  auto acquire = [&]() {
    const int s = it % ns;
    mbar_wait(&full[s], (it / ns) & 1);
    return st + s * STAGE;
  };
  // after a stage's wgmmas are committed: wait for the previous stage's
  // group and hand that stage back to the producer
  auto release_prev = [&]() {
    wgmma_wait<1>();
    if (held >= 0) mbar_arrive(&empty[held]);
    held = it % ns;
    ++it;
  };
  auto drain = [&]() {
    wgmma_wait<0>();
    if (held >= 0) mbar_arrive(&empty[held]);
    held = -1;
  };
  // D (64 x 64) = the A tile (64 x c) . this warpgroup's half (rows
  // 64 wg..) of each 128-row box^T, over the kpc k panels
  auto gemm_half = [&](float (&d)[32], const uint8_t* A) {
    for (int kp = 0; kp < kpc; ++kp) {
      const uint8_t* b = acquire();
      const int ks = min(4, cdiv(c - 64 * kp, 16));
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (kk >= ks) break;
        wgmma_ss_n64(d, desc128(A + kp * PANEL + kk * 32),
                     desc128(b + wg * 8192 + kk * 32), kp > 0 || kk > 0);
      }
      wgmma_commit();
      release_prev();
    }
    drain();
    fence_regs(d);
  };
  auto allbar = [&]() { bar_sync(1, 256); };
  auto wgbar = [&]() { bar_sync(2 + wg, 128); };

  const int vx = c % 8 == 0 ? 8 : (c % 4 == 0 ? 4 : 2);
  const int vo = co % 8 == 0 ? 8 : (co % 4 == 0 ? 4 : 2);
  const bf16 *b1 = (const bf16*)a.b1, *b2 = (const bf16*)a.b2,
             *bp = (const bf16*)a.bp, *kw = (const bf16*)a.kw,
             *kb = (const bf16*)a.kb, *x = (const bf16*)a.x;
  uint8_t* sg = sm + pl.stg_off + wg * PANEL;  // this consumer's staging
  int xphase = 0;

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int r0 = tile * 64;
    allbar();  // the last tile's readers of x, h and the staging are done
    if (a.x_tma) {
      if (threadIdx.x == 0) {
        fence_async_smem();
        mbar_expect_tx(xbar, kpc * PANEL);
        for (int kp = 0; kp < kpc; ++kp)
          tma_load_2d(xs + kp * PANEL, &tx, xbar, 64 * kp, r0);
      }
      mbar_wait(xbar, xphase);
      xphase ^= 1;
    } else {
      if (vx == 8)
        copy_x<8>(xs, xbs, a, r0, kpc * 64, threadIdx.x);
      else if (vx == 4)
        copy_x<4>(xs, xbs, a, r0, kpc * 64, threadIdx.x);
      else
        copy_x<2>(xs, xbs, a, r0, kpc * 64, threadIdx.x);
      cp_async_wait_all();
      allbar();
      if (a.yres != nullptr || a.ln_g != nullptr) {
        if (vx == 8)
          prologue_x<G, 8>(xs, xbs, a, r0, 4 * wg + warp, lane);
        else if (vx == 4)
          prologue_x<G, 4>(xs, xbs, a, r0, 4 * wg + warp, lane);
        else
          prologue_x<G, 2>(xs, xbs, a, r0, 4 * wg + warp, lane);
      }
      fence_async_smem();
      allbar();
    }

    const uint8_t* A = xs;
    if (pw) {  // x' = gelu_v<G>(x + x Wp + bp), 64 of each 128 columns each
      for (int q = 0; q < nqc; ++q) {
        float d[32];
        gemm_half(d, xs);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int row = warp * 16 + g + 8 * r;
            const int col = 128 * q + 64 * wg + 8 * i + 2 * t;
            if (col >= 64 * kpc) continue;   // past the tile's panels
            float v[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int cc = col + e;
              v[e] = cc < c ? gelu_v<G>(to_f(*reinterpret_cast<const bf16*>(
                                       xs + swz(row, cc))) +
                                   d[4 * i + 2 * r + e] + to_f(bp[cc]))
                            : 0.f;
            }
            *reinterpret_cast<uint32_t*>(xbs + swz(row, col)) =
                pack_bf16(v[0], v[1]);
          }
      }
      fence_async_smem();
      allbar();
      A = xbs;
    }

    for (int ps = 0; ps < npass; ++ps) {
      const int col0 = ps * 128 * NBW;
      const int nbox = cdiv(min(128 * NBW, co - col0), 128);
      float y[NBW][32];
#pragma unroll
      for (int b = 0; b < NBW; ++b)
#pragma unroll
        for (int i = 0; i < 32; ++i) y[b][i] = 0.f;
      for (int j = 0; j < nchunk; ++j) {
        // h = gelu_v<G>(x W1 + b1): this consumer's 64 of the chunk's 128
        // hidden columns, rounded into its panel of the chunk's buffer
        uint8_t* hb = hs + (j & 1) * 2 * PANEL;
        {
          float d[32];
          gemm_half(d, A);
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int row = warp * 16 + g + 8 * r;
              const int kc = 64 * wg + 8 * i + 2 * t;
              const int hid = HC * j + kc;
              *reinterpret_cast<uint32_t*>(hb + swz(row, kc)) = pack_bf16(
                  gelu_v<G>(d[4 * i + 2 * r] + ld_bf(b1, hid, hid < ch)),
                  gelu_v<G>(d[4 * i + 2 * r + 1] +
                       ld_bf(b1, hid + 1, hid + 1 < ch)));
            }
        }
        fence_async_smem();
        allbar();  // both halves of the chunk are in place
        // y += h W2: the chunk's two 64-wide k panels, each against the
        // pass's boxes of 128 output rows; block gb = NBW wg + b of the
        // pass lies in box gb / 2, half gb % 2
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          if (HC * j + 64 * kk >= ch) break;
          for (int i = 0; i < nbox; ++i) {
            const uint8_t* b = acquire();
            wgmma_fence();
#pragma unroll
            for (int bb = 0; bb < NBW; ++bb) {
              const int gb = NBW * wg + bb;
              if (gb / 2 != i) continue;
#pragma unroll
              for (int k16 = 0; k16 < 4; ++k16)
                wgmma_ss_n64(y[bb], desc128(hb + kk * PANEL + k16 * 32),
                             desc128(b + (gb & 1) * 8192 + k16 * 32), 1);
            }
            wgmma_commit();
            release_prev();
          }
        }
      }
      drain();
#pragma unroll
      for (int b = 0; b < NBW; ++b) fence_regs(y[b]);

      // epilogue: + b2, [gelu_v<G>(x +)], [k1], [+ x]; staged, stored as rows
#pragma unroll
      for (int bb = 0; bb < NBW; ++bb) {
        const int c0 = col0 + 64 * (NBW * wg + bb);
        if (c0 >= co) break;
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int row = warp * 16 + g + 8 * r;
            const int kc = 8 * i + 2 * t;
            float v[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int col = c0 + kc + e;
              const bool ok = col < co;
              float yv = y[bb][4 * i + 2 * r + e] + ld_bf(b2, col, ok);
              if (a.residual && ok)
                yv = gelu_v<G>(
                    to_f(*reinterpret_cast<const bf16*>(A + swz(row, col))) +
                    yv);
              if (kw != nullptr)
                yv = gelu_v<G>(yv + yv * ld_bf(kw, col, ok) +
                               ld_bf(kb, col, ok));
              if (a.add_res && ok && r0 + row < a.n)
                yv += to_f(x[(size_t)(r0 + row) * c + col]);
              v[e] = yv;
            }
            *reinterpret_cast<uint32_t*>(sg + swz(row, kc)) =
                pack_bf16(v[0], v[1]);
          }
        wgbar();
        const int ncols = min(64, co - c0);
        if (vo == 8)
          store_block<8>((bf16*)a.out, sg, r0, a.n, co, c0, ncols, tid);
        else if (vo == 4)
          store_block<4>((bf16*)a.out, sg, r0, a.n, co, c0, ncols, tid);
        else
          store_block<2>((bf16*)a.out, sg, r0, a.n, co, c0, ncols, tid);
        wgbar();
      }
    }
  }
}

// rows of each weight (nn.Linear layout, (out, in)) are up8(in) long: the
// wrapper pads a row that is not a whole number of 16 bytes
inline int up8(int v) { return (v + 7) & ~7; }

template <int G, int NBW>
int launch_tc(const Args& a, const Plan& pl, cudaStream_t s) {
  CUtensorMap tw1, tw2, twp, tx;
  const uint64_t d1[2] = {(uint64_t)up8(a.c), (uint64_t)a.ch};
  const uint64_t d2[2] = {(uint64_t)up8(a.ch), (uint64_t)a.co};
  const uint64_t dp[2] = {(uint64_t)up8(a.c), (uint64_t)a.c};
  const uint64_t dx[2] = {(uint64_t)a.c, (uint64_t)a.n};
  const uint32_t box[2] = {64, 128}, boxx[2] = {64, 64};
  if (!tensor_map(&tw1, a.w1, 2, d1, box) ||
      !tensor_map(&tw2, a.w2, 2, d2, box) ||
      (a.wp != nullptr && !tensor_map(&twp, a.wp, 2, dp, box)) ||
      (a.x_tma && !tensor_map(&tx, a.x, 2, dx, boxx)))
    return (int)cudaErrorInvalidValue;
  if (a.wp == nullptr) twp = tw1;  // never read
  if (!a.x_tma) tx = tw1;          // never read
  auto kernel = ffn_pair_tc_kernel<G, NBW>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, pl.bytes);
  if (e != cudaSuccess) return (int)e;
  int dev, sms;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return (int)e;
  const int ntiles = cdiv(a.n, 64);
  kernel<<<ntiles < sms ? ntiles : sms, 384, pl.bytes, s>>>(tw1, tw2, twp,
                                                            tx, a, pl);
  return (int)cudaGetLastError();
}

template <int G>
int launch_bf16(Args a, cudaStream_t s) {
  if (encoder() == nullptr) return (int)cudaErrorNotSupported;
  const Plan pl = make_plan(a.c, a.wp != nullptr);
  // y_dw is staged in the pw tile
  if (pl.ns < 2 || a.co > 640 || (a.yres != nullptr && a.wp == nullptr))
    return (int)cudaErrorInvalidValue;
  // x straight from TMA where no prologue stage rewrites it and its rows
  // are whole 16-byte units
  a.x_tma = a.yres == nullptr && a.ln_g == nullptr && a.c % 8 == 0;
  switch (wg_blocks(a.co)) {
    case 1: return launch_tc<G, 1>(a, pl, s);
    case 2: return launch_tc<G, 2>(a, pl, s);
    case 3: return launch_tc<G, 3>(a, pl, s);
    case 4: return launch_tc<G, 4>(a, pl, s);
    case 5: return launch_tc<G, 5>(a, pl, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <int G>
int launch_f32(const Args& a, cudaStream_t s) {
  size_t smem = sizeof(float) * BM * (2 * up4(a.c) + up4(a.ch));
  cudaError_t e = cudaFuncSetAttribute(
      ffn_pair_f32_kernel<G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  int grid = (a.n + BM - 1) / BM;
  ffn_pair_f32_kernel<G><<<grid, NT, smem, s>>>(a);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------- wide path
using GemmArgs = sf::FfnGemmArgs;

// the elementwise epilogue of one output: + bias, [gelu], [gelu(res +)],
// [k1], in f32
template <int G, typename T>
__device__ __forceinline__ float gemm_epilogue(float v, const GemmArgs& g,
                                               int row, int col) {
  const size_t at = (size_t)row * g.N + col;
  v += to_f(((const T*)g.bias)[col]);
  if (g.act) v = gelu_v<G>(v);
  if (g.res != nullptr) v = gelu_v<G>(to_f(((const T*)g.res)[at]) + v);
  if (g.kw != nullptr)
    v = gelu_v<G>(v + v * to_f(((const T*)g.kw)[col]) +
             to_f(((const T*)g.kb)[col]));
  return v;
}

constexpr int GM = 128, GN = 128, GK = 64;  // output tile, k panel
constexpr int G_NS = 4;                     // ring stages
constexpr int G_ABYTES = GM * GK * 2;       // A box (16 KB)
constexpr int G_STAGE = G_ABYTES + GN * GK * 2;
constexpr int G_SMEM = G_NS * G_STAGE + 2 * G_NS * 8 + 1024;

template <int G>
__global__ void __launch_bounds__(288, 1)
    ffn_pair_gemm_kernel(const __grid_constant__ CUtensorMap ta,
                         const __grid_constant__ CUtensorMap tw,
                         const GemmArgs g) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + G_NS * G_STAGE);
  uint64_t* empty = full + G_NS;
  const int m0 = blockIdx.y * GM, n0 = blockIdx.x * GN;
  const int nk = cdiv(g.K, GK);
  if (threadIdx.x == 0) {
    for (int s = 0; s < G_NS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 2) {
    // producer: one thread streams the k panels of A and W
    if (threadIdx.x == 256)
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % G_NS;
        mbar_wait(&empty[s], ((kt / G_NS) & 1) ^ 1);
        mbar_expect_tx(&full[s], G_STAGE);
        uint8_t* st = sm + s * G_STAGE;
        tma_load_2d(st, &ta, &full[s], kt * GK, m0);
        tma_load_2d(st + G_ABYTES, &tw, &full[s], kt * GK, n0);
      }
    return;
  }

  // consumers: warpgroup wg owns rows m0 + 64 wg .. + 63 of the tile
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  int prev = -1;
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % G_NS;
    mbar_wait(&full[s], (kt / G_NS) & 1);
    const uint8_t* st = sm + s * G_STAGE;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < GK / 16; ++kk)
      wgmma_ss_n128(acc, desc128(st + wg * 8192 + kk * 32),
                    desc128(st + G_ABYTES + kk * 32), kt > 0 || kk > 0);
    wgmma_commit();
    if (prev >= 0) {
      wgmma_wait<1>();
      mbar_arrive(&empty[prev]);
    }
    prev = s;
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // acc[4i + e]: row g + 8 (e / 2) of the warp's 16, column 8i + 2t + e % 2
  const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const int gq = lane >> 2, t = lane & 3;
  bf16* out = (bf16*)g.out;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = m0 + wg * 64 + warp * 16 + gq + 8 * r;
    if (row >= g.n) continue;
#pragma unroll
    for (int i = 0; i < GN / 8; ++i) {
      const int col = n0 + 8 * i + 2 * t;  // N is even: col + 1 < N too
      if (col >= g.N) continue;
      *reinterpret_cast<uint32_t*>(out + (size_t)row * g.N + col) =
          pack_bf16(gemm_epilogue<G, bf16>(acc[4 * i + 2 * r], g, row, col),
                    gemm_epilogue<G, bf16>(acc[4 * i + 2 * r + 1], g, row,
                                        col + 1));
    }
  }
}

constexpr int FM = 64, FN = 64, FK = 16;  // f32: tile rows, columns, k
static_assert(FM == FN, "one loop stages the A and W tiles");

template <int G>
__global__ void __launch_bounds__(256)
    ffn_pair_gemm_f32_kernel(const float* __restrict__ A,
                             const float* __restrict__ Wt, const GemmArgs g) {
  __shared__ float as[FK][FM + 4], ws[FK][FN + 4];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * FM, n0 = blockIdx.x * FN;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < g.K; k0 += FK) {
    for (int e = tid; e < FM * FK; e += 256) {
      const int r = e / FK, kk = e % FK;
      as[kk][r] = (m0 + r < g.n && k0 + kk < g.K)
                      ? A[(size_t)(m0 + r) * g.K + k0 + kk] : 0.f;
      ws[kk][r] = (n0 + r < g.N && k0 + kk < g.K)
                      ? Wt[(size_t)(n0 + r) * g.K + k0 + kk] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = as[kk][ty * 4 + i];
        b[i] = ws[kk][tx * 4 + i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* out = (float*)g.out;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = m0 + ty * 4 + i, col = n0 + tx * 4 + j;
      if (row < g.n && col < g.N)
        out[(size_t)row * g.N + col] =
            gemm_epilogue<G, float>(acc[i][j], g, row, col);
    }
}

// x' = gelu(x + y_dw + b_dw), rounded to the io type
template <int G, typename T>
__global__ void ffn_pair_prologue_kernel(const T* __restrict__ x,
                                         const T* __restrict__ y,
                                         const T* __restrict__ db,
                                         T* __restrict__ out, size_t total,
                                         int c) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x)
    out[i] = from_f<T>(gelu_v<G>(to_f(x[i]) + to_f(y[i]) + to_f(db[i % c])));
}

// the product of the wide path for gelu variant G
template <int G>
int gemm_launch(const void* a, const void* w, const GemmArgs& g, int dtype,
                cudaStream_t s) {
  const int n = g.n, N = g.N, K = g.K;
  if (dtype != sf::kBF16) {
    ffn_pair_gemm_f32_kernel<G><<<dim3(cdiv(N, FN), cdiv(n, FM)), 256, 0, s>>>(
        (const float*)a, (const float*)w, g);
    return (int)cudaGetLastError();
  }
  if (K % 8 || N % 2 || K == 0) return (int)cudaErrorInvalidValue;
  if (encoder() == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap ta, tw;
  const uint64_t da[2] = {(uint64_t)K, (uint64_t)n};
  const uint64_t dw[2] = {(uint64_t)K, (uint64_t)N};
  const uint32_t box[2] = {GK, GM};
  if (!tensor_map(&ta, a, 2, da, box) || !tensor_map(&tw, w, 2, dw, box))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      ffn_pair_gemm_kernel<G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      G_SMEM);
  if (e != cudaSuccess) return (int)e;
  ffn_pair_gemm_kernel<G><<<dim3(cdiv(N, GN), cdiv(n, GM)), 288, G_SMEM, s>>>(
      ta, tw, g);
  return (int)cudaGetLastError();
}

template <int G>
int prologue_launch(const void* x, const void* y, const void* db, void* out,
                    int n, int c, int dtype, cudaStream_t s) {
  const size_t total = (size_t)n * c;
  if (total == 0) return 0;
  const int grid = (int)((total + 255) / 256 < 8192 ? (total + 255) / 256
                                                    : 8192);
  if (dtype == sf::kBF16)
    ffn_pair_prologue_kernel<G, bf16><<<grid, 256, 0, s>>>(
        (const bf16*)x, (const bf16*)y, (const bf16*)db, (bf16*)out, total,
        c);
  else
    ffn_pair_prologue_kernel<G, float><<<grid, 256, 0, s>>>(
        (const float*)x, (const float*)y, (const float*)db, (float*)out,
        total, c);
  return (int)cudaGetLastError();
}

template <int G>
int pair_launch(const Args& a, int dtype, cudaStream_t s) {
  return dtype != sf::kBF16 ? launch_f32<G>(a, s) : launch_bf16<G>(a, s);
}

}  // namespace

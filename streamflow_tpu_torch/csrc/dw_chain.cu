// K5: the SK block's depthwise chain in one kernel (B8).
//
// Replaces the Pallas kernel streamflow_tpu/ops/pallas/_dw_conv_kernel.py
// (_dw_chain_fwd -> pl.pallas_call, body _kernel). For ks = (1,)*n1 + (k,),
// x (B, H, W, C) NHWC:
//   A   = io(g_n1(... g_1(x)))           g_i(v) = gelu(v (1 + w_i) + b_i)
//   out = io(gelu(A + dwconv_k(A) + b_k))   SAME zero padding of A
// with the k=1 stages, the products, the sums and the gelu in f32, and A
// rounded once to the io type, where the Pallas kernel rounds. The halo of
// A is zero (not g(0)): padding applies after the k=1 stages.
//
// bf16 runs on the tensor cores: the engine of sk_chain.cuh under its kK5
// policy (a block per (image, 32 x 32 outputs, 8 channels), the haloed
// NHWC box by cp.async, the k=1 stages once per box pixel into the ldmatrix
// planes of the banded product, mma.sync, the residual and gelu in the
// epilogue). The products are bf16 x bf16, exact in f32; only the order of
// the f32 sums differs from the f32 body below.
//
// f32 runs on the CUDA cores, bound by their f32 FMA rate (2 k^2 B H W C
// FLOP / 67 TFLOP/s = 46 us for the 15x15 stage of (3, 55, 128, 324)):
// one block of 256 threads per (image, 8 x 32 output tile, group of
// 32 channels). The block stages the haloed tile of A, (8 + 2r) x (32 + 2r)
// positions x 32 channels, in shared memory, computing the
// k=1 stages while it loads x (eight loads in flight per thread: the build
// is bound by the latency of its loads), and the group's k x k weights
// beside it, read from PyTorch's (C, 1, k, k) layout.
// Each thread owns one channel pair and a run of 16 outputs along W, with
// 32 f32 accumulators in registers; for each of the k rows of taps it holds
// that row's weights in registers and slides over the 16 + k - 1 positions
// of A it needs. Neighbouring threads take neighbouring channel pairs, so
// global loads and stores are coalesced in NHWC; the two half-warps of a
// warp take adjacent rows and the tile's row stride is an odd number of
// positions, so their shared-memory reads fall in distinct banks. The
// epilogue adds A's centre and the bias and applies the gelu.
// Device memory sees one read of x (the halo re-read comes from L2) and
// one write of out; A never leaves shared memory.

#include "sk_chain.cuh"

using namespace sf;

namespace {

constexpr int NT = 256;  // threads per block
constexpr int TH = 8;    // output rows per block
constexpr int TW = 32;   // output columns per block
constexpr int RW = 16;   // outputs per thread along W (TW / RW runs a row)
constexpr int NP = 16;   // channel pairs per block (32 channels)
static_assert(NT == NP * TH * (TW / RW), "one thread per pair and run");

struct Args {
  const float *x, *k1w, *k1b, *w, *b;
  float* out;
  int h, wd, c, n1;
};

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// haloed tile width and its row stride in positions (odd: see above)
__host__ __device__ constexpr int halo_w(int r) { return TW + 2 * r; }
__host__ __device__ constexpr int stride_w(int r) { return halo_w(r) | 1; }

template <int KS>
__global__ void __launch_bounds__(NT, 2) dw_chain_kernel(Args a) {
  constexpr int R = KS / 2;
  constexpr int HH = TH + 2 * R, WH = halo_w(R), SW = stride_w(R);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float2* as = reinterpret_cast<float2*>(smem_raw);  // A: HH x SW x NP
  float2* ws = as + HH * SW * NP;  // weights: KS*KS taps x NP

  const int H = a.h, W = a.wd, C = a.c;
  const int tiles_x = (W + TW - 1) / TW;
  const int y0 = (blockIdx.x / tiles_x) * TH;
  const int x0 = (blockIdx.x % tiles_x) * TW;
  const int c0 = blockIdx.y * 2 * NP;
  const size_t img = (size_t)blockIdx.z * H * W * C;
  const float* x = a.x + img;
  const float *k1w = a.k1w, *k1b = a.k1b;
  const int tid = threadIdx.x;

  // the group's weights from PyTorch's (C, 1, k, k) layout, a thread per
  // tap, so neighbouring threads read neighbouring taps of a channel
  for (int e = tid; e < KS * KS * NP; e += NT) {
    const int tap = e % (KS * KS), pr = e / (KS * KS), c = c0 + 2 * pr;
    const float* wc = a.w + (size_t)c * KS * KS + tap;
    ws[tap * NP + pr] = c < C ? make_float2(wc[0], wc[KS * KS])
                              : make_float2(0.f, 0.f);
  }
  // A's haloed tile: the k=1 stages, zeros outside the image and past C.
  // NT is a multiple of NP, so a thread keeps one channel pair; its loads
  // go out NB at a time.
  constexpr int NE = HH * WH * NP, NB = 8;
  const int pa = tid % NP, ca = c0 + 2 * pa;
  for (int e0 = tid; e0 < NE; e0 += NB * NT) {
    float2 v[NB];
    bool in[NB];
#pragma unroll
    for (int u = 0; u < NB; ++u) {
      const int pos = (e0 + u * NT) / NP, hy = pos / WH, hx = pos % WH;
      const int y = y0 + hy - R, xx = x0 + hx - R;
      in[u] = e0 + u * NT < NE && y >= 0 && y < H && xx >= 0 && xx < W &&
              ca < C;
      v[u] = in[u] ? load2(x + ((size_t)y * W + xx) * C + ca)
                   : make_float2(0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < NB; ++u) {
      const int pos = (e0 + u * NT) / NP, hy = pos / WH, hx = pos % WH;
      for (int s = 0; in[u] && s < a.n1; ++s) {
        const float2 wk = load2(k1w + (size_t)s * C + ca);
        const float2 bk = load2(k1b + (size_t)s * C + ca);
        v[u].x = gelu(v[u].x * (1.f + wk.x) + bk.x);
        v[u].y = gelu(v[u].y * (1.f + wk.y) + bk.y);
      }
      if (e0 + u * NT < NE)
        as[(hy * SW + hx) * NP + pa] = v[u];
    }
  }
  __syncthreads();

  const int p = tid % NP, hw = tid / NP;  // channel pair, half-warp
  const int oy = hw % TH, ox = (hw / TH) * RW;
  const int y = y0 + oy, c = c0 + 2 * p;
  if (y >= H || c >= C || x0 + ox >= W) return;

  float acc0[RW], acc1[RW];
#pragma unroll
  for (int j = 0; j < RW; ++j) acc0[j] = acc1[j] = 0.f;
#pragma unroll 1
  for (int dy = 0; dy < KS; ++dy) {
    float w0[KS], w1[KS];
#pragma unroll
    for (int dx = 0; dx < KS; ++dx) {
      const float2 t = ws[(dy * KS + dx) * NP + p];
      w0[dx] = t.x;
      w1[dx] = t.y;
    }
    const float2* row = as + ((oy + dy) * SW + ox) * NP + p;
#pragma unroll
    for (int i = 0; i < RW + KS - 1; ++i) {
      const float2 v = row[i * NP];
#pragma unroll
      for (int j = 0; j < RW; ++j) {
        const int dx = i - j;
        if (dx >= 0 && dx < KS) {
          acc0[j] = fmaf(v.x, w0[dx], acc0[j]);
          acc1[j] = fmaf(v.y, w1[dx], acc1[j]);
        }
      }
    }
  }

  const float2 bias = load2(a.b + c);
  float* out = a.out + img;
  const float2* ctr = as + ((oy + R) * SW + ox + R) * NP + p;
#pragma unroll
  for (int j = 0; j < RW; ++j) {
    const int xx = x0 + ox + j;
    if (xx < W) {
      const float2 v = ctr[j * NP];
      *reinterpret_cast<float2*>(out + ((size_t)y * W + xx) * C + c) =
          make_float2(gelu(v.x + acc0[j] + bias.x),
                      gelu(v.y + acc1[j] + bias.y));
    }
  }
}

template <int KS>
int launch(const Args& a, int nb, cudaStream_t s) {
  constexpr int R = KS / 2;
  const size_t smem = sizeof(float2) * NP *
                      ((size_t)(TH + 2 * R) * stride_w(R) + KS * KS);
  cudaError_t e = cudaFuncSetAttribute(
      dw_chain_kernel<KS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(((a.h + TH - 1) / TH) * ((a.wd + TW - 1) / TW),
            (a.c + 2 * NP - 1) / (2 * NP), nb);
  dw_chain_kernel<KS><<<grid, NT, smem, s>>>(a);
  return (int)cudaGetLastError();
}

int launch_k(const Args& a, int nb, int k, cudaStream_t s) {
  switch (k) {
    case 3: return launch<3>(a, nb, s);
    case 5: return launch<5>(a, nb, s);
    case 7: return launch<7>(a, nb, s);
    case 9: return launch<9>(a, nb, s);
    case 11: return launch<11>(a, nb, s);
    case 13: return launch<13>(a, nb, s);
    case 15: return launch<15>(a, nb, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x, out (nb, h, w, c); k1w, k1b (n1, c) (null when n1 == 0); w (c, k, k),
// PyTorch's depthwise layout; b (c); c even, k odd in [3, 15]
extern "C" int sf_dw_chain(const void* x, const void* k1w, const void* k1b,
                           const void* w, const void* b, void* out, int nb,
                           int h, int wd, int c, int n1, int k, int dtype,
                           void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (nb == 0 || h == 0 || wd == 0 || c == 0) return 0;
  if (c & 1) return (int)cudaErrorInvalidValue;  // channel pairs
  if (dtype == kBF16)  // the engine, sk_chain.cuh
    return chain::run<chain::kK5>(
        chain::Args{x, w, b, k1w, k1b, out, nb, h, wd, c, k, n1}, s);
  Args a{(const float*)x, (const float*)k1w, (const float*)k1b,
         (const float*)w, (const float*)b, (float*)out, h, wd, c, n1};
  return launch_k(a, nb, k, s);
}

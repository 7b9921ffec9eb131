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
// Bound on the H100: by chip_smoke.bound_ms (bf16 peak 989 TFLOP/s against
// one read of x and one write of out) the bytes bound it, 8.2 us for the
// 15x15 stage of (3, 55, 128, 324) in bf16. But a direct depthwise conv
// cannot use the tensor cores, so its real floor is the CUDA cores' f32 FMA
// rate: 2 k^2 B H W C FLOP / 67 TFLOP/s = 46 us for that call. The banded
// tensor-core form of the same conv is B10's work.
//
// Design: one block of 256 threads per (image, 8 x 32 output tile, group of
// 32 channels). The block stages the haloed tile of A, (8 + 2r) x (32 + 2r)
// positions x 32 channels, in shared memory in the io type, computing the
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
// epilogue adds A's centre and the bias, applies the gelu and rounds once.
// Device memory sees one read of x (the halo re-read comes from L2) and
// one write of out; A never leaves shared memory.

#include "common.cuh"

using namespace sf;

namespace {

constexpr int NT = 256;  // threads per block
constexpr int TH = 8;    // output rows per block
constexpr int TW = 32;   // output columns per block
constexpr int RW = 16;   // outputs per thread along W (TW / RW runs a row)
constexpr int NP = 16;   // channel pairs per block (32 channels)
static_assert(NT == NP * TH * (TW / RW), "one thread per pair and run");

struct Args {
  const void *x, *k1w, *k1b, *w, *b;
  void* out;
  int h, wd, c, n1;
};

template <typename T>
struct Pair;
template <>
struct Pair<float> {
  typedef float2 type;
};
template <>
struct Pair<__nv_bfloat16> {
  typedef __nv_bfloat162 type;
};

__device__ __forceinline__ float2 unpack(float2 v) { return v; }
__device__ __forceinline__ float2 unpack(__nv_bfloat162 v) {
  return __bfloat1622float2(v);
}

template <typename T>
__device__ __forceinline__ typename Pair<T>::type pack(float a, float b);
template <>
__device__ __forceinline__ float2 pack<float>(float a, float b) {
  return make_float2(a, b);
}
template <>
__device__ __forceinline__ __nv_bfloat162 pack<__nv_bfloat16>(float a,
                                                               float b) {
  return __floats2bfloat162_rn(a, b);
}

template <typename T>
__device__ __forceinline__ float2 load2(const T* p) {
  return unpack(*reinterpret_cast<const typename Pair<T>::type*>(p));
}

// haloed tile width and its row stride in positions (odd: see above)
__host__ __device__ constexpr int halo_w(int r) { return TW + 2 * r; }
__host__ __device__ constexpr int stride_w(int r) { return halo_w(r) | 1; }

template <typename T, int KS>
__global__ void __launch_bounds__(NT, 2) dw_chain_kernel(Args a) {
  typedef typename Pair<T>::type P2;
  constexpr int R = KS / 2;
  constexpr int HH = TH + 2 * R, WH = halo_w(R), SW = stride_w(R);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  P2* as = reinterpret_cast<P2*>(smem_raw);  // A: HH x SW positions x NP
  P2* ws = as + HH * SW * NP;                // weights: KS*KS taps x NP

  const int H = a.h, W = a.wd, C = a.c;
  const int tiles_x = (W + TW - 1) / TW;
  const int y0 = (blockIdx.x / tiles_x) * TH;
  const int x0 = (blockIdx.x % tiles_x) * TW;
  const int c0 = blockIdx.y * 2 * NP;
  const size_t img = (size_t)blockIdx.z * H * W * C;
  const T* x = (const T*)a.x + img;
  const T *k1w = (const T*)a.k1w, *k1b = (const T*)a.k1b;
  const int tid = threadIdx.x;

  // the group's weights from PyTorch's (C, 1, k, k) layout, a thread per
  // tap, so neighbouring threads read neighbouring taps of a channel
  const T* wg = (const T*)a.w;
  for (int e = tid; e < KS * KS * NP; e += NT) {
    const int tap = e % (KS * KS), pr = e / (KS * KS), c = c0 + 2 * pr;
    const T* wc = wg + (size_t)c * KS * KS + tap;
    ws[tap * NP + pr] = c < C ? pack<T>(to_f(wc[0]), to_f(wc[KS * KS]))
                              : pack<T>(0.f, 0.f);
  }
  // A's haloed tile: the k=1 stages in f32, one rounding to the io type,
  // zeros outside the image and past C. NT is a multiple of NP, so a
  // thread keeps one channel pair; its loads go out NB at a time.
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
        as[(hy * SW + hx) * NP + pa] = pack<T>(v[u].x, v[u].y);
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
      float2 t = unpack(ws[(dy * KS + dx) * NP + p]);
      w0[dx] = t.x;
      w1[dx] = t.y;
    }
    const P2* row = as + ((oy + dy) * SW + ox) * NP + p;
#pragma unroll
    for (int i = 0; i < RW + KS - 1; ++i) {
      const float2 v = unpack(row[i * NP]);
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

  const float2 bias = load2((const T*)a.b + c);
  T* out = (T*)a.out + img;
  const P2* ctr = as + ((oy + R) * SW + ox + R) * NP + p;
#pragma unroll
  for (int j = 0; j < RW; ++j) {
    const int xx = x0 + ox + j;
    if (xx < W) {
      const float2 v = unpack(ctr[j * NP]);
      *reinterpret_cast<P2*>(out + ((size_t)y * W + xx) * C + c) =
          pack<T>(gelu(v.x + acc0[j] + bias.x), gelu(v.y + acc1[j] + bias.y));
    }
  }
}

template <typename T, int KS>
int launch(const Args& a, int nb, cudaStream_t s) {
  constexpr int R = KS / 2;
  const size_t smem = sizeof(typename Pair<T>::type) * NP *
                      ((size_t)(TH + 2 * R) * stride_w(R) + KS * KS);
  cudaError_t e = cudaFuncSetAttribute(
      dw_chain_kernel<T, KS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(((a.h + TH - 1) / TH) * ((a.wd + TW - 1) / TW),
            (a.c + 2 * NP - 1) / (2 * NP), nb);
  dw_chain_kernel<T, KS><<<grid, NT, smem, s>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_k(const Args& a, int nb, int k, cudaStream_t s) {
  switch (k) {
    case 3: return launch<T, 3>(a, nb, s);
    case 5: return launch<T, 5>(a, nb, s);
    case 7: return launch<T, 7>(a, nb, s);
    case 9: return launch<T, 9>(a, nb, s);
    case 11: return launch<T, 11>(a, nb, s);
    case 13: return launch<T, 13>(a, nb, s);
    case 15: return launch<T, 15>(a, nb, s);
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
  Args a{x, k1w, k1b, w, b, out, h, wd, c, n1};
  if (dtype == kBF16) return launch_k<__nv_bfloat16>(a, nb, k, s);
  return launch_k<float>(a, nb, k, s);
}

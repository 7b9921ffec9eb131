// K6-K8: the SK block's depthwise k x k conv as a per-channel banded
// (Toeplitz) product (B10): the f32 body of all three, and the launchers of
// K6 and K8.
//
// Replaces the three Pallas kernels of
// streamflow_tpu/ops/pallas/_banded_dw_kernel.py, all NHWC in and out here,
// the transposes and the zero halo done while the block loads (JAX pads
// and transposes outside its K6 and K8 kernels into a C-major operand, a
// TPU lane-layout choice, not the function):
//   K6 _dw_banded_mxu_fwd   (pallas_call :122) and
//   K7 _dw_banded_mxu_t_fwd (pallas_call :223): the conv + bias;
//   K8 _sk_chain_banded_fwd (pallas_call :343): with the SK block's k=1
//      stages, a zero halo after them, the bias, the residual and the
//      final gelu fused.
//
// Which body is whose: bf16 K7 is its own kernel (dw_banded_t.cu: a
// persistent, pipelined kernel that walks W and keeps its halo); bf16 K6
// and K8 are the engine of sk_chain.cuh (shared with K5) under their
// policies; f32 K6, K7 and K8 are the slab body below (K7's launcher,
// sf_dw_banded_mxu_t in dw_banded_t.cu, calls dw_banded_f32).
//
// Math, per channel c and image b, X[wp][hp] the zero-padded input slab
// (W along rows, H along columns, as the Pallas lhs) and w[c][ky][kx]
// PyTorch's depthwise weights (C, 1, k, k):
//   y[wo][ho] = sum_kx sum_hp X[wo + kx][hp] T_kx[hp][ho],
//   T_kx[hp][ho] = w[c][hp - ho][kx] for 0 <= hp - ho < k, else 0.
// This is the Pallas product (B*Wp, Hp) @ R (Hp, k*H) restricted to the
// band's rows, with the kx-combine done as accumulation into the same f32
// sums instead of k slices of a k*H-wide result. R (36.9 MB for convc1 at
// 440x1024, more than the call's activations) never exists in device
// memory.
//
// Rounding, as the Pallas kernels: products of io-type values summed in
// f32; K6/K7 round the sum once to the io type and then add the bias in
// the io type; K8 computes the k=1 stages in f32 (A), feeds the conv A
// rounded to the io type, and adds the UNROUNDED A as the residual:
// out = io(gelu(A + conv + b_k)).
//
// The f32 body (dw_banded_kernel): one block of 256 threads per (image,
// 32 (H) x 64 (W) output region, 8 channels). The block loads the haloed
// region of its 8 channels, (64 + k - 1) rows along W x 48 columns along
// H, zeros outside the image, into shared memory as one (W, H) slab per
// channel (transposing NHWC into it while it loads, K8 applying its k=1
// stages there), and the weights as columns. Warp i computes channel i,
// each lane two rows along W with the k weights of a column in registers,
// f32 FMAs on the CUDA cores. The sums are staged in shared memory and the
// epilogue (rounding, bias, residual, gelu) runs in a coalesced store loop.

#include "sk_chain.cuh"

using namespace sf;

namespace {

using chain::Args;
using chain::KMAX;
using chain::NT;          // threads per block, one warp per channel
constexpr int CB = 8;     // channels per block
constexpr int RH = 32;    // output rows (H) per block
constexpr int RW = 64;    // output columns (W) per block
constexpr int QR = RW + KMAX - 1;  // slab rows (W) allocated per channel
constexpr int QC = 48;    // slab columns (H) loaded
constexpr int LDQ = 49;   // slab row stride: odd, lanes read rows on
                          // distinct banks
constexpr int QSZ = QR * LDQ;  // slab elements
constexpr int SLD = 34;   // row stride of the staged f32 sums
constexpr int NB = 8;     // loads in flight per thread
static_assert(NT == 32 * CB, "one warp per channel");
static_assert(RH + KMAX - 1 <= QC, "the slab covers the band");
static_assert(RW * SLD <= QSZ, "staged sums fit a slab");

// slabs, then the weight columns
constexpr size_t SMEM = 4 * (CB * QSZ + CB * KMAX * KMAX);

enum Mode { kNHWC = 1, kChain = 2 };

// the k=1 stages of K8 on one value, as _chain_kernel (:303): f32,
// v + v w + b, then gelu, in this order
__device__ __forceinline__ float k1_stages(float v, const Args& a, int c) {
  const float *w1 = (const float*)a.k1w, *b1 = (const float*)a.k1b;
  for (int s = 0; s < a.n1; ++s) {
    const float wk = w1[(size_t)s * a.c + c];
    const float bk = b1[(size_t)s * a.c + c];
    v = gelu(__fadd_rn(__fadd_rn(v, __fmul_rn(v, wk)), bk));
  }
  return v;
}

// lane l sums rows l and l + 32 (W) of the region, in four runs of 8
// along H, with the kx column of weights (ky zero-extended to KMAX) in
// registers; the sums staged at S (rows along W, SLD floats apart)
__device__ __forceinline__ void compute(const float* q, const float* wcol,
                                        float* S, int k) {
  const int lane = threadIdx.x & 31;
  float acc[2][4][8];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[r][s][j] = 0.f;
#pragma unroll 1
  for (int kx = 0; kx < k; ++kx) {
    float wk[KMAX];
#pragma unroll
    for (int ky = 0; ky < KMAX; ++ky) wk[ky] = wcol[kx * KMAX + ky];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float* row = q + (lane + 32 * r + kx) * LDQ;
#pragma unroll
      for (int s = 0; s < 4; ++s) {
#pragma unroll
        for (int i = 0; i < 8 + KMAX - 1; ++i) {
          const float v = row[8 * s + i];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int ky = i - j;
            if (ky >= 0 && ky < KMAX) acc[r][s][j] = fmaf(v, wk[ky], acc[r][s][j]);
          }
        }
      }
    }
  }
  __syncwarp();
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        S[(lane + 32 * r) * SLD + 8 * s + j] = acc[r][s][j];
}

template <int MODE>
__global__ void __launch_bounds__(NT, 1) dw_banded_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* slabs = reinterpret_cast<float*>(smem_raw);  // CB x QR x LDQ
  float* wcol = slabs + CB * QSZ;                     // weight columns

  const int H = a.h, W = a.wd, C = a.c, k = a.k, R = a.k / 2;
  const int tiles_w = (W + RW - 1) / RW;
  const int ho0 = (blockIdx.x / tiles_w) * RH;
  const int wo0 = (blockIdx.x % tiles_w) * RW;
  const int c0 = blockIdx.y * CB, bi = blockIdx.z;
  const int tid = threadIdx.x;
  const float* x = (const float*)a.x;
  const float* wt = (const float*)a.w;

  // weights: per channel and kx the column w[.][kx], zero past k
  for (int e = tid; e < CB * KMAX * KMAX; e += NT) {
    const int ky = e % KMAX, kx = (e / KMAX) % KMAX;
    const int c = c0 + e / (KMAX * KMAX);
    wcol[e] = (c < C && kx < k && ky < k) ? wt[((size_t)c * k + ky) * k + kx]
                                          : 0.f;
  }

  // the haloed slabs: slab row i, column j of channel ch holds padded
  // position (wp, hp) = (wo0 + i, ho0 + j), zero outside the image
  // (indices divided by the allocated row count QR, a constant: slab rows
  // past the band, i >= rows, are skipped)
  const int rows = RW + k - 1, ne = CB * QR * QC;
  for (int e0 = tid; e0 < ne; e0 += NB * NT) {
    float v[NB];
    int dst[NB], cs[NB];  // slab index (-1: past the end), channel
    bool inner[NB];       // inside the image, where K8's k=1 stages apply
#pragma unroll
    for (int u = 0; u < NB; ++u) {
      const int e = e0 + u * NT;
      // channels fastest: NHWC's contiguous axis
      int ch, i, j;
      ch = e % CB;
      i = (e / CB) % QR;
      j = e / (CB * QR);
      const int c = c0 + ch, wp = wo0 + i, hp = ho0 + j;
      const bool in_slab = e < ne && i < rows;
      bool ok = in_slab && c < C;
      size_t src;
      {
        const int hh = hp - R, ww = wp - R;
        ok = ok && hh >= 0 && hh < H && ww >= 0 && ww < W;
        src = (((size_t)bi * H + hh) * W + ww) * C + c;
      }
      v[u] = ok ? x[src] : 0.f;
      dst[u] = in_slab ? ch * QSZ + i * LDQ + j : -1;
      cs[u] = c;
      inner[u] = ok;  // inside the image
    }
#pragma unroll
    for (int u = 0; u < NB; ++u) {
      if (MODE == kChain && a.n1 > 0)  // the halo stays 0, not gelu(b)
        v[u] = inner[u] ? k1_stages(v[u], a, cs[u]) : 0.f;
      if (dst[u] >= 0) slabs[dst[u]] = v[u];
    }
  }
  __syncthreads();

  const int ch = tid >> 5;
  float* S = slabs + ch * QSZ;
  if (c0 + ch < C) compute(slabs + ch * QSZ, wcol + ch * KMAX * KMAX, S, k);
  __syncthreads();

  // epilogue and store, NHWC, channels fastest
  const float* bias = (const float*)a.b;
  float* out = (float*)a.out;
  for (int e0 = tid; e0 < CB * RW * RH; e0 += NB * NT) {
    float acc[NB], r0[NB];
    size_t oi[NB];
    int cs[NB];  // channel, -1 where the output is outside the tensor
#pragma unroll
    for (int u = 0; u < NB; ++u) {
      const int e = e0 + u * NT;
      const int cl = e % CB, wl = (e / CB) % RW, hl = e / (CB * RW);
      const int c = c0 + cl, wo = wo0 + wl, ho = ho0 + hl;
      const bool ok = c < C && wo < W && ho < H;
      cs[u] = ok ? c : -1;
      acc[u] = ok ? slabs[cl * QSZ + wl * SLD + hl] : 0.f;
      oi[u] = (((size_t)bi * H + ho) * W + wo) * C + c;
      // K8's residual is A unrounded: recomputed from x at the centre tap
      r0[u] = MODE == kChain && ok ? x[oi[u]] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < NB; ++u) {
      if (cs[u] < 0) continue;
      const float bc = bias[cs[u]];
      out[oi[u]] = MODE == kChain
                       ? gelu(__fadd_rn(
                             __fadd_rn(k1_stages(r0[u], a, cs[u]), acc[u]),
                             bc))
                       : acc[u] + bc;
    }
  }
}

template <int MODE>
int launch_f32(const Args& a, cudaStream_t s) {
  if (a.nb == 0 || a.h == 0 || a.wd == 0 || a.c == 0) return 0;
  if (a.k < 3 || a.k > KMAX || !(a.k & 1) || a.n1 < 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      dw_banded_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(((a.h + RH - 1) / RH) * ((a.wd + RW - 1) / RW),
            (a.c + CB - 1) / CB, a.nb);
  dw_banded_kernel<MODE><<<grid, NT, SMEM, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

namespace sf {
// K6's and K7's f32 launch (x, out (nb, h, wd, c) NHWC f32)
int dw_banded_f32(const void* x, const void* w, const void* b, void* out,
                  int nb, int h, int wd, int c, int k, cudaStream_t s) {
  Args a{x, w, b, nullptr, nullptr, out, nb, h, wd, c, k, 0};
  return launch_f32<kNHWC>(a, s);
}
}  // namespace sf

// K6. x, out (nb, h, wd, c) NHWC; w (c, 1, k, k); b (c). k odd in [3, 15].
extern "C" int sf_dw_banded_mxu(const void* x, const void* w, const void* b,
                                void* out, int nb, int h, int wd, int c, int k,
                                int dtype, void* stream) {
  Args a{x, w, b, nullptr, nullptr, out, nb, h, wd, c, k, 0};
  if (dtype == kBF16)  // the engine, sk_chain.cuh
    return chain::run<chain::kK6>(a, (cudaStream_t)stream);
  return launch_f32<kNHWC>(a, (cudaStream_t)stream);
}

// K8. x, out (nb, h, wd, c) NHWC; k1w, k1b (n1, c), the k=1 stages (null
// when n1 == 0); w (c, 1, k, k), b (c), the kxk stage.
extern "C" int sf_sk_chain_banded(const void* x, const void* k1w,
                                  const void* k1b, const void* w,
                                  const void* b, void* out, int nb, int h,
                                  int wd, int c, int n1, int k, int dtype,
                                  void* stream) {
  Args a{x, w, b, k1w, k1b, out, nb, h, wd, c, k, n1};
  if (dtype == kBF16)  // the engine, sk_chain.cuh
    return chain::run<chain::kK8>(a, (cudaStream_t)stream);
  return launch_f32<kChain>(a, (cudaStream_t)stream);
}

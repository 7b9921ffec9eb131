// K6-K8: the SK block's depthwise k x k conv as a per-channel banded
// (Toeplitz) product on the tensor cores (B10).
//
// Replaces the three Pallas kernels of
// streamflow_tpu/ops/pallas/_banded_dw_kernel.py:
//   K6 _dw_banded_mxu_fwd   (pallas_call :122): C-major padded operand
//      lhs (C, B*Wp, Hp) in, (C, B*W, H) out; the wrapper pads and
//      transposes around it, as JAX does;
//   K7 _dw_banded_mxu_t_fwd (pallas_call :223): NHWC in and out, the
//      transposes and the zero halo done while the block loads;
//   K8 _sk_chain_banded_fwd (pallas_call :343): NHWC in and out, as K7,
//      with the SK block's k=1 stages, a zero halo after them, the bias,
//      the residual and the final gelu fused (JAX pads and transposes
//      outside its kernel, a TPU lane-layout choice, not the function).
//
// Math, per channel c and image b, X[wp][hp] the zero-padded input slab
// (W along rows, H along columns, as the Pallas lhs) and w[c][ky][kx]
// PyTorch's depthwise weights (C, 1, k, k):
//   y[wo][ho] = sum_kx sum_hp X[wo + kx][hp] T_kx[hp][ho],
//   T_kx[hp][ho] = w[c][hp - ho][kx] for 0 <= hp - ho < k, else 0.
// This is the Pallas product (B*Wp, Hp) @ R (Hp, k*H) restricted to the
// band's rows, with the kx-combine done as accumulation into the same f32
// mma fragments instead of k slices of a k*H-wide result. R (36.9 MB for
// convc1 at 440x1024, more than the call's activations) never exists in
// device memory: T_kx is Toeplitz, so every B fragment is a pair of
// consecutive entries of the zero-extended weight column w[c][.][kx],
// which the block keeps in shared memory as a table of packed pairs.
//
// Rounding, as the Pallas kernels: products of io-type values summed in
// f32; K6/K7 round the sum once to the io type and then add the bias in
// the io type; K8 computes the k=1 stages in f32 (A), feeds the conv A
// rounded to the io type, and adds the UNROUNDED A as the residual:
// out = io(gelu(A + conv + b_k)).
//
// Bound on the H100: 2 k^2 N C FLOP against one read of x and one write
// of out; at bf16 the bytes bound it (convc1: 3.1e9 FLOP = 3.1 us at 989
// TFLOP/s, 27.5 MB = 8.2 us). The band costs this form (16 + k - 1 -> 32
// reduction rows per 16 outputs along H, k=15) about 2.1x the conv's own
// FLOP on the tensor cores, far below their rate.
//
// K6, K7 and K8's f32 body (dw_banded_kernel): one block of 256 threads
// per (image, 32 (H) x 64 (W) output region, 8 channels). The block loads
// the haloed region of its 8 channels, (64 + k - 1) rows along W x 48
// columns along H, zeros outside the image, into shared memory as one
// (W, H) slab per channel (K7 and K8 transpose NHWC into it while they
// load, K8 applying its k=1 stages there), and the weights as the pair
// table. bf16: warp i computes channel i, the region as 4 m16 tiles along
// W x 4 n8 tiles along H with mma.sync m16n8k16 (f32 accumulators, 64 a
// thread); for each kx the A fragments are the slab's rows shifted by kx
// (ldmatrix), 3 per m tile, and the five B registers are shared by every
// tile. f32: the same tiling, each lane two rows along W with the k
// weights of a column in registers, f32 FMAs on the CUDA cores. The sums
// are staged in shared memory and the epilogue (rounding, bias, residual,
// gelu) runs in a coalesced store loop. What bounds it is the load of the
// haloed tile: 2-byte loads, 8 in flight a thread.
//
// K8's bf16 body (chain::sk_chain_kernel), NHWC in and out with no copy
// around it: one block of 256 threads per (image, 32 x 32 output region,
// 8 channels), two blocks an SM (88 KB of shared memory each):
//   1. the haloed box of x, (32 + k - 1)^2 pixels x 8 channels, by
//      cp.async into shared memory, all of it in flight at once: 16-byte
//      pixel runs when C % 8 == 0; 8-byte at convc1's C = 324, whose
//      648-byte rows no 16-byte copy (and no tensor map, whose strides
//      must be multiples of 16 bytes) can take; 4-byte at C % 4 == 2,
//      2-byte loads at odd C. Pixels outside the image are not read;
//   2. meanwhile the block's weights (all loads issued before the first
//      is used), bias and k=1 parameters, and per warp its channel's pair
//      table of k + 3 entries per kx (d in [-2, k], clamped per lane);
//   3. one pass over the box applies the k=1 stages once per pixel (the 8
//      channels' gelu chains interleaved), writes 0 outside the image,
//      and writes each channel's (W, H) plane in the layout the ldmatrix
//      A fragments read (16-byte rows, 112 bytes apart); the centre pixels
//      go first and keep their unrounded A, which then takes the box's
//      place in shared memory for the residual;
//   4. warp i: channel i's 2 m16 x 4 n8 tiles on mma.sync (at k <= 9 the
//      even n8 tiles' all-zero second product is skipped), the sums staged
//      over its plane;
//   5. epilogue: gelu(A + conv + b) with one gelu per output, whole pixel
//      runs of the 8 channels stored (16 bytes when C % 8 == 0).
// Probe copies timed on the H100 (PERF.md, section 6) find no phase that
// dominates: the box pass, the products and the epilogue take about a
// fifth of the time each, the loads and the setup less.

#include "common.cuh"

using namespace sf;

namespace {

constexpr int NT = 256;   // threads per block, one warp per channel
constexpr int CB = 8;     // channels per block
constexpr int RH = 32;    // output rows (H) per block
constexpr int RW = 64;    // output columns (W) per block
constexpr int KMAX = 15;  // largest kernel size
constexpr int QR = RW + KMAX - 1;  // slab rows (W) allocated per channel
constexpr int QC = 48;    // slab columns (H) loaded: 3 k-chunks of 16
constexpr int TABW = 48;  // pair-table entries per kx (46 used)
constexpr int SLD = 34;   // row stride of the staged f32 sums
constexpr int NB = 8;     // loads in flight per thread
static_assert(NT == 32 * CB, "one warp per channel");
static_assert(RH + KMAX - 1 <= QC, "the k-chunks cover the band");

template <typename T>
struct Tile;
template <>
struct Tile<__nv_bfloat16> {
  // row stride: 16-byte rows for ldmatrix, 112 bytes so that 8 rows fall
  // in distinct bank groups
  static constexpr int LDQ = 56;
  static constexpr int MINB = 2;
};
template <>
struct Tile<float> {
  static constexpr int LDQ = 49;  // odd: lanes read rows, distinct banks
  static constexpr int MINB = 1;
};

template <typename T>
__host__ __device__ constexpr int slab_elems() {
  return QR * Tile<T>::LDQ;
}
static_assert(RW * SLD * 4 <= QR * 56 * 2, "staged sums fit a bf16 slab");
static_assert(RW * SLD * 4 <= QR * 49 * 4, "staged sums fit an f32 slab");

template <typename T>
size_t smem_bytes() {
  // slabs, then the bf16 pair table or the f32 weight columns
  return sizeof(T) * CB * slab_elems<T>() +
         (sizeof(T) == 2 ? 4 * CB * KMAX * TABW : 4 * CB * KMAX * KMAX);
}

enum Mode { kCMajor = 0, kNHWC = 1, kChain = 2 };

struct Args {
  const void *x, *w, *b, *k1w, *k1b;
  void* out;
  int nb, h, wd, c, k, n1;
};

// the k=1 stages of K8 on one value, as _chain_kernel (:303): f32,
// v + v w + b, then gelu, in this order
template <typename T>
__device__ __forceinline__ float k1_stages(float v, const Args& a, int c) {
  const T *w1 = (const T*)a.k1w, *b1 = (const T*)a.k1b;
  for (int s = 0; s < a.n1; ++s) {
    const float wk = to_f(w1[(size_t)s * a.c + c]);
    const float bk = to_f(b1[(size_t)s * a.c + c]);
    v = gelu(__fadd_rn(__fadd_rn(v, __fmul_rn(v, wk)), bk));
  }
  return v;
}

// bf16: warp `ch` sums its channel's region on the tensor cores and
// stages the f32 sums at S (rows along W, SLD floats apart)
__device__ __forceinline__ void compute(const __nv_bfloat16* q,
                                        const uint32_t* tab, float* S,
                                        int k) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float acc[4][4][4];
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;
  // B fragment of n8 tile j, k-chunk s: rows hp = 16 s + 2t(+1) and
  // 16 s + 2t + 8(+1) of column ho = 8 j + g, i.e. the weight pairs at
  // D = 16 s - 8 j + 2t - g (+8); with q = 2 s - j + 1 that is entry
  // 2t - g + 8 q + 7 of the table (D + 15), q = 0..4
  const uint32_t* tb = tab + 2 * t - g + 7;
  // ldmatrix x4: lanes 0-15 give rows 0-15 of columns 0-7, lanes 16-31
  // rows 0-15 of columns 8-15
  const __nv_bfloat16* arow = q + (lane & 15) * Tile<__nv_bfloat16>::LDQ +
                              (lane >> 4) * 8;
#pragma unroll 1
  for (int kx = 0; kx < k; ++kx) {
    uint32_t bw[5];
#pragma unroll
    for (int i = 0; i < 5; ++i) bw[i] = tb[kx * TABW + 8 * i];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      uint32_t af[3][4];
#pragma unroll
      for (int s = 0; s < 3; ++s)
        ldmatrix_x4(af[s], arow + (16 * m + kx) * Tile<__nv_bfloat16>::LDQ +
                               16 * s);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int s0 = j >> 1, i0 = 2 * s0 - j + 1;
        mma_bf16(acc[m][j], af[s0], bw[i0], bw[i0 + 1]);
        mma_bf16(acc[m][j], af[s0 + 1], bw[i0 + 2], bw[i0 + 3]);
      }
    }
  }
  __syncwarp();  // every lane is past its last read of the slab
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        S[(16 * m + g + 8 * (e >> 1)) * SLD + 8 * j + 2 * t + (e & 1)] =
            acc[m][j][e];
}

// f32: lane l sums rows l and l + 32 (W) of the region, in four runs of 8
// along H, with the kx column of weights (ky zero-extended to KMAX) in
// registers
__device__ __forceinline__ void compute(const float* q, const float* wcol,
                                        float* S, int k) {
  constexpr int LDQ = Tile<float>::LDQ;
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

template <typename T, int MODE>
__global__ void __launch_bounds__(NT, Tile<T>::MINB)
    dw_banded_kernel(Args a) {
  constexpr int LDQ = Tile<T>::LDQ, QSZ = slab_elems<T>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* slabs = reinterpret_cast<T*>(smem_raw);          // CB x QR x LDQ
  void* wtab = smem_raw + sizeof(T) * CB * QSZ;       // pairs or columns

  const int H = a.h, W = a.wd, C = a.c, k = a.k, R = a.k / 2;
  const int Hp = H + 2 * R, Wp = W + 2 * R;
  const int tiles_w = (W + RW - 1) / RW;
  const int ho0 = (blockIdx.x / tiles_w) * RH;
  const int wo0 = (blockIdx.x % tiles_w) * RW;
  const int c0 = blockIdx.y * CB, bi = blockIdx.z;
  const int tid = threadIdx.x;
  const T* x = (const T*)a.x;
  const T* wt = (const T*)a.w;

  // weights: bf16, per channel and kx the packed pairs
  // (w[D][kx], w[D + 1][kx]) for D = e - 15, zero outside [0, k); f32, per
  // channel and kx the column w[.][kx], zero past k
  if (sizeof(T) == 2) {
    uint32_t* tab = reinterpret_cast<uint32_t*>(wtab);
    for (int e = tid; e < CB * KMAX * TABW; e += NT) {
      const int d = e % TABW - 15, kx = (e / TABW) % KMAX;
      const int c = c0 + e / (TABW * KMAX);
      float lo = 0.f, hi = 0.f;
      if (c < C && kx < k) {
        const T* wc = wt + (size_t)c * k * k + kx;
        if (d >= 0 && d < k) lo = to_f(wc[d * k]);
        if (d + 1 >= 0 && d + 1 < k) hi = to_f(wc[(d + 1) * k]);
      }
      tab[e] = pack_bf16(lo, hi);
    }
  } else {
    float* wcol = reinterpret_cast<float*>(wtab);
    for (int e = tid; e < CB * KMAX * KMAX; e += NT) {
      const int ky = e % KMAX, kx = (e / KMAX) % KMAX;
      const int c = c0 + e / (KMAX * KMAX);
      wcol[e] = (c < C && kx < k && ky < k)
                    ? to_f(wt[((size_t)c * k + ky) * k + kx])
                    : 0.f;
    }
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
      int ch, i, j;
      if (MODE != kCMajor) {  // channels fastest: NHWC's contiguous axis
        ch = e % CB;
        i = (e / CB) % QR;
        j = e / (CB * QR);
      } else {  // H fastest: the C-major operand's contiguous axis
        j = e % QC;
        i = (e / QC) % QR;
        ch = e / (QC * QR);
      }
      const int c = c0 + ch, wp = wo0 + i, hp = ho0 + j;
      const bool in_slab = e < ne && i < rows;
      bool ok = in_slab && c < C;
      size_t src;
      if (MODE != kCMajor) {
        const int hh = hp - R, ww = wp - R;
        ok = ok && hh >= 0 && hh < H && ww >= 0 && ww < W;
        src = (((size_t)bi * H + hh) * W + ww) * C + c;
      } else {
        ok = ok && wp < Wp && hp < Hp;
        src = (((size_t)c * a.nb + bi) * Wp + wp) * Hp + hp;
      }
      v[u] = ok ? to_f(x[src]) : 0.f;
      dst[u] = in_slab ? ch * QSZ + i * LDQ + j : -1;
      cs[u] = c;
      inner[u] = ok;  // NHWC: ok means inside the image
    }
#pragma unroll
    for (int u = 0; u < NB; ++u) {
      if (MODE == kChain && a.n1 > 0)  // the halo stays 0, not gelu(b)
        v[u] = inner[u] ? k1_stages<T>(v[u], a, cs[u]) : 0.f;
      if (dst[u] >= 0) slabs[dst[u]] = from_f<T>(v[u]);
    }
  }
  __syncthreads();

  const int ch = tid >> 5;
  float* S = reinterpret_cast<float*>(slabs + ch * QSZ);
  if (c0 + ch < C) {
    if constexpr (sizeof(T) == 2)
      compute(slabs + ch * QSZ,
              reinterpret_cast<const uint32_t*>(wtab) + ch * KMAX * TABW, S,
              k);
    else
      compute(slabs + ch * QSZ,
              reinterpret_cast<const float*>(wtab) + ch * KMAX * KMAX, S, k);
  }
  __syncthreads();

  // epilogue and store: K6 writes (C, B*W, H), H fastest; K7 and K8
  // NHWC, channels fastest
  const T* bias = (const T*)a.b;
  T* out = (T*)a.out;
  for (int e0 = tid; e0 < CB * RW * RH; e0 += NB * NT) {
    float acc[NB], r0[NB];
    size_t oi[NB];
    int cs[NB];  // channel, -1 where the output is outside the tensor
#pragma unroll
    for (int u = 0; u < NB; ++u) {
      const int e = e0 + u * NT;
      int cl, wl, hl;
      if (MODE != kCMajor) {
        cl = e % CB;
        wl = (e / CB) % RW;
        hl = e / (CB * RW);
      } else {
        hl = e % RH;
        wl = (e / RH) % RW;
        cl = e / (RH * RW);
      }
      const int c = c0 + cl, wo = wo0 + wl, ho = ho0 + hl;
      const bool ok = c < C && wo < W && ho < H;
      cs[u] = ok ? c : -1;
      acc[u] = ok ? reinterpret_cast<const float*>(slabs + cl * QSZ)
                        [wl * SLD + hl] : 0.f;
      oi[u] = MODE != kCMajor ? (((size_t)bi * H + ho) * W + wo) * C + c
                              : (((size_t)c * a.nb + bi) * W + wo) * H + ho;
      // K8's residual is A unrounded: recomputed from x at the centre tap
      r0[u] = MODE == kChain && ok ? to_f(x[oi[u]]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < NB; ++u) {
      if (cs[u] < 0) continue;
      const float bc = to_f(bias[cs[u]]);
      float v;
      if (MODE == kChain)
        v = gelu(__fadd_rn(__fadd_rn(k1_stages<T>(r0[u], a, cs[u]), acc[u]),
                           bc));
      else
        v = round_io<T>(acc[u]) + bc;
      out[oi[u]] = from_f<T>(v);
    }
  }
}

template <typename T, int MODE>
int launch(const Args& a, cudaStream_t s) {
  const size_t smem = smem_bytes<T>();
  cudaError_t e = cudaFuncSetAttribute(
      dw_banded_kernel<T, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(((a.h + RH - 1) / RH) * ((a.wd + RW - 1) / RW),
            (a.c + CB - 1) / CB, a.nb);
  dw_banded_kernel<T, MODE><<<grid, NT, smem, s>>>(a);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------ K8's bf16 body
namespace chain {

typedef __nv_bfloat16 bf16;
constexpr int XC = 8;    // channels per block, one warp each
constexpr int XW = 32;   // output columns (W) per block: two m16 tiles
constexpr int XH = 32;   // output rows (H) per block: four n8 tiles
constexpr int LDQ = 56;  // plane row stride (elements): 16-byte ldmatrix
                         // rows, 8 rows on distinct banks
constexpr int QC = 48;   // plane columns: three k16 chunks
constexpr int QR = XW + KMAX - 1;  // plane rows allocated
constexpr int SLD = 40;  // staged-sum row stride (floats): a half-warp's
                         // float2 stores on distinct banks
constexpr int TW = KMAX + 3;       // pair-table entries per kx: d in [-2, k]
constexpr int NC = XW * XH;        // centre (output) pixels of a block
constexpr int RAW_B = (XW + KMAX - 1) * (XH + KMAX - 1) * XC * 2;
constexpr int PB = QR * LDQ * 2;   // plane bytes
constexpr int PE = PB / 2;
constexpr int TAB_B = XC * KMAX * TW * 4;
static_assert(NT == 32 * XC, "one warp per channel");
static_assert(NC % NT == 0, "whole rounds of centre pixels");
static_assert(XH + KMAX - 1 <= QC, "the k-chunks cover the band");
static_assert(XW * SLD * 4 <= PB, "staged sums fit a plane");
static_assert(RAW_B >= NC * XC * 4, "the centre's f32 A fits the raw box");
static_assert(RAW_B % 16 == 0 && PB % 16 == 0, "16-byte aligned regions");

size_t smem_bytes(int n1) {
  // raw box (then the centre's A), planes, pair table, bias, k=1 stage
  // parameters, the block's weights
  return RAW_B + XC * PB + TAB_B + 4 * XC + 8 * XC * n1 +
         2 * NT * ((XC * KMAX * KMAX + NT - 1) / NT);
}

template <int V>
struct Vec;
template <>
struct Vec<8> {
  typedef uint4 T;
};
template <>
struct Vec<4> {
  typedef uint2 T;
};
template <>
struct Vec<2> {
  typedef uint32_t T;
};
template <>
struct Vec<1> {
  typedef unsigned short T;
};

// the k=1 stages on a pixel's XC channels, as _chain_kernel (:303): f32,
// v + v w + b, then gelu, in this order; the channels' chains interleaved
__device__ __forceinline__ void stages(float (&v)[XC], const float2* prm,
                                       int n1) {
  for (int s = 0; s < n1; ++s) {
#pragma unroll
    for (int q = 0; q < XC; ++q) {
      const float2 p = prm[s * XC + q];
      v[q] = gelu(__fadd_rn(__fadd_rn(v[q], __fmul_rn(v[q], p.x)), p.y));
    }
  }
}

// warp `ch`: its channel's 32 x 32 region on the tensor cores, sums staged
// at S (rows along W, SLD floats apart). As compute() above with two m16
// tiles, and the pair table indexed by d + 2 clamped to [-2, k] (entries
// d = -2 and d = k are zero pairs). NARROW (k <= 9): the band of an even
// n8 tile lies in one k-chunk, and its second product, all zero weights,
// is skipped.
template <bool NARROW>
__device__ __forceinline__ void compute(const bf16* q, const uint32_t* tab,
                                        float* S, int k) {
  constexpr int MT = XW / 16;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float acc[MT][4][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;
  // B register i of this lane: the weight pair at d = 2t - g - 8 + 8i
  int toff[5];
#pragma unroll
  for (int i = 0; i < 5; ++i)
    toff[i] = min(max(2 * t - g - 8 + 8 * i, -2), k) + 2;
  const bf16* arow = q + (lane & 15) * LDQ + (lane >> 4) * 8;
#pragma unroll 1
  for (int kx = 0; kx < k; ++kx) {
    uint32_t bw[5];
#pragma unroll
    for (int i = 0; i < 5; ++i) bw[i] = tab[kx * TW + toff[i]];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      uint32_t af[3][4];
#pragma unroll
      for (int s = 0; s < 3; ++s)
        ldmatrix_x4(af[s], arow + (16 * m + kx) * LDQ + 16 * s);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int s0 = j >> 1, i0 = 2 * s0 - j + 1;
        mma_bf16(acc[m][j], af[s0], bw[i0], bw[i0 + 1]);
        if (!NARROW || (j & 1))
          mma_bf16(acc[m][j], af[s0 + 1], bw[i0 + 2], bw[i0 + 3]);
      }
    }
  }
  __syncwarp();  // every lane is past its last read of the plane
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(
            &S[(16 * m + g + 8 * h) * SLD + 8 * j + 2 * t]) =
            make_float2(acc[m][j][2 * h], acc[m][j][2 * h + 1]);
}

// V: channels per copy (8 when C % 8 == 0: 16-byte pixel runs; 4 at
// C = 324, whose 648-byte rows allow 8-byte copies)
template <int V>
__global__ void __launch_bounds__(NT, 2) sk_chain_kernel(Args a) {
  constexpr int NV = XC / V;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* raw = reinterpret_cast<bf16*>(smem_raw);  // box pixel x XC
  bf16* planes = reinterpret_cast<bf16*>(smem_raw + RAW_B);
  uint32_t* tab = reinterpret_cast<uint32_t*>(smem_raw + RAW_B + XC * PB);
  float* bias = reinterpret_cast<float*>(smem_raw + RAW_B + XC * PB + TAB_B);
  float2* prm = reinterpret_cast<float2*>(bias + XC);
  bf16* wraw = reinterpret_cast<bf16*>(prm + XC * a.n1);

  const int H = a.h, W = a.wd, C = a.c, k = a.k, R = k / 2, n1 = a.n1;
  const int rows = XW + k - 1, cols = XH + k - 1;
  const int tiles_w = (W + XW - 1) / XW;
  const int c0 = blockIdx.x * XC, nc = min(XC, C - c0);
  const int ho0 = (blockIdx.y / tiles_w) * XH;
  const int wo0 = (blockIdx.y % tiles_w) * XW;
  const int bi = blockIdx.z, tid = threadIdx.x;
  const bf16* x = (const bf16*)a.x;

  // 1. the haloed box by cp.async, left in flight: box pixel p = i cols + j
  // (i along W, j along H) holds x at (ho0 + j - R, wo0 + i - R). Pixels
  // outside the image are not read (the pass below writes 0 for them);
  // channels past C are zeroed.
  // (thread tid copies channels vi V of pixels p = tid / NV + n NT / NV,
  // (i, j) stepped without a division)
  const int vi = tid % NV, dj = (NT / NV) % cols, di = (NT / NV) / cols;
  int i = (tid / NV) / cols, j = (tid / NV) % cols;
  for (int p = tid / NV; p < rows * cols; p += NT / NV) {
    const int hh = ho0 + j - R, ww = wo0 + i - R, c = c0 + vi * V;
    bf16* dst = raw + p * XC + vi * V;
    i += di;
    j += dj;
    if (j >= cols) j -= cols, ++i;
    if (hh < 0 || hh >= H || ww < 0 || ww >= W) continue;
    if (c < C) {
      const bf16* src = x + (((size_t)bi * H + hh) * W + ww) * C + c;
      if constexpr (V > 1)
        cp_async<2 * V>(dst, src);
      else
        *dst = *src;
    } else {
      *reinterpret_cast<typename Vec<V>::T*>(dst) = typename Vec<V>::T{};
    }
  }
  // 2. while it lands: the block's weights (every load issued before the
  // first is used), bias and k=1 parameters, then the pair table: entry
  // (ch, kx, d + 2) = (w[d][kx], w[d + 1][kx]) for d in [-2, k], zero
  // outside [0, k)
  {
    constexpr int NW = (XC * KMAX * KMAX + NT - 1) / NT;
    const bf16* wg = (const bf16*)a.w + (size_t)c0 * k * k;
    bf16 wv[NW];
#pragma unroll
    for (int r = 0; r < NW; ++r) {
      const int e = tid + r * NT;
      wv[r] = e < nc * k * k ? wg[e] : __ushort_as_bfloat16(0);
    }
#pragma unroll
    for (int r = 0; r < NW; ++r) wraw[tid + r * NT] = wv[r];
  }
  if (tid < XC)
    bias[tid] = tid < nc ? to_f(((const bf16*)a.b)[c0 + tid]) : 0.f;
  for (int e = tid; e < n1 * XC; e += NT) {
    const int s = e / XC, ch = e % XC;
    const size_t o = (size_t)s * C + c0 + ch;
    prm[e] = ch < nc ? make_float2(to_f(((const bf16*)a.k1w)[o]),
                                   to_f(((const bf16*)a.k1b)[o]))
                     : make_float2(0.f, 0.f);
  }
  __syncthreads();
  {  // warp = channel
    const int ch = tid >> 5;
    const bf16* wc = wraw + ch * k * k;
    for (int e = tid & 31; e < k * TW; e += 32) {
      const int kx = e / TW, d = e - kx * TW - 2;
      float lo = 0.f, hi = 0.f;
      if (ch < nc) {
        if (d >= 0 && d < k) lo = to_f(wc[d * k + kx]);
        if (d + 1 >= 0 && d + 1 < k) hi = to_f(wc[(d + 1) * k + kx]);
      }
      tab[(ch * KMAX + kx) * TW + d + 2] = pack_bf16(lo, hi);
    }
  }
  // plane columns past the band are read by the last k-chunk: zero
  for (int e = tid; e < XC * rows * (QC - cols); e += NT) {
    const int ch = e % XC, r = e / XC, i = r / (QC - cols);
    planes[ch * PE + i * LDQ + cols + r - i * (QC - cols)] =
        __ushort_as_bfloat16(0);
  }
  cp_async_wait_all();
  __syncthreads();

  // 3. one pass over the box, each pixel once: the k=1 stages in f32
  // inside the image, 0 outside (the halo stays 0, not gelu(b)), rounded to
  // bf16 into the channel planes (row i, column j); the centre pixels first,
  // in the epilogue's order, their unrounded A kept for the residual
  auto pass = [&](int i, int j, float (&A)[XC]) {
    const int hh = ho0 + j - R, ww = wo0 + i - R;
    const bool in = hh >= 0 && hh < H && ww >= 0 && ww < W;
    const uint4 v =
        in ? *reinterpret_cast<const uint4*>(raw + (i * cols + j) * XC)
           : make_uint4(0, 0, 0, 0);
    const uint32_t vw[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int q = 0; q < XC; ++q)  // bf16 -> f32 is a 16-bit shift
      A[q] = __uint_as_float(q & 1 ? vw[q >> 1] & 0xffff0000u
                                   : vw[q >> 1] << 16);
    if (in) stages(A, prm, n1);
#pragma unroll
    for (int q = 0; q < XC; ++q)
      planes[q * PE + i * LDQ + j] = __float2bfloat16_rn(A[q]);
  };
  float keep[NC / NT][XC];
#pragma unroll
  for (int r = 0; r < NC / NT; ++r) {
    const int e = tid + r * NT, hl = e % XH, wl = e / XH;
    pass(wl + R, hl + R, keep[r]);
  }
  // the ring around the centre: rows i < R and i >= R + XW (all columns),
  // then columns j < R and j >= R + XH of the centre rows
  const int band = R * cols, ring = 2 * band + 2 * R * XW;
  for (int e = tid; e < ring; e += NT) {
    int i, j;
    if (e < 2 * band) {
      i = e / cols;
      j = e - i * cols;
      i += i >= R ? XW : 0;
    } else {
      const int q = e - 2 * band;
      i = q / (2 * R);
      j = q - i * 2 * R;
      i += R;
      j += j >= R ? XH : 0;
    }
    float A[XC];
    pass(i, j, A);
  }
  __syncthreads();
  // the box is consumed: the centre's A (f32, XC per pixel) takes its place
  float* Ac = reinterpret_cast<float*>(smem_raw);
#pragma unroll
  for (int r = 0; r < NC / NT; ++r) {
    float4* d = reinterpret_cast<float4*>(Ac + (tid + r * NT) * XC);
#pragma unroll
    for (int q = 0; q < XC / 4; ++q)
      d[q] = make_float4(keep[r][4 * q], keep[r][4 * q + 1],
                         keep[r][4 * q + 2], keep[r][4 * q + 3]);
  }

  // 4. the banded products, warp = channel; sums staged over its plane
  const int warp = tid >> 5;
  if (warp < nc) {
    const bf16* q = planes + warp * PE;
    const uint32_t* t = tab + warp * KMAX * TW;
    float* S = reinterpret_cast<float*>(planes + warp * PE);
    if (k <= 9)
      compute<true>(q, t, S, k);
    else
      compute<false>(q, t, S, k);
  }
  __syncthreads();

  // 5. epilogue: out = bf16(gelu(A + conv + b)), whole pixel runs of the
  // block's channels
  bf16* out = (bf16*)a.out;
#pragma unroll
  for (int r = 0; r < NC / NT; ++r) {
    const int e = tid + r * NT, hl = e % XH, wl = e / XH;
    const int ho = ho0 + hl, wo = wo0 + wl;
    if (ho >= H || wo >= W) continue;
    float v[XC];
#pragma unroll
    for (int q = 0; q < XC; ++q) {
      const float conv =
          reinterpret_cast<const float*>(planes + q * PE)[wl * SLD + hl];
      v[q] = gelu(__fadd_rn(__fadd_rn(Ac[e * XC + q], conv), bias[q]));
    }
    bf16* dst = out + (((size_t)bi * H + ho) * W + wo) * C + c0;
#pragma unroll
    for (int vi = 0; vi < NV; ++vi) {
      if (c0 + vi * V >= C) break;
      if constexpr (V == 1) {
        dst[vi] = __float2bfloat16_rn(v[vi]);
      } else {
        uint32_t w[4];
#pragma unroll
        for (int u = 0; u < V / 2; ++u)
          w[u] = pack_bf16(v[vi * V + 2 * u], v[vi * V + 2 * u + 1]);
        if constexpr (V == 8)
          *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
        else if constexpr (V == 4)
          *reinterpret_cast<uint2*>(dst + vi * V) = make_uint2(w[0], w[1]);
        else
          *reinterpret_cast<uint32_t*>(dst + vi * V) = w[0];
      }
    }
  }
}

template <int V>
int launch(const Args& a, cudaStream_t s) {
  const size_t smem = smem_bytes(a.n1);
  cudaError_t e = cudaFuncSetAttribute(
      sk_chain_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(sk_chain_kernel<V>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((a.c + XC - 1) / XC,
            ((a.h + XH - 1) / XH) * ((a.wd + XW - 1) / XW), a.nb);
  sk_chain_kernel<V><<<grid, NT, smem, s>>>(a);
  return (int)cudaGetLastError();
}

// channels per copy: the widest run that the pixel stride (2C bytes) and
// both tensors' addresses allow
int run(const Args& a, cudaStream_t s) {
  int v = 8;
  while (v > 1 && (a.c % v || ((uintptr_t)a.x | (uintptr_t)a.out) % (2 * v)))
    v /= 2;
  switch (v) {
    case 8: return launch<8>(a, s);
    case 4: return launch<4>(a, s);
    case 2: return launch<2>(a, s);
    default: return launch<1>(a, s);
  }
}

}  // namespace chain

template <int MODE>
int run(const Args& a, int dtype, cudaStream_t s) {
  if (a.nb == 0 || a.h == 0 || a.wd == 0 || a.c == 0) return 0;
  if (a.k < 3 || a.k > KMAX || !(a.k & 1) || a.n1 < 0)
    return (int)cudaErrorInvalidValue;
  if (dtype != kBF16) return launch<float, MODE>(a, s);
  if constexpr (MODE == kChain)
    return chain::run(a, s);  // K8's own bf16 body
  else
    return launch<__nv_bfloat16, MODE>(a, s);
}

}  // namespace

// K6. lhs (c, nb*(wd + k - 1), h + k - 1), the zero-padded C-major operand;
// w (c, 1, k, k); b (c); out (c, nb*wd, h). k odd in [3, 15].
extern "C" int sf_dw_banded_mxu(const void* lhs, const void* w, const void* b,
                                void* out, int nb, int h, int wd, int c, int k,
                                int dtype, void* stream) {
  Args a{lhs, w, b, nullptr, nullptr, out, nb, h, wd, c, k, 0};
  return run<kCMajor>(a, dtype, (cudaStream_t)stream);
}

// K7. x, out (nb, h, wd, c) NHWC; w (c, 1, k, k); b (c).
extern "C" int sf_dw_banded_mxu_t(const void* x, const void* w, const void* b,
                                  void* out, int nb, int h, int wd, int c,
                                  int k, int dtype, void* stream) {
  Args a{x, w, b, nullptr, nullptr, out, nb, h, wd, c, k, 0};
  return run<kNHWC>(a, dtype, (cudaStream_t)stream);
}

// K8. x, out (nb, h, wd, c) NHWC; k1w, k1b (n1, c), the k=1 stages (null
// when n1 == 0); w (c, 1, k, k), b (c), the kxk stage.
extern "C" int sf_sk_chain_banded(const void* x, const void* k1w,
                                  const void* k1b, const void* w,
                                  const void* b, void* out, int nb, int h,
                                  int wd, int c, int n1, int k, int dtype,
                                  void* stream) {
  Args a{x, w, b, k1w, k1b, out, nb, h, wd, c, k, n1};
  return run<kChain>(a, dtype, (cudaStream_t)stream);
}

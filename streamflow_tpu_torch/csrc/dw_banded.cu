// K6-K8: the SK block's depthwise k x k conv as a per-channel banded
// (Toeplitz) product on the tensor cores (B10).
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
// K7's bf16 body and the f32 body of K6-K8 (dw_banded_kernel): one block
// of 256 threads per (image, 32 (H) x 64 (W) output region, 8 channels).
// The block loads the haloed region of its 8 channels, (64 + k - 1) rows
// along W x 48 columns along H, zeros outside the image, into shared
// memory as one (W, H) slab per channel (transposing NHWC into it while it
// loads, K8 applying its k=1 stages there), and the weights as the pair
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
// K6's and K8's bf16 bodies are the engine of sk_chain.cuh (shared with
// K5): a block per (image, 32 x 32 outputs, 8 channels), the haloed NHWC
// box by cp.async, a pass that writes the ldmatrix planes (K8 applying its
// k=1 stages once per box pixel there), mma.sync, and an epilogue of the
// kernel's own (K6: rounding and bias; K8: residual and gelu). K7's bf16
// body and the f32 bodies of all three are dw_banded_kernel below.

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

enum Mode { kNHWC = 1, kChain = 2 };

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
      // channels fastest: NHWC's contiguous axis. (Written in this order,
      // the source offset formed apart from the test, on purpose: a
      // version with the offset inside the load's condition ran K7 1.2x to
      // 1.4x slower on the H100.)
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
      v[u] = ok ? to_f(x[src]) : 0.f;
      dst[u] = in_slab ? ch * QSZ + i * LDQ + j : -1;
      cs[u] = c;
      inner[u] = ok;  // inside the image
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

  // epilogue and store, NHWC, channels fastest
  const T* bias = (const T*)a.b;
  T* out = (T*)a.out;
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
      acc[u] = ok ? reinterpret_cast<const float*>(slabs + cl * QSZ)
                        [wl * SLD + hl] : 0.f;
      oi[u] = (((size_t)bi * H + ho) * W + wo) * C + c;
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

template <int MODE>
int run(const Args& a, int dtype, cudaStream_t s) {
  if (a.nb == 0 || a.h == 0 || a.wd == 0 || a.c == 0) return 0;
  if (a.k < 3 || a.k > KMAX || !(a.k & 1) || a.n1 < 0)
    return (int)cudaErrorInvalidValue;
  if (dtype != kBF16) return launch<float, MODE>(a, s);
  if constexpr (MODE == kChain)
    return chain::run<chain::kK8>(a, s);  // the engine, sk_chain.cuh
  else
    return launch<__nv_bfloat16, MODE>(a, s);
}

}  // namespace

// K6. x, out (nb, h, wd, c) NHWC; w (c, 1, k, k); b (c). k odd in [3, 15].
extern "C" int sf_dw_banded_mxu(const void* x, const void* w, const void* b,
                                void* out, int nb, int h, int wd, int c, int k,
                                int dtype, void* stream) {
  Args a{x, w, b, nullptr, nullptr, out, nb, h, wd, c, k, 0};
  if (dtype == kBF16)  // the engine, sk_chain.cuh
    return chain::run<chain::kK6>(a, (cudaStream_t)stream);
  return run<kNHWC>(a, dtype, (cudaStream_t)stream);  // f32: K7's body
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

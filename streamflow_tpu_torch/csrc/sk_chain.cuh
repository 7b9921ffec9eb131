// The SK block's depthwise stack on the tensor cores, NHWC in and out: the
// bf16 body of K8 (sk_chain_banded, dw_banded.cu), K6 (dw_banded_mxu,
// dw_banded.cu) and K5 (dw_chain, dw_chain.cu), one engine and a
// compile-time policy for what runs around its banded conv:
//
//   policy  k=1 stages in the box pass   residual     epilogue
//   kK8     gelu(v + v w + b)            A unrounded  gelu(A + S + b_k)
//   kK5     gelu(v (1 + w) + b)          io(A)        gelu(io(A) + S + b_k)
//   kK6     none (the box goes straight  none         io(io(S) + b_k)
//           into the planes)
//
// S is the f32 sum of the depthwise k x k conv of io(A) with SAME zero
// padding (the halo is 0 after the stages, never gelu(b)); every step is
// f32 in the Pallas kernels' order (__fmul_rn / __fadd_rn: no contraction
// to an FMA) and io(.) rounds to bf16.
//
// The conv, per channel c and image b, X[wp][hp] the zero-padded plane (W
// along rows, H along columns) and w[c][ky][kx] PyTorch's depthwise weights
// (C, 1, k, k):
//   S[wo][ho] = sum_kx sum_hp X[wo + kx][hp] T_kx[hp][ho],
//   T_kx[hp][ho] = w[c][hp - ho][kx] for 0 <= hp - ho < k, else 0,
// on mma.sync m16n8k16 with f32 accumulators: the A fragments are the
// plane's rows shifted by kx (ldmatrix), and since T_kx is Toeplitz every B
// fragment is a pair of consecutive entries of the zero-extended weight
// column w[c][.][kx], kept in shared memory as a table of packed pairs.
//
// One block of 256 threads per (image, 32 x 32 output region, 8 channels),
// two blocks an SM (86 KB of shared memory each):
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
//      go first and keep their A for the residual, which then takes the
//      box's place in shared memory (the box is the same space, so kK6,
//      which keeps none, needs as much shared memory);
//   4. warp i: channel i's 2 m16 x 4 n8 tiles on mma.sync (at k <= 9 the
//      even n8 tiles' all-zero second product is skipped), the sums staged
//      over its plane;
//   5. epilogue: the policy's, one gelu per output at most, whole pixel
//      runs of the 8 channels stored (16 bytes when C % 8 == 0).
// Probe copies of K8 timed on the H100 (PERF.md, section 6) find no phase
// that dominates: the box pass, the products and the epilogue take about a
// fifth of the time each, the loads and the setup less.
#pragma once

#include "common.cuh"

namespace {
namespace chain {

using namespace sf;

typedef __nv_bfloat16 bf16;
constexpr int NT = 256;  // threads per block, one warp per channel
constexpr int KMAX = 15;  // largest kernel size
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

// what runs around the banded conv (see the table above)
enum Policy { kK8 = 0, kK5 = 1, kK6 = 2 };

// x, out (nb, h, wd, c) NHWC; w (c, 1, k, k), b (c), the kxk stage; k1w,
// k1b (n1, c), the k=1 stages (null when n1 == 0; kK6 takes none)
struct Args {
  const void *x, *w, *b, *k1w, *k1b;
  void* out;
  int nb, h, wd, c, k, n1;
};

inline size_t smem_bytes(int n1) {
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

// the k=1 stages on a pixel's XC channels, f32, in the Pallas kernels'
// order: kK8 v + v w + b (_chain_kernel), kK5 v (1 + w) + b (_kernel of
// _dw_conv_kernel.py, prm holding 1 + w), then gelu; the channels' chains
// interleaved
template <int P>
__device__ __forceinline__ void stages(float (&v)[XC], const float2* prm,
                                       int n1) {
  for (int s = 0; s < n1; ++s) {
#pragma unroll
    for (int q = 0; q < XC; ++q) {
      const float2 p = prm[s * XC + q];
      const float y = P == kK5 ? __fmul_rn(v[q], p.x)
                               : __fadd_rn(v[q], __fmul_rn(v[q], p.x));
      v[q] = gelu(__fadd_rn(y, p.y));
    }
  }
}

// warp `ch`: its channel's 32 x 32 region on the tensor cores, sums staged
// at S (rows along W, SLD floats apart). The B register i of a lane is the
// table entry d + 2 clamped to [-2, k] (entries d = -2 and d = k are zero
// pairs). NARROW (k <= 9): the band of an even n8 tile lies in one
// k-chunk, and its second product, all zero weights, is skipped.
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
  // B fragment of n8 tile j, k-chunk s: rows hp = 16 s + 2t(+1) and
  // 16 s + 2t + 8(+1) of column ho = 8 j + g, i.e. the weight pairs at
  // d = 16 s - 8 j + 2t - g (+8): register i holds d = 2t - g - 8 + 8i
  int toff[5];
#pragma unroll
  for (int i = 0; i < 5; ++i)
    toff[i] = min(max(2 * t - g - 8 + 8 * i, -2), k) + 2;
  // ldmatrix x4: lanes 0-15 give rows 0-15 of columns 0-7, lanes 16-31
  // rows 0-15 of columns 8-15
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

// P: the policy; V: channels per copy (8 when C % 8 == 0: 16-byte pixel
// runs; 4 at C = 324, whose 648-byte rows allow 8-byte copies)
template <int P, int V>
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
  // first is used), bias and k=1 parameters (kK5: 1 + w), then the pair
  // table: entry (ch, kx, d + 2) = (w[d][kx], w[d + 1][kx]) for d in
  // [-2, k], zero outside [0, k)
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
    float wk = 0.f, bk = 0.f;
    if (ch < nc) {
      wk = to_f(((const bf16*)a.k1w)[o]);
      bk = to_f(((const bf16*)a.k1b)[o]);
    }
    prm[e] = make_float2(P == kK5 ? __fadd_rn(1.f, wk) : wk, bk);
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

  // 3. one pass over the box, each pixel once, 0 outside the image (the
  // halo stays 0, not gelu(b)), into the channel planes (row i, column j):
  // kK6 copies the box's bf16 values; kK8 and kK5 apply the k=1 stages in
  // f32 inside the image, rounded to bf16 into the planes. The centre
  // pixels go first, in the epilogue's order, their A kept for the
  // residual (kK5: rounded, as the products see it)
  auto pass = [&](int i, int j, float (&A)[XC]) {
    const int hh = ho0 + j - R, ww = wo0 + i - R;
    const bool in = hh >= 0 && hh < H && ww >= 0 && ww < W;
    const uint4 v =
        in ? *reinterpret_cast<const uint4*>(raw + (i * cols + j) * XC)
           : make_uint4(0, 0, 0, 0);
    const uint32_t vw[4] = {v.x, v.y, v.z, v.w};
    if constexpr (P == kK6) {
#pragma unroll
      for (int q = 0; q < XC; ++q)
        planes[q * PE + i * LDQ + j] = __ushort_as_bfloat16(
            q & 1 ? vw[q >> 1] >> 16 : vw[q >> 1] & 0xffffu);
    } else {
#pragma unroll
      for (int q = 0; q < XC; ++q)  // bf16 -> f32 is a 16-bit shift
        A[q] = __uint_as_float(q & 1 ? vw[q >> 1] & 0xffff0000u
                                     : vw[q >> 1] << 16);
      if (in) stages<P>(A, prm, n1);
#pragma unroll
      for (int q = 0; q < XC; ++q) {
        const bf16 r = __float2bfloat16_rn(A[q]);
        planes[q * PE + i * LDQ + j] = r;
        if (P == kK5) A[q] = __bfloat162float(r);
      }
    }
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
  if constexpr (P != kK6) {
#pragma unroll
    for (int r = 0; r < NC / NT; ++r) {
      float4* d = reinterpret_cast<float4*>(Ac + (tid + r * NT) * XC);
#pragma unroll
      for (int q = 0; q < XC / 4; ++q)
        d[q] = make_float4(keep[r][4 * q], keep[r][4 * q + 1],
                           keep[r][4 * q + 2], keep[r][4 * q + 3]);
    }
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

  // 5. epilogue, whole pixel runs of the block's channels: kK8 and kK5
  // bf16(gelu(A + S + b)), kK6 bf16(bf16(S) + b)
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
      if constexpr (P == kK6)
        v[q] = __fadd_rn(round_io<bf16>(conv), bias[q]);
      else
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

template <int P, int V>
int launch(const Args& a, cudaStream_t s) {
  const size_t smem = smem_bytes(a.n1);
  cudaError_t e = cudaFuncSetAttribute(
      sk_chain_kernel<P, V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(sk_chain_kernel<P, V>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((a.c + XC - 1) / XC,
            ((a.h + XH - 1) / XH) * ((a.wd + XW - 1) / XW), a.nb);
  sk_chain_kernel<P, V><<<grid, NT, smem, s>>>(a);
  return (int)cudaGetLastError();
}

// the bf16 stack under policy P, k odd in [3, KMAX]; channels per copy:
// the widest run that the pixel stride (2C bytes) and both tensors'
// addresses allow
template <int P>
int run(const Args& a, cudaStream_t s) {
  if (a.nb == 0 || a.h == 0 || a.wd == 0 || a.c == 0) return 0;
  if (a.k < 3 || a.k > KMAX || !(a.k & 1) || a.n1 < 0 ||
      (P == kK6 && a.n1 != 0))
    return (int)cudaErrorInvalidValue;
  int v = 8;
  while (v > 1 && (a.c % v || ((uintptr_t)a.x | (uintptr_t)a.out) % (2 * v)))
    v /= 2;
  switch (v) {
    case 8: return launch<P, 8>(a, s);
    case 4: return launch<P, 4>(a, s);
    case 2: return launch<P, 2>(a, s);
    default: return launch<P, 1>(a, s);
  }
}

}  // namespace chain
}  // namespace

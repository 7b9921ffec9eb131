// K3: non-causal flash attention forward, softmax(q k^T) v with q pre-scaled.
//
// Replaces the Pallas kernel streamflow_tpu/ops/pallas/_attention_kernel.py
// (flash_attention_tpu -> pl.pallas_call, body _flash_fwd_kernel), with its
// optional per-row logsumexp output m + log(l) (f32, (B*H, Nq)) that the
// backward (flash_attn_bwd.cu) rebuilds the probabilities from; a null lse
// pointer (inference) skips it.
//
// Math as the TPU kernel: f32 scores, f32 running max m, sum l and
// accumulator; probabilities rounded to the io type before the P.V product
// (the TPU kernel's p.astype(v.dtype)); padded kv columns of the last tile
// take a large finite negative score (not -inf, whose exp(-inf - -inf)
// would be NaN); a row with l == 0 divides by 1 and takes log 1 in lse.
//
// Bound on the H100: the two products and the exp per score. Design: one
// block walks all kv tiles for its query tile (the TPU's sequential kv
// grid axis becomes a loop) and the (n, m) scores never leave registers.
// bf16: the FlashAttention-2 layout on the tensor cores (mma.sync
// m16n8k16): 4 warps x 16 query rows, Q fragments held in registers, K/V
// tiles of 64 keys staged in shared memory (padded rows, conflict-free),
// the score accumulators re-packed in registers as the P operand of P.V.
// f32 (f32 models only): CUDA cores, K/V tiles staged as f32 with a
// padded row; D/32 threads share a query (32 dims each).

#include "common.cuh"

using namespace sf;

namespace {

constexpr int NT = 256;
constexpr int BK = 32;       // kv rows per tile
constexpr int DQ = 32;       // dims per thread
constexpr int CH = DQ + 4;   // padded sub-row stride (floats)
constexpr float NEG = -0.7f * 3.4028234663852886e38f;

template <typename T, int D>
__global__ void __launch_bounds__(NT)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out,
                     float* __restrict__ lse, int nq, int nk) {
  constexpr int TPQ = D / DQ;        // threads per query
  constexpr int BQ = NT / TPQ;       // queries per block
  constexpr int ROW = TPQ * CH;      // padded kv row (floats)
  __shared__ __align__(16) float ks[BK * ROW];
  __shared__ __align__(16) float vs[BK * ROW];

  const int bh = blockIdx.y;
  const int tid = threadIdx.x;
  const int sub = tid % TPQ;
  const int qi = blockIdx.x * BQ + tid / TPQ;
  const bool valid = qi < nq;
  const size_t qbase = ((size_t)bh * nq + (valid ? qi : 0)) * D + sub * DQ;
  const T* kb = k + (size_t)bh * nk * D;
  const T* vb = v + (size_t)bh * nk * D;

  float qr[DQ], acc[DQ];
#pragma unroll
  for (int i = 0; i < DQ; ++i) {
    qr[i] = to_f(q[qbase + i]);
    acc[i] = 0.f;
  }
  float m_run = NEG, l_run = 0.f;

  for (int j0 = 0; j0 < nk; j0 += BK) {
    __syncthreads();
    for (int e = tid; e < BK * D; e += NT) {
      int j = e / D, d = e % D;
      int dst = j * ROW + (d / DQ) * CH + d % DQ;
      bool in = j0 + j < nk;
      ks[dst] = in ? to_f(kb[(size_t)(j0 + j) * D + d]) : 0.f;
      vs[dst] = in ? to_f(vb[(size_t)(j0 + j) * D + d]) : 0.f;
    }
    __syncthreads();

    float s[BK];
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float4* kr =
          reinterpret_cast<const float4*>(ks + j * ROW + sub * CH);
      float a = 0.f;
#pragma unroll
      for (int i = 0; i < DQ / 4; ++i) {
        float4 kk = kr[i];
        a = fmaf(qr[4 * i], kk.x, a);
        a = fmaf(qr[4 * i + 1], kk.y, a);
        a = fmaf(qr[4 * i + 2], kk.z, a);
        a = fmaf(qr[4 * i + 3], kk.w, a);
      }
#pragma unroll
      for (int o = 1; o < TPQ; o <<= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
      s[j] = (j0 + j < nk) ? a : NEG;
    }
    float mt = m_run;
#pragma unroll
    for (int j = 0; j < BK; ++j) mt = fmaxf(mt, s[j]);
    const float alpha = expf(m_run - mt);
    float lsum = 0.f;
#pragma unroll
    for (int i = 0; i < DQ; ++i) acc[i] *= alpha;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float p = expf(s[j] - mt);
      lsum += p;
      float pr = round_io<T>(p);
      const float4* vr =
          reinterpret_cast<const float4*>(vs + j * ROW + sub * CH);
#pragma unroll
      for (int i = 0; i < DQ / 4; ++i) {
        float4 vv = vr[i];
        acc[4 * i] = fmaf(pr, vv.x, acc[4 * i]);
        acc[4 * i + 1] = fmaf(pr, vv.y, acc[4 * i + 1]);
        acc[4 * i + 2] = fmaf(pr, vv.z, acc[4 * i + 2]);
        acc[4 * i + 3] = fmaf(pr, vv.w, acc[4 * i + 3]);
      }
    }
    l_run = alpha * l_run + lsum;
    m_run = mt;
  }

  if (!valid) return;
  const float inv = (l_run == 0.f) ? 1.f : 1.f / l_run;
#pragma unroll
  for (int i = 0; i < DQ; ++i) out[qbase + i] = from_f<T>(acc[i] * inv);
  if (lse != nullptr && sub == 0)
    lse[(size_t)bh * nq + qi] = m_run + logf(l_run == 0.f ? 1.f : l_run);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out,
           float* lse, int bh, int nq, int nk, cudaStream_t s) {
  constexpr int BQ = NT / (D / DQ);
  dim3 grid((nq + BQ - 1) / BQ, bh);
  flash_fwd_kernel<T, D><<<grid, NT, 0, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, lse, nq, nk);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out,
             float* lse, int bh, int nq, int nk, int d, cudaStream_t s) {
  switch (d) {
    case 32: return launch<T, 32>(q, k, v, out, lse, bh, nq, nk, s);
    case 128: return launch<T, 128>(q, k, v, out, lse, bh, nq, nk, s);
  }
  return (int)cudaErrorInvalidValue;
}

// --------------------------------------------------------------- bf16 path
typedef __nv_bfloat16 bf16;
constexpr int TW = 4;        // warps per block
constexpr int TQ = 16 * TW;  // query rows per block
constexpr int TK = 64;       // keys per tile

template <int D>
__global__ void __launch_bounds__(TW * 32)
    flash_fwd_bf16_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v, bf16* __restrict__ out,
                          float* __restrict__ lse, int nq, int nk) {
  constexpr int LD = D + 8;  // odd multiple of 16 bytes: no bank conflicts
  __shared__ __align__(16) bf16 ks[TK * LD];  // Q tile first, then K tiles
  __shared__ __align__(16) bf16 vs[TK * LD];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, q0 = blockIdx.x * TQ;
  const bf16* kb = k + (size_t)bh * nk * D;
  const bf16* vb = v + (size_t)bh * nk * D;

  load_rows<D, LD, TW * 32>(ks, q + (size_t)bh * nq * D, q0, TQ, nq);
  __syncthreads();
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldmatrix_x4(qf[kk], ks + (warp * 16 + (lane & 15)) * LD + kk * 16 +
                            (lane >> 4) * 8);

  float o[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
  float m_run[2] = {NEG, NEG}, l_run[2] = {0.f, 0.f};  // rows g, g + 8

  for (int j0 = 0; j0 < nk; j0 += TK) {
    __syncthreads();
    load_rows<D, LD, TW * 32>(ks, kb, j0, TK, nk);
    load_rows<D, LD, TW * 32>(vs, vb, j0, TK, nk);
    __syncthreads();

    float s[TK / 8][4];
#pragma unroll
    for (int nt = 0; nt < TK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const bf16* kr = ks + (nt * 8 + g) * LD + kk * 16 + 2 * t;
        mma_bf16(s[nt], qf[kk], *reinterpret_cast<const uint32_t*>(kr),
                 *reinterpret_cast<const uint32_t*>(kr + 8));
      }
    }
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int nt = 0; nt < TK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (j0 + nt * 8 + 2 * t + (e & 1) >= nk) s[nt][e] = NEG;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = expf(m_run[r] - mx[r]);
      m_run[r] = mx[r];
      l_run[r] *= alpha[r];  // lane-partial sums, reduced at the end
    }
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      o[i][0] *= alpha[0];
      o[i][1] *= alpha[0];
      o[i][2] *= alpha[1];
      o[i][3] *= alpha[1];
    }
    uint32_t pf[TK / 16][4];  // P as the A operand, rounded to bf16
#pragma unroll
    for (int nt = 0; nt < TK / 8; ++nt) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = expf(s[nt][e] - mx[e >> 1]);
        l_run[e >> 1] += p[e];
      }
      pf[nt >> 1][(nt & 1) * 2] = pack_bf16(p[0], p[1]);
      pf[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
    }
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk)
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, vs + (kk * 16 + (lane & 15)) * LD + dp * 16 +
                                  (lane >> 4) * 8);
        mma_bf16(o[2 * dp], pf[kk], vf[0], vf[1]);
        mma_bf16(o[2 * dp + 1], pf[kk], vf[2], vf[3]);
      }
  }

  bf16* ob = out + (size_t)bh * nq * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = (l == 0.f) ? 1.f : 1.f / l;
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row >= nq) continue;
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      *reinterpret_cast<uint32_t*>(ob + (size_t)row * D + i * 8 + 2 * t) =
          pack_bf16(o[i][2 * r] * inv, o[i][2 * r + 1] * inv);
    if (lse != nullptr && t == 0)
      lse[(size_t)bh * nq + row] = m_run[r] + logf(l == 0.f ? 1.f : l);
  }
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* out,
                float* lse, int bh, int nq, int nk, cudaStream_t s) {
  dim3 grid((nq + TQ - 1) / TQ, bh);
  flash_fwd_bf16_kernel<D><<<grid, TW * 32, 0, s>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)out, lse, nq,
      nk);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int sf_flash_fwd(const void* q, const void* k, const void* v,
                            void* out, float* lse, int bh, int nq, int nk,
                            int d, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (bh == 0 || nq == 0) return 0;
  if (dtype == sf::kBF16) {
    switch (d) {
      case 32: return launch_bf16<32>(q, k, v, out, lse, bh, nq, nk, s);
      case 128: return launch_bf16<128>(q, k, v, out, lse, bh, nq, nk, s);
    }
    return (int)cudaErrorInvalidValue;
  }
  return dispatch<float>(q, k, v, out, lse, bh, nq, nk, d, s);
}

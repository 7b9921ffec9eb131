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
// Bound on the H100: the two products at d=128 (4 d FLOP per score); at
// d=32 the exp per score (MUFU, 16 per clock per SM) before the tensor
// cores; at d=64 (UMT's ViT, 12 heads) and d=384 (UMT's GMA aggregate)
// the products. Design: one block walks all kv tiles for its query tile (the
// TPU's sequential kv grid axis becomes a loop) and the (n, m) scores never
// leave registers. bf16: warp-specialised wgmma. One producer warp keeps a
// ring of K/V tile stages (128 keys at d=128, 64 at d=32) filled by TMA
// (tensor maps built here, mbarriers counting the bytes); two consumer
// warpgroups of 64 query rows each run S = Q.K^T as wgmma from shared
// memory, the online softmax in f32 registers (exp2 with log2 e folded
// into its argument), and O += P.V with P as bf16 register fragments and V
// read MN-major; the next tile's Q.K^T is issued behind P.V. At d=384 a
// 64 x 384 f32 O accumulator would take 192 registers a thread of one
// warpgroup before S and P, and Q with a two-stage ring of 64-key K/V
// tiles 240 KB: there the two consumer warpgroups share one 64-row query
// tile and split O's columns (192 each, as three 64-column wgmmas), each
// computing the same S = Q.K^T (1.5x the tile's operations), over 32-key
// K/V tiles in a ring of three stages (192 KB in all). f32 (f32 models
// only): CUDA cores, K/V tiles staged as f32 with a padded row; D/32
// threads share a query (D/48 at d=384, over 8-key tiles, so that the
// padded tiles fit the 48 KB of static shared memory).

#include "common.cuh"

using namespace sf;

namespace {

constexpr int NT = 256;
constexpr float NEG = -0.7f * 3.4028234663852886e38f;

// the f32 body's tile at head dim D: dims per thread, kv rows per tile
template <int D>
struct F32Tile {
  static constexpr int DQ = D == 384 ? 48 : 32;
  static constexpr int BK = D == 384 ? 8 : 32;
};

template <typename T, int D>
__global__ void __launch_bounds__(NT)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out,
                     float* __restrict__ lse, int nq, int nk) {
  constexpr int DQ = F32Tile<D>::DQ;  // dims per thread
  constexpr int BK = F32Tile<D>::BK;  // kv rows per tile
  constexpr int CH = DQ + 4;         // padded sub-row stride (floats)
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
  constexpr int BQ = NT / (D / F32Tile<D>::DQ);
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
    case 64: return launch<T, 64>(q, k, v, out, lse, bh, nq, nk, s);
    case 128: return launch<T, 128>(q, k, v, out, lse, bh, nq, nk, s);
    case 384: return launch<T, 384>(q, k, v, out, lse, bh, nq, nk, s);
  }
  return (int)cudaErrorInvalidValue;
}

// --------------------------------------------------------------- bf16 path
typedef __nv_bfloat16 bf16;

// Tiles of the bf16 kernel at head dim D. Q, K and V tiles are stored as
// they arrive from TMA: PANEL-wide column panels of row-major rows (128 B
// rows with the 128-byte swizzle at D=64, 128 and 384: one, two and six
// panels; 64 B rows with the 64-byte swizzle at D=32), the layouts the
// wgmma descriptors name.
template <int D>
struct Tiles {
  static constexpr int NWG = 2;                  // consumer warpgroups
  // d=384: both warpgroups on one 64-row query tile, O's columns split
  static constexpr bool SPLIT = D > 128;
  static constexpr int BM = SPLIT ? 64 : 64 * NWG;  // query rows per block
  static constexpr int DW = SPLIT ? D / NWG : D;    // O columns per wg
  // keys per tile: 128 at d=64 and 128; 64 at d=32, where a key costs
  // little and fewer registers let two blocks share an SM; 32 at d=384,
  // where a K/V tile pair is 48 KB
  static constexpr int BN = D == 32 ? 64 : SPLIT ? 32 : 128;
  static constexpr int NS = D == 128 ? 2 : D == 32 ? 4 : 3;  // ring stages
  static constexpr int MINB = D == 32 ? 2 : 1;   // blocks per SM
  static constexpr int PANEL = D < 64 ? D : 64;  // columns per panel
  static constexpr int ROWB = PANEL * 2;         // bytes per panel row
  static constexpr int SBO = 8 * ROWB;           // bytes per 8-row group
  static constexpr uint32_t SWZ = PANEL == 64 ? 1 : 2;  // 128 B / 64 B
  static constexpr int Q_BYTES = BM * D * 2;
  static constexpr int KV_BYTES = BN * D * 2;    // one K or V tile
  static constexpr int BAR_OFF = Q_BYTES + 2 * NS * KV_BYTES;
  static constexpr int SMEM = BAR_OFF + 8 * (2 * NS + 1) + 1024;  // + align
  static constexpr int NTH = NWG * 128 + 32;     // + one producer warp
};

// S (64 x BN keys) = Q rows q0.. of the tile . K_tile^T: D/16 wgmmas,
// both operands K-major
template <int D>
__device__ __forceinline__ void qk_tile(float (&s)[Tiles<D>::BN / 2],
                                        const bf16* qs, const bf16* kt,
                                        int q0) {
  using C = Tiles<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int p = kk * 16 / C::PANEL, c = kk * 16 % C::PANEL;
    const uint64_t da = wgmma_desc(qs + (p * C::BM + q0) * C::PANEL + c,
                                   16, C::SBO, C::SWZ);
    const uint64_t db =
        wgmma_desc(kt + p * C::BN * C::PANEL + c, 16, C::SBO, C::SWZ);
    if constexpr (C::BN == 128)
      wgmma_ss_n128(s, da, db, kk > 0);
    else if constexpr (C::BN == 64)
      wgmma_ss_n64(s, da, db, kk > 0);
    else
      wgmma_ss_n32(s, da, db, kk > 0);
  }
}

// O (64 x DW columns from panel p0) += P (bf16 registers) . V_tile: BN/16
// k steps, V MN-major (its rows are keys: the transpose flag), panels LBO
// apart; a DW of 64 or 192 as one wgmma per 64-column panel
template <int D>
__device__ __forceinline__ void pv_tile(float (&o)[Tiles<D>::DW / 2],
                                        uint32_t (&pf)[Tiles<D>::BN / 16][4],
                                        const bf16* vt, int p0) {
  using C = Tiles<D>;
#pragma unroll
  for (int kk = 0; kk < C::BN / 16; ++kk) {
    if constexpr (C::DW == 128 || C::DW == 32) {
      const uint64_t db = wgmma_desc(vt + kk * 16 * C::PANEL,
                                     C::BN * C::ROWB, C::SBO, C::SWZ);
      if constexpr (C::DW == 128)
        wgmma_rs_n128_mn(o, pf[kk], db, 1);
      else
        wgmma_rs_n32_mn(o, pf[kk], db, 1);
    } else {
#pragma unroll
      for (int c = 0; c < C::DW / 64; ++c) {
        const uint64_t db =
            wgmma_desc(vt + ((p0 + c) * C::BN + kk * 16) * C::PANEL,
                       C::BN * C::ROWB, C::SBO, C::SWZ);
        wgmma_rs_n64_mn(acc32(o + 32 * c), pf[kk], db, 1);
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(Tiles<D>::NTH, Tiles<D>::MINB)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           bf16* __restrict__ out, float* __restrict__ lse,
                           int nq, int nk) {
  using C = Tiles<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  bf16* qs = reinterpret_cast<bf16*>(sm);
  bf16* ks = reinterpret_cast<bf16*>(sm + C::Q_BYTES);
  bf16* vs = reinterpret_cast<bf16*>(sm + C::Q_BYTES + C::NS * C::KV_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + C::BAR_OFF);
  uint64_t* empty = full + C::NS;
  uint64_t* qbar = empty + C::NS;
  const int bh = blockIdx.y, q0 = blockIdx.x * C::BM;
  const int ntiles = (nk + C::BN - 1) / C::BN;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::NS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], C::NWG * 128);
    }
    mbar_init(qbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  // the warpgroup index, known warp-uniform to the compiler (a divergent
  // role branch would make ptxas serialize the consumers' wgmmas)
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == C::NWG) {
    // producer: one thread keeps the ring of K/V stages filled by TMA
    if (threadIdx.x == C::NWG * 128) {
      mbar_expect_tx(qbar, C::Q_BYTES);
      for (int p = 0; p < D / C::PANEL; ++p)
        tma_load_3d(qs + p * C::BM * C::PANEL, &tq, qbar, p * C::PANEL, q0,
                    bh);
      for (int j = 0; j < ntiles; ++j) {
        const int s = j % C::NS;
        mbar_wait(&empty[s], ((j / C::NS) & 1) ^ 1);
        mbar_expect_tx(&full[s], 2 * C::KV_BYTES);
        for (int p = 0; p < D / C::PANEL; ++p) {
          const int off = s * C::BN * D + p * C::BN * C::PANEL;
          tma_load_3d(ks + off, &tk, &full[s], p * C::PANEL, j * C::BN, bh);
          tma_load_3d(vs + off, &tv, &full[s], p * C::PANEL, j * C::BN, bh);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns query rows q0 + qr .. + 63 (qr = 64 wg,
  // or 0 where the two split O's columns: wg's are DW wg .. + DW - 1);
  // this thread holds rows r = warp*16 + g (+8) of them and columns
  // 8i + 2t (+1)
  const int warp = threadIdx.x / 32 % 4;
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const int qr = C::SPLIT ? 0 : wg * 64, oc = C::SPLIT ? wg * C::DW : 0;
  constexpr float L2E = 1.4426950408889634f;
  float o[C::DW / 2], sc[C::BN / 2];
  uint32_t pf[C::BN / 16][4];
#pragma unroll
  for (int i = 0; i < C::DW / 2; ++i) o[i] = 0.f;
  float m_run[2] = {NEG, NEG}, l_run[2] = {0.f, 0.f};

  mbar_wait(qbar, 0);
  if (ntiles > 0) {
    mbar_wait(&full[0], 0);
    wgmma_fence();
    qk_tile<D>(sc, qs, ks, qr);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
  }
  for (int j = 0; j < ntiles; ++j) {
    const int s = j % C::NS;
    if ((j + 1) * C::BN > nk) {  // kv tail: the finite NEG, not -inf
#pragma unroll
      for (int i = 0; i < C::BN / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (j * C::BN + 8 * i + 2 * t + (e & 1) >= nk) sc[4 * i + e] = NEG;
    }
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int i = 0; i < C::BN / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        mx[e >> 1] = fmaxf(mx[e >> 1], sc[4 * i + e]);
    float alpha[2], ml[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = exp2f((m_run[r] - mx[r]) * L2E);
      ml[r] = mx[r] * L2E;
      m_run[r] = mx[r];
      l_run[r] *= alpha[r];  // lane-partial sums, reduced at the end
    }
#pragma unroll
    for (int i = 0; i < C::DW / 8; ++i) {
      o[4 * i] *= alpha[0];
      o[4 * i + 1] *= alpha[0];
      o[4 * i + 2] *= alpha[1];
      o[4 * i + 3] *= alpha[1];
    }
#pragma unroll
    for (int i = 0; i < C::BN / 8; ++i) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = exp2f(fmaf(sc[4 * i + e], L2E, -ml[e >> 1]));
        l_run[e >> 1] += p[e];
      }
      pf[i >> 1][(i & 1) * 2] = pack_bf16(p[0], p[1]);
      pf[i >> 1][(i & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
    }
    fence_regs(o);
#pragma unroll
    for (int kk = 0; kk < C::BN / 16; ++kk) fence_regs(pf[kk]);
    wgmma_fence();
    pv_tile<D>(o, pf, vs + s * C::BN * D, oc / 64);
    wgmma_commit();
    if (j + 1 < ntiles) {  // the next tile's scores run behind P.V
      const int s1 = (j + 1) % C::NS;
      mbar_wait(&full[s1], ((j + 1) / C::NS) & 1);
      qk_tile<D>(sc, qs, ks + s1 * C::BN * D, qr);
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(sc);
#pragma unroll
    for (int kk = 0; kk < C::BN / 16; ++kk) fence_regs(pf[kk]);
    mbar_arrive(&empty[s]);
  }

  bf16* ob = out + (size_t)bh * nq * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = (l == 0.f) ? 1.f : 1.f / l;
    const int row = q0 + qr + warp * 16 + g + 8 * r;
    if (row >= nq) continue;
#pragma unroll
    for (int i = 0; i < C::DW / 8; ++i)
      *reinterpret_cast<uint32_t*>(ob + (size_t)row * D + oc + 8 * i +
                                   2 * t) =
          pack_bf16(o[4 * i + 2 * r] * inv, o[4 * i + 2 * r + 1] * inv);
    if (lse != nullptr && t == 0 && oc == 0)
      lse[(size_t)bh * nq + row] = m_run[r] + logf(l == 0.f ? 1.f : l);
  }
}

// tensor map of a contiguous (bh, rows, d) bf16 tensor, boxes of
// (1, box_rows, panel); rows past the end read as zeros
bool qkv_map(CUtensorMap* m, const void* base, int bh, int rows, int d,
             int panel, int box_rows) {
  const uint64_t dims[3] = {(uint64_t)d, (uint64_t)rows, (uint64_t)bh};
  const uint32_t box[2] = {(uint32_t)panel, (uint32_t)box_rows};
  return tensor_map(m, base, 3, dims, box);
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* out,
                float* lse, int bh, int nq, int nk, cudaStream_t s) {
  using C = Tiles<D>;
  if (encoder() == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  const int rows = nk > 0 ? nk : 1;  // no tile is read when nk == 0
  if (!qkv_map(&tq, q, bh, nq, D, C::PANEL, C::BM) ||
      !qkv_map(&tk, k, bh, rows, D, C::PANEL, C::BN) ||
      !qkv_map(&tv, v, bh, rows, D, C::PANEL, C::BN))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::SMEM);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((nq + C::BM - 1) / C::BM, bh);
  flash_fwd_wgmma_kernel<D><<<grid, C::NTH, C::SMEM, s>>>(
      tq, tk, tv, (bf16*)out, lse, nq, nk);
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
      case 64: return launch_bf16<64>(q, k, v, out, lse, bh, nq, nk, s);
      case 128: return launch_bf16<128>(q, k, v, out, lse, bh, nq, nk, s);
      case 384: return launch_bf16<384>(q, k, v, out, lse, bh, nq, nk, s);
    }
    return (int)cudaErrorInvalidValue;
  }
  return dispatch<float>(q, k, v, out, lse, bh, nq, nk, d, s);
}

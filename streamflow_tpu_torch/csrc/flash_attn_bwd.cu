// B5: the flash-attention backward, dq, dk and dv of softmax(q k^T) v (q
// pre-scaled) from (q, k, v, dO, lse, delta).
//
// Replaces the Pallas kernels of streamflow_tpu/ops/pallas/_attention_kernel.py
// (flash_attention_bwd_tpu -> two pl.pallas_calls: _flash_bwd_dq_kernel and
// _flash_bwd_dkv_kernel). Math as the TPU kernels: the probabilities are
// rebuilt per tile as P = exp(q k^T - lse) in f32 (lse = m + log l from the
// K3 forward), dP = dO v^T in f32, dS = P * (dP - delta) with delta =
// rowsum(dO * O) computed outside the kernels; dS is rounded to the io type
// before the dS k and dS^T q products, P before the P^T dO product; every
// product accumulates in f32 and each output is rounded once (the kernels
// write f32 buffers that the wrapper rounds). Padded kv columns are masked
// in the dq pass, padded q rows in the dk/dv pass (P = 0 there).
//
// Two kernels, like the TPU design: the dq pass holds a block of query rows
// and walks the kv tiles; the dk/dv pass holds a block of keys and walks
// the q tiles (the TPU's sequential grid axis becomes the loop). Bound on
// the H100: the five products per score (S and dP in both passes, dQ, dK,
// dV) on the tensor cores at d=128, 10 d FLOP per score; at d=32 the exp
// per score (MUFU) before them.
// bf16 design (Hopper, K3's pieces): a block holds 128 rows of its own axis
// in shared memory (by TMA), two consumer warpgroups of 64 rows each, and
// one producer warp streams the walked axis's tiles (64 rows of two
// tensors) through a ring of stages by TMA, counted on mbarriers. At
// D = 128 the producer is a whole warpgroup that gives its registers to
// the consumers (setmaxnreg: 40 and 232 a thread; the dk/dv pass holds
// dK, dV, S and dP, 192 f32 a thread, past the 168 ptxas allows a block
// of three warpgroups). Each walked tile: S and dP (64 x 64) as wgmma from
// shared memory (both operands K-major; in the dk/dv pass the transposed
// products S^T = K Q^T and dP^T = V dO^T, so that each warpgroup's rows
// are its keys), the f32 softmax gradient in registers (exp2 with log2 e
// folded in), then the rounded P^T / dS^T (dk/dv) or dS (dq) as bf16
// register fragments into dV += P^T dO, dK += dS^T Q, dQ += dS K (wgmma, B
// MN-major). Each block holds its f32 sums in registers to the end. One
// block fits an SM, so the walked axis is split over gridDim.z where that
// evens out the waves (split_rows): the GMA passes (153 blocks, two waves
// of which the second holds 21) take three slices, the GSA calls' dk/dv
// pass (13 key blocks x 4 heads) five; the blocks of a split walk add
// their sums with f32 atomics into the zeroed buffers, elsewhere (the GSA
// dq pass) each output row is stored once. f32 (f32 models only): CUDA
// cores, D/32 threads per row, the walked axis split over gridDim.z for
// about four blocks per SM.

#include <algorithm>

#include "common.cuh"

using namespace sf;

namespace {

constexpr float NEG = -0.7f * 3.4028234663852886e38f;

// --------------------------------------------------------------- f32 path
constexpr int NT = 256;
constexpr int BK = 32;       // walked rows per tile
constexpr int DQ = 32;       // dims per thread
constexpr int CH = DQ + 4;   // padded sub-row stride (floats)

// rows [r0, r0 + BK) of a (n, D) f32 matrix into shared memory, each row
// split in D/32 sub-rows of stride CH; zeros past row n
template <int D>
__device__ __forceinline__ void load_f32_tile(float* dst, const float* src,
                                              int r0, int n) {
  constexpr int ROW = (D / DQ) * CH;
  for (int e = threadIdx.x; e < BK * D; e += NT) {
    int j = e / D, d = e % D;
    dst[j * ROW + (d / DQ) * CH + d % DQ] =
        r0 + j < n ? src[(size_t)(r0 + j) * D + d] : 0.f;
  }
}

// dot of a thread's 32 dims with a staged sub-row, summed over the TPQ
// threads that share the row
template <int TPQ>
__device__ __forceinline__ float row_dot(const float (&x)[DQ],
                                         const float* r) {
  const float4* r4 = reinterpret_cast<const float4*>(r);
  float a = 0.f;
#pragma unroll
  for (int i = 0; i < DQ / 4; ++i) {
    float4 y = r4[i];
    a = fmaf(x[4 * i], y.x, a);
    a = fmaf(x[4 * i + 1], y.y, a);
    a = fmaf(x[4 * i + 2], y.z, a);
    a = fmaf(x[4 * i + 3], y.w, a);
  }
#pragma unroll
  for (int o = 1; o < TPQ; o <<= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
  return a;
}

template <int D>
__global__ void __launch_bounds__(NT)
    bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               float* __restrict__ dq, int nq, int nk, int chunk) {
  constexpr int TPQ = D / DQ, BQ = NT / TPQ, ROW = TPQ * CH;
  __shared__ __align__(16) float ks[BK * ROW];
  __shared__ __align__(16) float vs[BK * ROW];
  const int bh = blockIdx.y, tid = threadIdx.x, sub = tid % TPQ;
  const int qi = blockIdx.x * BQ + tid / TPQ;
  const bool valid = qi < nq;
  const size_t qbase = ((size_t)bh * nq + (valid ? qi : 0)) * D + sub * DQ;
  const float* kb = k + (size_t)bh * nk * D;
  const float* vb = v + (size_t)bh * nk * D;
  float qr[DQ], dr[DQ], acc[DQ];
#pragma unroll
  for (int i = 0; i < DQ; ++i) {
    qr[i] = valid ? q[qbase + i] : 0.f;
    dr[i] = valid ? dout[qbase + i] : 0.f;
    acc[i] = 0.f;
  }
  const float lr = valid ? lse[(size_t)bh * nq + qi] : 0.f;
  const float dl = valid ? delta[(size_t)bh * nq + qi] : 0.f;
  const int z = blockIdx.z;
  const int j_end = min(nk, (z + 1) * chunk);
  for (int j0 = z * chunk; j0 < j_end; j0 += BK) {
    __syncthreads();
    load_f32_tile<D>(ks, kb, j0, nk);
    load_f32_tile<D>(vs, vb, j0, nk);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      const float* kr = ks + j * ROW + sub * CH;
      const float s = row_dot<TPQ>(qr, kr);
      const float dp = row_dot<TPQ>(dr, vs + j * ROW + sub * CH);
      const float p = expf((j0 + j < nk ? s : NEG) - lr);
      const float ds = p * (dp - dl);
#pragma unroll
      for (int i = 0; i < DQ; ++i) acc[i] = fmaf(ds, kr[i], acc[i]);
    }
  }
  if (!valid) return;
#pragma unroll
  for (int i = 0; i < DQ; ++i) atomicAdd(dq + qbase + i, acc[i]);
}

template <int D>
__global__ void __launch_bounds__(NT)
    bwd_dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, float* __restrict__ dk,
                float* __restrict__ dv, int nq, int nk, int chunk) {
  constexpr int TPQ = D / DQ, BKEY = NT / TPQ, ROW = TPQ * CH;
  __shared__ __align__(16) float qs[BK * ROW];
  __shared__ __align__(16) float dos[BK * ROW];
  __shared__ float ls[BK], dls[BK];
  const int bh = blockIdx.y, tid = threadIdx.x, sub = tid % TPQ;
  const int kj = blockIdx.x * BKEY + tid / TPQ;
  const bool valid = kj < nk;
  const size_t kbase = ((size_t)bh * nk + (valid ? kj : 0)) * D + sub * DQ;
  const float* qb = q + (size_t)bh * nq * D;
  const float* db = dout + (size_t)bh * nq * D;
  float kr[DQ], vr[DQ], gk[DQ], gv[DQ];
#pragma unroll
  for (int i = 0; i < DQ; ++i) {
    kr[i] = valid ? k[kbase + i] : 0.f;
    vr[i] = valid ? v[kbase + i] : 0.f;
    gk[i] = 0.f;
    gv[i] = 0.f;
  }
  const int z = blockIdx.z;
  const int i_end = min(nq, (z + 1) * chunk);
  for (int i0 = z * chunk; i0 < i_end; i0 += BK) {
    __syncthreads();
    load_f32_tile<D>(qs, qb, i0, nq);
    load_f32_tile<D>(dos, db, i0, nq);
    if (tid < BK) {
      const bool in = i0 + tid < nq;
      ls[tid] = in ? lse[(size_t)bh * nq + i0 + tid] : 0.f;
      dls[tid] = in ? delta[(size_t)bh * nq + i0 + tid] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int i = 0; i < BK; ++i) {
      const float* qr = qs + i * ROW + sub * CH;
      const float* dr = dos + i * ROW + sub * CH;
      const float s = row_dot<TPQ>(kr, qr);
      const float dp = row_dot<TPQ>(vr, dr);
      const float p = expf((i0 + i < nq ? s : NEG) - ls[i]);
      const float dsc = p * (dp - dls[i]);
#pragma unroll
      for (int c = 0; c < DQ; ++c) {
        gv[c] = fmaf(p, dr[c], gv[c]);
        gk[c] = fmaf(dsc, qr[c], gk[c]);
      }
    }
  }
  if (!valid) return;
#pragma unroll
  for (int i = 0; i < DQ; ++i) {
    atomicAdd(dk + kbase + i, gk[i]);
    atomicAdd(dv + kbase + i, gv[i]);
  }
}

// rows of the walked axis (n rows in tiles of `tile`) per grid.z slice, for
// `blocks` blocks per slice: about four blocks per SM in all, each slice a
// whole number of tiles and at least four; sets *nz to the slice count
inline int slice_rows(int n, int tile, int blocks, int sms, int* nz) {
  const int tiles = (n + tile - 1) / tile;
  const int split =
      std::max(1, std::min(tiles / 4, (4 * sms + blocks - 1) / blocks));
  const int per = (tiles + split - 1) / split;
  *nz = (tiles + per - 1) / per;
  return per * tile;
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, float* dq, float* dk,
               float* dv, int bh, int nq, int nk, int sms, cudaStream_t s) {
  constexpr int ROWS = NT / (D / DQ);
  const int xq = (nq + ROWS - 1) / ROWS, xk = (nk + ROWS - 1) / ROWS;
  int zq, zk;
  const int cq = slice_rows(nk, BK, xq * bh, sms, &zq);
  const int ck = slice_rows(nq, BK, xk * bh, sms, &zk);
  bwd_dq_f32<D><<<dim3(xq, bh, zq), NT, 0, s>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
      lse, delta, dq, nq, nk, cq);
  int err = (int)cudaGetLastError();
  if (err) return err;
  bwd_dkv_f32<D><<<dim3(xk, bh, zk), NT, 0, s>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
      lse, delta, dk, dv, nq, nk, ck);
  return (int)cudaGetLastError();
}

// --------------------------------------------------------------- bf16 path
typedef __nv_bfloat16 bf16;

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

constexpr float L2E = 1.4426950408889634f;

// Tiles of the bf16 kernels at head dim D. Each block holds BR = 128 rows
// of its own axis (two consumer warpgroups of 64) and walks the other axis
// in tiles of BW = 64 rows through a ring of NS stages; tiles are stored as
// TMA writes them: PANEL-wide column panels of rows (128-byte swizzle at
// D = 128, 64-byte at D = 32), as K3's.
template <int D>
struct BT {
  static constexpr int NWG = 2;
  static constexpr int BR = 64 * NWG;                 // resident rows
  static constexpr int BW = 64;                       // walked rows per tile
  static constexpr int NS = D == 128 ? 3 : 4;         // stages in the ring
  static constexpr int PANEL = D < 64 ? D : 64;
  static constexpr int ROWB = PANEL * 2;
  static constexpr int SBO = 8 * ROWB;
  static constexpr uint32_t SWZ = PANEL == 64 ? 1 : 2;
  static constexpr int RES_BYTES = BR * D * 2;        // one resident tile
  static constexpr int WALK_BYTES = BW * D * 2;       // one walked tile
  // the dk/dv pass's lse (times log2 e) and delta of each walked tile
  static constexpr int LD_OFF = 2 * RES_BYTES + 2 * NS * WALK_BYTES;
  static constexpr int BAR_OFF = LD_OFF + NS * 2 * BW * 4;
  static constexpr int SMEM = BAR_OFF + 8 * (2 * NS + 1) + 1024;
  // + the producer: at D = 128 a whole warpgroup, which gives its
  // registers to the consumers (the dk/dv pass holds 192 f32 a thread);
  // at D = 32 one warp
  static constexpr bool REGS = D == 128;
  static constexpr int NTH = NWG * 128 + (REGS ? 128 : 32);
};

// D (64 x 64) = rows 64 wg.. of a resident tile . a walked tile^T (both
// K-major, the head dim the k axis)
template <int D>
__device__ __forceinline__ void ss_tile(float (&d)[32], const bf16* res,
                                        int wg, const bf16* walk) {
  using C = BT<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int p = kk * 16 / C::PANEL, c = kk * 16 % C::PANEL;
    wgmma_ss_n64(
        d,
        wgmma_desc(res + (p * C::BR + wg * 64) * C::PANEL + c, 16, C::SBO,
                   C::SWZ),
        wgmma_desc(walk + p * C::BW * C::PANEL + c, 16, C::SBO, C::SWZ),
        kk > 0);
  }
}

// O (64 x D) += A (bf16 registers, 64 x 64 walked rows) . walked tile
// (64 x D, MN-major: its rows are the k axis), panels LBO apart
template <int D>
__device__ __forceinline__ void rs_tile(float (&o)[D / 2],
                                        const uint32_t (&af)[4][4],
                                        const bf16* walk) {
  using C = BT<D>;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t db = wgmma_desc(walk + kk * 16 * C::PANEL, C::BW * C::ROWB,
                                   C::SBO, C::SWZ);
    if constexpr (D == 128)
      wgmma_rs_n128_mn(o, af[kk], db, 1);
    else
      wgmma_rs_n32_mn(o, af[kk], db, 1);
  }
}

// accumulator columns 8i + 2t (+1), rows g and g + 8, packed to bf16 as the
// A fragments of the next product (K3's P layout)
__device__ __forceinline__ void pack_frag(uint32_t (&f)[4][4], int i,
                                          const float (&v)[4]) {
  f[i >> 1][(i & 1) * 2] = pack_bf16(v[0], v[1]);
  f[i >> 1][(i & 1) * 2 + 1] = pack_bf16(v[2], v[3]);
}

// rows r of the block's own axis (64 wg + 16 warp + g + 8 rr), D/2 f32
// accumulator columns each: stored, or added where the walk is split
template <int D>
__device__ __forceinline__ void put_rows(float* out, const float (&o)[D / 2],
                                         int row0, int n, int add) {
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = row0 + g + 8 * rr;
    if (row >= n) continue;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      float* p = out + (size_t)row * D + 8 * i + 2 * t;
      if (add) {
        atomicAdd(p, o[4 * i + 2 * rr]);
        atomicAdd(p + 1, o[4 * i + 2 * rr + 1]);
      } else {
        *reinterpret_cast<float2*>(p) =
            make_float2(o[4 * i + 2 * rr], o[4 * i + 2 * rr + 1]);
      }
    }
  }
}

// The dk/dv pass: a block holds 128 keys (K and V by TMA) and walks the
// query tiles of its slice [z chunk, (z + 1) chunk): S^T = K Q^T and
// dP^T = V dO^T (wgmma, shared memory), P^T = exp(S^T - lse) with padded
// query columns zeroed, dS^T = P^T (dP^T - delta); dV += P^T dO and
// dK += dS^T Q with P^T and dS^T as bf16 register fragments.
template <int D>
__global__ void __launch_bounds__(BT<D>::NTH, 1)
    bwd_dkv_wgmma(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tdo,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, float* __restrict__ dk,
                  float* __restrict__ dv, int nq, int nk, int chunk) {
  using C = BT<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  bf16* ks = reinterpret_cast<bf16*>(sm);
  bf16* vs = reinterpret_cast<bf16*>(sm + C::RES_BYTES);
  bf16* qs = reinterpret_cast<bf16*>(sm + 2 * C::RES_BYTES);
  bf16* dos = qs + C::NS * C::BW * D;
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + C::BAR_OFF);
  uint64_t* empty = full + C::NS;
  uint64_t* kvbar = empty + C::NS;
  float* lds = reinterpret_cast<float*>(sm + C::LD_OFF);
  const int bh = blockIdx.y, k0 = blockIdx.x * C::BR;
  const int i0 = blockIdx.z * chunk;
  const int ntiles = cdiv(min(nq, i0 + chunk) - i0, C::BW);

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::NS; ++s) {
      mbar_init(&full[s], 1 + 32);  // the TMA's arrival + the warp's stores
      mbar_init(&empty[s], C::NWG * 128);
    }
    mbar_init(kvbar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int lane = threadIdx.x % 32;
  if (wg == C::NWG) {
    if constexpr (C::REGS) regs_dealloc<40>();
    if (threadIdx.x >= C::NWG * 128 + 32) return;
    // producer warp: lane 0 issues the TMA copies of K, V and each query
    // tile of Q and dO; every lane stores part of the tile's lse and delta
    if (lane == 0) {
      mbar_expect_tx(kvbar, 2 * C::RES_BYTES);
      for (int p = 0; p < D / C::PANEL; ++p) {
        tma_load_3d(ks + p * C::BR * C::PANEL, &tk, kvbar, p * C::PANEL, k0,
                    bh);
        tma_load_3d(vs + p * C::BR * C::PANEL, &tv, kvbar, p * C::PANEL, k0,
                    bh);
      }
    }
    for (int j = 0; j < ntiles; ++j) {
      const int s = j % C::NS, q0 = i0 + j * C::BW;
      mbar_wait(&empty[s], ((j / C::NS) & 1) ^ 1);
      if (lane == 0) {
        mbar_expect_tx(&full[s], 2 * C::WALK_BYTES);
        for (int p = 0; p < D / C::PANEL; ++p) {
          const int off = s * C::BW * D + p * C::BW * C::PANEL;
          tma_load_3d(qs + off, &tq, &full[s], p * C::PANEL, q0, bh);
          tma_load_3d(dos + off, &tdo, &full[s], p * C::PANEL, q0, bh);
        }
      }
      for (int r = lane; r < C::BW; r += 32) {
        const bool in = q0 + r < nq;
        const size_t at = (size_t)bh * nq + q0 + r;
        lds[s * 2 * C::BW + r] = in ? lse[at] * L2E : 0.f;
        lds[s * 2 * C::BW + C::BW + r] = in ? delta[at] : 0.f;
      }
      mbar_arrive(&full[s]);
    }
    return;
  }
  if constexpr (C::REGS) regs_alloc<232>();

  const int warp = threadIdx.x / 32 % 4;
  const int t = lane & 3;
  float gk[D / 2], gv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) gk[i] = gv[i] = 0.f;
  mbar_wait(kvbar, 0);
  for (int j = 0; j < ntiles; ++j) {
    const int s = j % C::NS;
    const bf16* qt = qs + s * C::BW * D;
    const bf16* dt = dos + s * C::BW * D;
    const int q0 = i0 + j * C::BW;
    const float* ml = lds + s * 2 * C::BW;  // the tile's lse * log2 e
    const float* dl = ml + C::BW;           // and delta
    float st[32], dp[32];
    mbar_wait(&full[s], (j / C::NS) & 1);
    wgmma_fence();
    ss_tile<D>(st, ks, wg, qt);
    ss_tile<D>(dp, vs, wg, dt);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(st);
    fence_regs(dp);
    uint32_t pf[4][4], sf[4][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float p[4], d[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * i + 2 * t + (e & 1);  // query column in the tile
        p[e] = q0 + c < nq ? exp2f(fmaf(st[4 * i + e], L2E, -ml[c])) : 0.f;
        d[e] = p[e] * (dp[4 * i + e] - dl[c]);
      }
      pack_frag(pf, i, p);
      pack_frag(sf, i, d);
    }
    fence_regs(gk);
    fence_regs(gv);
    wgmma_fence();
    rs_tile<D>(gv, pf, dt);
    rs_tile<D>(gk, sf, qt);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(gk);
    fence_regs(gv);
    mbar_arrive(&empty[s]);
  }
  const int row0 = k0 + wg * 64 + warp * 16;
  const size_t base = (size_t)bh * nk * D;
  put_rows<D>(dk + base, gk, row0, nk, gridDim.z > 1);
  put_rows<D>(dv + base, gv, row0, nk, gridDim.z > 1);
}

// The dq pass: a block holds 128 query rows (Q and dO by TMA) and walks
// the key tiles of its slice: S = Q K^T, dP = dO V^T, P = exp(S - lse)
// with padded key columns zeroed, dS = P (dP - delta), dQ += dS K with dS
// as bf16 register fragments.
template <int D>
__global__ void __launch_bounds__(BT<D>::NTH, 1)
    bwd_dq_wgmma(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tdo,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dq,
                 int nq, int nk, int chunk) {
  using C = BT<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  bf16* qs = reinterpret_cast<bf16*>(sm);
  bf16* dos = reinterpret_cast<bf16*>(sm + C::RES_BYTES);
  bf16* ks = reinterpret_cast<bf16*>(sm + 2 * C::RES_BYTES);
  bf16* vs = ks + C::NS * C::BW * D;
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + C::BAR_OFF);
  uint64_t* empty = full + C::NS;
  uint64_t* qbar = empty + C::NS;
  const int bh = blockIdx.y, q0 = blockIdx.x * C::BR;
  const int j0 = blockIdx.z * chunk;
  const int ntiles = cdiv(min(nk, j0 + chunk) - j0, C::BW);

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::NS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], C::NWG * 128);
    }
    mbar_init(qbar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == C::NWG) {
    if constexpr (C::REGS) regs_dealloc<40>();
    if (threadIdx.x == C::NWG * 128) {
      mbar_expect_tx(qbar, 2 * C::RES_BYTES);
      for (int p = 0; p < D / C::PANEL; ++p) {
        tma_load_3d(qs + p * C::BR * C::PANEL, &tq, qbar, p * C::PANEL, q0,
                    bh);
        tma_load_3d(dos + p * C::BR * C::PANEL, &tdo, qbar, p * C::PANEL, q0,
                    bh);
      }
      for (int j = 0; j < ntiles; ++j) {
        const int s = j % C::NS;
        mbar_wait(&empty[s], ((j / C::NS) & 1) ^ 1);
        mbar_expect_tx(&full[s], 2 * C::WALK_BYTES);
        for (int p = 0; p < D / C::PANEL; ++p) {
          const int off = s * C::BW * D + p * C::BW * C::PANEL;
          tma_load_3d(ks + off, &tk, &full[s], p * C::PANEL,
                      j0 + j * C::BW, bh);
          tma_load_3d(vs + off, &tv, &full[s], p * C::PANEL,
                      j0 + j * C::BW, bh);
        }
      }
    }
    return;
  }
  if constexpr (C::REGS) regs_alloc<232>();

  const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = q0 + wg * 64 + warp * 16;
  float ml[2], dl[2];  // rows g, g + 8
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = row0 + g + 8 * rr;
    ml[rr] = row < nq ? lse[(size_t)bh * nq + row] * L2E : 0.f;
    dl[rr] = row < nq ? delta[(size_t)bh * nq + row] : 0.f;
  }
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  mbar_wait(qbar, 0);
  for (int j = 0; j < ntiles; ++j) {
    const int s = j % C::NS;
    const bf16* kt = ks + s * C::BW * D;
    const bf16* vt = vs + s * C::BW * D;
    const int kc0 = j0 + j * C::BW;
    float st[32], dp[32];
    mbar_wait(&full[s], (j / C::NS) & 1);
    wgmma_fence();
    ss_tile<D>(st, qs, wg, kt);
    ss_tile<D>(dp, dos, wg, vt);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(st);
    fence_regs(dp);
    uint32_t sf[4][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float d[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = kc0 + 8 * i + 2 * t + (e & 1) < nk
                            ? exp2f(fmaf(st[4 * i + e], L2E, -ml[e >> 1]))
                            : 0.f;
        d[e] = p * (dp[4 * i + e] - dl[e >> 1]);
      }
      pack_frag(sf, i, d);
    }
    fence_regs(acc);
    wgmma_fence();
    rs_tile<D>(acc, sf, kt);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(&empty[s]);
  }
  put_rows<D>(dq + (size_t)bh * nq * D, acc, row0, nq, gridDim.z > 1);
}

// tensor map of a contiguous (bh, rows, D) bf16 tensor in boxes of
// (1, box_rows, PANEL); rows past the end read as zeros
template <int D>
bool bh_map(CUtensorMap* m, const void* base, int bh, int rows,
            int box_rows) {
  const uint64_t dims[3] = {(uint64_t)D, (uint64_t)(rows > 0 ? rows : 1),
                            (uint64_t)bh};
  const uint32_t box[2] = {(uint32_t)BT<D>::PANEL, (uint32_t)box_rows};
  return tensor_map(m, base, 3, dims, box);
}

// slices of the walked axis (n rows in tiles of `tile`) for `blocks`
// blocks of one SM each: the count of slices z (up to 8, each at least
// four tiles) whose waves, ceil(z blocks / sms) of them at 1/z of the walk
// each, take the least time, with 8% more per extra slice for its atomics
// and its resident tiles (the GMA passes: 153 blocks, two waves with
// z = 1, take z = 3; the GSA dk/dv pass takes about two blocks per SM).
// Sets *nz to the slice count, returns the rows per slice (a whole number
// of tiles).
inline int split_rows(int n, int tile, int blocks, int sms, int* nz) {
  const int tiles = cdiv(n, tile);
  int split = 1;
  float best = 1e30f;
  for (int z = 1; z <= std::min(8, std::max(1, tiles / 4)); ++z) {
    const float t = (float)cdiv(blocks * z, sms) / z * (1.f + 0.08f * (z - 1));
    if (t < best * 0.999f) {
      best = t;
      split = z;
    }
  }
  const int per = cdiv(tiles, split);
  *nz = cdiv(tiles, per);
  return per * tile;
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v,
                const void* dout, const float* lse, const float* delta,
                float* dq, float* dk, float* dv, int bh, int nq, int nk,
                int sms, cudaStream_t s) {
  using C = BT<D>;
  if (encoder() == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap q_res, do_res, k_walk, v_walk, q_walk, do_walk, k_res, v_res;
  if (!bh_map<D>(&q_res, q, bh, nq, C::BR) ||
      !bh_map<D>(&do_res, dout, bh, nq, C::BR) ||
      !bh_map<D>(&k_walk, k, bh, nk, C::BW) ||
      !bh_map<D>(&v_walk, v, bh, nk, C::BW) ||
      !bh_map<D>(&q_walk, q, bh, nq, C::BW) ||
      !bh_map<D>(&do_walk, dout, bh, nq, C::BW) ||
      !bh_map<D>(&k_res, k, bh, nk, C::BR) ||
      !bh_map<D>(&v_res, v, bh, nk, C::BR))
    return (int)cudaErrorInvalidValue;
  cudaError_t e;
  if ((e = cudaFuncSetAttribute(bwd_dq_wgmma<D>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                C::SMEM)) != cudaSuccess ||
      (e = cudaFuncSetAttribute(bwd_dkv_wgmma<D>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                C::SMEM)) != cudaSuccess)
    return (int)e;
  const int xq = cdiv(nq, C::BR), xk = cdiv(nk, C::BR);
  int zq, zk;
  const int cq = split_rows(nk, C::BW, xq * bh, sms, &zq);
  const int ck = split_rows(nq, C::BW, xk * bh, sms, &zk);
  bwd_dq_wgmma<D><<<dim3(xq, bh, zq), C::NTH, C::SMEM, s>>>(
      q_res, do_res, k_walk, v_walk, lse, delta, dq, nq, nk, cq);
  int err = (int)cudaGetLastError();
  if (err) return err;
  bwd_dkv_wgmma<D><<<dim3(xk, bh, zk), C::NTH, C::SMEM, s>>>(
      q_walk, do_walk, k_res, v_res, lse, delta, dk, dv, nq, nk, ck);
  return (int)cudaGetLastError();
}

}  // namespace

// dq/dk/dv: zeroed f32 buffers that the kernels add into (the wrapper
// rounds them to the io type).
extern "C" int sf_flash_bwd(const void* q, const void* k, const void* v,
                            const void* dout, const float* lse,
                            const float* delta, float* dq, float* dk,
                            float* dv, int bh, int nq, int nk, int d,
                            int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (bh == 0 || nq == 0 || nk == 0) return 0;
  int dev, sms;
  int err = (int)cudaGetDevice(&dev);
  if (!err)
    err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev);
  if (err) return err;
  if (dtype == sf::kBF16) {
    switch (d) {
      case 32:
        return launch_bf16<32>(q, k, v, dout, lse, delta, dq, dk, dv, bh, nq,
                               nk, sms, s);
      case 128:
        return launch_bf16<128>(q, k, v, dout, lse, delta, dq, dk, dv, bh, nq,
                                nk, sms, s);
    }
    return (int)cudaErrorInvalidValue;
  }
  switch (d) {
    case 32:
      return launch_f32<32>(q, k, v, dout, lse, delta, dq, dk, dv, bh, nq, nk,
                            sms, s);
    case 128:
      return launch_f32<128>(q, k, v, dout, lse, delta, dq, dk, dv, bh, nq,
                             nk, sms, s);
  }
  return (int)cudaErrorInvalidValue;
}

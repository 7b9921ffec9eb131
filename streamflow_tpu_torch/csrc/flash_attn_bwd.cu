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
// product accumulates in f32 and each output is rounded once. Padded kv
// columns are masked in the dq pass (score -0.7 FLT_MAX), padded q rows in
// the dk/dv pass.
//
// Two kernels, like the TPU design: the dq pass, one block per 64 query
// rows walking the kv tiles; the dk/dv pass, one block per 64 keys walking
// the q tiles (the TPU's sequential grid axis becomes the loop). Bound on
// the H100: the five products per score tile (2 in the dq pass, 3 in the
// dk/dv pass, plus the recomputed q k^T in both) and one exp per score.
// Where one walk would leave the card under-filled (GMA: 102 tiles x 3
// heads; GSA: 26 key tiles x 4 heads walking 1620 q tiles), the walked axis
// is split over gridDim.z (sf_flash_bwd picks the split from the SM count).
// Every block adds its partial sums with f32 atomics into zeroed f32
// buffers, which the wrapper rounds once to the io type.
// bf16: tensor cores via mma.sync m16n8k16 (the FlashAttention-2 layout of
// the K3 forward): 4 warps x 16 rows, the walked tiles staged in shared
// memory, score accumulators re-packed in registers as the A operand of the
// next product. f32 (f32 models only): CUDA cores, D/32 threads per row.

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

// --------------------------------------------------------------- bf16 path
typedef __nv_bfloat16 bf16;
constexpr int BW = 4;        // warps per block
constexpr int BR = 16 * BW;  // rows owned by a block (queries or keys)

// walked rows per tile: 32 at d=128 keeps the accumulators in registers
template <int D>
__host__ __device__ constexpr int walk_tile() {
  return D == 128 ? 32 : 64;
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// an accumulator pair (columns c, c + 1 of one row) added into an f32 output
__device__ __forceinline__ void add_pair(float* out, size_t idx, float a,
                                         float b) {
  atomicAdd(out + idx, a);
  atomicAdd(out + idx + 1, b);
}

template <int D>
__global__ void __launch_bounds__(BW * 32)
    bwd_dq_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, float* __restrict__ dq,
                int nq, int nk, int chunk) {
  constexpr int LD = D + 8;  // odd multiple of 16 bytes: no bank conflicts
  constexpr int TK = walk_tile<D>();
  __shared__ __align__(16) bf16 ks[TK * LD];
  __shared__ __align__(16) bf16 vs[TK * LD];
  __shared__ __align__(16) bf16 st[BR * LD];  // Q, then dO, for fragments
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, q0 = blockIdx.x * BR;
  const bf16* kb = k + (size_t)bh * nk * D;
  const bf16* vb = v + (size_t)bh * nk * D;
  const bf16* frag_row = st + (warp * 16 + (lane & 15)) * LD + (lane >> 4) * 8;

  uint32_t qf[D / 16][4], df[D / 16][4];
  load_rows<D, LD, BW * 32>(st, q + (size_t)bh * nq * D, q0, BR, nq);
  __syncthreads();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) ldmatrix_x4(qf[kk], frag_row + kk * 16);
  __syncthreads();
  load_rows<D, LD, BW * 32>(st, dout + (size_t)bh * nq * D, q0, BR, nq);
  __syncthreads();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) ldmatrix_x4(df[kk], frag_row + kk * 16);

  float lr[2], dl[2];  // rows g, g + 8
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    lr[r] = row < nq ? lse[(size_t)bh * nq + row] : 0.f;
    dl[r] = row < nq ? delta[(size_t)bh * nq + row] : 0.f;
  }
  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

  const int z = blockIdx.z;
  const int j_end = min(nk, (z + 1) * chunk);
  for (int j0 = z * chunk; j0 < j_end; j0 += TK) {
    __syncthreads();
    load_rows<D, LD, BW * 32>(ks, kb, j0, TK, nk);
    load_rows<D, LD, BW * 32>(vs, vb, j0, TK, nk);
    __syncthreads();

    float s[TK / 8][4], dp[TK / 8][4];
#pragma unroll
    for (int nt = 0; nt < TK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const bf16* kr = ks + (nt * 8 + g) * LD + kk * 16 + 2 * t;
        const bf16* vr = vs + (nt * 8 + g) * LD + kk * 16 + 2 * t;
        mma_bf16(s[nt], qf[kk], ld32(kr), ld32(kr + 8));
        mma_bf16(dp[nt], df[kk], ld32(vr), ld32(vr + 8));
      }
    }
    uint32_t sf[TK / 16][4];  // dS as the A operand, rounded to bf16
#pragma unroll
    for (int nt = 0; nt < TK / 8; ++nt) {
      float d[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool in = j0 + nt * 8 + 2 * t + (e & 1) < nk;
        const float p = expf((in ? s[nt][e] : NEG) - lr[e >> 1]);
        d[e] = p * (dp[nt][e] - dl[e >> 1]);
      }
      sf[nt >> 1][(nt & 1) * 2] = pack_bf16(d[0], d[1]);
      sf[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(d[2], d[3]);
    }
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk)
#pragma unroll
      for (int c = 0; c < D / 16; ++c) {
        uint32_t kf[4];
        ldmatrix_x4_trans(kf, ks + (kk * 16 + (lane & 15)) * LD + c * 16 +
                                  (lane >> 4) * 8);
        mma_bf16(acc[2 * c], sf[kk], kf[0], kf[1]);
        mma_bf16(acc[2 * c + 1], sf[kk], kf[2], kf[3]);
      }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row >= nq) continue;
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      add_pair(dq, ((size_t)bh * nq + row) * D + i * 8 + 2 * t,
               acc[i][2 * r], acc[i][2 * r + 1]);
  }
}

template <int D>
constexpr int dkv_smem_bytes() {
  return (2 * BR + 2 * walk_tile<D>()) * (D + 8) * 2 + 2 * walk_tile<D>() * 4;
}

template <int D>
__global__ void __launch_bounds__(BW * 32)
    bwd_dkv_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dk,
                 float* __restrict__ dv, int nq, int nk, int chunk) {
  constexpr int LD = D + 8;
  constexpr int QS = walk_tile<D>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + BR * LD;
  bf16* qs = vs + BR * LD;
  bf16* dos = qs + QS * LD;
  float* ls = reinterpret_cast<float*>(dos + QS * LD);
  float* dls = ls + QS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, k0 = blockIdx.x * BR;
  const bf16* qb = q + (size_t)bh * nq * D;
  const bf16* db = dout + (size_t)bh * nq * D;
  const int frag = (warp * 16 + (lane & 15)) * LD + (lane >> 4) * 8;

  load_rows<D, LD, BW * 32>(ks, k + (size_t)bh * nk * D, k0, BR, nk);
  load_rows<D, LD, BW * 32>(vs, v + (size_t)bh * nk * D, k0, BR, nk);
  float gk[D / 8][4], gv[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) gk[i][e] = gv[i][e] = 0.f;

  const int z = blockIdx.z;
  const int i_end = min(nq, (z + 1) * chunk);
  for (int i0 = z * chunk; i0 < i_end; i0 += QS) {
    __syncthreads();
    load_rows<D, LD, BW * 32>(qs, qb, i0, QS, nq);
    load_rows<D, LD, BW * 32>(dos, db, i0, QS, nq);
    for (int e = threadIdx.x; e < QS; e += BW * 32) {
      const bool in = i0 + e < nq;
      ls[e] = in ? lse[(size_t)bh * nq + i0 + e] : 0.f;
      dls[e] = in ? delta[(size_t)bh * nq + i0 + e] : 0.f;
    }
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T: rows = this warp's 16 keys
    float s[QS / 8][4], dp[QS / 8][4];
#pragma unroll
    for (int nt = 0; nt < QS / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t kf[4], vf[4];
      ldmatrix_x4(kf, ks + frag + kk * 16);
      ldmatrix_x4(vf, vs + frag + kk * 16);
#pragma unroll
      for (int nt = 0; nt < QS / 8; ++nt) {
        const bf16* qr = qs + (nt * 8 + g) * LD + kk * 16 + 2 * t;
        const bf16* dr = dos + (nt * 8 + g) * LD + kk * 16 + 2 * t;
        mma_bf16(s[nt], kf, ld32(qr), ld32(qr + 8));
        mma_bf16(dp[nt], vf, ld32(dr), ld32(dr + 8));
      }
    }
    uint32_t pf[QS / 16][4], sf[QS / 16][4];  // P^T, dS^T as A operands
#pragma unroll
    for (int nt = 0; nt < QS / 8; ++nt) {
      float p[4], d[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = nt * 8 + 2 * t + (e & 1);
        p[e] = expf((i0 + c < nq ? s[nt][e] : NEG) - ls[c]);
        d[e] = p[e] * (dp[nt][e] - dls[c]);
      }
      pf[nt >> 1][(nt & 1) * 2] = pack_bf16(p[0], p[1]);
      pf[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
      sf[nt >> 1][(nt & 1) * 2] = pack_bf16(d[0], d[1]);
      sf[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(d[2], d[3]);
    }
    // dV += P^T dO, dK += dS^T Q
#pragma unroll
    for (int kk = 0; kk < QS / 16; ++kk)
#pragma unroll
      for (int c = 0; c < D / 16; ++c) {
        const int off = (kk * 16 + (lane & 15)) * LD + c * 16 + (lane >> 4) * 8;
        uint32_t of[4], qf[4];
        ldmatrix_x4_trans(of, dos + off);
        mma_bf16(gv[2 * c], pf[kk], of[0], of[1]);
        mma_bf16(gv[2 * c + 1], pf[kk], of[2], of[3]);
        ldmatrix_x4_trans(qf, qs + off);
        mma_bf16(gk[2 * c], sf[kk], qf[0], qf[1]);
        mma_bf16(gk[2 * c + 1], sf[kk], qf[2], qf[3]);
      }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = k0 + warp * 16 + g + 8 * r;
    if (row >= nk) continue;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      const size_t idx = ((size_t)bh * nk + row) * D + i * 8 + 2 * t;
      add_pair(dk, idx, gk[i][2 * r], gk[i][2 * r + 1]);
      add_pair(dv, idx, gv[i][2 * r], gv[i][2 * r + 1]);
    }
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

template <int D>
int launch_bf16(const void* q, const void* k, const void* v,
                const void* dout, const float* lse, const float* delta,
                float* dq, float* dk, float* dv, int bh, int nq, int nk,
                int sms, cudaStream_t s) {
  constexpr int TILE = walk_tile<D>();
  constexpr int SMEM = dkv_smem_bytes<D>();
  const int xq = (nq + BR - 1) / BR, xk = (nk + BR - 1) / BR;
  int zq, zk;
  const int cq = slice_rows(nk, TILE, xq * bh, sms, &zq);
  const int ck = slice_rows(nq, TILE, xk * bh, sms, &zk);
  bwd_dq_bf16<D><<<dim3(xq, bh, zq), BW * 32, 0, s>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout, lse,
      delta, dq, nq, nk, cq);
  int err = (int)cudaGetLastError();
  if (err) return err;
  err = (int)cudaFuncSetAttribute(bwd_dkv_bf16<D>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  SMEM);
  if (err) return err;
  bwd_dkv_bf16<D><<<dim3(xk, bh, zk), BW * 32, SMEM, s>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout, lse,
      delta, dk, dv, nq, nk, ck);
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

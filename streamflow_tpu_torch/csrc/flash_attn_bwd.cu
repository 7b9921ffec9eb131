// B5: the flash-attention backward, dq, dk and dv of softmax(q k^T) v (q
// pre-scaled) from (q, k, v, dO, lse, delta), at head dims 32, 64, 128 and
// 384 (K3's: the Twins GSA blocks, UMT's ViT, GMA, and GMA at UMT's
// context_dim 384).
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
// dV) on the tensor cores at d >= 64, 10 d FLOP per score; at d=32 the exp
// per score (MUFU) before them.
// bf16 design (Hopper, K3's pieces) at d = 32, 64 and 128: a block holds
// 128 rows of its own axis in shared memory (by TMA), two consumer
// warpgroups of 64 rows each, and one producer warp streams the walked
// axis's tiles (64 rows of two tensors) through a ring of stages by TMA,
// counted on mbarriers. At D = 128 the producer is a whole warpgroup that
// gives its registers to the consumers (setmaxnreg: 40 and 232 a thread;
// the dk/dv pass holds dK, dV, S and dP, 192 f32 a thread, past the 168
// ptxas allows a block of three warpgroups); at D = 64 the same pass holds
// 128 f32 a thread and a producer warp does. Each walked tile: S and dP
// (64 x 64) as wgmma from shared memory (both operands K-major; in the
// dk/dv pass the transposed products S^T = K Q^T and dP^T = V dO^T, so
// that each warpgroup's rows are its keys), the f32 softmax gradient in
// registers (exp2 with log2 e folded in), then the rounded P^T / dS^T
// (dk/dv) or dS (dq) as bf16 register fragments into dV += P^T dO, dK +=
// dS^T Q, dQ += dS K (wgmma, B MN-major). Each block holds its f32 sums in
// registers to the end.
// bf16 at d = 384 (UMT's GMA), where 128 resident rows of two tensors are
// 192 KB, and dK and dV for 64 keys 2 x 64 x 384 f32 (192 KB, more than a
// warpgroup's registers): a block holds 64 rows of its own axis (two
// tensors, 96 KB) and walks 32-row tiles of two tensors (48 KB a stage,
// two stages: 194 KB in all). Its two consumer warpgroups split the
// output's 384 columns (192 each, 96 f32 a thread, as three m64n64
// wgmmas), and each computes the same scores (S^T, or S and dP) over the
// whole head dim, as K3's d=384 does. The dk/dv pass holds one of dK and
// dV a block: its grid has two blocks per 64 keys, the even one summing
// dK (S^T, dP^T, dS^T Q), the odd one dV (S^T alone, P^T dO); both read
// the same K, V and walked Q, dO tiles. So the scores cost 2x (dq) and 4x
// (S^T in dk/dv) their one computation, 1.6x the five products in all.
// One block fits an SM, so the walked axis is split over gridDim.z where
// that evens out the waves (split_rows): the GMA passes at d=128 (153
// blocks, two waves of which the second holds 21) take three slices, the
// GSA calls' dk/dv pass (13 key blocks x 4 heads) five; the blocks of a
// split walk add their sums with f32 atomics into the zeroed buffers,
// elsewhere each output row is stored once.
// f32 (f32 models only): CUDA cores, D/32 threads per row (D/48 at d=384,
// over 8-row walked tiles, so that two padded tiles fit the 48 KB of
// static shared memory), the walked axis split over gridDim.z for about
// four blocks per SM.

#include <algorithm>

#include "common.cuh"

using namespace sf;

namespace {

constexpr float NEG = -0.7f * 3.4028234663852886e38f;

// --------------------------------------------------------------- f32 path
constexpr int NT = 256;

// the f32 body's tiles at head dim D (K3's F32Tile)
template <int D>
struct F32Tile {
  static constexpr int DQ = D == 384 ? 48 : 32;  // dims per thread
  static constexpr int BK = D == 384 ? 8 : 32;   // walked rows per tile
  static constexpr int CH = DQ + 4;              // padded sub-row (floats)
  static constexpr int TPQ = D / DQ;             // threads per row
  static constexpr int ROWS = NT / TPQ;          // rows per block
  static constexpr int ROW = TPQ * CH;           // padded walked row
};

// rows [r0, r0 + BK) of a (n, D) f32 matrix into shared memory, each row
// split in D/DQ sub-rows of stride CH; zeros past row n
template <int D>
__device__ __forceinline__ void load_f32_tile(float* dst, const float* src,
                                              int r0, int n) {
  using F = F32Tile<D>;
  for (int e = threadIdx.x; e < F::BK * D; e += NT) {
    int j = e / D, d = e % D;
    dst[j * F::ROW + (d / F::DQ) * F::CH + d % F::DQ] =
        r0 + j < n ? src[(size_t)(r0 + j) * D + d] : 0.f;
  }
}

// dot of a thread's DQ dims with a staged sub-row, summed over the TPQ
// threads that share the row
template <int DQ, int TPQ>
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
  using F = F32Tile<D>;
  constexpr int DQ = F::DQ, TPQ = F::TPQ, ROW = F::ROW;
  __shared__ __align__(16) float ks[F::BK * ROW];
  __shared__ __align__(16) float vs[F::BK * ROW];
  const int bh = blockIdx.y, tid = threadIdx.x, sub = tid % TPQ;
  const int qi = blockIdx.x * F::ROWS + tid / TPQ;
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
  for (int j0 = z * chunk; j0 < j_end; j0 += F::BK) {
    __syncthreads();
    load_f32_tile<D>(ks, kb, j0, nk);
    load_f32_tile<D>(vs, vb, j0, nk);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < F::BK; ++j) {
      const float* kr = ks + j * ROW + sub * F::CH;
      const float s = row_dot<DQ, TPQ>(qr, kr);
      const float dp = row_dot<DQ, TPQ>(dr, vs + j * ROW + sub * F::CH);
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
  using F = F32Tile<D>;
  constexpr int DQ = F::DQ, TPQ = F::TPQ, ROW = F::ROW, BK = F::BK;
  __shared__ __align__(16) float qs[BK * ROW];
  __shared__ __align__(16) float dos[BK * ROW];
  __shared__ float ls[BK], dls[BK];
  const int bh = blockIdx.y, tid = threadIdx.x, sub = tid % TPQ;
  const int kj = blockIdx.x * F::ROWS + tid / TPQ;
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
      const float* qr = qs + i * ROW + sub * F::CH;
      const float* dr = dos + i * ROW + sub * F::CH;
      const float s = row_dot<DQ, TPQ>(kr, qr);
      const float dp = row_dot<DQ, TPQ>(vr, dr);
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
  using F = F32Tile<D>;
  const int xq = (nq + F::ROWS - 1) / F::ROWS;
  const int xk = (nk + F::ROWS - 1) / F::ROWS;
  int zq, zk;
  const int cq = slice_rows(nk, F::BK, xq * bh, sms, &zq);
  const int ck = slice_rows(nq, F::BK, xk * bh, sms, &zk);
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

// Tiles of the bf16 kernels at head dim D. Each block holds BR rows of its
// own axis and walks the other axis in tiles of BW rows through a ring of
// NS stages; tiles are stored as TMA writes them: PANEL-wide column panels
// of rows (128-byte swizzle at D >= 64, 64-byte at D = 32), as K3's. At
// D <= 128 the two consumer warpgroups hold 64 resident rows each (BR =
// 128, BW = 64); at D = 384 (SPLIT) they share 64 resident rows and split
// the output's columns, DW each, over 32-row walked tiles.
template <int D>
struct BT {
  static constexpr int NWG = 2;
  static constexpr bool SPLIT = D > 128;
  static constexpr int BR = SPLIT ? 64 : 64 * NWG;    // resident rows
  static constexpr int BW = SPLIT ? 32 : 64;          // walked rows per tile
  static constexpr int DW = SPLIT ? D / NWG : D;      // output cols per wg
  static constexpr int NS = D == 128 ? 3 : SPLIT ? 2 : 4;  // ring stages
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
  // elsewhere one warp
  static constexpr bool REGS = D == 128;
  static constexpr int NTH = NWG * 128 + (REGS ? 128 : 32);
};

// D (64 x BW) = resident rows r0.. (64) . a walked tile^T (both K-major,
// the head dim the k axis)
template <int D>
__device__ __forceinline__ void ss_tile(float (&d)[BT<D>::BW / 2],
                                        const bf16* res, int r0,
                                        const bf16* walk) {
  using C = BT<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int p = kk * 16 / C::PANEL, c = kk * 16 % C::PANEL;
    const uint64_t da = wgmma_desc(res + (p * C::BR + r0) * C::PANEL + c, 16,
                                   C::SBO, C::SWZ);
    const uint64_t db =
        wgmma_desc(walk + p * C::BW * C::PANEL + c, 16, C::SBO, C::SWZ);
    if constexpr (C::BW == 64)
      wgmma_ss_n64(d, da, db, kk > 0);
    else
      wgmma_ss_n32(d, da, db, kk > 0);
  }
}

// O (64 x DW, the columns from panel p0) += A (bf16 registers, 64 x BW
// walked rows) . walked tile (BW x D, MN-major: its rows are the k axis),
// panels LBO apart; at D = 64 and 384 one m64n64 wgmma per 64-column panel
template <int D>
__device__ __forceinline__ void rs_tile(float (&o)[BT<D>::DW / 2],
                                        const uint32_t (&af)[BT<D>::BW / 16][4],
                                        const bf16* walk, int p0) {
  using C = BT<D>;
#pragma unroll
  for (int kk = 0; kk < C::BW / 16; ++kk) {
    if constexpr (D == 128 || D == 32) {
      const uint64_t db = wgmma_desc(walk + kk * 16 * C::PANEL,
                                     C::BW * C::ROWB, C::SBO, C::SWZ);
      if constexpr (D == 128)
        wgmma_rs_n128_mn(o, af[kk], db, 1);
      else
        wgmma_rs_n32_mn(o, af[kk], db, 1);
    } else {
#pragma unroll
      for (int c = 0; c < C::DW / 64; ++c) {
        const uint64_t db =
            wgmma_desc(walk + ((p0 + c) * C::BW + kk * 16) * C::PANEL,
                       C::BW * C::ROWB, C::SBO, C::SWZ);
        wgmma_rs_n64_mn(acc32(o + 32 * c), af[kk], db, 1);
      }
    }
  }
}

// accumulator columns 8i + 2t (+1), rows g and g + 8, packed to bf16 as the
// A fragments of the next product (K3's P layout)
template <int K>
__device__ __forceinline__ void pack_frag(uint32_t (&f)[K][4], int i,
                                          const float (&v)[4]) {
  f[i >> 1][(i & 1) * 2] = pack_bf16(v[0], v[1]);
  f[i >> 1][(i & 1) * 2 + 1] = pack_bf16(v[2], v[3]);
}

// rows r of the block's own axis (row0 + g + 8 rr), NC f32 accumulator
// columns each into out (row stride D): stored, or added where the walk
// is split
template <int D, int NC>
__device__ __forceinline__ void put_rows(float* out, const float (&o)[NC / 2],
                                         int row0, int n, int add) {
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = row0 + g + 8 * rr;
    if (row >= n) continue;
#pragma unroll
    for (int i = 0; i < NC / 8; ++i) {
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

// The dk/dv pass (D <= 128): a block holds 128 keys (K and V by TMA) and
// walks the query tiles of its slice [z chunk, (z + 1) chunk): S^T = K Q^T
// and dP^T = V dO^T (wgmma, shared memory), P^T = exp(S^T - lse) with
// padded query columns zeroed, dS^T = P^T (dP^T - delta); dV += P^T dO and
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
  static_assert(!C::SPLIT, "d=384 takes bwd_split_wgmma");
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
    ss_tile<D>(st, ks, wg * 64, qt);
    ss_tile<D>(dp, vs, wg * 64, dt);
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
    rs_tile<D>(gv, pf, dt, 0);
    rs_tile<D>(gk, sf, qt, 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(gk);
    fence_regs(gv);
    mbar_arrive(&empty[s]);
  }
  const int row0 = k0 + wg * 64 + warp * 16;
  const size_t base = (size_t)bh * nk * D;
  put_rows<D, D>(dk + base, gk, row0, nk, gridDim.z > 1);
  put_rows<D, D>(dv + base, gv, row0, nk, gridDim.z > 1);
}

// The dq pass (D <= 128): a block holds 128 query rows (Q and dO by TMA)
// and walks the key tiles of its slice: S = Q K^T, dP = dO V^T, P =
// exp(S - lse) with padded key columns zeroed, dS = P (dP - delta), dQ +=
// dS K with dS as bf16 register fragments.
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
  static_assert(!C::SPLIT, "d=384 takes bwd_split_wgmma");
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
    ss_tile<D>(st, qs, wg * 64, kt);
    ss_tile<D>(dp, dos, wg * 64, vt);
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
    rs_tile<D>(acc, sf, kt, 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(&empty[s]);
  }
  put_rows<D, D>(dq + (size_t)bh * nq * D, acc, row0, nq, gridDim.z > 1);
}

// The d=384 passes (BT<D>::SPLIT): a block holds 64 rows of its own axis
// of two tensors, R1 and R2 (TMA), and walks 32-row tiles of two tensors,
// W1 and W2, of the slice [z chunk, (z + 1) chunk) of the other axis.
// Both consumer warpgroups compute the same X = R1 W1^T and Y = R2 W2^T
// (64 x 32, wgmma from shared memory over the whole head dim), and each
// adds F . W (F in bf16 register fragments, W's 32 rows MN-major) into its
// half of the output's columns (192, three m64n64 wgmmas a k step):
//   the dq pass (DQ): R = (Q, dO), W = (K, V): X = S, Y = dP, F = dS =
//     P (dP - delta) with P = exp(S - lse) and each row's lse and delta,
//     padded key columns zeroed; dQ += dS K.
//   the dk/dv pass: R = (K, V), W = (Q, dO); an even block sums dK: X =
//     S^T, Y = dP^T, F = dS^T with the walked query columns' lse and delta
//     (staged by the producer warp), padded ones zeroed; dK += dS^T Q. An
//     odd block sums dV: X = S^T alone, F = P^T; dV += P^T dO.
template <int D, bool DQ>
__global__ void __launch_bounds__(BT<D>::NTH, 1)
    bwd_split_wgmma(const __grid_constant__ CUtensorMap tr1,
                    const __grid_constant__ CUtensorMap tr2,
                    const __grid_constant__ CUtensorMap tw1,
                    const __grid_constant__ CUtensorMap tw2,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    float* __restrict__ out1, float* __restrict__ out2,
                    int nr, int nw, int chunk) {
  using C = BT<D>;
  static_assert(C::SPLIT, "d <= 128 takes bwd_dq_wgmma / bwd_dkv_wgmma");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  bf16* r1s = reinterpret_cast<bf16*>(sm);
  bf16* r2s = reinterpret_cast<bf16*>(sm + C::RES_BYTES);
  bf16* w1s = reinterpret_cast<bf16*>(sm + 2 * C::RES_BYTES);
  bf16* w2s = w1s + C::NS * C::BW * D;
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + C::BAR_OFF);
  uint64_t* empty = full + C::NS;
  uint64_t* rbar = empty + C::NS;
  float* lds = reinterpret_cast<float*>(sm + C::LD_OFF);
  // the dk/dv pass: odd blocks sum dV (S^T alone), even ones dK
  const bool sum_dv = !DQ && (blockIdx.x & 1);
  const int bh = blockIdx.y;
  const int r0 = (DQ ? blockIdx.x : blockIdx.x >> 1) * C::BR;
  const int w0 = blockIdx.z * chunk;
  const int ntiles = cdiv(min(nw, w0 + chunk) - w0, C::BW);

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::NS; ++s) {
      // the TMA's arrival (+ the warp's stores of lse and delta)
      mbar_init(&full[s], DQ ? 1 : 1 + 32);
      mbar_init(&empty[s], C::NWG * 128);
    }
    mbar_init(rbar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int lane = threadIdx.x % 32;
  if (wg == C::NWG) {
    // producer warp: lane 0 issues the TMA copies; in the dk/dv pass every
    // lane stores part of each walked tile's lse and delta
    if (lane == 0) {
      mbar_expect_tx(rbar, 2 * C::RES_BYTES);
      for (int p = 0; p < D / C::PANEL; ++p) {
        tma_load_3d(r1s + p * C::BR * C::PANEL, &tr1, rbar, p * C::PANEL, r0,
                    bh);
        tma_load_3d(r2s + p * C::BR * C::PANEL, &tr2, rbar, p * C::PANEL, r0,
                    bh);
      }
    }
    for (int j = 0; j < ntiles; ++j) {
      const int s = j % C::NS, c0 = w0 + j * C::BW;
      mbar_wait(&empty[s], ((j / C::NS) & 1) ^ 1);
      if (lane == 0) {
        mbar_expect_tx(&full[s], 2 * C::WALK_BYTES);
        for (int p = 0; p < D / C::PANEL; ++p) {
          const int off = s * C::BW * D + p * C::BW * C::PANEL;
          tma_load_3d(w1s + off, &tw1, &full[s], p * C::PANEL, c0, bh);
          tma_load_3d(w2s + off, &tw2, &full[s], p * C::PANEL, c0, bh);
        }
      }
      if (!DQ) {
        for (int r = lane; r < C::BW; r += 32) {
          const bool in = c0 + r < nw;
          const size_t at = (size_t)bh * nw + c0 + r;
          lds[s * 2 * C::BW + r] = in ? lse[at] * L2E : 0.f;
          lds[s * 2 * C::BW + C::BW + r] = in ? delta[at] : 0.f;
        }
        mbar_arrive(&full[s]);
      }
    }
    return;
  }

  const int warp = threadIdx.x / 32 % 4;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = r0 + warp * 16;      // this warp's 16 resident rows
  const int p0 = wg * (C::DW / 64);     // its warpgroup's first panel
  float ml[2] = {0.f, 0.f}, dl[2] = {0.f, 0.f};  // dq: rows g, g + 8
  if (DQ) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int row = row0 + g + 8 * rr;
      ml[rr] = row < nr ? lse[(size_t)bh * nr + row] * L2E : 0.f;
      dl[rr] = row < nr ? delta[(size_t)bh * nr + row] : 0.f;
    }
  }
  float acc[C::DW / 2];
#pragma unroll
  for (int i = 0; i < C::DW / 2; ++i) acc[i] = 0.f;
  mbar_wait(rbar, 0);
  for (int j = 0; j < ntiles; ++j) {
    const int s = j % C::NS;
    const bf16* w1t = w1s + s * C::BW * D;
    const bf16* w2t = w2s + s * C::BW * D;
    const int c0 = w0 + j * C::BW;
    const float* mw = lds + s * 2 * C::BW;  // dk/dv: the columns' lse * log2 e
    const float* dw = mw + C::BW;           // and delta
    float x[C::BW / 2], y[C::BW / 2];
    mbar_wait(&full[s], (j / C::NS) & 1);
    wgmma_fence();
    ss_tile<D>(x, r1s, 0, w1t);
    if (!sum_dv) ss_tile<D>(y, r2s, 0, w2t);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(x);
    if (!sum_dv) fence_regs(y);
    uint32_t f[C::BW / 16][4];
#pragma unroll
    for (int i = 0; i < C::BW / 8; ++i) {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * i + 2 * t + (e & 1);  // walked column in the tile
        const float m = DQ ? ml[e >> 1] : mw[c];
        const float p =
            c0 + c < nw ? exp2f(fmaf(x[4 * i + e], L2E, -m)) : 0.f;
        v[e] = sum_dv ? p : p * (y[4 * i + e] - (DQ ? dl[e >> 1] : dw[c]));
      }
      pack_frag(f, i, v);
    }
    fence_regs(acc);
    wgmma_fence();
    rs_tile<D>(acc, f, sum_dv ? w2t : w1t, p0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(&empty[s]);
  }
  float* out = (sum_dv ? out2 : out1) + (size_t)bh * nr * D + wg * C::DW;
  put_rows<D, C::DW>(out, acc, row0, nr, gridDim.z > 1);
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

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
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
  const int xq = cdiv(nq, C::BR), xk = cdiv(nk, C::BR);
  // the dk/dv pass at d=384 has two blocks (dK, dV) per key block
  const int xkv = C::SPLIT ? 2 * xk : xk;
  int zq, zk;
  const int cq = split_rows(nk, C::BW, xq * bh, sms, &zq);
  const int ck = split_rows(nq, C::BW, xkv * bh, sms, &zk);
  cudaError_t e;
  int err;
  if constexpr (C::SPLIT) {
    if ((e = allow_smem(bwd_split_wgmma<D, true>, C::SMEM)) != cudaSuccess ||
        (e = allow_smem(bwd_split_wgmma<D, false>, C::SMEM)) != cudaSuccess)
      return (int)e;
    bwd_split_wgmma<D, true><<<dim3(xq, bh, zq), C::NTH, C::SMEM, s>>>(
        q_res, do_res, k_walk, v_walk, lse, delta, dq, nullptr, nq, nk, cq);
    if ((err = (int)cudaGetLastError())) return err;
    bwd_split_wgmma<D, false><<<dim3(xkv, bh, zk), C::NTH, C::SMEM, s>>>(
        k_res, v_res, q_walk, do_walk, lse, delta, dk, dv, nk, nq, ck);
  } else {
    if ((e = allow_smem(bwd_dq_wgmma<D>, C::SMEM)) != cudaSuccess ||
        (e = allow_smem(bwd_dkv_wgmma<D>, C::SMEM)) != cudaSuccess)
      return (int)e;
    bwd_dq_wgmma<D><<<dim3(xq, bh, zq), C::NTH, C::SMEM, s>>>(
        q_res, do_res, k_walk, v_walk, lse, delta, dq, nq, nk, cq);
    if ((err = (int)cudaGetLastError())) return err;
    bwd_dkv_wgmma<D><<<dim3(xkv, bh, zk), C::NTH, C::SMEM, s>>>(
        q_walk, do_walk, k_res, v_res, lse, delta, dk, dv, nq, nk, ck);
  }
  return (int)cudaGetLastError();
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, float* dq, float* dk,
           float* dv, int bh, int nq, int nk, int dtype, int sms,
           cudaStream_t s) {
  if (dtype == sf::kBF16)
    return launch_bf16<D>(q, k, v, dout, lse, delta, dq, dk, dv, bh, nq, nk,
                          sms, s);
  return launch_f32<D>(q, k, v, dout, lse, delta, dq, dk, dv, bh, nq, nk,
                       sms, s);
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
  switch (d) {
    case 32:
      return launch<32>(q, k, v, dout, lse, delta, dq, dk, dv, bh, nq, nk,
                        dtype, sms, s);
    case 64:
      return launch<64>(q, k, v, dout, lse, delta, dq, dk, dv, bh, nq, nk,
                        dtype, sms, s);
    case 128:
      return launch<128>(q, k, v, dout, lse, delta, dq, dk, dv, bh, nq, nk,
                         dtype, sms, s);
    case 384:
      return launch<384>(q, k, v, dout, lse, delta, dq, dk, dv, bh, nq, nk,
                         dtype, sms, s);
  }
  return (int)cudaErrorInvalidValue;
}

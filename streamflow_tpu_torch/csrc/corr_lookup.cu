// K1: correlation lookup. For every query, the 9x9 (radius 4) bilinear
// window of the correlation volume f1 . f2_l^T / sqrt(C) at coords / 2^l,
// over the pooled f2 pyramid levels, without ever storing the (N, N) volume.
//
// Replaces the Pallas kernel
// streamflow_tpu/ops/pallas/_fused_lookup_kernel.py
// (fused_corr_lookup_prepared -> pl.pallas_call, body _fused_kernel).
// Per query and level, the (2r+2)^2 = 100 integer taps around
// floor(coords / 2^l) are dot products of C features; taps out of range
// are zero (grid_sample zero padding); the 100 values are scaled by
// 1/sqrt(C) and combined bilinearly into 81 outputs, written x-major
// (channel = level*81 + ix*9 + iy, reference core/corr.py order).
// Coordinates are clamped to [-(r+3), size+r+3] first, which only touches
// windows that lie fully out of range (they stay all zeros).
//
// bf16 (the main path): the TPU kernel's row-plane recompute, on Hopper's
// tensor cores. A block takes one frame pair, one 8x8 tile of queries and
// one pyramid level. It reduces its queries' windows to the box of level
// rows and columns they touch (a query whose window misses the level adds
// nothing), keeps the tile's f1 rows (64 x C) in shared memory, and for
// each box row h computes the plane f1_tile . f2_l[h, x0:x0+N]^T with
// wgmma (N = 128, 64 or 32 columns, whichever covers the rest of the box
// with least waste), f32 accumulators in registers. One producer warp
// streams the box's f2 row segments by TMA (32-column boxes, 64 channels
// each, the 128-byte swizzle; columns past the level read as zeros)
// through a ring of 16 KB stages. After each plane the consumer warpgroup
// copies, straight from its accumulators, the taps each query's window
// needs into a per-query f32 buffer; after the last plane it applies the
// scale and the bilinear weights and stores the 81 channels. Neighbouring
// queries share every f2 row read and every product; the work follows
// the data: a tile of smooth flow touches a box a few rows and columns
// wider than its window, 32 columns wide, uniform coordinates make every
// box the whole level (~100 GFLOP a call at 440x1024).
// Bound on the H100: bytes (f1, the pyramid, coords and the output, ~39 MB
// a call at 440x1024). What holds it back (PERF.md): wide boxes re-read
// their f2 rows from L2 once per tile (1.6 GB a call when every box is
// the whole level), narrow ones pay each block's setup and combine.
//
// f32 (f32 models only): one warp per query; each lane keeps C/32 features
// of f1 in registers, a tap is one coalesced read of the f2 feature row
// plus a warp reduction; whole tap rows out of range are skipped.

#include <limits.h>

#include "common.cuh"

using namespace sf;

namespace {

constexpr int WARPS = 8;
constexpr int MAXL = 4;    // pyramid levels
constexpr int MAXCPL = 16; // channels per lane (C <= 512)
constexpr int MAXR = 4;    // radius
constexpr int KT = 2 * MAXR + 2;

struct Levels {
  const void* f2[MAXL];
  int h[MAXL];
  int w[MAXL];
};

__global__ void __launch_bounds__(WARPS * 32)
    corr_lookup_kernel(const float* __restrict__ f1, Levels lv,
                       const float* __restrict__ coords,
                       float* __restrict__ out, int b, int n, int c, int nl,
                       int r, float scale) {
  __shared__ float taps[WARPS][KT * KT];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int qg = blockIdx.x * WARPS + warp;  // flat (batch, query)
  if (qg >= b * n) return;
  const int bi = qg / n;
  const int cpl = c / 32;
  const int k = 2 * r + 1, kt = 2 * r + 2;
  const int nout = nl * k * k;

  float f1r[MAXCPL];
#pragma unroll
  for (int i = 0; i < MAXCPL; ++i)
    f1r[i] = i < cpl ? f1[(size_t)qg * c + lane + 32 * i] : 0.f;
  const float px = coords[(size_t)qg * 2], py = coords[(size_t)qg * 2 + 1];
  float* tp = taps[warp];

  for (int l = 0; l < nl; ++l) {
    const int hl = lv.h[l], wl = lv.w[l];
    const float* f2 = (const float*)lv.f2[l] + (size_t)bi * hl * wl * c;
    const float inv = 1.0f / (float)(1 << l);
    float cy = fminf(fmaxf(py * inv, -(r + 3.0f)), hl + r + 3.0f);
    float cx = fminf(fmaxf(px * inv, -(r + 3.0f)), wl + r + 3.0f);
    const float y0 = floorf(cy), x0 = floorf(cx);
    const float fy = cy - y0, fx = cx - x0;
    const int iy0 = (int)y0 - r, ix0 = (int)x0 - r;
    for (int dy = 0; dy < kt; ++dy) {
      const int yy = iy0 + dy;
      const bool row_in = yy >= 0 && yy < hl;
      for (int dx = 0; dx < kt; ++dx) {
        const int xx = ix0 + dx;
        float a = 0.f;
        if (row_in && xx >= 0 && xx < wl) {
          const float* row = f2 + ((size_t)yy * wl + xx) * c;
#pragma unroll
          for (int i = 0; i < MAXCPL; ++i)
            if (i < cpl) a = fmaf(f1r[i], row[lane + 32 * i], a);
          a = warp_sum(a);
        }
        if (lane == 0) tp[dy * kt + dx] = a * scale;
      }
    }
    __syncwarp();
    for (int o = lane; o < k * k; o += 32) {
      const int ix = o / k, iy = o % k;
      const float r0 = (1.f - fy) * tp[iy * kt + ix] + fy * tp[(iy + 1) * kt + ix];
      const float r1 =
          (1.f - fy) * tp[iy * kt + ix + 1] + fy * tp[(iy + 1) * kt + ix + 1];
      out[(size_t)qg * nout + l * k * k + o] = (1.f - fx) * r0 + fx * r1;
    }
    __syncwarp();
  }
}

// --------------------------------------------------------------- bf16 path
typedef __nv_bfloat16 bf16;

constexpr int TQ = 8;                 // a tile is TQ x TQ queries,
constexpr int NQ = TQ * TQ;           // wgmma's 64 rows
constexpr int PANEL = 64;             // channels per 128-byte swizzled row
constexpr int SLAB = NQ * PANEL;      // f1 tile elements per panel (8 KB)
constexpr int PIECE = 32;             // columns per TMA box
constexpr int STAGE_COLS = 128;       // a ring stage: 128 columns x 1 panel,
constexpr int STAGE = STAGE_COLS * PANEL;  // or 64 x 2, or 32 x 4 (16 KB)
constexpr int NS = 3;                 // ring stages (two blocks per SM)
constexpr int TAPS = KT * KT;         // per query
constexpr int NTH = 128 + 32;         // consumer warpgroup + producer warp
constexpr int FAR = -(1 << 29);       // window origin of a query that adds
                                      // no tap (off the image or the level)

struct TileArgs {
  int n, c, nl, r, qw;  // queries per pair, channels, levels, radius, and
                        // the width of the raster the 8x8 tiles cut
  int h[MAXL], w[MAXL];
  float scale;
};

// shared memory: the f1 tile's panels, the ring, per-query taps and
// window data, the box, the ring's barriers
struct Smem {
  int nslab;
  __device__ __host__ explicit Smem(int c) : nslab((c + PANEL - 1) / PANEL) {}
  __device__ __host__ int ring() const { return nslab * SLAB * 2; }
  __device__ __host__ int taps() const { return ring() + NS * STAGE * 2; }
  __device__ __host__ int query() const { return taps() + NQ * TAPS * 4; }
  __device__ __host__ int box() const { return query() + 5 * NQ * 4; }
  __device__ __host__ int bars() const { return box() + 16; }
  __device__ __host__ int bytes() const { return bars() + 2 * NS * 8 + 1024; }
};

// columns of the next plane: the narrowest of 128, 64, 32 that covers the
// rest of the box row, or 128
__device__ __forceinline__ int plane_cols(int rest) {
  return rest > 64 ? 128 : rest > 32 ? 64 : 32;
}

template <int N>
__device__ __forceinline__ void wgmma_plane(float (&d)[N / 2], uint64_t da,
                                            uint64_t db, int scale_d) {
  if constexpr (N == 128)
    wgmma_ss_n128(d, da, db, scale_d);
  else if constexpr (N == 64)
    wgmma_ss_n64(d, da, db, scale_d);
  else
    wgmma_ss_n32(d, da, db, scale_d);
}

// One plane of N columns at box row h, column x: the stages of its panels
// (consumed in the producer's order, counted by `it`), then each of this
// thread's two queries (tile rows warp*16 + g and + 8: window origins qy,
// qx, taps tq) takes the taps of its window from the accumulators.
// d[4i + e] holds row g + 8 (e / 2) of the warp's 16, column
// 8i + 2t + e % 2.
template <int N>
__device__ __forceinline__ void plane(const bf16* fa, const bf16* ring,
                                      uint64_t* full, uint64_t* empty,
                                      int& it, int nslab, int h, int x,
                                      const int (&qy)[2], const int (&qx)[2],
                                      float* const (&tq)[2], int kt, int t,
                                      float scale) {
  constexpr int G = STAGE_COLS / N;  // panels per stage
  float d[N / 2];
  int prev = -1;
  for (int p0 = 0; p0 < nslab; p0 += G, ++it) {
    const int s = it % NS;
    mbar_wait(&full[s], (it / NS) & 1);
    const int np = min(G, nslab - p0);
    wgmma_fence();
    for (int j = 0; j < np; ++j) {
#pragma unroll
      for (int kk = 0; kk < PANEL / 16; ++kk) {
        const uint64_t da =
            wgmma_desc(fa + (p0 + j) * SLAB + kk * 16, 16, 1024, 1);
        const uint64_t db = wgmma_desc(
            ring + s * STAGE + j * N * PANEL + kk * 16, 16, 1024, 1);
        wgmma_plane<N>(d, da, db, p0 + j > 0 || kk > 0);
      }
    }
    wgmma_commit();
    if (prev >= 0) {
      wgmma_wait<1>();
      mbar_arrive(&empty[prev]);
    }
    prev = s;
  }
  wgmma_wait<0>();
  fence_regs(d);
  mbar_arrive(&empty[prev]);
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int dy = h - qy[rr];
    if ((unsigned)dy >= (unsigned)kt) continue;
    float* row = tq[rr] + dy * kt;
    const int base = x - qx[rr] + 2 * t;
#pragma unroll
    for (int i = 0; i < N / 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int dx = base + 8 * i + e;
        if ((unsigned)dx < (unsigned)kt)
          row[dx] = d[4 * i + 2 * rr + e] * scale;
      }
  }
}

__global__ void __launch_bounds__(NTH, 2)
    corr_lookup_tile_kernel(const __grid_constant__ CUtensorMap t0,
                            const __grid_constant__ CUtensorMap t1,
                            const __grid_constant__ CUtensorMap t2,
                            const __grid_constant__ CUtensorMap t3,
                            const bf16* __restrict__ f1,
                            const float* __restrict__ coords,
                            bf16* __restrict__ out, TileArgs a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const Smem lay(a.c);
  const int nslab = lay.nslab;
  bf16* fa = reinterpret_cast<bf16*>(sm);
  bf16* ring = reinterpret_cast<bf16*>(sm + lay.ring());
  float* taps = reinterpret_cast<float*>(sm + lay.taps());
  int* qys = reinterpret_cast<int*>(sm + lay.query());
  int* qxs = qys + NQ;
  int* qid = qxs + NQ;  // flat query index, or -1 off the raster
  float* qfy = reinterpret_cast<float*>(qid + NQ);
  float* qfx = qfy + NQ;
  int* box = reinterpret_cast<int*>(sm + lay.box());  // hlo, -hhi, xlo, -xhi
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + lay.bars());
  uint64_t* empty = full + NS;

  const int tiles_x = (a.qw + TQ - 1) / TQ;
  const int ty = blockIdx.x / tiles_x, tx = blockIdx.x - ty * tiles_x;
  const int b = blockIdx.y, l = blockIdx.z;
  const int hl = a.h[l], wl = a.w[l];
  const int r = a.r, k = 2 * r + 1, kt = 2 * r + 2;
  const int tid = threadIdx.x;
  // this thread's query (tid < 64): its coordinates load while the block
  // sets up
  const int qx0 = tx * TQ + (tid & 7);
  const int qi = (ty * TQ + (tid >> 3)) * a.qw + qx0;
  const bool on = tid < NQ && qx0 < a.qw && qi < a.n;
  float2 pc = make_float2(0.f, 0.f);
  if (on)
    pc = *reinterpret_cast<const float2*>(coords + ((size_t)b * a.n + qi) * 2);

  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128);
    }
    mbar_fence_init();
    box[0] = box[1] = box[2] = box[3] = INT_MAX;
  }
  if (tid < 128) {
    // the f1 tile by cp.async, in the 128-byte swizzle TMA would write
    // (16-byte chunk j of row q at chunk j ^ (q % 8)); channels past C and
    // rows off the raster are zeros
    const int cpr = a.c / 8, cpp = nslab * 8;
    for (int e = tid; e < NQ * cpp; e += 128) {
      const int q = e / cpp, j = e - q * cpp;
      const int x = tx * TQ + (q & 7), row = (ty * TQ + (q >> 3)) * a.qw + x;
      bf16* dst = fa + (j >> 3) * SLAB + q * PANEL + ((j & 7) ^ (q & 7)) * 8;
      if (j < cpr && x < a.qw && row < a.n)
        cp_async<16>(dst, f1 + ((size_t)b * a.n + row) * a.c + j * 8);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    }
    for (int e = tid; e < NQ * TAPS / 4; e += 128)
      reinterpret_cast<float4*>(taps)[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();
  if (tid < NQ) {
    // the query's window at this level; only a window that meets the
    // level widens the box
    int ys = FAR, xs = FAR;
    float fy = 0.f, fx = 0.f;
    if (on) {
      const float inv = 1.0f / (float)(1 << l);
      const float cy = fminf(fmaxf(pc.y * inv, -(r + 3.0f)), hl + r + 3.0f);
      const float cx = fminf(fmaxf(pc.x * inv, -(r + 3.0f)), wl + r + 3.0f);
      const float y0 = floorf(cy), x0 = floorf(cx);
      fy = cy - y0;
      fx = cx - x0;
      const int iy = (int)y0 - r, ix = (int)x0 - r;
      if (iy + kt > 0 && iy < hl && ix + kt > 0 && ix < wl) {
        ys = iy;
        xs = ix;
        atomicMin(&box[0], max(iy, 0));
        atomicMin(&box[1], -min(iy + kt - 1, hl - 1));
        atomicMin(&box[2], max(ix, 0));
        atomicMin(&box[3], -min(ix + kt - 1, wl - 1));
      }
    }
    qys[tid] = ys;
    qxs[tid] = xs;
    qid[tid] = on ? qi : -1;
    qfy[tid] = fy;
    qfx[tid] = fx;
  }
  __syncthreads();
  const int hlo = box[0], hhi = -box[1], xlo = box[2], xhi = -box[3];

  // the warpgroup index, known warp-uniform to the compiler (a divergent
  // role branch would make ptxas serialize the wgmmas)
  if (__shfl_sync(0xffffffffu, tid / 128, 0) == 1) {
    // producer: one thread streams the box's row segments, plane by plane
    // and panel group by panel group, in the consumers' order
    if (tid == 128 && hlo <= hhi) {
      const CUtensorMap* tm = l == 0 ? &t0 : l == 1 ? &t1 : l == 2 ? &t2 : &t3;
      int it = 0;
      for (int h = hlo; h <= hhi; ++h)
        for (int x = xlo; x <= xhi;) {
          const int nc = plane_cols(xhi - x + 1), g = STAGE_COLS / nc;
          for (int p0 = 0; p0 < nslab; p0 += g, ++it) {
            const int s = it % NS, np = min(g, nslab - p0);
            mbar_wait(&empty[s], ((it / NS) & 1) ^ 1);
            mbar_expect_tx(&full[s], np * nc * PANEL * 2);
            for (int j = 0; j < np; ++j)
              for (int pc = 0; pc < nc; pc += PIECE)
                tma_load_3d(ring + s * STAGE + (j * nc + pc) * PANEL, tm,
                            &full[s], (p0 + j) * PANEL, x + pc, b * hl + h);
          }
          x += nc;
        }
    }
    return;
  }

  // consumers: this thread holds tile rows warp*16 + g and + 8
  const int warp = tid / 32, lane = tid % 32, g = lane >> 2, t = lane & 3;
  int qy[2], qx[2];
  float* tq[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int q = warp * 16 + g + 8 * rr;
    qy[rr] = qys[q];
    qx[rr] = qxs[q];
    tq[rr] = taps + q * TAPS;
  }
  cp_async_wait_all();
  fence_async_smem();  // the f1 tile, written by this proxy, read by wgmma
  bar_sync(1, 128);
  int it = 0;
  for (int h = hlo; h <= hhi; ++h)
    for (int x = xlo; x <= xhi;) {
      const int nc = plane_cols(xhi - x + 1);
      if (nc == 128)
        plane<128>(fa, ring, full, empty, it, nslab, h, x, qy, qx, tq, kt, t,
                   a.scale);
      else if (nc == 64)
        plane<64>(fa, ring, full, empty, it, nslab, h, x, qy, qx, tq, kt, t,
                  a.scale);
      else
        plane<32>(fa, ring, full, empty, it, nslab, h, x, qy, qx, tq, kt, t,
                  a.scale);
      x += nc;
    }
  bar_sync(1, 128);

  // the bilinear combine of each query's taps, in the f32 body's order: a
  // warp takes every fourth query, lane j its channels j, j + 32, j + 64,
  // so each query's 81 channels of this level leave as one contiguous run
  const int kk2 = k * k, nout = a.nl * kk2;
  int tap[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const int o = lane + 32 * j, ix = o / k;
    tap[j] = (o - ix * k) * kt + ix;  // window row iy, column ix
  }
  for (int q = warp; q < NQ; q += 4) {
    const int qo = qid[q];
    if (qo < 0) continue;
    const float* tp = taps + q * TAPS;
    const float fy = qfy[q], fx = qfx[q];
    bf16* dst = out + ((size_t)b * a.n + qo) * nout + l * kk2;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      if (lane + 32 * j >= kk2) continue;
      const float* tw = tp + tap[j];
      const float r0 = (1.f - fy) * tw[0] + fy * tw[kt];
      const float r1 = (1.f - fy) * tw[1] + fy * tw[kt + 1];
      dst[lane + 32 * j] = __float2bfloat16_rn((1.f - fx) * r0 + fx * r1);
    }
  }
}

int launch_bf16(const void* f1, const Levels& lv, const float* coords,
                void* out, int b, int n, int c, int nl, int r, float scale,
                cudaStream_t s) {
  if (encoder() == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap maps[MAXL] = {};
  TileArgs a = {n, c, nl, r, lv.w[0] > 0 ? lv.w[0] : TQ, {}, {}, scale};
  for (int l = 0; l < MAXL; ++l) {
    a.h[l] = lv.h[l];
    a.w[l] = lv.w[l];
    if (l >= nl || lv.h[l] <= 0 || lv.w[l] <= 0) continue;  // never read
    // level l as (C, Wl, B*Hl): box (64 channels, 32 columns, one row)
    const uint64_t dims[3] = {(uint64_t)c, (uint64_t)lv.w[l],
                              (uint64_t)b * lv.h[l]};
    const uint32_t box[2] = {PANEL, PIECE};
    if (!tensor_map(&maps[l], lv.f2[l], 3, dims, box))
      return (int)cudaErrorInvalidValue;
  }
  const int smem = Smem(c).bytes();
  cudaError_t e = cudaFuncSetAttribute(
      corr_lookup_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  // queries as a raster of level 0's width (the query grid on every path;
  // any raster gives the same result, a coherent one the smallest boxes)
  const int rows = (n + a.qw - 1) / a.qw;
  const dim3 grid(((rows + TQ - 1) / TQ) * ((a.qw + TQ - 1) / TQ), b, nl);
  corr_lookup_tile_kernel<<<grid, NTH, smem, s>>>(
      maps[0], maps[1], maps[2], maps[3], (const bf16*)f1, coords, (bf16*)out,
      a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int sf_corr_lookup(const void* f1, const void* f2_0,
                              const void* f2_1, const void* f2_2,
                              const void* f2_3, const float* coords, void* out,
                              int b, int n, int c, int nl, int h0, int w0,
                              int h1, int w1, int h2, int w2, int h3, int w3,
                              int r, int dtype, float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (nl < 1 || nl > MAXL || c % 32 || c / 32 > MAXCPL || r > MAXR || r < 0)
    return (int)cudaErrorInvalidValue;
  if (b * n == 0) return 0;
  Levels lv = {{f2_0, f2_1, f2_2, f2_3}, {h0, h1, h2, h3}, {w0, w1, w2, w3}};
  if (dtype == sf::kBF16)
    return launch_bf16(f1, lv, coords, out, b, n, c, nl, r, scale, s);
  corr_lookup_kernel<<<(b * n + WARPS - 1) / WARPS, WARPS * 32, 0, s>>>(
      (const float*)f1, lv, coords, (float*)out, b, n, c, nl, r, scale);
  return (int)cudaGetLastError();
}

// K7: the SK block's depthwise k x k conv + bias, NHWC bf16 in and out, on
// the tensor cores: persistent blocks that walk W and keep each channel's
// planes for the next tile's halo, each box loaded two steps ahead.
//
// Replaces streamflow_tpu/ops/pallas/_banded_dw_kernel.py::
// _dw_banded_mxu_t_fwd (pallas_call :223): y = bf16(bf16(S) + b), S the f32
// sum of the depthwise k x k SAME conv of x; x, y (B, H, W, C), w PyTorch's
// (C, 1, k, k), b (C), k odd in [3, 15], any C (the TPU kernel's
// C % 128 == 0 is a lane rule of the TPU). Its f32 launch is the slab body
// of K6-K8 (dw_banded.cu).
//
// The conv, per channel, X[p][hp] the zero-padded plane (W positions along
// rows, H along columns) and T_kx Toeplitz (T_kx[hp][ho] = w[hp - ho][kx]
// for 0 <= hp - ho < k):
//   S[wo][ho] = sum_kx sum_hp X[wo + kx][hp] T_kx[hp][ho],
// on mma.sync m16n8k16 with f32 accumulators, in the order of the engine
// of K5, K6 and K8 (sk_chain.cuh): A the plane's rows shifted by kx
// (ldmatrix), B a packed pair of the weight column w[.][kx] (Toeplitz: one
// table entry per lane and register, the same for every n8 tile); n8 tile
// j reads k16 chunks j / 2 and j / 2 + 1 (the second skipped for even j at
// k <= 9). So K7's f32 sums, and its outputs, equal K6's bit for bit at
// the main path's shapes (one band of rows). m16n8k8 chunks (24 band rows
// an n8 tile at k = 15 against 32) were measured and dropped: 8% faster,
// but 9% more bf16 outputs off the plain version's (one more truncating
// tensor-core accumulation each), and the 'banded_mxu_t' forward then
// missed chip_smoke.py's bf16 accuracy guard (PERF.md, section 6).
//
// Bound on the H100: bytes (x read once, y written once; the convc1 call
// 27.5 MB = 8.2 us at 3.35 TB/s, its 3.1 GFLOP 3.1 us at 989 TFLOP/s).
// What the design does about the rest of the work:
//   - 16 channels a strip, so that every pixel run a block reads or
//     writes is 32 bytes, a whole L2 sector (a first design at 8 channels
//     and 16-byte runs, each sector read and written in two halves by two
//     blocks, spent a quarter of its time in its stores);
//   - persistent blocks, one an SM (the grid is the SM count), each
//     walking strips (image, 16 channels, 56 output rows along H, a run
//     of 16-column tiles along W) in a static round-robin order: no
//     counter in device memory, so a CUDA graph replays it as it is. The
//     run length is chosen on the host (plan() below, mirrored by
//     ops/kernels/dw_banded.py::t_plan) to balance the waves of strips
//     over the SMs;
//   - the planes are a ring of RING positions along W: a tile's k - 1 halo
//     columns stay from the tile before, and each tile loads, transposes
//     and writes only its 16 new columns (a strip's first step loads its
//     HALO left columns alone);
//   - each step's NHWC box (16 channels x LH rows x 16 columns) is loaded
//     into one of NS stages NS steps ahead, right after the plane pass
//     has freed the stage, so that it lands while two steps run: by TMA
//     (from one warp; one 16 x 1 x LH box a column, zeros outside the
//     image, written with the 32-byte swizzle) where the pixel pitch 2C and
//     x's address are whole 16-byte units, else by cp.async from every
//     thread (8 bytes at C % 4 == 0, as convc1's 324; 4 at C % 4 == 2;
//     zero-filled outside the image) or 2-byte loads (odd C), in the same
//     swizzled layout; an mbarrier a stage says when it has landed. (A
//     producer warp beside 16 consumers would cap them at 96 registers: an
//     SM sub-partition would hold 5 warps.)
//   - 16 warps, one a channel: the plane pass moves the stage's
//     8x8 (H x channel) blocks into the channels' planes by ldmatrix.trans
//     and stmatrix; the products run on the planes, the next kx's operands
//     loaded while one kx multiplies; the rounded, biased sums go to a
//     (channel, H, W) tile by stmatrix.trans, and the store pass reads
//     them back transposed (ldmatrix.trans) and, after a 4 x 4 transpose
//     in each quad of lanes, stores 16 bytes a lane, a pixel's 32 bytes
//     by two lanes of one store (8, 4 or 2 bytes where the output's pitch
//     or address allow no more).
// Shared memory 208,272 bytes (NS stages of 36,864, 16 planes of 4,624,
// 16 sums tiles of 2,704, the pair tables 17,280, the barriers): one
// block an SM, 512 threads, 126 registers a thread.

#include "common.cuh"

using namespace sf;

namespace sf {
// the f32 body of K6-K8 (dw_banded.cu)
int dw_banded_f32(const void* x, const void* w, const void* b, void* out,
                  int nb, int h, int wd, int c, int k, cudaStream_t s);
}  // namespace sf

namespace {

typedef __nv_bfloat16 bf16;
constexpr int KMAX = 15;  // largest kernel size
constexpr int CB = 16;    // channels per strip: 32-byte pixel runs
constexpr int TW = 16;    // output columns (W) per tile: one m16 tile
constexpr int HB = 56;    // output rows (H) per strip: seven n8 tiles
constexpr int NJ = HB / 8;
constexpr int LH = 72;    // box rows (H) loaded, >= HB + KMAX - 1 (the band's
                          // fifth k16 chunk reads 8 more: zeros)
constexpr int HALO = 16;  // columns of a strip's first step (>= KMAX - 1)
constexpr int RING = 32;  // plane positions kept (>= TW + KMAX - 1)
constexpr int NS = 2;     // box stages
constexpr int NCW = 16;   // warps, one a channel
constexpr int COLB = LH * 32;       // a box column: LH pixels x 16 channels
constexpr int STAGE = TW * COLB;
constexpr int ROWB = LH * 2;        // a plane row: 144 bytes, so that the 8
                                    // rows of an ldmatrix fall on distinct
                                    // banks (RING * ROWB = 0 mod 128: at
                                    // the ring's wrap too)
constexpr int PS = RING * ROWB + 16;  // plane stride, 16 mod 128: the 8
                                      // channel rows of an stmatrix apart
constexpr int SAR = TW * 2 + 16;    // sums tile row (one H row of TW
                                    // columns), 48 bytes: the 8 rows of an
                                    // stmatrix.trans on distinct banks
constexpr int SA = HB * SAR + 16;   // sums tile stride, 16 mod 128
constexpr int TABW = KMAX + 3;      // pair-table entries per kx: d in [-2, k]
constexpr int TAB_B = CB * KMAX * TABW * 4;
constexpr int SMEM = NS * STAGE + CB * PS + CB * SA + TAB_B + NS * 8;
static_assert(HB + KMAX - 1 <= LH && LH % 8 == 0, "the box covers the band");
static_assert(TW + KMAX - 1 <= RING && (RING & (RING - 1)) == 0 &&
                  HALO >= KMAX - 1 && HALO <= TW,
              "the ring holds a tile and its halo");
static_assert(COLB % 256 == 0, "TMA boxes on the 32-byte swizzle's span");
static_assert((RING * ROWB) % 128 == 0 && PS % 128 == 16 && SA % 128 == 16,
              "bank-conflict-free strides");
static_assert(NCW == CB && TW == 16, "a warp a channel, one m16 tile");
static_assert(SMEM <= 232448, "one block of the H100's shared memory");

// the kernel's arguments and the host's plan of the strips
struct Args {
  const bf16 *x, *w, *b;
  bf16* out;
  int nb, h, wd, c, k;
  int ncg, nbands, tiles_w, tps, nseg, strips;
  int vo;  // channels per output store (8, 4, 2, 1)
};

struct Strip {
  int b, c0, ho0, t0, nt;  // image, first channel, first row, tiles
};

// strip s: runs of tiles fastest, then H bands, channel groups, images
__device__ __forceinline__ Strip strip(const Args& a, int s) {
  const int seg = s % a.nseg;
  s /= a.nseg;
  const int band = s % a.nbands;
  s /= a.nbands;
  const int t0 = seg * a.tps;
  return {s / a.ncg, (s % a.ncg) * CB, band * HB, t0,
          min(a.tps, a.tiles_w - t0)};
}

// the columns a step loads, as ring positions p (input column
// t0 * TW - R + p): a strip's step 0 its HALO left columns, step i >= 1
// tile i - 1's TW new ones
__device__ __forceinline__ int step_p0(int step, int k) {
  return step == 0 ? 0 : k - 1 + TW * (step - 1);
}

// byte offset of channel byte o (0-31) of box row `row` in a column: the
// 16-byte halves of a pixel swapped on rows 4-7 of every 8, as TMA's
// 32-byte swizzle writes them (the 8 rows an ldmatrix reads fall on
// distinct banks)
__device__ __forceinline__ int box_off(int row, int o) {
  return row * 32 + ((((o >> 4) ^ (row >> 2)) & 1) << 4) + (o & 15);
}

// mbar_wait that traps instead of hanging if a handoff never completes
__device__ __forceinline__ void wait(uint64_t* bar, uint32_t parity) {
  for (uint32_t n = 0;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (n > (1u << 24)) __trap();
  }
}

// the loads of a block's steps, NS ahead of the step the block runs: a
// cursor over (strip, step) in the block's walk order
struct Cursor {
  int s, step;
  Strip st;
};

__device__ __forceinline__ void advance(Cursor& cu, const Args& a) {
  if (++cu.step > cu.st.nt) {
    cu.s += gridDim.x;
    cu.step = 0;
    if (cu.s < a.strips) cu.st = strip(a, cu.s);
  }
}

// the cursor's step's box into `dst`, its arrival counted on `full`: by
// TMA from warp 0 (V 0), else by every thread, cp.async of V channels (4,
// 2) or 2-byte loads (V 1)
template <int V>
__device__ void load_box(const CUtensorMap* tx, const Args& a,
                         const Cursor& cu, unsigned char* dst,
                         uint64_t* full) {
  if (cu.s >= a.strips) return;
  const int R = a.k >> 1, tid = threadIdx.x;
  const int w0 = cu.st.t0 * TW - R + step_p0(cu.step, a.k);
  const int h0 = cu.st.ho0 - R;
  if constexpr (V == 0) {
    if (tid < 32) {
      if (tid == 0) mbar_expect_tx(full, STAGE);
      __syncwarp();
      if (tid < TW)
        tma_load_4d(dst + tid * COLB, tx, full, cu.st.c0, w0 + tid, h0,
                    cu.st.b);
    }
  } else {
    // (column, row, channel run) of the box, runs fastest
    constexpr int NV = CB / V;
    for (int i = tid; i < TW * LH * NV; i += 32 * NCW) {
      const int vi = i % NV, q = i / NV;
      const int col = q % TW, row = q / TW;
      const int ww = w0 + col, hh = h0 + row, c = cu.st.c0 + vi * V;
      const bool in = ww >= 0 && ww < a.wd && hh >= 0 && hh < a.h && c < a.c;
      const bf16* src =
          in ? a.x + (((size_t)cu.st.b * a.h + hh) * a.wd + ww) * a.c + c
             : a.x;
      unsigned char* d = dst + col * COLB + box_off(row, vi * 2 * V);
      if constexpr (V == 1)
        *reinterpret_cast<bf16*>(d) = in ? *src : __ushort_as_bfloat16(0);
      else
        cp_async_zfill<2 * V>(d, src, in ? 2 * V : 0);
    }
    if constexpr (V == 1)
      mbar_arrive(full);
    else
      cp_async_mbar_arrive(full);
  }
}

// this warp's A fragments (the plane rows at ring positions pa + kx,
// five k16 chunks) and B registers (kx's pairs at d = 2t - g - 8 + 8i).
// Columns 72-79 (the last chunk's upper half, which meets only zero
// weights) are read from `zp`, 16 zero bytes: past a row they would be the
// next ring row, which may not be written yet (stale, even NaN, bits)
__device__ __forceinline__ void operands(const bf16* ar0, const bf16* zp,
                                         const uint32_t* tb,
                                         const int (&toff)[5], int pa, int kx,
                                         uint32_t (&af)[5][4],
                                         uint32_t (&bw)[5]) {
#pragma unroll
  for (int i = 0; i < 5; ++i) bw[i] = tb[kx * TABW + toff[i]];
  const bf16* ar = ar0 + ((pa + kx) & (RING - 1)) * LH;
#pragma unroll
  for (int q = 0; q < 4; ++q) ldmatrix_x4(af[q], ar + 16 * q);
  ldmatrix_x4(af[4], zp != nullptr ? zp : ar + 64);
}

// the engine's products (sk_chain.cuh): n8 tile j reads k16 chunks j / 2
// and j / 2 + 1, the second skipped at k <= 9 for even j
template <bool NARROW>
__device__ __forceinline__ void products(float (&acc)[NJ][4],
                                         const uint32_t (&af)[5][4],
                                         const uint32_t (&bw)[5]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int s0 = j >> 1, i0 = 2 * s0 - j + 1;
    mma_bf16(acc[j], af[s0], bw[i0], bw[i0 + 1]);
    if (!NARROW || (j & 1)) mma_bf16(acc[j], af[s0 + 1], bw[i0 + 2], bw[i0 + 3]);
  }
}

// v[i] for a lane-dependent i, by selects (no local memory)
__device__ __forceinline__ uint32_t pick(const uint32_t (&v)[4], int i) {
  return i == 0 ? v[0] : i == 1 ? v[1] : i == 2 ? v[2] : v[3];
}

// NARROW: k <= 9, where an even n8 tile's band lies in one k16 chunk
template <bool NARROW, int V>
__global__ void __launch_bounds__(32 * NCW, 1)
    dw_banded_t_kernel(const __grid_constant__ CUtensorMap tx, const Args a) {
  extern __shared__ __align__(1024) unsigned char smem[];
  unsigned char* raw = smem;                 // NS stages of the box
  unsigned char* planes = raw + NS * STAGE;  // CB rings, PS apart
  unsigned char* sums = planes + CB * PS;    // CB (H, W) tiles, SA apart
  uint32_t* tab = reinterpret_cast<uint32_t*>(sums + CB * SA);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + SMEM - NS * 8);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) mbar_init(&full[s], V == 0 ? 1 : 32 * NCW);
    mbar_fence_init();
  }
  // the 16 bytes past each ring: zeros, read as the band's columns 72-79
  if (threadIdx.x < CB)
    *reinterpret_cast<uint4*>(planes + threadIdx.x * PS + RING * ROWB) =
        make_uint4(0, 0, 0, 0);
  __syncthreads();
  // the first NS steps' boxes
  Cursor cu{(int)blockIdx.x, 0, {}};
  if (cu.s < a.strips) cu.st = strip(a, cu.s);
  for (int n = 0; n < NS; ++n, advance(cu, a))
    load_box<V>(&tx, a, cu, raw + n * STAGE, &full[n]);

  const int H = a.h, W = a.wd, C = a.c, k = a.k, vo = a.vo;
  const int ch = warp, g = lane >> 2, t = lane & 3;
  // the passes' lane roles: row r of matrix mi of an x4
  const int mi = lane >> 3, r = lane & 7;
  uint32_t* mytab = tab + ch * KMAX * TABW;
  const bf16* plane = reinterpret_cast<const bf16*>(planes + ch * PS);
  unsigned char* mysums = sums + ch * SA;
  int it = 0;
  for (int s = blockIdx.x; s < a.strips; s += gridDim.x) {
    const Strip st = strip(a, s);
    const int c = st.c0 + ch;
    const bool active = c < C;
    // this channel's pair table: entry (kx, d + 2) = (w[d][kx], w[d+1][kx])
    // for d in [-2, k], zero outside [0, k). (This warp is past its last
    // read of the old one.)
    for (int e = lane; e < KMAX * TABW; e += 32) {
      const int kx = e / TABW, d = e % TABW - 2;
      float lo = 0.f, hi = 0.f;
      if (active && kx < k) {
        const bf16* wc = a.w + (size_t)c * k * k + kx;
        if (d >= 0 && d < k) lo = to_f(wc[d * k]);
        if (d + 1 >= 0 && d + 1 < k) hi = to_f(wc[(d + 1) * k]);
      }
      mytab[e] = pack_bf16(lo, hi);
    }
    __syncwarp();
    const float bias = active ? to_f(a.b[c]) : 0.f;
    for (int step = 0; step <= st.nt; ++step, ++it) {
      const int stage = it % NS, p0 = step_p0(step, k);
      wait(&full[stage], (it / NS) & 1);
      // plane pass: the stage's columns into the rings, 4 columns x 8 rows
      // x 8 channels (one half of the pixel) an item
      const unsigned char* box = raw + stage * STAGE;
      for (int i = warp; i < TW / 4 * (LH / 8) * 2; i += NCW) {
        const int half = i & 1, cg = (i >> 1) / (LH / 8),
                  hg = (i >> 1) % (LH / 8);
        uint32_t v[4];
        ldmatrix_x4_trans(v, reinterpret_cast<const bf16*>(
                                 box + (4 * cg + mi) * COLB +
                                 box_off(8 * hg + r, 16 * half)));
        stmatrix_x4(planes + (8 * half + r) * PS +
                        ((p0 + 4 * cg + mi) & (RING - 1)) * ROWB + hg * 16,
                    v);
      }
      bar_sync(1, NCW * 32);  // the rings are written, the stage is free
      // the box of the step NS ahead into this stage, landing while this
      // step and the next run
      load_box<V>(&tx, a, cu, raw + stage * STAGE, &full[stage]);
      advance(cu, a);
      if (step == 0) continue;

      if (active) {
        // products: the tile's m16 x the band's 7 n8 tiles, the next kx's
        // operands loaded while one kx multiplies
        float acc[NJ][4];
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
        // B of n8 tile j, k16 chunk s: rows hp = 16s + 2t(+1) and
        // 16s + 2t + 8(+1) of column ho = 8j + g, the pairs at
        // d = 16s - 8j + 2t - g (+8): register i holds d = 2t - g - 8 + 8i
        // (clamped to [-2, k], whose entries are zero pairs)
        const uint32_t* tb = mytab;
        int toff[5];
#pragma unroll
        for (int i = 0; i < 5; ++i)
          toff[i] = min(max(2 * t - g - 8 + 8 * i, -2), k) + 2;
        const int pa = TW * (step - 1) + (lane & 15);
        const bf16* ar0 = plane + (lane >> 4) * 8;
        const bf16* zp = lane >= 16 ? plane + RING * LH : nullptr;
        uint32_t af0[5][4], af1[5][4], bw0[5], bw1[5];
        operands(ar0, zp, tb, toff, pa, 0, af0, bw0);
#pragma unroll 1
        for (int kx = 0; kx < k; kx += 2) {
          if (kx + 1 < k) operands(ar0, zp, tb, toff, pa, kx + 1, af1, bw1);
          products<NARROW>(acc, af0, bw0);
          if (kx + 2 < k) operands(ar0, zp, tb, toff, pa, kx + 2, af0, bw0);
          if (kx + 1 < k) products<NARROW>(acc, af1, bw1);
        }
        // bf16(bf16(S) + b), stored transposed: the sums tile's rows are H
        // (8j + row), its columns W. Matrix m = 2j + h2 of the fragments
        // holds rows W 8 h2 + g, columns H 8j + 2t(+1)
        uint32_t o[2 * NJ];
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2)
            o[2 * j + h2] =
                pack_bf16(__fadd_rn(round_io<bf16>(acc[j][2 * h2]), bias),
                          __fadd_rn(round_io<bf16>(acc[j][2 * h2 + 1]), bias));
        auto row = [&](int m) {  // this lane's row of matrix m
          return mysums + (8 * (m >> 1) + r) * SAR + (m & 1) * 16;
        };
#pragma unroll
        for (int q = 0; q < NJ / 2; ++q) {
          const uint32_t v[4] = {o[4 * q], o[4 * q + 1], o[4 * q + 2],
                                 o[4 * q + 3]};
          stmatrix_x4_trans(row(4 * q + mi), v);
        }
        if constexpr (NJ & 1)
          stmatrix_x2_trans(row(2 * NJ - 2 + (mi & 1)), o[2 * NJ - 2],
                            o[2 * NJ - 1]);
      }
      bar_sync(1, NCW * 32);  // the sums tiles are whole

      // store pass, an H row an item: matrix mi = (column group mi / 2,
      // channel half mi % 2), channels 8 half + 2t(+1) of column
      // 8 (mi / 2) + g in lane (g, t) after the ldmatrix; a 4 x 4
      // transpose in each quad gives lane t the 8 channels of half t % 2
      // of column 8 (t / 2) + g: 16 bytes, a pixel's 32 by two lanes of
      // one store
      const int wo = (st.t0 + step - 1) * TW + 8 * (t >> 1) + g;
      const int cc = st.c0 + 8 * (t & 1);
      for (int h = warp; h < HB; h += NCW) {
        uint32_t v[4], q4[4];
        ldmatrix_x4_trans(v, reinterpret_cast<const bf16*>(
                                 sums + (8 * (mi & 1) + r) * SA + h * SAR +
                                 (mi >> 1) * 16));
#pragma unroll
        for (int r2 = 0; r2 < 4; ++r2) {
          const uint32_t got = __shfl_sync(0xffffffffu, pick(v, (t - r2) & 3),
                                           (lane & ~3) | ((t + r2) & 3));
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (((t + r2) & 3) == j) q4[j] = got;
        }
        const int ho = st.ho0 + h;
        if (ho < H && wo < W && cc < C) {
          bf16* o = a.out + (((size_t)st.b * H + ho) * W + wo) * C + cc;
          if (vo == 8) {
            *reinterpret_cast<uint4*>(o) = make_uint4(q4[0], q4[1], q4[2],
                                                      q4[3]);
          } else if (vo == 4) {
            *reinterpret_cast<uint2*>(o) = make_uint2(q4[0], q4[1]);
            if (cc + 4 < C)
              *reinterpret_cast<uint2*>(o + 4) = make_uint2(q4[2], q4[3]);
          } else {
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              if (cc + j >= C) break;
              const uint32_t wv = q4[j >> 1];
              if (vo == 2 && !(j & 1))
                *reinterpret_cast<uint32_t*>(o + j) = wv;
              else if (vo == 1)
                o[j] = __ushort_as_bfloat16(
                    (unsigned short)(j & 1 ? wv >> 16 : wv));
            }
          }
        }
        __syncwarp();
      }
    }
  }
}

// the strips of a call: 8 channels x HB rows x runs of tps tiles; tps
// minimises the waves of strips over `sms` blocks times a strip's cost in
// steps (a tile 4, the halo step 1), the longest run on a tie
void plan(Args& a, int sms) {
  a.tiles_w = (a.wd + TW - 1) / TW;
  a.ncg = (a.c + CB - 1) / CB;
  a.nbands = (a.h + HB - 1) / HB;
  const long base = (long)a.nb * a.ncg * a.nbands;
  long best = -1;
  for (int tps = a.tiles_w; tps >= 1; --tps) {
    const int nseg = (a.tiles_w + tps - 1) / tps;
    const long strips = base * nseg;
    const long cost = (strips + sms - 1) / sms * (4 * tps + 1);
    if (best < 0 || cost < best) {
      best = cost;
      a.tps = tps;
      a.nseg = nseg;
      a.strips = (int)strips;
    }
  }
}

// x's tensor map as (C, W, H, B), CB x 1 x LH x 1 boxes written with the
// 32-byte swizzle, zeros outside the tensor
bool box_map(CUtensorMap* m, const Args& a) {
  if (encoder() == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)a.c, (cuuint64_t)a.wd,
                              (cuuint64_t)a.h, (cuuint64_t)a.nb};
  const cuuint64_t strides[3] = {2ull * a.c, 2ull * a.c * a.wd,
                                 2ull * a.c * a.wd * a.h};
  const cuuint32_t box[4] = {CB, 1, LH, 1}, unit[4] = {1, 1, 1, 1};
  return encoder()(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                   const_cast<bf16*>(a.x), dims, strides, box, unit,
                   CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_32B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool NARROW, int V>
int launch(const Args& a, const CUtensorMap& mx, int grid, cudaStream_t s) {
  auto kernel = dw_banded_t_kernel<NARROW, V>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, 32 * NCW, SMEM, s>>>(mx, a);
  return (int)cudaGetLastError();
}

template <bool NARROW>
int launch_v(const Args& a, int v, const CUtensorMap& mx, int grid,
             cudaStream_t s) {
  switch (v) {
    case 0: return launch<NARROW, 0>(a, mx, grid, s);
    case 4: return launch<NARROW, 4>(a, mx, grid, s);
    case 2: return launch<NARROW, 2>(a, mx, grid, s);
    default: return launch<NARROW, 1>(a, mx, grid, s);
  }
}

// the widest run of channels (8, 4, 2, 1) that the pixel pitch and the
// address allow
int run_width(int c, const void* p) {
  int v = 8;
  while (v > 1 && (c % v || (uintptr_t)p % (2 * v))) v /= 2;
  return v;
}

int run_bf16(Args a, cudaStream_t s) {
  int dev, sms;
  cudaError_t e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return (int)e;
  plan(a, sms);
  // the box by TMA where x's pixel pitch and address are whole 16-byte
  // units, else by cp.async of the widest run they allow; the output by
  // stores of the widest run its pitch and address allow
  int v = run_width(a.c, a.x);
  v = v == 8 ? 0 : v;
  a.vo = run_width(a.c, a.out);
  CUtensorMap mx = {};
  if (v == 0 && !box_map(&mx, a)) return (int)cudaErrorNotSupported;
  const int grid = a.strips < sms ? a.strips : sms;
  return a.k <= 9 ? launch_v<true>(a, v, mx, grid, s)
                  : launch_v<false>(a, v, mx, grid, s);
}

}  // namespace

// K7. x, out (nb, h, wd, c) NHWC; w (c, 1, k, k); b (c). k odd in [3, 15].
extern "C" int sf_dw_banded_mxu_t(const void* x, const void* w, const void* b,
                                  void* out, int nb, int h, int wd, int c,
                                  int k, int dtype, void* stream) {
  if (nb == 0 || h == 0 || wd == 0 || c == 0) return 0;
  if (k < 3 || k > KMAX || !(k & 1)) return (int)cudaErrorInvalidValue;
  if (dtype != kBF16)
    return dw_banded_f32(x, w, b, out, nb, h, wd, c, k, (cudaStream_t)stream);
  Args a{(const bf16*)x, (const bf16*)w, (const bf16*)b, (bf16*)out,
         nb, h, wd, c, k};
  return run_bf16(a, (cudaStream_t)stream);
}

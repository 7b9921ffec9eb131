// K4: locally-grouped (windowed) multi-head attention of Twins-SVT on an
// already-projected qkv grid: (B, Hp, Wp, 3C) -> (B, Hp, Wp, C).
//
// Replaces the Pallas kernel streamflow_tpu/ops/pallas/_lga_kernel.py
// (lga_attention -> pl.pallas_call, body _kernel). Same math as its
// composite layers/twins.py::lga_xla: q scaled in the io type, f32 scores
// and softmax, probabilities rounded to the io type, P.V accumulated in f32
// and rounded to the io type. Padded grid tokens are NOT masked: the module
// zero-pads before the qkv projection, so they hold qkv = bias and take
// part in the attention exactly as in lga_xla.
//
// Bound on the H100: bytes (qkv read once, the output written once; the
// products are ~0.15 MFLOP per 7x7 window and head, far below the tensor
// cores' rate). bf16 design (below): one block per window for all heads,
// so every qkv byte is read once, by 16-byte cp.async of whole token rows;
// the products on mma.sync m16n8k16 (wgmma's 64-row tiles buy nothing on
// 49-token windows); the output staged in shared memory and stored as whole
// token rows. f32 (f32 models only): one block per (window, head, batch),
// q/k/v of the head staged in shared memory (row stride hd+1), one thread
// per query row with its scores in registers. The TPU kernel's lane-mask
// head split and 128-row key padding are not needed.

#include <algorithm>

#include "common.cuh"

using namespace sf;

namespace {

constexpr int MAXS = 64;   // max tokens per window (ws*ws)
constexpr int MAXHD = 32;  // max head dim (static shared memory < 48 KB)
constexpr float NEG = -0.7f * 3.4028234663852886e38f;  // masked keys
constexpr float L2E = 1.4426950408889634f;

// a / b from rb = 1 / b and one correction step (the correctly rounded
// quotient but for rare last-bit cases), in place of IEEE division
__device__ __forceinline__ float div_r(float a, float b, float rb) {
  const float q = a * rb;
  return fmaf(fmaf(-q, b, a), rb, q);
}

template <typename T>
__global__ void __launch_bounds__(MAXS)
    lga_kernel(const T* __restrict__ qkv, T* __restrict__ out, int hp, int wp,
               int c, int nh, int ws, float scale) {
  __shared__ float qs[MAXS][MAXHD + 1];
  __shared__ float ks[MAXS][MAXHD + 1];
  __shared__ float vs[MAXS][MAXHD + 1];
  const int gw = wp / ws;
  const int win = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int gy = win / gw, gx = win % gw;
  const int hd = c / nh, S = ws * ws;
  const int tid = threadIdx.x;

  for (int e = tid; e < S * hd; e += blockDim.x) {
    int t = e / hd, d = e % hd;
    int y = gy * ws + t / ws, x = gx * ws + t % ws;
    size_t base = (((size_t)b * hp + y) * wp + x) * 3 * c + h * hd + d;
    qs[t][d] = round_io<T>(to_f(qkv[base]) * scale);
    ks[t][d] = to_f(qkv[base + c]);
    vs[t][d] = to_f(qkv[base + 2 * c]);
  }
  __syncthreads();
  if (tid >= S) return;

  float s[MAXS];
  float mx = -INFINITY;
#pragma unroll
  for (int j = 0; j < MAXS; ++j) {
    if (j < S) {
      float a = 0.f;
      for (int d = 0; d < hd; ++d) a = fmaf(qs[tid][d], ks[j][d], a);
      s[j] = a;
      mx = fmaxf(mx, a);
    }
  }
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < MAXS; ++j)
    if (j < S) {
      s[j] = expf(s[j] - mx);
      sum += s[j];
    }
#pragma unroll
  for (int j = 0; j < MAXS; ++j)
    if (j < S) s[j] = round_io<T>(s[j] / sum);

  const int y = gy * ws + tid / ws, x = gx * ws + tid % ws;
  T* o = out + (((size_t)b * hp + y) * wp + x) * c + h * hd;
  for (int d = 0; d < hd; ++d) {
    float a = 0.f;
#pragma unroll
    for (int j = 0; j < MAXS; ++j)
      if (j < S) a = fmaf(s[j], vs[j][d], a);
    o[d] = from_f<T>(a);
  }
}

template <typename T>
int launch(const void* qkv, void* out, int b, int hp, int wp, int c, int nh,
           int ws, float scale, cudaStream_t s) {
  dim3 grid((hp / ws) * (wp / ws), nh, b);
  lga_kernel<T><<<grid, MAXS, 0, s>>>((const T*)qkv, (T*)out, hp, wp, c, nh,
                                      ws, scale);
  return (int)cudaGetLastError();
}

// --------------------------------------------------------------- bf16 path
typedef __nv_bfloat16 bf16;

// floor(e / d) as a multiply-high by m = ceil(2^32 / d): exact while
// e * d < 2^32 (every use here is far below)
struct FastDiv {
  uint64_t m;
  __device__ explicit FastDiv(int d) : m(((1ull << 32) + d - 1) / d) {}
  __device__ __forceinline__ int div(int e) const {
    return (int)(((uint64_t)e * m) >> 32);
  }
};

// One block per work item (window, group of up to nhb heads; all heads on
// the main path), so every qkv byte is read once: the window's token rows
// come in by 16-byte cp.async into shared memory, [q | k | v] per token,
// each nhb x HP (the head dim padded with zeros to HP = 16 or 32), row
// stride 3 nhb HP + 8 elements (an odd number of 16-byte units: ldmatrix
// is conflict-free); tokens S..63 are zero rows. A warp takes one (head,
// 16-query tile) at a time: Q.K^T and P.V on mma.sync, keys padded to 64
// and masked with NEG, the softmax in registers. Its output overwrites its
// own q slots and leaves as whole token rows in 16-byte stores.
template <int HP, int LW>
__global__ void __launch_bounds__(LW * 32, 16 / LW)
    lga_kernel_bf16(const bf16* __restrict__ qkv, bf16* __restrict__ out,
                    int hp, int wp, int c, int nh, int nhb, int ws,
                    float scale) {
  extern __shared__ uint4 xs_raw[];
  bf16* xs = reinterpret_cast<bf16*>(xs_raw);
  const int hd = c / nh, S = ws * ws, CP = nhb * HP, LDR = 3 * CP + 8;
  const int ngroups = (nh + nhb - 1) / nhb, gw = wp / ws;
  const int win = blockIdx.x / ngroups, h0 = (blockIdx.x - win * ngroups) * nhb;
  const int nhi = min(nhb, nh - h0), gy = win / gw, gx = win - gy * gw;
  const size_t tok0 = ((size_t)blockIdx.y * hp + gy * ws) * wp + gx * ws;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const FastDiv by_ws(ws);
  // 16-byte copies straight between token rows and shared rows
  const bool whole =
      hd == HP && ((((uintptr_t)qkv) | ((uintptr_t)out)) & 15) == 0;

  if (whole) {
    const int seg = nhi * HP / 8, cpt = 3 * seg;  // 16-byte chunks
    const FastDiv by_cpt(cpt), by_seg(seg);
    for (int e = threadIdx.x; e < S * cpt; e += LW * 32) {
      const int tk = by_cpt.div(e), r = e - tk * cpt;
      const int part = by_seg.div(r), ch = r - part * seg;
      const int ty = by_ws.div(tk), tx = tk - ty * ws;
      cp_async16(xs + tk * LDR + part * CP + ch * 8,
                 qkv + (tok0 + (size_t)ty * wp + tx) * 3 * c + part * c +
                     h0 * hd + ch * 8);
    }
  } else {
    const int ept = 3 * CP;
    for (int e = threadIdx.x; e < S * ept; e += LW * 32) {
      const int tk = e / ept, r = e - tk * ept;
      const int part = r / CP, h = r % CP / HP, d = r % HP;
      const size_t tok = tok0 + (size_t)(tk / ws) * wp + tk % ws;
      xs[tk * LDR + r] = h < nhi && d < hd
                             ? qkv[tok * 3 * c + part * c + (h0 + h) * hd + d]
                             : __float2bfloat16_rn(0.f);
    }
  }
  const int zpr = 3 * CP / 8;
  for (int e = threadIdx.x; e < (64 - S) * zpr; e += LW * 32) {
    const int tk = S + e / zpr, ch = e % zpr;
    *reinterpret_cast<uint4*>(xs + tk * LDR + ch * 8) = make_uint4(0, 0, 0, 0);
  }
  cp_async_wait_all();
  __syncthreads();

  __nv_bfloat162 sc2 = __float2bfloat162_rn(scale);  // exact: a bf16 value
  const int QT = (S + 15) / 16;
  for (int task = warp; task < nhi * QT; task += LW) {
    const int h = task / QT, q0 = task % QT * 16;
    bf16* qb = xs + h * HP;
    const bf16* kb = xs + CP + h * HP;
    const bf16* vb = xs + 2 * CP + h * HP;
    uint32_t qf[HP / 16][4];
#pragma unroll
    for (int kk = 0; kk < HP / 16; ++kk) {
      ldmatrix_x4(qf[kk], qb + (q0 + (lane & 15)) * LDR + kk * 16 +
                              (lane >> 4) * 8);
#pragma unroll
      for (int r = 0; r < 4; ++r) {  // q * scale rounded once, as round_io
        __nv_bfloat162 v = __hmul2(
            *reinterpret_cast<__nv_bfloat162*>(&qf[kk][r]), sc2);
        qf[kk][r] = *reinterpret_cast<uint32_t*>(&v);
      }
    }
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int n2 = 0; n2 < 4; ++n2)
#pragma unroll
      for (int kk = 0; kk < HP / 16; ++kk) {
        uint32_t kf[4];  // keys 16 n2 .. +15, dims 16 kk .. +15
        ldmatrix_x4(kf, kb + (n2 * 16 + (lane & 7) + (lane >> 4) * 8) * LDR +
                            kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * n2], qf[kk], kf[0], kf[1]);
        mma_bf16(s[2 * n2 + 1], qf[kk], kf[2], kf[3]);
      }
    // rows g and g + 8 of the tile: max, exp and sum over the quad
    float mx[2] = {NEG, NEG}, sum[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (nt * 8 + 2 * t + (e & 1) >= S) s[nt][e] = NEG;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = exp2f((s[nt][e] - mx[e >> 1]) * L2E);
        sum[e >> 1] += s[nt][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
    }
    const float rs[2] = {1.f / sum[0], 1.f / sum[1]};
    uint32_t pf[4][4];  // the probabilities, rounded, as the A operand
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      pf[nt >> 1][(nt & 1) * 2] = pack_bf16(div_r(s[nt][0], sum[0], rs[0]),
                                            div_r(s[nt][1], sum[0], rs[0]));
      pf[nt >> 1][(nt & 1) * 2 + 1] =
          pack_bf16(div_r(s[nt][2], sum[1], rs[1]),
                    div_r(s[nt][3], sum[1], rs[1]));
    }
    float o[HP / 8][4];
#pragma unroll
    for (int i = 0; i < HP / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int dp = 0; dp < HP / 16; ++dp) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, vb + (kk * 16 + (lane & 15)) * LDR +
                                  dp * 16 + (lane >> 4) * 8);
        mma_bf16(o[2 * dp], pf[kk], vf[0], vf[1]);
        mma_bf16(o[2 * dp + 1], pf[kk], vf[2], vf[3]);
      }
    // only this warp reads these q slots: overwrite them with the output
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int i = 0; i < HP / 8; ++i)
        *reinterpret_cast<uint32_t*>(qb + (q0 + g + 8 * r) * LDR + 8 * i +
                                     2 * t) =
            pack_bf16(o[i][2 * r], o[i][2 * r + 1]);
  }
  __syncthreads();

  if (whole) {
    const int seg = nhi * HP / 8;
    const FastDiv by_seg(seg);
    for (int e = threadIdx.x; e < S * seg; e += LW * 32) {
      const int tk = by_seg.div(e), ch = e - tk * seg;
      const int ty = by_ws.div(tk), tx = tk - ty * ws;
      *reinterpret_cast<uint4*>(out + (tok0 + (size_t)ty * wp + tx) * c +
                                h0 * hd + ch * 8) =
          *reinterpret_cast<const uint4*>(xs + tk * LDR + ch * 8);
    }
  } else {
    const int ept = nhi * hd;
    for (int e = threadIdx.x; e < S * ept; e += LW * 32) {
      const int tk = e / ept, r = e - tk * ept;
      out[(tok0 + (size_t)(tk / ws) * wp + tk % ws) * c + h0 * hd + r] =
          xs[tk * LDR + r / hd * HP + r % hd];
    }
  }
}

template <int HP, int LW>
int launch_bf16(const void* qkv, void* out, int b, int hp, int wp, int c,
                int nh, int nhb, int ws, float scale, cudaStream_t s) {
  const int smem = 64 * (3 * nhb * HP + 8) * (int)sizeof(bf16);
  cudaError_t e = cudaFuncSetAttribute(
      lga_kernel_bf16<HP, LW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((hp / ws) * (wp / ws) * ((nh + nhb - 1) / nhb), b);
  lga_kernel_bf16<HP, LW><<<grid, LW * 32, smem, s>>>(
      (const bf16*)qkv, (bf16*)out, hp, wp, c, nh, nhb, ws, scale);
  return (int)cudaGetLastError();
}

// heads per block: as many as one block's shared memory holds (all of them
// on the main path); 4 warps when four such blocks fit an SM (stage 0:
// more blocks hide each other's loads), else 8 warps and two blocks
template <int HP>
int dispatch_bf16(const void* qkv, void* out, int b, int hp, int wp, int c,
                  int nh, int ws, float scale, cudaStream_t s) {
  constexpr int kMaxCP = ((227 * 1024) / (64 * 2) - 8) / 3;
  const int nhb = std::min(nh, kMaxCP / HP);
  if (64 * (3 * nhb * HP + 8) * 2 <= 56 * 1024)
    return launch_bf16<HP, 4>(qkv, out, b, hp, wp, c, nh, nhb, ws, scale, s);
  return launch_bf16<HP, 8>(qkv, out, b, hp, wp, c, nh, nhb, ws, scale, s);
}

}  // namespace

extern "C" int sf_lga_attn(const void* qkv, void* out, int b, int hp, int wp,
                           int c, int nh, int ws, float scale, int dtype,
                           void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (ws * ws > MAXS || c / nh > MAXHD || c % nh || hp % ws || wp % ws)
    return (int)cudaErrorInvalidValue;
  if (b == 0 || hp == 0 || wp == 0) return 0;
  if (dtype == sf::kBF16)
    return c / nh <= 16
               ? dispatch_bf16<16>(qkv, out, b, hp, wp, c, nh, ws, scale, s)
               : dispatch_bf16<32>(qkv, out, b, hp, wp, c, nh, ws, scale, s);
  return launch<float>(qkv, out, b, hp, wp, c, nh, ws, scale, s);
}

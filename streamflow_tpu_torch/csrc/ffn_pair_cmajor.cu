// The channel-major FFN pair: x (C, N), tokens along the rows' length.
//
// Replaces the Pallas kernel of tools/probe_cmajor_ffn.py
// (ffn_pair_cmajor -> pl.pallas_call, body _kernel_cm), a probe of whether
// an SK layout with channels outermost keeps K2's rate:
//   h = gelu(W1 x + b1), rounded to the io type   (Ch, N)
//   y = W2 h + b2 [y = gelu(x + y)]               (Co, N)
// weights in nn.Linear layout (out, in), the products accumulated in f32.
//
// Bound on the H100: the two products (4 N C Ch FLOP at Co = C, ~21 GFLOP
// at N = 21120, C = 384: 21 us at 989 TFLOP/s; x, y and the weights ~33
// MB, 10 us at 3.35 TB/s). In practice, as K2, the weights' bytes from L2:
// every token tile reads all of them.
// Design (bf16 only; the "wgmma" body), K2's parts turned around: in the
// C-major layout the token axis is the N side of both products, so the
// weights are wgmma's A operand (K-major, as K2 stages them) and the
// tokens its B operand, read MN-major. A block takes 64 tokens: a producer
// warp loads their x tile (C rows of 64 tokens, 128-byte swizzle) by TMA,
// then streams W1's and W2's boxes (128 rows x 64 k) through a ring of
// stages; two consumer warpgroups share each box, each the product of its
// 64 rows, m64n64k16 with f32 accumulators: h = gelu(W1 x + b1) a chunk of
// 128 hidden rows at a time into shared memory (Ch rows of 64 tokens, the
// swizzle TMA would write), then y = W2 h + b2 and the residual from the x
// tile, stored as rows of the (Co, N) output. x's rows must be whole
// 16-byte units (N a multiple of 8) for TMA; C, Ch and Co multiples of 64.

#include "common.cuh"

using namespace sf;

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BT = 64;          // tokens per block
constexpr int ROWB = BT * 2;    // bytes per row of the x and h tiles
constexpr int BOX = 16384;      // a weight box: 128 rows x 64 k
constexpr int NTH = 256 + 32;   // two consumer warpgroups + a producer warp
constexpr int SMEM_MAX = 232448;

struct CmArgs {
  bf16* out;
  const bf16 *b1, *b2;
  int c, ch, co, n, residual;
};

// byte offset of (row r, token t) in a tile of 128-byte rows, 128-byte
// swizzle (16-byte unit t / 8 of row r at unit (t / 8) ^ (r % 8))
__device__ __forceinline__ int swz(int r, int t) {
  return r * ROWB + ((((t >> 3) & 7) ^ (r & 7)) << 4) + ((t & 7) << 1);
}

struct CmPlan {
  int x_off, h_off, ring_off, bar_off, ns, bytes;
};

inline int up128(int v) { return (v + 127) & ~127; }

// the x tile, h (its rows rounded up to whole 128-row chunks), the ring of
// up to 8 boxes, the barriers; 1024-byte aligned (the swizzle's atoms)
inline CmPlan cm_plan(int c, int ch) {
  CmPlan p;
  p.x_off = 0;
  p.h_off = c * ROWB;
  p.ring_off = p.h_off + up128(ch) * ROWB;
  const int room = SMEM_MAX - 1024 - 256 - p.ring_off;
  p.ns = room < 0 ? 0 : (room / BOX < 8 ? room / BOX : 8);
  p.bar_off = p.ring_off + p.ns * BOX;
  p.bytes = p.bar_off + 16 * p.ns + 16 + 1024;
  return p;
}

__device__ __forceinline__ uint64_t desc_k(const uint8_t* p) {
  return wgmma_desc(p, 16, 1024, 1);  // K-major, 128-byte swizzle
}

__device__ __forceinline__ uint64_t desc_mn(const uint8_t* p) {
  return wgmma_desc(p, 1024, 1024, 1);  // MN-major, 64 columns, swizzled
}

template <int G>
__global__ void __launch_bounds__(NTH, 1)
    ffn_pair_cmajor_kernel(const __grid_constant__ CUtensorMap tx,
                           const __grid_constant__ CUtensorMap tw1,
                           const __grid_constant__ CUtensorMap tw2,
                           const CmArgs a, const CmPlan pl) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* xs = sm + pl.x_off;
  uint8_t* hs = sm + pl.h_off;
  uint8_t* ring = sm + pl.ring_off;
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + pl.bar_off);
  uint64_t* empty = full + pl.ns;
  uint64_t* xbar = empty + pl.ns;
  const int ns = pl.ns, n0 = blockIdx.x * BT;
  const int kx = a.c / 64, kh = a.ch / 64;  // k panels of each product
  const int m1 = (a.ch + 127) / 128, m2 = (a.co + 127) / 128;  // row chunks

  if (threadIdx.x == 0) {
    for (int s = 0; s < ns; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);
    }
    mbar_init(xbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 2) {
    // producer: the x tile, then every weight box in the consumers' order
    if (threadIdx.x == 256) {
      mbar_expect_tx(xbar, kx * 64 * ROWB);
      for (int p = 0; p < kx; ++p)
        tma_load_2d(xs + p * 64 * ROWB, &tx, xbar, n0, 64 * p);
      int it = 0;
      auto load = [&](const CUtensorMap* m, int k0, int r0) {
        const int s = it % ns;
        mbar_wait(&empty[s], ((it / ns) & 1) ^ 1);
        mbar_expect_tx(&full[s], BOX);
        tma_load_2d(ring + s * BOX, m, &full[s], k0, r0);
        ++it;
      };
      for (int j = 0; j < m1; ++j)
        for (int kp = 0; kp < kx; ++kp) load(&tw1, 64 * kp, 128 * j);
      for (int j = 0; j < m2; ++j)
        for (int kp = 0; kp < kh; ++kp) load(&tw2, 64 * kp, 128 * j);
    }
    return;
  }

  const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  int it = 0;
  // D (64 rows of this consumer x 64 tokens) = its half of each box of a
  // chunk (A) . the tile B (K rows of 64 tokens), over nk k panels
  auto product = [&](float (&d)[32], const uint8_t* B, int nk) {
    int prev = -1;
    for (int kp = 0; kp < nk; ++kp, ++it) {
      const int s = it % ns;
      mbar_wait(&full[s], (it / ns) & 1);
      const uint8_t* A = ring + s * BOX + wg * 8192;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss_n64_mn(d, desc_k(A + kk * 32),
                        desc_mn(B + (64 * kp + 16 * kk) * ROWB),
                        kp > 0 || kk > 0);
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
  };

  mbar_wait(xbar, 0);
  // h = gelu(W1 x + b1), rounded to bf16; d[4i + 2r + e] is row
  // warp * 16 + g + 8r of this consumer's 64, token 8i + 2t + e
  for (int j = 0; j < m1; ++j) {
    float d[32];
    product(d, xs, kx);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = 128 * j + 64 * wg + warp * 16 + g + 8 * r;
      if (row >= a.ch) continue;
      const float bias = __bfloat162float(a.b1[row]);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int tok = 8 * i + 2 * t;
        *reinterpret_cast<uint32_t*>(hs + swz(row, tok)) =
            pack_bf16(gelu_v<G>(d[4 * i + 2 * r] + bias),
                      gelu_v<G>(d[4 * i + 2 * r + 1] + bias));
      }
    }
  }
  fence_async_smem();  // h, written by this proxy, read by wgmma
  bar_sync(1, 256);

  // y = W2 h + b2 [gelu(x + y)], stored as rows of (Co, N)
  for (int j = 0; j < m2; ++j) {
    float d[32];
    product(d, hs, kh);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = 128 * j + 64 * wg + warp * 16 + g + 8 * r;
      if (row >= a.co) continue;
      const float bias = __bfloat162float(a.b2[row]);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int tok = 8 * i + 2 * t;
        if (n0 + tok >= a.n) continue;  // n is even: tok + 1 < n too
        float v0 = d[4 * i + 2 * r] + bias, v1 = d[4 * i + 2 * r + 1] + bias;
        if (a.residual) {
          const float2 xv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(xs + swz(row, tok)));
          v0 = gelu_v<G>(xv.x + v0);
          v1 = gelu_v<G>(xv.y + v1);
        }
        *reinterpret_cast<uint32_t*>(a.out + (size_t)row * a.n + n0 + tok) =
            pack_bf16(v0, v1);
      }
    }
  }
}

template <int G>
int launch(const void* x, const void* w1, const void* w2, const CmArgs& a,
           cudaStream_t s) {
  if (encoder() == nullptr) return (int)cudaErrorNotSupported;
  const CmPlan pl = cm_plan(a.c, a.ch);
  if (pl.ns < 2) return (int)cudaErrorInvalidValue;
  CUtensorMap tx, tw1, tw2;
  const uint64_t dx[2] = {(uint64_t)a.n, (uint64_t)a.c};
  const uint64_t d1[2] = {(uint64_t)a.c, (uint64_t)a.ch};
  const uint64_t d2[2] = {(uint64_t)a.ch, (uint64_t)a.co};
  const uint32_t boxx[2] = {BT, 64}, boxw[2] = {64, 128};
  if (!tensor_map(&tx, x, 2, dx, boxx) || !tensor_map(&tw1, w1, 2, d1, boxw) ||
      !tensor_map(&tw2, w2, 2, d2, boxw))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      ffn_pair_cmajor_kernel<G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      pl.bytes);
  if (e != cudaSuccess) return (int)e;
  ffn_pair_cmajor_kernel<G><<<(a.n + BT - 1) / BT, NTH, pl.bytes, s>>>(
      tx, tw1, tw2, a, pl);
  return (int)cudaGetLastError();
}

}  // namespace

// x (c, n), w1 (ch, c), b1 (ch), w2 (co, ch), b2 (co), out (co, n), all
// bf16; c, ch and co multiples of 64, n of 8, co == c with the residual;
// gelu as common.cuh's Gelu
extern "C" int sf_ffn_pair_cmajor(const void* x, const void* w1,
                                  const void* b1, const void* w2,
                                  const void* b2, void* out, int c, int ch,
                                  int co, int n, int residual, int dtype,
                                  int gelu, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype != sf::kBF16 || c % 64 || ch % 64 || co % 64 || n % 8 ||
      (residual && co != c))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const CmArgs a{(bf16*)out, (const bf16*)b1, (const bf16*)b2,
                 c, ch, co, n, residual};
  switch (gelu) {
    case kErf: return launch<kErf>(x, w1, w2, a, s);
    case kPoly: return launch<kPoly>(x, w1, w2, a, s);
    case kTanh: return launch<kTanh>(x, w1, w2, a, s);
  }
  return (int)cudaErrorInvalidValue;
}

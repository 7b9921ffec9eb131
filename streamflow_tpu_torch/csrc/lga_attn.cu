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
// Bound on the H100: latency of many tiny blocks (a 7x7 window is 49
// tokens, 49x49 scores per head, ~0.15 MFLOP); the kernel moves each qkv
// element once. Design: one block per (window, head, batch); q/k/v of the
// head are staged in shared memory (row stride hd+1: conflict-free column
// reads); one thread per query row keeps its 49 scores in registers. The
// TPU kernel's lane-mask head split and 128-row key padding are not needed.

#include "common.cuh"

using namespace sf;

namespace {

constexpr int MAXS = 64;   // max tokens per window (ws*ws)
constexpr int MAXHD = 32;  // max head dim (static shared memory < 48 KB)

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

}  // namespace

extern "C" int sf_lga_attn(const void* qkv, void* out, int b, int hp, int wp,
                           int c, int nh, int ws, float scale, int dtype,
                           void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (ws * ws > MAXS || c / nh > MAXHD || c % nh || hp % ws || wp % ws)
    return (int)cudaErrorInvalidValue;
  if (b == 0 || hp == 0 || wp == 0) return 0;
  if (dtype == sf::kBF16)
    return launch<__nv_bfloat16>(qkv, out, b, hp, wp, c, nh, ws, scale, s);
  return launch<float>(qkv, out, b, hp, wp, c, nh, ws, scale, s);
}

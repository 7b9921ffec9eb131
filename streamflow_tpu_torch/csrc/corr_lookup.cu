// K1: correlation lookup. For every query, the 9x9 (radius 4) bilinear
// window of the correlation volume f1 . f2_l^T / sqrt(C) at coords / 2^l,
// over the pooled f2 pyramid levels, without ever storing the (N, N) volume.
//
// Replaces the Pallas kernel
// streamflow_tpu/ops/pallas/_fused_lookup_kernel.py
// (fused_corr_lookup_prepared -> pl.pallas_call, body _fused_kernel), in
// its window-dot form rather than the TPU's row-plane recompute and lane
// gathers: per query and level, the (2r+2)^2 = 100 integer taps around
// floor(coords / 2^l) are each one C-long dot product; taps out of range
// are zero (grid_sample zero padding); the 100 values are scaled by
// 1/sqrt(C) and combined bilinearly into 81 outputs, written x-major
// (channel = level*81 + ix*9 + iy, reference core/corr.py order).
// Coordinates are clamped to [-(r+3), size+r+3] first, which only touches
// windows that lie fully out of range (they stay all zeros).
//
// Bound on the H100: L2 bandwidth of the tap reads (each tap re-reads C
// features of f2; ~4 GB/iteration at 440x1024 for 3 pairs, almost all L2
// hits since the pyramid is ~10 MB). Design: one warp per query; each lane
// keeps C/32 features of f1 in registers, a tap is one coalesced read of
// the f2 feature row plus a warp reduction; whole tap rows out of range are
// skipped without reading.

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

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
    corr_lookup_kernel(const T* __restrict__ f1, Levels lv,
                       const float* __restrict__ coords, T* __restrict__ out,
                       int b, int n, int c, int nl, int r, float scale) {
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
    f1r[i] = i < cpl ? to_f(f1[(size_t)qg * c + lane + 32 * i]) : 0.f;
  const float px = coords[(size_t)qg * 2], py = coords[(size_t)qg * 2 + 1];
  float* tp = taps[warp];

  for (int l = 0; l < nl; ++l) {
    const int hl = lv.h[l], wl = lv.w[l];
    const T* f2 = (const T*)lv.f2[l] + (size_t)bi * hl * wl * c;
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
          const T* row = f2 + ((size_t)yy * wl + xx) * c;
#pragma unroll
          for (int i = 0; i < MAXCPL; ++i)
            if (i < cpl) a = fmaf(f1r[i], to_f(row[lane + 32 * i]), a);
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
      out[(size_t)qg * nout + l * k * k + o] = from_f<T>((1.f - fx) * r0 + fx * r1);
    }
    __syncwarp();
  }
}

template <typename T>
int launch(const void* f1, const Levels& lv, const float* coords, void* out,
           int b, int n, int c, int nl, int r, float scale, cudaStream_t s) {
  int grid = (b * n + WARPS - 1) / WARPS;
  corr_lookup_kernel<T><<<grid, WARPS * 32, 0, s>>>(
      (const T*)f1, lv, coords, (T*)out, b, n, c, nl, r, scale);
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
    return launch<__nv_bfloat16>(f1, lv, coords, out, b, n, c, nl, r, scale,
                                 s);
  return launch<float>(f1, lv, coords, out, b, n, c, nl, r, scale, s);
}

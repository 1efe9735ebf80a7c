// Bilinear point sampling of mask logits (PointRend), forward and backward.
//
// Replaces autofocusformermod_tpu/ops/pallas/point_sample_kernel.py:
// point_sample_pallas (forward _fwd_kernel via point_sample_pallas_impl,
// backward _bwd_kernel via point_sample_pallas_bwd_impl).
//   x = clamp(cx * w - 0.5, -1, w),  y = clamp(cy * h - 0.5, -1, h)
//   out[m, p] = sum over the 2x2 taps (x0 + a, y0 + b) inside the image of
//               img[m, y0 + b, x0 + a] * (a ? wx : 1 - wx) * (b ? wy : 1 - wy)
// with x0 = floor(x), wx = x - x0: torch grid_sample(align_corners=False,
// padding_mode='zeros') on coordinates in [0, 1], the clamp as the TPU
// kernel's _prep_coords (it leaves every in-bounds tap as it is).
//
// What bounds it on the H100: the four scattered 4-byte reads per point
// (and, backward, four atomicAdd reductions per point).  A mask is 64 KB at
// 128x128, so the points of one mask hit L2; the TPU kernel's separable
// one-hot matmuls exist because the TPU's element gathers are slow, and are
// not carried over.
//
// Design: one thread per point, consecutive threads on consecutive points of
// one mask.  The gradient goes to the masks only; d img must arrive zeroed.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

struct Taps {
  long long base;
  int x0, y0;
  float wx, wy;
};

__device__ __forceinline__ Taps taps_of(const float* coords, long long pt, int P, int H,
                                        int W) {
  const float cx = coords[2 * pt];
  const float cy = coords[2 * pt + 1];
  // rounded as the plain version rounds it (no FMA), so floor() picks the
  // same taps
  const float x = fminf(fmaxf(__fsub_rn(__fmul_rn(cx, (float)W), 0.5f), -1.f), (float)W);
  const float y = fminf(fmaxf(__fsub_rn(__fmul_rn(cy, (float)H), 0.5f), -1.f), (float)H);
  const float x0 = floorf(x);
  const float y0 = floorf(y);
  Taps t;
  t.base = (pt / P) * (long long)H * W;
  t.x0 = (int)x0;
  t.y0 = (int)y0;
  t.wx = x - x0;
  t.wy = y - y0;
  return t;
}

__device__ __forceinline__ bool inside(int x, int y, int H, int W) {
  return x >= 0 && x < W && y >= 0 && y < H;
}

__global__ void __launch_bounds__(kThreads)
point_sample_kernel(const float* __restrict__ img, const float* __restrict__ coords,
                    float* __restrict__ out, long long total, int P, int H, int W) {
  const long long pt = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (pt >= total) return;
  const Taps t = taps_of(coords, pt, P, H, W);
  const float* im = img + t.base;
  const int x1 = t.x0 + 1, y1 = t.y0 + 1;
  const float v00 = inside(t.x0, t.y0, H, W) ? im[(size_t)t.y0 * W + t.x0] : 0.f;
  const float v01 = inside(x1, t.y0, H, W) ? im[(size_t)t.y0 * W + x1] : 0.f;
  const float v10 = inside(t.x0, y1, H, W) ? im[(size_t)y1 * W + t.x0] : 0.f;
  const float v11 = inside(x1, y1, H, W) ? im[(size_t)y1 * W + x1] : 0.f;
  const float top = v00 * (1.f - t.wx) + v01 * t.wx;
  const float bot = v10 * (1.f - t.wx) + v11 * t.wx;
  out[pt] = top * (1.f - t.wy) + bot * t.wy;
}

__global__ void __launch_bounds__(kThreads)
point_sample_bwd_kernel(const float* __restrict__ coords, const float* __restrict__ g,
                        float* __restrict__ dimg, long long total, int P, int H, int W) {
  const long long pt = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (pt >= total) return;
  const Taps t = taps_of(coords, pt, P, H, W);
  float* d = dimg + t.base;
  const float gp = g[pt];
  const float gt = gp * (1.f - t.wy), gb = gp * t.wy;
  const int x1 = t.x0 + 1, y1 = t.y0 + 1;
  if (inside(t.x0, t.y0, H, W)) atomicAdd(d + (size_t)t.y0 * W + t.x0, gt * (1.f - t.wx));
  if (inside(x1, t.y0, H, W)) atomicAdd(d + (size_t)t.y0 * W + x1, gt * t.wx);
  if (inside(t.x0, y1, H, W)) atomicAdd(d + (size_t)y1 * W + t.x0, gb * (1.f - t.wx));
  if (inside(x1, y1, H, W)) atomicAdd(d + (size_t)y1 * W + x1, gb * t.wx);
}

unsigned blocks_for(long long total) {
  return (unsigned)((total + kThreads - 1) / kThreads);
}

}  // namespace

// img (n, h, w) f32; coords (n, p, 2) f32 in [0, 1], (x, y) -> out (n, p)
extern "C" int aff_point_sample(const float* img, const float* coords, float* out,
                                int n, int p, int h, int w, void* stream_ptr) {
  if (n < 1 || p < 1 || h < 1 || w < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long total = (long long)n * p;
  point_sample_kernel<<<blocks_for(total), kThreads, 0,
                        static_cast<cudaStream_t>(stream_ptr)>>>(img, coords, out, total,
                                                                 p, h, w);
  return static_cast<int>(cudaGetLastError());
}

// coords (n, p, 2); g (n, p) = d out -> dimg (n, h, w), zeroed on entry
extern "C" int aff_point_sample_bwd(const float* coords, const float* g, float* dimg,
                                    int n, int p, int h, int w, void* stream_ptr) {
  if (n < 1 || p < 1 || h < 1 || w < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long total = (long long)n * p;
  point_sample_bwd_kernel<<<blocks_for(total), kThreads, 0,
                            static_cast<cudaStream_t>(stream_ptr)>>>(coords, g, dimg,
                                                                     total, p, h, w);
  return static_cast<int>(cudaGetLastError());
}

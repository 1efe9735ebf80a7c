// Point sampling of mask logits (PointRend): the bilinear sample, forward and
// backward, and the two one-tap nearest-cell reads of the uncertainty ranking
// (further down, with their own note).
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

// ---------------------------------------------------------------------------
// Nearest-cell reads for the uncertainty ranking (no gradient: the ranking is
// a selection heuristic and runs without one).
//
// point_sample_nearest_kernel replaces point_sample_kernel.py:
// point_sample_nearest_pallas,
//   out[m, p] = img[m, clamp(int(cy * h), 0, h - 1), clamp(int(cx * w), 0, w - 1)].
// The TPU kernel is two one-hot matrix products, because the TPU has no fast
// element gather, and it rounds the image to bf16 on the way.  The card
// gathers natively, so this kernel reads the fp32 value exactly: one thread
// per (mask, point), consecutive threads on consecutive points, the cell from
// __fmul_rn and a truncating cast as the plain version computes it.
//
// point_sample_nearest_rows_kernel replaces point_sample_kernel.py:
// point_sample_nearest_rows_pallas: the same read for y-stratified
// candidates.  The candidates come in chunks of 128; chunk c of `chunks` lies
// in the y-sliver [c / chunks, (c + 1) / chunks), which with chunks >= h
// spans at most the two image rows r0, r0 + 1, r0 = min(c * h / chunks,
// h - 2).  What is kept of the TPU kernel is that point -- two rows per chunk,
// no search -- not its block shape (one program per mask, 294 unrolled
// chunks): here a warp owns a chunk, loads its two rows (2 * w floats, 1 KB at
// w = 128) coalesced into shared memory once, and each lane then reads
// rows[cy == r0 ? 0 : 1][cx] for four candidates, cx/cy loaded and the
// result stored 16 bytes a lane.  A cy outside {r0, r0 + 1} reads row r0 + 1
// (the plain version raises on it instead).
//
// What bounds both: bytes.  At the training step's shapes (8000 masks of
// 128x128, 37632 candidates each) the candidate arrays (coords, or cx and cy)
// and the output are 3.6 GB against 0.5 GB of masks, so the least time is the
// candidates' streaming time; the reads of the masks hit L2.

constexpr int kChunk = 128;          // candidates per chunk
constexpr int kRowsWarps = 8;        // chunks (warps) per block

__device__ __forceinline__ int cell_of(float c, int size) {
  return min(max((int)__fmul_rn(c, (float)size), 0), size - 1);
}

__global__ void __launch_bounds__(kThreads)
point_sample_nearest_kernel(const float* __restrict__ img, const float2* __restrict__ coords,
                            float* __restrict__ out, long long total, int P, int H, int W) {
  const long long pt = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (pt >= total) return;
  const float2 c = coords[pt];
  const int cx = cell_of(c.x, W);
  const int cy = cell_of(c.y, H);
  out[pt] = img[(pt / P) * (long long)H * W + (long long)cy * W + cx];
}

__global__ void __launch_bounds__(kRowsWarps * 32)
point_sample_nearest_rows_kernel(const float* __restrict__ img, const int4* __restrict__ cx,
                                 const int4* __restrict__ cy, float4* __restrict__ out,
                                 int chunks, int H, int W) {
  extern __shared__ float rows_smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int groups = (chunks + kRowsWarps - 1) / kRowsWarps;
  const int c = (blockIdx.x % groups) * kRowsWarps + warp;
  if (c >= chunks) return;          // whole warps leave; only __syncwarp below
  const long long m = blockIdx.x / groups;
  const int r0 = min((int)((long long)c * H / chunks), H - 2);
  float* rows = rows_smem + warp * 2 * W;
  const float* src = img + (m * H + r0) * (long long)W;
  for (int i = lane; i < 2 * W; i += 32) rows[i] = src[i];
  __syncwarp();
  const long long at = (m * chunks + c) * (kChunk / 4) + lane;
  const int4 x = cx[at];
  const int4 y = cy[at];
  float4 v;
  v.x = rows[(y.x == r0 ? 0 : W) + x.x];
  v.y = rows[(y.y == r0 ? 0 : W) + x.y];
  v.z = rows[(y.z == r0 ? 0 : W) + x.z];
  v.w = rows[(y.w == r0 ? 0 : W) + x.w];
  out[at] = v;
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

// img (n, h, w) f32; coords (n, p, 2) f32 (x, y) -> out (n, p): the value of
// the cell each point falls in
extern "C" int aff_point_sample_nearest(const float* img, const float* coords, float* out,
                                        int n, int p, int h, int w, void* stream_ptr) {
  if (n < 1 || p < 1 || h < 1 || w < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long total = (long long)n * p;
  point_sample_nearest_kernel<<<blocks_for(total), kThreads, 0,
                                static_cast<cudaStream_t>(stream_ptr)>>>(
      img, reinterpret_cast<const float2*>(coords), out, total, p, h, w);
  return static_cast<int>(cudaGetLastError());
}

// img (n, h, w) f32; cx, cy (n, chunks, 128) int32 cells, 0 <= cx < w, chunk
// c's cy in {r0, r0 + 1} -> out (n, chunks, 128).  Needs chunks >= h >= 2
// and the 2 * w floats of each of a block's 8 warps within 48 KB of shared
// memory (w <= 768).
extern "C" int aff_point_sample_nearest_rows(const float* img, const int* cx, const int* cy,
                                             float* out, int n, int chunks, int h, int w,
                                             void* stream_ptr) {
  const size_t smem = (size_t)kRowsWarps * 2 * w * sizeof(float);
  const long long blocks = (long long)n * ((chunks + kRowsWarps - 1) / kRowsWarps);
  if (n < 1 || chunks < h || h < 2 || w < 1 || smem > 48 * 1024 || blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  point_sample_nearest_rows_kernel<<<(unsigned)blocks, kRowsWarps * 32, smem,
                                     static_cast<cudaStream_t>(stream_ptr)>>>(
      img, reinterpret_cast<const int4*>(cx), reinterpret_cast<const int4*>(cy),
      reinterpret_cast<float4*>(out), chunks, h, w);
  return static_cast<int>(cudaGetLastError());
}

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
// kernel's _prep_coords (it leaves every in-bounds tap as it is).  The
// gradient goes to the masks only.
//
// What bounds it on the H100: bytes.  At a training step's shapes the
// coordinates (8 bytes a point) and the outputs or gradients (4 bytes) are
// most of them; the masks are read (forward) or written (backward) once.  The
// TPU kernel's separable one-hot matmuls exist because the TPU's element
// gathers are slow, and are not carried over.
//
// Two routes, chosen by the wrapper from the mask's shape alone
// (ops/point_sample.py:point_sample_route), both counted:
//
// Shared route, for a mask whose fp32 image fits a block's shared memory
// (227 KB; the criterion's 128x128 logits are 64 KB): one block of 512
// threads per mask.
//   forward: the block brings the mask into shared memory with 16-byte
//     asynchronous copies, then reads every point's four taps there.  The
//     random tap reads, which cost the direct route a 32-byte L2 sector for 4
//     useful bytes, become bank accesses; device memory and L2 see the mask
//     once.
//   backward: the block zeroes a tile of the mask's size in shared memory,
//     adds every point's four tap contributions there with shared-memory
//     atomics, and writes the tile out once with 16-byte stores.  No global
//     atomic, no zero-fill pass over the gradient: each element of d img is
//     written exactly once.  The order of the adds into one cell is the
//     order in which the warps reach them, which is not fixed: two calls
//     may differ in the last bits.  The H100 has no fp32 add among its
//     shared-memory atomics: atomicAdd there compiles to a compare-and-swap
//     loop (ATOMS.CAST.SPIN), which keeps this kernel at ~2x its bytes
//     bound.  A fixed-order form (a stable block sort of each chunk's
//     (cell, value) pairs, then sums in entry order) ran several times
//     slower on the card (PERF.md section 6) and is not used.
// Both read two points' coordinates with one 16-byte load and write two
// results (or read two gradients) with one 8-byte access where the point
// count is even.
//
// Direct route, for a mask that does not fit (the criterion's 512x512 target
// masks, 1 MB): one thread per point, consecutive threads on consecutive
// points of one mask, the coordinates read as one 8-byte load; the backward
// scatters with global atomicAdd into a d img that arrives zeroed.
//
// On both routes a tap is chosen with the plain version's rounding
// (__fmul_rn, __fsub_rn, then floorf), clamped to [-1, w] x [-1, h], and read
// or written only inside the image: a y-stratified y can be exactly 1.0,
// whose lower taps lie outside.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kTileThreads = 512;
// the largest mask of the shared route: the 227 KB a block may use on the H100
constexpr int kMaxTileBytes = 227 * 1024;

struct Taps {
  int x0, y0;
  float wx, wy;
};

__device__ __forceinline__ Taps taps_of(float cx, float cy, int H, int W) {
  // rounded as the plain version rounds it (no FMA), so floor() picks the
  // same taps
  const float x = fminf(fmaxf(__fsub_rn(__fmul_rn(cx, (float)W), 0.5f), -1.f), (float)W);
  const float y = fminf(fmaxf(__fsub_rn(__fmul_rn(cy, (float)H), 0.5f), -1.f), (float)H);
  const float x0 = floorf(x);
  const float y0 = floorf(y);
  Taps t;
  t.x0 = (int)x0;
  t.y0 = (int)y0;
  t.wx = x - x0;
  t.wy = y - y0;
  return t;
}

__device__ __forceinline__ bool inside(int x, int y, int H, int W) {
  return x >= 0 && x < W && y >= 0 && y < H;
}

// The bilinear blend of one mask's image `im` (global or shared memory).
__device__ __forceinline__ float blend(const float* im, const Taps& t, int H, int W) {
  const int x1 = t.x0 + 1, y1 = t.y0 + 1;
  const float v00 = inside(t.x0, t.y0, H, W) ? im[t.y0 * W + t.x0] : 0.f;
  const float v01 = inside(x1, t.y0, H, W) ? im[t.y0 * W + x1] : 0.f;
  const float v10 = inside(t.x0, y1, H, W) ? im[y1 * W + t.x0] : 0.f;
  const float v11 = inside(x1, y1, H, W) ? im[y1 * W + x1] : 0.f;
  const float top = v00 * (1.f - t.wx) + v01 * t.wx;
  const float bot = v10 * (1.f - t.wx) + v11 * t.wx;
  return top * (1.f - t.wy) + bot * t.wy;
}

// One point's four tap contributions g * weight, added into `d` (global or
// shared memory) with atomicAdd.
__device__ __forceinline__ void scatter(float* d, const Taps& t, float gp, int H, int W) {
  const float gt = gp * (1.f - t.wy), gb = gp * t.wy;
  const int x1 = t.x0 + 1, y1 = t.y0 + 1;
  if (inside(t.x0, t.y0, H, W)) atomicAdd(d + t.y0 * W + t.x0, gt * (1.f - t.wx));
  if (inside(x1, t.y0, H, W)) atomicAdd(d + t.y0 * W + x1, gt * t.wx);
  if (inside(t.x0, y1, H, W)) atomicAdd(d + y1 * W + t.x0, gb * (1.f - t.wx));
  if (inside(x1, y1, H, W)) atomicAdd(d + y1 * W + x1, gb * t.wx);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// ------------------------------------------------------------ direct route
__global__ void __launch_bounds__(kThreads)
point_sample_kernel(const float* __restrict__ img, const float2* __restrict__ coords,
                    float* __restrict__ out, long long total, int P, int H, int W) {
  const long long pt = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (pt >= total) return;
  const float2 c = coords[pt];
  out[pt] = blend(img + (pt / P) * (long long)H * W, taps_of(c.x, c.y, H, W), H, W);
}

__global__ void __launch_bounds__(kThreads)
point_sample_bwd_kernel(const float2* __restrict__ coords, const float* __restrict__ g,
                        float* __restrict__ dimg, long long total, int P, int H, int W) {
  const long long pt = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (pt >= total) return;
  const float2 c = coords[pt];
  scatter(dimg + (pt / P) * (long long)H * W, taps_of(c.x, c.y, H, W), g[pt], H, W);
}

unsigned blocks_for(long long total) {
  return (unsigned)((total + kThreads - 1) / kThreads);
}

// ------------------------------------------------------------ shared route
// VN: the mask's H * W is a multiple of 4 and the image (or gradient) starts
// at a multiple of 16 bytes (16-byte copies of the tile, else 4-byte); VP:
// the point count is even and the coordinates start at a multiple of 16
// bytes (two points per 16-byte load, else one per 8-byte load).
template <bool VN, bool VP>
__global__ void __launch_bounds__(kTileThreads, 3)
point_sample_tile_kernel(const float* __restrict__ img, const float* __restrict__ coords,
                         float* __restrict__ out, int P, int H, int W) {
  extern __shared__ __align__(16) float tile[];
  const long long m = blockIdx.x;
  const int hw = H * W, tid = threadIdx.x;
  const float* src = img + m * hw;
  if constexpr (VN) {
    for (int i = tid * 4; i < hw; i += kTileThreads * 4) cp_async16(tile + i, src + i);
    cp_async_wait_all();
  } else {
    for (int i = tid; i < hw; i += kTileThreads) tile[i] = src[i];
  }
  __syncthreads();
  const float* cm = coords + m * P * 2;
  float* om = out + m * P;
  if constexpr (VP) {
    for (int i = tid; i < P / 2; i += kTileThreads) {
      const float4 c = reinterpret_cast<const float4*>(cm)[i];
      float2 o;
      o.x = blend(tile, taps_of(c.x, c.y, H, W), H, W);
      o.y = blend(tile, taps_of(c.z, c.w, H, W), H, W);
      reinterpret_cast<float2*>(om)[i] = o;
    }
  } else {
    for (int i = tid; i < P; i += kTileThreads) {
      const float2 c = reinterpret_cast<const float2*>(cm)[i];
      om[i] = blend(tile, taps_of(c.x, c.y, H, W), H, W);
    }
  }
}

template <bool VN, bool VP>
__global__ void __launch_bounds__(kTileThreads, 3)
point_sample_tile_bwd_kernel(const float* __restrict__ coords, const float* __restrict__ g,
                             float* __restrict__ dimg, int P, int H, int W) {
  extern __shared__ __align__(16) float tile[];
  const long long m = blockIdx.x;
  const int hw = H * W, tid = threadIdx.x;
  if constexpr (VN) {
    for (int i = tid * 4; i < hw; i += kTileThreads * 4)
      *reinterpret_cast<float4*>(tile + i) = make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
    for (int i = tid; i < hw; i += kTileThreads) tile[i] = 0.f;
  }
  __syncthreads();
  const float* cm = coords + m * P * 2;
  const float* gm = g + m * P;
  if constexpr (VP) {
    for (int i = tid; i < P / 2; i += kTileThreads) {
      const float4 c = reinterpret_cast<const float4*>(cm)[i];
      const float2 gp = reinterpret_cast<const float2*>(gm)[i];
      scatter(tile, taps_of(c.x, c.y, H, W), gp.x, H, W);
      scatter(tile, taps_of(c.z, c.w, H, W), gp.y, H, W);
    }
  } else {
    for (int i = tid; i < P; i += kTileThreads) {
      const float2 c = reinterpret_cast<const float2*>(cm)[i];
      scatter(tile, taps_of(c.x, c.y, H, W), gm[i], H, W);
    }
  }
  __syncthreads();
  float* dst = dimg + m * hw;
  if constexpr (VN) {
    for (int i = tid * 4; i < hw; i += kTileThreads * 4)
      *reinterpret_cast<float4*>(dst + i) = *reinterpret_cast<const float4*>(tile + i);
  } else {
    for (int i = tid; i < hw; i += kTileThreads) dst[i] = tile[i];
  }
}

inline bool aligned(const void* ptr, int bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

// Launch a shared-route kernel on n masks of hw floats: the leave to use more
// than 48 KB of dynamic shared memory is asked for at every launch (a host
// call of a microsecond; it is per device).
template <typename Kernel, typename... Args>
int launch_tile(Kernel kernel, int n, int hw, void* stream_ptr, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kMaxTileBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<n, kTileThreads, (size_t)hw * sizeof(float),
           static_cast<cudaStream_t>(stream_ptr)>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

bool tile_fits(int n, int p, int h, int w) {
  return n >= 1 && p >= 1 && h >= 1 && w >= 1 && (long long)h * w * 4 <= kMaxTileBytes;
}

// ---------------------------------------------------------------------------
// Nearest-cell reads for the uncertainty ranking (no gradient: the ranking is
// a selection heuristic and runs without one).
//
// K11, point_sample_nearest_kernel, replaces point_sample_kernel.py:
// point_sample_nearest_pallas,
//   out[m, p] = img[m, clamp(int(cy * h), 0, h - 1), clamp(int(cx * w), 0, w - 1)].
// The TPU kernel is two one-hot matrix products, because the TPU has no fast
// element gather, and it rounds the image to bf16 on the way.  The card
// gathers natively, so this kernel reads the fp32 value exactly, the cell
// from __fmul_rn and a truncating cast as the plain version computes it.
//
// What bounds it: bytes.  The coordinates (8 bytes a point) and the output
// (4) are streamed once; at the ranking's shapes (37632 candidates a mask,
// masks of 16x16 to 160x160) they are 82-99% of the bytes, the masks the
// rest.  Split on the card (PERF.md section 6): a first design, one thread
// per point reading its cell where the mask lies, ran at half its bound;
// without that read it ran at the streaming rate.  Each read is a dependent
// L2 access that moves a 32-byte sector for 4 useful bytes, 2.7 times the
// streamed bytes at 128x128.
//
// The design: a 2-D grid of blocks, one per (tile of points, mask), so no
// block divides by the point count.
//   shared route, for a mask whose fp32 image fits a block's shared memory
//     (227 KB; every shape of the ranking's i.i.d. route, 16x16 to 160x160):
//     the block copies its mask into shared memory once (16-byte cp.async),
//     while it issues its first coordinate loads, and every read is then a
//     bank access.  A tile streams at least 8 times its mask's bytes, so the
//     copies are a small share of a block's traffic.
//   direct route, for larger masks: the same loop, the cells read where the
//     mask lies (__ldg).
// Each thread takes 4 points a step from two 16-byte evict-first loads
// (__ldcs) and writes them with one 16-byte streaming store (__stcs); the next
// step's loads are issued before this step's reads, 64 bytes of
// coordinates in flight a thread.  An odd point count or an operand that
// does not start at a multiple of 16 bytes takes a variant of one point a
// slot (8-byte loads, 4-byte stores); a mask of a size not a multiple of 4
// floats, or not 16-byte aligned, is copied 4 bytes at a time.
//
// K12, point_sample_nearest_rows_kernel, replaces point_sample_kernel.py:
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
// (the plain version raises on it instead).  Bytes bound it as they bound
// K11: at a training step's shapes (8000 masks of 128x128, 37632 candidates
// each) cx, cy and the output are 3.6 GB against 0.5 GB of masks.

constexpr int kChunk = 128;          // candidates per chunk
constexpr int kRowsWarps = 8;        // chunks (warps) per block

__device__ __forceinline__ int cell_of(float c, int size) {
  return min(max((int)__fmul_rn(c, (float)size), 0), size - 1);
}

constexpr int kNearThreads = 512;
constexpr int kNearMinTile = 4096;   // points a tile, at least
constexpr int kNearFillBlocks = 4 * 132;   // four blocks on each of the H100's SMs

// the cell's value: a bank access (Shared) or a read where the mask lies
template <bool Shared>
__device__ __forceinline__ float cell_value(const float* im, float x, float y, int H, int W) {
  const int at = cell_of(y, H) * W + cell_of(x, W);
  if constexpr (Shared) return im[at];
  else return __ldg(im + at);
}

// One slot of K11: four points (VP: two 16-byte coordinate loads, one 16-byte
// store) or one (an 8-byte load, a 4-byte store).
template <bool VP>
struct NearSlot;

template <>
struct NearSlot<true> {
  static constexpr int kPoints = 4;
  float4 a, b;
  __device__ __forceinline__ void load(const float* cm, int s) {
    a = __ldcs(reinterpret_cast<const float4*>(cm) + 2 * s);
    b = __ldcs(reinterpret_cast<const float4*>(cm) + 2 * s + 1);
  }
  template <bool Shared>
  __device__ __forceinline__ void store(float* om, int s, const float* im, int H, int W) const {
    float4 o;
    o.x = cell_value<Shared>(im, a.x, a.y, H, W);
    o.y = cell_value<Shared>(im, a.z, a.w, H, W);
    o.z = cell_value<Shared>(im, b.x, b.y, H, W);
    o.w = cell_value<Shared>(im, b.z, b.w, H, W);
    __stcs(reinterpret_cast<float4*>(om) + s, o);
  }
};

template <>
struct NearSlot<false> {
  static constexpr int kPoints = 1;
  float2 c;
  __device__ __forceinline__ void load(const float* cm, int s) {
    c = __ldcs(reinterpret_cast<const float2*>(cm) + s);
  }
  template <bool Shared>
  __device__ __forceinline__ void store(float* om, int s, const float* im, int H, int W) const {
    __stcs(om + s, cell_value<Shared>(im, c.x, c.y, H, W));
  }
};

// Block (x, y): points [x * tile, (x + 1) * tile) of masks y, y + gridDim.y,
// ...; tile is a multiple of 4.  Shared: the mask is copied into shared
// memory first (VN: 16-byte copies).  A thread's slots in a step are s, s +
// kNearThreads, ... (kUnroll of them), coalesced across the block.
template <bool Shared, bool VN, bool VP>
__global__ void __launch_bounds__(kNearThreads)
point_sample_nearest_kernel(const float* __restrict__ img, const float* __restrict__ coords,
                            float* __restrict__ out, int n, int P, int H, int W, int tile) {
  extern __shared__ __align__(16) float cells[];
  using Slot = NearSlot<VP>;
  constexpr int kUnroll = VP ? 2 : 8;          // 64 bytes of coordinates a thread a step
  constexpr int kStep = kUnroll * kNearThreads;
  const int hw = H * W, tid = threadIdx.x;
  const int t0 = blockIdx.x * tile;
  const int s0 = t0 / Slot::kPoints + tid;
  const int s1 = min(t0 + tile, P) / Slot::kPoints;
  for (long long m = blockIdx.y; m < n; m += gridDim.y) {
    const float* src = img + m * hw;
    const float* im = src;
    if constexpr (Shared) {
      __syncthreads();                         // the last mask's reads are done
      if constexpr (VN) {
        for (int i = tid * 4; i < hw; i += kNearThreads * 4) cp_async16(cells + i, src + i);
      } else {
        for (int i = tid; i < hw; i += kNearThreads) cells[i] = src[i];
      }
      im = cells;
    }
    const float* cm = coords + m * P * 2;
    float* om = out + m * P;
    Slot cur[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (s0 + u * kNearThreads < s1) cur[u].load(cm, s0 + u * kNearThreads);
    if constexpr (Shared) {
      if constexpr (VN) cp_async_wait_all();
      __syncthreads();
    }
    for (int s = s0; s < s1; s += kStep) {
      Slot next[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (s + kStep + u * kNearThreads < s1) next[u].load(cm, s + kStep + u * kNearThreads);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (s + u * kNearThreads < s1)
          cur[u].template store<Shared>(om, s + u * kNearThreads, im, H, W);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) cur[u] = next[u];
    }
  }
}

// Points a tile (a multiple of 4): at least kNearMinTile and, on the shared
// route, a stream (12 bytes a point) of at least 8 times the mask's bytes;
// fewer where that leaves the card short of blocks; tiles of equal size.
int nearest_tile(int n, int p, int hw, bool shared) {
  long long least = kNearMinTile;
  if (shared) least = std::max(least, (long long)hw * 4 * 8 / 12);
  long long tiles = (p + least - 1) / least;
  const long long fill = (kNearFillBlocks + n - 1) / n;
  if (tiles < fill) tiles = std::min(fill, (p + 1023LL) / 1024);
  const long long tile = (p + tiles - 1) / tiles;
  return (int)((tile + 3) / 4 * 4);
}

template <bool Shared, bool VN, bool VP>
int launch_nearest(const float* img, const float* coords, float* out, int n, int p, int h,
                   int w, void* stream_ptr) {
  auto kernel = point_sample_nearest_kernel<Shared, VN, VP>;
  const size_t smem = Shared ? (size_t)h * w * sizeof(float) : 0;
  if (Shared) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           kMaxTileBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int tile = nearest_tile(n, p, h * w, Shared);
  const dim3 grid((p + tile - 1) / tile, std::min(n, 65535));
  kernel<<<grid, kNearThreads, smem, static_cast<cudaStream_t>(stream_ptr)>>>(
      img, coords, out, n, p, h, w, tile);
  return static_cast<int>(cudaGetLastError());
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

// img (n, h, w) f32; coords (n, p, 2) f32 in [0, 1], (x, y), 8-byte aligned
// -> out (n, p).  The direct route.
extern "C" int aff_point_sample(const float* img, const float* coords, float* out,
                                int n, int p, int h, int w, void* stream_ptr) {
  if (n < 1 || p < 1 || h < 1 || w < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long total = (long long)n * p;
  point_sample_kernel<<<blocks_for(total), kThreads, 0,
                        static_cast<cudaStream_t>(stream_ptr)>>>(
      img, reinterpret_cast<const float2*>(coords), out, total, p, h, w);
  return static_cast<int>(cudaGetLastError());
}

// The same on the shared route: h * w * 4 bytes must fit 227 KB.
extern "C" int aff_point_sample_shared(const float* img, const float* coords, float* out,
                                       int n, int p, int h, int w, void* stream_ptr) {
  if (!tile_fits(n, p, h, w)) return static_cast<int>(cudaErrorInvalidValue);
  const bool vn = (h * w) % 4 == 0 && aligned(img, 16);
  const bool vp = p % 2 == 0 && aligned(coords, 16) && aligned(out, 8);
  const int hw = h * w;
  if (vn && vp)
    return launch_tile(point_sample_tile_kernel<true, true>, n, hw, stream_ptr, img, coords, out,
                       p, h, w);
  if (vn)
    return launch_tile(point_sample_tile_kernel<true, false>, n, hw, stream_ptr, img, coords,
                       out, p, h, w);
  if (vp)
    return launch_tile(point_sample_tile_kernel<false, true>, n, hw, stream_ptr, img, coords,
                       out, p, h, w);
  return launch_tile(point_sample_tile_kernel<false, false>, n, hw, stream_ptr, img, coords, out,
                     p, h, w);
}

// coords (n, p, 2), 8-byte aligned; g (n, p) = d out -> dimg (n, h, w),
// zeroed on entry.  The direct route.
extern "C" int aff_point_sample_bwd(const float* coords, const float* g, float* dimg,
                                    int n, int p, int h, int w, void* stream_ptr) {
  if (n < 1 || p < 1 || h < 1 || w < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long total = (long long)n * p;
  point_sample_bwd_kernel<<<blocks_for(total), kThreads, 0,
                            static_cast<cudaStream_t>(stream_ptr)>>>(
      reinterpret_cast<const float2*>(coords), g, dimg, total, p, h, w);
  return static_cast<int>(cudaGetLastError());
}

// The same on the shared route: every element of dimg written, no zeroing
// needed; h * w * 4 bytes must fit 227 KB.
extern "C" int aff_point_sample_bwd_shared(const float* coords, const float* g, float* dimg,
                                           int n, int p, int h, int w, void* stream_ptr) {
  if (!tile_fits(n, p, h, w)) return static_cast<int>(cudaErrorInvalidValue);
  const bool vn = (h * w) % 4 == 0 && aligned(dimg, 16);
  const bool vp = p % 2 == 0 && aligned(coords, 16) && aligned(g, 8);
  const int hw = h * w;
  if (vn && vp)
    return launch_tile(point_sample_tile_bwd_kernel<true, true>, n, hw, stream_ptr, coords, g,
                       dimg, p, h, w);
  if (vn)
    return launch_tile(point_sample_tile_bwd_kernel<true, false>, n, hw, stream_ptr, coords, g,
                       dimg, p, h, w);
  if (vp)
    return launch_tile(point_sample_tile_bwd_kernel<false, true>, n, hw, stream_ptr, coords, g,
                       dimg, p, h, w);
  return launch_tile(point_sample_tile_bwd_kernel<false, false>, n, hw, stream_ptr, coords, g,
                     dimg, p, h, w);
}

// img (n, h, w) f32; coords (n, p, 2) f32 (x, y), 8-byte aligned -> out (n,
// p): the value of the cell each point falls in.  The direct route.
extern "C" int aff_point_sample_nearest(const float* img, const float* coords, float* out,
                                        int n, int p, int h, int w, void* stream_ptr) {
  if (n < 1 || p < 1 || h < 1 || w < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (p % 4 == 0 && aligned(coords, 16) && aligned(out, 16))
    return launch_nearest<false, false, true>(img, coords, out, n, p, h, w, stream_ptr);
  return launch_nearest<false, false, false>(img, coords, out, n, p, h, w, stream_ptr);
}

// The same on the shared route: h * w * 4 bytes must fit 227 KB.
extern "C" int aff_point_sample_nearest_shared(const float* img, const float* coords, float* out,
                                               int n, int p, int h, int w, void* stream_ptr) {
  if (!tile_fits(n, p, h, w)) return static_cast<int>(cudaErrorInvalidValue);
  const bool vn = (h * w) % 4 == 0 && aligned(img, 16);
  const bool vp = p % 4 == 0 && aligned(coords, 16) && aligned(out, 16);
  if (vn && vp) return launch_nearest<true, true, true>(img, coords, out, n, p, h, w, stream_ptr);
  if (vn) return launch_nearest<true, true, false>(img, coords, out, n, p, h, w, stream_ptr);
  if (vp) return launch_nearest<true, false, true>(img, coords, out, n, p, h, w, stream_ptr);
  return launch_nearest<true, false, false>(img, coords, out, n, p, h, w, stream_ptr);
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

// Row lookup in a channel-major table: out[b, :, s] = table[b, :, idx[b, s]].
//
// Replaces autofocusformermod_tpu/ops/pallas/window_gather.py:
// windowed_row_gather (_kernel).  The pixel decoder's channel-major sampling
// prep looks up, for every sampled location, the packed 4-NN row of its grid
// cell ([idx x4 | x x4 | y x4], C = 12 floats) in a Morton-ordered table
// (b, C, N) and wants the result channel-major too, (b, C, S) with the
// samples minor.  The TPU kernel slides a window of 128-row bands over the
// table and select-combines lane gathers, with a full-table sweep when a
// tile's rows spread wider than the window: none of that carries over, the
// card reads any address.  It copies floats, so the result is exact.
//
// What bounds it on the H100: bytes.  Per sample it reads 4 bytes of index
// and writes C floats, and the table is read once: (N C + S + S C) * 4 bytes
// per image.  It copies floats (fp32, no tensor cores), so the result is exact.
//
// Two routes, chosen by the wrapper from the shapes alone
// (ops/window_gather.py:window_gather_route), both counted:
//
// Shared route (window_gather_shared_kernel), the path's: one channel of one
// image's table is N * 4 bytes (64 KB at the path's 128x128 cells) and the
// result is channel-major too, so a block needs exactly one slice.  Grid
// (sample splits, C, b); a block brings its slice into dynamic shared memory
// with 16-byte asynchronous copies (cp.async), then walks its share of the
// samples: a thread reads 4 indices with one 16-byte load (coalesced, shared by
// the C channel blocks through L2), looks the 4 rows up in shared memory and
// writes one 16-byte coalesced store.  The random reads, which cost the direct
// route a 32-byte L2 sector for 4 useful bytes, become bank accesses; device
// memory sees the index and the result only, L2 the slice once per split.  The
// launcher picks the splits so that as many blocks as fit the SMs' shared
// memory (up to 3 per SM) fill the card once: 8 splits at b = 4, C = 12.
//
// Direct route (window_gather_kernel), for a slice that does not fit shared
// memory (N above 57344 cells) or a call with fewer samples than rows, where
// staging the slice would cost more than reading from it: one thread per
// (sample s, channel c), the channel on the grid's y axis.  The index of a
// sample is read once per channel (coalesced along s); reads of one channel
// are 4 bytes each wherever the sample's cell lies; writes are coalesced
// along s.
//
// On both routes an index outside [0, N) is clamped into the table (the
// contract is that none is; the plain version raises on one).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChannels = 32;
constexpr int kSharedThreads = 512;
// the largest slice of the shared route: 224 KB of the 227 KB a block may use
constexpr int kMaxSliceBytes = 57344 * 4;
constexpr int kMaxBlocksPerSm = 3;
constexpr int kMaxDevices = 64;

__global__ void __launch_bounds__(kThreads)
window_gather_kernel(const float* __restrict__ table, const int* __restrict__ idx,
                     float* __restrict__ out, int C, int N, int S) {
  const int b = blockIdx.z, c = blockIdx.y;
  const int s = blockIdx.x * kThreads + threadIdx.x;
  if (s >= S) return;
  const int row = min(max(idx[(size_t)b * S + s], 0), N - 1);
  out[((size_t)b * C + c) * S + s] = table[((size_t)b * C + c) * N + row];
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// VEC_N: the slice starts at a multiple of 16 bytes and N is a multiple of 4
// (16-byte asynchronous copies, else 4-byte loads); VEC_S: the same for the
// index and result rows (4 samples per thread and step, else 1).
template <bool VEC_N, bool VEC_S>
__global__ void __launch_bounds__(kSharedThreads)
window_gather_shared_kernel(const float* __restrict__ table, const int* __restrict__ idx,
                            float* __restrict__ out, int C, int N, int S, int per_split) {
  extern __shared__ __align__(16) float slice[];
  const int b = blockIdx.z, c = blockIdx.y;
  const float* src = table + ((size_t)b * C + c) * N;
  if constexpr (VEC_N) {
    for (int i = threadIdx.x * 4; i < N; i += kSharedThreads * 4) cp_async16(slice + i, src + i);
    cp_async_wait_all();
  } else {
    for (int i = threadIdx.x; i < N; i += kSharedThreads) slice[i] = src[i];
  }
  __syncthreads();

  const int s_beg = blockIdx.x * per_split;           // a multiple of 4
  const int s_end = min(S, s_beg + per_split);
  const int* ib = idx + (size_t)b * S;
  float* ob = out + ((size_t)b * C + c) * S;
  if constexpr (VEC_S) {
    for (int s = s_beg + threadIdx.x * 4; s < s_end; s += kSharedThreads * 4) {
      const int4 r = *reinterpret_cast<const int4*>(ib + s);
      float4 o;
      o.x = slice[min(max(r.x, 0), N - 1)];
      o.y = slice[min(max(r.y, 0), N - 1)];
      o.z = slice[min(max(r.z, 0), N - 1)];
      o.w = slice[min(max(r.w, 0), N - 1)];
      *reinterpret_cast<float4*>(ob + s) = o;
    }
  } else {
    for (int s = s_beg + threadIdx.x; s < s_end; s += kSharedThreads)
      ob[s] = slice[min(max(ib[s], 0), N - 1)];
  }
}

inline bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

}  // namespace

// table (b, c, n) f32 channel-major; idx (b, s) i32 in [0, n) -> out (b, c, s).
// The direct route.
extern "C" int aff_window_gather(const float* table, const int* idx, float* out, int b, int c,
                                 int n, int s, void* stream_ptr) {
  if (b < 1 || b > 65535 || c < 1 || c > kMaxChannels || n < 1 || s < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((s + kThreads - 1) / kThreads, c, b);
  window_gather_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream_ptr)>>>(
      table, idx, out, c, n, s);
  return static_cast<int>(cudaGetLastError());
}

// The same function on the shared route; n * 4 bytes must fit kMaxSliceBytes.
extern "C" int aff_window_gather_shared(const float* table, const int* idx, float* out, int b,
                                        int c, int n, int s, void* stream_ptr) {
  if (b < 1 || b > 65535 || c < 1 || c > kMaxChannels || n < 1 || s < 1 ||
      (long long)n * 4 > kMaxSliceBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  // per device, asked once: the SM count and (below) the kernels' leave to
  // use more than 48 KB of dynamic shared memory
  static int sm_count[kMaxDevices] = {};
  static bool may_use_slice[kMaxDevices][4] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (sm_count[dev] == 0) {
    err = cudaDeviceGetAttribute(&sm_count[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int sms = sm_count[dev];
  const int slice_bytes = (n * 4 + 15) / 16 * 16;
  const int per_sm = max(1, min(kMaxBlocksPerSm, (227 * 1024) / (slice_bytes + 1024)));
  // fill the card once; a split is a multiple of 4 samples and at least one
  // step of the block
  int splits = max(1, (sms * per_sm) / (b * c));
  splits = min(splits, (s + kSharedThreads * 4 - 1) / (kSharedThreads * 4));
  splits = min(splits, 65535);
  const int per_split = ((s + splits - 1) / splits + 3) / 4 * 4;
  dim3 grid((s + per_split - 1) / per_split, c, b);
  const bool vec_n = n % 4 == 0 && aligned16(table);
  const bool vec_s = s % 4 == 0 && aligned16(idx) && aligned16(out);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
#define SHARED_LAUNCH(VN, VS)                                                              \
  do {                                                                                     \
    bool& allowed = may_use_slice[dev][2 * VN + VS];                                       \
    if (!allowed) {                                                                        \
      err = cudaFuncSetAttribute(window_gather_shared_kernel<VN, VS>,                      \
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,              \
                                 kMaxSliceBytes);                                          \
      if (err != cudaSuccess) return static_cast<int>(err);                                \
      allowed = true;                                                                      \
    }                                                                                      \
    window_gather_shared_kernel<VN, VS><<<grid, kSharedThreads, slice_bytes, stream>>>(    \
        table, idx, out, c, n, s, per_split);                                              \
  } while (0)
  if (vec_n && vec_s) SHARED_LAUNCH(true, true);
  else if (vec_n) SHARED_LAUNCH(true, false);
  else if (vec_s) SHARED_LAUNCH(false, true);
  else SHARED_LAUNCH(false, false);
#undef SHARED_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

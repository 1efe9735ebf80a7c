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
// and writes C floats; the table (786 KB per image at 128x128 cells) is read
// at random but stays in L2, so device memory sees the index and the result:
// S * (4 + 4 C) bytes per image.
//
// Design: one thread per (sample s, channel c), the channel on the grid's y
// axis, so that every read and write of a warp is independent of the others
// and the card has b * C * S of them in flight.  The index of a sample is read
// once per channel (coalesced along s, from L2 after the first channel);
// reads of one channel are 4 bytes each wherever the sample's cell lies (the
// Morton order keeps nearby samples in nearby sectors); writes are coalesced
// along s.  An index outside [0, N) is clamped into the table (the contract
// is that none is; the plain version raises on one).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChannels = 32;

__global__ void __launch_bounds__(kThreads)
window_gather_kernel(const float* __restrict__ table, const int* __restrict__ idx,
                     float* __restrict__ out, int C, int N, int S) {
  const int b = blockIdx.z, c = blockIdx.y;
  const int s = blockIdx.x * kThreads + threadIdx.x;
  if (s >= S) return;
  const int row = min(max(idx[(size_t)b * S + s], 0), N - 1);
  out[((size_t)b * C + c) * S + s] = table[((size_t)b * C + c) * N + row];
}

}  // namespace

// table (b, c, n) f32 channel-major; idx (b, s) i32 in [0, n) -> out (b, c, s).
extern "C" int aff_window_gather(const float* table, const int* idx, float* out, int b, int c,
                                 int n, int s, void* stream_ptr) {
  if (b < 1 || b > 65535 || c < 1 || c > kMaxChannels || n < 1 || s < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((s + kThreads - 1) / kThreads, c, b);
  window_gather_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream_ptr)>>>(
      table, idx, out, c, n, s);
  return static_cast<int>(cudaGetLastError());
}

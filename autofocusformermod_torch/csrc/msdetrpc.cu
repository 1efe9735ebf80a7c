// Deformable point sampling over stacked levels (msdetrpc): forward and
// backward.
//
// Replaces autofocusformermod_tpu/ops/pallas/msdetrpc_kernel.py:
// msdetrpc_pallas_levels_s (forward, _run_fwd_v14 / _kernel_v14) and
// msdetrpc_pallas_levels_s_bwd_impl (backward, _bwd_levels_impl ->
// _run_bwd_kernel):
//   out[r, q, :] = sum_{j < L} sum_{p < P} w[r, q, j*P + p]
//                  * val[r, off_j + idx[r, q, j*P + p], :]
// with level-local indices idx, level offsets off_j = sum of the earlier
// level sizes, and w the 4-NN Shepard weight times the attention weight.
// Indices are clamped into their level, as the XLA gather's mode="clip".
//
// What bounds it on the H100: memory latency of the value-row gathers.  Each
// query reads L*P (48) rows of c_ (32) floats = 6 KB at ~2 flops per 8-byte
// pair; rows of one level are shared by nearby queries and sit in L2.
//
// Design: one block per (r = batch*head, tile of 8 queries), one warp per
// query with lanes over the channels, so each value row is one coalesced
// 128-byte read; the (idx, w) pairs are warp-uniform broadcast loads;
// accumulation is fp32 in registers.  The output keeps the natural
// (bh, n, c_) layout (the TPU kernel's channel-major output and its
// 128-row band windows exist for its tiling).
//
// Backward, for g = d out (bh, n, c_):
//   d_w[r, q, jp] = <g[r, q, :], val[r, row(jp), :]>
//   d_val[r, row(jp), :] += w[r, q, jp] * g[r, q, :]
// with the same warp-per-query layout: each pair is one coalesced row read,
// a warp-shuffle dot product and one coalesced row of atomicAdd reductions
// (many queries sample the same value row; the TPU kernel accumulates
// one-hot matmuls into a VMEM-resident d_val instead).  Bound by those
// reductions in L2: L*P*c_ per query.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kQueriesPerBlock = 8;

struct Levels {
  int count;
  int off[kMaxLevels];
  int size[kMaxLevels];
};

__global__ void __launch_bounds__(32 * kQueriesPerBlock)
msdetrpc_kernel(const int* __restrict__ idx, const float* __restrict__ w,
                const float* __restrict__ val, float* __restrict__ out,
                int N, int NTOT, int C, int P, Levels lv) {
  const int r = blockIdx.y;
  const int qi = blockIdx.x * kQueriesPerBlock + threadIdx.y;
  if (qi >= N) return;
  const int LP = lv.count * P;
  const int* ir = idx + ((size_t)r * N + qi) * LP;
  const float* wr = w + ((size_t)r * N + qi) * LP;
  const float* vr = val + (size_t)r * NTOT * C;
  float* orow = out + ((size_t)r * N + qi) * C;
  for (int c = threadIdx.x; c < C; c += 32) {
    float acc = 0.f;
    for (int j = 0; j < lv.count; ++j) {
      const int off = lv.off[j];
      const int last = lv.size[j] - 1;
      for (int p = 0; p < P; ++p) {
        const int t = min(max(ir[j * P + p], 0), last);
        acc += wr[j * P + p] * vr[(size_t)(off + t) * C + c];
      }
    }
    orow[c] = acc;
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__global__ void __launch_bounds__(32 * kQueriesPerBlock)
msdetrpc_bwd_kernel(const int* __restrict__ idx, const float* __restrict__ w,
                    const float* __restrict__ val, const float* __restrict__ g,
                    float* __restrict__ dval, float* __restrict__ dw,
                    int N, int NTOT, int C, int P, Levels lv) {
  const int r = blockIdx.y;
  const int qi = blockIdx.x * kQueriesPerBlock + threadIdx.y;
  if (qi >= N) return;  // the whole warp leaves together
  const int LP = lv.count * P;
  const int* ir = idx + ((size_t)r * N + qi) * LP;
  const float* wr = w + ((size_t)r * N + qi) * LP;
  const float* vr = val + (size_t)r * NTOT * C;
  float* dvr = dval + (size_t)r * NTOT * C;
  const float* grow = g + ((size_t)r * N + qi) * C;
  float* dwr = dw + ((size_t)r * N + qi) * LP;
  for (int j = 0; j < lv.count; ++j) {
    const int off = lv.off[j];
    const int last = lv.size[j] - 1;
    for (int p = 0; p < P; ++p) {
      const size_t row = (size_t)(off + min(max(ir[j * P + p], 0), last));
      const float wp = wr[j * P + p];
      float dot = 0.f;
      for (int c = threadIdx.x; c < C; c += 32) {
        const float gc = grow[c];
        dot += gc * vr[row * C + c];
        atomicAdd(dvr + row * C + c, wp * gc);
      }
      dot = warp_sum(dot);
      if (threadIdx.x == 0) dwr[j * P + p] = dot;
    }
  }
}

bool make_levels(int n_levels, const int* level_sizes, int ntot, Levels* lv) {
  if (n_levels < 1 || n_levels > kMaxLevels) return false;
  lv->count = n_levels;
  int off = 0;
  for (int j = 0; j < n_levels; ++j) {
    lv->off[j] = off;
    lv->size[j] = level_sizes[j];
    off += level_sizes[j];
  }
  return off == ntot;
}

}  // namespace

// idx (bh, n, L*P) i32 level-local; w (bh, n, L*P) f32; val (bh, ntot, c) f32
// -> out (bh, n, c) f32.  level_sizes: host array of L ints summing to ntot.
extern "C" int aff_msdetrpc(const int* idx, const float* w, const float* val,
                            float* out, int bh, int n, int ntot, int c,
                            int n_levels, const int* level_sizes, int pairs,
                            void* stream_ptr) {
  Levels lv;
  if (pairs < 1 || c < 1 || !make_levels(n_levels, level_sizes, ntot, &lv))
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 block(32, kQueriesPerBlock);
  dim3 grid((n + kQueriesPerBlock - 1) / kQueriesPerBlock, bh);
  msdetrpc_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream_ptr)>>>(
      idx, w, val, out, n, ntot, c, pairs, lv);
  return static_cast<int>(cudaGetLastError());
}

// The forward's operands plus g (bh, n, c) = d out -> dval (bh, ntot, c),
// which must arrive zeroed (atomic scatter), and dw (bh, n, L*P).
extern "C" int aff_msdetrpc_bwd(const int* idx, const float* w, const float* val,
                                const float* g, float* dval, float* dw, int bh, int n,
                                int ntot, int c, int n_levels, const int* level_sizes,
                                int pairs, void* stream_ptr) {
  Levels lv;
  if (pairs < 1 || c < 1 || !make_levels(n_levels, level_sizes, ntot, &lv))
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 block(32, kQueriesPerBlock);
  dim3 grid((n + kQueriesPerBlock - 1) / kQueriesPerBlock, bh);
  msdetrpc_bwd_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream_ptr)>>>(
      idx, w, val, g, dval, dw, n, ntot, c, pairs, lv);
  return static_cast<int>(cudaGetLastError());
}

// Deformable point sampling (msdetrpc), forward and backward, in every
// operand layout the pixel decoder builds.  First the stacked layout; the
// per-level, pair-major, head-natural and interleaved layouts follow it.
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


// ---------------------------------------------------------------------------
// The same contraction with the operands read where their producer left them.
//
// Replaces autofocusformermod_tpu/ops/pallas/msdetrpc_kernel.py:
//   msdetrpc_pallas_levels   (:1841, _kernel_v13): one (bh, n, P) idx and w
//                            array per level;
//   msdetrpc_pallas_levels_t (:1912): per level (bh, P, n), queries minor;
//   msdetrpc_pallas_bh       (:2359, _kernel_v12 / _bwd_kernel_v12): per level
//                            (b, n, h, P), values (b, ntot, h, c), result
//                            (b, n, h, c), heads where the Linear put them.
// On the TPU each layout is its own kernel because a relayout of the minor
// axes costs a pass over the operand; the three exist to avoid that pass.
// Here one body serves them: a warp per query with lanes over the channels,
// as above, and the address of pair p of level j of query (r, q) is
//   level_ptr[j] + r * batch_stride + q * query_stride + p * pair_stride.
// The head-natural layout is the per-level one with n * h "queries" per image
// (query q of head hd at q * h + hd), whose value rows lie h * c floats apart
// starting at hd * c.  No operand is copied or permuted on the way in.
//
// What bounds them: the value-row gathers, as above.  In the pair-major
// layout a query's pairs lie n floats apart, so its (idx, w) loads are not
// one broadcast line; the 8 consecutive queries of a block read the same
// 32-byte sectors, which L1 serves after the first warp.
//
// Backward: the same scatter as above (a row of atomicAdd per pair into a
// zeroed d_val, a warp-shuffle dot product for d_w), each d_w written at its
// weight's own address, so d_w has its operand's layout.

struct PairLayout {
  const int* idx[kMaxLevels];
  const float* w[kMaxLevels];
  float* dw[kMaxLevels];  // backward only
  long long batch_stride, query_stride, pair_stride;
};

// NQ: queries per r (n, or n * H head-natural); H: heads folded into the
// query axis (1 unless head-natural); val (R, NTOT, H, C); out (R, NQ, C).
// kUnitPairs: a query's pairs are contiguous (pair_stride 1), known when the
// kernel is compiled.
template <bool kUnitPairs>
__global__ void __launch_bounds__(32 * kQueriesPerBlock)
msdetrpc_layout_kernel(PairLayout lay, const float* __restrict__ val,
                       float* __restrict__ out, int NQ, int NTOT, int C, int P, int H,
                       Levels lv) {
  const int r = blockIdx.y;
  const int qi = blockIdx.x * kQueriesPerBlock + threadIdx.y;
  if (qi >= NQ) return;
  const size_t base = (size_t)r * lay.batch_stride + (size_t)qi * lay.query_stride;
  const size_t ps = kUnitPairs ? 1 : (size_t)lay.pair_stride;
  const size_t row_stride = (size_t)H * C;
  const float* vr = val + ((size_t)r * NTOT * H + (qi % H)) * C;
  float* orow = out + ((size_t)r * NQ + qi) * C;
  for (int c = threadIdx.x; c < C; c += 32) {
    float acc = 0.f;
    // unrolled over the capacity so that the level pointers are read from the
    // kernel's parameters at fixed offsets (an index that is only known at
    // run time would make every thread copy the struct to local memory)
#pragma unroll
    for (int j = 0; j < kMaxLevels; ++j) {
      if (j >= lv.count) break;
      const int* ip = lay.idx[j] + base;
      const float* wp = lay.w[j] + base;
      const int off = lv.off[j];
      const int last = lv.size[j] - 1;
      for (int p = 0; p < P; ++p) {
        const int t = min(max(ip[p * ps], 0), last);
        acc += wp[p * ps] * vr[(size_t)(off + t) * row_stride + c];
      }
    }
    orow[c] = acc;
  }
}

template <bool kUnitPairs>
__global__ void __launch_bounds__(32 * kQueriesPerBlock)
msdetrpc_layout_bwd_kernel(PairLayout lay, const float* __restrict__ val,
                           const float* __restrict__ g, float* __restrict__ dval,
                           int NQ, int NTOT, int C, int P, int H, Levels lv) {
  const int r = blockIdx.y;
  const int qi = blockIdx.x * kQueriesPerBlock + threadIdx.y;
  if (qi >= NQ) return;  // the whole warp leaves together
  const size_t base = (size_t)r * lay.batch_stride + (size_t)qi * lay.query_stride;
  const size_t ps = kUnitPairs ? 1 : (size_t)lay.pair_stride;
  const size_t row_stride = (size_t)H * C;
  const size_t head = ((size_t)r * NTOT * H + (qi % H)) * C;
  const float* vr = val + head;
  float* dvr = dval + head;
  const float* grow = g + ((size_t)r * NQ + qi) * C;
#pragma unroll
  for (int j = 0; j < kMaxLevels; ++j) {  // unrolled for the reason given above
    if (j >= lv.count) break;
    const int* ip = lay.idx[j] + base;
    const float* wp = lay.w[j] + base;
    float* dwp = lay.dw[j] + base;
    const int off = lv.off[j];
    const int last = lv.size[j] - 1;
    for (int p = 0; p < P; ++p) {
      const size_t row = (size_t)(off + min(max(ip[p * ps], 0), last)) * row_stride;
      const float wq = wp[p * ps];
      float dot = 0.f;
      for (int c = threadIdx.x; c < C; c += 32) {
        const float gc = grow[c];
        dot += gc * vr[row + c];
        atomicAdd(dvr + row + c, wq * gc);
      }
      dot = warp_sum(dot);
      if (threadIdx.x == 0) dwp[p * ps] = dot;
    }
  }
}

// ---------------------------------------------------------------------------
// The interleaved layout: replaces msdetrpc_kernel.py: msdetrpc_pallas
// (:1204, forward :1090 with _regroup :1072, VJP :1355), the kernel of the
// op ops/clusten.py: msdetrpc,
//   out[r, q, :] = sum_s attn[r, q, s] * sum_t nn_weight[r, q, s, t]
//                  * val[r, nn_idx[r, q, s, t], :]
// with M slots s of K taps t and GLOBAL row indices (clamped into the table).
// The TPU wrapper folds the attention into the weights and regroups the slots
// by level in XLA before its kernel, and splits the folded gradient after it;
// here the kernel reads (bh, n, M, K) and (bh, n, M) as they are, multiplies
// the attention in, and the backward emits d_nn_weight, d_attn and d_val:
//   dot[s, t]         = <g[r, q, :], val[r, idx[s, t], :]>
//   d_nn_weight[s, t] = attn[s] * dot[s, t]
//   d_attn[s]         = sum_t nn_weight[s, t] * dot[s, t]
//   d_val[r, idx, :] += attn[s] * nn_weight[s, t] * g[r, q, :]
// A slot's level is not needed: the indices are global.  Same warp-per-query
// design and the same bound (the value-row gathers) as the kernels above.

__global__ void __launch_bounds__(32 * kQueriesPerBlock)
msdetrpc_interleaved_kernel(const int* __restrict__ idx, const float* __restrict__ w,
                            const float* __restrict__ attn, const float* __restrict__ val,
                            float* __restrict__ out, int N, int NTOT, int C, int M, int K) {
  const int r = blockIdx.y;
  const int qi = blockIdx.x * kQueriesPerBlock + threadIdx.y;
  if (qi >= N) return;
  const size_t q = (size_t)r * N + qi;
  const int* ir = idx + q * M * K;
  const float* wr = w + q * M * K;
  const float* ar = attn + q * M;
  const float* vr = val + (size_t)r * NTOT * C;
  for (int c = threadIdx.x; c < C; c += 32) {
    float acc = 0.f;
    for (int s = 0; s < M; ++s) {
      float slot = 0.f;
      for (int t = 0; t < K; ++t) {
        const int row = min(max(ir[s * K + t], 0), NTOT - 1);
        slot += wr[s * K + t] * vr[(size_t)row * C + c];
      }
      acc += ar[s] * slot;
    }
    out[q * C + c] = acc;
  }
}

__global__ void __launch_bounds__(32 * kQueriesPerBlock)
msdetrpc_interleaved_bwd_kernel(const int* __restrict__ idx, const float* __restrict__ w,
                                const float* __restrict__ attn, const float* __restrict__ val,
                                const float* __restrict__ g, float* __restrict__ dw,
                                float* __restrict__ dattn, float* __restrict__ dval,
                                int N, int NTOT, int C, int M, int K) {
  const int r = blockIdx.y;
  const int qi = blockIdx.x * kQueriesPerBlock + threadIdx.y;
  if (qi >= N) return;  // the whole warp leaves together
  const size_t q = (size_t)r * N + qi;
  const int* ir = idx + q * M * K;
  const float* wr = w + q * M * K;
  const float* ar = attn + q * M;
  const float* vr = val + (size_t)r * NTOT * C;
  float* dvr = dval + (size_t)r * NTOT * C;
  const float* grow = g + q * C;
  for (int s = 0; s < M; ++s) {
    const float a = ar[s];
    float da = 0.f;
    for (int t = 0; t < K; ++t) {
      const size_t row = (size_t)min(max(ir[s * K + t], 0), NTOT - 1) * C;
      const float wt = wr[s * K + t];
      float dot = 0.f;
      for (int c = threadIdx.x; c < C; c += 32) {
        const float gc = grow[c];
        dot += gc * vr[row + c];
        atomicAdd(dvr + row + c, a * wt * gc);
      }
      dot = warp_sum(dot);
      da += wt * dot;
      if (threadIdx.x == 0) dw[q * M * K + s * K + t] = a * dot;
    }
    if (threadIdx.x == 0) dattn[q * M + s] = da;
  }
}

// Checks and launches one of the layout kernels.  idxs / ws / dws: host
// arrays of n_levels device pointers.  dws null: forward into `result`
// (out); else backward, with g = d out and `result` the zeroed d_val.
// r: images or image-heads (grid.y); nq: queries per r.
int run_layout(const void* const* idxs, const void* const* ws, void* const* dws,
               const float* val, const float* g, float* result, int r, int nq, int heads,
               int ntot, int c, int n_levels, const int* level_sizes, int pairs,
               long long query_stride, long long pair_stride, void* stream_ptr) {
  Levels lv;
  if (pairs < 1 || c < 1 || heads < 1 || nq < 1 || r < 1 || r > 65535 ||
      !make_levels(n_levels, level_sizes, ntot, &lv))
    return static_cast<int>(cudaErrorInvalidValue);
  PairLayout lay;
  for (int j = 0; j < n_levels; ++j) {
    lay.idx[j] = static_cast<const int*>(idxs[j]);
    lay.w[j] = static_cast<const float*>(ws[j]);
    lay.dw[j] = dws ? static_cast<float*>(dws[j]) : nullptr;
  }
  lay.batch_stride = (long long)nq * pairs;
  lay.query_stride = query_stride;
  lay.pair_stride = pair_stride;
  dim3 block(32, kQueriesPerBlock);
  dim3 grid((nq + kQueriesPerBlock - 1) / kQueriesPerBlock, r);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (dws && pair_stride == 1)
    msdetrpc_layout_bwd_kernel<true><<<grid, block, 0, stream>>>(lay, val, g, result, nq, ntot,
                                                                 c, pairs, heads, lv);
  else if (dws)
    msdetrpc_layout_bwd_kernel<false><<<grid, block, 0, stream>>>(lay, val, g, result, nq, ntot,
                                                                  c, pairs, heads, lv);
  else if (pair_stride == 1)
    msdetrpc_layout_kernel<true><<<grid, block, 0, stream>>>(lay, val, result, nq, ntot, c,
                                                             pairs, heads, lv);
  else
    msdetrpc_layout_kernel<false><<<grid, block, 0, stream>>>(lay, val, result, nq, ntot, c,
                                                              pairs, heads, lv);
  return static_cast<int>(cudaGetLastError());
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

// The per-level, pair-major and head-natural launchers.  idxs / ws / dws: host
// arrays of n_levels device pointers; level_sizes: host array of n_levels ints
// summing to ntot.  More than 8 levels, or a grid the card refuses
// (bh > 65535), is an error.  Each backward takes g = d out in out's layout,
// dval zeroed (atomic scatter) in val's layout, and writes every dws[j] in
// its w's layout.

// Per level idx, w (bh, n, P); val (bh, ntot, c) -> out (bh, n, c).
extern "C" int aff_msdetrpc_levels(const void* const* idxs, const void* const* ws,
                                   const float* val, float* out, int bh, int n, int ntot,
                                   int c, int n_levels, const int* level_sizes, int pairs,
                                   void* stream_ptr) {
  return run_layout(idxs, ws, nullptr, val, nullptr, out, bh, n, 1, ntot, c, n_levels,
                    level_sizes, pairs, pairs, 1, stream_ptr);
}

extern "C" int aff_msdetrpc_levels_bwd(const void* const* idxs, const void* const* ws,
                                       const float* val, const float* g, float* dval,
                                       void* const* dws, int bh, int n, int ntot, int c,
                                       int n_levels, const int* level_sizes, int pairs,
                                       void* stream_ptr) {
  return run_layout(idxs, ws, dws, val, g, dval, bh, n, 1, ntot, c, n_levels, level_sizes,
                    pairs, pairs, 1, stream_ptr);
}

// Per level idx, w (bh, P, n), queries minor; val (bh, ntot, c) -> out (bh, n, c).
extern "C" int aff_msdetrpc_levels_t(const void* const* idxs, const void* const* ws,
                                     const float* val, float* out, int bh, int n, int ntot,
                                     int c, int n_levels, const int* level_sizes, int pairs,
                                     void* stream_ptr) {
  return run_layout(idxs, ws, nullptr, val, nullptr, out, bh, n, 1, ntot, c, n_levels,
                    level_sizes, pairs, 1, n, stream_ptr);
}

extern "C" int aff_msdetrpc_levels_t_bwd(const void* const* idxs, const void* const* ws,
                                         const float* val, const float* g, float* dval,
                                         void* const* dws, int bh, int n, int ntot, int c,
                                         int n_levels, const int* level_sizes, int pairs,
                                         void* stream_ptr) {
  return run_layout(idxs, ws, dws, val, g, dval, bh, n, 1, ntot, c, n_levels, level_sizes,
                    pairs, 1, n, stream_ptr);
}

// Per level idx, w (b, n, h, P); val (b, ntot, h, c) -> out (b, n, h, c): the
// per-level layout with n * h queries per image.
extern "C" int aff_msdetrpc_bh(const void* const* idxs, const void* const* ws,
                               const float* val, float* out, int b, int n, int heads,
                               int ntot, int c, int n_levels, const int* level_sizes,
                               int pairs, void* stream_ptr) {
  if (heads < 1) return static_cast<int>(cudaErrorInvalidValue);
  return run_layout(idxs, ws, nullptr, val, nullptr, out, b, n * heads, heads, ntot, c,
                    n_levels, level_sizes, pairs, pairs, 1, stream_ptr);
}

extern "C" int aff_msdetrpc_bh_bwd(const void* const* idxs, const void* const* ws,
                                   const float* val, const float* g, float* dval,
                                   void* const* dws, int b, int n, int heads, int ntot, int c,
                                   int n_levels, const int* level_sizes, int pairs,
                                   void* stream_ptr) {
  if (heads < 1) return static_cast<int>(cudaErrorInvalidValue);
  return run_layout(idxs, ws, dws, val, g, dval, b, n * heads, heads, ntot, c, n_levels,
                    level_sizes, pairs, pairs, 1, stream_ptr);
}

// nn_idx, nn_weight (bh, n, m, k); attn (bh, n, m); val (bh, ntot, c) -> out (bh, n, c).
extern "C" int aff_msdetrpc_interleaved(const int* nn_idx, const float* nn_weight,
                                        const float* attn, const float* val, float* out,
                                        int bh, int n, int ntot, int c, int m, int k,
                                        void* stream_ptr) {
  if (m < 1 || k < 1 || c < 1 || ntot < 1 || bh > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 block(32, kQueriesPerBlock);
  dim3 grid((n + kQueriesPerBlock - 1) / kQueriesPerBlock, bh);
  msdetrpc_interleaved_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream_ptr)>>>(
      nn_idx, nn_weight, attn, val, out, n, ntot, c, m, k);
  return static_cast<int>(cudaGetLastError());
}

// The forward's operands plus g (bh, n, c) -> d_nn_weight (bh, n, m, k),
// d_attn (bh, n, m) and dval (bh, ntot, c), which must arrive zeroed.
extern "C" int aff_msdetrpc_interleaved_bwd(const int* nn_idx, const float* nn_weight,
                                            const float* attn, const float* val,
                                            const float* g, float* d_nn_weight,
                                            float* d_attn, float* dval, int bh, int n,
                                            int ntot, int c, int m, int k, void* stream_ptr) {
  if (m < 1 || k < 1 || c < 1 || ntot < 1 || bh > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 block(32, kQueriesPerBlock);
  dim3 grid((n + kQueriesPerBlock - 1) / kQueriesPerBlock, bh);
  msdetrpc_interleaved_bwd_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream_ptr)>>>(
      nn_idx, nn_weight, attn, val, g, d_nn_weight, d_attn, dval, n, ntot, c, m, k);
  return static_cast<int>(cudaGetLastError());
}

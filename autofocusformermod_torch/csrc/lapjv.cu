// Exact linear sum assignment (Jonker-Volgenant shortest augmenting paths
// with potentials), one thread block per problem.
//
// Replaces autofocusformermod_tpu/ops/pallas/lapjv_kernel.py: lsap_pallas
// (_kernel), itself the lockstep form of losses/lapjv.py hungarian_lsap.
// For each problem the T targets are rows and the Q >= T queries columns,
// 1-indexed with a virtual row 0 and column 0 (p[j] == 0: column j free).
// Row r = 1..T grows an alternating tree by Dijkstra over the columns:
//   cur_j  = c[i0, j] - u[i0] - v[j]           for columns j not in the tree
//   minv_j = min(minv_j, cur_j) (way_j = j0 where it drops)
//   j1 = first argmin of minv over free columns, delta = minv[j1]
//   u += delta on the tree's rows, v -= delta on its columns, minv -= delta
//   elsewhere; stop when j1 is unassigned, then flip the path back to col 0.
// Costs are clamped to +-3e4 (the matcher's 1e8 sentinel for padded targets
// would swamp the fp32 duals; the sentinels stay equal, so the order among
// costs is kept), and ties go to the first index, as in the JAX solver.
// A NaN cost counts as the largest cost, +3e4 (written out: fmaxf would drop
// the NaN and return -3e4), and +-inf are clamped like any other value, so
// every value the loop sees is finite: each Dijkstra step finds a finite
// minimum over the free columns, marks one more column used and so ends
// after at most Q + 1 steps, whatever the input.
// The float operations are the plain version's, in its order, so kernel and
// plain version give the same assignment.
//
// What bounds it on the H100: latency.  A solve is ~T^2/2 dependent
// Dijkstra steps of O(Q) work, each a block-wide argmin; the TPU kernel
// keeps all problems in lockstep on one core, here each problem is its own
// block (80 blocks for a batch-8 step's 10 stacked layers) and runs at its
// own pace.  State (u, v, minv, way, used, p) lives in shared memory; a
// thread owns columns tid, tid + blockDim, ...

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kClip = 3e4f;

// (value, index) pair that keeps the smaller value, the smaller index on ties
__device__ __forceinline__ void take_min(float& v, int& j, float v2, int j2) {
  if (v2 < v || (v2 == v && j2 < j)) {
    v = v2;
    j = j2;
  }
}

__global__ void __launch_bounds__(kThreads)
lapjv_kernel(const float* __restrict__ cost, int* __restrict__ out, int Q, int T) {
  extern __shared__ float smem[];
  const int q1 = Q + 1, t1 = T + 1;
  float* u = smem;                                   // t1
  float* v = u + t1;                                 // q1
  float* minv = v + q1;                              // q1
  int* way = reinterpret_cast<int*>(minv + q1);      // q1
  int* used = way + q1;                              // q1
  int* p = used + q1;                                // q1
  __shared__ float s_val[kWarps];
  __shared__ int s_idx[kWarps];
  __shared__ float s_delta;
  __shared__ int s_j0, s_j1;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* c = cost + (size_t)blockIdx.x * T * Q;  // (T, Q): row i-1, col j-1

  for (int j = tid; j < q1; j += kThreads) {
    v[j] = 0.f;
    p[j] = 0;
  }
  for (int i = tid; i < t1; i += kThreads) u[i] = 0.f;
  __syncthreads();

  for (int r = 1; r <= T; ++r) {
    for (int j = tid; j < q1; j += kThreads) {
      minv[j] = CUDART_INF_F;
      way[j] = 0;
      used[j] = j == 0;
    }
    if (tid == 0) {
      p[0] = r;
      s_j0 = 0;
    }
    __syncthreads();

    while (true) {
      const int j0 = s_j0;
      const int i0 = p[j0];
      const float ui0 = u[i0];
      const float* crow = c + (size_t)(i0 - 1) * Q;
      float best = CUDART_INF_F;
      int bj = q1;
      for (int j = tid; j < q1; j += kThreads) {
        if (used[j]) continue;
        const float raw = crow[j - 1];
        const float cij = raw != raw ? kClip : fminf(fmaxf(raw, -kClip), kClip);
        const float cur = cij - ui0 - v[j];
        if (cur < minv[j]) {
          minv[j] = cur;
          way[j] = j0;
        }
        take_min(best, bj, minv[j], j);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        take_min(best, bj, __shfl_xor_sync(0xffffffffu, best, o),
                 __shfl_xor_sync(0xffffffffu, bj, o));
      if (lane == 0) {
        s_val[warp] = best;
        s_idx[warp] = bj;
      }
      __syncthreads();
      if (tid == 0) {
        float dv = s_val[0];
        int dj = s_idx[0];
        for (int w = 1; w < kWarps; ++w) take_min(dv, dj, s_val[w], s_idx[w]);
        s_delta = dv;
        s_j1 = dj;
      }
      __syncthreads();

      const float delta = s_delta;
      const int j1 = s_j1;
      for (int j = tid; j < q1; j += kThreads) {
        if (used[j]) {
          u[p[j]] += delta;  // the used columns hold the tree's distinct rows
          v[j] -= delta;
        } else {
          minv[j] -= delta;
        }
      }
      __syncthreads();
      if (tid == 0) {
        used[j1] = 1;
        s_j0 = j1;
      }
      __syncthreads();
      if (p[j1] == 0) break;
    }

    if (tid == 0) {  // augment along the alternating path
      int j0 = s_j0;
      while (j0 != 0) {
        const int j1 = way[j0];
        p[j0] = p[j1];
        j0 = j1;
      }
    }
    __syncthreads();
  }

  int* o = out + (size_t)blockIdx.x * T;
  for (int j = tid + 1; j < q1; j += kThreads)
    if (p[j] > 0) o[p[j] - 1] = j - 1;
}

}  // namespace

// cost_tq (b, t, q) f32, the cost matrices transposed so that a target's row
// is contiguous, t <= q -> out (b, t) i32: the query matched to each target.
extern "C" int aff_lapjv(const float* cost_tq, int* out, int b, int q, int t,
                         void* stream_ptr) {
  if (b < 1 || t < 1 || t > q) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (size_t)(t + 1) * sizeof(float) + (size_t)(q + 1) * 2 * sizeof(float) +
                      (size_t)(q + 1) * 3 * sizeof(int);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  lapjv_kernel<<<b, kThreads, smem, static_cast<cudaStream_t>(stream_ptr)>>>(cost_tq, out,
                                                                             q, t);
  return static_cast<int>(cudaGetLastError());
}

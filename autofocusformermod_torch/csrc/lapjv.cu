// Exact linear sum assignment (Jonker-Volgenant shortest augmenting paths
// with potentials): one warp per problem ("warp" route), or one thread block
// per problem for shapes the warp cannot hold ("block" route).
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
// plain version give the same assignment.  Both routes read the matcher's
// (b, Q, T) cost layout in place: no transposed copy is made.
//
// What bounds it on the H100: latency.  A solve is a chain of dependent
// Dijkstra steps (4,000-5,000 for a training step's 100 x 100 problems, most
// of them on the padded target slots), each an argmin over the Q + 1
// columns; the work per step is tiny.  The time per step is the design's
// target:
//  - warp route (Q + 1 <= 32 * kMaxSlots, the costs fit shared memory): the
//    problem's costs are staged into shared memory once with cp.async (rows
//    T | 1 floats apart, so the 32 lanes' reads of one target's costs fall
//    on 32 banks) and clamped there.  Lane l owns columns l, l + 32, ...
//    (S = ceil((Q + 1) / 32) slots, a compile-time count) and keeps their
//    v, minv, way, p and the u of the row each column holds in registers;
//    u moves with its row when the path is flipped, so the tree's rows are
//    the used columns' and need no list.  A step has no branch: every slot
//    is computed and selects keep or drop it (branches per slot cost 2.8
//    times the time a step).  The argmin is the lane's own minimum over its
//    free columns (ties to the lower slot), which carries that column's p
//    and u along, then __reduce_min_sync over an order-preserving unsigned
//    image of the value (-0 read as +0, as the float comparison does) and a
//    second over the column among the lanes that hold it; the winner's p
//    and u come from its lane by one __shfl_sync each.  (A shuffle tree
//    carrying all four, one ballot per slot in place of the second reduce,
//    and a pairwise tree for the lane's own minimum were each slower.)  A
//    column's values are otherwise read from its owner by __shfl_sync, the
//    slot picked by compile-time comparisons (a run-time index into a
//    register array would spill it to local memory).  The path is walked
//    once along way (one shuffle a column) and flipped on all lanes at
//    once: every path column takes p and u of its way column, as the plain
//    version's backward walk does.  No block barrier anywhere; one warp per
//    block, so a step's 80 problems spread over 80 SMs.
//  - block route: 128 threads per problem, state in shared memory (the
//    first design, kept for shapes the warp route cannot take).

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr float kClip = 3e4f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxSlots = 8;                 // warp route: Q + 1 <= 256 columns
constexpr size_t kMaxSmem = 232448;          // the H100's shared memory per block

__device__ __forceinline__ float clamp_cost(float raw) {
  return raw != raw ? kClip : fminf(fmaxf(raw, -kClip), kClip);
}

// ------------------------------------------------------------ block route

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

// (value, index) pair that keeps the smaller value, the smaller index on ties
__device__ __forceinline__ void take_min(float& v, int& j, float v2, int j2) {
  if (v2 < v || (v2 == v && j2 < j)) {
    v = v2;
    j = j2;
  }
}

__global__ void __launch_bounds__(kThreads)
lapjv_block_kernel(const float* __restrict__ cost, int* __restrict__ out, int Q, int T) {
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
  const float* c = cost + (size_t)blockIdx.x * Q * T;  // (Q, T): col j-1, row i-1

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
      const float* crow = c + (i0 - 1);
      float best = CUDART_INF_F;
      int bj = q1;
      for (int j = tid; j < q1; j += kThreads) {
        if (used[j]) continue;
        const float cij = clamp_cost(crow[(size_t)(j - 1) * T]);
        const float cur = cij - ui0 - v[j];
        if (cur < minv[j]) {
          minv[j] = cur;
          way[j] = j0;
        }
        take_min(best, bj, minv[j], j);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        take_min(best, bj, __shfl_xor_sync(kFull, best, o), __shfl_xor_sync(kFull, bj, o));
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

// ------------------------------------------------------------- warp route

// a[s] for a warp-uniform run-time s, by compile-time comparisons (the
// array stays in registers)
template <int S, typename V>
__device__ __forceinline__ V pick(const V (&a)[S], int s) {
  V r = a[0];
#pragma unroll
  for (int k = 1; k < S; ++k)
    if (s == k) r = a[k];
  return r;
}

// order-preserving unsigned image of a finite float; -0 and +0 map to one
// key, as they compare equal
__device__ __forceinline__ unsigned order_key(float x) {
  const unsigned b = __float_as_uint(__fadd_rn(x, 0.f));
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float key_value(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

template <int S>
__global__ void __launch_bounds__(32)
lapjv_warp_kernel(const float* __restrict__ cost, int* __restrict__ out, int Q, int T, int ts) {
  extern __shared__ float cs[];                       // (Q, ts): cs[q * ts + t]
  const int lane = threadIdx.x;
  const float* c = cost + (size_t)blockIdx.x * Q * T;

  for (int q = 0; q < Q; ++q)
    for (int t = lane; t < T; t += 32) cp_async4(cs + q * ts + t, c + (size_t)q * T + t);
  asm volatile("cp.async.wait_all;\n" ::);
  for (int q = 0; q < Q; ++q)                         // each lane its own copies
    for (int t = lane; t < T; t += 32) cs[q * ts + t] = clamp_cost(cs[q * ts + t]);
  __syncwarp();

  float v[S], minv[S], uc[S];                         // uc: u of the row column j holds
  int p[S], way[S], coff[S];
  unsigned exists = 0;                                // bit s: column lane + 32 s <= Q
#pragma unroll
  for (int s = 0; s < S; ++s) {
    v[s] = 0.f;
    uc[s] = 0.f;
    p[s] = 0;
    way[s] = 0;
    // the slot's cost column, kept in range for column 0 and past Q (never used)
    coff[s] = min(max(lane + 32 * s - 1, 0), Q - 1) * ts;
    if (lane + 32 * s <= Q) exists |= 1u << s;
  }

  for (int r = 1; r <= T; ++r) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      minv[s] = CUDART_INF_F;
      way[s] = 0;
    }
    unsigned used = lane == 0 ? 1u : 0u;              // column 0 holds row r
    if (lane == 0) {
      p[0] = r;
      uc[0] = 0.f;
    }
    int j0 = 0, i0 = r;
    float ui0 = 0.f;
    while (true) {
      // every slot computed, selects in place of branches; the lane's own
      // minimum over its free columns (ties to the lower slot) carries that
      // column's p and u, so the winner's need no second lookup
      const float* crow = cs + (i0 - 1);
      const unsigned avail = exists & ~used;
      float best = CUDART_INF_F, bu = 0.f;
      int bs = 0, bp = 0;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const bool f = avail >> s & 1u;
        const float cur = crow[coff[s]] - ui0 - v[s];
        const bool lower = f && cur < minv[s];
        minv[s] = lower ? cur : minv[s];
        way[s] = lower ? j0 : way[s];
        const float cand = f ? minv[s] : CUDART_INF_F;
        const bool take = s == 0 || cand < best;
        best = take ? cand : best;
        bs = take ? s : bs;
        bp = take ? p[s] : bp;
        bu = take ? uc[s] : bu;
      }
      const unsigned key = order_key(best);
      const unsigned wkey = __reduce_min_sync(kFull, key);
      const unsigned mine = key == wkey ? static_cast<unsigned>(lane + 32 * bs) : kFull;
      const int j1 = static_cast<int>(__reduce_min_sync(kFull, mine));
      const int l1 = j1 & 31;
      const int pj = __shfl_sync(kFull, bp, l1);
      const float uj = __shfl_sync(kFull, bu, l1);
      const float delta = key_value(wkey);
      const unsigned tree = used & exists;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const bool t = tree >> s & 1u, f = avail >> s & 1u;
        uc[s] = t ? uc[s] + delta : uc[s];
        v[s] = t ? v[s] - delta : v[s];
        minv[s] = f ? minv[s] - delta : minv[s];
      }
      if (lane == l1) used |= 1u << (j1 >> 5);
      j0 = j1;
      if (pj == 0) break;
      i0 = pj;
      ui0 = uj;
    }

    // augment: mark the path from the free column j0 back to column 0, then
    // every path column takes p and u of its way column (old values, as in
    // the plain version's backward walk)
    unsigned path = 0;
    for (int j = j0; j != 0;) {
      const int sj = j >> 5, lj = j & 31;
      if (lane == lj) path |= 1u << sj;
      j = __shfl_sync(kFull, pick(way, sj), lj);
    }
    int np[S];
    float nu[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int w = way[s], ws = w >> 5, wl = w & 31;
      np[s] = 0;
      nu[s] = 0.f;
#pragma unroll
      for (int k = 0; k < S; ++k) {
        const int tp = __shfl_sync(kFull, p[k], wl);
        const float tu = __shfl_sync(kFull, uc[k], wl);
        if (ws == k) {
          np[s] = tp;
          nu[s] = tu;
        }
      }
    }
#pragma unroll
    for (int s = 0; s < S; ++s) {
      if (path >> s & 1u) {
        p[s] = np[s];
        uc[s] = nu[s];
      }
    }
  }

  int* o = out + (size_t)blockIdx.x * T;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int j = lane + 32 * s;
    if (j >= 1 && j <= Q && p[s] > 0) o[p[s] - 1] = j - 1;
  }
}

template <int S>
int launch_warp(const float* cost, int* out, int b, int q, int t, cudaStream_t stream) {
  const int ts = t | 1;
  const size_t smem = (size_t)q * ts * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        lapjv_warp_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  lapjv_warp_kernel<S><<<b, 32, smem, stream>>>(cost, out, q, t, ts);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// cost (b, q, t) f32, the matcher's layout, t <= q; route 0 = warp, 1 = block
// -> out (b, t) i32: the query matched to each target.
extern "C" int aff_lapjv(const float* cost, int* out, int b, int q, int t, int route,
                         void* stream_ptr) {
  if (b < 1 || t < 1 || t > q) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (route == 0) {
    if ((size_t)q * (t | 1) * sizeof(float) > kMaxSmem)
      return static_cast<int>(cudaErrorInvalidValue);
    switch ((q + 1 + 31) / 32) {
      case 1: return launch_warp<1>(cost, out, b, q, t, stream);
      case 2: return launch_warp<2>(cost, out, b, q, t, stream);
      case 3: return launch_warp<3>(cost, out, b, q, t, stream);
      case 4: return launch_warp<4>(cost, out, b, q, t, stream);
      case 5: return launch_warp<5>(cost, out, b, q, t, stream);
      case 6: return launch_warp<6>(cost, out, b, q, t, stream);
      case 7: return launch_warp<7>(cost, out, b, q, t, stream);
      case 8: return launch_warp<kMaxSlots>(cost, out, b, q, t, stream);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const size_t smem = (size_t)(t + 1) * sizeof(float) + (size_t)(q + 1) * 2 * sizeof(float) +
                      (size_t)(q + 1) * 3 * sizeof(int);
  if (route != 1 || smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  lapjv_block_kernel<<<b, kThreads, smem, stream>>>(cost, out, q, t);
  return static_cast<int>(cudaGetLastError());
}

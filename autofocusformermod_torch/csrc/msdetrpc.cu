// Deformable point sampling (msdetrpc), forward and backward, in every
// operand layout the pixel decoder builds.  One forward body and one backward
// pair serve the stacked, per-level, pair-major, head-natural and interleaved
// layouts.
//
// Replaces autofocusformermod_tpu/ops/pallas/msdetrpc_kernel.py:
//   msdetrpc_pallas_levels_s (:2061, forward _run_fwd_v14 / _kernel_v14) and
//   msdetrpc_pallas_levels_s_bwd_impl (:2078, _bwd_levels_impl ->
//   _run_bwd_kernel): idx and w (bh, n, L*P), the levels stacked on the pair
//   axis;
//   msdetrpc_pallas_levels   (:1841, _kernel_v13): one (bh, n, P) idx and w
//                            array per level;
//   msdetrpc_pallas_levels_t (:1912): per level (bh, P, n), queries minor;
//   msdetrpc_pallas_bh       (:2359, _kernel_v12 / _bwd_kernel_v12): per level
//                            (b, n, h, P), values (b, ntot, h, c), result
//                            (b, n, h, c), heads where the Linear put them;
//   msdetrpc_pallas          (:1204, forward :1090 with _regroup :1072, VJP
//                            :1355): interleaved nn_idx, nn_weight (bh, n, M,
//                            K) with GLOBAL indices and attn (bh, n, M).
// All compute
//   out[r, q, :] = sum_{j < L} sum_{p < P} w_j[r, q, p] * val[r, off_j + idx_j[r, q, p], :]
// with level-local indices idx, level offsets off_j = sum of the earlier
// level sizes, and w the 4-NN Shepard weight times the attention weight.
// Indices are clamped into their level, as the XLA gather's mode="clip".  The
// interleaved layout is the stacked one with one level of P = M * K pairs
// over the whole table (offset 0, size ntot: the global indices clamped into
// it), its attention a second weight: pair p of a query weighs
// nn_weight[p] * attn[p / K], the product taken before the row sum as the
// plain version and the JAX function fold it (the TPU wrapper folds it in
// XLA and regroups the slots by level before its kernel).  On
// the TPU each layout is its own kernel because a relayout of the minor axes
// costs a pass over the operand; here the kernels read every layout in place
// through a PairLayout: per-level pointers and batch / head / query / pair
// strides.  A "unit" r (grid.y) is an image-head, or for the head-natural
// layout image r / h and head r % h, whose value rows lie h * c floats apart;
// the stacked layout is the per-level one with level pointers j * P apart.
//
// What bounds it on the H100: the value-row reads.  Each query reads L*P (48)
// rows of c_ (32) floats = 6 KB at ~2 flops per 8-byte pair; rows of one
// level are shared by nearby queries (queries come in curve order and sample
// cells around their own position), so most reads are served by L1 and L2,
// and what bounds the kernel is how many row reads it keeps in flight.
//
// Forward design: one block per (unit, tile of 8 queries), one warp per query.
// The lanes load the query's L*P (idx, w) pairs in coalesced passes of 32,
// every pass's before the first row read, each lane clamping its pair into
// its level and adding the level's offset (levels chosen by compile-time
// comparisons, so the layout and level tables stay in the constant bank);
// __shfl_sync then hands each pair to the lanes that read its row.  Where
// queries are minor (pair-major), the block's 256 threads load the pairs of
// its 8 queries along the query axis into shared memory instead, and each
// warp reads its query's from there.  Rows are read as the local_attn
// kernels read theirs (local_attn_common.cuh load_unit): LPR = c_ / 4 lanes
// per row, 16 bytes per lane, 32 / LPR rows per load instruction (4 at c_ =
// 32), up to 8 load instructions in flight before their sums (at c_ = 32 all
// 32 rows of a pass).  Each lane group sums its rows in fp32 registers, the
// groups combine by shuffles at the end, and one group writes the output row
// with 16-byte stores.  L and P are compiled for the path's (3, 16) and, with
// the attention, the interleaved layout's (1, 48) (12 slots of 4 taps: two
// passes), with a generic instance for other shapes; the lane that loads a
// pair multiplies its attention in.  The kernel is held to 40 registers (6
// blocks an SM): the rows in flight are worth less than the warps.  The
// output keeps the unit's row layout (the TPU kernel's channel-major output
// and its 128-row band windows exist for its tiling).
//
// Backward, for g = d out:
//   d_w[r, q, jp] = <g[r, q, :], val[r, row(jp), :]>
//   d_val[r, row, :] = sum over the (q, jp) with row(jp) = row of w[r, q, jp] * g[r, q, :]
// Many queries sample the same value row (at n = 4096 each of level 0's 256
// rows ~256 times per image-head), so d_val is a reduction by row.  The TPU
// kernel accumulates it with one-hot matmuls into VMEM-resident band windows
// (_bwd_kernel_v4).  Here, with no float atomic and no zero-fill, two
// kernels:
//   1. msdetrpc_bwd_tile_kernel: a block per (unit, tile of T consecutive
//      queries; T * L*P <= 1536 entries, T = 32 at 3 x 16 pairs; for the
//      head-natural layout T consecutive spatial queries of one head, whose
//      rows repeat).  Each thread loads the (idx, w) of its 6 consecutive
//      entries through the layout (the blocked arrangement the block sort
//      takes; L1 serves its neighbours' words, also where queries are
//      minor).  A warp per query computes d_w with the g row in registers
//      and its value rows read coalesced (LPR lanes per row, 16 bytes per
//      lane, several pairs in flight, a lane-group shuffle sum per pair) into
//      shared memory, and the block writes each d_w at its weight's own
//      address along the operand's minor axis, so d_w has its operand's
//      layout.  The block sorts its (row, entry) pairs
//      by row (a stable block radix sort, so equal rows keep the entry order)
//      and sums each run of one row in that order: one partial row per
//      distinct row, stored with its row in the tile's part of a scratch
//      pool.  Queries come in curve order, so a tile's rows at a level are
//      few and close.
//   2. msdetrpc_bwd_band_kernel: a warp per (unit, band of 32 value rows)
//      walks the tiles in order and adds the partial rows of those with rows
//      in the band (pass 1 leaves, per tile, where each band starts in its
//      sorted list); every d_val row is written once.
// With the interleaved layout's attention, the folded weight w = nn_weight *
// attn enters the d_val sums, and the d_w write-out turns each staged
//   dot[s, t] = <g[r, q, :], val[r, row(s, t), :]>
// into d_nn_weight[s, t] = attn[s] * dot[s, t] and d_attn[s] = sum_t
// nn_weight[s, t] * dot[s, t], summed over t in order.  One level of ntot
// rows: a tile holds 32 queries of 48 pairs, at most min(1536, ntot) distinct
// rows; at AFF-Mini-1/5's batch-8 shapes (bh 64, levels 3276 + 655 + 131 =
// 4062 rows, c_ 32) the scratch of the 3276-query call is 103 tiles a unit:
// 1.30 GB of partial rows, 40.5 MB of row ids and 3.4 MB of band starts
// (0.26 GB and 0.06 GB of partial rows for the other two levels), allocated
// by the wrapper and written only as far as each tile needs.
// The order of every sum is fixed, so two calls give the same bits.  What
// bounds it: the value-row reads of d_w (as the forward), the block sort, and
// the band pass, which visits every (band, tile) of a unit.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include <cub/block/block_radix_sort.cuh>
#include <cub/block/block_scan.cuh>

#include "local_attn_common.cuh"

namespace {

constexpr int kMaxLevels = 8;
constexpr int kQueriesPerBlock = 8;
constexpr int kMaxC = 64;             // channels of the forward and backward

struct Levels {
  int count;
  int off[kMaxLevels];
  int size[kMaxLevels];
};

// Where a unit's pairs lie: pair p of level j of query q of unit r is at
//   idx[j] + (r / heads) * batch_stride + (r % heads) * head_stride
//          + q * query_stride + p * pair_stride
// and at the same offset in w[j] and (the backward's d_w) dw[j].  The value
// table, g and out of unit r are (R / heads, rows, heads, C) arrays.  The
// interleaved layout (one level, one head, pair stride 1) adds the attention:
// attn (R, N, LP / attn_k), one weight per attn_k consecutive pairs, and the
// backward's d_attn of the same shape.
struct PairLayout {
  const int* idx[kMaxLevels];
  const float* w[kMaxLevels];
  float* dw[kMaxLevels];  // backward only
  long long batch_stride, head_stride, query_stride, pair_stride;
  int heads;
  const float* attn;      // null: no attention
  float* dattn;           // backward only
  int attn_k;
};

// Row t of unit r in a (R / heads, rows, heads, C) array.
__device__ __forceinline__ size_t unit_row(int r, int t, int rows, int heads, int C) {
  return (((size_t)(r / heads) * rows + t) * heads + r % heads) * C;
}

// Offset of unit r's query 0 in every level's pair arrays.
__device__ __forceinline__ size_t unit_pairs(const PairLayout& lay, int r) {
  return (size_t)(r / lay.heads) * lay.batch_stride + (size_t)(r % lay.heads) * lay.head_stride;
}

// The global row and weight of pair s of the query whose pairs start at `at`:
// its level is chosen by compile-time comparisons (L_CT levels, else up to
// kMaxLevels), so that the layout's pointers and the level table are read at
// fixed offsets (an index known only at run time would copy both structs to
// local memory).
template <int L_CT>
__device__ __forceinline__ void load_pair(const PairLayout& lay, const Levels& lv, int L, int P,
                                          int s, size_t at, long long pair_stride, int& row,
                                          float& wt) {
  const int* ip = lay.idx[0];
  const float* wp = lay.w[0];
  int off = lv.off[0], last = lv.size[0] - 1, p = s;
#pragma unroll
  for (int j = 1; j < (L_CT ? L_CT : kMaxLevels); ++j) {
    if (j < L && s >= j * P) {
      ip = lay.idx[j];
      wp = lay.w[j];
      off = lv.off[j];
      last = lv.size[j] - 1;
      p = s - j * P;
    }
  }
  const size_t a = at + (size_t)p * pair_stride;
  row = off + min(max(ip[a], 0), last);
  wt = wp[a];
}

// The level of pair s of a query's L levels of P pairs (no division).
__device__ __forceinline__ int level_of(int s, int P, int L) {
  int j = 0;
  for (int l = 1; l < L; ++l) j += s >= l * P;
  return j;
}

// The row reads of the local_attn kernels: LPR lanes per row, VEC floats per
// lane, a lane-group shuffle sum.
using local_attn::across_groups_sum;
using local_attn::group_sum;
using local_attn::load_unit;
using local_attn::store_unit;

inline bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

// The forward.  VEC floats per lane and LPR lanes per value row, UNITS units
// of VEC channels per lane (c_ <= UNITS * LPR * VEC); L_CT levels of P_CT
// pairs compiled in, or 0 for the run-time L and P; kQueriesMinor: the pairs
// are staged through shared memory along the query axis; kAttn: each pair's
// weight times its slot's attention (the interleaved layout).
template <int VEC, int LPR, int UNITS, int L_CT, int P_CT, bool kQueriesMinor, bool kAttn>
__global__ void __launch_bounds__(32 * kQueriesPerBlock, 6)
msdetrpc_kernel(PairLayout lay, const float* __restrict__ val, float* __restrict__ out, int N,
                int NTOT, int C, int L_rt, int P_rt, Levels lv) {
  static_assert(!(kAttn && kQueriesMinor), "the attention comes with query-major pairs");
  constexpr int Q = kQueriesPerBlock;
  constexpr int RPI = 32 / LPR;   // rows per load instruction
  constexpr int STEPS = LPR;      // load instructions per pass of 32 pairs
  constexpr int G = STEPS < 8 ? STEPS : 8;                      // ... in flight at once
  constexpr int PASSES = L_CT ? (L_CT * P_CT + 31) / 32 : 1;    // passes of 32 pairs a round
  // a round's pairs of the block's queries, where queries are minor
  __shared__ int s_row[kQueriesMinor ? PASSES : 1][kQueriesMinor ? Q : 1][33];
  __shared__ float s_wt[kQueriesMinor ? PASSES : 1][kQueriesMinor ? Q : 1][33];
  const int L = L_CT ? L_CT : L_rt;
  const int P = P_CT ? P_CT : P_rt;
  const int LP = L * P;
  const int r = blockIdx.y;
  const int q0 = blockIdx.x * Q;
  const int qi = q0 + threadIdx.y;
  const bool live = qi < N;
  if (!kQueriesMinor && !live) return;   // the whole warp leaves together
  // & 31: the compiler then knows a pass's 32 pairs span at most two levels
  const int lane = threadIdx.x & 31, lig = lane % LPR, rl = lane / LPR;
  const size_t pairs0 = unit_pairs(lay, r);
  const float* vr = val + unit_row(r, 0, NTOT, lay.heads, C);
  const int vstride = lay.heads * C;
  float acc[UNITS][VEC];
#pragma unroll
  for (int u = 0; u < UNITS; ++u)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[u][e] = 0.f;

  // rounds of PASSES passes of 32 pairs (one round on the compiled path):
  // every pass's pairs are loaded before the round's row reads, so that what
  // stays live during them is one (row, weight) a pass
  for (int s0 = 0; s0 < LP; s0 += 32 * PASSES) {
    // this lane's pair of each pass: its global row and weight
    int row[PASSES];
    float wt[PASSES];
    if constexpr (kQueriesMinor) {
      // thread t loads pair t / Q of each pass of query q0 + t % Q: the Q
      // queries' words of one pair are consecutive
      const int t = threadIdx.y * 32 + lane, q = q0 + t % Q;
      __syncthreads();                     // the last round's pairs are read
#pragma unroll
      for (int x = 0; x < PASSES; ++x) {
        const int s = s0 + x * 32 + t / Q;
        if (s < LP && q < N)
          load_pair<L_CT>(lay, lv, L, P, s, pairs0 + (size_t)q * lay.query_stride,
                          lay.pair_stride, s_row[x][t % Q][t / Q], s_wt[x][t % Q][t / Q]);
      }
      __syncthreads();
#pragma unroll
      for (int x = 0; x < PASSES; ++x) {
        const bool in = live && s0 + x * 32 + lane < LP;
        row[x] = in ? s_row[x][threadIdx.y][lane] : 0;
        wt[x] = in ? s_wt[x][threadIdx.y][lane] : 0.f;
      }
    } else {
#pragma unroll
      for (int x = 0; x < PASSES; ++x) {
        const int s = s0 + x * 32 + lane;
        row[x] = 0;
        wt[x] = 0.f;
        if (s < LP) {
          load_pair<L_CT>(lay, lv, L, P, s, pairs0 + (size_t)qi * lay.query_stride, 1, row[x],
                          wt[x]);
          if constexpr (kAttn)
            wt[x] *= lay.attn[((size_t)r * N + qi) * (LP / lay.attn_k) + s / lay.attn_k];
        }
      }
    }
    // each pass's rows, G load instructions in flight before their sums
#pragma unroll
    for (int x = 0; x < PASSES; ++x) {
      const int p0 = s0 + x * 32;
#pragma unroll
      for (int y0 = 0; y0 < STEPS; y0 += G) {
        float v[G][UNITS][VEC];
        float ws[G];
#pragma unroll
        for (int k = 0; k < G; ++k) {
          const int y = y0 + k, sl = y * RPI + rl;
          const int rrow = __shfl_sync(0xffffffffu, row[x], sl);
          ws[k] = __shfl_sync(0xffffffffu, wt[x], sl);
          const float* vrow = vr + (size_t)rrow * vstride;
#pragma unroll
          for (int u = 0; u < UNITS; ++u) {
            const int ch = (lig + u * LPR) * VEC;
            if (p0 + y * RPI < LP && p0 + sl < LP && ch < C) {
              load_unit<VEC>(vrow + ch, v[k][u]);
            } else {
#pragma unroll
              for (int e = 0; e < VEC; ++e) v[k][u][e] = 0.f;
            }
          }
        }
#pragma unroll
        for (int k = 0; k < G; ++k)
#pragma unroll
          for (int u = 0; u < UNITS; ++u)
#pragma unroll
            for (int e = 0; e < VEC; ++e) acc[u][e] += ws[k] * v[k][u][e];
      }
    }
  }
  if (!live) return;                       // past the last __syncthreads
  // the lane groups' sums to every group; the first group writes
  float* orow = out + unit_row(r, qi, N, lay.heads, C);
#pragma unroll
  for (int u = 0; u < UNITS; ++u) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[u][e] = across_groups_sum<LPR>(acc[u][e]);
    const int ch = (lig + u * LPR) * VEC;
    if (rl == 0 && ch < C) store_unit<VEC>(orow + ch, acc[u]);
  }
}

// The backward.  Pass 1, per (unit, tile of T queries).
constexpr int kBwdThreads = 256;
constexpr int kBwdItems = 6;                          // sort keys per thread
constexpr int kBwdCap = kBwdThreads * kBwdItems;      // (query, pair) entries per tile
constexpr int kBwdMaxQueries = 32;
constexpr int kEntBits = 11, kEntMask = (1 << kEntBits) - 1;
static_assert(kBwdCap <= 1 << kEntBits, "an entry id must fit its bits of the sort value");
constexpr int kBand = 32;                             // value rows per warp of pass 2
constexpr int kBandWarps = 4;

int bwd_tile_queries(int lp) { return lp > kBwdCap ? 0 : std::min(kBwdMaxQueries, kBwdCap / lp); }

// Distinct rows a tile can leave: at most its entries, and per level at most
// the level's rows.
int bwd_pool_rows(int tile, int pairs, const Levels& lv) {
  int rows = 0;
  for (int j = 0; j < lv.count; ++j) rows += std::min(tile * pairs, lv.size[j]);
  return rows;
}

// VEC floats per lane and LPR lanes per value row for d_w, as the local_attn
// kernels read their rows (UNITS units of VEC channels per lane); kAttn: the
// interleaved layout's attention (one level, pair stride 1).
template <int VEC, int LPR, int UNITS, bool kAttn>
__global__ void __launch_bounds__(kBwdThreads, 5)
msdetrpc_bwd_tile_kernel(PairLayout lay, const float* __restrict__ val,
                         const float* __restrict__ g, int* __restrict__ pool_row,
                         float* __restrict__ pool_val, int* __restrict__ band_start, int N,
                         int NTOT, int C, int P, int T, int key_bits, int cap, Levels lv) {
  using Sort = cub::BlockRadixSort<unsigned, kBwdThreads, kBwdItems, int>;
  using Scan = cub::BlockScan<int, kBwdThreads>;
  constexpr int RPI = 32 / LPR;   // rows per load instruction
  constexpr int kStep = 6;        // row groups in flight
  __shared__ union {
    typename Sort::TempStorage sort;
    typename Scan::TempStorage scan;
    int start[kBwdCap + 1];       // first sorted place of each run, after the scan
  } tmp;
  __shared__ int s_row[kBwdCap];  // entry order, then sorted
  __shared__ union {
    float dw[kBwdCap];            // d_w in entry order
    int ent[kBwdCap];             // then, sorted: the entries, with their queries
  } s_x;
  __shared__ float s_w[kBwdCap];
  __shared__ __align__(16) float s_g[kBwdMaxQueries * kMaxC];
  __shared__ int s_off[kMaxLevels], s_size[kMaxLevels];
  __shared__ const int* s_ip[kMaxLevels];
  __shared__ const float* s_wp[kMaxLevels];
  __shared__ float* s_dwp[kMaxLevels];

  const int r = blockIdx.y;
  const int tile = blockIdx.x;
  const int q0 = tile * T;
  const int nq = min(T, N - q0);
  const int LP = lv.count * P;
  const int ne = nq * LP;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const size_t pairs0 = unit_pairs(lay, r) + (size_t)q0 * lay.query_stride;
  const long long qs = lay.query_stride, ps = lay.pair_stride;
  const float* vr = val + unit_row(r, 0, NTOT, lay.heads, C);
  const int vstride = lay.heads * C;

  // the level and layout tables to shared memory, read at fixed offsets (an
  // index known only at run time would copy the structs to local memory)
#pragma unroll
  for (int l = 0; l < kMaxLevels; ++l) {
    if (tid == l) {
      s_off[l] = lv.off[l];
      s_size[l] = lv.size[l];
      s_ip[l] = lay.idx[l];
      s_wp[l] = lay.w[l];
      s_dwp[l] = lay.dw[l];
    }
  }
  __syncthreads();
  // thread tid takes entries e = tid * kBwdItems + x (the blocked
  // arrangement the sort wants), walking (query q, pair s = j * P + pj) from
  // one division: its row and weight to s_row and s_w, and the sort's key and
  // value, which carries the entry and its query: q << kEntBits | e.  Past
  // the entries: the key NTOT.
  unsigned keys[kBwdItems];
  int ents[kBwdItems];
  {
    const int e0 = tid * kBwdItems;
    int q = e0 / LP, s = e0 - q * LP;
    int j = s / P, pj = s - j * P;
#pragma unroll
    for (int x = 0; x < kBwdItems; ++x) {
      const int e = e0 + x;
      keys[x] = NTOT;
      if (e < ne) {
        const size_t at = pairs0 + (size_t)q * qs + (size_t)pj * ps;
        const int row = s_off[j] + min(max(s_ip[j][at], 0), s_size[j] - 1);
        float wt = s_wp[j][at];
        if constexpr (kAttn)
          wt *= lay.attn[((size_t)r * N + q0 + q) * (LP / lay.attn_k) + pj / lay.attn_k];
        s_row[e] = row;
        s_w[e] = wt;
        keys[x] = row;
      }
      ents[x] = q << kEntBits | e;
      if (++pj == P) {
        pj = 0;
        ++j;
      }
      if (++s == LP) {
        s = j = 0;
        ++q;
      }
    }
  }
  {
    const float* g0 = g + unit_row(r, q0, N, lay.heads, C);
    for (int q = warp; q < nq; q += kBwdThreads / 32)
      for (int c = lane; c < C; c += 32) s_g[q * C + c] = g0[(size_t)q * vstride + c];
  }
  __syncthreads();

  // d_w: a warp per query, the g row in registers, kStep row groups in flight
  const int lig = lane % LPR, rl = lane / LPR;
  for (int ql = warp; ql < nq; ql += kBwdThreads / 32) {
    float gv[UNITS][VEC];
#pragma unroll
    for (int u = 0; u < UNITS; ++u) {
      const int ch = (lig + u * LPR) * VEC;
#pragma unroll
      for (int e = 0; e < VEC; ++e) gv[u][e] = ch + e < C ? s_g[ql * C + ch + e] : 0.f;
    }
    for (int s0 = 0; s0 < LP; s0 += kStep * RPI) {
      float dot[kStep];
#pragma unroll
      for (int y = 0; y < kStep; ++y) {
        const int s = s0 + y * RPI + rl;
        dot[y] = 0.f;
        if (s < LP) {
          const float* vrow = vr + (size_t)s_row[ql * LP + s] * vstride;
#pragma unroll
          for (int u = 0; u < UNITS; ++u) {
            const int ch = (lig + u * LPR) * VEC;
            if (ch < C) {
              float x[VEC];
              load_unit<VEC>(vrow + ch, x);
#pragma unroll
              for (int e = 0; e < VEC; ++e) dot[y] += gv[u][e] * x[e];
            }
          }
        }
      }
#pragma unroll
      for (int y = 0; y < kStep; ++y) {
        const int s = s0 + y * RPI + rl;
        dot[y] = group_sum<LPR>(dot[y]);
        if (lig == 0 && s < LP) s_x.dw[ql * LP + s] = dot[y];
      }
    }
  }
  __syncthreads();
  // each d_w at its weight's address, along the operand's minor axis: a
  // warp per query and lanes over its pairs, or (queries minor) a warp per
  // pair and lanes over the queries; with the attention, d_nn_weight and then
  // d_attn, a lane per slot summing its K taps in order
  if constexpr (kAttn) {
    const int K = lay.attn_k, M = LP / K;
    for (int ql = warp; ql < nq; ql += kBwdThreads / 32) {
      const size_t qa = ((size_t)r * N + q0 + ql) * M, at = pairs0 + (size_t)ql * qs;
      const float* dot = s_x.dw + ql * LP;
      for (int s = lane; s < LP; s += 32) s_dwp[0][at + s] = lay.attn[qa + s / K] * dot[s];
      for (int m = lane; m < M; m += 32) {
        float da = 0.f;
        for (int t = m * K; t < (m + 1) * K; ++t) da += s_wp[0][at + t] * dot[t];
        lay.dattn[qa + m] = da;
      }
    }
  } else if (ps == 1) {
    for (int ql = warp; ql < nq; ql += kBwdThreads / 32)
      for (int s = lane; s < LP; s += 32) {
        const int j = level_of(s, P, lv.count);
        s_dwp[j][pairs0 + (size_t)ql * qs + s - j * P] = s_x.dw[ql * LP + s];
      }
  } else {
    for (int s = warp; s < LP; s += kBwdThreads / 32) {
      const int j = level_of(s, P, lv.count);
      for (int q = lane; q < nq; q += 32)
        s_dwp[j][pairs0 + (size_t)q * qs + (size_t)(s - j * P) * ps] = s_x.dw[q * LP + s];
    }
  }

  // sort the entries by row; entry e sits at place e, so the sort's
  // stability keeps equal rows in entry order
  __syncthreads();              // every thread is done with s_row and s_x.dw in entry order
  Sort(tmp.sort).Sort(keys, ents, 0, key_bits);
#pragma unroll
  for (int x = 0; x < kBwdItems; ++x) {
    s_row[tid * kBwdItems + x] = keys[x];
    s_x.ent[tid * kBwdItems + x] = ents[x];
  }
  __syncthreads();

  // runs of one row: a run starts where the row changes
  int heads = 0;
#pragma unroll
  for (int x = 0; x < kBwdItems; ++x) {
    const int e = tid * kBwdItems + x;
    heads += e < ne && (e == 0 || s_row[e - 1] != s_row[e]);
  }
  int first, runs;
  Scan(tmp.scan).ExclusiveSum(heads, first, runs);
  __syncthreads();              // the scan's storage becomes tmp.start
#pragma unroll
  for (int x = 0; x < kBwdItems; ++x) {
    const int e = tid * kBwdItems + x;
    if (e < ne && (e == 0 || s_row[e] != s_row[e - 1])) tmp.start[first++] = e;
  }
  if (tid == 0) tmp.start[runs] = ne;
  __syncthreads();

  // where each band of kBand value rows starts in the tile's list of
  // distinct rows (band-major, so that pass 2 reads 32 tiles at once): band
  // k starts at the first run whose row lies in band k or later
  const int tiles = gridDim.x, bands = (NTOT + kBand - 1) / kBand;
  int* bs = band_start + (size_t)r * (bands + 1) * tiles + tile;
  for (int run = tid; run < runs; run += kBwdThreads) {
    const int band = s_row[tmp.start[run]] / kBand;
    const int prev = run == 0 ? -1 : s_row[tmp.start[run - 1]] / kBand;
    for (int k = prev + 1; k <= band; ++k) bs[(size_t)k * tiles] = run;
  }
  const int last = runs == 0 ? -1 : s_row[tmp.start[runs - 1]] / kBand;
  for (int k = last + 1 + tid; k <= bands; k += kBwdThreads) bs[(size_t)k * tiles] = runs;

  // one partial row per run, summed in entry order; a group of LPR lanes per
  // run (32 / LPR runs per warp at once), channels as in d_w
  const size_t tile_lin = (size_t)r * tiles + tile;
  int* prow = pool_row + tile_lin * cap;
  float* pval = pool_val + tile_lin * cap * C;
  for (int run = warp * RPI + rl; run < runs; run += kBwdThreads / 32 * RPI) {
    const int beg = tmp.start[run], end = tmp.start[run + 1];
    float acc[UNITS][VEC];
#pragma unroll
    for (int u = 0; u < UNITS; ++u)
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[u][e] = 0.f;
    for (int x = beg; x < end; ++x) {
      const int ent = s_x.ent[x];
      const float wt = s_w[ent & kEntMask];
      const float* gq = s_g + (ent >> kEntBits) * C;
#pragma unroll
      for (int u = 0; u < UNITS; ++u) {
        const int ch = (lig + u * LPR) * VEC;
        if (ch < C) {
          float gx[VEC];
          load_unit<VEC>(gq + ch, gx);
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[u][e] += wt * gx[e];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < UNITS; ++u) {
      const int ch = (lig + u * LPR) * VEC;
      if (ch < C) store_unit<VEC>(pval + (size_t)run * C + ch, acc[u]);
    }
    if (lig == 0) prow[run] = s_row[beg];
  }
}

// Pass 2: a warp per (unit, band of kBand value rows), kBandWarps bands a
// block.  The warp walks the tiles in order, 32 at a time (one per lane), and
// adds the partial rows of those with rows in the band into the band's rows
// in shared memory, lanes over channels; every d_val row is written once, in
// the unit's row layout (heads: the head-natural layout's h).
__global__ void __launch_bounds__(kBandWarps * 32)
msdetrpc_bwd_band_kernel(const int* __restrict__ pool_row, const float* __restrict__ pool_val,
                         const int* __restrict__ band_start, float* __restrict__ dval,
                         int tiles, int NTOT, int C, int cap, int heads) {
  __shared__ float s_acc[kBandWarps][kBand][kMaxC];
  __shared__ int s_xr[kBandWarps][kBand];       // the band rows of the tile at hand
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = blockIdx.y;
  const int bands = (NTOT + kBand - 1) / kBand;
  const int band = blockIdx.x * kBandWarps + warp;
  if (band >= bands) return;                    // the whole warp leaves together
  const int x0 = band * kBand;
  float (*acc)[kMaxC] = s_acc[warp];
  for (int x = 0; x < kBand; ++x)
    for (int c = lane; c < C; c += 32) acc[x][c] = 0.f;

  const int* bs = band_start + ((size_t)r * (bands + 1) + band) * tiles;
  for (int b0 = 0; b0 < tiles; b0 += 32) {
    // the tiles with rows in the band: [begin, end) of their lists
    const int t = b0 + lane;
    const int begin = t < tiles ? bs[t] : 0;
    const int end = t < tiles ? bs[tiles + t] : 0;
    for (unsigned mask = __ballot_sync(0xffffffffu, end > begin); mask; mask &= mask - 1) {
      const int y0 = __ffs(mask) - 1;
      const int tb = __shfl_sync(0xffffffffu, begin, y0);
      const int m = __shfl_sync(0xffffffffu, end, y0) - tb;    // distinct rows: m <= kBand
      const size_t at = ((size_t)r * tiles + b0 + y0) * cap + tb;
      if (lane < m) s_xr[warp][lane] = pool_row[at + lane] - x0;
      __syncwarp();
      const float* part = pool_val + at * C;
      for (int c = lane; c < C; c += 32) {
        float v[kBand];             // the tile's rows, all loads issued before the sums
#pragma unroll
        for (int y = 0; y < kBand; ++y) v[y] = y < m ? part[(size_t)y * C + c] : 0.f;
#pragma unroll
        for (int y = 0; y < kBand; ++y)
          if (y < m) acc[s_xr[warp][y]][c] += v[y];
      }
      __syncwarp();                 // s_xr is rewritten for the next tile
    }
  }
  float* d0 = dval + unit_row(r, x0, NTOT, heads, C);
  for (int x = 0; x < min(kBand, NTOT - x0); ++x)
    for (int c = lane; c < C; c += 32) d0[(size_t)x * heads * C + c] = acc[x][c];
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

// A layout over one (idx, w[, dw]) array per level; dws null in the forward.
bool level_arrays(const void* const* idxs, const void* const* ws, void* const* dws,
                  int n_levels, PairLayout* lay) {
  if (n_levels < 1 || n_levels > kMaxLevels) return false;
  for (int j = 0; j < n_levels; ++j) {
    lay->idx[j] = static_cast<const int*>(idxs[j]);
    lay->w[j] = static_cast<const float*>(ws[j]);
    lay->dw[j] = dws ? static_cast<float*>(dws[j]) : nullptr;
  }
  return true;
}

// The stacked layout: level j's pairs are columns [j * P, (j + 1) * P) of
// one (bh, n, L * P) array.
PairLayout stacked_layout(const int* idx, const float* w, float* dw, int n, int n_levels,
                          int pairs) {
  PairLayout lay{};
  for (int j = 0; j < n_levels && j < kMaxLevels; ++j) {
    lay.idx[j] = idx + j * pairs;
    lay.w[j] = w + j * pairs;
    lay.dw[j] = dw ? dw + j * pairs : nullptr;
  }
  lay.batch_stride = (long long)n * n_levels * pairs;
  lay.query_stride = (long long)n_levels * pairs;
  lay.pair_stride = 1;
  lay.heads = 1;
  return lay;
}

// The attention's layout: one level, one head, pairs along the query (the
// interleaved layout), whole slots of attn_k pairs.
bool attention_ok(const PairLayout& lay, int n_levels, int pairs) {
  return n_levels == 1 && lay.heads == 1 && lay.pair_stride == 1 && lay.attn_k >= 1 &&
         pairs % lay.attn_k == 0;
}

// Checks and launches the forward over `units` units of n queries.
int launch_forward(const PairLayout& lay, const float* val, float* out, int units, int n,
                   int ntot, int c, int n_levels, const int* level_sizes, int pairs,
                   void* stream_ptr) {
  Levels lv;
  if (pairs < 1 || c < 1 || c > kMaxC || n < 1 || units < 1 || units > 65535 ||
      lay.heads < 1 || !make_levels(n_levels, level_sizes, ntot, &lv))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(32, kQueriesPerBlock);
  const dim3 grid((n + kQueriesPerBlock - 1) / kQueriesPerBlock, units);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  // the path's 3 levels x 16 pairs compiled in (with the attention: 1 level
  // of 48 pairs), else the run-time count
  const bool attn = lay.attn != nullptr;
  const bool path = attn ? n_levels == 1 && pairs == 48 : n_levels == 3 && pairs == 16;
  const bool minor = lay.pair_stride != 1;
  if (attn && !attention_ok(lay, n_levels, pairs)) return static_cast<int>(cudaErrorInvalidValue);
#define FWD_ROUTE(VEC, LPR, UNITS, L, P, MINOR, ATTN)                                       \
  do {                                                                                      \
    if (path)                                                                               \
      msdetrpc_kernel<VEC, LPR, UNITS, L, P, MINOR, ATTN><<<grid, block, 0, stream>>>(      \
          lay, val, out, n, ntot, c, n_levels, pairs, lv);                                  \
    else                                                                                    \
      msdetrpc_kernel<VEC, LPR, UNITS, 0, 0, MINOR, ATTN><<<grid, block, 0, stream>>>(      \
          lay, val, out, n, ntot, c, n_levels, pairs, lv);                                  \
  } while (0)
#define FWD_LAUNCH(VEC, LPR, UNITS)                                                         \
  do {                                                                                      \
    if (attn) FWD_ROUTE(VEC, LPR, UNITS, 1, 48, false, true);                               \
    else if (minor) FWD_ROUTE(VEC, LPR, UNITS, 3, 16, true, false);                         \
    else FWD_ROUTE(VEC, LPR, UNITS, 3, 16, false, false);                                   \
  } while (0)
  // 16 bytes per lane where every value row and output row starts at a
  // multiple of 16 bytes
  const bool vec = c % 4 == 0 && aligned16(val) && aligned16(out);
  if (vec && c <= 16) FWD_LAUNCH(4, 4, 1);
  else if (vec && c <= 32) FWD_LAUNCH(4, 8, 1);
  else if (vec) FWD_LAUNCH(4, 16, 1);
  else FWD_LAUNCH(1, 32, 2);
#undef FWD_LAUNCH
#undef FWD_ROUTE
  return static_cast<int>(cudaGetLastError());
}

// Checks and launches the backward's two kernels over `units` units of n
// queries: d_val in val's layout, every d_w (lay.dw) in its w's layout; the
// scratch as aff_msdetrpc_bwd_scratch gives it per unit.
int launch_backward(const PairLayout& lay, const float* val, const float* g, float* dval,
                    int* pool_row, float* pool_val, int* band_start, int units, int n, int ntot,
                    int c, int n_levels, const int* level_sizes, int pairs, void* stream_ptr) {
  Levels lv;
  const int tile = pairs < 1 ? 0 : bwd_tile_queries(n_levels * pairs);
  if (tile < 1 || c < 1 || c > kMaxC || n < 1 || units < 1 || units > 65535 || lay.heads < 1 ||
      !make_levels(n_levels, level_sizes, ntot, &lv) ||
      (lay.attn && !attention_ok(lay, n_levels, pairs)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int tiles = (n + tile - 1) / tile;
  const int cap = bwd_pool_rows(tile, pairs, lv);
  const int key_bits = 32 - __builtin_clz((unsigned)ntot);   // rows and the past-end key ntot
  const dim3 grid(tiles, units);
#define TILE_ROUTE(VEC, LPR, UNITS, ATTN)                                                 \
  msdetrpc_bwd_tile_kernel<VEC, LPR, UNITS, ATTN><<<grid, kBwdThreads, 0, stream>>>(        \
      lay, val, g, pool_row, pool_val, band_start, n, ntot, c, pairs, tile, key_bits, cap, lv)
#define TILE_LAUNCH(VEC, LPR, UNITS)                                                       \
  do {                                                                                      \
    if (lay.attn) TILE_ROUTE(VEC, LPR, UNITS, true);                                        \
    else TILE_ROUTE(VEC, LPR, UNITS, false);                                                \
  } while (0)
  // 16 bytes per lane where every value row starts at a multiple of 16 bytes
  const bool vec = c % 4 == 0 && aligned16(val);
  if (vec && c <= 16) TILE_LAUNCH(4, 4, 1);
  else if (vec && c <= 32) TILE_LAUNCH(4, 8, 1);
  else if (vec) TILE_LAUNCH(4, 16, 1);
  else TILE_LAUNCH(1, 32, 2);
#undef TILE_LAUNCH
#undef TILE_ROUTE
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int bands = (ntot + kBand - 1) / kBand;
  msdetrpc_bwd_band_kernel<<<dim3((bands + kBandWarps - 1) / kBandWarps, units),
                             kBandWarps * 32, 0, stream>>>(pool_row, pool_val, band_start, dval,
                                                           tiles, ntot, c, cap, lay.heads);
  return static_cast<int>(cudaGetLastError());
}

// The per-level layouts' strides: (bh, n, P) per level, or queries minor
// (bh, P, n), or head-natural (b, n, h, P) with units b * h.
PairLayout per_level(int n, int pairs) {
  PairLayout lay{};
  lay.batch_stride = (long long)n * pairs;
  lay.query_stride = pairs;
  lay.pair_stride = 1;
  lay.heads = 1;
  return lay;
}

PairLayout pair_major(int n, int pairs) {
  PairLayout lay{};
  lay.batch_stride = (long long)pairs * n;
  lay.query_stride = 1;
  lay.pair_stride = n;
  lay.heads = 1;
  return lay;
}

PairLayout head_natural(int n, int heads, int pairs) {
  PairLayout lay{};
  lay.batch_stride = (long long)n * heads * pairs;
  lay.head_stride = pairs;
  lay.query_stride = (long long)heads * pairs;
  lay.pair_stride = 1;
  lay.heads = heads;
  return lay;
}

// The forward and backward of a layout over one (idx, w[, dw]) array per
// level.
int layout_forward(PairLayout lay, const void* const* idxs, const void* const* ws,
                   const float* val, float* out, int units, int n, int ntot, int c,
                   int n_levels, const int* level_sizes, int pairs, void* stream_ptr) {
  if (!level_arrays(idxs, ws, nullptr, n_levels, &lay))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_forward(lay, val, out, units, n, ntot, c, n_levels, level_sizes, pairs,
                        stream_ptr);
}

int layout_backward(PairLayout lay, const void* const* idxs, const void* const* ws,
                    void* const* dws, const float* val, const float* g, float* dval,
                    int* pool_row, float* pool_val, int* band_start, int units, int n, int ntot,
                    int c, int n_levels, const int* level_sizes, int pairs, void* stream_ptr) {
  if (!level_arrays(idxs, ws, dws, n_levels, &lay))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_backward(lay, val, g, dval, pool_row, pool_val, band_start, units, n, ntot, c,
                         n_levels, level_sizes, pairs, stream_ptr);
}

// The interleaved layout: one level of m * k pairs over the whole table, the
// attention each slot's second weight.
PairLayout interleaved_layout(const int* nn_idx, const float* nn_weight, float* d_nn_weight,
                              const float* attn, float* d_attn, int n, int m, int k) {
  PairLayout lay = stacked_layout(nn_idx, nn_weight, d_nn_weight, n, 1, m * k);
  lay.attn = attn;
  lay.dattn = d_attn;
  lay.attn_k = k;
  return lay;
}

}  // namespace

// idx (bh, n, L*P) i32 level-local; w (bh, n, L*P) f32; val (bh, ntot, c) f32
// -> out (bh, n, c) f32.  level_sizes: host array of L ints summing to ntot.
// c <= 64.
extern "C" int aff_msdetrpc(const int* idx, const float* w, const float* val,
                            float* out, int bh, int n, int ntot, int c,
                            int n_levels, const int* level_sizes, int pairs,
                            void* stream_ptr) {
  return launch_forward(stacked_layout(idx, w, nullptr, n, n_levels, pairs), val, out, bh, n,
                        ntot, c, n_levels, level_sizes, pairs, stream_ptr);
}

// The backward's scratch for units (image-heads) of n queries: ints[0] tiles
// per unit, ints[1] pool rows per tile, ints[2] band starts per tile.  The
// caller allocates pool_row (units * tiles * rows) int32, pool_val (units *
// tiles * rows, c) f32 and band_start (units * tiles * starts) int32.
extern "C" int aff_msdetrpc_bwd_scratch(int n, int n_levels, const int* level_sizes,
                                        int pairs, int* ints) {
  Levels lv;
  int ntot = 0;
  for (int j = 0; j < n_levels && j < kMaxLevels; ++j) ntot += level_sizes[j];
  const int tile = pairs < 1 ? 0 : bwd_tile_queries(n_levels * pairs);
  if (n < 1 || tile < 1 || !make_levels(n_levels, level_sizes, ntot, &lv))
    return static_cast<int>(cudaErrorInvalidValue);
  ints[0] = (n + tile - 1) / tile;
  ints[1] = bwd_pool_rows(tile, pairs, lv);
  ints[2] = (ntot + kBand - 1) / kBand + 1;
  return 0;
}

// The forward's operands plus g (bh, n, c) = d out -> dval (bh, ntot, c) and
// dw (bh, n, L*P), every element written; the scratch as
// aff_msdetrpc_bwd_scratch gives it.  c <= 64; L*P <= 1536.
extern "C" int aff_msdetrpc_bwd(const int* idx, const float* w, const float* val,
                                const float* g, float* dval, float* dw, int* pool_row,
                                float* pool_val, int* band_start, int bh, int n, int ntot, int c,
                                int n_levels, const int* level_sizes, int pairs,
                                void* stream_ptr) {
  return launch_backward(stacked_layout(idx, w, dw, n, n_levels, pairs), val, g, dval, pool_row,
                         pool_val, band_start, bh, n, ntot, c, n_levels, level_sizes, pairs,
                         stream_ptr);
}

// The per-level, pair-major and head-natural launchers.  idxs / ws / dws: host
// arrays of n_levels device pointers; level_sizes: host array of n_levels ints
// summing to ntot.  More than 8 levels, c > 64, or a grid the card refuses
// (more than 65535 units), is an error.  Each backward takes g = d out in
// out's layout and the scratch of aff_msdetrpc_bwd_scratch (units = bh, or b
// * h), and writes every element of dval in val's layout and of each dws[j]
// in its w's layout.
// Per level idx, w (bh, n, P); val (bh, ntot, c) -> out (bh, n, c).
extern "C" int aff_msdetrpc_levels(const void* const* idxs, const void* const* ws,
                                   const float* val, float* out, int bh, int n, int ntot,
                                   int c, int n_levels, const int* level_sizes, int pairs,
                                   void* stream_ptr) {
  return layout_forward(per_level(n, pairs), idxs, ws, val, out, bh, n, ntot, c, n_levels,
                        level_sizes, pairs, stream_ptr);
}

extern "C" int aff_msdetrpc_levels_bwd(const void* const* idxs, const void* const* ws,
                                       const float* val, const float* g, float* dval,
                                       int* pool_row, float* pool_val, int* band_start,
                                       void* const* dws, int bh, int n, int ntot, int c,
                                       int n_levels, const int* level_sizes, int pairs,
                                       void* stream_ptr) {
  return layout_backward(per_level(n, pairs), idxs, ws, dws, val, g, dval, pool_row, pool_val,
                         band_start, bh, n, ntot, c, n_levels, level_sizes, pairs, stream_ptr);
}

// Per level idx, w (bh, P, n), queries minor; val (bh, ntot, c) -> out (bh, n, c).
extern "C" int aff_msdetrpc_levels_t(const void* const* idxs, const void* const* ws,
                                     const float* val, float* out, int bh, int n, int ntot,
                                     int c, int n_levels, const int* level_sizes, int pairs,
                                     void* stream_ptr) {
  return layout_forward(pair_major(n, pairs), idxs, ws, val, out, bh, n, ntot, c, n_levels,
                        level_sizes, pairs, stream_ptr);
}

extern "C" int aff_msdetrpc_levels_t_bwd(const void* const* idxs, const void* const* ws,
                                         const float* val, const float* g, float* dval,
                                         int* pool_row, float* pool_val, int* band_start,
                                         void* const* dws, int bh, int n, int ntot, int c,
                                         int n_levels, const int* level_sizes, int pairs,
                                         void* stream_ptr) {
  return layout_backward(pair_major(n, pairs), idxs, ws, dws, val, g, dval, pool_row, pool_val,
                         band_start, bh, n, ntot, c, n_levels, level_sizes, pairs, stream_ptr);
}

// Per level idx, w (b, n, h, P); val (b, ntot, h, c) -> out (b, n, h, c): b * h
// units whose rows lie h * c floats apart.
extern "C" int aff_msdetrpc_bh(const void* const* idxs, const void* const* ws,
                               const float* val, float* out, int b, int n, int heads,
                               int ntot, int c, int n_levels, const int* level_sizes,
                               int pairs, void* stream_ptr) {
  return layout_forward(head_natural(n, heads, pairs), idxs, ws, val, out, b * heads, n, ntot, c,
                        n_levels, level_sizes, pairs, stream_ptr);
}

extern "C" int aff_msdetrpc_bh_bwd(const void* const* idxs, const void* const* ws,
                                   const float* val, const float* g, float* dval, int* pool_row,
                                   float* pool_val, int* band_start, void* const* dws, int b,
                                   int n, int heads, int ntot, int c, int n_levels,
                                   const int* level_sizes, int pairs, void* stream_ptr) {
  return layout_backward(head_natural(n, heads, pairs), idxs, ws, dws, val, g, dval, pool_row,
                         pool_val, band_start, b * heads, n, ntot, c, n_levels, level_sizes,
                         pairs, stream_ptr);
}

// The interleaved layout: nn_idx, nn_weight (bh, n, m, k) with GLOBAL indices
// (clamped into [0, ntot - 1]), attn (bh, n, m); val (bh, ntot, c) -> out (bh,
// n, c).  One level of m * k pairs over the whole table, the attention each
// slot's second weight.  m * k <= 1536 for the backward.
extern "C" int aff_msdetrpc_interleaved(const int* nn_idx, const float* nn_weight,
                                        const float* attn, const float* val, float* out,
                                        int bh, int n, int ntot, int c, int m, int k,
                                        void* stream_ptr) {
  if (m < 1 || k < 1 || ntot < 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch_forward(interleaved_layout(nn_idx, nn_weight, nullptr, attn, nullptr, n, m, k),
                        val, out, bh, n, ntot, c, 1, &ntot, m * k, stream_ptr);
}

// The forward's operands plus g (bh, n, c) = d out -> d_nn_weight (bh, n, m,
// k), d_attn (bh, n, m) and dval (bh, ntot, c), every element written; the
// scratch as aff_msdetrpc_bwd_scratch gives it for one level of ntot rows and
// m * k pairs.
extern "C" int aff_msdetrpc_interleaved_bwd(const int* nn_idx, const float* nn_weight,
                                            const float* attn, const float* val,
                                            const float* g, float* d_nn_weight,
                                            float* d_attn, float* dval, int* pool_row,
                                            float* pool_val, int* band_start, int bh, int n,
                                            int ntot, int c, int m, int k, void* stream_ptr) {
  if (m < 1 || k < 1 || ntot < 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch_backward(
      interleaved_layout(nn_idx, nn_weight, d_nn_weight, attn, d_attn, n, m, k), val, g, dval,
      pool_row, pool_val, band_start, bh, n, ntot, c, 1, &ntot, m * k, stream_ptr);
}

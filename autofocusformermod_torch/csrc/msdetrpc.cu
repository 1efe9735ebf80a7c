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
//   d_val[r, row, :] = sum over the (q, jp) with row(jp) = row of w[r, q, jp] * g[r, q, :]
// Many queries sample the same value row (at n = 4096 each of level 0's 256
// rows ~256 times per image-head), so d_val is a reduction by row.  The TPU
// kernel accumulates it with one-hot matmuls into VMEM-resident band windows
// (_bwd_kernel_v4).  Here, with no float atomic and no zero-fill, two
// kernels:
//   1. msdetrpc_bwd_tile_kernel: a block per (r, tile of T consecutive
//      queries; T * L*P <= 1536 entries, T = 32 at 3 x 16 pairs).  A warp per
//      query computes d_w with the g row in registers and its value rows read
//      coalesced (LPR lanes per row, 16 bytes per lane, several pairs in
//      flight, a lane-group shuffle sum per pair).  The block sorts its
//      (row, entry) pairs by row (a stable block radix sort, so equal rows
//      keep the entry order) and sums each run of one row in that order:
//      one partial row per distinct row, stored with its row in the tile's
//      part of a scratch pool.  Queries come in curve order, so a tile's rows
//      at a level are few and close.
//   2. msdetrpc_bwd_band_kernel: a warp per (r, band of 32 value rows) walks
//      the tiles in order and adds the partial rows of those with rows in
//      the band (pass 1 leaves, per tile, where each band starts in its
//      sorted list); every d_val row is written once.
// The order of every sum is fixed, so two calls give the same bits.  What
// bounds it: the value-row reads of d_w (as the forward) and the block sort.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include <cub/block/block_radix_sort.cuh>
#include <cub/block/block_scan.cuh>

#include "local_attn_common.cuh"

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

// The row reads of the local_attn kernels: LPR lanes per row, VEC floats per
// lane, a lane-group shuffle sum.
using local_attn::group_sum;
using local_attn::load_unit;
using local_attn::store_unit;

inline bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

// The backward of the stacked layout.  Pass 1, per (r, tile of T queries).
constexpr int kBwdThreads = 256;
constexpr int kBwdItems = 6;                          // sort keys per thread
constexpr int kBwdCap = kBwdThreads * kBwdItems;      // (query, pair) entries per tile
constexpr int kBwdMaxQueries = 32;
constexpr int kEntBits = 11, kEntMask = (1 << kEntBits) - 1;
static_assert(kBwdCap <= 1 << kEntBits, "an entry id must fit its bits of the sort value");
constexpr int kBwdMaxC = 64;
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
// kernels read their rows (UNITS units of VEC channels per lane).
template <int VEC, int LPR, int UNITS>
__global__ void __launch_bounds__(kBwdThreads, 5)
msdetrpc_bwd_tile_kernel(const int* __restrict__ idx, const float* __restrict__ w,
                         const float* __restrict__ val, const float* __restrict__ g,
                         float* __restrict__ dw, int* __restrict__ pool_row,
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
  __shared__ int s_ent[kBwdCap];  // sorted: the entries, with their queries
  __shared__ float s_w[kBwdCap];
  __shared__ __align__(16) float s_g[kBwdMaxQueries * kBwdMaxC];
  __shared__ int s_off[kMaxLevels], s_size[kMaxLevels];

  const int r = blockIdx.y;
  const int tile = blockIdx.x;
  const int q0 = tile * T;
  const int nq = min(T, N - q0);
  const int LP = lv.count * P;
  const int ne = nq * LP;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const size_t ent0 = ((size_t)r * N + q0) * LP;     // the tile's entries are contiguous
  const float* vr = val + (size_t)r * NTOT * C;

  // the level table to shared memory, read at fixed offsets (an index known
  // only at run time would copy the struct to local memory)
#pragma unroll
  for (int l = 0; l < kMaxLevels; ++l) {
    if (tid == l) {
      s_off[l] = lv.off[l];
      s_size[l] = lv.size[l];
    }
  }
  __syncthreads();
  // thread tid takes entries tid * kBwdItems + x (the blocked arrangement the
  // sort wants), walking (query, level, pair) from one division.  The sort's
  // value carries the entry and its query: q << kEntBits | e.  Past the
  // entries: the key NTOT.
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
        const int row = s_off[j] + min(max(idx[ent0 + e], 0), s_size[j] - 1);
        s_row[e] = row;
        s_w[e] = w[ent0 + e];
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
  for (int x = tid; x < nq * C; x += kBwdThreads) s_g[x] = g[((size_t)r * N + q0) * C + x];
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
          const float* vrow = vr + (size_t)s_row[ql * LP + s] * C;
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
        if (lig == 0 && s < LP) dw[ent0 + (size_t)ql * LP + s] = dot[y];
      }
    }
  }

  // sort the entries by row; entry e sits at place e, so the sort's
  // stability keeps equal rows in entry order
  __syncthreads();              // every warp is done with s_row in entry order
  Sort(tmp.sort).Sort(keys, ents, 0, key_bits);
#pragma unroll
  for (int x = 0; x < kBwdItems; ++x) {
    s_row[tid * kBwdItems + x] = keys[x];
    s_ent[tid * kBwdItems + x] = ents[x];
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
      const int ent = s_ent[x];
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

// Pass 2: a warp per (r, band of kBand value rows), kBandWarps bands a block.
// The warp walks the tiles in order, 32 at a time (one per lane), and adds
// the partial rows of those with rows in the band into the band's rows in
// shared memory, lanes over channels; every d_val row is written once.
__global__ void __launch_bounds__(kBandWarps * 32)
msdetrpc_bwd_band_kernel(const int* __restrict__ pool_row, const float* __restrict__ pool_val,
                         const int* __restrict__ band_start, float* __restrict__ dval,
                         int tiles, int NTOT, int C, int cap) {
  __shared__ float s_acc[kBandWarps][kBand][kBwdMaxC];
  __shared__ int s_xr[kBandWarps][kBand];       // the band rows of the tile at hand
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = blockIdx.y;
  const int bands = (NTOT + kBand - 1) / kBand;
  const int band = blockIdx.x * kBandWarps + warp;
  if (band >= bands) return;                    // the whole warp leaves together
  const int x0 = band * kBand;
  float (*acc)[kBwdMaxC] = s_acc[warp];
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
  for (int x = 0; x < min(kBand, NTOT - x0); ++x)
    for (int c = lane; c < C; c += 32) dval[((size_t)r * NTOT + x0 + x) * C + c] = acc[x][c];
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

// The backward's scratch for bh image-heads of n queries: ints[0] tiles per
// image-head, ints[1] pool rows per tile, ints[2] band starts per tile.  The
// caller allocates pool_row (bh * tiles * rows) int32, pool_val (bh * tiles
// * rows, c) f32 and band_start (bh * tiles * starts) int32.
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
  Levels lv;
  const int tile = pairs < 1 ? 0 : bwd_tile_queries(n_levels * pairs);
  if (tile < 1 || c < 1 || c > kBwdMaxC || n < 1 || bh < 1 || bh > 65535 ||
      !make_levels(n_levels, level_sizes, ntot, &lv))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int tiles = (n + tile - 1) / tile;
  const int cap = bwd_pool_rows(tile, pairs, lv);
  const int key_bits = 32 - __builtin_clz((unsigned)ntot);   // rows and the past-end key ntot
  const dim3 grid(tiles, bh);
#define TILE_LAUNCH(VEC, LPR, UNITS)                                                       \
  msdetrpc_bwd_tile_kernel<VEC, LPR, UNITS><<<grid, kBwdThreads, 0, stream>>>(              \
      idx, w, val, g, dw, pool_row, pool_val, band_start, n, ntot, c, pairs, tile, key_bits, \
      cap, lv)
  // 16 bytes per lane where every value row starts at a multiple of 16 bytes
  const bool vec = c % 4 == 0 && aligned16(val);
  if (vec && c <= 16) TILE_LAUNCH(4, 4, 1);
  else if (vec && c <= 32) TILE_LAUNCH(4, 8, 1);
  else if (vec) TILE_LAUNCH(4, 16, 1);
  else TILE_LAUNCH(1, 32, 2);
#undef TILE_LAUNCH
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int bands = (ntot + kBand - 1) / kBand;
  msdetrpc_bwd_band_kernel<<<dim3((bands + kBandWarps - 1) / kBandWarps, bh), kBandWarps * 32,
                             0, stream>>>(pool_row, pool_val, band_start, dval, tiles, ntot, c,
                                          cap);
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

// Exact 2-D k-nearest neighbours, k <= 16.
//
// Replaces autofocusformermod_tpu/ops/pallas/knn_kernel.py:knn_pallas (and
// the XLA sweep geometry/knn.py:knn uses below 1024 database points).
// Result: for each query the k database points of smallest
// d2 = (qx-x)^2 + (qy-y)^2, ascending, ties to the lowest database index --
// identical to a stable argsort of the brute-force distances.  Positions
// are finite (they are geometry).
//
// What bounds it on the H100: the pairs it evaluates.  Brute force is
// nq * ndb pairs (16384 x 4096 per image for the pixel decoder's largest
// tables) at ~8 instructions each; the bytes are tiny (8 per position).  So
// the large calls prune, as the TPU kernel does, and small ones sweep.
// Two routes, chosen by the wrapper from the shape:
//
//  - "sweep" (the first design): one thread per query, the whole database
//    streamed through shared memory in tiles of 1024.  The database is
//    scanned in index order and a candidate only enters on a strictly
//    smaller distance, so ties go to the lowest index without a second key.
//
//  - "pruned", two launches.  knn_prep_kernel, one 1024-thread block per
//    image, buckets the database into a grid of at most ncap cells over its
//    bounding box (the wrapper asks for about 16 points a cell; the TPU
//    kernel's spatial sort, done as a counting sort: histogram and cell
//    boxes with shared-memory atomics, a block scan, a scatter) and writes
//    each cell's points as (x, y, original index), its start and its exact
//    bounding box.  knn_search_kernel gives each warp 32 consecutive queries
//    (the AFF stages' tokens are in space-filling order, the decoder's grid
//    in raster order: a 32-query strip), takes their bounding box and
//    visits cells in proximity order: each round picks the unvisited cell
//    of least box-to-box lower bound by one warp reduce over a key of the
//    bound with its low 10 bits replaced by the cell's number (each cell's
//    key computed once per warp and kept in shared memory), stops when
//    that key's bound is strictly greater than the largest current k-th
//    distance of the warp's queries (a tie is kept, as knn_kernel.py keeps
//    it: an equal distance with a lower index still enters), and otherwise
//    stages the cell's points through shared memory 32 at a time.  A visit
//    order other than index order needs the second key: insertion compares
//    (d2, original index) lexicographically.
//    Exactness: a cell's box holds its points, and the bound is computed
//    with the same round-to-nearest, uncontracted operations as a distance
//    (__fsub_rn, __fmul_rn, __fadd_rn).  Rounding is monotone and odd, so
//    for a query x in [qlo, qhi] and a point px in [clo, chi] with
//    clo > qhi, |fl(x - px)| = fl(px - x) >= fl(clo - qhi) (likewise on the
//    other side), then fl(dx*dx) >= fl(gx*gx) and the sum keeps the order:
//    the bound never exceeds any computed distance of a point in the cell.
//    Clearing low bits of a non-negative float only lowers it, so a key's
//    bound is at most the bound of every cell left; a cell left unvisited
//    has bound > every query's k-th best, so none of its points could
//    enter.  The order of points inside a cell (set by the scatter's
//    atomics) changes only the work, never the result.
//    What a visit costs on the card (measured): cells of ~16 points beat 8
//    and 32; keys kept rather than bounds recomputed each round -7%; loading
//    the next cell while merging this one, 2 or 8 warps a block, or reading
//    points straight from global memory did not pay; the pair of launches
//    costs ~15 us however small the call, so small databases sweep.

// Every distance uses __fsub_rn/__fmul_rn/__fadd_rn so nvcc cannot contract
// it into an FMA, which would round differently from the CPU and break exact
// ties (half-integer queries tie exactly between grid nodes).

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float dist2(float qx, float qy, float x, float y) {
  const float dx = __fsub_rn(qx, x);
  const float dy = __fsub_rn(qy, y);
  return __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
}

// ------------------------------------------------------------ sweep route

constexpr int kThreads = 256;
constexpr int kTile = 1024;

template <int K>
__global__ void knn_kernel(const float* __restrict__ query,
                           const float* __restrict__ db,
                           int* __restrict__ out_idx,
                           float* __restrict__ out_d2,
                           int nq, int ndb) {
  __shared__ float sx[kTile];
  __shared__ float sy[kTile];
  const int b = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = i < nq;
  const float* qb = query + (size_t)b * nq * 2;
  const float* dbb = db + (size_t)b * ndb * 2;
  const float qx = active ? qb[2 * i] : 0.f;
  const float qy = active ? qb[2 * i + 1] : 0.f;

  float bd[K];
  int bi[K];
#pragma unroll
  for (int t = 0; t < K; ++t) {
    bd[t] = CUDART_INF_F;
    bi[t] = -1;
  }

  for (int base = 0; base < ndb; base += kTile) {
    const int cnt = min(kTile, ndb - base);
    __syncthreads();
    for (int t = threadIdx.x; t < cnt; t += blockDim.x) {
      sx[t] = dbb[2 * (base + t)];
      sy[t] = dbb[2 * (base + t) + 1];
    }
    __syncthreads();
    if (active) {
      for (int t = 0; t < cnt; ++t) {
        const float d = dist2(qx, qy, sx[t], sy[t]);
        if (d < bd[K - 1]) {
          bd[K - 1] = d;
          bi[K - 1] = base + t;
#pragma unroll
          for (int s = K - 1; s > 0; --s) {
            if (bd[s] < bd[s - 1]) {
              const float td = bd[s]; bd[s] = bd[s - 1]; bd[s - 1] = td;
              const int ti = bi[s]; bi[s] = bi[s - 1]; bi[s - 1] = ti;
            }
          }
        }
      }
    }
  }
  if (active) {
    const size_t o = ((size_t)b * nq + i) * K;
#pragma unroll
    for (int t = 0; t < K; ++t) {
      out_idx[o + t] = bi[t];
      out_d2[o + t] = bd[t];
    }
  }
}

// ----------------------------------------------------------- pruned route

constexpr int kPrepThreads = 1024;
constexpr int kMaxCells = 1024;
constexpr unsigned kCellMask = kMaxCells - 1;      // a cell's number in a search key
constexpr int kSearchWarps = 4;

// order-preserving unsigned image of a float, for min / max by integer atomics
__device__ __forceinline__ unsigned okey(float x) {
  const unsigned b = __float_as_uint(x);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float okey_value(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// one image's scratch: the points by cell (x, y, original index as bits, 0),
// the cells' boxes (xmin, ymin, xmax, ymax) and their starts (ncap + 1; the
// cells past the grid's are empty)
struct Scratch {
  float4* pts;
  float4* box;
  int* start;
};

__host__ __device__ __forceinline__ size_t scratch_stride(int ndb, int ncap) {
  return ((size_t)16 * ndb + (size_t)16 * ncap + (size_t)4 * (ncap + 1) + 15) / 16 * 16;
}

__device__ __forceinline__ Scratch scratch_of(unsigned char* base, int b, int ndb, int ncap) {
  unsigned char* s = base + (size_t)b * scratch_stride(ndb, ncap);
  Scratch r;
  r.pts = reinterpret_cast<float4*>(s);
  r.box = reinterpret_cast<float4*>(s + (size_t)16 * ndb);
  r.start = reinterpret_cast<int*>(s + (size_t)16 * ndb + (size_t)16 * ncap);
  return r;
}

struct CellGrid {
  float x0, y0, invx, invy;
  int cx, cy;
  __device__ __forceinline__ int cell(float x, float y) const {
    const int ix = min(cx - 1, max(0, __float2int_rz(__fmul_rn(__fsub_rn(x, x0), invx))));
    const int iy = min(cy - 1, max(0, __float2int_rz(__fmul_rn(__fsub_rn(y, y0), invy))));
    return iy * cx + ix;
  }
};

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__global__ void __launch_bounds__(kPrepThreads)
knn_prep_kernel(const float* __restrict__ db, int ndb, int ncap, unsigned char* scratch) {
  __shared__ int s_count[kMaxCells];
  __shared__ unsigned s_box[4][kMaxCells];
  __shared__ float s_red[4][kPrepThreads / 32];
  __shared__ int s_wsum[kPrepThreads / 32];
  __shared__ CellGrid s_grid;
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* p = db + (size_t)b * ndb * 2;
  const Scratch sc = scratch_of(scratch, b, ndb, ncap);

  // the database's bounding box
  float xmin = CUDART_INF_F, ymin = CUDART_INF_F, xmax = -CUDART_INF_F, ymax = -CUDART_INF_F;
  for (int i = tid; i < ndb; i += kPrepThreads) {
    const float x = p[2 * i], y = p[2 * i + 1];
    xmin = fminf(xmin, x);
    ymin = fminf(ymin, y);
    xmax = fmaxf(xmax, x);
    ymax = fmaxf(ymax, y);
  }
  xmin = warp_min(xmin);
  ymin = warp_min(ymin);
  xmax = warp_max(xmax);
  ymax = warp_max(ymax);
  if (lane == 0) {
    s_red[0][warp] = xmin;
    s_red[1][warp] = ymin;
    s_red[2][warp] = xmax;
    s_red[3][warp] = ymax;
  }
  for (int c = tid; c < kMaxCells; c += kPrepThreads) {
    s_count[c] = 0;
    s_box[0][c] = kFull;
    s_box[1][c] = kFull;
    s_box[2][c] = 0u;
    s_box[3][c] = 0u;
  }
  __syncthreads();
  if (warp == 0) {
    xmin = warp_min(s_red[0][lane]);
    ymin = warp_min(s_red[1][lane]);
    xmax = warp_max(s_red[2][lane]);
    ymax = warp_max(s_red[3][lane]);
    if (lane == 0) {
      // about ncap cells of equal sides over the box (a row or a column
      // where the box is flat); where the points fall only sets the work
      const float w = __fsub_rn(xmax, xmin), h = __fsub_rn(ymax, ymin);
      int cx = 1, cy = 1;
      if (w > 0.f && h > 0.f) {
        const float side = sqrtf(w * h / ncap);
        cx = min(ncap, max(1, (int)ceilf(w / side)));
        cy = min(ncap / cx, max(1, (int)ceilf(h / side)));
      } else if (w > 0.f) {
        cx = ncap;
      } else if (h > 0.f) {
        cy = ncap;
      }
      CellGrid g;
      g.x0 = xmin;
      g.y0 = ymin;
      g.cx = cx;
      g.cy = cy;
      g.invx = w > 0.f ? cx / w : 0.f;
      g.invy = h > 0.f ? cy / h : 0.f;
      if (!(g.invx < CUDART_INF_F)) g.invx = 0.f;
      if (!(g.invy < CUDART_INF_F)) g.invy = 0.f;
      s_grid = g;
    }
  }
  __syncthreads();
  const CellGrid g = s_grid;
  const int ncell = g.cx * g.cy;

  // histogram and exact boxes
  for (int i = tid; i < ndb; i += kPrepThreads) {
    const float x = p[2 * i], y = p[2 * i + 1];
    const int c = g.cell(x, y);
    atomicAdd(&s_count[c], 1);
    atomicMin(&s_box[0][c], okey(x));
    atomicMin(&s_box[1][c], okey(y));
    atomicMax(&s_box[2][c], okey(x));
    atomicMax(&s_box[3][c], okey(y));
  }
  __syncthreads();

  // exclusive scan of the counts (one cell a thread; ncell <= kPrepThreads)
  const int cnt = tid < ncell ? s_count[tid] : 0;
  int incl = cnt;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int n = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += n;
  }
  if (lane == 31) s_wsum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = s_wsum[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int n = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w += n;
    }
    s_wsum[lane] = w - s_wsum[lane];              // exclusive: the warps before
  }
  __syncthreads();
  if (tid < ncell) {
    const int start = s_wsum[warp] + incl - cnt;
    sc.start[tid] = start;
    s_count[tid] = start;                        // the scatter's cursor
    sc.box[tid] = cnt ? make_float4(okey_value(s_box[0][tid]), okey_value(s_box[1][tid]),
                                    okey_value(s_box[2][tid]), okey_value(s_box[3][tid]))
                      : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int c = ncell + tid; c <= ncap; c += kPrepThreads) sc.start[c] = ndb;  // empty cells
  __syncthreads();

  for (int i = tid; i < ndb; i += kPrepThreads) {
    const float x = p[2 * i], y = p[2 * i + 1];
    const int at = atomicAdd(&s_count[g.cell(x, y)], 1);
    sc.pts[at] = make_float4(x, y, __int_as_float(i), 0.f);
  }
}

// a lower bound on every computed distance from a query in [qlo, qhi] to a
// point in the box (see the note)
__device__ __forceinline__ float box_bound(float4 c, float qlx, float qly, float qhx, float qhy) {
  const float gx = fmaxf(fmaxf(__fsub_rn(c.x, qhx), __fsub_rn(qlx, c.z)), 0.f);
  const float gy = fmaxf(fmaxf(__fsub_rn(c.y, qhy), __fsub_rn(qly, c.w)), 0.f);
  return __fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy));
}

template <int K>
__global__ void __launch_bounds__(32 * kSearchWarps)
knn_search_kernel(const float* __restrict__ query, unsigned char* __restrict__ scratch,
                  int* __restrict__ out_idx, float* __restrict__ out_d2,
                  int nq, int ndb, int ncap) {
  extern __shared__ float4 s_mem[];
  float4* s_box = s_mem;                                         // ncap
  float4* s_buf = s_box + ncap;                                  // kSearchWarps x 32
  int* s_start = reinterpret_cast<int*>(s_buf + 32 * kSearchWarps);  // ncap + 1
  unsigned* s_key = reinterpret_cast<unsigned*>(s_start + ncap + 1);  // per warp 32 x rounds
  const int b = blockIdx.y, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Scratch sc = scratch_of(scratch, b, ndb, ncap);
  const int first = (blockIdx.x * kSearchWarps + warp) * 32;
  const int i = first + lane;
  const bool active = i < nq;
  const float* qb = query + (size_t)b * nq * 2;
  const float qx = active ? qb[2 * i] : 0.f;
  const float qy = active ? qb[2 * i + 1] : 0.f;
  for (int c = tid; c < ncap; c += 32 * kSearchWarps) s_box[c] = sc.box[c];
  for (int c = tid; c <= ncap; c += 32 * kSearchWarps) s_start[c] = sc.start[c];
  __syncthreads();
  if (first >= nq) return;                       // no block barrier after this
  const float qlx = warp_min(active ? qx : CUDART_INF_F);
  const float qly = warp_min(active ? qy : CUDART_INF_F);
  const float qhx = warp_max(active ? qx : -CUDART_INF_F);
  const float qhy = warp_max(active ? qy : -CUDART_INF_F);

  float bd[K];
  int bi[K];
#pragma unroll
  for (int t = 0; t < K; ++t) {
    bd[t] = CUDART_INF_F;
    bi[t] = 0x7fffffff;
  }

  // bit m: cell lane + 32 m is visited, or empty (the cells past the grid's
  // are)
  const int rounds = (ncap + 31) / 32;
  unsigned done = 0;
  for (int m = 0; m < rounds; ++m) {
    const int c = lane + 32 * m;
    if (c >= ncap || s_start[c] == s_start[c + 1]) done |= 1u << m;
  }
  for (int m = rounds; m < 32; ++m) done |= 1u << m;
  float4* buf = s_buf + 32 * warp;

  // each cell's key, once: the bound's bits with the low bits (kCellMask)
  // holding the cell's number.  A bound is >= +0 and never NaN, so its bits
  // order as its value; the cleared bits only lower it, so a key's bound is
  // at most the bound of every cell left, and stopping when it exceeds
  // worst skips no cell that could hold a point.  Lane-private entries.
  unsigned* key = s_key + 32 * rounds * warp;
  for (int m = 0; m < rounds; ++m) {
    const unsigned c = lane + 32 * m;
    key[c] = (done >> m & 1u)
                 ? kFull
                 : (__float_as_uint(box_bound(s_box[c], qlx, qly, qhx, qhy)) & ~kCellMask) | c;
  }

  while (true) {
    // the nearest unvisited cell, by one warp reduce over the keys
    unsigned best = kFull;
    for (int m = 0; m < rounds; ++m)
      if (!(done >> m & 1u)) best = min(best, key[lane + 32 * m]);
    const unsigned wkey = __reduce_min_sync(kFull, best);
    if (wkey == kFull) break;                          // every cell visited
    const unsigned worst = __reduce_max_sync(kFull, active ? __float_as_uint(bd[K - 1]) : 0u);
    if (__uint_as_float(wkey & ~kCellMask) > __uint_as_float(worst)) break;  // strictly
    const int c = static_cast<int>(wkey & kCellMask);
    if (lane == (c & 31)) done |= 1u << (c >> 5);

    const int end = s_start[c + 1];
    for (int base = s_start[c]; base < end; base += 32) {
      const int n = min(32, end - base);
      if (lane < n) buf[lane] = sc.pts[base + lane];
      __syncwarp();
      if (active) {
        for (int t = 0; t < n; ++t) {
          const float4 pt = buf[t];
          const float d = dist2(qx, qy, pt.x, pt.y);
          const int id = __float_as_int(pt.z);
          if (d < bd[K - 1] || (d == bd[K - 1] && id < bi[K - 1])) {
            bd[K - 1] = d;
            bi[K - 1] = id;
#pragma unroll
            for (int s = K - 1; s > 0; --s) {
              if (bd[s] < bd[s - 1] || (bd[s] == bd[s - 1] && bi[s] < bi[s - 1])) {
                const float td = bd[s]; bd[s] = bd[s - 1]; bd[s - 1] = td;
                const int ti = bi[s]; bi[s] = bi[s - 1]; bi[s - 1] = ti;
              }
            }
          }
        }
      }
      __syncwarp();
    }
  }

  if (active) {
    const size_t o = ((size_t)b * nq + i) * K;
#pragma unroll
    for (int t = 0; t < K; ++t) {
      out_idx[o + t] = bi[t];
      out_d2[o + t] = bd[t];
    }
  }
}

template <int K>
void launch(const float* q, const float* db, int* idx, float* d2, int b,
            int nq, int ndb, cudaStream_t stream) {
  dim3 grid((nq + kThreads - 1) / kThreads, b);
  knn_kernel<K><<<grid, kThreads, 0, stream>>>(q, db, idx, d2, nq, ndb);
}

template <int K>
void launch_search(const float* q, unsigned char* scratch, int* idx, float* d2, int b, int nq,
                   int ndb, int ncap, cudaStream_t stream) {
  const int per_block = 32 * kSearchWarps;
  dim3 grid((nq + per_block - 1) / per_block, b);
  const size_t smem = (size_t)16 * (ncap + per_block) + (size_t)4 * (ncap + 1) +
                      (size_t)4 * 32 * ((ncap + 31) / 32) * kSearchWarps;
  knn_search_kernel<K><<<grid, per_block, smem, stream>>>(q, scratch, idx, d2, nq, ndb, ncap);
}

}  // namespace

// query (b, nq, 2) f32, db (b, ndb, 2) f32 -> idx (b, nq, k) i32, d2 (b, nq, k) f32
extern "C" int aff_knn(const float* query, const float* db, int* idx, float* d2,
                       int b, int nq, int ndb, int k, void* stream_ptr) {
  cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  switch (k) {
    case 1: launch<1>(query, db, idx, d2, b, nq, ndb, s); break;
    case 2: launch<2>(query, db, idx, d2, b, nq, ndb, s); break;
    case 3: launch<3>(query, db, idx, d2, b, nq, ndb, s); break;
    case 4: launch<4>(query, db, idx, d2, b, nq, ndb, s); break;
    case 5: launch<5>(query, db, idx, d2, b, nq, ndb, s); break;
    case 6: launch<6>(query, db, idx, d2, b, nq, ndb, s); break;
    case 7: launch<7>(query, db, idx, d2, b, nq, ndb, s); break;
    case 8: launch<8>(query, db, idx, d2, b, nq, ndb, s); break;
    case 9: launch<9>(query, db, idx, d2, b, nq, ndb, s); break;
    case 10: launch<10>(query, db, idx, d2, b, nq, ndb, s); break;
    case 11: launch<11>(query, db, idx, d2, b, nq, ndb, s); break;
    case 12: launch<12>(query, db, idx, d2, b, nq, ndb, s); break;
    case 13: launch<13>(query, db, idx, d2, b, nq, ndb, s); break;
    case 14: launch<14>(query, db, idx, d2, b, nq, ndb, s); break;
    case 15: launch<15>(query, db, idx, d2, b, nq, ndb, s); break;
    case 16: launch<16>(query, db, idx, d2, b, nq, ndb, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The pruned route: the same operands and result, plus scratch of b * stride
// bytes with stride >= the layout's (ncap cells at most, 1 <= ncap <= 1024).
extern "C" int aff_knn_pruned(const float* query, const float* db, int* idx, float* d2,
                              void* scratch, long long stride, int b, int nq, int ndb, int k,
                              int ncap, void* stream_ptr) {
  if (ncap < 1 || ncap > kMaxCells || ndb < 1 ||
      stride != (long long)scratch_stride(ndb, ncap))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  unsigned char* sc = static_cast<unsigned char*>(scratch);
  knn_prep_kernel<<<b, kPrepThreads, 0, s>>>(db, ndb, ncap, sc);
  switch (k) {
    case 1: launch_search<1>(query, sc, idx, d2, b, nq, ndb, ncap, s); break;
    case 2: launch_search<2>(query, sc, idx, d2, b, nq, ndb, ncap, s); break;
    case 3: launch_search<3>(query, sc, idx, d2, b, nq, ndb, ncap, s); break;
    case 4: launch_search<4>(query, sc, idx, d2, b, nq, ndb, ncap, s); break;
    case 5: launch_search<5>(query, sc, idx, d2, b, nq, ndb, ncap, s); break;
    case 6: launch_search<6>(query, sc, idx, d2, b, nq, ndb, ncap, s); break;
    case 7: launch_search<7>(query, sc, idx, d2, b, nq, ndb, ncap, s); break;
    case 8: launch_search<8>(query, sc, idx, d2, b, nq, ndb, ncap, s); break;
    case 9: launch_search<9>(query, sc, idx, d2, b, nq, ndb, ncap, s); break;
    case 10: launch_search<10>(query, sc, idx, d2, b, nq, ndb, ncap, s); break;
    case 11: launch_search<11>(query, sc, idx, d2, b, nq, ndb, ncap, s); break;
    case 12: launch_search<12>(query, sc, idx, d2, b, nq, ndb, ncap, s); break;
    case 13: launch_search<13>(query, sc, idx, d2, b, nq, ndb, ncap, s); break;
    case 14: launch_search<14>(query, sc, idx, d2, b, nq, ndb, ncap, s); break;
    case 15: launch_search<15>(query, sc, idx, d2, b, nq, ndb, ncap, s); break;
    case 16: launch_search<16>(query, sc, idx, d2, b, nq, ndb, ncap, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Local cluster attention with rel-pos bias and a blank attention sink:
// forward and backward.
//
// Replaces autofocusformermod_tpu/ops/pallas/local_attn.py:
// sfc_cluster_attention (forward, _sfc_attention_forward / _kernel) and
// _sfc_attention_backward (_bwd_dq_kernel, _bwd_dkv_kernel).
// Tokens are sorted along a space-filling curve, so token i's neighbourhood
// is the nnc*span contiguous tokens [nc[i,t]*span, nc[i,t]*span + span),
// t < nnc; a slot is valid iff its token index is < n (padding is excluded
// exactly, as in the TPU kernel).  For each head:
//   s_j   = q_i . k_j + (dx, dy, dist, sin, cos) . w5[h] + b5[h]
//           with (dx, dy) = clip(pos_j - pos_i, +-511), (0,0) -> all zeros
//   blank = q_i . blank_k[h]
//   p     = softmax over {s_j valid} U {blank}  (fp32, expf)
//   out_i = sum_j p_j v_j,   blank_prob_i = p_blank,
//   lse_i = log(sum_j exp s_j + exp blank)      (saved for the backward)
// q arrives pre-scaled by c_^-0.5 (as in models/aff.py).  dist, sin and cos
// use sqrtf and IEEE division, the same operations as the plain path's
// rel_pos_features, where the TPU kernel used rsqrt to spare its VPU.
//
// What bounds it on the H100: memory.  Per query and head it reads nnc*span
// (48) key rows and value rows of c_ floats (16-32) that neighbouring
// queries mostly share, so L2 serves most of it; the arithmetic is ~2 flops
// per byte.
//
// Design (local_attn_kernel): one warp per (batch, query), looping over
// heads, so the geometry (neighbour indices and the five rel-pos features)
// is computed once and shared by every head from shared memory; the 8 warps
// of a block take 8 consecutive queries (one cluster where span is 8), whose
// neighbour lists are nearly the same, so L1 serves most rows after the
// first warp.  Two passes, each reading its rows coalesced as the backward's
// query side does (local_attn_common.cuh: LPR lanes per row, 16 bytes per
// lane, two row groups in flight): q.k into shared memory with a lane-group
// shuffle sum and the bias computed once per head and slot, the softmax with
// lanes over slots, then p.v over the value rows.  Two passes rather than an
// online softmax: each row is read once either way, and the second pass
// needs no rescaling.  The TPU kernel's 128-token blocks and visit lists
// exist for its (8,128) tiling and VMEM and are not carried over.  One warp
// serving 2 or 4 queries of a cluster (the union of their clusters walked
// once, every row scored against all their q rows in registers) ran 1.7-2.0
// times slower than this kernel over a step of either model (PERF.md): the
// union is larger than one list, and the per-query masks and biases cost
// more than the shared reads save.
//
// Backward: a query-side and a key-side kernel, as the TPU's pair
// (_bwd_dq_kernel over row blocks, _bwd_dkv_kernel over column blocks and
// reverse bounds), without its 128-token blocks.  fp32 throughout, no TF32 or
// bf16 tensor-core products: the gradients are held to the plain version at
// 1e-3 and to the JAX package in fp32, and the bound of both kernels is bytes
// (~2.5 flops per byte of k, v, q, g), not operations.
//
// What bounded the first version (one kernel: a warp per query, one lane per
// neighbour slot walking its own key and value row with 4-byte loads, dk and
// dv scattered with atomicAdd) on this card, measured by compiling parts out
// at AFF-Small's four stage shapes: the lane-per-slot row walk, each of whose
// load instructions touches up to 32 lines for 4 bytes of each.  Reading the
// rows with lanes over channels took 47% off its time; compiling the 2 *
// nnc*span * c_ float reductions per query and head out took 5% off.  So not
// the atomic scatter: PERF.md has the three times per stage.
//
// Query side (local_attn_bwd_dq_kernel): a warp per query, looping over
// heads, the 8 warps of a block on 8 consecutive queries (one cluster where
// span is 8), whose neighbour lists are nearly the same, so L1 serves most
// rows after the first warp.  Rows are read coalesced (local_attn_common.cuh:
// LPR lanes per row, 16 bytes per lane): one pass computes q.k and g.v of 32 /
// LPR rows per instruction with a lane-group shuffle sum, then
// p_j = exp(s_j - lse_i), ds_j = p_j (g_i . v_j - delta_i) with
// delta_i = g_i . out_i + gb_i pb_i from the wrapper, and adds ds_j k_j into
// dq from the key registers it still holds.  It writes dq_i, the per-query
// rel-pos partials drow_i = (sum_j ds_j feat_j[0..4], sum_j ds_j), and p and
// ds themselves to two scratch tensors (b, h, n, nnc*span), coalesced.  The
// rows are not staged in shared memory: with every query given the same six
// clusters (every row an L1 hit, the most a staged tile could buy) the kernel
// ran no faster, so fetching rows is not what holds it.  What does is most
// likely the load-store pipe, which moves 2 * nnc*span rows per query and head
// from L1 to registers and also serves the shuffles and the shared-memory
// tables (counted from the source, not measured: the machine has no ncu).
// Less of that needs queries that share key rows in registers, which this
// kernel does not do.
//
// Key side (local_attn_bwd_dkv_kernel): a key token receives from every query
// whose neighbour clusters hold it, a fan-in that varies from cluster to
// cluster.  The wrapper lists, per key cluster, the (query, slot group)
// references i * nnc + t in a fixed order (CSR: offsets, refs).  One warp
// (half a warp where c_ <= 16) per (image, head, key cluster), lanes over
// channels, holds the cluster's span dk rows and span dv rows in registers,
// walks the references in order (q_i and g_i rows coalesced, the span stored
// ds and p of the slot group as one 32-byte sector each), and writes every
// row once with plain stores, zeros where a cluster has no reference.  No
// atomics and no zero-fill, so the same inputs give the same bits.  Fan-in on
// the models' shapes: mean nnc * span = 48 queries per cluster, worst 67 (the
// regular grids of a 512x512 step's four stages).  A long list only makes its
// own warp run longer, and with thousands of warps per launch the kernel does
// nothing else about the imbalance.  The blank sink's terms and the w5/b5/blank_k reductions
// stay in PyTorch, as they stay in XLA on the TPU.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "local_attn_common.cuh"

namespace {

using namespace local_attn;

constexpr int kFwdWarps = 8;      // one cluster of queries per block where span is 8

// Forward.  VEC floats per lane and LPR lanes per row (32 / LPR rows per load
// instruction); a lane holds UNITS units of VEC channels: channel
// (lig + u * LPR) * VEC, lig its place in the row's lane group -- the layout
// of the backward's query side, whose row reads this kernel shares.
template <int VEC, int LPR, int UNITS>
__global__ void __launch_bounds__(kFwdWarps * 32)
local_attn_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ pos,
                  const int* __restrict__ nc, const float* __restrict__ w5,
                  const float* __restrict__ b5, const float* __restrict__ blank_k,
                  float* __restrict__ out, float* __restrict__ blank_prob,
                  float* __restrict__ lse, int B, int H, int N, int C, int NNC, int SPAN) {
  constexpr int RPI = 32 / LPR;   // rows per load instruction
  constexpr int kStep = 2;        // row groups in flight
  __shared__ float s_feat[kFwdWarps][5][kMaxSlots];
  __shared__ int s_key[kFwdWarps][kMaxSlots];
  __shared__ float s_p[kFwdWarps][kMaxSlots];
  __shared__ float s_bias[kFwdWarps][kMaxSlots];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kFwdWarps + warp;  // over B*N
  if (row >= (long long)B * N) return;  // the whole warp leaves together
  const int bi = (int)(row / N);
  const int i = (int)(row % N);
  const int M = NNC * SPAN;
  const int lig = lane % LPR;
  const int rl = lane / LPR;

  // geometry shared by all heads
  neighbourhood(pos + (size_t)bi * N * 2, nc + ((size_t)bi * N + i) * NNC, i, N, NNC, SPAN,
                lane, s_key[warp], s_feat[warp]);
  __syncwarp();

  for (int hh = 0; hh < H; ++hh) {
    const size_t head = (size_t)bi * H + hh;
    const size_t qi = head * N + i;
    float qv[UNITS][VEC];
    float bl = 0.f;   // the blank logit, over this lane's channels first
#pragma unroll
    for (int u = 0; u < UNITS; ++u) {
      const int ch = (lig + u * LPR) * VEC;
#pragma unroll
      for (int e = 0; e < VEC; ++e) qv[u][e] = 0.f;
      if (ch < C) {
        float bk[VEC];
        load_unit<VEC>(q + qi * C + ch, qv[u]);
        load_unit<VEC>(blank_k + (size_t)hh * C + ch, bk);
#pragma unroll
        for (int e = 0; e < VEC; ++e) bl += qv[u][e] * bk[e];
      }
    }
    bl = group_sum<LPR>(bl);
    const float* kh = k + head * N * C;
    const float* vh = v + head * N * C;
    const float w0 = w5[hh * 5 + 0], w1 = w5[hh * 5 + 1], w2 = w5[hh * 5 + 2];
    const float w3 = w5[hh * 5 + 3], w4 = w5[hh * 5 + 4], bb = b5[hh];

    // the rel-pos bias of every slot, lanes over slots
    for (int s = lane; s < M; s += 32)
      s_bias[warp][s] = s_feat[warp][0][s] * w0 + s_feat[warp][1][s] * w1 +
                        s_feat[warp][2][s] * w2 + s_feat[warp][3][s] * w3 +
                        s_feat[warp][4][s] * w4 + bb;
    __syncwarp();

    // pass 1: the logits, key rows read coalesced, kStep row groups per
    // step; the bound is uniform over the warp, which shuffles
    float mx = -CUDART_INF_F;
    for (int s0 = 0; s0 < M; s0 += kStep * RPI) {
      int j[kStep];
      float qk[kStep];
#pragma unroll
      for (int y = 0; y < kStep; ++y) {
        const int s = s0 + y * RPI + rl;
        j[y] = s < M ? s_key[warp][s] : -1;
        qk[y] = 0.f;
#pragma unroll
        for (int u = 0; u < UNITS; ++u) {
          const int ch = (lig + u * LPR) * VEC;
          if (j[y] >= 0 && ch < C) {
            float kr[VEC];
            load_unit<VEC>(kh + (size_t)j[y] * C + ch, kr);
#pragma unroll
            for (int e = 0; e < VEC; ++e) qk[y] += qv[u][e] * kr[e];
          }
        }
      }
#pragma unroll
      for (int y = 0; y < kStep; ++y) qk[y] = group_sum<LPR>(qk[y]);
#pragma unroll
      for (int y = 0; y < kStep; ++y) {
        const int s = s0 + y * RPI + rl;
        const float logit = j[y] >= 0 ? qk[y] + s_bias[warp][s] : -CUDART_INF_F;
        if (lig == 0 && s < M) s_p[warp][s] = logit;
        mx = fmaxf(mx, logit);
      }
    }
    mx = fmaxf(warp_max(mx), bl);
    __syncwarp();

    // the softmax, lanes over slots
    float sum = 0.f;
    for (int s = lane; s < M; s += 32) {
      const float e = s_key[warp][s] >= 0 ? expf(s_p[warp][s] - mx) : 0.f;
      s_p[warp][s] = e;
      sum += e;
    }
    const float pblank = expf(bl - mx);
    const float total = warp_sum(sum) + pblank;
    const float inv = 1.f / total;
    __syncwarp();

    // pass 2: p.v, value rows read coalesced as the key rows were
    float acc[UNITS][VEC];
#pragma unroll
    for (int u = 0; u < UNITS; ++u)
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[u][e] = 0.f;
    for (int s0 = 0; s0 < M; s0 += kStep * RPI) {
#pragma unroll
      for (int y = 0; y < kStep; ++y) {
        const int s = s0 + y * RPI + rl;
        const int j = s < M ? s_key[warp][s] : -1;
        if (j < 0) continue;
        const float p = s_p[warp][s];
#pragma unroll
        for (int u = 0; u < UNITS; ++u) {
          const int ch = (lig + u * LPR) * VEC;
          if (ch < C) {
            float vr[VEC];
            load_unit<VEC>(vh + (size_t)j * C + ch, vr);
#pragma unroll
            for (int e = 0; e < VEC; ++e) acc[u][e] += p * vr[e];
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < UNITS; ++u) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[u][e] = across_groups_sum<LPR>(acc[u][e]) * inv;
      const int ch = (lig + u * LPR) * VEC;
      if (rl == 0 && ch < C) store_unit<VEC>(out + qi * C + ch, acc[u]);
    }
    if (lane == 0) {
      blank_prob[qi] = pblank * inv;
      lse[qi] = mx + logf(total);
    }
    __syncwarp();  // s_p / s_bias are rewritten by the next head
  }
}

constexpr int kBwdWarps = 8;      // one cluster of queries per block where span is 8
constexpr int kDkvThreads = 256;

// Query side.  VEC floats per lane and LPR lanes per row (32 / LPR rows per
// load instruction); a lane holds UNITS units of VEC channels: channel
// (lig + u * LPR) * VEC, lig its place in the row's lane group.
template <int VEC, int LPR, int UNITS>
__global__ void __launch_bounds__(kBwdWarps * 32)
local_attn_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ pos,
                         const int* __restrict__ nc, const float* __restrict__ w5,
                         const float* __restrict__ b5, const float* __restrict__ g,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         float* __restrict__ dq, float* __restrict__ drow,
                         float* __restrict__ p_out, float* __restrict__ ds_out,
                         int B, int H, int N, int C, int NNC, int SPAN) {
  constexpr int RPI = 32 / LPR;   // rows per load instruction
  constexpr int kStep = 2;        // row groups in flight
  __shared__ float s_feat[kBwdWarps][5][kMaxSlots];
  __shared__ int s_key[kBwdWarps][kMaxSlots];
  __shared__ float s_p[kBwdWarps][kMaxSlots];
  __shared__ float s_ds[kBwdWarps][kMaxSlots];
  __shared__ float s_bias[kBwdWarps][kMaxSlots];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kBwdWarps + warp;  // over B*N
  if (row >= (long long)B * N) return;  // the whole warp leaves together
  const int bi = (int)(row / N);
  const int i = (int)(row % N);
  const int M = NNC * SPAN;
  const int lig = lane % LPR;
  const int rl = lane / LPR;

  // geometry shared by all heads
  neighbourhood(pos + (size_t)bi * N * 2, nc + ((size_t)bi * N + i) * NNC, i, N, NNC, SPAN,
                lane, s_key[warp], s_feat[warp]);
  __syncwarp();

  for (int hh = 0; hh < H; ++hh) {
    const size_t head = (size_t)bi * H + hh;
    const size_t qi = head * N + i;
    float qv[UNITS][VEC], gv[UNITS][VEC], acc[UNITS][VEC];
#pragma unroll
    for (int u = 0; u < UNITS; ++u) {
      const int ch = (lig + u * LPR) * VEC;
#pragma unroll
      for (int e = 0; e < VEC; ++e) qv[u][e] = gv[u][e] = acc[u][e] = 0.f;
      if (ch < C) {
        load_unit<VEC>(q + qi * C + ch, qv[u]);
        load_unit<VEC>(g + qi * C + ch, gv[u]);
      }
    }
    const float* kh = k + head * N * C;
    const float* vh = v + head * N * C;
    const float w0 = w5[hh * 5 + 0], w1 = w5[hh * 5 + 1], w2 = w5[hh * 5 + 2];
    const float w3 = w5[hh * 5 + 3], w4 = w5[hh * 5 + 4], bb = b5[hh];
    const float lse_i = lse[qi];
    const float delta_i = delta[qi];

    // the rel-pos bias of every slot, lanes over slots
    for (int s = lane; s < M; s += 32)
      s_bias[warp][s] = s_feat[warp][0][s] * w0 + s_feat[warp][1][s] * w1 +
                        s_feat[warp][2][s] * w2 + s_feat[warp][3][s] * w3 +
                        s_feat[warp][4][s] * w4 + bb;
    __syncwarp();

    // kStep row groups per step, their loads and shuffle sums independent of
    // each other; the bound is uniform over the warp, which shuffles
    for (int s0 = 0; s0 < M; s0 += kStep * RPI) {
      int j[kStep];
      float kr[kStep][UNITS][VEC], qk[kStep], gvd[kStep];
#pragma unroll
      for (int y = 0; y < kStep; ++y) {
        const int s = s0 + y * RPI + rl;
        j[y] = s < M ? s_key[warp][s] : -1;
        qk[y] = gvd[y] = 0.f;
#pragma unroll
        for (int u = 0; u < UNITS; ++u) {
          const int ch = (lig + u * LPR) * VEC;
#pragma unroll
          for (int e = 0; e < VEC; ++e) kr[y][u][e] = 0.f;
          if (j[y] >= 0 && ch < C) {
            float vr[VEC];
            load_unit<VEC>(kh + (size_t)j[y] * C + ch, kr[y][u]);
            load_unit<VEC>(vh + (size_t)j[y] * C + ch, vr);
#pragma unroll
            for (int e = 0; e < VEC; ++e) {
              qk[y] += qv[u][e] * kr[y][u][e];
              gvd[y] += gv[u][e] * vr[e];
            }
          }
        }
      }
#pragma unroll
      for (int y = 0; y < kStep; ++y) {
        qk[y] = group_sum<LPR>(qk[y]);
        gvd[y] = group_sum<LPR>(gvd[y]);
      }
#pragma unroll
      for (int y = 0; y < kStep; ++y) {
        const int s = s0 + y * RPI + rl;
        float p = 0.f, ds = 0.f;
        if (j[y] >= 0) {
          p = expf(qk[y] + s_bias[warp][s] - lse_i);
          ds = p * (gvd[y] - delta_i);
#pragma unroll
          for (int u = 0; u < UNITS; ++u)
#pragma unroll
            for (int e = 0; e < VEC; ++e) acc[u][e] += ds * kr[y][u][e];
        }
        if (lig == 0 && s < M) {
          s_p[warp][s] = p;
          s_ds[warp][s] = ds;
        }
      }
    }
    __syncwarp();

#pragma unroll
    for (int u = 0; u < UNITS; ++u) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[u][e] = across_groups_sum<LPR>(acc[u][e]);
      const int ch = (lig + u * LPR) * VEC;
      if (rl == 0 && ch < C) store_unit<VEC>(dq + qi * C + ch, acc[u]);
    }

    // p and ds to the scratch, coalesced, and the rel-pos partials
    float part[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int s = lane; s < M; s += 32) {
      const float ds = s_ds[warp][s];
      p_out[qi * M + s] = s_p[warp][s];
      ds_out[qi * M + s] = ds;
#pragma unroll
      for (int f = 0; f < 5; ++f) part[f] += ds * s_feat[warp][f][s];
      part[5] += ds;
    }
#pragma unroll
    for (int f = 0; f < 6; ++f) part[f] = warp_sum(part[f]);
    if (lane < 8) {
      float val = 0.f;
#pragma unroll
      for (int f = 0; f < 6; ++f) val = lane == f ? part[f] : val;
      drow[qi * 8 + lane] = val;
    }
    __syncwarp();  // s_p / s_ds / s_bias are rewritten by the next head
  }
}

// Key side.  A group of G lanes (a warp, or half of one) per (image, head, key
// cluster); a lane holds channels lig + u * G, u < UNITS, of ROWS rows of dk
// and dv at a time (all span rows in one pass where span <= ROWS).  ROW8: span
// is 8, so a slot group's 8 stored values are two aligned 16-byte loads.
template <int G, int UNITS, int ROWS, bool ROW8>
__global__ void __launch_bounds__(kDkvThreads)
local_attn_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ g,
                          const float* __restrict__ p, const float* __restrict__ ds,
                          const int* __restrict__ offsets, const int* __restrict__ refs,
                          float* __restrict__ dk, float* __restrict__ dv,
                          int B, int H, int N, int C, int NNC, int SPAN, int NCL) {
  constexpr int kBatch = UNITS * ROWS <= 8 ? 4 : 2;   // references in flight
  const long long group = ((long long)blockIdx.x * kDkvThreads + threadIdx.x) / G;
  if (group >= (long long)B * H * NCL) return;  // the whole group leaves together
  const int lig = threadIdx.x % G;
  const unsigned gmask = G == 32 ? 0xffffffffu : (0xffffu << (threadIdx.x & 16));
  const int cl = (int)(group % NCL);
  const int hh = (int)((group / NCL) % H);
  const int bi = (int)(group / ((long long)NCL * H));
  const int beg = offsets[(size_t)bi * (NCL + 1) + cl];
  const int end = offsets[(size_t)bi * (NCL + 1) + cl + 1];
  const int* rf = refs + (size_t)bi * N * NNC;
  const size_t hb = ((size_t)bi * H + hh) * N;   // the head's first row
  const int M = NNC * SPAN;

  for (int r0 = 0; r0 < SPAN; r0 += ROWS) {
    float ak[ROWS][UNITS], av[ROWS][UNITS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int u = 0; u < UNITS; ++u) ak[r][u] = av[r][u] = 0.f;

    for (int base = beg; base < end; base += G) {
      // a lane splits its own reference into (query, slot group) once
      const int mine = base + lig < end ? rf[base + lig] : 0;
      const int my_i = mine / NNC;
      const int my_t = mine - my_i * NNC;
      const int cnt = min(G, end - base);
      // kBatch references per step, their loads independent of each other; a
      // place past the list reads query 0 and counts with weight zero
      for (int x0 = 0; x0 < cnt; x0 += kBatch) {
        float qc[kBatch][UNITS], gc[kBatch][UNITS], dsv[kBatch][ROWS], pv[kBatch][ROWS];
#pragma unroll
        for (int y = 0; y < kBatch; ++y) {
          const int i = __shfl_sync(gmask, my_i, x0 + y, G);
          const int t = __shfl_sync(gmask, my_t, x0 + y, G);
          const bool on = x0 + y < cnt;
          const size_t qi = hb + i;
#pragma unroll
          for (int u = 0; u < UNITS; ++u) {
            const int ch = lig + u * G;
            qc[y][u] = ch < C ? q[qi * C + ch] : 0.f;
            gc[y][u] = ch < C ? g[qi * C + ch] : 0.f;
          }
          const float* dsr = ds + qi * M + t * SPAN + r0;
          const float* pr = p + qi * M + t * SPAN + r0;
          if constexpr (ROW8) {
            const float4 a0 = *reinterpret_cast<const float4*>(dsr);
            const float4 a1 = *reinterpret_cast<const float4*>(dsr + 4);
            const float4 c0 = *reinterpret_cast<const float4*>(pr);
            const float4 c1 = *reinterpret_cast<const float4*>(pr + 4);
            dsv[y][0] = a0.x; dsv[y][1] = a0.y; dsv[y][2] = a0.z; dsv[y][3] = a0.w;
            dsv[y][4] = a1.x; dsv[y][5] = a1.y; dsv[y][6] = a1.z; dsv[y][7] = a1.w;
            pv[y][0] = c0.x; pv[y][1] = c0.y; pv[y][2] = c0.z; pv[y][3] = c0.w;
            pv[y][4] = c1.x; pv[y][5] = c1.y; pv[y][6] = c1.z; pv[y][7] = c1.w;
          } else {
#pragma unroll
            for (int r = 0; r < ROWS; ++r) {
              dsv[y][r] = r0 + r < SPAN ? dsr[r] : 0.f;
              pv[y][r] = r0 + r < SPAN ? pr[r] : 0.f;
            }
          }
          if (!on) {
#pragma unroll
            for (int r = 0; r < ROWS; ++r) dsv[y][r] = pv[y][r] = 0.f;
          }
        }
#pragma unroll
        for (int y = 0; y < kBatch; ++y)
#pragma unroll
          for (int r = 0; r < ROWS; ++r)
#pragma unroll
            for (int u = 0; u < UNITS; ++u) {
              ak[r][u] += dsv[y][r] * qc[y][u];
              av[r][u] += pv[y][r] * gc[y][u];
            }
      }
    }

#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int tok = cl * SPAN + r0 + r;
      if (r0 + r < SPAN && tok < N) {
#pragma unroll
        for (int u = 0; u < UNITS; ++u) {
          const int ch = lig + u * G;
          if (ch < C) {
            dk[(hb + tok) * C + ch] = ak[r][u];
            dv[(hb + tok) * C + ch] = av[r][u];
          }
        }
      }
    }
  }
}

inline bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }
}  // namespace

// q/k/v (b, h, n, c) f32; pos (b, n, 2) f32; nc (b, n, nnc) i32; w5 (h, 5);
// b5 (h); blank_k (h, c) -> out (b, h, n, c), blank_prob (b, h, n, 1),
// lse (b, h, n, 1)
extern "C" int aff_local_attn(const float* q, const float* k, const float* v,
                              const float* pos, const int* nc, const float* w5,
                              const float* b5, const float* blank_k, float* out,
                              float* blank_prob, float* lse, int b, int h, int n,
                              int c, int nnc, int span, void* stream_ptr) {
  if (nnc * span > kMaxSlots || c > kMaxC || nnc <= 0 || span <= 0 || c <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const long long rows = (long long)b * n;
  const unsigned blocks = (unsigned)((rows + kFwdWarps - 1) / kFwdWarps);
#define FWD_LAUNCH(VEC, LPR, UNITS)                                                     \
  local_attn_kernel<VEC, LPR, UNITS><<<blocks, kFwdWarps * 32, 0, stream>>>(             \
      q, k, v, pos, nc, w5, b5, blank_k, out, blank_prob, lse, b, h, n, c, nnc, span)
  // 16 bytes per lane where every row starts at a multiple of 16 bytes
  const bool vec = c % 4 == 0 && aligned16(q) && aligned16(k) && aligned16(v) &&
                   aligned16(blank_k) && aligned16(out);
  if (vec && c <= 16) FWD_LAUNCH(4, 4, 1);
  else if (vec && c <= 32) FWD_LAUNCH(4, 8, 1);
  else if (vec) FWD_LAUNCH(4, 16, 1);
  else FWD_LAUNCH(1, 32, 2);
#undef FWD_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

// The backward's query side.  The forward's operands plus g (b, h, n, c) =
// d out, lse and delta (b, h, n, 1) -> dq (b, h, n, c) without the blank term,
// drow (b, h, n, 8), and p and ds (b, h, n, nnc * span) for the key side,
// every element written.  p and ds must start at a multiple of 16 bytes.
extern "C" int aff_local_attn_bwd_dq(const float* q, const float* k, const float* v,
                                     const float* pos, const int* nc, const float* w5,
                                     const float* b5, const float* g, const float* lse,
                                     const float* delta, float* dq, float* drow, float* p,
                                     float* ds, int b, int h, int n, int c, int nnc, int span,
                                     void* stream_ptr) {
  if (nnc * span > kMaxSlots || c > kMaxC || nnc <= 0 || span <= 0 || c <= 0 ||
      !aligned16(p) || !aligned16(ds))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const long long rows = (long long)b * n;
  const unsigned blocks = (unsigned)((rows + kBwdWarps - 1) / kBwdWarps);
#define DQ_LAUNCH(VEC, LPR, UNITS)                                                      \
  local_attn_bwd_dq_kernel<VEC, LPR, UNITS><<<blocks, kBwdWarps * 32, 0, stream>>>(      \
      q, k, v, pos, nc, w5, b5, g, lse, delta, dq, drow, p, ds, b, h, n, c, nnc, span)
  // 16 bytes per lane where every row starts at a multiple of 16 bytes
  const bool vec = c % 4 == 0 && aligned16(q) && aligned16(k) && aligned16(v) &&
                   aligned16(g) && aligned16(dq);
  if (vec && c <= 16) DQ_LAUNCH(4, 4, 1);
  else if (vec && c <= 32) DQ_LAUNCH(4, 8, 1);
  else if (vec) DQ_LAUNCH(4, 16, 1);
  else DQ_LAUNCH(1, 32, 2);
#undef DQ_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

// The backward's key side.  q, g (b, h, n, c), the query side's p and ds, and
// the reverse lists offsets (b, ncl + 1), refs (b, n * nnc) with
// ncl = ceil(n / span) -> dk, dv (b, h, n, c), every element written.
extern "C" int aff_local_attn_bwd_dkv(const float* q, const float* g, const float* p,
                                      const float* ds, const int* offsets, const int* refs,
                                      float* dk, float* dv, int b, int h, int n, int c, int nnc,
                                      int span, void* stream_ptr) {
  if (nnc * span > kMaxSlots || c > kMaxC || nnc <= 0 || span <= 0 || c <= 0 ||
      !aligned16(p) || !aligned16(ds))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int ncl = (n + span - 1) / span;
  const long long groups = (long long)b * h * ncl;
#define DKV_LAUNCH(G, UNITS, ROWS, ROW8)                                                \
  local_attn_bwd_dkv_kernel<G, UNITS, ROWS, ROW8>                                       \
      <<<(unsigned)((groups * G + kDkvThreads - 1) / kDkvThreads), kDkvThreads, 0, stream>>>( \
          q, g, p, ds, offsets, refs, dk, dv, b, h, n, c, nnc, span, ncl)
  if (span == 8 && c <= 16) DKV_LAUNCH(16, 1, 8, true);
  else if (span == 8 && c <= 32) DKV_LAUNCH(32, 1, 8, true);
  else if (span == 8) DKV_LAUNCH(32, 2, 8, true);
  else DKV_LAUNCH(32, 2, 16, false);
#undef DKV_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

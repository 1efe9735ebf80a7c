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
// Design: one warp per (batch, query), looping over heads, so the geometry
// (neighbour indices and the five rel-pos features) is computed once and
// shared by every head from shared memory.  Lanes split the neighbour slots
// for q.k and the softmax (warp shuffles for max and sum), then split the
// channels for p.v, reading value rows coalesced.  The TPU kernel's
// 128-token blocks and visit lists exist for its (8,128) tiling and VMEM and
// are not carried over.
//
// Backward: the same warp-per-query sweep recomputes p_j = exp(s_j - lse_i)
// and ds_j = p_j (g_i . v_j - delta_i), delta_i = g_i . out_i + gb_i pb_i
// (precomputed by the wrapper), then writes dq_i = sum_j ds_j k_j and the
// per-query rel-pos partials drow_i = (sum_j ds_j feat_j[0..4], sum_j ds_j).
// A key token receives from every query whose neighbour clusters hold it (a
// fan-in that varies from token to token), so dk_j += ds_j q_i and
// dv_j += p_j g_i are scattered with atomicAdd from the query side instead
// of walking reverse row-block bounds as the TPU kernel does; lanes over the
// channels make each scatter one coalesced row of reductions.  What bounds
// it: those reductions in L2, 2 * nnc*span * c_ per query and head (~3e8 at
// stage 1 of a batch-8 512x512 step).  The blank
// sink's terms and the w5/b5/blank_k reductions stay in PyTorch, as they
// stay in XLA on the TPU.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kWarps = 4;
constexpr int kMaxSlots = 128;   // nnc * span
constexpr int kMaxC = 64;        // channels per head
constexpr float kRelPosWidth = 511.f;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__global__ void __launch_bounds__(kWarps * 32)
local_attn_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ pos,
                  const int* __restrict__ nc, const float* __restrict__ w5,
                  const float* __restrict__ b5, const float* __restrict__ blank_k,
                  float* __restrict__ out, float* __restrict__ blank_prob,
                  float* __restrict__ lse, int B, int H, int N, int C, int NNC, int SPAN) {
  __shared__ float s_feat[kWarps][5][kMaxSlots];
  __shared__ int s_key[kWarps][kMaxSlots];
  __shared__ float s_p[kWarps][kMaxSlots];
  __shared__ float s_q[kWarps][kMaxC];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + warp;  // over B*N
  if (row >= (long long)B * N) return;  // the whole warp leaves together
  const int bi = (int)(row / N);
  const int i = (int)(row % N);
  const int M = NNC * SPAN;

  // geometry shared by all heads
  const float* pb = pos + (size_t)bi * N * 2;
  const float qx = pb[2 * i];
  const float qy = pb[2 * i + 1];
  const int* nci = nc + ((size_t)bi * N + i) * NNC;
  for (int s = lane; s < M; s += 32) {
    const int j = nci[s / SPAN] * SPAN + s % SPAN;
    const bool valid = j >= 0 && j < N;
    float dx = 0.f, dy = 0.f, dist = 0.f, sn = 0.f, cs = 0.f;
    if (valid) {
      dx = fminf(fmaxf(pb[2 * j] - qx, -kRelPosWidth), kRelPosWidth);
      dy = fminf(fmaxf(pb[2 * j + 1] - qy, -kRelPosWidth), kRelPosWidth);
      dist = sqrtf(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)));
      if (dist > 0.f) {
        sn = dy / dist;
        cs = dx / dist;
      }
    }
    s_key[warp][s] = valid ? j : -1;
    s_feat[warp][0][s] = dx;
    s_feat[warp][1][s] = dy;
    s_feat[warp][2][s] = dist;
    s_feat[warp][3][s] = sn;
    s_feat[warp][4][s] = cs;
  }
  __syncwarp();

  for (int hh = 0; hh < H; ++hh) {
    const size_t head = (size_t)bi * H + hh;
    const float* qrow = q + (head * N + i) * C;
    for (int c = lane; c < C; c += 32) s_q[warp][c] = qrow[c];
    __syncwarp();

    const float* kh = k + head * N * C;
    const float* vh = v + head * N * C;
    const float w0 = w5[hh * 5 + 0], w1 = w5[hh * 5 + 1], w2 = w5[hh * 5 + 2];
    const float w3 = w5[hh * 5 + 3], w4 = w5[hh * 5 + 4], bb = b5[hh];

    float mx = -CUDART_INF_F;
    for (int s = lane; s < M; s += 32) {
      const int j = s_key[warp][s];
      float logit = -CUDART_INF_F;
      if (j >= 0) {
        const float* kr = kh + (size_t)j * C;
        float acc = 0.f;
        for (int c = 0; c < C; ++c) acc += s_q[warp][c] * kr[c];
        const float bias = s_feat[warp][0][s] * w0 + s_feat[warp][1][s] * w1 +
                           s_feat[warp][2][s] * w2 + s_feat[warp][3][s] * w3 +
                           s_feat[warp][4][s] * w4 + bb;
        logit = acc + bias;
      }
      s_p[warp][s] = logit;
      mx = fmaxf(mx, logit);
    }
    float bl = 0.f;
    for (int c = lane; c < C; c += 32) bl += s_q[warp][c] * blank_k[hh * C + c];
    bl = warp_sum(bl);
    mx = fmaxf(warp_max(mx), bl);

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

    float* orow = out + (head * N + i) * C;
    for (int c = lane; c < C; c += 32) {
      float acc = 0.f;
      for (int s = 0; s < M; ++s) {
        const int j = s_key[warp][s];
        if (j >= 0) acc += s_p[warp][s] * vh[(size_t)j * C + c];
      }
      orow[c] = acc * inv;
    }
    if (lane == 0) {
      blank_prob[head * N + i] = pblank * inv;
      lse[head * N + i] = mx + logf(total);
    }
    __syncwarp();  // s_q / s_p are rewritten by the next head
  }
}

__global__ void __launch_bounds__(kWarps * 32)
local_attn_bwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ pos,
                      const int* __restrict__ nc, const float* __restrict__ w5,
                      const float* __restrict__ b5, const float* __restrict__ g,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      float* __restrict__ dq, float* __restrict__ dk,
                      float* __restrict__ dv, float* __restrict__ drow,
                      int B, int H, int N, int C, int NNC, int SPAN) {
  __shared__ float s_feat[kWarps][5][kMaxSlots];
  __shared__ int s_key[kWarps][kMaxSlots];
  __shared__ float s_p[kWarps][kMaxSlots];
  __shared__ float s_ds[kWarps][kMaxSlots];
  __shared__ float s_q[kWarps][kMaxC];
  __shared__ float s_g[kWarps][kMaxC];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + warp;
  if (row >= (long long)B * N) return;
  const int bi = (int)(row / N);
  const int i = (int)(row % N);
  const int M = NNC * SPAN;

  const float* pb = pos + (size_t)bi * N * 2;
  const float qx = pb[2 * i];
  const float qy = pb[2 * i + 1];
  const int* nci = nc + ((size_t)bi * N + i) * NNC;
  for (int s = lane; s < M; s += 32) {  // the forward's geometry, recomputed
    const int j = nci[s / SPAN] * SPAN + s % SPAN;
    const bool valid = j >= 0 && j < N;
    float dx = 0.f, dy = 0.f, dist = 0.f, sn = 0.f, cs = 0.f;
    if (valid) {
      dx = fminf(fmaxf(pb[2 * j] - qx, -kRelPosWidth), kRelPosWidth);
      dy = fminf(fmaxf(pb[2 * j + 1] - qy, -kRelPosWidth), kRelPosWidth);
      dist = sqrtf(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)));
      if (dist > 0.f) {
        sn = dy / dist;
        cs = dx / dist;
      }
    }
    s_key[warp][s] = valid ? j : -1;
    s_feat[warp][0][s] = dx;
    s_feat[warp][1][s] = dy;
    s_feat[warp][2][s] = dist;
    s_feat[warp][3][s] = sn;
    s_feat[warp][4][s] = cs;
  }
  __syncwarp();

  for (int hh = 0; hh < H; ++hh) {
    const size_t head = (size_t)bi * H + hh;
    const size_t qi = head * N + i;
    for (int c = lane; c < C; c += 32) {
      s_q[warp][c] = q[qi * C + c];
      s_g[warp][c] = g[qi * C + c];
    }
    __syncwarp();

    const float* kh = k + head * N * C;
    const float* vh = v + head * N * C;
    const float w0 = w5[hh * 5 + 0], w1 = w5[hh * 5 + 1], w2 = w5[hh * 5 + 2];
    const float w3 = w5[hh * 5 + 3], w4 = w5[hh * 5 + 4], bb = b5[hh];
    const float lse_i = lse[qi];
    const float delta_i = delta[qi];

    float part[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int s = lane; s < M; s += 32) {
      const int j = s_key[warp][s];
      float p = 0.f, ds = 0.f;
      if (j >= 0) {
        const float* kr = kh + (size_t)j * C;
        const float* vr = vh + (size_t)j * C;
        float qk = 0.f, gv = 0.f;
        for (int c = 0; c < C; ++c) {
          qk += s_q[warp][c] * kr[c];
          gv += s_g[warp][c] * vr[c];
        }
        const float bias = s_feat[warp][0][s] * w0 + s_feat[warp][1][s] * w1 +
                           s_feat[warp][2][s] * w2 + s_feat[warp][3][s] * w3 +
                           s_feat[warp][4][s] * w4 + bb;
        p = expf(qk + bias - lse_i);
        ds = p * (gv - delta_i);
#pragma unroll
        for (int f = 0; f < 5; ++f) part[f] += ds * s_feat[warp][f][s];
        part[5] += ds;
      }
      s_p[warp][s] = p;
      s_ds[warp][s] = ds;
    }
#pragma unroll
    for (int f = 0; f < 6; ++f) part[f] = warp_sum(part[f]);
    if (lane < 8) {
      float val = 0.f;
#pragma unroll
      for (int f = 0; f < 6; ++f) val = lane == f ? part[f] : val;
      drow[qi * 8 + lane] = val;
    }
    __syncwarp();

    for (int c = lane; c < C; c += 32) {
      const float qc = s_q[warp][c];
      const float gc = s_g[warp][c];
      float acc = 0.f;
      for (int s = 0; s < M; ++s) {
        const int j = s_key[warp][s];
        if (j < 0) continue;
        const float ds = s_ds[warp][s];
        acc += ds * kh[(size_t)j * C + c];
        atomicAdd(dk + (head * N + j) * C + c, ds * qc);
        atomicAdd(dv + (head * N + j) * C + c, s_p[warp][s] * gc);
      }
      dq[qi * C + c] = acc;
    }
    __syncwarp();  // s_q / s_g / s_p / s_ds are rewritten by the next head
  }
}

}  // namespace

// q/k/v (b, h, n, c) f32; pos (b, n, 2) f32; nc (b, n, nnc) i32; w5 (h, 5);
// b5 (h); blank_k (h, c) -> out (b, h, n, c), blank_prob (b, h, n, 1),
// lse (b, h, n, 1)
extern "C" int aff_local_attn(const float* q, const float* k, const float* v,
                              const float* pos, const int* nc, const float* w5,
                              const float* b5, const float* blank_k, float* out,
                              float* blank_prob, float* lse, int b, int h, int n,
                              int c, int nnc, int span, void* stream_ptr) {
  if (nnc * span > kMaxSlots || c > kMaxC || nnc * span <= 0 || c <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = (long long)b * n;
  const unsigned blocks = (unsigned)((rows + kWarps - 1) / kWarps);
  local_attn_kernel<<<blocks, kWarps * 32, 0, static_cast<cudaStream_t>(stream_ptr)>>>(
      q, k, v, pos, nc, w5, b5, blank_k, out, blank_prob, lse, b, h, n, c, nnc, span);
  return static_cast<int>(cudaGetLastError());
}

// The forward's operands plus g (b, h, n, c) = d out, lse and delta
// (b, h, n, 1) -> dq (b, h, n, c) without the blank term, drow (b, h, n, 8),
// and dk, dv (b, h, n, c), which must arrive zeroed (atomic scatter).
extern "C" int aff_local_attn_bwd(const float* q, const float* k, const float* v,
                                  const float* pos, const int* nc, const float* w5,
                                  const float* b5, const float* g, const float* lse,
                                  const float* delta, float* dq, float* dk, float* dv,
                                  float* drow, int b, int h, int n, int c, int nnc,
                                  int span, void* stream_ptr) {
  if (nnc * span > kMaxSlots || c > kMaxC || nnc * span <= 0 || c <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = (long long)b * n;
  const unsigned blocks = (unsigned)((rows + kWarps - 1) / kWarps);
  local_attn_bwd_kernel<<<blocks, kWarps * 32, 0, static_cast<cudaStream_t>(stream_ptr)>>>(
      q, k, v, pos, nc, w5, b5, g, lse, delta, dq, dk, dv, drow, b, h, n, c, nnc, span);
  return static_cast<int>(cudaGetLastError());
}

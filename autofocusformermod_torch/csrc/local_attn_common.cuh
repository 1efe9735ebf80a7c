// Device functions shared by the local_attn kernels (csrc/local_attn.cu):
// the limits, the warp and lane-group reductions, the neighbourhood geometry
// of one query, and the coalesced read of a key or value row (which the
// msdetrpc backward, csrc/msdetrpc.cu, uses for its value rows too).
//
// A head's rows lie C floats apart in the (b, h, n, c_) layout and tokens are
// sorted along the curve, so the span rows of one neighbour cluster are one
// contiguous run of span * c_ * 4 bytes.  A warp therefore reads rows with
// LPR lanes per row, VEC floats (16 bytes where c_ is a multiple of 4 and the
// tensors start at a multiple of 16 bytes, else 4) per lane: 32 / LPR rows
// and up to 512 contiguous bytes per load instruction, every sector used in
// full.  A lane-per-row walk with 4-byte loads, by contrast, touches up to 32
// lines per instruction and uses 4 bytes of each.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace local_attn {

// nnc * span, the slots of one query's neighbourhood: the kernels that stage
// them in shared memory are built for two bounds and the wrapper takes the
// smaller that holds them, so the 48-slot neighbourhoods of most models keep
// the blocks (and the occupancy) of a 128-slot table, and only AFF-Base's 6
// clusters of 24 pay for 144 (the backward's query side: 36.9 KB of shared
// memory a block for 128 slots, 41.5 KB for 144).
constexpr int kSlotsSmall = 128;
constexpr int kMaxSlots = 144;
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

// Sum over each group of LPR consecutive lanes (LPR a power of two); every
// lane of the warp must call it, and every lane of a group gets the sum.
template <int LPR>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = LPR / 2; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Sum over the lanes that hold the same place in their groups of LPR lanes
// (the 32 / LPR rows of one load instruction).
template <int LPR>
__device__ __forceinline__ float across_groups_sum(float x) {
#pragma unroll
  for (int o = LPR; o < 32; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// VEC consecutive floats of a row: one 16-byte load where VEC is 4.
template <int VEC>
__device__ __forceinline__ void load_unit(const float* __restrict__ src, float (&dst)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 t = *reinterpret_cast<const float4*>(src);
    dst[0] = t.x; dst[1] = t.y; dst[2] = t.z; dst[3] = t.w;
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e) dst[e] = src[e];
  }
}

template <int VEC>
__device__ __forceinline__ void store_unit(float* __restrict__ dst, const float (&src)[VEC]) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(dst) = make_float4(src[0], src[1], src[2], src[3]);
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e) dst[e] = src[e];
  }
}

// The neighbourhood of query i, by one warp: slot s = t * span + r is token
// nc[i, t] * span + r, valid iff that index lies in [0, n).  key[s] gets the
// token index or -1, feat[f][s] the five rel-pos features (dx, dy clipped to
// +-511, dist, sin, cos; all zero for an invalid slot and for (0, 0)), with
// sqrtf and IEEE division as the plain path's rel_pos_features.  The caller
// runs __syncwarp() before it reads the tables.
template <int SLOTS>
__device__ __forceinline__ void neighbourhood(const float* __restrict__ pos_b,
                                              const int* __restrict__ nc_i, int i, int n,
                                              int nnc, int span, int lane, int* key,
                                              float (*feat)[SLOTS]) {
  const float qx = pos_b[2 * i];
  const float qy = pos_b[2 * i + 1];
  const int m = nnc * span;
  for (int s = lane; s < m; s += 32) {
    const int j = nc_i[s / span] * span + s % span;
    const bool valid = j >= 0 && j < n;
    float dx = 0.f, dy = 0.f, dist = 0.f, sn = 0.f, cs = 0.f;
    if (valid) {
      dx = fminf(fmaxf(pos_b[2 * j] - qx, -kRelPosWidth), kRelPosWidth);
      dy = fminf(fmaxf(pos_b[2 * j + 1] - qy, -kRelPosWidth), kRelPosWidth);
      dist = sqrtf(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)));
      if (dist > 0.f) {
        sn = dy / dist;
        cs = dx / dist;
      }
    }
    key[s] = valid ? j : -1;
    feat[0][s] = dx;
    feat[1][s] = dy;
    feat[2][s] = dist;
    feat[3][s] = sn;
    feat[4][s] = cs;
  }
}

}  // namespace local_attn

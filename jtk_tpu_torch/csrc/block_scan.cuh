// Block-wide scans over the band lanes of one pair.
//
// One block holds one pair; thread k holds band lane k.  The block has
// ceil(W / 32) full warps; lanes k >= W are padding that feeds the scans
// their identity and never touches memory.
#pragma once

#include <cuda_runtime.h>

#define FULL_MASK 0xffffffffu

// Inclusive prefix min over lanes 0..k (int).  ``tmp`` holds one int per
// warp.  Every thread of the block must call it.
__device__ __forceinline__ int block_prefix_min(int v, int* tmp) {
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  for (int s = 1; s < 32; s <<= 1) {
    int o = __shfl_up_sync(FULL_MASK, v, s);
    if (lane >= s) v = min(v, o);
  }
  if (lane == 31) tmp[wid] = v;
  __syncthreads();
  if (wid == 0) {
    int t = lane < nw ? tmp[lane] : 0x7fffffff;
    for (int s = 1; s < 32; s <<= 1) {
      int o = __shfl_up_sync(FULL_MASK, t, s);
      if (lane >= s) t = min(t, o);
    }
    if (lane < nw) tmp[lane] = t;
  }
  __syncthreads();
  if (wid > 0) v = min(v, tmp[wid - 1]);
  __syncthreads();
  return v;
}

// Inclusive prefix max over lanes 0..k (int).
__device__ __forceinline__ int block_prefix_max(int v, int* tmp) {
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  for (int s = 1; s < 32; s <<= 1) {
    int o = __shfl_up_sync(FULL_MASK, v, s);
    if (lane >= s) v = max(v, o);
  }
  if (lane == 31) tmp[wid] = v;
  __syncthreads();
  if (wid == 0) {
    int t = lane < nw ? tmp[lane] : -0x7fffffff;
    for (int s = 1; s < 32; s <<= 1) {
      int o = __shfl_up_sync(FULL_MASK, t, s);
      if (lane >= s) t = max(t, o);
    }
    if (lane < nw) tmp[lane] = t;
  }
  __syncthreads();
  if (wid > 0) v = max(v, tmp[wid - 1]);
  __syncthreads();
  return v;
}

// Block sum / max of one float per lane (padding lanes pass 0).
// ``tmp`` holds one float per warp; the result is returned to every thread.
__device__ __forceinline__ float block_sum(float v, float* tmp) {
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  for (int s = 16; s > 0; s >>= 1) v += __shfl_xor_sync(FULL_MASK, v, s);
  if (lane == 0) tmp[wid] = v;
  __syncthreads();
  float t = 0.f;
  for (int w = 0; w < nw; ++w) t += tmp[w];
  __syncthreads();
  return t;
}

__device__ __forceinline__ float block_max(float v, float* tmp) {
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  for (int s = 16; s > 0; s >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL_MASK, v, s));
  if (lane == 0) tmp[wid] = v;
  __syncthreads();
  float t = tmp[0];
  for (int w = 1; w < nw; ++w) t = fmaxf(t, tmp[w]);
  __syncthreads();
  return t;
}

// First-order linear recurrence y[k] = c[k] + a * y[k-1] (y[-1] = 0) along
// the lanes, as an inclusive scan of the pairs (A, y) under
// (a1, y1) o (a2, y2) = (a1 a2, a2 y1 + y2): a shuffle scan inside each
// warp, then each warp folds in the prefix of the warps before it.
// ``ys``/``as`` hold one float per warp.  Padding lanes pass c = 0.
__device__ __forceinline__ float block_linrec_fwd(float c, float a,
                                                  float* ys, float* as) {
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  float y = c, A = a;
  for (int s = 1; s < 32; s <<= 1) {
    float yo = __shfl_up_sync(FULL_MASK, y, s);
    float ao = __shfl_up_sync(FULL_MASK, A, s);
    if (lane >= s) { y = y + A * yo; A = A * ao; }
  }
  if (lane == 31) { ys[wid] = y; as[wid] = A; }
  __syncthreads();
  if (wid == 0) {
    float ty = lane < nw ? ys[lane] : 0.f;
    float ta = lane < nw ? as[lane] : 1.f;
    for (int s = 1; s < 32; s <<= 1) {
      float yo = __shfl_up_sync(FULL_MASK, ty, s);
      float ao = __shfl_up_sync(FULL_MASK, ta, s);
      if (lane >= s) { ty = ty + ta * yo; ta = ta * ao; }
    }
    if (lane < nw) ys[lane] = ty;
  }
  __syncthreads();
  if (wid > 0) y = y + A * ys[wid - 1];
  __syncthreads();
  return y;
}

// Mirror: y[k] = c[k] + a * y[k+1] (y[W] = 0), a suffix scan under
// (a1, y1) o (a2, y2) = (a1 a2, y1 + a1 y2).  Padding lanes (the highest
// ones) pass c = 0, which makes them read as y = 0.
__device__ __forceinline__ float block_linrec_rev(float c, float a,
                                                  float* ys, float* as) {
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  float y = c, A = a;
  for (int s = 1; s < 32; s <<= 1) {
    float yo = __shfl_down_sync(FULL_MASK, y, s);
    float ao = __shfl_down_sync(FULL_MASK, A, s);
    if (lane + s < 32) { y = y + A * yo; A = A * ao; }
  }
  if (lane == 0) { ys[wid] = y; as[wid] = A; }
  __syncthreads();
  if (wid == 0) {
    float ty = lane < nw ? ys[lane] : 0.f;
    float ta = lane < nw ? as[lane] : 1.f;
    for (int s = 1; s < 32; s <<= 1) {
      float yo = __shfl_down_sync(FULL_MASK, ty, s);
      float ao = __shfl_down_sync(FULL_MASK, ta, s);
      if (lane + s < 32) { ty = ty + ta * yo; ta = ta * ao; }
    }
    if (lane < nw) ys[lane] = ty;
  }
  __syncthreads();
  if (wid + 1 < nw) y = y + A * ys[wid + 1];
  __syncthreads();
  return y;
}

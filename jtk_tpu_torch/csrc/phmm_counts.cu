// Expected counts of the banded 3-state pair-HMM: the gradient of lk.
//
// jtk_tpu computes this gradient with jax.value_and_grad through the
// forward scan (jtk_tpu/parallel/__init__.py::make_train_step); no Pallas
// kernel is involved.  The port computes it in closed form from the K1
// forward and backward tables (phmm_tables.cu): lk is a polynomial in the
// parameters, so d lk / d p_x = E[n_x] / p_x, and this kernel writes the
// expected counts E[n_x] of each pair, (B, 45):
//   [0, 9)   transitions [from, to] (M=0, I=1, D=2): into M at (i, j) from
//            (i-1, j-1), into I at (i, j) from (i-1, j), into D at (i, j)
//            from (i, j-1) (row 0's M->D / D->D chain included);
//   [9, 25)  mat_emit[ref, query] from the M posteriors;
//   [25, 45) ins_emit[prev query or 4 = start, query] from the I posteriors.
// With true f(i, j) = F[i, k] * exp(fcum[i]) and b(i, j) = B[i, k] *
// exp(bcum[i]) (j = off[i] + k), an edge into row i weighs
// exp(fcum[i-1] + bcum[i] - lk) and a cell of row i exp(fcum[i] + bcum[i]
// - lk).  Each weight goes half to the forward and half to the backward
// value (exp(c / 2), c / 2 capped at 88): whole, it passes float32's range
// where F * B is tiny, and 0 * inf would make the counts NaN.  Rows past
// q_len carry no counts.
//
// Bound on the H100: bytes, the six (Q+1, W) f32 tables and the template
// chars read once, 28 bytes a cell (~290 MB at B = 40, Q = 2048, W = 128);
// ~60 flops a cell.  No count depends on another row's: a row reads the
// stored tables at rows i and i - 1 and its left neighbour, so the work is
// a parallel reduction over (B, Q+1, W).
//
// Design: a memory-bound reduction without block barriers or atomics.
// - Pass 1 (counts_partial_kernel): one warp per unit of (pair, strip of
//   STRIP rows, chunk of CHUNK = 128 band lanes); 4 lanes a thread, read
//   with 16-byte loads coalesced along W (4-byte loads when W % 4 != 0).
//   The warp walks its strip, keeping row i - 1's forward values in
//   registers (one halo row at the strip's top); the neighbour lanes come
//   by shuffle, and at the chunk's two edges by one scalar load.  The
//   row's scales s_in and s_row, the query codes and the insertion emission
//   are computed once a row, by one lane of the strip's row streams.  The
//   9 transition counts accumulate in registers; a row's M posteriors by
//   ref code and its I posterior are warp sums kept by the lane of the
//   row's streams, which bins them by the row's (ref, query) and (prev
//   query, query) codes after the loop.  Each of the 45 counts is then a
//   warp butterfly sum, written as the unit's partial into a scratch
//   tensor.
// - Pass 2 (counts_final_kernel): one block per pair sums its units'
//   partials in index order and scales the transition counts by their
//   probabilities (taken out of the row sums).
// Every sum runs in a fixed order, so the counts, and model tuning's
// fitted HMMs, are identical from run to run.
#include <cstdint>

#include <cuda_runtime.h>

#ifndef FULL_MASK
#define FULL_MASK 0xffffffffu
#endif

constexpr int NC = 45;
constexpr int CHUNK = 128;   // band lanes of a unit: 32 threads x 4
constexpr int STRIP = 16;    // rows of a unit (<= 32: one lane a row)
constexpr int WARPS = 4;     // units a block
constexpr int MAX_W = 2048;
constexpr int GEOMETRY_ERROR = -2;

// 4 consecutive floats of a row from lane k0 (0 at lanes >= W).
template <bool VEC>
__device__ __forceinline__ float4 load4(const float* __restrict__ row, int k0,
                                        int W) {
  if constexpr (VEC) {
    return k0 < W ? *reinterpret_cast<const float4*>(row + k0)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
    return make_float4(k0 < W ? row[k0] : 0.f, k0 + 1 < W ? row[k0 + 1] : 0.f,
                       k0 + 2 < W ? row[k0 + 2] : 0.f,
                       k0 + 3 < W ? row[k0 + 3] : 0.f);
  }
}

template <bool VEC>
__device__ __forceinline__ int4 load4i(const int32_t* __restrict__ row,
                                       int k0, int W) {
  if constexpr (VEC) {
    return k0 < W ? *reinterpret_cast<const int4*>(row + k0)
                  : make_int4(4, 4, 4, 4);
  } else {
    return make_int4(k0 < W ? row[k0] : 4, k0 + 1 < W ? row[k0 + 1] : 4,
                     k0 + 2 < W ? row[k0 + 2] : 4,
                     k0 + 3 < W ? row[k0 + 3] : 4);
  }
}

__device__ __forceinline__ void unpack(float4 v, float (&x)[4]) {
  x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) v += __shfl_xor_sync(FULL_MASK, v, s);
  return v;
}

template <bool VEC>
__global__ void __launch_bounds__(32 * WARPS)
counts_partial_kernel(
    const float* __restrict__ fM, const float* __restrict__ fI,
    const float* __restrict__ fD, const float* __restrict__ bM,
    const float* __restrict__ bI, const float* __restrict__ bD,
    const float* __restrict__ fcum, const float* __restrict__ bcum,
    const int32_t* __restrict__ rcs, const int32_t* __restrict__ qs,
    const int32_t* __restrict__ shifts, const int32_t* __restrict__ qlen,
    const float* __restrict__ lk, const float* __restrict__ me,
    const float* __restrict__ ie, float* __restrict__ part, int B, int Q,
    int W, int strips, int chunks) {
  // me transposed, [query][ref]: a lane reads its ref code's emission of the
  // row's query code without bank conflicts
  __shared__ float me_t[64];
  if (threadIdx.x < 64) me_t[threadIdx.x] = me[(threadIdx.x & 7) * 8 +
                                               (threadIdx.x >> 3)];
  __syncthreads();   // once, before any row
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int unit = blockIdx.x * WARPS + warp;
  const int per_pair = strips * chunks;
  if (unit >= B * per_pair) return;
  const int b = unit / per_pair;
  const int strip = (unit - b * per_pair) / chunks;
  const int chunk = unit - b * per_pair - strip * chunks;
  const int ql = min(max(qlen[b], 0), Q);
  const int i0 = strip * STRIP;
  const int i1 = min(i0 + STRIP, ql + 1);   // rows 0..q_len carry counts
  const int k0 = chunk * CHUNK + lane * 4;
  const size_t Q1 = (size_t)Q + 1;
  const size_t tb = (size_t)b * Q1 * W;

  float acc[NC];
#pragma unroll
  for (int x = 0; x < NC; ++x) acc[x] = 0.f;
  // lane s: row i0 + s's M posteriors by ref code and I posterior, summed
  // over the chunk (binned by the row's query codes after the loop)
  float em_row[4] = {0.f, 0.f, 0.f, 0.f}, ie_row = 0.f;
  int qc = 4, qp = 4;
  if (i0 < i1) {
    // the strip's row streams: lane s holds row i0 + s; s_in and s_row are
    // the halves of the weights of an edge into the row and of its cells
    float s_in = 0.f, s_row = 0.f, ei = 0.f;
    int one = 0;
    {
      const int i = i0 + lane;
      if (lane < STRIP && i < i1) {
        const float lkb = lk[b];
        const float* fc = fcum + (size_t)b * Q1;
        const float* bc = bcum + (size_t)b * Q1;
        s_row = expf(fminf(0.5f * (fc[i] + bc[i] - lkb), 88.f));
        if (i >= 1) {
          const int32_t* q = qs + (size_t)b * Q;
          s_in = expf(fminf(0.5f * (fc[i - 1] + bc[i] - lkb), 88.f));
          qc = min(max(q[i - 1], 0), 7);
          qp = i >= 2 ? min(max(q[i - 2], 0), 7) : 4;
          one = shifts[(size_t)b * Q + i - 1] == 1;
          ei = ie[qp * 8 + qc];
        }
      }
    }
    // row i0 - 1's forward values (0 above row 0), and its lane k0 - 1
    float P[3][4] = {}, pl[3] = {0.f, 0.f, 0.f};
    const float* const F[3] = {fM + tb, fI + tb, fD + tb};
    if (i0 > 0) {
      const size_t o = (size_t)(i0 - 1) * W;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        unpack(load4<VEC>(F[a] + o, k0, W), P[a]);
        if (lane == 0 && k0 > 0) pl[a] = F[a][o + k0 - 1];
      }
    }
    for (int i = i0; i < i1; ++i) {
      const int s = i - i0;
      const float r_in = __shfl_sync(FULL_MASK, s_in, s);
      const float r_row = __shfl_sync(FULL_MASK, s_row, s);
      const float r_ei = __shfl_sync(FULL_MASK, ei, s);
      const int r_qc = __shfl_sync(FULL_MASK, qc, s);
      const int r_one = __shfl_sync(FULL_MASK, one, s);
      const size_t o = (size_t)i * W;
      float C[3][4], V[3][4];
      unpack(load4<VEC>(fM + tb + o, k0, W), C[0]);
      unpack(load4<VEC>(fI + tb + o, k0, W), C[1]);
      unpack(load4<VEC>(fD + tb + o, k0, W), C[2]);
      unpack(load4<VEC>(bM + tb + o, k0, W), V[0]);
      unpack(load4<VEC>(bI + tb + o, k0, W), V[1]);
      unpack(load4<VEC>(bD + tb + o, k0, W), V[2]);
      const int4 r4 = load4i<VEC>(rcs + tb + o, k0, W);
      const int R[4] = {r4.x, r4.y, r4.z, r4.w};
      // the chunk's edges: row i's lane k0 - 1, row i - 1's lane k0 + 4
      float cl[3] = {0.f, 0.f, 0.f}, pr[3] = {0.f, 0.f, 0.f};
      if (lane == 0 && k0 > 0) {
#pragma unroll
        for (int a = 0; a < 3; ++a) cl[a] = F[a][o + k0 - 1];
      }
      if (lane == 31 && i > 0 && k0 + 4 < W) {
#pragma unroll
        for (int a = 0; a < 3; ++a) pr[a] = F[a][o - W + k0 + 4];
      }
      float Xl[3], Xr[3], Cl[3];   // lanes k0 - 1 (rows i-1, i), k0 + 4 (i-1)
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        Xl[a] = __shfl_up_sync(FULL_MASK, P[a][3], 1);
        Xr[a] = __shfl_down_sync(FULL_MASK, P[a][0], 1);
        Cl[a] = __shfl_up_sync(FULL_MASK, C[a][3], 1);
        if (lane == 0) { Xl[a] = pl[a]; Cl[a] = cl[a]; }
        if (lane == 31) Xr[a] = pr[a];
      }
      const float s_post = i >= 1 ? r_row : 0.f;
      float pm[4] = {0.f, 0.f, 0.f, 0.f}, pi = 0.f;
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        // each side takes its half of the weight: the forward value the
        // source's (xd, xu times r_in; xl times r_row), the backward one
        // the target's (gM, gI times r_in; gD times r_row)
        const float em = me_t[r_qc * 8 + (R[l] & 7)];
        const float gM = em * V[0][l] * r_in;
        const float gI = r_ei * V[1][l] * r_in;
        const float gD = V[2][l] * r_row;
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          // sources: diagonal (i-1, j-1), up (i-1, j), left (i, j-1)
          const float pd = l > 0 ? P[a][l - 1] : Xl[a];
          const float pu = l < 3 ? P[a][l + 1] : Xr[a];
          const float xd = (r_one ? P[a][l] : pd) * r_in;
          const float xu = (r_one ? pu : P[a][l]) * r_in;
          const float xl = (l > 0 ? C[a][l - 1] : Cl[a]) * r_row;
          acc[3 * a] = fmaf(xd, gM, acc[3 * a]);
          acc[3 * a + 1] = fmaf(xu, gI, acc[3 * a + 1]);
          acc[3 * a + 2] = fmaf(xl, gD, acc[3 * a + 2]);
        }
        const float post_m = (C[0][l] * r_row) * (V[0][l] * s_post);
#pragma unroll
        for (int c = 0; c < 4; ++c) pm[c] += R[l] == c ? post_m : 0.f;
        pi = fmaf(C[1][l] * r_row, V[1][l] * s_post, pi);
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float v = warp_sum(pm[c]);
        if (lane == s) em_row[c] = v;
      }
      const float v = warp_sum(pi);
      if (lane == s) ie_row = v;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        pl[a] = Cl[a];
#pragma unroll
        for (int l = 0; l < 4; ++l) P[a][l] = C[a][l];
      }
    }
  }
  // emission counts: each lane's row into the bins of its query codes
#pragma unroll
  for (int q = 0; q < 4; ++q) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[9 + 4 * c + q] = qc == q ? em_row[c] : 0.f;
#pragma unroll
    for (int p = 0; p < 5; ++p)
      acc[25 + 4 * p + q] = qc == q && qp == p ? ie_row : 0.f;
  }
  // the unit's partial: lane x < 32 writes count x, lane x < 13 count 32 + x
  float lo = 0.f, hi = 0.f;
#pragma unroll
  for (int x = 0; x < NC; ++x) {
    const float v = warp_sum(acc[x]);
    if (x < 32) lo = lane == x ? v : lo;
    else hi = lane == x - 32 ? v : hi;
  }
  float* dst = part + (size_t)unit * NC;
  dst[lane] = lo;
  if (lane < NC - 32) dst[32 + lane] = hi;
}

// Pass 2: a pair's counts, its units' partials summed in index order; the
// transition counts times their probabilities.
__global__ void counts_final_kernel(const float* __restrict__ part,
                                    const float* __restrict__ trans,
                                    float* __restrict__ out, int per_pair) {
  const int b = blockIdx.x, x = threadIdx.x;
  if (x >= NC) return;
  const float* p = part + (size_t)b * per_pair * NC + x;
  float s = 0.f;
  for (int u = 0; u < per_pair; ++u) s += p[(size_t)u * NC];
  if (x < 9) s *= trans[(x / 3) * 8 + x % 3];
  out[(size_t)b * NC + x] = s;
}

// ``part`` is scratch of B * units * 45 floats, ``units`` the units a pair
// has (ops/phmm_grad.py::counts_geometry).  Returns 0, a CUDA error code, or
// GEOMETRY_ERROR when the caller's geometry is not this library's.
extern "C" int phmm_counts_launch(
    const float* fM, const float* fI, const float* fD, const float* bM,
    const float* bI, const float* bD, const float* fcum, const float* bcum,
    const int32_t* rcs, const int32_t* qs, const int32_t* shifts,
    const int32_t* qlen, const float* lk, const float* trans, const float* me,
    const float* ie, float* part, float* out, int B, int Q, int W, int units,
    int vec, void* stream) {
  if (B == 0) return 0;
  const int strips = (Q + 1 + STRIP - 1) / STRIP;
  const int chunks = (W + CHUNK - 1) / CHUNK;
  if (W < 1 || W > MAX_W || units != strips * chunks || (vec && W % 4))
    return GEOMETRY_ERROR;
  cudaStream_t s = (cudaStream_t)stream;
  const int grid = (B * units + WARPS - 1) / WARPS;
  if (vec)
    counts_partial_kernel<true><<<grid, 32 * WARPS, 0, s>>>(
        fM, fI, fD, bM, bI, bD, fcum, bcum, rcs, qs, shifts, qlen, lk, me, ie,
        part, B, Q, W, strips, chunks);
  else
    counts_partial_kernel<false><<<grid, 32 * WARPS, 0, s>>>(
        fM, fI, fD, bM, bI, bD, fcum, bcum, rcs, qs, shifts, qlen, lk, me, ie,
        part, B, Q, W, strips, chunks);
  counts_final_kernel<<<B, 64, 0, s>>>(part, trans, out, units);
  return (int)cudaGetLastError();
}

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
// - lk).  Rows past q_len carry no counts.
//
// Design: one block per pair, one thread per band lane (blockDim = W
// rounded up to a warp; W <= 1024).  Each thread walks rows 0..q_len,
// reading its lane of the six tables, getting the previous row's and its
// left neighbour's forward values through shared memory, and adds into 45
// register accumulators.  At the end each count is a block sum in a fixed
// order (warp xor-shuffle, then the warps in order): no float atomics, so
// the result is the same from run to run.
//
// Bound on the H100: reading the six tables and the template chars, 7 * 4
// bytes per cell (~300 MB at B = 40, Q = 2112, W = 128); ~60 flops per cell.
#include <cstdint>

#include "block_scan.cuh"

#define NC 45

__global__ void phmm_counts_kernel(
    const float* __restrict__ fM, const float* __restrict__ fI,
    const float* __restrict__ fD, const float* __restrict__ bM,
    const float* __restrict__ bI, const float* __restrict__ bD,
    const float* __restrict__ fcum, const float* __restrict__ bcum,
    const int32_t* __restrict__ rcs, const int32_t* __restrict__ qs,
    const int32_t* __restrict__ shifts, const int32_t* __restrict__ qlen,
    const float* __restrict__ lk, const float* __restrict__ trans,
    const float* __restrict__ me, const float* __restrict__ ie,
    float* __restrict__ out, int B, int Q, int W) {
  extern __shared__ float csm[];
  float* pm = csm;                // previous row, blockDim.x each
  float* pi = pm + blockDim.x;
  float* pd = pi + blockDim.x;
  float* cm = pd + blockDim.x;    // current row
  float* ci = cm + blockDim.x;
  float* cd = ci + blockDim.x;
  float* ys = cd + blockDim.x;    // 32
  float* me_s = ys + 32;          // 64
  float* ie_s = me_s + 64;        // 64

  const int b = blockIdx.x;
  const int k = threadIdx.x;
  const bool lane = k < W;
  for (int x = k; x < 64; x += blockDim.x) {
    me_s[x] = me[x];
    ie_s[x] = ie[x];
  }
  const float tmm = trans[0], tmi = trans[1], tmd = trans[2];
  const float tim = trans[8], tii = trans[9], tid = trans[10];
  const float tdm = trans[16], tdi = trans[17], tdd = trans[18];
  const int ql = qlen[b] < Q ? qlen[b] : Q;
  const float lkb = lk[b];
  const size_t Q1 = (size_t)Q + 1;
  const size_t tb = (size_t)b * Q1 * W;
  const float* fc = fcum + (size_t)b * Q1;
  const float* bc = bcum + (size_t)b * Q1;
  const int32_t* qrow = qs + (size_t)b * Q;
  const int32_t* srow = shifts + (size_t)b * Q;

  float acc[NC];
#pragma unroll
  for (int x = 0; x < NC; ++x) acc[x] = 0.f;

  // row 0: only the in-row D edges (M at j = 0, the D chain)
  float xm = lane ? fM[tb + k] : 0.f;
  float xi = lane ? fI[tb + k] : 0.f;
  float xd = lane ? fD[tb + k] : 0.f;
  {
    const float gD = (lane ? bD[tb + k] : 0.f) * expf(fc[0] + bc[0] - lkb);
    cm[k] = xm; ci[k] = xi; cd[k] = xd;
    __syncthreads();
    const float lm = k > 0 ? cm[k - 1] : 0.f;
    const float li = k > 0 ? ci[k - 1] : 0.f;
    const float ld = k > 0 ? cd[k - 1] : 0.f;
    __syncthreads();
    acc[2] += tmd * lm * gD;
    acc[5] += tid * li * gD;
    acc[8] += tdd * ld * gD;
  }

  for (int i = 1; i <= ql; ++i) {
    const bool one = srow[i - 1] == 1;
    const int qc = qrow[i - 1];
    const int qp = i >= 2 ? qrow[i - 2] : 4;
    const size_t o = tb + (size_t)i * W + k;
    const float fm = lane ? fM[o] : 0.f;
    const float fi = lane ? fI[o] : 0.f;
    const float fd = lane ? fD[o] : 0.f;
    const float vm = lane ? bM[o] : 0.f;
    const float vi = lane ? bI[o] : 0.f;
    const float vd = lane ? bD[o] : 0.f;
    const int rc = lane ? rcs[o] : 4;
    const float s_in = expf(fc[i - 1] + bc[i] - lkb);
    const float s_row = expf(fc[i] + bc[i] - lkb);
    pm[k] = xm; pi[k] = xi; pd[k] = xd;
    cm[k] = fm; ci[k] = fi; cd[k] = fd;
    __syncthreads();
    const float pml = k > 0 ? pm[k - 1] : 0.f;
    const float pil = k > 0 ? pi[k - 1] : 0.f;
    const float pdl = k > 0 ? pd[k - 1] : 0.f;
    const float pmr = k + 1 < W ? pm[k + 1] : 0.f;
    const float pir = k + 1 < W ? pi[k + 1] : 0.f;
    const float pdr = k + 1 < W ? pd[k + 1] : 0.f;
    const float cml = k > 0 ? cm[k - 1] : 0.f;
    const float cil = k > 0 ? ci[k - 1] : 0.f;
    const float cdl = k > 0 ? cd[k - 1] : 0.f;
    __syncthreads();
    // sources: diagonal (i-1, j-1) and up (i-1, j) in the previous band
    const float Md = one ? xm : pml, Id = one ? xi : pil, Dd = one ? xd : pdl;
    const float Mu = one ? pmr : xm, Iu = one ? pir : xi, Du = one ? pdr : xd;
    const float em = lane ? me_s[rc * 8 + qc] : 0.f;
    const float ei = ie_s[qp * 8 + qc];
    const float gM = em * vm * s_in;
    const float gI = ei * vi * s_in;
    const float gD = vd * s_row;
    acc[0] += tmm * Md * gM;
    acc[3] += tim * Id * gM;
    acc[6] += tdm * Dd * gM;
    acc[1] += tmi * Mu * gI;
    acc[4] += tii * Iu * gI;
    acc[7] += tdi * Du * gI;
    acc[2] += tmd * cml * gD;
    acc[5] += tid * cil * gD;
    acc[8] += tdd * cdl * gD;
    const float post_m = fm * vm * s_row;
    const float post_i = fi * vi * s_row;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (qc == q) {
#pragma unroll
        for (int a = 0; a < 4; ++a) acc[9 + a * 4 + q] += rc == a ? post_m : 0.f;
#pragma unroll
        for (int p = 0; p < 5; ++p) acc[25 + p * 4 + q] += qp == p ? post_i : 0.f;
      }
    }
    xm = fm; xi = fi; xd = fd;
  }

#pragma unroll
  for (int x = 0; x < NC; ++x) {
    const float v = block_sum(acc[x], ys);
    if (k == 0) out[(size_t)b * NC + x] = v;
  }
}

extern "C" int phmm_counts_launch(
    const float* fM, const float* fI, const float* fD, const float* bM,
    const float* bI, const float* bD, const float* fcum, const float* bcum,
    const int32_t* rcs, const int32_t* qs, const int32_t* shifts,
    const int32_t* qlen, const float* lk, const float* trans, const float* me,
    const float* ie, float* out, int B, int Q, int W, void* stream) {
  if (B == 0) return 0;
  const int threads = ((W + 31) / 32) * 32;
  const size_t shmem = 6 * threads * sizeof(float) + 160 * sizeof(float);
  phmm_counts_kernel<<<B, threads, shmem, (cudaStream_t)stream>>>(
      fM, fI, fD, bM, bI, bD, fcum, bcum, rcs, qs, shifts, qlen, lk, trans, me,
      ie, out, B, Q, W);
  return (int)cudaGetLastError();
}

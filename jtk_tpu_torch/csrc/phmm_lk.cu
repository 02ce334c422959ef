// K1l: banded 3-state pair-HMM forward log-likelihood, no tables.
//
// Replaces the Pallas kernel jtk_tpu/ops/pallas_phmm.py::_phmm_fwd_kernel
// (launched by _pallas_fwd, wrapped by pallas_likelihood_pileup).  Same
// recursion as jtk_tpu/ops/phmm.py::forward_banded in probability space:
// M/I/D update, the in-row Del chain D[k] = c[k] + tdd * D[k-1], each row
// rescaled by its SUM (+1e-30) with one running log scale per pair, rows
// past q_len frozen, lk = log(fin + 1e-30) + sum(log scales) with fin the
// M + I + D mass at column t_len of the last row.  Emissions are selected
// in the kernel from the padded (8, 8) tables: code 4 (N or past the end)
// emits with probability 0, ins row 4 is the start row.
//
// Design: one block per pair, one thread per band lane (blockDim = W
// rounded up to a warp; W <= 1024).  Each query row is one step:
// neighbour lanes through shared memory, the Del chain a block scan of a
// linear recurrence (block_scan.cuh), the row scale a block sum.
// Nothing but lk (B,) is written.  The loop stops at the pair's q_len.
//
// Bound on the H100: the per-row inputs (qs, shifts, inc: 12 bytes a row)
// and ~40 flops per cell; at W = 128 the arithmetic bounds it.  Each pair's
// rows are sequential with four block barriers per row, so the kernel is
// latency-bound unless many pairs are in flight.
#include <cstdint>

#include "block_scan.cuh"

__global__ void phmm_lk_kernel(const int32_t* __restrict__ qs,
                               const int32_t* __restrict__ shifts,
                               const int32_t* __restrict__ inc,
                               const int32_t* __restrict__ rc0,
                               const int32_t* __restrict__ j0,
                               const int32_t* __restrict__ qlen,
                               const int32_t* __restrict__ tlen,
                               const float* __restrict__ trans,
                               const float* __restrict__ me,
                               const float* __restrict__ ie,
                               float* __restrict__ out, int B, int Q, int W) {
  extern __shared__ float lsm[];
  float* mbuf = lsm;                         // blockDim.x each
  float* ibuf = mbuf + blockDim.x;
  float* dbuf = ibuf + blockDim.x;
  int* rcbuf = (int*)(dbuf + blockDim.x);
  float* ys = (float*)(rcbuf + blockDim.x);  // 32
  float* as = ys + 32;                       // 32
  float* me_s = as + 32;                     // 64
  float* ie_s = me_s + 64;                   // 64

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
  const int ql = qlen[b];
  const int tl = tlen[b];
  const size_t wb = (size_t)b * W;
  int j = lane ? j0[wb + k] : 0;
  int rc = lane ? rc0[wb + k] : 4;

  // row 0: start in M at j = 0, Del chain along the row
  float M = (lane && j == 0) ? 1.f : 0.f;
  float I = 0.f;
  mbuf[k] = M;
  __syncthreads();
  const float c0 = k > 0 ? tmd * mbuf[k - 1] : 0.f;
  __syncthreads();
  float D = block_linrec_fwd(lane ? c0 : 0.f, tdd, ys, as);
  D = (lane && j >= 1 && j <= tl) ? D : 0.f;
  const float s0 = block_sum(lane ? M + I + D : 0.f, ys) + 1e-30f;
  M /= s0;
  I /= s0;
  D /= s0;
  float logs = logf(s0);

  const int32_t* qrow = qs + (size_t)b * Q;
  const int32_t* srow = shifts + (size_t)b * Q;
  const int32_t* irow = inc + (size_t)b * Q;
  int qprev = 4;
  const int rows = ql < Q ? ql : Q;
  for (int r = 0; r < rows; ++r) {
    const int qc = qrow[r];
    const int sv = srow[r];
    const int newc = irow[r];
    const bool one = sv == 1;
    mbuf[k] = M; ibuf[k] = I; dbuf[k] = D; rcbuf[k] = rc;
    __syncthreads();
    const float Ml = k > 0 ? mbuf[k - 1] : 0.f;
    const float Il = k > 0 ? ibuf[k - 1] : 0.f;
    const float Dl = k > 0 ? dbuf[k - 1] : 0.f;
    const float Mr = k + 1 < W ? mbuf[k + 1] : 0.f;
    const float Ir = k + 1 < W ? ibuf[k + 1] : 0.f;
    const float Dr = k + 1 < W ? dbuf[k + 1] : 0.f;
    const int rc_next = (k == W - 1) ? newc : (k + 1 < W ? rcbuf[k + 1] : 4);
    __syncthreads();
    const float Md = one ? M : Ml, Id = one ? I : Il, Dd = one ? D : Dl;
    const float Mu = one ? Mr : M, Iu = one ? Ir : I, Du = one ? Dr : D;
    if (one) rc = rc_next;
    j += sv;
    const bool ok = lane && j >= 1 && j <= tl;
    const float em = ok ? me_s[rc * 8 + qc] : 0.f;
    const float ei = ie_s[qprev * 8 + qc];
    const float Mrow = em * (tmm * Md + tim * Id + tdm * Dd);
    const float Irow = (lane && j <= tl) ? ei * (tmi * Mu + tii * Iu + tdi * Du)
                                         : 0.f;
    // c[k] = tmd * Mrow[k-1] + tid * Irow[k-1]
    mbuf[k] = Mrow; ibuf[k] = Irow;
    __syncthreads();
    const float c = k > 0 ? tmd * mbuf[k - 1] + tid * ibuf[k - 1] : 0.f;
    __syncthreads();
    float Drow = block_linrec_fwd(lane ? c : 0.f, tdd, ys, as);
    Drow = ok ? Drow : 0.f;
    const float sc = block_sum(lane ? Mrow + Irow + Drow : 0.f, ys) + 1e-30f;
    M = Mrow / sc;
    I = Irow / sc;
    D = Drow / sc;
    logs += logf(sc);
    qprev = qc;
  }
  const float fin = block_sum((lane && j == tl) ? M + I + D : 0.f, ys);
  if (k == 0) out[b] = logf(fin + 1e-30f) + logs;
}

extern "C" int phmm_lk_launch(const int32_t* qs, const int32_t* shifts,
                              const int32_t* inc, const int32_t* rc0,
                              const int32_t* j0, const int32_t* qlen,
                              const int32_t* tlen, const float* trans,
                              const float* me, const float* ie, float* out,
                              int B, int Q, int W, void* stream) {
  if (B == 0) return 0;
  const int threads = ((W + 31) / 32) * 32;
  const size_t shmem = 4 * threads * sizeof(float) + 192 * sizeof(float);
  phmm_lk_kernel<<<B, threads, shmem, (cudaStream_t)stream>>>(
      qs, shifts, inc, rc0, j0, qlen, tlen, trans, me, ie, out, B, Q, W);
  return (int)cudaGetLastError();
}

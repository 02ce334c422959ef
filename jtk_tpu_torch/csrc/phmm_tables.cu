// K1: banded 3-state pair-HMM forward and backward tables.
//
// Replace the Pallas kernels jtk_tpu/ops/pallas_phmm.py::_fwd_tables_kernel
// (launched by _pallas_fwd_tables) and ::_bwd_tables_kernel (launched by
// _pallas_bwd_tables).  Same math, probability space with per-row
// rescaling: the forward pass rescales each row by its SUM, the backward
// pass by its MAX (the closed-form modification table joins the two
// cumulative scales, so they must not be mixed).
//
// Design: one block per pair, one thread per band lane (blockDim = W
// rounded up to a warp; W <= 1024).  Each query row is one step: the five
// precomputed emission streams give the row's emissions, the band shift
// reads neighbour lanes through shared memory, the in-row Del chain
// D[k] = c[k] + tdd * D[k-1] is a block scan of a linear recurrence, and
// the row scale is a block reduction.  Rows past q_len (forward) or at or
// past q_len (backward) are frozen.  A per-pair strand flag selects the
// first or second transition table.
//
// Bound on the H100: the table writes, 3 * Q * W * 4 bytes per pair and
// pass (~3 MB at Q = 2048, W = 128); the arithmetic is ~40 flops per cell.
// Each pair's rows are sequential, so the kernel needs many pairs in flight
// to hide the per-row barrier latency.
#include <cstdint>

#include "block_scan.cuh"

struct Trans {
  float mm, mi, md, im, ii, id, dm, di, dd;
};

__device__ __forceinline__ Trans load_trans(const float* t) {
  // t is the padded (8, 8) table [from, to] with states M=0, I=1, D=2
  Trans r;
  r.mm = t[0]; r.mi = t[1]; r.md = t[2];
  r.im = t[8]; r.ii = t[9]; r.id = t[10];
  r.dm = t[16]; r.di = t[17]; r.dd = t[18];
  return r;
}

__device__ __forceinline__ float pick_emis(int rc, float e0, float e1,
                                           float e2, float e3) {
  return rc == 0 ? e0 : rc == 1 ? e1 : rc == 2 ? e2 : rc == 3 ? e3 : 0.f;
}

__global__ void fwd_tables_kernel(const float* __restrict__ emis,
                                  const int32_t* __restrict__ shifts,
                                  const int32_t* __restrict__ inc,
                                  const int32_t* __restrict__ rc0,
                                  const int32_t* __restrict__ j0,
                                  const float* __restrict__ m0,
                                  const float* __restrict__ i0,
                                  const float* __restrict__ d0,
                                  const int32_t* __restrict__ qlen,
                                  const int32_t* __restrict__ tlen,
                                  const int32_t* __restrict__ strand,
                                  const float* __restrict__ trans,
                                  const float* __restrict__ trans2,
                                  float* __restrict__ outM,
                                  float* __restrict__ outI,
                                  float* __restrict__ outD,
                                  float* __restrict__ outLs,
                                  int B, int Q, int W) {
  extern __shared__ float fsm[];
  float* mbuf = fsm;                       // blockDim.x each
  float* ibuf = mbuf + blockDim.x;
  float* dbuf = ibuf + blockDim.x;
  int* rcbuf = (int*)(dbuf + blockDim.x);
  float* ys = (float*)(rcbuf + blockDim.x);  // 32
  float* as = ys + 32;                       // 32

  const int b = blockIdx.x;
  const int k = threadIdx.x;
  const bool lane = k < W;
  const Trans t = load_trans(strand[b] > 0 ? trans2 : trans);
  const int ql = qlen[b];
  const int tl = tlen[b];
  const size_t wb = (size_t)b * W;
  float M = lane ? m0[wb + k] : 0.f;
  float I = lane ? i0[wb + k] : 0.f;
  float D = lane ? d0[wb + k] : 0.f;
  int j = lane ? j0[wb + k] : 0;
  int rc = lane ? rc0[wb + k] : 0;
  const float* em = emis + (size_t)b * 5 * Q;
  const int32_t* srow = shifts + (size_t)b * Q;
  const int32_t* irow = inc + (size_t)b * Q;

  for (int r = 0; r < Q; ++r) {
    const int i = r + 1;
    const int sv = srow[r];
    const int newc = irow[r];
    const float e0 = em[r], e1 = em[Q + r], e2 = em[2 * Q + r],
                e3 = em[3 * Q + r], ei = em[4 * Q + r];
    const bool one = sv == 1;
    mbuf[k] = M; ibuf[k] = I; dbuf[k] = D; rcbuf[k] = rc;
    __syncthreads();
    const float Ml = k > 0 ? mbuf[k - 1] : 0.f;
    const float Il = k > 0 ? ibuf[k - 1] : 0.f;
    const float Dl = k > 0 ? dbuf[k - 1] : 0.f;
    const float Mr = k + 1 < W ? mbuf[k + 1] : 0.f;
    const float Ir = k + 1 < W ? ibuf[k + 1] : 0.f;
    const float Dr = k + 1 < W ? dbuf[k + 1] : 0.f;
    const int rc_next = (k == W - 1) ? newc : (k + 1 < W ? rcbuf[k + 1] : 0);
    __syncthreads();
    const float Md = one ? M : Ml, Id = one ? I : Il, Dd = one ? D : Dl;
    const float Mu = one ? Mr : M, Iu = one ? Ir : I, Du = one ? Dr : D;
    const int rc_n = one ? rc_next : rc;
    const int j_n = j + sv;
    const bool ok = lane && j_n >= 1 && j_n <= tl;
    const float e = ok ? pick_emis(rc_n, e0, e1, e2, e3) : 0.f;
    const float Mrow = e * (t.mm * Md + t.im * Id + t.dm * Dd);
    float Irow = ei * (t.mi * Mu + t.ii * Iu + t.di * Du);
    Irow = (lane && j_n <= tl) ? Irow : 0.f;
    // c[k] = tmd * Mrow[k-1] + tid * Irow[k-1]
    mbuf[k] = Mrow; ibuf[k] = Irow;
    __syncthreads();
    const float c = k > 0 ? t.md * mbuf[k - 1] + t.id * ibuf[k - 1] : 0.f;
    __syncthreads();
    float Drow = block_linrec_fwd(lane ? c : 0.f, t.dd, ys, as);
    Drow = ok ? Drow : 0.f;
    const float sc = block_sum(lane ? Mrow + Irow + Drow : 0.f, ys) + 1e-30f;
    const bool live = i <= ql;
    if (live) {
      M = Mrow / sc;
      I = Irow / sc;
      D = Drow / sc;
      j = j_n;
      rc = rc_n;
    }
    if (lane) {
      const size_t o = ((size_t)b * Q + r) * W + k;
      outM[o] = M; outI[o] = I; outD[o] = D;
    }
    if (k == 0) outLs[(size_t)b * Q + r] = live ? logf(sc) : 0.f;
  }
}

__global__ void bwd_tables_kernel(const float* __restrict__ emis,
                                  const int32_t* __restrict__ shifts,
                                  const int32_t* __restrict__ inc,
                                  const int32_t* __restrict__ rcq,
                                  const int32_t* __restrict__ jq,
                                  const float* __restrict__ bm0,
                                  const float* __restrict__ bi0,
                                  const float* __restrict__ bd0,
                                  const int32_t* __restrict__ qlen,
                                  const int32_t* __restrict__ tlen,
                                  const int32_t* __restrict__ strand,
                                  const float* __restrict__ trans,
                                  const float* __restrict__ trans2,
                                  float* __restrict__ outM,
                                  float* __restrict__ outI,
                                  float* __restrict__ outD,
                                  float* __restrict__ outLs,
                                  int B, int Q, int W) {
  extern __shared__ float bsm[];
  float* mbuf = bsm;
  float* ibuf = mbuf + blockDim.x;
  int* rcbuf = (int*)(ibuf + blockDim.x);
  float* ys = (float*)(rcbuf + blockDim.x);
  float* as = ys + 32;

  const int b = blockIdx.x;
  const int k = threadIdx.x;
  const bool lane = k < W;
  const Trans t = load_trans(strand[b] > 0 ? trans2 : trans);
  const int ql = qlen[b];
  const int tl = tlen[b];
  const size_t wb = (size_t)b * W;
  float bM = lane ? bm0[wb + k] : 0.f;
  float bI = lane ? bi0[wb + k] : 0.f;
  float bD = lane ? bd0[wb + k] : 0.f;
  int rc = lane ? rcq[wb + k] : 0;   // r[off[i] + k] at the current row
  int j = lane ? jq[wb + k] : 0;     // off[Q] + k
  const float* em = emis + (size_t)b * 5 * Q;
  const int32_t* srow = shifts + (size_t)b * Q;
  const int32_t* irow = inc + (size_t)b * Q;

  for (int i = Q - 1; i >= 0; --i) {   // row i from row i + 1
    const int sv = srow[i];
    const int newc = irow[i];
    const float e0 = em[i], e1 = em[Q + i], e2 = em[2 * Q + i],
                e3 = em[3 * Q + i], ei = em[4 * Q + i];
    const bool one = sv == 1;
    mbuf[k] = bM; ibuf[k] = bI; rcbuf[k] = rc;
    __syncthreads();
    const float bMr = k + 1 < W ? mbuf[k + 1] : 0.f;
    const float bIl = k > 0 ? ibuf[k - 1] : 0.f;
    const int rc_prev = (k == 0) ? newc : rcbuf[k - 1];
    __syncthreads();
    const int rc_i = one ? rc_prev : rc;
    const int j_i = j - sv;
    const float e = (lane && j_i + 1 <= tl) ? pick_emis(rc_i, e0, e1, e2, e3)
                                             : 0.f;
    const float bM1 = one ? bM : bMr;
    const float bI1 = one ? bIl : bI;
    const float u = e * bM1;
    const float v = ei * bI1;
    const float c = t.dm * u + t.di * v;
    float bDrow = block_linrec_rev(lane ? c : 0.f, t.dd, ys, as);
    // w[k] = bDrow[k + 1]
    mbuf[k] = bDrow;
    __syncthreads();
    const float w = k + 1 < W ? mbuf[k + 1] : 0.f;
    __syncthreads();
    const bool ok = lane && j_i <= tl;
    const float bMrow = ok ? t.mm * u + t.mi * v + t.md * w : 0.f;
    const float bIrow = ok ? t.im * u + t.ii * v + t.id * w : 0.f;
    bDrow = ok ? bDrow : 0.f;
    const float sc = block_max(lane ? bMrow + bIrow + bDrow : 0.f, ys) + 1e-30f;
    const bool live = i < ql;
    if (live) {
      bM = bMrow / sc;
      bI = bIrow / sc;
      bD = bDrow / sc;
      rc = rc_i;
      j = j_i;
    }
    if (lane) {
      const size_t o = ((size_t)b * Q + i) * W + k;
      outM[o] = bM; outI[o] = bI; outD[o] = bD;
    }
    if (k == 0) outLs[(size_t)b * Q + i] = live ? logf(sc) : 0.f;
  }
}

extern "C" int fwd_tables_launch(const float* emis, const int32_t* shifts,
                                 const int32_t* inc, const int32_t* rc0,
                                 const int32_t* j0, const float* m0,
                                 const float* i0, const float* d0,
                                 const int32_t* qlen, const int32_t* tlen,
                                 const int32_t* strand, const float* trans,
                                 const float* trans2, float* outM, float* outI,
                                 float* outD, float* outLs, int B, int Q, int W,
                                 void* stream) {
  if (B == 0) return 0;
  const int threads = ((W + 31) / 32) * 32;
  const size_t shmem = 4 * threads * sizeof(float) + 64 * sizeof(float);
  fwd_tables_kernel<<<B, threads, shmem, (cudaStream_t)stream>>>(
      emis, shifts, inc, rc0, j0, m0, i0, d0, qlen, tlen, strand, trans,
      trans2, outM, outI, outD, outLs, B, Q, W);
  return (int)cudaGetLastError();
}

extern "C" int bwd_tables_launch(const float* emis, const int32_t* shifts,
                                 const int32_t* inc, const int32_t* rcq,
                                 const int32_t* jq, const float* bm0,
                                 const float* bi0, const float* bd0,
                                 const int32_t* qlen, const int32_t* tlen,
                                 const int32_t* strand, const float* trans,
                                 const float* trans2, float* outM, float* outI,
                                 float* outD, float* outLs, int B, int Q, int W,
                                 void* stream) {
  if (B == 0) return 0;
  const int threads = ((W + 31) / 32) * 32;
  const size_t shmem = 3 * threads * sizeof(float) + 64 * sizeof(float);
  bwd_tables_kernel<<<B, threads, shmem, (cudaStream_t)stream>>>(
      emis, shifts, inc, rcq, jq, bm0, bi0, bd0, qlen, tlen, strand, trans,
      trans2, outM, outI, outD, outLs, B, Q, W);
  return (int)cudaGetLastError();
}

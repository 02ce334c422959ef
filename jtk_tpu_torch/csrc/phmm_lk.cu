// K1l: banded 3-state pair-HMM forward log-likelihood, no tables.
//
// Replaces the Pallas kernel jtk_tpu/ops/pallas_phmm.py::_phmm_fwd_kernel
// (launched by _pallas_fwd, wrapped by pallas_likelihood_pileup).  Same
// recursion as jtk_tpu/ops/phmm.py::forward_banded in probability space:
// row 0 starts in M at j = 0 with the Del chain along the row, then each row
// the M/I/D update and the in-row Del chain D[k] = c[k] + tdd * D[k-1],
// each row rescaled by its SUM (+1e-30) into one running log scale per pair,
// rows past q_len frozen, lk = log(fin + 1e-30) + sum(log scales) with fin
// the M + I + D mass at column t_len of the last row.  Codes are raw: an N
// (code 4) in the read or the template emits with probability 0.
//
// Bound on the H100: operations (~40 flops a cell; nothing is written but
// lk, and the inputs are 12 bytes a row).  But a pair's rows are a chain of
// q_len dependent steps, and the main path runs 40 to 256 pairs, one warp
// or a few each: a row costs about the instructions its warp issues.
//
// Design: the row wavefront of the K1 forward-tables kernel
// (phmm_tables.cu, geometry from ops/phmm_tables.py::tables_geometry)
// without the table stores:
// - L <= 4 consecutive band lanes a thread, in registers, 1 to 16 warps a
//   pair, 4 warps a block (several pairs of a narrow band share a block).
//   No __syncthreads; the warps of one pair meet at two named barriers a
//   row (edge lanes, then the Del-chain carry and the scale partials).
// - Neighbour lanes by shuffle at a thread's two edges; the Del chain is a
//   serial pass over the thread's lanes, warp_linrec_up with multipliers
//   tdd^(L 2^s), and a carry pass.
// - The row scale (the sum of the previous row) is off the row-to-row
//   chain and applied at the end of the row; its log accumulates as a
//   mantissa in [1, 2) and an integer exponent (a multiply and three
//   integer operations a row).
// - The row streams (shift, entering char, emissions) come two 6-row tiles
//   ahead by cp.async (wb::RowTile).  Their (5, Q) emission block is built
//   from the raw codes by lk_emis_kernel, launched just before: match
//   emissions me[ref, q] of ref codes 0..3 and the insertion emission
//   ie[q_prev, q] (q_prev = 4, the start row, at row 0).
// - The loop stops at the pair's q_len.
#include <cstdint>

#include "warp_band.cuh"

// Per warp of a block: [0] scan total, [1] final mass partial, [2] scale
// partial, [3..6] first lane's values, [7..9] last lane's values.
constexpr int SM_SLOTS = 12;
constexpr int GEOMETRY_ERROR = -2;
constexpr int MAX_W = 2048;

// Warps of a block: 4 pairs of one warp, 2 of two, or one wider pair.
__host__ __device__ constexpr int block_warps(int wpp) {
  return wpp >= 4 ? wpp : 4;
}

// A column no band lane reaches: masked lanes (k >= W) start there.
constexpr int NO_COLUMN = 1 << 30;

// emis[b] = (5, Q): me[c, q[r]] for ref codes c = 0..3, then ie[q[r-1], q[r]]
// (codes 0..4; q[-1] = 4).
__global__ void lk_emis_kernel(const int32_t* __restrict__ qs,
                               const float* __restrict__ me,
                               const float* __restrict__ ie,
                               float* __restrict__ emis, int B, int Q) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= B * Q) return;
  const int b = x / Q, r = x - b * Q;
  const int qc = min(max(qs[x], 0), 7);
  const int qp = r > 0 ? min(max(qs[x - 1], 0), 7) : 4;
  float* e = emis + (size_t)b * 5 * Q + r;
#pragma unroll
  for (int c = 0; c < 4; ++c) e[(size_t)c * Q] = me[c * 8 + qc];
  e[(size_t)4 * Q] = ie[qp * 8 + qc];
}

template <int L, int WPP>
__global__ void __launch_bounds__(32 * block_warps(WPP))
phmm_lk_kernel(const float* __restrict__ emis,
               const int32_t* __restrict__ shifts,
               const int32_t* __restrict__ inc,
               const int32_t* __restrict__ rc0,
               const int32_t* __restrict__ j0,
               const int32_t* __restrict__ qlen,
               const int32_t* __restrict__ tlen,
               const float* __restrict__ trans, float* __restrict__ out,
               int B, int Q, int W, int ppb) {
  __shared__ float sm[block_warps(WPP)][SM_SLOTS];
  __shared__ float streams[block_warps(WPP)][wb::STREAM_WORDS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wip = warp % WPP;              // warp within the pair
  const int w0 = warp - wip;               // the pair's first warp
  const int b = blockIdx.x * ppb + warp / WPP;
  if (b >= B) return;                      // all of the pair's warps
  const int bar = 1 + warp / WPP;
  const int k0 = (wip * 32 + lane) * L;
  const int nv = W - k0;                   // band lanes of this thread
  const int wl = W - 1 - k0;               // local index of lane W - 1
  // transitions [from, to], M = 0, I = 1, D = 2, in the padded (8, 8) table
  const float mm = trans[0], mi = trans[1], md = trans[2];
  const float im = trans[8], ii = trans[9], id = trans[10];
  const float dm = trans[16], di = trans[17], dd = trans[18];
  float a[5], am[5];
  wb::scan_powers(dd, L, a);
  wb::up_multipliers(a, lane, am);
  const float powT = wb::ipow(dd, L * lane);   // warp input -> thread input
  const float powW = wb::ipow(dd, 32 * L);     // across one warp
  const int ql = min(max(qlen[b], 0), Q);
  const int tl = tlen[b];
  const size_t wbase = (size_t)b * W;
  float* sw = sm[warp];

  // The Del chain D[k] = c[k] + dd D[k-1], c[k] = md M[k-1] + id I[k-1]
  // over the pair's lanes, masked by dmask; also sums the pair's scale
  // partials s (one named barrier when WPP > 1).  e_out is the thread's
  // part of D at the next thread's first lane; the scan carries it, and
  // the thread's first lane takes the carry.
  auto del_chain = [&](const float (&Mr)[L], const float (&Ir)[L],
                       const float (&dmask)[L], float (&Dr)[L], float& s) {
    float c[L];
#pragma unroll
    for (int l = 1; l < L; ++l) c[l] = md * Mr[l - 1] + id * Ir[l - 1];
    float z = 0.f;
#pragma unroll
    for (int l = 1; l < L; ++l) z = fmaf(dd, z, c[l]);
    const float e_out = fmaf(dd, z, md * Mr[L - 1] + id * Ir[L - 1]);
    const float E = wb::warp_linrec_up(e_out, am);
    float Ein = __shfl_up_sync(FULL_MASK, E, 1);
    if (lane == 0) Ein = 0.f;
    float G = 0.f;   // D at the warp's first lane
    if constexpr (WPP > 1) {
      if (lane == 31) sw[0] = E;
      if (lane == 0) sw[2] = s;
      wb::pair_sync(bar, WPP * 32);
      for (int w = 0; w < wip; ++w) G = sm[w0 + w][0] + powW * G;
      s = 0.f;
      for (int w = 0; w < WPP; ++w) s += sm[w0 + w][2];
    }
    float y = Ein + powT * G;
#pragma unroll
    for (int l = 0; l < L; ++l) {
      if (l > 0) y = fmaf(dd, y, c[l]);
      Dr[l] = y * dmask[l];
    }
  };

  // T: the last row computed, before its scale.  Row 0: M at j = 0, the
  // Del chain along the row (D lives at columns 1..t_len).
  float TM[L], TI[L], TD[L], dmask[L];
  int j[L], rc[L];
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const bool v = l < nv;
    j[l] = v ? j0[wbase + k0 + l] : NO_COLUMN;
    rc[l] = v ? rc0[wbase + k0 + l] : 4;
    TM[l] = j[l] == 0 ? 1.f : 0.f;
    TI[l] = 0.f;
    dmask[l] = (unsigned)(j[l] - 1) < (unsigned)tl ? 1.f : 0.f;
  }
  {
    float unused = 0.f;
    del_chain(TM, TI, dmask, TD, unused);
  }
  // edge lanes of the pair's neighbouring warps (0 at the band's ends)
  float lM = 0.f, lI = 0.f, lD = 0.f, rM = 0.f, rI = 0.f, rD = 0.f;
  int rR = 4;
  auto exchange_edges = [&]() {
    if constexpr (WPP > 1) {
      if (lane == 0) {
        sw[3] = TM[0]; sw[4] = TI[0]; sw[5] = TD[0];
        sw[6] = __int_as_float(rc[0]);
      }
      if (lane == 31) {
        sw[7] = TM[L - 1]; sw[8] = TI[L - 1]; sw[9] = TD[L - 1];
      }
      wb::pair_sync(bar, WPP * 32);
      if (lane == 0 && wip > 0) {
        lM = sm[warp - 1][7]; lI = sm[warp - 1][8]; lD = sm[warp - 1][9];
      }
      if (lane == 31 && wip < WPP - 1) {
        rM = sm[warp + 1][3]; rI = sm[warp + 1][4]; rD = sm[warp + 1][5];
        rR = __float_as_int(sm[warp + 1][6]);
      }
    }
  };
  // this warp's part of the sum of the row in T
  auto row_sum = [&]() {
    float s = 0.f;
#pragma unroll
    for (int l = 0; l < L; ++l) s += TM[l] + TI[l] + TD[l];
    return wb::warp_sum(s);
  };
  // sum of log scales = log(sp) + se * log(2), sp in [1, 2)
  float sp = 1.f;
  int se = 0;
  auto add_log = [&](float sc) {
    const int bits = __float_as_int(sp * sc);
    se += (bits >> 23) - 127;
    sp = __int_as_float((bits & 0x007fffff) | 0x3f800000);
  };
  exchange_edges();
  const float* em = emis + (size_t)b * 5 * Q;
  const int32_t* srow = shifts + (size_t)b * Q;
  const int32_t* irow = inc + (size_t)b * Q;
  wb::RowTile cur;
  cur.buf = streams[warp];
  cur.next = 0;
  cur.fetch(srow, irow, em, Q, ql, 0, 1, lane);
  cur.fetch(srow, irow, em, Q, ql, wb::TILE_ROWS, 1, lane);
  cur.take(lane);
  wb::Row rw = cur.row(0);
  int src = 0;

  // Row r + 1 from T = row r before its scale: the rows are linear in the
  // previous row, so the scale of row r (a reduction) runs beside the row's
  // own chain and is applied at its end.
  for (int r = 0; r < ql; ++r) {           // every row here is live
    const wb::Row nrw = cur.row(src + 1);  // the next row's streams
    float s = row_sum();
    float Mr[L], Ir[L];
    int rn[L];
    if (rw.sv == 1) {
      // diagonal from the same lane, up from lane k + 1
      float eM = __shfl_down_sync(FULL_MASK, TM[0], 1);
      float eI = __shfl_down_sync(FULL_MASK, TI[0], 1);
      float eD = __shfl_down_sync(FULL_MASK, TD[0], 1);
      int eR = __shfl_down_sync(FULL_MASK, rc[0], 1);
      if (lane == 31) { eM = rM; eI = rI; eD = rD; eR = rR; }
#pragma unroll
      for (int l = 0; l < L; ++l) {
        const float uM = l + 1 < L ? TM[l + 1] : eM;
        const float uI = l + 1 < L ? TI[l + 1] : eI;
        const float uD = l + 1 < L ? TD[l + 1] : eD;
        const int ur = l + 1 < L ? rc[l + 1] : eR;
        rn[l] = l == wl ? rw.nc : ur;
        Mr[l] = mm * TM[l] + im * TI[l] + dm * TD[l];
        Ir[l] = mi * uM + ii * uI + di * uD;
      }
    } else {
      // diagonal from lane k - 1, up from the same lane
      float eM = __shfl_up_sync(FULL_MASK, TM[L - 1], 1);
      float eI = __shfl_up_sync(FULL_MASK, TI[L - 1], 1);
      float eD = __shfl_up_sync(FULL_MASK, TD[L - 1], 1);
      if (lane == 0) { eM = lM; eI = lI; eD = lD; }
#pragma unroll
      for (int l = 0; l < L; ++l) {
        const float dM = l > 0 ? TM[l - 1] : eM;
        const float dI = l > 0 ? TI[l - 1] : eI;
        const float dD = l > 0 ? TD[l - 1] : eD;
        rn[l] = rc[l];
        Mr[l] = mm * dM + im * dI + dm * dD;
        Ir[l] = mi * TM[l] + ii * TI[l] + di * TD[l];
      }
    }
#pragma unroll
    for (int l = 0; l < L; ++l) {
      const int jn = j[l] + rw.sv;
      const bool ok = (unsigned)(jn - 1) < (unsigned)tl;   // 1 <= jn <= tl
      const float e = cur.match(src, rn[l]);
      Mr[l] *= ok ? e : 0.f;
      Ir[l] *= jn <= tl ? rw.ei : 0.f;
      dmask[l] = ok ? 1.f : 0.f;
      j[l] = jn;
      rc[l] = rn[l];
    }
    float Dr[L];
    del_chain(Mr, Ir, dmask, Dr, s);
    const float sc = s + 1e-30f;
    add_log(sc);
    const float inv = wb::rcp_approx(sc);
#pragma unroll
    for (int l = 0; l < L; ++l) {
      TM[l] = Mr[l] * inv;
      TI[l] = Ir[l] * inv;
      TD[l] = Dr[l] * inv;
    }
    exchange_edges();
    rw = nrw;
    if (++src == wb::TILE_ROWS) {
      src = 0;
      cur.fetch(srow, irow, em, Q, ql, r + 1 + wb::TILE_ROWS, 1, lane);
      cur.take(lane);
    }
  }
  // the last row's scale, and its mass at column t_len
  float s = row_sum();
  float f = 0.f;
#pragma unroll
  for (int l = 0; l < L; ++l)
    f += j[l] == tl ? TM[l] + TI[l] + TD[l] : 0.f;
  f = wb::warp_sum(f);
  if constexpr (WPP > 1) {
    if (lane == 0) { sw[1] = f; sw[2] = s; }
    wb::pair_sync(bar, WPP * 32);
    f = 0.f;
    s = 0.f;
    for (int w = 0; w < WPP; ++w) { f += sm[w0 + w][1]; s += sm[w0 + w][2]; }
  }
  const float sc = s + 1e-30f;
  add_log(sc);
  if (wip == 0 && lane == 0) {
    const float fin = f * wb::rcp_approx(sc);
    out[b] = (float)((double)logf(fin + 1e-30f) + (double)logf(sp) +
                     (double)se * 0.6931471805599453);
  }
}

// The geometries this library is built for: (lanes per thread, warps per
// pair), those of ops/phmm_tables.py::tables_geometry.
#define LK_GEOMETRIES(X) \
  X(1, 1) X(2, 1) X(4, 1) X(4, 2) X(4, 4) X(4, 8) X(4, 16)

#define LK_CASE(L_, WPP_)                                                   \
  if (lanes == L_ && warps == WPP_) {                                       \
    phmm_lk_kernel<L_, WPP_><<<grid, block, 0, s>>>(                        \
        emis, shifts, inc, rc0, j0, qlen, tlen, trans, out, B, Q, W, ppb);  \
    known = true;                                                           \
  }

// Builds the emission streams into ``emis`` (B * 5 * Q floats, scratch the
// caller allocates) and runs the forward pass.  Returns 0, a CUDA error
// code, or GEOMETRY_ERROR for a geometry the library was not built for (or
// that does not cover W).
extern "C" int phmm_lk_launch(const int32_t* qs, const int32_t* shifts,
                              const int32_t* inc, const int32_t* rc0,
                              const int32_t* j0, const int32_t* qlen,
                              const int32_t* tlen, const float* trans,
                              const float* me, const float* ie, float* emis,
                              float* out, int B, int Q, int W, int lanes,
                              int warps, int ppb, void* stream) {
  if (B == 0) return 0;
  if (W < 1 || W > MAX_W || Q < 1 || ppb < 1 || lanes * 32 * warps < W ||
      ppb * warps > block_warps(warps))
    return GEOMETRY_ERROR;
  cudaStream_t s = (cudaStream_t)stream;
  lk_emis_kernel<<<(B * Q + 255) / 256, 256, 0, s>>>(qs, me, ie, emis, B, Q);
  const dim3 grid((B + ppb - 1) / ppb), block(ppb * warps * 32);
  bool known = false;
  LK_GEOMETRIES(LK_CASE)
  if (!known) return GEOMETRY_ERROR;
  return (int)cudaGetLastError();
}

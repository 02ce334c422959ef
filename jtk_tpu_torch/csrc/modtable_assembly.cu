// K2: the modification table's closed-form assembly from the K1 tables.
//
// Replaces no Pallas kernel: jtk_tpu assembles the table in jnp code that
// XLA fuses inside one jit (jtk_tpu/ops/modtable.py::
// modification_table_from_tables, fused in _pallas_modtable_fused).  The
// port ran the same assembly eagerly, one PyTorch pass over the band
// tables an op (~200 passes a slice: 16 float64 column sums, each a cumsum,
// two gathers, a pad and a diagonal sum, and ~40 shifted copies of whole
// tables), 54-65 % of a phase chunk's time on the card.  The plain version,
// ops/modtable.py::modification_table_from_tables_plain, stays beside it.
//
// What it computes, per pair: for every band cell (i, k) of template column
// jc = off[i] + k, the terms of the 14 edits (substitutions and their base,
// three deletions, insertions and their base, three tandem copies with the
// closed form's "drop query insertions" approximation) from the forward
// tables fM/fI/fD, the backward tables bM/bD, the per-row scales
// exp(fcum[i-u] + bcum[i] - lk) (u = 0..3) and the template codes; summed
// over the cells of each column (16 sums); then in float32 the column
// shifts (sub and del at jc = j + 1, copy c at j + c), log(max(., EPS)) +
// lk, the end-of-template deletion override and the -1e30 mask.
//
// Bound on the H100: bytes.  The five tables it reads (fM, fI, fD, bM, bD;
// bI is not used) are 20 bytes a cell, each read once, and the
// (Tpad+1, 14) table is written once: ~1.1 GB a slice of 192 pairs at
// Q 2.2 k, W 128, ~0.33 ms at 3.35 TB/s.  ~150 float32 operations and 16
// float64 additions a cell.
//
// Design: one thread a template column of one pair, 128 columns a block.
// - Offsets never decrease and step by 0 or 1 (the K1 kernels' own
//   precondition), so the rows whose band covers column jc form one run,
//   found by two binary searches over the pair's offsets.  A thread walks
//   its run in increasing row order; the warp walks the union of its 32
//   runs with one row index, so at each step the 32 threads read 32
//   neighbouring lanes of one row (coalesced; the stencil's neighbours,
//   lanes k-1..k+3 of the row, are L1 hits).
// - A cell's terms read row i - 1 only at columns jc - 1 and jc, and the
//   copy recurrences only earlier rows of column jc: the thread carries
//   those values from its previous step in registers (no halo, no
//   shared-memory ring, no second pass).
// - The 16 column sums are float64 registers of the thread: the terms are
//   non-negative and summed in row order, so there is no atomic, no
//   cumsum difference and no cancellation, and a pair's table does not
//   depend on the batch it shares a launch with or on the launch's size.
//   The sums never touch device memory.
// - The table's row j takes sums of columns j (ins), j + 1 (sub, del) and
//   j + c (copy c): the thread of column jc writes those entries of rows
//   jc, jc - 1 and jc - c, so the columns Tpad + 1 .. Tpad + 3 get threads
//   too (empty sums) and one launch writes the whole table.
// - Geometry follows the shapes alone: B * ceil((Tpad + 4) / 128) blocks;
//   a band of any width W only lengthens a thread's walk.
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#ifndef FULL_MASK
#define FULL_MASK 0xffffffffu
#endif

constexpr int NUM_EDIT = 14;      // sub 4 | ins 4 | copy 1..3 | del 1..3
constexpr int COPY_SIZE = 3;
constexpr int THREADS = 128;      // template columns a block
constexpr int GEOMETRY_ERROR = -2;
constexpr float EPS = 1e-30f;
constexpr float MASKED = -1e30f;

// the 16 column sums
enum {
  S0 = 0, SB = 4, D1 = 5, I0 = 8, IB = 12, C1 = 13, NSUM = 16
};

// First row whose offset is >= v (n if none).
__device__ __forceinline__ int rows_from(const int64_t* __restrict__ off,
                                         int n, int64_t v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(off + mid) < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ float row_scale(float fc, float bc, float lk) {
  return expf(fminf(fmaxf(fc + bc - lk, -80.0f), 80.0f));
}

__global__ void __launch_bounds__(THREADS) modtable_assembly_kernel(
    const int32_t* __restrict__ q, const int64_t* __restrict__ off,
    const int64_t* __restrict__ qlen, const int64_t* __restrict__ tlen,
    const float* __restrict__ trans, const float* __restrict__ me,
    const float* __restrict__ lk, const float* __restrict__ fM,
    const float* __restrict__ fI, const float* __restrict__ fD,
    const float* __restrict__ fcum, const int32_t* __restrict__ tpl,
    const float* __restrict__ bM, const float* __restrict__ bD,
    const float* __restrict__ bcum, float* __restrict__ out, int Q, int W,
    int Tpad, int T, int col_blocks) {
  const int b = blockIdx.x / col_blocks;
  const int jc = (blockIdx.x % col_blocks) * THREADS + threadIdx.x;
  const int Q1 = Q + 1;
  // match emissions [ref code][query code], code 4 (pad, N past q_len,
  // row 0's missing query char) emits 0
  __shared__ float s_em[5][5];
  if (threadIdx.x < 25) {
    const int v = threadIdx.x / 5, c = threadIdx.x % 5;
    s_em[v][c] = (v < 4 && c < 4) ? me[b * 16 + v * 4 + c] : 0.0f;
  }
  __syncthreads();
  const float* tr = trans + b * 9;
  const float tmm = tr[0], tmd = tr[2], tim = tr[3], tid = tr[5];
  const float tdm = tr[6], tdd = tr[8];
  const int ql = (int)qlen[b];
  const int tl = (int)tlen[b];
  const float lkb = lk[b];
  const int64_t* offb = off + (size_t)b * Q1;
  const float* fcb = fcum + (size_t)b * Q1;
  const float* bcb = bcum + (size_t)b * Q1;
  const int32_t* qb = q + (size_t)b * Q;
  const bool valid = jc <= min(tl, Tpad);
  // rows whose band holds column jc - 1 or jc: jc - W <= off[i] <= jc
  int lo = INT_MAX, hi = -1;
  if (valid) {
    lo = rows_from(offb, Q1, (int64_t)jc - W);
    hi = min(rows_from(offb, Q1, (int64_t)jc + 1) - 1, ql);
  }
  const int wlo = __reduce_min_sync(FULL_MASK, lo);
  const int whi = __reduce_max_sync(FULL_MASK, hi);
  // template codes of columns jc - 2 .. jc + 3 (the band's code at column
  // x is 4 at x = 0 and past the template)
  int pc[6];
#pragma unroll
  for (int d = 0; d < 6; ++d) {
    const int x = jc + d - 2;
    pc[d] = (x >= 1 && x <= T) ? tpl[(size_t)b * T + x - 1] : 4;
  }
  double s[NSUM];
#pragma unroll
  for (int n = 0; n < NSUM; ++n) s[n] = 0.0;
  // carried from the previous row: f at column jc - 1 and at jc, and the
  // copy recurrences' values at jc
  float flM = 0.f, flI = 0.f, flD = 0.f, fcM = 0.f, fcI = 0.f, fcD = 0.f;
  float cM12 = 0.f, cM13 = 0.f, cMb2 = 0.f, cMb1 = 0.f, cD = 0.f;
  for (int i = wlo; i <= whi; ++i) {
    const int k = jc - (int)__ldg(offb + i);
    if (!(i >= lo && i <= hi && k >= 0 && k <= W)) continue;
    const size_t rb = ((size_t)b * Q1 + i) * W;
    float nlM = 0.f, nlI = 0.f, nlD = 0.f;
    if (k >= 1) {
      nlM = __ldg(fM + rb + k - 1);
      nlI = __ldg(fI + rb + k - 1);
      nlD = __ldg(fD + rb + k - 1);
    }
    if (k < W) {
      const float ncM = __ldg(fM + rb + k), ncI = __ldg(fI + rb + k);
      const float ncD = __ldg(fD + rb + k);
      float bMd[4], bDd[4];
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        const bool in = k + d < W;
        bMd[d] = in ? __ldg(bM + rb + k + d) : 0.f;
        bDd[d] = in ? __ldg(bD + rb + k + d) : 0.f;
      }
      const int qp = i >= 1 ? __ldg(qb + i - 1) : 4;
      // em(d): the emission of the code at lane k + d (4 off the band)
      float em[6];
#pragma unroll
      for (int d = 0; d < 6; ++d) {
        const int kd = k + d - 2;
        em[d] = s_em[(kd >= 0 && kd < W) ? pc[d] : 4][qp];
      }
      const float bci = __ldg(bcb + i);
      const float cB = row_scale(__ldg(fcb + i), bci, lkb);
      // fcum before row 0 is -inf (its scale clamps to exp(-80))
      const float ninf = __int_as_float(0xff800000);
      const float cA = row_scale(i >= 1 ? __ldg(fcb + i - 1) : ninf, bci,
                                 lkb);
      const float cU2 = row_scale(i >= 2 ? __ldg(fcb + i - 2) : ninf, bci,
                                  lkb);
      const float cU3 = row_scale(i >= 3 ? __ldg(fcb + i - 3) : ninf, bci,
                                  lkb);
      const float A = tmm * flM + tim * flI + tdm * flD;      // from jc - 1
      const float An = tmm * fcM + tim * fcI + tdm * fcD;     // from jc
      const float Dnew = tmd * nlM + tid * nlI + tdd * nlD;
      const float Dn = tmd * ncM + tid * ncI + tdd * ncD;
      const float AbM = A * bMd[0] * cA;
      const float AnbM = An * bMd[0] * cA;
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const float ev = s_em[v][qp];
        s[S0 + v] += (double)(ev * AbM);
        s[I0 + v] += (double)(ev * AnbM);
      }
      s[SB] += (double)(ncD * bDd[0] * cB);
      s[IB] += (double)(Dn * bDd[0] * cB);
#pragma unroll
      for (int d = 1; d <= 3; ++d)
        s[D1 + d - 1] += (double)(em[2 + d] * A * bMd[d] * cA
                                  + Dnew * bDd[d] * cB);
      // tandem copies: bucket u of consumed query chars scales by cU[u]
      const float bM0 = bMd[0], bD0 = bDd[0];
      const float e0 = em[2], e1 = em[1];
      s[C1] += (double)(e0 * An * bM0 * cA + Dn * bD0 * cB);
      const float M12 = e1 * An;
      s[C1 + 1] += (double)(e0 * (tmm * cM12) * bM0 * cU2
                            + e0 * (tdm * cD) * bM0 * cA
                            + tdd * Dn * bD0 * cB + tmd * M12 * bD0 * cA);
      const float M13 = em[0] * An;
      const float Mb2 = e1 * (tmm * cM13), Mb1 = e1 * (tdm * cD);
      s[C1 + 2] += (double)(
          e0 * (tmm * cMb2) * bM0 * cU3
          + e0 * (tmm * cMb1 + tdm * (tmd * cM13)) * bM0 * cU2
          + e0 * (tdm * (tdd * cD)) * bM0 * cA
          + tdd * (tdd * Dn) * bD0 * cB
          + (tmd * Mb1 + tdd * (tmd * M13)) * bD0 * cA
          + tmd * Mb2 * bD0 * cU2);
      fcM = ncM; fcI = ncI; fcD = ncD;
      cM12 = M12; cM13 = M13; cMb2 = Mb2; cMb1 = Mb1; cD = Dn;
    }
    flM = nlM; flI = nlI; flD = nlD;
  }
  // the table's entries that take this column's sums
  float* ob = out + (size_t)b * (Tpad + 1) * NUM_EDIT;
  if (jc <= Tpad) {                              // insertions before jc
    const float base = (float)s[IB];
#pragma unroll
    for (int v = 0; v < 4; ++v)
      ob[(size_t)jc * NUM_EDIT + 4 + v] =
          jc <= tl ? logf(fmaxf((float)s[I0 + v] + base, EPS)) + lkb
                   : MASKED;
  }
  const int r = jc - 1;                          // sub and del at jc - 1
  if (r >= 0 && r <= Tpad) {
    const float base = (float)s[SB];
#pragma unroll
    for (int v = 0; v < 4; ++v)
      ob[(size_t)r * NUM_EDIT + v] =
          r < tl ? logf(fmaxf((float)s[S0 + v] + base, EPS)) + lkb : MASKED;
#pragma unroll
    for (int d = 1; d <= 3; ++d) {
      float val = MASKED;
      if (r == tl - d) {
        // deleting a block that ends the template: the forward mass at
        // (q_len, t_len - d)
        const int kl = min(max(tl - d - (int)offb[ql], 0), W - 1);
        const size_t c = ((size_t)b * Q1 + ql) * W + kl;
        val = logf(fM[c] + fI[c] + fD[c] + EPS) + fcb[ql];
      } else if (r + d <= tl) {
        val = logf(fmaxf((float)s[D1 + d - 1], EPS)) + lkb;
      }
      ob[(size_t)r * NUM_EDIT + 8 + COPY_SIZE + d - 1] = val;
    }
  }
#pragma unroll
  for (int c = 1; c <= COPY_SIZE; ++c) {         // copy c anchored at jc
    const int rc = jc - c;
    if (rc >= 0 && rc <= Tpad)
      ob[(size_t)rc * NUM_EDIT + 8 + c - 1] =
          rc + c <= tl ? logf(fmaxf((float)s[C1 + c - 1], EPS)) + lkb
                       : MASKED;
  }
}

extern "C" int modtable_assembly_launch(
    const int32_t* q, const int64_t* off, const int64_t* qlen,
    const int64_t* tlen, const float* trans, const float* me, const float* lk,
    const float* fM, const float* fI, const float* fD, const float* fcum,
    const int32_t* tpl, const float* bM, const float* bD, const float* bcum,
    float* out, int B, int Q, int W, int Tpad, int T, void* stream) {
  if (B == 0) return 0;
  if (W < 1 || Q < 0 || Tpad < 0 || T < 0) return GEOMETRY_ERROR;
  const int col_blocks = (Tpad + 1 + COPY_SIZE + THREADS - 1) / THREADS;
  if ((long long)B * col_blocks > INT_MAX) return GEOMETRY_ERROR;
  modtable_assembly_kernel<<<B * col_blocks, THREADS, 0,
                             (cudaStream_t)stream>>>(
      q, off, qlen, tlen, trans, me, lk, fM, fI, fD, fcum, tpl, bM, bD, bcum,
      out, Q, W, Tpad, T, col_blocks);
  return (int)cudaGetLastError();
}

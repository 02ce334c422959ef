// K1: banded 3-state pair-HMM forward and backward tables.
//
// Replace the Pallas kernels jtk_tpu/ops/pallas_phmm.py:197
// _fwd_tables_kernel and :337 _bwd_tables_kernel.  Same math, probability
// space with per-row rescaling: the forward pass rescales each row by its
// SUM, the backward pass by its MAX (the closed-form modification table
// joins the two cumulative scales, so they must not be mixed).
//
// Bound on the H100: bytes, the three (Q, W) f32 tables written once per
// pair and pass (~3 MB at Q = 2048, W = 128); ~40 flops per cell.  But a
// pair's rows form a chain of Q dependent steps, and the main path has
// only 40 (model tuning) to 192 (polish) pairs, one warp or a few each, so
// an SM scheduler runs one warp: the time is Q times the cycles one row
// takes that warp, which are about the instructions it issues (in order,
// with little to hide their latency).  The design keeps a row short.
//
// Design (geometry from ops/phmm_tables.py::tables_geometry):
// - L <= 4 consecutive band lanes a thread, in registers, and as many
//   warps per pair (WPP, 1 to 16) as the band needs; 4 warps a block (4
//   pairs of one warp, 2 of two, or one wider pair).  No __syncthreads.
//   Lanes >= W are masked: state 0, and a column no range test accepts.
// - Neighbour reads stay in the thread except at its two edge lanes (one
//   shuffle each).  The band shift is the same on every lane of a row, so a
//   row needs only one direction.
// - The in-row Del chain (forward D[k] = c[k] + tdd D[k-1], backward
//   D[k] = c[k] + tdd D[k+1]) runs serially over the thread's L lanes, a
//   5-step warp scan carries it between threads (tdd is per pair, so only
//   y is shuffled, with multipliers tdd^(L 2^s)), and a second serial pass
//   applies the carry.
// - The row scale (forward: sum, backward: max; an in-thread reduction and
//   a 5-step butterfly) is off the row-to-row chain: each row is computed
//   from the previous row before its scale, which is applied at the end of
//   the row (the rows are linear in the previous row).
// - With WPP > 1 the pair's warps exchange scan carries, scale partials and
//   edge lanes through shared memory under a named barrier over their own
//   threads: two barriers a row.
// - The row streams (shift, entering char, emissions) are copied with
//   cp.async into shared memory two 6-row tiles ahead and taken into
//   registers a tile at a time; a row broadcasts its shift, char and
//   insertion emission with __shfl_sync, and each lane reads the match
//   emission of its own ref code with one shuffle.  No global load, and no
//   register scoreboard of one, sits between one row and the next.
// - The loop stops at the pair's q_len; the frozen rows past it (forward)
//   or at and past it (backward) are written after / before the loop with
//   plain stores and a log scale of 0.
// - Table rows are written as 16-byte stores of a thread's lanes.
//
// The wide form (W 2049..4096, and the float64 tables above 1024 lanes):
// 8 or 16 lanes a thread and 8 warps a pair, the same row code with the
// row's state (M, I, D, column, char of each lane) in shared memory
// instead of registers (wb::Lanes), so that no thread's state spills; the
// row's temporaries stay in registers.
//
// The scratch form (W above 4096, both types; band_scratch.cuh): one block
// of SCRATCH_THREADS threads a pair, ceil(W / 512) lanes a thread, two
// rows of the state in a per-pair scratch in device memory, three passes
// over a thread's lanes a row with block barriers between them.  Right at
// any width, not fast: such bands occur only for a chunk template of more
// than ~4.1 kb with a read ~4 kb shorter than it.
//
// Scalar type: float, or double for the gradient's tables
// (ops/phmm_grad.py): a read that starts s bases late in its template
// opens with a deletion run of weight ~tdd^(s-1) against the row's other
// cells (~1e-52 at s = 26 with tdd 0.01), under float's range in a row
// scaled once; double reaches ~150 bases.  The emissions and transitions
// stay float; the state, the Del chain's powers of tdd, the row scales
// and the tables are of the type.
#include <cstddef>
#include <cstdint>

#include "band_scratch.cuh"
#include "warp_band.cuh"

// Per warp of a block: [0] scan total, [2] scale partial, [3..6] first
// lane's values, [7..9] last lane's values (the char code as bits of the
// type).
constexpr int SM_SLOTS = 12;
constexpr int GEOMETRY_ERROR = -2;
constexpr int SHARED_FORM_W = 4096;   // above, the scratch form
constexpr int MAX_REG_LANES = 4;   // above, the row state is in shared memory

// Dynamic shared memory of a block: the wide form's row state, three
// values of the type and two ints a lane.
template <typename T>
__host__ __device__ constexpr int state_bytes(int L, int nthreads) {
  return L > MAX_REG_LANES ? L * nthreads * (3 * (int)sizeof(T) + 8) : 0;
}

// Warps of a block: 4 pairs of one warp, 2 of two, or one wider pair.
__host__ __device__ constexpr int block_warps(int wpp) {
  return wpp >= 4 ? wpp : 4;
}

// A column no band lane reaches: masked lanes (k >= W) start there, so
// every range test of theirs fails and their state stays 0.
constexpr int NO_COLUMN = 1 << 30;

using bs::Trans;
using bs::load_trans;

// The three output tables at one thread's first lane of one row.
template <typename T>
struct TablePtrs {
  T *M, *I, *D;

  // A thread's L lanes of each table: 16-byte stores when ``vec`` (float;
  // row stride and first lane multiples of 4 floats), else lane by lane;
  // only the first ``nv`` = W - k0 lanes are band lanes.
  template <int L, class A>
  __device__ __forceinline__ void store(int nv, bool vec, const A& m,
                                        const A& i, const A& d) const {
    if constexpr (L % 4 == 0 && sizeof(T) == 4) {
      if (vec) {
#pragma unroll
        for (int g = 0; g < L; g += 4)
          if (g < nv) {
            *reinterpret_cast<float4*>(M + g) =
                make_float4(m[g], m[g + 1], m[g + 2], m[g + 3]);
            *reinterpret_cast<float4*>(I + g) =
                make_float4(i[g], i[g + 1], i[g + 2], i[g + 3]);
            *reinterpret_cast<float4*>(D + g) =
                make_float4(d[g], d[g + 1], d[g + 2], d[g + 3]);
          }
        return;
      }
    }
#pragma unroll
    for (int l = 0; l < L; ++l)
      if (l < nv) { M[l] = m[l]; I[l] = i[l]; D[l] = d[l]; }
  }
  __device__ __forceinline__ void step(ptrdiff_t n) { M += n; I += n; D += n; }
};

template <typename T, int L, int WPP>
__global__ void __launch_bounds__(32 * block_warps(WPP))
fwd_tables_kernel(const float* __restrict__ emis,
                  const int32_t* __restrict__ shifts,
                  const int32_t* __restrict__ inc,
                  const int32_t* __restrict__ rc0,
                  const int32_t* __restrict__ j0,
                  const T* __restrict__ m0, const T* __restrict__ i0,
                  const T* __restrict__ d0,
                  const int32_t* __restrict__ qlen,
                  const int32_t* __restrict__ tlen,
                  const int32_t* __restrict__ strand,
                  const float* __restrict__ trans,
                  const float* __restrict__ trans2, T* __restrict__ outM,
                  T* __restrict__ outI, T* __restrict__ outD,
                  T* __restrict__ outLs, int B, int Q, int W, int ppb) {
  constexpr bool SMEM = L > MAX_REG_LANES;
  constexpr int NT = 32 * block_warps(WPP);   // the block's threads
  __shared__ T sm[block_warps(WPP)][SM_SLOTS];
  __shared__ float streams[block_warps(WPP)][wb::STREAM_WORDS];
  extern __shared__ __align__(16) unsigned char state[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wip = warp % WPP;              // warp within the pair
  const int w0 = warp - wip;               // the pair's first warp
  const int b = blockIdx.x * ppb + warp / WPP;
  if (b >= B) return;                      // all of the pair's warps
  const int bar = 1 + warp / WPP;
  const int k0 = (wip * 32 + lane) * L;
  const int nv = W - k0;                   // band lanes of this thread
  const int wl = W - 1 - k0;               // local index of lane W - 1
  const bool vec = (W & 3) == 0;
  const Trans tr = load_trans(strand[b] > 0 ? trans2 : trans);
  const T dd = tr.dd;
  T a[5], am[5];
  wb::scan_powers(dd, L, a);
  wb::up_multipliers(a, lane, am);
  const T powT = wb::ipow(dd, L * lane);   // warp input -> thread input
  const T powW = wb::ipow(dd, 32 * L);     // across one warp
  const int ql = min(max(qlen[b], 0), Q);
  const int tl = tlen[b];
  const size_t wbase = (size_t)b * W;
  // T*: the last row computed, before its scale (at first row 0, scaled)
  wb::Lanes<T, L, SMEM, NT> TM, TI, TD;
  wb::Lanes<int, L, SMEM, NT> j, rc;
  {
    T* st = reinterpret_cast<T*>(state);
    int* si = reinterpret_cast<int*>(st + 3 * L * NT);
    TM.bind(st, threadIdx.x);
    TI.bind(st + L * NT, threadIdx.x);
    TD.bind(st + 2 * L * NT, threadIdx.x);
    j.bind(si, threadIdx.x);
    rc.bind(si + L * NT, threadIdx.x);
  }
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const bool v = l < nv;
    TM[l] = v ? m0[wbase + k0 + l] : T(0);
    TI[l] = v ? i0[wbase + k0 + l] : T(0);
    TD[l] = v ? d0[wbase + k0 + l] : T(0);
    j[l] = v ? j0[wbase + k0 + l] : NO_COLUMN;
    rc[l] = v ? rc0[wbase + k0 + l] : 4;
  }
  // edge lanes of the pair's neighbouring warps (0 at the band's ends)
  T lM = 0, lI = 0, lD = 0, rM = 0, rI = 0, rD = 0;
  int rR = 4;
  T* sw = sm[warp];
  auto exchange_edges = [&]() {
    if constexpr (WPP > 1) {
      if (lane == 0) {
        sw[3] = TM[0]; sw[4] = TI[0]; sw[5] = TD[0];
        wb::int_to_slot(sw[6], rc[0]);
      }
      if (lane == 31) { sw[7] = TM[L - 1]; sw[8] = TI[L - 1]; sw[9] = TD[L - 1]; }
      wb::pair_sync(bar, WPP * 32);
      if (lane == 0 && wip > 0) {
        lM = sm[warp - 1][7]; lI = sm[warp - 1][8]; lD = sm[warp - 1][9];
      }
      if (lane == 31 && wip < WPP - 1) {
        rM = sm[warp + 1][3]; rI = sm[warp + 1][4]; rD = sm[warp + 1][5];
        rR = wb::slot_to_int(sm[warp + 1][6]);
      }
    }
  };
  // the sum of the row in T* over the pair (the row's scale, less EPS)
  auto row_sum = [&]() {
    T s = 0;
#pragma unroll
    for (int l = 0; l < L; ++l) s += TM[l] + TI[l] + TD[l];
    return wb::warp_sum(s);
  };
  exchange_edges();
  const float* em = emis + (size_t)b * 5 * Q;
  const int32_t* srow = shifts + (size_t)b * Q;
  const int32_t* irow = inc + (size_t)b * Q;
  const size_t tb = (size_t)b * Q * W + k0;
  TablePtrs<T> out{outM + tb, outI + tb, outD + tb};
  T* oLs = outLs + (size_t)b * Q;
  wb::RowTile cur;
  cur.buf = streams[warp];
  cur.next = 0;
  cur.fetch(srow, irow, em, Q, ql, 0, 1, lane);
  cur.fetch(srow, irow, em, Q, ql, wb::TILE_ROWS, 1, lane);
  cur.take(lane);
  wb::Row rw = cur.row(0);
  int src = 0;

  // Row r from T = row r - 1 before its scale: the rows are linear in the
  // previous row, so the scale of row r - 1 (a reduction) runs beside the
  // row's own chain and is applied at its end.
  for (int r = 0; r < ql; ++r) {           // every row here is live
    const wb::Row nrw = cur.row(src + 1);  // the next row's streams
    T s = row_sum();
    T Mr[L], Ir[L];
    int rn[L];
    if (rw.sv == 1) {
      // diagonal from the same lane, up from lane k + 1
      T eM = __shfl_down_sync(FULL_MASK, TM[0], 1);
      T eI = __shfl_down_sync(FULL_MASK, TI[0], 1);
      T eD = __shfl_down_sync(FULL_MASK, TD[0], 1);
      int eR = __shfl_down_sync(FULL_MASK, rc[0], 1);
      if (lane == 31) { eM = rM; eI = rI; eD = rD; eR = rR; }
#pragma unroll
      for (int l = 0; l < L; ++l) {
        const T uM = l + 1 < L ? TM[l + 1] : eM;
        const T uI = l + 1 < L ? TI[l + 1] : eI;
        const T uD = l + 1 < L ? TD[l + 1] : eD;
        const int ur = l + 1 < L ? rc[l + 1] : eR;
        rn[l] = l == wl ? rw.nc : ur;
        Mr[l] = tr.mm * TM[l] + tr.im * TI[l] + tr.dm * TD[l];
        Ir[l] = tr.mi * uM + tr.ii * uI + tr.di * uD;
      }
    } else {
      // diagonal from lane k - 1, up from the same lane
      T eM = __shfl_up_sync(FULL_MASK, TM[L - 1], 1);
      T eI = __shfl_up_sync(FULL_MASK, TI[L - 1], 1);
      T eD = __shfl_up_sync(FULL_MASK, TD[L - 1], 1);
      if (lane == 0) { eM = lM; eI = lI; eD = lD; }
#pragma unroll
      for (int l = 0; l < L; ++l) {
        const T dM = l > 0 ? TM[l - 1] : eM;
        const T dI = l > 0 ? TI[l - 1] : eI;
        const T dD = l > 0 ? TD[l - 1] : eD;
        rn[l] = rc[l];
        Mr[l] = tr.mm * dM + tr.im * dI + tr.dm * dD;
        Ir[l] = tr.mi * TM[l] + tr.ii * TI[l] + tr.di * TD[l];
      }
    }
    float dmask[L];   // 1 where the Del state lives (column in 1..tl)
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
    // Del chain D[k] = c[k] + dd D[k-1], c[k] = md Mrow[k-1] + id Irow[k-1].
    // e_out is the thread's part of D at the next thread's first lane; the
    // scan carries it, and the thread's first lane takes the carry E_in.
    T c[L];
#pragma unroll
    for (int l = 1; l < L; ++l) c[l] = tr.md * Mr[l - 1] + tr.id * Ir[l - 1];
    T z = 0;
#pragma unroll
    for (int l = 1; l < L; ++l) z = wb::fma_t(dd, z, c[l]);
    const T e_out = wb::fma_t(dd, z, tr.md * Mr[L - 1] + tr.id * Ir[L - 1]);
    const T E = wb::warp_linrec_up(e_out, am);
    T Ein = __shfl_up_sync(FULL_MASK, E, 1);
    if (lane == 0) Ein = 0;
    T G = 0;   // D at the warp's first lane
    if constexpr (WPP > 1) {
      if (lane == 31) sw[0] = E;
      if (lane == 0) sw[2] = s;
      wb::pair_sync(bar, WPP * 32);
      for (int w = 0; w < wip; ++w) G = sm[w0 + w][0] + powW * G;
      s = 0;
      for (int w = 0; w < WPP; ++w) s += sm[w0 + w][2];
    }
    T Dr[L];
    T y = Ein + powT * G;
#pragma unroll
    for (int l = 0; l < L; ++l) {
      if (l > 0) y = wb::fma_t(dd, y, c[l]);
      Dr[l] = y * dmask[l];
    }
    const T inv = r == 0 ? T(1) : wb::rcp_approx(s + T(1e-30));
    if (r > 0) {                           // row r - 1, scaled
#pragma unroll
      for (int l = 0; l < L; ++l) { TM[l] *= inv; TI[l] *= inv; TD[l] *= inv; }
      out.template store<L>(nv, vec, TM, TI, TD);
      out.step(W);
      if (wip == 0 && lane == 0) oLs[r - 1] = s + T(1e-30);
    }
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
  if (ql > 0) {                            // the last row, scaled
    T s = row_sum();
    if constexpr (WPP > 1) {
      if (lane == 0) sw[2] = s;
      wb::pair_sync(bar, WPP * 32);
      s = 0;
      for (int w = 0; w < WPP; ++w) s += sm[w0 + w][2];
    }
    const T inv = wb::rcp_approx(s + T(1e-30));
#pragma unroll
    for (int l = 0; l < L; ++l) { TM[l] *= inv; TI[l] *= inv; TD[l] *= inv; }
    out.template store<L>(nv, vec, TM, TI, TD);
    out.step(W);
    if (wip == 0 && lane == 0) oLs[ql - 1] = s + T(1e-30);
  }
  // rows past q_len repeat the frozen state
  for (int r = ql; r < Q; ++r) {
    out.template store<L>(nv, vec, TM, TI, TD);
    out.step(W);
  }
  if (wip == 0) {                          // scales -> log scales
    __syncwarp();
    for (int r = lane; r < Q; r += 32)
      oLs[r] = r < ql ? wb::log_t(oLs[r]) : T(0);
  }
}

template <typename T, int L, int WPP>
__global__ void __launch_bounds__(32 * block_warps(WPP))
bwd_tables_kernel(const float* __restrict__ emis,
                  const int32_t* __restrict__ shifts,
                  const int32_t* __restrict__ inc,
                  const int32_t* __restrict__ rcq,
                  const int32_t* __restrict__ jq,
                  const T* __restrict__ bm0, const T* __restrict__ bi0,
                  const T* __restrict__ bd0,
                  const int32_t* __restrict__ qlen,
                  const int32_t* __restrict__ tlen,
                  const int32_t* __restrict__ strand,
                  const float* __restrict__ trans,
                  const float* __restrict__ trans2, T* __restrict__ outM,
                  T* __restrict__ outI, T* __restrict__ outD,
                  T* __restrict__ outLs, int B, int Q, int W, int ppb) {
  constexpr bool SMEM = L > MAX_REG_LANES;
  constexpr int NT = 32 * block_warps(WPP);   // the block's threads
  __shared__ T sm[block_warps(WPP)][SM_SLOTS];
  __shared__ float streams[block_warps(WPP)][wb::STREAM_WORDS];
  extern __shared__ __align__(16) unsigned char state[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wip = warp % WPP;
  const int w0 = warp - wip;
  const int b = blockIdx.x * ppb + warp / WPP;
  if (b >= B) return;
  const int bar = 1 + warp / WPP;
  const int k0 = (wip * 32 + lane) * L;
  const int nv = W - k0;
  const bool vec = (W & 3) == 0;
  const Trans tr = load_trans(strand[b] > 0 ? trans2 : trans);
  const T dd = tr.dd;
  T a[5], am[5];
  wb::scan_powers(dd, L, a);
  wb::down_multipliers(a, lane, am);
  const T powT = wb::ipow(dd, L * (31 - lane) + 1);  // next warp -> thread
  const T powW = wb::ipow(dd, 32 * L);               // across one warp
  const int ql = min(max(qlen[b], 0), Q);
  const int tl = tlen[b];
  const size_t wbase = (size_t)b * W;
  // T*: the last row computed (row i + 1), before its scale (at first the
  // scaled init at row q_len)
  wb::Lanes<T, L, SMEM, NT> TM, TI, TD;
  // rc: r[off[i] + k] at the current row; j: off[i] + k
  wb::Lanes<int, L, SMEM, NT> j, rc;
  {
    T* st = reinterpret_cast<T*>(state);
    int* si = reinterpret_cast<int*>(st + 3 * L * NT);
    TM.bind(st, threadIdx.x);
    TI.bind(st + L * NT, threadIdx.x);
    TD.bind(st + 2 * L * NT, threadIdx.x);
    j.bind(si, threadIdx.x);
    rc.bind(si + L * NT, threadIdx.x);
  }
  float vmask[L];
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const bool v = l < nv;
    TM[l] = v ? bm0[wbase + k0 + l] : T(0);
    TI[l] = v ? bi0[wbase + k0 + l] : T(0);
    TD[l] = v ? bd0[wbase + k0 + l] : T(0);
    j[l] = v ? jq[wbase + k0 + l] : NO_COLUMN;
    rc[l] = v ? rcq[wbase + k0 + l] : 4;
    vmask[l] = v ? 1.f : 0.f;
  }
  const size_t tb = (size_t)b * Q * W + k0;
  T* oLs = outLs + (size_t)b * Q;
  // rows at or past q_len keep the init state
  TablePtrs<T> out{outM + tb + (size_t)ql * W, outI + tb + (size_t)ql * W,
                   outD + tb + (size_t)ql * W};
  for (int i = ql; i < Q; ++i) {
    out.template store<L>(nv, vec, TM, TI, TD);
    out.step(W);
  }
  T lI = 0, rM = 0;
  int lR = 4;
  T* sw = sm[warp];
  auto exchange_edges = [&]() {
    if constexpr (WPP > 1) {
      if (lane == 0) sw[3] = TM[0];
      if (lane == 31) { sw[7] = TI[L - 1]; wb::int_to_slot(sw[8], rc[L - 1]); }
      wb::pair_sync(bar, WPP * 32);
      if (lane == 0 && wip > 0) {
        lI = sm[warp - 1][7]; lR = wb::slot_to_int(sm[warp - 1][8]);
      }
      if (lane == 31 && wip < WPP - 1) rM = sm[warp + 1][3];
    }
  };
  // the max of the row in T* over the pair (the row's scale, less EPS)
  auto row_max = [&]() {
    T m = 0;
#pragma unroll
    for (int l = 0; l < L; ++l) m = wb::max_t(m, TM[l] + TI[l] + TD[l]);
    return wb::warp_max(m);
  };
  exchange_edges();
  const float* em = emis + (size_t)b * 5 * Q;
  const int32_t* srow = shifts + (size_t)b * Q;
  const int32_t* irow = inc + (size_t)b * Q;
  out = TablePtrs<T>{outM + tb + (size_t)(ql - 1) * W,
                     outI + tb + (size_t)(ql - 1) * W,
                     outD + tb + (size_t)(ql - 1) * W};
  wb::RowTile cur;
  cur.buf = streams[warp];
  cur.next = 0;
  cur.fetch(srow, irow, em, Q, ql, ql - 1, -1, lane);
  cur.fetch(srow, irow, em, Q, ql, ql - 1 - wb::TILE_ROWS, -1, lane);
  cur.take(lane);
  wb::Row rw = cur.row(0);
  int src = 0;

  // Row i = q_len - 1 - n from T = row i + 1 before its scale (see the
  // forward kernel).
  for (int n = 0; n < ql; ++n) {
    const wb::Row nrw = cur.row(src + 1);
    T m = row_max();
    T M1[L], I1[L];
    int ri[L];
    if (rw.sv == 1) {
      // I from lane k - 1, M from the same lane; chars move right
      T eI = __shfl_up_sync(FULL_MASK, TI[L - 1], 1);
      int eR = __shfl_up_sync(FULL_MASK, rc[L - 1], 1);
      if (lane == 0) { eI = lI; eR = k0 == 0 ? rw.nc : lR; }
#pragma unroll
      for (int l = 0; l < L; ++l) {
        M1[l] = TM[l];
        I1[l] = l > 0 ? TI[l - 1] : eI;
        ri[l] = l > 0 ? rc[l - 1] : eR;
      }
    } else {
      T eM = __shfl_down_sync(FULL_MASK, TM[0], 1);
      if (lane == 31) eM = rM;
#pragma unroll
      for (int l = 0; l < L; ++l) {
        M1[l] = l + 1 < L ? TM[l + 1] : eM;
        I1[l] = TI[l];
        ri[l] = rc[l];
      }
    }
    T u[L], v[L], c[L];
    float okm[L];
#pragma unroll
    for (int l = 0; l < L; ++l) {
      const int ji = j[l] - rw.sv;
      const float e = cur.match(src, ri[l]);
      u[l] = (ji < tl ? e : 0.f) * M1[l];
      v[l] = rw.ei * I1[l];
      c[l] = (tr.dm * u[l] + tr.di * v[l]) * vmask[l];
      okm[l] = ji <= tl ? 1.f : 0.f;
      j[l] = ji;
      rc[l] = ri[l];
    }
    // reverse Del chain D[k] = c[k] + dd D[k+1]
    T z = 0;
#pragma unroll
    for (int l = L - 1; l >= 0; --l) z = wb::fma_t(dd, z, c[l]);
    const T Y = wb::warp_linrec_down(z, am);
    T Yn = __shfl_down_sync(FULL_MASK, Y, 1);
    if (lane == 31) Yn = 0;
    T Dn = 0;   // D at the first lane of the next warp
    if constexpr (WPP > 1) {
      if (lane == 0) { sw[0] = Y; sw[2] = m; }
      wb::pair_sync(bar, WPP * 32);
      for (int w = WPP - 1; w > wip; --w) Dn = sm[w0 + w][0] + powW * Dn;
      m = sm[w0][2];
      for (int w = 1; w < WPP; ++w) m = wb::max_t(m, sm[w0 + w][2]);
    }
    T Dr[L];
    T y = dd * Yn + powT * Dn;
#pragma unroll
    for (int l = L - 1; l >= 0; --l) {
      y = l == L - 1 ? c[l] + y : wb::fma_t(dd, y, c[l]);
      Dr[l] = y;
    }
    T wn = __shfl_down_sync(FULL_MASK, Dr[0], 1);
    if (lane == 31) wn = Dn;
    T Mr[L], Ir[L];
#pragma unroll
    for (int l = 0; l < L; ++l) {
      const T w = l + 1 < L ? Dr[l + 1] : wn;
      Mr[l] = (tr.mm * u[l] + tr.mi * v[l] + tr.md * w) * okm[l];
      Ir[l] = (tr.im * u[l] + tr.ii * v[l] + tr.id * w) * okm[l];
    }
    const T inv = n == 0 ? T(1) : wb::rcp_approx(m + T(1e-30));
    if (n > 0) {                           // row i + 1, scaled
#pragma unroll
      for (int l = 0; l < L; ++l) { TM[l] *= inv; TI[l] *= inv; TD[l] *= inv; }
      out.template store<L>(nv, vec, TM, TI, TD);
      out.step(-W);
      if (wip == 0 && lane == 0) oLs[ql - n] = m + T(1e-30);
    }
#pragma unroll
    for (int l = 0; l < L; ++l) {
      TM[l] = Mr[l] * inv;
      TI[l] = Ir[l] * inv;
      TD[l] = Dr[l] * okm[l] * inv;
    }
    exchange_edges();
    rw = nrw;
    if (++src == wb::TILE_ROWS) {
      src = 0;
      cur.fetch(srow, irow, em, Q, ql, ql - 2 - n - wb::TILE_ROWS, -1, lane);
      cur.take(lane);
    }
  }
  if (ql > 0) {                            // row 0, scaled
    T m = row_max();
    if constexpr (WPP > 1) {
      if (lane == 0) sw[2] = m;
      wb::pair_sync(bar, WPP * 32);
      m = sm[w0][2];
      for (int w = 1; w < WPP; ++w) m = wb::max_t(m, sm[w0 + w][2]);
    }
    const T inv = wb::rcp_approx(m + T(1e-30));
#pragma unroll
    for (int l = 0; l < L; ++l) { TM[l] *= inv; TI[l] *= inv; TD[l] *= inv; }
    out.template store<L>(nv, vec, TM, TI, TD);
    if (wip == 0 && lane == 0) oLs[0] = m + T(1e-30);
  }
  if (wip == 0) {                          // scales -> log scales
    __syncwarp();
    for (int i = lane; i < Q; i += 32)
      oLs[i] = i < ql ? wb::log_t(oLs[i]) : T(0);
  }
}

// The scratch form of the forward tables: one block a pair, the state in
// ``scratch`` (bs::pair_bytes<T>(W) bytes a pair).  Row r from row r - 1
// (scaled): M and I and the thread's part of the Del chain; the chain's
// carry, D and the row's sum; the scaled row, stored.
template <typename T>
__global__ void __launch_bounds__(bs::SCRATCH_THREADS)
fwd_tables_scratch(const float* __restrict__ emis,
                   const int32_t* __restrict__ shifts,
                   const int32_t* __restrict__ inc,
                   const int32_t* __restrict__ rc0,
                   const int32_t* __restrict__ j0, const T* __restrict__ m0,
                   const T* __restrict__ i0, const T* __restrict__ d0,
                   const int32_t* __restrict__ qlen,
                   const int32_t* __restrict__ tlen,
                   const int32_t* __restrict__ strand,
                   const float* __restrict__ trans,
                   const float* __restrict__ trans2, T* __restrict__ outM,
                   T* __restrict__ outI, T* __restrict__ outD,
                   T* __restrict__ outLs, int B, int Q, int W,
                   unsigned char* __restrict__ scratch) {
  __shared__ T tmp[32];
  const int b = blockIdx.x;
  const bs::Span sp(W);
  const Trans tr = load_trans(strand[b] > 0 ? trans2 : trans);
  const int ql = min(max(qlen[b], 0), Q);
  const int tl = tlen[b];
  const size_t wbase = (size_t)b * W + sp.k0;
  const bs::Rows<T> st(scratch + (size_t)b * bs::pair_bytes<T>(W), W);
  for (int l = 0; l < sp.n; ++l) {
    const int a = sp.at(l);
    st.M(0)[a] = m0[wbase + l];
    st.I(0)[a] = i0[wbase + l];
    st.D(0)[a] = d0[wbase + l];
    st.R(0)[a] = rc0[wbase + l];
  }
  int jb = j0[(size_t)b * W];   // lane k sits at column jb + k
  __syncthreads();
  const float* em = emis + (size_t)b * 5 * Q;
  const size_t tb = (size_t)b * Q * W + sp.k0;
  T* oLs = outLs + (size_t)b * Q;
  for (int r = 0; r < ql; ++r) {
    const int p = r & 1, q = p ^ 1;
    const int sv = shifts[(size_t)b * Q + r];
    const int jn0 = jb + sv;
    const T z = bs::fwd_pass1(st, sp, W, p, q, tr, em, Q, r, sv,
                              inc[(size_t)b * Q + r], em[4 * (size_t)Q + r],
                              jn0, tl);
    const T sc = bs::fwd_pass2(st, sp, q, tr.md, tr.id, T(tr.dd), z, jn0, tl,
                               tmp);
    const T inv = wb::rcp_approx(sc);
    T *nM = st.M(q), *nI = st.I(q), *nD = st.D(q);
    const size_t o = tb + (size_t)r * W;
    for (int l = 0; l < sp.n; ++l) {
      const int a = sp.at(l);
      const T m = nM[a] * inv, i = nI[a] * inv, d = nD[a] * inv;
      nM[a] = m; nI[a] = i; nD[a] = d;
      outM[o + l] = m; outI[o + l] = i; outD[o + l] = d;
    }
    if (threadIdx.x == 0) oLs[r] = sc;   // its log after the loop
    jb = jn0;
    __syncthreads();
  }
  // rows past q_len repeat the frozen state
  const int p = ql & 1;
  for (int r = ql; r < Q; ++r) {
    const size_t o = tb + (size_t)r * W;
    for (int l = 0; l < sp.n; ++l) {
      const int a = sp.at(l);
      outM[o + l] = st.M(p)[a];
      outI[o + l] = st.I(p)[a];
      outD[o + l] = st.D(p)[a];
    }
  }
  // scales -> log scales, outside the row loop (the double log's call
  // there would spill)
  for (int r = threadIdx.x; r < Q; r += blockDim.x)
    oLs[r] = r < ql ? wb::log_t(oLs[r]) : T(0);
}

// The scratch form of the backward tables: row i from row i + 1 (scaled),
// from the init at row q_len.  The reverse Del chain D[k] = c[k] + dd
// D[k+1] runs over a thread's lanes from its last, so both passes walk
// the lanes downwards.
template <typename T>
__global__ void __launch_bounds__(bs::SCRATCH_THREADS)
bwd_tables_scratch(const float* __restrict__ emis,
                   const int32_t* __restrict__ shifts,
                   const int32_t* __restrict__ inc,
                   const int32_t* __restrict__ rcq,
                   const int32_t* __restrict__ jq, const T* __restrict__ bm0,
                   const T* __restrict__ bi0, const T* __restrict__ bd0,
                   const int32_t* __restrict__ qlen,
                   const int32_t* __restrict__ tlen,
                   const int32_t* __restrict__ strand,
                   const float* __restrict__ trans,
                   const float* __restrict__ trans2, T* __restrict__ outM,
                   T* __restrict__ outI, T* __restrict__ outD,
                   T* __restrict__ outLs, int B, int Q, int W,
                   unsigned char* __restrict__ scratch) {
  __shared__ T tmp[32];
  const int b = blockIdx.x;
  const bs::Span sp(W);
  const Trans tr = load_trans(strand[b] > 0 ? trans2 : trans);
  const T dd = tr.dd;
  const int ql = min(max(qlen[b], 0), Q);
  const int tl = tlen[b];
  const size_t wbase = (size_t)b * W + sp.k0;
  const bs::Rows<T> st(scratch + (size_t)b * bs::pair_bytes<T>(W), W);
  const size_t tb = (size_t)b * Q * W + sp.k0;
  T* oLs = outLs + (size_t)b * Q;
  for (int l = 0; l < sp.n; ++l) {
    const int a = sp.at(l);
    const T m = bm0[wbase + l], i = bi0[wbase + l], d = bd0[wbase + l];
    st.M(0)[a] = m; st.I(0)[a] = i; st.D(0)[a] = d;
    st.R(0)[a] = rcq[wbase + l];
    for (int r = ql; r < Q; ++r) {   // rows at or past q_len keep the init
      const size_t o = tb + (size_t)r * W + l;
      outM[o] = m; outI[o] = i; outD[o] = d;
    }
  }
  int jb = jq[(size_t)b * W];   // lane k sits at column jb + k
  __syncthreads();
  const float* em = emis + (size_t)b * 5 * Q;
  for (int n = 0; n < ql; ++n) {
    const int i = ql - 1 - n;
    const int p = n & 1, q = p ^ 1;
    const int sv = shifts[(size_t)b * Q + i];
    const int nc = inc[(size_t)b * Q + i];
    const float ei = em[4 * (size_t)Q + i];
    const int ji0 = jb - sv;
    const T *cM = st.M(p), *cI = st.I(p);
    const int32_t* cR = st.R(p);
    T *nM = st.M(q), *nI = st.I(q), *nD = st.D(q);
    int32_t* nR = st.R(q);
    // pass 1: u = em M1 and v = ei I1 (kept in the new row's M and I), the
    // chars, and the thread's part of the chain at its first lane
    T z = 0;
    for (int l = sp.n - 1; l >= 0; --l) {
      const int k = sp.k0 + l, a = sp.at(l);
      T M1, I1;
      int ri;
      if (sv == 1) {   // I from lane k - 1, M from the same lane
        const int b1 = k > 0 ? sp.prev(l) : a;
        M1 = cM[a];
        I1 = k > 0 ? cI[b1] : T(0);
        ri = k > 0 ? cR[b1] : nc;
      } else {
        const int b1 = sp.next(l);
        M1 = k + 1 < W ? cM[b1] : T(0);
        I1 = cI[a];
        ri = cR[a];
      }
      const int ji = ji0 + k;
      const float e = ji < tl ? bs::match_emission(em, Q, i, ri) : 0.f;
      const T u = e * M1, v = ei * I1;
      nM[a] = u;
      nI[a] = v;
      nR[a] = ri;
      z = wb::fma_t(dd, z, tr.dm * u + tr.di * v);
    }
    // pass 2: the chain's carry from the lanes after the thread's, then D,
    // M and I of the row (0 past column tl) and its max
    T w = bs::block_linrec_down(z, dd, sp.C, tmp);   // D after the last lane
    T mx = 0;
    for (int l = sp.n - 1; l >= 0; --l) {
      const int a = sp.at(l);
      const T u = nM[a], v = nI[a];
      const T d = wb::fma_t(dd, w, tr.dm * u + tr.di * v);
      const bool ok = ji0 + sp.k0 + l <= tl;
      const T m = ok ? tr.mm * u + tr.mi * v + tr.md * w : T(0);
      const T ii = ok ? tr.im * u + tr.ii * v + tr.id * w : T(0);
      const T dm = ok ? d : T(0);
      nM[a] = m; nI[a] = ii; nD[a] = dm;
      mx = wb::max_t(mx, m + ii + dm);
      w = d;
    }
    const T sc = bs::block_reduce<T, true>(mx, tmp) + T(1e-30);
    const T inv = wb::rcp_approx(sc);
    const size_t o = tb + (size_t)i * W;
    for (int l = 0; l < sp.n; ++l) {
      const int a = sp.at(l);
      const T m = nM[a] * inv, ii = nI[a] * inv, d = nD[a] * inv;
      nM[a] = m; nI[a] = ii; nD[a] = d;
      outM[o + l] = m; outI[o + l] = ii; outD[o + l] = d;
    }
    if (threadIdx.x == 0) oLs[i] = sc;   // its log after the loop
    jb = ji0;
    __syncthreads();
  }
  // scales -> log scales (rows at or past q_len: 0)
  for (int r = threadIdx.x; r < Q; r += blockDim.x)
    oLs[r] = r < ql ? wb::log_t(oLs[r]) : T(0);
}

// The geometries this library is built for, by type: (lanes per thread,
// warps per pair).  ops/phmm_tables.py::tables_geometry picks one of them:
// the register form up to 4 lanes a thread, the wide form (state in shared
// memory) at 8 and 16 lanes and 8 warps; double takes the wide form above
// 1024 lanes, where the register form's 16 warps (512 threads, so 128
// registers a thread) would spill its state.
#define TABLE_GEOMETRIES_F32(X) \
  X(1, 1) X(2, 1) X(4, 1) X(4, 2) X(4, 4) X(4, 8) X(4, 16) X(16, 8)
#define TABLE_GEOMETRIES_F64(X) \
  X(1, 1) X(2, 1) X(4, 1) X(4, 2) X(4, 4) X(4, 8) X(8, 8) X(16, 8)

#define TABLE_ARGS(T)                                                       \
  const float *emis, const int32_t *shifts, const int32_t *inc,             \
      const int32_t *rc0, const int32_t *j0, const T *m0, const T *i0,      \
      const T *d0, const int32_t *qlen, const int32_t *tlen,                \
      const int32_t *strand, const float *trans, const float *trans2,       \
      T *outM, T *outI, T *outD, T *outLs, int B, int Q, int W, int lanes,  \
      int warps, int ppb, unsigned char *scratch, void *stream
#define TABLE_PASS                                                          \
  emis, shifts, inc, rc0, j0, m0, i0, d0, qlen, tlen, strand, trans,        \
      trans2, outM, outI, outD, outLs, B, Q, W

// Returns 0, a CUDA error code, or GEOMETRY_ERROR for a geometry the
// library was not built for (or that does not cover W).  Above
// SHARED_FORM_W the scratch form: ``lanes`` = ceil(W / SCRATCH_THREADS),
// SCRATCH_WARPS warps, one pair a block, and ``scratch`` holds
// bs::pair_bytes<T>(W) bytes a pair (ops/phmm_tables.py::scratch_bytes).
#define TABLE_LAUNCH(T, GEOMETRIES, KERNEL, SCRATCH_KERNEL)                 \
  if (B == 0) return 0;                                                     \
  if (W < 1 || ppb < 1 || lanes * 32 * warps < W) return GEOMETRY_ERROR;    \
  cudaStream_t s = (cudaStream_t)stream;                                    \
  if (W > SHARED_FORM_W) {                                                  \
    if (warps != bs::SCRATCH_WARPS || ppb != 1 || scratch == nullptr ||     \
        lanes != (W + bs::SCRATCH_THREADS - 1) / bs::SCRATCH_THREADS)       \
      return GEOMETRY_ERROR;                                                \
    SCRATCH_KERNEL<T><<<B, bs::SCRATCH_THREADS, 0, s>>>(TABLE_PASS,         \
                                                        scratch);           \
    return (int)cudaGetLastError();                                         \
  }                                                                         \
  if (ppb * warps > block_warps(warps)) return GEOMETRY_ERROR;              \
  const dim3 grid((B + ppb - 1) / ppb), block(ppb * warps * 32);            \
  bool known = false;                                                       \
  GEOMETRIES(KERNEL)                                                        \
  if (!known) return GEOMETRY_ERROR;                                        \
  return (int)cudaGetLastError();

#define TABLE_CASE(kernel, T, L_, WPP_)                                     \
  if (lanes == L_ && warps == WPP_) {                                       \
    const int smem = state_bytes<T>(L_, 32 * block_warps(WPP_));            \
    if (smem > 48 * 1024)                                                   \
      cudaFuncSetAttribute(kernel<T, L_, WPP_>,                             \
                           cudaFuncAttributeMaxDynamicSharedMemorySize,     \
                           smem);                                           \
    kernel<T, L_, WPP_><<<grid, block, smem, s>>>(TABLE_PASS, ppb);         \
    known = true;                                                           \
  }
#define FWD32_CASE(L_, WPP_) TABLE_CASE(fwd_tables_kernel, float, L_, WPP_)
#define FWD64_CASE(L_, WPP_) TABLE_CASE(fwd_tables_kernel, double, L_, WPP_)
#define BWD32_CASE(L_, WPP_) TABLE_CASE(bwd_tables_kernel, float, L_, WPP_)
#define BWD64_CASE(L_, WPP_) TABLE_CASE(bwd_tables_kernel, double, L_, WPP_)

extern "C" int fwd_tables_launch(TABLE_ARGS(float)) {
  TABLE_LAUNCH(float, TABLE_GEOMETRIES_F32, FWD32_CASE, fwd_tables_scratch)
}
extern "C" int fwd_tables64_launch(TABLE_ARGS(double)) {
  TABLE_LAUNCH(double, TABLE_GEOMETRIES_F64, FWD64_CASE, fwd_tables_scratch)
}

// The backward pass takes the band chars and columns of row Q (rcq, jq)
// and the backward init (bm0, bi0, bd0) in the forward's rc0, j0, m0, i0,
// d0 slots.
extern "C" int bwd_tables_launch(TABLE_ARGS(float)) {
  TABLE_LAUNCH(float, TABLE_GEOMETRIES_F32, BWD32_CASE, bwd_tables_scratch)
}
extern "C" int bwd_tables64_launch(TABLE_ARGS(double)) {
  TABLE_LAUNCH(double, TABLE_GEOMETRIES_F64, BWD64_CASE, bwd_tables_scratch)
}

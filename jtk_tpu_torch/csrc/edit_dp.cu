// K3: banded unit-cost edit DP with a packed traceback stream, and the walk
// over that stream.
//
// Replaces the Pallas kernel jtk_tpu/ops/pallas_k3.py::_edit_dp_kernel
// (launched by _pallas_edit) and the device walk beside it,
// pallas_k3.py::_traceback_packed (a lax.scan in the same jit).  Same band
// conventions: offsets with unit increments, rc[k] = r[j-1] for
// j = off_i + k.  Row-0 initialisation and the final score/end selection
// stay in the wrapper, so one kernel serves global and infix modes.
//
// Each query row: shift the band, take the diag and up candidates, solve
// the in-row ref-gap chain e[k] = min_{k'<=k} cand[k'] + (k - k') as a
// prefix min of cand[k] - k, and store one int16 (ptr | run << 2) per cell
// into the (Q, B, W) stream, run being the cell's left-run length.  The
// run start of a LEFT cell is the last lane before it that is not LEFT,
// which is the largest index attaining the prefix min of cand - k (that
// lane has e == cand; every lane after it up to the cell has e < cand).
// So one (value, index) min-scan, ties to the larger index, gives both.
//
// Bound on the H100: the stream write, 2 * q_len * W bytes per pair (1 MB
// at q_len 2048, W 256); ~20 integer operations per cell.  But a pair's
// rows form a chain of q_len dependent steps: with few pairs (dump_sam's
// whole reads, one pair a launch) a row costs the latency one warp issues;
// with many (the mapper's 2048) the card is full and a row costs the
// instructions it issues.  The design keeps a row short on both counts.
//
// Warp form, W <= 2048 (ops/edit_dp.py::edit_dp_geometry):
// - L <= 4 consecutive band lanes a thread, in registers, 1 to 16 warps a
//   pair; 4 warps a block (4 pairs of one warp, 2 of two) or one wider
//   pair.  No __syncthreads.  The pair's warps meet at a named barrier
//   over their own threads once a row (the scan's warp totals and the
//   edge lanes' candidates, see edit_dp_warp); a pair of one warp has none.
// - In-thread neighbours come from registers, a thread's edge lanes from
//   one shuffle each, a warp's edge lanes from shared memory.  Lanes past W
//   sit at no reachable column, so their e stays INF.
// - The (value, index) scan: a serial pass over the thread's lanes, a
//   5-step __shfl_up_sync scan of both, the warp totals at the barrier,
//   then a second serial pass.
// - The row streams (query char, shift, the char entering the band) are
//   copied with cp.async two 32-row tiles ahead into the warp's shared
//   memory and packed into one word a lane; a row takes its word with one
//   shuffle, a row ahead: no global load sits on the row-to-row chain.
// - A thread's four int16 cells go out as one 8-byte store.
// - The loop stops at the pair's q_len: rows past it are not written (the
//   walk never reads them); `last` is the state at row q_len.
// Block form, W 2049..8192 (a consensus tile over ~14 kb; never on the
// mapper): one block per pair, 4 or 8 lanes a thread, block-wide scans.
// Scratch form, W above 8192 (a tile over ~60 kb): the block form's row at
// any width, its state in shared memory or a per-pair scratch
// (edit_dp_scratch), and int32 cells, since a left run may pass 8191 lanes
// there and ptr | run << 2 would not fit an int16.
//
// The walk (edit_tb_kernel): one pair a block of two warps.  A pair's walk
// is serial (row i's cell depends on the column the walk reached), so
// only dependent shared reads may sit on its chain.  The row is known a
// step ahead (i falls by one a step), the column is not, so whole rows
// (or, with many pairs, windows of them) are copied ahead: the second
// warp keeps a ring of 16-row groups in flight in shared memory (TMA bulk
// copies from one lane, or cp.async from all 32 where many pairs share an
// SM), each group completing on its "full" mbarrier; the walking warp
// waits on that barrier by phase once a group, walks the group's steps,
// and releases it on its "empty" mbarrier.  The ring is as deep as the
// block's share of the SM's shared memory when all pairs are resident at
// once (~13 groups of W 512 rows for one pair, 3 groups of 128-cell
// windows at the mapper's 2048 pairs of W 256, whose walk is held by the
// bytes it copies).  A step is then one shared load and the integer
// update (a second load where the cell ends a left run).  The band
// offsets come a 32-step tile ahead, one shuffle a step; dels and ops go
// out a 32-step tile at a time.
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "warp_band.cuh"

#define EDIT_INF (1 << 30)
#define MIN_ID 0x7fffffff
#define MAX_ID (-0x7fffffff)

constexpr int GEOMETRY_ERROR = -2;
constexpr int MAX_WARPS = 16;        // warps a pair has at most (warp form)
constexpr int MAX_THREADS = 1024;    // threads of a pair's block (block form)
constexpr int TILE = 32;             // rows of streams a tile holds
constexpr int TILE_STEP = TILE - 1;  // tiles overlap one row (the next row)
// ints of shared memory a warp takes: two sets of exchange slots, two
// stream tiles
constexpr int SLOTS = 16;
constexpr int WARP_WORDS = SLOTS + 2 * 3 * TILE;

// Warps of a block in the warp form: 4 pairs of one warp, 2 of two, or one
// wider pair.
__host__ __device__ constexpr int block_warps(int wpp) {
  return wpp >= 4 ? wpp : 4;
}

#define EDIT_ARGS                                                           \
  const int32_t *__restrict__ e0, const int32_t *__restrict__ qs,           \
      const int32_t *__restrict__ shifts, const int32_t *__restrict__ inc,  \
      const int32_t *__restrict__ rc0, const int32_t *__restrict__ j0,      \
      const int32_t *__restrict__ qlen, const int32_t *__restrict__ tlen,   \
      int16_t *__restrict__ out, int32_t *__restrict__ last, int B, int Q,  \
      int W
#define EDIT_PASS e0, qs, shifts, inc, rc0, j0, qlen, tlen, out, last, B, Q, W

__device__ __forceinline__ void commit_group() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// The row streams of one pair, copied two tiles ahead into the warp's
// shared memory (wb::RowTile's scheme, for K3's three int streams).  Lane
// s of the current tile holds row row0 + s packed as one word: query char
// (bits 0-7), the char entering lane W - 1 (8-15), the shift (16-31).
struct EditRows {
  int* buf;   // the warp's 2 * 3 * TILE words
  int next;   // the buffer the next fetch fills
  int word;   // this lane's packed row of the current tile

  __device__ __forceinline__ void fetch(const int32_t* __restrict__ q,
                                        const int32_t* __restrict__ s,
                                        const int32_t* __restrict__ c, int n,
                                        int row0, int lane) {
    int* b = buf + next * 3 * TILE;
    const int r = row0 + lane;
    const bool in = r < n;
    const int a = in ? r : 0;
    wb::cp_async4(reinterpret_cast<float*>(b + lane), q + a, in);
    wb::cp_async4(reinterpret_cast<float*>(b + TILE + lane), s + a, in);
    wb::cp_async4(reinterpret_cast<float*>(b + 2 * TILE + lane), c + a, in);
    commit_group();
    next ^= 1;
  }

  // make the older of the two tiles in flight the current one (each lane
  // reads only the words it copied itself)
  __device__ __forceinline__ void take(int lane) {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    const int* b = buf + next * 3 * TILE;
    word = (b[lane] & 0xff) | ((b[2 * TILE + lane] & 0xff) << 8) |
           (b[TILE + lane] << 16);
  }
};

// A pair's warps meet once a row.  Before the barrier each warp publishes
// its scan total and its edge lanes' candidates (and the new char of its
// first lane); after it, each warp takes the carry from the warps before
// it and computes the neighbour warps' edge lanes of the new row itself:
// the last lane of warp w - 1 has e = min(cand, carry + k), the first lane
// of warp w + 1 has e = min(cand, min(carry, total) + k) (a lane's e needs
// only the prefix min's value; the index matters to run starts within a
// warp).  The slots alternate between two sets by row parity, so a warp
// that runs ahead into the next row never overwrites what another still
// reads.
// One block a multiprocessor as the launch bound's floor: with none,
// ptxas held the 4-warp form near 64 registers and spilled.
template <int L, int WPP>
__global__ void __launch_bounds__(32 * block_warps(WPP), 1)
edit_dp_warp(EDIT_ARGS, int ppb) {
  extern __shared__ int smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wip = warp % WPP;               // warp within the pair
  const int w0 = warp - wip;                // the pair's first warp
  const int b = blockIdx.x * ppb + warp / WPP;
  if (b >= B) return;                       // all of the pair's warps
  const int bar = 1 + warp / WPP;
  const int k0 = (wip * 32 + lane) * L;
  const int wl = W - 1 - k0;                // local index of lane W - 1
  const size_t base = (size_t)b * W;
  int e[L], rc[L];
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const bool v = k0 + l < W;
    e[l] = v ? e0[base + k0 + l] : EDIT_INF;
    rc[l] = v ? rc0[base + k0 + l] : 4;
  }
  const int ql = min(max(qlen[b], 0), Q);
  const int tl = tlen[b];
  int jb = j0[base];   // lane k sits at column jb + k (unit-step rows)
  int* sw = smem + warp * WARP_WORDS;
  // edge lanes of the pair's neighbouring warps (INF / 4 at the band ends)
  int eL = EDIT_INF, eR = EDIT_INF, rR = 4;
  if constexpr (WPP > 1) {   // row 0's edges (slots no row set uses)
    if (lane == 0) { sw[5] = e[0]; sw[6] = rc[0]; }
    if (lane == 31) sw[7] = e[L - 1];
    wb::pair_sync(bar, WPP * 32);
    if (lane == 0 && wip > 0) eL = sw[7 - WARP_WORDS];
    if (lane == 31 && wip < WPP - 1) {
      eR = sw[5 + WARP_WORDS];
      rR = sw[6 + WARP_WORDS];
    }
  }
  const int32_t* qrow = qs + (size_t)b * Q;
  const int32_t* srow = shifts + (size_t)b * Q;
  const int32_t* irow = inc + (size_t)b * Q;
  EditRows rows{sw + SLOTS, 0, 0};
  rows.fetch(qrow, srow, irow, ql, 0, lane);
  rows.fetch(qrow, srow, irow, ql, TILE_STEP, lane);
  rows.take(lane);
  int fetch_row = 2 * TILE_STEP;
  int pk = __shfl_sync(FULL_MASK, rows.word, 0);
  int src = 0;
  int16_t* o = out + base + k0;
  const size_t ostep = (size_t)B * W;
  const bool vec = L == 4 && (W & 3) == 0 && k0 < W;

  for (int i = 0; i < ql; ++i) {   // DP row i + 1, stream row i
    const int npk = __shfl_sync(FULL_MASK, rows.word, src + 1);
    const int qc = (pk << 24) >> 24, nc = (pk << 16) >> 24, sv = pk >> 16;
    const bool one = sv == 1;
    int eU = __shfl_down_sync(FULL_MASK, e[0], 1);    // lane k0 + L
    int rU = __shfl_down_sync(FULL_MASK, rc[0], 1);
    int eD = __shfl_up_sync(FULL_MASK, e[L - 1], 1);  // lane k0 - 1
    if (lane == 31) { eU = eR; rU = rR; }
    if (lane == 0) eD = eL;
    const int lim = min(tl - jb - sv, W - 1);   // column <= t_len
    const int lo = 1 - jb - sv;                 // column >= 1
    int cand[L];
    bool dg[L];                 // cand == diag
    int bv = MIN_ID, bi = -1;   // in-thread (value, index) prefix min
#pragma unroll
    for (int l = 0; l < L; ++l) {
      const int k = k0 + l;
      const int en = l + 1 < L ? e[l + 1] : eU;
      const int ep = l > 0 ? e[l - 1] : eD;
      const int rn = l == wl ? nc : (l + 1 < L ? rc[l + 1] : rU);
      const int rcn = one ? rn : rc[l];
      const bool ok = k <= lim;
      const int diag = (ok && k >= lo) ? (one ? e[l] : ep) + (rcn != qc)
                                       : EDIT_INF;
      const int up = ok ? (one ? en : e[l]) + 1 : EDIT_INF;
      cand[l] = min(diag, up);
      dg[l] = cand[l] == diag;
      rc[l] = rcn;              // lanes after l read rc[l + 1..], not rc[l]
      if (cand[l] - k <= bv) { bv = cand[l] - k; bi = k; }
    }
    int* set = sw + (i & 1) * 8;   // this row's slots
    if constexpr (WPP > 1) {
      if (lane == 0) { set[2] = cand[0]; set[3] = rc[0]; }
    }
    // warp scan of the threads' totals (a lower lane wins only if less; a
    // lane below s gets its own values back, which never win)
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
      const int ov = __shfl_up_sync(FULL_MASK, bv, s);
      const int oi = __shfl_up_sync(FULL_MASK, bi, s);
      if (ov < bv) { bv = ov; bi = oi; }
    }
    int pv = __shfl_up_sync(FULL_MASK, bv, 1);   // over the lanes before
    int pi = __shfl_up_sync(FULL_MASK, bi, 1);
    if (lane == 0) { pv = MIN_ID; pi = -1; }
    if constexpr (WPP > 1) {
      if (lane == 31) { set[0] = bv; set[1] = bi; set[4] = cand[L - 1]; }
      wb::pair_sync(bar, WPP * 32);
      int cv = MIN_ID, ci = -1;   // over the pair's warps before this one
#pragma unroll
      for (int w = 0; w < WPP - 1; ++w) {
        if (w < wip) {
          const int* t = set + (w - wip) * WARP_WORDS;
          const int tv = t[0];
          if (tv <= cv) { cv = tv; ci = t[1]; }
        }
      }
      if (lane == 0 && wip > 0) {        // lane k0 - 1 of the new row
        const int k = k0 - 1;
        eL = k <= lim ? min(set[4 - WARP_WORDS], cv + k) : EDIT_INF;
      }
      if (lane == 31 && wip < WPP - 1) { // lane k0 + L of the new row
        const int k = k0 + L;
        eR = k <= lim ? min(set[2 + WARP_WORDS], min(cv, bv) + k) : EDIT_INF;
        rR = set[3 + WARP_WORDS];
      }
      if (cv < pv) { pv = cv; pi = ci; }
    }
    int cell[L];
#pragma unroll
    for (int l = 0; l < L; ++l) {
      const int k = k0 + l;
      if (cand[l] - k <= pv) { pv = cand[l] - k; pi = k; }
      const int er = k <= lim ? min(cand[l], pv + k) : EDIT_INF;
      // diag wins ties over up over left; er < cand only by a left run
      cell[l] = er == cand[l] ? (dg[l] ? 0 : 1) : (2 | ((k - pi) << 2));
      e[l] = er;
    }
    if (vec) {
      *reinterpret_cast<uint2*>(o) =
          make_uint2((cell[0] & 0xffff) | (cell[1] << 16),
                     (cell[2] & 0xffff) | (cell[3] << 16));
    } else {
#pragma unroll
      for (int l = 0; l < L; ++l)
        if (l < W - k0) o[l] = (int16_t)cell[l];
    }
    o += ostep;
    jb += sv;
    pk = npk;
    if (++src == TILE_STEP) {
      src = 0;
      rows.fetch(qrow, srow, irow, ql, fetch_row, lane);
      rows.take(lane);
      fetch_row += TILE_STEP;
    }
  }
#pragma unroll
  for (int l = 0; l < L; ++l)
    if (k0 + l < W) last[base + k0 + l] = e[l];
}

// Inclusive prefix min (MIN) or max over the block's threads, and in
// ``ex`` the exclusive one, over the threads before this one (the identity
// for thread 0).  ``tmp`` holds one int per warp.  Every thread of the
// block must call it.  (Block form only.)
template <bool MIN>
__device__ __forceinline__ int block_scan(int v, int* tmp, int& ex) {
  const int ident = MIN ? MIN_ID : MAX_ID;
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  for (int s = 1; s < 32; s <<= 1) {
    const int o = __shfl_up_sync(FULL_MASK, v, s);
    if (lane >= s) v = MIN ? min(v, o) : max(v, o);
  }
  ex = __shfl_up_sync(FULL_MASK, v, 1);
  if (lane == 0) ex = ident;
  if (lane == 31) tmp[wid] = v;
  __syncthreads();
  if (wid == 0) {
    int t = lane < nw ? tmp[lane] : ident;
    for (int s = 1; s < 32; s <<= 1) {
      const int o = __shfl_up_sync(FULL_MASK, t, s);
      if (lane >= s) t = MIN ? min(t, o) : max(t, o);
    }
    if (lane < nw) tmp[lane] = t;
  }
  __syncthreads();
  if (wid > 0) {
    const int c = tmp[wid - 1];
    v = MIN ? min(v, c) : max(v, c);
    ex = MIN ? min(ex, c) : max(ex, c);
  }
  __syncthreads();
  return v;
}

// Block form: one block per pair, L lanes a thread; each prefix is a
// serial pass over a thread's lanes around a block scan of the threads'
// totals.  At 8 lanes 1024 threads must fit 64 registers a thread, which
// only the launch bound guarantees.
template <int L>
__global__ void __launch_bounds__(MAX_THREADS, 1) edit_dp_block(EDIT_ARGS) {
  extern __shared__ int smem[];
  const int nt = blockDim.x;
  int* tmp = smem;              // 32: the block scans' warp totals
  int* efirst = tmp + 32;       // e of each thread's first lane
  int* rfirst = efirst + nt;    // rc of its first lane
  int* elast = rfirst + nt;     // e of its last lane

  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int k0 = t * L;
  const size_t row_base = (size_t)b * W;
  int e[L], rc[L];
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const bool lane = k0 + l < W;
    e[l] = lane ? e0[row_base + k0 + l] : EDIT_INF;
    rc[l] = lane ? rc0[row_base + k0 + l] : 4;
  }
  int jb = j0[row_base];   // lane k sits at column jb + k (unit-step rows)
  const int ql = min(max(qlen[b], 0), Q);
  const int tl = tlen[b];
  const int32_t* qrow = qs + (size_t)b * Q;
  const int32_t* srow = shifts + (size_t)b * Q;
  const int32_t* irow = inc + (size_t)b * Q;

  for (int i = 1; i <= ql; ++i) {
    const int qc = qrow[i - 1];
    const int sv = srow[i - 1];
    const int newc = irow[i - 1];
    efirst[t] = e[0];
    elast[t] = e[L - 1];
    rfirst[t] = rc[0];
    __syncthreads();
    // the lanes beside the thread's own: k0 - 1 and k0 + L
    const int e_left = t > 0 ? elast[t - 1] : EDIT_INF;
    const int e_right = t + 1 < nt ? efirst[t + 1] : EDIT_INF;
    const int r_right = t + 1 < nt ? rfirst[t + 1] : 4;
    __syncthreads();
    const bool one = sv == 1;
    const int lim = min(tl - jb - sv, W - 1);   // column <= t_len
    const int lo = 1 - jb - sv;                 // column >= 1
    int cand[L];
    bool ok[L], dg[L];      // column <= t_len; cand == diag
    int run_min = MIN_ID;   // in-thread prefix min of cand[k] - k
#pragma unroll
    for (int l = 0; l < L; ++l) {
      const int k = k0 + l;
      const int e_next = k + 1 < W ? (l + 1 < L ? e[l + 1] : e_right)
                                   : EDIT_INF;        // roll left
      const int e_prev = k > 0 ? (l > 0 ? e[l - 1] : e_left)
                               : EDIT_INF;            // roll right
      const int rc_next = k == W - 1 ? newc
                          : (k + 1 < W ? (l + 1 < L ? rc[l + 1] : r_right)
                                       : 4);
      const int diag_v = one ? e[l] : e_prev;         // E[i-1][j-1]
      const int rc_n = one ? rc_next : rc[l];
      ok[l] = k <= lim;
      const int diag = (ok[l] && k >= lo) ? diag_v + (rc_n == qc ? 0 : 1)
                                          : EDIT_INF;
      // E[i-1][j] + 1
      const int up = ok[l] ? (one ? e_next : e[l]) + 1 : EDIT_INF;
      cand[l] = min(diag, up);
      dg[l] = cand[l] == diag;
      // lanes past W sit past the last real lane: they never feed a prefix
      run_min = min(run_min, k < W ? cand[l] - k : EDIT_INF);
      rc[l] = rc_n;           // lanes after l read rc[l + 1..], not rc[l]
    }
    // a thread's lanes after its first take the in-thread prefix from the
    // threads before (ex); its last lane's prefix is the inclusive scan's
    int ex;
    const int ymin = block_scan<true>(run_min, tmp, ex);
    int ptr[L];
    int run_max = MAX_ID;   // in-thread prefix max of the last non-LEFT lane
#pragma unroll
    for (int l = 0; l < L; ++l) {
      const int k = k0 + l;
      ex = min(ex, k < W ? cand[l] - k : EDIT_INF);
      const int y = l == L - 1 ? ymin : ex;
      const int er = ok[l] ? min(cand[l], y + k) : EDIT_INF;
      // diag wins ties over up over left; er < cand only by a left run
      ptr[l] = er == cand[l] ? (dg[l] ? 0 : 1) : 2;
      run_max = max(run_max, ptr[l] != 2 ? k : -1);
      e[l] = er;
    }
    jb += sv;
    int nl;
    const int nmax = block_scan<false>(run_max, tmp, nl);
    int16_t* o = out + ((size_t)(i - 1) * B + b) * W;
#pragma unroll
    for (int l = 0; l < L; ++l) {
      const int k = k0 + l;
      if (ptr[l] != 2) nl = max(nl, k);
      const int nonleft = l == L - 1 ? nmax : nl;
      const int run = ptr[l] == 2 ? k - nonleft : 0;
      if (k < W) o[k] = (int16_t)(ptr[l] | (run << 2));
    }
  }
#pragma unroll
  for (int l = 0; l < L; ++l)
    if (k0 + l < W) last[row_base + k0 + l] = e[l];
}

// The geometries this library is built for: (lanes a thread, warps a
// pair) in the warp form, and lanes a thread in the block form.
// ops/edit_dp.py::edit_dp_geometry picks one of them.
#define EDIT_WARP_GEOMETRIES(X)                                             \
  X(1, 1) X(2, 1) X(4, 1) X(4, 2) X(4, 3) X(4, 4) X(4, 5) X(4, 6) X(4, 7)    \
  X(4, 8) X(4, 9) X(4, 10) X(4, 11) X(4, 12) X(4, 13) X(4, 14) X(4, 15)     \
  X(4, 16)

#define EDIT_BLOCK_LANES(X) X(4) X(8)

// The scratch form, W above 8192 (int32 cells, STREAM_INT16_W): one block
// of MAX_THREADS threads a pair, C = ceil(W / MAX_THREADS) consecutive
// lanes a thread, whatever W.  A row is three passes over the thread's
// lanes around the block form's two block scans: the candidates (kept in
// the state with their diag flags), the new e, the cells.  The state, e
// and the band chars of two rows (the row read and the row written), the
// candidates and the flags, 15 bytes a lane (edit_state_bytes, W padded to
// C x MAX_THREADS lanes, a thread's lane l at l x MAX_THREADS + t so that a
// warp touches consecutive words), lies in shared memory where it fits
// (EDIT_SMEM_STATE, ~13 600 lanes), else in a per-pair scratch in device
// memory (L2-resident).
__host__ __device__ constexpr size_t edit_state_bytes(int W) {
  return ((size_t)(W + MAX_THREADS - 1) / MAX_THREADS * MAX_THREADS * 15 +
          15) / 16 * 16;
}
constexpr int EDIT_SMEM_STATE = 204800;   // 200 KB
constexpr int STREAM_INT16_W = 8192;   // ptr | run << 2 fits an int16

__global__ void __launch_bounds__(MAX_THREADS, 1)
edit_dp_scratch(const int32_t* __restrict__ e0, const int32_t* __restrict__ qs,
                const int32_t* __restrict__ shifts,
                const int32_t* __restrict__ inc,
                const int32_t* __restrict__ rc0,
                const int32_t* __restrict__ j0,
                const int32_t* __restrict__ qlen,
                const int32_t* __restrict__ tlen, int32_t* __restrict__ out,
                int32_t* __restrict__ last, int B, int Q, int W,
                unsigned char* __restrict__ scratch) {
  extern __shared__ __align__(16) unsigned char state_smem[];
  __shared__ int tmp[32];       // the block scans' warp totals
  const int b = blockIdx.x;
  const int t = threadIdx.x, NT = blockDim.x;
  const int C = (W + NT - 1) / NT;            // lanes a thread
  const int k0 = t * C, n = max(0, min(C, W - k0));
  const size_t L = (size_t)C * NT;            // lanes a state row holds
  // lane k0 + l at l NT + t; lanes k0 + l +- 1
  auto at = [&](int l) { return l * NT + t; };
  auto next = [&](int l) { return l + 1 < C ? (l + 1) * NT + t : t + 1; };
  auto prev = [&](int l) {
    return l > 0 ? (l - 1) * NT + t : (C - 1) * NT + t - 1;
  };
  unsigned char* base = scratch == nullptr
                            ? state_smem
                            : scratch + (size_t)b * edit_state_bytes(W);
  int* E = reinterpret_cast<int*>(base);          // [2][L] e of two rows
  int* CAND = E + 2 * L;                          // [L] candidates
  int8_t* RC = reinterpret_cast<int8_t*>(CAND + L);   // [2][L] band chars
  int8_t* DG = RC + 2 * L;                        // [L] cand == diag
  const size_t row_base = (size_t)b * W;
  for (int l = 0; l < n; ++l) {
    E[at(l)] = e0[row_base + k0 + l];
    RC[at(l)] = (int8_t)rc0[row_base + k0 + l];
  }
  int jb = j0[row_base];   // lane k sits at column jb + k (unit-step rows)
  const int ql = min(max(qlen[b], 0), Q);
  const int tl = tlen[b];
  const int32_t* qrow = qs + (size_t)b * Q;
  const int32_t* srow = shifts + (size_t)b * Q;
  const int32_t* irow = inc + (size_t)b * Q;
  __syncthreads();
  for (int i = 1; i <= ql; ++i) {
    const int p = (i - 1) & 1;
    const int* cE = E + p * L;
    int* nE = E + (p ^ 1) * L;
    const int8_t* cR = RC + p * L;
    int8_t* nR = RC + (p ^ 1) * L;
    const int qc = qrow[i - 1];
    const int sv = srow[i - 1];
    const int newc = irow[i - 1];
    const bool one = sv == 1;
    const int lim = min(tl - jb - sv, W - 1);   // column <= t_len
    const int lo = 1 - jb - sv;                 // column >= 1
    int run_min = MIN_ID;   // in-thread prefix min of cand[k] - k
    for (int l = 0; l < n; ++l) {
      const int k = k0 + l, a = at(l);
      const int ek = cE[a];
      const int e_next = k + 1 < W ? cE[next(l)] : EDIT_INF;
      const int e_prev = k > 0 ? cE[prev(l)] : EDIT_INF;
      const int rc_next = k + 1 < W ? cR[next(l)] : newc;
      const int rc_n = one ? rc_next : cR[a];
      const bool ok = k <= lim;
      const int diag = (ok && k >= lo) ? (one ? ek : e_prev) + (rc_n != qc)
                                       : EDIT_INF;
      const int up = ok ? (one ? e_next : ek) + 1 : EDIT_INF;
      const int cand = min(diag, up);
      CAND[a] = cand;
      DG[a] = cand == diag;
      nR[a] = (int8_t)rc_n;
      run_min = min(run_min, cand - k);
    }
    int ex;
    block_scan<true>(run_min, tmp, ex);
    int run_max = MAX_ID;   // in-thread prefix max of the last non-LEFT lane
    for (int l = 0; l < n; ++l) {
      const int k = k0 + l, a = at(l);
      const int cand = CAND[a];
      ex = min(ex, cand - k);
      const int er = k <= lim ? min(cand, ex + k) : EDIT_INF;
      if (er == cand) run_max = k;   // diag or up: not LEFT
      nE[a] = er;
    }
    int nl;
    block_scan<false>(run_max, tmp, nl);
    int32_t* o = out + ((size_t)(i - 1) * B + b) * W + k0;
    for (int l = 0; l < n; ++l) {
      // diag wins ties over up over left; e < cand only by a left run
      const int k = k0 + l, a = at(l);
      const int cand = CAND[a];
      const int ptr = nE[a] == cand ? (DG[a] ? 0 : 1) : 2;
      if (ptr != 2) nl = k;
      o[l] = ptr | (ptr == 2 ? (k - nl) << 2 : 0);
    }
    jb += sv;
  }
  const int* fE = E + (ql & 1) * L;
  for (int l = 0; l < n; ++l) last[row_base + k0 + l] = fE[at(l)];
}

#define WARP_CASE(L_, WPP_)                                                 \
  if (lanes == L_ && warps == WPP_) {                                       \
    edit_dp_warp<L_, WPP_><<<grid, block, shmem, s>>>(EDIT_PASS, ppb);      \
    known = true;                                                           \
  }

#define BLOCK_CASE(L_)                                                      \
  if (lanes == L_) {                                                        \
    edit_dp_block<L_><<<B, threads, shmem, s>>>(EDIT_PASS);                 \
    known = true;                                                           \
  }

// Returns 0, a CUDA error code, or GEOMETRY_ERROR for a geometry the
// library was not built for or that does not cover W.  ``warps`` <=
// MAX_WARPS selects the warp form (``ppb`` pairs a block); more, the block
// form (one pair a block, ``ppb`` 1) at 4 or 8 lanes, the scratch form
// above 8 (W above STREAM_INT16_W; ``out`` then holds int32 cells, and
// ``scratch`` edit_state_bytes(W) bytes a pair where the state does not
// fit EDIT_SMEM_STATE, else null).  ``out`` holds int16 cells up to
// STREAM_INT16_W.
extern "C" int edit_dp_launch(const int32_t* e0, const int32_t* qs,
                              const int32_t* shifts, const int32_t* inc,
                              const int32_t* rc0, const int32_t* j0,
                              const int32_t* qlen, const int32_t* tlen,
                              void* out_cells, int32_t* last, int B, int Q,
                              int W, int lanes, int warps, int ppb,
                              unsigned char* scratch, void* stream) {
  if (B == 0) return 0;
  if (W < 1 || Q < 1 || lanes < 1 || warps < 1 || ppb < 1 ||
      lanes * 32 * warps < W)
    return GEOMETRY_ERROR;
  cudaStream_t s = (cudaStream_t)stream;
  if (W > STREAM_INT16_W) {
    const bool in_smem = edit_state_bytes(W) <= EDIT_SMEM_STATE;
    if (warps != MAX_THREADS / 32 || ppb != 1 ||
        lanes != (W + MAX_THREADS - 1) / MAX_THREADS ||
        in_smem != (scratch == nullptr))
      return GEOMETRY_ERROR;
    const int shmem = in_smem ? (int)edit_state_bytes(W) : 0;
    if (shmem > 48 * 1024)
      cudaFuncSetAttribute(edit_dp_scratch,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, shmem);
    edit_dp_scratch<<<B, MAX_THREADS, shmem, s>>>(
        e0, qs, shifts, inc, rc0, j0, qlen, tlen,
        static_cast<int32_t*>(out_cells), last, B, Q, W, scratch);
    return (int)cudaGetLastError();
  }
  int16_t* out = static_cast<int16_t*>(out_cells);
  bool known = false;
  if (warps <= MAX_WARPS) {
    if (ppb * warps > block_warps(warps)) return GEOMETRY_ERROR;
    const dim3 grid((B + ppb - 1) / ppb), block(ppb * warps * 32);
    const size_t shmem = (size_t)ppb * warps * WARP_WORDS * sizeof(int);
    EDIT_WARP_GEOMETRIES(WARP_CASE)
  } else {
    const int threads = warps * 32;
    if (ppb != 1 || threads > MAX_THREADS) return GEOMETRY_ERROR;
    const size_t shmem = (3 * threads + 32) * sizeof(int);
    EDIT_BLOCK_LANES(BLOCK_CASE)
  }
  if (!known) return GEOMETRY_ERROR;
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The walk
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// arrive and expect ``bytes`` of asynchronous copies on the barrier
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// wait until the barrier's phase of parity ``parity`` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned a = smem_u32(bar);
  unsigned done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// bulk copy (TMA) of ``bytes`` (a multiple of 16, both addresses 16-byte
// aligned) global -> shared, completing on ``bar``
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// the barrier's phase of parity ``parity`` has completed (no wait)
__device__ __forceinline__ bool mbar_test(uint64_t* bar, unsigned parity) {
  unsigned done;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// Walk block shape: warp 0 walks, lane 0 of warp 1 produces.
constexpr int TB_THREADS = 64;
// Shared memory a walk block may take, and an SM holds (H100).
constexpr int TB_BLOCK_SMEM = 227 * 1024;
constexpr int TB_SM_SMEM = 228 * 1024;
constexpr int TB_GROUP = 16;         // rows a pair of barriers covers
constexpr int TB_WINDOW = 128;       // cells a slot holds in window mode
constexpr int TB_MAX_GROUPS = 128;

// Bytes of a ring slot: a stream row of W cells from the 16-byte aligned
// address at or before its start (up to 15 bytes before it).
__host__ __device__ constexpr size_t tb_slot_bytes(int W, int cell) {
  return ((size_t)W * cell + 15 + 15) / 16 * 16;
}

// 16-byte asynchronous copy global -> shared (cp.async, the LSU path)
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

// the barrier tracks the completion of this thread's earlier cp.asyncs,
// as one of its expected arrivals
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// One pair a block.  With NG > 0 stream rows come through a ring of NG
// groups of G slots in shared memory, filled by warp 1 (the producer):
// the rows of step group u (steps u G .. u G + G - 1, rows q_len - 1 - t)
// go into group u mod NG, all completing on the group's "full" barrier,
// once the walking warp has arrived on the group's "empty" barrier for
// the rows that held it before (the producer polls it with a back-off,
// so its waiting takes no issue slots from the walk).  With ``bulk`` one
// elected lane copies each row with one TMA bulk copy; else (narrow rows
// or windows and many pairs an SM, where TMA's cost a request would bound
// the copies) the warp's lanes copy 16 bytes each with cp.async, every
// lane arriving on the barrier when its copies land.  Each copy reads the
// row's aligned superset (the wrapper pads the stream's allocation by 16
// bytes).
//
// With WINDOW (many pairs and rows wider than two windows: the mapper)
// a slot holds ``win`` cells of its row from w0 on, w0 centred on the
// column the walk had when it left the group that held the slot before
// (the walk drifts a few lanes a step: a deletion run moves it by its
// length); a cell outside the window is read from device memory, so the
// window changes no bit.  Both sides compute w0 from that column, which
// the walking warp leaves in ``kpub`` before it arrives on the empty
// barrier; the first NG groups centre on the walk's first column.
//
// The walking warp waits on the full barrier by phase once a group, takes
// the group's G offsets by shuffle, walks its G steps (unrolled), and
// arrives on the empty barrier when it leaves the group.  A step is one
// shared load and the integer update, and a second load only where the
// cell ends a left run (the run's first cell says whether it was entered
// by a diagonal; where there is no run that cell is the one read).  G is
// TB_GROUP, or 1 for rows too wide for two groups of TB_GROUP; with NG 0
// (a row wider than a quarter of a block's shared memory) the walking
// warp reads its cells from device memory.
template <typename Cell, int G, bool WINDOW>
__global__ void __launch_bounds__(TB_THREADS)
edit_tb_kernel(const Cell* __restrict__ packed,
               const int64_t* __restrict__ off,
               const int32_t* __restrict__ qlen,
               const int64_t* __restrict__ endj, int32_t* __restrict__ dels,
               uint8_t* __restrict__ ops, int64_t* __restrict__ start, int B,
               int Q, int W, int NG, int slot_bytes, int bulk, int win) {
  // cells are never negative: read them unsigned (no sign extension)
  using U = typename std::make_unsigned<Cell>::type;
  extern __shared__ __align__(128) unsigned char tb_smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(tb_smem);   // [NG]
  uint64_t* empty = full + NG;                             // [NG]
  int* kpub = reinterpret_cast<int*>(empty + NG);          // [NG]
  unsigned char* ring =                                    // [NG * G][slot]
      tb_smem + 16 * (size_t)NG + ((size_t)NG * 4 + 15) / 16 * 16;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x;
  const int ql = min(max(qlen[b], 0), Q);
  const size_t pitch = (size_t)B * W * sizeof(Cell);   // bytes a row
  const size_t row_bytes = (size_t)W * sizeof(Cell);
  const int64_t* ob = off + (size_t)b * (Q + 1);
  const int k_init = min(max((int)(endj[b] - ob[ql]), 0), W - 1);
  // byte offset of step t's row in the stream
  auto row_byte = [&](int t) {
    return (size_t)(ql - 1 - t) * pitch + (size_t)b * row_bytes;
  };
  // the first window cell of the group u in ring group g
  auto window0 = [&](int u, int g) {
    if constexpr (!WINDOW) return 0;
    const int kr = u < NG ? k_init : kpub[g];
    return min(max(kr - win / 2, 0), W - win);
  };
  const size_t copy_bytes = WINDOW ? (size_t)win * sizeof(Cell) : row_bytes;
  if (NG > 0) {
    if (threadIdx.x == 0) {
      for (int s = 0; s < NG; ++s) {
        mbar_init(full + s, bulk ? 1 : 32);
        mbar_init(empty + s, 1);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }
  if (warp == 1) {   // the producer
    if (NG == 0 || (bulk && lane != 0)) return;
    const unsigned char* src = reinterpret_cast<const unsigned char*>(packed);
    int g = 0;
    unsigned phase = 0;
    for (int t0 = 0; t0 < ql; t0 += G) {
      const int rows = min(G, ql - t0);
      while (!mbar_test(empty + g, phase ^ 1)) __nanosleep(128);
      const size_t w0 = (size_t)window0(t0 / G, g) * sizeof(Cell);
      unsigned char* dst = ring + (size_t)g * G * slot_bytes;
      // row r's copy: its aligned superset from a0, n bytes
      auto span = [&](int r, size_t& a0) {
        const size_t c0 = row_byte(t0 + r) + w0;
        a0 = c0 & ~(size_t)15;
        return (unsigned)(((c0 + copy_bytes + 15) & ~(size_t)15) - a0);
      };
      size_t a0;
      if (bulk) {
        unsigned total = 0;
        for (int r = 0; r < rows; ++r) total += span(r, a0);
        mbar_expect_tx(full + g, total);
        for (int r = 0; r < rows; ++r) {
          const unsigned n = span(r, a0);
          bulk_copy(dst + (size_t)r * slot_bytes, src + a0, n, full + g);
        }
      } else {
        for (int r = 0; r < rows; ++r) {
          const int n = (int)span(r, a0) >> 4;
          for (int c = lane; c < n; c += 32)
            cp_async16(dst + (size_t)r * slot_bytes + 16 * c,
                       src + a0 + 16 * (size_t)c);
        }
        cp_async_arrive(full + g);
      }
      if (++g == NG) { g = 0; phase ^= 1; }
    }
    return;
  }
  // lane s of a tile holds the offset of step 32 * tile + s's row
  auto off_at = [&](int t) {
    const int i = ql - t;
    return i >= 1 ? (int)ob[i] : 0;
  };
  int offc = off_at(lane), offn = off_at(32 + lane);
  int j = (int)endj[b];
  int k = k_init;       // the column of the last step
  int dv = 0, ov = 0;   // this lane's step of the current 32-step tile
  int32_t* db = dels + (size_t)b * Q;
  uint8_t* opb = ops + (size_t)b * Q;
  const unsigned char* gsrc = reinterpret_cast<const unsigned char*>(packed);
  // step t's cell at column c: from its row ``rr`` (with WINDOW, the
  // window's cells w0 .. w0 + win - 1 of it, the rest from device memory)
  auto cell_at = [&](const U* rr, int t, int w0, int c) -> int {
    if constexpr (WINDOW) {
      if ((unsigned)(c - w0) >= (unsigned)win)
        return reinterpret_cast<const U*>(gsrc + row_byte(t))[c];
    }
    return rr[c];
  };
  // step t of the walk on row ``rr``, band offset ``off_i``
  auto step = [&](const U* rr, int w0, int off_i, int t) {
    k = min(max(j - off_i, 0), W - 1);
    const int cell = cell_at(rr, t, w0, k);
    const int run = cell >> 2;
    int diag = (cell & 3) == 0;   // no run: k's own cell
    if (run != 0) {
      const int k2 = min(max(k - run, 0), W - 1);
      diag = (cell_at(rr, t, w0, k2) & 3) == 0;
    }
    j -= run + diag;
    if (lane == (t & 31)) { dv = run; ov = diag ? 1 : 2; }
  };
  // after step t: a whole 32-step tile goes out, the next tile's offsets
  auto tile_end = [&](int t) {
    if ((t & 31) == 31) {
      db[t - 31 + lane] = dv;
      opb[t - 31 + lane] = (uint8_t)ov;
      offc = offn;
      offn = off_at(t + 33 + lane);
    }
  };
  if (NG > 0) {
    const unsigned pm = (unsigned)(pitch & 15);
    const unsigned bm = (unsigned)((size_t)b * row_bytes) & 15;
    int g = 0;
    unsigned phase = 0;
    for (int t0 = 0; t0 < ql; t0 += G) {
      int offs[G];
#pragma unroll
      for (int r = 0; r < G; ++r)   // G divides 32: one tile
        offs[r] = __shfl_sync(FULL_MASK, offc, (t0 + r) & 31);
      const int w0 = window0(t0 / G, g);
      const unsigned char* gb = ring + (size_t)g * G * slot_bytes;
      // row r's cells: the slot from its copy's offset in a 16-byte block,
      // indexed by column (the window's first column at w0)
      auto row = [&](int r) {
        const unsigned m =
            ((unsigned)(ql - 1 - t0 - r) * pm + bm + w0 * sizeof(Cell)) & 15;
        return reinterpret_cast<const U*>(gb + (size_t)r * slot_bytes + m) -
               w0;
      };
      mbar_wait(full + g, phase);
      if (t0 + G <= ql) {
#pragma unroll
        for (int r = 0; r < G; ++r) step(row(r), w0, offs[r], t0 + r);
      } else {   // the last group (offsets by shuffle: offs stays in
                 // registers)
        for (int r = 0; r < ql - t0; ++r)
          step(row(r), w0, __shfl_sync(FULL_MASK, offc, (t0 + r) & 31),
               t0 + r);
      }
      if (WINDOW && lane == 0) kpub[g] = k;
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + g);
      if (++g == NG) { g = 0; phase ^= 1; }
      if (t0 + G <= ql) tile_end(t0 + G - 1);
    }
  } else {
    for (int t = 0; t < ql; ++t) {   // WINDOW is false here
      step(reinterpret_cast<const U*>(gsrc + row_byte(t)), 0,
           __shfl_sync(FULL_MASK, offc, t & 31), t);
      tile_end(t);
    }
  }
  // the last partial tile, then zeros for the steps past q_len
  for (int t = (ql & ~31) + lane; t < Q; t += 32) {
    const bool rec = t < ql;
    db[t] = rec ? dv : 0;
    opb[t] = rec ? (uint8_t)ov : 0;
  }
  if (lane == 0) start[b] = j;
}

// The walk's ring: G rows a group (TB_GROUP, or 1 for rows too wide for
// two groups of TB_GROUP in a block) and as many groups as the block's
// share of an SM's shared memory holds when all B pairs are resident
// together (B over the SMs' count, at most 32 blocks an SM), at least 2
// (fewer pairs are then resident at once) and no more than the steps
// need; NG 0 (direct loads) where two slots do not fit a block.  With 4
// or more pairs an SM the copies go by cp.async, not TMA (``bulk`` 0), and
// rows wider than two windows by windows of TB_WINDOW cells (``win``).
// The SM count is the current device's, read at every launch: a process
// may launch on several cards.
void tb_ring(int B, int Q, int W, int cell, int& NG, int& G, int& bulk,
             int& win) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (sms <= 0) sms = 1;
  const int per_sm = min(32, (B + sms - 1) / sms);
  bulk = per_sm < 4;
  win = !bulk && W >= 2 * TB_WINDOW ? TB_WINDOW : 0;
  const size_t slot = tb_slot_bytes(win ? win : W, cell);
  const size_t budget =
      min((size_t)TB_BLOCK_SMEM, (size_t)TB_SM_SMEM / per_sm - 1024);
  G = 2 * (TB_GROUP * slot + 32) <= (size_t)TB_BLOCK_SMEM ? TB_GROUP : 1;
  const int need = (Q + G - 1) / G;
  NG = (int)min(max(budget / (G * slot + 32), (size_t)2),
                (size_t)min(max(need, 2), TB_MAX_GROUPS));
  if (2 * (G * slot + 32) > (size_t)TB_BLOCK_SMEM) NG = 0;
}

// ``packed`` holds int16 cells up to STREAM_INT16_W lanes, int32 above,
// 16-byte aligned with 16 bytes of allocation past its end (the wrapper
// checks both).  Returns 0, a CUDA error code, or GEOMETRY_ERROR.
extern "C" int edit_tb_launch(const void* packed, const int64_t* off,
                              const int32_t* qlen, const int64_t* endj,
                              int32_t* dels, uint8_t* ops, int64_t* start,
                              int B, int Q, int W, void* stream) {
  if (B == 0) return 0;
  if (W < 1 || Q < 1) return GEOMETRY_ERROR;
  cudaStream_t s = (cudaStream_t)stream;
  const int cell = W > STREAM_INT16_W ? 4 : 2;
  int NG, G, bulk, win;
  tb_ring(B, Q, W, cell, NG, G, bulk, win);
  const int slot = (int)tb_slot_bytes(win ? win : W, cell);
  const size_t shmem =
      (size_t)NG * (16 + (size_t)G * slot) + ((size_t)NG * 4 + 15) / 16 * 16;
#define TB_CASE(CELL_, G_, WIN_)                                            \
  if (cell == (int)sizeof(CELL_) && G == G_ && (win > 0) == WIN_) {         \
    if (shmem > 48 * 1024)                                                  \
      cudaFuncSetAttribute(edit_tb_kernel<CELL_, G_, WIN_>,                 \
                           cudaFuncAttributeMaxDynamicSharedMemorySize,     \
                           (int)shmem);                                     \
    edit_tb_kernel<CELL_, G_, WIN_><<<B, TB_THREADS, shmem, s>>>(           \
        static_cast<const CELL_*>(packed), off, qlen, endj, dels, ops, start, \
        B, Q, W, NG, slot, bulk, win);                                      \
  }
  TB_CASE(int16_t, TB_GROUP, false)
  TB_CASE(int16_t, TB_GROUP, true)
  TB_CASE(int16_t, 1, false)
  TB_CASE(int16_t, 1, true)
  TB_CASE(int32_t, TB_GROUP, false)
  TB_CASE(int32_t, TB_GROUP, true)
  TB_CASE(int32_t, 1, false)
  TB_CASE(int32_t, 1, true)
#undef TB_CASE
  return (int)cudaGetLastError();
}

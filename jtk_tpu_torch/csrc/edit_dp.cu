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
// Block form, W > 2048 (a consensus tile over ~14 kb; never on the mapper):
// one block per pair, 4 or 8 lanes a thread, block-wide scans.
//
// The walk (edit_tb_kernel): one warp per pair.  A pair's walk is serial
// (row i's cell depends on the column the walk reached), so only two
// dependent reads may sit on its chain: the warp copies the stream rows
// the walk will need next, 15 rows ahead (7 above 4096 lanes), into a
// shared-memory ring with cp.async (the row is known, i falls by one a
// step; the column is not, so whole rows), and every lane walks the same
// cells out of the ring.  The band offsets come a 32-step tile ahead, one
// shuffle a step; dels and ops go out a 32-step tile at a time.
#include <cstdint>

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
// MAX_WARPS selects the warp form (``ppb`` pairs a block), more the block
// form (one pair a block, ``ppb`` 1).
extern "C" int edit_dp_launch(const int32_t* e0, const int32_t* qs,
                              const int32_t* shifts, const int32_t* inc,
                              const int32_t* rc0, const int32_t* j0,
                              const int32_t* qlen, const int32_t* tlen,
                              int16_t* out, int32_t* last, int B, int Q, int W,
                              int lanes, int warps, int ppb, void* stream) {
  if (B == 0) return 0;
  if (W < 1 || Q < 1 || lanes < 1 || warps < 1 || ppb < 1 ||
      lanes * 32 * warps < W)
    return GEOMETRY_ERROR;
  cudaStream_t s = (cudaStream_t)stream;
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

// 16-byte asynchronous copy global -> shared of the first ``bytes`` (0 to
// 16) bytes, the rest zero-filled; the source address must be valid.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(gmem), "r"(bytes)
               : "memory");
}

template <int N>
__device__ __forceinline__ void wait_groups() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Ring depth (stream rows in flight) by band width: 16 rows up to 4096
// lanes, 8 above (a ring row of 8192 lanes is 16 KB).
constexpr int TB_DEPTH_WIDE = 4096;
// Shared memory the warps of one walk block may take together.
constexpr int TB_BLOCK_BYTES = 160 * 1024;
constexpr int TB_MAX_PAIRS = 4;

// int16 cells of one ring row: the row's W cells from a 16-byte aligned
// start, up to 7 cells before it.
__host__ __device__ constexpr int ring_row(int W) { return (W + 7 + 7) / 8 * 8; }

// ALIGNED: W a multiple of 8, so every stream row starts 16-byte aligned
// and is copied as W / 8 whole chunks; otherwise from the aligned cell at
// or before its start, zero-filled past the stream's end.  Step t reads
// ring slot t mod D; the copy for step t + D - 1 goes into the slot step
// t - 1 read, which every lane has left once it passes step t's
// __syncwarp.
template <int D, bool ALIGNED>
__global__ void __launch_bounds__(32 * TB_MAX_PAIRS)
edit_tb_kernel(const int16_t* __restrict__ packed,
               const int64_t* __restrict__ off,
               const int32_t* __restrict__ qlen,
               const int64_t* __restrict__ endj, int32_t* __restrict__ dels,
               uint8_t* __restrict__ ops, int64_t* __restrict__ start, int B,
               int Q, int W, int ppb) {
  extern __shared__ int4 smem4[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * ppb + warp;
  if (b >= B) return;
  const int rs = ring_row(W);
  int16_t* ring = reinterpret_cast<int16_t*>(smem4) + (size_t)warp * D * rs;
  const int ql = min(max(qlen[b], 0), Q);
  const int64_t* ob = off + (size_t)b * (Q + 1);
  const size_t total = (size_t)Q * B * W;   // stream cells
  const size_t pitch = (size_t)B * W;       // cells from one row to the next
  // stream row r of this pair into ring slot ``slot``
  auto fetch = [&](int r, int slot) {
    if (r >= 0) {
      int16_t* dst = ring + slot * rs;
      const size_t c0 = r * pitch + (size_t)b * W;
      if constexpr (ALIGNED) {
        const int16_t* srcp = packed + c0;
        for (int c = lane; c < (W >> 3); c += 32)
          cp_async16(dst + c * 8, srcp + c * 8, 16);
      } else {
        const size_t a0 = c0 & ~(size_t)7;
        const int n = (int)((c0 - a0 + W + 7) >> 3);
        for (int c = lane; c < n; c += 32) {
          const size_t cell = a0 + (size_t)c * 8;
          const int bytes = cell >= total ? 0
                            : (int)min((size_t)16, (total - cell) * 2);
          cp_async16(dst + c * 8, packed + (bytes ? cell : 0), bytes);
        }
      }
    }
    commit_group();
  };
  // lane s of a tile holds the offset of step 32 * tile + s's row
  auto off_at = [&](int t) {
    const int i = ql - t;
    return i >= 1 ? (int)ob[i] : 0;
  };
  for (int s = 0; s < D - 1; ++s) fetch(ql - 1 - s, s);
  int offc = off_at(lane), offn = off_at(32 + lane);
  int j = (int)endj[b];
  int dv = 0, ov = 0;   // this lane's step of the current 32-step tile
  int32_t* db = dels + (size_t)b * Q;
  uint8_t* opb = ops + (size_t)b * Q;
  for (int t = 0; t < ql; ++t) {
    const int row = ql - 1 - t;
    const int sl = t & 31;
    const int off_i = __shfl_sync(FULL_MASK, offc, sl);
    wait_groups<D - 2>();   // this row's copies, from every lane
    __syncwarp();
    const int16_t* rr = ring + (t % D) * rs;
    if constexpr (!ALIGNED) rr += (int)((row * pitch + (size_t)b * W) & 7);
    const int k = min(max(j - off_i, 0), W - 1);
    const int cell = rr[k];
    // the copies go out while the cell is read (they write another slot)
    fetch(row - (D - 1), (t + D - 1) % D);
    const int run = cell >> 2;
    const int k2 = min(max(k - run, 0), W - 1);
    const int diag = (rr[k2] & 3) == 0;
    j -= run + diag;
    if (lane == sl) { dv = run; ov = diag ? 1 : 2; }
    if (sl == 31) {
      db[t - 31 + lane] = dv;
      opb[t - 31 + lane] = (uint8_t)ov;
      offc = offn;
      offn = off_at(t + 33 + lane);
    }
  }
  // the last partial tile, then zeros for the steps past q_len
  for (int t = (ql & ~31) + lane; t < Q; t += 32) {
    const bool rec = t < ql;
    db[t] = rec ? dv : 0;
    opb[t] = rec ? (uint8_t)ov : 0;
  }
  if (lane == 0) start[b] = j;
  wait_groups<0>();
}

#define TB_LAUNCH(D_, AL_)                                                  \
  cudaFuncSetAttribute(edit_tb_kernel<D_, AL_>,                             \
                       cudaFuncAttributeMaxDynamicSharedMemorySize,         \
                       (int)shmem);                                         \
  edit_tb_kernel<D_, AL_><<<grid, block, shmem, s>>>(                       \
      packed, off, qlen, endj, dels, ops, start, B, Q, W, ppb);

// Returns 0, a CUDA error code, or GEOMETRY_ERROR.
extern "C" int edit_tb_launch(const int16_t* packed, const int64_t* off,
                              const int32_t* qlen, const int64_t* endj,
                              int32_t* dels, uint8_t* ops, int64_t* start,
                              int B, int Q, int W, void* stream) {
  if (B == 0) return 0;
  if (W < 1 || Q < 1) return GEOMETRY_ERROR;
  const int D = W <= TB_DEPTH_WIDE ? 16 : 8;
  const size_t warp_bytes = (size_t)D * ring_row(W) * sizeof(int16_t);
  const int ppb = (int)max((size_t)1, min((size_t)TB_MAX_PAIRS,
                                          TB_BLOCK_BYTES / warp_bytes));
  const size_t shmem = ppb * warp_bytes;
  const dim3 grid((B + ppb - 1) / ppb), block(32 * ppb);
  cudaStream_t s = (cudaStream_t)stream;
  // the stream's base is 16-byte aligned (the wrapper checks it)
  if (D == 16) {
    if ((W & 7) == 0) { TB_LAUNCH(16, true) } else { TB_LAUNCH(16, false) }
  } else {
    if ((W & 7) == 0) { TB_LAUNCH(8, true) } else { TB_LAUNCH(8, false) }
  }
  return (int)cudaGetLastError();
}

// K3: banded unit-cost edit DP with a packed traceback stream.
//
// Replaces the Pallas kernel jtk_tpu/ops/pallas_k3.py::_edit_dp_kernel
// (launched by _pallas_edit).  Same band conventions: offsets with unit
// increments, rc[k] = r[j-1] for j = off_i + k, rows past q_len frozen.
// Row-0 initialisation and the final score/end selection stay in the
// wrapper, so one kernel serves global and infix modes.
//
// Design: one block per pair; each thread holds L consecutive band lanes
// (L = 1, 2, 4 or 8, so that a block of at most 1024 threads covers W up to
// 8192; ops/edit_dp.py::edit_dp_geometry).  Each query row is one step:
// shift the band (neighbour lanes through shared memory), take the diag and
// up candidates, solve the in-row ref-gap chain e[k] = min_{k'<=k} cand[k']
// + (k - k') as a prefix min of cand[k] - k, find the left-run lengths as a
// prefix max of the last non-LEFT lane, and store one int16 (ptr | run <<
// 2) per cell into the (Q, B, W) stream.  At one lane a thread (W <= 1024,
// every launch of the mapper and of consensus tiles up to ~7 kb) each
// prefix is one block scan (edit_dp_row1); above, a thread's in-thread
// neighbours come from registers and each prefix is a serial pass over its
// lanes around an exclusive block scan of the threads' totals.
//
// Bound on the H100: the stream write, 2 * Q * W bytes per pair (1 MB at
// Q = 2048, W = 256); the DP itself is ~20 integer operations per cell.
// The rows of one pair are sequential, so the kernel relies on many pairs
// (blocks) in flight to hide the per-row barrier latency.
#include <cstdint>

#include <cuda_runtime.h>

#define FULL_MASK 0xffffffffu
#define EDIT_INF (1 << 30)
#define MIN_ID 0x7fffffff
#define MAX_ID (-0x7fffffff)

constexpr int GEOMETRY_ERROR = -2;
constexpr int MAX_THREADS = 1024;

// Inclusive prefix min (MIN) or max over the block's threads, and in
// ``ex`` (when EX) the exclusive one, over the threads before this one (the
// identity for thread 0).  ``tmp`` holds one int per warp.  Every thread of
// the block must call it.
template <bool MIN, bool EX>
__device__ __forceinline__ int block_scan(int v, int* tmp, int& ex) {
  const int ident = MIN ? MIN_ID : MAX_ID;
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  for (int s = 1; s < 32; s <<= 1) {
    const int o = __shfl_up_sync(FULL_MASK, v, s);
    if (lane >= s) v = MIN ? min(v, o) : max(v, o);
  }
  if constexpr (EX) {
    ex = __shfl_up_sync(FULL_MASK, v, 1);
    if (lane == 0) ex = ident;
  }
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
    if constexpr (EX) ex = MIN ? min(ex, c) : max(ex, c);
  }
  __syncthreads();
  return v;
}

#define EDIT_ARGS                                                           \
  const int32_t *__restrict__ e0, const int32_t *__restrict__ qs,           \
      const int32_t *__restrict__ shifts, const int32_t *__restrict__ inc,  \
      const int32_t *__restrict__ rc0, const int32_t *__restrict__ j0,      \
      const int32_t *__restrict__ qlen, const int32_t *__restrict__ tlen,   \
      int16_t *__restrict__ out, int32_t *__restrict__ last, int B, int Q,  \
      int W
#define EDIT_PASS e0, qs, shifts, inc, rc0, j0, qlen, tlen, out, last, B, Q, W

// One lane a thread: lane k is thread k, with none of the L-lane form's
// lane guards and exclusive-scan selects.
__device__ __forceinline__ void edit_dp_row1(EDIT_ARGS) {
  extern __shared__ int smem[];
  int* ebuf = smem;                 // blockDim.x
  int* rcbuf = ebuf + blockDim.x;   // blockDim.x
  int* tmp = rcbuf + blockDim.x;    // 32: the block scans' warp totals

  const int b = blockIdx.x;
  const int k = threadIdx.x;
  const bool lane = k < W;
  const size_t row_base = (size_t)b * W;
  int e = lane ? e0[row_base + k] : EDIT_INF;
  int j = lane ? j0[row_base + k] : 0;
  int rc = lane ? rc0[row_base + k] : 4;
  const int ql = qlen[b];
  const int tl = tlen[b];
  const int32_t* qrow = qs + (size_t)b * Q;
  const int32_t* srow = shifts + (size_t)b * Q;
  const int32_t* irow = inc + (size_t)b * Q;
  int unused;

  for (int i = 1; i <= Q; ++i) {
    const int qc = qrow[i - 1];
    const int sv = srow[i - 1];
    const int newc = irow[i - 1];
    ebuf[k] = e;
    rcbuf[k] = rc;
    __syncthreads();
    const int e_next = (k + 1 < W) ? ebuf[k + 1] : EDIT_INF;   // roll left
    const int e_prev = (k > 0) ? ebuf[k - 1] : EDIT_INF;       // roll right
    const int rc_next = (k == W - 1) ? newc : ((k + 1 < W) ? rcbuf[k + 1] : 4);
    __syncthreads();
    const bool one = sv == 1;
    int up = (one ? e_next : e) + 1;                 // E[i-1][j] + 1
    const int diag_v = one ? e : e_prev;              // E[i-1][j-1]
    const int rc_n = one ? rc_next : rc;
    const int j_n = j + sv;
    const bool ok = j_n <= tl;
    const int diag = (ok && j_n >= 1) ? diag_v + (rc_n == qc ? 0 : 1)
                                      : EDIT_INF;
    up = ok ? up : EDIT_INF;
    const int cand = min(diag, up);
    // padding lanes sit past the last real lane: they never feed a prefix
    const int y = block_scan<true, false>(lane ? cand - k : EDIT_INF, tmp,
                                          unused);
    const int er = ok ? min(cand, y + k) : EDIT_INF;
    // diag wins ties over up over left
    const int ptr = (er == diag) ? 0 : ((er == up) ? 1 : 2);
    const int nonleft = block_scan<false, false>((ptr != 2) ? k : -1, tmp,
                                                 unused);
    const int run = (ptr == 2) ? (k - nonleft) : 0;
    if (lane)
      out[((size_t)(i - 1) * B + b) * W + k] = (int16_t)(ptr | (run << 2));
    if (i <= ql) {
      e = er;
      j = j_n;
      rc = rc_n;
    }
  }
  if (lane) last[row_base + k] = e;
}

template <int L>
__device__ __forceinline__ void edit_dp_rows(EDIT_ARGS) {
  extern __shared__ int smem[];
  const int nt = blockDim.x;
  int* tmp = smem;              // 32: the block scans' warp totals
  int* efirst = tmp + 32;       // e of each thread's first lane
  int* rfirst = efirst + nt;    // rc of its first lane
  int* elast = L > 1 ? rfirst + nt : efirst;   // e of its last lane

  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int k0 = t * L;
  const size_t row_base = (size_t)b * W;
  int e[L], j[L], rc[L];
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const bool lane = k0 + l < W;
    e[l] = lane ? e0[row_base + k0 + l] : EDIT_INF;
    j[l] = lane ? j0[row_base + k0 + l] : 0;
    rc[l] = lane ? rc0[row_base + k0 + l] : 4;
  }
  const int ql = qlen[b];
  const int tl = tlen[b];
  const int32_t* qrow = qs + (size_t)b * Q;
  const int32_t* srow = shifts + (size_t)b * Q;
  const int32_t* irow = inc + (size_t)b * Q;

  for (int i = 1; i <= Q; ++i) {
    const int qc = qrow[i - 1];
    const int sv = srow[i - 1];
    const int newc = irow[i - 1];
    efirst[t] = e[0];
    if (L > 1) elast[t] = e[L - 1];
    rfirst[t] = rc[0];
    __syncthreads();
    // the lanes beside the thread's own: k0 - 1 and k0 + L
    const int e_left = t > 0 ? elast[t - 1] : EDIT_INF;
    const int e_right = t + 1 < nt ? efirst[t + 1] : EDIT_INF;
    const int r_right = t + 1 < nt ? rfirst[t + 1] : 4;
    __syncthreads();
    const bool one = sv == 1;
    int cand[L];
    bool ok[L], dg[L];      // column j_n <= t_len; cand == diag
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
      const int j_n = j[l] + sv;
      ok[l] = j_n <= tl;
      const int diag = (ok[l] && j_n >= 1) ? diag_v + (rc_n == qc ? 0 : 1)
                                           : EDIT_INF;
      // E[i-1][j] + 1
      const int up = ok[l] ? (one ? e_next : e[l]) + 1 : EDIT_INF;
      cand[l] = min(diag, up);
      dg[l] = cand[l] == diag;
      // lanes past W sit past the last real lane: they never feed a prefix
      run_min = min(run_min, k < W ? cand[l] - k : EDIT_INF);
      if (i <= ql) {          // lanes after l read rc[l + 1..], not rc[l]
        j[l] = j_n;
        rc[l] = rc_n;
      }
    }
    // a thread's lanes after its first take the in-thread prefix from the
    // threads before (ex); its last lane's prefix is the inclusive scan's
    int ex = MIN_ID;
    const int ymin = block_scan<true, (L > 1)>(run_min, tmp, ex);
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
      if (i <= ql) e[l] = er;
    }
    int nl = MAX_ID;
    const int nmax = block_scan<false, (L > 1)>(run_max, tmp, nl);
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

// No launch bound below 8 lanes: with one, ptxas holds a row near 32
// registers by recomputing shared addresses inside the row loop (the
// L-lane form at one lane: 269 instructions a row against 197, 10.0 ms
// against 7.8 at B 2048, Q 2048, W 256 on the H100).  At 8 lanes 1024
// threads must fit 64 registers a thread, which only the bound guarantees.
template <int L>
__global__ void edit_dp_kernel(EDIT_ARGS) {
  if constexpr (L == 1)
    edit_dp_row1(EDIT_PASS);
  else
    edit_dp_rows<L>(EDIT_PASS);
}

__global__ void __launch_bounds__(MAX_THREADS, 1)
edit_dp_kernel8(EDIT_ARGS) { edit_dp_rows<8>(EDIT_PASS); }

// The lanes a thread can hold (ops/edit_dp.py::edit_dp_geometry picks one).
#define EDIT_LANES(X) X(1) X(2) X(4) X(8)

#define EDIT_CASE(L_)                                                       \
  if (lanes == L_) {                                                        \
    if constexpr (L_ == 8)                                                  \
      edit_dp_kernel8<<<B, threads, shmem, (cudaStream_t)stream>>>(         \
          e0, qs, shifts, inc, rc0, j0, qlen, tlen, out, last, B, Q, W);    \
    else                                                                    \
      edit_dp_kernel<L_><<<B, threads, shmem, (cudaStream_t)stream>>>(      \
          e0, qs, shifts, inc, rc0, j0, qlen, tlen, out, last, B, Q, W);    \
    known = true;                                                           \
  }

// Returns 0, a CUDA error code, or GEOMETRY_ERROR for a lane count the
// library was not built for or one that leaves W more than 1024 threads.
extern "C" int edit_dp_launch(const int32_t* e0, const int32_t* qs,
                              const int32_t* shifts, const int32_t* inc,
                              const int32_t* rc0, const int32_t* j0,
                              const int32_t* qlen, const int32_t* tlen,
                              int16_t* out, int32_t* last, int B, int Q, int W,
                              int lanes, void* stream) {
  if (B == 0) return 0;
  if (W < 1 || lanes < 1) return GEOMETRY_ERROR;
  const int threads = ((W + lanes - 1) / lanes + 31) / 32 * 32;
  if (threads > MAX_THREADS) return GEOMETRY_ERROR;
  const size_t shmem = ((lanes > 1 ? 3 : 2) * threads + 32) * sizeof(int);
  bool known = false;
  EDIT_LANES(EDIT_CASE)
  if (!known) return GEOMETRY_ERROR;
  return (int)cudaGetLastError();
}

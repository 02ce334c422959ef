// K3: banded unit-cost edit DP with a packed traceback stream.
//
// Replaces the Pallas kernel jtk_tpu/ops/pallas_k3.py::_edit_dp_kernel
// (launched by _pallas_edit).  Same band conventions: offsets with unit
// increments, rc[k] = r[j-1] for j = off_i + k, rows past q_len frozen.
// Row-0 initialisation and the final score/end selection stay in the
// wrapper, so one kernel serves global and infix modes.
//
// Design: one block per pair, one thread per band lane (blockDim = W
// rounded up to a warp; W <= 1024).  Each query row is one step: shift the
// band (neighbour lanes through shared memory), take the diag and up
// candidates, solve the in-row ref-gap chain e[k] = min_{k'<=k} cand[k'] +
// (k - k') as a block prefix-min of cand[k] - k, find the left-run lengths
// as a block prefix-max of the last non-LEFT lane, and store one int16
// (ptr | run << 2) per cell into the (Q, B, W) stream.
//
// Bound on the H100: the stream write, 2 * Q * W bytes per pair (1 MB at
// Q = 2048, W = 256); the DP itself is ~20 integer operations per cell.
// The rows of one pair are sequential, so the kernel relies on many pairs
// (blocks) in flight to hide the per-row barrier latency.
#include <cstdint>

#include "block_scan.cuh"

#define EDIT_INF (1 << 30)

__global__ void edit_dp_kernel(const int32_t* __restrict__ e0,
                               const int32_t* __restrict__ qs,
                               const int32_t* __restrict__ shifts,
                               const int32_t* __restrict__ inc,
                               const int32_t* __restrict__ rc0,
                               const int32_t* __restrict__ j0,
                               const int32_t* __restrict__ qlen,
                               const int32_t* __restrict__ tlen,
                               int16_t* __restrict__ out,
                               int32_t* __restrict__ last,
                               int B, int Q, int W) {
  extern __shared__ int smem[];
  int* ebuf = smem;                 // blockDim.x
  int* rcbuf = ebuf + blockDim.x;   // blockDim.x
  int* tmp = rcbuf + blockDim.x;    // 32

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
    const int sub = (rc_n == qc) ? 0 : 1;
    const bool ok = j_n <= tl;
    const int diag = (ok && j_n >= 1) ? diag_v + sub : EDIT_INF;
    up = ok ? up : EDIT_INF;
    const int cand = min(diag, up);
    // padding lanes sit past the last real lane: they never feed a prefix
    const int y = block_prefix_min(lane ? cand - k : EDIT_INF, tmp);
    int er = min(cand, y + k);
    er = ok ? er : EDIT_INF;
    const int ptr = (er == diag) ? 0 : ((er == up) ? 1 : 2);
    const int nonleft = block_prefix_max((ptr != 2) ? k : -1, tmp);
    const int run = (ptr == 2) ? (k - nonleft) : 0;
    if (lane) {
      out[((size_t)(i - 1) * B + b) * W + k] = (int16_t)(ptr | (run << 2));
    }
    if (i <= ql) {
      e = er;
      j = j_n;
      rc = rc_n;
    }
  }
  if (lane) last[row_base + k] = e;
}

extern "C" int edit_dp_launch(const int32_t* e0, const int32_t* qs,
                              const int32_t* shifts, const int32_t* inc,
                              const int32_t* rc0, const int32_t* j0,
                              const int32_t* qlen, const int32_t* tlen,
                              int16_t* out, int32_t* last, int B, int Q, int W,
                              void* stream) {
  if (B == 0) return 0;
  const int threads = ((W + 31) / 32) * 32;
  const size_t shmem = (2 * threads + 32) * sizeof(int);
  edit_dp_kernel<<<B, threads, shmem, (cudaStream_t)stream>>>(
      e0, qs, shifts, inc, rc0, j0, qlen, tlen, out, last, B, Q, W);
  return (int)cudaGetLastError();
}

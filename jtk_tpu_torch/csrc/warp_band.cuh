// Warp-level building blocks for banded row wavefronts (one warp, or a few
// warps, per pair; no block barriers).
//
// A pair's band of W lanes is spread over 32 * WPP threads, each holding
// L consecutive lanes in registers: thread t of the pair holds lanes
// t*L .. t*L + L - 1.  In-row chains run serially over a thread's L lanes
// and then as a 5-step warp scan across the threads; the warps of one pair
// meet at a named barrier that covers only their own threads.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#ifndef FULL_MASK
#define FULL_MASK 0xffffffffu
#endif

namespace wb {

// Barrier over the ``nthreads`` threads of one pair's warps.  ``id`` >= 1
// (barrier 0 is __syncthreads'); ``nthreads`` is a multiple of 32.
__device__ __forceinline__ void pair_sync(int id, int nthreads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(nthreads) : "memory");
}

// fma, max, 1 / x and log in the tables' type (float, or double for the
// gradient's tables).
__device__ __forceinline__ float fma_t(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_t(double a, double b, double c) {
  return fma(a, b, c);
}
__device__ __forceinline__ float log_t(float x) { return logf(x); }
__device__ __forceinline__ double log_t(double x) { return log(x); }
__device__ __forceinline__ float max_t(float a, float b) {
  return fmaxf(a, b);
}
__device__ __forceinline__ double max_t(double a, double b) {
  return fmax(a, b);
}

// x^n for n >= 0 by squaring.
template <typename T>
__device__ __forceinline__ T ipow(T x, int n) {
  T r = 1;
  while (n > 0) {
    if (n & 1) r *= x;
    x *= x;
    n >>= 1;
  }
  return r;
}

// a[s] = x^(n * 2^s), s = 0..4: the multipliers of a warp scan of a linear
// recurrence with the same coefficient x on every lane, n lanes a thread.
template <typename T>
__device__ __forceinline__ void scan_powers(T x, int n, T (&a)[5]) {
  a[0] = ipow(x, n);
#pragma unroll
  for (int s = 1; s < 5; ++s) a[s] = a[s - 1] * a[s - 1];
}

// Per-thread multipliers of the up-scan below: am[s] = a[s] where the
// thread has a partner 2^s lanes down, else 0 (a[s] = A^(2^s), see
// scan_powers).
template <typename T>
__device__ __forceinline__ void up_multipliers(const T (&a)[5], int lane,
                                               T (&am)[5]) {
#pragma unroll
  for (int s = 0; s < 5; ++s) am[s] = lane >= (1 << s) ? a[s] : T(0);
}

// ... and of the down-scan: a partner 2^s lanes up.
template <typename T>
__device__ __forceinline__ void down_multipliers(const T (&a)[5], int lane,
                                                 T (&am)[5]) {
#pragma unroll
  for (int s = 0; s < 5; ++s) am[s] = lane + (1 << s) < 32 ? a[s] : T(0);
}

// Inclusive scan y_t = z_t + A * y_{t-1} (y_{-1} = 0) over the warp's
// threads, with am from up_multipliers.  Only y is shuffled: one shuffle
// and one FMA a step.
template <typename T>
__device__ __forceinline__ T warp_linrec_up(T y, const T (&am)[5]) {
#pragma unroll
  for (int s = 0; s < 5; ++s)
    y = fma_t(am[s], __shfl_up_sync(FULL_MASK, y, 1 << s), y);
  return y;
}

// Mirror: y_t = z_t + A * y_{t+1} (y_32 = 0), am from down_multipliers.
template <typename T>
__device__ __forceinline__ T warp_linrec_down(T y, const T (&am)[5]) {
#pragma unroll
  for (int s = 0; s < 5; ++s)
    y = fma_t(am[s], __shfl_down_sync(FULL_MASK, y, 1 << s), y);
  return y;
}

// 1 / x: within 1 ulp in float (MUFU.RCP alone; x must be a normal float).
__device__ __forceinline__ float rcp_approx(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}
// ... in double for x in float's normal range (a row's scale): the float
// reciprocal refined by two Newton steps, to double's precision, with no
// call to the division's slow path.
__device__ __forceinline__ double rcp_approx(double x) {
  double r = rcp_approx((float)x);
  r = r * fma(-x, r, 2.0);
  return r * fma(-x, r, 2.0);
}

// Butterfly sum / max: every lane gets the same bits (each step adds the
// same two partials in either order).
template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) v += __shfl_xor_sync(FULL_MASK, v, s);
  return v;
}

template <typename T>
__device__ __forceinline__ T warp_max(T v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1)
    v = max_t(v, __shfl_xor_sync(FULL_MASK, v, s));
  return v;
}

// A char code kept in a slot of the tables' type (a bit copy in float).
__device__ __forceinline__ void int_to_slot(float& slot, int x) {
  slot = __int_as_float(x);
}
__device__ __forceinline__ void int_to_slot(double& slot, int x) {
  slot = __longlong_as_double((long long)x);
}
__device__ __forceinline__ int slot_to_int(float x) {
  return __float_as_int(x);
}
__device__ __forceinline__ int slot_to_int(double x) {
  return (int)__double_as_longlong(x);
}

// A thread's L band lanes of one row's state.  In registers (SMEM false),
// the form up to 2048 lanes; or in shared memory, lane l of thread t at
// base[l * N + t] with N the block's threads, a compile-time stride, so
// each lane is an immediate offset from one address (SMEM true: the wide
// form, whose row state would not fit a thread's registers).  Indexed by
// compile-time lanes either way.
template <typename T, int L, bool SMEM, int N>
struct Lanes {
  T v[L];
  __device__ __forceinline__ void bind(T*, int) {}
  __device__ __forceinline__ T& operator[](int l) { return v[l]; }
  __device__ __forceinline__ const T& operator[](int l) const { return v[l]; }
};

template <typename T, int L, int N>
struct Lanes<T, L, true, N> {
  T* p;
  __device__ __forceinline__ void bind(T* base, int t) { p = base + t; }
  __device__ __forceinline__ T& operator[](int l) const { return p[l * N]; }
};

// Rows of streams a tile holds: the match emissions of a row take five
// lanes (ref codes 0..3 and the pad code 4, whose emission is 0).
constexpr int TILE_ROWS = 6;

// One row's streams: band shift, the char entering the band, and the
// insertion emission (the match emissions stay in the tile, see RowTile).
struct Row {
  int sv, nc;
  float ei;
};

// 4-byte asynchronous copy global -> shared (zero fill when !valid; the
// source address must be valid all the same).  The copies of a tile are
// one group; no register waits on them until the tile is taken.
__device__ __forceinline__ void cp_async4(float* smem, const void* gmem,
                                          bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 4 : 0)
               : "memory");
}

// Words of shared memory a warp's row streams take: two tiles of 4 x 32.
constexpr int STREAM_WORDS = 2 * 4 * 32;

// The row streams of one pair, TILE_ROWS rows a tile, copied two tiles
// ahead into the warp's shared memory with cp.async (so no global load,
// and no register scoreboard of one, sits between one row and the next),
// and taken into registers a tile at a time.  In the current tile, lane
// s <= TILE_ROWS holds the shift, entering char and insertion emission of
// row s (one row past the tile, so the next row's streams can be read
// while a row is computed); lane 5 s + c holds the match emission of ref
// code c at row s, so a lane reads its own code's emission with one
// shuffle (match).  Rows run from ``row0`` in direction ``dir`` (+1
// forward, -1 backward); rows outside 0..n-1, and code 4 (the pad), read
// as 0.  ``emis`` is the pair's (5, Q) emission block (match emissions of
// ref codes 0..3, then the insertion emission).
struct RowTile {
  int sv, nc;
  float ei, em;
  float* buf;   // the warp's STREAM_WORDS words
  int next;     // the buffer the next fetch fills

  // start copying the tile from row0 (call fetch twice, then take)
  __device__ __forceinline__ void fetch(const int32_t* __restrict__ shifts,
                                        const int32_t* __restrict__ inc,
                                        const float* __restrict__ emis, int Q,
                                        int n, int row0, int dir, int lane) {
    float* b = buf + next * 128;
    const int ra = row0 + dir * lane;
    const bool ina = lane <= TILE_ROWS && ra >= 0 && ra < n;
    const int sa = ina ? ra : 0;
    cp_async4(b + lane, shifts + sa, ina);
    cp_async4(b + 32 + lane, inc + sa, ina);
    cp_async4(b + 64 + lane, emis + 4 * Q + sa, ina);
    const int rb = row0 + dir * (lane / 5), code = lane % 5;
    const bool inb = lane < 5 * TILE_ROWS && code < 4 && rb >= 0 && rb < n;
    cp_async4(b + 96 + lane, emis + (inb ? code * Q + rb : 0), inb);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    next ^= 1;
  }

  // make the older of the two tiles in flight the current one
  __device__ __forceinline__ void take(int lane) {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    const float* b = buf + next * 128;
    sv = __float_as_int(b[lane]);
    nc = __float_as_int(b[32 + lane]);
    ei = b[64 + lane];
    em = b[96 + lane];
  }

  // the current tile's row s (0..TILE_ROWS), to every lane
  __device__ __forceinline__ Row row(int s) const {
    return Row{__shfl_sync(FULL_MASK, sv, s), __shfl_sync(FULL_MASK, nc, s),
               __shfl_sync(FULL_MASK, ei, s)};
  }

  // match emission of ref code rc (0..4) at the current tile's row s
  __device__ __forceinline__ float match(int s, int rc) const {
    return __shfl_sync(FULL_MASK, em, 5 * s + rc);
  }
};

}  // namespace wb

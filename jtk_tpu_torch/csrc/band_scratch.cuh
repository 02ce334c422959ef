// The K1 family's scratch form: a band of any width, one block a pair.
//
// Above 4096 lanes a row's state no longer fits the wide form's shared
// memory (16 lanes a thread, 8 warps).  Here a pair's block of
// SCRATCH_THREADS threads keeps two rows of its state (the row read and the
// row written, M, I, D and the band char of every lane) in a per-pair
// scratch in device memory, which stays L2-resident (~0.5 MB a pair at
// W 16 384 in double), and thread t walks the C = ceil(W / SCRATCH_THREADS)
// consecutive lanes from t * C (Span), kept at l * SCRATCH_THREADS + t for
// its lane l, so that a warp's 32 threads touch 32 consecutive words.  A row
// is three passes over the thread's lanes with block barriers between
// them: the M and I updates and the thread's part of the in-row Del
// chain; the chain's carry by a block scan and the D values with the row's
// sum or max; the scaled row.  The temporaries of a row stay in the
// scratch, so nothing scales with C in registers.  Used by phmm_tables.cu
// (tables, float and double) and phmm_lk.cu (the likelihood).
#pragma once

#include <cstddef>
#include <cstdint>

#include "warp_band.cuh"

namespace bs {

constexpr int SCRATCH_THREADS = 512;
constexpr int SCRATCH_WARPS = SCRATCH_THREADS / 32;

// Lanes of one scratch row: W padded to a multiple of SCRATCH_THREADS.
__host__ __device__ constexpr int row_lanes(int W) {
  return (W + SCRATCH_THREADS - 1) / SCRATCH_THREADS * SCRATCH_THREADS;
}

// Bytes of one pair's scratch at band width W: two rows of M, I, D of type
// T, then two rows of band chars.
template <typename T>
__host__ __device__ constexpr size_t pair_bytes(int W) {
  return (size_t)row_lanes(W) * 2 * (3 * sizeof(T) + sizeof(int32_t));
}

// A thread's lanes: band lanes k0 .. k0 + n - 1 (k0 = t C), lane k0 + l
// kept at at(l) = l NT + t of a scratch row; next(l) and prev(l) are where
// lanes k0 + l + 1 and k0 + l - 1 are kept (another thread's at the
// thread's two ends).
struct Span {
  int t, C, NT, k0, n;
  __device__ explicit Span(int W)
      : t(threadIdx.x), C((W + blockDim.x - 1) / blockDim.x),
        NT(blockDim.x) {
    k0 = t * C;
    n = max(0, min(C, W - k0));
  }
  __device__ __forceinline__ int at(int l) const { return l * NT + t; }
  __device__ __forceinline__ int next(int l) const {
    return l + 1 < C ? (l + 1) * NT + t : t + 1;
  }
  __device__ __forceinline__ int prev(int l) const {
    return l > 0 ? (l - 1) * NT + t : (C - 1) * NT + t - 1;
  }
};

// Inclusive scan y_t = z_t + x^n y_{t-1} over the block's threads in
// thread order (n lanes a thread, y_{-1} = 0); returns y_{t-1}, the carry
// into thread t's first lane.  ``tmp`` holds one value a warp.  Every
// thread of the block calls it.
template <typename T>
__device__ __forceinline__ T block_linrec_up(T z, T x, int n, T* tmp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T a[5], am[5];
  wb::scan_powers(x, n, a);
  wb::up_multipliers(a, lane, am);
  const T E = wb::warp_linrec_up(z, am);
  T Ein = __shfl_up_sync(FULL_MASK, E, 1);
  if (lane == 0) Ein = T(0);
  if (lane == 31) tmp[warp] = E;
  __syncthreads();
  const T powW = wb::ipow(x, 32 * n);
  T G = 0;   // y at the last thread of the warp before this one
  for (int w = 0; w < warp; ++w) G = tmp[w] + powW * G;
  __syncthreads();
  return Ein + wb::ipow(x, n * lane) * G;
}

// Mirror: y_t = z_t + x^n y_{t+1} over the threads in reverse order
// (y past the last thread 0); returns y_{t+1}.
template <typename T>
__device__ __forceinline__ T block_linrec_down(T z, T x, int n, T* tmp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  T a[5], am[5];
  wb::scan_powers(x, n, a);
  wb::down_multipliers(a, lane, am);
  const T Y = wb::warp_linrec_down(z, am);
  T Yn = __shfl_down_sync(FULL_MASK, Y, 1);
  if (lane == 31) Yn = T(0);
  if (lane == 0) tmp[warp] = Y;
  __syncthreads();
  const T powW = wb::ipow(x, 32 * n);
  T Dn = 0;   // y at the first thread of the warp after this one
  for (int w = nw - 1; w > warp; --w) Dn = tmp[w] + powW * Dn;
  __syncthreads();
  return Yn + wb::ipow(x, n * (31 - lane)) * Dn;
}

// Sum (MAX false) or max over the block's threads, the same value on
// every thread; the warps' partials are combined in warp order.
template <typename T, bool MAX>
__device__ __forceinline__ T block_reduce(T v, T* tmp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  v = MAX ? wb::warp_max(v) : wb::warp_sum(v);
  if (lane == 0) tmp[warp] = v;
  __syncthreads();
  T r = tmp[0];
  for (int w = 1; w < nw; ++w) r = MAX ? wb::max_t(r, tmp[w]) : r + tmp[w];
  __syncthreads();
  return r;
}

// One pair's scratch: row p (0 or 1) of M, I, D and of the band chars,
// row_lanes(W) each.
template <typename T>
struct Rows {
  T* s;
  int32_t* c;
  int L;
  __device__ Rows(unsigned char* base, int W)
      : s(reinterpret_cast<T*>(base)),
        c(reinterpret_cast<int32_t*>(base + (size_t)6 * row_lanes(W) *
                                                sizeof(T))),
        L(row_lanes(W)) {}
  __device__ __forceinline__ T* M(int p) const {
    return s + (size_t)p * 3 * L;
  }
  __device__ __forceinline__ T* I(int p) const { return M(p) + L; }
  __device__ __forceinline__ T* D(int p) const { return M(p) + 2 * L; }
  __device__ __forceinline__ int32_t* R(int p) const {
    return c + (size_t)p * L;
  }
};

// Transitions [from, to] with M = 0, I = 1, D = 2.
struct Trans {
  float mm, mi, md, im, ii, id, dm, di, dd;
};

__device__ __forceinline__ Trans load_trans(const float* t) {
  // t is the padded (8, 8) table
  Trans r;
  r.mm = t[0]; r.mi = t[1]; r.md = t[2];
  r.im = t[8]; r.ii = t[9]; r.id = t[10];
  r.dm = t[16]; r.di = t[17]; r.dd = t[18];
  return r;
}

// Row r's match emission of ref code rc (0 for code 4, the pad) from the
// pair's (5, Q) emission block.
__device__ __forceinline__ float match_emission(const float* em, int Q, int r,
                                                int rc) {
  return rc < 4 ? em[(size_t)rc * Q + r] : 0.f;
}

// The forward recursion's first pass over the thread's lanes of the new
// row (into row q of the scratch) from row p: M and I, the band chars, and
// the thread's part of the Del chain D[k] = c[k] + dd D[k-1], c[k] = md
// M[k-1] + id I[k-1], at the lane after its last (returned).  ``jn0`` is
// the new row's column at lane 0, ``sv`` its shift, ``nc`` the char
// entering lane W - 1.
template <typename T>
__device__ __forceinline__ T fwd_pass1(const Rows<T>& st, const Span& sp,
                                       int W, int p, int q, const Trans& tr,
                                       const float* em, int Q, int r, int sv,
                                       int nc, float ei, int jn0, int tl) {
  const T *cM = st.M(p), *cI = st.I(p), *cD = st.D(p);
  const int32_t* cR = st.R(p);
  T *nM = st.M(q), *nI = st.I(q);
  int32_t* nR = st.R(q);
  const T dd = tr.dd;
  T z = 0;
  for (int l = 0; l < sp.n; ++l) {
    const int k = sp.k0 + l, a = sp.at(l);
    T dM, dI, dD, uM, uI, uD;
    int rn;
    if (sv == 1) {   // diagonal from the same lane, up from lane k + 1
      dM = cM[a]; dI = cI[a]; dD = cD[a];
      const bool in = k + 1 < W;
      const int b = sp.next(l);
      uM = in ? cM[b] : T(0);
      uI = in ? cI[b] : T(0);
      uD = in ? cD[b] : T(0);
      rn = in ? cR[b] : nc;
    } else {         // diagonal from lane k - 1, up from the same lane
      const bool in = k > 0;
      const int b = in ? sp.prev(l) : a;
      dM = in ? cM[b] : T(0);
      dI = in ? cI[b] : T(0);
      dD = in ? cD[b] : T(0);
      uM = cM[a]; uI = cI[a]; uD = cD[a];
      rn = cR[a];
    }
    const int jn = jn0 + k;
    const bool ok = (unsigned)(jn - 1) < (unsigned)tl;   // 1 <= jn <= tl
    const float e = ok ? match_emission(em, Q, r, rn) : 0.f;
    const T Mr = (tr.mm * dM + tr.im * dI + tr.dm * dD) * e;
    const T Ir =
        (tr.mi * uM + tr.ii * uI + tr.di * uD) * (jn <= tl ? ei : 0.f);
    nM[a] = Mr;
    nI[a] = Ir;
    nR[a] = rn;
    z = wb::fma_t(dd, z, tr.md * Mr + tr.id * Ir);
  }
  return z;
}

// The forward row's second pass: the Del chain's carry (a block scan of the
// threads' parts ``z``), D over the thread's lanes of row q (0 outside
// columns 1..tl), and the row's sum plus EPS, the same on every thread.
template <typename T>
__device__ __forceinline__ T fwd_pass2(const Rows<T>& st, const Span& sp,
                                       int q, float md, float id, T dd, T z,
                                       int jn0, int tl, T* tmp) {
  const T carry = block_linrec_up(z, dd, sp.C, tmp);
  const T *nM = st.M(q), *nI = st.I(q);
  T* nD = st.D(q);
  T y = carry, s = 0, pM = 0, pI = 0;
  for (int l = 0; l < sp.n; ++l) {
    if (l > 0) y = wb::fma_t(dd, y, md * pM + id * pI);
    const int a = sp.at(l);
    const T Mk = nM[a], Ik = nI[a];
    const int jn = jn0 + sp.k0 + l;
    const T Dk = (unsigned)(jn - 1) < (unsigned)tl ? y : T(0);
    nD[a] = Dk;
    s += Mk + Ik + Dk;
    pM = Mk;
    pI = Ik;
  }
  return block_reduce<T, false>(s, tmp) + T(1e-30);
}

}  // namespace bs

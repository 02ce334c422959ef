// The Metropolis clustering chain: one draw block of steps for every
// (chunk, restart) lane.
//
// Replaces the device loop of jtk_tpu/ops/cluster.py:184 (the lax.scan of
// mcmc_cluster_batch; no Pallas kernel).  A step of lane (b, s): pick read
// i = idx[t], move it from its cluster `old` to `new` = prop + (prop >=
// old), apply the read's row (+-1) to the K x V aggregates (gain, positive
// and negative counts) and the cluster sizes, re-score the objective
// (get_lk: for every used column the positive part of each cluster's gain,
// plus the Poisson size prior), accept if lk_new - lk > logu[t], and keep
// the best state on a strict >.  The draws (idx, prop, logu) come
// precomputed a block at a time from the wrapper
// (ops/cluster.py::block_draws), the same numbers the plain chain reads.
//
// Bit-exact against ops/cluster.py::mcmc_chain_plain: the aggregates'
// positive and negative counts and the sizes are whole numbers, a
// cluster's gain moves by +-x exactly as the plain version's agg + (+-1)*x,
// and the objective's float sums run in the plain version's fixed order:
// a column's K clusters in index order, the columns by the pairwise tree
// s[:h] + s[h:2h] (in-lane over the lane's column groups, then a
// __shfl_down_sync tree over the 32 lanes), the K size terms in index
// order.  Every float operation is an explicit round-to-nearest intrinsic,
// so no multiply and add are fused where PyTorch rounds twice.
//
// Bound on the H100: latency.  The work is ~20 K V operations and ~12
// bytes of draws a step, but each step conditions on the one before, so a
// lane's time is its steps times the dependent chain of one step: the
// shared-memory load of assign[i], the K-cluster column term, the 5-step
// shuffle tree and its broadcast, and the accept select (~200-400 cycles).
//
// Design: one warp per lane (a block of one warp, so the B x S lanes of
// path (b), ~540, spread over the SMs' schedulers); lane v of the warp
// owns columns v, v + 32, ... (column groups of 32).  The warp's shared
// memory holds its K x Vp aggregates, the cluster sizes and the
// assignment; the size table and the feature rows stay in global memory
// (L1-resident, read-only).  The draws of 32 steps are loaded a tile
// ahead, one step a lane, and broadcast with __shfl_sync; the best
// assignment is copied out on each improvement.  K and the column groups
// are compile-time (2 and 1, path (b)'s) or run-time (any K, any V whose
// K x V aggregates fit the block's shared memory).
#include <cstdint>

#include <cuda_runtime.h>

#ifndef FULL_MASK
#define FULL_MASK 0xffffffffu
#endif

constexpr float POS_THR = 1e-5f;
constexpr float POS_FRAC = 0.7f;
constexpr float IN_POS_RATIO = 2.f;
constexpr float POS_PAD = 1e-7f;
constexpr int GEOMETRY_ERROR = -2;

template <int KC, int MC>
__global__ void __launch_bounds__(32)
mcmc_chain_kernel(const float* __restrict__ X,        // (B, R, V)
                  const float* __restrict__ size_lk,  // (B, R + 1)
                  const int32_t* __restrict__ idx,    // (T, B, S)
                  const int32_t* __restrict__ prop,   // (T, B, S)
                  const float* __restrict__ logu,     // (T, B, S)
                  int32_t* __restrict__ assign,       // (B, S, R)
                  int32_t* __restrict__ best_assign,  // (B, S, R)
                  float* __restrict__ agg_gain,       // (B, S, K, V)
                  float* __restrict__ agg_pos, float* __restrict__ agg_neg,
                  float* __restrict__ counts,         // (B, S, K)
                  float* __restrict__ lk,             // (B, S)
                  float* __restrict__ best_lk, int B, int S, int R, int K_,
                  int V, int M_, int T) {
  const int K = KC > 0 ? KC : K_;
  const int M = MC > 0 ? MC : M_;
  const int Vp = 32 * M;
  extern __shared__ float smem[];
  float* sG = smem;                 // [K][Vp] gains
  float* sP = sG + K * Vp;          // [K][Vp] positive counts
  float* sN = sP + K * Vp;          // [K][Vp] negative counts
  float* sCol = sN + K * Vp;        // [M][32] column terms (M > 1)
  float* sC = sCol + Vp;            // [K] cluster sizes
  int* sA = reinterpret_cast<int*>(sC + K);   // [R] assignment
  const int lane = threadIdx.x;
  const int ln = blockIdx.x;        // the lane (b, s), b * S + s
  const int b = ln / S;
  const size_t abase = (size_t)ln * K * V;
  for (int k = 0; k < K; ++k)
    for (int m = 0; m < M; ++m) {
      const int v = lane + 32 * m;
      const bool in = v < V;
      const size_t g = abase + (size_t)k * V + v;
      sG[k * Vp + v] = in ? agg_gain[g] : 0.f;
      sP[k * Vp + v] = in ? agg_pos[g] : 0.f;
      sN[k * Vp + v] = in ? agg_neg[g] : 0.f;
    }
  for (int k = lane; k < K; k += 32) sC[k] = counts[(size_t)ln * K + k];
  int32_t* asg = assign + (size_t)ln * R;
  int32_t* best_asg = best_assign + (size_t)ln * R;
  for (int r = lane; r < R; r += 32) sA[r] = asg[r];
  float cur = lk[ln], best = best_lk[ln];
  const float* Xb = X + (size_t)b * R * V;
  const float* sl = size_lk + (size_t)b * (R + 1);
  const size_t BS = (size_t)B * S;
  __syncwarp();

  // the draws of 32 steps a tile, one step a lane, a tile ahead
  auto load_tile = [&](int t0, int& ti, int& tp, float& tu) {
    const int t = t0 + lane;
    if (t < T) {
      const size_t d = (size_t)t * BS + ln;
      ti = idx[d]; tp = prop[d]; tu = logu[d];
    } else {
      ti = 0; tp = 0; tu = 0.f;
    }
  };
  int cI, cP, nI, nP;
  float cU, nU;
  load_tile(0, cI, cP, cU);
  load_tile(32, nI, nP, nU);
  int i = __shfl_sync(FULL_MASK, cI, 0), pr = __shfl_sync(FULL_MASK, cP, 0);
  float lu = __shfl_sync(FULL_MASK, cU, 0);
  for (int t = 0; t < T; ++t) {
    // the next step's draws, off this step's chain
    const int j1 = (t + 1) & 31;
    if (j1 == 0) {
      cI = nI; cP = nP; cU = nU;
      load_tile(t + 33, nI, nP, nU);
    }
    const int i1 = __shfl_sync(FULL_MASK, cI, j1);
    const int pr1 = __shfl_sync(FULL_MASK, cP, j1);
    const float lu1 = __shfl_sync(FULL_MASK, cU, j1);
    const int old = sA[i];
    const int nw = pr + (pr >= old ? 1 : 0);
    const float* xr = Xb + (size_t)i * V;
    // the candidate objective's column term, this lane's columns
    float col = 0.f;
    for (int m = 0; m < M; ++m) {
      const int v = lane + 32 * m;
      const float x = v < V ? xr[v] : 0.f;
      const float p = x > POS_THR ? 1.f : 0.f;
      const float n = x < -POS_THR ? 1.f : 0.f;
      bool any = false;
      float piu = 0.f, pin = 0.f, cs = 0.f;
      for (int k = 0; k < K; ++k) {
        const int o = k * Vp + v;
        float g = sG[o], pp = sP[o], nn = sN[o];
        if (k == old) {
          g = __fsub_rn(g, x); pp = __fsub_rn(pp, p); nn = __fsub_rn(nn, n);
        } else if (k == nw) {
          g = __fadd_rn(g, x); pp = __fadd_rn(pp, p); nn = __fadd_rn(nn, n);
        }
        any |= g > 0.f &&
               pp > __fmul_rn(POS_FRAC, __fadd_rn(__fadd_rn(pp, nn), POS_PAD));
        if (g > 0.f) piu = __fadd_rn(piu, pp);
        else pin = __fadd_rn(pin, pp);
        const float gp = fmaxf(g, 0.f);
        cs = k == 0 ? gp : __fadd_rn(cs, gp);
      }
      const bool used = any && __fmul_rn(pin, IN_POS_RATIO) < piu;
      const float c = used ? cs : 0.f;
      if (M == 1) col = c;
      else sCol[m * 32 + lane] = c;
    }
    if (M > 1) {   // the tree's levels above 32 lanes, within the lane
      for (int h = M / 2; h >= 1; h /= 2)
        for (int m = 0; m < h; ++m)
          sCol[m * 32 + lane] =
              __fadd_rn(sCol[m * 32 + lane], sCol[(m + h) * 32 + lane]);
      col = sCol[lane];
    }
#pragma unroll
    for (int h = 16; h >= 1; h >>= 1)
      col = __fadd_rn(col, __shfl_down_sync(FULL_MASK, col, h));
    const float gain = __shfl_sync(FULL_MASK, col, 0);
    float size = 0.f;
    for (int k = 0; k < K; ++k) {
      float c = sC[k];
      if (k == old) c = __fsub_rn(c, 1.f);
      else if (k == nw) c = __fadd_rn(c, 1.f);
      const int ci = min(max((int)c, 0), R);
      const float sk = __ldg(sl + ci);
      size = k == 0 ? sk : __fadd_rn(size, sk);
    }
    const float lk_new = __fadd_rn(gain, size);
    if (__fsub_rn(lk_new, cur) > lu) {   // the same on every lane
      for (int m = 0; m < M; ++m) {
        const int v = lane + 32 * m;
        const float x = v < V ? xr[v] : 0.f;
        const float p = x > POS_THR ? 1.f : 0.f;
        const float n = x < -POS_THR ? 1.f : 0.f;
        const int o = old * Vp + v, q = nw * Vp + v;
        sG[o] = __fsub_rn(sG[o], x);
        sP[o] = __fsub_rn(sP[o], p);
        sN[o] = __fsub_rn(sN[o], n);
        sG[q] = __fadd_rn(sG[q], x);
        sP[q] = __fadd_rn(sP[q], p);
        sN[q] = __fadd_rn(sN[q], n);
      }
      __syncwarp();
      if (lane == 0) {
        sC[old] = __fsub_rn(sC[old], 1.f);
        sC[nw] = __fadd_rn(sC[nw], 1.f);
        sA[i] = nw;
      }
      __syncwarp();
      cur = lk_new;
      if (cur > best) {
        best = cur;
        for (int r = lane; r < R; r += 32) best_asg[r] = sA[r];
      }
    }
    i = i1; pr = pr1; lu = lu1;
  }
  __syncwarp();
  for (int k = 0; k < K; ++k)
    for (int m = 0; m < M; ++m) {
      const int v = lane + 32 * m;
      if (v < V) {
        const size_t g = abase + (size_t)k * V + v;
        agg_gain[g] = sG[k * Vp + v];
        agg_pos[g] = sP[k * Vp + v];
        agg_neg[g] = sN[k * Vp + v];
      }
    }
  for (int k = lane; k < K; k += 32) counts[(size_t)ln * K + k] = sC[k];
  for (int r = lane; r < R; r += 32) asg[r] = sA[r];
  if (lane == 0) {
    lk[ln] = cur;
    best_lk[ln] = best;
  }
}

// The forms this library is built for: (K, column groups) at compile time,
// 0 for a run-time count: path (b)'s K 2 on one group of 32 columns, and
// the general form.
#define CHAIN_FORMS(X) X(2, 1) X(0, 0)

#define CHAIN_CASE(KC_, MC_)                                                \
  if (!known && (KC_ == 0 || K == KC_) && (MC_ == 0 || M == MC_)) {         \
    if (smem > 48 * 1024)                                                   \
      cudaFuncSetAttribute(mcmc_chain_kernel<KC_, MC_>,                     \
                           cudaFuncAttributeMaxDynamicSharedMemorySize,     \
                           smem);                                           \
    mcmc_chain_kernel<KC_, MC_><<<B * S, 32, smem, s>>>(                   \
        X, size_lk, idx, prop, logu, assign, best_assign, agg_gain, agg_pos, \
        agg_neg, counts, lk, best_lk, B, S, R, K, V, M, T);                 \
    known = true;                                                           \
  }

// ``smem``: the bytes of shared memory a chain takes
// (ops/cluster.py::chain_smem_bytes), ``M`` its column groups of 32
// (ops/cluster.py::chain_groups).  Returns 0, a CUDA error code, or
// GEOMETRY_ERROR when the caller's layout is not this library's.
extern "C" int mcmc_chain_launch(const float* X, const float* size_lk,
                                 const int32_t* idx, const int32_t* prop,
                                 const float* logu, int32_t* assign,
                                 int32_t* best_assign, float* agg_gain,
                                 float* agg_pos, float* agg_neg, float* counts,
                                 float* lk, float* best_lk, int B, int S,
                                 int R, int K, int V, int M, int T, int smem,
                                 void* stream) {
  if (B == 0 || S == 0 || T == 0) return 0;
  if (K < 2 || V < 1 || R < 1 || M < 1 || (M & (M - 1)) ||
      32 * M < V || (M > 1 && 16 * M >= V) ||
      smem != 4 * (3 * K * 32 * M + 32 * M + K + R))
    return GEOMETRY_ERROR;
  cudaStream_t s = (cudaStream_t)stream;
  bool known = false;
  CHAIN_FORMS(CHAIN_CASE)
  if (!known) return GEOMETRY_ERROR;
  return (int)cudaGetLastError();
}

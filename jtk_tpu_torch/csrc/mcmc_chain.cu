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
// owns columns v, v + 32, ... (column groups of 32).  The draws of 32
// steps are loaded a tile ahead, one step a lane, and broadcast with
// __shfl_sync.  Two forms:
// - The register form (mcmc_chain_reg<K, PV>, K 2..4 at compile time, V <=
//   32, path (b)'s K 2 / V 8): lane v keeps its column's gain and
//   positive/negative counts of every cluster in registers, every lane the
//   K cluster sizes; the chunk's feature rows, the size table, the
//   assignment and the best assignment lie in the warp's shared memory.
//   Off a step's chain: the next step's X row (read a step ahead, its read
//   known from the draws), the next step's old cluster (read from the
//   assignment a step ahead and patched when this step accepts the same
//   read), the size terms (shared loads).  The moves are selects, not
//   branches.  The shuffle tree runs 3 levels up to V 8 (5 above): the lanes
//   beyond add +0, and a column term is never -0 (an unused column is the
//   literal +0, a used one a sum with a positive gain), so the skipped
//   levels change no bit.  An accept updates registers (selects) and one
//   shared store of the assignment, made by every lane so that each lane's
//   later reads see it without a barrier; an improvement copies the
//   assignment into the best one in shared memory, which goes to device
//   memory once at the end of the launch.
// - The general form (any K, any V whose K x V aggregates fit the block's
//   shared memory; K and the column groups at run time): the K x Vp
//   aggregates, the cluster sizes and the assignment in shared memory; the
//   size table and the feature rows in global memory (L1-resident,
//   read-only); the best assignment copied out on each improvement.
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
                  float* __restrict__ best_lk, int B, int S, int R, int K,
                  int V, int M, int T) {
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

// The register form: K clusters (compile-time), V <= 32 columns, one
// column a lane, a shuffle tree over PV lanes (8 or 32, at least V: the
// lanes from V on hold +0, so the levels above PV would add +0 to a
// column term that is never -0, and change no bit).  Shared memory: the
// chunk's feature rows (R x V), the size table (R + 1), the assignment and
// the best assignment (R each): reg_smem_bytes, at most REG_SMEM.
__host__ __device__ constexpr int reg_smem_bytes(int R, int V) {
  return 4 * (R * V + 3 * R + 1);
}
constexpr int REG_SMEM = 227 * 1024;

template <int K, int PV>
__global__ void __launch_bounds__(32)
mcmc_chain_reg(const float* __restrict__ X,        // (B, R, V)
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
               float* __restrict__ best_lk, int B, int S, int R, int V,
               int T) {
  extern __shared__ float smem[];
  float* sX = smem;                                   // [R][V]
  float* sSize = sX + (size_t)R * V;                  // [R + 1]
  int* sA = reinterpret_cast<int*>(sSize + R + 1);    // [R]
  int* sBest = sA + R;                                // [R]
  const int lane = threadIdx.x;
  const int ln = blockIdx.x;        // the lane (b, s), b * S + s
  const int b = ln / S;
  const bool in = lane < V;
  const size_t abase = (size_t)ln * K * V;
  // the cluster sizes are whole numbers (reads of weight 1): kept as ints,
  // they move by +-1 exactly as the plain chain's floats
  float g[K], pp[K], nn[K];
  int c[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const size_t o = abase + (size_t)k * V + lane;
    g[k] = in ? agg_gain[o] : 0.f;
    pp[k] = in ? agg_pos[o] : 0.f;
    nn[k] = in ? agg_neg[o] : 0.f;
    c[k] = (int)counts[(size_t)ln * K + k];
  }
  int32_t* asg = assign + (size_t)ln * R;
  int32_t* best_asg = best_assign + (size_t)ln * R;
  const float* sl = size_lk + (size_t)b * (R + 1);
  for (int r = lane; r < R; r += 32) {
    sA[r] = asg[r];
    sBest[r] = best_asg[r];
  }
  for (int r = lane; r <= R; r += 32) sSize[r] = sl[r];
  const float* Xb = X + (size_t)b * R * V;
  for (int e = lane; e < R * V; e += 32) sX[e] = Xb[e];
  float cur = lk[ln], best = best_lk[ln];
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
  float x = in ? sX[i * V + lane] : 0.f;
  int old = sA[i];
  for (int t = 0; t < T; ++t) {
    // the next step's draws, X row and old cluster, off this step's chain
    const int j1 = (t + 1) & 31;
    if (j1 == 0) {
      cI = nI; cP = nP; cU = nU;
      load_tile(t + 33, nI, nP, nU);
    }
    const int i1 = __shfl_sync(FULL_MASK, cI, j1);
    const int pr1 = __shfl_sync(FULL_MASK, cP, j1);
    const float lu1 = __shfl_sync(FULL_MASK, cU, j1);
    const float x1 = in ? sX[i1 * V + lane] : 0.f;
    const int old1 = sA[i1];   // patched below if this step moves read i1
    const int nw = pr + (pr >= old ? 1 : 0);
    const float px = x > POS_THR ? 1.f : 0.f;
    const float nx = x < -POS_THR ? 1.f : 0.f;
    float gn[K], pn[K], qn[K];
    bool any = false;
    float piu = 0.f, pin = 0.f, cs = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      // both moves computed, then selected: no branches
      const float gm = __fsub_rn(g[k], x), ga = __fadd_rn(g[k], x);
      const float pm = __fsub_rn(pp[k], px), pa = __fadd_rn(pp[k], px);
      const float qm = __fsub_rn(nn[k], nx), qa = __fadd_rn(nn[k], nx);
      const bool ko = k == old, kn = k == nw;
      const float gk = ko ? gm : kn ? ga : g[k];
      const float pk = ko ? pm : kn ? pa : pp[k];
      const float qk = ko ? qm : kn ? qa : nn[k];
      gn[k] = gk; pn[k] = pk; qn[k] = qk;
      any |= gk > 0.f &&
             pk > __fmul_rn(POS_FRAC, __fadd_rn(__fadd_rn(pk, qk), POS_PAD));
      if (gk > 0.f) piu = __fadd_rn(piu, pk);
      else pin = __fadd_rn(pin, pk);
      const float gp = fmaxf(gk, 0.f);
      cs = k == 0 ? gp : __fadd_rn(cs, gp);
    }
    const bool used = any && __fmul_rn(pin, IN_POS_RATIO) < piu;
    float col = used ? cs : 0.f;
#pragma unroll
    for (int h = PV / 2; h >= 1; h >>= 1)   // the levels PV lanes need
      col = __fadd_rn(col, __shfl_down_sync(FULL_MASK, col, h));
    const float gain = __shfl_sync(FULL_MASK, col, 0);
    int cn[K];
    float size = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      cn[k] = c[k] + (k == old ? -1 : k == nw ? 1 : 0);
      const float sk = sSize[min(max(cn[k], 0), R)];
      size = k == 0 ? sk : __fadd_rn(size, sk);
    }
    const float lk_new = __fadd_rn(gain, size);
    // the same on every lane
    const bool accept = __fsub_rn(lk_new, cur) > lu;
    if (accept) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        g[k] = gn[k]; pp[k] = pn[k]; nn[k] = qn[k]; c[k] = cn[k];
      }
      sA[i] = nw;
      cur = lk_new;
      if (cur > best) {
        best = cur;
#pragma unroll 1
        for (int r = lane; r < R; r += 32) sBest[r] = sA[r];
      }
    }
    old = accept && i1 == i ? nw : old1;
    i = i1; pr = pr1; lu = lu1; x = x1;
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (in) {
      const size_t o = abase + (size_t)k * V + lane;
      agg_gain[o] = g[k];
      agg_pos[o] = pp[k];
      agg_neg[o] = nn[k];
    }
    if (lane == k) counts[(size_t)ln * K + k] = (float)c[k];
  }
  for (int r = lane; r < R; r += 32) {
    asg[r] = sA[r];
    best_asg[r] = sBest[r];
  }
  if (lane == 0) {
    lk[ln] = cur;
    best_lk[ln] = best;
  }
}

// (K, the tree's width PV): V <= 8 runs 3 shuffle levels, V <= 32 all 5
#define REG_FORMS(X) X(2, 8) X(2, 32) X(3, 8) X(3, 32) X(4, 8) X(4, 32)

#define REG_CASE(K_, PV_)                                                   \
  if (!known && K == K_ && (V <= 8) == (PV_ == 8)) {                        \
    if (reg_smem_bytes(R, V) > 48 * 1024)                                   \
      cudaFuncSetAttribute(mcmc_chain_reg<K_, PV_>,                         \
                           cudaFuncAttributeMaxDynamicSharedMemorySize,     \
                           reg_smem_bytes(R, V));                           \
    mcmc_chain_reg<K_, PV_><<<B * S, 32, reg_smem_bytes(R, V), s>>>(        \
        X, size_lk, idx, prop, logu, assign, best_assign, agg_gain, agg_pos, \
        agg_neg, counts, lk, best_lk, B, S, R, V, T);                       \
    known = true;                                                           \
  }

// ``smem``: the bytes of shared memory the general form takes
// (ops/cluster.py::chain_smem_bytes), ``M`` its column groups of 32
// (ops/cluster.py::chain_groups).  The register form takes K 2..4, V <=
// 32 and R x V features within REG_SMEM (ops/cluster.py::chain_form)
// unless ``general`` is set; the rest runs the general form.  Returns 0,
// a CUDA error code, or GEOMETRY_ERROR when the caller's layout is not
// this library's.
extern "C" int mcmc_chain_launch(const float* X, const float* size_lk,
                                 const int32_t* idx, const int32_t* prop,
                                 const float* logu, int32_t* assign,
                                 int32_t* best_assign, float* agg_gain,
                                 float* agg_pos, float* agg_neg, float* counts,
                                 float* lk, float* best_lk, int B, int S,
                                 int R, int K, int V, int M, int T, int smem,
                                 int general, void* stream) {
  if (B == 0 || S == 0 || T == 0) return 0;
  if (K < 2 || V < 1 || R < 1 || M < 1 || (M & (M - 1)) ||
      32 * M < V || (M > 1 && 16 * M >= V) ||
      smem != 4 * (3 * K * 32 * M + 32 * M + K + R))
    return GEOMETRY_ERROR;
  cudaStream_t s = (cudaStream_t)stream;
  bool known = false;
  if (!general && V <= 32 && reg_smem_bytes(R, V) <= REG_SMEM) {
    REG_FORMS(REG_CASE)
  }
  if (!known) {   // the general form
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(mcmc_chain_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    mcmc_chain_kernel<<<B * S, 32, smem, s>>>(
        X, size_lk, idx, prop, logu, assign, best_assign, agg_gain, agg_pos,
        agg_neg, counts, lk, best_lk, B, S, R, K, V, M, T);
  }
  return (int)cudaGetLastError();
}

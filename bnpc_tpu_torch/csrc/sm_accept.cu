// The split-merge move's acceptance and its application (kernel 12;
// ops/cuda_sm_accept.py).
//
// What it computes: what models/splitmerge.py's _split_branch and
// _merge_branch do after their final scan (libs/CRP.py:641-820): the
// reverse proposal's std and bounds, the likelihood terms of the split
// rows and of the merged row, the Beta prior terms, for a merge the forced
// replay of the original sides (_rg_get_split_prob, libs/CRP.py:777-820),
// the MH ratio, the decision, and the application (first_free_slot's rule,
// the assignment, the sizes, the parameter rows, the [2, 2] MH counts).
// Its plain twin (ops/cuda_sm_accept.py's TWIN) runs the same stages as
// torch ops on the CPU: ~154 device operations a split and ~244 a merge
// on an H100 (scripts/kernel_census_torch.py), each a 0-d or [m]-long op.
// It replaces no Pallas kernel: XLA fused these ops on the TPU.
//
// The design. The move's float sums stay torch's: the caller takes
// ax.sum and ax.psum of the planes this kernel writes, as the twin takes
// them, so every sum keeps its bits and a sharded mutation axis
// all-reduces them as before; the realized transition sums stay kernel 7's
// (csrc/mh_sweep.cu's realized mode) on the std, a and b written here.
// Around them, launches of one template:
//   split: stage 0 (a thread a column) the planes; stage 1 the decision and
//     the application;
//   merge: stage 2 (a thread a column or a cell) the planes and the
//     original side masks, whose count products and the replay's
//     likelihood product the caller takes; stage 3 (a thread a cell or a
//     column) the replay's chosen term of every cell and the likelihood
//     terms of the original sides; stage 4 the decision and the
//     application.
// Stages 1 and 4 run a few blocks a chain, grid-strided over the cells,
// the parameter rows and the sizes. Each block computes its chain's scalar
// ratio itself from the sums (the same inputs, the same bits in every
// block): no shared state between blocks and no float atomics. Integer
// counts (the side count of a split, the replay's prefix and suffix counts)
// are summed in any order; they are exact.
//
// What bounds it: latency. A move reads a few [m] rows, the [n] cell
// vectors and the [k_max, m] parameters (copied to the new state), ~0.5 MB
// at 5,000 x 200 and k_max 256 (0.15 us at 3.35 TB/s); the ratio's scalar
// chain (a few lgammaf and logf) runs once a block.
//
// The bits: every torch op of the twin is one op of torch_ops.cuh,
// rounded as ATen rounds it, built with contraction on (ops/_build.py) so
// that logf, expf, log1pf and lgammaf round as ATen's kernels do; the
// replay's logsumexp is ATen's composite (amax, a max of +-inf taken as 0,
// exp, the sum of the two terms, log, add). The draws (the std index and
// the acceptance uniform) are the provider's, drawn by the wrapper in the
// twin's order.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

#include "torch_ops.cuh"

namespace {

using namespace torch_ops;

constexpr int kThreads = 256;
constexpr int kWarp = 32;

// The twin's constants, each as torch casts a Python float.
constexpr float kTmin = static_cast<float>(1e-5);        // config.TMIN
constexpr float kTmax = static_cast<float>(1.0 - 1e-5);  // config.TMAX
constexpr float kLogFloor = static_cast<float>(1e-30);

struct Args {
  // [chains]
  const int* anchor_i;
  const int* anchor_j;
  const int* cl_a;
  const int* cl_b;
  const float* n_move;
  const float* ltrans;      // the forward size-proposal term
  const float* inv_others;  // split: sum of 1 / size over other clusters
  const float* alpha;
  const float* fp;
  const float* fn;
  const float* u;           // the acceptance uniform
  // [chains, n]
  const bool* s_mask;
  const int* rg;            // the launch sides after the final scan
  const int* assign;
  // rows
  const float* params;      // [chains, k, m] the state's
  const int* sizes;         // [chains, k]
  const float* ps;          // [chains, 2, m] the split pair
  const float* pm;          // [chains, m] the merged row
  const float* n1s;         // [chains, 2, m] counts of the launch sides
  const float* n0s;
  const float* n1c;         // [chains, m] counts of the move's cells
  const float* n0c;
  const float* n1o;         // merge: [chains, 2, m] counts of the original
  const float* n0o;         // sides
  const float* ll2;         // merge: [chains, n, 2] the replay's likelihood
  const int* std_idx;       // as `std`
  const float* mask;        // [m] 0 / 1, or null
  // torch's sums, [chains]
  const float* gs_fwd;      // split: the final scan's; merge: the final
                            // merge scan's
  const float* real0;       // kernel 7's realized sums: split, the merged
  const float* real1;       // row's; merge, the original rows'
  const float* ll_split;
  const float* ll_all;
  const float* chosen_sum;  // merge: the replay's chosen terms
  const float* beta0_sum;   // split: the pair, cl_a's row; merge: the
  const float* beta1_sum;   // merged row, cl_a's and cl_b's rows
  const float* beta2_sum;
  // planes
  float* std;               // split: [chains, m]; merge: [chains, 2, m]
  float* a;
  float* b;
  float* target;            // as `std`: the state's rows cl_a (and cl_b)
  float* c1t;               // merge: [chains, 2, m] tables of `target`
  float* c0t;
  float* sides;             // merge: [chains, 2, n] original side masks
  float* t0;                // [chains, m] likelihood terms: side 0, side 1,
  float* t1;                // the merged row
  float* tm;
  float* beta0;             // split: [chains, 2, m], [chains, m];
  float* beta1;             // merge: three [chains, m]
  float* beta2;
  float* chosen;            // merge: [chains, n]
  // the new state
  int* assign_out;          // [chains, n]
  int* sizes_out;           // [chains, k]
  float* params_out;        // [chains, k, m]
  int* counts_out;          // [chains, 2, 2]
  int n, m, k, chains;
  int cell_blocks, chunk;   // stage 3: blocks over cells, cells a block
  float pm1, qm1, log_norm;  // the Beta prior (p - 1, q - 1, log B(p, q))
  int beta_prior;
  float neg_log_n;          // -log(n) as torch computes it on the host
};

// ops/mh.py::choose over PARAM_PROPOSAL_SD.
__device__ __forceinline__ float choose_sd(int i) {
  return i == 0 ? static_cast<float>(0.1)
                : (i == 1 ? static_cast<float>(0.25) : 0.5f);
}

// ops/likelihood.py::log_prob_tables.
__device__ __forceinline__ float table1(float th, float fp, float fn) {
  return logf(add(mul(th, sub(1.0f, fn)), mul(sub(1.0f, th), fp)));
}
__device__ __forceinline__ float table0(float th, float fp, float fn) {
  return logf(add(mul(th, fn), mul(sub(1.0f, th), sub(1.0f, fp))));
}

// splitmerge.py::_beta_prior_sum's terms: the density, masked.
__device__ __forceinline__ float beta_term(const Args& g, float x, int j) {
  const float v = beta_logpdf(x, g.pm1, g.qm1, g.log_norm);
  return g.mask == nullptr ? v : mul(v, g.mask[j]);
}

// The sum of `v` over the block, in every thread. The order is fixed, and
// the values are integers.
__device__ __forceinline__ int block_sum(int v) {
  __shared__ int part[kThreads / kWarp];
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  __syncthreads();
  if (threadIdx.x % kWarp == 0) part[threadIdx.x / kWarp] = v;
  __syncthreads();
  int t = 0;
  for (int w = 0; w < kThreads / kWarp; ++w) t += part[w];
  return t;
}

__device__ __forceinline__ int block_min(int v) {
  __shared__ int part[kThreads / kWarp];
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    v = min(v, __shfl_down_sync(0xffffffffu, v, off));
  }
  __syncthreads();
  if (threadIdx.x % kWarp == 0) part[threadIdx.x / kWarp] = v;
  __syncthreads();
  int t = INT_MAX;
  for (int w = 0; w < kThreads / kWarp; ++w) t = min(t, part[w]);
  return t;
}

// The flags before each thread's in the block (thread order), and their
// total.
__device__ __forceinline__ void block_prefix(bool f, int* before, int* total) {
  __shared__ int part[kThreads / kWarp];
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const unsigned bal = __ballot_sync(0xffffffffu, f);
  __syncthreads();
  if (lane == 0) part[warp] = __popc(bal);
  __syncthreads();
  int pre = __popc(bal & ((1u << lane) - 1u)), tot = 0;
  for (int w = 0; w < kThreads / kWarp; ++w) {
    if (w < warp) pre += part[w];
    tot += part[w];
  }
  *before = pre;
  *total = tot;
}

// first_free_slot: the lowest slot of size 0, 0 when every slot is taken.
__device__ __forceinline__ int free_slot(const Args& g, int c) {
  int lo = INT_MAX;
  for (int s = threadIdx.x; s < g.k; s += kThreads) {
    if (g.sizes[static_cast<long>(c) * g.k + s] == 0) lo = min(lo, s);
  }
  lo = block_min(lo);
  return lo == INT_MAX ? 0 : lo;
}

// A split's decision (_split_branch): the side-1 count of the movable
// cells (`count`), the ratio, the degenerate test, the acceptance.
__device__ bool split_accepts(const Args& g, int c, int count) {
  const float nm = g.n_move[c];
  const float n_j = add(static_cast<float>(count), 1.0f);
  const float n_i = sub(nm, n_j);
  const float trans = sub(g.real0[c], g.gs_fwd[c]);
  float lprior = sub(logf(g.alpha[c]), lgammaf(nm));
  lprior = add(lprior, lgammaf(n_j));
  lprior = add(lprior, lgammaf(n_i));
  if (g.beta_prior) {
    lprior = add(lprior, g.beta0_sum[c]);
    lprior = sub(lprior, g.beta1_sum[c]);
  }
  const float ll_ratio = sub(g.ll_split[c], g.ll_all[c]);
  // 1.0 / x is torch's reciprocal(x) * 1.0: one division.
  float norm = add(g.inv_others[c], dvd(1.0f, n_i));
  norm = add(norm, dvd(1.0f, n_j));
  const float rev = sub(-logf(mul(n_i, norm)), logf(mul(n_j, norm)));
  const float size_ratio = sub(rev, g.ltrans[c]);
  float A = add(trans, lprior);
  A = add(A, ll_ratio);
  A = add(A, size_ratio);
  const float s_count = sub(nm, 2.0f);
  const float moved = sub(n_j, 1.0f);
  const bool degenerate =
      s_count > 0.0f && (moved == 0.0f || moved == s_count);
  return !degenerate && logf(g.u[c]) < A;
}

// A merge's decision (_merge_branch).
__device__ bool merge_accepts(const Args& g, int c) {
  const long base = static_cast<long>(c) * g.k;
  const float nm = g.n_move[c];
  const float n_i = static_cast<float>(g.sizes[base + g.cl_a[c]]);
  const float n_j = static_cast<float>(g.sizes[base + g.cl_b[c]]);
  const float gs_split = add(add(g.real0[c], g.real1[c]), g.chosen_sum[c]);
  const float trans = sub(gs_split, g.gs_fwd[c]);
  float lprior = sub(lgammaf(nm), logf(g.alpha[c]));
  lprior = sub(lprior, lgammaf(n_i));
  lprior = sub(lprior, lgammaf(n_j));
  if (g.beta_prior) {
    lprior = add(lprior, g.beta0_sum[c]);
    lprior = sub(lprior, g.beta1_sum[c]);
    lprior = sub(lprior, g.beta2_sum[c]);
  }
  const float ll_ratio = sub(g.ll_all[c], g.ll_split[c]);
  const float s_count = sub(nm, 2.0f);
  const float s1 = sub(s_count, 1.0f);
  const float drop =
      s1 > 0.0f ? logf(isnan(s1) ? s1 : fmaxf(s1, kLogFloor)) : 0.0f;
  const float rev = sub(g.neg_log_n, drop);
  const float size_ratio = sub(rev, g.ltrans[c]);
  float A = add(trans, lprior);
  A = add(A, ll_ratio);
  A = add(A, size_ratio);
  return logf(g.u[c]) < A;
}

// The replay's chosen log-probability of a movable cell i that holds its
// original side `orig1`, `s1` movable cells other than it on side 1
// (_rg_get_split_prob).
__device__ __forceinline__ float replay_term(const Args& g, int c, long i,
                                             float s1, bool orig1) {
  const float nm = g.n_move[c];
  const float n_j = add(s1, 1.0f);
  const float n_i = sub(sub(nm, s1), 2.0f);
  const float log_denom = logf(add(sub(nm, 1.0f), g.alpha[c]));
  const float* ll = g.ll2 + (static_cast<long>(c) * g.n + i) * 2;
  const float l0 = sub(add(ll[0], logf(n_i)), log_denom);
  const float l1 = sub(add(ll[1], logf(n_j)), log_denom);
  // torch.logsumexp: the max, 0 where it is +-inf; exp; sum; log; add.
  float mx = maximum(l0, l1);
  if (isinf(mx)) mx = 0.0f;
  const float lse = add(logf(add(expf(sub(l0, mx)), expf(sub(l1, mx)))), mx);
  return sub(orig1 ? l1 : l0, lse);
}

// The stages (module comment). A template (the stage) so that the
// profiler's name for it, "sm_accept_kernel<0>(...)", is one that
// portbench's devtrace.kernel_base parses.
template <int kStage>
__global__ void __launch_bounds__(kThreads) sm_accept_kernel(const Args g) {
  const int c = blockIdx.y;
  const long m = g.m, n = g.n, k = g.k;
  const float fp = g.fp[c], fn = g.fn[c];

  if (kStage == 0) {  // split: the planes
    const long j = static_cast<long>(blockIdx.x) * kThreads + threadIdx.x;
    if (j >= m) return;
    const long e = c * m + j;
    const float s = choose_sd(g.std_idx[e]);
    const float pm = g.pm[e];
    g.std[e] = s;
    g.a[e] = dvd(sub(kTmin, pm), s);
    g.b[e] = dvd(sub(kTmax, pm), s);
    const float tg = g.params[(c * k + g.cl_a[c]) * m + j];
    g.target[e] = tg;
    const long r0 = c * 2 * m + j, r1 = r0 + m;
    const float p0 = g.ps[r0], p1 = g.ps[r1];
    g.t0[e] = loglik(p0, g.n1s[r0], g.n0s[r0], fp, fn);
    g.t1[e] = loglik(p1, g.n1s[r1], g.n0s[r1], fp, fn);
    g.tm[e] = loglik(pm, g.n1c[e], g.n0c[e], fp, fn);
    if (g.beta_prior) {
      g.beta0[r0] = beta_term(g, p0, j);
      g.beta0[r1] = beta_term(g, p1, j);
      g.beta1[e] = beta_term(g, tg, j);
    }
    return;
  }

  if (kStage == 2) {  // merge: the planes and the original side masks
    const long t = static_cast<long>(blockIdx.x) * kThreads + threadIdx.x;
    if (t < m) {
      const long j = t;
      for (int r = 0; r < 2; ++r) {
        const long e = (c * 2 + r) * m + j;
        const float s = choose_sd(g.std_idx[e]);
        const float p = g.ps[e];
        g.std[e] = s;
        // Bounds 0 / 1 here, not TMIN / TMAX: the reference's quirk
        // (libs/CRP.py:779-780).
        g.a[e] = dvd(sub(0.0f, p), s);
        g.b[e] = dvd(sub(1.0f, p), s);
        const int cl = r == 0 ? g.cl_a[c] : g.cl_b[c];
        const float tg = g.params[(c * k + cl) * m + j];
        g.target[e] = tg;
        g.c1t[e] = table1(tg, fp, fn);
        g.c0t[e] = table0(tg, fp, fn);
      }
      if (g.beta_prior) {
        const long e = c * m + j;
        g.beta0[e] = beta_term(g, g.pm[e], j);
        g.beta1[e] = beta_term(g, g.target[c * 2 * m + j], j);
        g.beta2[e] = beta_term(g, g.target[(c * 2 + 1) * m + j], j);
      }
    } else if (t < m + n) {
      const long i = t - m, e = c * n + i;
      const bool orig1 = g.assign[e] != g.cl_a[c];
      const bool in_s = g.s_mask[e];
      const bool side0 = (in_s && !orig1) || i == g.anchor_i[c];
      const bool side1 = (in_s && orig1) || i == g.anchor_j[c];
      g.sides[(c * 2) * n + i] = side0 ? 1.0f : 0.0f;
      g.sides[(c * 2 + 1) * n + i] = side1 ? 1.0f : 0.0f;
    }
    return;
  }

  if (kStage == 3) {  // merge: the replay's terms and the likelihood terms
    if (static_cast<int>(blockIdx.x) >= g.cell_blocks) {
      const long j = static_cast<long>(blockIdx.x - g.cell_blocks) * kThreads
                     + threadIdx.x;
      if (j >= m) return;
      const long e = c * m + j, r0 = c * 2 * m + j, r1 = r0 + m;
      g.t0[e] = loglik(g.ps[r0], g.n1o[r0], g.n0o[r0], fp, fn);
      g.t1[e] = loglik(g.ps[r1], g.n1o[r1], g.n0o[r1], fp, fn);
      g.tm[e] = loglik(g.pm[e], g.n1c[e], g.n0c[e], fp, fn);
      return;
    }
    // Cells [lo, hi): a movable cell's count of the others on side 1 is
    // its original sides before it plus its launch sides after it, in
    // ascending cell order.
    const int cl_a = g.cl_a[c];
    const long lo = static_cast<long>(blockIdx.x) * g.chunk;
    const long hi = min(n, lo + g.chunk);
    const bool* in_s = g.s_mask + c * n;
    const int* orig = g.assign + c * n;
    const int* lau = g.rg + c * n;
    int before = 0, after = 0, inside = 0;
    for (long i = threadIdx.x; i < lo; i += kThreads) {
      before += in_s[i] && orig[i] != cl_a;
    }
    for (long i = hi + threadIdx.x; i < n; i += kThreads) {
      after += in_s[i] && lau[i] == 1;
    }
    for (long i = lo + threadIdx.x; i < hi; i += kThreads) {
      inside += in_s[i] && lau[i] == 1;
    }
    before = block_sum(before);
    after = block_sum(after) + block_sum(inside);
    for (long s = lo; s < hi; s += kThreads) {
      const long i = s + threadIdx.x;
      const bool ok = i < hi;
      const bool f1 = ok && in_s[i] && orig[i] != cl_a;
      const bool f2 = ok && in_s[i] && lau[i] == 1;
      int pre1, tot1, pre2, tot2;
      block_prefix(f1, &pre1, &tot1);
      block_prefix(f2, &pre2, &tot2);
      if (ok) {
        // `after` counts side 1 from position s on: less those up to i.
        const int others = before + pre1 + after - pre2 - (f2 ? 1 : 0);
        g.chosen[c * n + i] =
            in_s[i] ? replay_term(g, c, i, static_cast<float>(others),
                                  orig[i] != cl_a)
                    : 0.0f;
      }
      before += tot1;
      after -= tot2;
    }
    return;
  }

  // Stages 1 and 4: the decision, then the new state over the flat range
  // of cells, parameters and sizes.
  bool accept;
  int new_slot = 0, moved = 0;
  if (kStage == 1) {
    int count = 0;
    for (long i = threadIdx.x; i < n; i += kThreads) {
      count += g.s_mask[c * n + i] && g.rg[c * n + i] == 1;
    }
    count = block_sum(count);
    new_slot = free_slot(g, c);
    accept = split_accepts(g, c, count);
    // anchor j is never movable: it moves too.
    moved = accept ? count + 1 : 0;
  } else {
    accept = merge_accepts(g, c);
  }
  const int cl_a = g.cl_a[c], cl_b = g.cl_b[c];
  const long span = n + k * m + k;
  for (long t = static_cast<long>(blockIdx.x) * kThreads + threadIdx.x;
       t < span; t += static_cast<long>(gridDim.x) * kThreads) {
    if (t < n) {
      const long e = c * n + t;
      const int was = g.assign[e];
      int now = was;
      if (kStage == 1) {
        const bool side1 = (g.s_mask[e] && g.rg[e] == 1) || t == g.anchor_j[c];
        if (accept && side1) now = new_slot;
      } else if (accept && was == cl_b) {
        now = cl_a;
      }
      g.assign_out[e] = now;
    } else if (t < n + k * m) {
      const long e = t - n, row = e / m, j = e % m;
      float v = g.params[c * k * m + e];
      if (accept) {
        if (kStage == 1) {
          if (row == new_slot) v = g.ps[(c * 2 + 1) * m + j];
          if (row == cl_a) v = g.ps[c * 2 * m + j];
        } else if (row == cl_a) {
          v = g.pm[c * m + j];
        }
      }
      g.params_out[c * k * m + e] = v;
    } else {
      const long s = t - n - k * m;
      const long base = c * k;
      int v = g.sizes[base + s];
      if (kStage == 1) {
        if (s == cl_a) v -= moved;
        if (s == new_slot) v += moved;
      } else {
        const int size_b = g.sizes[base + cl_b];
        if (s == cl_a) v += accept ? size_b : 0;
        if (s == cl_b) v = accept ? 0 : size_b;
      }
      g.sizes_out[base + s] = v;
    }
  }
  if (blockIdx.x == 0 && threadIdx.x < 4) {
    // counts[row] = (accepted, declined): row 0 splits, row 1 merges.
    const int row = kStage == 1 ? 0 : 1;
    const int r = threadIdx.x / 2, col = threadIdx.x % 2;
    g.counts_out[c * 4 + threadIdx.x] =
        r != row ? 0 : (col == 0 ? (accept ? 1 : 0) : (accept ? 0 : 1));
  }
}

constexpr int kApplyBlocks = 32;

template <int kStage>
void launch(const Args& g, int blocks, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(blocks),
                  static_cast<unsigned>(g.chains));
  sm_accept_kernel<kStage><<<grid, kThreads, 0, stream>>>(g);
}

int blocks_of(long threads) {
  return static_cast<int>((threads + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// One stage (0-4) on the Args that `args` points to (host memory); stage
// 3's cell_blocks and chunk are set here.
int bnpc_sm_accept(int stage, void* args, cudaStream_t stream) {
  Args& g = *static_cast<Args*>(args);
  if (g.chains <= 0 || g.n <= 0 || g.m <= 0 || g.k <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long apply = static_cast<long>(g.n) + static_cast<long>(g.k) * g.m
                     + g.k;
  const int apply_blocks =
      blocks_of(apply) < kApplyBlocks ? blocks_of(apply) : kApplyBlocks;
  switch (stage) {
    case 0:
      launch<0>(g, blocks_of(g.m), stream);
      break;
    case 1:
      launch<1>(g, apply_blocks, stream);
      break;
    case 2:
      launch<2>(g, blocks_of(static_cast<long>(g.m) + g.n), stream);
      break;
    case 3: {
      // At most 32 blocks of cells a chain, each a run of whole block
      // widths.
      int cells = blocks_of(g.n);
      if (cells > 32) cells = 32;
      const long per = (static_cast<long>(g.n) + cells - 1) / cells;
      g.chunk = static_cast<int>((per + kThreads - 1) / kThreads * kThreads);
      g.cell_blocks = static_cast<int>((g.n + g.chunk - 1) / g.chunk);
      launch<3>(g, g.cell_blocks + blocks_of(g.m), stream);
      break;
    }
    case 4:
      launch<4>(g, apply_blocks, stream);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

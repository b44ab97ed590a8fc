// The cluster-parameter MH sweep in one launch (kernel 7; ops/cuda_mh.py).
//
// What it replaces: the torch composition of ops/mh.py::mh_cluster_params
// (a truncated-normal random-walk MH step on every coordinate of a block of
// parameter rows, libs/CRP.py:314-383) and, in its realized mode, that of
// ops/mh.py::realized_trans_logprob. It replaces no Pallas kernel: on the
// TPU, XLA fused this elementwise chain by itself (bnpc_tpu/ops/mh.py); in
// the port's eager torch it ran as 140 small kernels a call, 0.22 ms a
// call inside a CUDA graph on an H100 (~1.6 us a kernel), about 490 of a
// chain-step's ~1,060 kernels.
//
// What bounds it: launch latency and the latency of one element's chain of
// transcendentals, not bytes. A call reads and writes at most 256 rows x
// 200 columns x 7 words (params, n1, n0, the std index, two uniforms in;
// the new params out) = 1.4 MB, 0.43 us at 3.35 TB/s. The design answers
// that by being one launch: one block a row, the row's m columns across
// its threads (one column a thread up to 1,024), every element computed
// start to end in registers, and each row's sums reduced in the block
// (warp shuffles, then the warps in order in shared memory), so no second
// kernel and no atomics. On an H100 a call takes 6.1 us inside a CUDA
// graph at 256 x 200 and 4.8 us at one or two rows. The order of the
// reduction depends on m alone, never on the number of rows or the grid:
// a batch of chains gives each chain the bits of its one-chain launch.
//
// The bits. The random draws stay torch's (the std index, the proposal's
// uniform, the acceptance uniform, drawn by the wrapper in the
// composition's order), and every element follows the composition
// operation by operation: each torch elementwise op is one correctly
// rounded operation here (the __f*_rn intrinsics, which are never
// contracted into an FMA, as ATen's separate kernels round each op), the
// math library calls are those ATen's kernels make (logf, log1pf, expf,
// expm1f, erff), and ndtri and log_ndtr are ATen's own CUDA bodies
// (aten_special.cuh), compiled, as ATen's are, with FMA contraction on
// (ops/_build.py). On an H100 every one of these agreed with torch's
// kernel bit for bit over 4M inputs a function.
// The per-row sums add in this kernel's order, not torch's: they agree
// with the composition to a rounding of the sum, not bit for bit.

#include <cuda_runtime.h>
#include <math.h>

#include "torch_ops.cuh"

namespace {

using namespace torch_ops;

constexpr int kMaxThreads = 1024;
constexpr int kWarp = 32;

// The composition's constants, each as torch casts a Python float.
constexpr float kTmin = static_cast<float>(1e-5);           // config.TMIN
constexpr float kTmax = static_cast<float>(1.0 - 1e-5);     // config.TMAX
constexpr float kTransMax = static_cast<float>(-1e-10);

struct Row {
  float fp, fn, pm1, qm1;
  bool beta_prior;
};

// ops/mh.py::log_A.
__device__ __forceinline__ float log_a(float nw, float old, float n1, float n0,
                                       float a, float b, float s, const Row& r,
                                       bool clip) {
  const float new_p = tn_logpdf(nw, a, b, old, s);
  const float a_rev = dvd(sub(kTmin, nw), s);
  const float b_rev = dvd(sub(kTmax, nw), s);
  const float old_p = tn_logpdf(old, a_rev, b_rev, nw, s);
  const float new_ll = loglik(nw, n1, n0, r.fp, r.fn);
  const float old_ll = loglik(old, n1, n0, r.fp, r.fn);
  float A = sub(add(sub(new_ll, old_ll), old_p), new_p);
  if (r.beta_prior) {
    A = add(A, beta_logpdf(nw, r.pm1, r.qm1, 0.0f));
    A = sub(A, beta_logpdf(old, r.pm1, r.qm1, 0.0f));
  }
  return clip ? clamp_max(A, 0.0f) : A;
}

struct Args {
  const float* x;        // sweep: params; realized: the target rows
  const float* src;      // realized: the source rows
  const float* n1;
  const float* n0;
  const float* fp;       // [chains]
  const float* fn;
  const int* std_idx;    // sweep: index into {0.1, 0.25, 0.5}
  const float* u_prop;   // sweep: the proposal's uniform
  const float* u;        // sweep: the acceptance uniform
  const float* a;        // realized: the forward bounds and std
  const float* b;
  const float* sd;
  const float* mask;     // [m] 0 / 1, or null
  float* out;            // sweep: the new params
  int* declined;         // sweep: [rows] declined real columns
  float* row_sum;        // [rows] transition sum (0 without trans_prob)
  int rows_per_chain;
  int m;
  float pm1, qm1;
  int beta_prior;
  int trans_prob;
};

// A block's sums of (f, i), the same order for every row: each thread's
// columns in order, a shuffle tree in each warp, then the warps in order.
__device__ __forceinline__ void row_reduce(float f, int i, float* sum_f,
                                           int* sum_i) {
  __shared__ float wf[kMaxThreads / kWarp];
  __shared__ int wi[kMaxThreads / kWarp];
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    f = add(f, __shfl_down_sync(0xffffffffu, f, off));
    i += __shfl_down_sync(0xffffffffu, i, off);
  }
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  if (lane == 0) {
    wf[warp] = f;
    wi[warp] = i;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float tf = wf[0];
    int ti = wi[0];
    for (int w = 1; w < static_cast<int>(blockDim.x) / kWarp; ++w) {
      tf = add(tf, wf[w]);
      ti += wi[w];
    }
    *sum_f = tf;
    *sum_i = ti;
  }
}

template <bool kRealized>
__global__ void __launch_bounds__(kMaxThreads) mh_sweep_kernel(const Args g) {
  const int row = blockIdx.x;
  const int chain = row / g.rows_per_chain;
  const Row r{g.fp[chain], g.fn[chain], g.pm1, g.qm1, g.beta_prior != 0};
  const long base = static_cast<long>(row) * g.m;
  float acc = 0.0f;
  int count = 0;
  for (int j = threadIdx.x; j < g.m; j += blockDim.x) {
    const long e = base + j;
    float v;
    if (kRealized) {
      // ops/mh.py::realized_trans_logprob: every coordinate accepted.
      v = log_a(g.x[e], g.src[e], g.n1[e], g.n0[e], g.a[e], g.b[e], g.sd[e],
                r, true);
    } else {
      const float x = g.x[e];
      const int k = g.std_idx[e];
      const float s = k == 0 ? static_cast<float>(0.1)
                             : (k == 1 ? static_cast<float>(0.25) : 0.5f);
      const float a = dvd(sub(kTmin, x), s);
      const float b = dvd(sub(kTmax, x), s);
      // ops/truncnorm.py::from_uniform, the inverse-CDF proposal.
      const float prop = tn_from_uniform(g.u_prop[e], a, b, x, s);
      const bool trans = g.trans_prob != 0;
      const float A = log_a(prop, x, g.n1[e], g.n0[e], a, b, s, r, trans);
      const bool decline = logf(g.u[e]) >= A;
      g.out[e] = decline ? x : prop;
      const bool real = g.mask == nullptr || g.mask[j] != 0.0f;
      count += (decline && real) ? 1 : 0;
      // A declined coordinate adds log(1 - e^A), an accepted one min(A, 0).
      v = !trans ? 0.0f
                 : (decline ? logf(-expm1f(clamp_max(A, kTransMax))) : A);
    }
    if (g.mask != nullptr) v = mul(v, g.mask[j]);
    acc = add(acc, v);
  }
  float sum_f;
  int sum_i;
  row_reduce(acc, count, &sum_f, &sum_i);
  if (threadIdx.x == 0) {
    g.row_sum[row] = sum_f;
    if (!kRealized) g.declined[row] = sum_i;
  }
}

int threads_for(int m) {
  const int t = (m + kWarp - 1) / kWarp * kWarp;
  return t < kMaxThreads ? t : kMaxThreads;
}

template <bool kRealized>
int launch(const Args& g, int rows, cudaStream_t stream) {
  if (rows > 0 && g.m > 0) {
    mh_sweep_kernel<kRealized><<<rows, threads_for(g.m), 0, stream>>>(g);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Rows [rows, m]: params, n1, n0, std_idx, u_prop, u, out; fp, fn
// [rows / rows_per_chain]; mask [m] or null; declined, trans [rows].
int bnpc_mh_sweep(const float* params, const float* n1, const float* n0,
                  const float* fp, const float* fn, const int* std_idx,
                  const float* u_prop, const float* u, const float* mask,
                  float* out, int* declined, float* trans, int rows,
                  int rows_per_chain, int m, float pm1, float qm1,
                  int beta_prior, int trans_prob, cudaStream_t stream) {
  Args g{params, nullptr, n1, n0, fp, fn, std_idx, u_prop, u,
         nullptr, nullptr, nullptr, mask, out, declined, trans,
         rows_per_chain, m, pm1, qm1, beta_prior, trans_prob};
  return launch<false>(g, rows, stream);
}

// Rows [rows, m]: target, source, n1, n0, a, b, sd; fp, fn
// [rows / rows_per_chain]; mask [m] or null; out [rows].
int bnpc_mh_realized(const float* target, const float* source,
                     const float* n1, const float* n0, const float* a,
                     const float* b, const float* sd, const float* fp,
                     const float* fn, const float* mask, float* out, int rows,
                     int rows_per_chain, int m, float pm1, float qm1,
                     int beta_prior, cudaStream_t stream) {
  Args g{target, source, n1, n0, fp, fn, nullptr, nullptr, nullptr,
         a, b, sd, mask, nullptr, nullptr, out,
         rows_per_chain, m, pm1, qm1, beta_prior, 1};
  return launch<true>(g, rows, stream);
}

}  // extern "C"

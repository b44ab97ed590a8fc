// A trace row's ML and MAP in two launches (kernel 11; ops/cuda_row.py).
//
// What it replaces: the torch composition of mcmc.py::summarize's ML
// (ops/likelihood.py::ll_from_stats on the log-prob tables) and of
// ops/likelihood.py::log_prior_full (the Gamma log-density of alpha, the
// CRP size terms, the Beta log-density of the live parameters, the two
// error-rate priors): a string of elementwise launches and reductions, 83
// device operations a row with the compacted params on an H100
// (scripts/kernel_census_torch.py). It replaces no Pallas kernel: XLA fused
// these ops on the TPU.
//
// The design. The sums stay torch's (the wrapper takes ax.sum and ax.psum
// of the terms this kernel writes), so that ML and each prior term keep
// the composition's bits, and a sharded mutation axis all-reduces them as
// before. Around them, two launches of one template:
//   stage 0 (one thread an element): the ML terms n1 * c1 + n0 * c0 (left
//     out where the caller has ML already: the error move's chosen
//     likelihood), the live slots' Beta terms under the column mask (left
//     out under a uniform prior) and, in the first chains x k threads, the
//     live slots' CRP size terms;
//   stage 1 (one thread a chain): the Gamma log-density of alpha, then the
//     log prior added up in the composition's order, and MAP = ML + it.
// No atomics, and nothing that depends on thread timing.
//
// What bounds it: latency. At 256 x 200 a row reads params and the
// statistics (~0.6 MB) and writes two planes of terms (0.4 MB): 0.3 us at
// 3.35 TB/s.
//
// The bits: every op of the composition is one op of torch_ops.cuh,
// rounded as ATen rounds it. The composition's CPU scalars (lgamma of the
// Gamma's shape, the priors' log(sd) and masses) are computed by torch on
// the host and passed in (ops/cuda_row.py).

#include <cuda_runtime.h>

#include "torch_ops.cuh"

namespace {

using namespace torch_ops;

constexpr int kThreads = 256;

struct Args {
  const float* params;     // [chains, k, m]
  const float* n1;
  const float* n0;
  const int* sizes;        // [chains, k] cluster sizes
  const float* fp;         // [chains]
  const float* fn;
  const float* alpha;
  const float* mask;       // [m] 0 / 1 column mask, or null
  float* ml_terms;         // [chains, k, m], or null: ML is given
  float* beta_terms;       // [chains, k, m], or null: a uniform prior
  float* crp_terms;        // [chains, k]
  const float* ml;         // stage 1: [chains] ML,
  const float* crp_sum;    // the sums of the CRP terms,
  const float* beta_sum;   // of the Beta terms (null: a uniform prior)
  float* map;              // [chains]
  int chains, k, m;
  float pm1, qm1, log_beta_norm;  // the Beta prior: p - 1, q - 1, log B(p, q)
  float n_minus_1;                // n_cells - 1
  // The Gamma prior of alpha (distributions.py::gamma_logpdf_loc): loc,
  // shape - 1, and the host's lgamma(shape) and log(scale).
  float gamma_loc, gamma_shape_m1, gamma_lgamma, gamma_log_scale;
  int learn_errors;
  Prior prior_fp, prior_fn;
};

// Stage 0 over every element, stage 1 over the chains. A template (the
// stage) so that the profiler's name for it, "trace_row_kernel<0>(...)",
// is one that portbench's devtrace.kernel_base parses.
template <int kStage>
__global__ void __launch_bounds__(kThreads) trace_row_kernel(const Args g) {
  const long i = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (kStage == 1) {
    if (i >= g.chains) return;
    const int c = static_cast<int>(i);
    // gamma_logpdf_loc: y = (alpha - loc) / 1, where(y > 0, ..., -inf).
    const float y = sub(g.alpha[c], g.gamma_loc);
    float lp = -INFINITY;
    if (y > 0.0f) {
      lp = sub(mul(logf(y), g.gamma_shape_m1), y);
      lp = sub(sub(lp, g.gamma_lgamma), g.gamma_log_scale);
    }
    lp = add(lp, g.crp_sum[c]);
    if (g.beta_sum != nullptr) lp = add(lp, g.beta_sum[c]);
    if (g.learn_errors) {
      lp = add(lp, prior_logpdf(g.fp[c], g.prior_fp));
      lp = add(lp, prior_logpdf(g.fn[c], g.prior_fn));
    }
    g.map[c] = add(g.ml[c], lp);
    return;
  }
  const long plane = static_cast<long>(g.k) * g.m;
  if (i < static_cast<long>(g.chains) * g.k) {
    // crp_size_log_prior(clamp(size, 1), n, alpha) on live slots, else 0.
    const int size = g.sizes[i];
    const float a = g.alpha[i / g.k];
    g.crp_terms[i] = size > 0
        ? sub(logf(__int2float_rn(size)), logf(add(a, g.n_minus_1)))
        : 0.0f;
  }
  if (i >= g.chains * plane) return;
  const int c = static_cast<int>(i / plane);
  const float th = g.params[i];
  if (g.ml_terms != nullptr) {
    g.ml_terms[i] = loglik(th, g.n1[i], g.n0[i], g.fp[c], g.fn[c]);
  }
  if (g.beta_terms != nullptr) {
    const int j = static_cast<int>(i % g.m);
    float v = beta_logpdf(th, g.pm1, g.qm1, g.log_beta_norm);
    if (g.mask != nullptr) v = mul(v, g.mask[j]);
    g.beta_terms[i] = g.sizes[i / g.m] > 0 ? v : 0.0f;
  }
}

template <int kStage>
void launch(const Args& g, long threads, cudaStream_t stream) {
  const long blocks = (threads + kThreads - 1) / kThreads;
  trace_row_kernel<kStage>
      <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(g);
}

}  // namespace

extern "C" {

// One stage (0 or 1) on the Args that `args` points to (host memory).
int bnpc_trace_row(int stage, const void* args, cudaStream_t stream) {
  const Args& g = *static_cast<const Args*>(args);
  const long elems = static_cast<long>(g.chains) * g.k * g.m;
  if (g.chains > 0 && g.k > 0 && g.m > 0) {
    if (stage == 0) {
      launch<0>(g, elems, stream);
    } else if (stage == 1) {
      launch<1>(g, g.chains, stream);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

// The error-rate MH in three launches (kernel 10; ops/cuda_error_mh.py).
//
// What it replaces: the torch composition of models/updates.py::
// update_error_rates, two scalar truncated-normal MH steps (FP, then FN
// with the new FP; libs/CRP_learning_errors.py:52-111). Every scalar op of
// the composition was a launch of its own, and each step summed the
// likelihood over the [k_max, m] statistics at its proposed and at its old
// rate: 272 device operations a call on an H100
// (scripts/kernel_census_torch.py). It replaces no Pallas kernel: XLA fused
// these ops on the TPU.
//
// The design. The sums over [k_max, m] stay torch's (the wrapper's caller
// takes ax.sum and ax.psum of the terms this kernel writes), so that each
// likelihood keeps the composition's bits, and a sharded mutation axis
// all-reduces them as before. Around them, three launches of one template:
//   stage 0 (one thread an element): FP's proposal, then the terms
//     n1 * c1 + n0 * c0 at (proposed FP, FN) and at (FP, FN);
//   stage 1 (one thread an element): FP's decision from the two sums, then
//     FN's proposal and its terms at (the chosen FP, proposed FN); the
//     first thread of each chain writes FP, its flag and its chosen sum;
//   stage 2 (one thread a chain): FN's decision. FN's old likelihood is
//     FP's chosen sum: the composition's same expression on the same values
//     (the chosen FP, FN), so the same bits, and it is not computed again.
// Each thread of a stage computes its chain's scalar steps itself: the same
// inputs give the same bits in every thread, with no shared state, no
// atomics and nothing that depends on thread timing.
//
// What bounds it: latency. A call moves 3 x 51,200 terms out and the
// statistics in three times at 256 x 200 (~1.8 MB, 0.55 us at 3.35 TB/s);
// each stage is one pass, and its scalar chain (ndtri, four log_ndtr) runs
// once a thread.
//
// The bits: every scalar op of the composition is one op of torch_ops.cuh,
// rounded as ATen rounds it; the draws are the composition's own six
// primitives, drawn by the wrapper in its order.

#include <cuda_runtime.h>

#include "torch_ops.cuh"

namespace {

using namespace torch_ops;

constexpr int kThreads = 256;

// One rate's host values (ops/cuda_error_mh.py::Rate).
struct Rate {
  float sd[3];  // the proposal's std multiset x the prior sd, in float32
  Prior prior;
};

struct Args {
  const float* params;   // [chains, per_chain]
  const float* n1;
  const float* n0;
  const float* fp;       // [chains]
  const float* fn;
  const int* idx_fp;     // [chains] the drawn primitives: the std index,
  const float* prop_fp;  // the proposal's uniform, the acceptance uniform
  const float* u_fp;
  const int* idx_fn;
  const float* prop_fn;
  const float* u_fn;
  const float* ll_new;   // [chains] torch's sums of the terms: FP's new and
  const float* ll_old;   // old (stage 1), FN's new (stage 2)
  float* terms_new;      // [chains, per_chain] stages 0 and 1
  float* terms_old;      // [chains, per_chain] stage 0
  float* fp_out;         // [chains]
  bool* fp_acc;
  float* ll_fp;          // FP's chosen likelihood
  float* fn_out;
  bool* fn_acc;
  float* ll_out;         // FN's chosen likelihood: the rates' likelihood
  long per_chain;
  int chains;
  Rate rate_fp, rate_fn;
};

// A proposal of _mh_error_rate: the std, the bounds and the new rate.
struct Proposal {
  float sd, a, b, nw;
};

__device__ __forceinline__ Proposal propose(float old, int idx, float u,
                                            const Rate& r) {
  Proposal p;
  // mh.choose(idx, sds): a select, the last value for any other index.
  p.sd = idx == 0 ? r.sd[0] : (idx == 1 ? r.sd[1] : r.sd[2]);
  p.a = dvd(sub(0.0f, old), p.sd);
  p.b = dvd(sub(1.0f, old), p.sd);
  p.nw = tn_from_uniform(u, p.a, p.b, old, p.sd);
  return p;
}

struct Decision {
  float value, ll;
  bool accept;
};

// The acceptance of _mh_error_rate from the likelihoods' sums.
__device__ __forceinline__ Decision decide(float old, const Proposal& p,
                                           float ll_new, float ll_old,
                                           float u, const Rate& r) {
  const float new_p = tn_logpdf(p.nw, p.a, p.b, old, p.sd);
  const float a_rev = dvd(sub(0.0f, p.nw), p.sd);
  const float b_rev = dvd(sub(1.0f, p.nw), p.sd);
  const float old_p = tn_logpdf(old, a_rev, b_rev, p.nw, p.sd);
  float A = sub(ll_new, ll_old);
  A = add(A, prior_logpdf(p.nw, r.prior));
  A = sub(A, prior_logpdf(old, r.prior));
  A = add(A, old_p);
  A = sub(A, new_p);
  const bool accept = logf(u) < A;
  return Decision{accept ? p.nw : old, accept ? ll_new : ll_old, accept};
}

// Stages 0 and 1 over every element, stage 2 over the chains. A template
// (the stage) so that the profiler's name for it, "error_mh_kernel<0>(...)",
// is one that portbench's devtrace.kernel_base parses.
template <int kStage>
__global__ void __launch_bounds__(kThreads) error_mh_kernel(const Args g) {
  const long i = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (kStage == 2) {
    if (i >= g.chains) return;
    const int c = static_cast<int>(i);
    const Proposal p = propose(g.fn[c], g.idx_fn[c], g.prop_fn[c], g.rate_fn);
    const Decision d = decide(g.fn[c], p, g.ll_new[c], g.ll_fp[c], g.u_fn[c],
                              g.rate_fn);
    g.fn_out[c] = d.value;
    g.fn_acc[c] = d.accept;
    g.ll_out[c] = d.ll;
    return;
  }
  if (i >= g.chains * g.per_chain) return;
  const int c = static_cast<int>(i / g.per_chain);
  const float th = g.params[i], n1 = g.n1[i], n0 = g.n0[i];
  const float fp = g.fp[c], fn = g.fn[c];
  const Proposal pf = propose(fp, g.idx_fp[c], g.prop_fp[c], g.rate_fp);
  if (kStage == 0) {
    g.terms_new[i] = loglik(th, n1, n0, pf.nw, fn);
    g.terms_old[i] = loglik(th, n1, n0, fp, fn);
    return;
  }
  const Decision d = decide(fp, pf, g.ll_new[c], g.ll_old[c], g.u_fp[c],
                            g.rate_fp);
  const Proposal pn = propose(fn, g.idx_fn[c], g.prop_fn[c], g.rate_fn);
  g.terms_new[i] = loglik(th, n1, n0, d.value, pn.nw);
  if (i == static_cast<long>(c) * g.per_chain) {
    g.fp_out[c] = d.value;
    g.fp_acc[c] = d.accept;
    g.ll_fp[c] = d.ll;
  }
}

template <int kStage>
void launch(const Args& g, long threads, cudaStream_t stream) {
  const long blocks = (threads + kThreads - 1) / kThreads;
  error_mh_kernel<kStage>
      <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(g);
}

}  // namespace

extern "C" {

// One stage (0, 1 or 2) on the Args that `args` points to (host memory).
int bnpc_error_mh(int stage, const void* args, cudaStream_t stream) {
  const Args& g = *static_cast<const Args*>(args);
  const long elems = g.chains * g.per_chain;
  if (g.chains > 0 && g.per_chain > 0) {
    if (stage == 0) {
      launch<0>(g, elems, stream);
    } else if (stage == 1) {
      launch<1>(g, elems, stream);
    } else if (stage == 2) {
      launch<2>(g, g.chains, stream);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

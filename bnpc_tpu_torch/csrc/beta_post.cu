// The Beta posterior rows of a split-merge launch in one launch (kernel 8;
// ops/cuda_beta.py).
//
// What it replaces: the torch composition of state.py::beta_posterior_params
// (rows from Beta(p + N1, q + N0), clipped to [TMIN, TMAX],
// libs/CRP.py:155-188), which draws through ops/randomx.py::beta_general:
// two Marsaglia-Tsang gammas, six unrolled rounds each with first-accept
// semantics, then the small-shape boost Gamma(a) = Gamma(a + 1) U^(1/a). It
// replaces no Pallas kernel: on the TPU, XLA fused this elementwise chain by
// itself (bnpc_tpu/ops/randomx.py); in the port's eager torch it ran as 334
// small kernels a call, three calls a split-merge move (models/
// splitmerge.py::_rg_init), about 350 of a chain-step's ~880 device
// operations.
//
// What bounds it: launch latency and one element's chain of ~15 dependent
// transcendentals, not bytes. A split-merge call reads 3 rows x 200 columns
// x 28 words (the two counts, 26 primitives) and writes 3 x 200 words:
// 70 KB, 0.02 us at 3.35 TB/s. The design answers that by being one
// launch: one thread an element, every element computed start to end in
// registers; nothing is reduced, so a batch of chains (more rows of one
// grid) gives each chain the bits of its one-chain launch.
//
// The bits. The random draws stay torch's (26 normals and uniforms a row,
// drawn by the wrapper in the composition's order), and every element
// follows the composition operation by operation: each torch elementwise op
// is one correctly rounded operation here (the __f*_rn intrinsics, which
// are never contracted into an FMA, as ATen's separate kernels round each
// op), and the math library calls are those ATen's kernels make: logf
// (torch.log), powf (torch.pow of two tensors), the correctly rounded sqrt
// (torch.sqrt), the cube of torch.pow(x, 3) as ATen's (x * x) * x, and
// 1.0 / t as torch's __rtruediv__, reciprocal(t) * 1.0. The file is built,
// as ATen's kernels are, with FMA contraction on (ops/_build.py), so that
// the library calls compile as theirs do.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBoostRounds = 6;                  // randomx.BOOST_ROUNDS

// The composition's constants, each as torch casts a Python float.
constexpr float kTmin = static_cast<float>(1e-5);           // config.TMIN
constexpr float kTmax = static_cast<float>(1.0 - 1e-5);     // config.TMAX
constexpr float kThird = static_cast<float>(1.0 / 3.0);

// One torch elementwise op each, rounded once.
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

// torch.clamp(v, lo, hi): NaN passes through.
__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

// 1.0 / t: torch's __rtruediv__, t.reciprocal() * 1.0.
__device__ __forceinline__ float rdiv1(float t) {
  return mul(dvd(1.0f, t), 1.0f);
}

// ops/randomx.py::mt_gamma_boosted on its drawn primitives `pr` (a row's
// column, the draws `m` apart): Marsaglia-Tsang at shape a + 1, kRounds
// rounds, the first accepting round's d * v kept (d where none accepts),
// then the boost.
template <int kRounds>
__device__ __forceinline__ float boosted(float a, const float* pr, int m) {
  const float d = sub(add(a, 1.0f), kThird);
  const float c = rdiv1(__fsqrt_rn(mul(d, 9.0f)));
  float g = d;
  bool accepted = false;
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const float x = pr[(2 * r) * m];
    const float u = pr[(2 * r + 1) * m];
    const float base = add(mul(c, x), 1.0f);
    const float v = mul(mul(base, base), base);   // torch.pow(base, 3)
    const float dv = mul(d, v);
    // 0.5 * x * x + d - d * v + d * log(where(v > 0, v, 1))
    const float rhs = add(sub(add(mul(mul(x, 0.5f), x), d), dv),
                          mul(d, logf(v > 0.0f ? v : 1.0f)));
    const bool ok = (v > 0.0f) && (logf(u) < rhs);
    if (!accepted && ok) g = dv;
    accepted = accepted || ok;
  }
  return mul(g, powf(pr[2 * kRounds * m], rdiv1(a)));
}

struct Args {
  const float* n1;       // [rows, m]
  const float* n0;
  const float* prims;    // [rows, 2 (2 rounds + 1), m]
  float* out;            // [rows, m]
  long elems;            // rows * m
  int m;
  float p, q;
};

// A template on kRounds (one value, kBoostRounds) so that the profiler's
// name for it, "beta_post_kernel<6>(...)", is one that portbench's
// devtrace.kernel_base parses; a plain name it does not (PERF.md, section 7).
template <int kRounds>
__global__ void __launch_bounds__(kThreads) beta_post_kernel(const Args g) {
  const long e = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= g.elems) return;
  const long row = e / g.m;
  const int j = static_cast<int>(e - row * g.m);
  // A gamma's primitives (a normal and a uniform a round, the boost's
  // uniform) and a row's (both gammas'): randomx.BETA_PRIMITIVES.
  constexpr int kGammaDraws = 2 * kRounds + 1;
  const float* pr = g.prims + row * (2 * kGammaDraws) * g.m + j;
  // state.py::beta_posterior_params: randomx.beta_general(p + n1, q + n0).
  const float a = add(g.n1[e], g.p);
  const float b = add(g.n0[e], g.q);
  const float ga = boosted<kRounds>(a, pr, g.m);
  const float gb = boosted<kRounds>(b, pr + kGammaDraws * g.m, g.m);
  const float denom = add(ga, gb);
  g.out[e] = clamp(denom > 0.0f ? dvd(ga, denom) : 0.5f, kTmin, kTmax);
}

}  // namespace

extern "C" {

// Rows [rows, m]: n1, n0 and out; prims [rows, 26, m].
int bnpc_beta_post(const float* n1, const float* n0, const float* prims,
                   float* out, int rows, int m, float p, float q,
                   cudaStream_t stream) {
  const long elems = static_cast<long>(rows) * m;
  if (elems > 0) {
    const Args g{n1, n0, prims, out, elems, m, p, q};
    const long blocks = (elems + kThreads - 1) / kThreads;
    beta_post_kernel<kBoostRounds>
        <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(g);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

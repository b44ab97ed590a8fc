// Torch's float32 elementwise ops on one value, each rounded as ATen's CUDA
// kernel for that op rounds it, and the compositions of them that the
// fused kernels share (kernels 7, 10 and 11: csrc/mh_sweep.cu,
// csrc/error_mh.cu, csrc/trace_row.cu).
//
// Each torch elementwise op is one correctly rounded operation here (the
// __f*_rn intrinsics, which nvcc never contracts into an FMA, as ATen's
// separate kernels round each op); the math library calls are those ATen's
// kernels make (logf, log1pf, expf, expm1f, erff), and ndtri and log_ndtr
// are ATen's own CUDA bodies (aten_special.cuh). A file that includes this
// header is built, as ATen is, with FMA contraction on (ops/_build.py), so
// that those bodies round as ATen's do. On an H100 every function agreed
// with torch's kernel bit for bit over 4M inputs (csrc/mh_sweep.cu).

#pragma once

#include <math.h>

#include "aten_special.cuh"

namespace torch_ops {

// The compositions' constants, each as torch casts a Python float.
constexpr float kHalfLog2Pi = static_cast<float>(0.9189385332046727);
constexpr float kSqrt1_2 = static_cast<float>(0.70710678118654752440);
constexpr float kPLo = static_cast<float>(1e-12);
constexpr float kPHi = static_cast<float>(1.0 - 1e-12);
constexpr float kMassMax = static_cast<float>(-1e-12);

// One torch elementwise op each, rounded once.
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

// torch.clamp(v, max=hi), torch.clamp(v, lo, hi): NaN passes through.
__device__ __forceinline__ float clamp_max(float v, float hi) {
  return isnan(v) ? v : fminf(v, hi);
}
__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}
// torch.maximum / torch.minimum: NaN propagates.
__device__ __forceinline__ float maximum(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
__device__ __forceinline__ float minimum(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}

// torch.special.ndtr: the composite (1 + erf(x * M_SQRT1_2)) * 0.5.
__device__ __forceinline__ float ndtr(float x) {
  return mul(add(1.0f, erff(mul(x, kSqrt1_2))), 0.5f);
}

// ops/truncnorm.py::_log_gauss_mass.
__device__ __forceinline__ float log_gauss_mass(float a, float b) {
  const bool flip = a > 0.0f;
  const float a_ = flip ? -b : a;
  const float b_ = flip ? -a : b;
  const float la = aten_special::log_ndtr(a_);
  const float lb = aten_special::log_ndtr(b_);
  return add(lb, log1pf(-expf(clamp_max(sub(la, lb), kMassMax))));
}

// ops/truncnorm.py::logpdf, `scale` a CUDA tensor (a true division).
__device__ __forceinline__ float tn_logpdf(float x, float a, float b,
                                           float loc, float scale) {
  const float z = dvd(sub(x, loc), scale);
  float r = mul(mul(z, -0.5f), z);
  r = sub(r, kHalfLog2Pi);
  r = sub(r, logf(scale));
  return sub(r, log_gauss_mass(a, b));
}

// ops/truncnorm.py::from_uniform: the inverse-CDF variate of uniform u.
__device__ __forceinline__ float tn_from_uniform(float u, float a, float b,
                                                 float loc, float scale) {
  const float pa = ndtr(a), pb = ndtr(b);
  const float p = clamp(add(pa, mul(u, sub(pb, pa))), kPLo, kPHi);
  const float y = add(loc, mul(scale, aten_special::ndtri(p)));
  return minimum(maximum(y, add(loc, mul(a, scale))),
                 add(loc, mul(b, scale)));
}

// ops/distributions.py::beta_logpdf.
__device__ __forceinline__ float beta_logpdf(float x, float pm1, float qm1,
                                             float log_norm) {
  return sub(add(mul(logf(x), pm1), mul(log1pf(-x), qm1)), log_norm);
}

// n1 * c1 + n0 * c0 of ops/likelihood.py::log_prob_tables.
__device__ __forceinline__ float loglik(float th, float n1, float n0,
                                        float fp, float fn) {
  const float c1 = logf(add(mul(th, sub(1.0f, fn)), mul(sub(1.0f, th), fp)));
  const float c0 = logf(add(mul(th, fn), mul(sub(1.0f, th), sub(1.0f, fp))));
  return add(mul(n1, c1), mul(n0, c0));
}

// One truncated-normal prior on [0, 1] of an error rate
// (ops/distributions.py::truncnorm_prior_logpdf): its scale, bounds and
// their mass are CPU tensors there, so torch computes log(sd) and the mass
// on the host and divides by sd as a product with its reciprocal (ATen's
// CUDA division by a CPU scalar); the wrappers pass those host values.
struct Prior {
  float mean;    // the prior mean, as torch casts it
  float inv_sd;  // 1 / sd in float32
  float log_sd;  // torch.log(sd) on the CPU
  float mass;    // truncnorm._log_gauss_mass(a, b) on the CPU
};

__device__ __forceinline__ float prior_logpdf(float x, const Prior& p) {
  const float z = mul(sub(x, p.mean), p.inv_sd);
  float r = mul(mul(z, -0.5f), z);
  r = sub(r, kHalfLog2Pi);
  r = sub(r, p.log_sd);
  return sub(r, p.mass);
}

}  // namespace torch_ops

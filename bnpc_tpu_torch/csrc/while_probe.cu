// Probe of the early exit: the lazy Gibbs segment's loop from a dynamic
// start position, ending at the first birth, with the compile probe's
// arithmetic.
//
// Replaces the TPU kernel benchmarks/mosaic_while_probe.py::kernel (the
// inline Pallas body of that probe). Per position i from i0:
//
//   cell = perm[i]; v = z[cell]
//   logits = v + log(max(sizes, 0))           (no log_denom, no removal)
//   best = max(logits); idx = argmax(logits)
//   cand = v[0] > best; free = first slot with size 0 (k_pad when none)
//   t = cand && free < k_pad ? free : idx
//   out[i] = t; sizes += onehot(t)
//
// and the loop ends after the first birth (cand with a free slot), writing
// info = (i_next, birth_cell, -1, -1); birth_cell is -1 when it ran to n.
//
// NaN follows JAX, whose probe may start from NaN sizes: jnp.maximum and
// jnp.max propagate a NaN and jnp.argmax returns the first NaN's index,
// where fmaxf would drop it. So max(sizes, 0) is `s < 0 ? 0 : s`, the best
// logit is a NaN-propagating warp reduction, and idx is the first NaN slot
// when the best is NaN.
//
// What bounds it: the serial chain through `sizes`, as in lazy_segment.cu,
// whose design it keeps: one warp, lane l owns slots l, l+32, ... in
// registers, warp-shuffle reductions, the next cell's perm entry and z row
// loaded one cell ahead, and a warp-uniform break. It measures what a
// data-dependent exit and a relaunch at i_next cost the lazy driver.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a --fmad=false (no fast
// math: the accurate logf of the plain torch twin,
// bnpc_tpu_torch/probes/while_probe.py::while_exit_ref).

#include <cuda_runtime.h>
#include <math_constants.h>

#include "gibbs_common.cuh"

namespace {

using bnpc::kFull;

// max(a, b) that returns a NaN if either is one (jnp.maximum).
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}

__device__ __forceinline__ float warp_nan_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = nan_max(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

template <int SPL>  // slots per lane; k_pad = 32 * SPL
__global__ void __launch_bounds__(32, 1) while_exit_kernel(
    const float* __restrict__ z,     // [n, k_pad]
    const int* __restrict__ perm,    // [n] visit order
    float* __restrict__ sizes,       // [k_pad], updated in place
    int* __restrict__ out,           // [n] target by position
    int* __restrict__ info,          // [4]
    int n, int i0) {
  constexpr int K = 32 * SPL;
  const int lane = threadIdx.x;

  float sz[SPL];
#pragma unroll
  for (int s = 0; s < SPL; ++s) sz[s] = sizes[s * 32 + lane];

  int i = i0, birth_cell = -1;
  int cell = 0;
  float v[SPL];
  if (i0 < n) {
    cell = perm[i0];
#pragma unroll
    for (int s = 0; s < SPL; ++s) v[s] = z[(size_t)cell * K + s * 32 + lane];
  }

  while (i < n) {
    // Prefetch the next cell: independent of the carried sizes.
    int cell_n = 0;
    float v_n[SPL];
    if (i + 1 < n) {
      cell_n = perm[i + 1];
#pragma unroll
      for (int s = 0; s < SPL; ++s)
        v_n[s] = z[(size_t)cell_n * K + s * 32 + lane];
    }

    float logit[SPL];
    float best = -CUDART_INF_F;
#pragma unroll
    for (int s = 0; s < SPL; ++s) {
      logit[s] = v[s] + logf(sz[s] < 0.f ? 0.f : sz[s]);
      best = nan_max(best, logit[s]);
    }
    best = warp_nan_max(best);
    const bool best_nan = best != best;

    int free_l = K, idx_l = K;
#pragma unroll
    for (int s = 0; s < SPL; ++s) {
      const int slot = s * 32 + lane;
      if (sz[s] == 0.f) free_l = min(free_l, slot);
      if (best_nan ? logit[s] != logit[s] : logit[s] == best)
        idx_l = min(idx_l, slot);
    }
    const int free_slot = bnpc::warp_min(free_l);
    const int idx = bnpc::warp_min(idx_l);

    const float v0 = __shfl_sync(kFull, v[0], 0);  // slot 0's raw z value
    const bool is_new = v0 > best && free_slot < K;
    const int t = is_new ? free_slot : idx;
#pragma unroll
    for (int s = 0; s < SPL; ++s) sz[s] += (s * 32 + lane == t) ? 1.f : 0.f;
    if (lane == 0) out[i] = t;
    ++i;

    if (is_new) {
      birth_cell = cell;
      break;
    }
    cell = cell_n;
#pragma unroll
    for (int s = 0; s < SPL; ++s) v[s] = v_n[s];
  }

#pragma unroll
  for (int s = 0; s < SPL; ++s) sizes[s * 32 + lane] = sz[s];
  if (lane == 0) {
    info[0] = i;
    info[1] = birth_cell;
    info[2] = -1;
    info[3] = -1;
  }
}

template <int SPL>
void launch(const float* z, const int* perm, float* sizes, int* out,
            int* info, int n, int i0, cudaStream_t stream) {
  while_exit_kernel<SPL><<<1, 32, 0, stream>>>(z, perm, sizes, out, info, n,
                                               i0);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success); an
// unsupported k_pad (not 32 * {1, 2, 4, 8, 16, 32}) is cudaErrorInvalidValue.
extern "C" int bnpc_while_exit(const float* z, const int* perm, float* sizes,
                               int* out, int* info, int n, int k_pad, int i0,
                               cudaStream_t stream) {
  switch (k_pad) {
    case 32: launch<1>(z, perm, sizes, out, info, n, i0, stream); break;
    case 64: launch<2>(z, perm, sizes, out, info, n, i0, stream); break;
    case 128: launch<4>(z, perm, sizes, out, info, n, i0, stream); break;
    case 256: launch<8>(z, perm, sizes, out, info, n, i0, stream); break;
    case 512: launch<16>(z, perm, sizes, out, info, n, i0, stream); break;
    case 1024: launch<32>(z, perm, sizes, out, info, n, i0, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

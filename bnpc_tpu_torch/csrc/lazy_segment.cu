// One birth-bounded segment of the sequential per-cell Gibbs sweep.
//
// Replaces the TPU kernel bnpc_tpu/ops/pallas_gibbs.py::_lazy_segment_kernel
// (called through pallas_lazy_segment). Semantics, per permutation position
// i >= i0 (reference: update_assignments_Gibbs, libs/CRP.py:254-299):
//
//   cell = perm[i]; sizes[assign[cell]] -= 1
//   logits = z[cell] + (log(max(sizes, 0)) - log_denom)   (padded slots: -1)
//   best = max(logits); cand = aux[cell] > best
//   free = first slot with size 0; is_new = cand && a free slot exists
//   tgt  = is_new ? free : first slot with logits == best
//   sizes[tgt] += 1; tgt_out[i] = tgt
//
// and the segment ends after the first birth (is_new), writing
// info = (i_next, birth_cell, birth_slot, cap_veto). The caller draws the
// newborn row, patches that one z column and relaunches at i_next.
//
// What bounds it: the serial dependency chain through `sizes`, i.e. latency
// per cell, not bandwidth (z is 5 MB at 5,000 x 256 and stays in L2; each
// cell reads one 1 KB row). Design: ONE warp. Each lane owns k_pad/32 slots
// of the sizes row in registers (lane l owns slots l, l+32, ...), so a z
// row load is coalesced; best/free/idx are warp-shuffle reductions (the
// index-mins keep the first-lane tie-break and the first free slot). The
// next cell's perm/assign/aux/z-row loads are issued one cell ahead, since
// they do not depend on the carried sizes. The TPU kernel's 128-lane
// vector-flow batching is not carried over: it only existed because Mosaic
// is slow at crossing from vector to scalar.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a --fmad=false (no fast
// math: the logits must use the accurate logf of the plain torch twin,
// bnpc_tpu_torch/ops/cuda_gibbs.py::lazy_segment_ref).

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

__device__ __forceinline__ int warp_min(int x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = min(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

template <int SPL>  // slots per lane; k_pad = 32 * SPL
__global__ void __launch_bounds__(32, 1) lazy_segment_kernel(
    const float* __restrict__ z,       // [n, k_pad]
    const float* __restrict__ aux,     // [n]
    const int* __restrict__ assign,    // [n] pre-sweep assignment
    const int* __restrict__ perm,      // [n] visit order
    float* __restrict__ sizes,         // [k_pad], updated in place
    int* __restrict__ tgt_out,         // [n] target by position
    int* __restrict__ info,            // [4]
    const float* __restrict__ log_denom_p, int n, int i0) {
  constexpr int K = 32 * SPL;
  const int lane = threadIdx.x;
  const float log_denom = *log_denom_p;

  float sz[SPL];
#pragma unroll
  for (int s = 0; s < SPL; ++s) sz[s] = sizes[s * 32 + lane];

  int veto = 0, birth_pos = -1, birth_cell = -1, birth_slot = -1;

  int cell = 0, old = 0;
  float a = 0.f, v[SPL];
  if (i0 < n) {
    cell = perm[i0];
    old = assign[cell];
    a = aux[cell];
#pragma unroll
    for (int s = 0; s < SPL; ++s) v[s] = z[(size_t)cell * K + s * 32 + lane];
  }

  for (int i = i0; i < n; ++i) {
    // Prefetch the next cell: independent of the carried sizes.
    int cell_n = 0, old_n = 0;
    float a_n = 0.f, v_n[SPL];
    if (i + 1 < n) {
      cell_n = perm[i + 1];
      old_n = assign[cell_n];
      a_n = aux[cell_n];
#pragma unroll
      for (int s = 0; s < SPL; ++s)
        v_n[s] = z[(size_t)cell_n * K + s * 32 + lane];
    }

    // Remove the cell from its cluster (libs/CRP.py:262-266).
#pragma unroll
    for (int s = 0; s < SPL; ++s)
      if (s * 32 + lane == old) sz[s] -= 1.f;

    float logit[SPL];
    float best = -CUDART_INF_F;
#pragma unroll
    for (int s = 0; s < SPL; ++s) {
      logit[s] = v[s] + (logf(fmaxf(sz[s], 0.f)) - log_denom);
      best = fmaxf(best, logit[s]);
    }
    best = warp_max(best);

    int free_l = K, idx_l = K;
#pragma unroll
    for (int s = 0; s < SPL; ++s) {
      const int slot = s * 32 + lane;
      if (sz[s] == 0.f) free_l = min(free_l, slot);
      if (logit[s] == best) idx_l = min(idx_l, slot);
    }
    const int free_slot = warp_min(free_l);
    const int idx = warp_min(idx_l);

    const bool cand = a > best;
    const bool is_new = cand && free_slot < K;
    veto |= (cand && free_slot >= K) ? 1 : 0;
    const int t = is_new ? free_slot : idx;
#pragma unroll
    for (int s = 0; s < SPL; ++s)
      if (s * 32 + lane == t) sz[s] += 1.f;
    if (lane == 0) tgt_out[i] = t;

    if (is_new) {
      birth_pos = i;
      birth_cell = cell;
      birth_slot = t;
      break;
    }
    cell = cell_n;
    old = old_n;
    a = a_n;
#pragma unroll
    for (int s = 0; s < SPL; ++s) v[s] = v_n[s];
  }

#pragma unroll
  for (int s = 0; s < SPL; ++s) sizes[s * 32 + lane] = sz[s];
  if (lane == 0) {
    info[0] = birth_pos >= 0 ? birth_pos + 1 : n;
    info[1] = birth_cell;
    info[2] = birth_slot;
    info[3] = veto;
  }
}

template <int SPL>
void launch(const float* z, const float* aux, const int* assign,
            const int* perm, float* sizes, int* tgt, int* info,
            const float* log_denom, int n, int i0, cudaStream_t stream) {
  lazy_segment_kernel<SPL><<<1, 32, 0, stream>>>(z, aux, assign, perm, sizes,
                                                 tgt, info, log_denom, n, i0);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success); an
// unsupported k_pad (not 32 * {1, 2, 4, 8, 16, 32}) is cudaErrorInvalidValue.
extern "C" int bnpc_lazy_segment(const float* z, const float* aux,
                                 const int* assign, const int* perm,
                                 float* sizes, int* tgt, int* info,
                                 const float* log_denom, int n, int k_pad,
                                 int i0, cudaStream_t stream) {
  switch (k_pad) {
    case 32: launch<1>(z, aux, assign, perm, sizes, tgt, info, log_denom, n, i0, stream); break;
    case 64: launch<2>(z, aux, assign, perm, sizes, tgt, info, log_denom, n, i0, stream); break;
    case 128: launch<4>(z, aux, assign, perm, sizes, tgt, info, log_denom, n, i0, stream); break;
    case 256: launch<8>(z, aux, assign, perm, sizes, tgt, info, log_denom, n, i0, stream); break;
    case 512: launch<16>(z, aux, assign, perm, sizes, tgt, info, log_denom, n, i0, stream); break;
    case 1024: launch<32>(z, aux, assign, perm, sizes, tgt, info, log_denom, n, i0, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

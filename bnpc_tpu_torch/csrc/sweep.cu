// The whole sequential Gibbs sweep in one launch, births patched in-kernel.
//
// Replaces the TPU kernel bnpc_tpu/ops/pallas_gibbs.py::_sweep_kernel
// (pallas_gibbs.py:78, called through pallas_sweep). Cells are visited in
// absolute order through perm; each takes the per-cell step of
// gibbs_common.cuh on row z[cell], old = assign[cell], aux = aux[cell].
// On a birth of cell c into slot f the kernel itself writes
//
//   z[j, f] = lf[j, c] + gum[j, f]   for every cell j
//   params[f, :] = fresh[c, :]
//
// (pallas_gibbs.py:170-196) and carries on: no exit, no relaunch, no host
// read. assign_out[cell] receives the chosen slot. z is the caller's
// working copy and is patched in place.
//
// What bounds it: the serial chain per cell (one warp, latency bound, as
// lazy_segment.cu), plus O(n) strided loads and stores per birth (a column
// of lf and gum in, a column of z out). Design: the sizes row in registers
// (k_pad <= 1024, lane l owns slots l, l+32, ..., with the cached log
// weights of gibbs_common.cuh::chain_step) or in shared memory (k_pad up to
// 58,112); the next cell's perm/assign/aux/z row are loaded one cell ahead.
// What the step caches (w, wp) follows the sizes only, never z, so a birth's
// patch of a z column leaves it valid; a cache of anything read from z
// would have to be refreshed after patch_birth. Two traps: (1) the lanes
// that write the patched column are not the lanes that later read those
// rows, so the patch ends in
// __syncwarp(), which orders memory among the warp, and z is read with
// plain (coherent) loads, never through the read-only path; (2) the row
// prefetched for the next cell predates the patch, so after a birth its
// element f is set in registers to the value just stored. First-index
// tie-breaks as jnp.argmax in interpret mode.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a --fmad=false.

#include "gibbs_common.cuh"

namespace {

using namespace bnpc;

__device__ __forceinline__ void patch_birth(
    float* z, const float* __restrict__ gum, const float* __restrict__ lf,
    const float* __restrict__ fresh, float* __restrict__ params, int n,
    int k_pad, int m, int cell, int f, int lane) {
  for (int j = lane; j < n; j += 32)
    z[(size_t)j * k_pad + f] = lf[(size_t)j * n + cell]
        + gum[(size_t)j * k_pad + f];
  for (int e = lane; e < m; e += 32)
    params[(size_t)f * m + e] = fresh[(size_t)cell * m + e];
  __syncwarp();
}

template <int SPL>
__device__ __forceinline__ void load_row(float (&v)[SPL], const float* z,
                                         int cell, int k_pad,
                                         const int (&col)[SPL]) {
  const float* row = z + (size_t)cell * k_pad;
#pragma unroll
  for (int s = 0; s < SPL; ++s) v[s] = row[col[s]];
}

template <int SPL>  // register layout; k_pad <= 32 * SPL
__global__ void __launch_bounds__(32, 1) sweep_reg_kernel(
    float* z,                          // [n, k_pad] working copy, patched
    const float* __restrict__ gum,     // [n, k_pad]
    const float* __restrict__ lf,      // [n, n] lf[j, c] = ll(j | fresh[c])
    const float* __restrict__ fresh,   // [n, m] newborn row per cell
    const float* __restrict__ aux,     // [n]
    const int* __restrict__ assign,    // [n] pre-sweep assignment
    const int* __restrict__ perm,      // [n] visit order
    float* __restrict__ sizes,         // [k_pad], updated in place
    float* __restrict__ params,        // [*, m], updated in place
    int* __restrict__ assign_out,      // [n] cell order
    const float* __restrict__ log_denom_p, int n, int k_pad, int m) {
  const int lane = threadIdx.x;

  Chain<SPL> c;
  chain_init<SPL>(c, sizes, k_pad, *log_denom_p, lane);
  int col[SPL];
  row_cols<SPL>(col, k_pad, lane);

  int cell = 0;
  float a = 0.f, v[SPL];
  if (n > 0) {
    cell = perm[0];
    chain_remove_first<SPL>(c, assign[cell], lane);
    a = aux[cell];
    load_row<SPL>(v, z, cell, k_pad, col);
  }
  for (int i = 0; i < n; ++i) {
    int cell_n = 0, old_n = 0;
    float a_n = 0.f, v_n[SPL];
    if (i + 1 < n) {
      cell_n = perm[i + 1];
      old_n = assign[cell_n];
      a_n = aux[cell_n];
      load_row<SPL>(v_n, z, cell_n, k_pad, col);
    }
    // The sweep runs on past a birth: the step always removes the next cell.
    const Pick p = chain_step<SPL>(c, v, a, old_n, i + 1 < n, false, lane);
    if (p.is_new) {
      patch_birth(z, gum, lf, fresh, params, n, k_pad, m, cell, p.t, lane);
      // The next cell's row predates the patch: its owner lane sets element
      // t to the value just stored (the same float add).
#pragma unroll
      for (int s = 0; s < SPL; ++s)
        if (i + 1 < n && s * 32 + lane == p.t)
          v_n[s] = lf[(size_t)cell_n * n + cell]
              + gum[(size_t)cell_n * k_pad + p.t];
    }
    if (lane == 0) assign_out[cell] = p.t;
    cell = cell_n;
    a = a_n;
#pragma unroll
    for (int s = 0; s < SPL; ++s) v[s] = v_n[s];
  }

  chain_store<SPL>(c, sizes, k_pad, lane);
}

// Shared-memory layout for k_pad > 1024: rows are read straight from z
// after the patch's __syncwarp(), so no prefetched row can be stale.
__global__ void __launch_bounds__(32, 1) sweep_smem_kernel(
    float* z, const float* __restrict__ gum, const float* __restrict__ lf,
    const float* __restrict__ fresh, const float* __restrict__ aux,
    const int* __restrict__ assign, const int* __restrict__ perm,
    float* __restrict__ sizes, float* __restrict__ params,
    int* __restrict__ assign_out, const float* __restrict__ log_denom_p,
    int n, int k_pad, int m) {
  extern __shared__ float sz[];  // [k_pad]
  const int lane = threadIdx.x;
  const float log_denom = *log_denom_p;
  for (int s = lane; s < k_pad; s += 32) sz[s] = sizes[s];
  __syncwarp();

  for (int i = 0; i < n; ++i) {
    const int cell = perm[i];
    const Pick p = pick_smem(sz, z + (size_t)cell * k_pad, k_pad,
                             assign[cell], aux[cell], log_denom, lane);
    if (p.is_new)
      patch_birth(z, gum, lf, fresh, params, n, k_pad, m, cell, p.t, lane);
    if (lane == 0) assign_out[cell] = p.t;
  }

  for (int s = lane; s < k_pad; s += 32) sizes[s] = sz[s];
}

template <int SPL>
void launch_reg(float* z, const float* gum, const float* lf,
                const float* fresh, const float* aux, const int* assign,
                const int* perm, float* sizes, float* params, int* out,
                const float* log_denom, int n, int k_pad, int m,
                cudaStream_t stream) {
  sweep_reg_kernel<SPL><<<1, 32, 0, stream>>>(z, gum, lf, fresh, aux, assign,
                                              perm, sizes, params, out,
                                              log_denom, n, k_pad, m);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success); k_pad must be
// a positive multiple of 32 of at most 58,112 (cudaErrorInvalidValue).
extern "C" int bnpc_eager_sweep(float* z, const float* gum, const float* lf,
                                const float* fresh, const float* aux,
                                const int* assign, const int* perm,
                                float* sizes, float* params, int* out,
                                const float* log_denom, int n, int k_pad,
                                int m, cudaStream_t stream) {
  if (k_pad <= 0 || k_pad % 32 != 0 || k_pad > bnpc::kMaxSmemSlots)
    return (int)cudaErrorInvalidValue;
  const int spl = k_pad / 32;
  if (spl <= 1) {
    launch_reg<1>(z, gum, lf, fresh, aux, assign, perm, sizes, params, out, log_denom, n, k_pad, m, stream);
  } else if (spl <= 2) {
    launch_reg<2>(z, gum, lf, fresh, aux, assign, perm, sizes, params, out, log_denom, n, k_pad, m, stream);
  } else if (spl <= 4) {
    launch_reg<4>(z, gum, lf, fresh, aux, assign, perm, sizes, params, out, log_denom, n, k_pad, m, stream);
  } else if (spl <= 8) {
    launch_reg<8>(z, gum, lf, fresh, aux, assign, perm, sizes, params, out, log_denom, n, k_pad, m, stream);
  } else if (spl <= 16) {
    launch_reg<16>(z, gum, lf, fresh, aux, assign, perm, sizes, params, out, log_denom, n, k_pad, m, stream);
  } else if (spl <= 32) {
    launch_reg<32>(z, gum, lf, fresh, aux, assign, perm, sizes, params, out, log_denom, n, k_pad, m, stream);
  } else {
    const int bytes = k_pad * (int)sizeof(float);
    const cudaError_t err = bnpc::allow_smem(sweep_smem_kernel, bytes);
    if (err != cudaSuccess) return (int)err;
    sweep_smem_kernel<<<1, 32, bytes, stream>>>(z, gum, lf, fresh, aux,
                                                assign, perm, sizes, params,
                                                out, log_denom, n, k_pad, m);
  }
  return (int)cudaGetLastError();
}

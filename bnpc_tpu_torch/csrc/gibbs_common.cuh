// Per-cell step of the sequential Gibbs sweep, shared by the streaming
// segment kernel (lazy_stream.cu) and the eager whole-sweep kernel
// (sweep.cu). One warp runs the sweep; this header holds its pieces.
//
// Per visited cell (reference: update_assignments_Gibbs, libs/CRP.py:254-299):
//
//   sizes[old] -= 1
//   logits = z_row + (log(max(sizes, 0)) - log_denom)   (padded slots: -1)
//   best = max(logits); cand = aux > best
//   free = first slot with size 0; is_new = cand && a free slot exists
//   t = is_new ? free : first slot with logits == best
//   sizes[t] += 1
//
// with the float32 expressions, strict `>` and first-index tie-breaks of the
// plain torch twins (bnpc_tpu_torch/ops/cuda_gibbs.py::pick_ref).
//
// Two layouts of the sizes row:
//   * registers (k_pad <= 1024): lane l owns slots l, l+32, ..., so a z-row
//     load is coalesced; SPL slots per lane, a power of two; slots at or
//     beyond the row's k_pad are masked (size -1, never free, logit -inf)
//     and read the row's last element (row_cols), so no row load is
//     predicated (predicated loads made both kernels' chains slower per
//     cell on an H100; PERF.md);
//   * shared memory (k_pad up to 58,112 = 227 KB / 4): lane 0 writes, all
//     lanes read; each lane scans slots lane, lane+32, ... with a running
//     first-index argmax.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace bnpc {

constexpr unsigned kFull = 0xffffffffu;
// Slots the shared-memory sizes row can hold: 227 KB of dynamic shared
// memory a block may use on sm_90, in floats.
constexpr int kMaxSmemSlots = 232448 / 4;

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

__device__ __forceinline__ float logit_of(float v, float sz, float log_denom) {
  return v + (logf(fmaxf(sz, 0.f)) - log_denom);
}

struct Pick {
  int t;        // chosen slot
  bool cand;    // the new-cluster option beat every slot
  bool is_new;  // cand and a free slot existed (a birth into slot t)
};

// Column of the row that this lane's slot s reads in the register layout:
// the slot itself, or the row's last element for a slot at or beyond k_pad.
template <int SPL>
__device__ __forceinline__ void row_cols(int (&col)[SPL], int k_pad,
                                         int lane) {
#pragma unroll
  for (int s = 0; s < SPL; ++s) col[s] = min(s * 32 + lane, k_pad - 1);
}

// Register layout. sz/v hold this lane's slots; the row's slots at or beyond
// k_pad must come in with sz = -1 and a finite v.
template <int SPL>
__device__ __forceinline__ Pick pick_reg(float (&sz)[SPL],
                                         const float (&v)[SPL], int old,
                                         float a, float log_denom, int lane) {
  constexpr int KT = 32 * SPL;
#pragma unroll
  for (int s = 0; s < SPL; ++s)
    if (s * 32 + lane == old) sz[s] -= 1.f;

  float logit[SPL];
  float best = -CUDART_INF_F;
#pragma unroll
  for (int s = 0; s < SPL; ++s) {
    logit[s] = logit_of(v[s], sz[s], log_denom);
    best = fmaxf(best, logit[s]);
  }
  best = warp_max(best);

  int free_l = KT, idx_l = KT;
#pragma unroll
  for (int s = 0; s < SPL; ++s) {
    const int slot = s * 32 + lane;
    if (sz[s] == 0.f) free_l = min(free_l, slot);
    if (logit[s] == best) idx_l = min(idx_l, slot);
  }
  const int free_slot = warp_min(free_l);
  const int idx = warp_min(idx_l);

  Pick p;
  p.cand = a > best;
  p.is_new = p.cand && free_slot < KT;
  p.t = p.is_new ? free_slot : idx;
#pragma unroll
  for (int s = 0; s < SPL; ++s)
    if (s * 32 + lane == p.t) sz[s] += 1.f;
  return p;
}

// Shared-memory layout: sz [k_pad] in shared memory, row [k_pad] in global
// memory. Within a lane the running `>` keeps the first index of the lane's
// maximum, so the warp-min over lanes holding the global maximum is the
// first slot with logits == best.
__device__ __forceinline__ Pick pick_smem(float* sz, const float* row,
                                          int k_pad, int old, float a,
                                          float log_denom, int lane) {
  if (lane == 0) sz[old] -= 1.f;
  __syncwarp();
  float best_l = -CUDART_INF_F;
  int idx_l = k_pad, free_l = k_pad;
  for (int s = lane; s < k_pad; s += 32) {
    const float sv = sz[s];
    const float lg = logit_of(row[s], sv, log_denom);
    if (idx_l == k_pad || lg > best_l) {
      best_l = lg;
      idx_l = s;
    }
    if (sv == 0.f && free_l == k_pad) free_l = s;
  }
  const float best = warp_max(best_l);
  const int idx = warp_min(best_l == best ? idx_l : k_pad);
  const int free_slot = warp_min(free_l);

  Pick p;
  p.cand = a > best;
  p.is_new = p.cand && free_slot < k_pad;
  p.t = p.is_new ? free_slot : idx;
  __syncwarp();  // every lane has read sz before lane 0 writes it
  if (lane == 0) sz[p.t] += 1.f;
  __syncwarp();
  return p;
}

// Dynamic shared memory above the 48 KB default needs an opt-in per kernel.
template <typename Kernel>
__host__ inline cudaError_t allow_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

}  // namespace bnpc

// Per-cell step of the sequential Gibbs sweep, shared by the streaming
// segment kernel (lazy_stream.cu), the eager whole-sweep kernel (sweep.cu)
// and the vecflow probe (vecflow_probe.cu); the resident segment kernel
// (lazy_segment.cu) bounds and verifies instead and takes only the row
// search, the key map and the perm chunks from here. One warp runs the
// sweep; this header holds its pieces.
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
// plain torch twins (bnpc_tpu_torch/ops/cuda_gibbs.py::pick_ref), which are
// the definition: every kernel equals its twin exactly.
//
// Two layouts of the sizes row:
//   * registers (k_pad <= 1024, `Chain` / `chain_step`): lane l owns slots
//     l, l+32, ..., so a z-row load is coalesced; SPL slots per lane, a
//     power of two. Slots at or beyond the row's k_pad are masked (size -1,
//     never free, logit -inf) and read the row's last element (row_cols), so
//     no row load is predicated (predicated loads made the kernels' chains
//     slower per cell on an H100; PERF.md);
//   * shared memory (k_pad up to 58,112 = 227 KB / 4, `pick_smem`): lane 0
//     writes, all lanes read; each lane scans slots lane, lane+32, ... with
//     a running first-index argmax.
//
// What bounds the step is one warp's serial chain: the next cell's logits
// need this cell's size update, and a warp issues its instructions in order,
// so a cell costs the chain's latency plus every instruction that does not
// fit under it. What the register layout does about both:
//   * between two cells only two slots change (the one that gained this
//     cell, the one that loses the next), so the log weights
//     w = log(max(size, 0)) - log_denom are carried beside the sizes and
//     updated there, not recomputed with SPL logf a lane a cell. A second
//     row wp holds every slot's weight after a +1, so the gaining slot's new
//     weight is a register move; the two logs a cell still needs (the
//     gaining slot's next wp, the losing slot's weight after its -1) read
//     the sizes as they stood before the pick and are started ahead of it,
//     off the chain. The logit stays v + w, the twin's float32 expression
//     in the twin's order;
//   * best logit and first index are two integer warp reductions
//     (redux.sync), not two trees of five shuffles: each lane's float max
//     crosses the warp as an order-preserving unsigned key, and the first
//     index as the lane's first slot that equals the best. The first free
//     slot is a third, taken only for a cell whose new-cluster option won;
//   * work that is off the chain shortens a cell only where it sits between
//     the chain's instructions, and the compiler moves nothing across a
//     branch: the segment kernels keep the loop body one basic block (no
//     branch around a load, the next cell's inputs fetched a cell ahead,
//     __syncwarp() at its top so that no warp-wide instruction needs a
//     divergence check).
// The sizes must be cell counts (integers below 2^24, or -1 on masked
// slots): where a cell joins the slot the next cell leaves, +1 and -1 cancel
// and the slot is left as it is.

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

// Order-preserving map of a float (no NaN) onto unsigned integers, so that
// a float max is an integer one. x + 0.0f turns -0.0 into +0.0: the two are
// equal as floats (a tie the first index wins) but would differ as keys,
// and the best logit that comes back must equal both. -inf maps to
// 0x007fffff, the least key of a non-NaN.
__device__ __forceinline__ unsigned key_of(float x) {
  const unsigned u = __float_as_uint(x + 0.0f);
  return u ^ ((unsigned)((int)u >> 31) | 0x80000000u);
}

__device__ __forceinline__ float float_of_key(unsigned key) {
  return __uint_as_float(key ^ (~(unsigned)((int)key >> 31) | 0x80000000u));
}

__device__ __forceinline__ float log_weight(float sz, float log_denom) {
  return logf(fmaxf(sz, 0.f)) - log_denom;
}

template <int N>
__device__ __forceinline__ int tree_min(const int* x) {
  if constexpr (N == 1) {
    return x[0];
  } else {
    return min(tree_min<N / 2>(x), tree_min<N - N / 2>(x + N / 2));
  }
}

// Register layout: the state one warp carries from cell to cell. Lane l's
// element s belongs to slot s * 32 + l.
template <int SPL>
struct Chain {
  float sz[SPL];  // sizes; the row's slots at or beyond k_pad hold -1
  float w[SPL];   // log_weight(sz)
  float wp[SPL];  // log_weight(sz + 1), stale at slot `pend`
  int pend;       // the slot the last step added to (-1: none)
  float log_denom;
};

// Loads the sizes row (k_pad slots of `sizes`) and fills w and wp
// (2 * SPL logf a lane, once a launch).
template <int SPL>
__device__ __forceinline__ void chain_init(Chain<SPL>& c,
                                           const float* __restrict__ sizes,
                                           int k_pad, float log_denom,
                                           int lane) {
  c.log_denom = log_denom;
  c.pend = -1;
#pragma unroll
  for (int s = 0; s < SPL; ++s) {
    const int slot = s * 32 + lane;
    c.sz[s] = slot < k_pad ? sizes[slot] : -1.f;
    c.w[s] = log_weight(c.sz[s], log_denom);
    c.wp[s] = log_weight(c.sz[s] + 1.f, log_denom);
  }
}

// Writes the sizes row back.
template <int SPL>
__device__ __forceinline__ void chain_store(const Chain<SPL>& c,
                                            float* __restrict__ sizes,
                                            int k_pad, int lane) {
#pragma unroll
  for (int s = 0; s < SPL; ++s) {
    const int slot = s * 32 + lane;
    if (slot < k_pad) sizes[slot] = c.sz[s];
  }
}

// This lane's element of row x in the lane-row of `slot`: the slot's own
// value on the lane that owns it (any element for slot -1).
template <int SPL>
__device__ __forceinline__ float lane_value(const float (&x)[SPL], int slot) {
  const int row = slot >> 5;
  float r = x[0];
#pragma unroll
  for (int s = 1; s < SPL; ++s)
    if (row == s) r = x[s];
  return r;
}

// Entry j of 64 values held one a lane in two registers: `cur` (entries
// 0-31) and `nxt` (32-63). No branch: both shuffles are made.
template <typename T>
__device__ __forceinline__ T pair_at(T cur, T nxt, int j) {
  const T x = __shfl_sync(kFull, cur, j & 31);
  const T y = __shfl_sync(kFull, nxt, j & 31);
  return j < 32 ? x : y;
}

// perm, and assign / aux gathered through it, of 32 consecutive positions:
// lane l holds position base + l (cell 0 and zeros past n). The kernels
// that visit cells through a permutation (lazy_segment.cu, sweep.cu) keep
// two of these, the current chunk and the next, and read them with pair_at,
// so that no index load is on the chain or behind a branch.
struct PermChunk {
  int cell;
  int o;
  float a;
  __device__ __forceinline__ void load(const int* __restrict__ perm,
                                       const int* __restrict__ assign,
                                       const float* __restrict__ aux,
                                       int base, int n, int lane) {
    const int p = base + lane;
    cell = p < n ? perm[p] : 0;
    o = p < n ? assign[cell] : 0;
    a = p < n ? aux[cell] : 0.f;
  }
};

template <int N>
__device__ __forceinline__ float tree_fmax(const float* x) {
  if constexpr (N == 1) {
    return x[0];
  } else {
    return fmaxf(tree_fmax<N / 2>(x), tree_fmax<N - N / 2>(x + N / 2));
  }
}

// Best of a row of logits in the register layout and the first slot
// holding it. Within a lane the max and the compare are float ones; only
// each lane's max crosses the warp, as a key.
template <int SPL>
__device__ __forceinline__ void row_best(const float (&logit)[SPL], int lane,
                                         float& best, int& idx) {
  best = float_of_key(
      __reduce_max_sync(kFull, key_of(tree_fmax<SPL>(logit))));
  int hit[SPL];
#pragma unroll
  for (int s = 0; s < SPL; ++s)
    hit[s] = logit[s] == best ? s * 32 + lane : 32 * SPL;
  idx = __reduce_min_sync(kFull, tree_min<SPL>(hit));
}

// Best logit of the row v + w and the first slot holding it.
template <int SPL>
__device__ __forceinline__ void best_and_first(const Chain<SPL>& c,
                                               const float (&v)[SPL],
                                               int lane, float& best,
                                               int& idx) {
  float logit[SPL];
#pragma unroll
  for (int s = 0; s < SPL; ++s) logit[s] = v[s] + c.w[s];
  row_best<SPL>(logit, lane, best, idx);
}

// Removes the segment's first cell from slot `old`: the one removal that is
// not folded into a step.
template <int SPL>
__device__ __forceinline__ void chain_remove_first(Chain<SPL>& c, int old,
                                                   int lane) {
  const float x = lane_value<SPL>(c.sz, old) - 1.f;
  const float wn = log_weight(x, c.log_denom);
#pragma unroll
  for (int s = 0; s < SPL; ++s)
    if (s * 32 + lane == old) {
      c.sz[s] = x;
      c.wp[s] = c.w[s];
      c.w[s] = wn;
    }
}

// One cell, whose own removal is already in `c`: picks its slot from row v
// (the row's slots at or beyond k_pad may hold any finite v) and new-cluster
// value a, adds it there and, when `has_next`, removes the next cell from
// `old_next`, unless `stop_at_birth` and this cell is a birth (the segment
// ends, the next cell stays where it is).
template <int SPL>
__device__ __forceinline__ Pick chain_step(Chain<SPL>& c,
                                           const float (&v)[SPL], float a,
                                           int old_next, bool has_next,
                                           bool stop_at_birth, int lane) {
  constexpr int KT = 32 * SPL;
  // Off the chain: both logs read the sizes as they stand before the pick.
  const float wp_fix =
      log_weight(lane_value<SPL>(c.sz, c.pend) + 1.f, c.log_denom);
  const float wm =
      log_weight(lane_value<SPL>(c.sz, old_next) - 1.f, c.log_denom);
  float best;
  int idx;
  best_and_first<SPL>(c, v, lane, best, idx);

  Pick p;
  p.cand = a > best;
  p.is_new = false;
  p.t = idx;
  if (p.cand) {
    // Rare, and the same on every lane (a and best are): only now is
    // the first free slot needed.
    int zero[SPL];
#pragma unroll
    for (int s = 0; s < SPL; ++s)
      zero[s] = c.sz[s] == 0.f ? s * 32 + lane : KT;
    const int free_slot = __reduce_min_sync(kFull, tree_min<SPL>(zero));
    p.is_new = free_slot < KT;
    if (p.is_new) p.t = free_slot;
  }

  // +1 at t and -1 at old_next; on one slot they cancel.
  const bool remove = has_next && !(stop_at_birth && p.is_new);
  const bool apply = !(remove && p.t == old_next);
#pragma unroll
  for (int s = 0; s < SPL; ++s) {
    const int slot = s * 32 + lane;
    if (slot == c.pend) c.wp[s] = wp_fix;
    if (apply && slot == p.t) {
      c.sz[s] += 1.f;
      c.w[s] = c.wp[s];
    }
    if (apply && remove && slot == old_next) {
      c.sz[s] -= 1.f;
      c.wp[s] = c.w[s];
      c.w[s] = wm;
    }
  }
  c.pend = p.t;
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

// Rows of Z on their way from global to shared memory: the segment kernels
// keep kRing - 1 rows in flight with cp.async, one commit group per row.
constexpr int kRing = 8;

__device__ __forceinline__ void cp_async4(unsigned smem, const float* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// This lane's part of one row into the ring, unpredicated. `dst` is the
// shared-memory address (cvta) of this lane's first element of the ring
// row; `row` the row in global memory, read at the columns of row_cols.
template <int SPL>
__device__ __forceinline__ void issue_row(unsigned dst,
                                          const float* __restrict__ row,
                                          const int (&col)[SPL]) {
#pragma unroll
  for (int s = 0; s < SPL; ++s) cp_async4(dst + s * 128, row + col[s]);
}

// The same for a row of exactly 32 * SPL elements; `row_lane` points at this
// lane's first element of it.
template <int SPL>
__device__ __forceinline__ void issue_row_full(
    unsigned dst, const float* __restrict__ row_lane) {
#pragma unroll
  for (int s = 0; s < SPL; ++s) cp_async4(dst + s * 128, row_lane + s * 32);
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

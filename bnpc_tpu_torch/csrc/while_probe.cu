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
// where fmaxf would drop it. So max(sizes, 0) is `s < 0 ? 0 : s`, and every
// NaN logit, whatever its sign or payload, crosses the warp as the one key
// 0xffffffff, above +inf's: the max key is NaN iff a logit is, and the first
// slot holding it is the first NaN.
//
// What bounds it: the serial chain through `sizes`, as in lazy_segment.cu,
// whose loop and step it keeps (gibbs_common.cuh), with this probe's
// arithmetic:
//   * the log weights w = log(max(sz, 0)) and wp = log(max(sz + 1, 0)) are
//     carried beside the sizes; only the gaining slot changes, by +1, so its
//     new w is wp, and its stale wp is refreshed by one logf a cell started
//     before the pick, off the chain. Sizes are integers or NaN, and
//     NaN + 1 is NaN, so the cache gives the twin's bits;
//   * best and first index are two redux.sync reductions of the NaN-aware
//     keys; the first free slot is a third, only when cand holds;
//   * perm comes in 32-position chunks a chunk ahead, and a cp.async ring
//     keeps the rows of the next kRing - 1 positions in flight; the loop
//     body is one basic block (a position past n copies cell 0's row), and
//     the exit after a birth is a warp-uniform test at its bottom.
// It measures what a data-dependent exit and a relaunch at i_next cost the
// lazy driver.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a --fmad=false (no fast
// math: the accurate logf of the plain torch twin,
// bnpc_tpu_torch/probes/while_probe.py::while_exit_ref).

#include "gibbs_common.cuh"

namespace {

using namespace bnpc;

// log(max(s, 0)) with jnp.maximum's NaN: a NaN size gives a NaN weight.
__device__ __forceinline__ float nan_log_weight(float s) {
  return logf(s < 0.f ? 0.f : s);
}

// key_of with every NaN mapped to 0xffffffff, above +inf's 0xff800000.
__device__ __forceinline__ unsigned nan_key(float x) {
  return x != x ? 0xffffffffu : key_of(x);
}

template <int N>
__device__ __forceinline__ unsigned tree_umax(const unsigned* x) {
  if constexpr (N == 1) {
    return x[0];
  } else {
    return max(tree_umax<N / 2>(x), tree_umax<N - N / 2>(x + N / 2));
  }
}

// The probe's carried state: lane l's element s belongs to slot s * 32 + l.
template <int SPL>
struct NanChain {
  float sz[SPL];
  float w[SPL];   // nan_log_weight(sz)
  float wp[SPL];  // nan_log_weight(sz + 1), stale at slot `pend`
  int pend;       // the slot the last step added to (-1: none)
};

// One cell: picks its slot from row v, whose slot 0 holds v0 (the
// new-cluster value), and adds it there. Returns the slot; is_new says it
// was a birth.
template <int SPL>
__device__ __forceinline__ int nan_step(NanChain<SPL>& c,
                                        const float (&v)[SPL], float v0,
                                        int lane, bool& is_new) {
  constexpr int KT = 32 * SPL;
  // Off the chain: reads the sizes as they stand before the pick.
  const float wp_fix = nan_log_weight(lane_value<SPL>(c.sz, c.pend) + 1.f);
  // v0 > best as keys: a NaN v0 gets the least key, and nothing is above
  // a NaN best's, so cand is false on either NaN.
  const unsigned v0_key = v0 != v0 ? 0u : key_of(v0);
  unsigned key[SPL];
#pragma unroll
  for (int s = 0; s < SPL; ++s) key[s] = nan_key(v[s] + c.w[s]);
  const unsigned best = __reduce_max_sync(kFull, tree_umax<SPL>(key));
  int hit[SPL];
#pragma unroll
  for (int s = 0; s < SPL; ++s) hit[s] = key[s] == best ? s * 32 + lane : KT;
  int t = __reduce_min_sync(kFull, tree_min<SPL>(hit));
  is_new = false;
  if (v0_key > best) {
    // Rare, and the same on every lane: only now is the free slot needed.
    int zero[SPL];
#pragma unroll
    for (int s = 0; s < SPL; ++s)
      zero[s] = c.sz[s] == 0.f ? s * 32 + lane : KT;
    const int free_slot = __reduce_min_sync(kFull, tree_min<SPL>(zero));
    is_new = free_slot < KT;
    if (is_new) t = free_slot;
  }
#pragma unroll
  for (int s = 0; s < SPL; ++s) {
    const int slot = s * 32 + lane;
    if (slot == c.pend) c.wp[s] = wp_fix;
    if (slot == t) {
      c.sz[s] += 1.f;
      c.w[s] = c.wp[s];
    }
  }
  c.pend = t;
  return t;
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
  __shared__ __align__(16) float ring[kRing][K];
  const int lane = threadIdx.x;

  NanChain<SPL> c;
  c.pend = -1;
#pragma unroll
  for (int s = 0; s < SPL; ++s) {
    c.sz[s] = sizes[s * 32 + lane];
    c.w[s] = nan_log_weight(c.sz[s]);
    c.wp[s] = nan_log_weight(c.sz[s] + 1.f);
  }

  int i_next = n, birth_cell = -1;
  if (i0 < n) {
    // perm of 32 positions a lane each, this chunk and the next (cell 0
    // past n).
    int cb = i0 & ~31;
    int cur = cb + lane < n ? perm[cb + lane] : 0;
    int nxt = cb + 32 + lane < n ? perm[cb + 32 + lane] : 0;

    // Rows of positions i0 .. i0 + kRing - 2 in flight, one commit group
    // per row; iteration i issues position i + kRing - 1's row into the
    // ring slot that position i - 1's row left.
    const unsigned ring_s =
        (unsigned)__cvta_generic_to_shared(&ring[0][lane]);
    constexpr unsigned kRowBytes = K * sizeof(float);
    const float* z_lane = z + lane;
    for (int d = 0; d < kRing - 1; ++d) {
      const int r = i0 + d;
      issue_row_full<SPL>(ring_s + (unsigned)r % kRing * kRowBytes,
                          z_lane + (size_t)pair_at(cur, nxt, r - cb) * K);
      cp_async_commit();
    }
    float v[SPL];
    cp_async_wait<kRing - 2>();  // row i0 has landed (this lane's part)
#pragma unroll
    for (int s = 0; s < SPL; ++s) v[s] = ring[i0 % kRing][s * 32 + lane];

    for (int i = i0;; ++i) {
      if (i - cb == 32) {  // once in 32 positions, before the block below
        cb = i;
        cur = nxt;
        nxt = cb + 32 + lane < n ? perm[cb + 32 + lane] : 0;
      }
      __syncwarp();
      const int r = i + kRing - 1;
      issue_row_full<SPL>(ring_s + (unsigned)r % kRing * kRowBytes,
                          z_lane + (size_t)pair_at(cur, nxt, r - cb) * K);
      cp_async_commit();
      cp_async_wait<kRing - 2>();  // position i + 1's row has landed
      float v_n[SPL];
#pragma unroll
      for (int s = 0; s < SPL; ++s)
        v_n[s] = ring[(unsigned)(i + 1) % kRing][s * 32 + lane];

      bool is_new;
      const int t = nan_step<SPL>(c, v, __shfl_sync(kFull, v[0], 0), lane,
                                  is_new);
      if (lane == 0) out[i] = t;
      if (is_new || i + 1 >= n) {
        i_next = i + 1;
        if (is_new) birth_cell = __shfl_sync(kFull, cur, i - cb);
        break;
      }
#pragma unroll
      for (int s = 0; s < SPL; ++s) v[s] = v_n[s];
    }
    cp_async_wait_all();
  }

  // The twin adds 0.0 to every other slot of a visited cell, which turns a
  // -0.0 size into +0.0; the same here, once.
#pragma unroll
  for (int s = 0; s < SPL; ++s)
    sizes[s * 32 + lane] = i0 < n ? c.sz[s] + 0.f : c.sz[s];
  if (lane == 0) {
    info[0] = i_next;
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

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
// per cell, not bandwidth (z is 5 MB at 5,000 x 256 and stays in L2). A
// search of every slot on that chain costs ~300 instructions a cell, yet
// within a segment each cell moves the log weights of only two slots, by
// little, while a cell's best logit usually beats its second by far more.
// So the kernel bounds and verifies, in two roles of one template:
//
//   * the bound pass (kBounds, many warps): with w0 the log weights of the
//     sizes as the launch finds them, for every position i >= i0 it writes
//     b = the first slot holding max_k (z[cell, k] + w0[k]), vb = z[cell, b]
//     and s2 = max over k != b of (z[cell, k] + w0[k]) (-inf if none) to
//     `bounds` [3, n] (b as a float);
//   * the walk (one warp a chain) carries the sizes, their log weights
//     w = log(max(size, 0)) - log_denom, w0 beside them, and D, an upper
//     bound on max_k (w[k] - w0[k]) raised at every removal and gain. A
//     cell with L = vb + w[b] (the twin's float32 logit of slot b, its own
//     removal in w) and
//
//         L > (s2 + D) + tol   and not   aux > L
//
//     takes slot b with best == L without looking at its row; any other
//     cell runs the full pick (every slot's logit, the first index of the
//     best, the free slot, the birth and veto rules) from its row.
//
// Why a settled cell's pick is the twin's, bit for bit. Let u = 2^-24 and
// e = 2^-150 (round to nearest: |x - fl(x)| <= u|fl(x)| + e). For a slot
// k != b, fl(z_k + w0_k) <= s2, so z_k + w0_k <= s2 + u|s2| + e. Every
// weight change raises D to at least fl(w_k - w0_k), so w_k - w0_k <=
// D(1 + 2u) + 2e (a weight that was -inf and is finite makes D = +inf, and
// the check fails; -inf - -inf is NaN, which fmaxf drops: the slot's logit
// is -inf). Hence z_k + w_k <= s2 + D + u|s2| + 2uD + 3e, and fl(z_k + w_k)
// < L holds once z_k + w_k <= L - 2u|L| - e, the float below L. The check
// computes T = fl(fl(s2 + D) + tol) >= s2 + D + tol(1 - u) - 2.01u(|s2| +
// D) - 3e, so L > T implies all that when tol(1 - u) >= u(3.01|s2| +
// 4.01D + 2|L|) + 7e. The kernel takes
//
//   tol = 2^-20 * (((|L| + D) + |s2|) + 2^-100)    (|s2| read as 0 at -inf)
//
// >= 16u(1 - u)^3 (|L| + D + |s2| + 2^-100), which covers it with room
// (2^-120 > 7e). At s2 = -inf every other slot's logit stays -inf unless
// some -inf weight became finite (D = +inf, NaN threshold): L > -inf is
// the whole check. So a settled cell's logit L is a strict maximum: no
// tie-break applies, best == L is the twin's logits.max(), and cand is
// false. The margin this gives up is ~2^-18 relative, against margins of
// tens to hundreds of nats between clusters.
//
// The walk checks 32 positions at once, lane j position pos + j: if every
// cell before j settles, the state at j's check is known ahead (each one
// removed from its slot and added at its bound's slot b), so lane j sizes
// slot b and D at its check from the counts of the window's earlier
// removals and gains at those slots (bit masks of lanes per slot, built
// with shared-memory atomicOr), three logs and a prefix max across the
// lanes. The cells before the first that fails are committed at once
// (targets, sizes, weights); that one runs the full pick serially, its row
// read from global memory (L2), in gibbs_common.cuh's register layout
// (row_best); the next window starts behind it. The state lives in shared
// memory, read and written the same by every lane between __syncwarp()s.
// perm comes in 32-position chunks, one chunk ahead, with assign[perm],
// aux[perm] and the bounds gathered behind it, a lane per position, and a
// window takes its 32 positions from the two chunks by warp shuffle. Each
// launch adds its number of full picks to full[chain] (when given).
//
// A batch of chains runs as a grid of one block a chain (bnpc_lazy_segment_
// chains): block c reads and writes chain c's slice of every argument, and
// takes its start position from i0s[c], which it advances to its i_next; a
// chain with i0s[c] >= n only writes its info (n, -1, -1, 0). The one-chain
// entry (bnpc_lazy_segment) is the same kernels on a grid of one, its start
// position a launch argument. Every entry launches the bound pass and then
// the walk on one stream.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a --fmad=false (no fast
// math: the logits must use the accurate logf of the plain torch twin,
// bnpc_tpu_torch/ops/cuda_gibbs.py::lazy_segment_ref; the bound and the
// check are modelled by lazy_bounds_ref and lazy_segment_verified_ref).

#include "gibbs_common.cuh"

namespace {

using namespace bnpc;

// The bound pass: kBoundWarps warps a block, kBoundRows positions a warp.
constexpr int kBoundWarps = 8;
constexpr int kBoundRows = 4;
constexpr int kBoundSpan = kBoundWarps * kBoundRows;  // positions a block

constexpr float kTolScale = 0x1p-20f;
constexpr float kTolFloor = 0x1p-100f;

// The bounds of 32 consecutive positions, lane l holding position base + l
// (zeros past n), as PermChunk holds their cells.
struct BoundChunk {
  int b;
  float vb;
  float s2;
  __device__ __forceinline__ void load(const float* __restrict__ bounds,
                                       int base, int n, int lane) {
    const int p = base + lane;
    b = p < n ? (int)bounds[p] : 0;
    vb = p < n ? bounds[n + p] : 0.f;
    s2 = p < n ? bounds[2 * n + p] : 0.f;
  }
};

template <int SPL>
__device__ __forceinline__ void bound_pass(const float* __restrict__ z,
                                           const int* __restrict__ perm,
                                           const float* __restrict__ sizes,
                                           float log_denom,
                                           float* __restrict__ bounds, int n,
                                           int i0) {
  constexpr int K = 32 * SPL;
  const int lane = threadIdx.x & 31;
  const int first =
      blockIdx.x * kBoundSpan + (int)(threadIdx.x >> 5) * kBoundRows;
  if (first + kBoundRows <= i0 || first >= n) return;
  float w0[SPL];
#pragma unroll
  for (int s = 0; s < SPL; ++s)
    w0[s] = log_weight(sizes[s * 32 + lane], log_denom);
  for (int r = 0; r < kBoundRows; ++r) {
    const int i = first + r;
    if (i < i0 || i >= n) continue;  // the same on every lane
    const float* zr = z + (size_t)perm[i] * K;
    float logit[SPL];
#pragma unroll
    for (int s = 0; s < SPL; ++s) logit[s] = zr[s * 32 + lane] + w0[s];
    float best;
    int b;
    row_best<SPL>(logit, lane, best, b);
    float rest = -CUDART_INF_F;
#pragma unroll
    for (int s = 0; s < SPL; ++s)
      if (s * 32 + lane != b) rest = fmaxf(rest, logit[s]);
    const float s2 =
        float_of_key(__reduce_max_sync(kFull, key_of(rest)));
    if (lane == 0) {
      bounds[i] = (float)b;
      bounds[n + i] = zr[b];
      bounds[2 * n + i] = s2;
    }
  }
}

template <int SPL>
__device__ __forceinline__ void walk(const float* __restrict__ z,
                                     const float* __restrict__ aux,
                                     const int* __restrict__ assign,
                                     const int* __restrict__ perm,
                                     float* __restrict__ sizes,
                                     int* __restrict__ tgt_out,
                                     int* __restrict__ info, float log_denom,
                                     const float* __restrict__ bounds,
                                     int* __restrict__ full_out, int n,
                                     int i0) {
  constexpr int K = 32 * SPL;
  // sizes, their weights, the weights at the launch, and per slot the
  // window's lanes whose cell leaves it / whose bound names it (bit masks).
  __shared__ float s_sz[K], s_w[K], s_w0[K];
  __shared__ unsigned s_left[K], s_named[K];
  const int lane = threadIdx.x;
  const unsigned below = (1u << lane) - 1u;  // the lanes before this one
  const unsigned upto = below | (1u << lane);
#pragma unroll
  for (int s = 0; s < SPL; ++s) {
    const int slot = s * 32 + lane;
    const float sz = sizes[slot];
    s_sz[slot] = sz;
    s_w[slot] = s_w0[slot] = log_weight(sz, log_denom);
    s_left[slot] = s_named[slot] = 0u;
  }

  int veto = 0, full = 0, birth_pos = -1, birth_cell = -1, birth_slot = -1;
  float d_max = 0.f;  // D above, over the events committed so far
  int cb = i0 & ~31;
  PermChunk cur, nxt;
  BoundChunk bcur, bnxt;
  cur.load(perm, assign, aux, cb, n, lane);
  nxt.load(perm, assign, aux, cb + 32, n, lane);
  bcur.load(bounds, cb, n, lane);
  bnxt.load(bounds, cb + 32, n, lane);
  __syncwarp();

  // A window: lane j takes position pos + j (of the m below n). Each lane
  // sizes its cell's check as the events before it leave the state (every
  // earlier cell of the window removed and added at its bound's slot, its
  // own cell removed), so all 32 checks run at once; the cells before the
  // first that fails are committed, that one runs the full pick, and the
  // next window starts behind it.
  for (int pos = i0; pos < n;) {
    if (pos - cb >= 32) {
      cb += 32;
      cur = nxt;
      bcur = bnxt;
      nxt.load(perm, assign, aux, cb + 32, n, lane);
      bnxt.load(bounds, cb + 32, n, lane);
    }
    const int m = min(32, n - pos);
    const int at = pos - cb + lane;  // < 64
    const int cell = pair_at(cur.cell, nxt.cell, at);
    const int o = pair_at(cur.o, nxt.o, at);
    const float a = pair_at(cur.a, nxt.a, at);
    const int b = pair_at(bcur.b, bnxt.b, at);
    const float vb = pair_at(bcur.vb, bnxt.vb, at);
    const float s2 = pair_at(bcur.s2, bnxt.s2, at);
    atomicOr(&s_left[o], 1u << lane);
    atomicOr(&s_named[b], 1u << lane);
    __syncwarp();
    const unsigned left_b = s_left[b], named_b = s_named[b];
    const unsigned left_o = s_left[o], named_o = s_named[o];
    const float sz_b = s_sz[b], sz_o = s_sz[o];
    const float w0_b = s_w0[b], w0_o = s_w0[o];
    // Slot b at this lane's check, and slot o after this lane's removal.
    const float at_b =
        sz_b + (float)(__popc(named_b & below) - __popc(left_b & upto));
    const float after_o =
        sz_o + (float)(__popc(named_o & below) - __popc(left_o & upto));
    const float w_b = log_weight(at_b, log_denom);
    const float w_g = log_weight(at_b + 1.f, log_denom);  // after the gain
    const float w_r = log_weight(after_o, log_denom);
    const float big_l = vb + w_b;
    // D at this lane's check: the removals up to it, the gains before it.
    const float d_gain = w_g - w0_b;
    const float gain_before = __shfl_up_sync(kFull, d_gain, 1);
    float e = fmaxf(w_r - w0_o, lane > 0 ? gain_before : -CUDART_INF_F);
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float x = __shfl_up_sync(kFull, e, off);
      if (lane >= off) e = fmaxf(e, x);
    }
    const float d_here = fmaxf(d_max, e);
    const float abs_s2 = s2 > -CUDART_INF_F ? fabsf(s2) : 0.f;
    const float tol =
        kTolScale * (((fabsf(big_l) + d_here) + abs_s2) + kTolFloor);
    const bool settled = big_l > (s2 + d_here) + tol && !(a > big_l);
    const unsigned fail = __ballot_sync(kFull, lane < m && !settled);
    const int f = fail ? __ffs(fail) - 1 : m;  // the first full pick
    // Committed: the gains of lanes below f, the removals up to f (< m).
    const int removed = f < m ? f + 1 : f;
    const unsigned gains = f == 32 ? kFull : (1u << f) - 1u;
    const unsigned losses = removed == 32 ? kFull : (1u << removed) - 1u;
    d_max = fmaxf(d_max, __shfl_sync(kFull, e, f < m ? f : m - 1));
    if (f == m) d_max = fmaxf(d_max, __shfl_sync(kFull, d_gain, m - 1));
    __syncwarp();  // every lane has read the state before any writes it
    s_left[o] = 0u;
    s_named[b] = 0u;
    if (lane < f) {
      tgt_out[pos + lane] = b;
      const float x = sz_b + (float)(__popc(named_b & gains) -
                                     __popc(left_b & losses));
      s_sz[b] = x;
      s_w[b] = log_weight(x, log_denom);
    }
    if (lane < removed) {
      const float x = sz_o + (float)(__popc(named_o & gains) -
                                     __popc(left_o & losses));
      s_sz[o] = x;
      s_w[o] = log_weight(x, log_denom);
    }
    __syncwarp();
    if (f == m) {
      pos += m;
      continue;
    }

    // The full pick of position pos + f, from its row and every slot's
    // weight (its own removal is in the state).
    ++full;
    const int cell_f = __shfl_sync(kFull, cell, f);
    const float a_f = __shfl_sync(kFull, a, f);
    const float* zr = z + (size_t)cell_f * K;
    float logit[SPL];
#pragma unroll
    for (int s = 0; s < SPL; ++s)
      logit[s] = zr[s * 32 + lane] + s_w[s * 32 + lane];
    float best;
    int t;
    row_best<SPL>(logit, lane, best, t);
    bool is_new = false;
    if (a_f > best) {
      // Rare, and the same on every lane: only now is the first free slot
      // needed.
      int zero[SPL];
#pragma unroll
      for (int s = 0; s < SPL; ++s)
        zero[s] = s_sz[s * 32 + lane] == 0.f ? s * 32 + lane : K;
      const int free_slot = __reduce_min_sync(kFull, tree_min<SPL>(zero));
      is_new = free_slot < K;
      if (is_new) t = free_slot;
      veto |= is_new ? 0 : 1;
    }
    const float sz_t = s_sz[t] + 1.f;
    const float w_t = log_weight(sz_t, log_denom);
    d_max = fmaxf(d_max, w_t - s_w0[t]);
    __syncwarp();
    s_sz[t] = sz_t;
    s_w[t] = w_t;
    if (lane == 0) tgt_out[pos + f] = t;
    __syncwarp();
    if (is_new) {
      birth_pos = pos + f;
      birth_cell = cell_f;
      birth_slot = t;
      break;
    }
    pos += f + 1;
  }

#pragma unroll
  for (int s = 0; s < SPL; ++s) sizes[s * 32 + lane] = s_sz[s * 32 + lane];
  if (lane == 0) {
    info[0] = birth_pos >= 0 ? birth_pos + 1 : n;
    info[1] = birth_cell;
    info[2] = birth_slot;
    info[3] = veto;
    if (full_out != nullptr) *full_out += full;
  }
}

template <int SPL, bool kBounds>  // slots per lane (k_pad = 32 * SPL); role
__global__ void __launch_bounds__(kBounds ? 32 * kBoundWarps : 32)
    lazy_segment_kernel(
        const float* __restrict__ z,       // [n, k_pad]
        const float* __restrict__ aux,     // [n]
        const int* __restrict__ assign,    // [n] pre-sweep assignment
        const int* __restrict__ perm,      // [n] visit order
        float* __restrict__ sizes,         // [k_pad], updated in place
        int* __restrict__ tgt_out,         // [n] target by position
        int* __restrict__ info,            // [4]
        const float* __restrict__ log_denom_p,
        int* __restrict__ i0s,             // [chains] or null: start, advanced
        float* __restrict__ bounds,        // [3, n] scratch
        int* __restrict__ full,            // [chains] or null: full picks
        int n, int i0) {
  constexpr int K = 32 * SPL;
  // Chain c's slice of every argument (all shaped [chains, ...]): the walk
  // runs one block a chain, the bound pass a row of blocks a chain.
  const size_t ch = kBounds ? blockIdx.y : blockIdx.x;
  z += ch * n * K;
  perm += ch * n;
  sizes += ch * K;
  bounds += ch * 3 * n;
  if (i0s != nullptr) i0 = i0s[ch];
  if constexpr (kBounds) {
    bound_pass<SPL>(z, perm, sizes, log_denom_p[ch], bounds, n, i0);
  } else {
    info += ch * 4;
    if (i0 >= n) {  // nothing left of this chain's sweep
      if (threadIdx.x == 0) {
        info[0] = n;
        info[1] = info[2] = -1;
        info[3] = 0;
      }
      return;
    }
    walk<SPL>(z, aux + ch * n, assign + ch * n, perm, sizes, tgt_out + ch * n,
              info, log_denom_p[ch], bounds, full == nullptr ? full : full + ch,
              n, i0);
    if (i0s != nullptr && threadIdx.x == 0) i0s[ch] = info[0];
  }
}

template <int SPL>
void launch(const float* z, const float* aux, const int* assign,
            const int* perm, float* sizes, int* tgt, int* info,
            const float* log_denom, int* i0s, float* bounds, int* full,
            int chains, int n, int i0, cudaStream_t stream) {
  const int blocks = (n + kBoundSpan - 1) / kBoundSpan;
  const dim3 grid(blocks > 0 ? blocks : 1, chains);
  lazy_segment_kernel<SPL, true><<<grid, 32 * kBoundWarps, 0, stream>>>(
      z, aux, assign, perm, sizes, tgt, info, log_denom, i0s, bounds, full, n,
      i0);
  lazy_segment_kernel<SPL, false><<<chains, 32, 0, stream>>>(
      z, aux, assign, perm, sizes, tgt, info, log_denom, i0s, bounds, full, n,
      i0);
}

int launch_any(const float* z, const float* aux, const int* assign,
               const int* perm, float* sizes, int* tgt, int* info,
               const float* log_denom, int* i0s, float* bounds, int* full,
               int chains, int n, int k_pad, int i0, cudaStream_t stream) {
  switch (k_pad) {
    case 32: launch<1>(z, aux, assign, perm, sizes, tgt, info, log_denom, i0s, bounds, full, chains, n, i0, stream); break;
    case 64: launch<2>(z, aux, assign, perm, sizes, tgt, info, log_denom, i0s, bounds, full, chains, n, i0, stream); break;
    case 128: launch<4>(z, aux, assign, perm, sizes, tgt, info, log_denom, i0s, bounds, full, chains, n, i0, stream); break;
    case 256: launch<8>(z, aux, assign, perm, sizes, tgt, info, log_denom, i0s, bounds, full, chains, n, i0, stream); break;
    case 512: launch<16>(z, aux, assign, perm, sizes, tgt, info, log_denom, i0s, bounds, full, chains, n, i0, stream); break;
    case 1024: launch<32>(z, aux, assign, perm, sizes, tgt, info, log_denom, i0s, bounds, full, chains, n, i0, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Both entries return cudaGetLastError() after the launches (0 on success);
// an unsupported k_pad (not 32 * {1, 2, 4, 8, 16, 32}) is
// cudaErrorInvalidValue. `bounds` is scratch of [chains, 3, n] floats;
// `full` [chains] (or null) gains each chain's number of full picks.
extern "C" int bnpc_lazy_segment(const float* z, const float* aux,
                                 const int* assign, const int* perm,
                                 float* sizes, int* tgt, int* info,
                                 const float* log_denom, float* bounds,
                                 int* full, int n, int k_pad, int i0,
                                 cudaStream_t stream) {
  return launch_any(z, aux, assign, perm, sizes, tgt, info, log_denom,
                    nullptr, bounds, full, 1, n, k_pad, i0, stream);
}

// `chains` chains, every argument [chains, ...]; i0s [chains] in and out.
extern "C" int bnpc_lazy_segment_chains(const float* z, const float* aux,
                                        const int* assign, const int* perm,
                                        float* sizes, int* tgt, int* info,
                                        const float* log_denom, int* i0s,
                                        float* bounds, int* full, int chains,
                                        int n, int k_pad,
                                        cudaStream_t stream) {
  if (chains <= 0) return (int)cudaErrorInvalidValue;
  return launch_any(z, aux, assign, perm, sizes, tgt, info, log_denom, i0s,
                    bounds, full, chains, n, k_pad, 0, stream);
}

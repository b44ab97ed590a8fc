// A split-merge launch scan's per-cell work around the restricted scan, in
// one launch (kernel 9; ops/cuda_rg_assign.py).
//
// What it replaces: the torch composition of models/splitmerge.py::
// _rg_scan_assign between the likelihood product and the new launch sides,
// ~100 device operations a call: the Gumbel transform of the drawn
// uniforms and the margins dz, the visit order (a stable radix sort of a
// 64-bit key over all n cells, then a stable partition by the movable mask,
// five gathers), the count log-table dtab, the counts s_count and count1,
// kernel 2, the merge with the launch sides, the scatter back to cell order,
// the side masks the caller builds next, and with trans_prob the replay's
// per-position chosen log-probabilities (two cumsums, a flip, logs, exps, a
// log-sum-exp). It replaces no Pallas kernel of its own: on the TPU this was
// XLA's fusion around bnpc_tpu/ops/pallas_rg.py::rg_scan.
//
// What bounds it: the scan's serial chain through the count (kernel 2's
// bound), then a sort and a handful of barriers; it reads ~30 bytes a cell.
// The design answers the operations' launch cost by doing them in the
// block that runs the chain, one block a chain:
//
//   1. Only the movable cells (S, ``s_mask``) ever reach the scan; the
//      others keep their launch side. So S alone is compacted (warp ballots
//      and a shared counter, in any order) with its 64-bit keys
//      (bits0 << 32) | bits1, and sorted in shared memory by (key, cell) by
//      a bitonic network over s_count padded to a power of two. Unsigned
//      (bits0, bits1) orders as the composition's signed key
//      (bits0 - 2^31) 2^32 + bits1, and its stable sort breaks ties by the
//      lower cell, so this is the composition's visit order of S.
//   2. s_count and count1 are the block's own sums. The table range the
//      scan can reach (kernel 2's [count1 - s_count, count1 + s_count - 1])
//      is computed into the keys' shared memory once they are sorted, with
//      the non-decreasing / NaN check of kernel 2.
//   3. Kernel 2's chain (csrc/rg_chain.cuh) runs as it is; its producers
//      read a position's cell through the sorted index and make its margin
//      dz = (ll2[c, 1] + g1) - (ll2[c, 0] + g0), g = -log(-log(max(u,
//      tiny))), from L2; a table without thresholds takes kernel 2's serial
//      route.
//   4. The new sides in cell order (the final side on S, the launch side
//      elsewhere) and the two f32 side masks (side 0 with anchor i, side 1
//      with anchor j).
//   5. With trans_prob, the replay's chosen log-probability of every visit
//      position, 0 from s_count on: the sides of the other movable cells
//      when the scan reaches a position (final sides before it, launch
//      sides after it) are block scans of 0 / 1 flags, then the logs, exps
//      and the log-sum-exp op by op. The sum stays torch's.
//
// The bits. The random draws stay torch's (the wrapper draws the uniforms,
// then the bits, as the composition does). Every torch elementwise op is
// one correctly rounded operation here (__f*_rn, never contracted), and the
// math library calls are ATen's (logf for torch.log, expf for torch.exp);
// the file is built, as ATen's kernels are, with FMA contraction on
// (ops/_build.py), so that those calls compile as theirs do. The chain is
// adds, compares and integers, the same under either build.
//
// A batch of chains is a grid of one block a chain, each chain with its
// own counts, table and order; the one-chain entry is a grid of one.
// Shared memory: 13 bytes a cell of n padded to a power of two (keys,
// indices, flags), so n is at most kMaxCells.

#include <cuda_runtime.h>
#include <float.h>
#include <limits.h>
#include <math.h>

#include "rg_chain.cuh"

namespace {

using rg_chain::kFull;
using rg_chain::kThreads;
// The largest n: 13 x 16,384 bytes of dynamic shared memory and the
// chain's buffers fit in the 227 KB of a block (ops/cuda_rg_assign.py::
// MAX_CELLS).
constexpr int kMaxCells = 16384;

// One torch elementwise op each, rounded once.
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// torch.maximum: NaN propagates.
__device__ __forceinline__ float maximum(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

// torch.clamp(x, min=lo): NaN passes through.
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}

// TorchDraws.gumbel on its uniform: -log(-log(clamp(u, min=tiny))).
__device__ __forceinline__ float gumbel(float u) {
  return -logf(-logf(clamp_min(u, FLT_MIN)));
}

// dtab[s] as _rg_scan_assign builds it: log(s + 1) - log(clamp(n_move - s
// - 2, min=0)), +inf where side 0 would empty.
__device__ __forceinline__ float dtab_at(int s, float n_move) {
  const float sf = static_cast<float>(s);
  return sub(logf(add(sf, 1.0f)),
             logf(clamp_min(sub(sub(n_move, sf), 2.0f), 0.0f)));
}

struct Args {
  const float* noise;         // [chains, n, 2] uniforms
  const long long* bits;      // [chains, 2, n] uint32 values
  const float* ll2;           // [chains, n, 2] launch log-likelihoods
  const unsigned char* s_mask;  // [chains, n] bool
  const int* rg;              // [chains, n] launch sides
  const int* anchor_i;        // [chains]
  const int* anchor_j;        // [chains]
  const float* n_move;        // [chains]
  const float* dp_alpha;      // [chains]
  int* rg_new;                // [chains, n]
  float* sides;               // [chains, 2, n]
  float* chosen;              // [chains, n], or null without trans_prob
  int n;
  int npad;                   // n padded to a power of two
};

// Ascending (key, index) over [0, spad) in shared memory: a bitonic
// network, every thread of the block taking its share of each pass. The
// pairs of a pass at distance j <= 32 lie in the 64 entries of one warp's
// pairs (thread t takes entry 2t - t % j and its partner), so such a pass
// waits for its own warp only; a pass at a wider distance, and the last
// of each merge, wait for the block.
__device__ __forceinline__ void sort_pairs(unsigned long long* keys,
                                           int* idx, int spad) {
  for (int k = 2; k <= spad; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < spad / 2; t += kThreads) {
        const int a = 2 * t - (t & (j - 1));
        const int b = a + j;
        const unsigned long long ka = keys[a], kb = keys[b];
        const int ia = idx[a], ib = idx[b];
        const bool greater = ka > kb || (ka == kb && ia > ib);
        if (greater == ((a & k) == 0)) {
          keys[a] = kb;
          keys[b] = ka;
          idx[a] = ib;
          idx[b] = ia;
        }
      }
      if (j > 32 || j == 1) {
        __syncthreads();
      } else {
        __syncwarp();
      }
    }
  }
}

// A template on the block size (one value, kThreads) so that the
// profiler's name for it, "rg_assign_kernel<1024>(...)", is one that
// portbench's devtrace.kernel_base parses; a plain name it does not
// (PERF.md, section 7).
template <int kBlock>
__global__ void __launch_bounds__(kBlock, 1) rg_assign_kernel(const Args g) {
  static_assert(kBlock == kThreads, "the chain's block");
  extern __shared__ unsigned long long keys[];  // [npad]
  __shared__ rg_chain::Buffers buf;
  __shared__ int counts[2];         // s_count, count1
  __shared__ int warp_sums[2][32];  // final and launch sides a warp
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned lanes_below = (1u << lane) - 1u;
  const int n = g.n;
  // Chain blockIdx.x's rows.
  const size_t ch = blockIdx.x;
  const float* noise = g.noise + ch * 2 * n;
  const long long* bits = g.bits + ch * 2 * n;
  const float* ll2 = g.ll2 + ch * 2 * n;
  const unsigned char* s_mask = g.s_mask + ch * n;
  const int* rg = g.rg + ch * n;
  const int ai = g.anchor_i[ch], aj = g.anchor_j[ch];
  const float n_move = g.n_move[ch];
  int* rg_new = g.rg_new + ch * n;
  float* side0 = g.sides + ch * 2 * n;
  float* side1 = side0 + n;
  int* idx = reinterpret_cast<int*>(keys + g.npad);         // [npad]
  unsigned char* flags = reinterpret_cast<unsigned char*>(idx + g.npad);
  // flags[i]: bit 0 the final side of visit position i, bit 1 its launch
  // side.

  if (tid < 2) counts[tid] = 0;
  __syncthreads();

  // 1. S compacted with its keys, and its launch sides counted.
  int ones = 0;
  for (int base = 0; base < n; base += kBlock) {
    const int c = base + tid;
    const bool in = c < n && s_mask[c];
    const unsigned m = __ballot_sync(kFull, in);
    int first = 0;
    if (lane == 0 && m) first = atomicAdd(&counts[0], __popc(m));
    first = __shfl_sync(kFull, first, 0);
    if (in) {
      const int slot = first + __popc(m & lanes_below);
      keys[slot] =
          (static_cast<unsigned long long>(static_cast<unsigned>(bits[c]))
           << 32) | static_cast<unsigned>(bits[n + c]);
      idx[slot] = c;
      ones += rg[c];
    }
  }
  ones = __reduce_add_sync(kFull, ones);
  if (lane == 0 && ones) atomicAdd(&counts[1], ones);
  __syncthreads();
  const int s_count = counts[0];
  const int count1 = counts[1];
  int spad = 1;
  while (spad < s_count) spad <<= 1;
  for (int i = s_count + tid; i < spad; i += kBlock) {
    keys[i] = ~0ull;
    idx[i] = INT_MAX;
  }
  __syncthreads();
  sort_pairs(keys, idx, spad);

  // 2. The reachable table range, into the sorted keys' memory.
  float* tab = reinterpret_cast<float*>(keys);
  int lo = 0, len = 0;
  bool serial = false;
  if (s_count > 0) {
    lo = max(count1 - s_count, 0);
    len = min(count1 + s_count - 1, n + 1) - lo + 1;
    bool bad = len <= 0;
    for (int j = tid; j < len; j += kBlock) {
      const float x = dtab_at(lo + j, n_move);
      bad |= !(x <= dtab_at(lo + min(j + 1, len - 1), n_move));
      tab[j] = x;
    }
    serial = __syncthreads_or(bad);
  }

  // 3. The scan, in visit order.
  auto item = [&](int i, float& dz, int& la) {
    const int c = idx[i];
    la = rg[c];
    flags[i] = static_cast<unsigned char>(la << 1);
    const float u0 = noise[2 * c], u1 = noise[2 * c + 1];
    dz = sub(add(ll2[2 * c + 1], gumbel(u1)), add(ll2[2 * c], gumbel(u0)));
  };
  auto put = [&](int i, int side) { flags[i] |= side; };
  if (s_count > 0) {
    if (serial) {
      // No thresholds: kernel 2's recurrence as written, on one thread.
      if (tid == 0) {
        int c1 = count1;
        for (int i = 0; i < s_count; ++i) {
          float dz;
          int la;
          item(i, dz, la);
          const int s1 = c1 - la;
          const int side = add(dz, tab[s1 - lo]) > 0.f ? 1 : 0;
          put(i, side);
          c1 = s1 + side;
        }
      }
      __syncthreads();
    } else {
      rg_chain::scan(buf, tab, lo, len, s_count, count1, item, put);
    }
  }

  // 4. The new sides and the side masks in cell order.
  for (int i = tid; i < s_count; i += kBlock) {
    const int c = idx[i];
    const int side = flags[i] & 1;
    rg_new[c] = side;
    side0[c] = (side == 0 || c == ai) ? 1.f : 0.f;
    side1[c] = (side == 1 || c == aj) ? 1.f : 0.f;
  }
  for (int c = tid; c < n; c += kBlock) {
    if (!s_mask[c]) {
      rg_new[c] = rg[c];
      side0[c] = c == ai ? 1.f : 0.f;
      side1[c] = c == aj ? 1.f : 0.f;
    }
  }

  // 5. The replay's chosen log-probabilities by visit position.
  if (g.chosen == nullptr) return;
  float* chosen = g.chosen + ch * n;
  const float log_denom = logf(add(sub(n_move, 1.0f), g.dp_alpha[ch]));
  int carry_f = 0, carry_l = 0;  // final / launch sides before the round
  for (int base = 0; base < s_count; base += kBlock) {
    const int p = base + tid;
    const bool live = p < s_count;
    const int fl = live ? flags[p] : 0;
    const unsigned fb = __ballot_sync(kFull, fl & 1);
    const unsigned lb = __ballot_sync(kFull, fl >> 1);
    if (lane == 0) {
      warp_sums[0][warp] = __popc(fb);
      warp_sums[1][warp] = __popc(lb);
    }
    __syncthreads();
    const int wf = warp_sums[0][lane], wl = warp_sums[1][lane];
    const int off_f = __reduce_add_sync(kFull, lane < warp ? wf : 0);
    const int off_l = __reduce_add_sync(kFull, lane < warp ? wl : 0);
    if (live) {
      // Final sides before p, launch sides after it.
      const int before = carry_f + off_f + __popc(fb & lanes_below);
      const int after =
          count1 - (carry_l + off_l + __popc(lb & (lanes_below | 1u << lane)));
      const int c = idx[p];
      const float s1 = static_cast<float>(before + after);
      const float n_j = add(s1, 1.0f);
      const float n_i = sub(sub(n_move, s1), 2.0f);
      const float lp0 = sub(add(ll2[2 * c], logf(n_i)), log_denom);
      const float lp1 = sub(add(ll2[2 * c + 1], logf(n_j)), log_denom);
      const float mx = maximum(lp0, lp1);
      const float lse =
          add(mx, logf(add(expf(sub(lp0, mx)), expf(sub(lp1, mx)))));
      chosen[p] = sub((fl & 1) ? lp1 : lp0, lse);
    }
    carry_f += __reduce_add_sync(kFull, wf);
    carry_l += __reduce_add_sync(kFull, wl);
    __syncthreads();
  }
  for (int p = s_count + tid; p < n; p += kBlock) chosen[p] = 0.f;
}

}  // namespace

extern "C" {

// chains chains of n cells: noise, ll2 [chains, n, 2]; bits, sides
// [chains, 2, n]; s_mask (bool), rg, rg_new, chosen [chains, n]; anchor_i,
// anchor_j, n_move, dp_alpha [chains]; chosen may be null. Returns
// cudaGetLastError() after the launch (0 on success).
int bnpc_rg_assign(const float* noise, const long long* bits,
                   const float* ll2, const unsigned char* s_mask,
                   const int* rg, const int* anchor_i, const int* anchor_j,
                   const float* n_move, const float* dp_alpha, int* rg_new,
                   float* sides, float* chosen, int chains, int n,
                   cudaStream_t stream) {
  if (chains <= 0 || n <= 0 || n > kMaxCells)
    return static_cast<int>(cudaErrorInvalidValue);
  int npad = 1;
  while (npad < n) npad <<= 1;
  const int bytes = npad * static_cast<int>(sizeof(unsigned long long)
                                            + sizeof(int) + 1);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        rg_assign_kernel<kThreads>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const Args g{noise, bits, ll2, s_mask, rg, anchor_i, anchor_j, n_move,
               dp_alpha, rg_new, sides, chosen, n, npad};
  rg_assign_kernel<kThreads><<<chains, kThreads, bytes, stream>>>(g);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

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
// cell reads one 1 KB row). Design: ONE warp running the per-cell step of
// gibbs_common.cuh (the sizes row and its cached log weights in registers,
// lane l owning slots l, l+32, ...; best logit and first index as two
// redux.sync reductions). Nothing a cell reads but the sizes depends
// on the cells before it, and perm is known ahead, so every load is taken
// off the chain: perm comes in 32-position chunks, one chunk ahead, with
// assign[perm] and aux[perm] gathered behind it (a lane per position, read
// back by warp shuffle), and a cp.async ring keeps the rows
// z[perm[i + 1 .. i + kRing - 1]] in flight in shared memory, which also
// hides the row's miss where z exceeds L2. The loop is software-pipelined
// by hand: iteration i reads position i + 1's row, aux and removed slot into
// registers, so the step starts on registers and its loads fill the waits
// of the chain. The TPU kernel's 128-lane
// vector-flow batching is not carried over: it only existed because Mosaic
// is slow at crossing from vector to scalar.
//
// A batch of chains runs as a grid of one block a chain (bnpc_lazy_segment_
// chains): block c reads and writes chain c's slice of every argument, and
// takes its start position from i0s[c], which it advances to its i_next; a
// chain with i0s[c] >= n only writes its info (n, -1, -1, 0). The one-chain
// entry (bnpc_lazy_segment) is the same kernel on a grid of one, its start
// position a launch argument.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a --fmad=false (no fast
// math: the logits must use the accurate logf of the plain torch twin,
// bnpc_tpu_torch/ops/cuda_gibbs.py::lazy_segment_ref).

#include "gibbs_common.cuh"

namespace {

using namespace bnpc;

template <int SPL>  // slots per lane; k_pad = 32 * SPL
__global__ void __launch_bounds__(32, 1) lazy_segment_kernel(
    const float* __restrict__ z,       // [n, k_pad]
    const float* __restrict__ aux,     // [n]
    const int* __restrict__ assign,    // [n] pre-sweep assignment
    const int* __restrict__ perm,      // [n] visit order
    float* __restrict__ sizes,         // [k_pad], updated in place
    int* __restrict__ tgt_out,         // [n] target by position
    int* __restrict__ info,            // [4]
    const float* __restrict__ log_denom_p,
    int* __restrict__ i0s,             // [chains] or null: start, advanced
    int n, int i0) {
  constexpr int K = 32 * SPL;
  __shared__ __align__(16) float ring[kRing][K];
  const int lane = threadIdx.x;
  // Chain blockIdx.x's slice of every argument (all shaped [chains, ...]).
  const size_t ch = blockIdx.x;
  z += ch * n * K;
  aux += ch * n;
  assign += ch * n;
  perm += ch * n;
  sizes += ch * K;
  tgt_out += ch * n;
  info += ch * 4;
  log_denom_p += ch;
  if (i0s != nullptr) i0 = i0s[ch];
  if (i0 >= n) {  // nothing left of this chain's sweep
    if (lane == 0) {
      info[0] = n;
      info[1] = info[2] = -1;
      info[3] = 0;
    }
    return;
  }

  Chain<SPL> c;
  chain_init<SPL>(c, sizes, K, *log_denom_p, lane);

  int veto = 0, birth_pos = -1, birth_cell = -1, birth_slot = -1;
  if (i0 < n) {
    int cb = i0 & ~31;
    PermChunk cur, nxt;
    cur.load(perm, assign, aux, cb, n, lane);
    nxt.load(perm, assign, aux, cb + 32, n, lane);

    // Rows of positions i0 .. i0 + kRing - 2 in flight, one commit group
    // per row (a position past n reads cell 0's row, so that no copy sits
    // behind a branch). Iteration i issues the row of position
    // i + kRing - 1 into the ring slot of position i - 1's row, which
    // iteration i - 2 read into registers.
    const unsigned ring_s =
        (unsigned)__cvta_generic_to_shared(&ring[0][lane]);
    constexpr unsigned kRowBytes = K * sizeof(float);
    const float* z_lane = z + lane;
    for (int d = 0; d < kRing - 1; ++d) {
      const int r = i0 + d;
      const int cell_r = pair_at(cur.cell, nxt.cell, r - cb);
      issue_row_full<SPL>(ring_s + (unsigned)r % kRing * kRowBytes,
                          z_lane + (size_t)cell_r * K);
      cp_async_commit();
    }
    chain_remove_first<SPL>(c, __shfl_sync(kFull, cur.o, i0 - cb), lane);

    // What position i needs is in registers before its iteration starts:
    // its row v, its aux a and the slot old_next that position i + 1 leaves
    // (0 past n).
    float a = __shfl_sync(kFull, cur.a, i0 - cb);
    int old_next = pair_at(cur.o, nxt.o, i0 + 1 - cb);
    float v[SPL];
    cp_async_wait<kRing - 2>();  // row i0 has landed (this lane's part)
#pragma unroll
    for (int s = 0; s < SPL; ++s) v[s] = ring[i0 % kRing][s * 32 + lane];

    for (int i = i0;; ++i) {
      if (i - cb == 32) {  // once in 32 positions, before the block below
        cb = i;
        cur = nxt;
        nxt.load(perm, assign, aux, cb + 32, n, lane);
      }
      __syncwarp();
      const int r = i + kRing - 1;
      const int cell_r = pair_at(cur.cell, nxt.cell, r - cb);
      issue_row_full<SPL>(ring_s + (unsigned)r % kRing * kRowBytes,
                          z_lane + (size_t)cell_r * K);
      cp_async_commit();
      const float a_n = pair_at(cur.a, nxt.a, i + 1 - cb);
      const int old_n2 = pair_at(cur.o, nxt.o, i + 2 - cb);
      cp_async_wait<kRing - 2>();  // position i + 1's row has landed
      float v_n[SPL];
#pragma unroll
      for (int s = 0; s < SPL; ++s)
        v_n[s] = ring[(unsigned)(i + 1) % kRing][s * 32 + lane];

      // Remove/add of libs/CRP.py:262-299, the next cell's removal folded
      // in.
      const Pick p = chain_step<SPL>(c, v, a, old_next, i + 1 < n, true,
                                     lane);
      veto |= (p.cand && !p.is_new) ? 1 : 0;
      if (lane == 0) tgt_out[i] = p.t;
      if (p.is_new) {
        birth_pos = i;
        birth_cell = __shfl_sync(kFull, cur.cell, i - cb);
        birth_slot = p.t;
        break;
      }
      if (i + 1 >= n) break;
      a = a_n;
      old_next = old_n2;
#pragma unroll
      for (int s = 0; s < SPL; ++s) v[s] = v_n[s];
    }
    cp_async_wait_all();
  }

  chain_store<SPL>(c, sizes, K, lane);
  if (lane == 0) {
    info[0] = birth_pos >= 0 ? birth_pos + 1 : n;
    info[1] = birth_cell;
    info[2] = birth_slot;
    info[3] = veto;
    if (i0s != nullptr) i0s[ch] = info[0];
  }
}

template <int SPL>
void launch(const float* z, const float* aux, const int* assign,
            const int* perm, float* sizes, int* tgt, int* info,
            const float* log_denom, int* i0s, int chains, int n, int i0,
            cudaStream_t stream) {
  lazy_segment_kernel<SPL><<<chains, 32, 0, stream>>>(
      z, aux, assign, perm, sizes, tgt, info, log_denom, i0s, n, i0);
}

int launch_any(const float* z, const float* aux, const int* assign,
               const int* perm, float* sizes, int* tgt, int* info,
               const float* log_denom, int* i0s, int chains, int n,
               int k_pad, int i0, cudaStream_t stream) {
  switch (k_pad) {
    case 32: launch<1>(z, aux, assign, perm, sizes, tgt, info, log_denom, i0s, chains, n, i0, stream); break;
    case 64: launch<2>(z, aux, assign, perm, sizes, tgt, info, log_denom, i0s, chains, n, i0, stream); break;
    case 128: launch<4>(z, aux, assign, perm, sizes, tgt, info, log_denom, i0s, chains, n, i0, stream); break;
    case 256: launch<8>(z, aux, assign, perm, sizes, tgt, info, log_denom, i0s, chains, n, i0, stream); break;
    case 512: launch<16>(z, aux, assign, perm, sizes, tgt, info, log_denom, i0s, chains, n, i0, stream); break;
    case 1024: launch<32>(z, aux, assign, perm, sizes, tgt, info, log_denom, i0s, chains, n, i0, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Both entries return cudaGetLastError() after the launch (0 on success); an
// unsupported k_pad (not 32 * {1, 2, 4, 8, 16, 32}) is cudaErrorInvalidValue.
extern "C" int bnpc_lazy_segment(const float* z, const float* aux,
                                 const int* assign, const int* perm,
                                 float* sizes, int* tgt, int* info,
                                 const float* log_denom, int n, int k_pad,
                                 int i0, cudaStream_t stream) {
  return launch_any(z, aux, assign, perm, sizes, tgt, info, log_denom,
                    nullptr, 1, n, k_pad, i0, stream);
}

// `chains` chains, every argument [chains, ...]; i0s [chains] in and out.
extern "C" int bnpc_lazy_segment_chains(const float* z, const float* aux,
                                        const int* assign, const int* perm,
                                        float* sizes, int* tgt, int* info,
                                        const float* log_denom, int* i0s,
                                        int chains, int n, int k_pad,
                                        cudaStream_t stream) {
  if (chains <= 0) return (int)cudaErrorInvalidValue;
  return launch_any(z, aux, assign, perm, sizes, tgt, info, log_denom, i0s,
                    chains, n, k_pad, 0, stream);
}

// One birth-bounded segment of the sequential Gibbs sweep, every input in
// VISIT (permutation) order.
//
// Replaces the TPU kernel bnpc_tpu/ops/pallas_gibbs.py::_lazy_stream_kernel
// (pallas_gibbs.py:521, called through pallas_lazy_segment_stream). Per
// visit position i >= i0, with the per-cell step of gibbs_common.cuh on
// row zp[i], old = assignp[i], aux = auxp[i]; tgt_out[i] = the chosen slot;
// the segment ends after the first birth and writes
// info = (i_next, birth_pos, birth_slot, cap_veto), birth_pos being a
// visit position (-1 when the segment ran to n). The caller
// (models/gibbs.py::_segment_impl) patches that slot's zp column and
// relaunches at i_next.
//
// What bounds it: the serial chain through the sizes row (latency per
// cell), and, where Z exceeds the 50 MB L2 (131,072 x 128 x 4 B = 67 MB),
// the HBM latency of each row. What the design does about each:
//   * the chain: one warp, the sizes row and its cached log weights in
//     registers (k_pad <= 1024), best logit and first index as two
//     redux.sync reductions (gibbs_common.cuh::chain_step);
//   * the row latency: in visit order the next rows' addresses are known,
//     so a cp.async ring keeps kRing - 1 rows in flight in shared memory;
//     aux and assign come in 32-position chunks, one chunk ahead, in
//     registers (a lane per position, read back by warp shuffle); and the
//     loop is software-pipelined by hand: iteration i reads position
//     i + 1's row, aux and removed slot into registers, so the step starts
//     on registers and its loads fill the waits of the chain.
// Above 1024 slots the sizes row lives in shared memory (up to 58,112
// slots) and rows are read straight from global memory, with the next row
// prefetched into L2.
//
// The TPU's [G, C, k_pad] chunking, SMEM staging of aux/assign and 128-cell
// vector-flow batches are not carried over: they exist for the TPU's
// memory spaces. The kernel takes flat zp [n, k_pad], auxp [n], assignp [n].
//
// A batch of chains runs as a grid of one block a chain (bnpc_lazy_stream_
// chains), in both layouts: block c reads and writes chain c's slice of
// every argument and takes its start position from i0s[c], which it
// advances to its i_next; a chain with i0s[c] >= n only writes its info
// (n, -1, -1, 0). The one-chain entry (bnpc_lazy_stream) is the same kernel
// on a grid of one, its start position a launch argument.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a --fmad=false (no fast
// math: the logits use the accurate logf of the plain torch twin,
// bnpc_tpu_torch/ops/cuda_stream.py::lazy_segment_stream_ref).

#include "gibbs_common.cuh"

namespace {

using namespace bnpc;

// aux/assign of 32 consecutive positions, lane l holding position base + l.
struct Chunk {
  float a;
  int o;
  __device__ __forceinline__ void load(const float* __restrict__ auxp,
                                       const int* __restrict__ assignp,
                                       int base, int n, int lane) {
    const int p = base + lane;
    a = p < n ? auxp[p] : 0.f;
    o = p < n ? assignp[p] : 0;
  }
};

__device__ __forceinline__ void write_info(int* info, int n, int birth_pos,
                                           int birth_slot, int veto) {
  info[0] = birth_pos >= 0 ? birth_pos + 1 : n;
  info[1] = birth_pos;
  info[2] = birth_slot;
  info[3] = veto;
}

// Chain blockIdx.x's slice of every argument (all shaped [chains, ...]) and
// its start position; a chain whose sweep is done writes its info and
// returns.
#define BNPC_CHAIN_SLICES()                                   \
  const size_t ch = blockIdx.x;                               \
  zp += ch * n * k_pad;                                       \
  auxp += ch * n;                                             \
  assignp += ch * n;                                          \
  sizes += ch * k_pad;                                        \
  tgt_out += ch * n;                                          \
  info += ch * 4;                                             \
  log_denom_p += ch;                                          \
  if (i0s != nullptr) i0 = i0s[ch];                           \
  if (i0 >= n) {                                              \
    if (threadIdx.x == 0) write_info(info, n, -1, -1, 0);     \
    return;                                                   \
  }

template <int SPL>  // register layout; k_pad <= 32 * SPL
__global__ void __launch_bounds__(32, 1) stream_reg_kernel(
    const float* __restrict__ zp,      // [n, k_pad] visit order
    const float* __restrict__ auxp,    // [n]
    const int* __restrict__ assignp,   // [n] pre-sweep assignment
    float* __restrict__ sizes,         // [k_pad], updated in place
    int* __restrict__ tgt_out,         // [n] target by position
    int* __restrict__ info,            // [4]
    const float* __restrict__ log_denom_p,
    int* __restrict__ i0s,             // [chains] or null: start, advanced
    int n, int k_pad, int i0) {
  __shared__ __align__(16) float ring[kRing][32 * SPL];
  const int lane = threadIdx.x;
  BNPC_CHAIN_SLICES()

  Chain<SPL> c;
  chain_init<SPL>(c, sizes, k_pad, *log_denom_p, lane);
  int col[SPL];
  row_cols<SPL>(col, k_pad, lane);

  int veto = 0, birth_pos = -1, birth_slot = -1;
  if (i0 < n) {
    // Rows i0 .. i0 + kRing - 2 in flight, one commit group per row. A row
    // past the end is the last row again (rowp stops), so that no copy sits
    // behind a branch. Iteration i issues row r = i + kRing - 1 into the
    // ring slot of row i - 1, which iteration i - 2 read into registers.
    const unsigned ring_s =
        (unsigned)__cvta_generic_to_shared(&ring[0][lane]);
    constexpr unsigned kRowBytes = 32 * SPL * sizeof(float);
    const float* rowp = zp + (size_t)i0 * k_pad;  // the next row to issue
    int r = i0;
    for (int d = 0; d < kRing - 1; ++d) {
      issue_row<SPL>(ring_s + (unsigned)r % kRing * kRowBytes, rowp, col);
      cp_async_commit();
      rowp += r + 1 < n ? k_pad : 0;
      ++r;
    }
    int cb = i0 & ~31;
    Chunk cur, nxt;
    cur.load(auxp, assignp, cb, n, lane);
    nxt.load(auxp, assignp, cb + 32, n, lane);
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
        nxt.load(auxp, assignp, cb + 32, n, lane);
      }
      __syncwarp();
      issue_row<SPL>(ring_s + (unsigned)r % kRing * kRowBytes, rowp, col);
      cp_async_commit();
      rowp += r + 1 < n ? k_pad : 0;
      ++r;
      const float a_n = pair_at(cur.a, nxt.a, i + 1 - cb);
      const int old_n2 = pair_at(cur.o, nxt.o, i + 2 - cb);
      cp_async_wait<kRing - 2>();  // row i + 1 has landed
      float v_n[SPL];
#pragma unroll
      for (int s = 0; s < SPL; ++s)
        v_n[s] = ring[(unsigned)(i + 1) % kRing][s * 32 + lane];

      const Pick p = chain_step<SPL>(c, v, a, old_next, i + 1 < n, true,
                                     lane);
      veto |= (p.cand && !p.is_new) ? 1 : 0;
      if (lane == 0) tgt_out[i] = p.t;
      if (p.is_new) {
        birth_pos = i;
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

  chain_store<SPL>(c, sizes, k_pad, lane);
  if (lane == 0) {
    write_info(info, n, birth_pos, birth_slot, veto);
    if (i0s != nullptr) i0s[ch] = info[0];
  }
}

// Shared-memory layout for k_pad > 1024.
__global__ void __launch_bounds__(32, 1) stream_smem_kernel(
    const float* __restrict__ zp, const float* __restrict__ auxp,
    const int* __restrict__ assignp, float* __restrict__ sizes,
    int* __restrict__ tgt_out, int* __restrict__ info,
    const float* __restrict__ log_denom_p, int* __restrict__ i0s, int n,
    int k_pad, int i0) {
  extern __shared__ float sz[];  // [k_pad]
  const int lane = threadIdx.x;
  BNPC_CHAIN_SLICES()
  const float log_denom = *log_denom_p;
  for (int s = lane; s < k_pad; s += 32) sz[s] = sizes[s];
  __syncwarp();

  int cb = i0 & ~31;
  Chunk cur, nxt;
  cur.load(auxp, assignp, cb, n, lane);
  nxt.load(auxp, assignp, cb + 32, n, lane);

  int veto = 0, birth_pos = -1, birth_slot = -1;
  for (int i = i0; i < n; ++i) {
    if (i + 1 < n) {  // the next row into L2, one 128 B line per lane
      const float* nr = zp + (size_t)(i + 1) * k_pad;
      for (int s = lane * 32; s < k_pad; s += 32 * 32)
        asm volatile("prefetch.global.L2 [%0];\n" ::"l"(nr + s));
    }
    if (i - cb == 32) {
      cb = i;
      cur = nxt;
      nxt.load(auxp, assignp, cb + 32, n, lane);
    }
    const float a = __shfl_sync(kFull, cur.a, i - cb);
    const int old = __shfl_sync(kFull, cur.o, i - cb);
    const Pick p = pick_smem(sz, zp + (size_t)i * k_pad, k_pad, old, a,
                             log_denom, lane);
    veto |= (p.cand && !p.is_new) ? 1 : 0;
    if (lane == 0) tgt_out[i] = p.t;
    if (p.is_new) {
      birth_pos = i;
      birth_slot = p.t;
      break;
    }
  }

  for (int s = lane; s < k_pad; s += 32) sizes[s] = sz[s];
  if (lane == 0) {
    write_info(info, n, birth_pos, birth_slot, veto);
    if (i0s != nullptr) i0s[ch] = info[0];
  }
}

template <int SPL>
void launch_reg(const float* zp, const float* auxp, const int* assignp,
                float* sizes, int* tgt, int* info, const float* log_denom,
                int* i0s, int chains, int n, int k_pad, int i0,
                cudaStream_t stream) {
  stream_reg_kernel<SPL><<<chains, 32, 0, stream>>>(
      zp, auxp, assignp, sizes, tgt, info, log_denom, i0s, n, k_pad, i0);
}

int launch_any(const float* zp, const float* auxp, const int* assignp,
               float* sizes, int* tgt, int* info, const float* log_denom,
               int* i0s, int chains, int n, int k_pad, int i0,
               cudaStream_t stream) {
  if (k_pad <= 0 || k_pad % 32 != 0 || k_pad > bnpc::kMaxSmemSlots)
    return (int)cudaErrorInvalidValue;
  const int spl = k_pad / 32;
  if (spl <= 1) {
    launch_reg<1>(zp, auxp, assignp, sizes, tgt, info, log_denom, i0s, chains, n, k_pad, i0, stream);
  } else if (spl <= 2) {
    launch_reg<2>(zp, auxp, assignp, sizes, tgt, info, log_denom, i0s, chains, n, k_pad, i0, stream);
  } else if (spl <= 4) {
    launch_reg<4>(zp, auxp, assignp, sizes, tgt, info, log_denom, i0s, chains, n, k_pad, i0, stream);
  } else if (spl <= 8) {
    launch_reg<8>(zp, auxp, assignp, sizes, tgt, info, log_denom, i0s, chains, n, k_pad, i0, stream);
  } else if (spl <= 16) {
    launch_reg<16>(zp, auxp, assignp, sizes, tgt, info, log_denom, i0s, chains, n, k_pad, i0, stream);
  } else if (spl <= 32) {
    launch_reg<32>(zp, auxp, assignp, sizes, tgt, info, log_denom, i0s, chains, n, k_pad, i0, stream);
  } else {
    const int bytes = k_pad * (int)sizeof(float);
    const cudaError_t err = bnpc::allow_smem(stream_smem_kernel, bytes);
    if (err != cudaSuccess) return (int)err;
    stream_smem_kernel<<<chains, 32, bytes, stream>>>(
        zp, auxp, assignp, sizes, tgt, info, log_denom, i0s, n, k_pad, i0);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Both entries return cudaGetLastError() after the launch (0 on success);
// k_pad must be a positive multiple of 32 of at most 58,112
// (cudaErrorInvalidValue).
extern "C" int bnpc_lazy_stream(const float* zp, const float* auxp,
                                const int* assignp, float* sizes, int* tgt,
                                int* info, const float* log_denom, int n,
                                int k_pad, int i0, cudaStream_t stream) {
  return launch_any(zp, auxp, assignp, sizes, tgt, info, log_denom, nullptr,
                    1, n, k_pad, i0, stream);
}

// `chains` chains, every argument [chains, ...]; i0s [chains] in and out.
extern "C" int bnpc_lazy_stream_chains(const float* zp, const float* auxp,
                                       const int* assignp, float* sizes,
                                       int* tgt, int* info,
                                       const float* log_denom, int* i0s,
                                       int chains, int n, int k_pad,
                                       cudaStream_t stream) {
  if (chains <= 0) return (int)cudaErrorInvalidValue;
  return launch_any(zp, auxp, assignp, sizes, tgt, info, log_denom, i0s,
                    chains, n, k_pad, 0, stream);
}

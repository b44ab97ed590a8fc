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
// (models/gibbs.py::_stream_impl) patches that slot's zp column and
// relaunches at i_next.
//
// What bounds it: the serial chain through the sizes row (latency per
// cell), and, where Z exceeds the 50 MB L2 (131,072 x 128 x 4 B = 67 MB),
// the HBM latency of each row. What the design does about each:
//   * the chain: one warp, the sizes row in registers (k_pad <= 1024),
//     best/free/idx as warp-shuffle reductions, as in lazy_segment.cu;
//   * the row latency: in visit order the next rows' addresses are known,
//     so a cp.async ring keeps kRing - 1 rows in flight in shared memory;
//     aux and assign come in 32-position chunks, one chunk ahead, in
//     registers (a lane per position, read back by warp shuffle).
// Above 1024 slots the sizes row lives in shared memory (up to 58,112
// slots) and rows are read straight from global memory, with the next row
// prefetched into L2.
//
// The TPU's [G, C, k_pad] chunking, SMEM staging of aux/assign and 128-cell
// vector-flow batches are not carried over: they exist for the TPU's
// memory spaces. The kernel takes flat zp [n, k_pad], auxp [n], assignp [n].
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a --fmad=false (no fast
// math: the logits use the accurate logf of the plain torch twin,
// bnpc_tpu_torch/ops/cuda_stream.py::lazy_segment_stream_ref).

#include "gibbs_common.cuh"

namespace {

using namespace bnpc;

constexpr int kRing = 8;  // rows in the shared-memory ring

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
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

// This lane's part of one row into the ring, unpredicated (row_cols).
template <int SPL>
__device__ __forceinline__ void issue_row(float* dst,
                                          const float* __restrict__ src,
                                          const int (&col)[SPL], int lane) {
#pragma unroll
  for (int s = 0; s < SPL; ++s) cp_async4(dst + s * 32 + lane, src + col[s]);
}

template <int SPL>  // register layout; k_pad <= 32 * SPL
__global__ void __launch_bounds__(32, 1) stream_reg_kernel(
    const float* __restrict__ zp,      // [n, k_pad] visit order
    const float* __restrict__ auxp,    // [n]
    const int* __restrict__ assignp,   // [n] pre-sweep assignment
    float* __restrict__ sizes,         // [k_pad], updated in place
    int* __restrict__ tgt_out,         // [n] target by position
    int* __restrict__ info,            // [4]
    const float* __restrict__ log_denom_p, int n, int k_pad, int i0) {
  __shared__ __align__(16) float ring[kRing][32 * SPL];
  const int lane = threadIdx.x;
  const float log_denom = *log_denom_p;

  float sz[SPL];
  int col[SPL];
  row_cols<SPL>(col, k_pad, lane);
#pragma unroll
  for (int s = 0; s < SPL; ++s) {
    const int slot = s * 32 + lane;
    sz[s] = slot < k_pad ? sizes[slot] : -1.f;
  }

  // Rows i0 .. i0 + kRing - 2 in flight, one commit group per row (empty
  // past n). Iteration i issues row i + kRing - 1 into the ring slot that
  // iteration i - 1 consumed: that iteration's branch on its pick has
  // resolved, so its shared-memory reads are complete.
  for (int d = 0; d < kRing - 1; ++d) {
    const int r = i0 + d;
    if (r < n) issue_row<SPL>(ring[r % kRing], zp + (size_t)r * k_pad, col,
                              lane);
    cp_async_commit();
  }
  int cb = i0 & ~31;
  Chunk cur, nxt;
  cur.load(auxp, assignp, cb, n, lane);
  nxt.load(auxp, assignp, cb + 32, n, lane);

  int veto = 0, birth_pos = -1, birth_slot = -1;
  for (int i = i0; i < n; ++i) {
    const int r = i + kRing - 1;
    if (r < n) issue_row<SPL>(ring[r % kRing], zp + (size_t)r * k_pad, col,
                              lane);
    cp_async_commit();
    if (i - cb == 32) {
      cb = i;
      cur = nxt;
      nxt.load(auxp, assignp, cb + 32, n, lane);
    }
    const float a = __shfl_sync(kFull, cur.a, i - cb);
    const int old = __shfl_sync(kFull, cur.o, i - cb);

    cp_async_wait<kRing - 1>();  // row i has landed (this lane's part)
    const float* row = ring[i % kRing];
    float v[SPL];
#pragma unroll
    for (int s = 0; s < SPL; ++s) v[s] = row[s * 32 + lane];
    const Pick p = pick_reg<SPL>(sz, v, old, a, log_denom, lane);
    veto |= (p.cand && !p.is_new) ? 1 : 0;
    if (lane == 0) tgt_out[i] = p.t;
    if (p.is_new) {
      birth_pos = i;
      birth_slot = p.t;
      break;
    }
  }
  cp_async_wait_all();

#pragma unroll
  for (int s = 0; s < SPL; ++s) {
    const int slot = s * 32 + lane;
    if (slot < k_pad) sizes[slot] = sz[s];
  }
  if (lane == 0) write_info(info, n, birth_pos, birth_slot, veto);
}

// Shared-memory layout for k_pad > 1024.
__global__ void __launch_bounds__(32, 1) stream_smem_kernel(
    const float* __restrict__ zp, const float* __restrict__ auxp,
    const int* __restrict__ assignp, float* __restrict__ sizes,
    int* __restrict__ tgt_out, int* __restrict__ info,
    const float* __restrict__ log_denom_p, int n, int k_pad, int i0) {
  extern __shared__ float sz[];  // [k_pad]
  const int lane = threadIdx.x;
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
  if (lane == 0) write_info(info, n, birth_pos, birth_slot, veto);
}

template <int SPL>
void launch_reg(const float* zp, const float* auxp, const int* assignp,
                float* sizes, int* tgt, int* info, const float* log_denom,
                int n, int k_pad, int i0, cudaStream_t stream) {
  stream_reg_kernel<SPL><<<1, 32, 0, stream>>>(zp, auxp, assignp, sizes, tgt,
                                               info, log_denom, n, k_pad, i0);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success); k_pad must be
// a positive multiple of 32 of at most 58,112 (cudaErrorInvalidValue).
extern "C" int bnpc_lazy_stream(const float* zp, const float* auxp,
                                const int* assignp, float* sizes, int* tgt,
                                int* info, const float* log_denom, int n,
                                int k_pad, int i0, cudaStream_t stream) {
  if (k_pad <= 0 || k_pad % 32 != 0 || k_pad > bnpc::kMaxSmemSlots)
    return (int)cudaErrorInvalidValue;
  const int spl = k_pad / 32;
  if (spl <= 1) {
    launch_reg<1>(zp, auxp, assignp, sizes, tgt, info, log_denom, n, k_pad, i0, stream);
  } else if (spl <= 2) {
    launch_reg<2>(zp, auxp, assignp, sizes, tgt, info, log_denom, n, k_pad, i0, stream);
  } else if (spl <= 4) {
    launch_reg<4>(zp, auxp, assignp, sizes, tgt, info, log_denom, n, k_pad, i0, stream);
  } else if (spl <= 8) {
    launch_reg<8>(zp, auxp, assignp, sizes, tgt, info, log_denom, n, k_pad, i0, stream);
  } else if (spl <= 16) {
    launch_reg<16>(zp, auxp, assignp, sizes, tgt, info, log_denom, n, k_pad, i0, stream);
  } else if (spl <= 32) {
    launch_reg<32>(zp, auxp, assignp, sizes, tgt, info, log_denom, n, k_pad, i0, stream);
  } else {
    const int bytes = k_pad * (int)sizeof(float);
    const cudaError_t err = bnpc::allow_smem(stream_smem_kernel, bytes);
    if (err != cudaSuccess) return (int)err;
    stream_smem_kernel<<<1, 32, bytes, stream>>>(zp, auxp, assignp, sizes,
                                                 tgt, info, log_denom, n,
                                                 k_pad, i0);
  }
  return (int)cudaGetLastError();
}

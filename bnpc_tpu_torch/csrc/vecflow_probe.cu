// Timing probe: the lazy Gibbs segment's per-cell chain with the targets
// kept in registers and the birth checked once per 128-cell batch.
//
// Replaces the TPU kernel benchmarks/vecflow_probe.py::_vecflow_kernel
// (called through vecflow). It runs the per-cell step of lazy_segment.cu
// (gibbs_common.cuh::chain_step) over positions 0, 1, ... in batches of 128:
//
//   * a position i >= n in the last batch is inert: it reads
//     cell = perm[n - 1], removes nothing, cannot give birth, and its target
//     is the first argmax of the logits;
//   * a birth does not stop its batch: the batch's later cells see the
//     newborn slot at size 1 (against an unpatched z column), and the sweep
//     ends after that batch;
//   * tgt_out [nb, 128] f32 receives the targets of every batch run (later
//     rows are not written), info[0] the first birth's position, or n.
//
// What bounds it: the serial chain through `sizes` (two dependent warp
// reductions a cell), as in lazy_segment.cu; not bandwidth. The design
// carries the TPU probe's ideas to this card: lane l holds the targets of
// the batch's
// positions 4l .. 4l+3 in registers and writes them with one 16-byte store
// per batch (one coalesced 512-byte store), not one store per cell; the
// batch's perm, assign and aux entries come in one batch ahead, four a lane,
// and reach the chain by warp shuffle; the next cell's z row is loaded one
// cell ahead; the birth is tracked as a warp-uniform float (the TPU
// kernel's 1e9 sentinel) and tested once per batch, with no break inside it.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a --fmad=false (no fast
// math: the logits use the accurate logf of the plain torch twin,
// bnpc_tpu_torch/probes/vecflow_probe.py::vecflow_ref).

#include <cuda_runtime.h>
#include <math_constants.h>

#include "gibbs_common.cuh"

namespace {

using bnpc::kFull;

constexpr int kBatch = 128;                 // positions per batch
constexpr int kPerLane = kBatch / 32;       // targets a lane holds
constexpr float kNoBirth = 1e9f;

// One batch's inputs, lane l holding positions base + 4l + r, r = 0..3,
// each clamped to n - 1 (the TPU kernel's read of the tail positions).
struct Batch {
  int cell[kPerLane];
  int old[kPerLane];
  float a[kPerLane];
};

__device__ __forceinline__ void load_batch(Batch& bt, const int* perm,
                                           const int* assign,
                                           const float* aux, int base, int n,
                                           int lane) {
#pragma unroll
  for (int r = 0; r < kPerLane; ++r)
    bt.cell[r] = perm[min(base + kPerLane * lane + r, n - 1)];
#pragma unroll
  for (int r = 0; r < kPerLane; ++r) {
    bt.old[r] = assign[bt.cell[r]];
    bt.a[r] = aux[bt.cell[r]];
  }
}

// First slot holding the best logit, sizes unchanged (an inert position).
template <int SPL>
__device__ __forceinline__ int first_argmax(const bnpc::Chain<SPL>& c,
                                            const float (&v)[SPL], int lane) {
  float best;
  int idx;
  bnpc::best_and_first<SPL>(c, v, lane, best, idx);
  return idx;
}

template <int SPL>  // slots per lane; k_pad = 32 * SPL
__global__ void __launch_bounds__(32, 1) vecflow_kernel(
    const float* __restrict__ z,       // [n8, k_pad]
    const float* __restrict__ aux,     // [n]
    const int* __restrict__ assign,    // [n] pre-sweep assignment
    const int* __restrict__ perm,      // [n] visit order
    float* __restrict__ sizes,         // [k_pad], updated in place
    float* __restrict__ tgt_out,       // [nb, 128] target by position
    int* __restrict__ info,            // [1]
    const float* __restrict__ log_denom_p, int n) {
  constexpr int K = 32 * SPL;
  const int lane = threadIdx.x;
  const int nb = (n + kBatch - 1) / kBatch;

  bnpc::Chain<SPL> c;
  bnpc::chain_init<SPL>(c, sizes, K, *log_denom_p, lane);

  Batch cur, nxt;
  load_batch(cur, perm, assign, aux, 0, n, lane);
  bnpc::chain_remove_first<SPL>(c, __shfl_sync(kFull, cur.old[0], 0), lane);
  float v[SPL];
  {
    const int cell0 = __shfl_sync(kFull, cur.cell[0], 0);
#pragma unroll
    for (int s = 0; s < SPL; ++s) v[s] = z[(size_t)cell0 * K + s * 32 + lane];
  }

  float bpos = kNoBirth;  // first birth position; warp-uniform
  for (int b = 0; b < nb && bpos >= kNoBirth; ++b) {
    const int base = b * kBatch;
    load_batch(nxt, perm, assign, aux, base + kBatch, n, lane);
    float w[kPerLane];
    for (int q = 0; q < 32; ++q) {
#pragma unroll
      for (int r = 0; r < kPerLane; ++r) {
        const int i = base + kPerLane * q + r;
        // The next position's row: independent of the carried sizes.
        const int nr = (r + 1) % kPerLane;
        const int nq = r + 1 < kPerLane ? q : q + 1;
        const int cell_n = nq < 32 ? __shfl_sync(kFull, cur.cell[nr], nq)
                                   : __shfl_sync(kFull, nxt.cell[0], 0);
        float v_n[SPL];
#pragma unroll
        for (int s = 0; s < SPL; ++s)
          v_n[s] = z[(size_t)cell_n * K + s * 32 + lane];

        // The next position's slot: the step removes it, and runs on past
        // a birth, but not past the end of a birth's batch, where the sweep
        // ends.
        const bool last = q == 31 && r == kPerLane - 1;
        const int old_n = nq < 32 ? __shfl_sync(kFull, cur.old[nr], nq)
                                  : __shfl_sync(kFull, nxt.old[0], 0);
        const float a = __shfl_sync(kFull, cur.a[r], q);
        int t;
        bool is_new = false;
        if (i < n) {
          const bool has_next = i + 1 < n && !(last && bpos < kNoBirth);
          const bnpc::Pick p = bnpc::chain_step<SPL>(c, v, a, old_n, has_next,
                                                     last, lane);
          t = p.t;
          is_new = p.is_new;
        } else {
          t = first_argmax<SPL>(c, v, lane);
        }
        if (lane == q) w[r] = (float)t;
        bpos = fminf(bpos, is_new ? (float)i : kNoBirth);
#pragma unroll
        for (int s = 0; s < SPL; ++s) v[s] = v_n[s];
      }
    }
    reinterpret_cast<float4*>(tgt_out + base)[lane] =
        make_float4(w[0], w[1], w[2], w[3]);
    cur = nxt;
  }

  bnpc::chain_store<SPL>(c, sizes, K, lane);
  if (lane == 0) info[0] = bpos >= kNoBirth ? n : (int)bpos;
}

template <int SPL>
void launch(const float* z, const float* aux, const int* assign,
            const int* perm, float* sizes, float* tgt, int* info,
            const float* log_denom, int n, cudaStream_t stream) {
  vecflow_kernel<SPL><<<1, 32, 0, stream>>>(z, aux, assign, perm, sizes, tgt,
                                            info, log_denom, n);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success); an
// unsupported k_pad (not 32 * {1, 2, 4, 8, 16, 32}) is cudaErrorInvalidValue.
// tgt must be 16-byte aligned (the wrapper checks).
extern "C" int bnpc_vecflow(const float* z, const float* aux,
                            const int* assign, const int* perm, float* sizes,
                            float* tgt, int* info, const float* log_denom,
                            int n, int k_pad, cudaStream_t stream) {
  switch (k_pad) {
    case 32: launch<1>(z, aux, assign, perm, sizes, tgt, info, log_denom, n, stream); break;
    case 64: launch<2>(z, aux, assign, perm, sizes, tgt, info, log_denom, n, stream); break;
    case 128: launch<4>(z, aux, assign, perm, sizes, tgt, info, log_denom, n, stream); break;
    case 256: launch<8>(z, aux, assign, perm, sizes, tgt, info, log_denom, n, stream); break;
    case 512: launch<16>(z, aux, assign, perm, sizes, tgt, info, log_denom, n, stream); break;
    case 1024: launch<32>(z, aux, assign, perm, sizes, tgt, info, log_denom, n, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

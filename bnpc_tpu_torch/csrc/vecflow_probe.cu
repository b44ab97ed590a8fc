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
// reductions a cell), as in lazy_segment.cu; not bandwidth. It runs
// kernel 1's loop, so that it differs from lazy_segment.cu only in the TPU
// probe's two ideas: a batch's 128 targets stay in registers (lane l holds
// positions l, l + 32, l + 64, l + 96) and leave as four coalesced 128-byte
// stores a batch, not one store a cell; and the birth is tracked
// warp-uniformly and tested once a batch, to decide whether the next batch
// runs. Kernel 1's loop: perm, assign[perm] and aux[perm] in 32-position
// chunks a chunk ahead; a cp.async ring of kRing rows; the next position's
// row, aux and removed slot in registers one iteration ahead; a loop body
// of one basic block. The last batch, when n % 128 != 0, runs the same loop
// to position n - 1; its inert positions share one target (the sizes do not
// change there), the first argmax of perm[n - 1]'s row read once, so no
// inert test sits in the loop.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a --fmad=false (no fast
// math: the logits use the accurate logf of the plain torch twin,
// bnpc_tpu_torch/probes/vecflow_probe.py::vecflow_ref).

#include "gibbs_common.cuh"

namespace {

using namespace bnpc;

constexpr int kBatch = 128;            // positions per batch
constexpr int kChunks = kBatch / 32;   // 32-position chunks a batch

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
  __shared__ __align__(16) float ring[kRing][K];
  const int lane = threadIdx.x;
  const int nb = (n + kBatch - 1) / kBatch;

  Chain<SPL> c;
  chain_init<SPL>(c, sizes, K, *log_denom_p, lane);

  int cb = 0;  // first position of the chunk `cur`
  PermChunk cur, nxt;
  cur.load(perm, assign, aux, 0, n, lane);
  nxt.load(perm, assign, aux, 32, n, lane);

  // Rows of positions 0 .. kRing - 2 in flight, one commit group per row (a
  // position past n reads cell 0's row); position i issues position
  // i + kRing - 1's row into the ring slot that position i - 1's row left.
  const unsigned ring_s = (unsigned)__cvta_generic_to_shared(&ring[0][lane]);
  constexpr unsigned kRowBytes = K * sizeof(float);
  const float* z_lane = z + lane;
  for (int d = 0; d < kRing - 1; ++d) {
    issue_row_full<SPL>(ring_s + d * kRowBytes,
                        z_lane + (size_t)pair_at(cur.cell, nxt.cell, d) * K);
    cp_async_commit();
  }
  chain_remove_first<SPL>(c, __shfl_sync(kFull, cur.o, 0), lane);

  // What position i needs is in registers before its iteration starts: its
  // row v, its aux a and the slot old_next that position i + 1 leaves.
  float a = __shfl_sync(kFull, cur.a, 0);
  int old_next = pair_at(cur.o, nxt.o, 1);
  float v[SPL];
  cp_async_wait<kRing - 2>();  // row 0 has landed (this lane's part)
#pragma unroll
  for (int s = 0; s < SPL; ++s) v[s] = ring[0][s * 32 + lane];

  int bpos = n;  // first birth's position; warp-uniform
  for (int b = 0; b < nb && bpos == n; ++b) {
    float w[kChunks];  // w[q] on lane l: position b * 128 + 32 q + l
#pragma unroll
    for (int q = 0; q < kChunks; ++q) {
      const int end = min(32, n - cb);  // 32 but in the ragged last batch
      for (int j = 0; j < end; ++j) {
        __syncwarp();
        const int i = cb + j;
        const int r = i + kRing - 1;
        issue_row_full<SPL>(
            ring_s + (unsigned)r % kRing * kRowBytes,
            z_lane + (size_t)pair_at(cur.cell, nxt.cell, j + kRing - 1) * K);
        cp_async_commit();
        const float a_n = pair_at(cur.a, nxt.a, j + 1);
        const int old_n2 = pair_at(cur.o, nxt.o, j + 2);
        cp_async_wait<kRing - 2>();  // position i + 1's row has landed
        float v_n[SPL];
#pragma unroll
        for (int s = 0; s < SPL; ++s)
          v_n[s] = ring[(unsigned)(i + 1) % kRing][s * 32 + lane];

        // The step removes the next position's cell, and runs on past a
        // birth, but not past the end of a birth's batch, where the sweep
        // ends.
        const bool last = q == kChunks - 1 && j == 31;
        const Pick p = chain_step<SPL>(c, v, a, old_next,
                                       i + 1 < n && !(last && bpos < n),
                                       last, lane);
        if (lane == j) w[q] = (float)p.t;
        bpos = min(bpos, p.is_new ? i : n);
        a = a_n;
        old_next = old_n2;
#pragma unroll
        for (int s = 0; s < SPL; ++s) v[s] = v_n[s];
      }
      cb += 32;
      cur = nxt;
      nxt.load(perm, assign, aux, cb + 32, n, lane);
    }
    const int base = b * kBatch;
    if (base + kBatch > n) {
      // The ragged batch's inert positions: the first argmax of perm[n -
      // 1]'s row on the sizes as they stand, one target for all of them.
      const float* row = z_lane + (size_t)perm[n - 1] * K;
      float vi[SPL];
#pragma unroll
      for (int s = 0; s < SPL; ++s) vi[s] = row[s * 32];
      float best;
      int idx;
      best_and_first<SPL>(c, vi, lane, best, idx);
#pragma unroll
      for (int q = 0; q < kChunks; ++q)
        if (base + 32 * q + lane >= n) w[q] = (float)idx;
    }
#pragma unroll
    for (int q = 0; q < kChunks; ++q) tgt_out[base + 32 * q + lane] = w[q];
  }
  cp_async_wait_all();

  chain_store<SPL>(c, sizes, K, lane);
  if (lane == 0) info[0] = bpos;
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

// The whole sequential Gibbs sweep in one launch, births patched in-kernel.
//
// Replaces the TPU kernel bnpc_tpu/ops/pallas_gibbs.py::_sweep_kernel
// (pallas_gibbs.py:78, called through pallas_sweep). Cells are visited in
// absolute order through perm; each takes the per-cell step of
// gibbs_common.cuh on row z[cell], old = assign[cell], aux = aux[cell].
// On a birth of cell c into slot f the kernel itself writes
//
//   z[j, f] = lf[j, c] + gum[j, f]   for every cell j
//   params[f, :] = fresh[c, :]
//
// (pallas_gibbs.py:170-196) and carries on: no exit, no relaunch, no host
// read. assign_out[cell] receives the chosen slot. z is the caller's
// working copy and is patched in place.
//
// What bounds it: the serial chain per cell through the sizes row (one warp,
// latency bound, and a warp issues in order, so every instruction that does
// not fit under the chain's waits adds to a cell), plus O(n) strided loads
// and stores per birth (a column of lf and gum in, a column of z out).
// What the register layout (k_pad <= 1024) does about it is the loop of
// lazy_segment.cu: nothing a cell reads but the sizes depends on the cells
// before it, and perm is known ahead, so
//   * perm comes in 32-position chunks one chunk ahead, with assign[perm]
//     and aux[perm] gathered behind it (gibbs_common.cuh::PermChunk, read
//     back by warp shuffle): no index load is on the chain or behind a
//     branch;
//   * a cp.async ring keeps the rows z[perm[i + 1 .. i + kRing - 1]] in
//     flight in shared memory, one commit group a row, issued unpredicated
//     (a position past n copies cell 0's row). A row may be narrower than
//     32 * SPL; then the copies read the clamped columns of row_cols. Where
//     it is exactly 32 * SPL wide (FULL) the copies' offsets are
//     compile-time constants, which saves two address instructions a slot
//     a cell;
//   * the inner loop's body is one basic block: position i + 1's row, aux
//     and removed slot are in registers before position i's step,
//     __syncwarp() sits at its top, and the only branches are the two cold
//     exits after the step (a birth, the end). A birth handled inside the
//     block (patch, then repair the rows already copied) made every cell
//     slower, births or none; so the loop LEAVES at a birth, as the
//     segment kernels do, and an outer loop patches and starts it again at
//     the next position, the chain's state staying in registers;
//   * assign_out[cell] is a scattered store off the chain; the cell index
//     comes from the chunk by shuffle.
// The step itself is gibbs_common.cuh::chain_step (lane l owns slots l,
// l+32, ..., with cached log weights). What it caches (w, wp) follows the
// sizes only, never z, so a birth's patch of a z column leaves it valid.
//
// The birth against rows already in flight. When a cell is born into slot f
// at position i, up to kRing - 1 rows in the ring and the row of position
// i + 1 in registers were copied before the patch, or race it. None of them
// is used: the warp waits for ALL outstanding copies (a late one must not
// land on a ring slot that is about to be filled again), patch_birth writes
// the column and ends in __syncwarp(), which orders its stores among the
// warp, and the rows of positions i + 1 .. i + kRing - 1 are copied anew
// from z. Those copies are cp.async.ca, through this SM's L1, and the lanes
// that wrote the column are not the lanes that copy it: what makes them
// see the patch is that an SM's L1 never holds a line stale against the
// SM's own stores (the same property that lets a block's threads exchange
// data through global memory across a barrier with plain loads), and lines
// of z were brought into L1 before the patch by the earlier copies, so the
// crafted cases (births one and three positions apart) test exactly that.
// z is written by the kernel, so it is neither __restrict__ const nor read
// through the read-only path.
//
// Above 1024 slots the sizes row lives in shared memory (up to 58,112 slots)
// and rows are read straight from z after the patch's __syncwarp(), so no
// copied row can be stale. First-index tie-breaks as jnp.argmax in
// interpret mode.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a --fmad=false.

#include "gibbs_common.cuh"

namespace {

using namespace bnpc;

// The birth of `cell` into slot f: z[:, f] = lf[:, cell] + gum[:, f] and
// params[f] = fresh[cell]. Ends in __syncwarp(), which orders the stores
// among the warp. More rows a lane in flight (4 to 32) made it no faster.
__device__ __forceinline__ void patch_birth(
    float* z, const float* __restrict__ gum, const float* __restrict__ lf,
    const float* __restrict__ fresh, float* __restrict__ params, int n,
    int k_pad, int m, int cell, int f, int lane) {
  for (int j = lane; j < n; j += 32)
    z[(size_t)j * k_pad + f] = lf[(size_t)j * n + cell]
        + gum[(size_t)j * k_pad + f];
  for (int e = lane; e < m; e += 32)
    params[(size_t)f * m + e] = fresh[(size_t)cell * m + e];
  __syncwarp();
}

// Register layout; k_pad <= 32 * SPL, and FULL says k_pad == 32 * SPL.
template <int SPL, bool FULL>
__global__ void __launch_bounds__(32, 1) sweep_reg_kernel(
    float* z,                          // [n, k_pad] working copy, patched
    const float* __restrict__ gum,     // [n, k_pad]
    const float* __restrict__ lf,      // [n, n] lf[j, c] = ll(j | fresh[c])
    const float* __restrict__ fresh,   // [n, m] newborn row per cell
    const float* __restrict__ aux,     // [n]
    const int* __restrict__ assign,    // [n] pre-sweep assignment
    const int* __restrict__ perm,      // [n] visit order
    float* __restrict__ sizes,         // [k_pad], updated in place
    float* __restrict__ params,        // [*, m], updated in place
    int* __restrict__ assign_out,      // [n] cell order
    const float* __restrict__ log_denom_p, int n, int k_pad, int m) {
  __shared__ __align__(16) float ring[kRing][32 * SPL];
  const int lane = threadIdx.x;

  Chain<SPL> c;
  chain_init<SPL>(c, sizes, k_pad, *log_denom_p, lane);
  int col[SPL];
  row_cols<SPL>(col, k_pad, lane);
  const unsigned ring_s = (unsigned)__cvta_generic_to_shared(&ring[0][lane]);
  constexpr unsigned kRowBytes = 32 * SPL * sizeof(float);
  // This lane's part of position r's row (of cell cell_r) into the ring.
  auto issue = [&](int r, int cell_r) {
    const unsigned dst = ring_s + (unsigned)r % kRing * kRowBytes;
    if constexpr (FULL) {
      issue_row_full<SPL>(dst, z + lane + (size_t)cell_r * (32 * SPL));
    } else {
      issue_row<SPL>(dst, z + (size_t)cell_r * k_pad, col);
    }
    cp_async_commit();
  };

  if (n > 0) {
    int cb = 0;
    PermChunk cur, nxt;
    cur.load(perm, assign, aux, 0, n, lane);
    nxt.load(perm, assign, aux, 32, n, lane);
    chain_remove_first<SPL>(c, __shfl_sync(kFull, cur.o, 0), lane);

    // One turn for the start and one for every birth: the loop below runs
    // from position i to the next birth or to n.
    for (int i = 0;;) {
      // Rows of positions i .. i + kRing - 2 in flight, one commit group
      // per row. Iteration i issues the row of position i + kRing - 1 into
      // the ring slot of position i - 1's row, which iteration i - 2 read
      // into registers.
      for (int r = i; r < i + kRing - 1; ++r)
        issue(r, pair_at(cur.cell, nxt.cell, r - cb));

      // What position i needs is in registers before its iteration starts:
      // its row v, its aux a and the slot old_next that position i + 1
      // leaves (0 past n).
      float a = pair_at(cur.a, nxt.a, i - cb);
      int old_next = pair_at(cur.o, nxt.o, i + 1 - cb);
      float v[SPL];
      cp_async_wait<kRing - 2>();  // row i has landed (this lane's part)
#pragma unroll
      for (int s = 0; s < SPL; ++s)
        v[s] = ring[(unsigned)i % kRing][s * 32 + lane];

      int born_cell = -1, born_slot = 0;
      for (;; ++i) {
        if (i - cb == 32) {  // once in 32 positions, before the block below
          cb = i;
          cur = nxt;
          nxt.load(perm, assign, aux, cb + 32, n, lane);
        }
        __syncwarp();
        const int r = i + kRing - 1;
        issue(r, pair_at(cur.cell, nxt.cell, r - cb));
        const int cell = __shfl_sync(kFull, cur.cell, i - cb);
        const float a_n = pair_at(cur.a, nxt.a, i + 1 - cb);
        const int old_n2 = pair_at(cur.o, nxt.o, i + 2 - cb);
        cp_async_wait<kRing - 2>();  // position i + 1's row has landed
        float v_n[SPL];
#pragma unroll
        for (int s = 0; s < SPL; ++s)
          v_n[s] = ring[(unsigned)(i + 1) % kRing][s * 32 + lane];

        // The sweep runs on past a birth: the step always removes the next
        // cell.
        const Pick p = chain_step<SPL>(c, v, a, old_next, i + 1 < n, false,
                                       lane);
        if (lane == 0) assign_out[cell] = p.t;
        if (p.is_new) {
          born_cell = cell;
          born_slot = p.t;
          break;
        }
        if (i + 1 >= n) break;
        a = a_n;
        old_next = old_n2;
#pragma unroll
        for (int s = 0; s < SPL; ++s) v[s] = v_n[s];
      }
      // No copy may land after this point: the ring is filled again below.
      cp_async_wait_all();
      if (born_cell < 0) break;
      patch_birth(z, gum, lf, fresh, params, n, k_pad, m, born_cell,
                  born_slot, lane);
      if (++i >= n) break;
    }
  }

  chain_store<SPL>(c, sizes, k_pad, lane);
}

// Shared-memory layout for k_pad > 1024: rows are read straight from z
// after the patch's __syncwarp(), so no copied row can be stale.
__global__ void __launch_bounds__(32, 1) sweep_smem_kernel(
    float* z, const float* __restrict__ gum, const float* __restrict__ lf,
    const float* __restrict__ fresh, const float* __restrict__ aux,
    const int* __restrict__ assign, const int* __restrict__ perm,
    float* __restrict__ sizes, float* __restrict__ params,
    int* __restrict__ assign_out, const float* __restrict__ log_denom_p,
    int n, int k_pad, int m) {
  extern __shared__ float sz[];  // [k_pad]
  const int lane = threadIdx.x;
  const float log_denom = *log_denom_p;
  for (int s = lane; s < k_pad; s += 32) sz[s] = sizes[s];
  __syncwarp();

  for (int i = 0; i < n; ++i) {
    const int cell = perm[i];
    const Pick p = pick_smem(sz, z + (size_t)cell * k_pad, k_pad,
                             assign[cell], aux[cell], log_denom, lane);
    if (p.is_new)
      patch_birth(z, gum, lf, fresh, params, n, k_pad, m, cell, p.t, lane);
    if (lane == 0) assign_out[cell] = p.t;
  }

  for (int s = lane; s < k_pad; s += 32) sizes[s] = sz[s];
}

template <int SPL>
void launch_reg(float* z, const float* gum, const float* lf,
                const float* fresh, const float* aux, const int* assign,
                const int* perm, float* sizes, float* params, int* out,
                const float* log_denom, int n, int k_pad, int m,
                cudaStream_t stream) {
  if (k_pad == 32 * SPL) {
    sweep_reg_kernel<SPL, true><<<1, 32, 0, stream>>>(
        z, gum, lf, fresh, aux, assign, perm, sizes, params, out, log_denom,
        n, k_pad, m);
  } else {
    sweep_reg_kernel<SPL, false><<<1, 32, 0, stream>>>(
        z, gum, lf, fresh, aux, assign, perm, sizes, params, out, log_denom,
        n, k_pad, m);
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success); k_pad must be
// a positive multiple of 32 of at most 58,112 (cudaErrorInvalidValue).
extern "C" int bnpc_eager_sweep(float* z, const float* gum, const float* lf,
                                const float* fresh, const float* aux,
                                const int* assign, const int* perm,
                                float* sizes, float* params, int* out,
                                const float* log_denom, int n, int k_pad,
                                int m, cudaStream_t stream) {
  if (k_pad <= 0 || k_pad % 32 != 0 || k_pad > bnpc::kMaxSmemSlots)
    return (int)cudaErrorInvalidValue;
  const int spl = k_pad / 32;
  if (spl <= 1) {
    launch_reg<1>(z, gum, lf, fresh, aux, assign, perm, sizes, params, out, log_denom, n, k_pad, m, stream);
  } else if (spl <= 2) {
    launch_reg<2>(z, gum, lf, fresh, aux, assign, perm, sizes, params, out, log_denom, n, k_pad, m, stream);
  } else if (spl <= 4) {
    launch_reg<4>(z, gum, lf, fresh, aux, assign, perm, sizes, params, out, log_denom, n, k_pad, m, stream);
  } else if (spl <= 8) {
    launch_reg<8>(z, gum, lf, fresh, aux, assign, perm, sizes, params, out, log_denom, n, k_pad, m, stream);
  } else if (spl <= 16) {
    launch_reg<16>(z, gum, lf, fresh, aux, assign, perm, sizes, params, out, log_denom, n, k_pad, m, stream);
  } else if (spl <= 32) {
    launch_reg<32>(z, gum, lf, fresh, aux, assign, perm, sizes, params, out, log_denom, n, k_pad, m, stream);
  } else {
    const int bytes = k_pad * (int)sizeof(float);
    const cudaError_t err = bnpc::allow_smem(sweep_smem_kernel, bytes);
    if (err != cudaSuccess) return (int)err;
    sweep_smem_kernel<<<1, 32, bytes, stream>>>(z, gum, lf, fresh, aux,
                                                assign, perm, sizes, params,
                                                out, log_denom, n, k_pad, m);
  }
  return (int)cudaGetLastError();
}

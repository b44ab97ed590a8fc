// The split-merge restricted 2-way Gibbs scan, in visit order.
//
// Replaces the TPU kernel bnpc_tpu/ops/pallas_rg.py::_rg_kernel (called
// through rg_scan). Reference: _rg_scan_assign, libs/CRP.py:609-632. With
// hoisted Gumbel noise each cell's 2-way draw is one comparison:
//
//   for i < s_count:  s1 = count1 - lau[i]
//                     side = (dz[i] + dtab[s1] > 0)
//                     out[i] = side; count1 = s1 + side
//
// where dtab[s1] = log(s1+1) - log(n_move-s1-2) (+inf where side 0 would
// empty). Positions >= s_count are not written; the caller keeps their
// launch sides. The plain twin (ops/cuda_rg.py::rg_scan_ref) is the
// definition, for ANY dtab.
//
// What bounds it: a serial chain through count1, i.e. latency per cell. Read
// as written, the chain holds a table load whose address is the carried
// count, a float add and a compare. But everything except count1 is known
// before the scan starts, so the load and the float add come off the chain:
//
//   * Thresholds. Where dtab is non-decreasing and NaN-free, the predicate
//     P_i(s) = (dz[i] + dtab[s] > 0), evaluated in float32 exactly as the
//     twin evaluates it, is false below some t_i and true from it on (float
//     addition is monotone in each argument; a NaN or infinite dz[i] makes
//     P_i constant or a step, never a bump). t_i is a binary search over the
//     table that any thread can do for any position, ahead of the chain.
//   * An integer chain. The recurrence is
//     count1' = count1 - lau[i] + (count1 - lau[i] >= t_i). The launch
//     sides are known ahead too, so their running sum L_i (over the
//     positions of the chunk before i) comes off the chain as well: with
//     y = count1 + L_i and U_i = t_i + lau[i] + L_i the link is
//     y' = y + (y >= U_i), on registers, one integer an entry; count1 is y
//     less the chunk's launch sides at its end. The link is taken as
//     y + ((U_i - 1 - y) >>> 31), a subtract and the add of its sign bit:
//     a compare with a predicated add takes more than twice as long
//     (probes/chain_probe.py, cmp_pred_add against scan_link).
//   * One block. Thread 0 runs the chain over chunk k while the threads of
//     the other warps make the entries of chunk k + 1 (dz and lau read
//     coalesced, a binary search each, the launch sides' prefix by ballot
//     and one barrier among themselves; handed over in shared memory) and
//     write the sides of chunk k - 1 (recomputed from the y the chain
//     stored before each cell), coalesced. One __syncthreads() a chunk.
//   * The table. With launch sides in {0, 1} the scan can only reach s1 in
//     [count1 - s_count, count1 + s_count - 1]; that range of dtab is
//     staged in shared memory where it fits (always at a few thousand
//     cells), else it is read through L1/L2.
//   * Any dtab. While staging, the block checks that the reachable range is
//     non-decreasing and NaN-free (one __syncthreads_or). If it is not, no
//     threshold exists and thread 0 runs the recurrence as written: the
//     same kernel, the same result as the twin, at the old speed.
// s_count and count1 are read from device memory, so the host never
// synchronizes to launch the scan. The TPU's 2C+128 SMEM window staging is
// not carried over: it only existed because of the TPU's scalar-memory size.
//
// The chain itself (thresholds, the integer chain, the producers and
// writers) is csrc/rg_chain.cuh, which kernel 9 (csrc/rg_assign.cu, a
// launch scan's per-cell work around this chain) runs too.
//
// A batch of chains runs as a grid of one block a chain (bnpc_rg_scan_
// chains): block c scans chain c's rows of dz, lau, dtab and out with its own
// s_count[c] and count1[c], and stages its own table in its own shared
// memory. The one-chain entry (bnpc_rg_scan) is the same kernel on a grid of
// one.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a --fmad=false.

#include <cuda_runtime.h>

#include "rg_chain.cuh"

namespace {

using rg_chain::kThreads;
// Table entries staged in shared memory at most (160 KB).
constexpr int kTabSmem = 40960;

__global__ void __launch_bounds__(kThreads, 1) rg_scan_kernel(
    const float* __restrict__ dz,     // [n] decision margins, visit order
    const int* __restrict__ lau,      // [n] launch sides, visit order
    const float* __restrict__ dtab,   // [n + 2] count log-table
    const int* __restrict__ s_count_p, const int* __restrict__ count1_p,
    int* __restrict__ out, int n, int tab_cap) {
  extern __shared__ float tab_s[];  // [tab_cap]
  __shared__ rg_chain::Buffers buf;
  const int tid = threadIdx.x;
  // Chain blockIdx.x's rows (every argument [chains, ...]).
  const size_t ch = blockIdx.x;
  dz += ch * n;
  lau += ch * n;
  dtab += ch * (n + 2);
  s_count_p += ch;
  count1_p += ch;
  out += ch * n;
  const int s_count = min(*s_count_p, n);
  int c1 = *count1_p;
  if (s_count <= 0) return;

  // The table range the scan can reach, inside the table.
  const int lo = max(c1 - s_count, 0);
  const int hi = min(c1 + s_count - 1, n + 1);
  const int len = hi - lo + 1;
  const bool staged = len <= tab_cap;

  // Stage and check: non-decreasing and NaN-free over [lo, hi].
  bool bad = len <= 0;
  for (int j = tid; j < len; j += kThreads) {
    const float x = dtab[lo + j];
    const float y = dtab[lo + min(j + 1, len - 1)];
    bad |= !(x <= y);
    if (staged) tab_s[j] = x;
  }
  if (__syncthreads_or(bad)) {
    // No thresholds: the recurrence as written, on one thread.
    if (tid == 0) {
      for (int i = 0; i < s_count; ++i) {
        const int s1 = c1 - lau[i];
        const int side = (dz[i] + dtab[s1] > 0.f) ? 1 : 0;
        out[i] = side;
        c1 = s1 + side;
      }
    }
    return;
  }

  rg_chain::scan(
      buf, staged ? tab_s : dtab + lo, lo, len, s_count, c1,
      [&](int i, float& x, int& la) {
        x = dz[i];
        la = lau[i];
      },
      [&](int i, int side) { out[i] = side; });
}

}  // namespace

namespace {

int launch(const float* dz, const int* lau, const float* dtab,
           const int* s_count, const int* count1, int* out, int chains,
           int n, cudaStream_t stream) {
  if (chains <= 0) return (int)cudaErrorInvalidValue;
  const int tab_cap = n + 2 < kTabSmem ? n + 2 : kTabSmem;
  const int bytes = tab_cap * (int)sizeof(float);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        rg_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
  }
  rg_scan_kernel<<<chains, kThreads, bytes, stream>>>(
      dz, lau, dtab, s_count, count1, out, n, tab_cap);
  return (int)cudaGetLastError();
}

}  // namespace

// Both entries return cudaGetLastError() after the launch (0 on success).
extern "C" int bnpc_rg_scan(const float* dz, const int* lau,
                            const float* dtab, const int* s_count,
                            const int* count1, int* out, int n,
                            cudaStream_t stream) {
  return launch(dz, lau, dtab, s_count, count1, out, 1, n, stream);
}

// `chains` chains: dz, lau, out [chains, n]; dtab [chains, n + 2];
// s_count, count1 [chains].
extern "C" int bnpc_rg_scan_chains(const float* dz, const int* lau,
                                   const float* dtab, const int* s_count,
                                   const int* count1, int* out, int chains,
                                   int n, cudaStream_t stream) {
  return launch(dz, lau, dtab, s_count, count1, out, chains, n, stream);
}

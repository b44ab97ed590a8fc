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
// launch sides.
//
// What bounds it: a serial chain of dependent scalar steps, i.e. latency
// per cell. Design: one thread. s_count and count1 are read from device
// memory, so the host never synchronizes to launch the scan. dz and lau are
// sequential streams; dtab is read straight from global memory because its
// index moves by at most 1 per cell, so the reads stay in L1. The TPU's
// 2C+128 SMEM window staging is not carried over: it only existed because
// of the TPU's scalar-memory size.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a --fmad=false.

#include <cuda_runtime.h>

namespace {

__global__ void __launch_bounds__(1, 1) rg_scan_kernel(
    const float* __restrict__ dz,     // [n] decision margins, visit order
    const int* __restrict__ lau,      // [n] launch sides, visit order
    const float* __restrict__ dtab,   // [n + 2] count log-table
    const int* __restrict__ s_count_p, const int* __restrict__ count1_p,
    int* __restrict__ out, int n) {
  const int s_count = min(*s_count_p, n);
  int c1 = *count1_p;
  for (int i = 0; i < s_count; ++i) {
    const int s1 = c1 - lau[i];
    const int side = (dz[i] + dtab[s1] > 0.f) ? 1 : 0;
    out[i] = side;
    c1 = s1 + side;
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int bnpc_rg_scan(const float* dz, const int* lau,
                            const float* dtab, const int* s_count,
                            const int* count1, int* out, int n,
                            cudaStream_t stream) {
  rg_scan_kernel<<<1, 1, 0, stream>>>(dz, lau, dtab, s_count, count1, out, n);
  return (int)cudaGetLastError();
}

// Latency of the dependent instructions the serial Gibbs chain is made of.
//
// A measurement, not a port of a TPU kernel: one warp times long chains in
// which every instruction needs the result of the one before, with clock64()
// around each, and reports cycles per link. The per-cell step of the Gibbs
// kernels (gibbs_common.cuh) is such a chain, so cells x (cycles of the
// shortest chain the algorithm allows) / clock is the least time a sweep can
// take on this card, however the kernel is written
// (bnpc_tpu_torch/probes/chain_probe.py turns the cycles into that bound).
//
// Chains (kLinks links each; out[2k] = cycles, out[2k+1] = the chain's last
// value, kept so that no chain is optimized away):
//   0 shfl           x = shfl_xor(x, 16)
//   1 shfl_fmax      x = fmaxf(x, shfl_xor(x, 16))   one round of warp_max
//   2 redux_max      u = redux.sync.max.u32(u)
//   3 ballot_test    u = ballot((u >> lane) & 1)
//   4 logf_fadd      x = logf(x) + c                 the accurate logf
//   5 smem_load_use  i = smem[i]
//   6 cmp_select     x = x > thr ? a : b
//   7 fadd           x = x + c
//   8 xor_add        u = (u ^ a) + b                 two integer ALU links
//   9 icmp_select    i = i >= t ? a : b              integer compare + select
//  10 cmp_pred_add   i = i + (i >= t)                as the compiler builds
//                                                    it: a compare and a
//                                                    predicated move
//  11 scan_link      i = i + ((t - 1 - i) >>> 31)    the same function as the
//                                                    restricted scan takes
//                                                    it (rg_scan.cu): a
//                                                    subtract, and the sign
//                                                    bit added
// out[2 * kChains] = cycles of the whole kernel, out[2 * kChains + 1] = its
// nanoseconds by %globaltimer: their ratio is the SM clock during the run.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a --fmad=false, no fast
// math (the same logf as the Gibbs kernels).

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kChains = 12;
constexpr int kUnroll = 16;

__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Times `iters` x kUnroll links of LINK, a statement that advances the
// chain's variable, and stores cycles and the final value (as bits).
#define BNPC_CHAIN(k, var, LINK)                              \
  {                                                           \
    const long long t0 = clock64();                           \
    for (int it = 0; it < iters; ++it) {                      \
      _Pragma("unroll") for (int r = 0; r < kUnroll; ++r) {   \
        LINK;                                                 \
      }                                                       \
    }                                                         \
    sink[lane] = (long long)(var);                            \
    const long long t1 = clock64();                           \
    if (lane == 0) {                                          \
      out[2 * (k)] = t1 - t0;                                 \
      out[2 * (k) + 1] = sink[0];                             \
    }                                                         \
  }

__global__ void __launch_bounds__(32, 1) chain_probe_kernel(
    const float* __restrict__ seed,  // [4]: 12.5, 1.0, 3.0, 5.0 (runtime
                                     // values the compiler cannot fold)
    long long* __restrict__ out,     // [2 * kChains + 2]
    int iters) {
  __shared__ int next[64];
  __shared__ volatile long long sink[32];
  const int lane = threadIdx.x;
  next[lane] = (lane + 1) % 64;
  next[lane + 32] = (lane + 33) % 64;
  __syncwarp();
  const float c_log = seed[0], one = seed[1], thr = seed[2], hi = seed[3];
  const unsigned ua = (unsigned)seed[2], ub = (unsigned)seed[3];

  const long long ns0 = global_ns();
  const long long cy0 = clock64();

  float x = c_log + (float)lane;
  BNPC_CHAIN(0, x, x = __shfl_xor_sync(kFull, x, 16))
  x = c_log + (float)lane;
  BNPC_CHAIN(1, x, x = fmaxf(x, __shfl_xor_sync(kFull, x, 16)))
  unsigned u = ua + lane;
  BNPC_CHAIN(2, u, u = __reduce_max_sync(kFull, u))
  u = 0x55555555u + ua;
  BNPC_CHAIN(3, u, u = __ballot_sync(kFull, (u >> lane) & 1u))
  x = c_log;
  BNPC_CHAIN(4, x, x = logf(x) + c_log)
  int i = lane;
  BNPC_CHAIN(5, i, i = next[i])
  x = one;
  BNPC_CHAIN(6, x, x = x > thr ? one : hi)
  x = one;
  BNPC_CHAIN(7, x, x = x + one)
  u = ua + lane;
  BNPC_CHAIN(8, u, u = (u ^ ua) + ub)
  const int it = (int)seed[2], ia = (int)seed[1], ib = (int)seed[3];
  i = ia;
  BNPC_CHAIN(9, i, i = i >= it ? ia : ib)
  i = ia;
  BNPC_CHAIN(10, i, i += i >= it + r ? 1 : 0)
  i = ia;
  BNPC_CHAIN(11, i, i += (unsigned)(it + r - 1 - i) >> 31)

  const long long cy1 = clock64();
  const long long ns1 = global_ns();
  if (lane == 0) {
    out[2 * kChains] = cy1 - cy0;
    out[2 * kChains + 1] = ns1 - ns0;
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success). Each chain
// runs iters * 16 links; out holds 2 * 12 + 2 int64 values.
extern "C" int bnpc_chain_probe(const float* seed, long long* out, int iters,
                                cudaStream_t stream) {
  chain_probe_kernel<<<1, 32, 0, stream>>>(seed, out, iters);
  return (int)cudaGetLastError();
}

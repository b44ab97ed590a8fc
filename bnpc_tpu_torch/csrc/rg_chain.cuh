// The restricted scan's chain (kernel 2, csrc/rg_scan.cu), shared by the
// scan's own entry and by a split-merge launch scan's fused kernel (kernel
// 9, csrc/rg_assign.cu). rg_scan.cu's header says what the design is: per
// position a threshold found by binary search over the staged table, an
// integer chain y' = y + (y >= U_i) on thread 0, producer warps making the
// entries of the next chunk and writing the sides of the previous one.
//
// The two kernels differ only in where a position's margin and launch side
// come from and where its side goes, so ``scan`` takes both as functors:
// ``item(i, dz, lau)`` fills position i's margin and launch side (called once
// for every position below s_count, by a producer thread, at least one
// barrier before that position's ``put``), and ``put(i, side)`` takes its
// side (once for every position below s_count, by a producer thread).
//
// Everything here is an add, a compare or integer arithmetic: nothing that
// FMA contraction could change, so the scan computes the same bits in a
// file built with --fmad=false (rg_scan.cu) and with --fmad=true
// (rg_assign.cu).

#pragma once

#include <cuda_runtime.h>

namespace rg_chain {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 1024;
// Positions a chunk: one for each thread outside the chain's warp.
constexpr int kChunk = kThreads - 32;
// The chain's loop handles positions in groups of kGroup, two groups a
// turn; a chunk's tail is padded to a whole turn with neutral entries.
constexpr int kGroup = 16;
static_assert(kChunk % (2 * kGroup) == 0, "a chunk is whole turns");
// An entry is U - 1. That of a position the scan does not reach: below
// 2^30, so that the link's subtract cannot overflow, and never passed.
constexpr int kNever = 0x3fffffff;

// The chain's shared memory (a __shared__ object of the calling kernel).
struct Buffers {
  __align__(16) int entries[2][kChunk + kGroup];  // U - 1
  __align__(16) int seen[2][kChunk];              // y before each cell
  int warp_sides[2][32];  // launch sides a producer warp
  int chunk_sides[2];     // launch sides a chunk
};

__device__ __forceinline__ void load_group(int (&e)[kGroup], const int* src) {
#pragma unroll
  for (int r = 0; r < kGroup; ++r) e[r] = src[r];
}

// kGroup links of the chain, y' = y + (y > e) with e = U - 1. The y each
// cell met is kept for the writers, who recompute its side from it.
__device__ __forceinline__ void chain_group(const int (&e)[kGroup], int* seen,
                                            int& y) {
#pragma unroll
  for (int r = 0; r < kGroup; ++r) {
    seen[r] = y;
    y += (int)((unsigned)(e[r] - y) >> 31);
  }
}

// The producers' own barrier (the chain's warp does not take part).
__device__ __forceinline__ void producers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kChunk) : "memory");
}

// First s in [0, len) with dz + tab[s] > 0, else len: the count of leading
// false values of a predicate that is false, then true.
__device__ __forceinline__ int threshold(const float* tab, int len,
                                         int top_step, float x) {
  int pos = 0;
  for (int step = top_step; step > 0; step >>= 1) {
    const int idx = pos + step - 1;
    if (idx < len && !(x + tab[idx] > 0.f)) pos += step;
  }
  return pos;
}

// The scan of positions [0, s_count) from count c1 on a table whose
// entries [lo, lo + len) are tab[0, len), non-decreasing and NaN-free
// (the caller checked). Every thread of the block (kThreads) calls it;
// it ends with a __syncthreads().
template <class Item, class Put>
__device__ __forceinline__ void scan(Buffers& b, const float* tab, int lo,
                                     int len, int s_count, int c1, Item item,
                                     Put put) {
  const int tid = threadIdx.x;
  int top_step = 1;
  while (top_step * 2 <= len) top_step *= 2;
  const int chunks = (s_count + kChunk - 1) / kChunk;
  const int j = tid - 32;  // this thread's position within every chunk
  const int lane = tid & 31, warp = tid >> 5;

  // Entries of chunk k into entries[k & 1] (every producer thread calls
  // it); positions from s_count on get an entry that changes nothing.
  auto produce = [&](int k) {
    const int i = k * kChunk + j;
    const bool live = i < s_count;
    float dz = 0.f;
    int la = 0;
    if (live) item(i, dz, la);
    const unsigned ones = __ballot_sync(kFull, la != 0);
    if (lane == 0) b.warp_sides[k & 1][warp - 1] = __popc(ones);
    const int t = live ? threshold(tab, len, top_step, dz) : 0;
    producers_sync();
    const int earlier = lane < warp - 1 ? b.warp_sides[k & 1][lane] : 0;
    const int before = __reduce_add_sync(kFull, earlier)
        + __popc(ones & ((1u << lane) - 1u));
    b.entries[k & 1][j] = live ? lo + t + la + before - 1 : kNever;
    if (j == kChunk - 1) b.chunk_sides[k & 1] = before + la;
  };

  if (j >= 0) produce(0);
  __syncthreads();

  for (int k = 0; k <= chunks; ++k) {
    if (tid == 0) {
      if (k < chunks) {
        const int cnt = min(kChunk, s_count - k * kChunk);
        const int* src = b.entries[k & 1];
        int* dst = b.seen[k & 1];
        int y = c1;
        int ea[kGroup], eb[kGroup];
        load_group(ea, src);
        for (int g = 0; g < cnt; g += 2 * kGroup) {
          load_group(eb, src + g + kGroup);
          chain_group(ea, dst + g, y);
          load_group(ea, src + g + 2 * kGroup);  // the pad past a full chunk
          chain_group(eb, dst + g + kGroup, y);
        }
        c1 = y - b.chunk_sides[k & 1];
      }
    } else if (j >= 0) {
      if (k >= 1) {
        const int i = (k - 1) * kChunk + j;
        if (i < s_count)
          put(i, b.seen[(k - 1) & 1][j] > b.entries[(k - 1) & 1][j] ? 1 : 0);
      }
      if (k + 1 < chunks) produce(k + 1);
    }
    __syncthreads();
  }
}

}  // namespace rg_chain

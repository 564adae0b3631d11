// Device code shared by the binning passes of both rasterizers
// (rasterize_multi.cu, rasterize_single.cu): the warp-aggregated slot in a
// segment and the per-batch-item scan of the segment counts. CUDA only; the
// host builds count and scan in plain loops.

#pragma once

#include <cuda_runtime.h>

namespace sr {
namespace {

constexpr int kScanThreads = 1024;

// The calling thread's slot in segment `seg`, counted in counts[seg]: one
// atomicAdd per run of equal segments among the warp's active threads
// (neighbouring triangles of a mesh mostly share a home tile), so the
// order within a segment varies from run to run.
__device__ __forceinline__ int segment_slot(int* counts, int seg) {
  const unsigned mask = __activemask();
  const int lane = threadIdx.x & 31;
  const unsigned peers = __match_any_sync(mask, seg);
  const int leader = __ffs(peers) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(&counts[seg], __popc(peers));
  base = __shfl_sync(peers, base, leader);
  return base + __popc(peers & ((1u << lane) - 1u));
}

// One block of kScanThreads per batch item: starts[b] = exclusive scan of
// counts[b] (K segments), then the total.
__global__ void __launch_bounds__(kScanThreads)
bin_scan(const int* __restrict__ counts, int* __restrict__ starts, int K) {
  constexpr unsigned kFull = 0xffffffffu;
  __shared__ int s_warp[kScanThreads / 32];
  const int* c = counts + (size_t)blockIdx.x * K;
  int* s = starts + (size_t)blockIdx.x * (K + 1);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = (K + kScanThreads - 1) / kScanThreads;
  const int lo = min(tid * per, K), hi = min(lo + per, K);
  int sum = 0;
  for (int i = lo; i < hi; ++i) sum += c[i];
  int incl = sum;
  for (int d = 1; d < 32; d <<= 1) {
    const int up = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += up;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = s_warp[lane];
    for (int d = 1; d < 32; d <<= 1) {
      const int up = __shfl_up_sync(kFull, w, d);
      if (lane >= d) w += up;
    }
    s_warp[lane] = w;
  }
  __syncthreads();
  int off = (warp > 0 ? s_warp[warp - 1] : 0) + incl - sum;
  for (int i = lo; i < hi; ++i) {
    s[i] = off;
    off += c[i];
  }
  if (tid == 0) s[K] = s_warp[kScanThreads / 32 - 1];
}

}  // namespace
}  // namespace sr

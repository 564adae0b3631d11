// Single-level tile rasterizer for Hopper (sm_90a).
//
// Replaces stylerenderer_tpu/ops/rasterize_pallas.py::_make_kernel (the
// Pallas TPU kernel launched at rasterize_pallas.py:514 inside
// rasterize_winners_pallas). For every pixel of an h x w image it finds the
// covering triangle of max depth, the lowest id on ties, -1 on background:
// the winner map of ops/rasterize.py::rasterize_winners, bit for bit.
//
// Input: the binned triangles of ops/rasterize_single.py::build_bins,
// sorted by key tier*ntiles + home tile: dat [B, nf, 9] f32 (corner px, py,
// z), ids [B, nf] i32, starts [B, 5*ntiles + 1] i32. Output: wins [B, h, w]
// i32. The tile grid is ceil(w/tile) x ceil(h/tile); pixels of an edge tile
// that fall outside the image are not evaluated.
//
// Design: one block per (tile, batch item), one thread per pixel of the
// tile, the z-buffer in registers. The block streams the tile's worklist
// (sr::single_tile_segments: one sorted segment per home row of each span
// tier, then the global XL segment) through shared memory, kChunk triangles
// at a time: each of the first kChunk threads loads one triangle's row and
// computes its setup once (sr::level_setup at level 0); then every thread
// tests every candidate of the chunk against its pixel. Ties go to the
// lowest id (sr::beats), so nothing is atomic and the order of the
// candidates does not matter.
//
// What bounds it on this card: the bytes it must move are the rows of the
// valid triangles (the prefix [0, starts[5*ntiles]) of the sorted arrays;
// back-facing and off-screen triangles are sorted past it and never read),
// 40 bytes each, read once, plus the winner map written once: about ten
// microseconds at B=16, 256 px, on the 100k-triangle face mesh at 3.35 TB/s
// (chip_smoke.py prints the figure for its inputs). The useful work,
// candidates whose clamped bbox holds the pixel, takes less at the card's
// f32 rate. This simple design instead spends its time on the bbox
// rejections (every pixel of a tile tests every candidate of the tile's
// worklist), on the 24 segment loops per tile and on two barriers per
// chunk; small tiles keep the worklists short, and staging with cp.async
// and per-warp culling are the next steps.
//
// Bit-exactness: the candidate math is rasterize_multi.cuh's, the oracle's
// expression sequence; build with --fmad=false and without fast math
// (ops/_build.py), see that header's note.

#include <cuda_runtime.h>

#include "rasterize_single.cuh"

namespace {

constexpr int kChunk = 64;
constexpr int kMaxTile = 32;  // tile * tile threads, at most 1024

__global__ void __launch_bounds__(kMaxTile * kMaxTile)
rasterize_single_kernel(const float* __restrict__ dat, const int* __restrict__ ids,
                        const int* __restrict__ starts, int* __restrict__ wins, int nf,
                        int h, int w, int tile, int perspective, float eps) {
  __shared__ float s_raw[kChunk][sr::kRaw];
  __shared__ int s_id[kChunk];
  __shared__ sr::LevelSetup s_set[kChunk];

  const int ntx = (w + tile - 1) / tile, nty = (h + tile - 1) / tile;
  const int ntiles = ntx * nty;
  const int tx = blockIdx.x % ntx, ty = blockIdx.x / ntx;
  const int b = blockIdx.y;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int X = tx * tile + tid % tile, Y = ty * tile + tid / tile;
  const bool live = X < w && Y < h;
  const float fx = (float)X, fy = (float)Y;
  const float wf = (float)w, hf = (float)h;

  int lo[sr::kSingleSegments], hi[sr::kSingleSegments];
  sr::single_tile_segments(starts + (size_t)b * (sr::kSingleTiers * ntiles + 1), ntx, ntiles,
                           tx, ty, lo, hi);

  float best = -INFINITY;
  int bid = sr::kNoWinner;
  const float* dat_b = dat + (size_t)b * nf * sr::kRaw;
  const int* ids_b = ids + (size_t)b * nf;
  for (int sg = 0; sg < sr::kSingleSegments; ++sg) {
    for (int base = lo[sg]; base < hi[sg]; base += kChunk) {
      const int n = min(kChunk, hi[sg] - base);
      __syncthreads();  // the previous chunk is consumed
      for (int i = tid; i < n; i += nthr) {
        const float* row = dat_b + (size_t)(base + i) * sr::kRaw;
#pragma unroll
        for (int r = 0; r < sr::kRaw; ++r) s_raw[i][r] = row[r];
        s_id[i] = ids_b[base + i];
        sr::level_setup(s_raw[i], 0, wf, hf, eps, s_set[i]);
      }
      __syncthreads();
      if (live) {
        for (int t = 0; t < n; ++t) {
          float depth, co[3];
          if (sr::level_pixel(s_set[t], s_raw[t], fx, fy, perspective != 0, eps, depth, co) &&
              sr::beats(depth, s_id[t], best, bid)) {
            best = depth;
            bid = s_id[t];
          }
        }
      }
    }
  }
  if (live) wins[((size_t)b * h + Y) * w + X] = bid == sr::kNoWinner ? -1 : bid;
}

}  // namespace

// Launches on `stream` and allocates nothing. Returns cudaGetLastError()
// after the launch (0 on success).
extern "C" int sr_rasterize_single(const float* dat, const int* ids, const int* starts,
                                   int* wins, int B, int nf, int h, int w, int tile,
                                   int perspective, float eps, void* stream) {
  if (B < 1 || B > 65535 || h < 1 || w < 1 || tile < 1 || tile > kMaxTile)
    return (int)cudaErrorInvalidValue;
  const int ntx = (w + tile - 1) / tile, nty = (h + tile - 1) / tile;
  const dim3 grid(ntx * nty, B);
  rasterize_single_kernel<<<grid, tile * tile, 0, static_cast<cudaStream_t>(stream)>>>(
      dat, ids, starts, wins, nf, h, w, tile, perspective, eps);
  return (int)cudaGetLastError();
}

extern "C" const char* sr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

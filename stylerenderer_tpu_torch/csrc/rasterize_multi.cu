// Multi-level pyramid rasterizer for Hopper (sm_90a).
//
// Replaces stylerenderer_tpu/ops/rasterize_pallas.py::_make_kernel_multi
// (the Pallas TPU kernel launched at rasterize_pallas.py:1182). For every
// pixel of every pyramid level, from `top` px down to top >> (n_levels-1),
// it finds the covering triangle of max depth (lowest id on ties) and, in
// attribute mode, the winner's interpolated attributes.
//
// Input: the binned triangles of ops/rasterize_multi.py::build_bins_multi,
// sorted by key tier*ntiles + home tile: dat [B, nf, 9 + 3C] f32 (corner
// px, py, z at the top level, then per-corner attributes), ids [B, nf] i32,
// starts [B, 4*ntiles + 1] i32. Output, level-major: vals [L][B, s, s, C]
// f32 (0 on background) and wins [L][B, s, s] i32 (-1 on background).
//
// Design: one block per (tile, batch item); one thread per pixel row of
// the tile across all levels (tile 16, 7 levels: 256 + 64 + 16 + 4 + 1 dense
// rows and 2 sparse rows, 343 rows in 352 threads; two rows per thread when
// a tile has more than 1024 rows). The block streams the tile's worklist
// segments (sorted-array ranges, sr::tile_segments) through shared memory
// in chunks of kChunk triangles. Per chunk the block computes each
// (triangle, level) setup once into shared memory; then each thread tests
// every candidate of the chunk against its pixel, mostly rejecting on the
// bbox of its level. The z-buffer lives in registers; nothing is atomic and
// the result does not depend on the order of the candidates.
//
// What bounds it on this card: the bytes it must move are the rows of the
// valid triangles (the prefix [0, starts[4*ntiles]) of the sorted arrays;
// back-facing and off-screen triangles are sorted past it and never read)
// read once, plus the maps written once: tens of microseconds at B=16 on
// the 100k-triangle face mesh at 3.35 TB/s (chip_smoke.py prints the
// figure for its inputs). The useful work, candidates whose bbox holds the
// pixel, takes less time than that at the card's f32 rate.
// This simple design instead spends its time on the bbox rejections (every
// row of a tile tests every candidate of the tile's worklist) and on one
// barrier per chunk. Staging chunks with cp.async or TMA and culling
// candidates per warp before the per-pixel test are the next steps.
//
// Bit-exactness: the candidate math (rasterize_multi.cuh) is the oracle's
// expression sequence; this file must be built with --fmad=false and
// without fast math (ops/_build.py), see the header's note.

#include <cuda_runtime.h>

#include "rasterize_multi.cuh"

namespace {

constexpr int kChunk = 32;
constexpr int kMaxLevels = 11;
constexpr int kMaxRowsPerThread = 2;

template <int C, int RPT>
__global__ void __launch_bounds__(1024)
rasterize_multi_kernel(const float* __restrict__ dat, const int* __restrict__ ids,
                       const int* __restrict__ starts, float* __restrict__ vals,
                       int* __restrict__ wins, int B, int nf, int top, int n_levels,
                       int tile, int rows, int perspective, float eps) {
  constexpr int R = sr::kRaw + 3 * C;
  extern __shared__ float smem[];
  float* s_raw = smem;                                           // [kChunk][R]
  int* s_id = reinterpret_cast<int*>(s_raw + kChunk * R);        // [kChunk]
  sr::LevelSetup* s_set = reinterpret_cast<sr::LevelSetup*>(s_id + kChunk);  // [kChunk][L]

  const int ntx = top / tile;
  const int ntiles = ntx * ntx;
  const int tx = blockIdx.x % ntx, ty = blockIdx.x / ntx;
  const int b = blockIdx.y;
  const int tid = threadIdx.x, nthr = blockDim.x;

  int lo[sr::kSegments], hi[sr::kSegments];
  sr::tile_segments(starts + (size_t)b * (sr::kTiers * ntiles + 1), ntx, tx, ty, lo, hi);

  int lev[RPT], X[RPT], Y[RPT];
  bool live[RPT];
  float best[RPT];
  int bid[RPT];
  float val[RPT][C > 0 ? C : 1];
#pragma unroll
  for (int j = 0; j < RPT; ++j) {
    const int r = tid + j * nthr;
    lev[j] = r < rows ? sr::row_pixel(r, top, tile, n_levels, tx, ty, X[j], Y[j], live[j]) : -1;
    if (lev[j] < 0) live[j] = false;
    best[j] = -INFINITY;
    bid[j] = sr::kNoWinner;
#pragma unroll
    for (int c = 0; c < (C > 0 ? C : 1); ++c) val[j][c] = 0.0f;
  }

  const float* dat_b = dat + (size_t)b * nf * R;
  const int* ids_b = ids + (size_t)b * nf;
  for (int sg = 0; sg < sr::kSegments; ++sg) {
    for (int base = lo[sg]; base < hi[sg]; base += kChunk) {
      const int n = min(kChunk, hi[sg] - base);
      __syncthreads();  // the previous chunk is consumed
      for (int i = tid; i < n * R; i += nthr) s_raw[i] = dat_b[(size_t)base * R + i];
      for (int i = tid; i < n; i += nthr) s_id[i] = ids_b[base + i];
      __syncthreads();
      for (int i = tid; i < n * n_levels; i += nthr) {
        const int t = i / n_levels, k = i - t * n_levels;
        const float wl = (float)(top >> k);
        sr::level_setup(s_raw + t * R, k, wl, wl, eps, s_set[i]);
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        if (!live[j]) continue;
        const float fx = (float)X[j], fy = (float)Y[j];
        for (int t = 0; t < n; ++t) {
          float depth, co[3];
          const float* raw = s_raw + t * R;
          if (sr::level_pixel(s_set[t * n_levels + lev[j]], raw, fx, fy, perspective != 0,
                              eps, depth, co) &&
              sr::beats(depth, s_id[t], best[j], bid[j])) {
            best[j] = depth;
            bid[j] = s_id[t];
#pragma unroll
            for (int c = 0; c < C; ++c)
              val[j][c] = sr::interp(co, raw[sr::kRaw + c], raw[sr::kRaw + C + c],
                                     raw[sr::kRaw + 2 * C + c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < RPT; ++j) {
    if (!live[j]) continue;
    const int s = top >> lev[j];
    const size_t pix = (size_t)sr::level_pixels_before(top, lev[j]) * B +
                       ((size_t)b * s + Y[j]) * s + X[j];
    const bool hit = bid[j] != sr::kNoWinner;
    wins[pix] = hit ? bid[j] : -1;
#pragma unroll
    for (int c = 0; c < C; ++c) vals[pix * C + c] = hit ? val[j][c] : 0.0f;
  }
}

template <int C, int RPT>
cudaError_t launch(dim3 grid, int threads, size_t smem, cudaStream_t stream,
                   const float* dat, const int* ids, const int* starts, float* vals,
                   int* wins, int B, int nf, int top, int n_levels, int tile, int rows,
                   int perspective, float eps) {
  rasterize_multi_kernel<C, RPT><<<grid, threads, smem, stream>>>(
      dat, ids, starts, vals, wins, B, nf, top, n_levels, tile, rows, perspective, eps);
  return cudaGetLastError();
}

template <int RPT>
cudaError_t launch_rpt(int n_attr, dim3 grid, int threads, size_t smem, cudaStream_t st,
                       const float* dat, const int* ids, const int* starts, float* vals,
                       int* wins, int B, int nf, int top, int n_levels, int tile, int rows,
                       int persp, float eps) {
#define SR_LAUNCH(C)                                                                   \
  case C:                                                                              \
    return launch<C, RPT>(grid, threads, smem, st, dat, ids, starts, vals, wins, B, nf, \
                          top, n_levels, tile, rows, persp, eps);
  switch (n_attr) {
    SR_LAUNCH(0) SR_LAUNCH(1) SR_LAUNCH(2) SR_LAUNCH(3)
    SR_LAUNCH(4) SR_LAUNCH(5) SR_LAUNCH(6) SR_LAUNCH(7)
    default:
      return cudaErrorInvalidValue;
  }
#undef SR_LAUNCH
}

}  // namespace

// Launches on `stream` and allocates nothing. Returns cudaGetLastError()
// after the launch (0 on success).
extern "C" int sr_rasterize_multi(const float* dat, const int* ids, const int* starts,
                                  float* vals, int* wins, int B, int nf, int top,
                                  int n_levels, int tile, int n_attr, int perspective,
                                  float eps, void* stream) {
  const int rows = sr::tile_rows(tile, n_levels);
  const int rpt = (rows + 1023) / 1024;
  if (B < 1 || top % tile || n_levels < 1 || n_levels > kMaxLevels || n_attr < 0 ||
      n_attr > 7 || rpt > kMaxRowsPerThread)
    return (int)cudaErrorInvalidValue;
  const int threads = (((rows + rpt - 1) / rpt) + 31) / 32 * 32;
  const int ntx = top / tile;
  const dim3 grid(ntx * ntx, B);
  const size_t smem = (size_t)kChunk * (sr::kRaw + 3 * n_attr + 1) * sizeof(float) +
                      (size_t)kChunk * n_levels * sizeof(sr::LevelSetup);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      rpt == 1 ? launch_rpt<1>(n_attr, grid, threads, smem, st, dat, ids, starts, vals, wins,
                               B, nf, top, n_levels, tile, rows, perspective, eps)
               : launch_rpt<2>(n_attr, grid, threads, smem, st, dat, ids, starts, vals, wins,
                               B, nf, top, n_levels, tile, rows, perspective, eps);
  return (int)err;
}

extern "C" const char* sr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

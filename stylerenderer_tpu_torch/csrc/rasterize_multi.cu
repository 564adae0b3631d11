// Multi-level pyramid rasterizer for Hopper (sm_90a), and its binning.
//
// Replaces stylerenderer_tpu/ops/rasterize_pallas.py::_make_kernel_multi
// (the Pallas TPU kernel launched at rasterize_pallas.py:1182) and the
// binning that feeds it (build_bins_multi, :645, which the JAX package
// leaves to XLA). For every pixel of every pyramid level, from `top` px down
// to top >> (n_levels-1), it finds the covering triangle of max depth
// (lowest id on ties) and, in attribute mode, the winner's interpolated
// attributes.
//
// Binning (sr_bin_multi, three passes, no host synchronisation): classify
// one thread per (batch item, triangle) into its key tier*ntiles + home
// (bin_multi.cuh, the decisions of ops/rasterize_multi.py::build_bins_multi)
// and take a slot in its segment with atomicAdd; scan the counts into
// starts [B, 4*ntiles + 1] (both in bin_passes.cuh, shared with the
// single-level binning); scatter every valid triangle's row: corner px,
// py, z at the top level, 3C corner attributes, the id's bits, padded to 16
// bytes (sr::row_words). The order within a segment varies from run to run;
// the result does not, since sr::beats is a total order on (depth, id) and
// values come from the winner's own row.
//
// Output, level-major: vals [L][B, s, s, C] f32 (0 on background) and wins
// [L][B, s, s] i32 (-1 on background).
//
// What bounds it on this card: the bytes it must move are the valid rows
// read once plus the maps written once, tens of microseconds at B=16 on the
// 100k-triangle face mesh at 3.35 TB/s; the useful candidate math (pixels
// inside a candidate's bbox) takes less at the card's f32 rate
// (chip_smoke.py prints both for its inputs). So the design is about not
// doing useless work. A face triangle covers about one pixel at 256 px and
// less than one at the coarse levels, where its clamped bbox is mostly
// empty. The first port gave every pixel row of a tile every candidate of
// the tile's worklist, nearly all rejected on the bbox. A per-warp cull
// (lane per candidate, __ballot_sync, the exact test on the survivors) cut
// the candidates but not the waste: each survivor still took a full warp's
// pass for the one or two pixels it covers (0.91 ms at 7 levels, B=16,
// against 1.39 ms; PERF.md). Hence this triangle-parallel design:
//
//   - One block per (tile, batch item), one thread per candidate of the
//     tile's worklist (its segments as one flat range). At each level the
//     candidate's bbox is clipped to the tile's pixels there; the rest of
//     the setup runs only where that clip is not empty and the triangle
//     faces front, and the exact test (sr::level_pixel) only on the pixels
//     of the clip. XL and degenerate candidates that miss the tile stop at
//     the bbox, as rasterize_pallas.py:934-944 skips them.
//   - The top level is done in place. A coarse level's clip is mostly empty
//     (a face triangle is smaller than a coarse pixel), and the few lanes
//     with one would hold their whole warp, so the non-empty coarse clips
//     go to a queue in shared memory that the block then works through
//     densely, one (candidate, level) pair per thread.
//   - The tile's z-buffer is one 64-bit key per pixel row in shared memory,
//     taken with atomicMax: the ordered depth above the inverted id
//     (sr::depth_key), so the max is the oracle's winner (max depth, lowest
//     id, -0 equal to +0) whatever order the threads run in; depths that
//     cannot win (-inf, NaN) never enter.
//   - A value pass after one barrier: each pixel's winner is recomputed
//     from its own row (slots: id -> row, written by the binning) and
//     interpolated, so values come from exactly one winner.
//   - Rows are 16-byte aligned, read with three 16-byte loads; no staging
//     and no barrier per candidate batch.

// Bit-exactness: the candidate math (rasterize_multi.cuh) and the binning
// (bin_multi.cuh) are the oracle's expression sequences; this file must be
// built with --fmad=false and without fast math (ops/_build.py), see the
// headers' notes.

#include <cuda_runtime.h>

#include "bin_multi.cuh"
#include "bin_passes.cuh"
#include "rasterize_multi.cuh"

namespace {

// Rasterizer block: one candidate per thread at a time (sr::kRound, the
// schedule the host build runs too), held to 64 registers for 4 blocks per
// SM. A choice: the timings that compared it with other block shapes were
// not kept.
constexpr int kThreads = sr::kRound;
constexpr int kMinBlocks = 4;
constexpr int kQueue = sr::kQueue;
constexpr int kBinThreads = 256;

// ---- binning ----------------------------------------------------------------

__global__ void bin_classify(const float* __restrict__ v, const long long* __restrict__ tri,
                             int* __restrict__ keys, int* __restrict__ rank,
                             int* __restrict__ counts, int B, int nv, int nf, int top,
                             int n_levels, int tile, int perspective, float eps) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)B * nf) return;
  const int b = (int)(i / nf), f = (int)(i - (long long)b * nf);
  const int K = sr::kTiers * (top / tile) * (top / tile);
  float px[3], py[3], z[3];
  const bool ok = sr::project_tri(v + (size_t)b * nv * 3, nv, tri + 3 * (size_t)f, top,
                                  top, perspective != 0, eps, px, py, z);
  const int key = sr::bin_key(px, py, ok, top, n_levels, tile, eps);
  keys[i] = key;
  if (key < K) rank[i] = sr::segment_slot(counts, b * K + key);
}

__global__ void bin_scatter(const float* __restrict__ v, const long long* __restrict__ tri,
                            const float* __restrict__ attrs, const int* __restrict__ keys,
                            const int* __restrict__ rank, const int* __restrict__ starts,
                            float* __restrict__ rows, int* __restrict__ slots, int B, int nv,
                            int nf, int top, int tile, int n_attr, int perspective, float eps) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)B * nf) return;
  const int K = sr::kTiers * (top / tile) * (top / tile);
  const int key = keys[i];
  if (key >= K) return;
  const int b = (int)(i / nf), f = (int)(i - (long long)b * nf);
  float px[3], py[3], z[3];
  sr::project_tri(v + (size_t)b * nv * 3, nv, tri + 3 * (size_t)f, top, top, perspective != 0,
                  eps, px, py, z);
  const int slot = starts[(size_t)b * (K + 1) + key] + rank[i];
  slots[i] = slot;
  sr::bin_row(px, py, z, attrs ? attrs + (size_t)b * nv * n_attr : nullptr, tri + 3 * (size_t)f,
              nv, n_attr, f, rows + ((size_t)b * nf + slot) * sr::row_words(n_attr));
}

// ---- the rasterizer -----------------------------------------------------------

template <int C>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
rasterize_multi_kernel(const float* __restrict__ rows, const int* __restrict__ starts,
                       const int* __restrict__ slots, float* __restrict__ vals,
                       int* __restrict__ wins, int B, int nf, int top, int n_levels, int tile,
                       int nrows, int perspective, float eps) {
  constexpr int RP = sr::row_words(C), R = sr::kRaw + 3 * C;
  extern __shared__ unsigned long long s_key[];  // [nrows]: the tile's z-buffer
  __shared__ sr::LevelTile s_lt[sr::kMaxLevels];
  const int tid = threadIdx.x;
  const int ntx = top / tile, ntiles = ntx * ntx;
  const int tx = blockIdx.x % ntx, ty = blockIdx.x / ntx;
  const int b = blockIdx.y;

  // the worklist's bounds in shared memory: 12 registers fewer per thread
  __shared__ int lo[sr::kSegments], hi[sr::kSegments];
  // (sorted position << 4 | level) of each candidate's coarse levels whose
  // clip is not empty, processed densely after level 0
  __shared__ int s_queue[kQueue];
  __shared__ int s_qn;
  if (tid == 0) s_qn = 0;
  for (int r = tid; r < nrows; r += kThreads) s_key[r] = 0ull;
  if (tid < n_levels) sr::level_tile(top, top, tile, n_levels, tid, tx, ty, s_lt[tid]);
  if (tid == 0)
    sr::tile_segments(starts + (size_t)b * (sr::kTiers * ntiles + 1), ntx, tx, ty, lo, hi);
  __syncthreads();
  const int total = sr::segment_total<sr::kSegments>(lo, hi);
  const float* rows_b = rows + (size_t)b * nf * RP;
  auto emit = [&](int r, unsigned long long key) { atomicMax(&s_key[r], key); };
  // the row at sorted position p -> its corners in t, its id
  auto load = [&](int p, float t[12]) {
    const float* row = rows_b + (size_t)p * RP;
    const float4* row4 = reinterpret_cast<const float4*>(row);
    *reinterpret_cast<float4*>(t) = __ldg(row4);
    *reinterpret_cast<float4*>(t + 4) = __ldg(row4 + 1);
    *reinterpret_cast<float4*>(t + 8) = __ldg(row4 + 2);
    return sr::f2i(C == 0 ? t[sr::kRaw] : __ldg(row + R));  // (C = 0: the id is t[9])
  };
  // every queued (candidate, coarse level) pair, 256 at a time
  auto run_queue = [&]() {
    const int n = s_qn;
    for (int i = tid; i < n; i += kThreads) {
      const int item = s_queue[i], k = item & 15;
      float t[12], p[6];
      sr::LevelSetup S;
      int clip[4];
      const int id = load(item >> 4, t);
      if (sr::level_clip(t, k, top, top, s_lt[k], p, S, clip))
        sr::clip_scan(t, id, p, clip, s_lt[k], S, perspective != 0, eps, emit);
    }
  };
  const int lane = tid & 31;
  for (int q0 = 0; q0 < total; q0 += kThreads) {
    const int q = q0 + tid;
    if (q < total) {
      const int pos = sr::segment_pos<sr::kSegments>(q, lo, hi);
      float t[12], p[6];
      sr::LevelSetup S;
      int clip[4];
      const int id = load(pos, t);
      if (sr::level_clip(t, 0, top, top, s_lt[0], p, S, clip))
        sr::clip_scan(t, id, p, clip, s_lt[0], S, perspective != 0, eps, emit);
      for (int k = 1; k < n_levels; ++k) {
        const bool push = sr::level_clip(t, k, top, top, s_lt[k], p, S, clip);
        // one shared atomicAdd per warp for its pushes
        const unsigned act = __activemask();
        const unsigned m = __ballot_sync(act, push);
        const int leader = __ffs(act) - 1;
        int base = 0;
        if (lane == leader && m) base = atomicAdd(&s_qn, __popc(m));
        base = __shfl_sync(act, base, leader);
        if (push) s_queue[base + __popc(m & ((1u << lane) - 1u))] = pos << 4 | k;
      }
    }
    // one decision for the whole block, taken before any thread can push
    // again: thread 0 reads the count after every push of the round
    __syncthreads();
    if (__syncthreads_or(tid == 0 && sr::queue_full(s_qn, kQueue, kThreads, n_levels))) {
      run_queue();
      __syncthreads();
      if (tid == 0) s_qn = 0;
      __syncthreads();
    }
  }
  run_queue();
  __syncthreads();

  for (int r = tid; r < nrows; r += kThreads) {
    int X, Y;
    bool live;
    const int k = sr::row_pixel(r, top, tile, n_levels, tx, ty, X, Y, live);
    if (!live) continue;
    const int s = top >> k;
    const size_t pix = (size_t)sr::level_pixels_before(top, k) * B + ((size_t)b * s + Y) * s + X;
    const unsigned long long key = s_key[r];
    const int id = key ? sr::key_id(key) : -1;
    wins[pix] = id;
    if (C > 0) {
      float v[C > 0 ? C : 1];
      if (id >= 0)
        sr::winner_values(rows_b + (size_t)slots[(size_t)b * nf + id] * RP, k, (float)s, X, Y,
                          perspective != 0, eps, C, v);
#pragma unroll
      for (int a = 0; a < C; ++a) vals[pix * C + a] = id >= 0 ? v[a] : 0.0f;
    }
  }
}

using Kernel = void (*)(const float*, const int*, const int*, float*, int*, int, int, int, int,
                        int, int, int, float);

Kernel kernel_for(int n_attr) {
  switch (n_attr) {
    case 0: return rasterize_multi_kernel<0>;
    case 1: return rasterize_multi_kernel<1>;
    case 2: return rasterize_multi_kernel<2>;
    case 3: return rasterize_multi_kernel<3>;
    case 4: return rasterize_multi_kernel<4>;
    case 5: return rasterize_multi_kernel<5>;
    case 6: return rasterize_multi_kernel<6>;
    case 7: return rasterize_multi_kernel<7>;
    default: return nullptr;
  }
}

// The kernel for these arguments and its dynamic shared memory (the tile's
// z-buffer); nullptr when the arguments are refused.
Kernel prepare(int B, int top, int n_levels, int tile, int n_attr, size_t& smem) {
  if (B < 1 || B > 65535 || tile < 1 || top % tile || n_levels < 1 ||
      n_levels > sr::kMaxLevels || n_attr < 0 || n_attr > 7)
    return nullptr;
  smem = (size_t)sr::tile_rows(tile, n_levels) * sizeof(unsigned long long);
  if (smem > 48 * 1024) return nullptr;
  return kernel_for(n_attr);
}

}  // namespace

// The binning passes on `stream`; they allocate nothing. counts [B, K] must
// be zero; keys, rank [B, nf], starts [B, K+1], rows [B, nf,
// row_words(n_attr)] and slots [B, nf] (each valid triangle's row) are
// written (rows past starts[b][K] and invalid triangles' slots are not). attrs
// [B, nv, n_attr] may be null when n_attr is 0. Returns cudaGetLastError()
// after the launches (0 on success).
extern "C" int sr_bin_multi(const float* v, const long long* tri, const float* attrs,
                            int* counts, int* keys, int* rank, int* starts, float* rows,
                            int* slots, int B,
                            int nv, int nf, int top, int n_levels, int tile, int n_attr,
                            int perspective, float eps, void* stream) {
  if (B < 1 || nv < 1 || nf < 0 || tile < 1 || top % tile || n_levels < 1 ||
      n_levels > sr::kMaxLevels || n_attr < 0 || n_attr > 7 || (n_attr > 0 && !attrs))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int K = sr::kTiers * (top / tile) * (top / tile);
  const long long n = (long long)B * nf;
  const unsigned blocks = (unsigned)((n + kBinThreads - 1) / kBinThreads);
  if (n > 0)
    bin_classify<<<blocks, kBinThreads, 0, st>>>(v, tri, keys, rank, counts, B, nv, nf, top,
                                                 n_levels, tile, perspective, eps);
  sr::bin_scan<<<B, sr::kScanThreads, 0, st>>>(counts, starts, K);
  if (n > 0)
    bin_scatter<<<blocks, kBinThreads, 0, st>>>(v, tri, attrs, keys, rank, starts, rows, slots,
                                                B, nv, nf, top, tile, n_attr, perspective, eps);
  return (int)cudaGetLastError();
}

// The rasterizer on `stream` over sr_bin_multi's rows, starts and slots;
// allocates nothing. Returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int sr_rasterize_multi(const float* rows, const int* starts, const int* slots,
                                  float* vals, int* wins, int B, int nf, int top, int n_levels,
                                  int tile, int n_attr, int perspective, float eps,
                                  void* stream) {
  size_t smem;
  const Kernel kernel = prepare(B, top, n_levels, tile, n_attr, smem);
  if (!kernel) return (int)cudaErrorInvalidValue;
  const int ntx = top / tile;
  kernel<<<dim3(ntx * ntx, B), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      rows, starts, slots, vals, wins, B, nf, top, n_levels, tile, sr::tile_rows(tile, n_levels),
      perspective, eps);
  return (int)cudaGetLastError();
}

// The rasterizer's launch shape for these arguments: out = {threads per
// block, dynamic shared memory bytes, static shared memory bytes,
// registers per thread, local memory bytes per thread (spills), resident
// blocks per SM}.
extern "C" int sr_rasterize_multi_shape(int top, int n_levels, int tile, int n_attr, int* out) {
  size_t bytes;
  const Kernel kernel = prepare(1, top, n_levels, tile, n_attr, bytes);
  if (!kernel) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  out[0] = kThreads;
  out[1] = (int)bytes;
  out[2] = (int)attr.sharedSizeBytes;
  out[3] = attr.numRegs;
  out[4] = (int)attr.localSizeBytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[5], kernel, kThreads, bytes);
}

extern "C" const char* sr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

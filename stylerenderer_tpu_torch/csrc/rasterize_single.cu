// Single-level tile rasterizer for Hopper (sm_90a), and its binning.
//
// Replaces stylerenderer_tpu/ops/rasterize_pallas.py::_make_kernel (the
// Pallas TPU kernel launched at rasterize_pallas.py:514 inside
// rasterize_winners_pallas) and the binning that feeds it (build_bins, :76,
// which the JAX package leaves to XLA). For every pixel of an h x w image
// it finds the covering triangle of max depth, the lowest id on ties, -1 on
// background: the winner map of ops/rasterize.py::rasterize_winners, bit
// for bit.
//
// Binning (sr_bin_single, three passes, no sort and no host
// synchronisation): classify one thread per (batch item, triangle) into its
// key tier*ntiles + home (bin_single.cuh, the decisions of
// ops/rasterize_single.py::build_bins) and take a slot in its segment with
// a warp-aggregated atomicAdd; scan the counts into starts [B, 5*ntiles+1]
// (both in bin_passes.cuh, shared with the multi-level binning); scatter
// every valid triangle's row: corner px, py, z and the id's bits, padded to
// 48 bytes (sr::row_words(0)). The tile grid is ceil(w/tile) x
// ceil(h/tile); the order within a segment varies from run to run, and the
// result does not, since the z-test below is a total order.
//
// What bounds it on this card: the bytes it must move are the valid rows
// read once plus the winner map written once, about ten microseconds at
// B=16, 256 px, on the 100k-triangle face mesh at 3.35 TB/s; the useful
// candidate math (pixels inside a candidate's bbox) takes less at the
// card's f32 rate (chip_smoke.py prints both for its inputs). A face
// triangle covers about one pixel, so the work is in not doing useless
// tests. The first port gave every pixel of a tile every candidate of the
// tile's worklist, nearly all rejected on the bbox, with two barriers per
// 64-candidate chunk (0.62 ms, 69x the bound; PERF.md). This design is the
// multi-level kernel's at one level (rasterize_multi.cu):
//
//   - One block per (tile, batch item) of sr::single_threads(tile) threads
//     (64 at tile 8, 256 at 16 and 32, the fastest measured; PERF.md), one
//     thread per candidate of the tile's worklist: its 24 segments as one
//     flat range, laid out by the first warp (one segment per lane, the
//     non-empty ones first), taken in rounds of one candidate per thread,
//     interleaved over the warps so that a short worklist spreads over all
//     of them. The candidate's bbox
//     is clipped to the tile's pixels (sr::level_clip; an edge tile's
//     rectangle is clipped to the image); only on a non-empty clip does the
//     rest of the setup run.
//   - The exact test (sr::level_pixel) runs only on the pixels of the
//     clips, spread evenly over each warp's lanes: every lane publishes its
//     candidate's setup and clip to a slot in shared memory, a warp scan of
//     the clip areas lays the warp's (candidate, pixel) pairs out as one
//     range, and the 32 lanes take its pairs in turn (each finds its pair's
//     candidate by a binary search of the scan; sr::pair_setup, pair_lane
//     and pair_pixel in rasterize_single.cuh, which the host build runs).
//     A clip of 1,024 px (a big triangle on a 32 px tile) costs its warp
//     32 steps, not 1,024, and a warp is not held by its one large
//     triangle. Against each lane
//     walking its own clip, this measured 2x faster on the synth writer's
//     mesh (~7 px triangles) and within 4% on the face mesh (~1 px) on an
//     H100 (PERF.md).
//   - The tile's z-buffer is one 64-bit key per pixel in shared memory,
//     taken with atomicMax: the ordered depth above the inverted id
//     (sr::depth_key), so the max is the oracle's winner (max depth, lowest
//     id, -0 equal to +0) whatever order the threads run in; -inf never
//     enters, and a NaN depth takes a key above all others that blanks its
//     pixel. After one barrier each pixel in the image gets its key's
//     winner, or -1 (sr::key_winner).
//   - Rows are 16-byte aligned, read with three 16-byte loads.
//
// Bit-exactness: the candidate math (rasterize_multi.cuh) and the binning
// (bin_single.cuh) are the oracle's expression sequences; this file must be
// built with --fmad=false and without fast math (ops/_build.py), see the
// headers' notes.

#include <cuda_runtime.h>

#include "bin_passes.cuh"
#include "bin_single.cuh"
#include "rasterize_single.cuh"

namespace {

constexpr int kMinBlocks = 4;  // held to 64 registers at 256 threads
constexpr int kMaxTile = 32;   // a z-buffer of tile * tile keys, at most 8 KB
constexpr unsigned kFull = 0xffffffffu;
constexpr int kBinThreads = 256;
constexpr int kRow = sr::row_words(0);  // 9 floats, the id, padding: 48 bytes

// ---- binning ----------------------------------------------------------------

__global__ void bin_single_classify(const float* __restrict__ v, const long long* __restrict__ tri,
                                    int* __restrict__ keys, int* __restrict__ rank,
                                    int* __restrict__ counts, int B, int nv, int nf, int h,
                                    int w, int tile, int perspective, float eps) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)B * nf) return;
  const int b = (int)(i / nf), f = (int)(i - (long long)b * nf);
  const int K = sr::kSingleTiers * sr::single_tiles(w, tile) * sr::single_tiles(h, tile);
  float px[3], py[3], z[3];
  const bool ok = sr::project_tri(v + (size_t)b * nv * 3, nv, tri + 3 * (size_t)f, w, h,
                                  perspective != 0, eps, px, py, z);
  const int key = sr::bin_key_single(px, py, ok, w, h, tile, eps);
  keys[i] = key;
  if (key < K) rank[i] = sr::segment_slot(counts, b * K + key);
}

__global__ void bin_single_scatter(const float* __restrict__ v, const long long* __restrict__ tri,
                                   const int* __restrict__ keys, const int* __restrict__ rank,
                                   const int* __restrict__ starts, float* __restrict__ rows,
                                   int B, int nv, int nf, int h, int w, int tile, int perspective,
                                   float eps) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)B * nf) return;
  const int K = sr::kSingleTiers * sr::single_tiles(w, tile) * sr::single_tiles(h, tile);
  const int key = keys[i];
  if (key >= K) return;
  const int b = (int)(i / nf), f = (int)(i - (long long)b * nf);
  float px[3], py[3], z[3];
  sr::project_tri(v + (size_t)b * nv * 3, nv, tri + 3 * (size_t)f, w, h, perspective != 0, eps,
                  px, py, z);
  const int slot = starts[(size_t)b * (K + 1) + key] + rank[i];
  sr::bin_row(px, py, z, nullptr, tri + 3 * (size_t)f, nv, 0, f,
              rows + ((size_t)b * nf + slot) * kRow);
}

// ---- the rasterizer -----------------------------------------------------------

__host__ __device__ constexpr size_t key_bytes(int npix) {
  return ((size_t)npix * sizeof(unsigned long long) + 15) / 16 * 16;
}

__global__ void __launch_bounds__(sr::kMaxSingleThreads, kMinBlocks)
rasterize_single_kernel(const float* __restrict__ rows, const int* __restrict__ starts,
                        int* __restrict__ wins, int nf, int h, int w, int tile, int perspective,
                        float eps) {
  __shared__ int lo[sr::kSingleSegments], hi[sr::kSingleSegments];
  const int tid = threadIdx.x, nthr = blockDim.x, lane = tid & 31;
  const int warp = tid >> 5, nwarps = nthr >> 5;
  const int ntx = sr::single_tiles(w, tile), ntiles = ntx * sr::single_tiles(h, tile);
  const int tx = blockIdx.x % ntx, ty = blockIdx.x / ntx;
  const int b = blockIdx.y;
  const int npix = tile * tile;
  // dynamic shared memory: the tile's z-buffer, then one slot and one scan
  // entry per thread
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* s_key = reinterpret_cast<unsigned long long*>(smem);
  sr::PairSlot* s_slot = reinterpret_cast<sr::PairSlot*>(smem + key_bytes(npix));
  int* s_end = reinterpret_cast<int*>(s_slot + nthr);

  for (int r = tid; r < npix; r += nthr) s_key[r] = 0ull;
  if (tid < 32) {
    // the worklist, one segment per lane, compacted in segment order: the
    // non-empty segments first, so segment_pos stops early
    int l = 0, e = 0;
    if (lane < sr::kSingleSegments)
      sr::single_tile_segment(starts + (size_t)b * (sr::kSingleTiers * ntiles + 1), ntx, ntiles,
                              tx, ty, lane, l, e);
    const bool live = e > l;
    const unsigned m = __ballot_sync(kFull, live);
    if (live) {
      const int slot = __popc(m & ((1u << lane) - 1u));
      lo[slot] = l;
      hi[slot] = e;
    }
    if (lane >= __popc(m) && lane < sr::kSingleSegments) lo[lane] = hi[lane] = 0;
  }
  __syncthreads();
  const int total = sr::segment_total<sr::kSingleSegments>(lo, hi);
  const sr::LevelTile T = sr::single_tile(w, h, tile, tx, ty);
  const float* rows_b = rows + (size_t)b * nf * kRow;
  const bool persp = perspective != 0;
  auto emit = [&](int r, unsigned long long key) { atomicMax(&s_key[r], key); };
  // the row at sorted position p -> its corners in t, its id
  auto load = [&](int p, float t[12]) {
    const float4* row4 = reinterpret_cast<const float4*>(rows_b + (size_t)p * kRow);
    *reinterpret_cast<float4*>(t) = __ldg(row4);
    *reinterpret_cast<float4*>(t + 4) = __ldg(row4 + 1);
    *reinterpret_cast<float4*>(t + 8) = __ldg(row4 + 2);
    return sr::f2i(t[sr::kRaw]);
  };

  // candidates interleaved over the warps; each warp lays its candidates'
  // clips out as one flat range of (candidate, pixel) pairs, and its 32
  // lanes take the pairs in turn
  const int* ends = s_end + warp * 32;
  const sr::PairSlot* slots = s_slot + warp * 32;
  for (int q0 = 0; q0 < total; q0 += nthr) {
    const int q = q0 + lane * nwarps + warp;
    int area = 0;
    if (q < total) {
      float t[12];
      const int id = load(sr::segment_pos<sr::kSingleSegments>(q, lo, hi), t);
      area = sr::pair_setup(t, id, w, h, T, eps, s_slot[tid]);
    }
    int end = area;  // inclusive scan of the clip areas over the warp
    for (int d = 1; d < 32; d <<= 1) {
      const int up = __shfl_up_sync(kFull, end, d);
      if (lane >= d) end += up;
    }
    s_end[tid] = end;
    const int n = __shfl_sync(kFull, end, 31);
    __syncwarp();
    for (int j = lane; j < n; j += 32) {
      const int o = sr::pair_lane(ends, j);
      int x, y;
      sr::pair_pixel(ends, slots[o], o, j, x, y);
      sr::test_pixel(slots[o].S, slots[o].z, slots[o].id, x, y, T, persp, eps, emit);
    }
    __syncwarp();  // the slots are read before the next round writes them
  }
  __syncthreads();

  for (int r = tid; r < npix; r += nthr) {
    const int X = T.x0 + r % tile, Y = T.y0 + r / tile;
    if (X > T.x1 || Y > T.y1) continue;  // an edge tile's pixels outside the image
    const unsigned long long key = s_key[r];
    wins[((size_t)b * h + Y) * w + X] = sr::key_winner(key);
  }
}

// The kernel's block for these arguments (sr::single_threads) and its
// dynamic shared memory (the z-buffer, then one slot and one scan entry per
// thread); false when they are refused.
bool prepare(int B, int h, int w, int tile, int& threads, size_t& smem) {
  if (B < 1 || B > 65535 || h < 1 || w < 1 || tile < 1 || tile > kMaxTile) return false;
  threads = sr::single_threads(tile);
  smem = key_bytes(tile * tile) + (size_t)threads * (sizeof(sr::PairSlot) + sizeof(int));
  return true;
}

}  // namespace

// The binning passes on `stream`; they allocate nothing. counts [B, K]
// (K = 5 * ntiles) must be zero; keys, rank [B, nf], starts [B, K+1] and
// rows [B, nf, 12] are written (rows past starts[b][K] are not). Returns
// cudaGetLastError() after the launches (0 on success).
extern "C" int sr_bin_single(const float* v, const long long* tri, int* counts, int* keys,
                             int* rank, int* starts, float* rows, int B, int nv, int nf, int h,
                             int w, int tile, int perspective, float eps, void* stream) {
  if (B < 1 || nv < 1 || nf < 0 || h < 1 || w < 1 || tile < 1 || tile > kMaxTile)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int K = sr::kSingleTiers * sr::single_tiles(w, tile) * sr::single_tiles(h, tile);
  const long long n = (long long)B * nf;
  const unsigned blocks = (unsigned)((n + kBinThreads - 1) / kBinThreads);
  if (n > 0)
    bin_single_classify<<<blocks, kBinThreads, 0, st>>>(v, tri, keys, rank, counts, B, nv, nf, h,
                                                        w, tile, perspective, eps);
  sr::bin_scan<<<B, sr::kScanThreads, 0, st>>>(counts, starts, K);
  if (n > 0)
    bin_single_scatter<<<blocks, kBinThreads, 0, st>>>(v, tri, keys, rank, starts, rows, B, nv,
                                                       nf, h, w, tile, perspective, eps);
  return (int)cudaGetLastError();
}

// The rasterizer on `stream` over sr_bin_single's rows and starts;
// allocates nothing. Returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int sr_rasterize_single(const float* rows, const int* starts, int* wins, int B, int nf,
                                   int h, int w, int tile, int perspective, float eps,
                                   void* stream) {
  int threads;
  size_t smem;
  if (!prepare(B, h, w, tile, threads, smem)) return (int)cudaErrorInvalidValue;
  const int ntiles = sr::single_tiles(w, tile) * sr::single_tiles(h, tile);
  rasterize_single_kernel<<<dim3(ntiles, B), threads, smem, static_cast<cudaStream_t>(stream)>>>(
      rows, starts, wins, nf, h, w, tile, perspective, eps);
  return (int)cudaGetLastError();
}

// The rasterizer's launch shape: out = {threads per block, dynamic shared
// memory bytes, static shared memory bytes, registers per thread, local
// memory bytes per thread (spills), resident blocks per SM}.
extern "C" int sr_rasterize_single_shape(int tile, int* out) {
  int threads;
  size_t smem;
  if (!prepare(1, tile, tile, tile, threads, smem)) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, rasterize_single_kernel);
  if (err != cudaSuccess) return (int)err;
  out[0] = threads;
  out[1] = (int)smem;
  out[2] = (int)attr.sharedSizeBytes;
  out[3] = attr.numRegs;
  out[4] = (int)attr.localSizeBytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[5], rasterize_single_kernel,
                                                            threads, smem);
}

extern "C" const char* sr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

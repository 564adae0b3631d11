// Per-tile bookkeeping and the pair schedule of the single-level tile
// rasterizer, shared by the Hopper kernel (rasterize_single.cu) and its
// host build (rasterize_single_host.cpp). The candidate math and the
// per-candidate clip (sr::level_clip, sr::test_pixel, sr::depth_key) are
// rasterize_multi.cuh's at level 0.
//
// Binning (bin_single.cuh, after stylerenderer_tpu/ops/rasterize_pallas.py:76):
// every valid triangle has one key, tier * ntiles + home, where home is the
// tile of its clamped integer bbox's top-left pixel and the tier is the
// smallest span of (1, 2, 4, 16) tiles that holds its bbox (degenerate
// triangles and bigger ones go to XL). starts[b] holds the first sorted
// index of every key, then the end: kSingleTiers * ntiles + 1 entries.

#pragma once

#include "rasterize_multi.cuh"

namespace sr {

constexpr int kSingleTiers = 5;      // spans 1, 2, 4 and 16 tiles, then XL
constexpr int kSingleSegments = 24;  // one home row per span: 1 + 2 + 4 + 16, then XL
constexpr int kMaxSingleThreads = 256;

SR_HD int single_tiles(int n, int tile) { return (n + tile - 1) / tile; }

// Segment sg (0..kSingleSegments-1) of the worklist of tile (tx, ty) in a
// grid ntx tiles wide: for each span, one contiguous segment per home row
// in the span x span neighbourhood up and left of the tile
// (rasterize_pallas.py:437-461), then the global XL segment. A triangle can
// cover a pixel of this tile only if its home lies in that neighbourhood of
// its tier.
SR_HD void single_tile_segment(const int* starts_b, int ntx, int ntiles, int tx, int ty, int sg,
                               int& lo, int& hi) {
  int tier = 0, first = 0, span = 1;  // spans 1, 2, 4, 16
  while (tier < kSingleTiers - 1 && sg >= first + span) {
    first += span;
    ++tier;
    span = tier == kSingleTiers - 2 ? 16 : span * 2;
  }
  if (tier == kSingleTiers - 1) {
    lo = starts_b[(kSingleTiers - 1) * ntiles];
    hi = starts_b[kSingleTiers * ntiles];
    return;
  }
  const int base = tier * ntiles, row = ty - (sg - first);
  const int col_lo = tx - (span - 1) > 0 ? tx - (span - 1) : 0;
  if (row >= 0) {
    lo = starts_b[base + row * ntx + col_lo];
    hi = starts_b[base + row * ntx + tx + 1];
  } else {
    lo = hi = 0;
  }
}

// The whole worklist, the non-empty segments first in segment order and the
// empty ones as (0, 0), as the kernel's first warp lays it out.
SR_HD void single_tile_segments(const int* starts_b, int ntx, int ntiles, int tx, int ty,
                                int lo[kSingleSegments], int hi[kSingleSegments]) {
  int n = 0;
  for (int sg = 0; sg < kSingleSegments; ++sg) {
    int l, h;
    single_tile_segment(starts_b, ntx, ntiles, tx, ty, sg, l, h);
    if (h > l) {
      lo[n] = l;
      hi[n] = h;
      ++n;
    }
  }
  for (; n < kSingleSegments; ++n) lo[n] = hi[n] = 0;
}

// The tile's pixels: (tx, ty) of a w x h image, clipped to the image.
SR_HD LevelTile single_tile(int w, int h, int tile, int tx, int ty) {
  LevelTile T;
  level_tile(w, h, tile, 1, 0, tx, ty, T);
  return T;
}

SR_HD int clip_area(const int clip[4]) { return (clip[1] - clip[0] + 1) * (clip[3] - clip[2] + 1); }

// The pair schedule. Each lane of a warp sets up one candidate and publishes
// it in a PairSlot; an inclusive scan of the 32 lanes' clip areas, ends[],
// lays the warp's (candidate, pixel) pairs out as one range [0, ends[31]),
// and the lanes take its pairs in turn.
struct alignas(16) PairSlot {
  LevelSetup S;
  float z[3];
  int id, x0, y0, cw;  // the clip's first pixel and width
  float inv_cw;
};

// Candidate row t (corners at level 0, id `id`) over tile T of a w x h
// image: its clip's pixel count, with its setup in c, or 0 when it can
// cover no pixel of the tile (c is then not written).
SR_HD int pair_setup(const float* t, int id, int w, int h, const LevelTile& T, float eps,
                     PairSlot& c) {
  float p[6];
  LevelSetup S;
  int clip[4];
  if (!level_clip(t, 0, w, h, T, p, S, clip)) return 0;
  level_coeffs(p, eps, S);
  if (!(S.flags & kCanCover)) return 0;
  c.S = S;
  c.z[0] = t[kZ];
  c.z[1] = t[kZ + 1];
  c.z[2] = t[kZ + 2];
  c.id = id;
  c.x0 = clip[0];
  c.y0 = clip[2];
  c.cw = clip[1] - clip[0] + 1;
  c.inv_cw = 1.0f / (float)c.cw;
  return clip_area(clip);
}

// Pair j of the warp's range: the lane whose candidate it belongs to (the
// first lane whose range ends past j, by a binary search of ends[0..31]).
SR_HD int pair_lane(const int* ends, int j) {
  int o = 0;
  for (int st = 16; st > 0; st >>= 1)
    if (ends[o + st - 1] <= j) o += st;
  return o;
}

// Pair j's pixel (x, y), for the candidate c of lane o: the clip's pixels in
// row-major order. The row is k / cw exactly (k < 1024, cw <= 32), by a
// multiply in place of the division.
SR_HD void pair_pixel(const int* ends, const PairSlot& c, int o, int j, int& x, int& y) {
  const int k = j - (o ? ends[o - 1] : 0);
  const int r = (int)(((float)k + 0.5f) * c.inv_cw);
  x = c.x0 + k - r * c.cw;
  y = c.y0 + r;
}

// Threads of the kernel's block (its round of candidates): one per pixel of
// the tile, at least two warps, at most kMaxSingleThreads.
SR_HD int single_threads(int tile) {
  const int n = (tile * tile + 31) / 32 * 32;
  return n < 64 ? 64 : (n > kMaxSingleThreads ? kMaxSingleThreads : n);
}

}  // namespace sr

// Per-tile bookkeeping of the single-level tile rasterizer, shared by the
// Hopper kernel (rasterize_single.cu) and its host build
// (rasterize_single_host.cpp). The candidate math is rasterize_multi.cuh's
// at level 0.
//
// Binning (ops/rasterize_single.py::build_bins, after
// stylerenderer_tpu/ops/rasterize_pallas.py:76): every valid triangle has
// one key, tier * ntiles + home, where home is the tile of its clamped
// integer bbox's top-left pixel and the tier is the smallest span of
// (1, 2, 4, 16) tiles that holds its bbox (degenerate triangles and bigger
// ones go to XL). starts[b] holds the first sorted index of every key, then
// the end: kSingleTiers * ntiles + 1 entries.

#pragma once

#include "rasterize_multi.cuh"

namespace sr {

constexpr int kSingleTiers = 5;      // spans 1, 2, 4 and 16 tiles, then XL
constexpr int kSingleSegments = 24;  // one home row per span: 1 + 2 + 4 + 16, then XL

// The worklist of tile (tx, ty) in a grid ntx tiles wide: for each span,
// one contiguous segment per home row in the span x span neighbourhood up
// and left of the tile (rasterize_pallas.py:437-461), then the global XL
// segment. A triangle can cover a pixel of this tile only if its home lies
// in that neighbourhood of its tier.
SR_HD void single_tile_segments(const int* starts_b, int ntx, int ntiles, int tx, int ty,
                                int lo[kSingleSegments], int hi[kSingleSegments]) {
  const int spans[kSingleTiers - 1] = {1, 2, 4, 16};
  int n = 0;
  for (int tier = 0; tier < kSingleTiers - 1; ++tier) {
    const int span = spans[tier], base = tier * ntiles;
    const int col_lo = tx - (span - 1) > 0 ? tx - (span - 1) : 0;
    for (int dy = 0; dy < span; ++dy) {
      const int row = ty - dy;
      if (row >= 0) {
        lo[n] = starts_b[base + row * ntx + col_lo];
        hi[n] = starts_b[base + row * ntx + tx + 1];
      } else {
        lo[n] = hi[n] = 0;
      }
      ++n;
    }
  }
  lo[n] = starts_b[(kSingleTiers - 1) * ntiles];
  hi[n] = starts_b[kSingleTiers * ntiles];
}

}  // namespace sr

// Host build of the single-level tile rasterizer: the same candidate math
// (rasterize_multi.cuh at level 0) and the same per-tile worklists
// (rasterize_single.cuh) as rasterize_single.cu, run by plain loops over
// (batch, tile, pixel). The CPU tests hold it bit for bit against the torch
// oracle. Build with g++ -O2 -ffp-contract=off -shared -fPIC (ops/_build.py).

#include "rasterize_single.cuh"

extern "C" int sr_rasterize_single_host(const float* dat, const int* ids, const int* starts,
                                        int* wins, int B, int nf, int h, int w, int tile,
                                        int perspective, float eps) {
  if (B < 1 || h < 1 || w < 1 || tile < 1) return 1;
  const int ntx = (w + tile - 1) / tile, nty = (h + tile - 1) / tile;
  const int ntiles = ntx * nty;
  for (int b = 0; b < B; ++b) {
    const float* dat_b = dat + (long long)b * nf * sr::kRaw;
    const int* ids_b = ids + (long long)b * nf;
    for (int t = 0; t < ntiles; ++t) {
      const int tx = t % ntx, ty = t / ntx;
      int lo[sr::kSingleSegments], hi[sr::kSingleSegments];
      sr::single_tile_segments(starts + (long long)b * (sr::kSingleTiers * ntiles + 1), ntx,
                               ntiles, tx, ty, lo, hi);
      for (int p = 0; p < tile * tile; ++p) {
        const int X = tx * tile + p % tile, Y = ty * tile + p / tile;
        if (X >= w || Y >= h) continue;
        float best = -INFINITY;
        int bid = sr::kNoWinner;
        for (int sg = 0; sg < sr::kSingleSegments; ++sg) {
          for (int q = lo[sg]; q < hi[sg]; ++q) {
            const float* raw = dat_b + (long long)q * sr::kRaw;
            sr::LevelSetup S;
            sr::level_setup(raw, 0, (float)w, (float)h, eps, S);
            float depth, co[3];
            if (sr::level_pixel(S, raw, (float)X, (float)Y, perspective != 0, eps, depth, co) &&
                sr::beats(depth, ids_b[q], best, bid)) {
              best = depth;
              bid = ids_b[q];
            }
          }
        }
        wins[((long long)b * h + Y) * w + X] = bid == sr::kNoWinner ? -1 : bid;
      }
    }
  }
  return 0;
}

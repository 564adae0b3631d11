// Host build of the multi-level pyramid rasterizer: the same per-candidate
// math and per-tile bookkeeping as rasterize_multi.cu (both include
// rasterize_multi.cuh), run by plain loops over (batch, tile, row). The CPU
// tests hold it bit for bit against the torch oracle, so FMA and division
// faults in the shared math show up without a card. Build with
// g++ -O2 -ffp-contract=off -shared -fPIC (ops/_build.py).

#include "rasterize_multi.cuh"

extern "C" int sr_rasterize_multi_host(const float* dat, const int* ids, const int* starts,
                                       float* vals, int* wins, int B, int nf, int top,
                                       int n_levels, int tile, int n_attr, int perspective,
                                       float eps) {
  if (B < 1 || top % tile || n_levels < 1 || n_attr < 0 || n_attr > 7) return 1;
  const int R = sr::kRaw + 3 * n_attr;
  const int ntx = top / tile, ntiles = ntx * ntx;
  const int rows = sr::tile_rows(tile, n_levels);
  for (int b = 0; b < B; ++b) {
    const float* dat_b = dat + (long long)b * nf * R;
    const int* ids_b = ids + (long long)b * nf;
    for (int t = 0; t < ntiles; ++t) {
      const int tx = t % ntx, ty = t / ntx;
      int lo[sr::kSegments], hi[sr::kSegments];
      sr::tile_segments(starts + (long long)b * (sr::kTiers * ntiles + 1), ntx, tx, ty, lo, hi);
      for (int r = 0; r < rows; ++r) {
        int X, Y;
        bool live;
        const int k = sr::row_pixel(r, top, tile, n_levels, tx, ty, X, Y, live);
        if (k < 0 || !live) continue;
        float best = -INFINITY, val[7] = {0, 0, 0, 0, 0, 0, 0};
        int bid = sr::kNoWinner;
        for (int sg = 0; sg < sr::kSegments; ++sg) {
          for (int p = lo[sg]; p < hi[sg]; ++p) {
            const float* raw = dat_b + (long long)p * R;
            sr::LevelSetup S;
            const float wl = (float)(top >> k);
            sr::level_setup(raw, k, wl, wl, eps, S);
            float depth, co[3];
            if (sr::level_pixel(S, raw, (float)X, (float)Y, perspective != 0, eps, depth, co) &&
                sr::beats(depth, ids_b[p], best, bid)) {
              best = depth;
              bid = ids_b[p];
              for (int c = 0; c < n_attr; ++c)
                val[c] = sr::interp(co, raw[sr::kRaw + c], raw[sr::kRaw + n_attr + c],
                                    raw[sr::kRaw + 2 * n_attr + c]);
            }
          }
        }
        const int s = top >> k;
        const long long pix = sr::level_pixels_before(top, k) * B + ((long long)b * s + Y) * s + X;
        const bool hit = bid != sr::kNoWinner;
        wins[pix] = hit ? bid : -1;
        for (int c = 0; c < n_attr; ++c) vals[pix * n_attr + c] = hit ? val[c] : 0.0f;
      }
    }
  }
  return 0;
}

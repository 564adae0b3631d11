// Host build of the single-level tile rasterizer and its binning: the same
// per-triangle binning (bin_single.cuh), worklists and pair schedule
// (rasterize_single.cuh), per-candidate clip and math (rasterize_multi.cuh)
// as rasterize_single.cu, run by plain loops. The binning counts in
// triangle order, so each segment is in ascending id order. The rasterizer
// runs each tile's candidates in the kernel's rounds, interleaved over its
// warps; for each warp it sets up the lanes' candidates into slots, scans
// their clip areas and walks the warp's (candidate, pixel) pairs through
// sr::pair_lane and sr::pair_pixel, as the card's lanes share them, into
// the tile's z-buffer of depth keys (a plain max where the card's threads
// take atomicMax); then it writes the winners. The CPU tests hold it bit
// for bit against the torch oracle, so FMA, division and pair-mapping
// faults in the shared code show up without a card. Build with g++ -O2
// -ffp-contract=off -shared -fPIC (ops/_build.py).

#include <vector>

#include "bin_single.cuh"
#include "rasterize_single.cuh"

// The card's three binning passes in one: keys [B, nf], starts [B, K+1]
// and rows [B, nf, 12] (rows past starts[b][K] are not written).
extern "C" int sr_bin_single_host(const float* v, const long long* tri, int* keys, int* starts,
                                  float* rows, int B, int nv, int nf, int h, int w, int tile,
                                  int perspective, float eps) {
  if (B < 1 || nv < 1 || nf < 0 || h < 1 || w < 1 || tile < 1 || tile > 32) return 1;
  const int K = sr::kSingleTiers * sr::single_tiles(w, tile) * sr::single_tiles(h, tile);
  const int RP = sr::row_words(0);
  std::vector<int> rank((size_t)nf);
  for (int b = 0; b < B; ++b) {
    const float* vb = v + (size_t)b * nv * 3;
    std::vector<int> count(K, 0);
    for (int f = 0; f < nf; ++f) {
      float px[3], py[3], z[3];
      const bool ok = sr::project_tri(vb, nv, tri + 3 * (size_t)f, w, h, perspective != 0, eps,
                                      px, py, z);
      const int key = sr::bin_key_single(px, py, ok, w, h, tile, eps);
      keys[(size_t)b * nf + f] = key;
      if (key < K) rank[f] = count[key]++;
    }
    int* st = starts + (size_t)b * (K + 1);
    st[0] = 0;
    for (int i = 0; i < K; ++i) st[i + 1] = st[i] + count[i];
    for (int f = 0; f < nf; ++f) {
      const int key = keys[(size_t)b * nf + f];
      if (key >= K) continue;
      float px[3], py[3], z[3];
      sr::project_tri(vb, nv, tri + 3 * (size_t)f, w, h, perspective != 0, eps, px, py, z);
      sr::bin_row(px, py, z, nullptr, tri + 3 * (size_t)f, nv, 0, f,
                  rows + ((size_t)b * nf + st[key] + rank[f]) * RP);
    }
  }
  return 0;
}

// The rasterizer with rounds of `round` candidates (0: the card's block for
// this tile, sr::single_threads; below 32, one partial warp). Returns 0, or
// 1 when the arguments are refused.
extern "C" int sr_rasterize_single_host(const float* rows, const int* starts, int* wins, int B,
                                        int nf, int h, int w, int tile, int round,
                                        int perspective, float eps) {
  if (round == 0) round = sr::single_threads(tile);
  if (B < 1 || h < 1 || w < 1 || tile < 1 || tile > 32 || round < 1 ||
      (round > 32 && round % 32))
    return 1;
  const int RP = sr::row_words(0);
  const int ntx = sr::single_tiles(w, tile), ntiles = ntx * sr::single_tiles(h, tile);
  const int lanes = round < 32 ? round : 32, nwarps = round / lanes;
  const bool persp = perspective != 0;
  std::vector<unsigned long long> key((size_t)tile * tile);
  sr::PairSlot slots[32];
  int ends[32];
  auto emit = [&](int r, unsigned long long k) { key[r] = k > key[r] ? k : key[r]; };
  for (int b = 0; b < B; ++b) {
    const float* rows_b = rows + (size_t)b * nf * RP;
    for (int tl = 0; tl < ntiles; ++tl) {
      const int tx = tl % ntx, ty = tl / ntx;
      const sr::LevelTile T = sr::single_tile(w, h, tile, tx, ty);
      for (auto& x : key) x = 0;
      int lo[sr::kSingleSegments], hi[sr::kSingleSegments];
      sr::single_tile_segments(starts + (size_t)b * (sr::kSingleTiers * ntiles + 1), ntx, ntiles,
                               tx, ty, lo, hi);
      const int total = sr::segment_total<sr::kSingleSegments>(lo, hi);
      for (int q0 = 0; q0 < total; q0 += round)
        for (int warp = 0; warp < nwarps; ++warp) {
          int end = 0;  // the inclusive scan of the lanes' clip areas
          for (int lane = 0; lane < 32; ++lane) {
            const int q = q0 + lane * nwarps + warp;
            if (lane < lanes && q < total) {
              const float* t =
                  rows_b + (size_t)sr::segment_pos<sr::kSingleSegments>(q, lo, hi) * RP;
              end += sr::pair_setup(t, sr::f2i(t[sr::kRaw]), w, h, T, eps, slots[lane]);
            }
            ends[lane] = end;
          }
          for (int j = 0; j < end; ++j) {
            const int o = sr::pair_lane(ends, j);
            int x, y;
            sr::pair_pixel(ends, slots[o], o, j, x, y);
            sr::test_pixel(slots[o].S, slots[o].z, slots[o].id, x, y, T, persp, eps, emit);
          }
        }
      for (int r = 0; r < tile * tile; ++r) {
        const int X = T.x0 + r % tile, Y = T.y0 + r / tile;
        if (X > T.x1 || Y > T.y1) continue;
        wins[((size_t)b * h + Y) * w + X] = sr::key_winner(key[r]);
      }
    }
  }
  return 0;
}

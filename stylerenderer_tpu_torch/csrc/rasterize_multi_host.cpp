// Host build of the multi-level pyramid rasterizer and its binning: the same
// per-triangle binning (bin_multi.cuh), per-candidate math and per-tile
// schedule (rasterize_multi.cuh) as rasterize_multi.cu, run by plain loops.
// The binning counts in triangle order, so each segment is in ascending id
// order; the rasterizer runs each tile's candidates in the kernel's rounds,
// its threads in turn: the top level in place, the coarse clips to a queue
// that is worked through when it might not take another round (any round
// and queue size), all into the tile's z-buffer of depth keys (a plain max
// where the card's threads take atomicMax); then it writes the winners and
// their values. The CPU tests hold it bit for bit against the torch oracle,
// so FMA and division faults in the shared code show up without a card.
// Build with g++ -O2 -ffp-contract=off -shared -fPIC (ops/_build.py).

#include <vector>

#include "bin_multi.cuh"
#include "rasterize_multi.cuh"

// The card's three binning passes in one, for the band [ty0, ty0 + nty) of
// tile rows: keys [B, nf], starts [B, K+1], rows [B, nf, row_words(C)] and
// slots [B, nf] (rows past starts[b][K] and invalid triangles' slots are
// not written).
extern "C" int sr_bin_multi_host(const float* v, const long long* tri, const float* attrs,
                                 int* keys, int* starts, float* rows, int* slots, int B, int nv,
                                 int nf, int top, int n_levels, int tile, int n_attr,
                                 int perspective, int ty0, int nty, float eps) {
  if (B < 1 || nv < 1 || nf < 0 || tile < 1 || top % tile || n_levels < 1 ||
      n_levels > sr::kMaxLevels || n_attr < 0 || n_attr > 7 ||
      !sr::band_ok(top, n_levels, tile, ty0, nty))
    return 1;
  const int ntx = top / tile, K = sr::kTiers * ntx * ntx, RP = sr::row_words(n_attr);
  std::vector<int> rank((size_t)nf);
  for (int b = 0; b < B; ++b) {
    const float* vb = v + (size_t)b * nv * 3;
    std::vector<int> count(K, 0);
    for (int f = 0; f < nf; ++f) {
      float px[3], py[3], z[3];
      const bool ok = sr::project_tri(vb, nv, tri + 3 * (size_t)f, top, top, perspective != 0,
                                      eps, px, py, z);
      const int key = sr::bin_key(px, py, ok, top, n_levels, tile, eps, ty0, ty0 + nty);
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
      sr::project_tri(vb, nv, tri + 3 * (size_t)f, top, top, perspective != 0, eps, px, py, z);
      const int slot = st[key] + rank[f];
      slots[(size_t)b * nf + f] = slot;
      sr::bin_row(px, py, z, attrs ? attrs + (size_t)b * nv * n_attr : nullptr,
                  tri + 3 * (size_t)f, nv, n_attr, f, rows + ((size_t)b * nf + slot) * RP);
    }
  }
  return 0;
}

// The rasterizer over the tiles of the band [ty0, ty0 + nty), with rounds of
// `round` candidates and a queue of `queue` items (0: the card's, sr::kRound
// and sr::kQueue). Returns how many times, over the band's tiles, a full
// queue was worked through between rounds (>= 0), or -1 when the arguments
// are refused.
extern "C" int sr_rasterize_multi_host(const float* rows, const int* starts, const int* slots,
                                       float* vals, int* wins, int B, int nf, int top,
                                       int n_levels, int tile, int n_attr, int perspective,
                                       int ty0, int nty, float eps, int round, int queue) {
  if (round == 0) round = sr::kRound;
  if (queue == 0) queue = sr::kQueue;
  if (B < 1 || tile < 1 || top % tile || n_levels < 1 || n_levels > sr::kMaxLevels ||
      n_attr < 0 || n_attr > 7 || round < 1 || queue < round * (n_levels - 1) ||
      !sr::band_ok(top, n_levels, tile, ty0, nty))
    return -1;
  const int RP = sr::row_words(n_attr), R = sr::kRaw + 3 * n_attr;
  const int ntx = top / tile, ntiles = ntx * ntx, nrows = sr::tile_rows(tile, n_levels);
  std::vector<unsigned long long> key(nrows);
  std::vector<sr::LevelTile> lt(n_levels);
  std::vector<int> items((size_t)queue);
  int flushes = 0;
  for (int b = 0; b < B; ++b) {
    const float* rows_b = rows + (size_t)b * nf * RP;
    auto emit = [&](int r, unsigned long long k) { key[r] = k > key[r] ? k : key[r]; };
    for (int tl = 0; tl < ntx * nty; ++tl) {
      const int tx = tl % ntx, ty = ty0 + tl / ntx;
      for (int k = 0; k < n_levels; ++k) sr::level_tile(top, top, tile, n_levels, k, tx, ty, lt[k]);
      for (auto& x : key) x = 0;
      int lo[sr::kSegments], hi[sr::kSegments];
      sr::tile_segments(starts + (size_t)b * (sr::kTiers * ntiles + 1), ntx, tx, ty, lo, hi);
      const int total = sr::segment_total<sr::kSegments>(lo, hi);
      int qn = 0;
      auto run_queue = [&]() {
        for (int i = 0; i < qn; ++i) {
          const int k = items[i] & 15;
          const float* t = rows_b + (size_t)(items[i] >> 4) * RP;
          float p[6];
          sr::LevelSetup S;
          int clip[4];
          if (sr::level_clip(t, k, top, top, lt[k], p, S, clip))
            sr::clip_scan(t, sr::f2i(t[R]), p, clip, lt[k], S, perspective != 0, eps, emit);
        }
        qn = 0;
      };
      for (int q0 = 0; q0 < total; q0 += round) {
        for (int q = q0; q < total && q < q0 + round; ++q) {
          const int pos = sr::segment_pos<sr::kSegments>(q, lo, hi);
          const float* t = rows_b + (size_t)pos * RP;
          float p[6];
          sr::LevelSetup S;
          int clip[4];
          if (sr::level_clip(t, 0, top, top, lt[0], p, S, clip))
            sr::clip_scan(t, sr::f2i(t[R]), p, clip, lt[0], S, perspective != 0, eps, emit);
          for (int k = 1; k < n_levels; ++k)
            if (sr::level_clip(t, k, top, top, lt[k], p, S, clip)) items[qn++] = pos << 4 | k;
        }
        if (sr::queue_full(qn, queue, round, n_levels)) {
          run_queue();
          ++flushes;
        }
      }
      run_queue();
      for (int r = 0; r < nrows; ++r) {
        int X, Y;
        bool live;
        const int k = sr::row_pixel(r, top, tile, n_levels, tx, ty, X, Y, live);
        if (!live) continue;
        const int s = top >> k;
        const long long pix = sr::band_pixel(top, tile, ty0, nty, B, b, k, X, Y);
        const int id = sr::key_winner(key[r]);
        wins[pix] = id;
        float v[7];
        if (id >= 0 && n_attr > 0)
          sr::winner_values(rows_b + (size_t)slots[(size_t)b * nf + id] * RP, k, (float)s, X, Y,
                            perspective != 0, eps, n_attr, v);
        for (int a = 0; a < n_attr; ++a) vals[pix * n_attr + a] = id >= 0 ? v[a] : 0.0f;
      }
    }
  }
  return flushes;
}

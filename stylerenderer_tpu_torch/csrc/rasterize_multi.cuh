// Per-candidate math and per-tile logic (worklists, each candidate's bbox
// clipped to the tile per level, the z-test key, the winner's values) of
// the multi-level pyramid rasterizer, shared by the Hopper kernel
// (rasterize_multi.cu) and its host build (rasterize_multi_host.cpp), which
// runs the kernel's per-tile schedule (queue_full) with its threads in
// turn, so the CPU tests check the card's math and its schedule (but not
// its concurrency: atomics, warp votes, barriers). The single-level kernel
// (rasterize_single.cu and its host build) uses the same candidate math at
// level 0.
//
// Every expression mirrors stylerenderer_tpu/ops/rasterize_pallas.py
// (_level_setup :186, _level_pixels :265, _kernel_depth :162) and the dense
// oracle (ops/rasterize.py::_eval_candidate) term for term, in the same
// association order, so that winners and values are bit-equal to the oracle.
// Two rounding traps are handled by the build, not by this source:
//
//   FMA contraction. nvcc contracts a*b+c into one fused multiply-add by
//   default, and g++ may too. Every product-then-sum below (the per-level
//   rescale px*invf + sh, the adjugate products, a0 + b0*X + c0*Y, the
//   depth sum and the interpolation (c0*a0 + c1*a1) + c2*a2) must round
//   twice, as in the oracle. Hence nvcc --fmad=false and g++
//   -ffp-contract=off (ops/_build.py); never --use_fast_math.
//
//   Division. 1/s_safe, lj/lsum_safe and the perspective 1/z need IEEE
//   division: nvcc's default -prec-div=true, again no fast math.

#pragma once

#include <climits>
#include <cmath>
#include <cstring>

#ifdef __CUDACC__
#define SR_HD __host__ __device__ __forceinline__
#else
#define SR_HD inline
#endif

namespace sr {

constexpr int kSegments = 6;  // tier-0 home, 2 tier-1 rows, 2 degenerate rows, XL
constexpr int kTiers = 4;     // span-1, span-2, degenerate (span <= 2), XL
constexpr int kRaw = 9;       // px0..2, py0..2, z0..2 ahead of the attributes
constexpr int kZ = 6;         // where z0..2 start in a raw row
constexpr int kNoWinner = INT_MAX;
constexpr int kMaxLevels = 11;  // pyramid levels the multi-level kernel takes

// flag bits of LevelSetup::flags
constexpr int kCanCover = 1;  // front-facing and a non-empty clamped bbox
constexpr int kNondeg = 2;    // |det| > eps
constexpr int kSeg = 4;       // degenerate: the longest edge is a segment

// One triangle's setup at one pyramid level (rasterize_pallas.py:186-262).
struct LevelSetup {
  float x0, x1, y0, y1;  // clamped integer bbox at this level
  float a0, a1, a2, b0, b1, b2, c0, c1, c2;
  float b_i, c_i, px_i, py_i, px_j, py_j, px_k, py_k;  // degenerate fallback
  int flags;
  int i_idx;  // vertex index of the longest-edge pick (degenerate fallback)
};

SR_HD float fmin_(float a, float b) { return a < b ? a : b; }
SR_HD float fmax_(float a, float b) { return a > b ? a : b; }
SR_HD float clip_(float x) { return fmin_(fmax_(x, -1.0f), 2.0f); }
// the longest-edge pick of rasterize_pallas.py:251 (m0: vertex 0, m1: vertex 1)
SR_HD float pick3(bool m0, bool m1, float v0, float v1, float v2) {
  return m0 ? v0 : (m1 ? v1 : v2);
}

// t: the 9 raw floats of one triangle at the TOP level -> its corners p
// (px0..2, py0..2) at level k: px_l = px*2^-k + (2^-k*0.5 - 0.5). The top
// level skips the rescale, so its expression stream is exactly the dense
// oracle's.
SR_HD void level_corners(const float* t, int k, float p[6]) {
  for (int i = 0; i < 6; ++i) p[i] = t[i];
  if (k > 0) {
    const float invf = 1.0f / (float)(1 << k);
    const float sh = invf * 0.5f - 0.5f;
    // FMA trap: px*invf + sh must round the product, then the sum
    for (int i = 0; i < 6; ++i) p[i] = p[i] * invf + sh;
  }
}

// The clamped integer bbox of corners p in a wl x hl image.
SR_HD void level_bbox(const float p[6], float wl, float hl, LevelSetup& S) {
  const float umin = fmin_(fmin_(p[0], p[1]), p[2]), umax = fmax_(fmax_(p[0], p[1]), p[2]);
  const float vmin = fmin_(fmin_(p[3], p[4]), p[5]), vmax = fmax_(fmax_(p[3], p[4]), p[5]);
  S.x0 = fmax_(ceilf(umin), 0.0f);
  S.x1 = fmin_(floorf(umax), wl - 1.0f);
  S.y0 = fmax_(ceilf(vmin), 0.0f);
  S.y1 = fmin_(floorf(vmax), hl - 1.0f);
}

// The rest of the setup, after level_bbox has filled S.x0..S.y1.
SR_HD void level_coeffs(const float p[6], float eps, LevelSetup& S) {
  const float px0 = p[0], px1 = p[1], px2 = p[2];
  const float py0 = p[3], py1 = p[4], py2 = p[5];
  // FMA trap: the adjugate products round before the difference
  float a0 = px1 * py2 - py1 * px2;
  float a1 = py0 * px2 - px0 * py2;
  float a2 = px0 * py1 - py0 * px1;
  const float det = a0 + a1 + a2;
  const bool front = det <= eps;
  const float sign = det < 0.0f ? -1.0f : 1.0f;
  const float det_pos = det * sign;
  const float b0 = (py1 - py2) * sign, b1 = (py2 - py0) * sign, b2 = (py0 - py1) * sign;
  const float c0 = (px2 - px1) * sign, c1 = (px0 - px2) * sign, c2 = (px1 - px0) * sign;
  a0 = a0 * sign;
  a1 = a1 * sign;
  a2 = a2 * sign;
  const bool bbox_ok = (S.x1 >= S.x0) && (S.y1 >= S.y0);
  S.a0 = a0; S.a1 = a1; S.a2 = a2;
  S.b0 = b0; S.b1 = b1; S.b2 = b2;
  S.c0 = c0; S.c1 = c1; S.c2 = c2;

  // degenerate fallback: the longest edge i (rasterize.py:155-160)
  const float l0 = b0 * b0 + c0 * c0;
  const float l1 = b1 * b1 + c1 * c1;
  const float l2 = b2 * b2 + c2 * c2;
  const bool m0 = (l0 > l1) && (l0 > l2);
  const bool m1 = !(l0 > l1) && (l1 > l2);
  S.i_idx = m0 ? 0 : (m1 ? 1 : 2);
  S.b_i = pick3(m0, m1, b0, b1, b2);
  S.c_i = pick3(m0, m1, c0, c1, c2);
  S.px_i = pick3(m0, m1, px0, px1, px2);
  S.py_i = pick3(m0, m1, py0, py1, py2);
  S.px_j = pick3(m0, m1, px1, px2, px0);
  S.py_j = pick3(m0, m1, py1, py2, py0);
  S.px_k = pick3(m0, m1, px2, px0, px1);
  S.py_k = pick3(m0, m1, py2, py0, py1);
  S.flags = ((front && bbox_ok) ? kCanCover : 0) | ((det_pos > eps) ? kNondeg : 0) |
            ((pick3(m0, m1, l0, l1, l2) > eps) ? kSeg : 0);
}

// One triangle's setup at level k of a wl x hl image (the pyramid passes its
// square size twice).
SR_HD void level_setup(const float* t, int k, float wl, float hl, float eps,
                       LevelSetup& S) {
  float p[6];
  level_corners(t, k, p);
  level_bbox(p, wl, hl, S);
  level_coeffs(p, eps, S);
}

// Candidate at pixel (X, Y) of the setup's level; z holds the triangle's
// three top-level depths (a raw row's t + kZ). Returns coverage; on coverage
// writes the depth and the final interpolation coefficients
// (rasterize_pallas.py:265-331 and :162-183). Every early return is a false
// conjunct of the oracle's `cov`.
SR_HD bool level_pixel(const LevelSetup& S, const float* z, float X, float Y,
                       bool perspective, float eps, float& depth, float co[3]) {
  if (!(S.flags & kCanCover)) return false;
  if (!((X >= S.x0) && (X <= S.x1) && (Y >= S.y0) && (Y <= S.y1))) return false;
  // FMA trap: (a0 + b0*X) + c0*Y with every product rounded
  const float r0 = S.a0 + S.b0 * X + S.c0 * Y;
  const float r1 = S.a1 + S.b1 * X + S.c1 * Y;
  const float r2 = S.a2 + S.b2 * X + S.c2 * Y;
  if (!((r0 >= -eps) && (r1 >= -eps) && (r2 >= -eps))) return false;
  if (S.flags & kNondeg) {
    const float s = r0 + r1 + r2;
    const float s_safe = fabsf(s) > 1e-30f ? s : 1.0f;
    const float s_inv = 1.0f / s_safe;  // division trap: IEEE reciprocal
    co[0] = clip_(r0 * s_inv);
    co[1] = clip_(r1 * s_inv);
    co[2] = clip_(r2 * s_inv);
  } else {
    // selects, not co[i] = ..., so co stays in registers on the card
    const int i = S.i_idx, j = (i + 1) % 3;
    if (S.flags & kSeg) {
      const float lj = -(X - S.px_k) * S.c_i + (Y - S.py_k) * S.b_i;
      const float lk = (X - S.px_j) * S.c_i - (Y - S.py_j) * S.b_i;
      const float lsum = lj + lk;
      const float lsum_safe = fabsf(lsum) > 1e-30f ? lsum : 1.0f;
      const float cj = clip_(lj / lsum_safe);  // division trap: IEEE division
      const float ck = clip_(lk / lsum_safe);
      if (!((cj >= -eps) && (ck >= -eps))) return false;
      co[0] = i == 0 ? 0.0f : (j == 0 ? cj : ck);
      co[1] = i == 1 ? 0.0f : (j == 1 ? cj : ck);
      co[2] = i == 2 ? 0.0f : (j == 2 ? cj : ck);
    } else {
      const float dx = X - S.px_i, dy = Y - S.py_i;
      if (!(dx * dx + dy * dy < eps)) return false;
      co[0] = i == 0 ? 1.0f : 0.0f;
      co[1] = i == 1 ? 1.0f : 0.0f;
      co[2] = i == 2 ? 1.0f : 0.0f;
    }
  }
  const float z0 = z[0], z1 = z[1], z2 = z[2];
  if (perspective) {
    const float z0s = z0 < -eps ? z0 : -1.0f;
    const float z1s = z1 < -eps ? z1 : -1.0f;
    const float z2s = z2 < -eps ? z2 : -1.0f;
    // division trap: a reciprocal, then a multiply (not co / z)
    const float q0 = co[0] * (1.0f / z0s);
    const float q1 = co[1] * (1.0f / z1s);
    const float q2 = co[2] * (1.0f / z2s);
    depth = q0 + q1 + q2;
    if (!(depth < -eps)) return false;
    co[0] = q0 * depth;
    co[1] = q1 * depth;
    co[2] = q2 * depth;
  } else {
    depth = co[0] * z0 + co[1] * z1 + co[2] * z2;  // FMA trap
  }
  return true;
}

// The winner's value, (c0*a0 + c1*a1) + c2*a2 as in _interp_from_win.
SR_HD float interp(const float co[3], float a0, float a1, float a2) {
  return co[0] * a0 + co[1] * a1 + co[2] * a2;  // FMA trap
}

// Pixel rows of one tile: the dense levels (tile >> k)^2 rows each, then one
// row per sparse level (a level whose pixels are larger than a tile).
SR_HD int tile_rows(int tile, int n_levels) {
  int n = 0;
  for (int k = 0; k < n_levels; ++k) {
    const int tl = tile >> k;
    n += tl ? tl * tl : 1;
  }
  return n;
}

// Row r of tile (tx, ty) -> its level, and the pixel it evaluates at that
// level. live is false for a sparse row whose pixel this tile does not own:
// a sparse pixel is evaluated by exactly one tile, the one that holds its
// center (rasterize_pallas.py:543 _sparse_sp), and no other tile writes it.
// Returns -1 for rows past the last level.
SR_HD int row_pixel(int r, int top, int tile, int n_levels, int tx, int ty,
                    int& X, int& Y, bool& live) {
  int off = 0;
  for (int k = 0; k < n_levels; ++k) {
    const int tl = tile >> k;
    if (tl) {
      if (r < off + tl * tl) {
        const int p = r - off;
        X = tx * tl + p % tl;
        Y = ty * tl + p / tl;
        live = true;
        return k;
      }
      off += tl * tl;
    } else {
      if (r == off) {
        const int step = 1 << k;  // top / wl
        const int S = step / tile, phase = (step / 2 - 1) / tile;
        live = tx >= phase && ty >= phase && (tx - phase) % S == 0 &&
               (ty - phase) % S == 0;
        X = (tx - phase) / S;
        Y = (ty - phase) / S;
        return k;
      }
      off += 1;
    }
  }
  live = false;
  return -1;
}

// The tile's worklist: contiguous segments of the sorted triangle array
// (rasterize_pallas.py:967-988). Tier 0 (span 1): the own home; tiers 1 and
// 2 (span 2, fast and degenerate): the homes of the 2x2 neighbourhood up
// and left, one segment per home row; XL: the global segment.
SR_HD void tile_segments(const int* starts_b, int ntx, int tx, int ty, int lo[kSegments],
                         int hi[kSegments]) {
  const int ntiles = ntx * ntx;
  int n = 0;
  const int spans[3] = {1, 2, 2};
  for (int tier = 0; tier < 3; ++tier) {
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
  lo[n] = starts_b[(kTiers - 1) * ntiles];
  hi[n] = starts_b[kTiers * ntiles];
}

// ---- the redesigned kernel's per-tile logic (rasterize_multi.cu) --------

// Words of one binned row (ops/rasterize_multi.py::launch_bin_multi): the 9
// raw floats, the 3C corner attributes, the triangle id's bits, padded to a
// multiple of 16 bytes so that a row is whole 16-byte loads.
SR_HD constexpr int row_words(int n_attr) { return (kRaw + 3 * n_attr + 1 + 3) / 4 * 4; }

SR_HD int f2i(float f) {
#ifdef __CUDA_ARCH__
  return __float_as_int(f);
#else
  int i;
  std::memcpy(&i, &f, sizeof i);
  return i;
#endif
}

SR_HD float i2f(int i) {
#ifdef __CUDA_ARCH__
  return __int_as_float(i);
#else
  float f;
  std::memcpy(&f, &i, sizeof f);
  return f;
#endif
}

// One level's pixels in one tile: an inclusive rectangle (empty when
// x0 > x1) and the tile rows they are: pixel (x, y) is row
// off + (y - y0) * stride + (x - x0) (row_pixel's numbering).
struct LevelTile {
  int x0, x1, y0, y1, off, stride;
};

// Tile (tx, ty) at level k of a w x h image (sparse levels: square images
// only). A dense level's rectangle is clipped to the image, since the
// single-level kernel's tile grid rounds up and its edge tiles stick out.
SR_HD void level_tile(int w, int h, int tile, int n_levels, int k, int tx, int ty,
                      LevelTile& T) {
  const int tl = tile >> k;
  T.off = tile_rows(tile, k);
  if (tl) {
    T.x0 = tx * tl;
    T.y0 = ty * tl;
    const int xe = T.x0 + tl - 1, ye = T.y0 + tl - 1;
    const int xm = (w >> k) - 1, ym = (h >> k) - 1;
    T.x1 = xe < xm ? xe : xm;
    T.y1 = ye < ym ? ye : ym;
    T.stride = tl;
  } else {  // a sparse level: the one pixel this tile owns, if any
    int X = 0, Y = 0;
    bool live;
    row_pixel(T.off, w, tile, n_levels, tx, ty, X, Y, live);
    T.x0 = T.x1 = X;
    T.y0 = T.y1 = Y;
    if (!live) T.x1 = X - 1;
    T.stride = 1;
  }
}

// A covered candidate whose depth is NaN blanks its pixel at that level,
// whatever the other candidates are: the JAX Pallas kernels' running max
// turns NaN there for good (rasterize_pallas.py:412-423, :1017-1093). Its
// key is above every depth key (the highest of those, +inf at id 0, is
// 0xff800000ffffffff), so atomicMax keeps it, and it decodes to background.
constexpr unsigned long long kPoisonKey = ~0ull;

// The z-test as one 64-bit integer: a larger key wins. The high word orders
// the depth (-0 and +0 are one depth); the low word is the inverted id, so
// equal depths go to the lowest id. A NaN depth gets kPoisonKey. Only
// depths that can win or poison (not -inf) get a key, and every such key
// is above 0, which marks background.
SR_HD unsigned long long depth_key(float depth, int id) {
  if (depth != depth) return kPoisonKey;
  const float d = depth == 0.0f ? 0.0f : depth;
  unsigned u = (unsigned)f2i(d);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)u << 32) | (0xffffffffu - (unsigned)id);
}

// A pixel's key -> its winner, -1 for background (no key, or poisoned).
SR_HD int key_winner(unsigned long long key) {
  return key == 0ull || key == kPoisonKey ? -1 : (int)(0xffffffffu - (unsigned)key);
}

// Candidate t (its raw row) at level k of a w x h image against the tile's
// pixels there: the level corners p, the clamped bbox in S, and that bbox
// clipped to the tile's pixels (integers held in f32, clipped before the
// conversion to int); false when the clip is empty.
SR_HD bool level_clip(const float* t, int k, int w, int h, const LevelTile& T, float p[6],
                      LevelSetup& S, int clip[4]) {
  if (T.x0 > T.x1) return false;
  level_corners(t, k, p);
  level_bbox(p, (float)(w >> k), (float)(h >> k), S);
  const float fx0 = fmax_(S.x0, (float)T.x0), fx1 = fmin_(S.x1, (float)T.x1);
  const float fy0 = fmax_(S.y0, (float)T.y0), fy1 = fmin_(S.y1, (float)T.y1);
  if (!(fx0 <= fx1 && fy0 <= fy1)) return false;
  clip[0] = (int)fx0;
  clip[1] = (int)fx1;
  clip[2] = (int)fy0;
  clip[3] = (int)fy1;
  return true;
}

// The exact test (level_pixel) of a set-up candidate with depths z at pixel
// (x, y) of the tile: a covered pixel with a depth that can win, or a NaN
// depth, gets emit(tile row, depth_key); -inf never enters (the dense
// oracle starts its z-buffer at -inf with a strict compare).
template <class Emit>
SR_HD void test_pixel(const LevelSetup& S, const float* z, int id, int x, int y,
                      const LevelTile& T, bool perspective, float eps, Emit&& emit) {
  float depth, co[3];
  if (level_pixel(S, z, (float)x, (float)y, perspective, eps, depth, co) && depth != -INFINITY)
    emit(T.off + (y - T.y0) * T.stride + (x - T.x0), depth_key(depth, id));
}

// After level_clip: the rest of the setup, then the exact test on every
// pixel of the clip.
template <class Emit>
SR_HD void clip_scan(const float* t, int id, const float p[6], const int clip[4],
                     const LevelTile& T, LevelSetup& S, bool perspective, float eps,
                     Emit&& emit) {
  level_coeffs(p, eps, S);
  if (!(S.flags & kCanCover)) return;
  for (int y = clip[2]; y <= clip[3]; ++y)
    for (int x = clip[0]; x <= clip[1]; ++x)
      test_pixel(S, t + kZ, id, x, y, T, perspective, eps, emit);
}

// The kernel's per-tile schedule: rounds of kRound candidates, one per
// thread; each does its top level in place and pushes its non-empty coarse
// clips, (sorted position << 4 | level), to a queue of kQueue items. After
// a round, a queue that might not take another round's pushes (at most
// kRound * (n_levels - 1)) is worked through and emptied; the rest after
// the last round. The host build runs this schedule with any round and
// queue size, so the CPU tests reach the flush at small sizes.
constexpr int kRound = 256;
constexpr int kQueue = 4096;
static_assert(kQueue >= kRound * (kMaxLevels - 1), "a round's pushes must fit the queue");

SR_HD bool queue_full(int qn, int queue, int round, int n_levels) {
  return qn > queue - round * (n_levels - 1);
}

// The winner's values at pixel (X, Y) of level k: its coefficients
// recomputed by the same code, then (c0*a0 + c1*a1) + c2*a2 per channel.
SR_HD void winner_values(const float* t, int k, float wl, int X, int Y, bool perspective,
                         float eps, int n_attr, float* out) {
  LevelSetup S;
  level_setup(t, k, wl, wl, eps, S);
  float depth, co[3];
  level_pixel(S, t + kZ, (float)X, (float)Y, perspective, eps, depth, co);
  for (int a = 0; a < n_attr; ++a)
    out[a] = interp(co, t[kRaw + a], t[kRaw + n_attr + a], t[kRaw + 2 * n_attr + a]);
}

// Candidates of a tile's N segments as one flat range: the number, and the
// sorted position of the q-th.
template <int N>
SR_HD int segment_total(const int lo[N], const int hi[N]) {
  int n = 0;
  for (int sg = 0; sg < N; ++sg) n += hi[sg] > lo[sg] ? hi[sg] - lo[sg] : 0;
  return n;
}

template <int N>
SR_HD int segment_pos(int q, const int lo[N], const int hi[N]) {
  for (int sg = 0; sg < N; ++sg) {
    const int n = hi[sg] > lo[sg] ? hi[sg] - lo[sg] : 0;
    if (q < n) return lo[sg] + q;
    q -= n;
  }
  return -1;
}

// A band of top-level tile rows [ty0, ty0 + nty) that is whole rows at every
// level: level k renders its rows [ty0 * tile >> k, (ty0 + nty) * tile >> k).
// The full image is the band (0, top / tile).
SR_HD bool band_ok(int top, int n_levels, int tile, int ty0, int nty) {
  if (ty0 < 0 || nty < 1 || ty0 + nty > top / tile) return false;
  for (int k = 0; k < n_levels; ++k)
    if ((ty0 * tile) % (1 << k) || (nty * tile) % (1 << k)) return false;
  return true;
}

// Offset, in pixels per batch item, of level k in the level-major output of
// a band `rows` top-level pixel rows high (top for the whole image).
SR_HD long long level_pixels_before(int top, int rows, int k) {
  long long n = 0;
  for (int j = 0; j < k; ++j) n += (long long)(top >> j) * (rows >> j);
  return n;
}

// Where pixel (X, Y) of level k (Y a row of the level's whole image, inside
// the band) of batch item b goes in the level-major output of the band
// [ty0, ty0 + nty): level k holds [B, (nty * tile) >> k, top >> k].
SR_HD long long band_pixel(int top, int tile, int ty0, int nty, int B, int b, int k, int X,
                           int Y) {
  const int rows = nty * tile, s = top >> k;
  const int hk = rows >> k, yk = (ty0 * tile) >> k;
  return level_pixels_before(top, rows, k) * B + ((long long)b * hk + (Y - yk)) * s + X;
}

}  // namespace sr

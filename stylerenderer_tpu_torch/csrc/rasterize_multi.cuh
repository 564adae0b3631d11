// Per-candidate math and per-tile bookkeeping of the multi-level pyramid
// rasterizer, shared by the Hopper kernel (rasterize_multi.cu) and its host
// build (rasterize_multi_host.cpp), so the CPU tests check the very code the
// card runs. The single-level kernel (rasterize_single.cu and its host build)
// uses the same candidate math at level 0.
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

#ifdef __CUDACC__
#define SR_HD __host__ __device__ __forceinline__
#else
#define SR_HD inline
#endif

namespace sr {

constexpr int kSegments = 6;  // tier-0 home, 2 tier-1 rows, 2 degenerate rows, XL
constexpr int kTiers = 4;     // span-1, span-2, degenerate (span <= 2), XL
constexpr int kRaw = 9;       // px0..2, py0..2, z0..2 ahead of the attributes
constexpr int kNoWinner = INT_MAX;

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

// t: the 9 raw floats of one triangle at the TOP level. Level k rescales
// px_l = px*2^-k + (2^-k*0.5 - 0.5); the top level skips the rescale, so its
// expression stream is exactly the dense oracle's. wl and hl are the level's
// width and height in pixels (the pyramid passes its square size twice).
SR_HD void level_setup(const float* t, int k, float wl, float hl, float eps,
                       LevelSetup& S) {
  float px0 = t[0], px1 = t[1], px2 = t[2];
  float py0 = t[3], py1 = t[4], py2 = t[5];
  if (k > 0) {
    const float invf = 1.0f / (float)(1 << k);
    const float sh = invf * 0.5f - 0.5f;
    // FMA trap: px*invf + sh must round the product, then the sum
    px0 = px0 * invf + sh;
    px1 = px1 * invf + sh;
    px2 = px2 * invf + sh;
    py0 = py0 * invf + sh;
    py1 = py1 * invf + sh;
    py2 = py2 * invf + sh;
  }
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

  const float umin = fmin_(fmin_(px0, px1), px2), umax = fmax_(fmax_(px0, px1), px2);
  const float vmin = fmin_(fmin_(py0, py1), py2), vmax = fmax_(fmax_(py0, py1), py2);
  S.x0 = fmax_(ceilf(umin), 0.0f);
  S.x1 = fmin_(floorf(umax), wl - 1.0f);
  S.y0 = fmax_(ceilf(vmin), 0.0f);
  S.y1 = fmin_(floorf(vmax), hl - 1.0f);
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

// Candidate at pixel (X, Y) of the setup's level; t holds the triangle's
// top-level z at t[6..8]. Returns coverage; on coverage writes the depth and
// the final interpolation coefficients (rasterize_pallas.py:265-331 and
// :162-183). Every early return is a false conjunct of the oracle's `cov`.
SR_HD bool level_pixel(const LevelSetup& S, const float* t, float X, float Y,
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
  const float z0 = t[6], z1 = t[7], z2 = t[8];
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

// Max depth wins, the lowest id breaks ties; a depth of -inf never wins
// (the dense oracle starts its z-buffer at -inf with a strict compare).
SR_HD bool beats(float depth, int id, float best, int best_id) {
  return depth > best || (depth == best && id < best_id && depth > -INFINITY);
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

// Offset, in pixels per batch item, of level k in the level-major output.
SR_HD long long level_pixels_before(int top, int k) {
  long long n = 0;
  for (int j = 0; j < k; ++j) n += (long long)(top >> j) * (top >> j);
  return n;
}

}  // namespace sr

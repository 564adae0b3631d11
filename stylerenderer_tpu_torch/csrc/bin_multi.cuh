// Per-triangle binning of the multi-level pyramid rasterizer, shared by the
// card's binning passes (rasterize_multi.cu) and their host build
// (rasterize_multi_host.cpp); the single-level binning (bin_single.cuh)
// uses its projection, NaN-propagating min and max and rows.
//
// It makes exactly the decisions of ops/rasterize_multi.py::build_bins_multi
// (after stylerenderer_tpu/ops/rasterize_pallas.py:645): the projection of
// ops/rasterize.py::_project_verts, validity as the union over levels, the
// degenerate test against eps * 4^kmax, the home tile of the float bbox, the
// tile span and the tier. Each torch expression there is one op per kernel
// on the card and rounds on its own, so every expression here is the same
// one in the same association order, built like rasterize_multi.cuh (no FMA
// contraction, IEEE division; no x / s turned into x * (1/s)). Minima,
// maxima and clamps propagate NaN as torch's amin, minimum and clamp do.

#pragma once

#include "rasterize_multi.cuh"

namespace sr {

SR_HD float tmin(float a, float b) { return (a < b || a != a) ? a : b; }
SR_HD float tmax(float a, float b) { return (a > b || a != a) ? a : b; }

// Triangle t3 (three vertex ids) of the vertices vb [nv, 3] of one batch
// item -> its corners px, py, z in a w x h image (the multi-level kernel's
// top level is top x top); returns whether every id is in range and, in
// perspective, every corner lies in front of the camera. Out-of-range ids
// read the clamped vertex.
SR_HD bool project_tri(const float* vb, int nv, const long long* t3, int w, int h,
                       bool perspective, float eps, float px[3], float py[3], float z[3]) {
  bool ok = true;
  const float half_w = (float)w * 0.5f, half_h = (float)h * 0.5f;
  for (int c = 0; c < 3; ++c) {
    const long long i = t3[c];
    ok = ok && i >= 0 && i < nv;
    const long long ci = i < 0 ? 0 : (i >= nv ? nv - 1 : i);
    float x = vb[ci * 3], y = vb[ci * 3 + 1];
    const float zz = vb[ci * 3 + 2];
    if (perspective) {
      const bool front = zz < -eps;
      const float zs = front ? zz : -1.0f;
      x = x / -zs;  // division trap: IEEE division, as torch's tensor / tensor
      y = y / -zs;
      ok = ok && front;
    }
    // FMA trap: (1 + x) * (w / 2) - 0.5 rounds the product, then the sum
    px[c] = (1.0f + x) * half_w - 0.5f;
    py[c] = (1.0f - y) * half_h - 0.5f;
    z[c] = zz;
  }
  return ok;
}

// The sort key tier * ntiles + home of a triangle with top-level corners
// px, py (ok: project_tri's verdict), or kTiers * ntiles when it is invalid.
SR_HD int bin_key(const float px[3], const float py[3], bool ok, int top, int n_levels, int tile,
                  float eps) {
  const int ntx = top / tile, ntiles = ntx * ntx;
  const float umin = tmin(tmin(px[0], px[1]), px[2]), umax = tmax(tmax(px[0], px[1]), px[2]);
  const float vmin = tmin(tmin(py[0], py[1]), py[2]), vmax = tmax(tmax(py[0], py[1]), py[2]);
  bool bbox_any = false;
  for (int k = 0; k < n_levels; ++k) {
    const float inv = 1.0f / (float)(1 << k), wl = (float)(top >> k);
    // FMA trap: (u + 0.5) * inv - 0.5 rounds the product, then the sum
    const float u0 = (umin + 0.5f) * inv - 0.5f, u1 = (umax + 0.5f) * inv - 0.5f;
    const float v0 = (vmin + 0.5f) * inv - 0.5f, v1 = (vmax + 0.5f) * inv - 0.5f;
    bbox_any = bbox_any || ((tmin(floorf(u1), wl - 1.0f) >= tmax(ceilf(u0), 0.0f)) &&
                            (tmin(floorf(v1), wl - 1.0f) >= tmax(ceilf(v0), 0.0f)));
  }
  // FMA trap: the adjugate products round before the differences
  const float det = (px[1] * py[2] - py[1] * px[2]) + (py[0] * px[2] - px[0] * py[2]) +
                    (px[0] * py[1] - py[0] * px[1]);
  // eps * 4^kmax: a power of two, so equal to torch's f32 of the double product
  const float thr = eps * (float)(1 << (2 * (n_levels - 1)));
  if (!(ok && bbox_any && det <= thr)) return kTiers * ntiles;

  // valid: det is not NaN, so neither is any corner
  const float last = (float)top - 1.0f;
  const int x0 = (int)tmin(tmax(floorf(umin), 0.0f), last);
  const int y0 = (int)tmin(tmax(floorf(vmin), 0.0f), last);
  int x1 = (int)tmin(tmax(floorf(umax), 0.0f), last);
  int y1 = (int)tmin(tmax(floorf(vmax), 0.0f), last);
  x1 = x1 > x0 ? x1 : x0;
  y1 = y1 > y0 ? y1 : y0;
  const int tx0 = x0 / tile, tx1 = x1 / tile, ty0 = y0 / tile, ty1 = y1 / tile;
  const int ts = (tx1 - tx0 > ty1 - ty0 ? tx1 - tx0 : ty1 - ty0) + 1;
  const float sgn = det < 0.0f ? -1.0f : 1.0f;
  const bool deg = det * sgn <= thr;
  int tier = ts <= 1 ? 0 : (ts <= 2 ? 1 : kTiers - 1);
  if (deg) tier = ts <= 2 ? 2 : kTiers - 1;
  return tier * ntiles + ty0 * ntx + tx0;
}

// Triangle `id`'s binned row (row_words(n_attr) words): corners px, py, z,
// then the corner attributes (corner-major, channel-minor) of ab [nv, C],
// then the id's bits; the padding is zero.
SR_HD void bin_row(const float px[3], const float py[3], const float z[3], const float* ab,
                   const long long* t3, int nv, int n_attr, int id, float* row) {
  for (int c = 0; c < 3; ++c) {
    row[c] = px[c];
    row[3 + c] = py[c];
    row[6 + c] = z[c];
    const long long i = t3[c];
    const long long ci = i < 0 ? 0 : (i >= nv ? nv - 1 : i);
    for (int a = 0; a < n_attr; ++a) row[kRaw + c * n_attr + a] = ab[ci * n_attr + a];
  }
  const int R = kRaw + 3 * n_attr;
  row[R] = i2f(id);
  for (int w = R + 1; w < row_words(n_attr); ++w) row[w] = 0.0f;
}

}  // namespace sr

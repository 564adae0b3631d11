// Per-triangle binning of the single-level tile rasterizer, shared by the
// card's binning passes (rasterize_single.cu) and their host build
// (rasterize_single_host.cpp).
//
// It makes exactly the decisions of ops/rasterize_single.py::build_bins
// (after stylerenderer_tpu/ops/rasterize_pallas.py:76): the projection of
// ops/rasterize.py::_project_verts to a w x h image (bin_multi.cuh's
// project_tri), validity as ops/rasterize_multi.py::_setup decides it, the
// clamped integer bbox, its span in tiles and the tier, the degenerate test
// |det| <= eps at this one level, and the home tile on a grid that rounds
// up. Each torch expression there is one op per kernel on the card and
// rounds on its own, so every expression here is the same one in the same
// association order, built like rasterize_multi.cuh (no FMA contraction);
// minima, maxima and clamps propagate NaN as torch's do (sr::tmin, tmax).

#pragma once

#include "bin_multi.cuh"
#include "rasterize_single.cuh"

namespace sr {

// The sort key tier * ntiles + home of a triangle with corners px, py in a
// w x h image (ok: project_tri's verdict), or kSingleTiers * ntiles when it
// is invalid.
SR_HD int bin_key_single(const float px[3], const float py[3], bool ok, int w, int h, int tile,
                         float eps) {
  const int ntx = single_tiles(w, tile), ntiles = ntx * single_tiles(h, tile);
  const float umin = tmin(tmin(px[0], px[1]), px[2]), umax = tmax(tmax(px[0], px[1]), px[2]);
  const float vmin = tmin(tmin(py[0], py[1]), py[2]), vmax = tmax(tmax(py[0], py[1]), py[2]);
  const float xm = (float)w - 1.0f, ym = (float)h - 1.0f;
  // _setup: a non-empty clamped bbox, and det in its left-to-right order
  // (FMA trap: every product rounds before the sum)
  const bool bbox_ok = (tmin(floorf(umax), xm) >= tmax(ceilf(umin), 0.0f)) &&
                       (tmin(floorf(vmax), ym) >= tmax(ceilf(vmin), 0.0f));
  const float det_setup = px[1] * py[2] - py[1] * px[2] + py[0] * px[2] - px[0] * py[2] +
                          px[0] * py[1] - py[0] * px[1];
  if (!(ok && bbox_ok && det_setup <= eps)) return kSingleTiers * ntiles;

  // valid: no corner is NaN; both ends of the bbox clamped to the image
  const int x0 = (int)tmin(tmax(ceilf(umin), 0.0f), xm);
  const int x1 = (int)tmin(tmax(floorf(umax), 0.0f), xm);
  const int y0 = (int)tmin(tmax(ceilf(vmin), 0.0f), ym);
  const int y1 = (int)tmin(tmax(floorf(vmax), 0.0f), ym);
  const int tx0 = x0 / tile, ty0 = y0 / tile;
  const int ts = (x1 / tile - tx0 > y1 / tile - ty0 ? x1 / tile - tx0 : y1 / tile - ty0) + 1;
  int tier = ts <= 1 ? 0 : (ts <= 2 ? 1 : (ts <= 4 ? 2 : (ts <= 16 ? 3 : kSingleTiers - 1)));
  // build_bins' det, grouped by pairs
  const float det = (px[1] * py[2] - py[1] * px[2]) + (py[0] * px[2] - px[0] * py[2]) +
                    (px[0] * py[1] - py[0] * px[1]);
  const float sgn = det < 0.0f ? -1.0f : 1.0f;
  if (det * sgn <= eps) tier = kSingleTiers - 1;
  return tier * ntiles + ty0 * ntx + tx0;
}

}  // namespace sr

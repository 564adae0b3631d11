// Host build of upfirdn2d: the same per-output math, tiling, launch shape
// and per-thread indexing (upfirdn2d.cuh) as upfirdn2d.cu, each work
// item's three phases (its rows brought in, widened, computed) run by
// plain loops over the threads in turn, as the kernel's barriers order
// them; a row's bulk copy is a memcpy of the same aligned span. The CPU tests hold it against the plain
// version and the float64 oracle, so math and indexing faults in the shared
// code show up without a card. Build with g++ -O2 -ffp-contract=off
// -shared -fPIC (ops/_build.py).

#include <vector>

#include "upfirdn2d.cuh"

namespace {

struct alignas(16) Vec16 {
  unsigned char b[16];
};

template <typename T, int KIND>
void run(const ufd::Args& a, const ufd::Shape& s) {
  using Acc = typename ufd::AccOf<T>::type;
  // 16-byte aligned, zeroed: the kernel's dynamic shared memory
  std::vector<Vec16> buf((s.smem + 15) / 16);
  unsigned char* smem = reinterpret_cast<unsigned char*>(buf.data());
  ufd::Taps<Acc> k{};
  if constexpr (KIND != ufd::kGeneric) k = ufd::load_taps<Acc>(a);
  for (long long t = 0; t < s.items; ++t) {
    const ufd::Item it = ufd::item_at<KIND>(a, s, ufd::walk_of(s, (unsigned)t));
    for (int tid = 0; tid < ufd::kThreads; ++tid) ufd::issue_rows<T>(a, s, it, 0, tid, smem);
    for (int tid = 0; tid < ufd::kThreads; ++tid) ufd::widen_rows<T, Acc>(s, 0, tid, smem);
    for (int tid = 0; tid < ufd::kThreads; ++tid) ufd::phase_compute<T, KIND>(a, s, it, k, tid, smem);
  }
}

// The blocks an H100 holds at once at one plane an item (132 SMs x 4), the
// count the card's launch measures for itself
constexpr int kCardBlocks = 528;

ufd::Shape shape_of(const ufd::Args& a, int dtype) {
  return ufd::launch_shape(a, dtype == 0 ? 4 : dtype == 1 ? 2 : 8, dtype == 2 ? 8 : 4,
                           kCardBlocks);
}

template <typename T>
void run_kind(const ufd::Args& a, const ufd::Shape& s) {
  switch (s.kind) {
    case ufd::kBlur:
      return run<T, ufd::kBlur>(a, s);
    case ufd::kUp2:
      return run<T, ufd::kUp2>(a, s);
    case ufd::kDown2:
      return run<T, ufd::kDown2>(a, s);
    default:
      return run<T, ufd::kGeneric>(a, s);
  }
}

}  // namespace

// sr_upfirdn2d's arguments (upfirdn2d.cu) on host memory, without the
// stream; 1 for arguments the kernel does not take.
extern "C" int sr_upfirdn2d_host(const void* x, void* out, const void* taps, int N, int C, int H,
                                 int W, long long sb, long long sc, long long sh, long long sw,
                                 int out_h, int out_w, int up_x, int up_y, int down_x,
                                 int down_y, int pad_x0, int pad_y0, int kh, int kw, int dtype) {
  const ufd::Args a{x,     out,   taps,  sb,    sc,     sh,     sw,     N,      C, H, W,
                    out_h, out_w, up_x,  up_y,  down_x, down_y, pad_x0, pad_y0, kh, kw};
  if (ufd::check(a) || dtype < 0 || dtype > 2) return 1;
  const ufd::Shape s = shape_of(a, dtype);
  if (dtype == 0)
    run_kind<float>(a, s);
  else if (dtype == 1)
    run_kind<uint16_t>(a, s);
  else
    run_kind<double>(a, s);
  return 0;
}

// ufd::launch_shape for these arguments: out = the first 20 values of
// sr_upfirdn2d_shape's.
extern "C" int sr_upfirdn2d_shape_host(int N, int C, int H, int W, int out_h, int out_w,
                                       int up_x, int up_y, int down_x, int down_y, int pad_x0,
                                       int pad_y0, int kh, int kw, int dtype, int unit_w,
                                       int* out) {
  int one = 0;
  const ufd::Args a{&one,  &one, &one, 0,    0,      0,      unit_w ? 1 : 2, N,      C, H, W,
                    out_h, out_w, up_x, up_y, down_x, down_y, pad_x0,        pad_y0, kh, kw};
  if (ufd::check(a) || dtype < 0 || dtype > 2) return 1;
  const ufd::Shape s = shape_of(a, dtype);
  const int vals[20] = {s.kind,   s.rx,     s.ry,      s.tx,      s.ty,          s.tp,
                        s.sx,     s.sy,     s.tiles_x, s.tiles_y, (int)s.groups, (int)s.items,
                        s.in_w,   s.in_h,   s.pitch,   s.raw_pitch, s.lanes,     s.bulk,
                        s.vec,    s.smem};
  for (int i = 0; i < 20; ++i) out[i] = vals[i];
  return 0;
}

// Host build of the styled conv's epilogue: the same per-element math,
// vector width, launch shape and per-thread indexing (fused_act.cuh) as
// fused_act.cu, its blocks and threads run in turn by plain loops. The CPU
// tests hold it against the plain chain (bit for bit in float32), so math,
// FMA and indexing faults in the shared code show up without a card. Build
// with g++ -O2 -ffp-contract=off -shared -fPIC (ops/_build.py).

#include "fused_act.cuh"

namespace {

template <typename T>
void run(const fa::Args& a) {
  constexpr int V = fa::kVecBytes / (int)sizeof(T);
  const fa::Shape s = fa::launch_shape(a.N, a.C, (long long)a.H * a.W, fa::vec_width<T>(a));
  for (long long bx = 0; bx < s.blocks; ++bx)
    for (int by = 0; by < s.chunks; ++by)
      for (int ty = 0; ty < s.ty; ++ty)
        for (int tx = 0; tx < s.tx; ++tx) {
          if (s.V == V)
            fa::run_thread<T, V>(a, s, (int)bx, by, tx, ty);
          else
            fa::run_thread<T, 1>(a, s, (int)bx, by, tx, ty);
        }
}

}  // namespace

// sr_fused_bias_act's arguments (fused_act.cu) on host memory, without the
// stream; 1 for arguments the kernel does not take.
extern "C" int sr_fused_bias_act_host(const void* y, void* out, const float* demod,
                                      const void* film_a, const void* film_b, const void* noise,
                                      const float* noise_weight, const float* bias, int N, int C,
                                      int H, int W, long long film_bs, long long film_ps,
                                      int noise_n, int noise_h, int noise_w, int flags, int dtype,
                                      float slope, float gain) {
  const fa::Args a{y,       out,     demod,   film_a,  film_b, noise, noise_weight,
                   bias,    film_bs, film_ps, N,       C,      H,     W,
                   noise_n, noise_h, noise_w, flags,   slope,  gain};
  if (fa::check(a) || dtype < 0 || dtype > 1) return 1;
  if (dtype == 0)
    run<float>(a);
  else
    run<uint16_t>(a);
  return 0;
}

// fa::launch_shape for (N, C, H * W) at the vector width of `dtype` (or 1
// without `vec`): out = {V, tx, ty, tiles, chunks, chunk, rows}.
extern "C" int sr_fused_bias_act_shape_host(int N, int C, int H, int W, int dtype, int vec,
                                            int* out) {
  if (N < 1 || C < 1 || H < 1 || W < 1 || dtype < 0 || dtype > 1) return 1;
  const fa::Shape s = fa::launch_shape(N, C, (long long)H * W,
                                       vec ? fa::kVecBytes / (dtype == 0 ? 4 : 2) : 1);
  const int vals[7] = {s.V, s.tx, s.ty, s.tiles, s.chunks, s.chunk, s.rows};
  for (int i = 0; i < 7; ++i) out[i] = vals[i];
  return 0;
}

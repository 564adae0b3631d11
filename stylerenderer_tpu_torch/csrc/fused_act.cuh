// The styled conv's epilogue, element by element, and the schedule that
// walks it: shared by the Hopper kernel (fused_act.cu) and its host build
// (fused_act_host.cpp), which runs the kernel's blocks and threads in turn,
// so the CPU tests check the card's math and its indexing.
//
// out = act(((y * demod[n,c]) * film_a[n,p] + film_b[n,p]) + w * noise[n?,p?]
//           + bias[c]),  act(t) = (t >= 0 ? t : t * slope) * gain,
//
// over y [N, C, P] (P = H * W; the mapping's [B, 512] is N = B, P = 1).
// Every term but y is optional. Each step rounds to float32 in the plain
// chain's order (ops/fused_act.py::fused_bias_act_ref), so a float32 y gives
// the plain chain's bits; a bfloat16 y is widened, and the result rounded
// once. The build keeps each multiply and add apart (nvcc --fmad=false, g++
// -ffp-contract=off, ops/_build.py): a contracted a*b+c rounds once, and the
// float32 result would no longer be the plain chain's.
//
// bfloat16 travels as its 16 bits (uint16_t), widened and rounded here (to
// nearest even, NaN to 0x7fc0, as c10::BFloat16), so that the header needs
// no CUDA type and the host build computes the same bits.

#pragma once

#include <cstdint>
#include <cstring>

#ifndef SR_HD
#ifdef __CUDACC__
#define SR_HD __host__ __device__ __forceinline__
#else
#define SR_HD inline
#endif
#endif

namespace fa {

constexpr int kThreads = 256;    // threads a block
constexpr int kVecBytes = 16;    // one load or store of a thread along W
constexpr int kWaveBlocks = 1056;  // 132 SMs x 8 resident blocks of kThreads

// flags: the terms present besides y (noise: a non-null pointer)
constexpr int kDemod = 1, kFilm = 2, kBias = 4;

SR_HD float bits_float(uint32_t u) {
#ifdef __CUDA_ARCH__
  return __uint_as_float(u);
#else
  float f;
  std::memcpy(&f, &u, 4);
  return f;
#endif
}

SR_HD uint32_t float_bits(float f) {
#ifdef __CUDA_ARCH__
  return __float_as_uint(f);
#else
  uint32_t u;
  std::memcpy(&u, &f, 4);
  return u;
#endif
}

SR_HD float widen(float x) { return x; }
SR_HD float widen(uint16_t x) { return bits_float((uint32_t)x << 16); }

SR_HD void narrow(float x, float& out) { out = x; }
SR_HD void narrow(float x, uint16_t& out) {
  const uint32_t u = float_bits(x);
  out = (u & 0x7fffffffu) > 0x7f800000u ? (uint16_t)0x7fc0
                                        : (uint16_t)((u + 0x7fffu + ((u >> 16) & 1u)) >> 16);
}

// The epilogue of one element, in float32, one rounding a step.
SR_HD float epilogue(float y, int flags, float demod, float fa, float fb, bool has_noise,
                     float wn, float n, float bias, float slope, float gain) {
  float t = y;
  if (flags & kDemod) t = t * demod;
  if (flags & kFilm) {
    t = t * fa;
    t = t + fb;
  }
  if (has_noise) {
    const float s = wn * n;
    t = t + s;
  }
  if (flags & kBias) t = t + bias;
  t = t >= 0.f ? t : t * slope;
  return t * gain;
}

struct Args {
  const void* y;
  void* out;
  const float* demod;         // [N, C]
  const void* film_a;         // film_a[n * film_bs + p * film_ps], y's type
  const void* film_b;
  const void* noise;          // [Nn, 1, Hn, Wn] float32, contiguous
  const float* noise_weight;  // [1]
  const float* bias;          // [C]
  long long film_bs, film_ps;
  int N, C, H, W, noise_n, noise_h, noise_w, flags;
  float slope, gain;
};

// The launch shape, from (N, C, P) and the vector width V that the
// pointers allow (16 bytes, or 1). A block is kThreads threads, tx along the
// pixels (V each) by ty along the channels; grid (N * tiles, chunks), each
// block looping over `chunk` channels. A large map gives tx = kThreads,
// ty = 1: a block owns a tile of pixels and loops over the channels,
// reading the per-pixel FiLM and noise terms once. A small one (the 4-16 px
// levels) gives the channels the rest of the block. Channels are split into
// chunks only while the blocks would not fill one wave of the card.
// P = 1 (the mapping's [B, 512]; a channels-last map, as the ResBlocks'
// convs give, taken as [N * H * W, C]) is a run of N * C values, channels
// fastest: `rows`, one block of kThreads along it, V values a thread.
struct Shape {
  int V, tx, ty, tiles, chunks, chunk, rows;
  long long blocks;  // along the grid's x: N * tiles, or tiles for a run
};

SR_HD Shape launch_shape(int N, int C, long long P, int V) {
  Shape s;
  s.rows = P == 1;
  const long long run = s.rows ? (long long)N * C : P;  // along a thread's V values
  s.V = run % V ? 1 : V;
  const long long pv = (run + s.V - 1) / s.V;
  if (s.rows) {
    s.tx = kThreads;
    s.ty = 1;
    s.tiles = (int)((pv + kThreads - 1) / kThreads);
    s.chunks = 1;
    s.chunk = C;
    s.blocks = s.tiles;
    return s;
  }
  s.tx = 1;
  while (s.tx < kThreads && s.tx < pv) s.tx *= 2;
  s.ty = kThreads / s.tx;
  s.tiles = (int)((pv + s.tx - 1) / s.tx);
  const long long blocks = s.blocks = (long long)N * s.tiles;
  const int steps = (C + s.ty - 1) / s.ty;  // channel steps of the whole block
  long long want = (kWaveBlocks + blocks - 1) / blocks;
  if (want > steps) want = steps;
  if (want < 1) want = 1;
  s.chunk = (int)((steps + want - 1) / want) * s.ty;
  s.chunks = (C + s.chunk - 1) / s.chunk;
  return s;
}

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

template <typename T, int V>
SR_HD void load(const void* base, long long i, float* out) {
  const Vec<T, V> x = *(reinterpret_cast<const Vec<T, V>*>(static_cast<const T*>(base) + i));
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
  for (int k = 0; k < V; ++k) out[k] = widen(x.v[k]);
}

template <typename T>
SR_HD float at(const void* base, long long i) {
  return widen(static_cast<const T*>(base)[i]);
}

// The noise value of sample n at pixel p = h * W + w.
SR_HD float noise_at(const Args& a, long long n, long long p) {
  const long long plane = (long long)a.noise_h * a.noise_w, h = p / a.W, w = p - h * a.W;
  return at<float>(a.noise, (a.noise_n > 1 ? n * plane : 0) + (a.noise_h > 1 ? h : 0) * a.noise_w +
                                (a.noise_w > 1 ? w : 0));
}

// Thread (tx, ty) of block (bx, by) of a map (P > 1): its V pixels of
// sample n, for the channels of chunk `by` that step ty takes.
template <typename T, int V>
SR_HD void run_planes(const Args& a, const Shape& s, int bx, int by, int tx, int ty) {
  const int n = bx / s.tiles;
  const long long P = (long long)a.H * a.W;
  const long long p0 = ((long long)(bx - n * s.tiles) * s.tx + tx) * V;
  if (p0 >= P) return;
  float fa[V] = {}, fb[V] = {}, nz[V] = {};
  if (a.flags & kFilm) {
    if (a.film_ps == 1) {
      load<T, V>(a.film_a, n * a.film_bs + p0, fa);
      load<T, V>(a.film_b, n * a.film_bs + p0, fb);
    } else {
      for (int k = 0; k < V; ++k) {
        fa[k] = at<T>(a.film_a, n * a.film_bs + (p0 + k) * a.film_ps);
        fb[k] = at<T>(a.film_b, n * a.film_bs + (p0 + k) * a.film_ps);
      }
    }
  }
  float wn = 0.f;
  if (a.noise) {  // [Nn, 1, Hn, Wn]: per pixel, one value, or broadcast along H or W
    if (a.noise_h == a.H && a.noise_w == a.W) {
      load<float, V>(a.noise, (a.noise_n > 1 ? n * P : 0) + p0, nz);
    } else {
      for (int k = 0; k < V; ++k) nz[k] = noise_at(a, n, p0 + k);
    }
    wn = *a.noise_weight;
  }
  const int c1 = (by + 1) * s.chunk < a.C ? (by + 1) * s.chunk : a.C;
#ifdef __CUDA_ARCH__
#pragma unroll 4
#endif
  for (int c = by * s.chunk + ty; c < c1; c += s.ty) {
    const long long row = ((long long)n * a.C + c) * P + p0;
    float y[V];
    load<T, V>(a.y, row, y);
    const float d = (a.flags & kDemod) ? a.demod[(long long)n * a.C + c] : 0.f;
    const float b = (a.flags & kBias) ? a.bias[c] : 0.f;
    Vec<T, V> o;
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
    for (int k = 0; k < V; ++k)
      narrow(epilogue(y[k], a.flags, d, fa[k], fb[k], a.noise != nullptr, wn, nz[k], b, a.slope,
                      a.gain),
             o.v[k]);
    *reinterpret_cast<Vec<T, V>*>(static_cast<T*>(a.out) + row) = o;
  }
}

// Thread tx of block bx of a run (P = 1): its V values, channels fastest.
template <typename T, int V>
SR_HD void run_rows(const Args& a, const Shape& s, int bx, int tx) {
  const long long i0 = ((long long)bx * s.tx + tx) * V;
  if (i0 >= (long long)a.N * a.C) return;
  long long n = i0 / a.C;
  int c = (int)(i0 - n * a.C);
  float y[V];
  load<T, V>(a.y, i0, y);
  const float wn = a.noise ? *a.noise_weight : 0.f;
  Vec<T, V> o;
  for (int k = 0; k < V; ++k) {
    const float fa = (a.flags & kFilm) ? at<T>(a.film_a, n * a.film_bs) : 0.f;
    const float fb = (a.flags & kFilm) ? at<T>(a.film_b, n * a.film_bs) : 0.f;
    const float nz = a.noise ? noise_at(a, n, 0) : 0.f;
    const float d = (a.flags & kDemod) ? a.demod[i0 + k] : 0.f;
    const float b = (a.flags & kBias) ? a.bias[c] : 0.f;
    narrow(epilogue(y[k], a.flags, d, fa, fb, a.noise != nullptr, wn, nz, b, a.slope, a.gain),
           o.v[k]);
    if (++c == a.C) {
      c = 0;
      ++n;
    }
  }
  *reinterpret_cast<Vec<T, V>*>(static_cast<T*>(a.out) + i0) = o;
}

template <typename T, int V>
SR_HD void run_thread(const Args& a, const Shape& s, int bx, int by, int tx, int ty) {
  if (s.rows)
    run_rows<T, V>(a, s, bx, tx);
  else
    run_planes<T, V>(a, s, bx, by, tx, ty);
}

SR_HD bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % (uintptr_t)bytes == 0;
}

// The vector width V for these arguments: kVecBytes / sizeof(T) when every
// pointer read or written by vector is aligned to its width, and the film's
// sample stride is a multiple of it; else 1 (launch_shape also takes 1 when
// V does not divide the values along a thread's run).
template <typename T>
SR_HD int vec_width(const Args& a) {
  constexpr int V = kVecBytes / (int)sizeof(T);
  bool ok = aligned(a.y, kVecBytes) && aligned(a.out, kVecBytes);
  if ((a.flags & kFilm) && a.film_ps == 1)
    ok = ok && a.film_bs % V == 0 && aligned(a.film_a, kVecBytes) &&
         aligned(a.film_b, kVecBytes);
  if (a.noise && a.noise_h == a.H && a.noise_w == a.W)
    ok = ok && aligned(a.noise, V * (int)sizeof(float));
  return ok ? V : 1;
}

// Arguments the kernel does not take: 0 when fine.
SR_HD int check(const Args& a) {
  if (a.N < 1 || a.C < 1 || a.H < 1 || a.W < 1 || !a.y || !a.out) return 1;
  if ((a.flags & kDemod) && !a.demod) return 1;
  if ((a.flags & kBias) && !a.bias) return 1;
  if ((a.flags & kFilm) &&
      (!a.film_a || !a.film_b || a.film_ps < 1 || a.film_bs < (long long)a.H * a.W * a.film_ps))
    return 1;
  if (a.noise &&
      (!a.noise_weight || (a.noise_n != 1 && a.noise_n != a.N) ||
       (a.noise_h != 1 && a.noise_h != a.H) || (a.noise_w != 1 && a.noise_w != a.W)))
    return 1;
  return 0;
}

}  // namespace fa

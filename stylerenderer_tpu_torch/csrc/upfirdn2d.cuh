// upfirdn2d's per-output index and tap math, its tiling and its launch
// shape: shared by the Hopper kernel (upfirdn2d.cu) and its host build
// (upfirdn2d_host.cpp), which runs the kernel's blocks, phases and threads
// in turn, so the CPU tests check the card's math and its indexing.
//
// out[n, oy, ox] = sum over the taps (ky, kx) whose stuffed position
//   (oy * down_y + ky - pad_y0, ox * down_x + kx - pad_x0) is a multiple of
//   (up_y, up_x) of  K[kh-1-ky, kw-1-kx] * x[n, that position / up]
// (zero outside the input), over the N * C planes n of x. K is the taps
// as the caller holds them (row-major [kh, kw], the accumulate type); the
// flip is in the indexing. Each output is summed in the accumulate type
// (float for float32 and bfloat16, double for float64) in one fixed order,
// each step one fused multiply-add, and rounded once to the output type at
// the store: no atomics, so every run and both builds give the same bits.
// The order: a 4x4 kernel that is an outer product (Taps) down each of the
// output's window columns, then along the row of those column sums, both
// in ascending tap order; any other kernel tap by tap, ky then kx
// ascending.
//
// A work item is one tile of outputs of `tp` planes. Its input rows (the
// outputs' window and the kernel's halo) arrive in shared memory as they
// lie in device memory: on the card one 1-D bulk copy a row of the
// 16-byte aligned span that covers the row's columns (rows start anywhere),
// or, for an x that is not unit-stride along W, gathered by plain loads. A
// pass then widens them into the tile in the accumulate type, zero outside
// the input, and the tile's outputs are computed from it. A block walks its
// work items with two raw buffers: the next item's rows are in flight while
// the current one is computed.
//
// The 4x4 kernels of the port's three forms (blur: up 1, down 1; upsample:
// up 2; downsample: down 2) take a register tile of RX x RY outputs a
// thread whose taps and shared-memory offsets are compile-time: up 2 is
// polyphase (each output reads only its phase's taps from the unstuffed
// input, and tile 0 starts at -(pad0 mod 2) so that the phase of every
// output is known), down 2 computes only the outputs it keeps. Every other
// geometry takes the same items with one output a thread and the phase
// worked out per output.

#pragma once

#include <cmath>
#include <cstdint>
#include <cstring>

#include "fused_act.cuh"

namespace ufd {

using fa::narrow;
using fa::Vec;
using fa::widen;

constexpr int kThreads = 256;       // threads a block
constexpr int kMaxTaps = 8;         // kh and kw at most
constexpr int kStageSteps = 5;      // column steps of a widened row: in_w <= 32 * 5
constexpr int kWidenRows = 2;       // rows a thread widens at once
constexpr int kSmemBudget = 64 * 1024;  // bytes of shared memory a block (x2 for double)

// the forms with a register tile; kGeneric is every other geometry
constexpr int kBlur = 0, kUp2 = 1, kDown2 = 2, kGeneric = 3;

SR_HD double widen(double x) { return x; }

// Sums rounded to the output type: bfloat16 to nearest even, as
// c10::BFloat16, NaN to 0x7fff; on the card one cvt for two sums.
SR_HD void round_to(float x, float& out) { out = x; }
SR_HD void round_to(double x, double& out) { out = x; }
SR_HD void round_to(float x, uint16_t& out) {
#ifdef __CUDA_ARCH__
  unsigned short h;
  asm("cvt.rn.bf16.f32 %0, %1;" : "=h"(h) : "f"(x));
  out = h;
#else
  if (x != x)
    out = 0x7fff;
  else
    narrow(x, out);
#endif
}

template <int RX, typename Acc, typename T>
SR_HD void round_run(const Acc* acc, T* out) {
#ifdef __CUDA_ARCH__
  if constexpr (sizeof(T) == 2 && RX % 2 == 0) {
    for (int k = 0; k < RX; k += 2) {
      uint32_t d;
      asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(d) : "f"(acc[k + 1]), "f"(acc[k]));
      out[k] = (uint16_t)(d & 0xffff);
      out[k + 1] = (uint16_t)(d >> 16);
    }
    return;
  }
#endif
  for (int k = 0; k < RX; ++k) round_to(acc[k], out[k]);
}

SR_HD float fmadd(float a, float b, float c) {
#ifdef __CUDA_ARCH__
  return __fmaf_rn(a, b, c);
#else
  return std::fma(a, b, c);
#endif
}

SR_HD double fmadd(double a, double b, double c) {
#ifdef __CUDA_ARCH__
  return __fma_rn(a, b, c);
#else
  return std::fma(a, b, c);
#endif
}

template <typename T>
struct AccOf {
  using type = float;
};
template <>
struct AccOf<double> {
  using type = double;
};

// (up, down, outputs a thread along x, along y) of a form
template <int KIND>
struct Form;
template <>
struct Form<kBlur> {
  static constexpr int UP = 1, DOWN = 1, RX = 4, RY = 4;
};
template <>
struct Form<kUp2> {
  static constexpr int UP = 2, DOWN = 1, RX = 8, RY = 4;
};
template <>
struct Form<kDown2> {
  static constexpr int UP = 1, DOWN = 2, RX = 2, RY = 4;
};

struct Args {
  const void* x;     // [N, C, H, W] at strides (sb, sc, sh, sw), elements
  void* out;         // [N, C, out_h, out_w], contiguous
  const void* taps;  // [kh, kw], the accumulate type, contiguous
  long long sb, sc, sh, sw;
  int N, C, H, W, out_h, out_w, up_x, up_y, down_x, down_y, pad_x0, pad_y0, kh, kw;
};

SR_HD int floor_div(long long a, long long b) {
  const long long q = a / b;
  return (int)(q * b > a ? q - 1 : q);
}

SR_HD int pos_mod(int a, int b) {
  const int m = a % b;
  return m < 0 ? m + b : m;
}

SR_HD int kind_of(const Args& a) {
  if (a.kh != 4 || a.kw != 4 || a.up_x != a.up_y || a.down_x != a.down_y) return kGeneric;
  if (a.up_x == 1 && a.down_x == 1) return kBlur;
  if (a.up_x == 2 && a.down_x == 1) return kUp2;
  if (a.up_x == 1 && a.down_x == 2) return kDown2;
  return kGeneric;
}

// The launch shape. A block is kThreads threads: tx along the outputs' x
// (each rx outputs), ty along y (each ry), tp planes; a work item is a tile
// of (tx * rx) x (ty * ry) outputs of tp planes, tile (0, 0) at (sx, sy).
// Its input tile of a plane is in_w x in_h: raw rows raw_pitch bytes apart
// (a multiple of 16, room for a row's 16-byte aligned span), widened rows
// `pitch` apart (a multiple of 4, so each thread's 16-byte shared loads stay
// aligned); each raw row has a 16-byte record of where its input lies in
// it (Span). Planes share an item (tp > 1) only where the plane's tile
// leaves threads over and there would still be `fill` items: the blocks
// the card holds at once (0: one plane an item). `lanes`
// threads widen a row. Items walk the tiles of a plane group first
// (neighbouring tiles share their halo in L2) unless x is not unit-stride
// along W (`bulk` false, a channels-last map): then the planes first, so
// that neighbouring channels' items read the same sectors at about the same
// time. Shared memory: two mbarriers, two raw buffers and their rows'
// records, the widened tile. tx = 1 << lx, ty = 1 << ly, lanes = 1 << llanes.
struct Shape {
  int kind, rx, ry, tx, ty, tp, sx, sy, tiles_x, tiles_y;
  long long groups, items;
  int in_w, in_h, pitch, raw_pitch, lanes, bulk, vec, smem, lx, ly, llanes;
};

// Input extent along one axis of a tile of t threads of r outputs.
SR_HD int in_extent(int kind, int t, int r, int up, int down, int k) {
  if (kind == kGeneric) return (int)(((long long)(t - 1) * down + k - 1 + up - 1) / up) + 1;
  return (t - 1) * (r * down / up) + ((r - 1) * down + k - 1) / up + 1;
}

SR_HD int next_pow2(long long n, int cap) {
  int p = 1;
  while (p < cap && p < n) p *= 2;
  return p;
}

// The most shared memory a launch shape asks: 16 bytes of mbarriers and
// the budget, which a plane's tile at one row of threads stays inside.
constexpr int max_smem(int acc_bytes) { return 16 + kSmemBudget / 4 * acc_bytes; }

SR_HD Shape launch_shape(const Args& a, int elem_bytes, int acc_bytes, int fill) {
  Shape s;
  s.kind = kind_of(a);
  const int rxs[4] = {Form<kBlur>::RX, Form<kUp2>::RX, Form<kDown2>::RX, 1};
  const int rys[4] = {Form<kBlur>::RY, Form<kUp2>::RY, Form<kDown2>::RY, 1};
  s.rx = rxs[s.kind];
  s.ry = rys[s.kind];
  s.sx = s.kind == kUp2 ? -pos_mod(a.pad_x0, 2) : 0;
  s.sy = s.kind == kUp2 ? -pos_mod(a.pad_y0, 2) : 0;
  s.tx = next_pow2((a.out_w - s.sx + s.rx - 1) / s.rx, 32);
  while (s.tx > 1 && in_extent(s.kind, s.tx, s.rx, a.up_x, a.down_x, a.kw) > 32 * kStageSteps)
    s.tx /= 2;
  s.ty = next_pow2((a.out_h - s.sy + s.ry - 1) / s.ry, kThreads / s.tx);
  s.in_w = in_extent(s.kind, s.tx, s.rx, a.up_x, a.down_x, a.kw);
  const int read_w = s.kind == kGeneric ? s.in_w : (s.tx - 1) * (s.rx * a.down_x / a.up_x) + 8;
  s.pitch = ((s.in_w > read_w ? s.in_w : read_w) + 3) / 4 * 4;
  s.raw_pitch = (s.in_w * elem_bytes + 32 + 15) / 16 * 16;
  const int budget = kSmemBudget / 4 * acc_bytes;
  for (;;) {
    s.in_h = in_extent(s.kind, s.ty, s.ry, a.up_y, a.down_y, a.kh);
    if (s.ty == 1 || (long long)s.in_h * (2 * (s.raw_pitch + 16) + s.pitch * acc_bytes) <= budget)
      break;
    s.ty /= 2;
  }
  const int plane_bytes = s.in_h * (2 * (s.raw_pitch + 16) + s.pitch * acc_bytes);
  s.tiles_x = (a.out_w - s.sx + s.tx * s.rx - 1) / (s.tx * s.rx);
  s.tiles_y = (a.out_h - s.sy + s.ty * s.ry - 1) / (s.ty * s.ry);
  const long long planes = (long long)a.N * a.C, tiles = (long long)s.tiles_x * s.tiles_y;
  long long tp = kThreads / (s.tx * s.ty);
  if (tp > budget / plane_bytes) tp = budget / plane_bytes;
  const long long most = fill > 0 ? planes * tiles / fill : 1;
  if (tp > most) tp = most;
  s.tp = tp < 1 ? 1 : (int)tp;
  s.groups = (planes + s.tp - 1) / s.tp;
  s.items = s.groups * tiles;
  s.lanes = next_pow2(s.in_w, 32);
  s.bulk = a.sw == 1 || a.W == 1;
  s.vec = s.kind != kGeneric && s.sx == 0 && a.out_w % s.rx == 0;
  s.smem = 16 + s.tp * plane_bytes;
  for (s.lx = 0; (1 << s.lx) < s.tx; ++s.lx) {
  }
  for (s.ly = 0; (1 << s.ly) < s.ty; ++s.ly) {
  }
  for (s.llanes = 0; (1 << s.llanes) < s.lanes; ++s.llanes) {
  }
  return s;
}

// Arguments the kernel does not take: 0 when fine.
SR_HD int check(const Args& a) {
  if (!a.x || !a.out || !a.taps || a.N < 1 || a.C < 1 || a.H < 1 || a.W < 1 || a.out_h < 1 ||
      a.out_w < 1 || a.up_x < 1 || a.up_y < 1 || a.down_x < 1 || a.down_y < 1 || a.kh < 1 ||
      a.kw < 1 || a.kh > kMaxTaps || a.kw > kMaxTaps)
    return 1;
  // every index below fits an int
  const long long lim = 1LL << 30;
  if ((long long)a.N * a.C >= lim ||(long long)a.H * a.up_y + a.kh + (a.pad_y0 < 0 ? -a.pad_y0 : a.pad_y0) >= lim ||
      (long long)a.W * a.up_x + a.kw + (a.pad_x0 < 0 ? -a.pad_x0 : a.pad_x0) >= lim ||
      (long long)a.out_h * a.down_y >= lim || (long long)a.out_w * a.down_x >= lim)
    return 1;
  return 0;
}

// A work item's index as mixed-radix digits, fastest first: (tile_x,
// tile_y, plane group), or for a strided x (group, tile_x, tile_y). A block
// walks items blockIdx.x, + gridDim.x, ... by adding gridDim.x's digits,
// so no item costs a division.
struct Walk {
  int d[3];
};

SR_HD void radices(const Shape& s, int r[3]) {
  r[0] = s.bulk ? s.tiles_x : (int)s.groups;
  r[1] = s.bulk ? s.tiles_y : s.tiles_x;
  r[2] = s.bulk ? (int)s.groups : s.tiles_y;
}

SR_HD Walk walk_of(const Shape& s, unsigned t) {
  int r[3];
  radices(s, r);
  Walk w;
  w.d[0] = (int)(t % (unsigned)r[0]);
  t /= (unsigned)r[0];
  w.d[1] = (int)(t % (unsigned)r[1]);
  w.d[2] = (int)(t / (unsigned)r[1]);
  return w;
}

// w += by; whether w is still an item.
SR_HD bool walk_step(const Shape& s, Walk& w, const Walk& by) {
  int r[3];
  radices(s, r);
  int carry = 0;
  for (int i = 0; i < 2; ++i) {
    w.d[i] += by.d[i] + carry;
    carry = w.d[i] >= r[i];
    if (carry) w.d[i] -= r[i];
  }
  w.d[2] += by.d[2] + carry;
  return w.d[2] < r[2];
}

// One work item: its plane group and its tile.
struct Item {
  int group;
  int ix_lo, iy_lo;  // the input tile's first column and row
  int o0x, o0y;      // its first output column and row
};

template <int KIND>
SR_HD Item item_at(const Args& a, const Shape& s, const Walk& w) {
  Item it;
  it.group = s.bulk ? w.d[2] : w.d[0];
  const int tile_x = s.bulk ? w.d[0] : w.d[1], tile_y = s.bulk ? w.d[1] : w.d[2];
  it.o0x = s.sx + tile_x * s.tx * s.rx;
  it.o0y = s.sy + tile_y * s.ty * s.ry;
  if constexpr (KIND == kGeneric) {
    it.ix_lo = floor_div((long long)it.o0x * a.down_x - a.pad_x0, a.up_x);
    it.iy_lo = floor_div((long long)it.o0y * a.down_y - a.pad_y0, a.up_y);
  } else {  // exact: the origin puts every tile at phase 0
    it.ix_lo = (it.o0x * Form<KIND>::DOWN - a.pad_x0) / Form<KIND>::UP;
    it.iy_lo = (it.o0y * Form<KIND>::DOWN - a.pad_y0) / Form<KIND>::UP;
  }
  return it;
}

// shared memory: the two raw buffers' mbarriers, the raw buffers
// [tp * in_h][raw_pitch bytes], their rows' records [2][tp * in_h], the
// widened tile [tp][in_h][pitch]
SR_HD uint64_t* barrier_of(unsigned char* smem, int stage) {
  return reinterpret_cast<uint64_t*>(smem) + stage;
}

SR_HD unsigned char* raw_of(unsigned char* smem, const Shape& s, int stage) {
  return smem + 16 + stage * s.tp * s.in_h * s.raw_pitch;
}

// Where raw row r's input lies: tile columns c0 .. c1 - 1 hold input
// (none when c0 == c1: the row is outside the planes or the input), column
// c at raw element c + offset.
struct Span {
  int offset, c0, c1, pad;
};

SR_HD Span* spans_of(unsigned char* smem, const Shape& s, int stage) {
  return reinterpret_cast<Span*>(raw_of(smem, s, 2)) + stage * s.tp * s.in_h;
}

template <typename Acc>
SR_HD Acc* tile_of(unsigned char* smem, const Shape& s) {
  return reinterpret_cast<Acc*>(spans_of(smem, s, 2));
}

SR_HD uint32_t smem_addr(const void* p) {
#ifdef __CUDA_ARCH__
  return (uint32_t)__cvta_generic_to_shared(p);
#else
  (void)p;
  return 0;
#endif
}

// Thread tid's part of bringing item `it`'s rows into raw buffer `stage`,
// with their records: row r is plane r / in_h of the item, row r % in_h of
// its tile. On the card a bulk copy of the 16-byte aligned span around a
// row's input, whose bytes the thread announces on the stage's mbarrier as
// it arrives (every thread arrives once an item); a strided x's rows are
// gathered and stored before the arrival. The span reaches at most 15
// bytes past the row's first and last input element, inside their 16-byte
// granules: on the card inside the tensor's allocation (the caching
// allocator's blocks start and end on 512 bytes).
template <typename T>
SR_HD void issue_rows(const Args& a, const Shape& s, const Item& it, int stage, int tid,
                      unsigned char* smem) {
  unsigned char* raw = raw_of(smem, s, stage);
  Span* spans = spans_of(smem, s, stage);
  const int c0 = it.ix_lo < 0 ? -it.ix_lo : 0;
  const int c1 = it.ix_lo + s.in_w < a.W ? s.in_w : a.W - it.ix_lo;
  const unsigned planes = (unsigned)a.N * (unsigned)a.C;
  uint32_t bytes = 0;
#ifdef __CUDA_ARCH__
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
#endif
  // row r is thread (r % 8) * 32 + r / 8's: the rows' copies spread over the warps
  for (int r = (tid >> 5) + ((tid & 31) << 3); r < s.tp * s.in_h; r += kThreads) {
    const int p = s.tp == 1 ? 0 : r / s.in_h, iy = it.iy_lo + (r - p * s.in_h);
    const unsigned n = (unsigned)it.group * s.tp + p;
    Span sp{0, 0, 0, 0};
    if (n < planes && iy >= 0 && iy < a.H && c0 < c1) {
      const unsigned bn = n / (unsigned)a.C;
      const T* row = static_cast<const T*>(a.x) + bn * a.sb + (n - bn * a.C) * a.sc + iy * a.sh;
      unsigned char* dst = raw + r * s.raw_pitch;
      const int ix0 = it.ix_lo + c0;
      sp.c0 = c0;
      sp.c1 = c1;
      if (s.bulk) {
        const uintptr_t first = reinterpret_cast<uintptr_t>(row + ix0),
                        lo = first & ~(uintptr_t)15,
                        hi = (first + (uintptr_t)(c1 - c0) * sizeof(T) + 15) & ~(uintptr_t)15;
        sp.offset = (int)((first - lo) / sizeof(T)) - c0;
#ifdef __CUDA_ARCH__
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
            "[%3];" ::"r"(smem_addr(dst)),
            "l"(lo), "r"((uint32_t)(hi - lo)), "r"(smem_addr(barrier_of(smem, stage)))
            : "memory");
#else
        std::memcpy(dst, reinterpret_cast<const void*>(lo), hi - lo);
#endif
        bytes += (uint32_t)(hi - lo);
      } else {
        sp.offset = -c0;
        for (int c = c0; c < c1; ++c)
          reinterpret_cast<T*>(dst)[c - c0] = row[(long long)(it.ix_lo + c) * a.sw];
      }
    }
    spans[r] = sp;
  }
#ifdef __CUDA_ARCH__
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_addr(barrier_of(smem, stage))),
               "r"(bytes)
               : "memory");
#endif
}

// Wait until raw buffer `stage` holds its item (its use `use`); on the
// card a spin on its mbarrier's phase, which traps after some seconds
// rather than hang the card.
SR_HD void wait_rows(unsigned char* smem, int stage, int use) {
#ifdef __CUDA_ARCH__
  const uint32_t bar = smem_addr(barrier_of(smem, stage)), parity = use & 1;
  for (long long spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spins > (1LL << 24)) __trap();
  }
#else
  (void)smem, (void)stage, (void)use;
#endif
}

// Thread tid's part of widening raw buffer `stage` into the tile: `lanes`
// threads a row, zero where the row or column holds no input. The raw rows
// and the tile share shared memory, so the compiler keeps every load after
// the stores written before it: the thread loads kWidenRows rows' values
// before it stores any.
template <typename T, typename Acc>
SR_HD void widen_rows(const Shape& s, int stage, int tid, unsigned char* smem) {
  const int lanes = s.lanes, g = tid & (lanes - 1), row_lanes = kThreads >> s.llanes;
  const int n_rows = s.tp * s.in_h;
  const unsigned char* raw = raw_of(smem, s, stage);
  const Span* spans = spans_of(smem, s, stage);
  Acc* tile = tile_of<Acc>(smem, s);
  for (int r0 = tid >> s.llanes; r0 < n_rows; r0 += kWidenRows * row_lanes) {
    Acc v[kWidenRows][kStageSteps];
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
    for (int j = 0; j < kWidenRows; ++j) {
      const int r = r0 + j * row_lanes;
      const Span sp = r < n_rows ? spans[r] : Span{0, 0, 0, 0};
      const T* src = reinterpret_cast<const T*>(raw + r * s.raw_pitch) + sp.offset + g;
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
      for (int k = 0; k < kStageSteps; ++k) {
        const int c = g + k * lanes;
        v[j][k] = (unsigned)(c - sp.c0) < (unsigned)(sp.c1 - sp.c0) ? (Acc)widen(src[k * lanes])
                                                                    : (Acc)0;
      }
    }
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
    for (int j = 0; j < kWidenRows; ++j) {
      const int r = r0 + j * row_lanes;
      if (r < n_rows) {
        Acc* dst = tile + r * s.pitch + g;
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
        for (int k = 0; k < kStageSteps; ++k)
          if (g + k * lanes < s.in_w) dst[k * lanes] = v[j][k];
      }
    }
  }
}

// The 8 staged values from `src` (16-byte aligned) on.
template <typename Acc>
SR_HD void load8(const Acc* src, Acc* v) {
  constexpr int V = 16 / (int)sizeof(Acc);
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
  for (int i = 0; i < 8; i += V) {
    const Vec<Acc, V> w = *reinterpret_cast<const Vec<Acc, V>*>(src + i);
    for (int k = 0; k < V; ++k) v[i + k] = w.v[k];
  }
}

// Store the RX sums of one output row from column ox on: one vector store
// where the shape allows it (`vec`: the row is whole and aligned), else
// each output in range.
template <typename T, typename Acc, int RX>
SR_HD void store_row(T* row, int ox, int out_w, bool vec, const Acc* acc) {
  if (vec) {
    if (ox >= out_w) return;
    Vec<T, RX> o;
    round_run<RX>(acc, o.v);
    *reinterpret_cast<Vec<T, RX>*>(row + ox) = o;
    return;
  }
  for (int k = 0; k < RX; ++k)
    if (ox + k >= 0 && ox + k < out_w) round_to(acc[k], row[ox + k]);
}

// A 4x4 kernel as a thread holds it for a whole launch: where it is an
// outer product, exactly in the accumulate type (every flipped tap
// t[ky][kx] == col[ky] * row[kx]: make_kernel of a 1-D tap list), `sep` and
// the two factors; else the compute reads the taps themselves.
template <typename Acc>
struct Taps {
  Acc col[4], row[4];
  bool sep;
};

template <typename Acc>
SR_HD Acc flipped_tap(const Args& a, int ky, int kx) {
  return static_cast<const Acc*>(a.taps)[(3 - ky) * 4 + (3 - kx)];
}

template <typename Acc>
SR_HD Taps<Acc> load_taps(const Args& a) {
  Taps<Acc> k;
  const Acc t00 = flipped_tap<Acc>(a, 0, 0);
  k.sep = t00 != 0;
  for (int i = 0; i < 4; ++i) {
    k.col[i] = flipped_tap<Acc>(a, i, 0);
    k.row[i] = k.sep ? flipped_tap<Acc>(a, 0, i) / t00 : (Acc)0;
  }
  for (int ky = 0; ky < 4; ++ky)
    for (int kx = 0; kx < 4; ++kx)
      k.sep = k.sep && k.col[ky] * k.row[kx] == flipped_tap<Acc>(a, ky, kx);
  return k;
}

// Phase 2 of the register-tile forms, thread tid: its RX x RY outputs of
// one plane. Output v of a thread's run along an axis reads taps
// k = c_v + UP * j, c_v = (-v * DOWN) mod UP, at staged offset
// (v * DOWN + c_v) / UP + j from the thread's own start (RX * DOWN / UP
// columns a thread): all compile-time. A separable kernel sums each
// window column down its rows first (col), then each output along its
// row of those sums (row): 11 multiply-adds a blurred output, not 16.
template <typename T, typename Acc, int KIND>
SR_HD void phase_tiles(const Args& a, const Shape& s, const Item& b, const Taps<Acc>& k,
                       int tid, unsigned char* smem) {
  constexpr int UP = Form<KIND>::UP, DOWN = Form<KIND>::DOWN, RX = Form<KIND>::RX,
                RY = Form<KIND>::RY, K = 4;
  constexpr int WY = ((RY - 1) * DOWN + K - 1) / UP + 1;  // tile rows a thread reads
  constexpr int WX = ((RX - 1) * DOWN + K - 1) / UP + 1;  // tile columns
  const int tx_i = tid & (s.tx - 1), ty_i = (tid >> s.lx) & (s.ty - 1), p = tid >> (s.lx + s.ly);
  const long long n = (long long)b.group * s.tp + p;
  if (p >= s.tp || n >= (long long)a.N * a.C) return;
  const Acc* src = tile_of<Acc>(smem, s) + ((long long)p * s.in_h + ty_i * (RY * DOWN / UP)) *
                                                 s.pitch + tx_i * (RX * DOWN / UP);
  Acc acc[RY][RX];
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
  for (int vy = 0; vy < RY; ++vy)
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
    for (int vx = 0; vx < RX; ++vx) acc[vy][vx] = 0;
  if (k.sep) {
    Acc col[RY][WX];
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
    for (int vy = 0; vy < RY; ++vy)
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
      for (int w = 0; w < WX; ++w) col[vy][w] = 0;
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
    for (int wy = 0; wy < WY; ++wy) {
      Acc v[8];
      load8(src + wy * s.pitch, v);
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
      for (int vy = 0; vy < RY; ++vy) {
        const int cy = ((-vy * DOWN) % UP + UP) % UP, jy = wy - (vy * DOWN + cy) / UP;
        if (jy < 0 || cy + UP * jy >= K) continue;
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
        for (int w = 0; w < WX; ++w) col[vy][w] = fmadd(k.col[cy + UP * jy], v[w], col[vy][w]);
      }
    }
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
    for (int vy = 0; vy < RY; ++vy)
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
      for (int vx = 0; vx < RX; ++vx) {
        const int cx = ((-vx * DOWN) % UP + UP) % UP, fx = (vx * DOWN + cx) / UP;
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
        for (int jx = 0; cx + UP * jx < K; ++jx)
          acc[vy][vx] = fmadd(k.row[cx + UP * jx], col[vy][fx + jx], acc[vy][vx]);
      }
  } else {
    Acc t[K][K];
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
    for (int ky = 0; ky < K; ++ky)
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
      for (int kx = 0; kx < K; ++kx) t[ky][kx] = flipped_tap<Acc>(a, ky, kx);
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
    for (int wy = 0; wy < WY; ++wy) {
      Acc v[8];
      load8(src + wy * s.pitch, v);
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
      for (int vy = 0; vy < RY; ++vy) {
        const int cy = ((-vy * DOWN) % UP + UP) % UP, jy = wy - (vy * DOWN + cy) / UP;
        if (jy < 0 || cy + UP * jy >= K) continue;
        const int ky = cy + UP * jy;
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
        for (int vx = 0; vx < RX; ++vx) {
          const int cx = ((-vx * DOWN) % UP + UP) % UP, fx = (vx * DOWN + cx) / UP;
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
          for (int jx = 0; cx + UP * jx < K; ++jx)
            acc[vy][vx] = fmadd(t[ky][cx + UP * jx], v[fx + jx], acc[vy][vx]);
        }
      }
    }
  }
  T* out = static_cast<T*>(a.out) + n * a.out_h * a.out_w;
  const int ox = b.o0x + tx_i * RX;
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
  for (int vy = 0; vy < RY; ++vy) {
    const int oy = b.o0y + ty_i * RY + vy;
    if (oy >= 0 && oy < a.out_h)
      store_row<T, Acc, RX>(out + (long long)oy * a.out_w, ox, a.out_w, s.vec, acc[vy]);
  }
}

// Phase 2 of every other geometry, thread tid: one output, its phase's
// taps worked out here, in the same order as phase_tiles.
template <typename T, typename Acc>
SR_HD void phase_generic(const Args& a, const Shape& s, const Item& b, int tid,
                         unsigned char* smem) {
  const int tx_i = tid & (s.tx - 1), ty_i = (tid >> s.lx) & (s.ty - 1), p = tid >> (s.lx + s.ly);
  const long long n = (long long)b.group * s.tp + p;
  const int ox = b.o0x + tx_i, oy = b.o0y + ty_i;
  if (p >= s.tp || n >= (long long)a.N * a.C || ox >= a.out_w || oy >= a.out_h) return;
  const int ax = ox * a.down_x - a.pad_x0, ay = oy * a.down_y - a.pad_y0;
  const int kx0 = pos_mod(-ax, a.up_x), ky0 = pos_mod(-ay, a.up_y);
  const int lx0 = (ax + kx0) / a.up_x - b.ix_lo, ly0 = (ay + ky0) / a.up_y - b.iy_lo;
  const Acc* tile = tile_of<Acc>(smem, s) + (long long)p * s.in_h * s.pitch;
  const Acc* taps = static_cast<const Acc*>(a.taps);
  Acc acc = 0;
  for (int ky = ky0, ly = ly0; ky < a.kh; ky += a.up_y, ++ly)
    for (int kx = kx0, lx = lx0; kx < a.kw; kx += a.up_x, ++lx)
      acc = fmadd(taps[(a.kh - 1 - ky) * a.kw + (a.kw - 1 - kx)], tile[ly * s.pitch + lx], acc);
  round_to(acc, static_cast<T*>(a.out)[(n * a.out_h + oy) * a.out_w + ox]);
}

template <typename T, int KIND>
SR_HD void phase_compute(const Args& a, const Shape& s, const Item& b,
                         const Taps<typename AccOf<T>::type>& k, int tid, unsigned char* smem) {
  using Acc = typename AccOf<T>::type;
  if constexpr (KIND == kGeneric)
    phase_generic<T, Acc>(a, s, b, tid, smem);
  else
    phase_tiles<T, Acc, KIND>(a, s, b, k, tid, smem);
}

}  // namespace ufd

// upfirdn2d (upsample, FIR filter, downsample) as one kernel for Hopper
// (sm_90a), on every card path of the port (ops/upfirdn2d.py: the forward
// and, since the op's adjoint is again an upfirdn2d, every order of its
// gradient); per-output math, tiling and launch shape in upfirdn2d.cuh.
//
// It replaces no TPU kernel: the JAX package leaves upfirdn2d to one XLA
// convolution. It was added because the port's plain version, a zero-stuffed
// and padded copy of the input and a depthwise F.conv2d, landed in ATen's
// generic depthwise kernel (one output a thread, every tap read from device
// memory, three of four taps of an upsample reading stuffed zeros), the
// heaviest device operation of the synthesis and of a training step.
//
// What bounds it on this card: bytes. A 4x4 blur does 16 multiply-adds an
// output, about 8 operations a bfloat16 byte against the card's ~295. So
// the design's whole job is to read the input once and write the output
// once at full bandwidth, with enough reads in flight and few instructions
// an output:
// - persistent blocks, as many as the card holds, each walking its work
//   items (a tile of outputs of one or more planes) with two raw buffers:
//   the next item's input rows arrive while the current one is computed;
// - a row arrives by one 1-D bulk copy (the copy engine, completion on an
//   mbarrier) of the 16-byte aligned span around it, since the transposed
//   conv's 2H+1-wide rows start anywhere; a pass widens the rows into a
//   tile in the accumulate type, zero outside the input;
// - each thread sums a register tile of outputs from 16-byte shared loads,
//   a separable kernel (make_kernel's outer products) down the columns and
//   then along the rows, 11 multiply-adds a blurred output; up 2 reads only
//   its phase's taps of the unstuffed input, down 2 computes only the kept
//   outputs; one vector store an output row, bfloat16 packed two a cvt;
// - small planes share an item, so that the card still has work for every
//   block; integer division stays out of the per-item and per-row paths.

#include <cuda_runtime.h>

#include <mutex>

#include "upfirdn2d.cuh"

namespace {

// A persistent block walks work items blockIdx.x, + gridDim.x, ...: item
// i's rows were brought into raw buffer i & 1 while item i - 1 was
// computed; it brings item i + 1's into the other buffer, waits for its
// own, widens them, and computes the item.
template <typename T, int KIND>
__global__ void __launch_bounds__(ufd::kThreads, 4) upfirdn2d_kernel(ufd::Args a, ufd::Shape s) {
  using Acc = typename ufd::AccOf<T>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int stage = 0; stage < 2; ++stage)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                       ufd::smem_addr(ufd::barrier_of(smem, stage))),
                   "r"(ufd::kThreads)
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  ufd::Taps<Acc> k;
  if constexpr (KIND != ufd::kGeneric) k = ufd::load_taps<Acc>(a);
  const ufd::Walk by = ufd::walk_of(s, gridDim.x);
  ufd::Walk cur = ufd::walk_of(s, blockIdx.x);
  ufd::issue_rows<T>(a, s, ufd::item_at<KIND>(a, s, cur), 0, tid, smem);
  for (int i = 0;; ++i) {
    const int stage = i & 1;
    ufd::Walk next = cur;
    const bool more = ufd::walk_step(s, next, by);
    if (more) ufd::issue_rows<T>(a, s, ufd::item_at<KIND>(a, s, next), stage ^ 1, tid, smem);
    ufd::wait_rows(smem, stage, i >> 1);
    ufd::widen_rows<T, Acc>(s, stage, tid, smem);
    __syncthreads();
    ufd::phase_compute<T, KIND>(a, s, ufd::item_at<KIND>(a, s, cur), k, tid, smem);
    __syncthreads();
    if (!more) break;
    cur = next;
  }
}

template <typename T>
const void* kernel_of(int kind) {
  switch (kind) {
    case ufd::kBlur:
      return reinterpret_cast<const void*>(upfirdn2d_kernel<T, ufd::kBlur>);
    case ufd::kUp2:
      return reinterpret_cast<const void*>(upfirdn2d_kernel<T, ufd::kUp2>);
    case ufd::kDown2:
      return reinterpret_cast<const void*>(upfirdn2d_kernel<T, ufd::kDown2>);
    default:
      return reinterpret_cast<const void*>(upfirdn2d_kernel<T, ufd::kGeneric>);
  }
}

const void* kernel_for(int dtype, int kind) {
  return dtype == 0 ? kernel_of<float>(kind)
                    : dtype == 1 ? kernel_of<uint16_t>(kind) : kernel_of<double>(kind);
}

int acc_bytes_of(int dtype) { return dtype == 2 ? 8 : 4; }

ufd::Shape shape_for(const ufd::Args& a, int dtype, int fill) {
  return ufd::launch_shape(a, dtype == 0 ? 4 : dtype == 1 ? 2 : 8, acc_bytes_of(dtype), fill);
}

// Blocks of `fn` resident on the whole card at `smem` bytes. The first call
// for a kernel on a device raises its dynamic shared memory limit to the
// most a launch shape asks (ufd::max_smem), once; the counts are worked out
// once per (device, kernel, bytes). One lock over both, so that host
// threads may launch at once.
int resident_blocks(const void* fn, int acc_bytes, int smem, int* out) {
  struct Entry {
    const void* fn;
    int dev, smem, blocks;  // smem -1: the limit is raised
  };
  static Entry seen[256];
  static int n_seen = 0;
  static std::mutex lock;
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  std::lock_guard<std::mutex> hold(lock);
  bool raised = false;
  for (int i = 0; i < n_seen; ++i) {
    const Entry& e = seen[i];
    if (e.fn != fn || e.dev != dev) continue;
    raised = raised || e.smem == -1;
    if (e.smem == smem) {
      *out = e.blocks;
      return 0;
    }
  }
  if (!raised) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               ufd::max_smem(acc_bytes));
    if (err != cudaSuccess) return (int)err;
    if (n_seen < 256) seen[n_seen++] = Entry{fn, dev, -1, 0};
  }
  int sms, per_sm;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, ufd::kThreads, smem);
  if (err == cudaSuccess && per_sm < 1) err = cudaErrorInvalidConfiguration;
  if (err != cudaSuccess) return (int)err;
  *out = sms * per_sm;
  if (n_seen < 256) seen[n_seen++] = Entry{fn, dev, smem, *out};
  return 0;
}

// The launch shape, its kernel and its grid (the blocks the card holds at
// its shared memory, at most one an item). Planes share an item only where
// there would still be an item for each block the card holds at one plane
// an item.
int plan(const ufd::Args& a, int dtype, ufd::Shape* s, const void** fn, int* grid) {
  *fn = kernel_for(dtype, ufd::kind_of(a));
  int fill;
  int rc = resident_blocks(*fn, acc_bytes_of(dtype), shape_for(a, dtype, 0).smem, &fill);
  if (rc) return rc;
  *s = shape_for(a, dtype, fill);
  rc = resident_blocks(*fn, acc_bytes_of(dtype), s->smem, grid);
  if (rc) return rc;
  if (*grid > s->items) *grid = (int)s->items;
  return 0;
}

}  // namespace

// x [N, C, H, W] at element strides (sb, sc, sh, sw), dtype 0: float32,
// 1: bfloat16, 2: float64 -> out [N, C, out_h, out_w], contiguous, the
// same type, on `stream`; taps [kh, kw] on the card, contiguous, float32
// (float64 for dtype 2), unflipped. Allocates nothing and never
// synchronises. Returns cudaGetLastError() after the launch (0 on success).
extern "C" int sr_upfirdn2d(const void* x, void* out, const void* taps, int N, int C, int H,
                            int W, long long sb, long long sc, long long sh, long long sw,
                            int out_h, int out_w, int up_x, int up_y, int down_x, int down_y,
                            int pad_x0, int pad_y0, int kh, int kw, int dtype, void* stream) {
  const ufd::Args a{x,     out,   taps,  sb,    sc,     sh,     sw,     N,      C, H, W,
                    out_h, out_w, up_x,  up_y,  down_x, down_y, pad_x0, pad_y0, kh, kw};
  if (ufd::check(a) || dtype < 0 || dtype > 2) return (int)cudaErrorInvalidValue;
  ufd::Shape s;
  const void* fn;
  int grid;
  const int rc = plan(a, dtype, &s, &fn, &grid);
  if (rc) return rc;
  if (s.items > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  void* params[] = {const_cast<ufd::Args*>(&a), const_cast<ufd::Shape*>(&s)};
  const cudaError_t err = cudaLaunchKernel(fn, dim3((unsigned)grid), dim3(ufd::kThreads), params,
                                           (size_t)s.smem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The launch shape for these arguments (x unit-stride along W when
// `unit_w`): out = {kind, rx, ry, tx, ty, tp, sx, sy, tiles_x, tiles_y,
// groups, items, in_w, in_h, pitch, raw_pitch, lanes, bulk, vec, smem,
// the grid (resident blocks), registers per thread, local memory bytes
// per thread (spills)}: the grid at most one block an item.
extern "C" int sr_upfirdn2d_shape(int N, int C, int H, int W, int out_h, int out_w, int up_x,
                                  int up_y, int down_x, int down_y, int pad_x0, int pad_y0,
                                  int kh, int kw, int dtype, int unit_w, int* out) {
  int one = 0;
  const ufd::Args a{&one,  &one, &one, 0,    0,      0,      unit_w ? 1 : 2, N,      C, H, W,
                    out_h, out_w, up_x, up_y, down_x, down_y, pad_x0,        pad_y0, kh, kw};
  if (ufd::check(a) || dtype < 0 || dtype > 2) return (int)cudaErrorInvalidValue;
  ufd::Shape s;
  const void* fn;
  int grid;
  const int rc = plan(a, dtype, &s, &fn, &grid);
  if (rc) return rc;
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  const int vals[23] = {s.kind,     s.rx,          s.ry,        s.tx,     s.ty,    s.tp,
                        s.sx,       s.sy,          s.tiles_x,   s.tiles_y, (int)s.groups,
                        (int)s.items, s.in_w,      s.in_h,      s.pitch,  s.raw_pitch,
                        s.lanes,    s.bulk,        s.vec,       s.smem,   grid,
                        attr.numRegs, (int)attr.localSizeBytes};
  for (int i = 0; i < 23; ++i) out[i] = vals[i];
  return 0;
}

extern "C" const char* sr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

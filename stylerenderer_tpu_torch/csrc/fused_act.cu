// The styled conv's epilogue as one kernel for Hopper (sm_90a):
// demodulation, FiLM, noise, bias, leaky ReLU and gain on the conv's output
// (ops/fused_act.py::fused_bias_act; math and schedule in fused_act.cuh).
//
// It replaces no TPU kernel: the JAX package leaves this chain to XLA,
// which fuses it; the port's plain chain runs it as about ten elementwise
// kernels, each reading and writing the whole activation. One launch reads
// the conv output once and writes the activation once.
//
// What bounds it on this card: bytes. Per element it does about ten float32
// operations on two to four bytes read and written, far under the card's
// 20 operations a byte; at 1024^2, B=16, C=32 in bf16 with FiLM and per-pixel
// float32 noise it must move ~2.28 GB, 0.68 ms at 3.35 TB/s. So the design
// is about bytes and bandwidth: 16-byte loads and stores along W, a block
// that owns a tile of pixels and loops over the channels so that the
// per-pixel FiLM and noise terms come from DRAM once and not C times, and
// enough blocks (fa::launch_shape) to keep one wave of loads in flight.
// The gain arrives as a launch argument, so nothing waits for the host.

#include <cuda_runtime.h>

#include "fused_act.cuh"

namespace {

template <typename T, int V>
__global__ void __launch_bounds__(fa::kThreads) fused_bias_act_kernel(fa::Args a, fa::Shape s) {
  fa::run_thread<T, V>(a, s, blockIdx.x, blockIdx.y, threadIdx.x, threadIdx.y);
}

template <typename T>
int launch(const fa::Args& a, cudaStream_t st) {
  constexpr int V = fa::kVecBytes / (int)sizeof(T);
  const fa::Shape s = fa::launch_shape(a.N, a.C, (long long)a.H * a.W, fa::vec_width<T>(a));
  if (s.blocks > 0x7fffffffLL || s.chunks > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)s.blocks, (unsigned)s.chunks), block(s.tx, s.ty);
  if (s.V == V)
    fused_bias_act_kernel<T, V><<<grid, block, 0, st>>>(a, s);
  else
    fused_bias_act_kernel<T, 1><<<grid, block, 0, st>>>(a, s);
  return (int)cudaGetLastError();
}

}  // namespace

// y [N, C, H*W] (dtype 0: float32, 1: bfloat16) -> out, the same, on
// `stream`; allocates nothing and never synchronises. demod [N, C], bias
// [C] and noise_weight [1] are float32; film_a and film_b are y's type at
// film_a[n * film_bs + p * film_ps]; noise [noise_n, 1, noise_h, noise_w] is
// float32 and contiguous. Null pointers leave their terms out (flags
// name demod, film and bias). Returns cudaGetLastError() after the launch
// (0 on success).
extern "C" int sr_fused_bias_act(const void* y, void* out, const float* demod, const void* film_a,
                                 const void* film_b, const void* noise,
                                 const float* noise_weight, const float* bias, int N, int C, int H,
                                 int W, long long film_bs, long long film_ps, int noise_n,
                                 int noise_h, int noise_w, int flags, int dtype, float slope, float gain, void* stream) {
  const fa::Args a{y,       out,     demod,   film_a,  film_b, noise, noise_weight,
                   bias,    film_bs, film_ps, N,       C,      H,     W,
                   noise_n, noise_h, noise_w, flags,   slope,  gain};
  if (fa::check(a) || dtype < 0 || dtype > 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch<float>(a, st) : launch<uint16_t>(a, st);
}

// The launch shape for these arguments: out = {V, threads along the pixels,
// along the channels, pixel tiles, channel chunks, channels a chunk, rows,
// registers per thread, local memory bytes per thread (spills)}.
extern "C" int sr_fused_bias_act_shape(int N, int C, int H, int W, int dtype, int vec, int* out) {
  if (N < 1 || C < 1 || H < 1 || W < 1 || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  const int V = vec ? fa::kVecBytes / (dtype == 0 ? 4 : 2) : 1;
  const fa::Shape s = fa::launch_shape(N, C, (long long)H * W, V);
  cudaFuncAttributes attr;
  cudaError_t err;
  if (dtype == 0)
    err = cudaFuncGetAttributes(&attr, V == 1 ? fused_bias_act_kernel<float, 1>
                                              : fused_bias_act_kernel<float, 4>);
  else
    err = cudaFuncGetAttributes(&attr, V == 1 ? fused_bias_act_kernel<uint16_t, 1>
                                              : fused_bias_act_kernel<uint16_t, 8>);
  if (err != cudaSuccess) return (int)err;
  const int vals[9] = {s.V, s.tx, s.ty, s.tiles, s.chunks, s.chunk, s.rows, attr.numRegs,
                       (int)attr.localSizeBytes};
  for (int i = 0; i < 9; ++i) out[i] = vals[i];
  return 0;
}

extern "C" const char* sr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

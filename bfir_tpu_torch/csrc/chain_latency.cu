// Latency of each operation on K9's serial chain (csrc/dither_q.cu), for
// the chain bound that chip_smoke.py states beside K9's time. Not a port of
// a TPU kernel: a measurement.
//
// One warp runs 16 x iters repetitions of "x = op(x); x = x + b", each
// depending on the last, between two clock64() reads; kind 0 is the add
// alone, so op's latency is the difference. Kinds: 0 add, 1 truncation,
// 2 max, 3 a select whose predicate is ready early (as K9's clip select
// on the sign and clip flags), in float32 or float64 (the add, truncation,
// max and select of K9's two instantiations).

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float op_trunc(float v) { return truncf(v); }
__device__ __forceinline__ double op_trunc(double v) { return trunc(v); }
__device__ __forceinline__ float op_max(float a, float b) {
  return fmaxf(a, b);
}
__device__ __forceinline__ double op_max(double a, double b) {
  return fmax(a, b);
}

template <typename T, int K>
__global__ void __launch_bounds__(32)
    chain_kernel(const T* __restrict__ in, T* __restrict__ out,
                 long long* __restrict__ cycles, int iters, unsigned mask) {
  T x = in[threadIdx.x % 4];
  const T b = in[4], c = in[5];
  const long long t0 = clock64();
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      if constexpr (K == 1) x = op_trunc(x);
      if constexpr (K == 2) x = op_max(x, c);
      if constexpr (K == 3) x = (mask >> u) & 1 ? c : x;
      x = x + b;
    }
  }
  const long long t1 = clock64();
  out[threadIdx.x] = x;
  cycles[threadIdx.x] = t1 - t0;
}

template <typename T>
int launch(int kind, const void* in, void* out, long long* cycles, int iters,
           unsigned mask, cudaStream_t s) {
  using Kernel = void (*)(const T*, T*, long long*, int, unsigned);
  const Kernel kernels[] = {chain_kernel<T, 0>, chain_kernel<T, 1>,
                            chain_kernel<T, 2>, chain_kernel<T, 3>};
  if (kind < 0 || kind > 3) return static_cast<int>(cudaErrorInvalidValue);
  kernels[kind]<<<1, 32, 0, s>>>(static_cast<const T*>(in),
                                 static_cast<T*>(out), cycles, iters, mask);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// in: 6 values (four starting x, the addend b, the operand c) of float32
// (is_f64 = 0) or float64; out [32] of the same type; cycles [32] int64:
// each lane's clock64() span over 16 x iters repetitions. mask picks the
// select's side at each of the 16 unrolled steps (kind 3).
extern "C" int bfir_chain_latency(int kind, int is_f64, const void* in,
                                  void* out, long long* cycles, int iters,
                                  unsigned mask, void* stream) {
  if (iters < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_f64 ? launch<double>(kind, in, out, cycles, iters, mask, s)
                : launch<float>(kind, in, out, cycles, iters, mask, s);
}

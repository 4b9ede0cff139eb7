// Overlap-save tail inverse for Hopper (sm_90a): kernel K4 of the port.
//
// Replaces bfir_tpu/kernels/fft_fused.py::cfft_balanced_fused as reached by
// ::irfft_split_hc_tail_balanced (the two-stage engine's tail-fire inverse).
//
// Input: halfcomplex planes hr, hi [rows, >= h] (lane 0 = (DC.re,
// Nyquist.re)) of a length-n = 2h real spectrum. Output: samples [h, n) of
// its inverse real FFT, [rows, h]. Per row, in one block:
//   1. tangle (fft_fused._tangle_xla): the spectrum of the packed
//      length-h complex sequence z[j] = x[2j] + i x[2j+1];
//   2. inverse length-h complex FFT of z, with the 1/h scale;
//   3. keep z[h/2 .. h) and write it as interleaved (re, im) sample pairs.
// The transform is computed here, by the kernel, not by cuFFT.
//
// What bounds it on the H100: at the tail geometry (64 rows, h = 8192) it
// reads 4 MB and writes 2 MB, and does about 5 h log2(h) = 0.5 MFLOP per
// row, so neither memory nor arithmetic bounds it: the rows' passes through
// shared memory and the barriers between the 13 radix-2 stages do. 64 rows
// are 64 blocks, under half of the 132 SMs: a later version should split a
// row over a cluster of blocks or use more rows per call.
//
// Design: one block per row keeps the whole 8192-point sequence (64 KB of
// float2) in dynamic shared memory, above the 48 KB static limit, so the
// launch raises the kernel's MaxDynamicSharedMemorySize first. The tangle
// writes straight into bit-reversed order, the radix-2 stages run in place,
// and the twiddles come from tables built in float64 and rounded once to
// float32. Lane-padded input rows are read through their row stride.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxH = 16384;  // 128 KB of float2 shared memory

__global__ void __launch_bounds__(kThreads)
    irfft_hc_tail_kernel(const float* __restrict__ hr,
                         const float* __restrict__ hi, long long in_stride,
                         float* __restrict__ out,
                         const float2* __restrict__ tw_n,
                         const float2* __restrict__ tw_h, int h, int log2h) {
  extern __shared__ float2 z[];
  const float* r = hr + blockIdx.x * in_stride;
  const float* q = hi + blockIdx.x * in_stride;
  const float dc = r[0];
  const float ny = q[0];
  // 1. tangle: A = (X[k] + X*[h-k]) / 2, D = (X[k] - X*[h-k]) / 2,
  //    Z[k] = A + i e^{+2 pi i k / n} D; lane 0 holds DC and Nyquist
  for (int k = threadIdx.x; k < h; k += kThreads) {
    const float xr = k ? r[k] : dc;
    const float xi = k ? q[k] : 0.f;
    const float vr = k ? r[h - k] : ny;
    const float vi = k ? q[h - k] : 0.f;
    const float ar = 0.5f * (xr + vr);
    const float ai = 0.5f * (xi - vi);
    const float dr = 0.5f * (xr - vr);
    const float di = 0.5f * (xi + vi);
    const float2 w = tw_n[k];
    const float er = w.x * dr - w.y * di;
    const float ei = w.x * di + w.y * dr;
    z[__brev(static_cast<unsigned int>(k)) >> (32 - log2h)] =
        make_float2(ar - ei, ai + er);
  }
  __syncthreads();
  // 2. in-place radix-2 decimation-in-time inverse FFT
  for (int s = 0, half = 1; half < h; ++s, half <<= 1) {
    const int stride = (h >> 1) >> s;  // twiddle e^{+2 pi i j / (2 half)}
    for (int b = threadIdx.x; b < (h >> 1); b += kThreads) {
      const int j = b & (half - 1);
      const int a = ((b >> s) << (s + 1)) | j;
      const float2 w = tw_h[j * stride];
      const float2 u = z[a];
      const float2 v = z[a + half];
      const float tr = w.x * v.x - w.y * v.y;
      const float ti = w.x * v.y + w.y * v.x;
      z[a] = make_float2(u.x + tr, u.y + ti);
      z[a + half] = make_float2(u.x - tr, u.y - ti);
    }
    __syncthreads();
  }
  // 3. tail half of z -> real sample pairs (2i, 2i + 1)
  float2* o = reinterpret_cast<float2*>(out + static_cast<long long>(blockIdx.x) * h);
  const float inv = 1.0f / static_cast<float>(h);
  for (int i = threadIdx.x; i < (h >> 1); i += kThreads) {
    const float2 v = z[(h >> 1) + i];
    o[i] = make_float2(v.x * inv, v.y * inv);
  }
}

}  // namespace

// tw_n: e^{+2 pi i k / (2h)} for k < h; tw_h: e^{+2 pi i j / h} for j < h/2,
// both as interleaved float32 (cos, sin). Returns the cudaError_t of the
// launch.
extern "C" int bfir_irfft_hc_tail(const float* hr, const float* hi,
                                  long long in_stride, float* out,
                                  const float* tw_n, const float* tw_h,
                                  int rows, int h, void* stream) {
  if (rows < 1 || h < 2 || (h & (h - 1)) || h > kMaxH || in_stride < h)
    return static_cast<int>(cudaErrorInvalidValue);
  int log2h = 0;
  while ((1 << log2h) < h) ++log2h;
  const int smem = h * static_cast<int>(sizeof(float2));
  cudaError_t e = cudaFuncSetAttribute(
      irfft_hc_tail_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  irfft_hc_tail_kernel<<<rows, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      hr, hi, in_stride, out, reinterpret_cast<const float2*>(tw_n),
      reinterpret_cast<const float2*>(tw_h), h, log2h);
  return static_cast<int>(cudaGetLastError());
}

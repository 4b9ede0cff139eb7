// Overlap-save tail inverse for Hopper (sm_90a): kernel K4 of the port.
//
// Replaces bfir_tpu/kernels/fft_fused.py::cfft_balanced_fused as reached by
// ::irfft_split_hc_tail_balanced (the two-stage engine's tail-fire inverse).
//
// Input: halfcomplex planes hr, hi [rows, >= h] (lane 0 = (DC.re,
// Nyquist.re)) of a length-n = 2h real spectrum. Output: samples [h, n) of
// its inverse real FFT, [rows, h]. Per row:
//   1. tangle (fft_fused._tangle_xla): the spectrum of the packed
//      length-h complex sequence z[j] = x[2j] + i x[2j+1];
//   2. inverse length-h complex FFT of z, with the 1/h scale;
//   3. keep z[h/2 .. h) and write it as interleaved (re, im) sample pairs.
// The transform is computed here, by the kernel, not by cuFFT.
//
// What bounds it on the H100: at the tail geometry (64 rows, h = 8192) it
// reads 4 MB and writes 2 MB (1.9 us at 3.35 TB/s) and does about
// 5 h log2 h = 0.5 MFLOP a row (0.5 us at 67 TFLOP/s): bytes bound it, but
// a row's passes through shared memory, their barriers and the latency of
// 64 rows on 132 SMs hold it above that.
//
// Design: the register-radix, self-sorting core of fft_common.cuh
// (bfir::fft::core). Pass 0 tangles as it loads: each of its points k
// reads hr[k], hi[k], the mirrored hr[h-k], hi[h-k] and tw[k], a
// half-warp's 16 consecutive k at a time (coalesced, through the row
// stride of lane-padded planes). h = 8192 runs as 32 x 16 x 16 by a block
// of 512 threads (16 points each) with three barriers; h = 1024 as
// 32 x 32 by 128 threads (8 points each: five loads a point want more
// threads in flight) with one barrier; a block a row. The last pass
// writes only points [h/2, h), the upper half of each radix-R butterfly
// (the only half computed where one thread holds the butterfly), from
// registers as (re, im) x 1/h pairs. The
// twiddles come from the caller's one float64-built table
// e^{-2 pi i t / 2h}: the tangle's e^{+2 pi i k / 2h} as its conjugate, the
// FFT's from the quarter table staged into shared memory. The kernel's
// shared-memory size is raised once per size and device, not per launch.

#include <cuda_runtime.h>

#include "fft_common.cuh"

namespace {

namespace F = bfir::fft;
namespace C = bfir::fft::core;

template <class Sh>
__global__ void __launch_bounds__(Sh::T)
    irfft_hc_tail_kernel(const float* __restrict__ hr,
                         const float* __restrict__ hi, long long in_stride,
                         float* __restrict__ out,
                         const float2* __restrict__ tw) {
  extern __shared__ float2 smem[];
  float2* q = smem + Sh::H;
  C::stage_quarter<Sh::L>(q, tw);
  const long long row = blockIdx.x;
  const float* r = hr + row * in_stride;
  const float* i = hi + row * in_stride;
  float2* o = reinterpret_cast<float2*>(out + row * Sh::H);
  const float inv = 1.0f / static_cast<float>(Sh::H);
  C::run<Sh, true, true>(
      smem, q, threadIdx.x,
      [&](int k) { return F::tangle(r, i, k, Sh::H, tw); },
      [&](int k, float2 v) { o[k - Sh::H / 2] = F::scale(v, inv); });
}

// 8 points a thread at h = 1024 (five loads a point want more threads in
// flight there), 16 elsewhere
template <int L, class Sh = C::Shape<L, L == 10 ? 8 : 16>>
int launch(const float* hr, const float* hi, long long in_stride, float* out,
           const float2* tw, int rows, cudaStream_t stream) {
  return static_cast<int>(C::launch_rows<irfft_hc_tail_kernel<Sh>, Sh>(
      rows, stream, hr, hi, in_stride, out, tw));
}

}  // namespace

// tw: e^{-2 pi i t / 2h} for t < 2h as interleaved float32 (cos, sin);
// h a power of two in [1024, 16384]. Returns the cudaError_t of the
// launch.
extern "C" int bfir_irfft_hc_tail(const float* hr, const float* hi,
                                  long long in_stride, float* out,
                                  const float* tw, int rows, int h,
                                  void* stream) {
  if (rows < 1 || in_stride < h)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* t = reinterpret_cast<const float2*>(tw);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (h) {
    case 1024: return launch<10>(hr, hi, in_stride, out, t, rows, s);
    case 2048: return launch<11>(hr, hi, in_stride, out, t, rows, s);
    case 4096: return launch<12>(hr, hi, in_stride, out, t, rows, s);
    case 8192: return launch<13>(hr, hi, in_stride, out, t, rows, s);
    case 16384: return launch<14>(hr, hi, in_stride, out, t, rows, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

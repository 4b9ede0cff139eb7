// Overlap-save tail inverse for Hopper (sm_90a): kernels K4, K16 and K17
// of the port, one kernel.
//
// Replaces three TPU kernels that compute one function:
//   K4  bfir_tpu/kernels/fft_fused.py::cfft_balanced_fused (pallas_call
//       :392) as reached by ::irfft_split_hc_tail_balanced (the two-stage
//       engine's tail-fire inverse);
//   K16 fft_fused.py::irfft_hc_tail_fused (pallas_call :274);
//   K17 bfir_tpu/kernels/fft_pallas.py::irfft_hc_tail_pallas
//       (pallas_call :206).
// They differ only in how they feed the TPU's matrix unit (a balanced
// n1 x 128 split, radix-4 decimation in frequency, an inverse four-step);
// on the H100 one kernel serves all three, and each wrapper keeps its own
// domain and launch count (kernels/fft_fused.py, kernels/fft_pallas.py).
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
// 5 h log2 h = 0.5 MFLOP a row (0.5 us at 67 TFLOP/s); at session G's
// shape (h = 1024) 0.8 MB, 0.2 us. Bytes bound it, but a row's passes
// through shared memory, their barriers and the latency of 64 rows on 132
// SMs hold it above that.
//
// Design: the register-radix, self-sorting core of fft_common.cuh
// (bfir::fft::core). Pass 0 tangles as it loads: each of its points k
// reads hr[k], hi[k], the mirrored hr[h-k], hi[h-k] and tw[k], a
// half-warp's 16 consecutive k at a time (coalesced, through the row
// stride of lane-padded planes). A block takes a row: h / tail_points(L)
// threads, each holding that many points in registers (8 up to h = 4096,
// 16 above), one block barrier at h <= 1024 and three above. The last
// pass writes only points [h/2, h), the upper half of each radix-R
// butterfly (the only half computed where one thread holds the
// butterfly), from registers as (re, im) x 1/h pairs. No pass reads a
// twiddle from device memory after the tangle's: the FFT's come from the
// quarter table staged into shared memory, from the caller's one
// float64-built table e^{-2 pi i t / 2h} (the tangle's e^{+2 pi i k / 2h}
// is its conjugate). The kernel's
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

// points a thread by log2 h: 8 up to h = 4096 (five loads a point want
// many threads in flight), 16 at 8192 and 16384; the fastest of 8, 16 and
// 32 at each h on the card (PERF.md §6)
constexpr int tail_points(int L) { return L >= 13 ? 16 : 8; }

template <int L, class Sh = C::Shape<L, tail_points(L)>>
int launch(const float* hr, const float* hi, long long in_stride, float* out,
           const float2* tw, int rows, cudaStream_t stream) {
  return static_cast<int>(C::launch_rows<irfft_hc_tail_kernel<Sh>, Sh>(
      rows, stream, hr, hi, in_stride, out, tw));
}

}  // namespace

// K4, K16 and K17. hr, hi: [rows, in_stride] with the planes in the first
// h lanes; out: [rows, h]; tw: e^{-2 pi i t / 2h} for t < 2h as
// interleaved float32 (cos, sin); h a power of two in [512, 16384].
// Returns the cudaError_t of the launch.
extern "C" int bfir_irfft_hc_tail(const float* hr, const float* hi,
                                  long long in_stride, float* out,
                                  const float* tw, int rows, int h,
                                  void* stream) {
  if (rows < 1 || in_stride < h)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* t = reinterpret_cast<const float2*>(tw);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (h) {
    case 512: return launch<9>(hr, hi, in_stride, out, t, rows, s);
    case 1024: return launch<10>(hr, hi, in_stride, out, t, rows, s);
    case 2048: return launch<11>(hr, hi, in_stride, out, t, rows, s);
    case 4096: return launch<12>(hr, hi, in_stride, out, t, rows, s);
    case 8192: return launch<13>(hr, hi, in_stride, out, t, rows, s);
    case 16384: return launch<14>(hr, hi, in_stride, out, t, rows, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

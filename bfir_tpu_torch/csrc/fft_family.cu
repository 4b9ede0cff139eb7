// The forward FFTs for Hopper (sm_90a): kernels K14, K15 and K18 of the
// port.
//
// Two kernels, two functions, each transform computed in the kernel's
// own body (no cuFFT):
//
//   K14 cfft_balanced    replaces bfir_tpu/kernels/fft_fused.py::
//                        cfft_balanced_fused (pallas_call :392) as reached by
//                        ::rfft_split_hc_balanced: the length-h complex FFT
//                        of split planes, forward or inverse (with 1/h), in
//                        natural order, optionally only outputs [h/2, h).
//   K15 rfft_hc          replaces fft_fused.py::rfft_hc_fused (:148): rfft ->
//                        halfcomplex planes.
//   K18 rfft_hc          replaces bfir_tpu/kernels/fft_pallas.py::
//                        rfft_hc_pallas (:303): the same function as K15, so
//                        the same kernel (the TPU kernels differ only in how
//                        they feed the MXU).
//
// The inverse tails (K4, K16, K17) are one kernel in csrc/irfft_hc_tail.cu.
// The forward real transform uses the real-packing route of the reference:
// the length-n real sequence x is the length-h = n/2 complex sequence
// z[j] = x[2j] + i x[2j+1], whose spectrum Z is untangled into the
// halfcomplex planes (lane 0 = (DC.re, Nyquist.re)).
//
// What bounds them on the H100: at the streaming shape ([64, 2048], h =
// 1024) a call moves 1 MB, 0.3 us at 3.35 TB/s, and does 5 h log2 h = 51
// kflop a row, 0.05 us at 67 TFLOP/s; at the tail shape ([64, 16384], h =
// 8192) 8 MB and 0.5 Mflop a row. Neither memory nor arithmetic bounds
// them: the latency of a row's passes (dependent loads, barriers, the
// exchanges through shared memory) does, and 64 rows are 64 blocks on 132
// SMs.
//
// Design. Both run on the register-radix, self-sorting core of
// fft_common.cuh (bfir::fft::core): points in registers, butterflies of
// radix 8-32 there (a radix-32 one over two lane groups with shuffles),
// Stockham passes through a swizzled, conflict-free buffer, one block
// barrier at h <= 1024 and three above, the twiddles from a quarter table
// staged by cp.async; one block a row, whose shared-memory size is raised
// once per size and device, not on every launch. Twiddles come from one
// table per length, tw[t] = e^{-2 pi i t / 2h} for t < 2h, built in
// float64 and rounded once to float32.
//   - K14 loads split planes and stores natural-order planes from
//     registers;
//   - K15/K18 load sample pair k as one coalesced float2 (no bit
//     reversal), keep Z in shared memory (core::run's KEEP) and untangle
//     in pairs: a thread reads Z[k] and Z[h-k] and writes hc lanes k and
//     h - k (X[h-k] = conj(A - W B), the mirror of X[k] = A + W B), so
//     every point of Z is read once, with W = tw[k] read coalesced from
//     the caller's table; k = 0 takes Z[h/2] for its mirror and writes
//     lanes 0 and h/2.

#include <cuda_runtime.h>

#include "fft_common.cuh"

namespace {

namespace C = bfir::fft::core;

// K14: the length-h complex FFT of split planes on the register-radix core
// (fft_common.cuh): pass 0 loads zr[k], zi[k] coalesced, the last pass
// writes natural-order split planes from registers, x 1/h for the inverse,
// only outputs [h/2, h) with TAIL.
template <class Sh, bool INV, bool TAIL>
__global__ void __launch_bounds__(Sh::T)
    cfft_balanced_kernel(const float* __restrict__ zr,
                         const float* __restrict__ zi,
                         float* __restrict__ out_r, float* __restrict__ out_i,
                         const float2* __restrict__ tw) {
  constexpr int kOut = TAIL ? Sh::H / 2 : Sh::H;
  extern __shared__ float2 smem[];
  float2* q = smem + Sh::H;
  C::stage_quarter<Sh::L>(q, tw);
  const long long row = blockIdx.x;
  const long long in_off = row * Sh::H;
  const long long out_off = row * kOut - (Sh::H - kOut);
  const float s = INV ? 1.0f / static_cast<float>(Sh::H) : 1.0f;
  C::run<Sh, INV, TAIL>(
      smem, q, threadIdx.x,
      [&](int k) {
        return make_float2(__ldg(zr + in_off + k), __ldg(zi + in_off + k));
      },
      [&](int k, float2 v) {
        out_r[out_off + k] = v.x * s;
        out_i[out_off + k] = v.y * s;
      });
}

// 16 points a thread, 32 at h = 8192 (fewer, fuller threads measured
// faster there)
template <int L, bool INV, bool TAIL, class Sh = C::Shape<L, L == 13 ? 32 : 16>>
int launch_cfft(const float* zr, const float* zi, float* out_r, float* out_i,
                const float2* tw, int rows, cudaStream_t stream) {
  return static_cast<int>(
      C::launch_rows<cfft_balanced_kernel<Sh, INV, TAIL>, Sh>(
          rows, stream, zr, zi, out_r, out_i, tw));
}

template <bool INV, bool TAIL>
int launch_cfft_h(const float* zr, const float* zi, float* o_r, float* o_i,
                  const float2* tw, int rows, int h, cudaStream_t s) {
  switch (h) {
    case 1024: return launch_cfft<10, INV, TAIL>(zr, zi, o_r, o_i, tw, rows, s);
    case 2048: return launch_cfft<11, INV, TAIL>(zr, zi, o_r, o_i, tw, rows, s);
    case 4096: return launch_cfft<12, INV, TAIL>(zr, zi, o_r, o_i, tw, rows, s);
    case 8192: return launch_cfft<13, INV, TAIL>(zr, zi, o_r, o_i, tw, rows, s);
    case 16384:
      return launch_cfft<14, INV, TAIL>(zr, zi, o_r, o_i, tw, rows, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K15/K18: rfft of rows of 2h samples -> halfcomplex planes on the core.
// Pass 0 loads sample pair k, z[k] = x[2k] + i x[2k+1], as one float2; the
// core leaves Z in shared memory (zslot order); then thread t untangles
// the pairs (k, h - k) for k = t + b T < h/2, (0, h/2) for k = 0:
// A = (Z[k] + Z*[h-k]) / 2, B = -i (Z[k] - Z*[h-k]) / 2, W = tw[k] =
// e^{-2 pi i k / 2h}; X[k] = A + W B, X[h-k] = conj(A - W B); lane 0 =
// (Re Z0 + Im Z0, Re Z0 - Im Z0), lane h/2 = conj(Z[h/2]). A thread issues
// all its loads before its math and selects, not branches, for k = 0, so
// its pairs wait on one load latency, not one each (a branch per pair
// measured 1.2 us slower at h = 1024).
template <class Sh>
__global__ void __launch_bounds__(Sh::T)
    rfft_hc_kernel(const float* __restrict__ x, float* __restrict__ hr,
                   float* __restrict__ hi, const float2* __restrict__ tw) {
  extern __shared__ float2 smem[];
  float2* q = smem + Sh::H;
  C::stage_quarter<Sh::L>(q, tw);
  const long long row = blockIdx.x;
  const float2* pairs = reinterpret_cast<const float2*>(x) + row * Sh::H;
  C::run<Sh, false, false, true>(
      smem, q, threadIdx.x, [&](int k) { return __ldg(pairs + k); },
      [&](int k, float2 v) { smem[C::zslot<Sh::L>(k)] = v; });
  float* re = hr + row * Sh::H;
  float* im = hi + row * Sh::H;
  constexpr int kPairs = Sh::PTS / 2;  // pairs a thread
  float2 p[kPairs], m[kPairs], w[kPairs];
#pragma unroll
  for (int b = 0; b < kPairs; ++b) {
    const int k = threadIdx.x + b * Sh::T;
    const bool dc = b == 0 && k == 0;  // lanes 0 and h/2
    p[b] = smem[C::zslot<Sh::L>(k)];
    m[b] = smem[C::zslot<Sh::L>(dc ? Sh::H / 2 : Sh::H - k)];
    w[b] = __ldg(tw + k);
  }
#pragma unroll
  for (int b = 0; b < kPairs; ++b) {
    const int k = threadIdx.x + b * Sh::T;
    const float ar = 0.5f * (p[b].x + m[b].x);
    const float ai = 0.5f * (p[b].y - m[b].y);
    const float br = 0.5f * (p[b].y + m[b].y);
    const float bi = -0.5f * (p[b].x - m[b].x);
    const float cr = w[b].x * br - w[b].y * bi;  // W B
    const float ci = w[b].x * bi + w[b].y * br;
    const bool dc = b == 0 && k == 0;
    re[k] = dc ? p[b].x + p[b].y : ar + cr;
    im[k] = dc ? p[b].x - p[b].y : ai + ci;
    const int k2 = dc ? Sh::H / 2 : Sh::H - k;
    re[k2] = dc ? m[b].x : ar - cr;
    im[k2] = dc ? -m[b].y : ci - ai;
  }
}

// points a thread of K15/K18 by log2 h: 16, and 32 (half the threads) at
// h = 16384, the faster of 8, 16 and 32 at each h on the card (PERF.md)
constexpr int rfft_points(int L) { return L == 14 ? 32 : 16; }

template <int L, class Sh = C::Shape<L, rfft_points(L)>>
int launch_rfft(const float* x, float* hr, float* hi, const float2* tw,
                int rows, cudaStream_t stream) {
  return static_cast<int>(C::launch_rows<rfft_hc_kernel<Sh>, Sh>(
      rows, stream, x, hr, hi, tw));
}

}  // namespace

// tw: e^{-2 pi i t / 2h} for t < 2h as interleaved float32 (cos, sin) in
// every entry point below. Each returns the cudaError_t of its launch.

// K14. zr, zi: [rows, h] contiguous; out_r, out_i: [rows, h] or, with
// tail_only, [rows, h/2]; h a power of two in [1024, 16384].
extern "C" int bfir_cfft_balanced(const float* zr, const float* zi,
                                  float* out_r, float* out_i, const float* tw,
                                  int rows, int h, int inverse, int tail_only,
                                  void* stream) {
  if (rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto* t = reinterpret_cast<const float2*>(tw);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto fn = inverse ? (tail_only ? launch_cfft_h<true, true>
                                       : launch_cfft_h<true, false>)
                          : (tail_only ? launch_cfft_h<false, true>
                                       : launch_cfft_h<false, false>);
  return fn(zr, zi, out_r, out_i, t, rows, h, s);
}

// K15 and K18. x: [rows, 2h] contiguous, 8-byte aligned; hr, hi:
// [rows, h]; h a power of two in [512, 16384].
extern "C" int bfir_rfft_hc(const float* x, float* hr, float* hi,
                            const float* tw, int rows, int h, void* stream) {
  if (rows < 1 || reinterpret_cast<size_t>(x) % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* t = reinterpret_cast<const float2*>(tw);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (h) {
    case 512: return launch_rfft<9>(x, hr, hi, t, rows, s);
    case 1024: return launch_rfft<10>(x, hr, hi, t, rows, s);
    case 2048: return launch_rfft<11>(x, hr, hi, t, rows, s);
    case 4096: return launch_rfft<12>(x, hr, hi, t, rows, s);
    case 8192: return launch_rfft<13>(x, hr, hi, t, rows, s);
    case 16384: return launch_rfft<14>(x, hr, hi, t, rows, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

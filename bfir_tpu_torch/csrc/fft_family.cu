// The FFT family for Hopper (sm_90a): kernels K14-K18 of the port.
//
// Five kernels, three functions, each transform computed in the kernel's
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
//   K16 irfft_tail_dif   replaces fft_fused.py::irfft_hc_tail_fused (:274):
//                        halfcomplex planes -> samples [n/2, n) of the
//                        inverse, radix-4 decimation in frequency.
//   K17 irfft_tail_4step replaces fft_pallas.py::irfft_hc_tail_pallas
//                        (:206): the same function as K16, as an inverse
//                        four-step.
//
// The real transforms use the real-packing route of the reference: the
// length-n real sequence x is the length-h = n/2 complex sequence
// z[j] = x[2j] + i x[2j+1]; the forward untangles Z into the halfcomplex
// planes (lane 0 = (DC.re, Nyquist.re)), the inverse tangles the planes
// into Z first (fft_common.cuh).
//
// What bounds them on the H100: at the streaming shape ([64, 2048], h =
// 1024) a call moves 1 MB, 0.3 us at 3.35 TB/s, and does 5 h log2 h = 51
// kflop a row, 0.05 us at 67 TFLOP/s; at the tail shape ([64, 16384], h =
// 8192) 8 MB and 0.5 Mflop a row. Neither memory nor arithmetic bounds
// them: the latency of a row's passes (dependent loads, barriers, the
// exchanges through shared memory) does, and 64 rows are 64 blocks on 132
// SMs.
//
// Design. K14, K15 and K18 run on the register-radix, self-sorting core
// of fft_common.cuh (bfir::fft::core): points in registers, butterflies
// of radix 8-32 there (a radix-32 one over two lane groups with
// shuffles), Stockham passes through a swizzled, conflict-free buffer, one
// block barrier at h <= 1024 and three above, the twiddles from a quarter
// table staged by cp.async; one block a row, whose shared-memory size is
// raised once per size and device, not on every launch.
//   - K14 loads split planes and stores natural-order planes from
//     registers;
//   - K15/K18 load sample pair k as one coalesced float2 (no bit
//     reversal), keep Z in shared memory (core::run's KEEP) and untangle
//     in pairs: a thread reads Z[k] and Z[h-k] and writes hc lanes k and
//     h - k (X[h-k] = conj(A - W B), the mirror of X[k] = A + W B), so
//     every point of Z is read once, with W = tw[k] read coalesced from
//     the caller's table; k = 0 takes Z[h/2] for its mirror and writes
//     lanes 0 and h/2.
// K16 and K17 run stages over a row in shared memory (tw read from
// device memory per butterfly, bank conflicts in the strided stages):
//   - K16 (radix-4 DIF): the tangle and the radix-4 butterflies of the
//     four contiguous spectrum quarters in one pass, then four length-h/4
//     inverse sub-transforms whose last radix-4 stage computes only the
//     tail half of its outputs; the re/im interleave is the store index;
//   - K17 (inverse four-step): the tangle stores the four stride-4
//     subsequences apart, four length-h/4 radix-2 sub-transforms run side
//     by side, and the last radix-4 combine, twiddle folded in, computes
//     only the outputs i2 in {2, 3}: half of its butterflies.
// Their blocks are sized to a stage's work (at most 1024 threads), and
// their shared-memory limit is raised once per kernel and device. Twiddles
// come from one table per length, tw[t] = e^{-2 pi i t / 2h} for t < 2h,
// built in float64 and rounded once to float32.

#include <cuda_runtime.h>

#include "fft_common.cuh"

namespace {

namespace F = bfir::fft;
namespace C = bfir::fft::core;

constexpr int kMaxH = 16384;  // 128 KB of float2 shared memory

int log2_of(int v) {
  int l = 0;
  while ((1 << l) < v) ++l;
  return l;
}

int clamp_threads(int work) {
  return work < 128 ? 128 : (work > 1024 ? 1024 : work);
}

// K16: radix-4 DIF inverse of the tangled spectrum, tail outputs only.
// c[4 i1 + r] = (1/h) IDFT_n1(u_r)[i1], u_r[k1] = e^{+2 pi i r k1 / h}
// sum_q Z[k1 + q n1] i^{q r}; the tail [h/2, h) is i1 >= n1/2.
__global__ void __launch_bounds__(1024)
    irfft_tail_dif_kernel(const float* __restrict__ hr,
                          const float* __restrict__ hi, long long in_stride,
                          float* __restrict__ out,
                          const float2* __restrict__ tw, int h, int log2n1) {
  extern __shared__ float2 z[];
  const int n1 = h >> 2;
  const float* r = hr + blockIdx.x * in_stride;
  const float* q = hi + blockIdx.x * in_stride;
  for (int k1 = threadIdx.x; k1 < n1; k1 += blockDim.x) {
    const float2 z0 = F::tangle(r, q, k1, h, tw);
    const float2 z1 = F::tangle(r, q, k1 + n1, h, tw);
    const float2 z2 = F::tangle(r, q, k1 + 2 * n1, h, tw);
    const float2 z3 = F::tangle(r, q, k1 + 3 * n1, h, tw);
    const float2 s02 = F::add(z0, z2), d02 = F::sub(z0, z2);
    const float2 s13 = F::add(z1, z3);
    const float2 id13 = F::rot(F::sub(z1, z3), true);  // +i (z1 - z3)
    const int p = F::bitrev(k1, log2n1);
    z[p] = F::add(s02, s13);
    z[n1 + p] = F::mul(F::twiddle(tw, 2 * k1, true), F::add(d02, id13));
    z[2 * n1 + p] = F::mul(F::twiddle(tw, 4 * k1, true), F::sub(s02, s13));
    z[3 * n1 + p] = F::mul(F::twiddle(tw, 6 * k1, true), F::sub(d02, id13));
  }
  __syncthreads();
  int quarter = 1;
  if (log2n1 & 1) {
    F::radix2_stage(z, h, 0, 1, tw, 2 * h, true);
    __syncthreads();
    quarter = 2;
  }
  for (; quarter < n1; quarter <<= 2) {
    F::radix4_stage(z, h, quarter, tw, 2 * h, true, 4 * quarter == n1);
    __syncthreads();
  }
  // tail pair 4 i1' + r = c[4 (i1' + n1/2) + r] -> samples (2t, 2t + 1)
  float2* o = reinterpret_cast<float2*>(out + static_cast<long long>(blockIdx.x) * h);
  const float inv = 1.0f / static_cast<float>(h);
  for (int t = threadIdx.x; t < (h >> 1); t += blockDim.x)
    o[t] = F::scale(z[(t & 3) * n1 + (n1 >> 1) + (t >> 2)], inv);
}

// K17: inverse four-step of the tangled spectrum, tail outputs only.
// j = 4 j1 + j2, i = i1 + n1 i2: t_j2[i1] = e^{+2 pi i j2 i1 / h}
// IDFT_n1(Z[4 j1 + j2])[i1], c[i1 + n1 i2] = (1/h) sum_j2 i^{j2 i2} t_j2[i1];
// the tail [h/2, h) is i2 in {2, 3}.
__global__ void __launch_bounds__(1024)
    irfft_tail_4step_kernel(const float* __restrict__ hr,
                            const float* __restrict__ hi,
                            long long in_stride, float* __restrict__ out,
                            const float2* __restrict__ tw, int h,
                            int log2n1) {
  extern __shared__ float2 z[];
  const int n1 = h >> 2;
  const float* r = hr + blockIdx.x * in_stride;
  const float* q = hi + blockIdx.x * in_stride;
  for (int k = threadIdx.x; k < h; k += blockDim.x)
    z[(k & 3) * n1 + F::bitrev(k >> 2, log2n1)] = F::tangle(r, q, k, h, tw);
  __syncthreads();
  for (int half = 1; half < n1; half <<= 1) {
    F::radix2_stage(z, h, 0, half, tw, 2 * h, true);
    __syncthreads();
  }
  float2* o = reinterpret_cast<float2*>(out + static_cast<long long>(blockIdx.x) * h);
  const float inv = 1.0f / static_cast<float>(h);
  for (int i1 = threadIdx.x; i1 < n1; i1 += blockDim.x) {
    const float2 t0 = z[i1];
    const float2 t1 = F::mul(F::twiddle(tw, 2 * i1, true), z[n1 + i1]);
    const float2 t2 = F::mul(F::twiddle(tw, 4 * i1, true), z[2 * n1 + i1]);
    const float2 t3 = F::mul(F::twiddle(tw, 6 * i1, true), z[3 * n1 + i1]);
    const float2 s02 = F::add(t0, t2), d02 = F::sub(t0, t2);
    o[i1] = F::scale(F::sub(s02, F::add(t1, t3)), inv);           // i2 = 2
    o[n1 + i1] = F::scale(F::sub(d02, F::rot(F::sub(t1, t3), true)),
                          inv);                                    // i2 = 3
  }
}

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

// h a power of two in [h_min, kMaxH]
bool bad_h(int h, int h_min) {
  return h < h_min || (h & (h - 1)) || h > kMaxH;
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

// K16 (dif = 1, h >= 1024) and K17 (dif = 0, h >= 512). hr, hi: [rows,
// in_stride] with the planes in the first h lanes; out: [rows, h].
static int launch_irfft_tail(const float* hr, const float* hi,
                             long long in_stride, float* out, const float* tw,
                             int rows, int h, bool dif, void* stream) {
  if (rows < 1 || bad_h(h, dif ? 1024 : 512) || in_stride < h)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = dif ? irfft_tail_dif_kernel : irfft_tail_4step_kernel;
  // the limit is raised to the largest row, kMaxH points, once
  constexpr int kBytes = kMaxH * static_cast<int>(sizeof(float2));
  cudaError_t e = dif ? C::raise_smem_once<irfft_tail_dif_kernel>(kBytes)
                      : C::raise_smem_once<irfft_tail_4step_kernel>(kBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int threads = clamp_threads(dif ? h >> 2 : h >> 1);
  kernel<<<rows, threads, h * sizeof(float2),
           static_cast<cudaStream_t>(stream)>>>(
      hr, hi, in_stride, out, reinterpret_cast<const float2*>(tw), h,
      log2_of(h >> 2));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bfir_irfft_tail_dif(const float* hr, const float* hi,
                                   long long in_stride, float* out,
                                   const float* tw, int rows, int h,
                                   void* stream) {
  return launch_irfft_tail(hr, hi, in_stride, out, tw, rows, h, true, stream);
}

extern "C" int bfir_irfft_tail_4step(const float* hr, const float* hi,
                                     long long in_stride, float* out,
                                     const float* tw, int rows, int h,
                                     void* stream) {
  return launch_irfft_tail(hr, hi, in_stride, out, tw, rows, h, false,
                           stream);
}

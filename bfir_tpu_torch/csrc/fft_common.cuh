// Device helpers shared by the FFT-family kernels (csrc/fft_family.cu): the
// bit-reverse index, radix-2 and radix-4 decimation-in-time stages over a
// sequence in shared memory, and the real-packing tangle and untangle.
//
// Conventions. A sequence of complex points is float2 (re, im). Twiddles
// come from one table per transform length: tw[t] = e^{-2 pi i t / tlen}
// for t < tlen, built in float64 on the host and rounded once to float32;
// a stage reads tw[t] for the forward sign and its conjugate for the
// inverse. Every helper loops over its work with a stride of blockDim.x, so
// the block may be any size; the caller synchronises between stages.

#pragma once

#include <cuda_runtime.h>

namespace bfir {
namespace fft {

__device__ __forceinline__ float2 add(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float2 sub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}

__device__ __forceinline__ float2 mul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ float2 scale(float2 a, float s) {
  return make_float2(a.x * s, a.y * s);
}

// -i * a (forward) or +i * a (inverse)
__device__ __forceinline__ float2 rot(float2 a, bool inverse) {
  return inverse ? make_float2(-a.y, a.x) : make_float2(a.y, -a.x);
}

// e^{-+2 pi i t / tlen}: the table entry, conjugated for the inverse
__device__ __forceinline__ float2 twiddle(const float2* __restrict__ tw,
                                          int t, bool inverse) {
  const float2 w = __ldg(tw + t);
  return inverse ? make_float2(w.x, -w.y) : w;
}

// k with its low `bits` bits reversed (k < 2^bits)
__device__ __forceinline__ int bitrev(int k, int bits) {
  return bits ? static_cast<int>(__brev(static_cast<unsigned>(k)) >>
                                 (32 - bits))
              : 0;
}

// One radix-2 DIT stage, in place, over `stride` interleaved sequences of
// n / stride points each (point j of sequence c at z[j * stride + c],
// stride a power of two, 2^slog): combines sub-transforms of `half` points
// into transforms of 2 half. Inputs in bit-reversed order within each
// sequence give natural-order outputs after the last stage. Twiddle
// W_{2 half}^j = tw[j * tlen / (2 half)].
__device__ __forceinline__ void radix2_stage(float2* z, int n, int slog,
                                             int half,
                                             const float2* __restrict__ tw,
                                             int tlen, bool inverse) {
  const int step = tlen / (2 * half);
  const int cmask = (1 << slog) - 1;
  for (int b = threadIdx.x; b < (n >> 1); b += blockDim.x) {
    const int c = b & cmask;
    const int bb = b >> slog;
    const int j = bb & (half - 1);
    const int a = ((((bb - j) << 1) | j) << slog) | c;
    const int a2 = a + (half << slog);
    const float2 w = twiddle(tw, j * step, inverse);
    const float2 u = z[a];
    const float2 v = mul(w, z[a2]);
    z[a] = add(u, v);
    z[a2] = sub(u, v);
  }
}

// One radix-4 DIT stage, in place, over n points (every sequence a multiple
// of 4 quarter points long): combines four sub-transforms of `quarter`
// points into transforms of 4 quarter. After radix-2 stages from
// bit-reversed input, the four quarters of a block hold the sub-transforms
// of the points congruent to 0, 2, 1 and 3 mod 4 (a radix-4 stage is two
// radix-2 stages), so quarters 1 and 2 swap roles here. `upper_only`:
// compute and write only outputs [2 quarter, 4 quarter) of each block (the
// upper half of a transform that ends with this stage).
__device__ __forceinline__ void radix4_stage(float2* z, int n, int quarter,
                                             const float2* __restrict__ tw,
                                             int tlen, bool inverse,
                                             bool upper_only) {
  const int step = tlen / (4 * quarter);
  for (int b = threadIdx.x; b < (n >> 2); b += blockDim.x) {
    const int k = b & (quarter - 1);
    const int a = ((b - k) << 2) | k;
    const float2 a0 = z[a];
    const float2 a2 = mul(twiddle(tw, 2 * k * step, inverse), z[a + quarter]);
    const float2 a1 =
        mul(twiddle(tw, k * step, inverse), z[a + 2 * quarter]);
    const float2 a3 =
        mul(twiddle(tw, 3 * k * step, inverse), z[a + 3 * quarter]);
    const float2 t0 = add(a0, a2);
    const float2 t1 = sub(a0, a2);
    const float2 t2 = add(a1, a3);
    const float2 t3 = rot(sub(a1, a3), inverse);
    if (!upper_only) {
      z[a] = add(t0, t2);
      z[a + quarter] = add(t1, t3);
    }
    z[a + 2 * quarter] = sub(t0, t2);
    z[a + 3 * quarter] = sub(t1, t3);
  }
}

// Point k of the spectrum Z of the packed length-h complex sequence
// z[j] = x[2j] + i x[2j+1], from halfcomplex planes (lane 0 = (DC.re,
// Nyquist.re)) of the length-2h real spectrum X: A = (X[k] + X*[h-k]) / 2,
// D = (X[k] - X*[h-k]) / 2, Z[k] = A + i e^{+2 pi i k / 2h} D, where
// tw2h[k] = e^{-2 pi i k / 2h}. The tangle of the inverse routes.
__device__ __forceinline__ float2 tangle(const float* __restrict__ hr,
                                         const float* __restrict__ hi, int k,
                                         int h,
                                         const float2* __restrict__ tw2h) {
  const float xr = __ldg(hr + k);
  const float xi = k ? __ldg(hi + k) : 0.f;
  const float vr = k ? __ldg(hr + h - k) : __ldg(hi);
  const float vi = k ? __ldg(hi + h - k) : 0.f;
  const float ar = 0.5f * (xr + vr);
  const float ai = 0.5f * (xi - vi);
  const float dr = 0.5f * (xr - vr);
  const float di = 0.5f * (xi + vi);
  const float2 w = twiddle(tw2h, k, true);
  const float er = w.x * dr - w.y * di;
  const float ei = w.x * di + w.y * dr;
  return make_float2(ar - ei, ai + er);
}

// Halfcomplex lane k of the real spectrum X from the spectrum Z (natural
// order, in shared memory) of the packed length-h sequence:
// X[k] = A + W B with A = (Z[k] + Z*[h-k]) / 2, B = -i (Z[k] - Z*[h-k]) / 2,
// W = tw2h[k] = e^{-2 pi i k / 2h}; lane 0 of the im plane carries
// Nyquist.re = Re Z0 - Im Z0. The untangle and hc pack of the forward
// routes; returns (hr[k], hi[k]).
__device__ __forceinline__ float2 untangle(const float2* z, int k, int h,
                                           const float2* __restrict__ tw2h) {
  const float2 p = z[k];
  const float2 q = z[(h - k) & (h - 1)];
  const float ar = 0.5f * (p.x + q.x);
  const float ai = 0.5f * (p.y - q.y);
  const float br = 0.5f * (p.y + q.y);
  const float bi = -0.5f * (p.x - q.x);
  const float2 w = __ldg(tw2h + k);
  const float xr = ar + w.x * br - w.y * bi;
  const float xi = ai + w.x * bi + w.y * br;
  return make_float2(xr, k ? xi : p.x - p.y);
}

}  // namespace fft
}  // namespace bfir

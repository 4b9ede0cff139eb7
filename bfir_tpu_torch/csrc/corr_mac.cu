// Correlation MAC of the G-cycle batched bulk scan for Hopper (sm_90a):
// kernel K7 of the port.
//
// Replaces bfir_tpu/kernels/corr_mac.py::corr_mac_pallas (its Pallas body
// is _corr_chunk). For an ordered (newest-last) spectrum history
// hist [P-1+B, 2C, Hp] and coefficient planes coeff [P, 2Cs, Hp] (Cs = C,
// or 1 for one filter shared by all channels):
//
//   y[b, c, k] = sum_q coeff[q, c, k] * hist[P-1+b-q, c, k],   b < B
//
// on split planes (re rows, then im rows), with the halfcomplex law at
// global lane 0: (DC.re, Nyquist.re) are two real products. Outputs are
// float32 [B, C, Hp]; hist and coeff are float32 or bf16 (widened in
// registers).
//
// What bounds it on the H100: device-memory bandwidth, if each input byte
// is read once. At the flagship's G = 8 the head call reads a 41 MB
// history and 8.4 MB of coefficients and writes 33.5 MB; the tail call
// 88 MB, 59 MB and 33.5 MB. The arithmetic is 8 flops per (b, q, lane),
// well under the float32 peak.
//
// Design: one thread owns two neighbouring lanes of one channel and walks
// its range of b. The TPU kernel kept whole slabs in VMEM; here the reuse
// lives in registers. The thread holds QC = 16 coefficients in registers
// and a ring of the last QC history rows; the b loop is unrolled by QC, so
// every ring index is a compile-time constant and each history row is read
// from device memory once per coefficient chunk (P <= 16: once in all).
// P > 16 walks further chunks of 16 coefficients and adds into the thread's
// own outputs. The lane-0 law is a template switch taken only by the thread
// that owns lanes 0 and 1; the TPU kernel's A/B plane folding (which only
// pleased Mosaic's stack limits) is not needed. A wide history is split
// along b over the grid's z axis when the lane x channel grid alone would
// leave SMs idle (each extra split re-reads QC-1 rows).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

enum Kind { kF32 = 0, kBF16 = 1 };

constexpr int kThreads = 128;
constexpr int kQC = 16;  // coefficients held in registers per chunk

template <int K>
__device__ __forceinline__ float2 load2(const void* base, long long row,
                                        int hp, int lane) {
  const long long off = row * hp + lane;
  if constexpr (K == kF32) {
    return __ldg(reinterpret_cast<const float2*>(
        static_cast<const float*>(base) + off));
  } else {
    const unsigned int u = __ldg(reinterpret_cast<const unsigned int*>(
        static_cast<const __nv_bfloat16*>(base) + off));
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
  }
}

__device__ __forceinline__ void cmac(float& ar, float& ai, float cr, float ci,
                                     float wr, float wi) {
  ar += cr * wr - ci * wi;
  ai += cr * wi + ci * wr;
}

template <int HK, int CK, bool LANE0>
__device__ __forceinline__ void corr_body(const void* hist, const void* coeff,
                                          float* __restrict__ yr,
                                          float* __restrict__ yi, int P,
                                          int C, int Cs, int hp, int c,
                                          int lane, int b0, int b1) {
  const int cc = Cs == 1 ? 0 : c;
  for (int q0 = 0; q0 < P; q0 += kQC) {
    float2 cr[kQC], ci[kQC];
#pragma unroll
    for (int k = 0; k < kQC; ++k) {
      if (q0 + k < P) {
        const long long row = static_cast<long long>(q0 + k) * 2 * Cs + cc;
        cr[k] = load2<CK>(coeff, row, hp, lane);
        ci[k] = load2<CK>(coeff, row + Cs, hp, lane);
      } else {
        cr[k] = make_float2(0.f, 0.f);
        ci[k] = make_float2(0.f, 0.f);
      }
    }
    // ring slot (j mod QC) holds history row base + j; b0 is a multiple of
    // QC, so slot t holds j = b0 - QC + t before the first group
    const int base = P - 1 - q0;
    float2 wr[kQC], wi[kQC];
#pragma unroll
    for (int t = 0; t < kQC; ++t) {
      const int row = base + b0 - kQC + t;
      if (t > 0 && row >= 0) {
        const long long r = static_cast<long long>(row) * 2 * C + c;
        wr[t] = load2<HK>(hist, r, hp, lane);
        wi[t] = load2<HK>(hist, r + C, hp, lane);
      } else {  // only ever paired with coefficients past P (zero)
        wr[t] = make_float2(0.f, 0.f);
        wi[t] = make_float2(0.f, 0.f);
      }
    }
    for (int bb = b0; bb < b1; bb += kQC) {
#pragma unroll
      for (int u = 0; u < kQC; ++u) {
        const int b = bb + u;
        if (b >= b1) break;
        const long long r = static_cast<long long>(base + b) * 2 * C + c;
        wr[u] = load2<HK>(hist, r, hp, lane);
        wi[u] = load2<HK>(hist, r + C, hp, lane);
        float2 ar = make_float2(0.f, 0.f);
        float2 ai = make_float2(0.f, 0.f);
#pragma unroll
        for (int k = 0; k < kQC; ++k) {
          const int s = (u - k + kQC) % kQC;
          if constexpr (LANE0) {  // (DC.re, Nyquist.re): two real products
            ar.x += cr[k].x * wr[s].x;
            ai.x += ci[k].x * wi[s].x;
          } else {
            cmac(ar.x, ai.x, cr[k].x, ci[k].x, wr[s].x, wi[s].x);
          }
          cmac(ar.y, ai.y, cr[k].y, ci[k].y, wr[s].y, wi[s].y);
        }
        const long long o = (static_cast<long long>(b) * C + c) * hp + lane;
        float2* pr = reinterpret_cast<float2*>(yr + o);
        float2* pi = reinterpret_cast<float2*>(yi + o);
        if (q0 > 0) {  // a later chunk of coefficients adds in
          const float2 er = *pr;
          const float2 ei = *pi;
          ar.x += er.x;
          ar.y += er.y;
          ai.x += ei.x;
          ai.y += ei.y;
        }
        *pr = ar;
        *pi = ai;
      }
    }
  }
}

template <int HK, int CK>
__global__ void __launch_bounds__(kThreads)
    corr_mac_kernel(const void* hist, const void* coeff,
                    float* __restrict__ yr, float* __restrict__ yi, int P,
                    int B, int C, int Cs, int hp, int b_chunk) {
  const int lane = (blockIdx.x * kThreads + threadIdx.x) * 2;
  const int c = blockIdx.y;
  const int b0 = blockIdx.z * b_chunk;
  const int b1 = min(B, b0 + b_chunk);
  if (lane >= hp || b0 >= b1) return;
  if (lane == 0) {
    corr_body<HK, CK, true>(hist, coeff, yr, yi, P, C, Cs, hp, c, lane, b0,
                            b1);
  } else {
    corr_body<HK, CK, false>(hist, coeff, yr, yi, P, C, Cs, hp, c, lane, b0,
                             b1);
  }
}

template <int HK, int CK>
void launch(const void* h, const void* g, float* yr, float* yi, int P, int B,
            int C, int Cs, int hp, int b_chunk, cudaStream_t s) {
  const dim3 grid((hp / 2 + kThreads - 1) / kThreads, C,
                  (B + b_chunk - 1) / b_chunk);
  corr_mac_kernel<HK, CK><<<grid, kThreads, 0, s>>>(h, g, yr, yi, P, B, C,
                                                     Cs, hp, b_chunk);
}

}  // namespace

// Launches K7 on ``stream``; returns the cudaError_t of the launch.
// h_kind / c_kind: 0 float32, 1 bf16. hist is [P-1+B, 2C, hp], coeff
// [P, 2Cs, hp], yr and yi [B, C, hp]; hp is even; b_chunk (the b range of
// one grid z slice) is a positive multiple of 16.
extern "C" int bfir_corr_mac(const void* hist, int h_kind, const void* coeff,
                             int c_kind, float* yr, float* yi, int P, int B,
                             int C, int Cs, int hp, int b_chunk,
                             void* stream) {
  if (P < 1 || B < 1 || C < 1 || (Cs != 1 && Cs != C) || hp < 2 || hp % 2 ||
      b_chunk < kQC || b_chunk % kQC)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (h_kind * 2 + c_kind) {
    case kF32 * 2 + kF32: launch<kF32, kF32>(hist, coeff, yr, yi, P, B, C, Cs, hp, b_chunk, s); break;
    case kF32 * 2 + kBF16: launch<kF32, kBF16>(hist, coeff, yr, yi, P, B, C, Cs, hp, b_chunk, s); break;
    case kBF16 * 2 + kF32: launch<kBF16, kF32>(hist, coeff, yr, yi, P, B, C, Cs, hp, b_chunk, s); break;
    case kBF16 * 2 + kBF16: launch<kBF16, kBF16>(hist, coeff, yr, yi, P, B, C, Cs, hp, b_chunk, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The halfcomplex ring MAC and the overlap-save tail of the inverse in one
// launch, for Hopper (sm_90a): kernel K12 of the port.
//
// Replaces bfir_tpu/kernels/spectrum_mac.py::mac_tail_pallas_hc. For ring
// and per-channel coefficients [P, 2C, Hp] (re rows, then im rows; lane 0
// = (DC.re, Nyquist.re)) and the half-DFT tail basis wr, wi [Hp, Hp]
// (ops/fft._hc_tail_weights, zero-padded from h = n_fft / 2 to Hp):
//
//   acc[c, k] = sum_p coeff[p, c, k] * ring[(pos - p) mod P, c, k]
//   out[c, t] = sum_k acc_r[c, k] wr[k, t] + acc_i[c, k] wi[k, t]
//
// with K1's lane-0 law in the MAC (two real products at lane 0). out is
// float32 [C, Hp]: the time-domain overlap-save tail, zero beyond h. The
// product is full float32 FMA (the TPU kernel asks for
// Precision.HIGHEST); no TF32.
//
// What bounds it on the H100: device-memory bandwidth for the MAC (the
// ring and coefficients, 134 MB at P = 128, C = 64, Hp = 1024, three times
// the 50 MB L2) and, far behind, the product: 4 C Hp^2 flops (268 MFLOP, 4
// us at 67 TFLOP/s) against an 8.4 MB basis.
//
// Design: one block of 1024 threads per channel. The TPU kernel kept the
// [C, Hp] accumulator in VMEM across its sequential partition grid; here
// the tail product needs a channel's whole accumulator row, so the block
// that owns a channel computes all of it into shared memory (2 Hp floats,
// 8 KB at Hp = 1024), synchronises, and forms the product itself. Four
// groups of 256 threads split the work both times: in the MAC each thread
// owns four neighbouring lanes (16-byte loads) and group g sums partitions
// g, g + 4, ...; in the product each thread owns four neighbouring output
// samples and group g sums basis rows g, g + 4, ... (a warp reads 512
// contiguous bytes of a basis row). The groups' partial sums meet in
// shared memory in a fixed order, so the result is deterministic.
// Left for later work: one block per channel fills only 64 of the 132 SMs,
// and every block reads the whole basis (8.4 MB, from L2: 537 MB of L2
// traffic at C = 64). A thread-block cluster that shares the accumulator
// through distributed shared memory, so that each block reads a slice of
// the basis for several channels, is the redesign.

#include <cuda_runtime.h>

#include "mac_common.cuh"

namespace {

using bfir::ld4;

constexpr int kLaneThreads = 256;  // four lanes each: 1024 lanes a pass
constexpr int kGroups = 4;
constexpr int kThreads = kLaneThreads * kGroups;
constexpr int kDefaultSmem = 48 * 1024;

__device__ __forceinline__ void add4(float* dst, float4 v, bool first) {
  float4* d = reinterpret_cast<float4*>(dst);
  if (first) {
    *d = v;
  } else {
    const float4 o = *d;
    *d = make_float4(o.x + v.x, o.y + v.y, o.z + v.z, o.w + v.w);
  }
}

__global__ void __launch_bounds__(kThreads)
    mac_tail_hc_kernel(const float* __restrict__ ring,
                       const float* __restrict__ coeff,
                       const float* __restrict__ wr,
                       const float* __restrict__ wi, float* __restrict__ out,
                       int P, int C, int hp, int pos) {
  extern __shared__ float4 smem4[];
  float* acc_r = reinterpret_cast<float*>(smem4);  // [hp]
  float* acc_i = acc_r + hp;                       // [hp]
  float* part = acc_i + hp;                        // [hp] product partials
  const int c = blockIdx.x;
  const int g = threadIdx.x / kLaneThreads;
  const int tid = threadIdx.x % kLaneThreads;
  const long long slot_stride = 2LL * C * hp;
  const long long re0 = static_cast<long long>(c) * hp;
  const long long im0 = re0 + static_cast<long long>(C) * hp;

  // 1. the MAC: group g sums partitions g, g + kGroups, ... into registers,
  // then the groups add into acc in the order 0, 1, 2, 3
  for (int base = 0; base < hp; base += 4 * kLaneThreads) {
    const int k = base + 4 * tid;
    float4 ar = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 ai = ar;
    if (k < hp) {
      for (int p = g; p < P; p += kGroups) {
        int slot = pos - p;
        if (slot < 0) slot += P;
        const float* r = ring + slot * slot_stride;
        const float* w = coeff + p * slot_stride;
        bfir::cmac4(ar, ai, ld4(w + re0 + k), ld4(w + im0 + k),
                    ld4(r + re0 + k), ld4(r + im0 + k), k == 0);
      }
    }
    for (int gg = 0; gg < kGroups; ++gg) {
      if (g == gg && k < hp) {
        add4(acc_r + k, ar, gg == 0);
        add4(acc_i + k, ai, gg == 0);
      }
      __syncthreads();
    }
  }

  // 2. the tail product: group g sums basis rows g, g + kGroups, ... for
  // its four output samples; the groups meet in `part` in order, and group
  // kGroups - 1 writes the sum
  for (int base = 0; base < hp; base += 4 * kLaneThreads) {
    const int t = base + 4 * tid;
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t < hp) {
#pragma unroll 4
      for (int k = g; k < hp; k += kGroups) {
        const float a = acc_r[k], b = acc_i[k];
        const float4 x = ld4(wr + static_cast<long long>(k) * hp + t);
        const float4 y = ld4(wi + static_cast<long long>(k) * hp + t);
        o.x += a * x.x + b * y.x;
        o.y += a * x.y + b * y.y;
        o.z += a * x.z + b * y.z;
        o.w += a * x.w + b * y.w;
      }
    }
    for (int gg = 0; gg < kGroups; ++gg) {
      if (g == gg && t < hp) {
        if (gg < kGroups - 1) {
          add4(part + t, o, gg == 0);
        } else {
          const float4 q = *reinterpret_cast<const float4*>(part + t);
          *reinterpret_cast<float4*>(out + re0 + t) =
              make_float4(q.x + o.x, q.y + o.y, q.z + o.z, q.w + o.w);
        }
      }
      __syncthreads();
    }
  }
}

}  // namespace

// K12: float32 ring and per-channel coefficients [P, 2C, hp], basis wr, wi
// [hp, hp] -> out [C, hp]. hp is a multiple of 4 whose three shared rows
// of hp floats fit a block's 227 KB; 0 <= pos < P.
extern "C" int bfir_mac_tail_hc(const float* ring, const float* coeff,
                                const float* wr, const float* wi, float* out,
                                int P, int C, int hp, int pos, void* stream) {
  const size_t smem = 3 * static_cast<size_t>(hp) * sizeof(float);
  if (P < 1 || C < 1 || hp < 4 || hp % 4 || pos < 0 || pos >= P ||
      smem > 227 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem > kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        mac_tail_hc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  mac_tail_hc_kernel<<<C, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      ring, coeff, wr, wi, out, P, C, hp, pos);
  return static_cast<int>(cudaGetLastError());
}

// Three variants of the uniform ring MAC for Hopper (sm_90a): kernels K10,
// K11 and K13 of the port.
//
// Replaces bfir_tpu/kernels/spectrum_mac.py::mac_pallas_chunked (K10),
// ::mac_pallas (K11) and ::mac_pallas_hc_insert (K13). Each computes
//
//   y[c, k] = sum_p coeff[p, c, k] * ring[(pos - p) mod P, c, k]
//
// as a complex multiply on split re/im planes, over another layout:
//
// - K11 (split planes, the step_split engine): four separate planes
//   ring_re, ring_im, coeff_re, coeff_im, each [P, C, Fp] (Fp = N + 1
//   rounded up to 128), no lane-0 law.
// - K10 (the doubled ring, the step_chunked engine): ring2 [2P, 2C, Fp]
//   with slot s mirrored at s + P, and coefficients [P, 2C, Fp] whose
//   partition order is reversed inside each chunk of k. Chunk i, element t
//   reads ring2 slot pos + P - (i + 1) k + 1 + t against coefficient
//   i k + t, which is partition i k + k - 1 - t at ring slot
//   (pos - that partition) mod P: the same sum, read without a wrap. No
//   lane-0 law.
// - K13 (the in-kernel ring insert, the step_hc2 engine): the halfcomplex
//   MAC of K1 over ring and per-channel coefficients [P, 2C, Hp] with the
//   lane-0 law (DC.re, Nyquist.re are two real products), where partition
//   0 multiplies the new frame spectrum xpk [2C, Hp] and the kernel also
//   writes xpk into ring slot pos.
//
// K10 and K11 compute the first `lanes` lanes of each row (the engines pass
// their N + 1 live bins rounded up to 4), as K8 does.
//
// What bounds them on the H100: device-memory bandwidth. Per partition and
// lane each reads four float32 plane values and does eight flops. At the
// packed flagship (P = 128, C = 64, Fp = 1152, 1025 live bins) K10 and K11
// read 134 MB a call, K13 at Hp = 1024 the P - 1 old slots, the
// coefficients and xpk (134 MB), nearly three times the 50 MB L2, so they
// stream from HBM.
//
// Design: K1's (csrc/mac_hc.cu). A thread owns four neighbouring lanes of
// one channel (16-byte loads, a warp reads contiguous rows), the TPU
// kernel's sequential partition grid axis becomes a loop inside the thread
// with the sums in registers, and each output is written once.
// - K11 takes four base pointers where K1 takes re/im row offsets of one
//   tensor.
// - K10's chunk size k was the TPU kernel's DMA granule (k slots in one
//   contiguous copy). Here it is the depth of the unrolled inner loop
//   (k = 1, 2, 4, 8 and 16 are compiled as such, other divisors of P run a
//   loop), so the k loads of a chunk can be in flight together; the sum
//   over partitions is the same for every k, in another order.
// - K13: only partition 0 maps to slot pos, and it reads xpk, so no thread
//   reads the slot the kernel writes; each thread writes the four lanes it
//   owns in the slot's re row and im row. The TPU kernel existed to take
//   the separate slot copy (a whole-ring copy under XLA) out of the step;
//   here it takes one copy launch out of each block.

#include <cuda_runtime.h>

#include "mac_common.cuh"

namespace {

using bfir::cmac4;
using bfir::ld4;

constexpr int kThreads = 64;

__device__ __forceinline__ void store(float* yr, float* yi, long long o,
                                      float4 ar, float4 ai) {
  *reinterpret_cast<float4*>(yr + o) = ar;
  *reinterpret_cast<float4*>(yi + o) = ai;
}

// K11: four planes [P, C, fp] -> yr, yi [C, lanes]
__global__ void __launch_bounds__(kThreads)
    mac_split_kernel(const float* __restrict__ rr_p,
                     const float* __restrict__ ri_p,
                     const float* __restrict__ cr_p,
                     const float* __restrict__ ci_p, float* __restrict__ yr,
                     float* __restrict__ yi, int P, int C, int fp, int lanes,
                     int pos) {
  const int k = (blockIdx.x * kThreads + threadIdx.x) * 4;
  const int c = blockIdx.y;
  if (k >= lanes) return;
  const long long plane = static_cast<long long>(C) * fp;  // one slot
  const long long row = static_cast<long long>(c) * fp + k;
  float4 ar = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 ai = ar;
  for (int p = 0; p < P; ++p) {
    int slot = pos - p;
    if (slot < 0) slot += P;
    const long long r = slot * plane + row;
    const long long g = p * plane + row;
    cmac4(ar, ai, ld4(cr_p + g), ld4(ci_p + g), ld4(rr_p + r), ld4(ri_p + r));
  }
  store(yr, yi, static_cast<long long>(c) * lanes + k, ar, ai);
}

// K10: ring2 [2P, 2C, fp], chunk-reversed coefficients [P, 2C, fp] ->
// yr, yi [C, lanes]. KT > 0: the chunk size k, unrolled; KT = 0: k_rt.
template <int KT>
__global__ void __launch_bounds__(kThreads)
    mac_chunked_kernel(const float* __restrict__ ring2,
                       const float* __restrict__ coeff, float* __restrict__ yr,
                       float* __restrict__ yi, int P, int C, int fp,
                       int lanes, int pos, int k_rt) {
  const int k = KT > 0 ? KT : k_rt;
  const int lane = (blockIdx.x * kThreads + threadIdx.x) * 4;
  const int c = blockIdx.y;
  if (lane >= lanes) return;
  const long long slot_stride = 2LL * C * fp;
  const long long re = static_cast<long long>(c) * fp + lane;
  const long long im = re + static_cast<long long>(C) * fp;
  float4 ar = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 ai = ar;
  auto element = [&](int s, int g) {  // ring2 slot s, coefficient row g
    const float* r = ring2 + s * slot_stride;
    const float* w = coeff + g * slot_stride;
    cmac4(ar, ai, ld4(w + re), ld4(w + im), ld4(r + re), ld4(r + im));
  };
  for (int i = 0; i < P / k; ++i) {
    const int s0 = pos + P - (i + 1) * k + 1;
    if constexpr (KT > 0) {
#pragma unroll
      for (int t = 0; t < KT; ++t) element(s0 + t, i * KT + t);
    } else {
      for (int t = 0; t < k; ++t) element(s0 + t, i * k + t);
    }
  }
  store(yr, yi, static_cast<long long>(c) * lanes + lane, ar, ai);
}

// K13: ring [P, 2C, hp] (updated in place at slot pos), per-channel
// coefficients [P, 2C, hp], xpk [2C, hp] -> yr, yi [C, hp]
__global__ void __launch_bounds__(kThreads)
    mac_hc_insert_kernel(float* ring, const float* __restrict__ coeff,
                         const float* __restrict__ xpk, float* __restrict__ yr,
                         float* __restrict__ yi, int P, int C, int hp,
                         int pos) {
  const int k = (blockIdx.x * kThreads + threadIdx.x) * 4;
  const int c = blockIdx.y;
  if (k >= hp) return;
  const long long slot_stride = 2LL * C * hp;
  const long long re = static_cast<long long>(c) * hp + k;
  const long long im = re + static_cast<long long>(C) * hp;
  // partition 0: the new spectrum, which is also what slot pos receives
  const float4 xr = ld4(xpk + re);
  const float4 xi = ld4(xpk + im);
  *reinterpret_cast<float4*>(ring + pos * slot_stride + re) = xr;
  *reinterpret_cast<float4*>(ring + pos * slot_stride + im) = xi;
  float4 ar = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 ai = ar;
  for (int p = 0; p < P; ++p) {
    float4 rr = xr, ri = xi;
    if (p > 0) {  // slot != pos: no thread writes it
      int slot = pos - p;
      if (slot < 0) slot += P;
      const float* r = ring + slot * slot_stride;
      rr = *reinterpret_cast<const float4*>(r + re);
      ri = *reinterpret_cast<const float4*>(r + im);
    }
    const float* w = coeff + p * slot_stride;
    cmac4(ar, ai, ld4(w + re), ld4(w + im), rr, ri, k == 0);
  }
  store(yr, yi, static_cast<long long>(c) * hp + k, ar, ai);
}

dim3 grid_of(int lanes, int C) {
  return dim3((lanes / 4 + kThreads - 1) / kThreads, C);
}

bool bad_lanes(int fp, int lanes) {
  return fp < 4 || fp % 4 || lanes < 4 || lanes % 4 || lanes > fp;
}

}  // namespace

// K11: float32 planes [P, C, fp] -> yr, yi [C, lanes]. fp and lanes are
// multiples of 4, lanes <= fp; 0 <= pos < P.
extern "C" int bfir_mac_split(const float* rr, const float* ri,
                              const float* cr, const float* ci, float* yr,
                              float* yi, int P, int C, int fp, int lanes,
                              int pos, void* stream) {
  if (P < 1 || C < 1 || bad_lanes(fp, lanes) || pos < 0 || pos >= P)
    return static_cast<int>(cudaErrorInvalidValue);
  mac_split_kernel<<<grid_of(lanes, C), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      rr, ri, cr, ci, yr, yi, P, C, fp, lanes, pos);
  return static_cast<int>(cudaGetLastError());
}

// K10: float32 ring2 [2P, 2C, fp] and chunk-reversed coefficients
// [P, 2C, fp] -> yr, yi [C, lanes]. k divides P; fp and lanes as K11's.
extern "C" int bfir_mac_chunked(const float* ring2, const float* coeff,
                                float* yr, float* yi, int P, int C, int fp,
                                int lanes, int pos, int k, void* stream) {
  if (P < 1 || C < 1 || bad_lanes(fp, lanes) || pos < 0 || pos >= P ||
      k < 1 || P % k)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid = grid_of(lanes, C);
  switch (k) {
#define BFIR_CHUNKED(KT)                                               \
  case KT:                                                             \
    mac_chunked_kernel<KT><<<grid, kThreads, 0, s>>>(                  \
        ring2, coeff, yr, yi, P, C, fp, lanes, pos, k);                \
    break;
    BFIR_CHUNKED(1)
    BFIR_CHUNKED(2)
    BFIR_CHUNKED(4)
    BFIR_CHUNKED(8)
    BFIR_CHUNKED(16)
#undef BFIR_CHUNKED
    default:
      mac_chunked_kernel<0><<<grid, kThreads, 0, s>>>(
          ring2, coeff, yr, yi, P, C, fp, lanes, pos, k);
  }
  return static_cast<int>(cudaGetLastError());
}

// K13: float32 ring [P, 2C, hp] (slot pos receives xpk), per-channel
// coefficients [P, 2C, hp], xpk [2C, hp] -> yr, yi [C, hp]. hp is a
// multiple of 4; 0 <= pos < P.
extern "C" int bfir_mac_hc_insert(float* ring, const float* coeff,
                                  const float* xpk, float* yr, float* yi,
                                  int P, int C, int hp, int pos,
                                  void* stream) {
  if (P < 1 || C < 1 || hp < 4 || hp % 4 || pos < 0 || pos >= P)
    return static_cast<int>(cudaErrorInvalidValue);
  mac_hc_insert_kernel<<<grid_of(hp, C), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      ring, coeff, xpk, yr, yi, P, C, hp, pos);
  return static_cast<int>(cudaGetLastError());
}

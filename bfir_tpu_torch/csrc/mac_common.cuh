// Device helpers shared by the ring-MAC kernels (csrc/mac_hc.cu,
// csrc/mac_variants.cu, csrc/mac_tail_hc.cu): a read-only 16-byte load,
// the complex multiply-accumulate of four neighbouring lanes on split
// re/im planes, and the partition loops of one thread over those lanes:
// ring_mac4 over all P partitions (K12, and K1-K3, K5, K6, K8 unsliced)
// and ring_mac4_range over one contiguous run of them (a partition slice
// of K1-K3, K5, K6, K8).
//
// Sum order: both loops add partition p's product into float32 sums that
// start at zero, in increasing p, one partition at a time, whatever their
// unroll (the unroll only issues loads early). A kernel that cuts the
// partitions into runs adds the runs' sums in run order itself, so every
// output is the same sequence of float32 operations on every launch of
// the same shape: no atomics, no order that depends on timing.

#pragma once

#include <cuda_runtime.h>

namespace bfir {

__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ void cmac(float& ar, float& ai, float cr, float ci,
                                     float rr, float ri) {
  ar += cr * rr - ci * ri;
  ai += cr * ri + ci * rr;
}

// a += c * r on four lanes. lane0: the first lane is the halfcomplex lane 0,
// (DC.re, Nyquist.re), whose product is two real products.
__device__ __forceinline__ void cmac4(float4& ar, float4& ai, float4 cr,
                                      float4 ci, float4 rr, float4 ri,
                                      bool lane0 = false) {
  if (lane0) {
    ar.x += cr.x * rr.x;
    ai.x += ci.x * ri.x;
  } else {
    cmac(ar.x, ai.x, cr.x, ci.x, rr.x, ri.x);
  }
  cmac(ar.y, ai.y, cr.y, ci.y, rr.y, ri.y);
  cmac(ar.z, ai.z, cr.z, ci.z, rr.z, ri.z);
  cmac(ar.w, ai.w, cr.w, ci.w, rr.w, ri.w);
}

// The ring MAC of one thread's four neighbouring lanes over all P
// partitions, with the sums in registers: partition p multiplies ring slot
// (pos - p) mod P. load(slot, p, rr, ri, cr, ci) fetches the four planes'
// vectors; lane0 as in cmac4. kUnroll partitions' loads issue before their
// math; the sums run in partition order whatever kUnroll is.
template <int kUnroll = 1, class Load>
__device__ __forceinline__ void ring_mac4(float4& ar, float4& ai, int P,
                                          int pos, bool lane0, Load load) {
  ar = make_float4(0.f, 0.f, 0.f, 0.f);
  ai = ar;
  int p = 0;
  for (; p + kUnroll <= P; p += kUnroll) {
    float4 rr[kUnroll], ri[kUnroll], cr[kUnroll], ci[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      int slot = pos - p - u;
      if (slot < 0) slot += P;
      load(slot, p + u, rr[u], ri[u], cr[u], ci[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      cmac4(ar, ai, cr[u], ci[u], rr[u], ri[u], lane0);
  }
  for (; p < P; ++p) {
    int slot = pos - p;
    if (slot < 0) slot += P;
    float4 rr, ri, cr, ci;
    load(slot, p, rr, ri, cr, ci);
    cmac4(ar, ai, cr, ci, rr, ri, lane0);
  }
}

// Partitions [p0, p1) of the ring MAC of one thread's four lanes, added
// into (ar, ai) in partition order (0 <= p0 <= p1 <= P): partition p
// multiplies ring slot (pos - p) mod P, as in ring_mac4, and kUnroll
// partitions' loads issue before their math. The caller zeroes (ar, ai).
template <int kUnroll = 1, class Load>
__device__ __forceinline__ void ring_mac4_range(float4& ar, float4& ai,
                                                int p0, int p1, int P,
                                                int pos, bool lane0,
                                                Load load) {
  int p = p0;
  for (; p + kUnroll <= p1; p += kUnroll) {
    float4 rr[kUnroll], ri[kUnroll], cr[kUnroll], ci[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      int slot = pos - p - u;
      if (slot < 0) slot += P;
      load(slot, p + u, rr[u], ri[u], cr[u], ci[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      cmac4(ar, ai, cr[u], ci[u], rr[u], ri[u], lane0);
  }
  for (; p < p1; ++p) {
    int slot = pos - p;
    if (slot < 0) slot += P;
    float4 rr, ri, cr, ci;
    load(slot, p, rr, ri, cr, ci);
    cmac4(ar, ai, cr, ci, rr, ri, lane0);
  }
}

}  // namespace bfir

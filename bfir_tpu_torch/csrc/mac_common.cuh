// Device helpers shared by the ring-MAC kernels (csrc/mac_hc.cu,
// csrc/mac_variants.cu, csrc/mac_tail_hc.cu): a read-only 16-byte load and
// the complex multiply-accumulate of four neighbouring lanes on split
// re/im planes.

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

}  // namespace bfir

// Device helpers shared by the FFT kernels (csrc/fft_family.cu,
// csrc/irfft_hc_tail.cu): complex arithmetic, the real-packing tangle of
// the inverse tail (K4, K16, K17), and the register-radix, self-sorting
// core of every FFT kernel of the port, K4 and K14-K18 (namespace core,
// below).
//
// Conventions. A sequence of complex points is float2 (re, im). Twiddles
// come from one table per transform length: tw[t] = e^{-2 pi i t / tlen}
// for t < tlen, built in float64 on the host and rounded once to float32;
// a helper reads tw[t] for the forward sign and its conjugate for the
// inverse.

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

// ---------------------------------------------------------------------------
// The register-radix, self-sorting core of K4, K16 and K17 (one kernel,
// csrc/irfft_hc_tail.cu), K14 (cfft_balanced_kernel in csrc/fft_family.cu)
// and K15/K18 (rfft_hc_kernel there): the length-h complex FFT of one row,
// h = 2^L in [512, 16384] (K14 instantiates h >= 1024 only), by a block of
// T = h / PTS threads that each hold PTS = 8, 16 or 32 points in registers
// (Shape).
//
// Passes. Each pass p has a radix R = 2^kPlan[L-9][p] (8, 16 or 32) and
// Ns, the product of the earlier radices. Butterfly j (< h/R) reads points
// j + r h/R (r < R), multiplies point r by W_{Ns R}^{(j mod Ns) r}, runs
// the radix-R DFT and writes output k to (j div Ns) Ns R + (j mod Ns) +
// k Ns: Stockham's autosort, so every pass reads and writes in natural
// order and no bit-reversal permutation exists anywhere. A thread runs
// PTS / R whole butterflies j = t + b T in registers where R <= PTS; a
// larger butterfly is split over G = R / PTS (2 or 4) lanes of one warp,
// l + 32/G g: lane g holds points r = g + G s (s < PL = R / G), runs the
// radix-PL DFT over s in registers, multiplies by W_R^{g k1} and finishes
// with a radix-G DFT across the lanes by shuffles (decimation in
// frequency), ending with output k1 + PL digit(g). Pass 0 reads from the
// caller (device memory; the inverse tail tangles as it loads, K15/K18
// read sample pairs), the last pass hands output point j + k Ns (j < Ns there) to the
// caller's store straight from registers; with TAIL, only outputs
// k >= R/2, points [h/2, h), are handed over; with KEEP, the store writes
// shared memory between two more block barriers, so the caller can pair
// points that other threads computed (K15/K18's untangle). Between passes
// the row goes through shared memory: ceil(log_R h) - 1 exchanges, one at
// h = 512 (32 x 16) and 1024 (32 x 32: one block barrier), two at
// h = 2048-16384 (three barriers: after pass 0, and before and after the
// middle pass's in-place store). One block takes one row, so 64 rows fill
// 64 SMs.
//
// Shared memory is conflict-free. The data buffer's slot of logical index
// i is swz(i): the low nibble XOR the four bits from bit W (log2 min(R0,
// 2 PTS)) rotated left by 2, which turns every pass's store and load of a
// half-warp into 16 distinct bank pairs (pass 0 stores with a lane stride
// of R0; a split butterfly puts two lane groups in a half-warp). The
// output buffer of KEEP has its own map, zslot: natural order, the upper
// half with bit 3 flipped. A half-warp's mirror points h - k of 16
// consecutive k straddle two 16-point groups, which swz maps with two
// different XORs; zslot keeps their low nibbles distinct, and the flip
// separates the two lane groups of a four-lane last butterfly (one
// writes the lower half, the other the upper). Twiddles
// come from a quarter table staged once per block with cp.async,
// q[qswz(m)] = tw[2m] = W_h^m for m < h/4 (the other quadrants by
// multiples of -i), from the caller's float64-built table
// tw[t] = e^{-2 pi i t / 2h}; a butterfly loads W^{(j mod Ns) u 2^e} for
// e < log2 R (u = h / (Ns R)) and multiplies the other powers out (at
// most four products for r = 31). Those loads are 16 lanes at a
// power-of-two stride, which qswz (low nibble XOR every higher nibble)
// spreads over distinct bank pairs. No fast-math sincos.
// tests/test_torch_fft_core.py models all of this in numpy, checks it
// against numpy.fft and asserts the bank maps.
// ---------------------------------------------------------------------------
namespace core {

// log2 of each pass's radix by L - 9 (h = 512 .. 16384); 0: no pass
constexpr int kPlan[6][3] = {{5, 4, 0}, {5, 5, 0}, {4, 4, 3},
                             {4, 4, 4}, {5, 4, 4}, {5, 5, 4}};

// A transform of h = 2^L_ points by h / PTS_ threads, PTS_ = 8, 16 or
// 32 points each.
template <int L_, int PTS_>
struct Shape {
  static constexpr int L = L_;
  static constexpr int H = 1 << L;
  static constexpr int PTS = PTS_;              // points a thread holds
  static constexpr int T = H / PTS;             // threads: one row a block
  static constexpr int NP = kPlan[L - 9][2] ? 3 : 2;
  // swizzle window: log2 min(pass 0's radix, 2 PTS)
  static constexpr int W = kPlan[L - 9][0] < (PTS == 8 ? 4 : 5)
                               ? kPlan[L - 9][0]
                               : (PTS == 8 ? 4 : 5);
  static_assert(PTS == 8 || PTS == 16 || PTS == 32, "8, 16 or 32 points");
  static_assert(T <= 1024, "at most 1024 threads a block");
  // shared memory: the row's buffer, then the quarter table
  static constexpr int SMEM = (H + H / 4) * static_cast<int>(sizeof(float2));
};

template <class Sh, int P>
struct Pass {
  static constexpr int L = Sh::L;
  static constexpr int LR = kPlan[L - 9][P];
  static constexpr int R = 1 << LR;
  static constexpr int PTS = Sh::PTS;
  static constexpr int G = R > PTS ? R / PTS : 1;  // lanes a butterfly
  static constexpr int LG = G == 4 ? 2 : G == 2 ? 1 : 0;
  static constexpr int PL = R / G;     // its points a lane
  static constexpr int B = PTS / PL;   // butterflies a thread
  static constexpr int LNS = P == 0 ? 0
                             : P == 1 ? kPlan[L - 9][0]
                                      : kPlan[L - 9][0] + kPlan[L - 9][1];
  static constexpr int NS = 1 << LNS;
  static constexpr int LU = L - LNS - LR;  // twiddle unit h / (Ns R)
  static_assert(G <= 4, "a butterfly spans at most four lane groups");
};

// Butterfly j of thread t's slot group b, and the thread's lane g in it:
// a butterfly over G lanes takes lanes l, l + 32/G, .. of one warp, so
// g is the top log2 G bits of the lane.
template <class Sh, int P>
__device__ __forceinline__ int butterfly(int t, int b) {
  using X = Pass<Sh, P>;
  return X::G > 1 ? ((t >> 5) << (5 - X::LG)) + (t & ((32 >> X::LG) - 1))
                  : t + b * Sh::T;
}

template <class Sh, int P>
__device__ __forceinline__ int group_lane(int t) {
  using X = Pass<Sh, P>;
  return X::G > 1 ? (t >> (5 - X::LG)) & (X::G - 1) : 0;
}

// the radix-G digit of the outputs lane g ends with: g, bit-reversed
// for G = 4 (the decimation in frequency across lanes)
template <int G>
__device__ __forceinline__ int lane_digit(int g) {
  return G == 4 ? ((g & 1) << 1) | (g >> 1) : g;
}

// slot of logical index i: the low nibble XOR the next four bits from
// bit W, rotated left by 2
template <int W>
__device__ __forceinline__ int swz(int i) {
  const int n = (i >> W) & 15;
  return i ^ (((n << 2) | (n >> 2)) & 15);
}

// slot of point i of a KEEP output buffer (h = 2^L): natural order, bit 3
// flipped in the upper half
template <int L>
__device__ __forceinline__ int zslot(int i) {
  return i ^ ((i >> (L - 1)) << 3);
}

__device__ __forceinline__ int qswz(int m) {
  return m ^ ((m >> 4) & 15) ^ ((m >> 8) & 15);
}

// W_h^e (e < h) from the quarter table; conjugated for the inverse
template <int L, bool INV>
__device__ __forceinline__ float2 qtw(const float2* q, int e) {
  const float2 a = q[qswz(e & ((1 << (L - 2)) - 1))];
  const int quad = e >> (L - 2);
  const float2 w = quad == 0   ? a
                   : quad == 1 ? make_float2(a.y, -a.x)
                   : quad == 2 ? make_float2(-a.x, -a.y)
                               : make_float2(-a.y, a.x);
  return INV ? make_float2(w.x, -w.y) : w;
}

// Start q[qswz(m)] = tw[2m] for m < h/4, by every thread of the block,
// as cp.async copies, so no thread waits on them before its pass-0 loads;
// run waits for them (quarter_staged) before its first barrier.
template <int L>
__device__ __forceinline__ void stage_quarter(float2* q,
                                              const float2* __restrict__ tw) {
  for (int m = threadIdx.x; m < (1 << (L - 2)); m += blockDim.x) {
    const unsigned a =
        static_cast<unsigned>(__cvta_generic_to_shared(q + qswz(m)));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(a),
                 "l"(tw + 2 * m)
                 : "memory");
  }
}

// this thread's quarter-table copies have landed
__device__ __forceinline__ void quarter_staged() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// W_32^k (k < 16, a constant after unrolling), conjugated for the inverse
template <bool INV>
__device__ __forceinline__ float2 w32(int k) {
  constexpr float c[16] = {
      1.000000000e+00f, 9.807852804e-01f, 9.238795325e-01f, 8.314696123e-01f,
      7.071067812e-01f, 5.555702330e-01f, 3.826834324e-01f, 1.950903220e-01f,
      0.0f, -1.950903220e-01f, -3.826834324e-01f, -5.555702330e-01f,
      -7.071067812e-01f, -8.314696123e-01f, -9.238795325e-01f,
      -9.807852804e-01f};
  constexpr float s[16] = {
      0.0f, 1.950903220e-01f, 3.826834324e-01f, 5.555702330e-01f,
      7.071067812e-01f, 8.314696123e-01f, 9.238795325e-01f, 9.807852804e-01f,
      1.000000000e+00f, 9.807852804e-01f, 9.238795325e-01f, 8.314696123e-01f,
      7.071067812e-01f, 5.555702330e-01f, 3.826834324e-01f, 1.950903220e-01f};
  return make_float2(c[k], INV ? s[k] : -s[k]);
}

// W_32^e for any e < 32 (a constant after unrolling)
template <bool INV>
__device__ __forceinline__ float2 w32_any(int e) {
  const float2 w = w32<INV>(e & 15);
  return e < 16 ? w : make_float2(-w.x, -w.y);
}

// a * W_32^k; W_32^8 = -i is a rotation
template <bool INV>
__device__ __forceinline__ float2 mul_w32(float2 a, int k) {
  if (k == 0) return a;
  if (k == 8) return rot(a, INV);
  return mul(a, w32<INV>(k));
}

// log2 of a power of two x <= 32, folded to a constant after unrolling
__host__ __device__ constexpr int ilog2(int x) {
  return x >= 32 ? 5 : x >= 16 ? 4 : x >= 8 ? 3 : x >= 4 ? 2 : x >= 2 ? 1 : 0;
}

// The radix-R DFT of v[0..R) in registers, natural order in and out:
// log2 R radix-2 Stockham stages with constant twiddles W_{2 ns}^k.
template <int R, bool INV>
__device__ __forceinline__ void dft(float2* v) {
#pragma unroll
  for (int st = 0; st < ilog2(R); ++st) {
    const int ns = 1 << st;
    float2 b[R];
#pragma unroll
    for (int j = 0; j < R / 2; ++j) {
      const int k = j & (ns - 1);
      const float2 x0 = v[j];
      const float2 x1 = mul_w32<INV>(v[j + R / 2], k * (16 / ns));
      b[2 * (j - k) + k] = add(x0, x1);
      b[2 * (j - k) + k + ns] = sub(x0, x1);
    }
#pragma unroll
    for (int j = 0; j < R; ++j) v[j] = b[j];
  }
}

// The butterflies of pass P on the thread's points (after the twiddles):
// radix-R DFTs in registers, or, for a butterfly over G lanes, the
// radix-PL DFT of the lane's points r = g + G s, the twiddle W_R^{g k1}
// and a radix-G DFT across the lanes by shuffles (decimation in
// frequency), which leaves output k1 + PL lane_digit(g) in slot k1.
template <class Sh, int P, bool INV>
__device__ __forceinline__ void butterflies(float2* v, int t) {
  using X = Pass<Sh, P>;
  if constexpr (X::G == 1) {
#pragma unroll
    for (int b = 0; b < X::B; ++b) dft<X::R, INV>(v + b * X::R);
  } else {
    constexpr int kStep = 32 / X::R;  // W_R = W_32^kStep
    const int g = group_lane<Sh, P>(t);
    dft<X::PL, INV>(v);
#pragma unroll
    for (int k = 0; k < X::PL; ++k) {
      float2 a = v[k];
      if (k) {
        const float2 w1 = w32_any<INV>(kStep * k);
        const float2 w2 = w32_any<INV>(2 * kStep * k);
        const float2 w3 = w32_any<INV>(3 * kStep * k);
        const float2 w = g == 0 ? make_float2(1.f, 0.f)
                         : g == 1 ? w1
                         : g == 2 ? w2
                                  : w3;
        a = mul(a, w);
      }
      if constexpr (X::G == 4) {
        // lanes g and g ^ 2 (lane bit 4), then g and g ^ 1 (lane bit 3)
        float2 p = make_float2(__shfl_xor_sync(0xffffffffu, a.x, 16),
                               __shfl_xor_sync(0xffffffffu, a.y, 16));
        a = g < 2 ? add(a, p) : g == 2 ? sub(p, a) : rot(sub(p, a), INV);
        p = make_float2(__shfl_xor_sync(0xffffffffu, a.x, 8),
                        __shfl_xor_sync(0xffffffffu, a.y, 8));
        a = (g & 1) ? sub(p, a) : add(a, p);
      } else {
        const float2 p = make_float2(__shfl_xor_sync(0xffffffffu, a.x, 16),
                                     __shfl_xor_sync(0xffffffffu, a.y, 16));
        a = g ? sub(p, a) : add(a, p);
      }
      v[k] = a;
    }
  }
}

// Pass P >= 1: v[slot] *= W_{Ns R}^{(j mod Ns) r} for the slot's point r
template <class Sh, int P, bool INV>
__device__ __forceinline__ void twiddles(float2* v, const float2* q, int t) {
  using X = Pass<Sh, P>;
  const int g = group_lane<Sh, P>(t);
#pragma unroll
  for (int b = 0; b < X::B; ++b) {
    const int k = butterfly<Sh, P>(t, b) & (X::NS - 1);
    float2 wp[X::LR];
#pragma unroll
    for (int e = 0; e < X::LR; ++e)
      wp[e] = qtw<Sh::L, INV>(q, (k << (X::LU + e)) & (Sh::H - 1));
    // w[s] = W^{k u G s}, lowest set bit first; then lane g's W^{k u g}
    float2 w[X::PL];
#pragma unroll
    for (int s = 1; s < X::PL; ++s) {
      const int r = X::G * s;
      const int low = r & -r;
      const int e = ilog2(low);
      w[s] = r == low ? wp[e] : mul(w[s - low / X::G], wp[e]);
    }
    float2 wg = make_float2(1.f, 0.f);
    if constexpr (X::G >= 2) wg = g & 1 ? wp[0] : wg;
    if constexpr (X::G == 4)
      wg = g == 2 ? wp[1] : g == 3 ? mul(wp[0], wp[1]) : wg;
#pragma unroll
    for (int s = 0; s < X::PL; ++s) {
      float2& x = v[b * X::PL + s];
      if (s) x = mul(x, w[s]);
      if constexpr (X::G > 1)
        if (g) x = mul(x, wg);
    }
  }
}

// v[b PL + s] = z[swz(j + r h/R)], r the slot's point
template <class Sh, int P>
__device__ __forceinline__ void load_smem(float2* v, const float2* z, int t) {
  using X = Pass<Sh, P>;
  const int g = group_lane<Sh, P>(t);
#pragma unroll
  for (int b = 0; b < X::B; ++b)
#pragma unroll
    for (int s = 0; s < X::PL; ++s)
      v[b * X::PL + s] = z[swz<Sh::W>(
          butterfly<Sh, P>(t, b) + (g + X::G * s) * (Sh::H / X::R))];
}

// output k = s + PL lane_digit(g) of each butterfly to its Stockham place
template <class Sh, int P>
__device__ __forceinline__ void store_smem(const float2* v, float2* z, int t) {
  using X = Pass<Sh, P>;
  const int g = lane_digit<X::G>(group_lane<Sh, P>(t));
#pragma unroll
  for (int b = 0; b < X::B; ++b) {
    const int j = butterfly<Sh, P>(t, b);
    const int d = ((j >> X::LNS) << (X::LNS + X::LR)) + (j & (X::NS - 1));
#pragma unroll
    for (int s = 0; s < X::PL; ++s)
      z[swz<Sh::W>(d + (s + X::PL * g) * X::NS)] = v[b * X::PL + s];
  }
}

// The whole transform of one row by a block of T threads. z: the row's h
// slots of shared memory; q: the quarter table, whose copies the block
// has started (stage_quarter) before the call; t: the thread's index,
// < T. load(k) -> float2 gives input point k; store(k, v) takes output
// point k (k >= h/2 only, with TAIL). With KEEP, store writes shared
// memory (z itself, say): every thread's last-pass loads are done before
// the first store, and every store before run returns.
template <class Sh, bool INV, bool TAIL, bool KEEP = false, class Load,
          class Store>
__device__ __forceinline__ void run(float2* z, const float2* q, int t,
                                    Load load, Store store) {
  constexpr int LAST = Sh::NP - 1;
  float2 v[Sh::PTS];
  {
    using X = Pass<Sh, 0>;
    const int g = group_lane<Sh, 0>(t);
#pragma unroll
    for (int b = 0; b < X::B; ++b)
#pragma unroll
      for (int s = 0; s < X::PL; ++s)
        v[b * X::PL + s] = load(butterfly<Sh, 0>(t, b) +
                                (g + X::G * s) * (Sh::H / X::R));
    butterflies<Sh, 0, INV>(v, t);
    store_smem<Sh, 0>(v, z, t);
  }
  quarter_staged();
  __syncthreads();
  if constexpr (Sh::NP == 3) {
    load_smem<Sh, 1>(v, z, t);
    twiddles<Sh, 1, INV>(v, q, t);
    butterflies<Sh, 1, INV>(v, t);
    __syncthreads();
    store_smem<Sh, 1>(v, z, t);
    __syncthreads();
  }
  using X = Pass<Sh, LAST>;
  load_smem<Sh, LAST>(v, z, t);
  twiddles<Sh, LAST, INV>(v, q, t);
  butterflies<Sh, LAST, INV>(v, t);
  if constexpr (KEEP) __syncthreads();
  const int g = lane_digit<X::G>(group_lane<Sh, LAST>(t));
#pragma unroll
  for (int b = 0; b < X::B; ++b) {
    const int j = butterfly<Sh, LAST>(t, b);
#pragma unroll
    for (int s = 0; s < X::PL; ++s) {
      const int k = s + X::PL * g;  // the butterfly's output
      if (!TAIL || k >= X::R / 2) store(j + k * X::NS, v[b * X::PL + s]);
    }
  }
  if constexpr (KEEP) __syncthreads();
}

// Raise `Kernel`'s dynamic shared-memory limit to `bytes` once per device,
// not on every launch.
template <auto Kernel>
cudaError_t raise_smem_once(int bytes) {
  static unsigned ready = 0;  // devices whose attribute is set
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || (ready >> dev & 1u)) return e;
  e = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes);
  if (e == cudaSuccess) ready |= 1u << dev;
  return e;
}

// Launch `Kernel` (whose arguments follow) on `rows` rows of shape Sh,
// one block a row.
template <auto Kernel, class Sh, class... Args>
cudaError_t launch_rows(int rows, cudaStream_t stream, Args... args) {
  const cudaError_t e = raise_smem_once<Kernel>(Sh::SMEM);
  if (e != cudaSuccess) return e;
  Kernel<<<rows, Sh::T, Sh::SMEM, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace core

}  // namespace fft
}  // namespace bfir

// hp-TPDF requantizer for Hopper (sm_90a): kernel K9 of the port.
//
// Replaces bfir_tpu/kernels/dither_kernel.py::quantize_hp_tpdf_pallas.
//
// For each channel c and sample t in order, with the dither values dv given:
//
//   xp = (x + e0) - e1;  d = xp + dv
//   q  = d < 0 ? ceil(d) - 1 : floor(d), clipped to [imin, imax]
//   clipped: n_overflows += 1, largest = max(largest, |d|)
//   else:    intlargest = max(intlargest, |q|)
//   e1 = e0;  e0 = xp - q
//
// on x, dv [C, T] float32 or float64 -> q [C, T] int32 plus the new e0, e1
// and statistics [C]. The inputs are not modified. NaN samples are outside
// the domain (the session aborts on NaN before its output stage): there
// the int conversion differs from the plain version's.
//
// What bounds it on the H100: the serial chain, not memory. The recurrence
// in e0 is nonlinear (rounding, clip), so time cannot be split: each sample
// waits on the previous one, while the bytes of a [64, 1024] float32 call
// (x, dv and q, 0.79 MB) take 0.23 us. Only ceil(C / 32) warps have work,
// one per SM: a single warp issues every instruction of its channel's
// loop, so a sample costs its chain's latency or its instruction count,
// whichever is more. The chain in the SASS: three adds to d, the
// truncation, the - 1 for d < 0, the clip, the add to the new e0.
//
// Design: one thread owns one channel and runs its whole loop with e0, e1
// and the three statistics in registers; it writes the new state once.
// There are no staging warps and no block barriers: a block is one warp,
// 32 channels. Each thread keeps a register window of its own row, W
// samples of x and dv (128 bytes each: W = 32 in float32, 16 in float64),
// and loads the next window as 16-byte vectors while it computes this one,
// so a load's latency hides behind W samples of the chain; q leaves four
// samples at a time as one int4 store. A row whose length is not a
// multiple of 4 (its rows not 16-byte aligned) takes scalar loads and
// stores in the same windows. The body has no branch, and no predicate on
// the chain but the clip's in float64: the reference's rounding
// d < 0 ? ceil(d) - 1 : floor(d) is trunc(d) - (d < 0), whose sign test
// runs beside the truncation; the float32 clip is a max and a min
// (float64's is a select, faster there than its 64-bit min and max); the
// statistics are selects, so lanes never diverge on clipping; |q| comes
// from the int q (an integer abs saturated at INT_MAX, equal to the int
// conversion of |q|). The arithmetic is the reference's, value for value;
// there are no multiplies, so FMA contraction cannot change a bit, and the
// build uses no fast-math: the kernel equals its plain version bit for
// bit.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 32;  // one warp: a channel a lane
constexpr int kWindowBytes = 128;  // of x and of dv, per row and window

__device__ __forceinline__ float dtrunc(float v) { return truncf(v); }
__device__ __forceinline__ double dtrunc(double v) { return trunc(v); }
__device__ __forceinline__ float dabs(float v) { return fabsf(v); }
__device__ __forceinline__ double dabs(double v) { return fabs(v); }

// The clip of the rounded value r to [lo, hi], for float as min and max
// (no predicate on the chain); for double as a select on the clip flags,
// which the card runs faster than its 64-bit min and max. Equal for
// non-NaN d: d <= lo gives r <= lo, and d > hi gives r >= hi.
__device__ __forceinline__ float clip(float r, bool clipped, bool clip_lo,
                                      float lo, float hi) {
  return fminf(fmaxf(r, lo), hi);
}
__device__ __forceinline__ double clip(double r, bool clipped, bool clip_lo,
                                       double lo, double hi) {
  return clipped ? (clip_lo ? lo : hi) : r;
}

template <typename T>
struct State {
  T e0, e1, lg;
  int nof, ilg;
};

// One sample of the recurrence; returns the int q. The reference's
// d < 0 ? ceil(d) - 1 : floor(d) is trunc(d) - (d < 0): the same value and
// the same sign of zero (trunc(-0.0) - 0 = -0.0 = floor(-0.0)), with the
// sign test off the chain.
template <typename T>
__device__ __forceinline__ int32_t step(State<T>& s, T x, T dv, T lo, T hi) {
  const T xp = (x + s.e0) - s.e1;
  const T d = xp + dv;
  const T r = dtrunc(d) - (d < T(0) ? T(1) : T(0));
  const bool clip_lo = d <= lo;
  const bool clipped = clip_lo || d > hi;
  const T qv = clip(r, clipped, clip_lo, lo, hi);
  const int32_t qi = static_cast<int32_t>(qv);
  const uint32_t mag = qi < 0 ? 0u - static_cast<uint32_t>(qi)
                              : static_cast<uint32_t>(qi);
  const int32_t aq = static_cast<int32_t>(min(mag, 0x7fffffffu));
  const T ad = dabs(d);
  s.nof += clipped;
  s.lg = clipped && ad > s.lg ? ad : s.lg;
  s.ilg = !clipped && aq > s.ilg ? aq : s.ilg;
  s.e1 = s.e0;
  s.e0 = xp - qv;
  return qi;
}

// Window [t0, t0 + W) of one row into registers: 16-byte vectors when kVec
// (n a multiple of 4, every row 16-byte aligned), else scalars; samples at
// or beyond n are not read.
template <typename T, bool kVec, int W>
__device__ __forceinline__ void load_window(T (&xw)[W], T (&dw)[W],
                                            const T* __restrict__ x,
                                            const T* __restrict__ dv, int t0,
                                            int n) {
  if constexpr (kVec) {
    constexpr int V = 16 / sizeof(T);
#pragma unroll
    for (int j = 0; j < W; j += V) {
      if (t0 + j < n) {
        if constexpr (V == 4) {
          const float4 a = __ldg(reinterpret_cast<const float4*>(x + t0 + j));
          const float4 b = __ldg(reinterpret_cast<const float4*>(dv + t0 + j));
          xw[j] = a.x; xw[j + 1] = a.y; xw[j + 2] = a.z; xw[j + 3] = a.w;
          dw[j] = b.x; dw[j + 1] = b.y; dw[j + 2] = b.z; dw[j + 3] = b.w;
        } else {
          const double2 a =
              __ldg(reinterpret_cast<const double2*>(x + t0 + j));
          const double2 b =
              __ldg(reinterpret_cast<const double2*>(dv + t0 + j));
          xw[j] = a.x; xw[j + 1] = a.y;
          dw[j] = b.x; dw[j + 1] = b.y;
        }
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < W; ++j) {
      if (t0 + j < n) {
        xw[j] = __ldg(x + t0 + j);
        dw[j] = __ldg(dv + t0 + j);
      }
    }
  }
}

// q[t0 .. t0 + W) of one row, samples below n only.
template <bool kVec, int W>
__device__ __forceinline__ void store_window(int32_t* __restrict__ q,
                                             const int32_t (&qw)[W], int t0,
                                             int n) {
#pragma unroll
  for (int j = 0; j < W; j += 4) {
    if constexpr (kVec) {
      if (t0 + j < n)
        *reinterpret_cast<int4*>(q + t0 + j) =
            make_int4(qw[j], qw[j + 1], qw[j + 2], qw[j + 3]);
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (t0 + j + u < n) q[t0 + j + u] = qw[j + u];
    }
  }
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
    quantize_kernel(const T* __restrict__ x, const T* __restrict__ dv,
                    const T* __restrict__ e0_in, const T* __restrict__ e1_in,
                    const int* __restrict__ nof_in,
                    const T* __restrict__ lg_in,
                    const int* __restrict__ ilg_in, int32_t* __restrict__ q,
                    T* __restrict__ e0_out, T* __restrict__ e1_out,
                    int* __restrict__ nof_out, T* __restrict__ lg_out,
                    int* __restrict__ ilg_out, int C, int n, T lo, T hi) {
  constexpr int W = kWindowBytes / sizeof(T);
  static_assert(W % 4 == 0, "windows of whole int4 stores");
  const int c = blockIdx.x * kThreads + threadIdx.x;
  const bool mine = c < C;
  const int cc = mine ? c : C - 1;  // spare lanes shadow the last row
  const long long row = static_cast<long long>(cc) * n;
  x += row;
  dv += row;
  q += row;
  State<T> s{e0_in[cc], e1_in[cc], lg_in[cc], nof_in[cc], ilg_in[cc]};
  T xa[W], da[W], xb[W], db[W];
  int32_t qw[W];
  load_window<T, kVec>(xa, da, x, dv, 0, n);
  int t0 = 0;
  for (; t0 + W <= n; t0 += W) {
    load_window<T, kVec>(xb, db, x, dv, t0 + W, n);
#pragma unroll
    for (int j = 0; j < W; ++j) qw[j] = step(s, xa[j], da[j], lo, hi);
    if (mine) store_window<kVec>(q, qw, t0, n);
#pragma unroll
    for (int j = 0; j < W; ++j) {
      xa[j] = xb[j];
      da[j] = db[j];
    }
  }
#pragma unroll
  for (int j = 0; j < W; ++j)
    if (t0 + j < n) qw[j] = step(s, xa[j], da[j], lo, hi);
  if (mine) {
    store_window<kVec>(q, qw, t0, n);
    e0_out[c] = s.e0;
    e1_out[c] = s.e1;
    nof_out[c] = s.nof;
    lg_out[c] = s.lg;
    ilg_out[c] = s.ilg;
  }
}

template <typename T>
void launch(const void* x, const void* dv, const void* e0, const void* e1,
            const int* nof, const void* lg, const int* ilg, int32_t* q,
            void* e0o, void* e1o, int* nofo, void* lgo, int* ilgo, int C,
            int n, double imin, double imax, cudaStream_t s) {
  const dim3 grid((C + kThreads - 1) / kThreads);
  auto kernel = n % 4 ? quantize_kernel<T, false> : quantize_kernel<T, true>;
  kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(dv),
      static_cast<const T*>(e0), static_cast<const T*>(e1), nof,
      static_cast<const T*>(lg), ilg, q, static_cast<T*>(e0o),
      static_cast<T*>(e1o), nofo, static_cast<T*>(lgo), ilgo, C, n,
      static_cast<T>(imin), static_cast<T>(imax));
}

}  // namespace

// Launches K9 on ``stream``; returns the cudaError_t of the launch. x, dv
// [C, T] and e0, e1, largest [C] are float32 (is_f64 = 0) or float64;
// n_overflows and intlargest [C] int32; q [C, T] int32; every pointer
// 16-byte aligned. The state outputs are separate buffers from the state
// inputs. imin and imax are converted to the sample type, as the reference
// does.
extern "C" int bfir_quantize_hp_tpdf(const void* x, const void* dv,
                                     const void* e0, const void* e1,
                                     const int* nof, const void* lg,
                                     const int* ilg, int32_t* q, void* e0o,
                                     void* e1o, int* nofo, void* lgo,
                                     int* ilgo, int C, int n, double imin,
                                     double imax, int is_f64, void* stream) {
  if (C < 1 || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_f64)
    launch<double>(x, dv, e0, e1, nof, lg, ilg, q, e0o, e1o, nofo, lgo, ilgo,
                   C, n, imin, imax, s);
  else
    launch<float>(x, dv, e0, e1, nof, lg, ilg, q, e0o, e1o, nofo, lgo, ilgo,
                  C, n, imin, imax, s);
  return static_cast<int>(cudaGetLastError());
}

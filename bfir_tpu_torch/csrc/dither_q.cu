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
// and statistics [C]. The inputs are not modified.
//
// What bounds it on the H100: the serial chain, not memory. The recurrence
// in e0/e1 is nonlinear (floor, clip), so time cannot be split: each sample
// waits on the previous one through about six dependent operations, some
// 25 000 cycles per 1024 samples (about 14 us at 1.755 GHz), while the
// bytes of a [64, 1024] float32 call (x, dv and q, 0.79 MB) take 0.23 us.
// Only ceil(C / 32) warps have work: the kernel is latency-bound by nature.
//
// Design: one thread owns one channel and runs its whole loop with e0, e1
// and the three statistics in registers; it writes the new state once, with
// no atomics. A block serves 32 channels: warp 0 computes while warps 1-4
// stage the next [32 channels x 32 samples] tile of x and dv from device
// memory into shared memory with row-contiguous (coalesced) loads, and
// write the previous tile of q back the same way; the two buffers swap at a
// __syncthreads per tile. Each staging thread issues all sixteen of its
// loads before its first shared-memory store, so a tile costs one memory
// latency, not sixteen. Rows are padded by one word, so the computing
// warp's column reads (one channel per thread) are free of bank conflicts.
// The arithmetic order is the reference's; there are no multiplies, so FMA
// contraction cannot change a bit, and the build uses no fast-math: the
// kernel equals its plain version bit for bit.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kChannels = 32;  // channels per block: one per lane of warp 0
constexpr int kTile = 32;      // samples per staged tile
constexpr int kRow = kTile + 1;
constexpr int kWarps = 5;      // warp 0 computes, warps 1-4 stage tiles
constexpr int kThreads = 32 * kWarps;
constexpr int kStagers = kThreads - 32;
constexpr int kPer = kChannels * kTile / kStagers;  // elements per stager
static_assert(kChannels * kTile % kStagers == 0, "uneven staging");

template <typename T>
struct Tiles {
  T x[2][kChannels][kRow];
  T dv[2][kChannels][kRow];
  int32_t q[2][kChannels][kRow];
};

__device__ __forceinline__ float dfloor(float v) { return floorf(v); }
__device__ __forceinline__ double dfloor(double v) { return floor(v); }
__device__ __forceinline__ float dceil(float v) { return ceilf(v); }
__device__ __forceinline__ double dceil(double v) { return ceil(v); }
__device__ __forceinline__ float dabs(float v) { return fabsf(v); }
__device__ __forceinline__ double dabs(double v) { return fabs(v); }

// Stager thread st handles tile elements i = st + u * kStagers, element i
// being (row i / kTile, column i % kTile): neighbouring threads read
// neighbouring samples of one channel.
template <typename T>
__device__ void load_tile(Tiles<T>& s, int buf, const T* __restrict__ x,
                          const T* __restrict__ dv, int c0, int C, int n,
                          int t0, int st) {
  T xv[kPer], dvv[kPer];
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int i = st + u * kStagers;
    const int r = i / kTile;
    const int j = i % kTile;
    const bool in = c0 + r < C && t0 + j < n;
    const long long o = static_cast<long long>(c0 + r) * n + t0 + j;
    xv[u] = in ? x[o] : T(0);
    dvv[u] = in ? dv[o] : T(0);
  }
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int i = st + u * kStagers;
    s.x[buf][i / kTile][i % kTile] = xv[u];
    s.dv[buf][i / kTile][i % kTile] = dvv[u];
  }
}

template <typename T>
__device__ void store_tile(const Tiles<T>& s, int buf, int32_t* __restrict__ q,
                           int c0, int C, int n, int t0, int st) {
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int i = st + u * kStagers;
    const int r = i / kTile;
    const int j = i % kTile;
    if (c0 + r < C && t0 + j < n)
      q[static_cast<long long>(c0 + r) * n + t0 + j] = s.q[buf][r][j];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    quantize_kernel(const T* __restrict__ x, const T* __restrict__ dv,
                    const T* __restrict__ e0_in, const T* __restrict__ e1_in,
                    const int* __restrict__ nof_in,
                    const T* __restrict__ lg_in,
                    const int* __restrict__ ilg_in, int32_t* __restrict__ q,
                    T* __restrict__ e0_out, T* __restrict__ e1_out,
                    int* __restrict__ nof_out, T* __restrict__ lg_out,
                    int* __restrict__ ilg_out, int C, int n, T lo, T hi) {
  __shared__ Tiles<T> s;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int c0 = blockIdx.x * kChannels;
  const int c = c0 + lane;
  const bool mine = warp == 0 && c < C;
  T e0 = 0, e1 = 0, lg = 0;
  int nof = 0, ilg = 0;
  if (mine) {
    e0 = e0_in[c];
    e1 = e1_in[c];
    nof = nof_in[c];
    lg = lg_in[c];
    ilg = ilg_in[c];
  }
  const int ntiles = (n + kTile - 1) / kTile;
  if (warp > 0 && ntiles > 0) load_tile(s, 0, x, dv, c0, C, n, 0, tid - 32);
  __syncthreads();
  for (int k = 0; k < ntiles; ++k) {
    const int buf = k & 1;
    if (warp == 0) {
      if (mine) {
        const int len = min(kTile, n - k * kTile);
#pragma unroll 4
        for (int j = 0; j < len; ++j) {
          const T xp = (s.x[buf][lane][j] + e0) - e1;
          const T d = xp + s.dv[buf][lane][j];
          T qv = d < T(0) ? dceil(d) - T(1) : dfloor(d);
          const bool clip_lo = d <= lo;
          const bool clip_hi = d > hi;
          if (clip_lo) qv = lo;
          else if (clip_hi) qv = hi;
          if (clip_lo || clip_hi) {
            ++nof;
            const T ad = dabs(d);
            lg = ad > lg ? ad : lg;
          } else {
            const int aq = static_cast<int>(dabs(qv));
            ilg = aq > ilg ? aq : ilg;
          }
          s.q[buf][lane][j] = static_cast<int32_t>(qv);
          e1 = e0;
          e0 = xp - qv;
        }
      }
    } else {
      // stage tile k + 1 into the other buffer; write back tile k - 1
      if (k + 1 < ntiles)
        load_tile(s, buf ^ 1, x, dv, c0, C, n, (k + 1) * kTile, tid - 32);
      if (k > 0)
        store_tile(s, buf ^ 1, q, c0, C, n, (k - 1) * kTile, tid - 32);
    }
    __syncthreads();
  }
  if (warp > 0 && ntiles > 0)
    store_tile(s, (ntiles - 1) & 1, q, c0, C, n, (ntiles - 1) * kTile,
               tid - 32);
  if (mine) {
    e0_out[c] = e0;
    e1_out[c] = e1;
    nof_out[c] = nof;
    lg_out[c] = lg;
    ilg_out[c] = ilg;
  }
}

template <typename T>
void launch(const void* x, const void* dv, const void* e0, const void* e1,
            const int* nof, const void* lg, const int* ilg, int32_t* q,
            void* e0o, void* e1o, int* nofo, void* lgo, int* ilgo, int C,
            int n, double imin, double imax, cudaStream_t s) {
  const dim3 grid((C + kChannels - 1) / kChannels);
  quantize_kernel<T><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(dv),
      static_cast<const T*>(e0), static_cast<const T*>(e1), nof,
      static_cast<const T*>(lg), ilg, q, static_cast<T*>(e0o),
      static_cast<T*>(e1o), nofo, static_cast<T*>(lgo), ilgo, C, n,
      static_cast<T>(imin), static_cast<T>(imax));
}

}  // namespace

// Launches K9 on ``stream``; returns the cudaError_t of the launch. x, dv
// [C, T] and e0, e1, largest [C] are float32 (is_f64 = 0) or float64;
// n_overflows and intlargest [C] int32; q [C, T] int32. The state outputs
// are separate buffers from the state inputs. imin and imax are converted
// to the sample type, as the reference does.
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

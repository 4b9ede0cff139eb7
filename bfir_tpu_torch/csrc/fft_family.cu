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
//   K15 rfft_hc_r4       replaces fft_fused.py::rfft_hc_fused (:148): rfft ->
//                        halfcomplex planes, radix-4.
//   K16 irfft_tail_dif   replaces fft_fused.py::irfft_hc_tail_fused (:274):
//                        halfcomplex planes -> samples [n/2, n) of the
//                        inverse, radix-4 decimation in frequency.
//   K17 irfft_tail_4step replaces bfir_tpu/kernels/fft_pallas.py::
//                        irfft_hc_tail_pallas (:206): the same function as
//                        K16, as an inverse four-step.
//   K18 rfft_hc_r2       replaces fft_pallas.py::rfft_hc_pallas (:303): the
//                        same function as K15, radix-2.
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
// them: the passes of a row through shared memory and the barriers between
// the stages do, and 64 rows are 64 blocks on 132 SMs.
//
// Design, against that: one block per row keeps the whole sequence in
// dynamic shared memory (8 h bytes, 128 KB at the h = 16384 limit, above the
// 48 KB static limit, so each launch raises the kernel's
// MaxDynamicSharedMemorySize first); the block is sized to a stage's work,
// not fixed at 1024 threads. The decompositions differ in how many
// block-wide barriers they need, which is what the family measures:
//   - K18 (radix-2, as K4): log2 h stages, 10 barriers at h = 1024;
//   - K15 (radix-4): log4 h stages, 5 at h = 1024 (6 + 1 at h = 8192);
//   - K14 (the balanced n1 x 128 split): log2 n1 radix-2 stages over 128
//     interleaved columns (3 at h = 1024), then each length-128 row DFT in
//     one warp, four points a lane, with shuffles and no block barrier; the
//     twiddle is folded into the row loads and the k1-major -> natural
//     reorder into the store index;
//   - K16 (radix-4 DIF): the tangle and the radix-4 butterflies of the
//     four contiguous spectrum quarters in one pass, then four length-h/4
//     inverse sub-transforms whose last radix-4 stage computes only the
//     tail half of its outputs; the re/im interleave is the store index;
//   - K17 (inverse four-step): the tangle stores the four stride-4
//     subsequences apart, four length-h/4 radix-2 sub-transforms run side
//     by side, and the last radix-4 combine, twiddle folded in, computes
//     only the outputs i2 in {2, 3}: half of its butterflies.
// The loads of the forward kernels are 8-byte float2 reads of sample pairs
// into bit-reversed positions; the inverse kernels read lane-padded planes
// through their row stride. Twiddles come from one table per length,
// tw[t] = e^{-2 pi i t / 2h} for t < 2h, built in float64 and rounded once to
// float32. Shared-memory bank conflicts of the strided stages are not
// avoided yet: a correct kernel first.

#include <cuda_runtime.h>

#include "fft_common.cuh"

namespace {

namespace F = bfir::fft;

constexpr int kMaxH = 16384;  // 128 KB of float2 shared memory

int log2_of(int v) {
  int l = 0;
  while ((1 << l) < v) ++l;
  return l;
}

int clamp_threads(int work) {
  return work < 128 ? 128 : (work > 1024 ? 1024 : work);
}

// Forward routes: a row of 2h real samples as h float2 pairs into
// bit-reversed positions of z.
__device__ __forceinline__ void load_pairs_bitrev(const float* __restrict__ x,
                                                  float2* z, int h,
                                                  int log2h) {
  const float2* row =
      reinterpret_cast<const float2*>(x + static_cast<long long>(blockIdx.x) * 2 * h);
  for (int j = threadIdx.x; j < h; j += blockDim.x)
    z[F::bitrev(j, log2h)] = __ldg(row + j);
}

// Forward routes: the untangle and hc pack of Z (natural order in z).
__device__ __forceinline__ void store_hc(const float2* z, float* __restrict__ hr,
                                         float* __restrict__ hi, int h,
                                         const float2* __restrict__ tw) {
  const long long off = static_cast<long long>(blockIdx.x) * h;
  for (int k = threadIdx.x; k < h; k += blockDim.x) {
    const float2 v = F::untangle(z, k, h, tw);
    hr[off + k] = v.x;
    hi[off + k] = v.y;
  }
}

// K18: radix-2 DIT forward, log2 h stages.
__global__ void __launch_bounds__(1024)
    rfft_hc_r2_kernel(const float* __restrict__ x, float* __restrict__ hr,
                      float* __restrict__ hi, const float2* __restrict__ tw,
                      int h, int log2h) {
  extern __shared__ float2 z[];
  load_pairs_bitrev(x, z, h, log2h);
  __syncthreads();
  for (int half = 1; half < h; half <<= 1) {
    F::radix2_stage(z, h, 0, half, tw, 2 * h, false);
    __syncthreads();
  }
  store_hc(z, hr, hi, h, tw);
}

// K15: radix-4 DIT forward (one radix-2 stage first when log2 h is odd).
__global__ void __launch_bounds__(1024)
    rfft_hc_r4_kernel(const float* __restrict__ x, float* __restrict__ hr,
                      float* __restrict__ hi, const float2* __restrict__ tw,
                      int h, int log2h) {
  extern __shared__ float2 z[];
  load_pairs_bitrev(x, z, h, log2h);
  __syncthreads();
  int quarter = 1;
  if (log2h & 1) {
    F::radix2_stage(z, h, 0, 1, tw, 2 * h, false);
    __syncthreads();
    quarter = 2;
  }
  for (; quarter < h; quarter <<= 2) {
    F::radix4_stage(z, h, quarter, tw, 2 * h, false, false);
    __syncthreads();
  }
  store_hc(z, hr, hi, h, tw);
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

// K14: the balanced split h = n1 x 128, j = 128 j1 + j2, k = n1 k2 + k1:
// X[k] = sum_j2 W_128^{j2 k2} W_h^{j2 k1} sum_j1 W_n1^{j1 k1} z[j].
__global__ void __launch_bounds__(1024)
    cfft_balanced_kernel(const float* __restrict__ zr,
                         const float* __restrict__ zi,
                         float* __restrict__ out_r, float* __restrict__ out_i,
                         const float2* __restrict__ tw, int h, int log2n1,
                         bool inverse, bool tail_only) {
  extern __shared__ float2 z[];
  const int n1 = h >> 7;
  const long long in_off = static_cast<long long>(blockIdx.x) * h;
  // stage 1: 128 column DFTs of length n1, columns interleaved (row j1 of
  // z is [128] wide), rows in bit-reversed order
  for (int j = threadIdx.x; j < h; j += blockDim.x)
    z[(F::bitrev(j >> 7, log2n1) << 7) | (j & 127)] =
        make_float2(__ldg(zr + in_off + j), __ldg(zi + in_off + j));
  __syncthreads();
  for (int half = 1; half < n1; half <<= 1) {
    F::radix2_stage(z, h, 7, half, tw, 2 * h, inverse);
    __syncthreads();
  }
  // stage 2: row k1 of z holds A[j2, k1]; one warp per row: lane l takes
  // j2 = l + 32 q, folds in the twiddle W_h^{j2 k1}, runs the radix-4
  // butterfly over q in registers (k2 = r + 4 m), then the length-32 DFT
  // over the lanes (decimation in frequency with shuffles: lane l ends with
  // m = bitrev5(l)), and writes X[n1 (r + 4 m) + k1] back to its own row
  const int lane = threadIdx.x & 31;
  const int step128 = (2 * h) >> 7;  // W_128^t = tw[t * step128]
  for (int k1 = threadIdx.x >> 5; k1 < n1; k1 += blockDim.x >> 5) {
    float2* row = z + (k1 << 7);
    float2 a[4];
#pragma unroll
    for (int qq = 0; qq < 4; ++qq) {
      const int j2 = lane + 32 * qq;
      a[qq] = F::mul(F::twiddle(tw, 2 * j2 * k1, inverse), row[j2]);
    }
    const float2 t0 = F::add(a[0], a[2]), t1 = F::sub(a[0], a[2]);
    const float2 t2 = F::add(a[1], a[3]);
    const float2 t3 = F::rot(F::sub(a[1], a[3]), inverse);
    float2 b[4] = {F::add(t0, t2), F::add(t1, t3), F::sub(t0, t2),
                   F::sub(t1, t3)};
#pragma unroll
    for (int r = 1; r < 4; ++r)
      b[r] = F::mul(F::twiddle(tw, lane * r * step128, inverse), b[r]);
#pragma unroll
    for (int d = 16; d >= 1; d >>= 1) {
      const float2 w = F::twiddle(tw, (lane & (d - 1)) * (h / d), inverse);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float2 p = make_float2(__shfl_xor_sync(0xffffffffu, b[r].x, d),
                                     __shfl_xor_sync(0xffffffffu, b[r].y, d));
        b[r] = (lane & d) ? F::mul(F::sub(p, b[r]), w) : F::add(b[r], p);
      }
    }
    __syncwarp();
    const int m = F::bitrev(lane, 5);
#pragma unroll
    for (int r = 0; r < 4; ++r) row[r + 4 * m] = b[r];
  }
  __syncthreads();
  // natural order: k = n1 k2 + k1 sits at row k1, column k2
  const int h_out = tail_only ? h >> 1 : h;
  const int k0 = h - h_out;
  const float s = inverse ? 1.0f / static_cast<float>(h) : 1.0f;
  const long long out_off = static_cast<long long>(blockIdx.x) * h_out;
  for (int t = threadIdx.x; t < h_out; t += blockDim.x) {
    const int k = k0 + t;
    const float2 v = z[((k & (n1 - 1)) << 7) | (k >> log2n1)];
    out_r[out_off + t] = v.x * s;
    out_i[out_off + t] = v.y * s;
  }
}

// h a power of two in [h_min, kMaxH]
bool bad_h(int h, int h_min) {
  return h < h_min || (h & (h - 1)) || h > kMaxH;
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, int h) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              h * static_cast<int>(sizeof(float2)));
}

}  // namespace

// tw: e^{-2 pi i t / 2h} for t < 2h as interleaved float32 (cos, sin) in
// every entry point below. Each returns the cudaError_t of its launch.

// K14. zr, zi: [rows, h] contiguous; out_r, out_i: [rows, h] or, with
// tail_only, [rows, h/2].
extern "C" int bfir_cfft_balanced(const float* zr, const float* zi,
                                  float* out_r, float* out_i, const float* tw,
                                  int rows, int h, int inverse, int tail_only,
                                  void* stream) {
  if (rows < 1 || bad_h(h, 1024)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = prepare(cfft_balanced_kernel, h);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int threads = clamp_threads(h >> 1);
  cfft_balanced_kernel<<<rows, threads, h * sizeof(float2),
                         static_cast<cudaStream_t>(stream)>>>(
      zr, zi, out_r, out_i, reinterpret_cast<const float2*>(tw), h,
      log2_of(h >> 7), inverse != 0, tail_only != 0);
  return static_cast<int>(cudaGetLastError());
}

// K15 (radix4 = 1) and K18 (radix4 = 0). x: [rows, 2h] contiguous, 8-byte
// aligned; hr, hi: [rows, h].
static int launch_rfft_hc(const float* x, float* hr, float* hi,
                          const float* tw, int rows, int h, bool radix4,
                          void* stream) {
  if (rows < 1 || bad_h(h, 512) || reinterpret_cast<size_t>(x) % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = radix4 ? rfft_hc_r4_kernel : rfft_hc_r2_kernel;
  cudaError_t e = prepare(kernel, h);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int threads = clamp_threads(radix4 ? h >> 2 : h >> 1);
  kernel<<<rows, threads, h * sizeof(float2),
           static_cast<cudaStream_t>(stream)>>>(
      x, hr, hi, reinterpret_cast<const float2*>(tw), h, log2_of(h));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bfir_rfft_hc_r4(const float* x, float* hr, float* hi,
                               const float* tw, int rows, int h,
                               void* stream) {
  return launch_rfft_hc(x, hr, hi, tw, rows, h, true, stream);
}

extern "C" int bfir_rfft_hc_r2(const float* x, float* hr, float* hi,
                               const float* tw, int rows, int h,
                               void* stream) {
  return launch_rfft_hc(x, hr, hi, tw, rows, h, false, stream);
}

// K16 (dif = 1, h >= 1024) and K17 (dif = 0, h >= 512). hr, hi: [rows,
// in_stride] with the planes in the first h lanes; out: [rows, h].
static int launch_irfft_tail(const float* hr, const float* hi,
                             long long in_stride, float* out, const float* tw,
                             int rows, int h, bool dif, void* stream) {
  if (rows < 1 || bad_h(h, dif ? 1024 : 512) || in_stride < h)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = dif ? irfft_tail_dif_kernel : irfft_tail_4step_kernel;
  cudaError_t e = prepare(kernel, h);
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

// Ring MAC for Hopper (sm_90a): kernels K1, K2, K3, K5, K6 and K8 of the
// port.
//
// Replaces bfir_tpu/kernels/spectrum_mac.py::mac_pallas_hc (K1),
// ::mac_pallas_hc_tiled (K2), ::mac_pallas_hc_tiled_int (K3),
// ::mac_pallas_hc_band (K5), ::mac_pallas_hc_band_int (K6) and
// ::mac_pallas_packed (K8).
//
//   y[c, k] = sum_p coeff[p, c, b0 + k] * ring[(pos - p) mod P, c, b0 + k]
//
// for k < band_len, on split planes [P, 2C, Hp] (re rows 0..C-1, im rows
// C..2C-1); y is [C, band_len]. K1-K3 run the full width (b0 = 0,
// band_len = Hp); the split-tail schedule's K5 and K6 run one 128-aligned
// band per streaming phase. Global lane 0 carries (DC.re, Nyquist.re), so
// its product is two real products, not a complex one; other bands have no
// such lane. Shared coefficients are [P, 2, Hp], read for every channel.
// K8, the packed engine's MAC, is the same sum over split planes
// [P, 2C, Fp] (Fp = N + 1 rounded up to 128) without the lane-0 law: its
// lane 0 is DC as a full complex value. A template switch drops the law.
//
// What bounds it on the H100: device-memory bandwidth. Per partition and
// lane it reads four plane values and does eight flops, about half a flop
// per byte in float32, forty times under the card's float32 ridge. At the
// two-stage tail (14 x 128 x 8192 ring and coefficients) one call streams
// about 117 MB in float32 and 88 MB in int24; one of its eight bands an
// eighth of that. K8 at the packed flagship (128 x 128 x 1152 ring and
// coefficients) reads only the N + 1 = 1025 live lanes of each row (1028,
// four to a vector): 135 MB, nearly three times the 50 MB L2, so its calls
// read from HBM. Bandwidth is reached only with enough loads in flight,
// about 2 MB on the card (3.35 TB/s x ~0.6 us to HBM): where a call has
// few lanes a channel (small blocks: N = 64's tail is [254, 128, 512], its
// head [16, 128, 128]), one thread a four-lane quad keeps too few loads
// out, and a thread that walks all P partitions pays P round trips one
// after another.
//
// Design: one thread owns four neighbouring lanes of one channel and loads
// them as one 16-byte (float32) or 8-byte (bf16, int16) vector, so a warp
// reads contiguous rows. The TPU kernel's sequential partition grid axis
// becomes a loop inside the thread with the sums in registers. A block is
// width x S threads: threadIdx.x walks `width` quads of one channel
// (blockIdx.y), threadIdx.y is the partition slice. Slice s sums the
// contiguous partitions [s P / S, (s + 1) P / S) in partition order, with
// `unroll` partitions' loads issued before their math
// (bfir::ring_mac4_range). Slices 1..S-1 leave their sums in shared
// memory; slice 0 adds them to its own in slice order 1, 2, ..., S-1 and
// writes each output once. The sum order is a function of the shape and
// the plan alone (no atomics), so a shape gives the same bits on every
// launch; at S = 1 it is the whole partition loop of one thread, as
// before slicing. The wrapper's plan (kernels/spectrum_mac.mac_hc_plan,
// a pure function of P, C, the band's width and the SM count) takes S = 1
// where the quads of all channels already fill the card, or where each
// thread's chain is short (the flagship's K1-K3, K5, K6), and otherwise
// the fewest slices that give the card 512 threads an SM. Storage decodes
// in registers: bf16 widens, int24 is (hi * 256 + lo) * scale and int16
// is hi * scale, with the row's scale read from column 0 of its [.., 128]
// scale plane. Accumulation is float32 for every storage. The TPU
// kernel's frequency tiling only fitted VMEM; here the grid tiles
// frequency, and where that is too little, the partitions too.
// Left for later work: shared coefficients are re-read per channel through
// L2 rather than staged once in shared memory; the flagship's head and
// bands keep S = 1 (their bits), sliced they are untried.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "mac_common.cuh"

namespace {

enum Kind { kF32 = 0, kBF16 = 1, kI24 = 2, kI16 = 3 };

constexpr int kThreads = 64;     // quads a block walks (32 where a band has
                                 // no more than 32, or S > kMaxBlock / 64)
constexpr int kMaxSlices = 16;   // partition slices a block
constexpr int kMaxBlock = 512;   // threads a block: width x slices
constexpr int kSliceUnroll = 2;  // partitions' loads in flight a sliced
                                 // thread (an unsliced one: 1)

struct Planes {
  const void* a;       // float32 / bf16 values, or the int16 high part
  const uint8_t* lo;   // int24 low byte (kI24 only)
  const float* scale;  // [rows, 128] per-row scale (kI24 / kI16 only)
};

template <int K>
__device__ __forceinline__ float4 load4(const Planes& pl, long long row,
                                        int hp, int lane) {
  const long long off = row * hp + lane;
  if constexpr (K == kF32) {
    return __ldg(reinterpret_cast<const float4*>(
        static_cast<const float*>(pl.a) + off));
  } else if constexpr (K == kBF16) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(
        static_cast<const __nv_bfloat16*>(pl.a) + off));
    const float2 f0 = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 f1 = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&u.y));
    return make_float4(f0.x, f0.y, f1.x, f1.y);
  } else {
    const float s = __ldg(pl.scale + row * 128);
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(
        static_cast<const int16_t*>(pl.a) + off));
    int q0 = static_cast<int16_t>(u.x & 0xffffu);
    int q1 = static_cast<int16_t>(u.x >> 16);
    int q2 = static_cast<int16_t>(u.y & 0xffffu);
    int q3 = static_cast<int16_t>(u.y >> 16);
    if constexpr (K == kI24) {
      const unsigned int l =
          __ldg(reinterpret_cast<const unsigned int*>(pl.lo + off));
      q0 = q0 * 256 + static_cast<int>(l & 0xffu);
      q1 = q1 * 256 + static_cast<int>((l >> 8) & 0xffu);
      q2 = q2 * 256 + static_cast<int>((l >> 16) & 0xffu);
      q3 = q3 * 256 + static_cast<int>(l >> 24);
    }
    return make_float4(static_cast<float>(q0) * s, static_cast<float>(q1) * s,
                       static_cast<float>(q2) * s, static_cast<float>(q3) * s);
  }
}

__device__ __forceinline__ void add4(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

// Block (width, S): thread (x, s) sums partition slice s of quad
// blockIdx.x * width + x of channel blockIdx.y. kUnroll == 1 is the
// unsliced launch (S = 1): each thread walks all P partitions
// (bfir::ring_mac4), as before slicing. A sliced launch (kUnroll =
// kSliceUnroll, S > 1) keeps the sums of slices 1..S-1 in shared memory,
// [S - 1][2][width] float4, for slice 0 to add.
template <int RK, int CK, bool kLane0, int kUnroll>
__global__ void __launch_bounds__(kUnroll == 1 ? kThreads : kMaxBlock)
    mac_hc_kernel(Planes ring, Planes coeff, float* __restrict__ yr,
                  float* __restrict__ yi, int P, int C, int Cs, int hp,
                  int band_start, int band_len, int pos) {
  extern __shared__ float4 part[];
  const int width = blockDim.x;
  const int k = (blockIdx.x * width + threadIdx.x) * 4;
  const int c = blockIdx.y;
  const bool live = k < band_len;
  const int lane = band_start + k;
  const int cc = Cs == 1 ? 0 : c;
  const bool lane0 = kLane0 && lane == 0;
  auto load = [&](int slot, int p, float4& rr, float4& ri, float4& cr,
                  float4& ci) {
    const long long r_row = static_cast<long long>(slot) * 2 * C + c;
    const long long c_row = static_cast<long long>(p) * 2 * Cs + cc;
    rr = load4<RK>(ring, r_row, hp, lane);
    ri = load4<RK>(ring, r_row + C, hp, lane);
    cr = load4<CK>(coeff, c_row, hp, lane);
    ci = load4<CK>(coeff, c_row + Cs, hp, lane);
  };
  float4 ar, ai;
  if constexpr (kUnroll == 1) {
    if (!live) return;
    bfir::ring_mac4(ar, ai, P, pos, lane0, load);
  } else {
    const int slices = blockDim.y, s = threadIdx.y;
    ar = make_float4(0.f, 0.f, 0.f, 0.f);
    ai = ar;
    if (live)
      bfir::ring_mac4_range<kUnroll>(ar, ai, s * P / slices,
                                     (s + 1) * P / slices, P, pos, lane0,
                                     load);
    if (s > 0) {
      part[(2 * (s - 1)) * width + threadIdx.x] = ar;
      part[(2 * (s - 1) + 1) * width + threadIdx.x] = ai;
    }
    __syncthreads();
    if (s > 0 || !live) return;
    for (int g = 1; g < slices; ++g) {  // slice order
      add4(ar, part[(2 * (g - 1)) * width + threadIdx.x]);
      add4(ai, part[(2 * (g - 1) + 1) * width + threadIdx.x]);
    }
  }
  const long long o = static_cast<long long>(c) * band_len + k;
  *reinterpret_cast<float4*>(yr + o) = ar;
  *reinterpret_cast<float4*>(yi + o) = ai;
}

// The launch plan as the wrapper passes it: S partition slices, the
// unroll and the block's quad width.
struct Plan {
  int slices, unroll, width;
};

// True when the kernel takes ``pl`` for P partitions: an unsliced launch
// unrolls 1, a sliced one kSliceUnroll.
bool plan_ok(const Plan& pl, int P) {
  return pl.slices >= 1 && pl.slices <= kMaxSlices && pl.slices <= P &&
         (pl.width == 32 || pl.width == kThreads) &&
         pl.width * pl.slices <= kMaxBlock &&
         pl.unroll == (pl.slices == 1 ? 1 : kSliceUnroll);
}

template <int RK, int CK, bool kLane0 = true>
void launch(const Planes& r, const Planes& g, float* yr, float* yi, int P,
            int C, int Cs, int hp, int b0, int bl, int pos, const Plan& pl,
            cudaStream_t s) {
  const dim3 grid((bl / 4 + pl.width - 1) / pl.width, C);
  const dim3 block(pl.width, pl.slices);
  const size_t smem = sizeof(float4) * 2 * pl.width * (pl.slices - 1);
  if (pl.unroll == 1)
    mac_hc_kernel<RK, CK, kLane0, 1><<<grid, block, smem, s>>>(
        r, g, yr, yi, P, C, Cs, hp, b0, bl, pos);
  else
    mac_hc_kernel<RK, CK, kLane0, kSliceUnroll><<<grid, block, smem, s>>>(
        r, g, yr, yi, P, C, Cs, hp, b0, bl, pos);
}

}  // namespace

// Launches the MAC on ``stream``; returns the cudaError_t of the launch.
// r_kind / c_kind: 0 float32, 1 bf16, 2 int24, 3 int16 (float kinds pair
// with float kinds, integer kinds with integer kinds). 0 <= pos < P. The
// band [b0, b0 + bl) lies inside [0, hp), b0 and bl multiples of 4; yr and
// yi are [C, bl]. (slices, unroll, width) is the wrapper's plan
// (spectrum_mac.mac_hc_plan); a plan outside plan_ok is refused, never
// replaced.
extern "C" int bfir_mac_hc(const void* r_a, const void* r_lo,
                           const float* r_scale, int r_kind, const void* c_a,
                           const void* c_lo, const float* c_scale, int c_kind,
                           float* yr, float* yi, int P, int C, int Cs, int hp,
                           int b0, int bl, int pos, int slices, int unroll,
                           int width, void* stream) {
  const Plan pl{slices, unroll, width};
  if (P < 1 || C < 1 || (Cs != 1 && Cs != C) || hp < 4 || hp % 4 ||
      b0 < 0 || b0 % 4 || bl < 4 || bl % 4 || b0 + bl > hp || pos < 0 ||
      pos >= P || !plan_ok(pl, P))
    return static_cast<int>(cudaErrorInvalidValue);
  const Planes r{r_a, static_cast<const uint8_t*>(r_lo), r_scale};
  const Planes g{c_a, static_cast<const uint8_t*>(c_lo), c_scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (r_kind * 4 + c_kind) {
    case kF32 * 4 + kF32: launch<kF32, kF32>(r, g, yr, yi, P, C, Cs, hp, b0, bl, pos, pl, s); break;
    case kF32 * 4 + kBF16: launch<kF32, kBF16>(r, g, yr, yi, P, C, Cs, hp, b0, bl, pos, pl, s); break;
    case kBF16 * 4 + kF32: launch<kBF16, kF32>(r, g, yr, yi, P, C, Cs, hp, b0, bl, pos, pl, s); break;
    case kBF16 * 4 + kBF16: launch<kBF16, kBF16>(r, g, yr, yi, P, C, Cs, hp, b0, bl, pos, pl, s); break;
    case kI24 * 4 + kI24: launch<kI24, kI24>(r, g, yr, yi, P, C, Cs, hp, b0, bl, pos, pl, s); break;
    case kI24 * 4 + kI16: launch<kI24, kI16>(r, g, yr, yi, P, C, Cs, hp, b0, bl, pos, pl, s); break;
    case kI16 * 4 + kI24: launch<kI16, kI24>(r, g, yr, yi, P, C, Cs, hp, b0, bl, pos, pl, s); break;
    case kI16 * 4 + kI16: launch<kI16, kI16>(r, g, yr, yi, P, C, Cs, hp, b0, bl, pos, pl, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// K8: the packed MAC over float32 ring and coefficients [P, 2C, fp] (no
// lane-0 law, per-channel coefficients) on the first ``lanes`` lanes of each
// row -> yr, yi [C, lanes]. The engine passes N + 1 bins rounded up to 4, so
// the zero lanes that pad a row to fp are neither read nor written. fp and
// lanes are multiples of 4, lanes <= fp; 0 <= pos < P; the plan as for
// bfir_mac_hc.
extern "C" int bfir_mac_packed(const float* ring, const float* coeff,
                               float* yr, float* yi, int P, int C, int fp,
                               int lanes, int pos, int slices, int unroll,
                               int width, void* stream) {
  const Plan pl{slices, unroll, width};
  if (P < 1 || C < 1 || fp < 4 || fp % 4 || lanes < 4 || lanes % 4 ||
      lanes > fp || pos < 0 || pos >= P || !plan_ok(pl, P))
    return static_cast<int>(cudaErrorInvalidValue);
  const Planes r{ring, nullptr, nullptr};
  const Planes g{coeff, nullptr, nullptr};
  launch<kF32, kF32, false>(r, g, yr, yi, P, C, C, fp, 0, lanes, pos, pl,
                            static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* bfir_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

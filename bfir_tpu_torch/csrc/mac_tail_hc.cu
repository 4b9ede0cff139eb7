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
// the 50 MB L2) and, far behind, the product, a [C, 2Hp] x [2Hp, Hp] GEMM:
// 4 C Hp^2 flops (268 MFLOP, 4 us at 67 TFLOP/s) against an 8.4 MB basis.
// The TPU kernel kept the accumulator in VMEM across its sequential
// partition grid and multiplied it on the MXU at the last step; on the
// H100 the MAC must spread over all 132 SMs to reach the bandwidth, and
// the product needs every channel's whole accumulator row, so the two
// phases meet through L2 at a grid-wide barrier.
//
// Design: one cooperative launch (cudaLaunchCooperativeKernel) of a
// persistent grid, as many 256-thread blocks as fit on the card at once,
// in three phases separated by cooperative_groups grid syncs.
// 1. The MAC, K1's loop (bfir::ring_mac4) with four partitions' loads
//    issued before their math: a thread owns four neighbouring lanes of
//    one channel with 16-byte loads; work comes in warp-sized items of 32
//    such threads, dealt round-robin over the blocks so that every SM
//    streams. Each thread scatters its sums into the float32
//    scratch acc [2Hp, Cs] (k-major, Cs = C rounded up to kTile), which
//    stays in L2 (512 KB at the flagship).
// 2. The product: work items are (64-channel tile, 64-sample tile, k
//    split); each block stages 16-deep k-slices of acc and of its basis
//    columns into shared memory (double-buffered through registers, one
//    barrier a slice) and each thread keeps a 4 x 4 register tile of
//    outputs, summing k in one fixed order. The k splits make enough items
//    to fill the grid (the wrapper's plan: splits x tiles about the grid
//    size); each basis element is read once per channel tile, not once per
//    channel. With one split the tile goes straight to out; else to a
//    partial-sum scratch [S, C, Hp].
// 3. With S > 1, after a second grid sync, out = the partials summed in
//    split order. No atomics: the result does not depend on scheduling.
// Left for later work: the product's slices are fetched one ahead, so
// their latency shows beside its arithmetic (PERF.md, section 6).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "mac_common.cuh"

namespace cg = cooperative_groups;

namespace {

using bfir::ld4;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;   // product tile: channels x samples
constexpr int kSlice = 16;  // k-slice staged per step
constexpr int kUnroll = 4;  // partitions whose loads issue together
static_assert(kSlice * kTile == 4 * kThreads, "one float4 a thread a slice");

struct Args {
  const float* ring;
  const float* coeff;
  const float* wr;
  const float* wi;
  float* out;
  float* acc;   // [2 hp, cs]
  float* part;  // [splits, C, hp] (splits > 1)
  int P, C, hp, pos, cs, splits, ks;
};

__device__ __forceinline__ float4 ldcg4(const float* p) {
  return __ldcg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ void fma4(float4& o, float a, float4 b) {
  o.x = fmaf(a, b.x, o.x);
  o.y = fmaf(a, b.y, o.y);
  o.z = fmaf(a, b.z, o.z);
  o.w = fmaf(a, b.w, o.w);
}

// Phase 1: warp item j is items 32 j .. 32 j + 31 of the C * hp / 4
// (channel, lane group) pairs, channel-major.
__device__ void mac_phase(const Args& a) {
  const int groups = a.hp / 4;
  const int items = a.C * groups;
  const int witems = (items + 31) / 32;
  const int warp = threadIdx.x / 32;
  const long long slot_stride = 2LL * a.C * a.hp;
  for (int j = blockIdx.x + gridDim.x * warp; j < witems;
       j += gridDim.x * kWarps) {
    const int i = j * 32 + threadIdx.x % 32;
    if (i >= items) continue;
    const int c = i / groups;
    const int k = (i % groups) * 4;
    const long long re = static_cast<long long>(c) * a.hp + k;
    const long long im = re + static_cast<long long>(a.C) * a.hp;
    float4 ar, ai;
    bfir::ring_mac4<kUnroll>(ar, ai, a.P, a.pos, k == 0,
                    [&](int slot, int p, float4& rr, float4& ri, float4& cr,
                        float4& ci) {
                      const float* r = a.ring + slot * slot_stride;
                      const float* w = a.coeff + p * slot_stride;
                      rr = ld4(r + re);
                      ri = ld4(r + im);
                      cr = ld4(w + re);
                      ci = ld4(w + im);
                    });
    float* dr = a.acc + static_cast<long long>(k) * a.cs + c;
    float* di = dr + static_cast<long long>(a.hp) * a.cs;
    dr[0] = ar.x;
    dr[a.cs] = ar.y;
    dr[2 * a.cs] = ar.z;
    dr[3 * a.cs] = ar.w;
    di[0] = ai.x;
    di[a.cs] = ai.y;
    di[2 * a.cs] = ai.z;
    di[3 * a.cs] = ai.w;
  }
}

struct Slices {
  float a[2][kSlice][kTile];  // acc[k0 + kk, c0 + j]
  float b[2][kSlice][kTile];  // basis[k0 + kk, t0 + j]
};

// Thread tid's share of slice k0: row tid / 16, columns 4 (tid % 16) + 0..3
// of both tiles; zero beyond the split's end and beyond hp.
__device__ __forceinline__ void fetch(const Args& a, int k0, int ke, int c0,
                                      int t0, float4& va, float4& vb) {
  const int kk = k0 + threadIdx.x / 16;
  const int col = 4 * (threadIdx.x % 16);
  va = vb = make_float4(0.f, 0.f, 0.f, 0.f);
  if (kk < ke) {
    va = ldcg4(a.acc + static_cast<long long>(kk) * a.cs + c0 + col);
    if (t0 + col < a.hp) {
      const float* w = kk < a.hp ? a.wr + static_cast<long long>(kk) * a.hp
                                 : a.wi + static_cast<long long>(kk - a.hp) *
                                              a.hp;
      vb = ld4(w + t0 + col);
    }
  }
}

// Phase 2: item w is (tile w / splits, split w % splits); tiles are
// channel-tile-major. Thread tid owns channels cb..cb+3 and samples
// tb..tb+3 of its tile: a warp covers 16 channels x 32 samples, so its
// shared reads are 4 and 8 distinct 16-byte words (broadcast, no
// conflicts).
__device__ void product_phase(const Args& a, Slices& s) {
  const int nct = (a.C + kTile - 1) / kTile;
  const int ntt = (a.hp + kTile - 1) / kTile;
  const int items = nct * ntt * a.splits;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int cb = (warp / 2) * 16 + (lane / 8) * 4;
  const int tb = (warp % 2) * 32 + (lane % 8) * 4;
  const int srow = threadIdx.x / 16;
  const int scol = 4 * (threadIdx.x % 16);
  int buf = 0;
  for (int w = blockIdx.x; w < items; w += gridDim.x) {
    const int split = w % a.splits;
    const int tile = w / a.splits;
    const int c0 = (tile / ntt) * kTile;
    const int t0 = (tile % ntt) * kTile;
    const int kb = split * a.ks;
    const int ke = min(2 * a.hp, kb + a.ks);
    float4 o[4];
    for (int i = 0; i < 4; ++i) o[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 va, vb;
    fetch(a, kb, ke, c0, t0, va, vb);
    for (int k0 = kb; k0 < ke; k0 += kSlice) {
      *reinterpret_cast<float4*>(&s.a[buf][srow][scol]) = va;
      *reinterpret_cast<float4*>(&s.b[buf][srow][scol]) = vb;
      __syncthreads();
      if (k0 + kSlice < ke) fetch(a, k0 + kSlice, ke, c0, t0, va, vb);
#pragma unroll
      for (int kk = 0; kk < kSlice; ++kk) {
        const float4 x = *reinterpret_cast<const float4*>(&s.a[buf][kk][cb]);
        const float4 y = *reinterpret_cast<const float4*>(&s.b[buf][kk][tb]);
        fma4(o[0], x.x, y);
        fma4(o[1], x.y, y);
        fma4(o[2], x.z, y);
        fma4(o[3], x.w, y);
      }
      buf ^= 1;
    }
    if (t0 + tb >= a.hp) continue;
    float* dst = a.splits == 1
                     ? a.out
                     : a.part + static_cast<long long>(split) * a.C * a.hp;
    for (int i = 0; i < 4; ++i) {
      const int c = c0 + cb + i;
      if (c < a.C)
        *reinterpret_cast<float4*>(dst + static_cast<long long>(c) * a.hp +
                                   t0 + tb) = o[i];
    }
  }
}

// Phase 3: out = part[0] + part[1] + ... in that order.
__device__ void reduce_phase(const Args& a) {
  const long long n4 = static_cast<long long>(a.C) * a.hp / 4;
  for (long long i = blockIdx.x * static_cast<long long>(kThreads) +
                     threadIdx.x;
       i < n4; i += static_cast<long long>(gridDim.x) * kThreads) {
    float4 v = ldcg4(a.part + 4 * i);
    for (int sp = 1; sp < a.splits; ++sp) {
      const float4 u = ldcg4(a.part + 4 * (sp * n4 + i));
      v = make_float4(v.x + u.x, v.y + u.y, v.z + u.z, v.w + u.w);
    }
    reinterpret_cast<float4*>(a.out)[i] = v;
  }
}

__global__ void __launch_bounds__(kThreads, 2)
    mac_tail_hc_kernel(Args a) {
  __shared__ Slices s;
  cg::grid_group grid = cg::this_grid();
  mac_phase(a);
  grid.sync();
  product_phase(a, s);
  if (a.splits > 1) {
    grid.sync();
    reduce_phase(a);
  }
}

}  // namespace

// K12's grid: the blocks of 256 threads that fit on the current device at
// once (occupancy x SMs), the size of its cooperative launch. Fails where
// the device cannot launch cooperatively.
extern "C" int bfir_mac_tail_hc_grid(int* grid) {
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, mac_tail_hc_kernel, kThreads, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (!coop || per_sm < 1) return static_cast<int>(cudaErrorNotSupported);
  *grid = per_sm * sms;
  return 0;
}

// K12: float32 ring and per-channel coefficients [P, 2C, hp], basis wr, wi
// [hp, hp] -> out [C, hp], hp a multiple of 4, 0 <= pos < P. scratch holds
// acc [2 hp, cs] (cs = C rounded up to 64), then, when splits > 1, the
// partial sums [splits, C, hp]; the k range 2 hp is cut into splits of ks
// (a multiple of 16) rows. grid at most bfir_mac_tail_hc_grid's.
extern "C" int bfir_mac_tail_hc(const float* ring, const float* coeff,
                                const float* wr, const float* wi, float* out,
                                float* scratch, int P, int C, int hp, int pos,
                                int grid, int splits, int ks, void* stream) {
  const int cs = (C + kTile - 1) / kTile * kTile;
  if (P < 1 || C < 1 || hp < 4 || hp % 4 || pos < 0 || pos >= P ||
      grid < 1 || splits < 1 || ks < kSlice || ks % kSlice ||
      static_cast<long long>(splits) * ks < 2LL * hp ||
      static_cast<long long>(splits - 1) * ks >= 2LL * hp)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{ring, coeff, wr, wi, out, scratch,
         scratch + 2LL * hp * cs, P, C, hp, pos, cs, splits, ks};
  void* params[] = {&a};
  cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(mac_tail_hc_kernel), dim3(grid),
      dim3(kThreads), params, 0, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

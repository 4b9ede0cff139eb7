// Correlation MAC of the G-cycle batched bulk scan for Hopper (sm_90a):
// kernel K7 of the port.
//
// Replaces bfir_tpu/kernels/corr_mac.py::corr_mac_pallas (its Pallas body
// is _corr_chunk). For an ordered (newest-last) spectrum history
// hist [P-1+B, 2C, Hp] and coefficient planes coeff [P, 2Cs, Hp] (Cs = C,
// or 1 for one filter shared by all channels):
//
//   y[b, c, k] = sum_q coeff[q, c, k] * hist[P-1+b-q, c, k],   b < B
//
// on split planes (re rows, then im rows), with the halfcomplex law at
// global lane 0: (DC.re, Nyquist.re) are two real products. Outputs are
// float32 [B, C, Hp]; hist and coeff are float32 or bf16 (widened in
// registers). A row of either holds a whole number of 16-byte chunks
// (Hp % 4 == 0 in float32, Hp % 8 == 0 in bf16): the unit of the copies.
//
// What bounds it on the H100: device-memory bandwidth, each input byte
// read once. At the flagship's G = 8 the head call (P = 16, B = 64,
// C = 64, Hp = 1024) moves 83.4 MB (history 41.4, coefficients 8.4,
// outputs 33.6), 24.9 us at 3.35 TB/s; the tail call (P = 14, B = 8,
// Hp = 8192) 180.4 MB (88.1, 58.7, 33.6), 53.8 us. The arithmetic, four
// FMAs per (b, q, channel, lane), is about a third of that time.
//
// Design: a persistent grid that streams.
// - Work items are (channel, lane tile, b range), dealt round-robin over a
//   grid of occupancy x SMs blocks (the wrapper's plan, capped at the item
//   count). The b range is all of B unless the items would leave SMs idle;
//   the wrapper counts what a split re-reads.
// - In each block one producer thread walks the block's items and copies
//   every row tile they need, in the order the consumers use them, into a
//   ring of S shared-memory stages: a tile is the re segment and the im
//   segment of one row over the tile's lanes, two cp.async.bulk (TMA bulk)
//   copies completing on the stage's "full" mbarrier. The ring keeps up to
//   S tiles in flight, across item boundaries: the next item's
//   coefficients arrive while this one computes.
// - The consumer warps own the tile's lanes, V neighbouring lanes a
//   thread (S, V and the consumer threads: the launch variant). An item's
//   coefficients come first, kQW taps at a time, into registers; then its
//   history rows, each read from shared memory once into a register
//   window of the last kQW rows. The b loop is unrolled by kQW, so every
//   window index is a compile-time constant; each output sums its kQW
//   taps in q order from registers. A warp releases a stage to the
//   producer through the stage's "empty" mbarrier once it holds the row.
// - P > kQW walks further chunks of kQW taps, each streaming the rows it
//   needs again, and adds into the thread's own outputs; every output has
//   one writer, and no atomics: the result does not depend on scheduling.
// - The lane-0 law costs no branch and no register a tap: a thread's
//   first lane sums cr wr, ci wi, cr wi and ci wr apart (the four FMAs a
//   tap that the complex product takes anyway) and combines them once an
//   output: (s1 - s2, s3 + s4), or (s1, s2) at global lane 0. Every
//   thread runs the same code, so no warp diverges, and no planes are
//   folded in memory as _corr_chunk's A/B planes were.
// On the card the tail call runs near 80% of its bound; the head call,
// two fifths of whose bytes are writes, lower, near the rate of a
// device-to-device copy of the same bytes (PERF.md, section 6).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

enum Kind { kF32 = 0, kBF16 = 1 };

constexpr int kQW = 16;  // taps (and window rows) held in registers

// launch variants: consumer threads, lanes a thread, ring stages.
// kernels/corr_mac.py picks one per call shape (its _VARIANTS and
// _variant): 128-lane tiles at the head's Hp = 1024, 256-lane tiles at the
// tail's Hp = 8192, the fastest of eight variants (64-256 threads, one or
// two lanes a thread, 8-32 stages) timed at each on the H100. Two lanes a
// thread take 162 registers, so four blocks of 96 threads (two of 160)
// fit an SM.
struct Variant {
  int threads, lanes, stages;
};
constexpr Variant kVariants[] = {{64, 2, 16}, {128, 2, 16}};
constexpr int kNumVariants = sizeof(kVariants) / sizeof(kVariants[0]);

template <int K>
struct Elem {
  using T = float;
};
template <>
struct Elem<kBF16> {
  using T = __nv_bfloat16;
};

struct Args {
  const void* hist;
  const void* coeff;
  float* yr;
  float* yi;
  int P, B, C, Cs, hp, b_chunk, nsplit, items;
};

struct Item {
  int c, t0, lanes, b0, b1;
};

// item w -> (b split fastest, then channel, then lane tile)
__device__ __forceinline__ Item item_of(const Args& a, int w, int tile) {
  const int rest = w / a.nsplit;
  Item it;
  it.c = rest % a.C;
  it.t0 = rest / a.C * tile;
  it.lanes = min(tile, a.hp - it.t0);
  it.b0 = w % a.nsplit * a.b_chunk;
  it.b1 = min(a.B, it.b0 + a.b_chunk);
  return it;
}

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(saddr(bar)),
               "r"(count));
}

__device__ __forceinline__ bool mbar_try(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}"
      : "=r"(done)
      : "r"(saddr(bar)), "r"(parity)
      : "memory");
  return done;
}

// Wait for the phase of ``bar`` with ``parity`` to complete. A wait that
// lasts about ten seconds traps (the launch then fails) instead of
// hanging the device.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  if (mbar_try(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try(bar, parity))
    if (clock64() - t0 > (1LL << 34)) __trap();
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(saddr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          saddr(bar)),
      "r"(bytes)
      : "memory");
}

// bytes (a multiple of 16) from global src to shared dst, both 16-byte
// aligned, completing on bar
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(saddr(dst)),
      "l"(src), "r"(bytes), "r"(saddr(bar))
      : "memory");
}

// V lanes from element i * V of a shared segment, widened to float
template <int K, int V>
__device__ __forceinline__ void read_lanes(const unsigned char* seg, int i,
                                           float (&out)[V]) {
  if constexpr (K == kF32) {
    const float* s = reinterpret_cast<const float*>(seg) + i * V;
    if constexpr (V == 1) {
      out[0] = s[0];
    } else {
      static_assert(V == 2, "one or two lanes a thread");
      const float2 t = *reinterpret_cast<const float2*>(s);
      out[0] = t.x;
      out[1] = t.y;
    }
  } else {
    const __nv_bfloat16* s =
        reinterpret_cast<const __nv_bfloat16*>(seg) + i * V;
    if constexpr (V == 1) {
      out[0] = __bfloat162float(s[0]);
    } else {
      const float2 t =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(s));
      out[0] = t.x;
      out[1] = t.y;
    }
  }
}

template <int V>
__device__ __forceinline__ void store_lanes(float* dst, const float (&v)[V],
                                            bool add) {
  if constexpr (V == 1) {
    dst[0] = add ? dst[0] + v[0] : v[0];
  } else {
    float2 t = make_float2(v[0], v[1]);
    if (add) {
      const float2 e = *reinterpret_cast<const float2*>(dst);
      t.x += e.x;
      t.y += e.y;
    }
    *reinterpret_cast<float2*>(dst) = t;
  }
}

// the ring of S stages of T-lane tiles: a stage holds the re segment,
// then the im segment, kSeg bytes each (float32-sized, so that either
// input's tiles fit)
template <int T, int S>
struct Ring {
  static constexpr int kSeg = T * 4;
  unsigned char* stage;  // [S][2 * kSeg]
  uint64_t* full;        // the stage's tile has landed
  uint64_t* empty;       // every consumer warp holds the stage's tile
};

// The producer: every row tile of the block's items, in consumer order.
template <int T, int S, int HK, int CK>
__device__ void produce(const Args& a, const Ring<T, S>& ring) {
  using HT = typename Elem<HK>::T;
  using CT = typename Elem<CK>::T;
  constexpr int kSeg = Ring<T, S>::kSeg;
  const HT* hist = static_cast<const HT*>(a.hist);
  const CT* coeff = static_cast<const CT*>(a.coeff);
  uint32_t j = 0;
  auto push = [&](const void* re, const void* im, uint32_t bytes) {
    const int s = j % S;
    mbar_wait(&ring.empty[s], ((j / S) & 1) ^ 1);
    mbar_expect_tx(&ring.full[s], 2 * bytes);
    unsigned char* dst = ring.stage + s * 2 * kSeg;
    bulk_copy(dst, re, bytes, &ring.full[s]);
    bulk_copy(dst + kSeg, im, bytes, &ring.full[s]);
    ++j;
  };
  for (int w = blockIdx.x; w < a.items; w += gridDim.x) {
    const Item it = item_of(a, w, T);
    const int cc = a.Cs == 1 ? 0 : it.c;
    for (int q0 = 0; q0 < a.P; q0 += kQW) {
      const int qn = min(kQW, a.P - q0);
      for (int k = 0; k < qn; ++k) {
        const CT* re = coeff +
                       (static_cast<long long>(q0 + k) * 2 * a.Cs + cc) *
                           a.hp +
                       it.t0;
        push(re, re + static_cast<long long>(a.Cs) * a.hp,
             it.lanes * sizeof(CT));
      }
      const int base = a.P - 1 - q0;
      for (int r = max(0, base + it.b0 - kQW + 1); r < base + it.b1; ++r) {
        const HT* re =
            hist + (static_cast<long long>(r) * 2 * a.C + it.c) * a.hp +
            it.t0;
        push(re, re + static_cast<long long>(a.C) * a.hp,
             it.lanes * sizeof(HT));
      }
    }
  }
}

// The consumers: the block's items in order, each through the ring;
// thread i owns lanes t0 + i V .. t0 + i V + V - 1 of an item.
template <int NT, int V, int S, int HK, int CK>
__device__ void consume(const Args& a, const Ring<NT * V, S>& ring) {
  constexpr int T = NT * V;
  constexpr int kSeg = Ring<T, S>::kSeg;
  const int i = threadIdx.x;
  const bool leader = (i & 31) == 0;
  uint32_t j = 0;
  auto wait = [&]() -> const unsigned char* {
    const int s = j % S;
    mbar_wait(&ring.full[s], (j / S) & 1);
    return ring.stage + s * 2 * kSeg;
  };
  auto release = [&]() {
    __syncwarp();
    if (leader) mbar_arrive(&ring.empty[j % S]);
    ++j;
  };
  for (int w = blockIdx.x; w < a.items; w += gridDim.x) {
    const Item it = item_of(a, w, T);
    const bool lane0 = it.t0 == 0 && i == 0;
    const bool live = i * V < it.lanes;
    const long long out0 =
        static_cast<long long>(it.c) * a.hp + it.t0 + i * V;
    for (int q0 = 0; q0 < a.P; q0 += kQW) {
      const int qn = min(kQW, a.P - q0);
      float cr[kQW][V], ci[kQW][V];
#pragma unroll
      for (int k = 0; k < kQW; ++k) {
        if (k < qn) {
          const unsigned char* st = wait();
          read_lanes<CK, V>(st, i, cr[k]);
          read_lanes<CK, V>(st + kSeg, i, ci[k]);
          release();
        } else {
#pragma unroll
          for (int v = 0; v < V; ++v) cr[k][v] = ci[k][v] = 0.f;
        }
      }
      // window slot (b - b0) mod kQW holds history row base + b; before
      // the first group, slot t holds row base + b0 - kQW + t
      const int base = a.P - 1 - q0;
      float wr[kQW][V], wi[kQW][V];
#pragma unroll
      for (int t = 0; t < kQW; ++t) {
        if (t > 0 && base + it.b0 - kQW + t >= 0) {
          const unsigned char* st = wait();
          read_lanes<HK, V>(st, i, wr[t]);
          read_lanes<HK, V>(st + kSeg, i, wi[t]);
          release();
        } else {  // only ever paired with taps past P (zero)
#pragma unroll
          for (int v = 0; v < V; ++v) wr[t][v] = wi[t][v] = 0.f;
        }
      }
      for (int bb = it.b0; bb < it.b1; bb += kQW) {
#pragma unroll
        for (int u = 0; u < kQW; ++u) {
          const int b = bb + u;
          if (b >= it.b1) break;
          const unsigned char* st = wait();
          read_lanes<HK, V>(st, i, wr[u]);
          read_lanes<HK, V>(st + kSeg, i, wi[u]);
          release();
          // the first lane keeps the four real sums (cr wr, ci wi, cr wi,
          // ci wr) apart and combines them by the lane-0 law at the end;
          // the other lanes accumulate the complex product
          float s1 = 0.f, s2 = 0.f, s3 = 0.f, s4 = 0.f;
          float ar[V], ai[V];
#pragma unroll
          for (int v = 0; v < V; ++v) ar[v] = ai[v] = 0.f;
#pragma unroll
          for (int k = 0; k < kQW; ++k) {
            const int s = (u - k + kQW) % kQW;
            s1 = fmaf(cr[k][0], wr[s][0], s1);
            s2 = fmaf(ci[k][0], wi[s][0], s2);
            s3 = fmaf(cr[k][0], wi[s][0], s3);
            s4 = fmaf(ci[k][0], wr[s][0], s4);
#pragma unroll
            for (int v = 1; v < V; ++v) {
              ar[v] = fmaf(cr[k][v], wr[s][v], ar[v]);
              ar[v] = fmaf(-ci[k][v], wi[s][v], ar[v]);
              ai[v] = fmaf(cr[k][v], wi[s][v], ai[v]);
              ai[v] = fmaf(ci[k][v], wr[s][v], ai[v]);
            }
          }
          ar[0] = lane0 ? s1 : s1 - s2;  // (DC.re, Nyquist.re) at lane 0
          ai[0] = lane0 ? s2 : s3 + s4;
          if (live) {
            const long long o = static_cast<long long>(b) * a.C * a.hp + out0;
            store_lanes<V>(a.yr + o, ar, q0 > 0);
            store_lanes<V>(a.yi + o, ai, q0 > 0);
          }
        }
      }
    }
  }
}

template <int NT, int V, int S, int HK, int CK>
__global__ void __launch_bounds__(NT + 32)
    corr_mac_kernel(const Args a) {
  constexpr int T = NT * V;
  __shared__ alignas(128) unsigned char stage[S * 2 * T * 4];
  __shared__ alignas(8) uint64_t full[S];
  __shared__ alignas(8) uint64_t empty[S];
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NT / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const Ring<T, S> ring{stage, full, empty};
  if (threadIdx.x < NT) {
    consume<NT, V, S, HK, CK>(a, ring);
  } else if (threadIdx.x == NT) {
    produce<T, S, HK, CK>(a, ring);
  }
}

template <int I, int HK, int CK>
auto kernel_of() {
  constexpr Variant v = kVariants[I];
  return &corr_mac_kernel<v.threads, v.lanes, v.stages, HK, CK>;
}

// f(kernel, threads a block) for variant I and the kinds' instantiation
template <int I, class F>
cudaError_t with_kernel(int h_kind, int c_kind, F f) {
  constexpr int nt = kVariants[I].threads + 32;
  switch (h_kind * 2 + c_kind) {
    case kF32 * 2 + kF32: return f(kernel_of<I, kF32, kF32>(), nt);
    case kF32 * 2 + kBF16: return f(kernel_of<I, kF32, kBF16>(), nt);
    case kBF16 * 2 + kF32: return f(kernel_of<I, kBF16, kF32>(), nt);
    case kBF16 * 2 + kBF16: return f(kernel_of<I, kBF16, kBF16>(), nt);
    default: return cudaErrorInvalidValue;
  }
}

template <int I = 0, class F>
cudaError_t dispatch(int variant, int h_kind, int c_kind, F f) {
  if constexpr (I < kNumVariants) {
    if (variant == I) return with_kernel<I>(h_kind, c_kind, f);
    return dispatch<I + 1>(variant, h_kind, c_kind, f);
  } else {
    return cudaErrorInvalidValue;
  }
}

}  // namespace

// Blocks of K7's variant ``variant`` that fit on one SM of the current
// device at once, and the device's SM count: the wrapper's grid.
extern "C" int bfir_corr_mac_occupancy(int variant, int h_kind, int c_kind,
                                       int* per_sm, int* sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(
      dispatch(variant, h_kind, c_kind, [&](auto kernel, int threads) {
        return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel,
                                                             threads, 0);
      }));
}

// Launches K7 on ``stream``; returns the cudaError_t of the launch.
// h_kind / c_kind: 0 float32, 1 bf16. hist is [P-1+B, 2C, hp], coeff
// [P, 2Cs, hp], yr and yi [B, C, hp], each row a whole number of 16-byte
// chunks. Work items: C x ceil(hp / tile) x ceil(B / b_chunk), tile the
// variant's threads x lanes, b_chunk a positive multiple of 16, over a
// grid of ``grid`` blocks.
extern "C" int bfir_corr_mac(const void* hist, int h_kind, const void* coeff,
                             int c_kind, float* yr, float* yi, int P, int B,
                             int C, int Cs, int hp, int variant, int b_chunk,
                             int grid, void* stream) {
  const int hsize = h_kind == kBF16 ? 2 : 4;
  const int csize = c_kind == kBF16 ? 2 : 4;
  if (P < 1 || B < 1 || C < 1 || (Cs != 1 && Cs != C) || hp < 4 ||
      hp * hsize % 16 || hp * csize % 16 || b_chunk < kQW || b_chunk % kQW ||
      grid < 1 || variant < 0 || variant >= kNumVariants)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tile = kVariants[variant].threads * kVariants[variant].lanes;
  const int nsplit = (B + b_chunk - 1) / b_chunk;
  const long long items =
      static_cast<long long>(C) * ((hp + tile - 1) / tile) * nsplit;
  if (items > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{hist, coeff, yr, yi, P, B, C, Cs, hp, b_chunk, nsplit,
               static_cast<int>(items)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e =
      dispatch(variant, h_kind, c_kind, [&](auto kernel, int threads) {
        kernel<<<grid, threads, 0, s>>>(a);
        return cudaGetLastError();
      });
  return static_cast<int>(e);
}

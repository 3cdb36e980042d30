// Merge of two per-row sorted 2-limb key rows for Hopper (sm_90a).
//
// Replaces merge2_pallas (mhap_tpu/ops/merge_pallas.py:117, body
// _make_merge2_kernel :106): row t of a and row t of b, each sorted
// ascending by the unsigned key (limb0 << 32 | limb1) with pads
// (0xFFFFFFFF, 0xFFFFFFFF) in the suffix, become the first OW keys of
// their sorted union, equal keys a before b.  The TPU kernel ran a bitonic
// merge network of log2(pow2(2S)) compare-exchange stages on lane rolls
// in VMEM.  Outputs are whole keys with no payload, so any correct merge
// gives the same bits.
//
// What bounds it on the H100: bytes.  A row reads 4 S-wide limb arrays
// and writes 2 OW-wide ones once (48 KiB a row at S = 1,536, OW = 3,072:
// 0.060 ms for 4,096 rows at 3.35 TB/s); a merge path needs O(S) work a
// row plus one search a thread.
//
// Design: a persistent merge path in fixed-width output tiles.
//  - Each row's OW outputs are cut into tiles of W = 256 x kItems = 3,072
//    outputs.  Tile g's split point (i, j), i + j = g W, is one search on
//    its diagonal; the tile needs only a[i_g, i_g+1) and b[j_g, j_g+1), W
//    keys in all, so shared memory (96 KiB a block: two input stages, two
//    output stages) does not grow with S, and any S runs.
//  - A grid of the card's resident blocks (2 an SM) walks the (row, tile)
//    items, a contiguous run of items a block.  Warp 0 is the producer:
//    it finds the split points with a 32-way warp search in device
//    memory (a tile's start is the previous tile's end when the block
//    walks on along a row; at S = 1,536, OW = 2S a row is one tile and
//    needs none), waits for a free stage of the input ring and fills it
//    asynchronously, so tile k+1's loads fly while tile k merges.  Where
//    every row is 16-byte aligned (S and OW multiples of 4), one thread
//    copies the aligned supersets of the four slices with cp.async.bulk
//    onto the stage's mbarrier; otherwise the warp copies 4-byte words
//    with cp.async, whose completion the same mbarrier tracks.
//  - Warps 1-8 merge: thread k searches its diagonal k x kItems in the
//    tile's shared slices, merges kItems keys in registers (a key is one
//    u64 compare) and writes them into an output stage as the two limb
//    slices.  The stage goes out by cp.async.bulk shared -> global (or,
//    unaligned, by coalesced stores of all threads) while the next tile
//    merges; two output stages alternate.  No tensor cores: bytes are the
//    bound.
// The merging threads' shared loads (a search of ~11 steps and kItems
// steps of two pointers, scattered over the banks) are the SM's busiest
// pipe: 12 outputs a thread spread each thread's search over more outputs
// than 8 or 4 would, and a wide tile needs fewer device searches a row.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;
constexpr int kConsumers = 256;              // merging threads, warps 1-8
constexpr int kThreads = kConsumers + 32;    // and the producer warp
constexpr int kItems = 12;                   // outputs a merging thread
constexpr int kStages = 2;                   // input ring depth
constexpr int kTile = kConsumers * kItems;   // W, outputs a tile
// limb words a stage holds: a's and b's slices (W keys) widened to 16-byte
// bounds, at most 6 words each
constexpr int kCap = kTile + 16;
constexpr int kMaxDevices = 64;
static_assert(kItems % 4 == 0, "output stage writes are 16-byte vectors");

struct Meta {
  int row, d0, len;  // the tile: row, first output, outputs
  int a_off, la;     // a's slice in the stage's limb arrays
  int b_off, lb;     // b's slice
  int pad;
};

struct __align__(16) Smem {
  unsigned in[kStages][2][kCap];  // limb0, limb1 of a's then b's slice
  unsigned out[2][2][kTile];      // two output stages of limb0, limb1
  Meta meta[kStages];
  u64 full[kStages], empty[kStages];
};

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(u64* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(saddr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(u64* bar) {
  asm volatile(
      "{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, [%0];\n}" ::"r"(
          saddr(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(u64* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(saddr(bar)),
               "r"(bytes)
               : "memory");
}

// wait for the completion of the barrier's phase of this parity
__device__ __forceinline__ void mbar_wait(u64* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(saddr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// global -> shared, `bytes` a multiple of 16 at 16-byte aligned ends,
// completing on `bar`'s transaction count
__device__ __forceinline__ void bulk_load(unsigned* dst, const unsigned* src,
                                          uint32_t bytes, u64* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(saddr(dst)),
      "l"(src), "r"(bytes), "r"(saddr(bar))
      : "memory");
}

__device__ __forceinline__ void bulk_store(unsigned* dst, const unsigned* src,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(
          dst),
      "r"(saddr(src)), "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void word_load(unsigned* dst, const unsigned* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(saddr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ u64 key(const unsigned* l0, const unsigned* l1,
                                   size_t i) {
  return ((u64)l0[i] << 32) | l1[i];
}

// The merge path's split at diagonal d of rows a, b (S keys each): the
// number i of a's keys among the first d outputs, the least i in
// [max(0, d - S), min(d, S)] with a[i] > b[d - 1 - i] (a before b on
// equal keys), i = min(d, S) if none.  All 32 lanes probe evenly spaced
// i, so each round of device-memory latency cuts the interval 32-fold.
__device__ int warp_split(const unsigned* a0, const unsigned* a1,
                          const unsigned* b0, const unsigned* b1, int S,
                          int d) {
  const int lane = threadIdx.x & 31;
  int lo = max(0, d - S), hi = min(d, S);
  while (lo < hi) {
    const long long n = hi - lo;
    const int p = lo + (int)((lane * n) >> 5);
    const bool later = key(a0, a1, p) > key(b0, b1, d - 1 - p);
    const unsigned m = __ballot_sync(0xFFFFFFFFu, later);
    const int l = m ? __ffs(m) - 1 : 32;  // probes are nondecreasing
    if (l == 0) return lo;
    const int next = l < 32 ? lo + (int)((l * n) >> 5) : hi;
    lo = lo + (int)(((l - 1) * n) >> 5) + 1;
    hi = next;
  }
  return lo;
}

template <bool kBulk>
__device__ void produce(Smem& sm, const unsigned* __restrict__ a0,
                        const unsigned* __restrict__ a1,
                        const unsigned* __restrict__ b0,
                        const unsigned* __restrict__ b1, int S, int OW,
                        int ntiles, long long first, long long last) {
  const int lane = threadIdx.x;
  int prev_row = -1, prev_g = 0, carry = 0;
  for (long long item = first, n = 0; item < last; ++item, ++n) {
    const int row = (int)(item / ntiles), g = (int)(item % ntiles);
    const int d0 = g * kTile, d1 = min(d0 + kTile, OW);
    const size_t base = (size_t)row * S;
    const unsigned *ra0 = a0 + base, *ra1 = a1 + base;
    const unsigned *rb0 = b0 + base, *rb1 = b1 + base;
    const int i0 = row == prev_row && g == prev_g + 1
                       ? carry
                       : warp_split(ra0, ra1, rb0, rb1, S, d0);
    const int i1 = warp_split(ra0, ra1, rb0, rb1, S, d1);
    prev_row = row;
    prev_g = g;
    carry = i1;
    const int j0 = d0 - i0, j1 = d1 - i1, la = i1 - i0, lb = j1 - j0;
    const int s = (int)(n % kStages);
    if (n >= kStages) mbar_wait(&sm.empty[s], ((n / kStages) - 1) & 1);
    unsigned* l0 = sm.in[s][0];
    unsigned* l1 = sm.in[s][1];
    if (kBulk) {
      const int as = i0 & ~3, bs = j0 & ~3;
      const int na = la ? ((i1 + 3) & ~3) - as : 0;
      const int nb = lb ? ((j1 + 3) & ~3) - bs : 0;
      if (lane == 0) {
        sm.meta[s] = Meta{row, d0, d1 - d0, i0 - as, la, na + j0 - bs, lb, 0};
        mbar_arrive_expect_tx(&sm.full[s], (uint32_t)(na + nb) * 8u);
        if (na) {
          bulk_load(l0, ra0 + as, na * 4, &sm.full[s]);
          bulk_load(l1, ra1 + as, na * 4, &sm.full[s]);
        }
        if (nb) {
          bulk_load(l0 + na, rb0 + bs, nb * 4, &sm.full[s]);
          bulk_load(l1 + na, rb1 + bs, nb * 4, &sm.full[s]);
        }
      }
    } else {
      for (int e = lane; e < la; e += 32) {
        word_load(l0 + e, ra0 + i0 + e);
        word_load(l1 + e, ra1 + i0 + e);
      }
      for (int e = lane; e < lb; e += 32) {
        word_load(l0 + la + e, rb0 + j0 + e);
        word_load(l1 + la + e, rb1 + j0 + e);
      }
      // one arrival a lane when its copies land, one for the metadata
      asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::
                       "r"(saddr(&sm.full[s]))
                   : "memory");
      if (lane == 0) {
        sm.meta[s] = Meta{row, d0, d1 - d0, 0, la, la, lb, 0};
        mbar_arrive(&sm.full[s]);
      }
    }
  }
}

template <bool kBulk>
__device__ void consume(Smem& sm, int OW, long long first, long long last,
                        unsigned* __restrict__ o0,
                        unsigned* __restrict__ o1) {
  const int ctid = threadIdx.x - 32, lane = threadIdx.x & 31;
  const int k0 = ctid * kItems;
  for (long long item = first, n = 0; item < last; ++item, ++n) {
    const int s = (int)(n % kStages);
    mbar_wait(&sm.full[s], (n / kStages) & 1);
    const Meta m = sm.meta[s];
    const unsigned* a0 = sm.in[s][0] + m.a_off;
    const unsigned* a1 = sm.in[s][1] + m.a_off;
    const unsigned* b0 = sm.in[s][0] + m.b_off;
    const unsigned* b1 = sm.in[s][1] + m.b_off;
    u64 v[kItems];
    if (k0 < m.len) {
      int lo = max(0, k0 - m.lb), hi = min(k0, m.la);
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (key(a0, a1, mid) > key(b0, b1, k0 - 1 - mid)) hi = mid;
        else lo = mid + 1;
      }
      int ia = lo, ib = k0 - lo;
      u64 ka = ia < m.la ? key(a0, a1, ia) : ~0ull;
      u64 kb = ib < m.lb ? key(b0, b1, ib) : ~0ull;
#pragma unroll
      for (int t = 0; t < kItems; ++t) {
        const bool take_a = ib >= m.lb || (ia < m.la && ka <= kb);
        v[t] = take_a ? ka : kb;
        if (t + 1 < kItems) {
          if (take_a) {
            ++ia;
            ka = ia < m.la ? key(a0, a1, ia) : ~0ull;
          } else {
            ++ib;
            kb = ib < m.lb ? key(b0, b1, ib) : ~0ull;
          }
        }
      }
    } else {
#pragma unroll
      for (int t = 0; t < kItems; ++t) v[t] = ~0ull;
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.empty[s]);
    // output stage n % 2: its store of item n - 2 finished reading it
    // before item n - 1's barrier
    unsigned* q0 = sm.out[n & 1][0];
    unsigned* q1 = sm.out[n & 1][1];
#pragma unroll
    for (int t = 0; t < kItems; t += 4) {
      *reinterpret_cast<uint4*>(q0 + k0 + t) =
          make_uint4((unsigned)(v[t] >> 32), (unsigned)(v[t + 1] >> 32),
                     (unsigned)(v[t + 2] >> 32), (unsigned)(v[t + 3] >> 32));
      *reinterpret_cast<uint4*>(q1 + k0 + t) =
          make_uint4((unsigned)v[t], (unsigned)v[t + 1], (unsigned)v[t + 2],
                     (unsigned)v[t + 3]);
    }
    const size_t ob = (size_t)m.row * OW + m.d0;
    if (kBulk) {
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      if (ctid == 0)
        asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
      asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
      if (ctid == 0) {
        bulk_store(o0 + ob, q0, (uint32_t)m.len * 4u);
        bulk_store(o1 + ob, q1, (uint32_t)m.len * 4u);
        asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      }
    } else {
      asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
      for (int e = ctid; e < m.len; e += kConsumers) {
        o0[ob + e] = q0[e];
        o1[ob + e] = q1[e];
      }
    }
  }
  if (kBulk && ctid == 0)
    asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

template <bool kBulk>
__global__ void __launch_bounds__(kThreads)
    merge2_kernel(const unsigned* __restrict__ a0,
                  const unsigned* __restrict__ a1,
                  const unsigned* __restrict__ b0,
                  const unsigned* __restrict__ b1, int S, int OW, int ntiles,
                  long long items, unsigned* __restrict__ o0,
                  unsigned* __restrict__ o1) {
  extern __shared__ __align__(128) unsigned char raw[];
  Smem& sm = *reinterpret_cast<Smem*>(raw);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      // bulk: the producer's expect_tx; else 32 lanes' cp.async arrivals
      // and the metadata's
      mbar_init(&sm.full[s], kBulk ? 1 : 33);
      mbar_init(&sm.empty[s], kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const long long first = items * blockIdx.x / gridDim.x;
  const long long last = items * (blockIdx.x + 1) / gridDim.x;
  if (threadIdx.x < 32)
    produce<kBulk>(sm, a0, a1, b0, b1, S, OW, ntiles, first, last);
  else
    consume<kBulk>(sm, OW, first, last, o0, o1);
}

// Resident blocks per SM of the kernel (after allowing its dynamic shared
// memory), and the card's SM count.
template <bool kBulk>
cudaError_t residency(int* per_sm, int* sms) {
  static int cached[kMaxDevices][2];
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < kMaxDevices && cached[dev][0]) {
    *per_sm = cached[dev][0];
    *sms = cached[dev][1];
    return cudaSuccess;
  }
  e = cudaFuncSetAttribute(merge2_kernel<kBulk>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)sizeof(Smem));
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, merge2_kernel<kBulk>, kThreads, sizeof(Smem));
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess && *per_sm < 1) e = cudaErrorInvalidConfiguration;
  if (e == cudaSuccess && dev < kMaxDevices) {
    cached[dev][0] = *per_sm;
    cached[dev][1] = *sms;
  }
  return e;
}

template <bool kBulk>
cudaError_t launch(const unsigned* a0, const unsigned* a1, const unsigned* b0,
                   const unsigned* b1, int T, int S, int OW, unsigned* o0,
                   unsigned* o1, cudaStream_t stream) {
  int per_sm, sms;
  cudaError_t e = residency<kBulk>(&per_sm, &sms);
  if (e != cudaSuccess) return e;
  const int ntiles = (OW + kTile - 1) / kTile;
  const long long items = (long long)T * ntiles;
  const long long grid = items < (long long)per_sm * sms
                             ? items : (long long)per_sm * sms;
  merge2_kernel<kBulk><<<(int)grid, kThreads, sizeof(Smem), stream>>>(
      a0, a1, b0, b1, S, OW, ntiles, items, o0, o1);
  return cudaGetLastError();
}

bool bulk_path(int S, int OW) { return S % 4 == 0 && OW % 4 == 0; }

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

extern "C" {

// a0, a1, b0, b1: [T, S] uint32 limbs; o0, o1: [T, OW] uint32, OW <= 2S.
int mhap_merge2(const void* a0, const void* a1, const void* b0,
                const void* b1, int T, int S, int OW, void* o0, void* o1,
                void* stream) {
  if (T <= 0 || OW <= 0) return (int)cudaSuccess;
  if (S < 1 || OW > 2 * S) return (int)cudaErrorInvalidValue;
  const bool bulk = bulk_path(S, OW) && aligned16(a0) && aligned16(a1) &&
                    aligned16(b0) && aligned16(b1) && aligned16(o0) &&
                    aligned16(o1);
  auto* c0 = (const unsigned*)a0;
  auto* c1 = (const unsigned*)a1;
  auto* c2 = (const unsigned*)b0;
  auto* c3 = (const unsigned*)b1;
  const cudaStream_t st = (cudaStream_t)stream;
  return (int)(bulk ? launch<true>(c0, c1, c2, c3, T, S, OW, (unsigned*)o0,
                                   (unsigned*)o1, st)
                    : launch<false>(c0, c1, c2, c3, T, S, OW, (unsigned*)o0,
                                    (unsigned*)o1, st));
}

// The resources of the kernel that merges [T, S] rows into OW outputs
// (16-byte aligned tensors): info = {registers a thread, static shared
// bytes, dynamic shared bytes, local (spill) bytes a thread, resident
// blocks per SM, 1 if the cp.async.bulk path else 0 (cp.async), outputs
// a tile, input stages}.
int mhap_merge2_occupancy(int S, int OW, int* info) {
  if (S < 1 || OW < 0 || OW > 2 * S) return (int)cudaErrorInvalidValue;
  const bool bulk = bulk_path(S, OW);
  int per_sm = 0, sms = 0;
  cudaFuncAttributes a;
  cudaError_t e = bulk ? residency<true>(&per_sm, &sms)
                       : residency<false>(&per_sm, &sms);
  if (e == cudaSuccess)
    e = bulk ? cudaFuncGetAttributes(&a, merge2_kernel<true>)
             : cudaFuncGetAttributes(&a, merge2_kernel<false>);
  if (e != cudaSuccess) return (int)e;
  info[0] = a.numRegs;
  info[1] = (int)a.sharedSizeBytes;
  info[2] = (int)sizeof(Smem);
  info[3] = (int)a.localSizeBytes;
  info[4] = per_sm;
  info[5] = bulk ? 1 : 0;
  info[6] = kTile;
  info[7] = kStages;
  return (int)cudaSuccess;
}

}  // extern "C"

// Weighted-MinHash min-reduce for Hopper (sm_90a).
//
// Replaces the two Pallas kernels of mhap_tpu/ops/minhash_pallas.py:
//   min_reduce_w1_pallas        (:156, body _make_w1_kernel :104)
//   weighted_min_reduce_pallas  (:193, body _make_kernel :38)
// Reference loop: sketch/MinHashSketch.java:134-153.  For each of H slots,
// every active k-mer steps its xorshift64 stream `w` times (w = 1 for the
// first kernel); its window minimum, compared as a signed 64-bit value,
// competes lexicographically on (value, tiebreak).  The slot stores the
// low half of the winner's hash on even slots, the high half on odd ones.
//
// What bounds it on the H100: INT32 operations, H * sum(w) stream steps
// of ~16 32-bit operations each (three 64-bit shifts and xors, a signed
// 64-bit compare and select), plus one arg-min reduction per slot.  Input
// bytes (8-17 B per k-mer, read once) are negligible against that.
//
// Kernel 1 (min_reduce_kernel): one block per row.  The k-mer axis is
// cut into tiles of kThreads * kItems k-mers whose stream states stay in
// registers for the whole slot loop, so rows of any width run with no
// state in memory: a tile walks all H slots, and a running best per slot
// in shared memory carries the result across tiles (the TPU kernel held
// the whole row in VMEM instead).  Per slot, a warp-shuffle butterfly
// reduces (value, tiebreak, index); the warps' results for a group of 32
// slots meet in shared memory and one warp folds them into the running
// best, so the block synchronises twice per 32 slots, not per slot.
//
// Kernel 2 spreads the work over the card by stream steps, not by rows,
// in three passes (the wrapper in ops/minhash_kernels.py plans them):
//  1. light pass (min_reduce_light_kernel), grid (row, segment): the
//     active k-mers with w < heavy_min of one segment of the row, in
//     kernel 1's register tiles.  Few or long rows become many blocks
//     (a tile per segment, or less where the rows still leave SMs idle),
//     and a tile with no light k-mer is skipped by the whole block
//     (__syncthreads_or), so short rows padded to the longest cost a
//     scan.  Each warp keeps its own running
//     best per slot in shared memory, written only by the lane that owns
//     the slot, so the slot loop has no block barrier; the warps' bests
//     meet once at the end, as a partial arg-min per (row, segment, slot).
//  2. heavy pass (min_reduce_heavy_kernel), one thread per (heavy k-mer,
//     slot range): a k-mer with w >= heavy_min would step H * w times in a
//     row on one thread while its block waited.  The xorshift step is
//     linear over GF(2), so the state after j steps is M^j x; with the
//     table of M^(2^i) (48 x 64 columns, 24 KB, in shared memory: lanes
//     read different entries, which constant memory would serialise) a
//     thread jumps to its first slot s0 in popcount(w * s0) matrix-vector
//     products and steps w times for each slot of its range, which the
//     plan sizes at about 1,024 steps, the cost of a jump.
//  3. fold pass (min_reduce_fold_kernel), one thread per (row, slot): the
//     lexicographic minimum of the row's segment partials and its heavy
//     k-mers' values.  The minimum is associative, so the cuts are exact.
// Large H: kernel 1 keeps H * 16 bytes of running bests a block and the
// light pass kWarps * H * 16, in shared memory while that fits the card's
// opt-in limit a block (cudaDevAttrMaxSharedMemoryPerBlockOptin, less the
// static part): on the H100 H <= 14,272 and H <= 1,816.  Above it the same
// bests live in a device-memory workspace that the wrapper allocates, one
// slice a block, and a grid of the card's resident blocks (or fewer) loops
// over the rows (kernel 1) or the (row, segment) blocks (light pass); each
// lane reads and writes only the bests of its own slot, once per 32-slot
// group, so the traffic stays small beside the stream steps.  The heavy
// pass (its 24 KB jump table) and the fold pass hold nothing per slot and
// take any H.
// Traps: the window minimum is compared as a signed 64-bit value (Java's
// long); the stream shifts right logically (Java's >>>); the slot's parity
// picks the half; ties on value go to the smaller tiebreak across the
// partials and heavy values too (tiebreaks are distinct within a row, as
// the callers give them: first-occurrence positions).

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 16;  // k-mers per thread per tile
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 32;  // slots per shared-memory combine
constexpr int kJumpBits = 48;  // rows of the jump table
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ unsigned long long xorshift(unsigned long long x) {
  x ^= x << 21;
  x ^= x >> 35;  // logical: Java's >>>
  x ^= x << 4;
  return x;
}

__device__ __forceinline__ bool lex_less(long long v1, int t1, long long v2,
                                         int t2) {
  return v1 < v2 || (v1 == v2 && t1 < t2);
}

// Lexicographic (value, tiebreak) arg-min across the warp; every lane
// ends with the result.
__device__ __forceinline__ void warp_argmin(long long& bv, int& btb,
                                            int& bidx) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const long long ov = __shfl_xor_sync(kFull, bv, off);
    const int otb = __shfl_xor_sync(kFull, btb, off);
    const int oidx = __shfl_xor_sync(kFull, bidx, off);
    if (lex_less(ov, otb, bv, btb)) {
      bv = ov;
      btb = otb;
      bidx = oidx;
    }
  }
}

// Kernel 1: out [B, H] sketch halves.  kShared: grid B, the running bests
// in shared memory; else a grid of resident blocks looping over the rows,
// block b's bests at ws + b * H * 16.
template <bool kShared>
__global__ void __launch_bounds__(kThreads)
    min_reduce_kernel(const long long* __restrict__ h,
                      const unsigned char* __restrict__ active, int B, int n,
                      int H, unsigned char* __restrict__ ws,
                      int* __restrict__ out) {
  extern __shared__ long long smem_v[];
  long long* best_v =                       // [H] running best value
      kShared ? smem_v : (long long*)(ws + (size_t)blockIdx.x * H * 16);
  int* best_tb = (int*)(best_v + H);        // [H] its tiebreak
  int* best_idx = best_tb + H;              // [H] its k-mer index, -1 none
  __shared__ long long red_v[kWarps][kGroup];
  __shared__ int red_tb[kWarps][kGroup];
  __shared__ int red_idx[kWarps][kGroup];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (size_t row = blockIdx.x; row < (size_t)B; row += gridDim.x) {
    const long long* hr = h + row * n;
    const unsigned char* ar = active + row * n;

    for (int s = tid; s < H; s += kThreads) {
      best_v[s] = LLONG_MAX;
      best_tb[s] = INT_MAX;
      best_idx[s] = -1;
    }
    __syncthreads();

    for (int base = 0; base < n; base += kThreads * kItems) {
      unsigned long long x[kItems];
      int w[kItems], tb[kItems];
  #pragma unroll
      for (int i = 0; i < kItems; ++i) {
        const int k = base + i * kThreads + tid;
        const bool on = k < n && ar[k];
        x[i] = on ? (unsigned long long)hr[k] : 0ull;
        w[i] = on ? 1 : 0;
        tb[i] = on ? k : INT_MAX;
      }
      for (int g = 0; g < H; g += kGroup) {
        const int gn = min(kGroup, H - g);
        for (int j = 0; j < gn; ++j) {
          long long bv = LLONG_MAX;
          int btb = INT_MAX, bidx = -1;
  #pragma unroll
          for (int i = 0; i < kItems; ++i) {
            if (w[i] <= 0) continue;
            x[i] = xorshift(x[i]);
            const long long wm = (long long)x[i];
            if (lex_less(wm, tb[i], bv, btb)) {
              bv = wm;
              btb = tb[i];
              bidx = base + i * kThreads + tid;
            }
          }
          warp_argmin(bv, btb, bidx);
          if (lane == 0) {
            red_v[warp][j] = bv;
            red_tb[warp][j] = btb;
            red_idx[warp][j] = bidx;
          }
        }
        __syncthreads();
        if (warp == 0 && lane < gn) {
          const int s = g + lane;
          long long bv = best_v[s];
          int btb = best_tb[s], bidx = best_idx[s];
          for (int q = 0; q < kWarps; ++q) {
            if (lex_less(red_v[q][lane], red_tb[q][lane], bv, btb)) {
              bv = red_v[q][lane];
              btb = red_tb[q][lane];
              bidx = red_idx[q][lane];
            }
          }
          best_v[s] = bv;
          best_tb[s] = btb;
          best_idx[s] = bidx;
        }
        __syncthreads();
      }
    }

    for (int s = tid; s < H; s += kThreads) {
      const int idx = best_idx[s];
      const unsigned long long key =
          idx >= 0 ? (unsigned long long)hr[idx] : 0ull;
      out[row * H + s] = (int)(unsigned)((s & 1) ? (key >> 32) : key);
    }
    __syncthreads();  // this row's reads precede the next row's writes
  }
}

// Kernel 2, light pass: block (row, g) takes the active k-mers of
// [g * seg, (g + 1) * seg) with w < heavy_min and writes its per-slot
// arg-min to part_* [B, nseg, H].  Each warp keeps its own running best
// per slot ([kWarps][H], 16 bytes each), updated by the lane that owns
// the slot within its 32-slot group, so the slot loop has no block
// barrier; the warps' bests meet once, at the end.  kShared: grid (B,
// nseg), the bests in shared memory; else a grid of resident blocks
// looping over the B * nseg (row, g), block b's bests at
// ws + b * kWarps * H * 16.
template <bool kShared>
__global__ void __launch_bounds__(kThreads)
    min_reduce_light_kernel(const long long* __restrict__ h,
                            const int* __restrict__ weight,
                            const int* __restrict__ tiebreak,
                            const unsigned char* __restrict__ active, int B,
                            int n, int H, int heavy_min, int seg, int nseg,
                            unsigned char* __restrict__ ws,
                            long long* __restrict__ part_v,
                            int* __restrict__ part_tb,
                            int* __restrict__ part_idx) {
  extern __shared__ long long smem_v[];
  long long* wbest_v =                            // [kWarps][H]
      kShared ? smem_v
              : (long long*)(ws + (size_t)blockIdx.x * kWarps * H * 16);
  int* wbest_tb = (int*)(wbest_v + kWarps * H);   // [kWarps][H]
  int* wbest_idx = wbest_tb + kWarps * H;         // [kWarps][H]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t nvb = kShared ? 1 : (size_t)B * nseg;
  for (size_t vb = kShared ? 0 : blockIdx.x; vb < nvb;
       vb += kShared ? 1 : gridDim.x) {
    const size_t row = kShared ? blockIdx.x : vb / nseg;
    const int g = kShared ? (int)blockIdx.y : (int)(vb % nseg);
    const size_t off = row * n;
    const int lo = g * seg, hi = min(n, lo + seg);
    long long* my_v = wbest_v + warp * H;
    int* my_tb = wbest_tb + warp * H;
    int* my_idx = wbest_idx + warp * H;
    for (int s = lane; s < H; s += 32) {
      my_v[s] = LLONG_MAX;
      my_tb[s] = INT_MAX;
      my_idx[s] = -1;
    }
    __syncwarp();

    for (int base = lo; base < hi; base += kThreads * kItems) {
      unsigned long long x[kItems];
      int w[kItems], tb[kItems];
      bool any = false;
  #pragma unroll
      for (int i = 0; i < kItems; ++i) {
        const int k = base + i * kThreads + tid;
        const bool on =
            k < hi && active[off + k] && weight[off + k] < heavy_min;
        x[i] = on ? (unsigned long long)h[off + k] : 0ull;
        w[i] = on ? weight[off + k] : 0;
        tb[i] = on ? tiebreak[off + k] : INT_MAX;
        any |= on;
      }
      // uniform across the block: a tile with no light k-mer is skipped
      if (!__syncthreads_or(any)) continue;
      for (int g = 0; g < H; g += kGroup) {
        const int own = g + lane;  // the slot this lane keeps in the group
        long long run_v = LLONG_MAX;
        int run_tb = INT_MAX, run_idx = -1;
        if (own < H) {
          run_v = my_v[own];
          run_tb = my_tb[own];
          run_idx = my_idx[own];
        }
        const int gn = min(kGroup, H - g);
        for (int j = 0; j < gn; ++j) {
          long long bv = LLONG_MAX;
          int btb = INT_MAX, bidx = -1;
  #pragma unroll
          for (int i = 0; i < kItems; ++i) {
            if (w[i] <= 0) continue;
            long long wm = LLONG_MAX;
            for (int t = 0; t < w[i]; ++t) {
              x[i] = xorshift(x[i]);
              const long long v = (long long)x[i];
              wm = v < wm ? v : wm;
            }
            if (lex_less(wm, tb[i], bv, btb)) {
              bv = wm;
              btb = tb[i];
              bidx = base + i * kThreads + tid;
            }
          }
          warp_argmin(bv, btb, bidx);
          if (lane == j && lex_less(bv, btb, run_v, run_tb)) {
            run_v = bv;
            run_tb = btb;
            run_idx = bidx;
          }
        }
        if (own < H) {
          my_v[own] = run_v;
          my_tb[own] = run_tb;
          my_idx[own] = run_idx;
        }
      }
    }
    __syncthreads();

    const size_t p = (row * nseg + g) * H;
    for (int s = tid; s < H; s += kThreads) {
      long long bv = LLONG_MAX;
      int btb = INT_MAX, bidx = -1;
      for (int q = 0; q < kWarps; ++q) {
        const int a = q * H + s;
        if (lex_less(wbest_v[a], wbest_tb[a], bv, btb)) {
          bv = wbest_v[a];
          btb = wbest_tb[a];
          bidx = wbest_idx[a];
        }
      }
      part_v[p + s] = bv;
      part_tb[p + s] = btb;
      part_idx[p + s] = bidx;
    }
    __syncthreads();  // the warps' bests are read before the next reset
  }
}

// y = M x over GF(2), M given by its 64 columns
__device__ __forceinline__ unsigned long long gf2_apply(
    const unsigned long long* cols, unsigned long long x) {
  unsigned long long y = 0;
#pragma unroll 16
  for (int b = 0; b < 64; ++b) y ^= cols[b] & (0ull - ((x >> b) & 1ull));
  return y;
}

// Kernel 2, heavy pass: thread (e, q), e < n_heavy, q < H, takes heavy
// k-mer heavy_flat[e] (an index into the [B, n] inputs) over slots
// [q * r, min(H, (q + 1) * r)) with r = clamp(ceil(jump_steps / w), 1, H),
// or nothing when q * r >= H; writes each slot's window minimum to
// heavy_v[e, slot].
__global__ void __launch_bounds__(kThreads)
    min_reduce_heavy_kernel(const long long* __restrict__ h,
                            const int* __restrict__ weight,
                            const long long* __restrict__ heavy_flat,
                            int n_heavy, int H, int jump_steps,
                            const unsigned long long* __restrict__ table,
                            long long* __restrict__ heavy_v) {
  __shared__ unsigned long long tab[kJumpBits * 64];
  const size_t t = (size_t)blockIdx.x * kThreads + threadIdx.x;
  const size_t e = t / H;
  const long long q = (long long)(t % H);
  long long w = 0, r = 1;
  bool on = e < (size_t)n_heavy;
  if (on) {
    w = weight[heavy_flat[e]];
    r = min((long long)H, max(1ll, (jump_steps + w - 1) / w));
    on = q * r < H;
  }
  if (!__syncthreads_or(on)) return;
  for (int i = threadIdx.x; i < kJumpBits * 64; i += kThreads)
    tab[i] = table[i];
  __syncthreads();
  if (!on) return;
  const int s0 = (int)(q * r), s1 = (int)min((long long)H, q * r + r);
  unsigned long long x = (unsigned long long)h[heavy_flat[e]];
  // slot s consumes steps s * w + 1 .. (s + 1) * w of the stream
  unsigned long long j = (unsigned long long)(w * s0);
  for (int i = 0; j; ++i, j >>= 1)
    if (j & 1) x = gf2_apply(tab + i * 64, x);
  long long* hv = heavy_v + e * H;
  for (int s = s0; s < s1; ++s) {
    long long wm = LLONG_MAX;
    for (long long u = 0; u < w; ++u) {
      x = xorshift(x);
      const long long v = (long long)x;
      wm = v < wm ? v : wm;
    }
    hv[s] = wm;
  }
}

__device__ __forceinline__ int lower_bound(const long long* a, int len,
                                           long long key) {
  int lo = 0, hi = len;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < key)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// Kernel 2, fold pass: thread (row, slot) takes the lexicographic minimum
// of the row's nseg partials and of its heavy k-mers (the entries of the
// sorted heavy_flat in [row * n, (row + 1) * n)), and writes the winner's
// half (0: no winner) to out, or, with out null (a slab of the heavy
// k-mers that is not the last), the minimum back to the row's partial 0.
__global__ void __launch_bounds__(kThreads)
    min_reduce_fold_kernel(const long long* __restrict__ h,
                           const int* __restrict__ tiebreak,
                           long long* __restrict__ part_v,
                           int* __restrict__ part_tb,
                           int* __restrict__ part_idx, int nseg,
                           const long long* __restrict__ heavy_flat,
                           int n_heavy,
                           const long long* __restrict__ heavy_v, int B,
                           int n, int H, int* __restrict__ out) {
  const size_t t = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (t >= (size_t)B * H) return;
  const size_t row = t / H;
  const int s = (int)(t % H);
  long long bv = LLONG_MAX, bidx = -1;
  int btb = INT_MAX;
  for (int g = 0; g < nseg; ++g) {
    const size_t p = (row * nseg + g) * H + s;
    if (lex_less(part_v[p], part_tb[p], bv, btb)) {
      bv = part_v[p];
      btb = part_tb[p];
      bidx = part_idx[p];
    }
  }
  const long long row0 = (long long)row * n;
  const int e1 = lower_bound(heavy_flat, n_heavy, row0 + n);
  for (int e = lower_bound(heavy_flat, n_heavy, row0); e < e1; ++e) {
    const long long v = heavy_v[(size_t)e * H + s];
    const int tb = tiebreak[heavy_flat[e]];
    if (lex_less(v, tb, bv, btb)) {
      bv = v;
      btb = tb;
      bidx = heavy_flat[e] - row0;
    }
  }
  if (out == nullptr) {
    const size_t p = row * nseg * H + s;
    part_v[p] = bv;
    part_tb[p] = btb;
    part_idx[p] = (int)bidx;
    return;
  }
  const unsigned long long key =
      bidx >= 0 ? (unsigned long long)h[row0 + bidx] : 0ull;
  out[t] = (int)(unsigned)((s & 1) ? (key >> 32) : key);
}

// Dynamic shared memory above the 48 KB default needs an opt-in.
template <typename K>
cudaError_t allow_smem(K kern, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// The running bests a block keeps: H * 16 bytes (kernel 1, which = 1) or
// kWarps * H * 16 (the light pass, which = 2).
size_t best_bytes(int which, int H) {
  return (size_t)(which == 1 ? 1 : kWarps) * H *
         (sizeof(long long) + 2 * sizeof(int));
}

// Do the bests fit the card's opt-in shared memory a block, less the
// kernel's static part?
template <typename K>
cudaError_t fits_shared(K kern, size_t bytes, bool* fits) {
  *fits = false;
  int dev, optin;
  cudaFuncAttributes a;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&a, kern);
  if (e == cudaSuccess) *fits = bytes + a.sharedSizeBytes <= (size_t)optin;
  return e;
}

// info = {0 shared memory or 1 device memory, the bests' bytes a block,
// resident blocks on the card of the kernel that runs}.
template <typename KS, typename KD>
int plan_of(KS shared_kern, KD device_kern, size_t bytes, long long* info) {
  bool fits;
  cudaError_t e = fits_shared(shared_kern, bytes, &fits);
  int dev, sms = 0, blocks = 0;
  if (e == cudaSuccess && fits) e = allow_smem(shared_kern, bytes);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = fits ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                   &blocks, shared_kern, kThreads, bytes)
             : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                   &blocks, device_kern, kThreads, 0);
  info[0] = fits ? 0 : 1;
  info[1] = (long long)bytes;
  info[2] = (long long)blocks * sms;
  return (int)e;
}

}  // namespace

extern "C" {

// Where the running bests of kernel 1 (which = 1) or of the light pass
// (which = 2) live at H slots: see plan_of.
int mhap_min_reduce_plan(int which, int H, long long* info) {
  if (H <= 0 || (which != 1 && which != 2)) return (int)cudaErrorInvalidValue;
  const size_t bytes = best_bytes(which, H);
  return which == 1 ? plan_of(min_reduce_kernel<true>,
                              min_reduce_kernel<false>, bytes, info)
                    : plan_of(min_reduce_light_kernel<true>,
                              min_reduce_light_kernel<false>, bytes, info);
}

// Kernel 1. h: [B, n] int64 hashes; active: [B, n] uint8; out: [B, H]
// int32.  ws null: the bests in shared memory (they must fit); else
// `grid` blocks with ws holding grid * H * 16 bytes.
int mhap_min_reduce(const void* h, const void* active, int B, int n, int H,
                    void* ws, int grid, void* out, void* stream) {
  if (B <= 0 || H <= 0) return (int)cudaSuccess;
  const size_t bytes = best_bytes(1, H);
  if (ws == nullptr) {
    bool fits;
    cudaError_t e = fits_shared(min_reduce_kernel<true>, bytes, &fits);
    if (e == cudaSuccess && !fits) e = cudaErrorInvalidValue;
    if (e == cudaSuccess) e = allow_smem(min_reduce_kernel<true>, bytes);
    if (e != cudaSuccess) return (int)e;
    min_reduce_kernel<true><<<B, kThreads, bytes, (cudaStream_t)stream>>>(
        (const long long*)h, (const unsigned char*)active, B, n, H, nullptr,
        (int*)out);
  } else {
    if (grid < 1) return (int)cudaErrorInvalidValue;
    min_reduce_kernel<false><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const long long*)h, (const unsigned char*)active, B, n, H,
        (unsigned char*)ws, (int*)out);
  }
  return (int)cudaGetLastError();
}

// Kernel 2, launched as two calls so that the host can find the heavy
// k-mers while the light pass runs.  h: [B, n] int64; weight, tiebreak:
// [B, n] int32; active: [B, n] uint8 (or bool); k-mers with w >=
// heavy_min are heavy.  part_v [B, nseg, H] int64, part_tb and part_idx
// [B, nseg, H] int32: the light pass's partials over nseg segments of
// seg k-mers a row.  ws null: the bests in shared memory (they must
// fit); else `grid` blocks with ws holding grid * kWarps * H * 16 bytes.
int mhap_weighted_light(const void* h, const void* weight,
                        const void* tiebreak, const void* active, int B,
                        int n, int H, int heavy_min, int seg, int nseg,
                        void* ws, int grid, void* part_v, void* part_tb,
                        void* part_idx, void* stream) {
  if (B <= 0 || H <= 0) return (int)cudaSuccess;
  const size_t bytes = best_bytes(2, H);
  if (ws == nullptr) {
    bool fits;
    cudaError_t e = fits_shared(min_reduce_light_kernel<true>, bytes, &fits);
    if (e == cudaSuccess && !fits) e = cudaErrorInvalidValue;
    if (e == cudaSuccess) e = allow_smem(min_reduce_light_kernel<true>, bytes);
    if (e != cudaSuccess) return (int)e;
    min_reduce_light_kernel<true><<<dim3(B, nseg), kThreads, bytes,
                                    (cudaStream_t)stream>>>(
        (const long long*)h, (const int*)weight, (const int*)tiebreak,
        (const unsigned char*)active, B, n, H, heavy_min, seg, nseg, nullptr,
        (long long*)part_v, (int*)part_tb, (int*)part_idx);
  } else {
    if (grid < 1) return (int)cudaErrorInvalidValue;
    min_reduce_light_kernel<false><<<grid, kThreads, 0,
                                     (cudaStream_t)stream>>>(
        (const long long*)h, (const int*)weight, (const int*)tiebreak,
        (const unsigned char*)active, B, n, H, heavy_min, seg, nseg,
        (unsigned char*)ws, (long long*)part_v, (int*)part_tb,
        (int*)part_idx);
  }
  return (int)cudaGetLastError();
}

// heavy_flat [n_heavy] int64: row * n + column of the heavy k-mers,
// ascending; table [48, 64] uint64 (xorshift_jump_table); heavy_v
// [n_heavy, H] int64 scratch; out [B, H] int32, or null to fold this slab
// of the heavy k-mers into the partials for a later call.
int mhap_weighted_heavy_fold(const void* h, const void* weight,
                             const void* tiebreak, int B, int n, int H,
                             int nseg, const void* heavy_flat, int n_heavy,
                             int jump_steps, const void* table, void* part_v,
                             void* part_tb, void* part_idx, void* heavy_v,
                             void* out, void* stream) {
  if (B <= 0 || H <= 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  if (n_heavy > 0) {
    const size_t threads = (size_t)n_heavy * H;
    min_reduce_heavy_kernel<<<(unsigned)((threads + kThreads - 1) / kThreads),
                              kThreads, 0, st>>>(
        (const long long*)h, (const int*)weight,
        (const long long*)heavy_flat, n_heavy, H, jump_steps,
        (const unsigned long long*)table, (long long*)heavy_v);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const size_t cells = (size_t)B * H;
  min_reduce_fold_kernel<<<(unsigned)((cells + kThreads - 1) / kThreads),
                           kThreads, 0, st>>>(
      (const long long*)h, (const int*)tiebreak, (long long*)part_v,
      (int*)part_tb, (int*)part_idx, nseg,
      (const long long*)heavy_flat, n_heavy, (const long long*)heavy_v, B, n,
      H, (int*)out);
  return (int)cudaGetLastError();
}

const char* mhap_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"

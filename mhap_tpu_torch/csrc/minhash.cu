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
// What bounds it on the H100: integer ALU work, H * sum(w) stream steps
// of ~10 instructions per k-mer per row (a 2.9 kb read at H = 512 is
// ~1.5M steps), plus one arg-min reduction per slot.  Input bytes
// (8-16 B per k-mer, read once) are negligible against that.
//
// Design: one block per row.  The k-mer axis is cut into tiles of
// kThreads * kItems k-mers whose stream states stay in registers for the
// whole slot loop, so rows of any width run with no state in memory: a
// tile walks all H slots, and a running best per slot in shared memory
// carries the result across tiles (the TPU kernel held the whole row in
// VMEM instead).  Per slot, a warp-shuffle butterfly reduces
// (value, tiebreak, index); the warps' results for a group of 32 slots
// meet in shared memory and one warp folds them into the running best, so
// the block synchronises twice per 32 slots, not per slot.  The weighted
// kernel loops `w` steps per k-mer at run time: any weight, any width.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 16;  // k-mers per thread per tile
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 32;  // slots per shared-memory combine
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

template <bool WEIGHTED>
__global__ void __launch_bounds__(kThreads)
    min_reduce_kernel(const long long* __restrict__ h,
                      const int* __restrict__ weight,
                      const int* __restrict__ tiebreak,
                      const unsigned char* __restrict__ active, int n, int H,
                      int* __restrict__ out) {
  extern __shared__ long long best_v[];     // [H] running best value
  int* best_tb = (int*)(best_v + H);        // [H] its tiebreak
  int* best_idx = best_tb + H;              // [H] its k-mer index, -1 none
  __shared__ long long red_v[kWarps][kGroup];
  __shared__ int red_tb[kWarps][kGroup];
  __shared__ int red_idx[kWarps][kGroup];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t row = blockIdx.x;
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
      if (WEIGHTED) {
        w[i] = on ? weight[row * n + k] : 0;
        tb[i] = on ? tiebreak[row * n + k] : INT_MAX;
      } else {
        w[i] = on ? 1 : 0;
        tb[i] = on ? k : INT_MAX;
      }
    }
    for (int g = 0; g < H; g += kGroup) {
      const int gn = min(kGroup, H - g);
      for (int j = 0; j < gn; ++j) {
        long long bv = LLONG_MAX;
        int btb = INT_MAX, bidx = -1;
#pragma unroll
        for (int i = 0; i < kItems; ++i) {
          if (w[i] <= 0) continue;
          long long wm;
          if (WEIGHTED) {
            wm = LLONG_MAX;
            for (int t = 0; t < w[i]; ++t) {
              x[i] = xorshift(x[i]);
              const long long v = (long long)x[i];
              wm = v < wm ? v : wm;
            }
          } else {
            x[i] = xorshift(x[i]);
            wm = (long long)x[i];
          }
          if (lex_less(wm, tb[i], bv, btb)) {
            bv = wm;
            btb = tb[i];
            bidx = base + i * kThreads + tid;
          }
        }
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
}

template <bool WEIGHTED>
cudaError_t launch(const void* h, const void* w, const void* tb,
                   const void* act, int B, int n, int H, void* out,
                   cudaStream_t stream) {
  const size_t smem = (size_t)H * (sizeof(long long) + 2 * sizeof(int));
  auto kern = min_reduce_kernel<WEIGHTED>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<B, kThreads, smem, stream>>>(
      (const long long*)h, (const int*)w, (const int*)tb,
      (const unsigned char*)act, n, H, (int*)out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// h: [B, n] int64 hashes; weight, tiebreak: [B, n] int32 (ignored and may
// be null when weighted == 0); active: [B, n] uint8; out: [B, H] int32.
int mhap_min_reduce(const void* h, const void* weight, const void* tiebreak,
                    const void* active, int B, int n, int H, int weighted,
                    void* out, void* stream) {
  if (B <= 0 || H <= 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e =
      weighted ? launch<true>(h, weight, tiebreak, active, B, n, H, out, st)
               : launch<false>(h, weight, tiebreak, active, B, n, H, out, st);
  return (int)e;
}

const char* mhap_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"

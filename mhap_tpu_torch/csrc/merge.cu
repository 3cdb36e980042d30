// Merge of two per-row sorted 2-limb key rows for Hopper (sm_90a).
//
// Replaces merge2_pallas (mhap_tpu/ops/merge_pallas.py:117, body
// _make_merge2_kernel :106): row t of a and row t of b, each sorted
// ascending by the unsigned key (limb0 << 32 | limb1) with pads
// (0xFFFFFFFF, 0xFFFFFFFF) in the suffix, become the first OW keys of
// their sorted union.  The TPU kernel ran a bitonic merge network of
// log2(pow2(2S)) compare-exchange stages on lane rolls in VMEM.
//
// What bounds it on the H100: bytes.  A row reads 4 S-wide limb arrays
// and writes 2 OW-wide ones once (48 KiB a row at S = 1,536, OW = 3,072);
// the work per key is one binary search of about log2(S) steps in shared
// memory.
//
// Design (merge by ranking): one block per row.  The block packs a and b
// as 64-bit keys into shared memory, a then b (2 S x 8 B, 24 KiB at
// S = 1,536).  Each key then finds its place in the merged row by binary
// search in the other input: a[j] goes to j + #(b < a[j]) and b[k] to
// k + #(a <= b[k]), so equal keys keep a before b and the places are a
// permutation of [0, 2S).  Keys land at their places in a second shared
// buffer (OW x 8 B), and the block writes the first OW out as two
// coalesced limb rows.  No step depends on S being a power of two.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
typedef unsigned long long u64;

__device__ __forceinline__ int count_less(const u64* v, int n, u64 x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (v[mid] < x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ int count_less_equal(const u64* v, int n, u64 x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (v[mid] <= x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
    merge2_kernel(const unsigned* __restrict__ a0,
                  const unsigned* __restrict__ a1,
                  const unsigned* __restrict__ b0,
                  const unsigned* __restrict__ b1, int S, int OW,
                  unsigned* __restrict__ o0, unsigned* __restrict__ o1) {
  extern __shared__ u64 smem[];
  u64* in = smem;           // [2S]: a, then b
  u64* out = smem + 2 * S;  // [OW]
  const size_t row = blockIdx.x;
  const size_t base = row * (size_t)S;
  for (int i = threadIdx.x; i < S; i += kThreads) {
    in[i] = ((u64)a0[base + i] << 32) | a1[base + i];
    in[S + i] = ((u64)b0[base + i] << 32) | b1[base + i];
  }
  __syncthreads();
  const u64* a = in;
  const u64* b = in + S;
  for (int i = threadIdx.x; i < 2 * S; i += kThreads) {
    const u64 x = in[i];
    const int r = i < S ? i + count_less(b, S, x)
                        : (i - S) + count_less_equal(a, S, x);
    if (r < OW) out[r] = x;
  }
  __syncthreads();
  const size_t obase = row * (size_t)OW;
  for (int r = threadIdx.x; r < OW; r += kThreads) {
    o0[obase + r] = (unsigned)(out[r] >> 32);
    o1[obase + r] = (unsigned)out[r];
  }
}

}  // namespace

extern "C" {

// a0, a1, b0, b1: [T, S] uint32 limbs; o0, o1: [T, OW] uint32, OW <= 2S.
int mhap_merge2(const void* a0, const void* a1, const void* b0,
                const void* b1, int T, int S, int OW, void* o0, void* o1,
                void* stream) {
  if (T <= 0 || OW <= 0) return (int)cudaSuccess;
  const size_t smem = (size_t)(2 * S + OW) * sizeof(u64);
  if (smem >= 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        merge2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  merge2_kernel<<<T, kThreads, smem, (cudaStream_t)stream>>>(
      (const unsigned*)a0, (const unsigned*)a1, (const unsigned*)b0,
      (const unsigned*)b1, S, OW, (unsigned*)o0, (unsigned*)o1);
  return (int)cudaGetLastError();
}

}  // extern "C"

// The two tensor-core routes for popc(a & b), summed over the bits, on
// Hopper, measured side by side for kernel 6 (csrc/bits.cu):
//  (1) checks the fragment maps kernel 6 uses, for mma.sync m16n8k256 b1
//      .and.popc (lane t takes words 4t..4t+3 of a 16-word row chunk) and
//      for m16n8k32 s8 on 0/1 bytes expanded from nibbles, against the
//      host on a 16 x 8 tile 512 bits deep;
//  (2) times each MMA's issue rate: independent accumulator chains, grids
//      of 4-32 warps an SM;
//  (3) times pure 16-byte streaming stores (st.global.cs) of 16 MiB and
//      256 MiB, kernel 6's output sizes at [2,048]^2 and [8,192]^2, and
//      cudaMemsetAsync of the same.
// TC_B1_OPS_PER_SM_CLOCK in scripts/kernel_ab.py (kernel 6's bound) rests
// on (2); rerun it on another card, or before kernel 6 changes its route.
// Build and run on the card, from the repository's root (scratch_chip/ is
// ignored by git):
//   mkdir -p scratch_chip && nvcc -gencode arch=compute_90a,code=sm_90a \
//     -O3 -std=c++17 -o scratch_chip/mma_routes scripts/mma_routes.cu \
//     && scratch_chip/mma_routes
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <vector>

#define CK(x)                                                          \
  do {                                                                 \
    cudaError_t e_ = (x);                                              \
    if (e_ != cudaSuccess) {                                           \
      printf("CUDA error %s at %d\n", cudaGetErrorString(e_), __LINE__); \
      exit(1);                                                         \
    }                                                                  \
  } while (0)

__device__ __forceinline__ void mma_b1(int* d, const uint32_t* a,
                                       const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_s8(int* d, const uint32_t* a,
                                       const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t expand4(uint32_t x) {
  return ((x & 0xFu) * 0x00204081u) & 0x01010101u;
}

// A: 16 rows x 16 words, B: 8 cols x 16 words (512 bits); D 16 x 8.
// b1: thread t takes words 4t..4t+3 of the row; step 0 = (4t, 4t+1),
// step 1 = (4t+2, 4t+3) as (reg0, reg2).
__global__ void layout_b1(const uint32_t* A, const uint32_t* B, int* D) {
  const int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
  int acc[4] = {0, 0, 0, 0};
  for (int s = 0; s < 2; ++s) {
    uint32_t a[4] = {A[g * 16 + 4 * t + 2 * s], A[(g + 8) * 16 + 4 * t + 2 * s],
                     A[g * 16 + 4 * t + 2 * s + 1],
                     A[(g + 8) * 16 + 4 * t + 2 * s + 1]};
    uint32_t b[2] = {B[g * 16 + 4 * t + 2 * s], B[g * 16 + 4 * t + 2 * s + 1]};
    mma_b1(acc, a, b);
  }
  D[g * 8 + 2 * t] = acc[0];
  D[g * 8 + 2 * t + 1] = acc[1];
  D[(g + 8) * 8 + 2 * t] = acc[2];
  D[(g + 8) * 8 + 2 * t + 1] = acc[3];
}

// s8: step w (one 32-bit word of the row); thread t takes byte t of the
// word: low nibble -> reg0 (k 4t..4t+3), high nibble -> reg2 (k 16+4t..).
__global__ void layout_s8(const uint32_t* A, const uint32_t* B, int* D) {
  const int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
  int acc[4] = {0, 0, 0, 0};
  for (int w = 0; w < 16; ++w) {
    const uint32_t x0 = A[g * 16 + w] >> (8 * t), x1 = A[(g + 8) * 16 + w] >> (8 * t);
    const uint32_t y = B[g * 16 + w] >> (8 * t);
    uint32_t a[4] = {expand4(x0), expand4(x1), expand4(x0 >> 4),
                     expand4(x1 >> 4)};
    uint32_t b[2] = {expand4(y), expand4(y >> 4)};
    mma_s8(acc, a, b);
  }
  D[g * 8 + 2 * t] = acc[0];
  D[g * 8 + 2 * t + 1] = acc[1];
  D[(g + 8) * 8 + 2 * t] = acc[2];
  D[(g + 8) * 8 + 2 * t + 1] = acc[3];
}

template <int MODE, int CH>
__global__ void tput(int iters, int* sink) {
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = (threadIdx.x + 1) * 2654435761u ^ (i * 0x1234567u);
  for (int i = 0; i < 2; ++i) b[i] = (threadIdx.x + 7) * 2246822519u ^ (i * 0x7654321u);
  if (MODE == 1)
    for (int i = 0; i < 4; ++i) a[i] &= 0x01010101u;
  int acc[CH][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      if (MODE == 0)
        mma_b1(acc[c], a, b);
      else
        mma_s8(acc[c], a, b);
    }
  }
  int s = 0;
  for (int c = 0; c < CH; ++c)
    for (int i = 0; i < 4; ++i) s += acc[c][i];
  if (s == 0x7fffffff) sink[0] = s;
}

__global__ void store_cs(float4* out, long long n4) {
  const float4 v = make_float4(1.f, 2.f, 3.f, 4.f);
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n4;
       i += (long long)gridDim.x * blockDim.x)
    asm volatile("st.global.cs.v4.f32 [%0], {%1,%2,%3,%4};" ::"l"(out + i),
                 "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
                 : "memory");
}

static int popc32(uint32_t x) { return __builtin_popcount(x); }

template <typename K>
static float time_launch(K launch, int reps = 5) {
  cudaEvent_t e0, e1;
  CK(cudaEventCreate(&e0));
  CK(cudaEventCreate(&e1));
  launch();
  CK(cudaDeviceSynchronize());
  std::vector<float> ts;
  for (int r = 0; r < reps; ++r) {
    CK(cudaEventRecord(e0));
    launch();
    CK(cudaEventRecord(e1));
    CK(cudaEventSynchronize(e1));
    float ms;
    CK(cudaEventElapsedTime(&ms, e0, e1));
    ts.push_back(ms);
  }
  std::sort(ts.begin(), ts.end());
  return ts[reps / 2];
}

template <int MODE, int CH>
static void run_tput(int sms, double clk_hz, int warps_block, int blocks_sm,
                     int* sink) {
  const int iters = 4096;
  const int grid = sms * blocks_sm;
  float ms = time_launch([&] {
    tput<MODE, CH><<<grid, warps_block * 32>>>(iters, sink);
  });
  CK(cudaGetLastError());
  const double mmas = (double)grid * warps_block * iters * CH;
  const double per_s = mmas / (ms * 1e-3);
  const double per_clk_sm = per_s / sms / clk_hz;
  const double k_bits = MODE == 0 ? 256 : 32;
  const double bit_macs = per_s * 16 * 8 * k_bits;
  printf("%s CH=%d warps/SM=%d: %.3f ms, %.4f mma/clk/SM, %.1f T bit-MAC/s"
         " (%.1f T op/s as 2 ops a MAC)\n",
         MODE == 0 ? "b1 m16n8k256 and.popc" : "s8 m16n8k32", CH,
         warps_block * blocks_sm, ms, per_clk_sm, bit_macs / 1e12,
         2 * bit_macs / 1e12);
}

int main() {
  int dev = 0, sms, clk_khz;
  CK(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  CK(cudaDeviceGetAttribute(&clk_khz, cudaDevAttrClockRate, dev));
  cudaDeviceProp p;
  CK(cudaGetDeviceProperties(&p, dev));
  printf("%s, %d SMs, clock %d kHz\n", p.name, sms, clk_khz);
  // (1) layouts
  std::vector<uint32_t> A(16 * 16), B(8 * 16);
  uint32_t s = 12345;
  auto rnd = [&] { s = s * 1664525u + 1013904223u; return s ^ (s >> 13); };
  for (auto& x : A) x = rnd();
  for (auto& x : B) x = rnd();
  A[3 * 16 + 5] = 0xFFFFFFFFu;
  B[0] = 0xFFFFFFFFu;
  std::vector<int> want(16 * 8), got(16 * 8);
  for (int r = 0; r < 16; ++r)
    for (int c = 0; c < 8; ++c) {
      int v = 0;
      for (int w = 0; w < 16; ++w) v += popc32(A[r * 16 + w] & B[c * 16 + w]);
      want[r * 8 + c] = v;
    }
  uint32_t *dA, *dB;
  int *dD, *sink;
  CK(cudaMalloc(&dA, A.size() * 4));
  CK(cudaMalloc(&dB, B.size() * 4));
  CK(cudaMalloc(&dD, 16 * 8 * 4));
  CK(cudaMalloc(&sink, 64));
  CK(cudaMemcpy(dA, A.data(), A.size() * 4, cudaMemcpyHostToDevice));
  CK(cudaMemcpy(dB, B.data(), B.size() * 4, cudaMemcpyHostToDevice));
  for (int mode = 0; mode < 2; ++mode) {
    CK(cudaMemset(dD, 0xFF, 16 * 8 * 4));
    if (mode == 0)
      layout_b1<<<1, 32>>>(dA, dB, dD);
    else
      layout_s8<<<1, 32>>>(dA, dB, dD);
    CK(cudaGetLastError());
    CK(cudaMemcpy(got.data(), dD, 16 * 8 * 4, cudaMemcpyDeviceToHost));
    int bad = 0;
    for (int i = 0; i < 16 * 8; ++i) bad += got[i] != want[i];
    printf("layout %s: %d of 128 differ (D[0][0] %d want %d, D[3][1] %d "
           "want %d)\n",
           mode == 0 ? "b1" : "s8", bad, got[0], want[0], got[25], want[25]);
  }
  // (2) MMA issue rates
  const double clk = clk_khz * 1e3;
  for (int wb : {4, 8})
    for (int bs : {1, 2, 4}) {
      run_tput<0, 4>(sms, clk, wb, bs, sink);
      run_tput<0, 8>(sms, clk, wb, bs, sink);
      run_tput<1, 4>(sms, clk, wb, bs, sink);
      run_tput<1, 8>(sms, clk, wb, bs, sink);
    }
  // (3) stores
  for (long long bytes : {16777216LL, 268435456LL}) {
    float4* out;
    CK(cudaMalloc(&out, bytes));
    const long long n4 = bytes / 16;
    for (int bps : {2, 4, 8}) {
      float ms = time_launch([&] { store_cs<<<sms * bps, 256>>>(out, n4); });
      printf("store_cs %lld B, %d blocks/SM: %.4f ms, %.3f TB/s\n", bytes,
             bps, ms, bytes / (ms * 1e-3) / 1e12);
    }
    float ms = time_launch([&] { cudaMemsetAsync(out, 0, bytes); });
    printf("cudaMemsetAsync %lld B: %.4f ms, %.3f TB/s\n", bytes, ms,
           bytes / (ms * 1e-3) / 1e12);
    CK(cudaFree(out));
  }
  return 0;
}

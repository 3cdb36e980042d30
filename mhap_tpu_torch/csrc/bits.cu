// Bit-sketch similarity matrix for Hopper (sm_90a): kernel 6.
//
// Replaces bit_similarity_matrix (mhap_tpu/sketches/bits.py:137), which is
// not a Pallas kernel but jax.lax.population_count over a broadcast xor.
// For a [NA, W] and b [NB, W] words of 32 or 64 bits:
//
//   out[i, j] = 1 - float(popcount(a[i] ^ b[j]) summed over W) / float(bits W)
//
// with an IEEE round-to-nearest divide and subtract (__fdiv_rn,
// __fsub_rn), as the JAX expression and the plain version (ops/bits.py)
// compute it.  On 64-bit words the count covers all 64 bits, which the
// JAX version, under its 32-bit default, does not.
//
// What bounds it on the H100: operations.  Each output reads W words of
// its row and of its column but writes 4 bytes, so at the widths of the
// bit sketches (W = 8 or 16) the popcounts (one per 32-bit word, two per
// 64-bit word, 16 a clock on an SM) cost more than the bytes.
//
// Design, simple first: one block computes a 64 x 64 output tile with
// 16 x 16 threads, 4 x 4 outputs each: thread (tx, ty) owns rows
// ty + 16 r and columns tx + 16 c, so neighbouring threads store
// neighbouring floats.  A and B tiles go through shared memory in chunks
// of kChunk words, transposed ([word][row]) so that a thread's four column
// reads touch neighbouring addresses; rows past NA or NB load zeros and
// their outputs are not stored.  Counts stay in int32 registers.  One
// template serves both word widths.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTile = 64;   // rows and columns of a block's output tile
constexpr int kSide = 16;   // threads a side of the block
constexpr int kChunk = 16;  // words of a row staged at a time
constexpr int kPer = kTile / kSide;

__device__ __forceinline__ int popc(uint32_t x) { return __popc(x); }
__device__ __forceinline__ int popc(unsigned long long x) {
  return __popcll(x);
}

template <typename Word>
__global__ void __launch_bounds__(kSide* kSide)
    bit_similarity_kernel(const Word* __restrict__ a,
                          const Word* __restrict__ b, int na, int nb, int w,
                          float nbits, float* __restrict__ out) {
  __shared__ Word as[kChunk][kTile + 1];
  __shared__ Word bs[kChunk][kTile + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kSide + tx;
  const int row0 = blockIdx.y * kTile, col0 = blockIdx.x * kTile;
  int acc[kPer][kPer] = {};
  for (int k0 = 0; k0 < w; k0 += kChunk) {
    const int kc = min(kChunk, w - k0);
    for (int idx = tid; idx < kTile * kChunk; idx += kSide * kSide) {
      const int r = idx / kChunk, k = idx % kChunk;
      Word va = 0, vb = 0;
      if (k < kc) {
        if (row0 + r < na) va = a[(size_t)(row0 + r) * w + k0 + k];
        if (col0 + r < nb) vb = b[(size_t)(col0 + r) * w + k0 + k];
      }
      as[k][r] = va;
      bs[k][r] = vb;
    }
    __syncthreads();
    for (int k = 0; k < kc; ++k) {
      Word ra[kPer], rb[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        ra[i] = as[k][ty + kSide * i];
        rb[i] = bs[k][tx + kSide * i];
      }
#pragma unroll
      for (int i = 0; i < kPer; ++i)
#pragma unroll
        for (int j = 0; j < kPer; ++j) acc[i][j] += popc(ra[i] ^ rb[j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int r = row0 + ty + kSide * i;
    if (r >= na) continue;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int c = col0 + tx + kSide * j;
      if (c < nb)
        out[(size_t)r * nb + c] =
            __fsub_rn(1.0f, __fdiv_rn((float)acc[i][j], nbits));
    }
  }
}

}  // namespace

extern "C" {

// a: [na, w], b: [nb, w] words of word_bits (32 or 64) bits, contiguous;
// out: [na, nb] float32.  Launches nothing for an empty side.
int mhap_bit_similarity(const void* a, const void* b, int na, int nb, int w,
                        int word_bits, void* out, void* stream) {
  if (na < 0 || nb < 0 || w < 1 || (word_bits != 32 && word_bits != 64))
    return (int)cudaErrorInvalidValue;
  if (na == 0 || nb == 0) return (int)cudaSuccess;
  const dim3 grid((nb + kTile - 1) / kTile, (na + kTile - 1) / kTile);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  const dim3 block(kSide, kSide);
  const float nbits = (float)((long long)word_bits * w);
  cudaStream_t s = (cudaStream_t)stream;
  if (word_bits == 32)
    bit_similarity_kernel<uint32_t><<<grid, block, 0, s>>>(
        (const uint32_t*)a, (const uint32_t*)b, na, nb, w, nbits,
        (float*)out);
  else
    bit_similarity_kernel<unsigned long long><<<grid, block, 0, s>>>(
        (const unsigned long long*)a, (const unsigned long long*)b, na, nb,
        w, nbits, (float*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"

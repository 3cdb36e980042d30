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
// The count goes through the tensor cores.  For bit rows a and b,
//
//   popc(a ^ b) = popc(a) + popc(b) - 2 popc(a & b),
//
// and popc(a & b) summed over the words is the integer product D = A B^T
// of the rows' bits, K = bits W deep: one mma.sync m16n8k256 b1 with
// .and.popc covers 256 bits of a 16 x 8 output tile and accumulates in
// int32.  Rows are read as strings of 32-bit words, whatever the word
// type: the identity holds under any bit order that a and b share, so
// uint64 words and their uint32 view take one path.  K is padded with
// zero words to the MMA's depth; zero bits add nothing to D or to the
// popcounts, so every W >= 1 is exact.
//
// What bounds it on the H100: bytes.  Each output costs 2K bit operations
// on the tensor cores, but writes 4 bytes; at the widths of the bit
// sketches (K = 512) the binary MMA (~0.59 a clock on an SM, measured by
// scripts/mma_routes.cu) needs far less time than the output's stores.
//
// Design, around the stores:
//  - Each warp owns whole output tiles of kTM x kTN (2 x 8 MMA tiles) and
//    walks a 1-D list of them, tile t = row band t / tiles_n, column band
//    t % tiles_n, stepping by the grid's warps; the grid is the card's
//    resident blocks (or fewer), so any NA fits, and a warp's stores of one
//    tile drain while it computes the next.
//  - Fragments load straight from device memory (the rows are small and
//    stay in L2): lane (g, t) reads 16 bytes, words 4t..4t+3 of a 16-word
//    chunk, of each row it feeds, zero past the row's end; words (4t, 4t+1)
//    feed the chunk's first MMA as (a0/b0, a2/b1), (4t+2, 4t+3) its second.
//    A and B use the same word-to-k map, so D is exact.  Row indices past
//    NA or NB are clamped to the last row: their outputs are not stored.
//  - The lanes' popcounts of the same words, summed over the quad that
//    shares a row, give popc(a[i]) and popc(b[j]); the column's sum comes
//    from the quad that loaded it by a shuffle.
//  - Epilogue: count = popc(a[i]) + popc(b[j]) - 2 D[i, j], and the
//    output for it from a table of 1 - c / nbits for c = 0..nbits that
//    each block fills with the IEEE divide and subtract before its first
//    tile (one block barrier, outside the walk): a per-output divide is a
//    dozen instructions and a branch that serialise the epilogue (rows of
//    kTableMax bits or more still divide).  The outputs go into the warp's
//    staging tile in shared memory (pitch kTN + 8 floats: conflict-free
//    float2 writes).  A tile inside
//    [NA, NB] whose rows are 16-byte aligned (NB % 4 == 0) goes out as
//    16-byte streaming stores (st.global.cs), two rows of 256 bytes a warp
//    instruction; an edge tile or unaligned rows as coalesced 4-byte
//    streaming stores, masked to [NA, NB].

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kWarps = 8;        // warps a block, each walking its own tiles
constexpr int kTM = 32;          // output rows of a warp's tile (2 MMA tiles)
constexpr int kTN = 64;          // output columns of a warp's tile (8)
constexpr int kMT = kTM / 16;
constexpr int kNT = kTN / 8;
constexpr int kPitch = kTN + 8;  // floats a staged row
constexpr int kChunk = 16;       // 32-bit words of a row a step: 2 MMAs
constexpr int kMaxDevices = 64;
constexpr int kStageBytes = kWarps * kTM * kPitch * (int)sizeof(float);
// outputs by count, 1 - count / nbits for count = 0..nbits, while nbits
// + 1 fits; wider rows divide per output
constexpr int kTableMax = 8192;

constexpr int smem_bytes(bool table) {
  return kStageBytes + (table ? kTableMax * (int)sizeof(float) : 0);
}

// d += popc(A & B) over 256 bits: A 16 x 256 row-major, B 256 x 8
// column-major, 32 bits a register
__device__ __forceinline__ void mma_and_popc(int (&d)[4], uint32_t a0,
                                             uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint32_t b0,
                                             uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// words [w0, w0 + 4) of a row of nw words, zero past its end; kVec: the
// row is 16-byte aligned and nw % 4 == 0, so the four are in or out
template <bool kVec>
__device__ __forceinline__ uint4 load4(const uint32_t* __restrict__ row,
                                       int w0, int nw) {
  if (kVec)
    return w0 < nw ? __ldg(reinterpret_cast<const uint4*>(row + w0))
                   : make_uint4(0u, 0u, 0u, 0u);
  uint4 v;
  v.x = w0 < nw ? __ldg(row + w0) : 0u;
  v.y = w0 + 1 < nw ? __ldg(row + w0 + 1) : 0u;
  v.z = w0 + 2 < nw ? __ldg(row + w0 + 2) : 0u;
  v.w = w0 + 3 < nw ? __ldg(row + w0 + 3) : 0u;
  return v;
}

__device__ __forceinline__ int popc4(uint4 v) {
  return __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
}

__device__ __forceinline__ float similarity(int count, float nbits) {
  return __fsub_rn(1.0f, __fdiv_rn((float)count, nbits));
}

__device__ __forceinline__ void store_cs(float* p, float v) {
  asm volatile("st.global.cs.f32 [%0], %1;" ::"l"(p), "f"(v) : "memory");
}

__device__ __forceinline__ void store_cs4(float* p, float4 v) {
  asm volatile("st.global.cs.v4.f32 [%0], {%1,%2,%3,%4};" ::"l"(p),
               "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

template <bool kVec, bool kTable>
__global__ void __launch_bounds__(kWarps * 32, 2)
    bit_similarity_kernel(const uint32_t* __restrict__ a,
                          const uint32_t* __restrict__ b, int na, int nb,
                          int nw, int tiles, int nbits, bool aligned_out,
                          float* __restrict__ out) {
  extern __shared__ float4 smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  float* stage = reinterpret_cast<float*>(smem) + warp * kTM * kPitch;
  float* table = reinterpret_cast<float*>(smem) + kWarps * kTM * kPitch;
  const float fbits = (float)nbits;
  if (kTable) {
    for (int c = threadIdx.x; c <= nbits; c += kWarps * 32)
      table[c] = similarity(c, fbits);
    __syncthreads();
  }
  const int tiles_n = (nb + kTN - 1) / kTN;
  const int steps = (nw + kChunk - 1) / kChunk;
  for (int tile = blockIdx.x * kWarps + warp; tile < tiles;
       tile += gridDim.x * kWarps) {
    const int r0 = tile / tiles_n * kTM, c0 = tile % tiles_n * kTN;
    int acc[kMT][kNT][4] = {};
    int pa[kMT][2] = {}, pb[kNT] = {};
    for (int s = 0; s < steps; ++s) {
      const int w0 = s * kChunk + 4 * t;
      uint4 xa[kMT][2];
#pragma unroll
      for (int m = 0; m < kMT; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = min(r0 + 16 * m + 8 * h + g, na - 1);
          xa[m][h] = load4<kVec>(a + (size_t)r * nw, w0, nw);
          pa[m][h] += popc4(xa[m][h]);
        }
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        const int c = min(c0 + 8 * n + g, nb - 1);
        const uint4 xb = load4<kVec>(b + (size_t)c * nw, w0, nw);
        pb[n] += popc4(xb);
#pragma unroll
        for (int m = 0; m < kMT; ++m) {
          mma_and_popc(acc[m][n], xa[m][0].x, xa[m][1].x, xa[m][0].y,
                       xa[m][1].y, xb.x, xb.y);
          mma_and_popc(acc[m][n], xa[m][0].z, xa[m][1].z, xa[m][0].w,
                       xa[m][1].w, xb.z, xb.w);
        }
      }
    }
    // the quad 4g..4g+3 read row g's words: sum its four parts
#pragma unroll
    for (int m = 0; m < kMT; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        pa[m][h] += __shfl_xor_sync(0xffffffffu, pa[m][h], 1);
        pa[m][h] += __shfl_xor_sync(0xffffffffu, pa[m][h], 2);
      }
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      pb[n] += __shfl_xor_sync(0xffffffffu, pb[n], 1);
      pb[n] += __shfl_xor_sync(0xffffffffu, pb[n], 2);
      // accumulator (g, t) holds columns 2t and 2t + 1: quads 2t, 2t + 1
      const int p0 = __shfl_sync(0xffffffffu, pb[n], 8 * t);
      const int p1 = __shfl_sync(0xffffffffu, pb[n], 8 * t + 4);
#pragma unroll
      for (int m = 0; m < kMT; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int n0 = pa[m][h] + p0 - 2 * acc[m][n][2 * h];
          const int n1 = pa[m][h] + p1 - 2 * acc[m][n][2 * h + 1];
          const float2 v =
              kTable ? make_float2(table[n0], table[n1])
                     : make_float2(similarity(n0, fbits),
                                   similarity(n1, fbits));
          *reinterpret_cast<float2*>(
              stage + (16 * m + 8 * h + g) * kPitch + 8 * n + 2 * t) = v;
        }
    }
    __syncwarp();
    if (aligned_out && r0 + kTM <= na && c0 + kTN <= nb) {
      const int col = 4 * (lane & 15);
#pragma unroll 4
      for (int i = 0; i < kTM / 2; ++i) {
        const int row = 2 * i + (lane >> 4);
        store_cs4(out + (size_t)(r0 + row) * nb + c0 + col,
                  *reinterpret_cast<const float4*>(stage + row * kPitch +
                                                   col));
      }
    } else {
      const int rows = min(kTM, na - r0), cols = min(kTN, nb - c0);
      for (int row = 0; row < rows; ++row)
        for (int col = lane; col < cols; col += 32)
          store_cs(out + (size_t)(r0 + row) * nb + c0 + col,
                   stage[row * kPitch + col]);
    }
    __syncwarp();  // the stage is rewritten by the next tile
  }
}

// Resident blocks per SM of the kernel (after allowing its dynamic shared
// memory), and the card's SM count.
template <bool kVec, bool kTable>
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
  e = cudaFuncSetAttribute(bit_similarity_kernel<kVec, kTable>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem_bytes(kTable));
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, bit_similarity_kernel<kVec, kTable>, kWarps * 32,
        smem_bytes(kTable));
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess && *per_sm < 1) e = cudaErrorInvalidConfiguration;
  if (e == cudaSuccess && dev < kMaxDevices) {
    cached[dev][0] = *per_sm;
    cached[dev][1] = *sms;
  }
  return e;
}

template <bool kVec, bool kTable>
cudaError_t launch(const uint32_t* a, const uint32_t* b, int na, int nb,
                   int nw, int tiles, int nbits, bool aligned_out,
                   float* out, cudaStream_t s) {
  int per_sm = 0, sms = 0;
  cudaError_t e = residency<kVec, kTable>(&per_sm, &sms);
  if (e != cudaSuccess) return e;
  const int want = (tiles + kWarps - 1) / kWarps;
  const int grid = want < per_sm * sms ? want : per_sm * sms;
  const int smem = kStageBytes + (kTable ? (nbits + 1) * 4 : 0);
  bit_similarity_kernel<kVec, kTable><<<grid, kWarps * 32, smem, s>>>(
      a, b, na, nb, nw, tiles, nbits, aligned_out, out);
  return cudaGetLastError();
}

template <bool kVec>
cudaError_t dispatch(const uint32_t* a, const uint32_t* b, int na, int nb,
                     int nw, int tiles, int nbits, bool aligned_out,
                     float* out, cudaStream_t s) {
  return nbits < kTableMax
             ? launch<kVec, true>(a, b, na, nb, nw, tiles, nbits,
                                  aligned_out, out, s)
             : launch<kVec, false>(a, b, na, nb, nw, tiles, nbits,
                                   aligned_out, out, s);
}

template <bool kVec, bool kTable>
cudaError_t occupancy(int* info) {
  int per_sm = 0, sms = 0;
  cudaFuncAttributes at;
  cudaError_t e = residency<kVec, kTable>(&per_sm, &sms);
  if (e == cudaSuccess)
    e = cudaFuncGetAttributes(&at, bit_similarity_kernel<kVec, kTable>);
  if (e != cudaSuccess) return e;
  info[0] = at.numRegs;
  info[1] = (int)at.sharedSizeBytes;
  info[2] = smem_bytes(kTable);
  info[3] = (int)at.localSizeBytes;
  info[4] = per_sm;
  info[5] = kWarps;
  info[6] = kTM;
  info[7] = kTN;
  return cudaSuccess;
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
  const long long nw = (long long)w * (word_bits / 32);
  const long long tiles = ((na + (long long)kTM - 1) / kTM) *
                          ((nb + (long long)kTN - 1) / kTN);
  if (nw > INT_MAX / 64 || tiles > INT_MAX / 2)
    return (int)cudaErrorInvalidValue;
  const bool vec = nw % 4 == 0 && (uintptr_t)a % 16 == 0 &&
                   (uintptr_t)b % 16 == 0;
  const bool aligned_out = nb % 4 == 0 && (uintptr_t)out % 16 == 0;
  const int nbits = (int)(32 * nw);
  const uint32_t *wa = (const uint32_t*)a, *wb = (const uint32_t*)b;
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(vec ? dispatch<true>(wa, wb, na, nb, (int)nw, (int)tiles,
                                    nbits, aligned_out, (float*)out, s)
                   : dispatch<false>(wa, wb, na, nb, (int)nw, (int)tiles,
                                     nbits, aligned_out, (float*)out, s));
}

// info[0..7]: registers a thread, static and dynamic shared bytes a block
// (the table's at its largest), local (spill) bytes a thread, resident
// blocks per SM, warps a block, rows and columns of a warp's output tile;
// vec picks the kernel of 16-byte row loads (nonzero) or of 4-byte ones,
// table the kernel that looks outputs up by count (nonzero) or divides.
int mhap_bit_similarity_occupancy(int vec, int table, int* info) {
  return (int)(vec ? (table ? occupancy<true, true>(info)
                            : occupancy<true, false>(info))
                   : (table ? occupancy<false, true>(info)
                            : occupancy<false, false>(info)));
}

}  // extern "C"

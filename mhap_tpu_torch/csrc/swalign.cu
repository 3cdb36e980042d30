// Batched affine-gap local Smith-Waterman for Hopper (sm_90a): kernel 5.
//
// Replaces sw_align_batch (mhap_tpu/ops/swalign.py:37), which is not a
// Pallas kernel but a jax.lax.scan over anti-diagonals: each step ~100
// elementwise ops on [P, n+1] arrays with 26 carried arrays, a launch
// each in plain PyTorch (ops/swalign.py).  Same outputs, bit for bit, on
// all eight columns: score, q_end, r_end, q_begin, r_begin, matches,
// errors, length.  The tie rules it keeps (ops/swalign.py's docstring):
// E and F extend on ties; H takes diag before F before E, stats only
// where h > 0; a path begins at (i-1, j-1) where that cell's H is 0; the
// best cell is the largest score, then the smallest i, then the smallest
// j; a best score of 0 gives q_end = r_end = -1 and zero stats.
//
// What bounds it on the H100: operations.  A cell reads one byte of r
// and does ~55 INT32 operations (the recurrences, the stat selections,
// the running best); the inputs are a few KB a pair.
//
// Design, simple first: one block a pair (a grid-stride loop over pairs),
// blockDim threads own query rows in stripes of blockDim.  Thread t of a
// stripe holds row i = base + t + 1 and sweeps the reference with an
// anti-diagonal skew: at step s it computes column j = s - t + 1.
//  - H(i, j-1), E(i, j-1) and their stats stay in registers; so does
//    H(i-1, j-1) with its stats, which is the previous step's "up".
//  - H(i-1, j) and F(i-1, j) with their eight stats come from thread t-1's
//    previous step through a shared-memory ping-pong (two buffers of 10 x
//    blockDim ints, one __syncthreads a step).
//  - A stripe's top row (the previous stripe's last row) comes from a
//    device-memory buffer of (m + 1) x 10 ints a block, written by the
//    previous stripe's last thread.  Thread 0 reads column j at step j-1
//    and the last thread overwrites it at step j + blockDim - 2, after it
//    was read, so one buffer serves in place.
//  - Each pair is swept to its own qlen x rlen, not the batch's padded
//    n x m: padded cells score 0 and never win under strict >.
//  - A thread visits its cells in (i, j) order and keeps its best on
//    strict >; the block then takes the largest score and, on ties, the
//    smallest i (a row belongs to one thread), which is the JAX order.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kNeg = -(1 << 29);
constexpr int kFields = 10;  // H, F, then M, L, Q, R of H and of F

struct Stats {
  int m, l, q, r;
};

__device__ __forceinline__ Stats pick(bool c, const Stats& a,
                                      const Stats& b) {
  return c ? a : b;
}

__global__ void sw_kernel(const uint8_t* __restrict__ q, int n,
                          const uint8_t* __restrict__ r, int m,
                          const int* __restrict__ qlen,
                          const int* __restrict__ rlen, int P, int match,
                          int mismatch, int go, int ge,
                          int* __restrict__ border, int* __restrict__ out) {
  extern __shared__ int smem[];  // [2][kFields][B]; then [7][B] to reduce
  const int B = blockDim.x, t = threadIdx.x;
  int* top = border + (size_t)blockIdx.x * (m + 1) * kFields;
  for (int p = blockIdx.x; p < P; p += gridDim.x) {
    const int ql = min(max(qlen[p], 0), n), rl = min(max(rlen[p], 0), m);
    const uint8_t* qp = q + (size_t)p * n;
    const uint8_t* rp = r + (size_t)p * m;
    int best = 0, bi = INT_MAX, bj = 0;
    Stats bs{0, 0, 0, 0};
    for (int base = 0; base < ql; base += B) {
      const int i = base + t + 1;
      const bool row_on = i <= ql;
      const uint8_t qc = row_on ? qp[i - 1] : 0;
      const bool first = base == 0;
      const bool hand_down = t == B - 1 && base + B < ql;
      const int rows = min(B, ql - base);
      int hl = 0, el = kNeg, hd = 0;  // H(i,j-1), E(i,j-1), H(i-1,j-1)
      Stats hsl{0, 0, 0, 0}, esl{0, 0, 0, 0}, hsd{0, 0, 0, 0};
      const int steps = rl + rows - 1;
      for (int s = 0; s < steps; ++s) {
        const int j = s - t + 1;
        if (row_on && j >= 1 && j <= rl) {
          int hu, fu;
          Stats hsu, fsu;
          if (t > 0) {
            const int* rd = smem + ((s + 1) & 1) * kFields * B + t - 1;
            hu = rd[0];
            fu = rd[B];
            hsu = {rd[2 * B], rd[3 * B], rd[4 * B], rd[5 * B]};
            fsu = {rd[6 * B], rd[7 * B], rd[8 * B], rd[9 * B]};
          } else if (first) {
            hu = 0;
            fu = kNeg;
            hsu = fsu = {0, 0, 0, 0};
          } else {
            const int* b = top + j * kFields;
            hu = b[0];
            fu = b[1];
            hsu = {b[2], b[3], b[4], b[5]};
            fsu = {b[6], b[7], b[8], b[9]};
          }
          // E: gap along r, from (i, j-1); extends on ties
          const bool eext = el - ge >= hl - go;
          const int e = eext ? el - ge : hl - go;
          Stats es = pick(eext, esl, hsl);
          es.l += 1;
          // F: gap along q, from (i-1, j); extends on ties
          const bool fext = fu - ge >= hu - go;
          const int f = fext ? fu - ge : hu - go;
          Stats fs = pick(fext, fsu, hsu);
          fs.l += 1;
          // diag from (i-1, j-1); a path begins where that H is 0
          const bool mt = qc == rp[j - 1];
          const int dg = hd + (mt ? match : mismatch);
          Stats ds{hsd.m + (int)mt, hsd.l + 1, hd == 0 ? i - 1 : hsd.q,
                   hd == 0 ? j - 1 : hsd.r};
          const int h = max(max(dg, 0), max(e, f));
          Stats hs{0, 0, 0, 0};
          if (h > 0) hs = h == dg ? ds : h == f ? fs : h == e ? es : hs;
          int* wr = smem + (s & 1) * kFields * B + t;
          wr[0] = h;
          wr[B] = f;
          wr[2 * B] = hs.m;
          wr[3 * B] = hs.l;
          wr[4 * B] = hs.q;
          wr[5 * B] = hs.r;
          wr[6 * B] = fs.m;
          wr[7 * B] = fs.l;
          wr[8 * B] = fs.q;
          wr[9 * B] = fs.r;
          if (hand_down) {
            int* b = top + j * kFields;
            b[0] = h;
            b[1] = f;
            b[2] = hs.m;
            b[3] = hs.l;
            b[4] = hs.q;
            b[5] = hs.r;
            b[6] = fs.m;
            b[7] = fs.l;
            b[8] = fs.q;
            b[9] = fs.r;
          }
          if (h > best) {
            best = h;
            bi = i;
            bj = j;
            bs = hs;
          }
          hd = hu;
          hsd = hsu;
          hl = h;
          el = e;
          hsl = hs;
          esl = es;
        }
        __syncthreads();
      }
    }
    // the block's best: largest score, then smallest i
    int* red = smem;
    red[t] = best;
    red[B + t] = bi;
    red[2 * B + t] = bj;
    red[3 * B + t] = bs.m;
    red[4 * B + t] = bs.l;
    red[5 * B + t] = bs.q;
    red[6 * B + t] = bs.r;
    __syncthreads();
    if (t == 0) {
      int w = 0;
      for (int k = 1; k < B; ++k)
        if (red[k] > red[w] || (red[k] == red[w] && red[B + k] < red[B + w]))
          w = k;
      int o[8] = {0, -1, -1, 0, 0, 0, 0, 0};
      if (red[w] > 0) {
        const int M = red[3 * B + w], L = red[4 * B + w];
        o[0] = red[w];
        o[1] = red[B + w] - 1;
        o[2] = red[2 * B + w] - 1;
        o[3] = red[5 * B + w];
        o[4] = red[6 * B + w];
        o[5] = M;
        o[6] = L - M;
        o[7] = L;
      }
      for (int k = 0; k < 8; ++k) out[(size_t)k * P + p] = o[k];
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// q: [P, n] uint8, r: [P, m] uint8, qlen, rlen: [P] int32 (clamped to
// [0, n] and [0, m]); border: grid x (m + 1) x 10 int32 of scratch; out:
// [8, P] int32 in the order score, q_end, r_end, q_begin, r_begin,
// matches, errors, length.  ``threads`` a block, ``grid`` blocks.
int mhap_sw_align_batch(const void* q, int n, const void* r, int m,
                        const void* qlen, const void* rlen, int P,
                        int match, int mismatch, int gap_open,
                        int gap_extend, int threads, int grid, void* border,
                        void* out, void* stream) {
  if (P <= 0) return (int)cudaSuccess;
  if (threads < 1 || threads > 1024 || grid < 1 || n < 0 || m < 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)2 * kFields * threads * sizeof(int);
  sw_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)q, n, (const uint8_t*)r, m, (const int*)qlen,
      (const int*)rlen, P, match, mismatch, gap_open, gap_extend,
      (int*)border, (int*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"

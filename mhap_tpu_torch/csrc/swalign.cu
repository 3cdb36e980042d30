// Batched affine-gap local Smith-Waterman for Hopper (sm_90a): kernel 5.
//
// Replaces sw_align_batch (mhap_tpu/ops/swalign.py:37), which is not a
// Pallas kernel but a jax.lax.scan over anti-diagonals: each step ~100
// elementwise ops on [P, n+1] arrays with 26 carried arrays, a launch
// each in plain PyTorch (ops/swalign.py).  Same outputs, bit for bit, on
// all eight columns: score, q_end, r_end, q_begin, r_begin, matches,
// errors, length.  The tie rules it keeps (ops/swalign.py's docstring):
// E and F extend on ties; H takes diag before F before E, stats only where
// h > 0; a path begins at (i-1, j-1) where that cell's H is 0; the
// best cell is the largest score, then the smallest i, then the smallest
// j; a best score of 0 gives q_end = r_end = -1 and zero stats.
//
// What bounds it on the H100: operations.  A cell reads one byte of r
// and needs at least 31 integer operations (the recurrences, the stat
// selections, the running best; scripts/kernel_ab.py SW_OPS_PER_CELL), which
// this kernel does in ~48 instructions with its bookkeeping; the inputs
// are a few KB a pair.
//
// Design: a block of kWarps warps a pair; within a warp the rows are
// handed from lane to lane in registers.
//  - The wrapper orders the pairs by qlen x rlen, largest first; a
//    persistent grid of the card's resident blocks takes them in that
//    order from an atomic counter, so the largest pairs start first and
//    the small ones fill the end.  A block, not a warp, takes a pair, so
//    the largest pair is not left to one warp at the end (alone, a warp
//    sweeps 7.7 M cells in 11.5 ms on the H100; a block of 4 in 4.7 ms).
//  - A warp sweeps stripes of 32 x kRows query rows; warp w of the block
//    takes the pair's stripes w, w + kWarps, ...  Lane t holds rows
//    i0 + t kRows + k + 1 (k < kRows) and at step s computes column
//    j = s - t kRows - k + 1 of each: an anti-diagonal inside the lane as
//    across the warp, so a lane's kRows cells of a step are independent
//    of each other.
//  - Row k reads H(i-1, j), F(i-1, j) and their stats from row k-1's
//    previous step, and H(i-1, j-1) from row k-1's step before that: H
//    and its stats are kept for two steps (a ping-pong on the step's
//    parity, the step loop unrolled by two), so nothing is copied.  Row
//    0 gets row kRows-1 of lane t-1 by __shfl_up_sync, with no shared
//    memory and no barrier.
//  - A stripe's last row goes to the warp's border row in device memory,
//    one column a step from lane 31; lane 0 of the next stripe's warp
//    reads it, two steps ahead of its use.  The writer publishes how many
//    columns it has written (a fence, then a count in shared memory)
//    every 32 steps and at the stripe's end; the reader waits for the
//    columns of each 32 steps (of each step in the masked steps below)
//    before it reads them.  A border row is rewritten only kWarps stripes
//    later, by a warp whose own top row waited, link by link, on the
//    reader having passed those columns, so no ring bound can deadlock
//    the team and no column is overwritten unread.  The last warp's
//    border row starts each pair as the matrix's top boundary, which
//    warp 0 reads above the first stripe.
//  - Steps where every cell of the warp lies inside the pair run
//    unmasked; the stripe's first and last 32 kRows steps, and a last
//    stripe of fewer rows, run a masked copy of the step in which a cell
//    outside the pair keeps its row's state.
//  - Path stats (matches M, columns L, begin (Q, R)) take two words,
//    L << 16 | M and Q + 1 << 16 | R + 1 (the position i << 16 | j of
//    the path's first diagonal cell), where n + m <= 65,535 and the gap
//    penalties are >= 0: one add steps both L and M, a fresh path takes
//    the cell's position, and the stats of a cell whose H is 0 are left
//    as they are instead of zeroed, since no path with a positive score
//    reads them then (a gap that opens or extends from such a cell scores
//    at most -gap_open, and the diagonal starts a fresh path there).
//    Other batches take the 32-bit instantiation, four words, zeroed as
//    the plain version does: no size is refused.
//  - E and F take Hopper's DPX __vibmax_s32 (the max and "extend >=
//    open" in one).  H is two max: with __vimax3_s32_relu (max(diag, E,
//    F, 0) in one) H's values stay right but the stats its h == diag and
//    h == F select come out wrong from ptxas at -O1 and above (CUDA
//    12.9 on the H100; right at -O0), so it is not used.
//  - Each row keeps its best on strict >, visiting j in order; at the end
//    of a stripe the rows fold into the lane's best in order of i, and at
//    the end of the pair a shuffle reduction in each warp, then the
//    block's first thread over the warps, takes the largest score, then
//    the smallest (i, j).

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

// The block's shape is the wrapper's (ops/swalign_kernels.py WARPS and
// ROWS), which ops/_build.py passes to nvcc
#if !defined(MHAP_SW_WARPS) || !defined(MHAP_SW_ROWS)
#error "build with -DMHAP_SW_WARPS and -DMHAP_SW_ROWS (ops/_build.py)"
#endif

constexpr int kNeg = -(1 << 29);
constexpr int kLanes = 32;
constexpr int kRows = MHAP_SW_ROWS;          // query rows a lane
constexpr int kStripe = kLanes * kRows;      // query rows a warp sweeps
constexpr int kWarps = MHAP_SW_WARPS;  // a team of warps that share a pair
constexpr unsigned kAll = 0xffffffffu;

template <bool kWide>
struct Path;

// Two words: lm = L << 16 | M, qr = Q << 16 | R.  A cell's position is
// i << 16 | j, so a path's start is the position of its first diagonal
// cell and the best cell's (i, j) order is one unsigned compare.
template <>
struct Path<false> {
  struct S {
    uint32_t lm, qr;
  };
  using Pos = uint32_t;
  static __device__ __forceinline__ S sel(bool c, const S& a, const S& b) {
    return {c ? a.lm : b.lm, c ? a.qr : b.qr};
  }
  static __device__ __forceinline__ S gap(const S& a) {
    return {a.lm + 0x10000u, a.qr};
  }
  static __device__ __forceinline__ S diag(const S& d, int hd, bool mt,
                                           int /*i*/, Pos pos) {
    const bool z = hd == 0;
    return {(z ? 0u : d.lm) + (mt ? 0x10001u : 0x10000u), z ? pos : d.qr};
  }
  // stats of H = h > 0; left as they are where h == 0 (no reader)
  static __device__ __forceinline__ S pick(int h, int dg, int f, const S& ds,
                                           const S& fs, const S& es) {
    return sel(h == dg, ds, sel(h == f, fs, es));
  }
  static __device__ __forceinline__ bool earlier(int /*ai*/, Pos a,
                                                 int /*bi*/, Pos b) {
    return a < b;
  }
  static __device__ __forceinline__ void decode(int /*i*/, Pos pos,
                                                const S& s, int* o) {
    o[1] = (int)(pos >> 16) - 1;
    o[2] = (int)(pos & 0xffffu) - 1;
    o[3] = (int)(s.qr >> 16) - 1;
    o[4] = (int)(s.qr & 0xffffu) - 1;
    o[5] = (int)(s.lm & 0xffffu);
    o[7] = (int)(s.lm >> 16);
    o[6] = o[7] - o[5];
  }
};

// Four 32-bit words M, L, Q, R (the path's begin), zeroed where H is 0,
// as the plain version keeps them; a position is the column j (i is the
// row's).
template <>
struct Path<true> {
  struct S {
    int m, l, q, r;
  };
  using Pos = int;
  static __device__ __forceinline__ S sel(bool c, const S& a, const S& b) {
    return {c ? a.m : b.m, c ? a.l : b.l, c ? a.q : b.q, c ? a.r : b.r};
  }
  static __device__ __forceinline__ S gap(const S& a) {
    return {a.m, a.l + 1, a.q, a.r};
  }
  static __device__ __forceinline__ S diag(const S& d, int hd, bool mt, int i,
                                           Pos j) {
    const bool z = hd == 0;
    return {d.m + (int)mt, d.l + 1, z ? i - 1 : d.q, z ? j - 1 : d.r};
  }
  static __device__ __forceinline__ S pick(int h, int dg, int f, const S& ds,
                                           const S& fs, const S& es) {
    const S zero{0, 0, 0, 0};
    return sel(h > 0, sel(h == dg, ds, sel(h == f, fs, es)), zero);
  }
  static __device__ __forceinline__ bool earlier(int ai, Pos a, int bi,
                                                 Pos b) {
    return ai < bi || (ai == bi && a < b);
  }
  static __device__ __forceinline__ void decode(int i, Pos j, const S& s,
                                                int* o) {
    o[1] = i - 1;
    o[2] = j - 1;
    o[3] = s.q;
    o[4] = s.r;
    o[5] = s.m;
    o[6] = s.l - s.m;
    o[7] = s.l;
  }
};

// A column of the border row: the H and F of a stripe's last row and
// their stats, padded to 16 bytes (32 bytes packed, 48 wide)
template <bool kWide>
struct alignas(16) Entry {
  int h, f;
  typename Path<kWide>::S hs, fs;
  int pad[2];
};

__device__ __forceinline__ uint32_t shfl_up(uint32_t v) {
  return __shfl_up_sync(kAll, v, 1);
}
__device__ __forceinline__ int shfl_up(int v) {
  return __shfl_up_sync(kAll, v, 1);
}
__device__ __forceinline__ Path<false>::S shfl_up(const Path<false>::S& s) {
  return {shfl_up(s.lm), shfl_up(s.qr)};
}
__device__ __forceinline__ Path<true>::S shfl_up(const Path<true>::S& s) {
  return {shfl_up(s.m), shfl_up(s.l), shfl_up(s.q), shfl_up(s.r)};
}

// A lane's registers for one stripe
template <bool kWide>
struct Lane {
  using PT = Path<kWide>;
  using S = typename PT::S;
  using Pos = typename PT::Pos;
  int H[2][kRows];           // H(i, j) of the last two steps, by parity
  S HS[2][kRows];
  int E[kRows], F[kRows];    // of the last step
  S ES[kRows], FS[kRows];
  int U[2];                  // row 0's up H of the last two steps
  S US[2];
  int C[2][kRows];           // r[j - 1] of this step and the next
  Entry<kWide> B[2];         // lane 0: border columns of the next steps
  int qc[kRows];             // q[i - 1] of each row
  int rb[kRows];             // each row's best this stripe
  Pos rpos[kRows];
  S rs[kRows];
};

// What a lane's steps read of its pair and stripe, and the stripe's
// hand-off to the next warp of the team
struct Pair {
  const uint8_t* r;
  void* own;  // the warp's border row, Entry<kWide>[m + 2], written
  void* top;  // the row it reads: the team's previous warp's
  volatile long long* done;  // border columns each warp has published
  long long wait_base;  // done[src] at column 0 of the top row; < 0: none
  long long pub_base;   // done[w] at column 0 of this stripe's last row
  int ql, rl, m, i1, tR, lane, w, src, avail, match, mismatch, go, ge;
};

// Publish the columns of this stripe's last row that lane 31 wrote in the
// steps before s (fence, then the count), for the team's next warp.
__device__ __forceinline__ void publish(const Pair& c, int s) {
  const int cols = min(max(s - kStripe + 1, 0), c.rl);
  __threadfence_block();
  if (c.lane == kLanes - 1) c.done[c.w] = c.pub_base + cols;
}

// Wait until the top row's columns 1..need are published.  A producer
// that stops for 2^36 clocks (~35 s) traps the kernel rather than hang.
__device__ __forceinline__ void wait_top(Pair& c, int need) {
  if (c.wait_base < 0 || need <= c.avail) return;
  const long long t0 = clock64();
  long long d;
  while ((d = c.done[c.src] - c.wait_base) < need) {
    if (clock64() - t0 > (1LL << 36)) __trap();
    __nanosleep(128);
  }
  c.avail = (int)min(d, (long long)c.rl);
  __threadfence_block();
}

// One step s of a lane, parity u = s & 1.  kMasked: cells outside the
// pair (j < 1, j > rlen, i > qlen) keep their row's state.
template <bool kWide, bool kMasked, int u>
__device__ __forceinline__ void step(Lane<kWide>& L, int s, const Pair& c) {
  using PT = Path<kWide>;
  using S = typename PT::S;
  using Pos = typename PT::Pos;
  constexpr int v = 1 - u;
  Entry<kWide>* top = static_cast<Entry<kWide>*>(c.top);
  // row 0's up: lane t-1's last row at the last step; the border for
  // lane 0
  int uh = shfl_up(L.H[v][kRows - 1]);
  int uf = shfl_up(L.F[kRows - 1]);
  S uhs = shfl_up(L.HS[v][kRows - 1]);
  S ufs = shfl_up(L.FS[kRows - 1]);
  if (c.lane == 0) {
    uh = L.B[u].h;
    uf = L.B[u].f;
    uhs = L.B[u].hs;
    ufs = L.B[u].fs;
    const int col = kMasked ? min(s + 3, c.m + 1) : s + 3;
    L.B[u] = top[col];
  }
  // r for the next step: row k reads r[s1 - k]
  const int s1 = s + 1 - c.tR;
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int x = kMasked ? min(max(s1 - k, 0), c.m - 1) : s1 - k;
    L.C[v][k] = c.r[x];
  }
  // rows last to first: row k reads row k-1's state before its update
#pragma unroll
  for (int k = kRows - 1; k >= 0; --k) {
    const int a = k > 0 ? k - 1 : 0;
    const int hu = k ? L.H[v][a] : uh;
    const int fu = k ? L.F[a] : uf;
    const S hsu = k ? L.HS[v][a] : uhs;
    const S fsu = k ? L.FS[a] : ufs;
    const int hd = k ? L.H[u][a] : L.U[v];
    const S hsd = k ? L.HS[u][a] : L.US[v];
    const int hl = L.H[v][k];
    const S hsl = L.HS[v][k];
    // E: gap along r, from (i, j-1); F: gap along q, from (i-1, j); both
    // extend on ties: __vibmax_s32(a, b, &p) is max(a, b) with p = a >= b
    bool pe, pf;
    const int e = __vibmax_s32(L.E[k] - c.ge, hl - c.go, &pe);
    const S es = PT::gap(PT::sel(pe, L.ES[k], hsl));
    const int f = __vibmax_s32(fu - c.ge, hu - c.go, &pf);
    const S fs = PT::gap(PT::sel(pf, fsu, hsu));
    // diag from (i-1, j-1); a path begins where that H is 0
    const bool mt = L.qc[k] == L.C[u][k];
    const int dg = hd + (mt ? c.match : c.mismatch);
    // the cell's position: packed (i << 16) + j, wide j (= s1 - k)
    Pos pos;
    if constexpr (kWide)
      pos = s1 - k;
    else
      pos = ((uint32_t)(c.i1 + k) << 16) + (uint32_t)(s1 - k);
    const S ds = PT::diag(hsd, hd, mt, c.i1 + k, pos);
    const int h = max(max(dg, 0), max(e, f));
    const S hs = PT::pick(h, dg, f, ds, fs, es);
    bool act = true;
    if (kMasked) {
      const int j = s1 - k;
      act = c.i1 + k <= c.ql && j >= 1 && j <= c.rl;
    }
    if (act) {
      L.H[u][k] = h;
      L.HS[u][k] = hs;
      L.E[k] = e;
      L.ES[k] = es;
      L.F[k] = f;
      L.FS[k] = fs;
      if (h > L.rb[k]) {
        L.rb[k] = h;
        L.rpos[k] = pos;
        L.rs[k] = hs;
      }
    } else {
      L.H[u][k] = hl;
      L.HS[u][k] = hsl;
    }
    // lane 31's last row goes down to the next stripe
    if (k == kRows - 1 && c.lane == kLanes - 1 && act)
      static_cast<Entry<kWide>*>(c.own)[s1 - k] =
          Entry<kWide>{h, f, hs, fs, {0, 0}};
  }
  L.U[u] = uh;
  L.US[u] = uhs;
}

template <bool kWide, bool kMasked>
__device__ __forceinline__ void two_steps(Lane<kWide>& L, int s,
                                          const Pair& c) {
  step<kWide, kMasked, 0>(L, s, c);
  step<kWide, kMasked, 1>(L, s + 1, c);
}

// Masked steps s and s + 1, after publishing every 32 steps and waiting
// for the top row's columns they read (up to s + 4)
template <bool kWide>
__device__ __forceinline__ void masked_steps(Lane<kWide>& L, int s,
                                             Pair& c) {
  if ((s & 31) == 0) publish(c, s);
  wait_top(c, min(s + 4, c.rl));
  two_steps<kWide, true>(L, s, c);
}

template <bool kWide>
__global__ void __launch_bounds__(kWarps * kLanes)
    sw_kernel(const uint8_t* __restrict__ q, int n,
              const uint8_t* __restrict__ r, int m,
              const int* __restrict__ qlen, const int* __restrict__ rlen,
              const int* __restrict__ order, int P, int match, int mismatch,
              int go, int ge, Entry<kWide>* border, int* next,
              int* __restrict__ out) {
  using PT = Path<kWide>;
  using S = typename PT::S;
  using Pos = typename PT::Pos;
  __shared__ int s_pair;
  __shared__ volatile long long s_done[kWarps];
  __shared__ int s_best[kWarps], s_i[kWarps];  // each warp's best
  __shared__ Pos s_pos[kWarps];
  __shared__ S s_stats[kWarps];
  const int lane = threadIdx.x % kLanes, w = threadIdx.x / kLanes;
  Pair c{};
  c.own = border + ((size_t)blockIdx.x * kWarps + w) * (m + 2);
  c.src = (w + kWarps - 1) % kWarps;
  c.top = border + ((size_t)blockIdx.x * kWarps + c.src) * (m + 2);
  c.done = s_done;
  c.m = m;
  c.tR = lane * kRows;
  c.lane = lane;
  c.w = w;
  c.match = match;
  c.mismatch = mismatch;
  c.go = go;
  c.ge = ge;
  const S zero{};
  for (;;) {
    if (threadIdx.x == 0) s_pair = atomicAdd(next, 1);
    if (threadIdx.x < kWarps) s_done[threadIdx.x] = 0;
    __syncthreads();
    const int idx = s_pair;
    if (idx >= P) break;
    const int p = order[idx];
    const int rl = min(max(rlen[p], 0), m);
    const int ql = rl ? min(max(qlen[p], 0), n) : 0;
    const uint8_t* qp = q + (size_t)p * n;
    c.r = r + (size_t)p * m;
    c.ql = ql;
    c.rl = rl;
    // the last warp's border row starts as the matrix's top boundary,
    // which warp 0 reads above the pair's first stripe
    if (w == kWarps - 1)
      for (int j = lane; j < rl + 2; j += kLanes)
        static_cast<Entry<kWide>*>(c.own)[j] =
            Entry<kWide>{0, kNeg, zero, zero, {0, 0}};
    __syncthreads();
    int lb = 0, li = INT_MAX;  // the lane's best: score, i, position
    Pos lpos = 0;
    S ls = zero;
    // warp w sweeps stripes w, w + kWarps, ...; its t-th stripe's top row
    // is the previous stripe's last row, the t-th (t - 1-th for warp 0) of
    // warp src, published in done[src] from column 0 at t' x rlen
    for (int i0 = w * kStripe, t = 0; i0 < ql;
         i0 += kWarps * kStripe, ++t) {
      Lane<kWide> L;
      c.i1 = i0 + c.tR + 1;
      c.wait_base = i0 == 0 ? -1 : (long long)(w ? t : t - 1) * rl;
      c.pub_base = (long long)t * rl;
      c.avail = 0;
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        L.qc[k] = c.i1 + k <= ql ? qp[c.i1 + k - 1] : 0;
        L.H[0][k] = L.H[1][k] = 0;
        L.HS[0][k] = L.HS[1][k] = zero;
        L.E[k] = L.F[k] = kNeg;
        L.ES[k] = L.FS[k] = zero;
        L.C[0][k] = c.r[min(max(-c.tR - k, 0), m - 1)];
        L.rb[k] = 0;
        L.rpos[k] = 0;
        L.rs[k] = zero;
      }
      L.U[0] = L.U[1] = 0;
      L.US[0] = L.US[1] = zero;
      wait_top(c, min(4, rl));
      if (lane == 0) {
        L.B[0] = static_cast<Entry<kWide>*>(c.top)[1];
        L.B[1] = static_cast<Entry<kWide>*>(c.top)[2];
      }
      const int rows = min(kStripe, ql - i0);
      const int total = rl + rows - 1;  // steps until the last row ends
      int s = 0;
      // fill: until lane 31's last row reaches column 1 (a whole stripe
      // of rows) or to the end
      for (const int lo = rows == kStripe ? kStripe : total; s < lo; s += 2)
        masked_steps(L, s, c);
      // steady: every cell of both steps inside the pair, and the next
      // step's r inside rlen; 32 steps at a time (s starts at kStripe, a
      // multiple of 32), the top row's columns waited for once for all
      while (s + 2 < rl) {
        publish(c, s);
        wait_top(c, min(s + 34, rl));
        for (const int e = s + 32; s < e && s + 2 < rl; s += 2)
          two_steps<kWide, false>(L, s, c);
      }
      for (; s < total; s += 2) masked_steps(L, s, c);
      publish(c, rl + kStripe);  // the whole row
      // the rows' bests into the lane's, in order of i
#pragma unroll
      for (int k = 0; k < kRows; ++k)
        if (L.rb[k] > lb) {
          lb = L.rb[k];
          li = c.i1 + k;
          lpos = L.rpos[k];
          ls = L.rs[k];
        }
    }
    // the warp's best, then the team's: the largest score, then the
    // smallest (i, j)
#pragma unroll
    for (int off = kLanes / 2; off; off >>= 1) {
      const int ob = __shfl_xor_sync(kAll, lb, off);
      const int oi = __shfl_xor_sync(kAll, li, off);
      const Pos opos = __shfl_xor_sync(kAll, lpos, off);
      S os;
      if constexpr (kWide)
        os = {__shfl_xor_sync(kAll, ls.m, off),
              __shfl_xor_sync(kAll, ls.l, off),
              __shfl_xor_sync(kAll, ls.q, off),
              __shfl_xor_sync(kAll, ls.r, off)};
      else
        os = {__shfl_xor_sync(kAll, ls.lm, off),
              __shfl_xor_sync(kAll, ls.qr, off)};
      if (ob > lb || (ob == lb && PT::earlier(oi, opos, li, lpos))) {
        lb = ob;
        li = oi;
        lpos = opos;
        ls = os;
      }
    }
    if (lane == 0) {
      s_best[w] = lb;
      s_i[w] = li;
      s_pos[w] = lpos;
      s_stats[w] = ls;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int v = 1; v < kWarps; ++v)
        if (s_best[v] > lb ||
            (s_best[v] == lb && PT::earlier(s_i[v], s_pos[v], li, lpos))) {
          lb = s_best[v];
          li = s_i[v];
          lpos = s_pos[v];
          ls = s_stats[v];
        }
      int o[8] = {0, -1, -1, 0, 0, 0, 0, 0};
      if (lb > 0) {
        o[0] = lb;
        PT::decode(li, lpos, ls, o);
      }
      for (int k = 0; k < 8; ++k) out[(size_t)k * P + p] = o[k];
    }
  }
}

template <bool kWide>
cudaError_t launch(const void* q, int n, const void* r, int m,
                   const void* qlen, const void* rlen, const void* order,
                   int P, int match, int mismatch, int go, int ge, int grid,
                   void* border, void* next, void* out, cudaStream_t stream) {
  sw_kernel<kWide><<<grid, kWarps * kLanes, 0, stream>>>(
      (const uint8_t*)q, n, (const uint8_t*)r, m, (const int*)qlen,
      (const int*)rlen, (const int*)order, P, match, mismatch, go, ge,
      (Entry<kWide>*)border, (int*)next, (int*)out);
  return cudaGetLastError();
}

template <bool kWide>
cudaError_t occupancy(int* info) {
  int dev = 0, per_sm = 0, sms = 0;
  cudaFuncAttributes a;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, sw_kernel<kWide>, kWarps * kLanes, 0);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&a, sw_kernel<kWide>);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  info[0] = a.numRegs;
  info[1] = (int)a.localSizeBytes;
  info[2] = per_sm;
  info[3] = sms;
  info[4] = (int)sizeof(Entry<kWide>);
  return cudaSuccess;
}

}  // namespace

extern "C" {

// q: [P, n] uint8, r: [P, m] uint8, qlen, rlen: [P] int32 (clamped to
// [0, n] and [0, m]); order: [P] int32, the pairs in the order the warps
// take them; wide: 0 for the two-word stats, 1 for the 32-bit ones, as
// the wrapper's packed_stats chooses (two words only where every field
// fits 16 bits and no gap penalty is negative); grid: blocks of
// kWarps warps; border: grid x kWarps x (m + 2) entries of scratch (32
// bytes each, 48 wide); next: one int32, 0 at the launch; out: [8, P]
// int32 in the order score, q_end, r_end, q_begin, r_begin, matches,
// errors, length.
int mhap_sw_align_batch(const void* q, int n, const void* r, int m,
                        const void* qlen, const void* rlen, const void* order,
                        int P, int match, int mismatch, int gap_open,
                        int gap_extend, int wide, int grid, void* border,
                        void* next, void* out, void* stream) {
  if (P <= 0) return (int)cudaSuccess;
  if (grid < 1 || n < 0 || m < 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)(wide ? launch<true>(q, n, r, m, qlen, rlen, order, P, match,
                                   mismatch, gap_open, gap_extend, grid,
                                   border, next, out, s)
                    : launch<false>(q, n, r, m, qlen, rlen, order, P, match,
                                    mismatch, gap_open, gap_extend, grid,
                                    border, next, out, s));
}

// info: registers a thread, local (spill) bytes a thread, resident blocks
// an SM, SMs, bytes a border column
int mhap_sw_align_occupancy(int wide, int* info) {
  return (int)(wide ? occupancy<true>(info) : occupancy<false>(info));
}

}  // extern "C"

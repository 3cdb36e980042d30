// Stage-2 pair scorer for Hopper (sm_90a): BottomOverlapSketch's
// getOverlapInfo with every stage spread over the threads of the block.
//
// Replaces score_pairs_pallas (mhap_tpu/ops/scorer_pallas.py:471, body
// _make_kernel :118).  The TPU kernel vectorised the merge automaton into
// sort networks and bounded scans and flagged the lanes its scan model
// could not reproduce (`escal`) for two slower rescoring rungs.  This
// kernel computes exactly what native/scorer.h does (get_overlap_info
// :214, record_matching_kmers :134, MatchData :33-132, bottom_k_jaccard
// :183) on every lane, so `escal` is always 0.
//
// What bounds it on the H100: per pair, the 24 KB read of the two
// S = 1536 (hash, pos) rows (each distinct store row comes from device
// memory once; repeats hit L2), then shared-memory work: a merge of the
// two rows, short automata, a few radix-select sweeps and ~40 block
// barriers.  The instruction throughput of that work (the kernel's bound
// counts its operations), with six pairs resident per SM to hide latency.
//
// Design: one block of 256 threads per pair; the block copies its rows
// from the store's [N, S] columns by the qi/ci index arrays with
// asynchronous copies.  Stages:
//  1. Run pairs: a merge path over A's and B's hashes (A first on equal
//     hashes; each thread merges its diagonal slice) puts B's cursor at
//     lower_bound(B, v) as A's entry v is taken.  It keeps, for each run
//     of equal hashes in A that B shares, the start of B's run (`partner`,
//     for both passes) and counts the shared entries (n_shared).
//  2. recordMatchingKmers, both passes, as one automaton per run pair.
//     The automaton only advances a cursor past an entry whose hash the
//     other side lacks, and a record's cursor extension stops at the end
//     of its hash run, so its state on reaching a hash never depends on
//     any other hash: a pass equals the concatenation, in hash order, of
//     the same automaton run on each pair of same-hash runs.  Each thread
//     runs the run pairs that start in its chunk of A; runs of any length
//     stay exact, since the thread walks them.  A run pair of lengths
//     (a, b) at (s1, s2) makes at most floor(2 (a + b) / 3) records (a
//     record step consumes two entries for one record or at least three
//     for two), so it writes them from slot floor(2 (s1 + s2) / 3) on:
//     the slot ranges are disjoint, in hash order, below floor(2 (m1 +
//     m2) / 3).  A compaction (each thread holds 9 slots in registers
//     across a block prefix sum) then packs them in hash order.
//  3. Upper medians (Utils.quickSelect at count/2) by radix select of
//     shift - (least shift), 8 bits a pass from the top digit of the
//     shifts' range, in a 256-bin shared histogram.
//  4. optimizeShifts as a segmented arg-min over runs of adjacent equal
//     pos1 (a block scan of (run start, min (|shift - median|, index))),
//     segmented on pos1 over the whole record list, since such runs can
//     span hashes; then the same compaction to the kept records.
//  5. UMVU edges from block min/max/count reductions, with Java's int32
//     wrap of the numerator and half-up rounding.
//  6. The windowed bottom-k Jaccard in closed form: a hash value with
//     in-window multiplicities c1, c2 spends max(c1, c2) union steps, the
//     first min(c1, c2) of them intersections, and counts
//     min(max(k - U, 0), min(c1, c2)), U the steps of smaller values =
//     #f1 < v + #f2 < v - (prefix sum of min(c1, c2) over smaller values).
//     The in-window entries are compacted (ballot words and their prefix
//     counts), the ranks come from galloping searches, the prefix from a
//     block scan.
// Lanes that do not score (ok = 0) still run every stage, with an empty
// record set taking the median 0x7FFFFFFF, so all 16 output columns equal
// the plain version's (ops/scorer.py score_pairs_ref) on every lane.
// Compiled with --fmad=false; (int)(overlap * max_shift) is the plain
// IEEE double product of the Java reference.
//
// Scratch per block, S entries a side: the four [S] row arrays;
// [floor(4S / 3)] record slots of (A index, B index); the [S] partner
// indices, whose bytes become the keep flags of optimizeShifts; and, in
// static shared memory, a 256-bin histogram and scan scratch (1,392 B).
// Two paths share every stage (score_pair):
//  * shared memory (score_pairs_kernel), 16-bit indices (a record is
//    one 32-bit word): 36.4 KB at S = 1536, so 6 blocks (48 warps) fit
//    on an SM.  It runs while S <= 65,535 and the footprint fits the
//    card's opt-in shared memory a block
//    (cudaDevAttrMaxSharedMemoryPerBlockOptin, less the static part):
//    on the H100, S up to about 9,900.
//  * device memory (score_pairs_wide_kernel) above that: the same
//    scratch in a workspace the wrapper allocates, one slice a block,
//    with 32-bit indices (a record is a 64-bit word), so any S up to
//    kMaxS.  The grid is the card's resident blocks (or fewer), each
//    looping over pairs.  Asynchronous copies can only write shared
//    memory, so this path copies its rows with plain loads.
// kNone and kEmpty (all ones) stay out of the index range, since indices
// are < S; kMaxS keeps every index and offset within a slice an int.

#include <algorithm>
#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 6;  // per SM, what the shared memory allows
constexpr int kCols = 16;
constexpr int IMAX = 0x7FFFFFFF;
constexpr int kMaxNarrowS = 0xFFFF;  // 16-bit record and partner indices
constexpr int kMaxS = 0x7FFFFFFF / 8;  // the workspace slice's int offsets
constexpr int kPer = 9;  // words a thread holds in one round of compaction
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr unsigned long long kNoKey = ~0ull;

__device__ __forceinline__ int w32(long long x) {
  return (int)(unsigned)(unsigned long long)x;
}

__device__ __forceinline__ int floor_div(int a, int b) {  // b > 0
  int q = a / b;
  if ((a % b != 0) && (a < 0)) --q;
  return q;
}

__device__ __forceinline__ int abs_max_of(int median, int nk1, int nk2,
                                          double max_shift) {
  const int left = max(0, w32(-(long long)median));
  const int right = min(nk1, w32((long long)nk2 - median));
  const int overlap = max(10, w32((long long)right - left));
  return min(max(nk1, nk2), (int)((double)overlap * max_shift));
}

// One recordMatchingKmers pass's parameters and position windows.
struct Pass {
  int med, am, v1l, v1u, v2l, v2u;
};

__device__ __forceinline__ Pass pass_of(int med, int am, int nk1, int nk2) {
  return Pass{med,
              am,
              max(0, w32(-(long long)med - am)),
              min(nk1, w32((long long)nk2 - med + am)),
              max(0, w32((long long)med - am)),
              min(nk2, w32((long long)nk1 + med + am))};
}

// The first index >= j of sorted a[0, hi) whose value is >= v (> v when
// kUpper), for a j at or below it: galloping steps from j, then a binary
// search, so a cursor that moves a little pays a few loads.
template <bool kUpper>
__device__ __forceinline__ int gallop(const int* a, int j, int hi, int v) {
  auto before = [v](int x) { return kUpper ? x <= v : x < v; };
  if (j >= hi || !before(a[j])) return j;
  int lo = j, step = 1;
  while (lo + step < hi && before(a[lo + step])) {
    lo += step;
    step <<= 1;
  }
  int l = lo + 1, h = min(lo + step, hi);
  while (l < h) {
    const int mid = (l + h) >> 1;
    if (before(a[mid]))
      l = mid + 1;
    else
      h = mid;
  }
  return l;
}

// This thread's contiguous chunk [lo, hi) of n items, in thread order.
// The chunk length is odd, so a warp's threads start on distinct banks.
__device__ __forceinline__ void chunk_of(int n, int& lo, int& hi) {
  const int c = ((n + kThreads - 1) / kThreads) | 1;
  lo = min(n, (int)threadIdx.x * c);
  hi = min(n, lo + c);
}

struct Scratch {
  int hist[256];  // zero between radix passes
  int wsum[kWarps];
  int wflag[kWarps];
  unsigned long long wmin[kWarps];
  int red[5][kWarps];
  int shift_lo[kWarps], shift_hi[kWarps];
  int sel[2];
};

// Exclusive prefix sum of v over the block's threads in thread order;
// *total gets the sum.  Every thread must call it.
__device__ int block_excl_sum(int v, int* total, Scratch& s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += o;
  }
  if (lane == 31) s.wsum[warp] = x;
  __syncthreads();
  int before = 0, tot = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int c = s.wsum[w];
    if (w < warp) before += c;
    tot += c;
  }
  __syncthreads();  // wsum is reused by the next call
  *total = tot;
  return before + x - v;
}

__device__ __forceinline__ int block_sum(int v, Scratch& s) {
  int tot;
  block_excl_sum(v, &tot, s);
  return tot;
}

// Segmented minimum: f marks a segment start; (a, b) -> b's segment
// restarts at b when b holds a start.
struct Seg {
  int f;
  unsigned long long v;
};

__device__ __forceinline__ Seg seg_op(Seg a, Seg b) {
  return Seg{a.f | b.f, b.f ? b.v : min(a.v, b.v)};
}

__device__ Seg block_excl_segmin(Seg x, Scratch& s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  Seg inc = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const Seg o{__shfl_up_sync(kFull, inc.f, d),
                __shfl_up_sync(kFull, inc.v, d)};
    if (lane >= d) inc = seg_op(o, inc);
  }
  Seg ex{__shfl_up_sync(kFull, inc.f, 1), __shfl_up_sync(kFull, inc.v, 1)};
  if (lane == 0) ex = Seg{0, kNoKey};
  if (lane == 31) {
    s.wflag[warp] = inc.f;
    s.wmin[warp] = inc.v;
  }
  __syncthreads();
  Seg pre{0, kNoKey};
  for (int w = 0; w < warp; ++w) pre = seg_op(pre, Seg{s.wflag[w], s.wmin[w]});
  __syncthreads();
  return seg_op(pre, ex);
}

// A record packs (A index, B index) into the two halves of a Rec word:
// 16-bit halves of an unsigned on the shared-memory path, 32-bit halves
// of an unsigned long long on the device-memory path.  Partners are
// unsigned short or unsigned.  The all-ones word and index are "none".
template <typename Rec>
__device__ __forceinline__ int rec_a(Rec r) {
  return (int)(r >> (sizeof(Rec) * 4));
}
template <typename Rec>
__device__ __forceinline__ int rec_b(Rec r) {
  return (int)(r & ((Rec(1) << (sizeof(Rec) * 4)) - 1));
}
template <typename Rec>
__device__ __forceinline__ Rec rec_of(int a, int b) {
  return (Rec)(unsigned)a << (sizeof(Rec) * 4) | (Rec)(unsigned)b;
}
template <typename T>
__device__ __forceinline__ T none_of() {
  return (T)~T(0);  // kEmpty for a record slot, kNone for a partner
}

template <typename Rec>
__device__ __forceinline__ int shift_of(const Rec* rec, int i, const int* ap,
                                        const int* bp) {
  const Rec r = rec[i];
  return bp[rec_b(r)] - ap[rec_a(r)];
}

// Upper median (Utils.quickSelect at count/2) of the record shifts
// bp[b] - ap[a], i < cnt; 0x7FFFFFFF when cnt == 0.  Radix select on
// shift - (least shift) as unsigned (which keeps the order), 8 bits a
// pass, from the digit of the highest bit of the shifts' range (block
// min and max); warp 0 finds the bin holding rank k and clears the
// histogram for the next pass.
template <typename Rec>
__device__ int block_median(const Rec* rec, int cnt, const int* ap,
                            const int* bp, Scratch& s) {
  if (cnt == 0) return IMAX;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int lo = IMAX, hi = -IMAX - 1;
  for (int i = tid; i < cnt; i += kThreads) {
    const int x = shift_of(rec, i, ap, bp);
    lo = min(lo, x);
    hi = max(hi, x);
  }
  lo = __reduce_min_sync(kFull, lo);
  hi = __reduce_max_sync(kFull, hi);
  if (lane == 0) {
    s.shift_lo[warp] = lo;
    s.shift_hi[warp] = hi;
  }
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    lo = min(lo, s.shift_lo[w]);
    hi = max(hi, s.shift_hi[w]);
  }
  const unsigned range = (unsigned)hi - (unsigned)lo;
  if (range == 0) return lo;  // all shifts equal
  unsigned prefix = 0;
  int k = cnt / 2;
  for (int d = (31 - __clz(range)) / 8 * 8; d >= 0; d -= 8) {
    const unsigned high = d == 24 ? 0u : kFull << (d + 8);
    for (int i = tid; i < cnt; i += kThreads) {
      const unsigned key = (unsigned)shift_of(rec, i, ap, bp) - (unsigned)lo;
      if ((key & high) == prefix) atomicAdd(&s.hist[(key >> d) & 255], 1);
    }
    __syncthreads();
    if (tid < 32) {
      int c[8], sum = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        c[j] = s.hist[lane * 8 + j];
        s.hist[lane * 8 + j] = 0;
        sum += c[j];
      }
      int inc = sum;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, inc, o);
        if (lane >= o) inc += y;
      }
      int acc = inc - sum;
      if (acc <= k && k < inc) {  // one lane: rank k lies in its bins
        int bin = -1;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (bin < 0 && acc + c[j] > k)
            bin = j;
          else if (bin < 0)
            acc += c[j];
        }
        s.sel[0] = lane * 8 + bin;
        s.sel[1] = k - acc;
      }
    }
    __syncthreads();
    prefix |= (unsigned)s.sel[0] << d;
    k = s.sel[1];
  }
  return (int)((unsigned)lo + prefix);
}

// Smem views of one pair.
struct Rows {
  int *ah, *ap, *bh, *bp;
  int m1, m2;
};

// recordMatchingKmers on one pair of same-hash runs, A's from s1 and B's
// from s2: native/scorer.h's automaton with both cursors kept inside the
// runs (equal hashes, so only the window and shift tests remain).
template <typename Rec>
__device__ void run_pair(const Rows& R, int s1, int s2, const Pass& q,
                         Rec* out) {
  const int v = R.ah[s1];
  int i1 = s1, i2 = s2, n = 0;
  while (i1 < R.m1 && i2 < R.m2 && R.ah[i1] == v && R.bh[i2] == v) {
    const int p1 = R.ap[i1], p2 = R.bp[i2];
    if (p1 < q.v1l || p1 >= q.v1u) {
      ++i1;
    } else if (p2 < q.v2l || p2 >= q.v2u) {
      ++i2;
    } else {
      const long long diff = (long long)(p2 - p1) - q.med;
      if (diff > q.am) {
        ++i1;
      } else if (diff < -(long long)q.am) {
        ++i2;
      } else {
        out[n] = rec_of<Rec>(i1, i2);
        ++n;
        // extend both cursors over the same-hash run with valid positions
        int e1 = i1;
        while (e1 + 1 < R.m1 && R.ah[e1 + 1] == v && R.ap[e1 + 1] >= q.v1l &&
               R.ap[e1 + 1] < q.v1u)
          ++e1;
        int e2 = i2;
        while (e2 + 1 < R.m2 && R.bh[e2 + 1] == v && R.bp[e2 + 1] >= q.v2l &&
               R.bp[e2 + 1] < q.v2u)
          ++e2;
        if (e1 != i1 || e2 != i2) {
          out[n] = rec_of<Rec>(e1, e2);
          ++n;
        }
        i1 = e1 + 1;
        i2 = e2 + 1;
      }
    }
  }
}

// The first slot of the records of the run pair at (s1, s2).  A run pair
// of lengths (a, b) makes at most floor(2 (a + b) / 3) records and the
// next one starts at or past (s1 + a, s2 + b), so these slot ranges are
// disjoint and lie below floor(2 (m1 + m2) / 3).
__device__ __forceinline__ int slot_of(int s1, int s2) {
  return 2 * (s1 + s2) / 3;
}

// Stable in-place compaction of the words of rec[0, n) that are not
// empty (and have keep[i], when keep is given) to rec[0, count); returns
// the count to every thread.  Each thread holds a chunk of kPer words in
// registers (odd, so a warp's threads start on distinct banks) across
// the prefix sum's barriers, so every read precedes every write.
template <typename Rec>
__device__ int compact_slots(Rec* rec, int n, const unsigned char* keep,
                             Scratch& s) {
  const Rec kEmpty = none_of<Rec>();
  int total = 0;
  for (int base = 0; base < n; base += kThreads * kPer) {
    const int lo = base + threadIdx.x * kPer;
    Rec v[kPer];
    int c = 0;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int i = lo + k;
      v[k] = i < n && (keep == nullptr || keep[i]) ? rec[i] : kEmpty;
      c += v[k] != kEmpty;
    }
    int tot;
    int off = total + block_excl_sum(c, &tot, s);
#pragma unroll
    for (int k = 0; k < kPer; ++k)
      if (v[k] != kEmpty) rec[off++] = v[k];
    total += tot;
    __syncthreads();  // this round's writes precede the next one's reads
  }
  return total;
}

// One recordMatchingKmers pass: each run pair writes its records to its
// own slots (slot_of; the others stay empty), then the slots are
// compacted, which leaves the records in hash order.  Returns the count
// to every thread.
template <typename Rec, typename Part>
__device__ int merge_pass(const Rows& R, const Part* partner, const Pass& q,
                          Rec* rec, Scratch& s) {
  const int span = 2 * (R.m1 + R.m2) / 3;
  for (int i = threadIdx.x; i < span; i += kThreads) rec[i] = none_of<Rec>();
  __syncthreads();
  int lo, hi;
  chunk_of(R.m1, lo, hi);
  for (int i = lo; i < hi; ++i)
    if (partner[i] != none_of<Part>())
      run_pair(R, i, partner[i], q, rec + slot_of(i, partner[i]));
  __syncthreads();
  return compact_slots(rec, span, nullptr, s);
}

// (|shift - median|, index): the least is the record optimizeShifts
// keeps.  Shifts and the median lie in (-2^31, 2^31), so |d| < 2^32.
template <typename Rec>
__device__ __forceinline__ unsigned long long shift_key(const Rows& R, Rec r,
                                                        int med, int i) {
  const long long d = (long long)(R.bp[rec_b(r)] - R.ap[rec_a(r)]) - med;
  return (unsigned long long)(d < 0 ? -d : d) << 32 | (unsigned)i;
}

// optimizeShifts: per run of adjacent equal pos1 keep the first record
// with the least |shift - median|.  Returns the kept count.
template <typename Rec>
__device__ int optimize_shifts(const Rows& R, Rec* rec, int cnt, int med,
                               unsigned char* keep, Scratch& s) {
  for (int i = threadIdx.x; i < cnt; i += kThreads) keep[i] = 0;
  int lo, hi;
  chunk_of(cnt, lo, hi);
  auto starts = [&](int i) {
    return i == 0 || R.ap[rec_a(rec[i])] != R.ap[rec_a(rec[i - 1])];
  };
  Seg agg{0, kNoKey};
  for (int i = lo; i < hi; ++i)
    agg = seg_op(agg, Seg{starts(i), shift_key(R, rec[i], med, i)});
  Seg run = block_excl_segmin(agg, s);  // its barriers order the clearing
  for (int i = lo; i < hi; ++i) {
    run = seg_op(run, Seg{starts(i), shift_key(R, rec[i], med, i)});
    if (i == cnt - 1 || starts(i + 1)) keep[run.v & 0xFFFFFFFFu] = 1;
  }
  __syncthreads();
  return compact_slots(rec, cnt, keep, s);
}

// The store columns and pair indices of one launch.
struct Pairs {
  const int *q_oh, *q_op, *q_om, *q_nk, *c_oh, *c_op, *c_om, *c_nk, *qi, *ci;
};

// Scores pair t with the block's scratch at `scratch` ([4S] ints of rows,
// then [R_cap] records, then [S] partners): shared memory, whose rows
// arrive by asynchronous copies (kAsync), or a device-memory slice, whose
// rows arrive by plain loads.
template <typename Rec, typename Part, bool kAsync>
__device__ void score_pair(const Pairs& P, size_t t, int S, int R_cap,
                           double max_shift, int* scratch, Scratch& s,
                           int* __restrict__ out) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t qa = (size_t)P.qi[t], cb = (size_t)P.ci[t];
  const int nk1 = P.q_nk[qa], nk2 = P.c_nk[cb];
  Rows R{scratch,         scratch + S,     scratch + 2 * S,
         scratch + 3 * S, P.q_om[qa],      P.c_om[cb]};
  Rec* rec = (Rec*)(scratch + 4 * S);      // [R_cap]
  Part* partner = (Part*)(rec + R_cap);    // [S]
  unsigned char* keep = (unsigned char*)partner;  // after pass 2
  const Part kNone = none_of<Part>();

  const int* gah = P.q_oh + qa * S;
  const int* gap = P.q_op + qa * S;
  const int* gbh = P.c_oh + cb * S;
  const int* gbp = P.c_op + cb * S;
  if (kAsync) {  // asynchronous copies, all in flight at once
    for (int i = tid; i < R.m1; i += kThreads) {
      __pipeline_memcpy_async(R.ah + i, gah + i, sizeof(int));
      __pipeline_memcpy_async(R.ap + i, gap + i, sizeof(int));
    }
    for (int i = tid; i < R.m2; i += kThreads) {
      __pipeline_memcpy_async(R.bh + i, gbh + i, sizeof(int));
      __pipeline_memcpy_async(R.bp + i, gbp + i, sizeof(int));
    }
    __pipeline_commit();
  } else {
    for (int i = tid; i < R.m1; i += kThreads) {
      R.ah[i] = gah[i];
      R.ap[i] = gap[i];
    }
    for (int i = tid; i < R.m2; i += kThreads) {
      R.bh[i] = gbh[i];
      R.bp[i] = gbp[i];
    }
  }
  for (int i = tid; i < 256; i += kThreads) s.hist[i] = 0;
  if (kAsync) __pipeline_wait_prior(0);
  __syncthreads();

  // ---- run pairs: a merge path over A and B, A first on equal hashes,
  // so B's cursor stands at lower_bound(B, v) when A's entry v is taken ----
  int n_sh = 0;
  {
    const int m = R.m1 + R.m2, per = (m + kThreads - 1) / kThreads;
    const int d0 = min(m, tid * per), d1 = min(m, d0 + per);
    int i = max(0, d0 - R.m2), hi = min(d0, R.m1);
    while (i < hi) {  // how many of the first d0 merged entries are A's
      const int mid = (i + hi) >> 1;
      if (R.ah[mid] <= R.bh[d0 - 1 - mid])
        i = mid + 1;
      else
        hi = mid;
    }
    int j = d0 - i;
    for (int d = d0; d < d1; ++d) {
      if (j >= R.m2 || (i < R.m1 && R.ah[i] <= R.bh[j])) {
        const int v = R.ah[i];
        const bool found = j < R.m2 && R.bh[j] == v;
        n_sh += found;
        partner[i] = found && (i == 0 || R.ah[i - 1] != v) ? j : kNone;
        ++i;
      } else {
        n_sh += i > 0 && R.ah[i - 1] == R.bh[j];
        ++j;
      }
    }
  }
  const int n_shared = block_sum(n_sh, s);  // its barriers publish partner

  // ---- pass 1: unconstrained windows; pass 2 around its median ----
  const int am0 = w32((long long)max(nk1, nk2) + 1);
  const int cnt1 = merge_pass(R, partner, pass_of(0, am0, nk1, nk2), rec, s);
  const int med1 = block_median(rec, cnt1, R.ap, R.bp, s);
  const int am1 = abs_max_of(med1, nk1, nk2, max_shift);
  const int cnt2 =
      merge_pass(R, partner, pass_of(med1, am1, nk1, nk2), rec, s);
  const int med2 = block_median(rec, cnt2, R.ap, R.bp, s);
  const int cnt3 = optimize_shifts(R, rec, cnt2, med2, keep, s);
  const int med3 = block_median(rec, cnt3, R.ap, R.bp, s);
  const int am3 = abs_max_of(med3, nk1, nk2, max_shift);

  // ---- UMVU edges ----
  int l1 = IMAX, l2 = IMAX, u1 = -IMAX, u2 = -IMAX, nv = 0;
  for (int i = tid; i < cnt3; i += kThreads) {
    const int r1 = R.ap[rec_a(rec[i])], r2 = R.bp[rec_b(rec[i])];
    if (llabs((long long)(r2 - r1) - med3) > am3) continue;
    l1 = min(l1, r1);
    l2 = min(l2, r2);
    u1 = max(u1, r1);
    u2 = max(u2, r2);
    ++nv;
  }
  l1 = __reduce_min_sync(kFull, l1);
  l2 = __reduce_min_sync(kFull, l2);
  u1 = __reduce_max_sync(kFull, u1);
  u2 = __reduce_max_sync(kFull, u2);
  nv = __reduce_add_sync(kFull, nv);
  if (lane == 0) {
    s.red[0][warp] = l1;
    s.red[1][warp] = l2;
    s.red[2][warp] = u1;
    s.red[3][warp] = u2;
    s.red[4][warp] = nv;
  }
  __syncthreads();  // also: every read of rec and of the positions is done
  int nrec = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    l1 = min(l1, s.red[0][w]);
    l2 = min(l2, s.red[1][w]);
    u1 = max(u1, s.red[2][w]);
    u2 = max(u2, s.red[3][w]);
    nrec += s.red[4][w];
  }
  const int den = max(nrec - 1, 1);
  // Java: (int)(n*lo - hi) wraps in int32 before Math.round of the
  // quotient; round-half-up of num/den is q + (2 rem >= den)
  auto umvu = [nrec, den](int lo, int hi) {
    const int num = w32((long long)nrec * lo - hi);
    const int q = floor_div(num, den);
    const int rem = num - q * den;
    return q + (2 * rem >= den ? 1 : 0);
  };
  const int a1 = max(0, umvu(l1, u1)), a2 = min(nk1, umvu(u1, l1));
  const int b1 = max(0, umvu(l2, u2)), b2 = min(nk2, umvu(u2, l2));

  // ---- windowed bottom-k Jaccard ----
  // in-window flags as ballot words, their prefix counts, then the
  // in-window hashes f1, f2 compacted into the position arrays
  const int W = (max(R.m1, R.m2) + 31) / 32;
  unsigned* wa = (unsigned*)rec;
  unsigned* wb = wa + W;
  int* pa = (int*)(wb + W);
  int* pb = pa + W;
  for (int base = 0; base < W * 32; base += kThreads) {
    const int i = base + tid;
    const bool fa = i < R.m1 && R.ap[i] >= a1 && R.ap[i] <= a2;
    const bool fb = i < R.m2 && R.bp[i] >= b1 && R.bp[i] <= b2;
    const unsigned ba = __ballot_sync(kFull, fa);
    const unsigned bb = __ballot_sync(kFull, fb);
    if (lane == 0 && i < W * 32) {
      wa[i >> 5] = ba;
      wb[i >> 5] = bb;
    }
  }
  __syncthreads();
  if (warp < 2) {  // warp 0 scans A's words, warp 1 B's
    const unsigned* w = warp ? wb : wa;
    int* p = warp ? pb : pa;
    const int per = (W + 31) / 32;
    const int lo = min(W, lane * per), hi = min(W, lo + per);
    int sum = 0;
    for (int j = lo; j < hi; ++j) sum += __popc(w[j]);
    int inc = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, inc, o);
      if (lane >= o) inc += y;
    }
    int ex = inc - sum;
    for (int j = lo; j < hi; ++j) {
      p[j] = ex;
      ex += __popc(w[j]);
    }
    if (lane == 31) s.sel[warp] = inc;
  }
  __syncthreads();
  const int F1 = s.sel[0], F2 = s.sel[1];
  for (int i = tid; i < W * 32; i += kThreads) {
    const unsigned below = (1u << (i & 31)) - 1u;
    if (wa[i >> 5] >> (i & 31) & 1u)
      R.ap[pa[i >> 5] + __popc(wa[i >> 5] & below)] = R.ah[i];
    if (wb[i >> 5] >> (i & 31) & 1u)
      R.bp[pb[i >> 5] + __popc(wb[i >> 5] & below)] = R.bh[i];
  }
  __syncthreads();
  const int* f1 = R.ap;
  const int* f2 = R.bp;
  int* mn_of = R.ah;  // per f1 run start: min(c1, c2), and #f2 < v
  int* lb_of = R.bh;
  const int k = min(F1, F2);
  int lo, hi;
  chunk_of(F1, lo, hi);
  int msum = 0;
  int lb2 = 0;  // f2's cursor
  for (int j = lo; j < hi; ++j) {
    const int v = f1[j];
    int mn = 0;
    if (j == 0 || f1[j - 1] != v) {
      lb2 = gallop<false>(f2, lb2, F2, v);
      if (lb2 < F2 && f2[lb2] == v)
        mn = min(gallop<true>(f1, j, F1, v) - j,
                 gallop<true>(f2, lb2, F2, v) - lb2);
    }
    mn_of[j] = mn;
    lb_of[j] = lb2;
    msum += mn;
  }
  int mtot;
  int M = block_excl_sum(msum, &mtot, s);
  int part = 0;
  for (int j = lo; j < hi; ++j) {
    const int mn = mn_of[j];
    if (mn == 0) continue;
    const int U = j + lb_of[j] - M;
    part += min(max(k - U, 0), mn);
    M += mn;
  }
  const int inter = block_sum(part, s);

  if (tid < kCols) {
    const int ok = cnt1 > 0 && cnt2 > 0 && cnt3 > 0 && nrec >= 3;
    // escal (8) is 0: the kernel is exact on every lane
    const int col[kCols] = {ok,   inter, k,    nrec, a1,       a2, b1, b2,
                            0,    cnt1,  cnt2, cnt3, n_shared, 0,  0,  0};
    out[t * kCols + tid] = col[tid];
  }
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
    score_pairs_kernel(Pairs P, int S, int R_cap, double max_shift,
                       int* __restrict__ out) {
  extern __shared__ int smem[];
  __shared__ Scratch s;
  score_pair<unsigned, unsigned short, true>(P, blockIdx.x, S, R_cap,
                                             max_shift, smem, s, out);
}

// The device-memory path: block b keeps its scratch at ws + b * footprint
// and scores pairs b, b + gridDim.x, ...
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    score_pairs_wide_kernel(Pairs P, int T, int S, int R_cap,
                            size_t footprint, double max_shift,
                            unsigned char* __restrict__ ws,
                            int* __restrict__ out) {
  __shared__ Scratch s;
  int* scratch = (int*)(ws + blockIdx.x * footprint);
  for (size_t t = blockIdx.x; t < (size_t)T; t += gridDim.x) {
    score_pair<unsigned long long, unsigned, false>(P, t, S, R_cap,
                                                     max_shift, scratch, s,
                                                     out);
    __syncthreads();  // this pair's reads precede the next one's writes
  }
}

// Scratch bytes a block at sketch size S, records of rec_bytes and
// partners of part_bytes each.  Records, and the Jaccard's 4 words per 32
// entries, share [R_cap]; the keep flags reuse the partners' bytes.
size_t footprint(int S, size_t rec_bytes, size_t part_bytes, int* R_cap) {
  *R_cap = std::max(4 * S / 3, 4 * ((S + 31) / 32));
  const size_t flags = std::max(part_bytes * S, (size_t)*R_cap);
  return (size_t)4 * S * sizeof(int) + (size_t)*R_cap * rec_bytes +
         (flags + 3) / 4 * 4;
}

size_t smem_bytes(int S, int* R_cap) {
  return footprint(S, sizeof(unsigned), sizeof(unsigned short), R_cap);
}

// A device-memory slice, rounded so that every slice stays aligned.
size_t wide_bytes(int S, int* R_cap) {
  const size_t b = footprint(S, sizeof(unsigned long long), sizeof(unsigned),
                             R_cap);
  return (b + 255) / 256 * 256;
}

// Does the shared-memory kernel take S on this card?  It needs 16-bit
// indices and its footprint within the opt-in limit less its static part.
cudaError_t fits_shared(int S, bool* fits) {
  *fits = false;
  if (S > kMaxNarrowS) return cudaSuccess;
  int dev, optin;
  cudaFuncAttributes a;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&a, score_pairs_kernel);
  int R_cap;
  if (e == cudaSuccess)
    *fits = smem_bytes(S, &R_cap) + a.sharedSizeBytes <= (size_t)optin;
  return e;
}

cudaError_t prepare_shared(size_t smem) {
  cudaError_t e = cudaFuncSetAttribute(
      score_pairs_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      (int)cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess && smem > 48 * 1024)
    e = cudaFuncSetAttribute(score_pairs_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  return e;
}

}  // namespace

extern "C" {

// Store columns: oh/op [N, S] int32, om/nk [N] int32 for the query (q_*)
// and candidate (c_*) stores; qi/ci [T] int32 row indices; out [T, 16].
// ws null: the shared-memory kernel, one block a pair (S must fit it, see
// mhap_score_pairs_plan).  Otherwise the device-memory kernel on `grid`
// blocks, ws holding grid * (mhap_score_pairs_plan's info[1]) bytes.
int mhap_score_pairs(const void* q_oh, const void* q_op, const void* q_om,
                     const void* q_nk, const void* c_oh, const void* c_op,
                     const void* c_om, const void* c_nk, const void* qi,
                     const void* ci, int T, int S, double max_shift,
                     void* ws, int grid, void* out, void* stream) {
  if (T <= 0) return (int)cudaSuccess;
  if (S < 1 || S > kMaxS) return (int)cudaErrorInvalidValue;
  const Pairs P{(const int*)q_oh, (const int*)q_op, (const int*)q_om,
                (const int*)q_nk, (const int*)c_oh, (const int*)c_op,
                (const int*)c_om, (const int*)c_nk, (const int*)qi,
                (const int*)ci};
  int R_cap;
  if (ws == nullptr) {
    bool fits;
    cudaError_t e = fits_shared(S, &fits);
    if (e != cudaSuccess) return (int)e;
    if (!fits) return (int)cudaErrorInvalidValue;
    const size_t smem = smem_bytes(S, &R_cap);
    e = prepare_shared(smem);
    if (e != cudaSuccess) return (int)e;
    score_pairs_kernel<<<T, kThreads, smem, (cudaStream_t)stream>>>(
        P, S, R_cap, max_shift, (int*)out);
  } else {
    if (grid < 1) return (int)cudaErrorInvalidValue;
    const size_t bytes = wide_bytes(S, &R_cap);
    score_pairs_wide_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        P, T, S, R_cap, bytes, max_shift, (unsigned char*)ws, (int*)out);
  }
  return (int)cudaGetLastError();
}

// The path the card takes at sketch size S: info = {0 shared memory or 1
// device memory, the scratch bytes a block (dynamic shared memory, or the
// workspace slice), the kernel's resident blocks on the card}.
int mhap_score_pairs_plan(int S, long long* info) {
  if (S < 1 || S > kMaxS) return (int)cudaErrorInvalidValue;
  bool fits;
  cudaError_t e = fits_shared(S, &fits);
  int R_cap, dev, sms = 0, blocks = 0;
  const size_t bytes = fits ? smem_bytes(S, &R_cap) : wide_bytes(S, &R_cap);
  if (e == cudaSuccess && fits) e = prepare_shared(bytes);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = fits ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                   &blocks, score_pairs_kernel, kThreads, bytes)
             : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                   &blocks, score_pairs_wide_kernel, kThreads, 0);
  info[0] = fits ? 0 : 1;
  info[1] = (long long)bytes;
  info[2] = (long long)blocks * sms;
  return (int)e;
}

// The resources of the kernel that takes sketch size S: info =
// {registers a thread, static shared bytes, dynamic shared bytes, local
// (spill) bytes a thread, resident blocks per SM}.
int mhap_score_pairs_occupancy(int S, int* info) {
  if (S < 1 || S > kMaxS) return (int)cudaErrorInvalidValue;
  bool fits;
  cudaError_t e = fits_shared(S, &fits);
  int R_cap;
  const size_t smem = fits ? smem_bytes(S, &R_cap) : 0;
  cudaFuncAttributes a;
  if (e == cudaSuccess)
    e = fits ? cudaFuncGetAttributes(&a, score_pairs_kernel)
             : cudaFuncGetAttributes(&a, score_pairs_wide_kernel);
  if (e == cudaSuccess && fits) e = prepare_shared(smem);
  int blocks = 0;
  if (e == cudaSuccess)
    e = fits ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                   &blocks, score_pairs_kernel, kThreads, smem)
             : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                   &blocks, score_pairs_wide_kernel, kThreads, 0);
  if (e != cudaSuccess) return (int)e;
  info[0] = a.numRegs;
  info[1] = (int)a.sharedSizeBytes;
  info[2] = (int)smem;
  info[3] = (int)a.localSizeBytes;
  info[4] = blocks;
  return (int)cudaSuccess;
}

}  // extern "C"

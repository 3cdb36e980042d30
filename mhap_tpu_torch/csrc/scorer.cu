// Stage-2 pair scorer for Hopper (sm_90a): BottomOverlapSketch's
// getOverlapInfo as an exact per-pair automaton.
//
// Replaces score_pairs_pallas (mhap_tpu/ops/scorer_pallas.py:471, body
// _make_kernel :118).  The TPU kernel vectorised the merge automaton into
// sort networks and bounded scans and flagged the lanes its scan model
// could not reproduce (`escal`) for two slower rescoring rungs.  This
// kernel runs the sequential automaton of native/scorer.h itself
// (get_overlap_info :214, record_matching_kmers :134, MatchData :33-132,
// bottom_k_jaccard :183), so no lane escalates and `escal` is always 0.
//
// What bounds it on the H100: per pair, the 24 KB read of the two
// S = 1536 (hash, pos) rows and a sequential merge over the entries whose
// hash both sketches share -- latency of dependent shared-memory loads in
// one thread, not bandwidth or ALU throughput.
//
// Design: one block per pair; the block gathers its own rows from the
// store's [N, S] columns by the qi/ci index arrays (no [T, S] copies).
// The parallel parts use all threads: the coalesced row loads, a binary
// search per entry that flags hashes present in the other sketch, a
// stable in-place compaction to those shared entries (entries whose hash
// is absent on the other side are only ever skipped by the automaton, and
// same-hash runs stay contiguous, so the records are unchanged), the
// bitonic sorts that take each upper median, and the window filtering of
// the Jaccard step.  One thread runs the two merge passes, optimizeShifts,
// the UMVU edges and the union merge over shared memory.
//
// Lanes that do not score (ok = 0) still run every stage, with an empty
// record set taking the median 0x7FFFFFFF, so all 16 output columns equal
// the TPU kernel's on every lane it did not escalate.  Compiled with
// --fmad=false; (int)(overlap * max_shift) is the plain IEEE double
// product of the Java reference.
//
// Shared memory per block, S entries per side: four [S] row arrays, two
// [2S] record arrays (at most 2 min(m1, m2) records per pass), a
// [pow2(2S)] sort buffer and two [S] flag arrays: 68.6 KB at S = 1536,
// so the launch raises the dynamic shared-memory limit.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 16;
constexpr int IMAX = 0x7FFFFFFF;

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

struct Windows {
  int v1l, v1u, v2l, v2u;
};

__device__ __forceinline__ Windows windows_of(int med, int am, int nk1,
                                              int nk2) {
  Windows w;
  w.v1l = max(0, w32(-(long long)med - am));
  w.v1u = min(nk1, w32((long long)nk2 - med + am));
  w.v2l = max(0, w32((long long)med - am));
  w.v2u = min(nk2, w32((long long)nk1 + med + am));
  return w;
}

// lower_bound in sorted a[0..n): is v present?
__device__ __forceinline__ bool contains(const int* a, int n, int v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < v)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo < n && a[lo] == v;
}

// Stable in-place compaction of (h[i], p[i]) for i < n with flag[i] set.
// Block-wide; returns the kept count to every thread.
__device__ int compact(int* h, int* p, const unsigned char* flag, int n,
                       int* warp_tot) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int total = 0;
  for (int base = 0; base < n; base += kThreads) {
    const int i = base + tid;
    const bool keep = i < n && flag[i];
    const int hv = keep ? h[i] : 0, pv = keep ? p[i] : 0;
    const unsigned bal = __ballot_sync(0xffffffffu, keep);
    const int lane_off = __popc(bal & ((1u << lane) - 1u));
    if (lane == 0) warp_tot[warp] = __popc(bal);
    __syncthreads();  // every read of this tile precedes every write
    int woff = 0, tile = 0;
    for (int q = 0; q < kWarps; ++q) {
      const int c = warp_tot[q];
      if (q < warp) woff += c;
      tile += c;
    }
    if (keep) {
      h[total + woff + lane_off] = hv;
      p[total + woff + lane_off] = pv;
    }
    total += tile;
    __syncthreads();
  }
  return total;
}

// Upper median (Utils.quickSelect at count/2) of the record shifts
// r2[i] - r1[i], i < cnt; 0x7FFFFFFF when cnt == 0.  Block-wide.
__device__ int block_median(const int* r1, const int* r2, int cnt,
                            int* buf) {
  const int tid = threadIdx.x;
  int P = 1;
  while (P < cnt) P <<= 1;
  for (int i = tid; i < P; i += kThreads)
    buf[i] = i < cnt ? r2[i] - r1[i] : IMAX;
  __syncthreads();
  for (int k = 2; k <= P; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = tid; i < P; i += kThreads) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const int a = buf[i], b = buf[ixj];
          const bool asc = (i & k) == 0;
          if ((a > b) == asc) {
            buf[i] = b;
            buf[ixj] = a;
          }
        }
      }
      __syncthreads();
    }
  }
  const int med = cnt > 0 ? buf[cnt / 2] : IMAX;
  __syncthreads();  // buf is reused by the next call
  return med;
}

// One recordMatchingKmers pass over the compacted lists (one thread).
__device__ int merge_pass(const int* ah, const int* ap, int n1,
                          const int* bh, const int* bp, int n2, int med,
                          int am, Windows w, int* r1, int* r2) {
  int i1 = 0, i2 = 0, cnt = 0;
  while (i1 < n1 && i2 < n2) {
    const int h1 = ah[i1], p1 = ap[i1], h2 = bh[i2], p2 = bp[i2];
    if (h1 < h2 || p1 < w.v1l || p1 >= w.v1u) {
      ++i1;
    } else if (h2 < h1 || p2 < w.v2l || p2 >= w.v2u) {
      ++i2;
    } else {
      const long long diff = (long long)(p2 - p1) - med;
      if (diff > am) {
        ++i1;
      } else if (diff < -(long long)am) {
        ++i2;
      } else {
        r1[cnt] = p1;
        r2[cnt] = p2;
        ++cnt;
        // extend both cursors over the same-hash run with valid positions
        int e1 = i1;
        while (e1 + 1 < n1 && ah[e1 + 1] == h1 && ap[e1 + 1] >= w.v1l &&
               ap[e1 + 1] < w.v1u)
          ++e1;
        int e2 = i2;
        while (e2 + 1 < n2 && bh[e2 + 1] == h2 && bp[e2 + 1] >= w.v2l &&
               bp[e2 + 1] < w.v2u)
          ++e2;
        if (e1 != i1 || e2 != i2) {
          r1[cnt] = ap[e1];
          r2[cnt] = bp[e2];
          ++cnt;
        }
        i1 = e1 + 1;
        i2 = e2 + 1;
      }
    }
  }
  return cnt;
}

// optimizeShifts: per run of adjacent equal pos1 keep the first record
// with the least |shift - median| (one thread, in place).
__device__ int optimize_shifts(int* r1, int* r2, int cnt, int med) {
  int rc = -1;
  for (int i = 0; i < cnt; ++i) {
    if (rc >= 0 && r1[rc] == r1[i]) {
      const long long drc = llabs((long long)(r2[rc] - r1[rc]) - med);
      const long long di = llabs((long long)(r2[i] - r1[i]) - med);
      if (drc > di) {
        r1[rc] = r1[i];
        r2[rc] = r2[i];
      }
    } else {
      ++rc;
      r1[rc] = r1[i];
      r2[rc] = r2[i];
    }
  }
  return rc + 1;
}

__global__ void __launch_bounds__(kThreads) score_pairs_kernel(
    const int* __restrict__ q_oh, const int* __restrict__ q_op,
    const int* __restrict__ q_om, const int* __restrict__ q_nk,
    const int* __restrict__ c_oh, const int* __restrict__ c_op,
    const int* __restrict__ c_om, const int* __restrict__ c_nk,
    const int* __restrict__ qi, const int* __restrict__ ci, int S, int P,
    double max_shift, int* __restrict__ out) {
  extern __shared__ int smem[];
  int* ah = smem;         // [S]
  int* ap = ah + S;       // [S]
  int* bh = ap + S;       // [S]
  int* bp = bh + S;       // [S]
  int* r1 = bp + S;       // [2S]
  int* r2 = r1 + 2 * S;   // [2S]
  int* buf = r2 + 2 * S;  // [P]
  unsigned char* fa = (unsigned char*)(buf + P);  // [S]
  unsigned char* fb = fa + S;                     // [S]
  __shared__ int warp_tot[kWarps];
  __shared__ int sh[12];

  const int tid = threadIdx.x;
  const size_t t = blockIdx.x;
  const size_t qa = (size_t)qi[t], cb = (size_t)ci[t];
  const int m1 = q_om[qa], m2 = c_om[cb];
  const int nk1 = q_nk[qa], nk2 = c_nk[cb];
  const int* gah = q_oh + qa * S;
  const int* gap = q_op + qa * S;
  const int* gbh = c_oh + cb * S;
  const int* gbp = c_op + cb * S;

  for (int i = tid; i < m1; i += kThreads) {
    ah[i] = gah[i];
    ap[i] = gap[i];
  }
  for (int i = tid; i < m2; i += kThreads) {
    bh[i] = gbh[i];
    bp[i] = gbp[i];
  }
  __syncthreads();

  // ---- entries whose hash the other sketch also holds ----
  for (int i = tid; i < m1; i += kThreads) fa[i] = contains(bh, m2, ah[i]);
  for (int i = tid; i < m2; i += kThreads) fb[i] = contains(ah, m1, bh[i]);
  __syncthreads();
  const int n1 = compact(ah, ap, fa, m1, warp_tot);
  const int n2 = compact(bh, bp, fb, m2, warp_tot);

  // ---- pass 1: unconstrained windows ----
  if (tid == 0) {
    const int am0 = w32((long long)max(nk1, nk2) + 1);
    sh[0] = merge_pass(ah, ap, n1, bh, bp, n2, 0, am0,
                       windows_of(0, am0, nk1, nk2), r1, r2);
  }
  __syncthreads();
  const int cnt1 = sh[0];
  const int med1 = block_median(r1, r2, cnt1, buf);

  // ---- pass 2: windows around the pass-1 median ----
  if (tid == 0) {
    const int am1 = abs_max_of(med1, nk1, nk2, max_shift);
    sh[1] = merge_pass(ah, ap, n1, bh, bp, n2, med1, am1,
                       windows_of(med1, am1, nk1, nk2), r1, r2);
  }
  __syncthreads();
  const int cnt2 = sh[1];
  const int med2 = block_median(r1, r2, cnt2, buf);
  if (tid == 0) sh[2] = optimize_shifts(r1, r2, cnt2, med2);
  __syncthreads();
  const int cnt3 = sh[2];
  const int med3 = block_median(r1, r2, cnt3, buf);

  // ---- UMVU edges ----
  if (tid == 0) {
    const int am3 = abs_max_of(med3, nk1, nk2, max_shift);
    int l1 = IMAX, l2 = IMAX, u1 = -IMAX, u2 = -IMAX, nrec = 0;
    for (int i = 0; i < cnt3; ++i) {
      if (llabs((long long)(r2[i] - r1[i]) - med3) > am3) continue;
      l1 = min(l1, r1[i]);
      l2 = min(l2, r2[i]);
      u1 = max(u1, r1[i]);
      u2 = max(u2, r2[i]);
      ++nrec;
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
    sh[3] = nrec;
    sh[4] = max(0, umvu(l1, u1));
    sh[5] = min(nk1, umvu(u1, l1));
    sh[6] = max(0, umvu(l2, u2));
    sh[7] = min(nk2, umvu(u2, l2));
  }
  __syncthreads();
  const int a1 = sh[4], a2 = sh[5], b1 = sh[6], b2 = sh[7];

  // ---- windowed bottom-k Jaccard over the full sketches ----
  for (int i = tid; i < m1; i += kThreads) {
    ah[i] = gah[i];
    ap[i] = gap[i];
    fa[i] = ap[i] >= a1 && ap[i] <= a2;
  }
  for (int i = tid; i < m2; i += kThreads) {
    bh[i] = gbh[i];
    bp[i] = gbp[i];
    fb[i] = bp[i] >= b1 && bp[i] <= b2;
  }
  __syncthreads();
  const int f1 = compact(ah, ap, fa, m1, warp_tot);
  const int f2 = compact(bh, bp, fb, m2, warp_tot);
  if (tid == 0) {
    const int k = min(f1, f2);
    int i = 0, j = 0, inter = 0;
    for (int uni = 0; uni < k; ++uni) {
      if (ah[i] < bh[j]) {
        ++i;
      } else if (ah[i] > bh[j]) {
        ++j;
      } else {
        ++inter;
        ++i;
        ++j;
      }
    }
    const int nrec = sh[3];
    const bool ok = cnt1 > 0 && cnt2 > 0 && cnt3 > 0 && nrec >= 3;
    int* o = out + t * kCols;
    o[0] = ok;
    o[1] = inter;
    o[2] = k;
    o[3] = nrec;
    o[4] = a1;
    o[5] = a2;
    o[6] = b1;
    o[7] = b2;
    o[8] = 0;  // escal: the automaton is exact on every lane
    o[9] = cnt1;
    o[10] = cnt2;
    o[11] = cnt3;
    o[12] = n1 + n2;
    o[13] = o[14] = o[15] = 0;
  }
}

}  // namespace

extern "C" {

// Store columns: oh/op [N, S] int32, om/nk [N] int32 for the query (q_*)
// and candidate (c_*) stores; qi/ci [T] int32 row indices; out [T, 16].
int mhap_score_pairs(const void* q_oh, const void* q_op, const void* q_om,
                     const void* q_nk, const void* c_oh, const void* c_op,
                     const void* c_om, const void* c_nk, const void* qi,
                     const void* ci, int T, int S, double max_shift,
                     void* out, void* stream) {
  if (T <= 0) return (int)cudaSuccess;
  int P = 1;
  while (P < 2 * S) P <<= 1;
  const size_t smem = (size_t)(4 * S + 4 * S + P) * sizeof(int) + 2 * S;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        score_pairs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  score_pairs_kernel<<<T, kThreads, smem, (cudaStream_t)stream>>>(
      (const int*)q_oh, (const int*)q_op, (const int*)q_om,
      (const int*)q_nk, (const int*)c_oh, (const int*)c_op,
      (const int*)c_om, (const int*)c_nk, (const int*)qi, (const int*)ci, S,
      P, max_shift, (int*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"

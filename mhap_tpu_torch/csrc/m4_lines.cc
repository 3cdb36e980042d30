// A job's M4 lines (impl/MatchResult.java:98-113 layout) as one byte
// buffer: formatting and sorting on the host, with a plain C interface
// bound by ctypes (mhap_tpu_torch/utils/native.py).
//
// mhap_m4_format writes "%lld %lld %.6f %.6f %lld ... %lld\n" a line,
// byte-equal to Python's "%s %s %.6f %.6f %d ..." % (...) on every input.
// Integers are written digit by digit.  The two %.6f columns take exact
// integer paths on their proven domains and snprintf elsewhere:
//   * err in [0, 1]: x = m 2^-s with m < 2^53, so m 10^6 < 2^73 fits
//     unsigned __int128; q = (m 10^6) >> s, rounded half to even on the
//     remainder, is the correctly rounded x 10^6, printed as q / 10^6 "."
//     q % 10^6.  That is what glibc's printf and CPython's %-format both
//     give (the correctly rounded decimal of the binary value, ties to
//     even).
//   * raw, an integer count in a double: an exact integer in [0, 2^53)
//     prints as that integer and ".000000".
//   * anything else (negative, -0.0, NaN, inf, err over 1, raw not
//     integral or too large) goes to snprintf; NaN prints "nan", as
//     CPython prints it whatever its sign bit.
//
// mhap_m4_sort orders the lines of a buffer as Python's sorted() orders
// the str lines: for ASCII and UTF-8 that is byte order, a line before
// its extensions.  It sorts (first 8 bytes as a big-endian integer, line
// offset and length) entries, comparing the lines themselves only on
// equal keys.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <system_error>
#include <thread>
#include <vector>

namespace {

// the longest line: 10 int64 of 20 bytes, two %.6f of at most 317 bytes
// (-DBL_MAX) and snprintf's NUL, 11 spaces, a newline
constexpr long long kMaxLine = 1024;
constexpr size_t kMaxFixed = 320;

const char kDigits2[] =
    "00010203040506070809101112131415161718192021222324252627282930313233343536373839"
    "40414243444546474849505152535455565758596061626364656667686970717273747576777879"
    "8081828384858687888990919293949596979899";

inline char* put_u64(char* p, uint64_t v) {
  char tmp[20];
  char* e = tmp + 20;
  char* b = e;
  while (v >= 100) {
    unsigned r = static_cast<unsigned>(v % 100);
    v /= 100;
    b -= 2;
    std::memcpy(b, kDigits2 + 2 * r, 2);
  }
  if (v >= 10) {
    b -= 2;
    std::memcpy(b, kDigits2 + 2 * v, 2);
  } else {
    *--b = static_cast<char>('0' + v);
  }
  size_t n = static_cast<size_t>(e - b);
  std::memcpy(p, b, n);
  return p + n;
}

inline char* put_i64(char* p, long long v) {
  if (v < 0) {
    *p++ = '-';
    return put_u64(p, 0 - static_cast<uint64_t>(v));
  }
  return put_u64(p, static_cast<uint64_t>(v));
}

// q < 10^6 as exactly six digits
inline char* put_frac6(char* p, unsigned q) {
  std::memcpy(p, kDigits2 + 2 * (q / 10000), 2);
  std::memcpy(p + 2, kDigits2 + 2 * (q / 100 % 100), 2);
  std::memcpy(p + 4, kDigits2 + 2 * (q % 100), 2);
  return p + 6;
}

inline char* put_slow(char* p, double x) {
  if (std::isnan(x)) {
    std::memcpy(p, "nan", 3);
    return p + 3;
  }
  int w = std::snprintf(p, kMaxFixed, "%.6f", x);
  return p + w;
}

// "%.6f" of x in [0, 1]; any other x through put_slow
inline char* put_unit(char* p, double x) {
  if (!(x >= 0.0 && x <= 1.0) || std::signbit(x)) return put_slow(p, x);
  uint64_t bits;
  std::memcpy(&bits, &x, 8);
  int ef = static_cast<int>(bits >> 52);  // the sign bit is 0
  uint64_t m = bits & ((uint64_t{1} << 52) - 1);
  int s;  // x = m 2^-s
  if (ef == 0) {
    s = 1074;
  } else {
    m |= uint64_t{1} << 52;
    s = 1075 - ef;
  }
  unsigned q = 0;
  if (m != 0 && s < 128) {
    unsigned __int128 prod = static_cast<unsigned __int128>(m) * 1000000u;
    unsigned __int128 qq = prod >> s;
    unsigned __int128 rem = prod - (qq << s);
    unsigned __int128 half = static_cast<unsigned __int128>(1) << (s - 1);
    if (rem > half || (rem == half && (qq & 1))) qq += 1;
    q = static_cast<unsigned>(qq);
  }  // s >= 128: x 10^6 < 2^73 / 2^128, which rounds to 0
  p = put_u64(p, q / 1000000u);
  *p++ = '.';
  return put_frac6(p, q % 1000000u);
}

// "%.6f" of an integer count; any other x through put_slow
inline char* put_count(char* p, double x) {
  if (x >= 0.0 && x < 9007199254740992.0 && !std::signbit(x)) {
    uint64_t v = static_cast<uint64_t>(x);
    if (static_cast<double>(v) == x) {
      p = put_u64(p, v);
      std::memcpy(p, ".000000", 7);
      return p + 7;
    }
  }
  return put_slow(p, x);
}

struct Entry {
  uint64_t key;  // the line's first 8 bytes, big-endian, zero-padded
  uint64_t pos;  // offset << 20 | length without the newline (kLongLine:
                 // that long or longer)
};

constexpr uint64_t kLongLine = (1u << 20) - 1;

inline uint64_t key_of(const unsigned char* p, int64_t len) {
  uint64_t k = 0;
  if (len >= 8) {
    std::memcpy(&k, p, 8);
    return __builtin_bswap64(k);
  }
  for (int64_t i = 0; i < len; i++) k |= uint64_t{p[i]} << (56 - 8 * i);
  return k;
}

// Python's order of two newline-terminated lines: byte by byte, a line
// that ends first (its newline) before one that goes on
inline bool line_less(const unsigned char* a, const unsigned char* b) {
  for (;; a++, b++) {
    bool ea = *a == '\n', eb = *b == '\n';
    if (ea || eb) return ea && !eb;
    if (*a != *b) return *a < *b;
  }
}

// runs body(t) for t in [0, parts), on parts - 1 new threads and this
// one; serially if a thread cannot be started
template <class F>
void in_parallel(int parts, F body) {
  std::vector<std::thread> team;
  int t = 1;
  try {
    for (; t < parts; t++) team.emplace_back(body, t);
  } catch (const std::system_error&) {
    for (int u = t; u < parts; u++) body(u);
  }
  body(0);
  for (std::thread& th : team) th.join();
}

// rows a thread at least: fewer rows are not worth a thread's start
constexpr long long kRowsAThread = 16384;

struct Columns {
  const long long *qid, *cid;
  const double *err, *raw;
  const long long* ints[8];  // qrc, a1, a2, ql, crc, b1, b2, cl
};

// rows [lo, hi) into [p, end); the end of the lines, or nullptr if the
// room may run short
char* format_rows(const Columns& c, long long lo, long long hi, char* p,
                  const char* end) {
  for (long long i = lo; i < hi; i++) {
    if (end - p < kMaxLine) return nullptr;
    p = put_i64(p, c.qid[i]);
    *p++ = ' ';
    p = put_i64(p, c.cid[i]);
    *p++ = ' ';
    p = put_unit(p, c.err[i]);
    *p++ = ' ';
    p = put_count(p, c.raw[i]);
    for (const long long* col : c.ints) {
      *p++ = ' ';
      p = put_i64(p, col[i]);
    }
    *p++ = '\n';
  }
  return p;
}

}  // namespace

extern "C" long long mhap_m4_format(
    const long long* qid, const long long* cid, const double* err,
    const double* raw, const long long* qrc, const long long* a1,
    const long long* a2, const long long* ql, const long long* crc,
    const long long* b1, const long long* b2, const long long* cl,
    long long n, char* out, long long cap, int threads) {
  // newline-terminated lines; returns the bytes written, or -1 if the
  // buffer may be too short.  Up to ``threads`` threads each format a
  // share of the rows into the same share of the buffer; the shares are
  // then moved together.
  if (n == 0) return 0;
  const Columns c{qid, cid, err, raw, {qrc, a1, a2, ql, crc, b1, b2, cl}};
  int parts = static_cast<int>(
      std::max(1LL, std::min<long long>(threads, n / kRowsAThread)));
  long long room = cap / n;  // bytes a row
  std::vector<char*> ends(parts);
  in_parallel(parts, [&](int t) {
    long long lo = n * t / parts, hi = n * (t + 1) / parts;
    ends[t] = format_rows(c, lo, hi, out + lo * room,
                          t + 1 < parts ? out + hi * room : out + cap);
  });
  char* p = out;
  for (int t = 0; t < parts; t++) {
    if (ends[t] == nullptr) return -1;
    char* from = out + n * t / parts * room;
    std::memmove(p, from, static_cast<size_t>(ends[t] - from));
    p += ends[t] - from;
  }
  return p - out;
}

extern "C" long long mhap_m4_sort(const char* in, long long len, char* out,
                                  int threads) {
  // the newline-terminated lines of in[0, len) into out, sorted; returns
  // the line count, or -1 if the buffer does not end with a newline
  if (len == 0) return 0;
  if (in[len - 1] != '\n') return -1;
  const unsigned char* u = reinterpret_cast<const unsigned char*>(in);
  // the entries and a count of lines and bytes by the keys' first two
  // bytes
  std::vector<Entry> lines;
  lines.reserve(static_cast<size_t>(len / 48 + 1));
  std::vector<uint64_t> first(65537, 0), bytes(65537, 0);
  for (int64_t s = 0; s < len;) {
    const void* nl = std::memchr(in + s, '\n', static_cast<size_t>(len - s));
    int64_t e = static_cast<const char*>(nl) - in;
    uint64_t key = key_of(u + s, e - s);
    uint64_t n = std::min<uint64_t>(static_cast<uint64_t>(e - s), kLongLine);
    lines.push_back({key, static_cast<uint64_t>(s) << 20 | n});
    first[(key >> 48) + 1]++;
    bytes[(key >> 48) + 1] += static_cast<uint64_t>(e - s + 1);
    s = e + 1;
  }
  for (size_t b = 0; b < 65536; b++) {
    first[b + 1] += first[b];
    bytes[b + 1] += bytes[b];
  }
  std::vector<Entry> sorted(lines.size());
  std::vector<uint64_t> next(first.begin(), first.end() - 1);
  for (const Entry& e : lines) sorted[next[e.key >> 48]++] = e;
  // each thread a run of whole buckets, about as many lines each: a merge
  // sort in each bucket (the vote emits lines query by query, in sorted
  // runs, on which a merge sort beats std::sort), then the bucket's lines
  // at its place in the output
  auto less = [u](const Entry& a, const Entry& b) {
    if (a.key != b.key) return a.key < b.key;
    return line_less(u + (a.pos >> 20), u + (b.pos >> 20));
  };
  uint64_t total = sorted.size();
  int parts = static_cast<int>(std::max<uint64_t>(
      1, std::min<uint64_t>(threads, total / kRowsAThread)));
  std::vector<size_t> cut(parts + 1, 65536);
  cut[0] = 0;
  for (int t = 1; t < parts; t++)
    cut[t] = static_cast<size_t>(
        std::lower_bound(first.begin(), first.end() - 1, total * t / parts) -
        first.begin());
  in_parallel(parts, [&](int t) {
    char* p = out + bytes[cut[t]];
    for (size_t b = cut[t]; b < cut[t + 1]; b++) {
      auto lo = sorted.begin() + first[b], hi = sorted.begin() + first[b + 1];
      if (hi - lo > 1) std::stable_sort(lo, hi, less);
      for (auto it = lo; it != hi; ++it) {
        const char* line = in + (it->pos >> 20);
        size_t n = it->pos & kLongLine;
        if (n == kLongLine)
          n = static_cast<size_t>(static_cast<const char*>(std::memchr(
                  line, '\n', static_cast<size_t>(in + len - line))) - line);
        std::memcpy(p, line, n + 1);
        p += n + 1;
      }
    }
  });
  return static_cast<long long>(total);
}

// Host-side native runtime of flash_hash_join_tpu_torch (the PyTorch/CUDA
// port), built by g++ (utils/native.py), never by nvcc: ops/cuda/_build.py
// compiles only csrc/*.cu and *.cuh.
//
// The port's own copy of the JAX package's host runtime, with the same C
// ABI, so that the port needs nothing of that package: an exact threaded
// first-match join oracle (count; materialize in probe order, the first
// inserted build row of a key winning, which is the port's minimum-build-row
// winner) for parity checks at sizes where numpy's np.isin is too slow, and
// a CSV column loader for the db-benchmark J1 suites (no pandas needed).
//
// A plain C ABI consumed via ctypes.  This is verification and I/O tooling:
// deliberately simple, independent of the CUDA join path it checks.

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// Fibonacci multiplicative hashing (Knuth); nothing like the reference's
// CRC32-based scheme, and it doesn't need to be: the oracle only needs a
// correct set-membership structure.
inline uint64_t mix(uint64_t x) {
  x ^= x >> 33;
  x *= 0xff51afd7ed558ccdULL;
  x ^= x >> 33;
  return x;
}

struct KeySet {
  // Open-addressing set with a presence bitmap so key 0 needs no sentinel.
  std::vector<uint64_t> keys;
  std::vector<uint8_t> used;
  uint64_t mask = 0;

  explicit KeySet(int64_t n) {
    uint64_t cap = 16;
    while (cap < static_cast<uint64_t>(n) * 2) cap <<= 1;
    keys.assign(cap, 0);
    used.assign(cap, 0);
    mask = cap - 1;
  }

  void insert(uint64_t k) {
    uint64_t i = mix(k) & mask;
    while (used[i]) {
      if (keys[i] == k) return;
      i = (i + 1) & mask;
    }
    used[i] = 1;
    keys[i] = k;
  }

  bool contains(uint64_t k) const {
    uint64_t i = mix(k) & mask;
    while (used[i]) {
      if (keys[i] == k) return true;
      i = (i + 1) & mask;
    }
    return false;
  }
};

struct KeyValueMap {
  std::vector<uint64_t> keys;
  std::vector<uint64_t> vals;
  std::vector<uint8_t> used;
  uint64_t mask = 0;

  explicit KeyValueMap(int64_t n) {
    uint64_t cap = 16;
    while (cap < static_cast<uint64_t>(n) * 2) cap <<= 1;
    keys.assign(cap, 0);
    vals.assign(cap, 0);
    used.assign(cap, 0);
    mask = cap - 1;
  }

  // Keeps the FIRST value seen for a key: inserted in row order, that is
  // the minimum build row's, the winner of every tier of the port.
  void insert_first(uint64_t k, uint64_t v) {
    uint64_t i = mix(k) & mask;
    while (used[i]) {
      if (keys[i] == k) return;
      i = (i + 1) & mask;
    }
    used[i] = 1;
    keys[i] = k;
    vals[i] = v;
  }

  bool lookup(uint64_t k, uint64_t* v) const {
    uint64_t i = mix(k) & mask;
    while (used[i]) {
      if (keys[i] == k) {
        *v = vals[i];
        return true;
      }
      i = (i + 1) & mask;
    }
    return false;
  }
};

int resolve_threads(int nthreads) {
  if (nthreads > 0) return nthreads;
  unsigned hc = std::thread::hardware_concurrency();
  return hc ? static_cast<int>(hc) : 1;
}

// Run fn(t) on one thread per chunk index t in [0, nt).
template <typename Fn>
void parallel_chunks(int nt, Fn fn) {
  if (nt <= 1) {
    if (nt == 1) fn(0);
    return;
  }
  std::vector<std::thread> ts;
  ts.reserve(nt);
  for (int t = 0; t < nt; ++t) ts.emplace_back([=] { fn(t); });
  for (auto& t : ts) t.join();
}

template <typename Fn>
void parallel_ranges(int64_t n, int nthreads, Fn fn) {
  nthreads = resolve_threads(nthreads);
  if (nthreads <= 1 || n < (1 << 16)) {
    fn(0, n, 0);
    return;
  }
  std::vector<std::thread> ts;
  int64_t per = (n + nthreads - 1) / nthreads;
  for (int t = 0; t < nthreads; ++t) {
    int64_t lo = t * per;
    int64_t hi = lo + per < n ? lo + per : n;
    if (lo >= hi) break;
    ts.emplace_back([=] { fn(lo, hi, t); });
  }
  for (auto& t : ts) t.join();
}

}  // namespace

extern "C" {

// First-match inner-join count: #probe rows whose key exists in build.
int64_t fhj_oracle_join_count(const uint64_t* build_keys, int64_t n_build,
                              const uint64_t* probe_keys, int64_t n_probe,
                              int nthreads) {
  KeySet set(n_build);
  for (int64_t i = 0; i < n_build; ++i) set.insert(build_keys[i]);

  std::atomic<int64_t> total{0};
  parallel_ranges(n_probe, nthreads, [&](int64_t lo, int64_t hi, int) {
    int64_t local = 0;
    for (int64_t i = lo; i < hi; ++i) {
      local += set.contains(probe_keys[i]) ? 1 : 0;
    }
    total.fetch_add(local, std::memory_order_relaxed);
  });
  return total.load();
}

// First-match materialize: for each matching probe row (in probe order)
// write (probe_key, build_value).  Returns the match count; out arrays must
// have n_probe capacity.
int64_t fhj_oracle_join_materialize(const uint64_t* build_keys,
                                    const uint64_t* build_values,
                                    int64_t n_build,
                                    const uint64_t* probe_keys,
                                    int64_t n_probe, uint64_t* out_keys,
                                    uint64_t* out_values) {
  KeyValueMap map(n_build);
  for (int64_t i = 0; i < n_build; ++i) {
    map.insert_first(build_keys[i], build_values[i]);
  }
  int64_t count = 0;
  for (int64_t i = 0; i < n_probe; ++i) {
    uint64_t v;
    if (map.lookup(probe_keys[i], &v)) {
      out_keys[count] = probe_keys[i];
      out_values[count] = v;
      ++count;
    }
  }
  return count;
}

// Parse one numeric uint64 column out of a CSV file (with header row).
// Returns the number of rows written to `out` (capacity `max_rows`), or -1
// on I/O error, -2 if the column index is out of range.
int64_t fhj_load_csv_u64(const char* path, int32_t column, uint64_t* out,
                         int64_t max_rows, int nthreads) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::vector<char> buf(static_cast<size_t>(size));
  if (std::fread(buf.data(), 1, buf.size(), f) != buf.size()) {
    std::fclose(f);
    return -1;
  }
  std::fclose(f);

  const char* data = buf.data();
  const char* end = data + buf.size();

  // Skip the header line.
  const char* p = static_cast<const char*>(memchr(data, '\n', buf.size()));
  if (!p) return 0;
  ++p;

  // Split the body into per-thread chunks at line boundaries; small
  // bodies get fewer chunks so threads always have >= ~64 KB of work.
  int nt = resolve_threads(nthreads);
  int64_t body = end - p;
  if (body <= 0) return 0;
  int64_t max_chunks = body / (1 << 16) + 1;
  if (nt > max_chunks) nt = static_cast<int>(max_chunks);
  std::vector<const char*> starts{p};
  for (int t = 1; t < nt; ++t) {
    const char* cand = p + body * t / nt;
    const char* nl = static_cast<const char*>(
        memchr(cand, '\n', static_cast<size_t>(end - cand)));
    starts.push_back(nl ? nl + 1 : end);
  }
  starts.push_back(end);

  // Pass 1: count rows per chunk so each thread writes to a disjoint range.
  std::vector<int64_t> rows(nt, 0);
  parallel_chunks(nt, [&](int t) {
    int64_t c = 0;
    for (const char* q = starts[t]; q < starts[t + 1]; ++q) {
      if (*q == '\n') ++c;
    }
    if (starts[t] < starts[t + 1] && starts[t + 1][-1] != '\n') ++c;
    rows[t] = c;
  });
  std::vector<int64_t> offs(nt + 1, 0);
  for (int t = 0; t < nt; ++t) offs[t + 1] = offs[t] + rows[t];
  if (offs[nt] > max_rows) return -3;

  std::atomic<int64_t> bad{0};
  parallel_chunks(nt, [&](int t) {
    {
      const char* q = starts[t];
      const char* qe = starts[t + 1];
      int64_t w = offs[t];
      while (q < qe) {
        // seek to the target column
        int col = 0;
        const char* field = q;
        while (q < qe && *q != '\n') {
          if (*q == ',') {
            ++col;
            if (col == column + 1) break;
            field = q + 1;
          }
          ++q;
        }
        if (col < column) {
          // line has too few columns: count it bad AND emit a row so the
          // output stays aligned (the -2 error return makes the value
          // unobservable, but w must track offs[] row accounting)
          bad.fetch_add(1, std::memory_order_relaxed);
          out[w++] = 0;
        } else {
          // parse uint64 from the field; tolerate leading/trailing
          // spaces and double quotes (common CSV writers), reject
          // anything else non-numeric
          uint64_t v = 0;
          const char* r = field;
          bool any = false, overflow = false;
          while (r < qe && (*r == ' ' || *r == '"')) ++r;
          while (r < qe && *r >= '0' && *r <= '9') {
            uint64_t d = static_cast<uint64_t>(*r - '0');
            // values beyond 2^64-1 must be counted bad, not wrapped
            if (v > (UINT64_MAX - d) / 10) overflow = true;
            v = v * 10 + d;
            ++r;
            any = true;
          }
          while (r < qe && (*r == ' ' || *r == '"' || *r == '\r')) ++r;
          bool clean_end = (r >= qe) || (*r == ',') || (*r == '\n');
          if (!any || !clean_end || overflow)
            bad.fetch_add(1, std::memory_order_relaxed);
          out[w++] = v;
        }
        while (q < qe && *q != '\n') ++q;
        if (q < qe) ++q;
      }
    }
  });
  if (bad.load() > 0) return -2;
  return offs[nt];
}

int32_t fhj_version() { return 1; }

}  // extern "C"

// uspmv_host — native host-side preprocessing for the SpMV framework.
//
// Native (C++17) implementations of the ingest/convert hot path, mirroring
// the reference's native components (mmio.cpp + read_mtx at
// utilities.hpp:2148-2309; convert_to_scs at utilities.hpp:1842-2104) with
// semantics bit-identical to the Python implementations in
// uspmv_tpu/io/mmio.py and uspmv_tpu/formats/scs.py (which remain the
// fallback + parity oracle). Exposed as a C ABI consumed via ctypes
// (uspmv_tpu/native/__init__.py).
//
// Memory protocol: every entry point returning variable-sized arrays uses a
// two-call pattern — create an opaque handle carrying the result + sizes,
// then fetch into caller(numpy)-allocated buffers, then free the handle.

#include <algorithm>
#include <cctype>
#include <cerrno>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <numeric>
#include <stdexcept>
#include <string>
#include <vector>

#define USPMV_API extern "C" __attribute__((visibility("default")))

namespace {

thread_local std::string g_error;

void set_error(const std::string& msg) { g_error = msg; }

// ---------------------------------------------------------------------------
// MatrixMarket reader
// ---------------------------------------------------------------------------

struct MtxHandle {
  int64_t n_rows = 0;
  int64_t n_cols = 0;
  std::vector<int32_t> I;
  std::vector<int32_t> J;
  std::vector<double> vals;
  int is_symmetric = 0;
};

// Case-insensitive token compare.
bool tok_eq(const char* a, const char* b) {
  for (; *a && *b; ++a, ++b)
    if (std::tolower((unsigned char)*a) != std::tolower((unsigned char)*b))
      return false;
  return *a == *b;
}

// Parse one ASCII line [p, end) -> advances p past the trailing newline.
const char* next_line(const char* p, const char* end, std::string* out) {
  const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
  if (!nl) nl = end;
  out->assign(p, nl - p);
  return nl < end ? nl + 1 : end;
}

bool is_blank(const std::string& s) {
  for (char c : s)
    if (!std::isspace((unsigned char)c)) return false;
  return true;
}

// Fast whitespace-delimited scans over the body buffer.
inline const char* skip_ws(const char* p, const char* end) {
  while (p < end && std::isspace((unsigned char)*p)) ++p;
  return p;
}

inline bool scan_i64(const char*& p, const char* end, int64_t* out) {
  p = skip_ws(p, end);
  if (p >= end) return false;
  char* q;
  errno = 0;
  long long v = strtoll(p, &q, 10);
  if (q == p || errno == ERANGE) return false;
  p = q;
  *out = v;
  return true;
}

inline bool scan_f64(const char*& p, const char* end, double* out) {
  p = skip_ws(p, end);
  if (p >= end) return false;
  char* q;
  errno = 0;
  double v = strtod(p, &q);
  if (q == p) return false;
  p = q;
  *out = v;
  return true;
}

// Stable sort by row via index permutation (reference sort_perm,
// utilities.hpp:2139-2146).
void stable_row_sort(MtxHandle* m) {
  const size_t n = m->I.size();
  std::vector<int64_t> perm(n);
  std::iota(perm.begin(), perm.end(), 0);
  std::stable_sort(perm.begin(), perm.end(), [&](int64_t a, int64_t b) {
    return m->I[a] < m->I[b];
  });
  std::vector<int32_t> I2(n), J2(n);
  std::vector<double> v2(n);
  for (size_t i = 0; i < n; ++i) {
    I2[i] = m->I[perm[i]];
    J2[i] = m->J[perm[i]];
    v2[i] = m->vals[perm[i]];
  }
  m->I.swap(I2);
  m->J.swap(J2);
  m->vals.swap(v2);
}

}  // namespace

USPMV_API const char* uspmv_last_error() { return g_error.c_str(); }

// Bumped whenever an exported signature changes; the ctypes loader
// refuses to bind a library whose version differs (a stale .so with the
// different signature would corrupt memory silently).
USPMV_API int64_t uspmv_abi_version() { return 8; }

// Reads a MatrixMarket coordinate file. Returns a handle (or null on error;
// see uspmv_last_error). Mirrors uspmv_tpu/io/mmio.py:read_mtx.
USPMV_API MtxHandle* uspmv_read_mtx(const char* path, int require_square) {
  FILE* f = fopen(path, "rb");
  if (!f) {
    set_error(std::string("cannot open ") + path);
    return nullptr;
  }
  fseek(f, 0, SEEK_END);
  long sz = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::string buf(sz, '\0');
  if (sz && fread(&buf[0], 1, sz, f) != (size_t)sz) {
    fclose(f);
    set_error("short read");
    return nullptr;
  }
  fclose(f);

  const char* p = buf.data();
  const char* end = p + buf.size();
  std::string line;
  p = next_line(p, end, &line);

  // banner: %%MatrixMarket matrix <format> <field> <symmetry>
  char w0[64], w1[64], fmt[64], field[64], sym[64];
  if (sscanf(line.c_str(), "%63s %63s %63s %63s %63s", w0, w1, fmt, field,
             sym) != 5 ||
      strcmp(w0, "%%MatrixMarket") != 0 || !tok_eq(w1, "matrix")) {
    set_error("invalid MatrixMarket banner: " + line);
    return nullptr;
  }
  if (!tok_eq(fmt, "coordinate")) {
    set_error("only sparse (coordinate) MatrixMarket files are supported");
    return nullptr;
  }
  bool pattern = tok_eq(field, "pattern");
  if (tok_eq(field, "complex")) {
    set_error("complex matrices are not supported");
    return nullptr;
  }
  if (!pattern && !tok_eq(field, "real") && !tok_eq(field, "integer")) {
    set_error(std::string("unknown MatrixMarket field ") + field);
    return nullptr;
  }
  bool symmetric = tok_eq(sym, "symmetric");
  bool skew = tok_eq(sym, "skew-symmetric");
  if (tok_eq(sym, "hermitian")) {
    set_error("hermitian matrices are not supported");
    return nullptr;
  }
  if (!symmetric && !skew && !tok_eq(sym, "general")) {
    set_error(std::string("unknown MatrixMarket symmetry ") + sym);
    return nullptr;
  }

  // skip comments/blank; first content line = sizes
  for (;;) {
    if (p >= end) {
      set_error("missing MatrixMarket size line");
      return nullptr;
    }
    p = next_line(p, end, &line);
    if (is_blank(line)) continue;
    const size_t ns = line.find_first_not_of(" \t\r");
    if (ns != std::string::npos && line[ns] == '%') continue;
    break;
  }
  int64_t n_rows, n_cols, nnz_decl;
  {
    const char* q = line.c_str();
    const char* qe = q + line.size();
    if (!scan_i64(q, qe, &n_rows) || !scan_i64(q, qe, &n_cols) ||
        !scan_i64(q, qe, &nnz_decl)) {
      set_error("invalid size line: " + line);
      return nullptr;
    }
  }
  if (require_square && n_rows != n_cols) {
    set_error("input matrix must be square (reference utilities.hpp:2206-2210)");
    return nullptr;
  }

  auto* m = new MtxHandle;
  m->n_rows = n_rows;
  m->n_cols = n_cols;
  m->is_symmetric = (symmetric || skew) ? 1 : 0;
  m->I.reserve(nnz_decl);
  m->J.reserve(nnz_decl);
  m->vals.reserve(nnz_decl);

  for (int64_t k = 0; k < nnz_decl; ++k) {
    int64_t i, j;
    double v = 1.0;  // pattern entries read as 1.0
    if (!scan_i64(p, end, &i) || !scan_i64(p, end, &j) ||
        (!pattern && !scan_f64(p, end, &v))) {
      delete m;
      set_error("file truncated: expected " + std::to_string(nnz_decl) +
                " entries, got " + std::to_string(k));
      return nullptr;
    }
    --i;
    --j;
    if (i < 0 || i >= n_rows || j < 0 || j >= n_cols) {
      delete m;
      set_error("index out of declared matrix bounds");
      return nullptr;
    }
    m->I.push_back((int32_t)i);
    m->J.push_back((int32_t)j);
    m->vals.push_back(v);
  }

  // symmetric expansion: mirror off-diagonals, appended in original order
  // (reference utilities.hpp:2213-2267)
  if (symmetric || skew) {
    const double sign = skew ? -1.0 : 1.0;
    const int64_t n0 = (int64_t)m->I.size();
    for (int64_t k = 0; k < n0; ++k) {
      if (m->I[k] != m->J[k]) {
        m->I.push_back(m->J[k]);
        m->J.push_back(m->I[k]);
        m->vals.push_back(sign * m->vals[k]);
      }
    }
  }
  stable_row_sort(m);
  return m;
}

USPMV_API void uspmv_mtx_sizes(const MtxHandle* m, int64_t* n_rows,
                               int64_t* n_cols, int64_t* nnz,
                               int32_t* is_symmetric) {
  *n_rows = m->n_rows;
  *n_cols = m->n_cols;
  *nnz = (int64_t)m->I.size();
  *is_symmetric = m->is_symmetric;
}

USPMV_API void uspmv_mtx_fetch(const MtxHandle* m, int32_t* I, int32_t* J,
                               double* vals) {
  memcpy(I, m->I.data(), m->I.size() * sizeof(int32_t));
  memcpy(J, m->J.data(), m->J.size() * sizeof(int32_t));
  memcpy(vals, m->vals.data(), m->vals.size() * sizeof(double));
}

USPMV_API void uspmv_mtx_free(MtxHandle* m) { delete m; }

// ---------------------------------------------------------------------------
// SELL-C-sigma converter
// ---------------------------------------------------------------------------

struct ScsHandle {
  int64_t n_rows = 0;
  int64_t n_rows_padded = 0;
  int64_t n_chunks = 0;
  int64_t n_elements = 0;
  std::vector<int32_t> chunk_ptrs;     // n_chunks + 1
  std::vector<int32_t> chunk_lengths;  // n_chunks
  std::vector<int32_t> col_idxs;       // n_elements
  std::vector<double> values;          // n_elements
  std::vector<int32_t> old_to_new;     // n_rows
  std::vector<int32_t> new_to_old;     // n_rows_padded (-1 at padding)
  std::vector<int32_t> row_counts_new; // n_rows_padded
};

// COO (row indices need not be sorted; element order within a row is
// preserved) -> SCS. Mirrors uspmv_tpu/formats/scs.py:convert_to_scs /
// reference utilities.hpp:1842-2104. fixed_perm: old->new of length
// >= n_rows, or null.
USPMV_API ScsHandle* uspmv_convert_to_scs(
    int64_t n_rows, int64_t nnz, const int32_t* I, const int32_t* J,
    const double* vals, int64_t C, int64_t sigma, const int32_t* fixed_perm) {
  if (C < 1 || sigma < 1) {
    set_error("C and sigma must be >= 1");
    return nullptr;
  }
  const int64_t n_chunks = (n_rows + C - 1) / C;
  const int64_t n_rows_padded = n_chunks * C;

  std::vector<int64_t> counts(n_rows_padded, 0);
  for (int64_t e = 0; e < nnz; ++e) ++counts[I[e]];

  std::vector<int32_t> old_to_new(n_rows);
  std::vector<int64_t> counts_sorted(n_rows_padded);
  if (fixed_perm) {
    for (int64_t r = 0; r < n_rows; ++r) old_to_new[r] = fixed_perm[r];
    std::fill(counts_sorted.begin(), counts_sorted.end(), 0);
    for (int64_t r = 0; r < n_rows; ++r) counts_sorted[old_to_new[r]] = counts[r];
  } else {
    // per sigma-window descending-count sort, stable on original index
    std::vector<int64_t> order(n_rows_padded);
    std::iota(order.begin(), order.end(), 0);
    for (int64_t lo = 0; lo < n_rows_padded; lo += sigma) {
      const int64_t hi = std::min(lo + sigma, n_rows_padded);
      std::stable_sort(order.begin() + lo, order.begin() + hi,
                       [&](int64_t a, int64_t b) { return counts[a] > counts[b]; });
    }
    std::vector<int32_t> o2n_full(n_rows_padded);
    for (int64_t k = 0; k < n_rows_padded; ++k) {
      o2n_full[order[k]] = (int32_t)k;
      counts_sorted[k] = counts[order[k]];
    }
    for (int64_t r = 0; r < n_rows; ++r) old_to_new[r] = o2n_full[r];
  }

  auto* s = new ScsHandle;
  s->n_rows = n_rows;
  s->n_rows_padded = n_rows_padded;
  s->n_chunks = n_chunks;
  s->chunk_lengths.resize(n_chunks);
  s->chunk_ptrs.resize(n_chunks + 1);
  int64_t run = 0;
  for (int64_t c = 0; c < n_chunks; ++c) {
    int64_t mx = 0;
    for (int64_t i = 0; i < C; ++i)
      mx = std::max(mx, counts_sorted[c * C + i]);
    s->chunk_lengths[c] = (int32_t)mx;
    s->chunk_ptrs[c] = (int32_t)run;
    run += mx * C;
    if (run > INT32_MAX) {
      delete s;
      set_error("SCS element count exceeds int32 (reference overflow guard, "
                "utilities.hpp:105-190)");
      return nullptr;
    }
  }
  s->chunk_ptrs[n_chunks] = (int32_t)run;
  s->n_elements = run;

  s->values.assign(run, 0.0);
  s->col_idxs.assign(run, 0);
  // scatter in input order with per-(new)row running counters
  std::vector<int64_t> kctr(n_rows_padded, 0);
  for (int64_t e = 0; e < nnz; ++e) {
    const int64_t rn = old_to_new[I[e]];
    const int64_t idx = (int64_t)s->chunk_ptrs[rn / C] + kctr[rn]++ * C + rn % C;
    s->values[idx] = vals[e];
    s->col_idxs[idx] = J[e];
  }

  s->old_to_new = std::move(old_to_new);
  s->new_to_old.assign(n_rows_padded, -1);
  for (int64_t r = 0; r < n_rows; ++r) s->new_to_old[s->old_to_new[r]] = (int32_t)r;
  s->row_counts_new.resize(n_rows_padded);
  for (int64_t k = 0; k < n_rows_padded; ++k)
    s->row_counts_new[k] = (int32_t)counts_sorted[k];
  return s;
}

USPMV_API void uspmv_scs_sizes(const ScsHandle* s, int64_t* n_rows,
                               int64_t* n_rows_padded, int64_t* n_chunks,
                               int64_t* n_elements) {
  *n_rows = s->n_rows;
  *n_rows_padded = s->n_rows_padded;
  *n_chunks = s->n_chunks;
  *n_elements = s->n_elements;
}

USPMV_API void uspmv_scs_fetch(const ScsHandle* s, int32_t* chunk_ptrs,
                               int32_t* chunk_lengths, int32_t* col_idxs,
                               double* values, int32_t* old_to_new,
                               int32_t* new_to_old, int32_t* row_counts_new) {
  memcpy(chunk_ptrs, s->chunk_ptrs.data(), s->chunk_ptrs.size() * 4);
  memcpy(chunk_lengths, s->chunk_lengths.data(), s->chunk_lengths.size() * 4);
  memcpy(col_idxs, s->col_idxs.data(), s->col_idxs.size() * 4);
  if (values) memcpy(values, s->values.data(), s->values.size() * 8);
  memcpy(old_to_new, s->old_to_new.data(), s->old_to_new.size() * 4);
  memcpy(new_to_old, s->new_to_old.data(), s->new_to_old.size() * 4);
  memcpy(row_counts_new, s->row_counts_new.data(), s->row_counts_new.size() * 4);
}

// Dtype-aware value fetch: the padded value array can be many times nnz
// (every chunk pads to its longest row); casting during the copy keeps one
// pass and no intermediate f64 buffer.
USPMV_API void uspmv_scs_fetch_vals_f32(const ScsHandle* s, float* values) {
  const double* src = s->values.data();
  const int64_t n = (int64_t)s->values.size();
  for (int64_t i = 0; i < n; ++i) values[i] = (float)src[i];
}

USPMV_API void uspmv_scs_free(ScsHandle* s) { delete s; }

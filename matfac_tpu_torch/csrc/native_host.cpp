// Host-side helpers of matfac_tpu_torch: the GKlib-text CSR parser and
// the item-item cosine top-k graph, with OpenMP.
//
// The port's own copy of native/matfac_native.cpp, the JAX package's
// host library: the same entry points (mfio_parse_csr_count,
// mfio_parse_csr_fill, mfio_item_cosine_topk2) and the same code, built
// by matfac_tpu_torch/ops/_build.py with g++ and the flags of
// native/Makefile, so that the two libraries compute the same bits
// (tests/test_torch_native.py holds them to each other). It is host C++,
// not a CUDA kernel: no TPU kernel of the JAX package stands behind it.
// Bound through ctypes by matfac_tpu_torch/utils/native.py.

#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

// Read a whole file into a buffer (with one extra NUL).
static char* read_file(const char* path, size_t* len_out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  std::fseek(f, 0, SEEK_END);
  long len = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (len < 0) { std::fclose(f); return nullptr; }
  char* buf = static_cast<char*>(std::malloc(len + 1));
  if (!buf) { std::fclose(f); return nullptr; }
  size_t rd = std::fread(buf, 1, len, f);
  std::fclose(f);
  if (rd != static_cast<size_t>(len)) { std::free(buf); return nullptr; }
  buf[len] = '\0';
  *len_out = len;
  return buf;
}

static inline const char* skip_ws(const char* p, const char* end) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
  return p;
}

// Fast float parse (accepts int, decimal, exponent). Falls back to
// strtod for exotic forms.
static inline double parse_val(const char** pp, const char* end) {
  char* q;
  double v = std::strtod(*pp, &q);
  (void)end;
  *pp = q;
  return v;
}

static inline long parse_int(const char** pp) {
  char* q;
  long v = std::strtol(*pp, &q, 10);
  *pp = q;
  return v;
}

}  // namespace

extern "C" {

// Pass 1: count rows and entries of a GKlib-text CSR file.
// Returns nnz (>=0) or -1 on error; *nrows_out receives the row count.
long long mfio_parse_csr_count(const char* path, int with_values,
                               long long* nrows_out) {
  size_t len = 0;
  char* buf = read_file(path, &len);
  if (!buf) return -1;
  const char* end = buf + len;

  long long nrows = 0, ntokens = 0;
  // count newline-terminated rows + whitespace-separated tokens
  const char* p = buf;
  bool in_token = false, line_has_any = false, last_line_open = false;
  while (p < end) {
    char ch = *p++;
    if (ch == '\n') {
      nrows++;
      in_token = false;
      line_has_any = false;
      last_line_open = false;
    } else if (ch == ' ' || ch == '\t' || ch == '\r') {
      in_token = false;
    } else {
      if (!in_token) {
        ntokens++;
        in_token = true;
      }
      line_has_any = true;
      last_line_open = true;
    }
  }
  if (last_line_open) nrows++;  // file without trailing newline
  std::free(buf);
  *nrows_out = nrows;
  long long per = with_values ? 2 : 1;
  if (ntokens % per != 0) return -1;
  return ntokens / per;
}

// Pass 2: fill indptr[nrows+1], cols[nnz], vals[nnz] (vals untouched if
// with_values == 0). nrows/nnz are the pass-1 counts and bound every
// write: a malformed token (non-numeric — strtol/strtod would leave the
// cursor in place and loop forever) or a count mismatch returns nonzero
// instead of overrunning the caller's buffers. Returns 0 on success.
int mfio_parse_csr_fill(const char* path, int with_values,
                        long long nrows, long long nnz,
                        long long* indptr, int32_t* cols, float* vals) {
  size_t len = 0;
  char* buf = read_file(path, &len);
  if (!buf) return 1;
  const char* end = buf + len;

  long long row = 0, e = 0;
  indptr[0] = 0;
  const char* p = buf;
  int rc = 0;
  while (p < end && rc == 0) {
    // one line
    const char* line_end = static_cast<const char*>(
        memchr(p, '\n', end - p));
    if (!line_end) line_end = end;
    const char* q = p;
    while (true) {
      q = skip_ws(q, line_end);
      if (q >= line_end) break;
      if (e >= nnz) { rc = 2; break; }  // more entries than pass 1 saw
      const char* before = q;
      long col = parse_int(&q);
      if (q == before) { rc = 3; break; }  // non-numeric token
      cols[e] = static_cast<int32_t>(col);
      if (with_values) {
        q = skip_ws(q, line_end);
        before = q;
        vals[e] = static_cast<float>(parse_val(&q, line_end));
        if (q == before) { rc = 3; break; }
      }
      e++;
    }
    if (rc != 0) break;
    if (row >= nrows) { rc = 2; break; }
    row++;
    indptr[row] = e;
    p = line_end + 1;
  }
  std::free(buf);
  if (rc == 0 && (e != nnz || row > nrows)) rc = 2;
  if (rc == 0) {
    for (long long r = row; r < nrows; ++r) indptr[r + 1] = e;
  }
  return rc;
}

// Item-item cosine-similarity top-k graph (writeItemSimMatPar analog,
// io.cpp:943-1060): two-hop accumulation needing both the CSC
// (item-major) and CSR (user-major) views of the train matrix; OpenMP
// over items. Outputs top_k neighbors per item (out_cols -1-padded).
int mfio_item_cosine_topk2(long long n_items, long long n_users,
                           const long long* colptr, const int32_t* rowind,
                           const float* colval, const long long* rowptr,
                           const int32_t* colind, const float* rowval,
                           int top_k, int32_t* out_cols,
                           float* out_vals) {
  std::vector<double> norms(n_items, 0.0);
  for (long long i = 0; i < n_items; ++i) {
    double s = 0;
    for (long long jj = colptr[i]; jj < colptr[i + 1]; ++jj)
      s += static_cast<double>(colval[jj]) * colval[jj];
    norms[i] = s > 0 ? std::sqrt(s) : 1.0;
  }

#ifdef _OPENMP
#pragma omp parallel
#endif
  {
    std::vector<double> acc(n_items, 0.0);
    std::vector<char> seen(n_items, 0);
    std::vector<int32_t> touched;
    touched.reserve(4096);
#ifdef _OPENMP
#pragma omp for schedule(dynamic, 16)
#endif
    for (long long i = 0; i < n_items; ++i) {
      touched.clear();
      for (long long uu = colptr[i]; uu < colptr[i + 1]; ++uu) {
        int32_t u = rowind[uu];
        double vi = colval[uu];
        for (long long jj = rowptr[u]; jj < rowptr[u + 1]; ++jj) {
          int32_t j = colind[jj];
          if (j == i) continue;
          // membership via a seen flag: an accumulator that transits
          // through exactly 0.0 must not be double-inserted
          if (!seen[j]) { seen[j] = 1; touched.push_back(j); }
          acc[j] += vi * static_cast<double>(rowval[jj]);
        }
      }
      // top-k selection over touched
      int k = top_k;
      for (int t = 0; t < k; ++t) {
        out_cols[i * top_k + t] = -1;
        out_vals[i * top_k + t] = 0.0f;
      }
      for (int32_t j : touched) {
        double sim = acc[j] / (norms[i] * norms[j]);
        acc[j] = 0.0;
        seen[j] = 0;
        // insertion into the running top-k (k is small)
        int pos = -1;
        for (int t = 0; t < k; ++t) {
          if (sim > out_vals[i * top_k + t] ||
              out_cols[i * top_k + t] < 0) {
            pos = t;
            break;
          }
        }
        if (pos >= 0) {
          for (int t = k - 1; t > pos; --t) {
            out_cols[i * top_k + t] = out_cols[i * top_k + t - 1];
            out_vals[i * top_k + t] = out_vals[i * top_k + t - 1];
          }
          out_cols[i * top_k + pos] = j;
          out_vals[i * top_k + pos] = static_cast<float>(sim);
        }
      }
    }
  }
  return 0;
}

}  // extern "C"

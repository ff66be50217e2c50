// traceback: native full-matrix Smith-Waterman affine-gap fill with packed
// traceback states, for top-k hit re-alignment.
//
// The reference deliberately dropped traceback (score-only engine; SURVEY.md
// §0), but the north star restores it for the best hits. The hot database
// scan stays on the GPU (ops/swa_cuda.py); this kernel serves the O(k)
// re-alignment phase, where per-pair latency (not batch throughput) matters.
//
// Recurrence identical to ops/oracle.py and the reference
// (src/alignment.c:122-161): H folds E/F at the diagonal, all matrices
// floored at zero, tie priority H > E > F. Each cell's three 2-bit
// predecessor states pack into one byte: tb_h | tb_e<<2 | tb_f<<4.
//
// Structure per row (mirrors the NumPy fill in ops/traceback.py so both
// paths are bit-identical): pass A computes H/E — they depend only on the
// previous row, so the loop is branchless and auto-vectorizes; pass B runs
// the horizontal-gap prefix scan F[i] = max(0, max(H,E)[i-1]+go, F[i-1]+ge)
// (2-op dependent chain); pass C derives F's traceback sources and the
// row maximum vectorized. Exposed via plain C ABI for ctypes.

#include <cstdint>
#include <cstdlib>
#include <cstring>

namespace {
inline int32_t imax(int32_t a, int32_t b) { return a > b ? a : b; }
}

extern "C" {

// q, d: encoded sequences (values 0..31). table: 32x32 int8 row-major.
// go = gap_open + gap_extend (length-1 gap cost), ge = gap_extend.
// states: caller-allocated (lb+1)*(lq+1) bytes; row j at states + j*(lq+1).
// best_j/best_i: position of the running-max H cell (first encountered,
// scanning j outer / i inner — matches the NumPy fill's argmax order).
// Returns the best score, or INT64_MIN on allocation failure.
int64_t sw_tb_fill(const int8_t* q, int64_t lq, const int8_t* d, int64_t lb,
                   const int8_t* table, int32_t go, int32_t ge,
                   uint8_t* states, int64_t* best_j, int64_t* best_i) {
  const int64_t w = lq + 1;
  int32_t* h_prev = static_cast<int32_t*>(calloc(w, sizeof(int32_t)));
  int32_t* e_prev = static_cast<int32_t*>(calloc(w, sizeof(int32_t)));
  int32_t* f_prev = static_cast<int32_t*>(calloc(w, sizeof(int32_t)));
  int32_t* h_cur = static_cast<int32_t*>(calloc(w, sizeof(int32_t)));
  int32_t* e_cur = static_cast<int32_t*>(calloc(w, sizeof(int32_t)));
  int32_t* f_cur = static_cast<int32_t*>(calloc(w, sizeof(int32_t)));
  int32_t* srow32 = static_cast<int32_t*>(calloc(w, sizeof(int32_t)));
  if (!h_prev || !e_prev || !f_prev || !h_cur || !e_cur || !f_cur || !srow32) {
    free(h_prev); free(e_prev); free(f_prev);
    free(h_cur); free(e_cur); free(f_cur); free(srow32);
    return INT64_MIN;
  }
  // No memset: every (j>=1, i>=1) byte is written below, and the walkback
  // never reads row 0 / column 0.

  int32_t best = 0;
  int64_t bj = 0, bi = 0;
  for (int64_t j = 1; j <= lb; ++j) {
    // Substitution scores widened once (helps pass A vectorize).
    // NB: the convention is table[q_char][d_char] (row = QUERY character),
    // matching the NumPy fill and the oracle — asymmetric matrices depend
    // on this orientation.
    const int64_t dj = static_cast<int64_t>(d[j - 1]);
    uint8_t* st = states + j * w;
    for (int64_t i = 0; i < lq; ++i)
      srow32[i] = table[static_cast<int64_t>(q[i]) * 32 + dj];

    // Pass A: H and E from the previous row only — branchless, SIMD-able.
    h_cur[0] = e_cur[0] = f_cur[0] = 0;
    for (int64_t i = 1; i <= lq; ++i) {
      int32_t dh = h_prev[i - 1], de = e_prev[i - 1], df = f_prev[i - 1];
      int32_t m = imax(dh, de);
      uint32_t hs = de > dh ? 2u : 1u;
      hs = df > m ? 3u : hs;
      m = imax(m, df);
      int32_t hv = m + srow32[i - 1];
      hs = hv < 0 ? 0u : hs;
      hv = imax(hv, 0);

      int32_t eh = h_prev[i] + go, ee = e_prev[i] + ge, ef = f_prev[i] + go;
      int32_t ev = imax(eh, ee);
      uint32_t es = ee > eh ? 2u : 1u;
      es = ef > ev ? 3u : es;
      ev = imax(ev, ef);
      es = ev < 0 ? 0u : es;
      ev = imax(ev, 0);

      h_cur[i] = hv;
      e_cur[i] = ev;
      st[i] = static_cast<uint8_t>(hs | (es << 2));
    }

    // Pass B: horizontal-gap scan (the only intra-row dependence; 2-op
    // latency chain). carry = unfloored prefix max; F = max(0, carry).
    {
      int32_t carry = INT32_MIN / 2;
      for (int64_t i = 1; i <= lq; ++i) {
        carry = imax(imax(h_cur[i - 1], e_cur[i - 1]) + go, carry + ge);
        f_cur[i] = imax(carry, 0);
      }
    }

    // Pass C: F sources (priority H > E > F, 0 when floored) and the row
    // max — branchless, SIMD-able.
    int32_t rowmax = 0;
    for (int64_t i = 1; i <= lq; ++i) {
      int32_t fh = h_cur[i - 1] + go;
      int32_t fe = e_cur[i - 1] + go;
      int32_t ff = f_cur[i - 1] + ge;
      uint32_t fs = fe > fh ? 2u : 1u;
      fs = ff > imax(fh, fe) ? 3u : fs;
      fs = f_cur[i] == 0 ? 0u : fs;
      st[i] = static_cast<uint8_t>(st[i] | (fs << 4));
      rowmax = imax(rowmax, h_cur[i]);
    }
    if (rowmax > best) {
      best = rowmax;
      bj = j;
      for (int64_t i = 1; i <= lq; ++i) {
        if (h_cur[i] == rowmax) { bi = i; break; }
      }
    }
    int32_t* t;
    t = h_prev; h_prev = h_cur; h_cur = t;
    t = e_prev; e_prev = e_cur; e_cur = t;
    t = f_prev; f_prev = f_cur; f_cur = t;
  }
  free(h_prev); free(e_prev); free(f_prev);
  free(h_cur); free(e_cur); free(f_cur); free(srow32);
  *best_j = bj;
  *best_i = bi;
  return best;
}

// Score-only forward pass: returns the best score and its cell (first
// encountered in j-outer/i-inner order) without materializing any traceback
// state. Used to localize an alignment's END cell in O(min(lq,lb)) memory;
// the caller then re-runs the reverse pass on a small window to find the
// START, and fills traceback states only for the [start..end] rectangle —
// the linear-space recompute strategy that replaces full-matrix fills for
// huge pairs.
int64_t sw_tb_ends(const int8_t* q, int64_t lq, const int8_t* d, int64_t lb,
                   const int8_t* table, int32_t go, int32_t ge,
                   int64_t* best_j, int64_t* best_i) {
  const int64_t w = lq + 1;
  int32_t* h_prev = static_cast<int32_t*>(calloc(w, sizeof(int32_t)));
  int32_t* e_prev = static_cast<int32_t*>(calloc(w, sizeof(int32_t)));
  int32_t* f_prev = static_cast<int32_t*>(calloc(w, sizeof(int32_t)));
  int32_t* h_cur = static_cast<int32_t*>(calloc(w, sizeof(int32_t)));
  int32_t* e_cur = static_cast<int32_t*>(calloc(w, sizeof(int32_t)));
  int32_t* f_cur = static_cast<int32_t*>(calloc(w, sizeof(int32_t)));
  int32_t* srow32 = static_cast<int32_t*>(calloc(w, sizeof(int32_t)));
  if (!h_prev || !e_prev || !f_prev || !h_cur || !e_cur || !f_cur || !srow32) {
    free(h_prev); free(e_prev); free(f_prev);
    free(h_cur); free(e_cur); free(f_cur); free(srow32);
    return INT64_MIN;
  }
  int32_t best = 0;
  int64_t bj = 0, bi = 0;
  for (int64_t j = 1; j <= lb; ++j) {
    const int64_t dj = static_cast<int64_t>(d[j - 1]);
    for (int64_t i = 0; i < lq; ++i)
      srow32[i] = table[static_cast<int64_t>(q[i]) * 32 + dj];
    h_cur[0] = e_cur[0] = f_cur[0] = 0;
    for (int64_t i = 1; i <= lq; ++i) {
      int32_t m = imax(imax(h_prev[i - 1], e_prev[i - 1]), f_prev[i - 1]);
      h_cur[i] = imax(m + srow32[i - 1], 0);
      int32_t ev = imax(imax(h_prev[i] + go, e_prev[i] + ge),
                        f_prev[i] + go);
      e_cur[i] = imax(ev, 0);
    }
    {
      int32_t carry = INT32_MIN / 2;
      for (int64_t i = 1; i <= lq; ++i) {
        carry = imax(imax(h_cur[i - 1], e_cur[i - 1]) + go, carry + ge);
        f_cur[i] = imax(carry, 0);
      }
    }
    int32_t rowmax = 0;
    for (int64_t i = 1; i <= lq; ++i) rowmax = imax(rowmax, h_cur[i]);
    if (rowmax > best) {
      best = rowmax;
      bj = j;
      for (int64_t i = 1; i <= lq; ++i) {
        if (h_cur[i] == rowmax) { bi = i; break; }
      }
    }
    int32_t* t;
    t = h_prev; h_prev = h_cur; h_cur = t;
    t = e_prev; e_prev = e_cur; e_cur = t;
    t = f_prev; f_prev = f_cur; f_cur = t;
  }
  free(h_prev); free(e_prev); free(f_prev);
  free(h_cur); free(e_cur); free(f_cur); free(srow32);
  *best_j = bj;
  *best_i = bi;
  return best;
}

}  // extern "C"

// fastio: native FASTA/FASTQ parsing, encoding, and lane-batch packing.
//
// Native replacement for the reference's vendored C seq_file library
// (L0 in SURVEY.md; used by the reference driver at
// src/alignment_cmdline.c:335-457) plus the driver's per-record encode+pack
// loops (src/alignment_cmdline.c:444-450). Exposed to Python via a plain C
// ABI consumed with ctypes (no pybind11 in this environment).
//
// Semantics match seqalign.utils.fasta / packing:
//  - FASTA ('>') and FASTQ ('@') autodetected; gzip autodetected (zlib).
//  - Sequence characters encoded a-z/A-Z -> 1..26, '*' -> 31; any other
//    character is a fatal parse error (code -2), matching letters_to_index
//    (reference src/alignment_scoring.c:70-81).
//  - pack_batch fills a '*'-padded (lb_pad, lanes) int8 buffer position-major
//    (db[pos * lanes + lane]), the reference's lane-major layout scaled up.
//
// Performance notes (the GPU kernel consumes >1 Gres/s, so host ingest must
// not be the pipeline's long pole):
//  - Plain files are read with one sized fread (gzip detected by magic and
//    routed through zlib); the encode pass writes through a raw pointer into
//    a single pre-sized buffer instead of per-byte vector growth.
//  - pack writes are tiled: a position-major store stream has stride `lanes`
//    (hundreds of lanes), i.e. one cache line touched per byte if written
//    directly. Records are instead gathered into an L1-resident tile and the
//    tile's rows are flushed with contiguous copies, keeping every DRAM
//    access sequential.

#include <unistd.h>  // dup (non-seekable-input gzdopen route)
#include <zlib.h>

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <string>
#include <vector>

#ifdef __AVX2__
#include <immintrin.h>
#endif

namespace {

constexpr int8_t kPad = 31;  // '*'

int8_t encode_lut[256];

struct LutInit {
  LutInit() {
    memset(encode_lut, -1, sizeof(encode_lut));
    for (int c = 'a'; c <= 'z'; ++c) encode_lut[c] = static_cast<int8_t>(c - 96);
    for (int c = 'A'; c <= 'Z'; ++c) encode_lut[c] = static_cast<int8_t>(c - 64);
    encode_lut[static_cast<int>('*')] = kPad;
  }
} lut_init;

struct ParseResult {
  std::unique_ptr<int8_t[]> seq;  // concatenated encoded residues
  int64_t seq_len = 0;
  std::vector<int64_t> offsets;   // N+1 offsets into seq
  std::string names;             // concatenated names, '\n'-separated
  int64_t n = 0;
};

bool read_all_gzfile(gzFile f, std::string* out) {
  gzbuffer(f, 1 << 20);
  char buf[1 << 20];
  int n;
  while ((n = gzread(f, buf, sizeof(buf))) > 0) out->append(buf, n);
  bool ok = n == 0;
  gzclose(f);
  return ok;
}

bool read_all_gz(const char* path, std::string* out) {
  gzFile f = gzopen(path, "rb");
  if (f == nullptr) return false;
  return read_all_gzfile(f, out);
}

// Reads the whole file. Gzip (magic 1f 8b) goes through zlib; plain files
// are read with a single sized fread. Non-seekable inputs (FIFOs/pipes)
// cannot afford the 2-byte magic probe (the bytes would be lost on
// reopen), so they hand their descriptor straight to zlib, which reads
// gzip AND plain data transparently.
bool read_all(const char* path, std::string* out) {
  FILE* f = fopen(path, "rb");
  if (f == nullptr) return false;
  if (fseek(f, 0, SEEK_CUR) != 0) {  // non-seekable
    gzFile g = gzdopen(dup(fileno(f)), "rb");
    fclose(f);
    if (g == nullptr) return false;
    return read_all_gzfile(g, out);
  }
  unsigned char magic[2];
  const size_t m = fread(magic, 1, 2, f);
  if (m == 2 && magic[0] == 0x1f && magic[1] == 0x8b) {
    fclose(f);
    return read_all_gz(path, out);
  }
  out->append(reinterpret_cast<char*>(magic), m);
  long size = -1;
  if (fseek(f, 0, SEEK_END) == 0) {
    size = ftell(f);
    if (fseek(f, static_cast<long>(m), SEEK_SET) != 0) size = -1;
  }
  bool ok = true;
  if (size >= 0) {
    const size_t body = static_cast<size_t>(size) - m;
    const size_t base = out->size();
#if defined(__cpp_lib_string_resize_and_overwrite)
    // resize_and_overwrite: no zero-fill before fread overwrites the bytes.
    size_t got = 0;
    out->resize_and_overwrite(
        base + body, [&](char* p, size_t want) {
          got = fread(p + base, 1, want - base, f);
          return base + got;
        });
    ok = got == body;
#else
    // Pre-C++23 fallback (zero-fills first; still one sized read).
    out->resize(base + body);
    const size_t got = body ? fread(&(*out)[base], 1, body, f) : 0;
    out->resize(base + got);
    ok = got == body;
#endif
  } else {  // cannot determine size: chunked append
    char buf[1 << 20];
    size_t n;
    while ((n = fread(buf, 1, sizeof(buf), f)) > 0) out->append(buf, n);
    ok = !ferror(f);
  }
  fclose(f);
  return ok;
}

// Scalar reference encode for a [i, eol) span (skipping '\r'/' '/'\t').
inline bool encode_span_scalar(const char* data, size_t i, size_t eol,
                               int8_t** wp) {
  int8_t* w = *wp;
  for (size_t k = i; k < eol; ++k) {
    const unsigned char c = data[k];
    if (c == '\r' || c == ' ' || c == '\t') continue;
    const int8_t e = encode_lut[c];
    if (e < 0) return false;
    *w++ = e;
  }
  *wp = w;
  return true;
}

// Encodes [i, eol) into *wp (skipping '\r'/' '/'\t'), advancing both.
// Returns false on an illegal character.
//
// AVX2 fast path: letters encode as c & 31 ('A'/'a' -> 1 ... 'Z'/'z' -> 26)
// and '*' -> 31, so a 32-byte chunk of pure letters/stars is one load, a
// range test, a mask-blend, and one store. Chunks containing whitespace (to
// be dropped) or anything unrecognized (a fatal parse error) take the scalar
// path, which preserves exact error semantics.
inline bool encode_span(const char* data, size_t i, size_t eol, int8_t** wp) {
#ifdef __AVX2__
  int8_t* w = *wp;
  const __m256i lower_bit = _mm256_set1_epi8(0x20);
  const __m256i below_a = _mm256_set1_epi8('a' - 1);
  const __m256i above_z = _mm256_set1_epi8('z' + 1);
  const __m256i star = _mm256_set1_epi8('*');
  const __m256i mask31 = _mm256_set1_epi8(31);
  while (i + 32 <= eol) {
    const __m256i v =
        _mm256_loadu_si256(reinterpret_cast<const __m256i*>(data + i));
    const __m256i lo = _mm256_or_si256(v, lower_bit);
    const __m256i letter = _mm256_and_si256(
        _mm256_cmpgt_epi8(lo, below_a), _mm256_cmpgt_epi8(above_z, lo));
    const __m256i is_star = _mm256_cmpeq_epi8(v, star);
    const unsigned ok = static_cast<unsigned>(
        _mm256_movemask_epi8(_mm256_or_si256(letter, is_star)));
    if (ok != 0xFFFFFFFFu) {
      // Whitespace or an illegal character somewhere in the chunk.
      if (!encode_span_scalar(data, i, i + 32, &w)) return false;
      i += 32;
      continue;
    }
    // letter -> c & 31, star -> 31.
    const __m256i enc = _mm256_blendv_epi8(
        mask31, _mm256_and_si256(v, mask31), letter);
    _mm256_storeu_si256(reinterpret_cast<__m256i*>(w), enc);
    w += 32;
    i += 32;
  }
  *wp = w;
  return encode_span_scalar(data, i, eol, wp);
#else
  return encode_span_scalar(data, i, eol, wp);
#endif
}

// Returns 0 ok, -1 io error, -2 illegal character, -3 bad format.
int parse(const char* path, ParseResult* res) {
  std::string data;
  if (!read_all(path, &data)) return -1;
  res->offsets.push_back(0);
  size_t i = 0;
  const size_t n = data.size();
  // Every residue comes from the file, so the file size bounds the encoded
  // length; one uninitialized allocation + raw-pointer writes replace
  // per-byte growth (new[] of a POD skips the zero-fill a vector pays).
  res->seq.reset(new int8_t[n ? n : 1]);
  int8_t* wp = res->seq.get();
  const int8_t* const seq_base = wp;
  // Skip leading blank lines.
  while (i < n && (data[i] == '\n' || data[i] == '\r' || data[i] == ' ')) ++i;
  if (i >= n) return 0;  // empty file -> zero records
  const char marker = data[i];
  if (marker != '>' && marker != '@') return -3;
  const bool fastq = marker == '@';
  while (i < n) {
    if (data[i] != marker) return -3;
    ++i;
    size_t eol = data.find('\n', i);
    if (eol == std::string::npos) eol = n;
    size_t name_end = eol;
    while (name_end > i && (data[name_end - 1] == '\r')) --name_end;
    res->names.append(data, i, name_end - i);
    res->names.push_back('\n');
    i = eol + 1;
    if (fastq) {
      size_t seq_eol = data.find('\n', i);
      if (seq_eol == std::string::npos) seq_eol = n;
      if (!encode_span(data.data(), i, seq_eol, &wp)) return -2;
      i = seq_eol + 1;
      // '+' line and quality line.
      size_t plus_eol = data.find('\n', i);
      i = plus_eol == std::string::npos ? n : plus_eol + 1;
      size_t qual_eol = data.find('\n', i);
      i = qual_eol == std::string::npos ? n : qual_eol + 1;
      // Skip blank lines between records.
      while (i < n && (data[i] == '\n' || data[i] == '\r')) ++i;
    } else {
      while (i < n && data[i] != marker) {
        size_t line_eol = data.find('\n', i);
        if (line_eol == std::string::npos) line_eol = n;
        if (!encode_span(data.data(), i, line_eol, &wp)) return -2;
        i = line_eol + 1;
      }
    }
    res->offsets.push_back(static_cast<int64_t>(wp - seq_base));
    res->n += 1;
  }
  res->seq_len = static_cast<int64_t>(wp - seq_base);
  return 0;
}

// Incremental (chunked) reader: bounded-memory parsing for databases that
// do not fit in RAM (pipeline.search_files_streaming). Same record/encode
// semantics as parse(); gzip handled transparently by zlib.
struct StreamState {
  gzFile f = nullptr;
  std::string buf;  // buffered unconsumed bytes
  size_t pos = 0;
  bool eof = false;
  char marker = 0;  // record marker ('>' / '@') once detected
  bool started = false;
};

// Appends more data; returns false at EOF or on a read error (err set).
bool refill(StreamState* st, int* err) {
  if (st->eof) return false;
  if (st->pos > (1u << 20) && st->pos * 2 > st->buf.size()) {
    st->buf.erase(0, st->pos);  // compact consumed prefix
    st->pos = 0;
  }
  char tmp[1 << 20];
  const int n = gzread(st->f, tmp, sizeof(tmp));
  if (n < 0) {
    *err = -1;
    st->eof = true;
    return false;
  }
  if (n == 0) {
    st->eof = true;
    return false;
  }
  st->buf.append(tmp, n);
  return true;
}

// Byte available at pos? (refilling as needed)
inline bool have_byte(StreamState* st, int* err) {
  while (st->pos >= st->buf.size()) {
    if (!refill(st, err)) return false;
  }
  return true;
}

// End of the line starting at pos (index of '\n' or buffer end at EOF).
// `searched` is tracked relative to pos because refill() may compact the
// buffer and shift absolute indices.
size_t line_end(StreamState* st, int* err) {
  size_t searched = 0;
  for (;;) {
    const size_t e = st->buf.find('\n', st->pos + searched);
    if (e != std::string::npos) return e;
    searched = st->buf.size() - st->pos;
    if (!refill(st, err)) return st->buf.size();
  }
}

// Chunked results grow seq dynamically (chunk size is bounded).
struct ParseResult2 {
  std::vector<int8_t> seq;
  std::vector<int64_t> offsets;
  std::string names;
  int64_t n = 0;
};

// Encodes the line at pos into res->seq (growing it), advancing past the
// newline. Returns false on an illegal character.
bool encode_line(StreamState* st, ParseResult2* res, int* err) {
  const size_t eol = line_end(st, err);
  const size_t old = res->seq.size();
  res->seq.resize(old + (eol - st->pos));
  int8_t* w = res->seq.data() + old;
  if (!encode_span(st->buf.data(), st->pos, eol, &w)) {
    *err = -2;
    return false;
  }
  res->seq.resize(w - res->seq.data());
  st->pos = eol + 1;
  if (st->pos > st->buf.size()) st->pos = st->buf.size();
  return true;
}

// Skips one full line (FASTQ '+' and quality lines).
void skip_line(StreamState* st, int* err) {
  const size_t eol = line_end(st, err);
  st->pos = eol + 1;
  if (st->pos > st->buf.size()) st->pos = st->buf.size();
}

// Parses up to max_records records into *res. Returns 0 ok (possibly zero
// records at clean EOF), else the error code.
int parse_chunk(StreamState* st, int64_t max_records, ParseResult2* res) {
  int err = 0;
  res->offsets.push_back(0);
  if (!st->started) {
    // Skip leading blank lines.
    while (have_byte(st, &err)) {
      const char c = st->buf[st->pos];
      if (c == '\n' || c == '\r' || c == ' ') {
        ++st->pos;
        continue;
      }
      break;
    }
    if (err) return err;
    if (st->eof && st->pos >= st->buf.size()) return 0;  // empty input
    st->marker = st->buf[st->pos];
    if (st->marker != '>' && st->marker != '@') return -3;
    st->started = true;
  }
  const bool fastq = st->marker == '@';
  while (res->n < max_records) {
    if (!have_byte(st, &err)) break;  // clean EOF (or err set)
    if (st->buf[st->pos] != st->marker) return -3;
    ++st->pos;
    // Name line.
    const size_t eol = line_end(st, &err);
    size_t name_end = eol;
    while (name_end > st->pos && st->buf[name_end - 1] == '\r') --name_end;
    res->names.append(st->buf, st->pos, name_end - st->pos);
    res->names.push_back('\n');
    st->pos = eol + 1;
    if (st->pos > st->buf.size()) st->pos = st->buf.size();
    if (fastq) {
      if (!encode_line(st, res, &err)) return err;
      skip_line(st, &err);  // '+'
      skip_line(st, &err);  // quality
      while (have_byte(st, &err)) {  // blank lines between records
        const char c = st->buf[st->pos];
        if (c == '\n' || c == '\r') {
          ++st->pos;
          continue;
        }
        break;
      }
    } else {
      while (have_byte(st, &err) && st->buf[st->pos] != st->marker) {
        if (!encode_line(st, res, &err)) return err;
      }
    }
    if (err) return err;
    res->offsets.push_back(static_cast<int64_t>(res->seq.size()));
    res->n += 1;
  }
  return err;
}

}  // namespace

extern "C" {

// Opens a FASTA/FASTQ file (gzip ok) for chunked reading. Returns a stream
// handle, or nullptr with *err = -1 on open failure.
void* fastio_open(const char* path, int* err) {
  gzFile f = gzopen(path, "rb");
  if (f == nullptr) {
    *err = -1;
    return nullptr;
  }
  gzbuffer(f, 1 << 20);
  auto* st = new StreamState();
  st->f = f;
  *err = 0;
  return st;
}

// Reads up to max_records records. Returns a result handle for
// fastio_fetch/fastio_free, or nullptr at clean EOF (err 0) / on error
// (err -1 io, -2 illegal char, -3 format).
void* fastio_read_chunk(void* stream, int64_t max_records, int64_t* n_records,
                        int64_t* n_residues, int64_t* names_bytes, int* err) {
  auto* st = static_cast<StreamState*>(stream);
  auto* res = new ParseResult2();
  const int rc = parse_chunk(st, max_records, res);
  if (rc != 0 || res->n == 0) {
    delete res;
    *err = rc;
    return nullptr;
  }
  *err = 0;
  *n_records = res->n;
  *n_residues = static_cast<int64_t>(res->seq.size());
  *names_bytes = static_cast<int64_t>(res->names.size());
  return res;
}

// Fetches a chunk produced by fastio_read_chunk (same layout as
// fastio_fetch) and frees it.
void fastio_fetch_chunk(void* handle, int8_t* seq_out, int64_t* offsets_out,
                        char* names_out) {
  auto* res = static_cast<ParseResult2*>(handle);
  if (!res->seq.empty()) memcpy(seq_out, res->seq.data(), res->seq.size());
  memcpy(offsets_out, res->offsets.data(),
         res->offsets.size() * sizeof(int64_t));
  if (!res->names.empty())
    memcpy(names_out, res->names.data(), res->names.size());
  delete res;
}

void fastio_close(void* stream) {
  auto* st = static_cast<StreamState*>(stream);
  if (st->f != nullptr) gzclose(st->f);
  delete st;
}

// Parses path. On success returns a heap handle and fills counts; call
// fastio_fetch to copy data out and fastio_free to release. Returns nullptr
// on failure and sets *err (-1 io, -2 illegal char, -3 format).
void* fastio_parse(const char* path, int64_t* n_records, int64_t* n_residues,
                   int64_t* names_bytes, int* err) {
  auto* res = new ParseResult();
  const int rc = parse(path, res);
  if (rc != 0) {
    delete res;
    *err = rc;
    return nullptr;
  }
  *err = 0;
  *n_records = res->n;
  *n_residues = res->seq_len;
  *names_bytes = static_cast<int64_t>(res->names.size());
  return res;
}

void fastio_fetch(void* handle, int8_t* seq_out, int64_t* offsets_out,
                  char* names_out) {
  auto* res = static_cast<ParseResult*>(handle);
  if (res->seq_len > 0)
    memcpy(seq_out, res->seq.get(), res->seq_len);
  memcpy(offsets_out, res->offsets.data(),
         res->offsets.size() * sizeof(int64_t));
  if (!res->names.empty())
    memcpy(names_out, res->names.data(), res->names.size());
}

void fastio_free(void* handle) { delete static_cast<ParseResult*>(handle); }

#ifdef __SSE2__
// Transposes 16 rows of 16 bytes (classic unpack network; output rows come
// out in natural order — verified by tests/test_native_io.py round-trips).
static inline void tr16x16(const __m128i r[16], __m128i out[16]) {
  __m128i t[16], u[16], v[16];
  for (int k = 0; k < 8; ++k) {
    t[2 * k] = _mm_unpacklo_epi8(r[2 * k], r[2 * k + 1]);
    t[2 * k + 1] = _mm_unpackhi_epi8(r[2 * k], r[2 * k + 1]);
  }
  for (int k = 0; k < 4; ++k) {
    u[4 * k] = _mm_unpacklo_epi16(t[4 * k], t[4 * k + 2]);
    u[4 * k + 1] = _mm_unpackhi_epi16(t[4 * k], t[4 * k + 2]);
    u[4 * k + 2] = _mm_unpacklo_epi16(t[4 * k + 1], t[4 * k + 3]);
    u[4 * k + 3] = _mm_unpackhi_epi16(t[4 * k + 1], t[4 * k + 3]);
  }
  for (int k = 0; k < 2; ++k) {
    for (int j = 0; j < 4; ++j) {
      v[8 * k + 2 * j] = _mm_unpacklo_epi32(u[8 * k + j], u[8 * k + j + 4]);
      v[8 * k + 2 * j + 1] = _mm_unpackhi_epi32(u[8 * k + j], u[8 * k + j + 4]);
    }
  }
  for (int j = 0; j < 8; ++j) {
    out[2 * j] = _mm_unpacklo_epi64(v[j], v[j + 8]);
    out[2 * j + 1] = _mm_unpackhi_epi64(v[j], v[j + 8]);
  }
}
#endif

// Packs the records selected by `order` (n_sel indices) into a '*'-padded
// position-major batch: out[pos * lanes + lane]. out must hold
// lb_pad * lanes bytes and is fully overwritten.
//
// Tiled layout transform: a direct write stream has stride `lanes`, touching
// a fresh cache line per byte. Instead each (kTileP positions x kTileL lanes)
// tile is gathered in L1 and flushed row-by-row with contiguous writes.
// Tiles past every record's end in a lane group are skipped — the upfront
// memset already left them '*'. The gather itself runs 16 lanes x 16
// positions at a time through a register transpose where all 16 records
// cover the position window (the caller feeds length-sorted lanes, so nearly
// always); ragged edges fall back to byte stores.
void fastio_pack(const int8_t* seq, const int64_t* offsets,
                 const int64_t* order, int64_t n_sel, int64_t lanes,
                 int64_t lb_pad, int8_t* out) {
  constexpr int64_t kTileP = 64;
  constexpr int64_t kTileL = 128;  // 8 KiB tile, L1-resident
  memset(out, kPad, static_cast<size_t>(lb_pad) * lanes);
  int8_t tile[kTileP * kTileL];
  for (int64_t l0 = 0; l0 < n_sel; l0 += kTileL) {
    const int64_t lw = n_sel - l0 < kTileL ? n_sel - l0 : kTileL;
    int64_t group_max = 0;
    for (int64_t t = 0; t < lw; ++t) {
      const int64_t rec = order[l0 + t];
      const int64_t len = offsets[rec + 1] - offsets[rec];
      if (len > group_max) group_max = len;
    }
    if (group_max > lb_pad) group_max = lb_pad;
    for (int64_t p0 = 0; p0 < group_max; p0 += kTileP) {
      const int64_t pw = group_max - p0 < kTileP ? group_max - p0 : kTileP;
      memset(tile, kPad, sizeof(tile));
      int64_t ts = 0;
#ifdef __SSE2__
      for (; ts + 16 <= lw; ts += 16) {
        const int8_t* src[16];
        int64_t minlen = pw;  // fast-path extent shared by all 16 lanes
        int64_t len16[16];
        for (int j = 0; j < 16; ++j) {
          const int64_t rec = order[l0 + ts + j];
          const int64_t beg = offsets[rec];
          int64_t len = offsets[rec + 1] - beg - p0;
          if (len < 0) len = 0;
          if (len > pw) len = pw;
          len16[j] = len;
          if (len < minlen) minlen = len;
          src[j] = seq + beg + p0;
        }
        const int64_t fast = minlen & ~int64_t(15);
        for (int64_t pc = 0; pc < fast; pc += 16) {
          __m128i r[16], o[16];
          for (int j = 0; j < 16; ++j)
            r[j] = _mm_loadu_si128(
                reinterpret_cast<const __m128i*>(src[j] + pc));
          tr16x16(r, o);
          for (int j = 0; j < 16; ++j)
            _mm_storeu_si128(
                reinterpret_cast<__m128i*>(tile + (pc + j) * kTileL + ts),
                o[j]);
        }
        for (int j = 0; j < 16; ++j) {  // ragged tails, byte stores
          int8_t* col = tile + ts + j;
          for (int64_t p = fast; p < len16[j]; ++p)
            col[p * kTileL] = src[j][p];
        }
      }
#endif
      for (; ts < lw; ++ts) {
        const int64_t rec = order[l0 + ts];
        const int64_t beg = offsets[rec];
        int64_t len = offsets[rec + 1] - beg - p0;
        if (len <= 0) continue;
        if (len > pw) len = pw;
        const int8_t* src = seq + beg + p0;
        int8_t* col = tile + ts;
        for (int64_t p = 0; p < len; ++p) col[p * kTileL] = src[p];
      }
      int8_t* dst = out + p0 * lanes + l0;
      for (int64_t p = 0; p < pw; ++p)
        memcpy(dst + p * lanes, tile + p * kTileL, lw);
    }
  }
}

}  // extern "C"

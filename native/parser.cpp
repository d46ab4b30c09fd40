// Columnar parser for kmcp search-result TSVs — the profile hot path.
//
// Replaces the per-row Python object parse (kmcp_tpu/profile/core.py
// parse_search_tsv, mirroring the reference's streaming row filter at
// kmcp/cmd/util-profile.go:94-182) with a single pass that emits the
// column arrays the vectorized profiler consumes: per-row group id,
// interned target id, fragment index, query length and qCov, plus
// per-target chunk-count/genome-size and per-group query-id offsets.
// Row filters (qCov >= min, FPR <= max) use strtod, which rounds
// identically to Python's float() for these decimal literals.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_map>

namespace {

struct SV {
  const char* p;
  size_t n;
  bool operator==(const SV& o) const {
    return n == o.n && std::memcmp(p, o.p, n) == 0;
  }
};

struct SVHash {
  size_t operator()(const SV& s) const {
    // FNV-1a
    uint64_t h = 1469598103934665603ull;
    for (size_t i = 0; i < s.n; ++i) {
      h ^= (unsigned char)s.p[i];
      h *= 1099511628211ull;
    }
    return (size_t)h;
  }
};

}  // namespace

extern "C" {

// Parse one file's decompressed content.  Caller allocates the output
// arrays with capacity >= number of '\n' in buf (rows) and a target /
// group capacity of the same size.  Returns 0 on success, -1 on a
// malformed row (fewer than 13 columns).
//
// Outputs (all caller-allocated):
//   row_group[i64], row_target[i32], row_frag[i32], row_qlen[i64],
//   row_qcov[f64]                            — per kept row
//   tgt_off/tgt_len [i64], tgt_idx_num[i32], tgt_gsize[i64]
//                                            — per interned target,
//                                              name as (offset, len) into buf
//   grp_off/grp_len [i64]                    — per group, query id offsets
//   out_counts[5]: n_rows, n_groups, n_targets, total_queries,
//                  n_matched_queries (from '# matched queries:' lines)
int64_t kt_parse_search_tsv(const char* buf, int64_t len, double max_fpr,
                            double min_qcov, int64_t* row_group,
                            int32_t* row_target, int32_t* row_frag,
                            int64_t* row_qlen, double* row_qcov,
                            int64_t* tgt_off, int64_t* tgt_len,
                            int32_t* tgt_idx_num, int64_t* tgt_gsize,
                            int64_t* grp_off, int64_t* grp_len,
                            int64_t* out_counts) {
  std::unordered_map<SV, int32_t, SVHash> intern;
  int64_t n_rows = 0, n_groups = 0, total_queries = 0, matched_queries = 0;
  SV prev_query{nullptr, 0};
  bool have_prev = false;

  const char* p = buf;
  const char* end = buf + len;
  while (p < end) {
    const char* nl = (const char*)memchr(p, '\n', end - p);
    const char* eol = nl ? nl : end;
    if (p == eol) {
      p = eol + 1;
      continue;
    }
    if (*p == '#') {
      // "# input queries: N" / "# matched queries: N"
      static const char kIn[] = "# input queries:";
      static const char kMa[] = "# matched queries:";
      if ((size_t)(eol - p) > sizeof(kIn) - 1 &&
          std::memcmp(p, kIn, sizeof(kIn) - 1) == 0) {
        total_queries += strtoll(p + sizeof(kIn) - 1, nullptr, 10);
      } else if ((size_t)(eol - p) > sizeof(kMa) - 1 &&
                 std::memcmp(p, kMa, sizeof(kMa) - 1) == 0) {
        matched_queries += strtoll(p + sizeof(kMa) - 1, nullptr, 10);
      }
      p = eol + 1;
      continue;
    }
    // split the 13+ needed columns
    const char* col[13];
    size_t cln[13];
    int nc = 0;
    const char* q = p;
    while (nc < 13 && q <= eol) {
      const char* tab = (const char*)memchr(q, '\t', eol - q);
      const char* ce = tab ? tab : eol;
      col[nc] = q;
      cln[nc] = ce - q;
      ++nc;
      if (!tab) break;
      q = ce + 1;
    }
    if (nc < 13) return -1;

    const double qcov = strtod(col[11], nullptr);
    if (qcov >= min_qcov) {
      const double fpr = strtod(col[3], nullptr);
      if (fpr <= max_fpr) {
        const SV query{col[0], cln[0]};
        if (!have_prev || !(query == prev_query)) {
          grp_off[n_groups] = col[0] - buf;
          grp_len[n_groups] = (int64_t)cln[0];
          ++n_groups;
        }
        prev_query = query;
        have_prev = true;

        const SV tname{col[5], cln[5]};
        int32_t tid;
        auto it = intern.find(tname);
        if (it == intern.end()) {
          tid = (int32_t)intern.size();
          intern.emplace(tname, tid);
          tgt_off[tid] = col[5] - buf;
          tgt_len[tid] = (int64_t)cln[5];
          tgt_idx_num[tid] = (int32_t)strtol(col[7], nullptr, 10);
          tgt_gsize[tid] = strtoll(col[8], nullptr, 10);
        } else {
          tid = it->second;
        }
        row_group[n_rows] = n_groups - 1;
        row_target[n_rows] = tid;
        row_frag[n_rows] = (int32_t)strtol(col[6], nullptr, 10);
        row_qlen[n_rows] = strtoll(col[1], nullptr, 10);
        row_qcov[n_rows] = qcov;
        ++n_rows;
      }
    }
    p = eol + 1;
  }
  out_counts[0] = n_rows;
  out_counts[1] = n_groups;
  out_counts[2] = (int64_t)intern.size();
  out_counts[3] = total_queries;
  out_counts[4] = matched_queries;
  return 0;
}

// ------------------------------------------------------------------ merge

// Scan one search-result file for the k-way merge (kmcp merge,
// kmcp/cmd/merge.go:160-260): per data row emit its byte span, the
// hits-column span (rewritten at output time), query-id length
// (column 0 starts at the row offset), queryIdx and the score column.
// '# input queries/matched queries' stat lines accumulate into
// out_counts[1..2]; out_counts[0] = number of rows.  Returns 0, or -1
// on a row with fewer than 15 columns.
int64_t kt_merge_scan(const char* buf, int64_t len, int score_col,
                      int64_t* row_off, int64_t* row_len,
                      int64_t* hits_off, int64_t* hits_len,
                      int64_t* qid_len, int64_t* qidx, double* score,
                      int64_t* out_counts) {
  int64_t n_rows = 0, total_queries = 0, matched_queries = 0;
  const char* p = buf;
  const char* end = buf + len;
  while (p < end) {
    const char* nl = (const char*)memchr(p, '\n', end - p);
    const char* eol = nl ? nl : end;
    if (p == eol) {
      p = eol + 1;
      continue;
    }
    if (*p == '#') {
      static const char kIn[] = "# input queries:";
      static const char kMa[] = "# matched queries:";
      if ((size_t)(eol - p) > sizeof(kIn) - 1 &&
          std::memcmp(p, kIn, sizeof(kIn) - 1) == 0) {
        total_queries += strtoll(p + sizeof(kIn) - 1, nullptr, 10);
      } else if ((size_t)(eol - p) > sizeof(kMa) - 1 &&
                 std::memcmp(p, kMa, sizeof(kMa) - 1) == 0) {
        matched_queries += strtoll(p + sizeof(kMa) - 1, nullptr, 10);
      }
      p = eol + 1;
      continue;
    }
    const char* col[15];
    size_t cln[15];
    int nc = 0;
    const char* q = p;
    while (nc < 15 && q <= eol) {
      const char* tab = (const char*)memchr(q, '\t', eol - q);
      const char* ce = tab ? tab : eol;
      col[nc] = q;
      cln[nc] = ce - q;
      ++nc;
      if (!tab) break;
      q = ce + 1;
    }
    if (nc < 15) return -1;
    row_off[n_rows] = p - buf;
    row_len[n_rows] = eol - p;
    hits_off[n_rows] = col[4] - buf;
    hits_len[n_rows] = (int64_t)cln[4];
    qid_len[n_rows] = (int64_t)cln[0];
    qidx[n_rows] = strtoll(col[14], nullptr, 10);
    score[n_rows] = strtod(col[score_col], nullptr);
    ++n_rows;
    p = eol + 1;
  }
  out_counts[0] = n_rows;
  out_counts[1] = total_queries;
  out_counts[2] = matched_queries;
  return 0;
}

// Emit merged rows in `order`, splicing the rewritten hits value, and
// verify that all rows of one queryIdx share a query id (merge.go's
// unmatched-sequence-Id check).  Returns bytes written, or -(i+2) when
// output position i's query id mismatches its group's first row.
int64_t kt_merge_emit(const char* buf, int64_t n_out, const int64_t* order,
                      const int64_t* row_off, const int64_t* row_len,
                      const int64_t* hits_off, const int64_t* hits_len,
                      const int64_t* qid_len, const int64_t* qidx,
                      const int32_t* hits, char* out) {
  char* p = out;
  int64_t cur_qidx = -1;
  const char* cur_qid = nullptr;
  int64_t cur_qid_len = 0;
  for (int64_t i = 0; i < n_out; ++i) {
    const int64_t r = order[i];
    const char* row = buf + row_off[r];
    if (qidx[r] != cur_qidx) {
      cur_qidx = qidx[r];
      cur_qid = row;
      cur_qid_len = qid_len[r];
    } else if (qid_len[r] != cur_qid_len ||
               std::memcmp(row, cur_qid, cur_qid_len) != 0) {
      return -(i + 2);
    }
    const int64_t pre = hits_off[r] - row_off[r];
    std::memcpy(p, row, pre);
    p += pre;
    // hits value (<= 10 digits)
    int32_t v = hits[i];
    if (v == 0) {
      *p++ = '0';
    } else {
      char tmp[12];
      int n = 0;
      while (v > 0) {
        tmp[n++] = '0' + (v % 10);
        v /= 10;
      }
      while (n > 0) *p++ = tmp[--n];
    }
    const char* post = row + pre + hits_len[r];
    const int64_t post_len = row_len[r] - pre - hits_len[r];
    std::memcpy(p, post, post_len);
    p += post_len;
    *p++ = '\n';
  }
  return p - out;
}

// Pack variable-length reads into a zero-padded row-major [n, stride]
// uint8 matrix (the device batch layout).  Replaces a NumPy boolean
// fancy-index scatter that cost ~50 ms per 131k-read batch on this
// box's 4 CPUs.
void kt_pack_rows(const uint8_t* concat, const int64_t* offs, int64_t n,
                  int64_t stride, uint8_t* out) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; i++) {
    int64_t len = offs[i + 1] - offs[i];
    if (len > stride) len = stride;
    std::memcpy(out + i * stride, concat + offs[i], len);
    std::memset(out + i * stride + len, 0, stride - len);
  }
}

// 4-bit packed variant: two base CODES per output byte (A=1 C=2 G=3
// T=4, case-insensitive, anything else 0 = invalid; low nibble =
// earlier base).  Halves the H2D bytes of a device read batch; the
// device decodes nibbles back to the ASCII plane before the hash
// (kmcp_tpu/search/device_hash.py unpack_reads, packed4).
void kt_pack_rows_4bit(const uint8_t* concat, const int64_t* offs,
                       int64_t n, int64_t stride, uint8_t* out) {
  static uint8_t code[256];
  static bool init = false;
  if (!init) {  // benign race: all writers store identical values
    code[(int)'A'] = code[(int)'a'] = 1;
    code[(int)'C'] = code[(int)'c'] = 2;
    code[(int)'G'] = code[(int)'g'] = 3;
    code[(int)'T'] = code[(int)'t'] = 4;
    init = true;
  }
  const int64_t half = stride / 2;
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; i++) {
    int64_t len = offs[i + 1] - offs[i];
    if (len > stride) len = stride;
    const uint8_t* src = concat + offs[i];
    uint8_t* dst = out + i * half;
    int64_t p = 0;
    for (; p + 1 < len; p += 2)
      dst[p / 2] = (uint8_t)(code[src[p]] | (code[src[p + 1]] << 4));
    if (p < len) dst[p / 2] = code[src[p]];
    std::memset(dst + (len + 1) / 2, 0, half - (len + 1) / 2);
  }
}


// 2-bit packed variant + invalid bitmap: FOUR base codes per output
// byte (A=0 C=1 G=2 T=3, low pair = earlier base) plus one INVALID
// bit per base in a [n, stride/8] bitmap (bit i%8 of byte i/8 set =
// not ACGT; padding past len is invalid).  Quarter the read bytes +
// an eighth for the bitmap = 0.375x the ASCII layout, vs 0.5x for the
// 4-bit form (kmcp_tpu/search/device_hash.py unpack_reads, packed2,
// decodes on device).
void kt_pack_rows_2bit(const uint8_t* concat, const int64_t* offs,
                       int64_t n, int64_t stride, uint8_t* out,
                       uint8_t* nmask) {
  static uint8_t code2[256];
  static uint8_t valid2[256];
  static bool init2 = false;
  if (!init2) {  // benign race: all writers store identical values
    code2[(int)'A'] = code2[(int)'a'] = 0;
    code2[(int)'C'] = code2[(int)'c'] = 1;
    code2[(int)'G'] = code2[(int)'g'] = 2;
    code2[(int)'T'] = code2[(int)'t'] = 3;
    valid2[(int)'A'] = valid2[(int)'a'] = 1;
    valid2[(int)'C'] = valid2[(int)'c'] = 1;
    valid2[(int)'G'] = valid2[(int)'g'] = 1;
    valid2[(int)'T'] = valid2[(int)'t'] = 1;
    init2 = true;
  }
  const int64_t q = stride / 4, e = stride / 8;
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; i++) {
    int64_t len = offs[i + 1] - offs[i];
    if (len > stride) len = stride;
    const uint8_t* src = concat + offs[i];
    uint8_t* dst = out + i * q;
    uint8_t* nm = nmask + i * e;
    std::memset(dst, 0, q);
    std::memset(nm, 0xFF, e);
    for (int64_t p = 0; p < len; p++) {
      uint8_t c = src[p];
      dst[p / 4] = (uint8_t)(dst[p / 4] | (code2[c] << (2 * (p % 4))));
      if (valid2[c]) nm[p / 8] = (uint8_t)(nm[p / 8] & ~(1 << (p % 8)));
    }
  }
}

}  // extern "C"
